"""Time-major LSTM recurrence (both directions of a bidirectional layer at
once, or the one direction of a unidirectional layer): the hand-written CUDA
kernels and their plain PyTorch versions.

Kernels (sources under ``csrc/``), each replacing a Pallas kernel of
``speech_enhancement_by_s3prl_tpu/ops/pallas/lstm_kernel.py``:

- B1 ``lstm_bidir_tm``: the recurrence, forward only
  (``lstm_bidir_pallas_tm``). It runs whenever no gradient is needed.
- B2 fwd ``lstm_bidir_tm_fc`` (the same kernel with its cell flag): the
  recurrence that also returns the cell states (``_tm_fwd_with_cell``).
  For a hidden size that is a multiple of 8 up to 256 (``fwd_route``) both
  run ``lstm_tm_cluster.cu``: one thread-block cluster per (direction, batch
  block of ``fwd_batch_block`` rows), W_hh^T held in registers, xw fetched
  ahead, h exchanged through distributed shared memory, no grid barrier.
  ``lstm_bidir_tm_fwd_model`` is that algorithm in PyTorch, for the CPU
  tests. Any other hidden size takes the earlier cooperative kernel of
  ``lstm_tm.cu``.
- B2 bwd ``lstm_bidir_tm_bwd`` (``lstm_tm_bwd.cu``): the reverse-time VJP
  (``_tm_bwd``), which recomputes the gates and sums dW_hh^T itself. For a
  hidden size that is a multiple of 8 up to 256 (``bwd_route``) one call is
  three phases: the gates of every step as one product on the tensor cores,
  the dh chain alone in a kernel of thread-block clusters, and dW_hh^T as one
  more product. ``lstm_bidir_tm_bwd_model`` is that algorithm in PyTorch, for
  the CPU tests. Any other hidden size takes the earlier single kernel.

- B6 ``lstm_bidir_bb``: the same function as B1, computed independently per
  batch block (``lstm_bidir_pallas``). It runs B1's cluster kernel
  (``lstm_tm_cluster.cu``) at ``bb_batch_block`` rows a cluster.
- B7 ``lstm_bidir_fused`` (``lstm_bb_cluster.cu``): the recurrence with the
  input projection inside, so that no ``xw`` tensor exists
  (``lstm_bidir_pallas_fused``), on B1's skeleton: one thread-block cluster
  per (direction, batch block of ``bb_batch_block`` rows), W_hh^T in
  registers, h through distributed shared memory, the step product on FMAs,
  and the projection of a run of steps ahead on the tensor cores.
  ``lstm_bidir_bb_model`` / ``lstm_bidir_fused_model`` are those algorithms
  in PyTorch, for the CPU tests. Both take the shapes of ``bb_route``.

``LstmBidirTm`` ties B2 fwd and B2 bwd into a ``torch.autograd.Function``, the
counterpart of the JAX custom VJP ``lstm_bidir_tm``; ``lstm_bidir_tm`` routes
to it when a gradient is needed. B6 and B7 are forward-only, as they are in
the JAX package, and raise when a gradient is needed.

All keep the JAX layout: ``xw`` (2, B, T, 4H) holds the input projections
plus biases, direction 1 already time-flipped; ``w_hh_t`` (2, H, 4H) is
W_hh^T per direction; ``hs`` and ``cs`` are (2, B, T, H) f32. B1 and B2 also
take a leading axis of 1: the recurrence of a one-direction layer (the JAX
package's ``lax.scan`` cell). Gate order is
i, f, g, o; h and c start at zero and stay f32. There are no lengths: the
recurrence runs over the whole (padded) T, as the JAX package does.

B1 also continues a recurrence (the JAX ``_lstm_scan(..., init_state=,
return_final=True)``): ``lstm_bidir_tm(xw, w_hh_t, state=(h0, c0),
return_state=True)`` starts from h0, c0 (ndir, B, H) and returns the final
(hT, cT) beside hs; hT is hs's last step and the kernel writes cT. That is
what a stream carried chunk by chunk runs (``ops/streaming.StatefulStreamer``).
It is inference only: with a gradient needed it raises (gradient through a
carried state, ``ROADMAP.md`` A3).

B1, B2 fwd and B2 bwd have a bf16-h form (``h_bf16=True``): the
one-direction layer of the JAX package in bf16, its ``lax.scan`` cell
(``LstmCellScan`` running ``_lstm_scan``), which rounds h_{t-1} (h0
included) to bf16 for the step product only; h, c, hs and the carried (hT,
cT) stay f32. Its backward, as the jaxpr of JAX's gradient has it: the gates
recomputed from bf16(h_{t-1}), dh_t = dhs_t + bf16(da_{t+1} @ W_hh) (the
carried product rounded once), dxw = da in f32, and dW_hh^T a bf16 sum taken
one step at a time in reverse, which no product over all rows gives: that
sum is a kernel of its own, ``lstm_bidir_tm_dw_bf16`` (``lstm_dw_bf16.cu``:
the step products on the tensor cores, the bf16 carry in packed pairs),
launched by B2 bwd's wrapper in the form; ``lstm_bidir_tm_dw_bf16_model`` is
its algorithm in PyTorch, for the CPU tests.

B1, B2 fwd and B2 bwd also have the JAX package's bf16 stream forms, which
change what the kernels read and write, never the f32 recurrence:

- bf16 xw (``SE_LSTM_XW_BF16`` there): ``xw`` handed in as bf16, widened to
  f32 where a step reads it; B2 bwd then writes dxw in bf16 (JAX's dxw in
  xw's dtype, ``_tm_bwd``). B6 takes it too.
- bf16 hs (``SE_PALLAS_HS_BF16``): B1 stores hs in bf16
  (``hs_dtype=torch.bfloat16``); h and c stay f32 inside the recurrence.
- bf16 residuals (``SE_PALLAS_VJP_BF16``): B2 fwd stores hs and cs in bf16
  (``res_dtype``), and B2 bwd, handed bf16 hs / cs / dhs, recomputes the gates
  from them against W_hh^T rounded to bf16, rounds da to bf16 for the carried
  dh product, and sums dW_hh^T in f32 from the bf16 h and the f32 da
  (``_kernel_tm_bwd`` with a bf16 ``whh``).

B1 has three more forms of the JAX package, which change the function it
computes (its ``_kernel_tm`` under ``SE_PALLAS_MXU_BF16`` /
``SE_PALLAS_GATES_BF16``, and ``_lstm_scan`` under ``SE_LSTM_XW_INT8``):

- the MXU form (``mxu_bf16=True``): W_hh^T rounded to bf16 and h_{t-1}
  rounded to bf16 for the step product, which sums in f32: the bf16-h form
  on bf16 W_hh^T values, stored hs of either dtype. Under a gradient it
  changes nothing, as JAX's ``_tm_fwd_with_cell`` / ``_tm_bwd`` read no
  variable.
- the gates form (``gates_bf16=True``): the gate pre-activations rounded to
  bf16; i, f, o = bf16(bf16(tanh(t / 2)) / 2 + 1/2) and g = bf16(tanh(t)),
  each pass in f32 on a bf16 value and rounded; i * g rounded to bf16; then
  c = f * c + i * g and h = o * tanh(c) in f32. B1 only, as the MXU form.
- an int8 xw (the scan's ``SE_LSTM_XW_INT8``): ``quantize_xw_int8`` gives q
  (int8) and a scale a (direction, row, step), and a step reads q * scale in
  f32. B1 reads q and the scale (``xw_scale``); under a gradient the caller
  hands the dequantized f32 xw to B2 (``dequantize_xw_int8``).

``lstm_bidir_tm`` returns hs widened to f32 whatever it stored, as
``lstm_bidir_pallas_tm`` and the custom VJP's forward return it; under
autograd that widening is where the dh cotangent is rounded to bf16 on its way
back (``_lstm_bidir_tm_bwd``'s ``dout.astype(hs_tm.dtype)``). The forms are
arguments here; ``models/lstm.py`` reads the JAX package's variables.

A CPU tensor takes the plain versions. A CUDA tensor launches the kernel or
raises; nothing falls back. For B1's stateless call the choice is the
dispatcher's: ``lstm_bidir_tm`` calls the op ``se_torch::lstm_recurrence``
(``ops/cuda/library.py``), whose CPU kernel is the plain version and whose
CUDA kernel is ``_b1_cuda``; a carried state stays outside the op (the
streamer's chunks are not exported).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ...utils import costs
from ._build import launch_args, load, raise_on

# the dtypes of the streams the kernels read and write: f32, or bf16 in a
# stream form
STREAM_DTYPES = (torch.float32, torch.bfloat16)
# bits of the C entries' `form`: the bf16-h form, a bf16 xw, bf16 hs (B1) or
# residuals (B2 fwd stores them, B2 bwd reads them), the gates form and an
# int8 xw with its scale (B1)
FORM_H, FORM_XW, FORM_OUT, FORM_GATES, FORM_XW_INT8 = 1, 2, 4, 8, 16


def _form(h_bf16: bool, xw: torch.Tensor, out_dtype: torch.dtype = torch.float32,
          gates_bf16: bool = False) -> int:
    return ((FORM_H if h_bf16 else 0) | (FORM_XW if xw.dtype == torch.bfloat16 else 0)
            | (FORM_OUT if out_dtype == torch.bfloat16 else 0)
            | (FORM_GATES if gates_bf16 else 0)
            | (FORM_XW_INT8 if xw.dtype == torch.int8 else 0))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest, ties to even), held in f32."""
    return x.to(torch.bfloat16).float()


def _int8_scale(xw: torch.Tensor) -> torch.Tensor:
    """The scale of JAX's int8 xw a (..., row, step): max |xw| over the 4H
    gate inputs / 127 + 1e-12, (..., B, T, 1) f32."""
    return xw.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12


def quantize_xw_int8(xw: torch.Tensor):
    """xw (..., B, T, 4H) f32 -> (q, scale), as the JAX ``_lstm_scan`` stores
    its int8 stream (``models/lstm.py:111-113`` there): scale (..., B, T, 1)
    f32 from ``_int8_scale``, q = clip(round(xw / scale), -127, 127) as int8
    (round half to even, as ``jnp.round``). A step reads q * scale in f32."""
    scale = _int8_scale(xw)
    return torch.clamp(torch.round(xw / scale), -127, 127).to(torch.int8), scale


def dequantize_xw_int8(xw: torch.Tensor) -> torch.Tensor:
    """The f32 xw a step of the int8 form reads, q * scale, as torch ops under
    autograd: JAX's gradient of its int8 scan. ``round`` has a zero
    derivative, so the gradient reaches xw through the scale alone (the max
    splitting it evenly over ties, as both frameworks' max does)."""
    scale = _int8_scale(xw)
    return torch.clamp(torch.round(xw / scale), -127, 127) * scale


def _step_xw(xw: torch.Tensor, xw_scale: Optional[torch.Tensor], t: int) -> torch.Tensor:
    """Step t's xw in f32: widened from bf16, or dequantized from int8."""
    x = xw[..., t, :].float()
    return x if xw_scale is None else x * xw_scale[..., t, :]


def _sigmoid_bf16(t: torch.Tensor) -> torch.Tensor:
    """The gates form's sigmoid of bf16 values t, as the JAX kernel spells it
    in bf16: tanh(t / 2) / 2 + 1/2, each pass rounded to bf16 (the halvings
    are exact)."""
    return _bf16(_bf16(torch.tanh(t * 0.5)) * 0.5 + 0.5)


def _cell(gates: torch.Tensor, c: torch.Tensor, H: int, gates_bf16: bool = False):
    """One step's cell from its f32 gate pre-activations: (c, h). In the
    gates form the activations of the bf16-rounded gates and i * g are bf16
    values; c and h are f32 either way."""
    if gates_bf16:
        i, f, g, o = _bf16(gates).split(H, dim=-1)
        i, f, o = _sigmoid_bf16(i), _sigmoid_bf16(f), _sigmoid_bf16(o)
        c = f * c + _bf16(i * _bf16(torch.tanh(g)))
    else:
        i, f, g, o = gates.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        o = torch.sigmoid(o)
    return c, o * torch.tanh(c)


def _recurrence(xw: torch.Tensor, w_hh_t: torch.Tensor, with_cell: bool, state=None,
                h_bf16: bool = False, gates_bf16: bool = False,
                xw_scale: Optional[torch.Tensor] = None):
    """hs (and cs with ``with_cell``) in f32; xw of any stream dtype is
    widened (or, int8, dequantized by ``xw_scale``) where a step reads it."""
    H = w_hh_t.shape[-2]
    lead = xw.shape[:-2]  # (..., B)
    if state is None:
        h = xw.new_zeros(lead + (H,), dtype=torch.float32)
        c = torch.zeros_like(h)
    else:
        h, c = state
    hs, cs = [h[..., None, :][..., :0, :]], [c[..., None, :][..., :0, :]]  # T = 0
    for t in range(xw.shape[-2]):
        gates = _step_xw(xw, xw_scale, t) + torch.matmul(_bf16(h) if h_bf16 else h, w_hh_t)
        c, h = _cell(gates, c, H, gates_bf16)
        hs.append(h[..., None, :])
        cs.append(c[..., None, :])
    hs = torch.cat(hs, dim=-2)
    return (hs, torch.cat(cs, dim=-2)) if with_cell else hs


def lstm_bidir_tm_ref(xw: torch.Tensor, w_hh_t: torch.Tensor, state=None,
                      return_state: bool = False, h_bf16: bool = False,
                      hs_dtype: torch.dtype = torch.float32, gates_bf16: bool = False,
                      xw_scale: Optional[torch.Tensor] = None):
    """Plain PyTorch recurrence (B1's plain version): a Python loop over time.

    Works for any leading axes: xw (..., B, T, 4H) with w_hh_t (..., H, 4H)
    gives (..., B, T, H). ``state`` (h0, c0), each (..., B, H), is the
    initial state (None: zeros); with ``return_state`` the result is (hs,
    (hT, cT)). ``h_bf16``: the bf16-h form, which rounds h_{t-1} (h0
    included) to bf16 for the step product only; h, c, hs and (hT, cT) stay
    f32 and unrounded (with W_hh^T holding bf16 values it is the MXU form).
    xw may be bf16 (the bf16 xw form) or int8 with its ``xw_scale`` (..., B,
    T, 1) (the int8 form); ``hs_dtype`` bf16 stores hs rounded (the bf16 hs
    form; (hT, cT) stay f32); ``gates_bf16`` runs the gates form's cell
    (``_cell``)."""
    forms = dict(h_bf16=h_bf16, gates_bf16=gates_bf16, xw_scale=xw_scale)
    if not return_state:
        hs = _recurrence(xw, w_hh_t, with_cell=False, state=state, **forms)
        return hs.to(hs_dtype)
    hs, cs = _recurrence(xw, w_hh_t, with_cell=True, state=state, **forms)
    return hs.to(hs_dtype), _final_state(hs, cs, state)


def _final_state(hs, cs, state):
    """(hT, cT) of a recurrence with outputs hs, cs (..., B, T, H) that
    started from ``state`` (None: zeros), T = 0 included."""
    if hs.shape[-2]:
        return hs[..., -1, :], cs[..., -1, :]
    if state is None:
        zeros = hs.new_zeros(hs.shape[:-2] + hs.shape[-1:])
        return zeros, zeros.clone()
    return state


def lstm_bidir_tm_fc_ref(xw: torch.Tensor, w_hh_t: torch.Tensor, h_bf16: bool = False,
                         res_dtype: torch.dtype = torch.float32):
    """B2 fwd's plain version: (hs, cs), each (2, B, T, H) in ``res_dtype``
    (bf16: the bf16 residual form, both stored rounded); ``h_bf16`` and a
    bf16 xw as for ``lstm_bidir_tm_ref``."""
    hs, cs = _recurrence(xw, w_hh_t, with_cell=True, h_bf16=h_bf16)
    return hs.to(res_dtype), cs.to(res_dtype)


def lstm_bidir_tm_dw_bf16_ref(hs: torch.Tensor, da: torch.Tensor) -> torch.Tensor:
    """The plain version of the bf16-h form's dW_hh^T kernel: the cotangent
    of a bf16 W_hh^T as the JAX package's reverse ``lax.scan`` sums it, one
    step at a time in bf16. With acc = 0 in bf16, for t = T-1 .. 1:
        acc = bf16(acc + bf16(sum_b bf16(h_{t-1, b})^T da_{t, b}))
    (the step's product summed in f32, h_{-1} = 0 adding nothing at t = 0).
    hs (ndir, B, T, H), da (ndir, B, T, 4H) f32 -> dw_hh_t (ndir, H, 4H) f32
    holding bf16 values."""
    acc = torch.zeros(hs.shape[:-3] + (hs.shape[-1], da.shape[-1]), dtype=torch.float32,
                      device=hs.device)
    for tt in range(hs.shape[-2] - 1, 0, -1):
        step = torch.matmul(_bf16(hs[..., tt - 1, :]).transpose(-1, -2), da[..., tt, :])
        acc = _bf16(acc + _bf16(step))
    return acc


def split_bf16x3(x: torch.Tensor):
    """(hi, mid, lo): three tensors of bf16 values held in f32, hi =
    bf16(x), mid = bf16(x - hi), lo = x - hi - mid, whose sum is x exactly
    for a normal f32 x above 2^-100 (the three terms hold its 24 bits)."""
    hi = _bf16(x)
    mid = _bf16(x - hi)
    return hi, mid, (x - hi) - mid


# the most batch rows lstm_dw_bf16_f32 stages for one step at once: per row two
# staged runs of h and da (2 * 4 * (72 + 40) bytes, padded rows) and two
# buffers of its fragments (2 * 384 bytes), within the 232,448 bytes a block of
# an H100 may use, in groups of 8 rows (kChunkRows in lstm_dw_bf16.cu); a
# larger batch takes its rows in chunks (``dw_bf16_chunks``)
DW_BF16_CHUNK_ROWS = 232448 // (2 * 4 * (72 + 40) + 2 * 384) // 8 * 8
# past one chunk, the most rows a wgmma chain of a step's sum takes
# (kChainGroups groups of 8 in lstm_dw_bf16.cu)
DW_BF16_CHAIN_ROWS = 32


def dw_bf16_chunks(batch: int):
    """The row ranges ``lstm_dw_bf16.cu`` stages a step's rows in, as
    ``lstm_dw_bf16_f32`` cuts them: all rows in one chunk up to
    ``DW_BF16_CHUNK_ROWS``, else the ceil(B / 8) groups of 8 rows in the
    fewest chunks of at most that many rows, each of ceil(groups / chunks)
    groups (the last one ragged). Every chunk starts on a group of 8 rows, so
    on a K slice of 4."""
    groups = -(-batch // 8)
    fit = DW_BF16_CHUNK_ROWS // 8
    chunks = -(-groups // fit) if groups > fit else 1
    rows = 8 * -(-groups // chunks)
    return [(lo, min(batch, lo + rows)) for lo in range(0, batch, rows)] if chunks > 1 \
        else [(0, batch)]


def dw_bf16_chains(batch: int):
    """The row ranges of the kernel's wgmma chains of a step's sum: one chain
    over all rows within one chunk, else each chunk of ``dw_bf16_chunks`` in
    chains of ``DW_BF16_CHAIN_ROWS`` rows (a chunk's last one shorter)."""
    chunks = dw_bf16_chunks(batch)
    if len(chunks) == 1:
        return chunks
    return [(a, min(hi, a + DW_BF16_CHAIN_ROWS)) for lo, hi in chunks
            for a in range(lo, hi, DW_BF16_CHAIN_ROWS)]


def lstm_bidir_tm_dw_bf16_model(hs: torch.Tensor, da: torch.Tensor) -> torch.Tensor:
    """The algorithm of ``lstm_dw_bf16.cu`` in PyTorch, for the CPU tests:
    what ``lstm_bidir_tm_dw_bf16_ref`` computes, with the step product taken
    as the kernel's tensor cores take it. da is split into three bf16 terms
    (``split_bf16x3``) against bf16(h), so every product is exact; the batch
    rows go in K slices of 4 (zero rows pad the last), each slice's exact sum
    is added to the step's f32 sum with one rounding (the kernel's wgmma chain,
    a slice at a time), and the carry adds bf16 pairs with one rounding,
    acc = bf16(acc + bf16(p)). Past ``DW_BF16_CHUNK_ROWS`` rows the step's
    rows go in the chains of ``dw_bf16_chains``: the first chain is the
    step's sum, each later one starts from zero and is added to it with one
    rounding. (The tensor cores' f32 accumulation itself is not
    round-to-nearest, so the kernel's bits are this model's only where no
    sum lost a bit there: past one chunk this is the kernel's order, not a
    bit-for-bit reference.) hs (ndir, B, T, H), da (ndir, B,
    T, 4H) f32 -> (ndir, H, 4H) f32 holding bf16 values."""
    B, T = hs.shape[-3], hs.shape[-2]
    acc = torch.zeros(hs.shape[:-3] + (hs.shape[-1], da.shape[-1]), dtype=torch.float32,
                      device=hs.device)
    if T < 2:
        return acc
    h = _bf16(hs[..., :-1, :]).double()
    terms = torch.stack(split_bf16x3(da[..., 1:, :]), dim=-2).double()  # (.., B, T-1, 3, 4H)
    step = torch.zeros(acc.shape[:-2] + (T - 1,) + acc.shape[-2:], dtype=torch.float32,
                       device=hs.device)
    for c, (lo, hi) in enumerate(dw_bf16_chains(B)):
        chain = torch.zeros_like(step)
        for b0 in range(lo, hi, 4):
            rows = slice(b0, min(b0 + 4, hi))
            part = torch.einsum("...btk,...btjn->...tkn", h[..., rows, :, :],
                                terms[..., rows, :, :, :])
            chain = (chain.double() + part).float()
        step = chain if c == 0 else step + chain
    for tt in range(T - 2, -1, -1):
        acc = _bf16(acc + _bf16(step[..., tt, :, :]))
    return acc


def lstm_bidir_tm_bwd_ref(xw, w_hh_t, hs, cs, dhs, h_bf16: bool = False):
    """B2 bwd's plain version, step for step the Pallas ``_kernel_tm_bwd``:
    reverse time, gates recomputed from (xw_t, h_{t-1}), h_{-1} = c_{-1} = 0,
    dh and dc carried. Returns (dxw (2, B, T, 4H) in xw's dtype, dw_hh_t (2,
    H, 4H) f32).

    ``h_bf16``: the VJP of the bf16-h form (the JAX ``lax.scan`` cell in
    bf16): the gates recomputed from bf16(h_{t-1}), the carried dh_t =
    dhs_t + bf16(da_{t+1} @ W_hh) (the whole product rounded once), and
    dW_hh^T summed in bf16 step by step (``lstm_bidir_tm_dw_bf16_ref``).

    The bf16 residual form, taken when hs, cs and dhs are bf16: W_hh^T rounded
    to bf16 for both products, the gates recomputed from the bf16 h_{t-1},
    c_{t-1} and c_t, the carried dh_t = dhs_t + bf16(da_{t+1}) @ bf16(W_hh),
    and dW_hh^T = sum h_{t-1}^T da in f32 from the unrounded da. A bf16 xw
    is widened where read, and dxw is da rounded to bf16 (dW_hh^T still
    takes the f32 da)."""
    H = w_hh_t.shape[-2]
    T = xw.shape[-2]
    res_bf16 = hs.dtype == torch.bfloat16
    w = _bf16(w_hh_t) if res_bf16 else w_hh_t
    hs, cs, dhs = hs.float(), cs.float(), dhs.float()
    dh_c = hs.new_zeros(hs.shape[:-2] + (H,))
    dc_c = torch.zeros_like(dh_c)
    dw = torch.zeros(w_hh_t.shape, dtype=torch.float32, device=xw.device)
    das = [xw.new_zeros(xw.shape[:-2] + (0, 4 * H), dtype=torch.float32)] + [None] * T
    for tt in range(T - 1, -1, -1):
        h_prev = hs[..., tt - 1, :] if tt > 0 else torch.zeros_like(dh_c)
        c_prev = cs[..., tt - 1, :] if tt > 0 else torch.zeros_like(dh_c)
        gates = xw[..., tt, :].float() + torch.matmul(_bf16(h_prev) if h_bf16 else h_prev, w)
        i, f, g, o = gates.split(H, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        tc = torch.tanh(cs[..., tt, :])
        dh = dhs[..., tt, :] + dh_c
        do = dh * tc
        dct = dh * o * (1.0 - tc * tc) + dc_c
        dc_c = dct * f
        da = torch.cat([
            dct * g * i * (1.0 - i),
            dct * c_prev * f * (1.0 - f),
            dct * i * (1.0 - g * g),
            do * o * (1.0 - o),
        ], dim=-1)
        das[tt + 1] = da[..., None, :]
        dh_c = torch.matmul(_bf16(da) if res_bf16 else da, w.transpose(-1, -2))
        if h_bf16:
            dh_c = _bf16(dh_c)
        else:
            dw = dw + torch.matmul(h_prev.transpose(-1, -2), da)
    da = torch.cat(das, dim=-2)
    return da.to(xw.dtype), (lstm_bidir_tm_dw_bf16_ref(hs, da) if h_bf16 else dw)


def _check(xw: torch.Tensor, w_hh_t: torch.Tensor, dirs=(1, 2), xw_scale=None):
    """``dirs``: the direction counts (leading axis) the caller's kernel takes.
    xw is f32 or bf16 (the bf16 xw form), or int8 beside its ``xw_scale``
    (ndir, B, T, 1) f32 (the int8 form, B1 only); w_hh_t f32."""
    if xw.dim() != 4 or xw.shape[0] not in dirs or xw.shape[-1] % 4:
        raise ValueError(f"xw must be ({' or '.join(map(str, dirs))}, B, T, 4H), "
                         f"got {tuple(xw.shape)}")
    ndir, H = xw.shape[0], xw.shape[-1] // 4
    if tuple(w_hh_t.shape) != (ndir, H, 4 * H):
        raise ValueError(
            f"w_hh_t must be ({ndir}, {H}, {4 * H}) for xw {tuple(xw.shape)}, "
            f"got {tuple(w_hh_t.shape)}"
        )
    if xw_scale is None:
        if xw.dtype not in STREAM_DTYPES or w_hh_t.dtype != torch.float32:
            raise ValueError(
                f"lstm_bidir_tm takes an f32 or bf16 xw (int8 with its xw_scale) and an f32 "
                f"w_hh_t, got {xw.dtype} / {w_hh_t.dtype}"
            )
    elif (xw.dtype != torch.int8 or w_hh_t.dtype != torch.float32
          or xw_scale.dtype != torch.float32 or xw_scale.device != xw.device
          or tuple(xw_scale.shape) != tuple(xw.shape[:-1]) + (1,)):
        raise ValueError(
            f"an xw_scale goes with an int8 xw: f32 {tuple(xw.shape[:-1]) + (1,)} beside int8 "
            f"xw and f32 w_hh_t, got {xw_scale.dtype} {tuple(xw_scale.shape)} on "
            f"{xw_scale.device} / {xw.dtype} / {w_hh_t.dtype}")
    if xw.device != w_hh_t.device:
        raise ValueError(f"xw on {xw.device} but w_hh_t on {w_hh_t.device}")
    if xw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm_bidir_tm runs on cpu or cuda, not {xw.device}")


def _check_form(h_bf16: bool, out_dtype: torch.dtype, name: str, b1: bool = False):
    """``out_dtype``: what B1 (hs, ``b1``) or B2 fwd (hs, cs) stores. The
    bf16-h form stores bf16 hs only in B1 (the MXU form under
    ``SE_PALLAS_HS_BF16``): B2's residuals have no bf16-h form."""
    if out_dtype not in STREAM_DTYPES:
        raise ValueError(f"{name} stores f32 or bf16, got {out_dtype}")
    if h_bf16 and out_dtype != torch.float32 and not b1:
        raise ValueError(f"{name}: the bf16-h form stores f32 hs and cs")


def _check_state(xw: torch.Tensor, state):
    """``state`` = (h0, c0), each (ndir, B, H) f32 on xw's device."""
    if len(state) != 2:
        raise ValueError("state must be (h0, c0)")
    ndir, B, _, h4 = xw.shape
    want = (ndir, B, h4 // 4)
    for name, t in zip(("h0", "c0"), state):
        if tuple(t.shape) != want or t.dtype != torch.float32 or t.device != xw.device:
            raise ValueError(f"{name} must be f32 {want} on {xw.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _check_residuals(xw, hs, cs, dhs, h_bf16: bool = False):
    """hs, cs and dhs (ndir, B, T, H) on xw's device, all f32 or all bf16
    (the bf16 residual form, which the bf16-h form does not take)."""
    ndir, B, T, h4 = xw.shape
    want = (ndir, B, T, h4 // 4)
    dtype = torch.float32 if h_bf16 or hs.dtype != torch.bfloat16 else torch.bfloat16
    for name, t in (("hs", hs), ("cs", cs), ("dhs", dhs)):
        if tuple(t.shape) != want or t.dtype != dtype or t.device != xw.device:
            raise ValueError(
                f"{name} must be {dtype} {want} on {xw.device} (hs, cs and dhs all f32 or all "
                f"bf16; f32 in the bf16-h form), got {t.dtype} {tuple(t.shape)} on {t.device}"
            )


def _library():
    lib = load("lstm_tm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_bidir_tm_f32.argtypes = [p] * 8 + [i] * 6 + [p]
    lib.lstm_bidir_tm_f32.restype = i
    lib.lstm_bidir_tm_fc_f32.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.lstm_bidir_tm_fc_f32.restype = i
    lib.lstm_tm_error_string.argtypes = [i]
    lib.lstm_tm_error_string.restype = ctypes.c_char_p
    return lib


def _cluster_library():
    lib = load("lstm_tm_cluster")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_tm_cluster_f32.argtypes = [p] * 7 + [i] * 8 + [p]
    lib.lstm_tm_cluster_f32.restype = i
    lib.lstm_tm_cluster_fc_f32.argtypes = [p] * 4 + [i] * 7 + [p]
    lib.lstm_tm_cluster_fc_f32.restype = i
    lib.lstm_tm_cluster_max_clusters.argtypes = [i, ctypes.POINTER(i)]
    lib.lstm_tm_cluster_max_clusters.restype = i
    lib.lstm_tm_cluster_error_string.argtypes = [i]
    lib.lstm_tm_cluster_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_library():
    lib = load("lstm_tm_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_bidir_tm_bwd_grid_f32.argtypes = [p] * 8 + [i] * 6 + [p]
    lib.lstm_bidir_tm_bwd_grid_f32.restype = i
    lib.lstm_bidir_tm_bwd_phases_f32.argtypes = [p] * 9 + [i] * 7 + [p]
    lib.lstm_bidir_tm_bwd_phases_f32.restype = i
    lib.lstm_tm_bwd_error_string.argtypes = [i]
    lib.lstm_tm_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _dw_bf16_library():
    lib = load("lstm_dw_bf16")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_dw_bf16_f32.argtypes = [p] * 3 + [i] * 5 + [p]
    lib.lstm_dw_bf16_f32.restype = i
    lib.lstm_dw_bf16_error_string.argtypes = [i]
    lib.lstm_dw_bf16_error_string.restype = ctypes.c_char_p
    return lib


# widest layer whose 8-block cluster keeps its W_hh^T slices resident
# (H / 8 units a block)
CLUSTER_MAX_HIDDEN = 256
# batch rows one cluster of the forward's ``cluster`` route takes at most
# (kMaxRows in lstm_tm_cluster.cu: a warp a row in the cell phase)
FWD_MAX_BATCH_BLOCK = 16
# slices of the reduction over H in that kernel: a warp a slice of 16
# consecutive inputs of h padded with zeros to CLUSTER_MAX_HIDDEN
FWD_SLICES = 16
# the ``cluster`` kernel of B1 with one element of its design changed, for
# measurement on the card (``variant`` of lstm_tm_cluster_f32)
FWD_VARIANTS = {"weights in shared memory": 1, "xw loaded in its step": 2,
                "16-byte remote stores": 4, "whole cluster barrier": 8}


def fwd_route(hidden: int) -> str:
    """The design B1 and B2 fwd run on a CUDA tensor, by the hidden size
    alone: ``"cluster"`` (``lstm_tm_cluster.cu``) for a multiple of 8 up to
    256, ``"grid"`` (the earlier cooperative kernel of ``lstm_tm.cu``) for any
    other."""
    return "cluster" if hidden % 8 == 0 and hidden <= CLUSTER_MAX_HIDDEN else "grid"


def fwd_batch_block(batch: int, ndir: int, clusters: int) -> int:
    """Rows a cluster of the ``cluster`` route takes: the fewest such that all
    ``ndir * ceil(batch / rows)`` clusters fit the ``clusters`` the card holds
    at once, at most ``FWD_MAX_BATCH_BLOCK`` (past that the clusters take
    turns). Rows are independent, so the choice never changes a bit of the
    result, only how the rows spread over the card."""
    per_dir = max(1, clusters // max(1, ndir))
    return max(1, min(FWD_MAX_BATCH_BLOCK, -(-batch // per_dir)))


@functools.lru_cache(maxsize=None)
def _fwd_clusters(device_index: int) -> int:
    """Clusters of the forward's ``cluster`` kernel that the card holds at
    once (``cudaOccupancyMaxActiveClusters``)."""
    lib = _cluster_library()
    out = ctypes.c_int(0)
    err = lib.lstm_tm_cluster_max_clusters(device_index, ctypes.byref(out))
    raise_on(err, "lstm_tm_cluster_max_clusters", lib.lstm_tm_cluster_error_string,
             device=device_index)
    if out.value < 1:
        raise RuntimeError(f"no cluster of lstm_tm_cluster fits device {device_index}")
    return out.value


def lstm_bidir_tm_fwd_model(xw: torch.Tensor, w_hh_t: torch.Tensor, batch_block: int = 1,
                            slices: int = FWD_SLICES, with_cell: bool = False, state=None,
                            h_bf16: bool = False, out_dtype: torch.dtype = torch.float32,
                            gates_bf16: bool = False, xw_scale: Optional[torch.Tensor] = None):
    """The ``cluster`` route of B1 / B2 fwd in PyTorch, as
    ``lstm_tm_cluster.cu`` runs it (the function of ``lstm_bidir_tm_ref``):
    each block of ``batch_block`` rows is its own recurrence; h is padded with
    zeros to ``max(H, CLUSTER_MAX_HIDDEN)`` inputs, cut into ``slices`` runs
    of consecutive inputs (the kernel: 16 runs of 16, a warp a run); at every
    step a slice's partial gates are summed one input at a time, the gates
    are xw plus the partials in slice order (a slice wholly past H adds
    nothing), and the cell runs row by row. Every operation acts on one row
    at a time or elementwise, so a row's bits do not depend on the other rows
    of its block. ``state`` (h0, c0), each (ndir, B, H), starts the
    recurrence where the kernel loads it (None: zeros). ``h_bf16``: the
    bf16-h form, the h each block pushes (and h0) rounded to bf16 for the
    step product. A bf16 xw is widened where a step reads it (the bf16 xw
    form); an int8 xw is q * scale with its ``xw_scale`` (ndir, B, T, 1) (the
    int8 form: one f32 product an element, then the partials added to it);
    ``gates_bf16`` runs the gates form's cell. Returns hs, or (hs, cs) with
    ``with_cell``, each (ndir, B, T, H) in ``out_dtype`` (bf16: the kernel's
    bf16 store of hs, and of cs)."""
    ndir, B, T, h4 = xw.shape
    H = h4 // 4
    hs = xw.new_zeros((ndir, B, T, H), dtype=torch.float32)
    cs = torch.zeros_like(hs)
    span = -(-max(H, CLUSTER_MAX_HIDDEN) // slices)
    for b0 in range(0, B, batch_block):
        rows = range(b0, min(B, b0 + batch_block))
        if state is None:
            h = xw.new_zeros((ndir, len(rows), H), dtype=torch.float32)
            c = torch.zeros_like(h)
        else:
            h, c = (s[:, b0:rows.stop].float() for s in state)
        for t in range(T):
            gates = _step_xw(xw[:, b0:rows.stop],
                             None if xw_scale is None else xw_scale[:, b0:rows.stop], t)
            h_in = _bf16(h) if h_bf16 else h
            for s in range(-(-H // span)):
                part = torch.zeros_like(gates)
                for i in range(s * span, min(H, (s + 1) * span)):
                    part = part + h_in[:, :, i:i + 1] * w_hh_t[:, None, i, :]
                gates = gates + part
            h, c = h.clone(), c.clone()
            for d in range(ndir):
                for r in range(len(rows)):
                    c[d, r], h[d, r] = _cell(gates[d, r], c[d, r], H, gates_bf16)
            hs[:, b0:rows.stop, t] = h
            cs[:, b0:rows.stop, t] = c
    hs, cs = hs.to(out_dtype), cs.to(out_dtype)
    return (hs, cs) if with_cell else hs


def _launch_fwd(route: str, xw, w_hh_t, with_cell: bool = False,
                batch_block: Optional[int] = None, variant: int = 0, state=None,
                return_state: bool = False, h_bf16: bool = False,
                out_dtype: torch.dtype = torch.float32, gates_bf16: bool = False,
                xw_scale: Optional[torch.Tensor] = None):
    """Launch B1 (or B2 fwd with ``with_cell``) on ``route`` ("cluster" or
    "grid") on checked, contiguous CUDA tensors with B, T > 0; returns hs or
    (hs, cs) in ``out_dtype``. B1 also takes ``state`` (h0, c0), contiguous
    (ndir, B, H) (None: zeros), and with ``return_state`` returns (hs, (hT,
    cT)), the kernel writing cT. ``lstm_bidir_tm`` / ``lstm_bidir_tm_fc`` pick
    the route by ``fwd_route`` and the batch block by ``fwd_batch_block``; the
    card script also runs the other route, other batch blocks and, through
    ``variant`` (B1 on the cluster route only), the design with one element
    changed (``FWD_VARIANTS``). ``h_bf16``, a bf16 xw and ``out_dtype`` bf16
    launch the forms (variant 0); B1 also ``gates_bf16`` and an int8 xw with
    its contiguous ``xw_scale``."""
    ndir, B, T, h4 = xw.shape
    H = h4 // 4
    hs = torch.empty((ndir, B, T, H), device=xw.device, dtype=out_dtype)
    cs = torch.empty_like(hs) if with_cell else None
    if with_cell and (state is not None or return_state):
        raise ValueError("B2 fwd takes no carried state")
    if out_dtype != torch.float32 and (state is not None or return_state):
        raise ValueError("a carried state runs with f32 hs (hT is hs's last step)")
    form = _form(h_bf16, xw, out_dtype, gates_bf16)
    c_out = torch.empty((ndir, B, H), device=xw.device, dtype=torch.float32) \
        if return_state else None
    ptrs = (xw.data_ptr(), w_hh_t.data_ptr(), hs.data_ptr())
    # B1's entries also take the int8 form's scale (null otherwise)
    b1_ptrs = (xw.data_ptr(), 0 if xw_scale is None else xw_scale.data_ptr(),
               w_hh_t.data_ptr(), hs.data_ptr())
    # null pointers: zeros in, no cT out
    carried = tuple(0 if t is None else t.data_ptr()
                    for t in (*(state or (None, None)), c_out))
    if route == "cluster":
        lib = _cluster_library()
        if batch_block is None:
            batch_block = fwd_batch_block(B, ndir, _fwd_clusters(launch_args(xw)[0]))
        if with_cell:
            err = lib.lstm_tm_cluster_fc_f32(*ptrs, cs.data_ptr(), ndir, B, T, H, batch_block,
                                             form, *launch_args(xw))
        else:
            err = lib.lstm_tm_cluster_f32(*b1_ptrs, *carried, ndir, B, T, H, batch_block,
                                          variant, form, *launch_args(xw))
        errstr = lib.lstm_tm_cluster_error_string
    else:
        lib = _library()
        # with hs stored in bf16 the steps exchange the f32 h through this
        # buffer, one (ndir, B, H) a step parity, in place of hs
        hf = (torch.empty((2, ndir, B, H), device=xw.device, dtype=torch.float32)
              if out_dtype != torch.float32 else None)
        hf_ptr = 0 if hf is None else hf.data_ptr()
        if with_cell:
            err = lib.lstm_bidir_tm_fc_f32(*ptrs, cs.data_ptr(), hf_ptr, ndir, B, T, H, form,
                                           *launch_args(xw))
        else:
            err = lib.lstm_bidir_tm_f32(*b1_ptrs, *carried, hf_ptr, ndir, B, T, H, form,
                                        *launch_args(xw))
        errstr = lib.lstm_tm_error_string
    raise_on(err, "lstm_bidir_tm_fc" if with_cell else "lstm_bidir_tm", errstr, route=route,
             ndir=ndir, B=B, T=T, H=H, batch_block=batch_block, variant=variant, form=form)
    if return_state:
        return hs, (hs[:, :, -1], c_out)
    return (hs, cs) if with_cell else hs


def lstm_bidir_tm(xw: torch.Tensor, w_hh_t: torch.Tensor, state=None,
                  return_state: bool = False, h_bf16: bool = False,
                  hs_dtype: torch.dtype = torch.float32,
                  res_dtype: torch.dtype = torch.float32, mxu_bf16: bool = False,
                  gates_bf16: bool = False, xw_scale: Optional[torch.Tensor] = None):
    """(2, B, T, 4H), (2, H, 4H) -> hs (2, B, T, H) f32; a leading 1 in place
    of the 2 is a one-direction layer. ``state`` (h0, c0), each (2, B, H)
    f32, starts the recurrence there (None: zeros); with ``return_state``
    the result is (hs, (hT, cT)). ``h_bf16`` runs the bf16-h form
    (``lstm_bidir_tm_ref``), the one-direction layer in bf16. A bf16 xw runs
    the bf16 xw form; ``hs_dtype`` bf16 stores B1's hs in bf16 and
    ``res_dtype`` bf16 B2 fwd's hs and cs (the bf16 residual form, B2 bwd
    reading them so); either way hs comes back widened to f32. An int8 xw
    with its ``xw_scale`` (``quantize_xw_int8``) runs the int8 form, without
    a gradient only. ``mxu_bf16`` and ``gates_bf16`` are forms of B1 alone
    (JAX's ``_kernel_tm``; its custom VJP's forward and backward read
    neither): without a gradient the MXU form (the bf16-h form on W_hh^T
    rounded to bf16) and the gates form, under a gradient nothing.

    When a gradient is needed (grad mode on and an input that requires it)
    this is ``LstmBidirTm``: B2 fwd now, B2 bwd in the backward pass; a
    carried state raises there. Otherwise it is B1 (the primal of the JAX
    custom VJP): on a CUDA tensor the kernel of route ``fwd_route(H)``,
    counted in ``lstm_bidir_tm.launches`` and ``lstm_bidir_tm.by_route``, a
    launch with a state in or out also in ``lstm_bidir_tm.carried``, one of
    the bf16-h form (the MXU form included) in ``lstm_bidir_tm.h_bf16``, of a
    bf16 xw in ``.xw_bf16``, of bf16 hs in ``.hs_bf16``, of the gates form in
    ``.gates_bf16`` and of an int8 xw in ``.xw_int8``; on a CPU tensor the
    plain version."""
    _check(xw, w_hh_t, xw_scale=xw_scale)
    _check_form(h_bf16, hs_dtype, "lstm_bidir_tm", b1=True)
    _check_form(h_bf16, res_dtype, "lstm_bidir_tm")
    if state is not None:
        _check_state(xw, state)
    grad = torch.is_grad_enabled() and (
        xw.requires_grad or w_hh_t.requires_grad
        or (state is not None and any(t.requires_grad for t in state)))
    if grad:
        if state is not None or return_state:
            raise RuntimeError(
                "lstm_bidir_tm: a carried state (state= / return_state=) is inference "
                "only; the gradient through a carried state is not ported (ROADMAP.md A3)")
        if xw_scale is not None:
            raise RuntimeError(
                "lstm_bidir_tm: an int8 xw is inference only; under a gradient hand in "
                "its dequantized f32 xw (dequantize_xw_int8)")
        # the widening's backward rounds the dh cotangent to the residuals' dtype
        return LstmBidirTm.apply(xw, w_hh_t, h_bf16, res_dtype).float()
    if mxu_bf16:
        # JAX's _kernel_tm: W_hh^T and h_{t-1} in bf16 for the step product
        w_hh_t, h_bf16 = _bf16(w_hh_t), True
    hs_bf16 = hs_dtype == torch.bfloat16
    if state is None and not return_state:
        from .library import lstm_recurrence

        with costs.kernel("B1", costs.b1_call_cost, xw, w_hh_t, h_bf16, hs_bf16,
                          xw_scale=xw_scale):
            return lstm_recurrence(xw, w_hh_t, h_bf16, hs_bf16, gates_bf16, xw_scale).float()
    if hs_dtype != torch.float32:
        raise ValueError("lstm_bidir_tm: a carried state runs with f32 hs")
    with costs.kernel("B1", costs.b1_call_cost, xw, w_hh_t, h_bf16, carried=True,
                      xw_scale=xw_scale):
        if xw.device.type == "cpu":
            return lstm_bidir_tm_ref(xw, w_hh_t, state, return_state, h_bf16, hs_dtype,
                                     gates_bf16, xw_scale)
        return _b1_cuda(xw, w_hh_t, state, return_state, h_bf16, hs_dtype, gates_bf16,
                        xw_scale)


def _b1_cuda(xw: torch.Tensor, w_hh_t: torch.Tensor, state=None, return_state: bool = False,
             h_bf16: bool = False, hs_dtype: torch.dtype = torch.float32,
             gates_bf16: bool = False, xw_scale: Optional[torch.Tensor] = None):
    """B1 on checked CUDA tensors: the kernel of route ``fwd_route(H)``, one
    launch and its counts (none for B = 0 or T = 0); hs in ``hs_dtype``, or
    (hs, (hT, cT)) with ``return_state``. Stateless, it is the CUDA kernel of
    the op ``se_torch::lstm_recurrence``."""
    if state is not None:
        state = tuple(t.contiguous() for t in state)
    if xw_scale is not None:
        xw_scale = xw_scale.contiguous()
    if not (xw.is_contiguous() and w_hh_t.is_contiguous()):
        raise ValueError("lstm_bidir_tm needs contiguous xw and w_hh_t")
    ndir, B, T, h4 = xw.shape
    if B == 0 or T == 0:
        hs = torch.empty((ndir, B, T, h4 // 4), device=xw.device, dtype=hs_dtype)
        return (hs, _final_state(hs, hs, state)) if return_state else hs
    route = fwd_route(h4 // 4)
    out = _launch_fwd(route, xw, w_hh_t, state=state, return_state=return_state,
                      h_bf16=h_bf16, out_dtype=hs_dtype, gates_bf16=gates_bf16,
                      xw_scale=xw_scale)
    lstm_bidir_tm.launches += 1
    lstm_bidir_tm.by_route[route] += 1
    lstm_bidir_tm.carried += state is not None or return_state
    lstm_bidir_tm.h_bf16 += h_bf16
    lstm_bidir_tm.xw_bf16 += xw.dtype == torch.bfloat16
    lstm_bidir_tm.hs_bf16 += hs_dtype == torch.bfloat16
    lstm_bidir_tm.gates_bf16 += gates_bf16
    lstm_bidir_tm.xw_int8 += xw.dtype == torch.int8
    return out


@costs.counted("B2 fwd", lambda xw, w_hh_t, h_bf16=False, res_dtype=torch.float32:
               costs.b1_call_cost(xw, w_hh_t, h_bf16, cell=True, res_dtype=res_dtype))
def lstm_bidir_tm_fc(xw: torch.Tensor, w_hh_t: torch.Tensor, h_bf16: bool = False,
                     res_dtype: torch.dtype = torch.float32):
    """B2 fwd: (2, B, T, 4H), (2, H, 4H) -> (hs, cs), each (2, B, T, H) in
    ``res_dtype`` (bf16: the bf16 residual form); ``h_bf16`` runs the bf16-h
    form, a bf16 xw the bf16 xw form. Kernel of route ``fwd_route(H)`` on a
    CUDA tensor (counted in ``lstm_bidir_tm_fc.launches`` and ``.by_route``,
    the forms also in ``.h_bf16``, ``.xw_bf16`` and ``.res_bf16``), plain
    version on a CPU tensor."""
    _check(xw, w_hh_t)
    _check_form(h_bf16, res_dtype, "lstm_bidir_tm_fc")
    if xw.device.type == "cpu":
        return lstm_bidir_tm_fc_ref(xw, w_hh_t, h_bf16, res_dtype)
    if not (xw.is_contiguous() and w_hh_t.is_contiguous()):
        raise ValueError("lstm_bidir_tm_fc needs contiguous xw and w_hh_t")
    ndir, B, T, h4 = xw.shape
    if B == 0 or T == 0:
        hs = torch.empty((ndir, B, T, h4 // 4), device=xw.device, dtype=res_dtype)
        return hs, torch.empty_like(hs)
    route = fwd_route(h4 // 4)
    out = _launch_fwd(route, xw, w_hh_t, with_cell=True, h_bf16=h_bf16, out_dtype=res_dtype)
    lstm_bidir_tm_fc.launches += 1
    lstm_bidir_tm_fc.by_route[route] += 1
    lstm_bidir_tm_fc.h_bf16 += h_bf16
    lstm_bidir_tm_fc.xw_bf16 += xw.dtype == torch.bfloat16
    lstm_bidir_tm_fc.res_bf16 += res_dtype == torch.bfloat16
    return out


# batch rows one cluster of B2 bwd's dh chain takes (kSeqRows in lstm_tm_bwd.cu)
BWD_BATCH_BLOCK = 8
# rows of dW_hh^T's contraction per split, and the most splits
BWD_SPLIT_ROWS, BWD_MAX_SPLITS = 512, 16


def bwd_route(hidden: int) -> str:
    """The design B2 bwd runs on a CUDA tensor, by the hidden size alone:
    ``"phases"`` (tensor-core products for the gates and dW_hh^T, the dh
    chain in thread-block clusters) for a multiple of 8 up to 256,
    ``"grid"`` (the earlier single cooperative kernel) for any other."""
    return "phases" if hidden % 8 == 0 and hidden <= CLUSTER_MAX_HIDDEN else "grid"


def bwd_splits(rows: int) -> int:
    """How many ways the ``phases`` route splits dW_hh^T's contraction over
    ``rows`` = B * T; the partial sums are added in split order."""
    return max(1, min(BWD_MAX_SPLITS, -(-rows // BWD_SPLIT_ROWS)))


def _cell_activations(gates, H):
    i, f, g, o = gates.split(H, dim=-1)
    return torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)],
                     dim=-1)


def lstm_bidir_tm_bwd_model(xw, w_hh_t, hs, cs, dhs, batch_block: int = BWD_BATCH_BLOCK,
                            splits: Optional[int] = None, h_bf16: bool = False):
    """The ``phases`` route of B2 bwd in PyTorch, phase for phase as
    ``lstm_tm_bwd.cu`` runs it (same function as ``lstm_bidir_tm_bwd_ref``):

    1. the gate activations of every step from one product over all rows,
       h_{t-1} being ``hs`` shifted by a step with zeros at t = 0, written
       into the dxw buffer;
    2. per batch block, the reverse loop that carries only dh and dc: a step
       reads its activations from the buffer, overwrites them with da, and
       dh_carry = da @ W_hh is its one product;
    3. dW_hh^T = sum over rows with t >= 1 of hs_{t-1}^T da, the rows cut into
       ``splits`` chunks whose partial sums are added in chunk order.

    ``h_bf16``, the bf16-h form: phase 1 takes h_{t-1} rounded to bf16, phase
    2 rounds dh_carry to bf16, and dW_hh^T is the step-by-step bf16 sum of
    ``lstm_bidir_tm_dw_bf16`` (its plain version) in place of phase 3.

    The bf16 residual form (bf16 hs, cs, dhs): phases 1 and 2 read them
    widened and W_hh^T rounded to bf16, phase 2 rounds da to bf16 for its
    product (not where it stores it), phase 3 is unchanged. A bf16 xw is
    widened where phase 1 reads it; the da buffer stays f32 for phase 3 (or
    the bf16 dW_hh^T), and dxw is it rounded to bf16, as phase 2 stores it.
    """
    ndir, B, T, h4 = xw.shape
    H = h4 // 4
    if B == 0 or T == 0:
        return torch.zeros_like(xw), torch.zeros_like(w_hh_t)
    res_bf16 = hs.dtype == torch.bfloat16
    w = _bf16(w_hh_t) if res_bf16 else w_hh_t
    hs, cs, dhs = hs.float(), cs.float(), dhs.float()
    h_prev = torch.cat([torch.zeros_like(hs[:, :, :1]), hs[:, :, :-1]], dim=2)
    h_in = _bf16(h_prev) if h_bf16 else h_prev
    dxw = _cell_activations(xw.float() + torch.matmul(h_in, w[:, None]), H)
    c_prev = torch.cat([torch.zeros_like(cs[:, :, :1]), cs[:, :, :-1]], dim=2)
    w_hh = w.transpose(-1, -2)
    for b0 in range(0, B, batch_block):
        rows = slice(b0, min(B, b0 + batch_block))
        dh_c = dc_c = hs.new_zeros((ndir, rows.stop - b0, H))
        for tt in range(T - 1, -1, -1):
            i, f, g, o = dxw[:, rows, tt].split(H, dim=-1)
            tc = torch.tanh(cs[:, rows, tt])
            dh = dhs[:, rows, tt] + dh_c
            do = dh * tc
            dct = dh * o * (1.0 - tc * tc) + dc_c
            dc_c = dct * f
            da = torch.cat([
                dct * g * i * (1.0 - i),
                dct * c_prev[:, rows, tt] * f * (1.0 - f),
                dct * i * (1.0 - g * g),
                do * o * (1.0 - o),
            ], dim=-1)
            dxw[:, rows, tt] = da
            dh_c = torch.matmul(_bf16(da) if res_bf16 else da, w_hh)
            if h_bf16:
                dh_c = _bf16(dh_c)
    if h_bf16:
        return dxw.to(xw.dtype), lstm_bidir_tm_dw_bf16_ref(hs, dxw)
    M = B * T
    if splits is None:
        splits = bwd_splits(M)
    chunk = -(-M // splits)
    hp, da = h_prev.reshape(ndir, M, H), dxw.reshape(ndir, M, 4 * H)
    dw = torch.zeros_like(w_hh_t)
    for r0 in range(0, M, chunk):
        dw = dw + torch.matmul(hp[:, r0:r0 + chunk].transpose(-1, -2), da[:, r0:r0 + chunk])
    return dxw.to(xw.dtype), dw


def _launch_bwd(route: str, xw, w_hh_t, hs, cs, dhs, h_bf16: bool = False):
    """Launch B2 bwd's ``route`` ("phases" or "grid") on checked, contiguous
    CUDA tensors; returns (dxw in xw's dtype, dw_hh_t). ``lstm_bidir_tm_bwd``
    picks the route by ``bwd_route``; the card script also times the other
    one. The form follows the dtypes (a bf16 xw; bf16 hs, cs, dhs) and
    ``h_bf16``: the bf16-h form's dxw, then its dW_hh^T from the kernel of
    ``lstm_bidir_tm_dw_bf16`` (which counts its launch)."""
    ndir, B, T, h4 = xw.shape
    H = h4 // 4
    dxw = torch.empty_like(xw)
    # da in f32, which dW_hh^T sums: dxw itself, or beside a bf16 dxw
    da = dxw if xw.dtype == torch.float32 else torch.empty(xw.shape, device=xw.device,
                                                           dtype=torch.float32)
    dxw_b = None if da is dxw else dxw
    # the bf16-h form writes dxw only: null dW_hh^T pointers
    dw = None if h_bf16 else torch.empty_like(w_hh_t)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    lib = _bwd_library()
    form = _form(h_bf16, xw, hs.dtype)
    inputs = [t.data_ptr() for t in (xw, w_hh_t, hs, cs, dhs)]
    outputs = (da.data_ptr(), ptr(dxw_b), ptr(dw))
    if route == "phases":
        splits = bwd_splits(B * T)
        scratch = dw if splits == 1 or h_bf16 else torch.empty(
            (splits,) + tuple(dw.shape), device=xw.device, dtype=torch.float32)
        err = lib.lstm_bidir_tm_bwd_phases_f32(*inputs, *outputs, ptr(scratch), ndir, B, T, H,
                                               splits, form, *launch_args(xw))
    else:
        err = lib.lstm_bidir_tm_bwd_grid_f32(*inputs, *outputs, ndir, B, T, H, form,
                                             *launch_args(xw))
    raise_on(err, "lstm_bidir_tm_bwd", lib.lstm_tm_bwd_error_string, route=route,
             ndir=ndir, B=B, T=T, H=H, form=form)
    if h_bf16:
        dw = lstm_bidir_tm_dw_bf16(hs, da)
    return dxw, dw


@costs.counted("B2 bwd dW_hh^T bf16", lambda hs, da: costs.dw_bf16_call_cost(hs))
def lstm_bidir_tm_dw_bf16(hs: torch.Tensor, da: torch.Tensor) -> torch.Tensor:
    """The bf16-h form's dW_hh^T: hs (ndir, B, T, H) and da (ndir, B, T, 4H)
    (the bf16-h backward's dxw), f32 -> dw_hh_t (ndir, H, 4H) f32 holding
    bf16 values, summed step by step in bf16 as the JAX package's reverse
    scan sums it (``lstm_bidir_tm_dw_bf16_ref``). On a CUDA tensor the kernel
    ``lstm_dw_bf16_kernel`` of ``lstm_dw_bf16.cu`` (any H and B, past
    ``DW_BF16_CHUNK_ROWS`` rows a step's rows in chunks; deterministic; its
    step sums in the tensor cores' order, ``lstm_bidir_tm_dw_bf16_model``),
    counted in
    ``lstm_bidir_tm_dw_bf16.launches``; on a CPU tensor the plain version."""
    if hs.dim() != 4 or da.dim() != 4 or da.shape[:3] != hs.shape[:3] or \
            da.shape[-1] != 4 * hs.shape[-1]:
        raise ValueError(f"hs must be (ndir, B, T, H) and da (ndir, B, T, 4H), got "
                         f"{tuple(hs.shape)} / {tuple(da.shape)}")
    if hs.dtype != torch.float32 or da.dtype != torch.float32 or hs.device != da.device:
        raise ValueError("lstm_bidir_tm_dw_bf16 takes f32 tensors on one device")
    if hs.device.type == "cpu":
        return lstm_bidir_tm_dw_bf16_ref(hs, da)
    if not (hs.is_contiguous() and da.is_contiguous()):
        raise ValueError("lstm_bidir_tm_dw_bf16 needs contiguous inputs")
    ndir, B, T, H = hs.shape
    dw = torch.empty((ndir, H, 4 * H), device=hs.device, dtype=torch.float32)
    if B == 0 or T == 0:
        return dw.zero_()
    lib = _dw_bf16_library()
    err = lib.lstm_dw_bf16_f32(hs.data_ptr(), da.data_ptr(), dw.data_ptr(), ndir, B, T, H,
                               *launch_args(hs))
    raise_on(err, "lstm_bidir_tm_dw_bf16", lib.lstm_dw_bf16_error_string, ndir=ndir, B=B,
             T=T, H=H)
    lstm_bidir_tm_dw_bf16.launches += 1
    return dw


@costs.counted("B2 bwd", lambda xw, w_hh_t, hs, cs, dhs, h_bf16=False:
               costs.b2_bwd_call_cost(xw, hs, h_bf16))
def lstm_bidir_tm_bwd(xw, w_hh_t, hs, cs, dhs, h_bf16: bool = False):
    """B2 bwd: the forward's inputs and residuals plus the cotangent ``dhs``
    -> (dxw (2, B, T, 4H) in xw's dtype, dw_hh_t (2, H, 4H) f32) (or a
    leading 1 throughout). Kernel on a CUDA tensor, on the route
    ``bwd_route(H)`` names (one call is one count in
    ``lstm_bidir_tm_bwd.launches`` and in ``lstm_bidir_tm_bwd.by_route``,
    whatever the number of launches inside; deterministic: the same inputs
    give the same bits), plain version on a CPU tensor. B = 0 or T = 0 gives
    zeros without a launch. ``h_bf16``: the VJP of the bf16-h form
    (``lstm_bidir_tm_bwd_ref``), also counted in ``lstm_bidir_tm_bwd.h_bf16``;
    its dW_hh^T is ``lstm_bidir_tm_dw_bf16``'s kernel, a launch of its own. A
    bf16 xw (counted in ``.xw_bf16``) gives a bf16 dxw; bf16 hs, cs and dhs
    run the bf16 residual form (``.res_bf16``)."""
    _check(xw, w_hh_t)
    _check_residuals(xw, hs, cs, dhs, h_bf16)
    if xw.device.type == "cpu":
        return lstm_bidir_tm_bwd_ref(xw, w_hh_t, hs, cs, dhs, h_bf16)
    tensors = (xw, w_hh_t, hs, cs, dhs)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lstm_bidir_tm_bwd needs contiguous inputs")
    _, B, T, h4 = xw.shape
    if B == 0 or T == 0:
        return torch.zeros_like(xw), torch.zeros_like(w_hh_t)
    route = bwd_route(h4 // 4)
    out = _launch_bwd(route, *tensors, h_bf16=h_bf16)
    lstm_bidir_tm_bwd.launches += 1
    lstm_bidir_tm_bwd.by_route[route] += 1
    lstm_bidir_tm_bwd.h_bf16 += h_bf16
    lstm_bidir_tm_bwd.xw_bf16 += xw.dtype == torch.bfloat16
    lstm_bidir_tm_bwd.res_bf16 += hs.dtype == torch.bfloat16
    return out


class LstmBidirTm(torch.autograd.Function):
    """The differentiable recurrence (the JAX custom VJP ``lstm_bidir_tm``):
    forward B2 fwd, saving (xw, w_hh_t, hs, cs) and returning hs in
    ``res_dtype``; backward B2 bwd on the contiguous cotangent, which arrives
    in hs's dtype; ``h_bf16`` runs both in their bf16-h form, a bf16 xw in
    the bf16 xw form (dxw in bf16). Kernels on CUDA tensors, plain versions
    on CPU tensors. Reach it through ``lstm_bidir_tm``, which runs B1 instead
    when no gradient is needed."""

    @staticmethod
    def forward(ctx, xw, w_hh_t, h_bf16=False, res_dtype=torch.float32):
        hs, cs = lstm_bidir_tm_fc(xw, w_hh_t, h_bf16, res_dtype)
        ctx.save_for_backward(xw, w_hh_t, hs, cs)
        ctx.h_bf16 = h_bf16
        return hs

    @staticmethod
    def backward(ctx, dhs):
        xw, w_hh_t, hs, cs = ctx.saved_tensors
        dxw, dw = lstm_bidir_tm_bwd(xw, w_hh_t, hs, cs, dhs.contiguous(), ctx.h_bf16)
        return (dxw if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None, None, None)


def lstm_bidir_bb_ref(xw: torch.Tensor, w_hh_t: torch.Tensor) -> torch.Tensor:
    """B6's plain version: the plain recurrence (an xw of either dtype, hs
    f32). Batch rows are independent, so how the kernel partitions them into
    batch blocks does not enter."""
    return _recurrence(xw, w_hh_t, with_cell=False)


def lstm_bidir_fused_ref(xs: torch.Tensor, w_ih_t: torch.Tensor, bias: torch.Tensor,
                         w_hh_t: torch.Tensor) -> torch.Tensor:
    """B7's plain version: the input projection, then the plain recurrence."""
    xw = torch.matmul(xs, w_ih_t[:, None]) + bias[:, None, None, :]
    return _recurrence(xw, w_hh_t, with_cell=False)


# widest layer the batch-blocked kernels take: a lane is a hidden unit and a
# block of the 8-block cluster keeps H / 8 units' columns of W_hh^T resident
BB_MAX_HIDDEN = CLUSTER_MAX_HIDDEN
# rows a cluster of lstm_bb_cluster.cu (B7) takes at most: what its shared
# memory leaves beside the projection's ring and staging (kMaxRows there)
FUSED_MAX_ROWS = 10
# B7's projection: a run covers rows * R <= 64 (row, step) pairs, and its sum
# over D goes in chunks of 32 inputs, each a fresh chain of k-steps of 8
RUN_PAIRS, PROJ_CHUNK, PROJ_KSTEP = 64, 32, 8


def bb_route(hidden: int, inputs: int = 0) -> Optional[str]:
    """The design B6 (``inputs`` 0) and B7 (``inputs`` = D) run on a CUDA
    tensor, by the shape alone: ``"cluster"`` for a hidden size that is a
    multiple of 8 up to 256 and any D (B6 on B1's ``lstm_tm_cluster.cu``, B7
    on ``lstm_bb_cluster.cu``), else None (no kernel takes it; the wrappers
    raise)."""
    ok = hidden % 8 == 0 and 0 < hidden <= BB_MAX_HIDDEN and inputs >= 0
    return "cluster" if ok else None


def bb_batch_block(batch: int, batch_block: int, clusters: int, fused: bool) -> int:
    """Rows a cluster takes under B6 (``lstm_tm_cluster.cu``, at most
    ``FWD_MAX_BATCH_BLOCK``) or B7 (``fused``: ``lstm_bb_cluster.cu``, at
    most ``FUSED_MAX_ROWS``): the caller's ``batch_block`` is an upper bound
    too, and within those the rows spread so that all ``2 * ceil(batch /
    rows)`` clusters fit the ``clusters`` the card holds at once, as
    ``fwd_batch_block`` does for B1."""
    cap = FUSED_MAX_ROWS if fused else FWD_MAX_BATCH_BLOCK
    per_dir = max(1, clusters // 2)
    return max(1, min(batch_block, cap, -(-batch // per_dir)))


def bb_run(rows: int) -> int:
    """B7's run length R: the steps whose projection one pass computes, so
    that rows * R (row, step) pairs fill ``RUN_PAIRS``."""
    return max(1, RUN_PAIRS // rows)


def _ordered_sum(h, w, lo, hi):
    """sum_{i = lo}^{hi - 1} h[..., i] * w[..., i, :] added one input at a time
    from the first product, as one mma chain sums them. Elementwise, so a
    row's bits do not depend on the other rows."""
    part = h[..., lo:lo + 1] * w[..., lo, :]
    for i in range(lo + 1, hi):
        part = part + h[..., i:i + 1] * w[..., i, :]
    return part


def _projection_run(xs, w_ih_t, bias):
    """B7's projection of one run, as the kernel sums it: for (row, step)
    pairs xs (ndir, rows, R, D), bias plus the chunks of ``PROJ_CHUNK`` inputs
    in order, each chunk a fresh chain of k-steps of ``PROJ_KSTEP`` inputs."""
    D = xs.shape[-1]
    w = w_ih_t[:, None, None]
    out = bias[:, None, None, :].expand(*xs.shape[:-1], bias.shape[-1])
    for c0 in range(0, D, PROJ_CHUNK):
        part = None
        for k0 in range(c0, min(D, c0 + PROJ_CHUNK), PROJ_KSTEP):
            step = _ordered_sum(xs, w, k0, min(D, k0 + PROJ_KSTEP))
            part = step if part is None else part + step
        out = out + part
    return out


def lstm_bidir_bb_model(xw: torch.Tensor, w_hh_t: torch.Tensor,
                        batch_block: int = FWD_MAX_BATCH_BLOCK) -> torch.Tensor:
    """B6 as its route runs it (the function of ``lstm_bidir_bb_ref``): B1's
    cluster kernel, so ``lstm_bidir_tm_fwd_model`` with each block of
    ``batch_block`` rows its own recurrence. A row's sums never depend on the
    other rows, so the bits do not depend on the batch block.
    (2, B, T, 4H), (2, H, 4H) -> hs (2, B, T, H) f32."""
    return lstm_bidir_tm_fwd_model(xw, w_hh_t, batch_block=batch_block)


def lstm_bidir_fused_model(xs: torch.Tensor, w_ih_t: torch.Tensor, bias: torch.Tensor,
                           w_hh_t: torch.Tensor, batch_block: int = FUSED_MAX_ROWS,
                           run: Optional[int] = None) -> torch.Tensor:
    """B7 as ``lstm_bb_cluster.cu`` runs it (the function of
    ``lstm_bidir_fused_ref``): the projection of each run of ``run`` steps
    (default ``bb_run(batch_block)``) as ``_projection_run`` sums it, then
    the recurrence of each block of ``batch_block`` rows with B1's step
    product and cell (``lstm_bidir_tm_fwd_model``), which the kernel shares.
    The run length only moves the projection in time, never a sum, so the
    bits depend on neither it nor the batch block."""
    run = bb_run(batch_block) if run is None else run
    T = xs.shape[2]
    runs = [_projection_run(xs[:, :, t0:t0 + run].float(), w_ih_t.float(), bias.float())
            for t0 in range(0, T, run)]
    xw = (torch.cat(runs, dim=2) if runs
          else xs.new_zeros((*xs.shape[:3], w_ih_t.shape[-1]), dtype=torch.float32))
    return lstm_bidir_tm_fwd_model(xw, w_hh_t, batch_block=batch_block)


def _bb_cluster_library():
    lib = load("lstm_bb_cluster")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_bb_cluster_f32.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.lstm_bb_cluster_f32.restype = i
    lib.lstm_bb_cluster_max_clusters.argtypes = [i, ctypes.POINTER(i)]
    lib.lstm_bb_cluster_max_clusters.restype = i
    lib.lstm_bb_cluster_error_string.argtypes = [i]
    lib.lstm_bb_cluster_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _fused_clusters(device_index: int) -> int:
    """Clusters of ``lstm_bb_cluster.cu`` that the card holds at once."""
    lib = _bb_cluster_library()
    out = ctypes.c_int(0)
    err = lib.lstm_bb_cluster_max_clusters(device_index, ctypes.byref(out))
    raise_on(err, "lstm_bb_cluster_max_clusters", lib.lstm_bb_cluster_error_string,
             device=device_index)
    if out.value < 1:
        raise RuntimeError(f"no cluster of lstm_bb_cluster fits device {device_index}")
    return out.value


def _launch_fused(xs, w_ih_t, bias, w_hh_t, batch_block: int):
    """Launch B7 (``lstm_bb_cluster.cu``) on checked, contiguous CUDA tensors
    with B, T, D > 0, at ``bb_batch_block`` rows a cluster; returns hs."""
    _, B, T, D = xs.shape
    H = w_hh_t.shape[-2]
    rows = bb_batch_block(B, batch_block, _fused_clusters(launch_args(xs)[0]), fused=True)
    hs = torch.empty((2, B, T, H), device=xs.device, dtype=torch.float32)
    lib = _bb_cluster_library()
    err = lib.lstm_bb_cluster_f32(*(t.data_ptr() for t in (xs, w_ih_t, bias, w_hh_t, hs)),
                                  B, T, H, D, rows, *launch_args(xs))
    raise_on(err, "lstm_bidir_fused", lib.lstm_bb_cluster_error_string, B=B, T=T, H=H, D=D,
             rows=rows)
    return hs


def _check_bb(name: str, tensors, batch_block: int, H: int, D: int = 0):
    if batch_block < 1:
        raise ValueError(f"batch_block must be at least 1, got {batch_block}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only: take lstm_bidir_tm (LstmBidirTm) where a "
            "gradient is needed")
    if tensors[0].device.type == "cpu":
        return
    if bb_route(H, D) is None:
        raise ValueError(
            f"{name} takes a hidden size that is a multiple of 8 and at most "
            f"{BB_MAX_HIDDEN} on a CUDA tensor, got {H}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")


@costs.counted("B6", lambda xw, w_hh_t, batch_block=32:
               costs.b1_call_cost(xw, w_hh_t, cls="tf32x3"))
def lstm_bidir_bb(xw: torch.Tensor, w_hh_t: torch.Tensor, batch_block: int = 32) -> torch.Tensor:
    """B6: (2, B, T, 4H), (2, H, 4H) -> hs (2, B, T, H), all f32: the function
    of ``lstm_bidir_tm``, each block of rows an independent recurrence, run
    on B1's cluster kernel (``lstm_tm_cluster.cu``). ``batch_block`` is an
    upper bound on the rows a block takes (so is ``FWD_MAX_BATCH_BLOCK``);
    within it the rows spread so that every cluster runs at once
    (``bb_batch_block``). Rows are independent and a row's sums do not depend
    on the others, so the result does not depend on ``batch_block`` (it is
    B1's, bit for bit); no caller in the package sets it. A bf16 xw runs the
    bf16 xw form, as the JAX package's ``lstm_bidir_pallas`` reads it; hs is
    f32.

    Forward-only: raises when a gradient is needed. On a CUDA tensor the
    kernel of route ``bb_route(H)``, counted in ``lstm_bidir_bb.launches``
    and ``.by_route`` (a bf16 xw also in ``.xw_bf16``); on a CPU tensor the
    plain version."""
    _check(xw, w_hh_t, dirs=(2,))
    _, B, T, h4 = xw.shape
    H = h4 // 4
    _check_bb("lstm_bidir_bb", (xw, w_hh_t), batch_block, H)
    if xw.device.type == "cpu":
        return lstm_bidir_bb_ref(xw, w_hh_t)
    if B == 0 or T == 0:
        return torch.empty((2, B, T, H), device=xw.device, dtype=torch.float32)
    rows = bb_batch_block(B, batch_block, _fwd_clusters(launch_args(xw)[0]), fused=False)
    hs = _launch_fwd("cluster", xw, w_hh_t, batch_block=rows)
    lstm_bidir_bb.launches += 1
    lstm_bidir_bb.by_route["cluster"] += 1
    lstm_bidir_bb.xw_bf16 += xw.dtype == torch.bfloat16
    return hs


@costs.counted("B7", lambda xs, w_ih_t, bias, w_hh_t, batch_block=32:
               costs.fused_call_cost(xs, w_hh_t))
def lstm_bidir_fused(xs: torch.Tensor, w_ih_t: torch.Tensor, bias: torch.Tensor,
                     w_hh_t: torch.Tensor, batch_block: int = 32) -> torch.Tensor:
    """B7: xs (2, B, T, D) direction-stacked inputs (direction 1 already
    time-flipped), w_ih_t (2, D, 4H), bias (2, 4H) = b_ih + b_hh, w_hh_t
    (2, H, 4H) -> hs (2, B, T, H), all f32. The input projection happens
    inside the kernel, a run of steps ahead; no (2, B, T, 4H) tensor is
    written. ``batch_block`` as for ``lstm_bidir_bb`` (B7 takes at most
    ``FUSED_MAX_ROWS`` rows a block beside its projection's buffers).

    Forward-only: raises when a gradient is needed. On a CUDA tensor the
    kernel of route ``bb_route(H, D)``, counted in
    ``lstm_bidir_fused.launches`` and ``.by_route``; on a CPU tensor the
    plain version."""
    if xs.dim() != 4 or xs.shape[0] != 2:
        raise ValueError(f"xs must be (2, B, T, D), got {tuple(xs.shape)}")
    _, B, T, D = xs.shape
    if w_hh_t.dim() != 3 or w_hh_t.shape[-1] != 4 * w_hh_t.shape[-2]:
        raise ValueError(f"w_hh_t must be (2, H, 4H), got {tuple(w_hh_t.shape)}")
    H = w_hh_t.shape[-2]
    want = {"w_ih_t": (2, D, 4 * H), "bias": (2, 4 * H), "w_hh_t": (2, H, 4 * H)}
    tensors = (xs, w_ih_t, bias, w_hh_t)
    for (name, shape), t in zip(want.items(), tensors[1:]):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} for xs {tuple(xs.shape)}, "
                             f"got {tuple(t.shape)}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("lstm_bidir_fused takes f32 tensors, got "
                         + " / ".join(str(t.dtype) for t in tensors))
    if any(t.device != xs.device for t in tensors):
        raise ValueError("lstm_bidir_fused needs all inputs on one device")
    if xs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm_bidir_fused runs on cpu or cuda, not {xs.device}")
    _check_bb("lstm_bidir_fused", tensors, batch_block, H, D)
    if xs.device.type == "cpu":
        return lstm_bidir_fused_ref(xs, w_ih_t, bias, w_hh_t)
    if B == 0 or T == 0:
        return torch.empty((2, B, T, H), device=xs.device, dtype=torch.float32)
    if D == 0:
        raise ValueError("lstm_bidir_fused takes D >= 1 on a CUDA tensor")
    hs = _launch_fused(xs, w_ih_t, bias, w_hh_t, batch_block)
    lstm_bidir_fused.launches += 1
    lstm_bidir_fused.by_route["cluster"] += 1
    return hs


# kernel launches since the last reset (chip_smoke.py reads them to show that
# the main path went through the kernels)
lstm_bidir_tm.launches = 0
lstm_bidir_tm.by_route = {"cluster": 0, "grid": 0}
lstm_bidir_tm.carried = 0
lstm_bidir_tm.h_bf16 = lstm_bidir_tm.xw_bf16 = lstm_bidir_tm.hs_bf16 = 0
lstm_bidir_tm.gates_bf16 = lstm_bidir_tm.xw_int8 = 0
lstm_bidir_tm_fc.launches = 0
lstm_bidir_tm_fc.by_route = {"cluster": 0, "grid": 0}
lstm_bidir_tm_fc.h_bf16 = lstm_bidir_tm_fc.xw_bf16 = lstm_bidir_tm_fc.res_bf16 = 0
lstm_bidir_tm_bwd.launches = 0
lstm_bidir_tm_bwd.by_route = {"phases": 0, "grid": 0}
lstm_bidir_tm_bwd.h_bf16 = lstm_bidir_tm_bwd.xw_bf16 = lstm_bidir_tm_bwd.res_bf16 = 0
lstm_bidir_tm_dw_bf16.launches = 0
lstm_bidir_bb.launches = 0
lstm_bidir_bb.by_route = {"cluster": 0}
lstm_bidir_bb.xw_bf16 = 0
lstm_bidir_fused.launches = 0
lstm_bidir_fused.by_route = {"cluster": 0}
