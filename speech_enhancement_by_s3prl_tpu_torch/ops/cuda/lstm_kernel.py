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

A CPU tensor takes the plain versions. A CUDA tensor launches the kernel or
raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ._build import launch_args, load, raise_on


def _recurrence(xw: torch.Tensor, w_hh_t: torch.Tensor, with_cell: bool):
    H = w_hh_t.shape[-2]
    lead = xw.shape[:-2]  # (..., B)
    h = xw.new_zeros(lead + (H,), dtype=torch.float32)
    c = torch.zeros_like(h)
    hs, cs = [h[..., None, :][..., :0, :]], [c[..., None, :][..., :0, :]]  # T = 0
    for t in range(xw.shape[-2]):
        gates = xw[..., t, :].float() + torch.matmul(h, w_hh_t)
        i, f, g, o = gates.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h[..., None, :])
        cs.append(c[..., None, :])
    hs = torch.cat(hs, dim=-2)
    return (hs, torch.cat(cs, dim=-2)) if with_cell else hs


def lstm_bidir_tm_ref(xw: torch.Tensor, w_hh_t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch recurrence (B1's plain version): a Python loop over time.

    Works for any leading axes: xw (..., B, T, 4H) with w_hh_t (..., H, 4H)
    gives (..., B, T, H)."""
    return _recurrence(xw, w_hh_t, with_cell=False)


def lstm_bidir_tm_fc_ref(xw: torch.Tensor, w_hh_t: torch.Tensor):
    """B2 fwd's plain version: (hs, cs), each (2, B, T, H) f32."""
    return _recurrence(xw, w_hh_t, with_cell=True)


def lstm_bidir_tm_bwd_ref(xw, w_hh_t, hs, cs, dhs):
    """B2 bwd's plain version, step for step the Pallas ``_kernel_tm_bwd``:
    reverse time, gates recomputed from (xw_t, h_{t-1}), h_{-1} = c_{-1} = 0,
    dh and dc carried. Returns (dxw (2, B, T, 4H), dw_hh_t (2, H, 4H)), f32."""
    H = w_hh_t.shape[-2]
    T = xw.shape[-2]
    dh_c = hs.new_zeros(hs.shape[:-2] + (H,))
    dc_c = torch.zeros_like(dh_c)
    dw = torch.zeros(w_hh_t.shape, dtype=torch.float32, device=xw.device)
    dxw = [xw.new_zeros(xw.shape[:-2] + (0, 4 * H), dtype=torch.float32)] + [None] * T
    for tt in range(T - 1, -1, -1):
        h_prev = hs[..., tt - 1, :] if tt > 0 else torch.zeros_like(dh_c)
        c_prev = cs[..., tt - 1, :] if tt > 0 else torch.zeros_like(dh_c)
        gates = xw[..., tt, :].float() + torch.matmul(h_prev, w_hh_t)
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
        dxw[tt + 1] = da[..., None, :]
        dh_c = torch.matmul(da, w_hh_t.transpose(-1, -2))
        dw = dw + torch.matmul(h_prev.transpose(-1, -2), da)
    return torch.cat(dxw, dim=-2), dw


def _check(xw: torch.Tensor, w_hh_t: torch.Tensor, dirs=(1, 2)):
    """``dirs``: the direction counts (leading axis) the caller's kernel takes."""
    if xw.dim() != 4 or xw.shape[0] not in dirs or xw.shape[-1] % 4:
        raise ValueError(f"xw must be ({' or '.join(map(str, dirs))}, B, T, 4H), "
                         f"got {tuple(xw.shape)}")
    ndir, H = xw.shape[0], xw.shape[-1] // 4
    if tuple(w_hh_t.shape) != (ndir, H, 4 * H):
        raise ValueError(
            f"w_hh_t must be ({ndir}, {H}, {4 * H}) for xw {tuple(xw.shape)}, "
            f"got {tuple(w_hh_t.shape)}"
        )
    if xw.dtype != torch.float32 or w_hh_t.dtype != torch.float32:
        raise ValueError(
            f"lstm_bidir_tm takes f32 tensors, got {xw.dtype} / {w_hh_t.dtype}"
        )
    if xw.device != w_hh_t.device:
        raise ValueError(f"xw on {xw.device} but w_hh_t on {w_hh_t.device}")
    if xw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm_bidir_tm runs on cpu or cuda, not {xw.device}")


def _check_residuals(xw, hs, cs, dhs):
    ndir, B, T, h4 = xw.shape
    want = (ndir, B, T, h4 // 4)
    for name, t in (("hs", hs), ("cs", cs), ("dhs", dhs)):
        if tuple(t.shape) != want or t.dtype != torch.float32 or t.device != xw.device:
            raise ValueError(
                f"{name} must be f32 {want} on {xw.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )


def _library():
    lib = load("lstm_tm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_bidir_tm_f32.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.lstm_bidir_tm_f32.restype = i
    lib.lstm_bidir_tm_fc_f32.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.lstm_bidir_tm_fc_f32.restype = i
    lib.lstm_tm_error_string.argtypes = [i]
    lib.lstm_tm_error_string.restype = ctypes.c_char_p
    return lib


def _cluster_library():
    lib = load("lstm_tm_cluster")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_tm_cluster_f32.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.lstm_tm_cluster_f32.restype = i
    lib.lstm_tm_cluster_fc_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.lstm_tm_cluster_fc_f32.restype = i
    lib.lstm_tm_cluster_max_clusters.argtypes = [i, ctypes.POINTER(i)]
    lib.lstm_tm_cluster_max_clusters.restype = i
    lib.lstm_tm_cluster_error_string.argtypes = [i]
    lib.lstm_tm_cluster_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_library():
    lib = load("lstm_tm_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_bidir_tm_bwd_grid_f32.argtypes = [p] * 7 + [i, i, i, i, i, p]
    lib.lstm_bidir_tm_bwd_grid_f32.restype = i
    lib.lstm_bidir_tm_bwd_phases_f32.argtypes = [p] * 8 + [i, i, i, i, i, i, p]
    lib.lstm_bidir_tm_bwd_phases_f32.restype = i
    lib.lstm_tm_bwd_error_string.argtypes = [i]
    lib.lstm_tm_bwd_error_string.restype = ctypes.c_char_p
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
                            slices: int = FWD_SLICES, with_cell: bool = False):
    """The ``cluster`` route of B1 / B2 fwd in PyTorch, as
    ``lstm_tm_cluster.cu`` runs it (the function of ``lstm_bidir_tm_ref``):
    each block of ``batch_block`` rows is its own recurrence; h is padded with
    zeros to ``max(H, CLUSTER_MAX_HIDDEN)`` inputs, cut into ``slices`` runs
    of consecutive inputs (the kernel: 16 runs of 16, a warp a run); at every
    step a slice's partial gates are summed one input at a time, the gates
    are xw plus the partials in slice order (a slice wholly past H adds
    nothing), and the cell runs row by row. Every operation acts on one row
    at a time or elementwise, so a row's bits do not depend on the other rows
    of its block. Returns hs, or (hs, cs) with ``with_cell``, each
    (ndir, B, T, H) f32."""
    ndir, B, T, h4 = xw.shape
    H = h4 // 4
    hs = xw.new_zeros((ndir, B, T, H), dtype=torch.float32)
    cs = torch.zeros_like(hs)
    span = -(-max(H, CLUSTER_MAX_HIDDEN) // slices)
    for b0 in range(0, B, batch_block):
        rows = range(b0, min(B, b0 + batch_block))
        h = xw.new_zeros((ndir, len(rows), H), dtype=torch.float32)
        c = torch.zeros_like(h)
        for t in range(T):
            gates = xw[:, b0:rows.stop, t].float()
            for s in range(-(-H // span)):
                part = torch.zeros_like(gates)
                for i in range(s * span, min(H, (s + 1) * span)):
                    part = part + h[:, :, i:i + 1] * w_hh_t[:, None, i, :]
                gates = gates + part
            h, c = h.clone(), c.clone()
            for d in range(ndir):
                for r in range(len(rows)):
                    i, f, g, o = gates[d, r].split(H)
                    c[d, r] = torch.sigmoid(f) * c[d, r] + torch.sigmoid(i) * torch.tanh(g)
                    h[d, r] = torch.sigmoid(o) * torch.tanh(c[d, r])
            hs[:, b0:rows.stop, t] = h
            cs[:, b0:rows.stop, t] = c
    return (hs, cs) if with_cell else hs


def _launch_fwd(route: str, xw, w_hh_t, with_cell: bool = False,
                batch_block: Optional[int] = None, variant: int = 0):
    """Launch B1 (or B2 fwd with ``with_cell``) on ``route`` ("cluster" or
    "grid") on checked, contiguous CUDA tensors with B, T > 0; returns hs or
    (hs, cs). ``lstm_bidir_tm`` / ``lstm_bidir_tm_fc`` pick the route by
    ``fwd_route`` and the batch block by ``fwd_batch_block``; the card script
    also runs the other route, other batch blocks and, through ``variant``
    (B1 on the cluster route only), the design with one element changed
    (``FWD_VARIANTS``)."""
    ndir, B, T, h4 = xw.shape
    H = h4 // 4
    hs = torch.empty((ndir, B, T, H), device=xw.device, dtype=torch.float32)
    cs = torch.empty_like(hs) if with_cell else None
    ptrs = (xw.data_ptr(), w_hh_t.data_ptr(), hs.data_ptr())
    if route == "cluster":
        lib = _cluster_library()
        if batch_block is None:
            batch_block = fwd_batch_block(B, ndir, _fwd_clusters(launch_args(xw)[0]))
        if with_cell:
            err = lib.lstm_tm_cluster_fc_f32(*ptrs, cs.data_ptr(), ndir, B, T, H, batch_block,
                                             *launch_args(xw))
        else:
            err = lib.lstm_tm_cluster_f32(*ptrs, ndir, B, T, H, batch_block, variant,
                                          *launch_args(xw))
        errstr = lib.lstm_tm_cluster_error_string
    else:
        lib = _library()
        if with_cell:
            err = lib.lstm_bidir_tm_fc_f32(*ptrs, cs.data_ptr(), ndir, B, T, H,
                                           *launch_args(xw))
        else:
            err = lib.lstm_bidir_tm_f32(*ptrs, ndir, B, T, H, *launch_args(xw))
        errstr = lib.lstm_tm_error_string
    raise_on(err, "lstm_bidir_tm_fc" if with_cell else "lstm_bidir_tm", errstr, route=route,
             ndir=ndir, B=B, T=T, H=H, batch_block=batch_block, variant=variant)
    return (hs, cs) if with_cell else hs


def lstm_bidir_tm(xw: torch.Tensor, w_hh_t: torch.Tensor) -> torch.Tensor:
    """(2, B, T, 4H), (2, H, 4H) -> hs (2, B, T, H), all f32; a leading 1
    in place of the 2 is a one-direction layer.

    When a gradient is needed (grad mode on and an input that requires it)
    this is ``LstmBidirTm``: B2 fwd now, B2 bwd in the backward pass.
    Otherwise it is B1 (the primal of the JAX custom VJP): on a CUDA tensor
    the kernel of route ``fwd_route(H)``, counted in ``lstm_bidir_tm.launches``
    and ``lstm_bidir_tm.by_route``; on a CPU tensor the plain version."""
    _check(xw, w_hh_t)
    if torch.is_grad_enabled() and (xw.requires_grad or w_hh_t.requires_grad):
        return LstmBidirTm.apply(xw, w_hh_t)
    if xw.device.type == "cpu":
        return lstm_bidir_tm_ref(xw, w_hh_t)
    if not (xw.is_contiguous() and w_hh_t.is_contiguous()):
        raise ValueError("lstm_bidir_tm needs contiguous xw and w_hh_t")
    ndir, B, T, h4 = xw.shape
    if B == 0 or T == 0:
        return torch.empty((ndir, B, T, h4 // 4), device=xw.device, dtype=torch.float32)
    route = fwd_route(h4 // 4)
    hs = _launch_fwd(route, xw, w_hh_t)
    lstm_bidir_tm.launches += 1
    lstm_bidir_tm.by_route[route] += 1
    return hs


def lstm_bidir_tm_fc(xw: torch.Tensor, w_hh_t: torch.Tensor):
    """B2 fwd: (2, B, T, 4H), (2, H, 4H) -> (hs, cs), each (2, B, T, H) f32.
    Kernel of route ``fwd_route(H)`` on a CUDA tensor (counted in
    ``lstm_bidir_tm_fc.launches`` and ``.by_route``), plain version on a CPU
    tensor."""
    _check(xw, w_hh_t)
    if xw.device.type == "cpu":
        return lstm_bidir_tm_fc_ref(xw, w_hh_t)
    if not (xw.is_contiguous() and w_hh_t.is_contiguous()):
        raise ValueError("lstm_bidir_tm_fc needs contiguous xw and w_hh_t")
    ndir, B, T, h4 = xw.shape
    if B == 0 or T == 0:
        hs = torch.empty((ndir, B, T, h4 // 4), device=xw.device, dtype=torch.float32)
        return hs, torch.empty_like(hs)
    route = fwd_route(h4 // 4)
    out = _launch_fwd(route, xw, w_hh_t, with_cell=True)
    lstm_bidir_tm_fc.launches += 1
    lstm_bidir_tm_fc.by_route[route] += 1
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
                            splits: Optional[int] = None):
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
    """
    ndir, B, T, h4 = xw.shape
    H = h4 // 4
    if B == 0 or T == 0:
        return torch.zeros_like(xw), torch.zeros_like(w_hh_t)
    h_prev = torch.cat([torch.zeros_like(hs[:, :, :1]), hs[:, :, :-1]], dim=2)
    dxw = _cell_activations(xw + torch.matmul(h_prev, w_hh_t[:, None]), H)
    c_prev = torch.cat([torch.zeros_like(cs[:, :, :1]), cs[:, :, :-1]], dim=2)
    w_hh = w_hh_t.transpose(-1, -2)
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
            dh_c = torch.matmul(da, w_hh)
    M = B * T
    if splits is None:
        splits = bwd_splits(M)
    chunk = -(-M // splits)
    hp, da = h_prev.reshape(ndir, M, H), dxw.reshape(ndir, M, 4 * H)
    dw = torch.zeros_like(w_hh_t)
    for r0 in range(0, M, chunk):
        dw = dw + torch.matmul(hp[:, r0:r0 + chunk].transpose(-1, -2), da[:, r0:r0 + chunk])
    return dxw, dw


def _launch_bwd(route: str, xw, w_hh_t, hs, cs, dhs):
    """Launch B2 bwd's ``route`` ("phases" or "grid") on checked, contiguous
    CUDA tensors; returns (dxw, dw_hh_t). ``lstm_bidir_tm_bwd`` picks the
    route by ``bwd_route``; the card script also times the other one."""
    ndir, B, T, h4 = xw.shape
    H = h4 // 4
    dxw = torch.empty_like(xw)
    dw = torch.empty_like(w_hh_t)
    lib = _bwd_library()
    inputs = [t.data_ptr() for t in (xw, w_hh_t, hs, cs, dhs)]
    if route == "phases":
        splits = bwd_splits(B * T)
        scratch = dw if splits == 1 else torch.empty(
            (splits,) + tuple(dw.shape), device=xw.device, dtype=torch.float32)
        err = lib.lstm_bidir_tm_bwd_phases_f32(
            *inputs, dxw.data_ptr(), dw.data_ptr(), scratch.data_ptr(), ndir, B, T, H,
            splits, *launch_args(xw))
    else:
        err = lib.lstm_bidir_tm_bwd_grid_f32(*inputs, dxw.data_ptr(), dw.data_ptr(), ndir,
                                             B, T, H, *launch_args(xw))
    raise_on(err, "lstm_bidir_tm_bwd", lib.lstm_tm_bwd_error_string, route=route,
             ndir=ndir, B=B, T=T, H=H)
    return dxw, dw


def lstm_bidir_tm_bwd(xw, w_hh_t, hs, cs, dhs):
    """B2 bwd: the forward's inputs and residuals plus the cotangent ``dhs``
    -> (dxw (2, B, T, 4H), dw_hh_t (2, H, 4H)), f32 (or a leading 1
    throughout). Kernel on a CUDA tensor, on the route ``bwd_route(H)`` names
    (one call is one count in ``lstm_bidir_tm_bwd.launches`` and in
    ``lstm_bidir_tm_bwd.by_route``, whatever the number of launches inside;
    deterministic: the same inputs give the same bits), plain version on a
    CPU tensor. B = 0 or T = 0 gives zeros without a launch."""
    _check(xw, w_hh_t)
    _check_residuals(xw, hs, cs, dhs)
    if xw.device.type == "cpu":
        return lstm_bidir_tm_bwd_ref(xw, w_hh_t, hs, cs, dhs)
    tensors = (xw, w_hh_t, hs, cs, dhs)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lstm_bidir_tm_bwd needs contiguous inputs")
    _, B, T, h4 = xw.shape
    if B == 0 or T == 0:
        return torch.zeros_like(xw), torch.zeros_like(w_hh_t)
    route = bwd_route(h4 // 4)
    out = _launch_bwd(route, *tensors)
    lstm_bidir_tm_bwd.launches += 1
    lstm_bidir_tm_bwd.by_route[route] += 1
    return out


class LstmBidirTm(torch.autograd.Function):
    """The differentiable recurrence (the JAX custom VJP ``lstm_bidir_tm``):
    forward B2 fwd, saving (xw, w_hh_t, hs, cs); backward B2 bwd on the
    contiguous cotangent. Kernels on CUDA tensors, plain versions on CPU
    tensors. Reach it through ``lstm_bidir_tm``, which runs B1 instead when
    no gradient is needed."""

    @staticmethod
    def forward(ctx, xw, w_hh_t):
        hs, cs = lstm_bidir_tm_fc(xw, w_hh_t)
        ctx.save_for_backward(xw, w_hh_t, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        xw, w_hh_t, hs, cs = ctx.saved_tensors
        dxw, dw = lstm_bidir_tm_bwd(xw, w_hh_t, hs, cs, dhs.contiguous())
        return (dxw if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None)


def lstm_bidir_bb_ref(xw: torch.Tensor, w_hh_t: torch.Tensor) -> torch.Tensor:
    """B6's plain version: the plain recurrence. Batch rows are independent,
    so how the kernel partitions them into batch blocks does not enter."""
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


def lstm_bidir_bb(xw: torch.Tensor, w_hh_t: torch.Tensor, batch_block: int = 32) -> torch.Tensor:
    """B6: (2, B, T, 4H), (2, H, 4H) -> hs (2, B, T, H), all f32: the function
    of ``lstm_bidir_tm``, each block of rows an independent recurrence, run
    on B1's cluster kernel (``lstm_tm_cluster.cu``). ``batch_block`` is an
    upper bound on the rows a block takes (so is ``FWD_MAX_BATCH_BLOCK``);
    within it the rows spread so that every cluster runs at once
    (``bb_batch_block``). Rows are independent and a row's sums do not depend
    on the others, so the result does not depend on ``batch_block`` (it is
    B1's, bit for bit); no caller in the package sets it.

    Forward-only: raises when a gradient is needed. On a CUDA tensor the
    kernel of route ``bb_route(H)``, counted in ``lstm_bidir_bb.launches``
    and ``.by_route``; on a CPU tensor the plain version."""
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
    return hs


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
lstm_bidir_tm_fc.launches = 0
lstm_bidir_tm_fc.by_route = {"cluster": 0, "grid": 0}
lstm_bidir_tm_bwd.launches = 0
lstm_bidir_tm_bwd.by_route = {"phases": 0, "grid": 0}
lstm_bidir_bb.launches = 0
lstm_bidir_bb.by_route = {"cluster": 0}
lstm_bidir_fused.launches = 0
lstm_bidir_fused.by_route = {"cluster": 0}
