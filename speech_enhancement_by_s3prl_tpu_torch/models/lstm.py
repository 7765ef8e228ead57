"""Multi-layer (bi)LSTM (counterpart of
``speech_enhancement_by_s3prl_tpu/models/lstm.py``).

- The input projection of a layer is computed once for all steps; only
  h @ W_hh runs inside the recurrence.
- A bidirectional layer runs both directions in one recurrence: direction 1
  gets the time-flipped input on a leading direction axis. A one-direction
  layer runs the same recurrence with a direction axis of 1 (the JAX package
  runs a ``lax.scan`` cell there). A one-direction stack also continues from
  a carried state: ``forward(x, initial_state=, return_state=True)`` takes
  one (h, c) per layer, each (B, H), and returns the final ones beside the
  output, as the JAX stack does for streaming (kernel B1 with its state in
  and out; inference only). A bidirectional stack refuses a state.
  The recurrence is ``ops/cuda/lstm_kernel.lstm_bidir_tm``: under autograd the
  ``LstmBidirTm`` function (kernels B2 fwd / B2 bwd on a CUDA tensor), whose
  gradients reach ``w_hh`` through dW_hh^T and ``w_ih``, ``b_ih``, ``b_hh``
  through the projection; otherwise kernel B1. A CPU tensor takes the plain
  versions on either route.
- ``recurrence`` picks the kernel a bidirectional layer runs when no gradient
  is needed: ``"tm"`` (B1, the default), ``"blocked"`` (B6,
  ``lstm_bidir_bb``: the JAX package's batch-blocked route) or ``"fused"``
  (B7, ``lstm_bidir_fused``: the input projection inside the kernel). B6 and
  B7 are forward-only, so under autograd every route is ``LstmBidirTm``. The
  parameters are the same under all three. It is a switch of this class
  alone, for the tests and the card script that hold B6 and B7 against the
  JAX package's ``lstm_bidir_pallas`` and ``lstm_bidir_pallas_fused``: no
  builder takes it, so every head, trainer and enhancer runs ``"tm"``, which
  takes every hidden size. B6 runs B1's own kernel, and B7 is slower than the
  projection plus B1 at every measured shape (``PERF.md``). The attribute
  may be set on a built stack (``head.lstm.recurrence = "blocked"``).
- Parameters are in torch layout with gate order i, f, g, o, under
  ``l{k}_fwd`` / ``l{k}_bwd`` with ``w_ih``, ``w_hh``, ``b_ih``, ``b_hh``.
- Sequences run fully padded, as the JAX package runs them: the backward
  direction of a padded batch sees the padding.
- A forward handed a :class:`Capture` records the streams of the layers it
  selects (``layer``: a layer index or ``"all"``) for the per-sample
  gradient scorer (``active/sampler.py``): ``l{k}_xs``, the layer's input on
  a leading direction axis (2 or 1, B, T, D; direction 1 time-flipped),
  ``l{k}_xw``, its input projection (2 or 1, B, T, 4H), the very tensor the
  recurrence reads, so that its gradient under one batched backward is the
  per-sample, per-step gate cotangent (B2 bwd's dxw on the card), and
  ``l{k}_hs``, the recurrence's output (2 or 1, B, T, H). The JAX modules'
  ``capture_layer`` is this per-call selection. With no ``capture`` nothing
  is recorded.

- ``compute_dtype`` bf16 (``--compute_dtype bf16``) is, for a bidirectional
  layer, the JAX package's layer on its Pallas path (``models/lstm.py:272-338``,
  the path the port's kernels are the counterpart of): the projection takes
  the input and W_ih rounded to bf16 and returns their f32 product (exact
  products summed in f32, ``einsum(..., preferred_element_type=f32)``) plus
  the f32 bias; W_hh^T is rounded to bf16 and handed to the recurrence as
  f32; h and c stay f32, so B1 / B2 fwd / B2 bwd run unchanged. On the card
  the projection is one bf16 GEMM with an f32 output. A gradient reaching an
  f32 parameter through a bf16 rounding comes back rounded to bf16, as the
  transpose of JAX's ``convert_element_type`` gives it. JAX's default scan
  path (no ``SE_PALLAS_LSTM``) rounds h to bf16 every step instead; it is
  not the reference for a bidirectional layer. A one-direction layer has no
  other JAX form than that scan cell (``LstmCellScan``), so there it is the
  reference: the same projection and bf16 W_hh^T, and the recurrence in its
  bf16-h form (``lstm_bidir_tm(..., h_bf16=True)``: h rounded to bf16 for
  the step product, B1 / B2 fwd / B2 bwd with their flag and dW_hh^T summed
  step by step in bf16), stateless or from a carried state.
- The JAX package's stream forms of its LSTM kernels, read from the same
  environment variables at forward time (JAX reads them at trace time,
  ``models/lstm.py:40-52`` and ``ops/pallas/lstm_kernel.py``), as
  ``stream_forms`` returns them (``LstmForms``). ``SE_LSTM_XW_BF16=1``: the
  input projection (plus bias) is rounded to bf16 once, here, and the
  recurrence reads it so;
  its gradient comes back rounded to bf16. ``SE_PALLAS_HS_BF16=1``: B1 stores
  hs in bf16 and the next layer reads it widened. ``SE_PALLAS_VJP_BF16=1``:
  under autograd B2 fwd stores hs and cs in bf16 (the next layer reads that
  hs), and B2 bwd reads them, rounds the dh cotangent, W_hh^T and the da of
  its dh product to bf16. A bidirectional layer honours all three, as JAX's
  Pallas path does; a one-direction layer (JAX's ``lax.scan`` cell) only the
  first. ``Capture`` records ``l{k}_xw`` before the rounding, where JAX
  perturbs it, so its gradient is the bf16 dxw widened. Three more change
  the function computed, each where the JAX package reads it:
  ``SE_PALLAS_MXU_BF16=1`` and ``SE_PALLAS_GATES_BF16=1`` are forms of its
  Pallas B1 (``_kernel_tm``), so a bidirectional layer without a gradient
  runs B1's MXU form (W_hh^T and h_{t-1} rounded to bf16 for the step
  product) and its gates form (the gate activations and i * g in bf16),
  alone or together, with either hs; under a gradient neither changes
  anything, as JAX's custom VJP reads neither, and a one-direction layer
  (the scan) reads neither. ``SE_LSTM_XW_INT8=1`` is a form of the scan:
  a one-direction layer quantizes its xw per (row, step) to int8 with a
  scale (``ops/cuda/lstm_kernel.quantize_xw_int8``), which B1 reads (a
  carried state too), and under a gradient runs the quantize and dequantize
  as torch ops into B2 (JAX's gradient through it: the scale's alone). It
  wins over ``SE_LSTM_XW_BF16`` there; a bidirectional layer keeps an f32
  xw under it, even with ``SE_LSTM_XW_BF16=1``, as JAX's Pallas path casts
  every xw but a bf16 one to f32. B6 and B7 (``recurrence="blocked"`` /
  ``"fused"``) read neither bf16 form of B1, as in the JAX package; B7 has
  no xw stream and reads no variable.

- Under tensor parallelism (``--mesh DxM``, ``parallel/mesh.py``) a stack's
  ``tp`` (a ``parallel.mesh.ShardGather``) is set: each rank stores its gate
  rows of every ``w_ih``, ``w_hh``, ``b_ih`` and ``b_hh`` (and the optimizer
  their moments), and each forward first gathers the full tensors over the
  model group, in one all-reduce; B2 fwd / B2 bwd (or B1) then run on the
  rank's rows of the batch as without a model axis, and the backward keeps
  the rank's rows of each gradient. So the M ranks of a model group compute
  the same LSTM on the same rows: M times the LSTM's work, and every rank
  the same bits. JAX partitions the gate products instead (its scan under
  GSPMD), which is a collective in every step of the recurrence: 1001 steps
  x 3 layers x 2 directions of them at the flagship's 10 s rows, against one
  gather here, and the recurrence would no longer be one kernel.

Initialization: xavier-uniform W_ih, orthogonal W_hh, zero biases.
"""
from __future__ import annotations

import os
from types import SimpleNamespace
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..ops.cuda.lstm_kernel import (
    dequantize_xw_int8,
    lstm_bidir_bb,
    lstm_bidir_fused,
    lstm_bidir_tm,
    quantize_xw_int8,
)
from ..utils import costs

RECURRENCES = ("tm", "blocked", "fused")
# the JAX package's variables of its LSTM kernels' forms, each read as "1"
FORM_VARIABLES = ("SE_LSTM_XW_INT8", "SE_LSTM_XW_BF16", "SE_PALLAS_HS_BF16",
                  "SE_PALLAS_VJP_BF16", "SE_PALLAS_MXU_BF16", "SE_PALLAS_GATES_BF16")


class LstmForms(NamedTuple):
    """The forms of the LSTM kernels the environment sets: ``xw`` "f32",
    "bf16" or "int8" (JAX's ``_xw_mode``: int8 first), B1's bf16 hs, the
    VJP's bf16 residuals, and B1's MXU and gates forms."""

    xw: str
    hs_bf16: bool
    vjp_bf16: bool
    mxu_bf16: bool
    gates_bf16: bool


def stream_forms() -> LstmForms:
    """The forms the JAX package's variables (``FORM_VARIABLES``) turn on,
    each set to "1" as the JAX package reads it; read at every forward, as
    JAX reads them at every trace."""
    on = {name: os.environ.get(name, "0") == "1" for name in FORM_VARIABLES}
    xw = "int8" if on["SE_LSTM_XW_INT8"] else "bf16" if on["SE_LSTM_XW_BF16"] else "f32"
    return LstmForms(xw, on["SE_PALLAS_HS_BF16"], on["SE_PALLAS_VJP_BF16"],
                     on["SE_PALLAS_MXU_BF16"], on["SE_PALLAS_GATES_BF16"])


def scan_stream(xw: torch.Tensor, w_hh_t: torch.Tensor, xw_form: str):
    """What a one-direction layer (JAX's ``lax.scan`` cell) hands the
    recurrence for its xw (1, B, T, 4H) f32 under ``xw_form`` (JAX's
    ``_xw_mode``): (xw, None) in f32, (bf16 xw, None), or in the int8 form
    (q, scale) without a gradient (B1 reads both) and under one the
    dequantized f32 xw, as torch ops so that the gradient is JAX's."""
    if xw_form == "bf16":
        return xw.to(torch.bfloat16), None
    if xw_form != "int8":
        return xw, None
    if torch.is_grad_enabled() and (xw.requires_grad or w_hh_t.requires_grad):
        return dequantize_xw_int8(xw), None
    return quantize_xw_int8(xw)


class Bf16Product(torch.autograd.Function):
    """``a @ b`` for bf16 (n, i, k) and (n, k, j) with an f32 result: exact
    products summed in f32, as JAX's ``einsum`` of bf16 operands with
    ``preferred_element_type=f32``. On the card one bf16 GEMM with an f32
    output (``torch.bmm``'s ``out_dtype``); on the CPU, which lacks that
    overload, the same function as the f32 product of the operands' values.
    The gradients are the f32 products of the f32 cotangent with the other
    operand, rounded to bf16 (the transpose of JAX's ``dot_general``)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        # a product of bf16 numbers on either device (utils/costs)
        with costs.kernel("bf16 product", costs.product_call_cost, a, b, "bf16"):
            if a.device.type == "cuda":
                return torch.bmm(a, b, out_dtype=torch.float32)
            return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.bmm(g, b.float().transpose(1, 2)).to(torch.bfloat16)
        if ctx.needs_input_grad[1]:
            db = torch.bmm(a.float().transpose(1, 2), g).to(torch.bfloat16)
        return da, db


def project(xs: torch.Tensor, w_ih: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The input projection of a layer without its bias: (2, B, T, D) x (2,
    4H, D) -> (2, B, T, 4H) f32, or a leading 1 for one direction. In f32 the
    plain einsum; in bf16 both operands rounded to bf16 and their f32 product
    (``Bf16Product``)."""
    if dtype == torch.float32:
        return torch.einsum("dbtn,dhn->dbth", xs, w_ih)
    d, B, T, D = xs.shape
    a = xs.to(dtype).reshape(d, B * T, D)
    return Bf16Product.apply(a, w_ih.to(dtype).transpose(1, 2)).reshape(d, B, T, -1)


class Capture(dict):
    """The streams a forward records for the per-sample gradient scorer, by
    name. ``layer`` (an LSTM layer index or ``"all"``) selects what is
    recorded."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer


def captured(capture: Optional[Capture], layer) -> bool:
    """Whether a forward handed ``capture`` records ``layer`` (an index, or
    a name such as ``"scaling"`` that only ``"all"`` selects)."""
    return capture is not None and capture.layer in ("all", layer)


class LstmDirParams(nn.Module):
    """Parameters of one direction of one layer (torch layout)."""

    def __init__(self, hidden_size: int, input_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h4 = 4 * hidden_size
        self.w_ih = nn.Parameter(torch.empty(h4, input_size))
        self.w_hh = nn.Parameter(torch.empty(h4, hidden_size))
        self.b_ih = nn.Parameter(torch.zeros(h4))
        self.b_hh = nn.Parameter(torch.zeros(h4))
        nn.init.xavier_uniform_(self.w_ih, generator=generator)
        nn.init.orthogonal_(self.w_hh, generator=generator)


class LSTMStack(nn.Module):
    """torch ``nn.LSTM(num_layers, bidirectional, batch_first=True)``
    equivalent over (B, T, D). Output dim = hidden_size * (2 if
    bidirectional else 1). ``recurrence`` ("tm", "blocked" or "fused")
    names the forward-only kernel of the bidirectional layers, a switch for
    the tests and the card script; a one-direction layer always runs
    ``lstm_bidir_tm``. ``compute_dtype`` (f32 or bf16) is the precision of
    the input projection and of W_hh^T's values, and for a one-direction
    layer also of h in the step product."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False,
                 generator: Optional[torch.Generator] = None,
                 recurrence: str = "tm", compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be f32 or bf16, got {compute_dtype}")
        self.compute_dtype = compute_dtype
        self.recurrence = recurrence
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        dirs = ("fwd", "bwd") if bidirectional else ("fwd",)
        d_in = input_size
        for k in range(num_layers):
            for name in dirs:
                # named as the flax tree names them: lstm.l0_fwd.w_ih, ...
                self.add_module(
                    f"l{k}_{name}", LstmDirParams(hidden_size, d_in, generator)
                )
            d_in = hidden_size * len(dirs)
        self.tp = None

    def direction(self, k: int, name: str, full=None):
        """Layer ``k``'s parameters of direction ``name`` ("fwd" | "bwd"):
        the module itself, or under a model axis the gathered full tensors
        ``full`` (``tp``'s result) under the same attribute names."""
        own = getattr(self, f"l{k}_{name}")
        if full is None:
            return own
        pre = f"l{k}_{name}."
        return SimpleNamespace(**{a: full.get(pre + a, getattr(own, a))
                                  for a in ("w_ih", "w_hh", "b_ih", "b_hh")})

    @property
    def recurrence(self) -> str:
        return self._recurrence

    @recurrence.setter
    def recurrence(self, value: str):
        if value not in RECURRENCES:
            raise ValueError(f"recurrence must be one of {RECURRENCES}, got {value!r}")
        self._recurrence = value

    def forward(self, x: torch.Tensor, initial_state=None, return_state: bool = False,
                capture: Optional[Capture] = None):
        """(B, T, D) -> (B, T, H * directions); with ``return_state`` (a
        one-direction stack only) (output, final states), the final states one
        (h, c) per layer, each (B, H). ``initial_state`` is such a sequence to
        start from (None: zeros). ``capture`` receives the streams of the
        captured layers."""
        carry = initial_state is not None or return_state
        if carry and self.bidirectional:
            raise ValueError(
                "recurrent-state carrying (streaming) needs a unidirectional stack: the "
                "backward direction would need future audio")
        if carry and capture is not None:
            raise ValueError("capture records a stateless forward only")
        # B6 and B7 have no backward kernel: a gradient takes LstmBidirTm
        forward_only = not (torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters())))
        final_states = []
        bf16 = self.compute_dtype == torch.bfloat16
        forms = stream_forms()
        # the xw a bidirectional layer hands B1 / B2 / B6: bf16, else f32 (int8 too)
        stream = lambda xw: xw.to(torch.bfloat16) if forms.xw == "bf16" else xw  # noqa: E731
        below = capture.layer if capture is not None and isinstance(capture.layer, int) else 0
        full = None if self.tp is None else self.tp(self)
        for k in range(self.num_layers):
            pf = self.direction(k, "fwd", full)
            if not self.bidirectional:
                # one direction on the leading axis: LstmBidirTm when a
                # gradient is needed, B1 when not. In bf16 the JAX scan cell:
                # its projection, bias added as it adds it, bf16 W_hh^T and
                # the bf16-h form of the recurrence
                if bf16:
                    xw = project(x[None], pf.w_ih[None], self.compute_dtype) + pf.b_ih + pf.b_hh
                    w_hh_t = pf.w_hh.T[None].to(torch.bfloat16).float()
                else:
                    xw = (torch.matmul(x, pf.w_ih.T) + (pf.b_ih + pf.b_hh))[None]
                    w_hh_t = pf.w_hh.T[None]
                xw, w_hh_t = xw.contiguous(), w_hh_t.contiguous()
                x_in, scale = scan_stream(xw, w_hh_t, forms.xw)
                if not carry:
                    hs = lstm_bidir_tm(x_in, w_hh_t, h_bf16=bf16, xw_scale=scale)
                    if captured(capture, k):
                        capture.update({f"l{k}_xs": x[None], f"l{k}_xw": xw,
                                        f"l{k}_hs": hs})
                    x = hs[0]
                    continue
                state = None if initial_state is None else tuple(
                    t[None] for t in initial_state[k])
                hs, (h, c) = lstm_bidir_tm(x_in, w_hh_t, state=state, return_state=True,
                                           h_bf16=bf16, xw_scale=scale)
                x = hs[0]
                final_states.append((h[0], c[0]))
                continue
            pb = self.direction(k, "bwd", full)
            xs = torch.stack([x, torch.flip(x, dims=[1])], dim=0)  # (2, B, T, D)
            w_ih = torch.stack([pf.w_ih, pb.w_ih], dim=0)  # (2, 4H, D)
            bias = torch.stack([pf.b_ih + pf.b_hh, pb.b_ih + pb.b_hh], dim=0)
            w_hh_t = torch.stack([pf.w_hh.T, pb.w_hh.T], dim=0)  # (2, H, 4H)
            if bf16:
                w_hh_t = w_hh_t.to(torch.bfloat16).float()  # bf16 values, f32 recurrence
            w_hh_t = w_hh_t.contiguous()
            capture_k = captured(capture, k)
            if self.recurrence == "fused" and forward_only and not capture_k:
                if bf16:
                    raise NotImplementedError("B7 (recurrence='fused') projects in f32 "
                                              "inside the kernel: it has no bf16 form")
                hs = lstm_bidir_fused(xs, w_ih.transpose(1, 2).contiguous(), bias, w_hh_t)
            else:
                xw = (project(xs, w_ih, self.compute_dtype)
                      + bias[:, None, None, :]).contiguous()
                if self.recurrence == "blocked" and forward_only:
                    hs = lstm_bidir_bb(stream(xw), w_hh_t)
                else:
                    # LstmBidirTm when a gradient is needed, B1 when not. A
                    # layer below a captured one needs none: the scorer
                    # differentiates at the captured streams only, as JAX's
                    # capture engine at its perturbation, whose custom VJP runs
                    # its forward on the layers the perturbed stream reaches
                    # and its primal below (they differ under VJP bf16)
                    with torch.set_grad_enabled(torch.is_grad_enabled() and k >= below):
                        hs = lstm_bidir_tm(
                            stream(xw), w_hh_t,
                            hs_dtype=torch.bfloat16 if forms.hs_bf16 else torch.float32,
                            res_dtype=torch.bfloat16 if forms.vjp_bf16 else torch.float32,
                            mxu_bf16=forms.mxu_bf16, gates_bf16=forms.gates_bf16)
                if capture_k:
                    capture.update({f"l{k}_xs": xs, f"l{k}_xw": xw, f"l{k}_hs": hs})
            x = torch.cat([hs[0], torch.flip(hs[1], dims=[1])], dim=-1)
        return (x, tuple(final_states)) if return_state else x
