"""Program cost model: FLOPs by arithmetic class and an HBM-traffic model
(counterpart of ``speech_enhancement_by_s3prl_tpu/utils/costs.py``), and the
card's peaks they are read against.

``program_cost(fn, *args, **kwargs)`` runs ``fn`` once, eagerly, under a
``TorchDispatchMode`` (the mechanism ``torch.utils.flop_counter`` uses) and
walks the aten ops it dispatches, the backward's included when ``fn`` runs
one (the mode reaches autograd's threads) and a recomputed forward
(``torch.utils.checkpoint``) counted again, as dispatched. It returns the JAX
keys with their meanings:

- ``flops``: 2 * M * N * K a product (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``convolution`` and its backward,
  ``scaled_dot_product_attention``'s forward and backward ops), batch dims
  folded in; one flop an output element for a pointwise op (``torch.Tag.
  pointwise``) and one an input element for a reduction, as JAX's
  ``_ELEMENTWISE`` / ``_REDUCTIONS``; softmax, log-softmax and layer norm as
  the passes JAX's primitives of the same function make (``_PASSES``); an FFT
  5 N log2 N a complex transform (half for a real one). Copies, casts, views,
  fills, indexing and random draws count nothing.
- ``dot_flops``: the products' subtotal.
- ``hbm_bytes_model``: a traffic model, not a counter: the program's inputs
  and outputs once (tensors of the arguments and the result, an
  ``nn.Module``'s parameters and buffers, containers walked), plus every
  product's operands and result. Elementwise traffic is left out. Eager
  execution has no loop to see through, so a weight read by the products of
  a Python loop counts once a product; inside a kernel (B1's W_hh^T over T
  steps) it counts once, as the kernel's formula says.
- ``opaque_calls``: ops of another namespace than ``aten`` / ``prims`` (an
  ``se_torch`` op called without its wrapper, as an exported program replays
  it, among them); ``unbounded_loops``: always 0 (eager PyTorch has no loop
  it cannot count).

And ``flops_by_class``: each flop carries the class of the cheapest
arithmetic the numerics allow (``CLASSES``): ``f32``, f32 FMAs with TF32 off,
as every f32 product of the port runs (``use_full_fp32``); ``tf32x3`` /
``tf32x2``, products kept to f32 accuracy by three (two) split-TF32 passes on
the tensor cores; ``bf16`` / ``bf16x3``, products of bf16 numbers in one
(three) bf16 passes; ``other``, pointwise ops, reductions and FFTs on the
CUDA cores. An aten product is classed by its operands' dtypes, not by the
kernel that serves it.

The hand-written kernels are opaque to a dispatch mode (B2, B3, B6, B7 and B1
from a carried state launch through ctypes) or, as ``torch.library`` ops
(B1, B4, B5), would be counted by their CPU kernel's aten ops. So each
kernel's wrapper opens ``kernel(name, formula, ...)`` around its body: inside
a count, the formula of the function the kernel computes (``lstm_cost``,
``lstm_bwd_cost``, ``dw_bf16_cost``, ``lstm_fused_cost``, ``attention_cost``,
``stft_cost``, ``decode_cost``, ``dropout_cost``), keyed on shapes, dtypes and stream form, is
added once, and no op dispatched inside is counted. The count is the same
whether the card runs the kernel or the CPU its plain version, and whichever
route serves it.

The formulas are the one copy of the kernels' counts: ``bound_of`` reads a
formula against ``PEAKS`` as the least time the card could take (the larger
of operations over their peaks and bytes over the memory rate), and the
named bounds ``chip_smoke.py`` prints (``lstm_bound``, ``attention_bound``,
...) are that. ``roofline`` reads a ``program_cost`` the same way:
``mfu`` = (sum over classes of flops / peak) / seconds a step.

One count runs at a time in a process; outside a count a wrapper's ``kernel``
is a shared null context.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

CLASSES = ("f32", "tf32x3", "tf32x2", "bf16", "bf16x3", "other")
H100 = "NVIDIA H100 80GB HBM3"
# the H100 SXM5 data sheet: f32 outside the tensor cores, dense TF32 and dense
# bf16 on them, and HBM3
PEAK_F32, PEAK_TF32, PEAK_BF16, PEAK_BYTES = 67e12, 495e12, 989e12, 3.35e12
# peak operations a second of each class, and bytes a second of the memory
# (``"hbm"``), by ``torch.cuda.get_device_name``; a card without an entry
# gets no peak
PEAKS: Dict[str, Dict[str, float]] = {
    H100: {"f32": PEAK_F32, "tf32x3": PEAK_TF32 / 3, "tf32x2": PEAK_TF32 / 2,
           "bf16": PEAK_BF16, "bf16x3": PEAK_BF16 / 3, "other": PEAK_F32,
           "hbm": PEAK_BYTES},
}
# instructions a bf16 dW_hh^T element takes on the CUDA cores each step: its
# carry, cvt.rn.bf16x2.f32 and add.rn.bf16x2 for two elements (the kernel's
# SASS: 8 F2FP and 8 HADD2 a thread and step for 16 elements), at one
# instruction a lane and clock, half the f32 operation rate
DW_CARRY_INSTRUCTIONS = 1


@dataclasses.dataclass(frozen=True)
class Cost:
    """The work of one call: ``flops`` by class, ``nbytes`` moved (each input
    read once, each output written once), ``dot_flops`` (its products), and
    ``ops_ms``, where the classes run on pipes that overlap, the least time
    their operations take (else the sum over classes of flops / peak)."""

    flops: Mapping[str, float]
    nbytes: float
    dot_flops: float = 0.0
    ops_ms: Optional[float] = None

    def __add__(self, other: "Cost") -> "Cost":
        flops = dict(self.flops)
        for c, f in other.flops.items():
            flops[c] = flops.get(c, 0) + f
        ops = None
        if self.ops_ms is not None or other.ops_ms is not None:
            ops = _ops_ms(self) + _ops_ms(other)
        return Cost(flops, self.nbytes + other.nbytes, self.dot_flops + other.dot_flops, ops)


def _ops_ms(cost: Cost, as_class: Optional[str] = None) -> float:
    if as_class is not None:
        return sum(cost.flops.values()) / PEAKS[H100][as_class] * 1e3
    if cost.ops_ms is not None:
        return cost.ops_ms
    return sum(f / PEAKS[H100][c] for c, f in cost.flops.items()) * 1e3


def bound(flops, nbytes, peak=PEAK_F32) -> Tuple[float, str]:
    """The least time the card could take, in ms: operations over their peak
    rate (f32 outside the tensor cores unless ``peak`` says otherwise) against
    bytes over the memory rate (each input read once, each output written
    once); and which of the two binds."""
    by_ops, by_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def bound_of(cost: Cost, as_class: Optional[str] = None) -> Tuple[float, str]:
    """``bound`` of a formula on the H100: its operations over each class's
    peak (or, with ``as_class``, all of them at that class's peak, e.g.
    ``"f32"`` for the same products as f32 FMAs) against its bytes."""
    by_ops, by_bytes = _ops_ms(cost, as_class), cost.nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


# -- the kernels' formulas -------------------------------------------------

def lstm_cost(ndir, B, T, H, cell=False, xw_bytes=4, out_bytes=4, h_bf16=False,
              carried=False, cls=None) -> Cost:
    """B1 (``cell``: B2 fwd, B6 with ``cls="tf32x3"``) at (ndir, B, T, H): one
    h @ W_hh^T a step and direction, f32 FMAs (the bf16-h form, and the MXU
    form, which is it on bf16 W_hh^T values: one bf16 pass); xw in
    (``xw_bytes`` an element; an int8 xw, 1, also reads its f32 scale a
    direction, row and step), W_hh^T in, hs (and cs) out (``out_bytes``), and
    with a ``carried`` state h0, c0 in and cT out. The gates form counts as
    the f32 one: its rounding passes are not products."""
    product = 2 * ndir * B * T * H * 4 * H
    nbytes = (ndir * B * T * 4 * H * xw_bytes + 4 * ndir * H * 4 * H
              + ndir * B * T * H * out_bytes * (2 if cell else 1))
    if xw_bytes == 1:
        nbytes += 4 * ndir * B * T
    if carried:
        nbytes += 4 * 3 * ndir * B * H
    return Cost({cls or ("bf16" if h_bf16 else "f32"): product}, nbytes, product)


def dw_bf16_cost(ndir, B, T, H) -> Cost:
    """The bf16-h form's dW_hh^T, summed step by step in bf16: the step
    products as three bf16 passes (da split into three bf16 terms) on the
    tensor cores, overlapping the bf16 carry of every element and step on the
    CUDA cores (``DW_CARRY_INSTRUCTIONS`` an element and step at any B); hs
    and da in, dW_hh^T out."""
    product = 2 * ndir * B * (T - 1) * H * 4 * H
    carry = ndir * (T - 1) * H * 4 * H
    carry_ms = carry * DW_CARRY_INSTRUCTIONS / (PEAK_F32 / 2) * 1e3
    tensor_ms = 3 * product / PEAK_BF16 * 1e3
    nbytes = 4 * ndir * (B * T * 5 * H + 4 * H * H)
    return Cost({"bf16x3": product, "other": carry}, nbytes, product, max(carry_ms, tensor_ms))


def lstm_bwd_cost(ndir, B, T, H, xw_bytes=4, res_bytes=4, h_bf16=False, dw=True) -> Cost:
    """B2 bwd at (ndir, B, T, H): the gate, dh and dW_hh^T products, each as
    three TF32 passes (f32 residuals), or the two products of bf16 numbers as
    one bf16 pass each and dW_hh^T of bf16 h against the f32 da as two TF32
    passes (``res_bytes`` 2, the bf16 residual form); xw, W_hh^T, hs, cs, dhs
    in, dxw (xw's bytes) and dW_hh^T out. The bf16-h form (``h_bf16``): the
    gates from bf16 h (a bf16 pass) and the dh product of the f32 da and the
    bf16 W_hh (three TF32 passes), with xw, hs, cs, dhs and W_hh^T in and dxw
    out, then (``dw``) its dW_hh^T kernel, ``dw_bf16_cost``."""
    product = 2 * ndir * B * T * H * 4 * H
    n, w = ndir * B * T, ndir * H * 4 * H
    if h_bf16:
        nbytes = 4 * (n * (4 * H + 3 * H) + w + n * 4 * H)
        cost = Cost({"bf16": product, "tf32x3": product}, nbytes, 2 * product)
        return cost + dw_bf16_cost(ndir, B, T, H) if dw else cost
    nbytes = 2 * n * 4 * H * xw_bytes + 8 * w + 3 * n * H * res_bytes
    if res_bytes == 2:
        return Cost({"bf16": 2 * product, "tf32x2": product}, nbytes, 3 * product)
    return Cost({"tf32x3": 3 * product}, nbytes, 3 * product)


def lstm_fused_cost(B, T, D, H) -> Cost:
    """B7, two directions: the projection xs @ W_ih^T and one h @ W_hh^T a
    step, as three TF32 passes; xs, W_ih^T, the bias and W_hh^T in, hs out."""
    flops = 2 * 2 * B * T * H * 4 * H + 2 * 2 * B * T * D * 4 * H
    nbytes = 4 * (2 * B * T * D + 2 * H * 4 * H + 2 * D * 4 * H + 2 * 4 * H + 2 * B * T * H)
    return Cost({"tf32x3": flops}, nbytes, flops)


def attention_cost(B, T, N, D, backward=False, bf16=False) -> Cost:
    """B3: 2 tile products of 2 * T * T * D a head forward, 5 backward (the
    logits recomputed from lse); three TF32 passes each in f32, one bf16 pass
    in bf16. q, k, v, out (and dout, dq, dk, dv) moved once, lse (and the
    backward's Di) in f32."""
    products = 5 if backward else 2
    flops = products * 2 * B * N * T * T * D
    if bf16:
        nbytes = 2 * (8 if backward else 4) * B * T * N * D + 4 * B * N * T * (
            2 if backward else 1)
        return Cost({"bf16": flops}, nbytes, flops)
    nbytes = 4 * ((9 if backward else 4) * B * T * N * D + B * N * T)
    return Cost({"tf32x3": flops}, nbytes, flops)


def stft_cost(rows, n_frames, n_fft, hop) -> Cost:
    """B4 by its cheapest algorithm, an FFT of each frame: window (n_fft),
    the n_fft / 2-point complex transform (5 M log2 M) and the split pass
    (~6 n_fft) a frame on the CUDA cores, against the samples and the tables
    in and n_fft + 2 values a frame out. Bytes bind."""
    m = n_fft // 2
    flops = rows * n_frames * (n_fft + 5 * m * math.log2(m) + 6 * n_fft)
    nbytes = 4 * (rows * ((n_frames - 1) * hop + n_frames * (n_fft + 2)) + 3 * n_fft + 2)
    return Cost({"other": flops}, nbytes)


def decode_cost(rows, n_frames, n_fft, hop) -> Cost:
    """B5 by its cheapest algorithm, an inverse FFT of each frame: the rescale
    (~8 operations a bin), the packing (~12 a point), the M-point transform
    (5 M log2 M), the window and the overlap-add a frame on the CUDA cores
    (~13 k operations at n_fft 400), against pred and the carrier in, the raw
    overlap-add and the tables out and in. Bytes bind."""
    m, k = n_fft // 2, -(-n_fft // hop)
    flops = rows * n_frames * (8 * (m + 1) + 12 * m + 5 * m * math.log2(m) + n_fft + k * hop)
    nbytes = 4 * (rows * (3 * n_frames * (m + 1) + (n_frames + k - 1) * hop) + 3 * n_fft + 2)
    return Cost({"other": flops}, nbytes)


# integer operations a threefry2x32 block takes (2 + 20 rounds of add, rotate,
# xor + 5 key injections of 2 adds + 5 round constants), plus the fold of its
# two words, the keep test and the select
THREEFRY_OPS = 2 + 20 * 3 + 5 * 3 + 4


def dropout_cost(n, itemsize) -> Cost:
    """D1 on ``n`` elements: x read and y written once; a threefry block, the
    keep test and one division an element on the CUDA cores, counted at the
    f32 rate (the card's integer rate is not in its data sheet's table)."""
    return Cost({"other": n * (THREEFRY_OPS + 1)}, 2 * n * itemsize)


# -- the bounds chip_smoke.py prints, read from the formulas ---------------

def lstm_bound(B, T, H, products=1, extra_streams=0, D=0, peak=PEAK_F32):
    """Two directions: B1 (B2 fwd with ``extra_streams`` 1, its cs), B2 bwd
    (``products`` 3), B7 (``D`` > 0). ``peak=PEAK_TF32`` reads each product
    as three TF32 passes (B2 bwd, B6, B7), ``PEAK_F32`` as f32 FMAs."""
    if D:
        cost = lstm_fused_cost(B, T, D, H)
    elif products == 3:
        cost = lstm_bwd_cost(2, B, T, H)
    else:
        cost = lstm_cost(2, B, T, H, cell=extra_streams == 1, cls="tf32x3")
    return bound_of(cost, None if peak == PEAK_TF32 else "f32")


def carried_bound(B, T, H):
    """B1 of one direction continuing from a carried state."""
    return bound_of(lstm_cost(1, B, T, H, carried=True))


def attention_bound(B, T, N, D, products, peak=PEAK_TF32):
    """B3 f32 (``products`` 2 forward, 5 backward) as three TF32 passes a
    product, or (``peak=PEAK_F32``) as f32 FMAs."""
    cost = attention_cost(B, T, N, D, backward=products != 2)
    return bound_of(cost, None if peak == PEAK_TF32 else "f32")


def attention_bound_bf16(B, T, N, D, products):
    """B3 bf16: one bf16 pass a product."""
    return bound_of(attention_cost(B, T, N, D, backward=products != 2, bf16=True))


def stft_bound(rows, n_frames, n_fft, hop):
    return bound_of(stft_cost(rows, n_frames, n_fft, hop))


def decode_bound(rows, n_frames, n_fft, hop):
    return bound_of(decode_cost(rows, n_frames, n_fft, hop))


def bf16_h_bound(B, T, H, form):
    """The bf16-h forms of one direction: ``form`` "b1" / "fc" (B1, B2 fwd),
    "bwd" (B2 bwd without its dW_hh^T kernel) or "dw" (that kernel)."""
    if form == "dw":
        return bound_of(dw_bf16_cost(1, B, T, H))
    if form == "bwd":
        return bound_of(lstm_bwd_cost(1, B, T, H, h_bf16=True, dw=False))
    return bound_of(lstm_cost(1, B, T, H, cell=form == "fc", h_bf16=True))


def dw_first_bound(B, T, H):
    """The bound the first dW_hh^T design was held to: its step products as
    f32 FMAs on the CUDA cores against the bytes."""
    cost = dw_bf16_cost(1, B, T, H)
    return bound_of(Cost({"f32": cost.dot_flops}, cost.nbytes))


def stream_bound(B, T, H, kind, xw_bf16, out_bf16, ndir=2):
    """A stream form at (ndir, B, T, H): ``kind`` "b1" / "fc" / "bwd", xw in
    bf16 (``xw_bf16``), B1's hs or B2's residuals in bf16 (``out_bf16``)."""
    xb, ob = (2 if xw_bf16 else 4), (2 if out_bf16 else 4)
    if kind == "bwd":
        return bound_of(lstm_bwd_cost(ndir, B, T, H, xb, ob))
    return bound_of(lstm_cost(ndir, B, T, H, cell=kind == "fc", xw_bytes=xb, out_bytes=ob))


def b1_form_bound(B, T, H, form, ndir=2, hs_bf16=False):
    """B1 in one of the forms that change its function: ``form`` "mxu" (the
    bf16-h form's count), "gates" (the f32 count), "int8" (1 byte an xw
    element and its scale), or "f32"; ``hs_bf16``: hs stored in bf16."""
    return bound_of(lstm_cost(ndir, B, T, H, xw_bytes=1 if form == "int8" else 4,
                              out_bytes=2 if hs_bf16 else 4, h_bf16=form == "mxu"))


# -- the count --------------------------------------------------------------

# the count running, if any, and the kernel regions open inside it: the
# wrappers reach them from wherever they are called (autograd runs a backward
# on threads of its own), so they live here, set and cleared by program_cost
_COUNT: Optional["_Count"] = None
_DEPTH = 0
_NULL = contextlib.nullcontext()


@dataclasses.dataclass
class _Count:
    flops: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(CLASSES, 0.0))
    dot_flops: float = 0.0
    nbytes: float = 0.0
    opaque_calls: int = 0
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, flops: Mapping[str, float], nbytes: float = 0.0, dot: float = 0.0):
        for c, f in flops.items():
            self.flops[c] += f
        self.nbytes += nbytes
        self.dot_flops += dot

    def add_kernel(self, name: str, cost: Cost):
        self.add(cost.flops, cost.nbytes, cost.dot_flops)
        self.kernels[name] = self.kernels.get(name, 0) + 1


class _Region:
    """A kernel wrapper's body inside a count: its formula added once on
    entry (none when another region is open), nothing dispatched inside
    counted."""

    __slots__ = ("name", "formula", "args", "kwargs")

    def __init__(self, name, formula, args, kwargs):
        self.name, self.formula, self.args, self.kwargs = name, formula, args, kwargs

    def __enter__(self):
        global _DEPTH
        if _DEPTH == 0:
            _COUNT.add_kernel(self.name, self.formula(*self.args, **self.kwargs))
        _DEPTH += 1

    def __exit__(self, *exc):
        global _DEPTH
        _DEPTH -= 1
        return False


def kernel(name: str, formula, *args, **kwargs):
    """The context a kernel wrapper's body runs in: inside ``program_cost``,
    ``formula(*args, **kwargs)`` (a ``Cost``) counted once for ``name`` and
    the body's own ops not at all; outside, a null context."""
    if _COUNT is None:
        return _NULL
    return _Region(name, formula, args, kwargs)


def counted(name, formula):
    """``kernel`` as a decorator, for a wrapper whose every call is its
    kernel's: ``formula`` (and ``name``, where it is a callable) takes the
    wrapper's arguments."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _COUNT is None:
                return fn(*args, **kwargs)
            label = name(*args, **kwargs) if callable(name) else name
            with _Region(label, formula, args, kwargs):
                return fn(*args, **kwargs)
        return wrapper
    return wrap


def stft_call_cost(wavs, n_fft, hop) -> Cost:
    """``stft_cost`` of B4 on (..., time) ``wavs``."""
    time = wavs.shape[-1]
    return stft_cost(wavs.numel() // max(time, 1), 1 + time // hop, n_fft, hop)


def decode_call_cost(pred, n_fft, hop) -> Cost:
    return decode_cost(pred.shape[0], pred.shape[1], n_fft, hop)


def b1_call_cost(xw, w_hh_t, h_bf16=False, hs_bf16=False, carried=False, cell=False,
                 res_dtype=None, cls=None, xw_scale=None) -> Cost:
    """``lstm_cost`` of a recurrence call on xw (ndir, B, T, 4H): its stream
    form from the dtypes (``hs_bf16`` or a bf16 ``res_dtype``: bf16 out; an
    int8 xw, read with its ``xw_scale``)."""
    ndir, B, T, h4 = xw.shape
    out_bf16 = hs_bf16 or res_dtype == torch.bfloat16
    return lstm_cost(ndir, B, T, h4 // 4, cell, xw.element_size(), 2 if out_bf16 else 4,
                     h_bf16, carried, cls)


def b2_bwd_call_cost(xw, hs, h_bf16=False) -> Cost:
    ndir, B, T, h4 = xw.shape
    return lstm_bwd_cost(ndir, B, T, h4 // 4, xw.element_size(), hs.element_size(), h_bf16)


def dw_bf16_call_cost(hs) -> Cost:
    return dw_bf16_cost(*hs.shape)


def dropout_call_cost(x) -> Cost:
    return dropout_cost(x.numel(), x.element_size())


def dropout_bound(n, itemsize):
    """D1 on ``n`` elements of ``itemsize`` bytes."""
    return bound_of(dropout_cost(n, itemsize))

def attention_call_cost(q, n_heads, backward=False) -> Cost:
    B, T, HD = q.shape
    return attention_cost(B, T, n_heads, HD // n_heads, backward, q.dtype == torch.bfloat16)


def fused_call_cost(xs, w_hh_t) -> Cost:
    _, B, T, D = xs.shape
    return lstm_fused_cost(B, T, D, w_hh_t.shape[-2])


def product_call_cost(a, b, cls) -> Cost:
    """A batched product (n, i, k) @ (n, k, j) of class ``cls``."""
    n, i, k = a.shape
    flops = 2 * n * i * k * b.shape[-1]
    return Cost({cls: flops}, _nbytes(a) + _nbytes(b) + 4 * n * i * b.shape[-1], flops)


# ops that move, cast, fill or draw data: no flops, whatever their tags say
_MOVES = frozenset({
    "clone", "copy", "copy_", "_to_copy", "fill", "fill_", "zero_", "zeros_like",
    "ones_like", "full_like", "empty_like", "rand_like", "randn_like", "lift_fresh",
    "lift_fresh_copy", "detach", "alias", "contiguous", "_copy_from", "_copy_from_and_resize",
})
# one flop an input element
_REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin", "cumsum",
    "cumprod", "cummax", "cummin", "logsumexp", "logcumsumexp", "var", "std", "var_mean",
    "std_mean", "norm", "linalg_vector_norm", "any", "all", "nansum", "aminmax",
    "count_nonzero",
})
# flops an element of the first input: the passes JAX's primitives make for
# the same function (softmax: max, subtract, exp, sum, divide; layer norm:
# two means, subtract, square, scale, shift, and the rest per row)
_PASSES = {
    "_softmax": 5, "_log_softmax": 5, "_softmax_backward_data": 4,
    "_log_softmax_backward_data": 3, "native_layer_norm": 8, "native_layer_norm_backward": 16,
}
_SDPA = frozenset({
    "_scaled_dot_product_flash_attention", "_scaled_dot_product_flash_attention_for_cpu",
    "_scaled_dot_product_efficient_attention", "_scaled_dot_product_cudnn_attention",
})
_FFT = {"_fft_r2c": 0.5, "_fft_c2r": 0.5, "_fft_c2c": 1.0}


def _nbytes(t) -> float:
    return float(t.numel() * t.element_size()) if isinstance(t, torch.Tensor) else 0.0


def _tensors(x, out, seen):
    """The tensors of ``x`` (containers, dataclasses and modules walked) into
    ``out``, each storage once."""
    if isinstance(x, torch.Tensor):
        key = (x.device, x.data_ptr(), x.numel(), x.dtype)
        if key not in seen:
            seen.add(key)
            out.append(x)
    elif isinstance(x, torch.nn.Module):
        for t in list(x.parameters()) + list(x.buffers()):
            _tensors(t, out, seen)
    elif isinstance(x, Mapping):
        for v in x.values():
            _tensors(v, out, seen)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out, seen)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _tensors(getattr(x, f.name), out, seen)


def _io_bytes(x) -> float:
    found: list = []
    _tensors(x, found, set())
    return sum(_nbytes(t) for t in found)


def _product_class(*operands) -> str:
    low = (torch.bfloat16, torch.float16)
    return "bf16" if any(t.dtype in low for t in operands if isinstance(t, torch.Tensor)) \
        else "f32"


def _product_flops(op: str, args, out) -> Tuple[float, float, Tuple]:
    """(product flops, pointwise flops, operands) of a product op, or None."""
    if op == "mm":
        a, b = args[0], args[1]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1], 0.0, (a, b)
    if op == "addmm":
        c, a, b = args[0], args[1], args[2]
        mn = a.shape[0] * b.shape[1]
        return 2.0 * mn * a.shape[1], float(mn), (c, a, b)
    if op == "bmm":
        a, b = args[0], args[1]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2], 0.0, (a, b)
    if op == "baddbmm":
        c, a, b = args[0], args[1], args[2]
        bmn = a.shape[0] * a.shape[1] * b.shape[2]
        return 2.0 * bmn * a.shape[2], float(bmn), (c, a, b)
    if op == "convolution":
        x, w = args[0], args[1]
        return 2.0 * _conv_macs(x, w, out, args[6]), 0.0, (x, w, args[2])
    if op == "convolution_backward":
        gout, x, w, mask = args[0], args[1], args[2], args[10]
        macs = _conv_macs(x, w, gout, args[7])
        grad_bias = float(gout.numel()) if mask[2] else 0.0
        return 2.0 * macs * (int(bool(mask[0])) + int(bool(mask[1]))), grad_bias, (gout, x, w)
    backward = op.endswith("_backward") and op[: -len("_backward")] in _SDPA
    if op in _SDPA or backward:
        # the backward ops take the cotangent first
        q, k, v = args[int(backward):int(backward) + 3]
        B, N, Tq, D = q.shape
        Tk, Dv = k.shape[-2], v.shape[-1]
        logits, pv = 2.0 * B * N * Tq * Tk * D, 2.0 * B * N * Tq * Tk * Dv
        if not backward:
            return logits + pv, 0.0, (q, k, v)
        # the logits recomputed from the log-sum-exp, dV, dP, dQ and dK
        return 3 * logits + 2 * pv, 0.0, (q, k, v)
    return None


def _conv_macs(x, w, out, transposed) -> float:
    """Multiply-adds of a convolution: the kernel elements feeding each output
    element (each input element, transposed)."""
    if transposed:
        return float(x.numel()) * w.numel() / max(w.shape[0], 1)
    return float(out.numel()) * w.numel() / max(w.shape[0], 1)


def _fft_flops(op: str, args, out) -> float:
    x, dims = args[0], args[1]
    sizes = out.shape if op == "_fft_c2r" else x.shape
    n = math.prod(sizes[d] for d in dims) or 1
    return _FFT[op] * 5.0 * (out.numel() if op == "_fft_c2r" else x.numel()) * math.log2(max(n, 2))


def _count_op(count: _Count, func, args, out) -> None:
    ns, _, name = func._schema.name.partition("::")
    if ns not in ("aten", "prims"):
        count.opaque_calls += 1
        return
    if name in _MOVES:
        return
    product = _product_flops(name, args, out)
    if product is not None:
        dot, pointwise, operands = product
        outs: list = []
        _tensors(out, outs, set())
        nbytes = sum(_nbytes(t) for t in operands) + sum(_nbytes(t) for t in outs)
        count.add({_product_class(*operands): dot, "other": pointwise}, nbytes, dot)
        return
    first = next((a for a in args if isinstance(a, torch.Tensor)), None)
    if name in _FFT:
        count.add({"other": _fft_flops(name, args, out)})
    elif name in _REDUCTIONS and first is not None:
        count.add({"other": float(first.numel())})
    elif name in _PASSES and first is not None:
        count.add({"other": float(_PASSES[name] * first.numel())})
    elif torch.Tag.pointwise in func.tags:
        outs = []
        _tensors(out, outs, set())
        count.add({"other": float(sum(t.numel() for t in outs))})


@functools.lru_cache(maxsize=None)
def _composite(func) -> bool:
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)


class _CostMode(TorchDispatchMode):
    """Counts each op it meets (``_count_op``). A composite op (``einsum``,
    ``linear``, ``softmax``, ...), which reaches the mode whole where autograd
    is off (``torch.inference_mode``), runs its decomposition under the mode,
    as it runs with autograd on, so its products are counted as the
    dispatcher would run them."""

    def __init__(self, count: _Count):
        super().__init__()
        self.count = count

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # the port compiles nothing: no need to wrap the dispatch in
        # torch._dynamo.disable, whose first call imports torch._dynamo
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _DEPTH == 0 and _composite(func):
            # the C++ composite kernel eager runs, its ops back through the mode
            with self:
                return func._op_dk(torch._C.DispatchKey.CompositeImplicitAutograd, *args,
                                   **kwargs)
        out = func(*args, **kwargs)
        if _DEPTH == 0:
            _count_op(self.count, func, args, out)
        return out


def program_cost(fn, *args, **kwargs) -> Dict[str, Any]:
    """Cost totals of ``fn(*args, **kwargs)``, which runs once (the module
    docstring): ``flops``, ``dot_flops``, ``hbm_bytes_model``,
    ``flops_by_class`` (every class of ``CLASSES``), ``opaque_calls``,
    ``unbounded_loops`` (0), and ``kernels``: the calls counted by formula,
    by name (each hand-written kernel's id, and ``bf16 product`` for the
    products of bf16 numbers the CPU computes in f32)."""
    global _COUNT, _DEPTH
    if _COUNT is not None:
        raise RuntimeError("program_cost: a count is already running")
    count = _Count()
    _COUNT, _DEPTH = count, 0
    try:
        with _CostMode(count):
            out = fn(*args, **kwargs)
    finally:
        _COUNT, _DEPTH = None, 0
    io = _io_bytes((args, kwargs)) + _io_bytes(out)
    return {
        "flops": sum(count.flops.values()),
        "dot_flops": count.dot_flops,
        "hbm_bytes_model": count.nbytes + io,
        "flops_by_class": dict(count.flops),
        "opaque_calls": count.opaque_calls,
        "unbounded_loops": 0,
        "kernels": dict(count.kernels),
    }


def peaks(device_name: str) -> Dict[str, float]:
    """The peak table of the card named ``device_name``; raises where there is
    none (no peak is guessed)."""
    if device_name not in PEAKS:
        raise LookupError(f"no peak table for {device_name!r} (known: {sorted(PEAKS)})")
    return PEAKS[device_name]


def roofline(cost: Mapping[str, Any], seconds: float, device_name: str) -> Dict[str, float]:
    """``mfu`` (sum over classes of ``flops_by_class`` / peak, over
    ``seconds`` a step) and ``hbm_util_model`` (the modelled bytes a second
    over the memory rate) of a ``program_cost`` on the card named
    ``device_name``."""
    table = peaks(device_name)
    ideal = sum(f / table[c] for c, f in cost["flops_by_class"].items() if f)
    return {"mfu": ideal / seconds,
            "hbm_util_model": cost["hbm_bytes_model"] / seconds / table["hbm"]}
