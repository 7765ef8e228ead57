"""flax ``nn.Dropout`` with JAX's threefry masks: the hand-written CUDA kernel
D1 and its plain PyTorch version.

Kernel (source ``csrc/threefry_dropout.cu``, sharing ``csrc/threefry.cuh``
with B3's threefry mask form): ``threefry_dropout_kernel`` computes, for each
element i of x (flat, row-major),

    keep_i = (bits >> 9) < keep_threshold23(1 - rate),
    bits   = threefry2x32(key, (hi, lo) of offset + i) XOR-folded,
    y_i    = keep_i ? x_i / keep : 0        (in x's dtype),

which is ``jax.random.bernoulli(key, 1 - rate, shape)`` and flax's
``lax.select(mask, inputs / keep_prob, 0)`` bit for bit
(``utils/prng.py``): in f32 an IEEE division by float32(1 - rate); in bf16 the
division by bf16(1 - rate), as JAX divides a bf16 array by a weakly typed
Python float, rounded once to bf16. ``offset`` = ``batch0`` times the elements
of a row places a data-parallel rank's rows in the global draw. JAX computes
this in XLA, not in a Pallas kernel: D1 has no Pallas counterpart.

``ThreefryDropout`` is the differentiable op: its backward is the same kernel
on the cotangent (flax's autodiff of ``select(mask, x / keep, 0)`` is
``select(mask, g / keep, 0)``), the mask recomputed from the key, so no mask
and no input is kept.

A CPU tensor takes the plain version (``threefry_dropout_ref``: the mask of
``utils/prng.bernoulli`` and ``torch.where``). A CUDA tensor launches the
kernel or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ...utils import costs, prng
from ._build import launch_args, load, raise_on


def keep_divisor(rate: float, dtype: torch.dtype) -> torch.Tensor:
    """``1 - rate`` in ``dtype``: what flax's ``inputs / keep_prob`` divides
    by (a weakly typed Python float takes the array's dtype)."""
    return torch.tensor(1.0 - rate, dtype=dtype)


def _offset(x: torch.Tensor, batch0: int) -> int:
    return int(batch0) * (math.prod(x.shape[1:]) if x.dim() else 1)


def threefry_dropout_ref(x: torch.Tensor, key, rate: float, batch0: int = 0) -> torch.Tensor:
    """D1's plain version: flax ``nn.Dropout(rate)`` on ``x`` from ``key``,
    rows b being rows ``batch0`` + b of the global draw."""
    keep = prng.bernoulli(key, 1.0 - rate, x.shape, _offset(x, batch0), x.device)
    return torch.where(keep, x / keep_divisor(rate, x.dtype).to(x.device), torch.zeros_like(x))


@functools.cache
def _library():
    lib = load("threefry_dropout")
    p, ll, u, f, i = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint, ctypes.c_float,
                      ctypes.c_int)
    for entry in (lib.threefry_dropout_f32, lib.threefry_dropout_bf16):
        entry.argtypes = [p, p, ll, ll, u, u, u, f, i, p]
        entry.restype = i
    lib.threefry_dropout_error_string.argtypes = [i]
    lib.threefry_dropout_error_string.restype = ctypes.c_char_p
    return lib


def _d1_cost(x, *args, **kwargs):
    return costs.dropout_call_cost(x)


@costs.counted("D1", _d1_cost)
def threefry_dropout_kernel(x: torch.Tensor, key, rate: float, batch0: int = 0) -> torch.Tensor:
    """D1: ``threefry_dropout_ref``'s function, the kernel on a CUDA tensor
    (counted in ``threefry_dropout_kernel.launches``), the plain version on a
    CPU tensor. f32 or bf16."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"D1 takes f32 or bf16, got {x.dtype}")
    if x.device.type == "cpu":
        return threefry_dropout_ref(x, key, rate, batch0)
    if x.device.type != "cuda":
        raise ValueError(f"D1 runs on cpu or cuda, not {x.device}")
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    k0, k1 = (int(k) & prng.MASK32 for k in key)
    lib = _library()
    entry = lib.threefry_dropout_f32 if x.dtype == torch.float32 else lib.threefry_dropout_bf16
    err = entry(x.data_ptr(), y.data_ptr(), x.numel(), _offset(x, batch0), k0, k1,
                prng.keep_threshold23(1.0 - rate), float(keep_divisor(rate, x.dtype)),
                *launch_args(x))
    raise_on(err, "threefry_dropout", lib.threefry_dropout_error_string, n=x.numel())
    threefry_dropout_kernel.launches += 1
    return y


class ThreefryDropout(torch.autograd.Function):
    """D1 forward, D1 on the cotangent backward: nothing saved but the key."""

    @staticmethod
    def forward(ctx, x, key, rate, batch0):
        ctx.args = (tuple(key), rate, batch0)
        return threefry_dropout_kernel(x, key, rate, batch0)

    @staticmethod
    def backward(ctx, g):
        return threefry_dropout_kernel(g.contiguous(), *ctx.args), None, None, None


def threefry_dropout(x: torch.Tensor, key, rate: float, batch0: int = 0) -> torch.Tensor:
    """flax ``nn.Dropout(rate)(x, deterministic=False)`` with the dropout key
    ``key``: ``ThreefryDropout`` when a gradient is needed, else D1 alone.
    Rate 0 returns x and rate 1 zeros, as flax does (neither draws)."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if torch.is_grad_enabled() and x.requires_grad:
        return ThreefryDropout.apply(x, tuple(key), rate, int(batch0))
    return threefry_dropout_kernel(x, key, rate, batch0)


# kernel launches since the last reset (chip_smoke.py reads them)
threefry_dropout_kernel.launches = 0
