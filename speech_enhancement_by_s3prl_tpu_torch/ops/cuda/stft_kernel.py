"""Fused STFT: the hand-written CUDA kernel B4 and its plain PyTorch version.

``stft_fused`` replaces ``stft_pallas`` of
``speech_enhancement_by_s3prl_tpu/ops/pallas/stft_kernel.py``: reflect-padded
framing, Hann window and real DFT in one launch, without a padded waveform or
a frame matrix in device memory, f32 throughout. It is forward-only, as the
TPU kernel is: ``ops/stft.stft`` routes here only where no gradient is needed.

Two kernels compute the same function, chosen by ``n_fft`` alone
(``stft_route``), never because the other failed:

- ``"fft"`` (``csrc/stft_fft.cu``): a mixed-radix FFT of each frame in shared
  memory, for an even ``n_fft`` whose half factors into 2, 3, 4 and 5 (the
  flagship's 400 = 2 * 2^3 * 5^2). The TPU kernel multiplies every frame by
  the window-folded DFT matrix because the matrix unit is the TPU's only fast
  arithmetic; on this card that product (322 k operations a frame at 400
  points) binds, while the FFT's ~17 k leave the bytes that must move anyway
  as the bound.
- ``"product"`` (``csrc/stft_fused.cu``): that matrix product on the CUDA
  cores, for every other ``n_fft`` (a preprocessor section may name any, e.g.
  254 = 2 * 127).

``fft_plan``, ``fft_tables`` and ``stft_fft_model`` are the FFT kernel's
algorithm in Python: the radix list, the float64-built window / twiddle /
split tables the kernel reads, and its passes step by step on those tables.
The CPU tests hold the model against the plain version and the JAX package;
the kernel is a transcription of it.

A CPU tensor takes the plain version. A CUDA tensor launches the kernel or
raises; nothing falls back. The choice is the dispatcher's: ``stft_fused``
calls the op ``se_torch::stft`` (``ops/cuda/library.py``), whose CPU kernel is
the plain version and whose CUDA kernel is ``_stft_cuda``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...utils import costs
from ..stft import _dft_tensors, _needs_grad, _padded_window, _stft_matmul
from ._build import launch_args, load, raise_on

# the largest n_fft whose per-warp buffers (8 warps a block) fit one SM's
# shared memory beside the tables and the staged samples
FFT_MAX_N = 2048
# sin(2 pi / 3); cos and sin of 2 pi / 5 and 4 pi / 5: the radix-3 and radix-5
# butterflies (the same literals stand in csrc/stft_fft.cu)
_S3 = 0.8660254037844386
_C51, _C52 = 0.30901699437494745, -0.8090169943749475
_S51, _S52 = 0.9510565162951535, 0.5877852522924731


@functools.lru_cache(maxsize=None)
def fft_plan(n_fft: int) -> Optional[Tuple[int, ...]]:
    """The radices, in pass order, of the n_fft / 2-point complex FFT that the
    FFT kernel runs on a frame's even/odd-packed samples, or None where it
    does not take ``n_fft``: odd, below 4, above ``FFT_MAX_N``, or with a
    prime factor of n_fft / 2 beyond 5. Odd radices come first: the first
    pass stores at a stride of its radix, which only an odd one keeps free
    of bank conflicts."""
    if n_fft < 4 or n_fft % 2 or n_fft > FFT_MAX_N:
        return None
    m, radices = n_fft // 2, []
    for r in (5, 3, 4, 2):
        while m % r == 0:
            radices.append(r)
            m //= r
    return tuple(radices) if m == 1 else None


def stft_route(n_fft: int) -> str:
    """Which kernel ``stft_fused`` launches on a CUDA tensor: ``"fft"``
    where ``fft_plan`` takes ``n_fft``, else ``"product"``."""
    return "fft" if fft_plan(n_fft) is not None else "product"


@functools.lru_cache(maxsize=8)
def fft_tables(n_fft: int, win_length: int) -> np.ndarray:
    """The FFT kernel's tables as one f32 array of 3 * n_fft + 2 values, built
    in float64: the padded window (n_fft), the twiddles exp(-2 pi i t / M) of
    the M = n_fft / 2-point transform as M real then M imaginary parts, and
    the split pass's exp(-2 pi i k / n_fft), k = 0 .. M, likewise."""
    m = n_fft // 2
    t = np.arange(m, dtype=np.float64) * (2.0 * math.pi / m)
    k = np.arange(m + 1, dtype=np.float64) * (2.0 * math.pi / n_fft)
    sp_re, sp_im = np.cos(k), -np.sin(k)
    sp_re[m], sp_im[m] = -1.0, 0.0  # exp(-i pi) exactly: bin n_fft / 2 is real
    return np.concatenate([_padded_window(win_length, n_fft).astype(np.float64),
                           np.cos(t), -np.sin(t), sp_re, sp_im]).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _fft_operands(n_fft: int, win_length: int, device: torch.device, tables=fft_tables):
    """(``tables(n_fft, win_length)`` as a tensor on ``device``, the plan as
    a C int array, its length): what a launch of an FFT kernel takes beside
    its data (B4's tables by default; B5 passes its own)."""
    plan = fft_plan(n_fft)
    with torch.inference_mode(False):
        on_device = torch.from_numpy(tables(n_fft, win_length)).to(device)
    return on_device, (ctypes.c_int * len(plan))(*plan), len(plan)


def _butterfly(r: int, ar, ai):
    """The r-point DFT (forward, e^{-i}) of lists of real / imaginary parts."""
    if r == 2:
        return [ar[0] + ar[1], ar[0] - ar[1]], [ai[0] + ai[1], ai[0] - ai[1]]
    if r == 3:
        tr, ti = ar[1] + ar[2], ai[1] + ai[2]
        mr, mi = ar[0] - 0.5 * tr, ai[0] - 0.5 * ti
        nr, ni = _S3 * (ar[1] - ar[2]), _S3 * (ai[1] - ai[2])
        # m -+ i n
        return [ar[0] + tr, mr + ni, mr - ni], [ai[0] + ti, mi - nr, mi + nr]
    if r == 4:
        t0r, t0i, t1r, t1i = ar[0] + ar[2], ai[0] + ai[2], ar[0] - ar[2], ai[0] - ai[2]
        t2r, t2i, t3r, t3i = ar[1] + ar[3], ai[1] + ai[3], ar[1] - ar[3], ai[1] - ai[3]
        return ([t0r + t2r, t1r + t3i, t0r - t2r, t1r - t3i],
                [t0i + t2i, t1i - t3r, t0i - t2i, t1i + t3r])
    if r == 5:
        t1r, t1i, t2r, t2i = ar[1] + ar[4], ai[1] + ai[4], ar[2] + ar[3], ai[2] + ai[3]
        t3r, t3i, t4r, t4i = ar[1] - ar[4], ai[1] - ai[4], ar[2] - ar[3], ai[2] - ai[3]
        m1r, m1i = ar[0] + _C51 * t1r + _C52 * t2r, ai[0] + _C51 * t1i + _C52 * t2i
        m2r, m2i = ar[0] + _C52 * t1r + _C51 * t2r, ai[0] + _C52 * t1i + _C51 * t2i
        n1r, n1i = _S51 * t3r + _S52 * t4r, _S51 * t3i + _S52 * t4i
        n2r, n2i = _S52 * t3r - _S51 * t4r, _S52 * t3i - _S51 * t4i
        return ([ar[0] + t1r + t2r, m1r + n1i, m2r + n2i, m2r - n2i, m1r - n1i],
                [ai[0] + t1i + t2i, m1i - n1r, m2i - n2r, m2i + n2r, m1i + n1r])
    raise ValueError(f"no radix-{r} butterfly")


def _stockham(xr: torch.Tensor, xi: torch.Tensor, plan, twr: torch.Tensor,
              twi: torch.Tensor):
    """``csrc/fft_stockham.cuh``'s passes over the last axis (M points) of
    (xr, xi), every frame at once: one Stockham pass per radix of ``plan``,
    butterfly b = p * s + q reading b + k * M / r and writing
    q + s * (r * p + j) times twiddle p * s * j of ``twr`` / ``twi``
    (exp(-2 pi i t / M)), so the forward DFT comes out in natural order with
    no digit reversal. Returns its real and imaginary parts."""
    m = xr.shape[-1]
    s = 1
    for r in plan:
        nb = m // r
        b = torch.arange(nb, device=xr.device)
        q = b % s
        ps = b - q
        br, bi = _butterfly(r, [xr[..., b + k * nb] for k in range(r)],
                            [xi[..., b + k * nb] for k in range(r)])
        yr = xr.new_empty(xr.shape)
        yi = xi.new_empty(xi.shape)
        for j in range(r):
            wr, wi = twr[ps * j], twi[ps * j]
            yr[..., q + ps * r + s * j] = br[j] * wr - bi[j] * wi
            yi[..., q + ps * r + s * j] = br[j] * wi + bi[j] * wr
        xr, xi, s = yr, yi, s * r
    return xr, xi


def stft_fft_model(wavs: torch.Tensor, n_fft: int, win_length: int, hop: int) -> torch.Tensor:
    """The FFT kernel's arithmetic, pass by pass, on the tables of
    ``fft_tables``, as torch ops over all frames at once (a model of the
    kernel for the CPU tests, not a route): window, even samples to the real
    and odd samples to the imaginary part of an M = n_fft / 2-point sequence,
    the Stockham passes of ``fft_plan`` (``_stockham``), then the split pass
    X[k] = E[k] + exp(-2 pi i k / n_fft) O[k], E and O the transforms of the
    even and odd samples recovered from Z[k] and conj(Z[M - k])."""
    plan = fft_plan(n_fft)
    if plan is None:
        raise ValueError(f"the FFT kernel does not take n_fft = {n_fft}")
    m = n_fft // 2
    tables = torch.from_numpy(fft_tables(n_fft, win_length)).to(wavs.device)
    window, twr, twi, spr, spi = torch.split(tables, [n_fft, m, m, m + 1, m + 1])
    lead, time = wavs.shape[:-1], wavs.shape[-1]
    x = F.pad(wavs.reshape(-1, 1, time), (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    z = x.unfold(-1, n_fft, hop) * window
    xr, xi = _stockham(z[..., 0::2], z[..., 1::2], plan, twr, twi)
    k = torch.arange(m + 1, device=wavs.device)
    ka, kb = k % m, (m - k) % m
    er, ei = 0.5 * (xr[..., ka] + xr[..., kb]), 0.5 * (xi[..., ka] - xi[..., kb])
    o_r, o_i = 0.5 * (xi[..., ka] + xi[..., kb]), -0.5 * (xr[..., ka] - xr[..., kb])
    out = torch.cat([er + spr * o_r - spi * o_i, ei + spr * o_i + spi * o_r], dim=-1)
    return out.reshape(lead + (1 + time // hop, 2 * (m + 1)))


def stft_fused_ref(wavs: torch.Tensor, n_fft: int, win_length: int, hop: int) -> torch.Tensor:
    """B4's plain version: reflect pad, ``unfold``, one matmul with the
    window-folded DFT matrix. (..., time) -> (..., 1 + time // hop,
    2 * (n_fft // 2 + 1)) packed [re | im]."""
    return _stft_matmul(wavs, n_fft, win_length, hop)


@functools.cache
def _product_library():
    lib = load("stft_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.stft_fused_f32.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.stft_fused_f32.restype = i
    lib.stft_fused_error_string.argtypes = [i]
    lib.stft_fused_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _fft_library():
    lib = load("stft_fft")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.stft_fft_f32.argtypes = [p, p, p, i, i, i, i, ctypes.POINTER(i), i, i, p]
    lib.stft_fft_f32.restype = i
    lib.stft_fft_error_string.argtypes = [i]
    lib.stft_fft_error_string.restype = ctypes.c_char_p
    return lib


def _launch(route: str, x: torch.Tensor, out: torch.Tensor, n_fft: int, win_length: int,
            hop: int) -> None:
    """One launch of the ``route`` kernel on contiguous rows ``x`` (N, time)
    into ``out`` (N, n_frames, 2 * n_freq); raises on a CUDA error."""
    rows, time = x.shape
    if route == "fft":
        lib, errstr = _fft_library(), "stft_fft_error_string"
        tables, radices, n_passes = _fft_operands(n_fft, win_length, x.device)
        err = lib.stft_fft_f32(x.data_ptr(), tables.data_ptr(), out.data_ptr(), rows, time,
                               n_fft, hop, radices, n_passes, *launch_args(x))
    else:
        lib, errstr = _product_library(), "stft_fused_error_string"
        fwd, _, _ = _dft_tensors(n_fft, win_length, x.device)
        err = lib.stft_fused_f32(x.data_ptr(), fwd.data_ptr(), out.data_ptr(), rows, time,
                                 n_fft, hop, fwd.shape[1], *launch_args(x))
    raise_on(err, f"stft_fused ({route})", getattr(lib, errstr), rows=rows, time=time,
             n_fft=n_fft, hop=hop)


@costs.counted("B4", lambda wavs, n_fft, win_length, hop: costs.stft_call_cost(wavs, n_fft, hop))
def stft_fused(wavs: torch.Tensor, n_fft: int, win_length: int, hop: int) -> torch.Tensor:
    """(..., time) f32 -> (..., 1 + time // hop, 2 * (n_fft // 2 + 1)) f32,
    packed [re | im], torch.stft's ``center=True`` reflect framing with a
    periodic Hann window of ``win_length``.

    Leading axes are flattened to rows of one launch. On a CUDA tensor the
    kernel ``stft_route(n_fft)`` names (the FFT where its plan takes
    ``n_fft``, the matrix product otherwise: a dispatch by shape, not a
    fallback), counted in ``stft_fused.launches`` and by route in
    ``stft_fused.by_route``; on a CPU tensor the plain version. Raises where
    a gradient is needed (the kernels have no backward) and, as ``F.pad``
    does, when ``time <= n_fft // 2``."""
    if wavs.dtype != torch.float32:
        raise ValueError(f"stft_fused takes f32 waveforms, got {wavs.dtype}")
    if wavs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stft_fused runs on cpu or cuda, not {wavs.device}")
    if wavs.dim() < 1:
        raise ValueError("stft_fused needs a (..., time) tensor")
    if _needs_grad(wavs):
        raise RuntimeError(
            "stft_fused is forward-only: take stft(..., fused=False) where a "
            "gradient with respect to the waveform is needed")
    time = wavs.shape[-1]
    if time <= n_fft // 2:
        raise ValueError(
            f"the reflect padding of {n_fft // 2} samples needs more than that "
            f"many input samples, got {time}")
    from .library import stft

    if wavs.dim() == 2:
        return stft(wavs, n_fft, win_length, hop)
    out = stft(wavs.reshape(-1, time), n_fft, win_length, hop)
    return out.reshape(wavs.shape[:-1] + out.shape[1:])


def _stft_cuda(wavs: torch.Tensor, n_fft: int, win_length: int, hop: int) -> torch.Tensor:
    """B4 on CUDA rows (N, time): the kernel ``stft_route(n_fft)`` names, one
    launch and its counts (none for N = 0). The CUDA kernel of the op
    ``se_torch::stft``."""
    x = wavs.contiguous()
    n_frames, n_out = 1 + x.shape[1] // hop, 2 * (n_fft // 2 + 1)
    out = torch.empty((x.shape[0], n_frames, n_out), device=x.device, dtype=torch.float32)
    if x.shape[0]:
        route = stft_route(n_fft)
        _launch(route, x, out, n_fft, win_length, hop)
        stft_fused.launches += 1
        stft_fused.by_route[route] += 1
    return out


# kernel launches since the last reset, and the same by kernel
stft_fused.launches = 0
stft_fused.by_route = {"fft": 0, "product": 0}
