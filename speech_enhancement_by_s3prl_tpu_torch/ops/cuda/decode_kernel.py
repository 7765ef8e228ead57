"""Fused decode: the hand-written CUDA kernel B5 and its plain PyTorch version.

``decode_ola`` replaces ``decode_ola_pallas`` of
``speech_enhancement_by_s3prl_tpu/ops/pallas/decode_kernel.py``: magnitude
from the predicted spectrum, the packed phase carrier rescaled to it, the
inverse real DFT with the synthesis window and the overlap-add in one kernel,
without a rescaled spectrum or a frame matrix in device memory. It computes
in f32 with f32 accumulation. It is forward-only, as the TPU kernel is:
``ops/stft.istft`` routes here only where no gradient is needed, and trims
and divides by the window envelope itself.

Two kernels compute the same function, chosen by ``n_fft`` alone
(``decode_route``), never because the other failed:

- ``"fft"`` (``csrc/decode_fft.cu``): the rescaled spectrum packed into an
  n_fft / 2-point complex sequence, a mixed-radix inverse FFT of each frame
  in shared memory (the Stockham passes of the fused STFT's FFT kernel,
  ``csrc/fft_stockham.cuh``), then window and overlap-add, for every
  ``n_fft`` that ``stft_kernel.fft_plan`` takes (the flagship's 400). The
  TPU kernel multiplies by the window-folded inverse-DFT matrix because the
  matrix unit is the TPU's only fast arithmetic; on this card that product
  (322 k operations a frame at 400 points) binds, while the FFT's ~13 k
  leave the bytes as the bound.
- ``"product"`` (``csrc/decode_ola.cu``): that matrix product on the CUDA
  cores, for every other ``n_fft`` (e.g. 254 = 2 * 127).

``decode_fft_tables`` and ``decode_fft_model`` are the FFT kernel's
algorithm in Python: the float64-built window / twiddle / unpack tables the
kernel reads, and its steps on those tables. The CPU tests hold the model
against the plain version and the JAX package; the kernel is a transcription
of it.

A CPU tensor takes the plain version. A CUDA tensor launches the kernel or
raises; nothing falls back. The choice is the dispatcher's: ``decode_ola``
calls the op ``se_torch::decode`` (``ops/cuda/library.py``), whose CPU kernel
is the plain version and whose CUDA kernel is ``_decode_cuda``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..stft import (
    _decode_matmul,
    _dft_tensors,
    _needs_grad,
    _overlap_add,
    _padded_window,
    _rescale_carrier,
)
from ...utils import costs
from ._build import launch_args, load, raise_on
from .stft_kernel import _fft_operands, _stockham, fft_plan


def decode_ola_ref(pred: torch.Tensor, uph: torch.Tensor, n_fft: int, win_length: int,
                   hop: int, linear_power: float = 2.0) -> torch.Tensor:
    """B5's plain version: rescale, one matmul with the inverse DFT matrix,
    synthesis window, shifted adds. pred (B, T', F), uph (B, T', 2F) ->
    the raw overlap-add (B, (T' + K - 1) * hop), K = ceil(n_fft / hop):
    untrimmed, not divided by the window envelope, zero from sample
    ``n_fft + (T' - 1) * hop`` on."""
    return _decode_matmul(pred, uph, n_fft, win_length, hop, linear_power)


def decode_route(n_fft: int) -> str:
    """Which kernel ``decode_ola`` launches on a CUDA tensor: ``"fft"``
    where ``fft_plan`` takes ``n_fft``, else ``"product"``."""
    return "fft" if fft_plan(n_fft) is not None else "product"


@functools.lru_cache(maxsize=8)
def decode_fft_tables(n_fft: int, win_length: int) -> np.ndarray:
    """The FFT decode kernel's tables as one f32 array of 3 * n_fft + 2
    values, built in float64: the padded synthesis window divided by
    M = n_fft / 2 (the inverse transform's 1 / M; the packing's halves make
    it the inverse real DFT's 1 / n_fft), the twiddles exp(-2 pi i t / M) of
    the forward passes (the inverse runs them on swapped parts) as M real
    then M imaginary parts, and the unpack factors exp(+2 pi i k / n_fft),
    k = 0 .. M, likewise."""
    m = n_fft // 2
    t = np.arange(m, dtype=np.float64) * (2.0 * math.pi / m)
    k = np.arange(m + 1, dtype=np.float64) * (2.0 * math.pi / n_fft)
    sp_re, sp_im = np.cos(k), np.sin(k)
    sp_re[m], sp_im[m] = -1.0, 0.0  # exp(i pi) exactly
    window = _padded_window(win_length, n_fft).astype(np.float64) / m
    return np.concatenate([window, np.cos(t), -np.sin(t), sp_re, sp_im]).astype(np.float32)


def decode_fft_model(pred: torch.Tensor, uph: torch.Tensor, n_fft: int, win_length: int,
                     hop: int, linear_power: float = 2.0) -> torch.Tensor:
    """The FFT decode kernel's arithmetic, step by step, on the tables of
    ``decode_fft_tables``, as torch ops over all frames at once (a model of
    the kernel for the CPU tests, not a route). pred (B, T', F), uph
    (B, T', 2F) -> the raw overlap-add (B, (T' + K - 1) * hop), as
    ``decode_ola_ref``:

    1. the rescaled spectrum X[0..M], M = n_fft / 2, with Im X[0] and
       Im X[M] zeroed (the inverse real DFT reads neither);
    2. Z[k] = E[k] + i O[k], k < M, E = (X[k] + conj X[M - k]) / 2,
       O = (X[k] - conj X[M - k]) exp(+2 pi i k / n_fft) / 2, stored swapped
       (Re Z as the imaginary part, Im Z as the real part);
    3. the forward Stockham passes (``_stockham``), which on swapped data
       give the inverse transform swapped: x[2n] from the imaginary part,
       x[2n + 1] from the real part;
    4. times the window / M, and the overlap-add of hop-row r summed over
       the slots j = 0 .. K - 1 of frames r - j in j order."""
    plan = fft_plan(n_fft)
    if plan is None:
        raise ValueError(f"the FFT decode kernel does not take n_fft = {n_fft}")
    m = n_fft // 2
    tables = torch.from_numpy(decode_fft_tables(n_fft, win_length)).to(pred.device)
    window, twr, twi, spr, spi = torch.split(tables, [n_fft, m, m, m + 1, m + 1])
    b, t = pred.shape[:2]
    mag = pred ** (1.0 / linear_power) if linear_power != 1.0 else pred
    xr, xi = _rescale_carrier(mag, uph, m + 1)
    xi[..., 0] = 0.0
    xi[..., m] = 0.0
    k = torch.arange(m, device=pred.device)
    ar, ai, yr, yi = xr[..., :m], xi[..., :m], xr[..., m - k], xi[..., m - k]
    er, ei = 0.5 * (ar + yr), 0.5 * (ai - yi)
    dr, di = 0.5 * (ar - yr), 0.5 * (ai + yi)
    o_r, o_i = dr * spr[:m] - di * spi[:m], dr * spi[:m] + di * spr[:m]
    zr, zi = _stockham(ei + o_r, er - o_i, plan, twr, twi)
    frames = torch.stack([zi, zr], dim=-1).reshape(b, t, n_fft) * window
    return _overlap_add(frames, hop)


@functools.lru_cache(maxsize=16)
def _windowed_inverse(n_fft: int, win_length: int, device: torch.device) -> torch.Tensor:
    """(2F, n_fft) inverse real-DFT matrix with the synthesis window folded in."""
    with torch.inference_mode(False):
        _, inv, window = _dft_tensors(n_fft, win_length, device)
        return (inv * window).contiguous()


@functools.cache
def _product_library():
    lib = load("decode_ola")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_ola_f32.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, i, p]
    lib.decode_ola_f32.restype = i
    lib.decode_ola_error_string.argtypes = [i]
    lib.decode_ola_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _fft_library():
    lib = load("decode_fft")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_fft_f32.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, ctypes.POINTER(i),
                                   i, i, i, p]
    lib.decode_fft_f32.restype = i
    lib.decode_fft_error_string.argtypes = [i]
    lib.decode_fft_error_string.restype = ctypes.c_char_p
    return lib


def _launch(route: str, pred: torch.Tensor, uph: torch.Tensor, out: torch.Tensor, n_fft: int,
            win_length: int, hop: int, linear_power: float, fpw: int = 0) -> None:
    """One launch of the ``route`` kernel on contiguous pred (B, T', F) and
    uph (B, T', 2F) into ``out`` (B, (T' + K - 1) * hop); raises on a CUDA
    error. ``fpw`` > 0 forces the FFT kernel's frames a warp (a
    measurement); 0 lets the kernel pick them by grid size."""
    B, T, F = pred.shape
    if route == "fft":
        lib, errstr = _fft_library(), "decode_fft_error_string"
        tables, radices, n_passes = _fft_operands(n_fft, win_length, pred.device,
                                                  decode_fft_tables)
        err = lib.decode_fft_f32(pred.data_ptr(), uph.data_ptr(), tables.data_ptr(),
                                 out.data_ptr(), B, T, n_fft, hop, float(linear_power),
                                 radices, n_passes, fpw, *launch_args(pred))
    else:
        lib, errstr = _product_library(), "decode_ola_error_string"
        winv = _windowed_inverse(n_fft, win_length, pred.device)
        err = lib.decode_ola_f32(pred.data_ptr(), uph.data_ptr(), winv.data_ptr(),
                                 out.data_ptr(), B, T, F, n_fft, hop, float(linear_power),
                                 *launch_args(pred))
    raise_on(err, f"decode_ola ({route})", getattr(lib, errstr), B=B, T=T, F=F, n_fft=n_fft,
             hop=hop)


@costs.counted("B5", lambda pred, uph, n_fft, win_length, hop, linear_power=2.0:
               costs.decode_call_cost(pred, n_fft, hop))
def decode_ola(pred: torch.Tensor, uph: torch.Tensor, n_fft: int, win_length: int,
               hop: int, linear_power: float = 2.0) -> torch.Tensor:
    """pred (B, T', F) non-negative spectrum, uph (B, T', 2F) packed
    [re | im] carrier, both f32 -> the raw overlap-add waveform
    (B, (T' + K - 1) * hop) f32: magnitude ``pred ** (1 / linear_power)``
    (a square root at power 2), carrier rescaled by magnitude / |z| with
    (1, 0) at |z| = 0, inverse DFT with the synthesis window, overlap-add.
    The caller slices ``[n_fft // 2 : n_fft // 2 + (T' - 1) * hop]`` and
    divides by the window-square envelope.

    On a CUDA tensor the kernel ``decode_route(n_fft)`` names (the inverse
    FFT where its plan takes ``n_fft``, the matrix product otherwise: a
    dispatch by shape, not a fallback), counted in ``decode_ola.launches``
    and by route in ``decode_ola.by_route``; on a CPU tensor the plain
    version. Raises where a gradient is needed (the kernels have no
    backward)."""
    if pred.dim() != 3 or uph.dim() != 3 or uph.shape != pred.shape[:2] + (2 * pred.shape[2],):
        raise ValueError(f"decode_ola takes pred (B, T', F) and uph (B, T', 2F), got "
                         f"{tuple(pred.shape)} and {tuple(uph.shape)}")
    if pred.shape[2] != n_fft // 2 + 1:
        raise ValueError(f"pred has {pred.shape[2]} bins, n_fft {n_fft} has {n_fft // 2 + 1}")
    if pred.dtype != torch.float32 or uph.dtype != torch.float32:
        raise ValueError(f"decode_ola takes f32 tensors, got {pred.dtype} / {uph.dtype}")
    if pred.device != uph.device:
        raise ValueError(f"pred on {pred.device} but uph on {uph.device}")
    if pred.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_ola runs on cpu or cuda, not {pred.device}")
    if not linear_power > 0:
        raise ValueError(f"linear_power must be positive, got {linear_power}")
    if _needs_grad(pred, uph):
        raise RuntimeError(
            "decode_ola is forward-only: take istft(..., fused=False) where the "
            "decode sits in a gradient")
    from .library import decode

    return decode(pred, uph, n_fft, win_length, hop, float(linear_power))


def _decode_cuda(pred: torch.Tensor, uph: torch.Tensor, n_fft: int, win_length: int,
                 hop: int, linear_power: float) -> torch.Tensor:
    """B5 on CUDA tensors: the kernel ``decode_route(n_fft)`` names, one
    launch and its counts (zeros and none for B = 0 or T' = 0). The CUDA
    kernel of the op ``se_torch::decode``."""
    B, T, _ = pred.shape
    K = -(-n_fft // hop)
    out = torch.empty((B, (T + K - 1) * hop), device=pred.device, dtype=torch.float32)
    if B == 0 or T == 0:
        return out.zero_()
    route = decode_route(n_fft)
    _launch(route, pred.contiguous(), uph.contiguous(), out, n_fft, win_length, hop,
            linear_power)
    decode_ola.launches += 1
    decode_ola.by_route[route] += 1
    return out


# kernel launches since the last reset, and the same by kernel
decode_ola.launches = 0
decode_ola.by_route = {"fft": 0, "product": 0}
