"""Fused decode: the hand-written CUDA kernel B5 and its plain PyTorch version.

``decode_ola`` (``csrc/decode_ola.cu``) replaces ``decode_ola_pallas`` of
``speech_enhancement_by_s3prl_tpu/ops/pallas/decode_kernel.py``: magnitude
from the predicted spectrum, the packed phase carrier rescaled to it, the
window-folded inverse DFT and the overlap-add in one kernel, without a
rescaled spectrum or a frame matrix in device memory. It computes in f32 with
f32 accumulation. It is forward-only, as the TPU kernel is: ``ops/stft.istft``
routes here only where no gradient is needed, and trims and divides by the
window envelope itself.

A CPU tensor takes the plain version. A CUDA tensor launches the kernel or
raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..stft import _decode_matmul, _dft_tensors, _needs_grad
from ._build import launch_args, load, raise_on


def decode_ola_ref(pred: torch.Tensor, uph: torch.Tensor, n_fft: int, win_length: int,
                   hop: int, linear_power: float = 2.0) -> torch.Tensor:
    """B5's plain version: rescale, one matmul with the inverse DFT matrix,
    synthesis window, shifted adds. pred (B, T', F), uph (B, T', 2F) ->
    the raw overlap-add (B, (T' + K - 1) * hop), K = ceil(n_fft / hop):
    untrimmed, not divided by the window envelope, zero from sample
    ``n_fft + (T' - 1) * hop`` on."""
    return _decode_matmul(pred, uph, n_fft, win_length, hop, linear_power)


@functools.lru_cache(maxsize=16)
def _windowed_inverse(n_fft: int, win_length: int, device: torch.device) -> torch.Tensor:
    """(2F, n_fft) inverse real-DFT matrix with the synthesis window folded in."""
    with torch.inference_mode(False):
        _, inv, window = _dft_tensors(n_fft, win_length, device)
        return (inv * window).contiguous()


def _library():
    lib = load("decode_ola")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_ola_f32.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, i, p]
    lib.decode_ola_f32.restype = i
    lib.decode_ola_error_string.argtypes = [i]
    lib.decode_ola_error_string.restype = ctypes.c_char_p
    return lib


def decode_ola(pred: torch.Tensor, uph: torch.Tensor, n_fft: int, win_length: int,
               hop: int, linear_power: float = 2.0) -> torch.Tensor:
    """pred (B, T', F) non-negative spectrum, uph (B, T', 2F) packed
    [re | im] carrier, both f32 -> the raw overlap-add waveform
    (B, (T' + K - 1) * hop) f32: magnitude ``pred ** (1 / linear_power)``
    (a square root at power 2), carrier rescaled by magnitude / |z| with
    (1, 0) at |z| = 0, inverse DFT with the synthesis window, overlap-add.
    The caller slices ``[n_fft // 2 : n_fft // 2 + (T' - 1) * hop]`` and
    divides by the window-square envelope.

    On a CUDA tensor the kernel, counted in ``decode_ola.launches``; on a
    CPU tensor the plain version. Raises where a gradient is needed (the
    kernel has no backward)."""
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
    if pred.device.type == "cpu":
        return decode_ola_ref(pred, uph, n_fft, win_length, hop, linear_power)
    B, T, F = pred.shape
    K = -(-n_fft // hop)
    out = torch.empty((B, (T + K - 1) * hop), device=pred.device, dtype=torch.float32)
    if B == 0 or T == 0:
        return out.zero_()
    pred, uph = pred.contiguous(), uph.contiguous()
    winv = _windowed_inverse(n_fft, win_length, pred.device)
    lib = _library()
    err = lib.decode_ola_f32(pred.data_ptr(), uph.data_ptr(), winv.data_ptr(),
                             out.data_ptr(), B, T, F, n_fft, hop, float(linear_power),
                             *launch_args(pred))
    raise_on(err, "decode_ola", lib.decode_ola_error_string, B=B, T=T, F=F, n_fft=n_fft,
             hop=hop)
    decode_ola.launches += 1
    return out


# kernel launches since the last reset
decode_ola.launches = 0
