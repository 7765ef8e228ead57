"""Fused STFT: the hand-written CUDA kernel B4 and its plain PyTorch version.

``stft_fused`` (``csrc/stft_fused.cu``) replaces ``stft_pallas`` of
``speech_enhancement_by_s3prl_tpu/ops/pallas/stft_kernel.py``: reflect-padded
framing, Hann window and real DFT as one product with the window-folded
matrix, without a padded waveform or a frame matrix in device memory. It
computes in f32 with f32 accumulation. It is forward-only, as the TPU kernel
is: ``ops/stft.stft`` routes here only where no gradient is needed.

A CPU tensor takes the plain version. A CUDA tensor launches the kernel or
raises; nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from ..stft import _dft_tensors, _needs_grad, _stft_matmul
from ._build import launch_args, load, raise_on


def stft_fused_ref(wavs: torch.Tensor, n_fft: int, win_length: int, hop: int) -> torch.Tensor:
    """B4's plain version: reflect pad, ``unfold``, one matmul with the
    window-folded DFT matrix. (..., time) -> (..., 1 + time // hop,
    2 * (n_fft // 2 + 1)) packed [re | im]."""
    return _stft_matmul(wavs, n_fft, win_length, hop)


def _library():
    lib = load("stft_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.stft_fused_f32.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.stft_fused_f32.restype = i
    lib.stft_fused_error_string.argtypes = [i]
    lib.stft_fused_error_string.restype = ctypes.c_char_p
    return lib


def stft_fused(wavs: torch.Tensor, n_fft: int, win_length: int, hop: int) -> torch.Tensor:
    """(..., time) f32 -> (..., 1 + time // hop, 2 * (n_fft // 2 + 1)) f32,
    packed [re | im], torch.stft's ``center=True`` reflect framing with a
    periodic Hann window of ``win_length``.

    Leading axes are flattened to rows of one launch. On a CUDA tensor the
    kernel, counted in ``stft_fused.launches``; on a CPU tensor the plain
    version. Raises where a gradient is needed (the kernel has no backward)
    and, as ``F.pad`` does, when ``time <= n_fft // 2``."""
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
    if wavs.device.type == "cpu":
        return stft_fused_ref(wavs, n_fft, win_length, hop)
    lead = wavs.shape[:-1]
    x = wavs.reshape(-1, time).contiguous()
    fwd, _, _ = _dft_tensors(n_fft, win_length, wavs.device)
    n_frames, n_out = 1 + time // hop, fwd.shape[1]
    out = torch.empty((x.shape[0], n_frames, n_out), device=x.device, dtype=torch.float32)
    if x.shape[0]:
        lib = _library()
        err = lib.stft_fused_f32(x.data_ptr(), fwd.data_ptr(), out.data_ptr(), x.shape[0],
                                 time, n_fft, hop, n_out, *launch_args(x))
        raise_on(err, "stft_fused", lib.stft_fused_error_string, rows=x.shape[0],
                 time=time, n_fft=n_fft, hop=hop)
        stft_fused.launches += 1
    return out.reshape(lead + (n_frames, n_out))


# kernel launches since the last reset
stft_fused.launches = 0
