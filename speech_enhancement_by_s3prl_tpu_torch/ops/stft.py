"""STFT / iSTFT in PyTorch, with the JAX package's conventions
(``speech_enhancement_by_s3prl_tpu/ops/stft.py``).

- Framing identical to ``torch.stft(center=True, pad_mode='reflect',
  onesided=True, normalized=False)`` with a periodic Hann window:
  ``n_frames = 1 + len // hop``.
- ``magphase`` returns the POWER spectrum plus phase.
- ``istft(power, phase)`` reconstructs with ``power ** (1/2)`` as magnitude,
  trims the centre padding and returns ``(n_frames - 1) * hop`` samples.

The forward transform is frames times the window-folded real-DFT matrix
(one ``torch.matmul``), the same matrix the JAX package convolves with. A
matmul keeps it out of cuDNN, whose f32 convolutions default to TF32.
The fused STFT and decode kernels (ROADMAP B4, B5) are not ported yet.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window — matches ``torch.hann_window(periodic=True)``."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * math.pi * n / win_length)
    return w.astype(dtype)


def _padded_window(win_length: int, n_fft: int) -> np.ndarray:
    """Hann window zero-padded symmetrically to n_fft (torch.stft behavior)."""
    w = hann_window(win_length)
    if win_length == n_fft:
        return w
    if win_length > n_fft:
        raise ValueError(f"win_length {win_length} > n_fft {n_fft}")
    left = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float32)
    out[left : left + win_length] = w
    return out


@functools.lru_cache(maxsize=8)
def _dft_kernels(n_fft: int, win_length: int):
    """Window-folded real-DFT analysis kernel and synthesis kernel (numpy).

    Returns:
      fwd: (n_fft, 2 * n_freq) — frames @ fwd = [real | imag] of rFFT(w * x)
      inv: (2 * n_freq, n_fft) — [real | imag] @ inv = irFFT, *without* window
      window: (n_fft,)
    """
    n_freq = n_fft // 2 + 1
    window = _padded_window(win_length, n_fft)
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_freq, dtype=np.float64)[None, :]
    ang = 2.0 * math.pi * n * k / n_fft
    cos, sin = np.cos(ang), np.sin(ang)
    # rFFT with e^{-i theta}: real = sum x cos, imag = -sum x sin
    fwd = np.concatenate([window[:, None] * cos, window[:, None] * -sin], axis=1)

    # inverse rDFT: x_n = (1/N) * sum_k c_k * (re_k cos - im_k sin),
    # c_k = 1 for k in {0, N/2}, else 2 (onesided hermitian completion).
    c = np.full(n_freq, 2.0)
    c[0] = 1.0
    if n_fft % 2 == 0:
        c[-1] = 1.0
    inv = np.concatenate([(c[:, None] * cos.T), (c[:, None] * -sin.T)], axis=0) / n_fft
    return (
        np.asarray(fwd, dtype=np.float32),
        np.asarray(inv, dtype=np.float32),
        np.asarray(window, dtype=np.float32),
    )


@dataclass(frozen=True)
class StftParams:
    """STFT geometry: 25 ms window, 10 ms hop, 201 bins at 16 kHz."""

    sample_rate: int = 16000
    win_ms: float = 25.0
    hop_ms: float = 10.0
    n_freq: int = 201

    @property
    def win_length(self) -> int:
        return round(self.win_ms * self.sample_rate / 1000)

    @property
    def hop_length(self) -> int:
        return round(self.hop_ms * self.sample_rate / 1000)

    @property
    def n_fft(self) -> int:
        return (self.n_freq - 1) * 2

    def n_frames(self, num_samples: int) -> int:
        return 1 + num_samples // self.hop_length


def stft(wavs: torch.Tensor, params: StftParams) -> torch.Tensor:
    """(..., time) f32 -> (..., n_frames, 2 * n_freq) with real parts in
    [..., :n_freq] and imaginary parts in [..., n_freq:].

    The reflect padding needs ``time > n_fft // 2`` samples."""
    n_fft, hop = params.n_fft, params.hop_length
    lead = wavs.shape[:-1]
    time = wavs.shape[-1]
    n_frames = params.n_frames(time)
    x = wavs.reshape(-1, 1, time)
    x = F.pad(x, (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)  # (N, n_frames, n_fft), a view
    fwd, _, _ = _dft_kernels(n_fft, params.win_length)
    out = torch.matmul(frames, torch.from_numpy(fwd).to(wavs.device))
    return out.reshape(lead + (n_frames, 2 * params.n_freq))


def magphase(complx: torch.Tensor, n_freq: int, power: float = 2.0):
    """Split packed [real | imag] into (power-spectrum, phase)."""
    re, im = complx[..., :n_freq], complx[..., n_freq:]
    sq = re * re + im * im
    if power == 2.0:
        mag = sq
    elif power == 1.0:
        mag = torch.sqrt(sq)
    else:
        mag = sq ** (power / 2.0)
    return mag, torch.atan2(im, re)


def istft(
    linear: torch.Tensor,
    phase: torch.Tensor,
    params: StftParams,
    linear_power: float = 2.0,
) -> torch.Tensor:
    """Inverse STFT from (power-)magnitude + phase, torch.istft semantics.

    ``phase`` is either radians, (..., n_frames, n_freq), or the packed
    ``[re | im]`` spectrum of the 'uphase' feature, (..., n_frames,
    2 * n_freq), which is rescaled to the target magnitude; at |z| = 0 the
    carrier is the unit vector (1, 0), as arctan2 gives phase 0 there.

    Returns (..., (n_frames - 1) * hop)."""
    n_fft, hop, n_freq = params.n_fft, params.hop_length, params.n_freq
    lead = linear.shape[:-2]
    n_frames = linear.shape[-2]

    mag = linear ** (1.0 / linear_power) if linear_power != 1.0 else linear
    if phase.shape[-1] == 2 * n_freq:
        zre, zim = phase[..., :n_freq], phase[..., n_freq:]
        zmag = torch.sqrt(zre * zre + zim * zim)
        nonzero = zmag > 0.0
        inv_z = 1.0 / torch.where(nonzero, zmag, torch.ones_like(zmag))
        re = mag * torch.where(nonzero, zre * inv_z, torch.ones_like(zre))
        im = mag * torch.where(nonzero, zim * inv_z, torch.zeros_like(zim))
    else:
        re = mag * torch.cos(phase)
        im = mag * torch.sin(phase)
    packed = torch.cat([re, im], dim=-1).reshape(-1, n_frames, 2 * n_freq)

    _, inv, window = _dft_kernels(n_fft, params.win_length)
    dev = linear.device
    frames = torch.matmul(packed, torch.from_numpy(inv).to(dev)) * torch.from_numpy(
        window
    ).to(dev)  # (B, n_frames, n_fft)

    wav = _overlap_add(frames, hop)  # (B, n_fft + (n_frames-1)*hop)

    start = n_fft // 2
    length = (n_frames - 1) * hop
    wav = wav[:, start : start + length]
    env = torch.from_numpy(
        _ola_envelope_np(n_fft, params.win_length, hop, n_frames)[
            start : start + length
        ]
    ).to(dev)
    wav = wav / torch.where(env > 1e-11, env, torch.ones_like(env))
    return wav.reshape(lead + (length,))


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add as K = ceil(n_fft/hop) shifted dense adds: slot j of
    frame t lands exactly at hop-slot (t + j) of the output."""
    b, n_frames, n_fft = frames.shape
    k = -(-n_fft // hop)
    pad = k * hop - n_fft
    if pad:
        frames = F.pad(frames, (0, pad))
    slots = frames.reshape(b, n_frames, k, hop)

    out_slots = n_frames + k - 1
    wav = frames.new_zeros((b, out_slots, hop))
    for j in range(k):
        wav[:, j : j + n_frames] += slots[:, :, j]
    return wav.reshape(b, out_slots * hop)[:, : n_fft + (n_frames - 1) * hop]


@functools.lru_cache(maxsize=32)
def _ola_envelope_np(n_fft: int, win_length: int, hop: int, n_frames: int):
    """Window-square overlap-add envelope, summed in f64 (numpy)."""
    w2 = _padded_window(win_length, n_fft).astype(np.float64) ** 2
    out = np.zeros(n_fft + (n_frames - 1) * hop)
    for t in range(n_frames):
        out[t * hop : t * hop + n_fft] += w2
    return out.astype(np.float32)
