"""STFT / iSTFT in PyTorch, with the JAX package's conventions
(``speech_enhancement_by_s3prl_tpu/ops/stft.py``).

- Framing identical to ``torch.stft(center=True, pad_mode='reflect',
  onesided=True, normalized=False)`` with a periodic Hann window:
  ``n_frames = 1 + len // hop``.
- ``magphase`` returns the POWER spectrum plus phase.
- ``istft(power, phase)`` reconstructs with ``power ** (1/2)`` as magnitude,
  trims the centre padding and returns ``(n_frames - 1) * hop`` samples.

Both transforms have two bodies. The kernel branch is the fused STFT
(``ops/cuda/stft_kernel.stft_fused``, kernel B4) and the fused decode
(``ops/cuda/decode_kernel.decode_ola``, kernel B5): a CUDA tensor launches
the kernel, a CPU tensor runs its plain version. The torch-op body is frames
times the window-folded real-DFT matrix (one ``torch.matmul``, the same
matrix the JAX package convolves with; a matmul keeps it out of cuDNN, whose
f32 convolutions default to TF32) and its inverse with a scatter-free
overlap-add; it is differentiable. ``fused=None`` takes the kernel branch
whenever no gradient is needed. Both kernels are forward-only, as they are in
the JAX package.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

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


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


@functools.lru_cache(maxsize=16)
def _dft_tensors(n_fft: int, win_length: int, device: torch.device):
    """``_dft_kernels`` as f32 tensors on ``device``: (fwd, inv, window).
    Built outside inference mode, so that autograd may save them later."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device)
                     for a in _dft_kernels(n_fft, win_length))


def _stft_matmul(wavs: torch.Tensor, n_fft: int, win_length: int, hop: int) -> torch.Tensor:
    """The torch-op STFT: reflect pad, ``unfold`` into frames (a view), one
    matmul with the window-folded DFT matrix. Differentiable."""
    lead = wavs.shape[:-1]
    time = wavs.shape[-1]
    x = wavs.reshape(-1, 1, time)
    x = F.pad(x, (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)  # (N, n_frames, n_fft), a view
    fwd, _, _ = _dft_tensors(n_fft, win_length, wavs.device)
    out = torch.matmul(frames, fwd)
    return out.reshape(lead + (1 + time // hop, fwd.shape[1]))


def stft(wavs: torch.Tensor, params: StftParams, fused: Optional[bool] = None) -> torch.Tensor:
    """(..., time) f32 -> (..., n_frames, 2 * n_freq) with real parts in
    [..., :n_freq] and imaginary parts in [..., n_freq:].

    ``fused=True`` is kernel B4 (``stft_fused``: on a CUDA tensor the
    kernel, on a CPU tensor its plain version), ``fused=False`` the
    differentiable torch-op body. ``None`` takes the kernel whenever no
    gradient is needed (grad mode off, or ``wavs`` does not require one).
    The kernel is forward-only: ``fused=True`` raises where a gradient is
    needed.

    The reflect padding needs ``time > n_fft // 2`` samples."""
    if fused is None:
        fused = not _needs_grad(wavs)
    if fused:
        from .cuda.stft_kernel import stft_fused

        return stft_fused(wavs, params.n_fft, params.win_length, params.hop_length)
    return _stft_matmul(wavs, params.n_fft, params.win_length, params.hop_length)


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


def _rescale_carrier(mag: torch.Tensor, packed: torch.Tensor, n_freq: int):
    """(re, im) of the packed [re | im] carrier rescaled to magnitude ``mag``;
    at |z| = 0 the carrier is the unit vector (1, 0), as arctan2 gives phase
    0 there."""
    zre, zim = packed[..., :n_freq], packed[..., n_freq:]
    zmag = torch.sqrt(zre * zre + zim * zim)
    nonzero = zmag > 0.0
    inv_z = 1.0 / torch.where(nonzero, zmag, torch.ones_like(zmag))
    re = mag * torch.where(nonzero, zre * inv_z, torch.ones_like(zre))
    im = mag * torch.where(nonzero, zim * inv_z, torch.zeros_like(zim))
    return re, im


def _synthesize_ola(re: torch.Tensor, im: torch.Tensor, n_fft: int, win_length: int,
                    hop: int) -> torch.Tensor:
    """(B, T', F) real and imaginary parts -> the raw overlap-add (B,
    (T' + K - 1) * hop): inverse DFT, synthesis window, ``_overlap_add``.
    Untrimmed and not divided by the window envelope."""
    packed = torch.cat([re, im], dim=-1)
    _, inv, window = _dft_tensors(n_fft, win_length, re.device)
    frames = torch.matmul(packed, inv) * window  # (B, T', n_fft)
    return _overlap_add(frames, hop)


def _decode_matmul(pred, uph, n_fft: int, win_length: int, hop: int,
                   linear_power: float = 2.0) -> torch.Tensor:
    """The torch-op decode of a packed carrier: pred (B, T', F), uph (B, T',
    2F) -> raw overlap-add (B, (T' + K - 1) * hop). Differentiable."""
    mag = pred ** (1.0 / linear_power) if linear_power != 1.0 else pred
    re, im = _rescale_carrier(mag, uph, pred.shape[-1])
    return _synthesize_ola(re, im, n_fft, win_length, hop)


def istft(
    linear: torch.Tensor,
    phase: torch.Tensor,
    params: StftParams,
    linear_power: float = 2.0,
    fused: Optional[bool] = None,
) -> torch.Tensor:
    """Inverse STFT from (power-)magnitude + phase, torch.istft semantics.

    ``phase`` is either radians, (..., n_frames, n_freq), or the packed
    ``[re | im]`` spectrum of the 'uphase' feature, (..., n_frames,
    2 * n_freq), which is rescaled to the target magnitude; at |z| = 0 the
    carrier is the unit vector (1, 0), as arctan2 gives phase 0 there.

    With a packed carrier, ``fused=True`` is kernel B5 (``decode_ola``: on a
    CUDA tensor the kernel, on a CPU tensor its plain version) and
    ``fused=False`` the differentiable torch-op body; ``None`` takes the
    kernel whenever no gradient is needed (grad mode off, or neither input
    requires one). B5 has no backward kernel, in the JAX package neither: a
    decode that sits in a gradient keeps the torch-op body, and ``fused=True``
    raises there. The radian form never takes the kernel. Trimming the centre
    padding and dividing by the window-square envelope happen here on either
    route.

    Returns (..., (n_frames - 1) * hop)."""
    n_fft, hop, n_freq = params.n_fft, params.hop_length, params.n_freq
    lead = linear.shape[:-2]
    n_frames = linear.shape[-2]

    if phase.shape[-1] == 2 * n_freq:
        if fused is None:
            fused = not _needs_grad(linear, phase)
        pred = linear.reshape(-1, n_frames, n_freq)
        uph = phase.reshape(-1, n_frames, 2 * n_freq)
        if fused:
            from .cuda.decode_kernel import decode_ola

            wav = decode_ola(pred, uph, n_fft, params.win_length, hop, linear_power)
        else:
            wav = _decode_matmul(pred, uph, n_fft, params.win_length, hop, linear_power)
    else:
        mag = linear ** (1.0 / linear_power) if linear_power != 1.0 else linear
        re = (mag * torch.cos(phase)).reshape(-1, n_frames, n_freq)
        im = (mag * torch.sin(phase)).reshape(-1, n_frames, n_freq)
        wav = _synthesize_ola(re, im, n_fft, params.win_length, hop)

    start = n_fft // 2
    length = (n_frames - 1) * hop
    wav = wav[:, start : start + length]
    wav = wav / _ola_divisor(n_fft, params.win_length, hop, n_frames, linear.device)
    return wav.reshape(lead + (length,))


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add as K = ceil(n_fft/hop) shifted dense adds: slot j of
    frame t lands exactly at hop-slot (t + j) of the output. Returns all
    (n_frames + K - 1) hop-slots, (B, (n_frames + K - 1) * hop); samples
    from ``n_fft + (n_frames - 1) * hop`` on are zero."""
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
    return wav.reshape(b, out_slots * hop)


@functools.lru_cache(maxsize=32)
def _ola_envelope_np(n_fft: int, win_length: int, hop: int, n_frames: int):
    """Window-square overlap-add envelope, summed in f64 (numpy)."""
    w2 = _padded_window(win_length, n_fft).astype(np.float64) ** 2
    out = np.zeros(n_fft + (n_frames - 1) * hop)
    for t in range(n_frames):
        out[t * hop : t * hop + n_fft] += w2
    return out.astype(np.float32)


def _ola_divisor(n_fft: int, win_length: int, hop: int, n_frames: int,
                 device: torch.device) -> torch.Tensor:
    """What ``istft`` divides the trimmed overlap-add by: the window-square
    envelope over samples ``n_fft // 2`` .. ``n_fft // 2 + (n_frames - 1) *
    hop``, 1 where it is below 1e-11. Built once per geometry, length and
    device (not copied to the card on every call), outside inference mode,
    so that autograd may save it later. While a graph is traced
    (``torch.export``) it is built afresh, a constant of that graph: a cache
    entry made then would hold the tracer's tensor, not one an eager call
    can read."""
    if torch.compiler.is_compiling():
        return _ola_divisor_tensor(n_fft, win_length, hop, n_frames, device)
    return _ola_divisor_cached(n_fft, win_length, hop, n_frames, device)


def _ola_divisor_tensor(n_fft: int, win_length: int, hop: int, n_frames: int,
                        device: torch.device) -> torch.Tensor:
    start = n_fft // 2
    env = _ola_envelope_np(n_fft, win_length, hop, n_frames)[start : start + (n_frames - 1) * hop]
    with torch.inference_mode(False):
        return torch.from_numpy(np.where(env > 1e-11, env, np.float32(1.0))).to(device)


_ola_divisor_cached = functools.lru_cache(maxsize=64)(_ola_divisor_tensor)
