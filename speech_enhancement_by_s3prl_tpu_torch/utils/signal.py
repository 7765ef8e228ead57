"""Signal toolbox: silence removal and resampling (counterpart of
``speech_enhancement_by_s3prl_tpu/utils/signal.py``).

Both run on the device of the tensors they are given; their constants (the
window, the filter) are built there.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=2)
def _hann_nozero(n: int) -> np.ndarray:
    return np.hanning(n + 2)[1:-1].astype(np.float32)


def remove_silence(
    x: torch.Tensor,
    y: torch.Tensor,
    dyn_range: float = 40.0,
    framelen: int = 256,
    hop: int = 128,
    use_ref: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """STOI-style silent-frame removal on a pair of 1-D signals.

    Frames both signals (hann window), drops frames whose energy is more
    than ``dyn_range`` dB below the loudest frame (measured on ``y`` when
    ``use_ref``), and overlap-adds the kept frames. The shapes do not depend
    on the data: kept frames move to the front in order, and the returned
    signals are zero beyond ``n_kept * hop + hop`` (also returned).

    Returns (x_speech, y_speech, n_valid_samples)."""
    w = torch.from_numpy(_hann_nozero(framelen)).to(x.device)
    n_frames = max((x.shape[-1] - framelen) // hop + 1, 1)
    idx = (torch.arange(n_frames, device=x.device)[:, None] * hop
           + torch.arange(framelen, device=x.device)[None, :])
    xf = x[idx] * w
    yf = y[idx] * w

    basis = yf if use_ref else xf
    energies = 20.0 * torch.log10(torch.linalg.norm(basis, dim=-1) + 1e-12)
    keep = (energies.max() - dyn_range - energies) < 0

    order = torch.argsort((~keep).to(torch.int8), stable=True)
    kept = keep[order].to(x.dtype)[:, None]
    xk = xf[order] * kept
    yk = yf[order] * kept

    out_len = (n_frames - 1) * hop + framelen
    pos = idx.reshape(-1)
    x_out = torch.zeros(out_len, dtype=x.dtype, device=x.device).index_add_(
        0, pos, xk.reshape(-1))
    y_out = torch.zeros(out_len, dtype=y.dtype, device=y.device).index_add_(
        0, pos, yk.reshape(-1))
    n_valid = keep.sum() * hop + hop
    return x_out, y_out, n_valid


@functools.lru_cache(maxsize=8)
def _resample_filter(width: int, orig_freq: int, new_freq: int):
    """(windowed-sinc taps at the polyphase rate, up, down)."""
    g = math.gcd(orig_freq, new_freq)
    up, down = new_freq // g, orig_freq // g
    cutoff = 0.99 * 0.5 * min(orig_freq, new_freq)
    poly_rate = orig_freq * up
    half_width = int(math.ceil(width * poly_rate / (2.0 * cutoff)))
    t = np.arange(-half_width, half_width + 1, dtype=np.float64) / poly_rate
    win = np.where(
        np.abs(t) < width / (2.0 * cutoff),
        0.5 * (1 + np.cos(2 * math.pi * cutoff / width * t)),
        0.0,
    )
    sinc = 2 * cutoff / orig_freq * np.sinc(2 * cutoff * t)
    return (win * sinc).astype(np.float32), up, down


class Resampler:
    """Polyphase sinc resampler, Kaldi convention (lowpass at 0.99 * Nyquist
    of the lower rate, configurable filter width): the input zero-stuffed by
    ``up`` and filtered by one strided convolution."""

    def __init__(self, lowpass_filter_width: int = 6):
        self.width = lowpass_filter_width

    def __call__(self, waveform: torch.Tensor, orig_freq: int, new_freq: int):
        """(..., T) -> (..., ceil(T * new / orig))."""
        if orig_freq == new_freq:
            return waveform
        h, up, down = _resample_filter(self.width, int(orig_freq), int(new_freq))
        lead = waveform.shape[:-1]
        t = waveform.shape[-1]
        xb = waveform.reshape(-1, 1, t)
        stuffed = xb.new_zeros(xb.shape[0], 1, (t - 1) * up + 1)
        stuffed[..., ::up] = xb
        k = len(h) // 2
        stuffed = F.pad(stuffed, (k, k + up * down))
        taps = torch.from_numpy(h).to(device=waveform.device, dtype=waveform.dtype)
        out = F.conv1d(stuffed, taps[None, None, :], stride=down)
        n_out = int(math.ceil(t * up / down))
        # the taps' amplitude 2 * cutoff / orig already makes up for the
        # zero-stuffing's attenuation
        return out[:, 0, :n_out].reshape(lead + (n_out,))
