"""Mel filterbank / MFCC building blocks (counterpart of
``speech_enhancement_by_s3prl_tpu/ops/mel.py``).

HTK mel scale, no area normalization, f_min=0, f_max=sr/2; MFCC = DCT-II
(ortho) of log(mel + 1e-6). The matrices are built with numpy exactly as the
JAX package builds them; the hot path is a single matmul.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    n_freq: int, n_mels: int, sample_rate: int, f_min: float = 0.0, f_max=None
) -> np.ndarray:
    """Triangular HTK-mel filterbank, shape (n_freq, n_mels)."""
    f_max = sample_rate / 2 if f_max is None else f_max
    all_freqs = np.linspace(0.0, sample_rate / 2, n_freq)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freq, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return np.asarray(fb, dtype=np.float32)


@functools.lru_cache(maxsize=8)
def dct_matrix(n_input: int, n_coeffs: int) -> np.ndarray:
    """DCT-II basis with 'ortho' norm, shape (n_input, n_coeffs)."""
    n = np.arange(n_input, dtype=np.float64)
    k = np.arange(n_coeffs, dtype=np.float64)
    basis = np.cos(math.pi / n_input * (n[:, None] + 0.5) * k[None, :])
    basis *= math.sqrt(2.0 / n_input)
    basis[:, 0] = 1.0 / math.sqrt(n_input)
    return np.asarray(basis, dtype=np.float32)


def power_to_mel(power: torch.Tensor, n_mels: int, sample_rate: int) -> torch.Tensor:
    """(..., n_freq) power spectrum -> (..., n_mels) mel power spectrum."""
    fb = mel_filterbank(power.shape[-1], n_mels, sample_rate)
    return torch.matmul(power, torch.from_numpy(fb).to(power.device))


def mel_to_mfcc(mel: torch.Tensor, n_mfcc: int, log_offset: float = 1e-6) -> torch.Tensor:
    """(..., n_mels) mel power -> (..., n_mfcc) MFCC (log-mel + ortho DCT-II)."""
    dct = dct_matrix(mel.shape[-1], n_mfcc)
    return torch.matmul(torch.log(mel + log_offset), torch.from_numpy(dct).to(mel.device))
