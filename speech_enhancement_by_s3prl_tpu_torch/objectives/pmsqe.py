"""PMSQE, the Perceptual Metric for Speech Quality Evaluation as a loss
(counterpart of ``speech_enhancement_by_s3prl_tpu/objectives/pmsqe.py``).

A differentiable distortion modeled on PESQ's perceptual pipeline
(Martin-Donas et al., IEEE SPL 2018) between masked power spectra:
level normalization, bark-band grouping, partial gain equalization,
Zwicker-law loudness, then symmetric and asymmetric disturbances averaged
over the valid frames. The bark bands are generated analytically
(Traunmüller bark scale, 49 bands at 16 kHz) for whatever ``n_freq`` the
STFT produces.

Every ``max``, ``min`` and clip is ``torch.maximum`` / ``torch.minimum``,
which split the gradient evenly at a tie, as the JAX package's do
(``torch.clamp`` would pass all of it at a bound). The bark product runs in
full f32: the trainer calls the objective with TF32 off.
"""
from __future__ import annotations

import functools
import numpy as np
import torch

# Zwicker-law and disturbance constants from the PESQ / PMSQE formulation
POWER_FACTOR = 1e7          # target active-band power after normalization
ZWICKER_GAMMA = 0.23
P0 = 1e4                    # modeled hearing threshold per band (flat)
MASK_FACTOR = 0.25
ASYM_CLIP = 12.0
ASYM_FLOOR = 3.0
D_SYM_WEIGHT = 0.1
D_ASYM_WEIGHT = 0.0309      # asteroid's alpha / beta pairing for joint use
SAMPLE_RATE = 16000         # the rate of every spectrum the objective sees
EPS = 1e-8


def hz_to_bark(f):
    return 26.81 * np.asarray(f, dtype=np.float64) / (1960.0 + np.asarray(f)) - 0.53


@functools.lru_cache(maxsize=4)
def bark_matrix(n_freq: int, sample_rate: int):
    """(n_freq, n_bands) averaging matrix over equal-bark-width bands: 49
    bands at 16 kHz and above, 42 below, as the JAX package's."""
    n_bands = 49 if sample_rate >= 16000 else 42
    freqs = np.linspace(0.0, sample_rate / 2.0, n_freq)
    bark = hz_to_bark(freqs)
    edges = np.linspace(bark[1], bark[-1], n_bands + 1)
    mat = np.zeros((n_freq, n_bands), dtype=np.float32)
    idx = np.clip(np.searchsorted(edges, bark) - 1, 0, n_bands - 1)
    for k in range(n_freq):
        mat[k, idx[k]] = 1.0
    # normalize: mean power per band
    counts = mat.sum(axis=0, keepdims=True)
    mat = mat / np.maximum(counts, 1.0)
    return mat


@functools.lru_cache(maxsize=8)
def _tables_on(n_freq: int, device: torch.device):
    """The bark matrix and the 350-3250 Hz band mask on ``device``, made once."""
    f = np.linspace(0, SAMPLE_RATE / 2, n_freq)
    band = ((f > 350) & (f < 3250)).astype(np.float32)
    return (torch.from_numpy(bark_matrix(n_freq, SAMPLE_RATE)).to(device),
            torch.from_numpy(band).to(device))


def _max(x, bound: float):
    # a 0-dim CPU tensor enters a CUDA kernel as a scalar; one made on the
    # card would be a copy that waits for the queued work
    return torch.maximum(x, torch.tensor(bound))


def _clip(x, lo: float, hi: float):
    """``jnp.clip``: maximum, then minimum."""
    return torch.minimum(_max(x, lo), torch.tensor(hi))


class PMSQE:
    """Differentiable PMSQE distortion between power spectra.

    ``__call__(deg_power, ref_power, frame_masks)`` -> scalar loss, with
    deg / ref (B, T, n_freq) power spectra at ``SAMPLE_RATE`` and frame_masks
    (B, T).
    """

    @staticmethod
    def _normalize_power(power, frame_masks, band):
        """Scale so the mean active power in the speech band hits
        POWER_FACTOR (PESQ's level alignment as one gain an utterance)."""
        masked = power * frame_masks[..., None]
        band_power = (masked * band).sum(dim=(-1, -2))
        n_active = _max(frame_masks.sum(-1) * band.sum(), 1.0)
        mean_power = band_power / n_active
        gain = POWER_FACTOR / _max(mean_power, EPS)
        return power * gain[:, None, None]

    @staticmethod
    def _loudness(bark):
        ratio = (0.5 + 0.5 * bark / P0) ** ZWICKER_GAMMA - 1.0
        return ((P0 / 0.5) ** ZWICKER_GAMMA) * _max(ratio, 0.0)

    def __call__(self, deg_power, ref_power, frame_masks):
        mat, band = _tables_on(deg_power.shape[-1], deg_power.device)
        fm = frame_masks.to(deg_power.dtype)
        deg_bark = torch.matmul(self._normalize_power(deg_power, fm, band), mat)
        ref_bark = torch.matmul(self._normalize_power(ref_power, fm, band), mat)

        # partial gain equalization: per-band average ratio, clamped as in
        # PESQ to avoid over-compensation
        num = (ref_bark * fm[..., None]).sum(dim=1) + EPS
        den = (deg_bark * fm[..., None]).sum(dim=1) + EPS
        band_gain = _clip(num / den, 3e-4, 5.0)
        deg_bark = deg_bark * band_gain[:, None, :]

        l_deg = self._loudness(deg_bark)
        l_ref = self._loudness(ref_bark)

        diff = torch.abs(l_deg - l_ref)
        mask_thr = MASK_FACTOR * torch.minimum(l_deg, l_ref)
        d_sym = _max(diff - mask_thr, 0.0)

        asym = ((deg_bark + 50.0) / (ref_bark + 50.0)) ** 1.2
        asym = torch.where(asym < ASYM_FLOOR, torch.zeros_like(asym),
                           torch.minimum(asym, torch.tensor(ASYM_CLIP)))
        d_asym = d_sym * asym

        # per-frame band aggregation (L2-like, as in PMSQE), masked frame mean
        frame_sym = torch.sqrt((d_sym ** 2).mean(dim=-1) + EPS)
        frame_asym = torch.sqrt((d_asym ** 2).mean(dim=-1) + EPS)
        denom = _max(fm.sum(dim=-1), 1.0)
        per_utt = ((D_SYM_WEIGHT * frame_sym + D_ASYM_WEIGHT * frame_asym) * fm).sum(
            dim=-1) / denom
        return per_utt.mean()
