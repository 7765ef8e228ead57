"""Training objectives (counterpart of
``speech_enhancement_by_s3prl_tpu/objectives/__init__.py``).

Every loss is ``criterion(**step_context) -> (loss, aux_dict)``: the step
context carries whichever tensors a loss reads, masked by the STFT frame
lengths. Spectral losses read the POWER spectrogram ('linear' features).
The perceptual losses (``stoi``, ``estoi``, ``pmsqe``) are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

Aux = Dict[str, Any]


class L1:
    """Log-spectral L1: mean |log_pred - log(tar + eps)| over valid frames
    (the sum divided by the mask mass times the bin count)."""

    def __init__(self, eps: float = 1e-10, **kwargs):
        self.eps = eps

    def __call__(self, log_predicted, linear_tar, stft_length_masks, **kwargs):
        mask = stft_length_masks[..., None]
        diff = torch.abs(log_predicted - torch.log(linear_tar + self.eps)) * mask
        loss = diff.sum() / (stft_length_masks.sum() * log_predicted.shape[-1])
        return loss, {}


class SISDR:
    """Scale-invariant SDR on sqrt-magnitude spectra."""

    def __init__(self, eps: float = 1e-10, **kwargs):
        self.eps = eps

    def __call__(self, predicted, linear_tar, stft_length_masks, **kwargs):
        mask = stft_length_masks[..., None]
        src = torch.sqrt(torch.relu(predicted)) * mask
        tar = torch.sqrt(torch.relu(linear_tar)) * mask
        src = src.reshape(src.shape[0], -1)
        tar = tar.reshape(tar.shape[0], -1)
        alpha = (src * tar).sum(-1) / ((tar * tar).sum(-1) + self.eps)
        ay = alpha[:, None] * tar
        norm = ((ay - src) ** 2).sum(-1) + self.eps
        loss = -10.0 * torch.log10((ay * ay).sum(-1) / norm + self.eps)
        return loss.mean(), {}


def _si_sdr_core(est, tar, zero_mean: bool, eps: float = 1e-8):
    """SI-SDR of flattened signals, (B, N) -> (B,)."""
    if zero_mean:
        est = est - est.mean(dim=-1, keepdim=True)
        tar = tar - tar.mean(dim=-1, keepdim=True)
    dot = (est * tar).sum(-1, keepdim=True)
    s_tar_energy = (tar * tar).sum(-1, keepdim=True) + eps
    scaled_tar = dot * tar / s_tar_energy
    e_noise = est - scaled_tar
    ratio = (scaled_tar ** 2).sum(-1) / ((e_noise ** 2).sum(-1) + eps)
    return 10.0 * torch.log10(ratio + eps)


class sisdr:
    """Negative SI-SDR (no zero mean) over the flattened masked
    (frames x bins) spectrum of each utterance."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, predicted, linear_tar, stft_length_masks, **kwargs):
        mask = stft_length_masks[..., None]
        src = (predicted * mask).reshape(predicted.shape[0], -1)
        tar = (linear_tar * mask).reshape(linear_tar.shape[0], -1)
        return -_si_sdr_core(src, tar, zero_mean=False).mean(), {}


class WSD:
    """Weighted speech distortion on the mask ``offset``: a voice-activity
    mask from an energy-dB threshold gates the speech-distortion term; the
    noise-leakage term penalizes mask response on the noise excess. The JAX
    package's spectrogram-figure logger (matplotlib + TensorBoard) is not
    ported: the aux dict is empty."""

    def __init__(self, alpha: float = 0.5, db_interval: float = 30, eps: float = 1e-10,
                 **kwargs):
        self.alpha = alpha
        self.db_interval = db_interval
        self.eps = eps

    def __call__(self, linear_inp, offset, linear_tar, stft_length_masks, **kwargs):
        S, G = linear_tar, offset
        N = torch.relu(linear_inp - linear_tar)

        energy = S.sum(dim=-1, keepdim=True)
        db_thres = 10.0 * torch.log10(energy.max() + self.eps) - self.db_interval
        voice_mask = (10.0 * torch.log10(energy + self.eps) > db_thres).to(S.dtype)

        mask = stft_length_masks[..., None]
        speech_diff = (S - G * S) * voice_mask * mask
        speech_loss = (speech_diff ** 2).sum(dim=(-1, -2)).mean()
        noise_loss = ((G * N * mask) ** 2).sum(dim=(-1, -2)).mean()
        loss = self.alpha * speech_loss + (1.0 - self.alpha) * noise_loss
        return loss, {}


class _NotPorted:
    def __init__(self, **kwargs):
        raise NotImplementedError(
            f"objective {type(self).__name__} is not ported yet: the "
            "perceptual objectives are ROADMAP A6, the port's next slice (the "
            "metrics of A6 are ported)"
        )


class stoi(_NotPorted):
    """Negative STOI (ROADMAP A6)."""


class estoi(_NotPorted):
    """Negative extended STOI (ROADMAP A6)."""


class pmsqe(_NotPorted):
    """PMSQE perceptual loss (ROADMAP A6)."""


OBJECTIVE_REGISTRY = {
    "L1": L1,
    "SISDR": SISDR,
    "sisdr": sisdr,
    "stoi": stoi,
    "estoi": estoi,
    "pmsqe": pmsqe,
    "WSD": WSD,
}


def build_objective(name: str, **cfg):
    """The objective registered under ``name``, built from its config."""
    if name not in OBJECTIVE_REGISTRY:
        raise ValueError(f"unknown objective {name}")
    return OBJECTIVE_REGISTRY[name](**cfg)
