"""Training objectives (counterpart of
``speech_enhancement_by_s3prl_tpu/objectives/__init__.py``).

Every loss is ``criterion(**step_context) -> (loss, aux_dict)``: the step
context carries whichever tensors a loss reads, masked by the STFT frame
lengths. Spectral losses read the POWER spectrogram ('linear' features).
The perceptual losses are ``stoi`` / ``estoi`` (the negative scores of
``metrics/stoi.py`` on the masked waveforms of the eval step) and ``pmsqe``
(``objectives/pmsqe.py``); the trainer calls every objective with TF32 off.
``WSD``'s aux carries a figure logger that the Runner calls at ``log_step``.

Each objective also names the count its loss averages over,
``weight(**step_context)`` (a 0-d f32 tensor on the batch's device): ``L1``
the valid frames times the bins, every other objective the rows. A
data-parallel step (``parallel/mesh.py``) combines the ranks' losses as
sum_r w_r L_r / sum_r w_r, and their gradients the same way, which is the
loss of the single-process step on the global batch: with ragged lengths the
plain mean of the ranks' ``L1`` losses is not. ``WSD``'s voice threshold reads
the largest frame energy of the batch; a data-parallel step hands it
``reduce_max`` (the maximum across the ranks) in the step context.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..metrics.stoi import stoi_coeff_batch
from ..utils.plotting import spectrograms_png
from .pmsqe import PMSQE

Aux = Dict[str, Any]


class _RowMean:
    """An objective whose loss is a mean over the batch's rows."""

    def weight(self, stft_length_masks, **kwargs):
        # filled on the device: a tensor copied from the host would make the
        # host wait for the step's queued work
        return stft_length_masks.new_full((), float(stft_length_masks.shape[0]))


class L1:
    """Log-spectral L1: mean |log_pred - log(tar + eps)| over valid frames
    (the sum divided by the mask mass times the bin count)."""

    def __init__(self, eps: float = 1e-10, **kwargs):
        self.eps = eps

    def weight(self, stft_length_masks, linear_tar, **kwargs):
        return stft_length_masks.sum() * linear_tar.shape[-1]

    def __call__(self, log_predicted, linear_tar, stft_length_masks, **kwargs):
        mask = stft_length_masks[..., None]
        diff = torch.abs(log_predicted - torch.log(linear_tar + self.eps)) * mask
        loss = diff.sum() / (stft_length_masks.sum() * log_predicted.shape[-1])
        return loss, {}


class SISDR(_RowMean):
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


class sisdr(_RowMean):
    """Negative SI-SDR (no zero mean) over the flattened masked
    (frames x bins) spectrum of each utterance."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, predicted, linear_tar, stft_length_masks, **kwargs):
        mask = stft_length_masks[..., None]
        src = (predicted * mask).reshape(predicted.shape[0], -1)
        tar = (linear_tar * mask).reshape(linear_tar.shape[0], -1)
        return -_si_sdr_core(src, tar, zero_mean=False).mean(), {}


class _StoiLoss(_RowMean):
    """Negative (E)STOI on the masked waveforms, without silent-frame
    removal. The waveforms exist only in the eval step's context, as in the
    JAX package: a train step with this objective fails on the missing
    ``wav_predicted``."""

    extended = False

    def __init__(self, sample_rate: int = 16000, **kwargs):
        self.sample_rate = sample_rate

    def __call__(self, wav_predicted, wav_tar, length_masks, **kwargs):
        src = wav_predicted * length_masks
        tar = wav_tar * length_masks
        # stoi_coeff_batch takes (clean reference, processed)
        return -stoi_coeff_batch(tar, src, self.sample_rate, extended=self.extended,
                                 remove_silent=False).mean(), {}


class stoi(_StoiLoss):
    """Negative STOI on masked waveforms."""


class estoi(_StoiLoss):
    """Negative extended STOI on masked waveforms."""

    extended = True


class pmsqe(_RowMean):
    """PMSQE perceptual loss on masked power spectra (``objectives/pmsqe.py``)."""

    def __init__(self, **kwargs):
        self._fn = PMSQE()

    def __call__(self, predicted, linear_tar, stft_length_masks, **kwargs):
        mask = stft_length_masks[..., None]
        return self._fn(predicted * mask, linear_tar * mask, stft_length_masks), {}


class WSD(_RowMean):
    """Weighted speech distortion on the mask ``offset``: a voice-activity
    mask from an energy-dB threshold gates the speech-distortion term; the
    noise-leakage term penalizes mask response on the noise excess. Its aux
    holds a ``logger(log, global_step)`` closure that draws the five
    spectrograms of utterance 0 (target, input, frame energy, voiced target,
    noise excess) as one figure, ``WSD_variables``."""

    # the Runner re-runs the forward at log_step to call the logger
    has_logger = True

    def __init__(self, alpha: float = 0.5, db_interval: float = 30, eps: float = 1e-10,
                 **kwargs):
        self.alpha = alpha
        self.db_interval = db_interval
        self.eps = eps

    def __call__(self, linear_inp, offset, linear_tar, stft_length_masks, reduce_max=None,
                 **kwargs):
        S, G = linear_tar, offset
        N = torch.relu(linear_inp - linear_tar)

        energy = S.sum(dim=-1, keepdim=True)
        # the batch's largest frame energy (across the ranks of a data-parallel
        # step); it only sets a threshold, so no gradient passes through it
        peak = energy.max() if reduce_max is None else reduce_max(energy.max().detach())
        db_thres = 10.0 * torch.log10(peak + self.eps) - self.db_interval
        voice_mask = (10.0 * torch.log10(energy + self.eps) > db_thres).to(S.dtype)

        mask = stft_length_masks[..., None]
        speech_diff = (S - G * S) * voice_mask * mask
        speech_loss = (speech_diff ** 2).sum(dim=(-1, -2)).mean()
        noise_loss = ((G * N * mask) ** 2).sum(dim=(-1, -2)).mean()

        def logger(log, global_step):
            s, inp, e, sv, n = (t[0].detach().cpu().numpy()
                                for t in (S, linear_inp, energy, S * voice_mask, N))
            panels = (s, inp, np.broadcast_to(e, s.shape), sv, n)
            log.add_png("WSD_variables",
                        spectrograms_png([np.log(p + self.eps) for p in panels]), global_step)

        loss = self.alpha * speech_loss + (1.0 - self.alpha) * noise_loss
        return loss, {"logger": logger}


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
