"""Evaluation metrics (counterpart of
``speech_enhancement_by_s3prl_tpu/metrics/__init__.py``), SI-SDR only.

``batch_scores`` scores a whole padded batch on its device; STOI, ESTOI
and PESQ are not ported yet and raise.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

PORTED_METRICS = ("sisdr",)


def si_sdr_batch(src: torch.Tensor, tar: torch.Tensor, lengths=None, eps: float = 1e-10):
    """Scale-invariant SDR per utterance, (B, T) -> (B,). Zero padding
    cancels in the inner products, so masking equals trimming."""
    if lengths is not None:
        ascending = torch.arange(src.shape[-1], device=src.device)[None, :]
        mask = (ascending < lengths[:, None]).to(src.dtype)
        src = src * mask
        tar = tar * mask
    alpha = (src * tar).sum(-1) / ((tar * tar).sum(-1) + eps)
    ay = alpha[:, None] * tar
    norm = ((ay - src) ** 2).sum(-1) + eps
    return 10.0 * torch.log10((ay * ay).sum(-1) / norm + eps)


def check_metrics(names: Sequence[str]) -> None:
    """Raise on a metric the port cannot score."""
    for name in names:
        if name not in PORTED_METRICS:
            raise NotImplementedError(
                f"metric {name!r} is not ported yet (STOI, ESTOI and PESQ are "
                "ROADMAP A6); the port scores 'sisdr'"
            )


def batch_scores(
    names: Sequence[str],
    wav_predicted: torch.Tensor,
    wav_tar: torch.Tensor,
    lengths: torch.Tensor,
    sample_rate: int = 16000,
) -> Dict[str, torch.Tensor]:
    """{name: (B,) scores} on the device of the inputs."""
    check_metrics(names)
    return {name: si_sdr_batch(wav_predicted, wav_tar, lengths) for name in names}
