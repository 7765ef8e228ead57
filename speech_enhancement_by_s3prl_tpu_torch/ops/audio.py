"""Waveform-level tensor utilities (counterpart of
``speech_enhancement_by_s3prl_tpu/ops/audio.py``): mask-based, so they work
on padded batches."""
from __future__ import annotations

import torch


def length_masks(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len) {0,1} f32 mask."""
    ascending = torch.arange(max_len, device=lengths.device)[None, :]
    return (ascending < lengths[:, None]).to(torch.float32)


def masked_mean(batch, masks, keepdims: bool = False, eps: float = 1e-8):
    """Mean over the valid region only."""
    return (batch * masks).sum(dim=-1, keepdim=keepdims) / (
        masks.sum(dim=-1, keepdim=keepdims) + eps
    )


def masked_normalize_decibel(audio, target, masks, eps: float = 1e-8):
    """Renormalize each utterance's RMS level to a target dB.

    ``target`` may be a python scalar (fixed dB, e.g. -25), a (B,) tensor of
    per-utterance dB levels, or a (B, T) reference waveform whose masked dB
    level is matched.
    """
    target = torch.as_tensor(target, dtype=audio.dtype, device=audio.device)
    if target.dim() == 0:
        target = target.expand(audio.shape[0])
    elif target.dim() > 1:
        target = 10.0 * torch.log10(masked_mean(target**2, masks) + eps)
    scalar_square = (10.0 ** (target[:, None] / 10.0)) / (
        masked_mean(audio**2, masks, keepdims=True) + eps
    )
    return audio * torch.sqrt(scalar_square)
