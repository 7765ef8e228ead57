"""The inference half of ``speech_enhancement_by_s3prl_tpu/runner/trainer.py``:
the six-feature context and the waveform decode. The train and eval steps
are ROADMAP A5 and A4."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..ops.audio import length_masks, masked_normalize_decibel


def make_context(
    preprocessor,
    wavs: torch.Tensor,
    lengths: torch.Tensor,
    channel_inp: int,
    channel_tar: int,
) -> Dict[str, torch.Tensor]:
    """Extract the six-feature bundle and assemble the objective context."""
    (
        feats_for_upstream,
        feats_for_downstream,
        linear_inp,
        phase_inp,
        linear_tar,
        phase_tar,
    ) = preprocessor(wavs)

    hop = preprocessor._win_args["hop_length"]
    stft_lengths = lengths // hop + 1
    stft_masks = length_masks(stft_lengths, linear_inp.shape[1])

    return {
        "wavs": wavs,
        "lengths": lengths,
        "feats_for_upstream": feats_for_upstream,
        "feats_for_downstream": feats_for_downstream,
        "linear_inp": linear_inp,
        "phase_inp": phase_inp,
        "linear_tar": linear_tar,
        "phase_tar": phase_tar,
        "stft_lengths": stft_lengths,
        "stft_length_masks": stft_masks,
        "wav_inp": wavs[:, channel_inp, :],
        "wav_tar": wavs[:, channel_tar, :],
    }


def decode_wav(preprocessor, predicted, phase_inp, lengths, max_len, target_level):
    """iSTFT + zero-pad (or cut) to max_len + renorm to target level.

    ``istft`` returns ``(n_frames - 1) * hop`` samples, which the pad or cut
    brings back to the input length."""
    wav = preprocessor.istft(predicted, phase_inp)
    pad = max_len - wav.shape[-1]
    wav = F.pad(wav, (0, pad)) if pad > 0 else wav[:, :max_len]
    masks = length_masks(lengths, max_len)
    return masked_normalize_decibel(wav, target_level, masks)
