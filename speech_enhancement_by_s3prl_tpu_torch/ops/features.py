"""Feature engine (counterpart of
``speech_enhancement_by_s3prl_tpu/ops/features.py``).

A ``feat_list`` of dicts ``{feat_type, channel, log, delta, cmvn}`` with
feat_type in {complx, linear, phase, uphase, mel, mfcc} is computed from one
STFT per (batch, channel). 'linear' is the POWER spectrum; 'uphase' carries
the phase as the packed [re | im] spectrum, which ``istft`` rescales to the
target magnitude. Frame count: ``n_frames = 1 + time // hop``.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch

from .mel import mel_to_mfcc, power_to_mel
from .stft import StftParams, istft as _istft, stft as _stft

FEAT_TYPES = ("complx", "linear", "phase", "uphase", "mel", "mfcc")


def compute_deltas(feat: torch.Tensor, win_length: int = 5) -> torch.Tensor:
    """Delta features over the time axis (torchaudio ``compute_deltas``
    semantics: symmetric difference kernel, replicate padding).

    feat: (..., time, dim)
    """
    n = (win_length - 1) // 2
    denom = sum(i * i for i in range(1, n + 1)) * 2.0
    padded = torch.cat(
        [feat[..., :1, :].expand(*feat.shape[:-2], n, feat.shape[-1]), feat,
         feat[..., -1:, :].expand(*feat.shape[:-2], n, feat.shape[-1])],
        dim=-2,
    )
    time = feat.shape[-2]
    out = torch.zeros_like(feat)
    for i in range(-n, n + 1):
        if i == 0:
            continue
        out = out + i * padded[..., i + n : i + n + time, :]
    return out / denom


def apply_cmvn(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Per-utterance mean/variance normalization over time, with the
    unbiased (ddof=1) std."""
    mean = feat.mean(dim=-2, keepdim=True)
    var = ((feat - mean) ** 2).sum(dim=-2, keepdim=True) / max(feat.shape[-2] - 1, 1)
    return (feat - mean) / (torch.sqrt(var) + eps)


def get_feat_config(
    feat_type: str, channel: int = 0, log: bool = False, delta: int = 0,
    cmvn: bool = False,
) -> Dict[str, Any]:
    if feat_type not in FEAT_TYPES:
        raise ValueError(f"unknown feat_type {feat_type!r}")
    return {
        "feat_type": feat_type,
        "channel": channel,
        "log": log,
        "delta": delta,
        "cmvn": cmvn,
    }


def feat_dim(cfg: Dict[str, Any], params: "PreprocessorConfig") -> int:
    base = {
        "complx": 2 * params.stft.n_freq,
        "linear": params.stft.n_freq,
        "phase": params.stft.n_freq,
        "uphase": 2 * params.stft.n_freq,
        "mel": params.n_mels,
        "mfcc": params.n_mfcc,
    }[cfg["feat_type"]]
    return base * (1 + int(cfg.get("delta", 0)))


@dataclass(frozen=True)
class PreprocessorConfig:
    sample_rate: int = 16000
    win_ms: float = 25.0
    hop_ms: float = 10.0
    n_freq: int = 201
    n_mels: int = 40
    n_mfcc: int = 13
    eps: float = 1e-10

    @property
    def stft(self) -> StftParams:
        return StftParams(
            sample_rate=self.sample_rate,
            win_ms=self.win_ms,
            hop_ms=self.hop_ms,
            n_freq=self.n_freq,
        )


class OnlinePreprocessor:
    """``preprocessor(wavs)`` with wavs (batch, channel, time) returns one
    feature tensor per feat_list entry, each (batch, n_frames, dim), on the
    device of ``wavs``. ``preprocessor(device=...)`` with no wavs returns
    dummy features for shape inference. Extra constructor kwargs (dataset
    fields that ride along in a pretraining config) are ignored."""

    def __init__(
        self,
        sample_rate: int = 16000,
        win_ms: float = 25.0,
        hop_ms: float = 10.0,
        n_freq: int = 201,
        n_mels: int = 40,
        n_mfcc: int = 13,
        feat_list: Optional[List[Dict[str, Any]]] = None,
        eps: float = 1e-10,
        **kwargs,
    ):
        self.config = PreprocessorConfig(
            sample_rate=sample_rate,
            win_ms=win_ms,
            hop_ms=hop_ms,
            n_freq=n_freq,
            n_mels=n_mels,
            n_mfcc=n_mfcc,
            eps=eps,
        )
        self.feat_list = copy.deepcopy(feat_list) if feat_list is not None else None
        self._win_args = {
            "n_fft": self.config.stft.n_fft,
            "hop_length": self.config.stft.hop_length,
            "win_length": self.config.stft.win_length,
        }

    def extract(self, wavs: torch.Tensor, feat_list: Sequence[Dict[str, Any]]):
        """wavs (B, C, T) -> list of (B, n_frames, dim)."""
        cfg = self.config
        # only transform the channels the feat_list references: dataset
        # batches carry three channels but the six-feature bundle reads two
        used = sorted({int(f.get("channel", 0)) for f in feat_list})
        if len(used) < wavs.shape[1]:
            wavs = wavs[:, used]
            remap = {c: i for i, c in enumerate(used)}
        else:
            remap = None
        complx = _stft(wavs, cfg.stft)  # (B, C_used, T', 2F)
        re, im = complx[..., : cfg.n_freq], complx[..., cfg.n_freq :]
        power = re * re + im * im

        cache: Dict[str, torch.Tensor] = {
            "complx": complx,
            "linear": power,
            "uphase": complx,
        }

        # not recursive: a closure that called itself would be a reference
        # cycle holding these features (GiBs at hundreds of rows) until the
        # garbage collector next ran
        def base_feat(feat_type: str) -> torch.Tensor:
            if feat_type in cache:
                return cache[feat_type]
            if feat_type in ("mel", "mfcc") and "mel" not in cache:
                cache["mel"] = power_to_mel(power, cfg.n_mels, cfg.sample_rate)
            if feat_type == "phase":
                cache["phase"] = torch.atan2(im, re)
            elif feat_type == "mfcc":
                cache["mfcc"] = mel_to_mfcc(cache["mel"], cfg.n_mfcc)
            elif feat_type != "mel":
                raise ValueError(f"unknown feat_type {feat_type}")
            return cache[feat_type]

        outs = []
        for f in feat_list:
            ch = int(f.get("channel", 0))
            if remap is not None:
                ch = remap[ch]
            feat = base_feat(f["feat_type"])[:, ch]
            if f.get("log", False):
                feat = torch.log(feat + cfg.eps)
            if int(f.get("delta", 0)) > 0:
                parts = [feat]
                for _ in range(int(f["delta"])):
                    parts.append(compute_deltas(parts[-1]))
                feat = torch.cat(parts, dim=-1)
            if f.get("cmvn", False):
                feat = apply_cmvn(feat)
            outs.append(feat)
        return outs

    def __call__(self, wavs=None, feat_list=None, device=None):
        feat_list = self.feat_list if feat_list is None else feat_list
        if feat_list is None:
            raise ValueError("no feat_list given")
        if wavs is None:
            if device is None:
                raise ValueError("a dummy call needs an explicit device")
            max_ch = max(int(f.get("channel", 0)) for f in feat_list)
            wavs = torch.zeros(
                (1, max_ch + 1, self.config.sample_rate), device=device
            )
        return self.extract(wavs, feat_list)

    def istft(self, linears=None, phases=None, linear_power: float = 2.0):
        """Waveform reconstruction with the (noisy) phase."""
        return _istft(linears, phases, self.config.stft, linear_power=linear_power)

    def feat_dims(self, feat_list=None) -> List[int]:
        feat_list = self.feat_list if feat_list is None else feat_list
        return [feat_dim(f, self.config) for f in feat_list]
