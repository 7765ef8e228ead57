"""Evaluation metrics (counterpart of
``speech_enhancement_by_s3prl_tpu/metrics/__init__.py``).

Per-utterance functions under the reference's names, ``{metric}_eval``
resolved by name through ``METRIC_REGISTRY`` (sisdr, stoi, estoi, pesq_nb,
pesq_wb), and batched versions that score a whole padded batch on the
device of its inputs: SI-SDR, STOI / ESTOI (``metrics/stoi.py``) and the
P.862 model (``metrics/pesq_model.py``), with length masks in place of
trimming. PESQ moves to the host, one utterance at a time, only where the
ITU ``pesq`` wheel imports (``device_batch_metrics``).

Every metric product runs in full f32: ``batch_scores`` turns TF32 off
around the scoring, because a reduced-precision contraction moves STOI by up
to 0.09 and ESTOI by more.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from .stoi import stoi_coeff_batch, stoi_estoi_batch


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


# -- per-utterance reference API (numpy in, float out) --------------------------

def _pair(src, tar):
    return (torch.from_numpy(np.asarray(src, np.float32))[None],
            torch.from_numpy(np.asarray(tar, np.float32))[None])


def sisdr_eval(src, tar, sr: int = 16000, eps: float = 1e-10) -> float:
    src, tar = _pair(src, tar)
    return float(si_sdr_batch(src, tar, eps=eps)[0])


def stoi_eval(src, tar, sr: int = 16000) -> float:
    """STOI of enhanced ``src`` against the clean reference ``tar``."""
    src, tar = _pair(src, tar)
    return float(stoi_coeff_batch(tar, src, sample_rate=sr, extended=False)[0])


def estoi_eval(src, tar, sr: int = 16000) -> float:
    src, tar = _pair(src, tar)
    return float(stoi_coeff_batch(tar, src, sample_rate=sr, extended=True)[0])


def pesq_nb_eval(src, tar, sr: int = 16000) -> float:
    """ITU-T P.862 narrowband MOS-LQO."""
    from .pesq import pesq_mos_lqo

    return pesq_mos_lqo(np.asarray(tar), np.asarray(src), sr, mode="nb")


def pesq_wb_eval(src, tar, sr: int = 16000) -> float:
    from .pesq import pesq_mos_lqo

    return pesq_mos_lqo(np.asarray(tar), np.asarray(src), sr, mode="wb")


METRIC_REGISTRY: Dict[str, Callable] = {
    "sisdr": sisdr_eval,
    "stoi": stoi_eval,
    "estoi": estoi_eval,
    "pesq_nb": pesq_nb_eval,
    "pesq_wb": pesq_wb_eval,
}

# metrics with a batched version on the device (PESQ there is the port's
# P.862 model; metrics/pesq_model.py states its fidelity)
DEVICE_BATCH_METRICS = ("sisdr", "stoi", "estoi", "pesq_nb", "pesq_wb")


def device_batch_metrics() -> tuple:
    """The metric names to score on the device in this process. pesq_* move
    to the host, one utterance at a time, when the ITU-conformant ``pesq``
    wheel imports (its scores are certified, matching what the reference
    logs); otherwise they stay on the device through the approximate P.862
    model."""
    from .pesq import itu_pesq_fn

    if itu_pesq_fn() is not None:
        return ("sisdr", "stoi", "estoi")
    return DEVICE_BATCH_METRICS


def check_metrics(names: Sequence[str]) -> None:
    """Raise on a metric name the registry does not know."""
    for name in names:
        if name not in METRIC_REGISTRY:
            raise ValueError(f"unknown metric {name!r}; known: {sorted(METRIC_REGISTRY)}")


def build_metrics(names: Sequence[str]) -> List[Callable]:
    """The per-utterance functions of ``names``, by name."""
    check_metrics(names)
    return [METRIC_REGISTRY[n] for n in names]


@contextlib.contextmanager
def full_f32():
    """Run the f32 products inside in full f32 (TF32 off), then restore the
    settings the caller had."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def batch_scores(
    names: Sequence[str],
    wav_predicted: torch.Tensor,
    wav_tar: torch.Tensor,
    lengths: torch.Tensor,
    sample_rate: int = 16000,
) -> Dict[str, torch.Tensor]:
    """{name: (B,) scores} on the device of the inputs, in full f32. A metric
    family asked for whole runs through its shared front end: stoi with
    estoi (they differ only in the segment correlation), pesq_nb with
    pesq_wb (only in the receive gain and the MOS mapping). Each score has
    the bits of its per-metric call."""
    check_metrics(names)
    out = {}
    with full_f32():
        if "stoi" in names and "estoi" in names:
            out["stoi"], out["estoi"] = stoi_estoi_batch(
                wav_tar, wav_predicted, sample_rate, lengths=lengths)
        pesq_modes = tuple(n.split("_")[1] for n in ("pesq_nb", "pesq_wb") if n in names)
        if pesq_modes:
            from .pesq_model import pesq_batch_modes

            scores = pesq_batch_modes(wav_tar, wav_predicted, sample_rate, pesq_modes,
                                      lengths=lengths)
            for m in pesq_modes:
                out[f"pesq_{m}"] = scores[m]
        for name in names:
            if name in out:
                continue
            if name == "sisdr":
                out[name] = si_sdr_batch(wav_predicted, wav_tar, lengths)
            elif name in ("stoi", "estoi"):
                out[name] = stoi_coeff_batch(wav_tar, wav_predicted, sample_rate,
                                             extended=name == "estoi", lengths=lengths)
    return out
