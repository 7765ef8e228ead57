"""PESQ on the host, one utterance at a time (counterpart of
``speech_enhancement_by_s3prl_tpu/metrics/pesq.py``).

``pesq_mos_lqo(ref, deg, sr, mode)`` -> MOS-LQO float, with the reference's
calling convention and its near-silence warning. It scores with the
ITU-conformant ``pesq`` wheel when that imports (what the reference scores
with), else with the port's P.862 model (``metrics/pesq_model.py``) on the
CPU, with the bad-interval realignment on and a one-time notice that the
score is approximate: the model runs the published P.862 tables and the
full time-alignment chain, but is not certified against the ITU
conformance points.
"""
from __future__ import annotations

import functools
import warnings

import numpy as np
import torch


@functools.lru_cache(maxsize=1)
def itu_pesq_fn():
    """The ITU-conformant scorer, or None when the wheel is absent."""
    try:
        from pesq import pesq as _pesq  # type: ignore

        return _pesq
    except ImportError:
        return None


@functools.lru_cache(maxsize=1)
def _warn_approximate() -> bool:
    warnings.warn(
        "[pesq] scoring with the port's P.862 model (published tables, "
        "coarse+fine time alignment, no ITU conformance certification); "
        "install the `pesq` package for ITU-conformant MOS-LQO"
    )
    return True


def pesq_mos_lqo(ref: np.ndarray, deg: np.ndarray, sr: int = 16000,
                 mode: str = "nb") -> float:
    ref = np.asarray(ref, dtype=np.float32).reshape(-1)
    deg = np.asarray(deg, dtype=np.float32).reshape(-1)
    if np.allclose(deg.sum(), 0.0, atol=1e-10) or np.allclose(
        ref.sum(), 0.0, atol=1e-10
    ):
        warnings.warn(
            f"[pesq] wav values too small: deg {deg.sum()}, ref {ref.sum()}"
        )

    itu = itu_pesq_fn()
    if itu is not None:
        # the reference's call: pesq(sr, reference, degraded, mode)
        return float(itu(sr, ref, deg, mode))

    _warn_approximate()
    from .pesq_model import pesq_batch

    # external pairs may carry mid-utterance delay changes, so the host API
    # runs the P.862 bad-interval realignment
    return float(
        pesq_batch(torch.from_numpy(ref)[None], torch.from_numpy(deg)[None], sr, mode,
                   realign=True)[0]
    )
