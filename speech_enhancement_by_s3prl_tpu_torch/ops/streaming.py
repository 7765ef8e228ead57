"""Chunked enhancement for audio longer than the largest duration bucket
(counterpart of ``enhance_streaming`` in
``speech_enhancement_by_s3prl_tpu/ops/streaming.py``; numpy only).

Fixed windows with overlapped cosine crossfades: it works with any model,
bidirectional ones included, recomputes the overlap, and its crossfaded seams
differ from a full-utterance pass. The stateful constant-latency streamer for
unidirectional heads is not ported yet (ROADMAP A10).
"""
from __future__ import annotations

from typing import Callable

import numpy as np


def enhance_streaming(
    enhance_fn: Callable[[np.ndarray], np.ndarray],
    wav: np.ndarray,
    sample_rate: int = 16000,
    window_sec: float = 10.0,
    overlap_sec: float = 1.0,
) -> np.ndarray:
    """Apply a fixed-window enhancer to a long 1-D signal.

    enhance_fn: maps a window (exactly window samples, zero-padded at the
    tail) to its enhanced version of the same length.
    """
    window = int(window_sec * sample_rate)
    overlap = int(overlap_sec * sample_rate)
    if not 0 <= overlap < window:
        raise ValueError(f"the overlap ({overlap} samples) must be shorter than the "
                         f"window ({window} samples)")
    hop = window - overlap
    n = len(wav)
    if n <= window:
        padded = np.zeros(window, np.float32)
        padded[:n] = wav
        return np.asarray(enhance_fn(padded))[:n]

    fade_in = 0.5 - 0.5 * np.cos(np.pi * np.arange(overlap) / overlap)
    out = np.zeros(n, np.float32)
    norm = np.zeros(n, np.float32)

    start = 0
    while start < n:
        chunk = np.zeros(window, np.float32)
        valid = min(window, n - start)
        chunk[:valid] = wav[start : start + valid]
        enhanced = np.asarray(enhance_fn(chunk))[:valid]

        weight = np.ones(valid, np.float32)
        if start > 0:
            m = min(overlap, valid)
            weight[:m] = fade_in[:m]
        if start + valid < n:
            m = min(overlap, valid)
            weight[valid - m :] = fade_in[::-1][:m][-m:]
        out[start : start + valid] += enhanced * weight
        norm[start : start + valid] += weight
        if start + window >= n:
            break
        start += hop

    return out / np.maximum(norm, 1e-8)
