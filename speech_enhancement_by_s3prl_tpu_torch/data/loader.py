"""Duration buckets (counterpart of the helpers at the top of
``speech_enhancement_by_s3prl_tpu/data/loader.py``). Requests and batches
are padded to a bucket length, so a bounded set of shapes reaches the
device."""
from __future__ import annotations

from typing import List, Sequence


def bucket_length(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (falls back to the largest bucket)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def default_buckets(sample_rate: int = 16000, max_time_ms: int = 10000) -> List[int]:
    """Duration buckets in samples: 1s, 2s, 4s, 6s, 8s, max."""
    secs = [1, 2, 4, 6, 8]
    out = [s * sample_rate for s in secs if s * 1000 < max_time_ms]
    out.append(sample_rate * max_time_ms // 1000)
    return out
