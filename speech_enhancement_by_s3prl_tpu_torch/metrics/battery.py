"""The metric conformance battery: deterministic (name, clean, degraded)
pairs at 16 kHz, a copy of ``battery()`` in ``scripts/metrics_conformance.py``
(held to it array for array by tests/test_torch_port_metrics.py). Their
scores under the JAX package's metrics are pinned in
``docs/CONFORMANCE.json``; the port's tests and ``chip_smoke.py`` hold the
port's metrics to those pins."""
from __future__ import annotations

import json

import numpy as np

SR = 16000
# the pins' tolerances (those of the JAX package's battery test)
PESQ_TOL = 5e-3
STOI_TOL = 2e-3


def battery():
    """Deterministic (name, clean, degraded) pairs, 16 kHz float32."""
    rng = np.random.default_rng(1227)
    n = 4 * SR
    t = np.arange(n) / SR
    # speech-shaped deterministic "clean": harmonic stack with slow AM
    f0 = 140.0
    clean = sum(
        a * np.sin(2 * np.pi * f0 * k * t + p)
        for k, (a, p) in enumerate(
            [(0.5, 0.0), (0.35, 1.0), (0.22, 2.0), (0.12, 0.5), (0.06, 1.5)],
            start=1,
        )
    )
    clean *= 1.0 + 0.4 * np.sin(2 * np.pi * 2.5 * t)
    clean = (0.1 * clean / np.abs(clean).max()).astype(np.float32)

    pairs = []
    for snr in (20, 10, 5, 0, -5):
        noise = rng.standard_normal(n).astype(np.float32)
        noise *= np.sqrt((clean**2).mean() / (noise**2).mean()) * 10 ** (
            -snr / 20
        )
        pairs.append((f"white_snr{snr}", clean, clean + noise))
    # level offset (PESQ should be ~level-invariant after alignment)
    pairs.append(("gain+6dB", clean, (clean * 2.0).astype(np.float32)))
    # lowpassed degraded (band distortion)
    k = np.hanning(33).astype(np.float32)
    k /= k.sum()
    lp = np.convolve(clean, k, mode="same").astype(np.float32)
    pairs.append(("lowpass", clean, lp))
    # clipped
    pairs.append(("clip", clean, np.clip(clean, -0.03, 0.03)))
    return pairs


def pins(path: str) -> dict:
    """{pair name: {"pesq_nb", "pesq_wb", "stoi", "estoi"}} from a
    conformance report (``docs/CONFORMANCE.json``)."""
    with open(path) as f:
        return {p["name"]: p["jax"] for p in json.load(f)["pairs"]}
