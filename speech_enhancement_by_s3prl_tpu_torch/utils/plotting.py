"""Spectrogram images for media logging (counterpart of
``speech_enhancement_by_s3prl_tpu/utils/plotting.py``).

A spectrogram (frames, bins) becomes an 8-bit greyscale PNG with one pixel a
(bin, frame), low frequencies at the bottom, min-max normalized; groups of
values become a box plot (``boxplot_png``, the gradient diagnostic's figure).
The PNG is written with ``zlib`` and ``struct`` alone, so no plotting library
is needed.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _prep(spec) -> np.ndarray:
    spec = np.asarray(spec)
    spec = np.squeeze(spec)
    assert spec.ndim == 2, f"expected 2-D spectrogram, got {spec.shape}"
    return np.flipud(spec.T)  # (freq, time), low freq at bottom


def grey_levels(image: np.ndarray) -> np.ndarray:
    """Min-max normalize to 0-255 (uint8); a constant image is all 0."""
    image = np.asarray(image, np.float64)
    lo, hi = image.min(), image.max()
    scaled = (image - lo) / (hi - lo) if hi > lo else np.zeros_like(image)
    return np.rint(scaled * 255.0).astype(np.uint8)


def _png(pixels: np.ndarray) -> bytes:
    """An 8-bit greyscale PNG of a (height, width) uint8 array."""
    height, width = pixels.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    # each scanline starts with filter type 0 (none)
    rows = np.concatenate([np.zeros((height, 1), np.uint8), pixels], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def spectrogram_png(spec) -> bytes:
    """PNG bytes of one (frames, bins) spectrogram, (bins, frames) pixels."""
    return _png(grey_levels(_prep(spec)))


def spectrograms_png(specs) -> bytes:
    """PNG bytes of spectrograms of one shape stacked top to bottom, each
    normalized on its own."""
    assert isinstance(specs, (list, tuple))
    return _png(np.concatenate([grey_levels(_prep(s)) for s in specs], axis=0))


def boxplot_png(groups, height: int = 240, box_width: int = 40, gap: int = 20) -> bytes:
    """PNG bytes of a box plot, one box a group of values, black on white:
    the box from the first to the third quartile with a line at the median,
    whiskers to the furthest values within 1.5 times the box's height of it
    (matplotlib's rule), the values beyond them as single pixels. The
    vertical axis spans the smallest to the largest value of all groups."""
    groups = [np.asarray(g, np.float64).reshape(-1) for g in groups]
    everything = np.concatenate(groups)
    lo, hi = float(everything.min()), float(everything.max())
    span = hi - lo if hi > lo else 1.0
    margin = 10
    width = gap + len(groups) * (box_width + gap)
    pixels = np.full((height, width), 255, np.uint8)

    def row(v: float) -> int:
        return int(round(margin + (hi - v) / span * (height - 1 - 2 * margin)))

    for k, g in enumerate(groups):
        left = gap + k * (box_width + gap)
        right, mid = left + box_width - 1, left + box_width // 2
        q1, med, q3 = np.percentile(g, [25, 50, 75])
        reach = 1.5 * (q3 - q1)
        inside = g[(g >= q1 - reach) & (g <= q3 + reach)]
        top, bottom = row(q3), row(q1)
        pixels[top, left:right + 1] = pixels[bottom, left:right + 1] = 0
        pixels[top:bottom + 1, left] = pixels[top:bottom + 1, right] = 0
        pixels[row(med), left:right + 1] = 0
        w_top, w_bottom = row(inside.max()), row(inside.min())
        pixels[w_top:top + 1, mid] = pixels[bottom:w_bottom + 1, mid] = 0
        pixels[w_top, left + box_width // 4:right - box_width // 4 + 1] = 0
        pixels[w_bottom, left + box_width // 4:right - box_width // 4 + 1] = 0
        for v in g[(g < q1 - reach) | (g > q3 + reach)]:
            pixels[row(v), mid] = 0
    return _png(pixels)
