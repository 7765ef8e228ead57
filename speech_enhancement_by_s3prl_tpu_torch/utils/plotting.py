"""Spectrogram images for media logging (counterpart of
``speech_enhancement_by_s3prl_tpu/utils/plotting.py``).

A spectrogram (frames, bins) becomes an 8-bit greyscale PNG with one pixel a
(bin, frame), low frequencies at the bottom, min-max normalized. The PNG is
written with ``zlib`` and ``struct`` alone, so no plotting library is needed.
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
