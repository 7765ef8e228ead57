"""Audio file I/O (counterpart of
``speech_enhancement_by_s3prl_tpu/data/audio_io.py``).

- ``read_wav``: pure-numpy RIFF parser (PCM 8/16/24/32-bit, float32/64).
- ``read_audio``: WAV, or FLAC through the native decoder (``data/flac.py``),
  by the file's extension.
- ``write_wav``: float32 [-1, 1] to 16-bit PCM; ``write_wav_pcm16``: int16
  PCM quantized elsewhere (the bench's pipeline mode) to the same bytes.
- ``load_audio(path, sr)``: mono float32, resampled with scipy's polyphase
  resampler when the file's rate differs.
"""
from __future__ import annotations

import io
import os
import struct
import wave
from typing import Optional, Tuple

import numpy as np


def _pcm_to_float(data: np.ndarray, sampwidth: int) -> np.ndarray:
    if sampwidth == 1:  # unsigned 8-bit
        return (data.astype(np.float32) - 128.0) / 128.0
    return data.astype(np.float32) / float(2 ** (8 * sampwidth - 1))


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a RIFF/WAVE file -> (samples (channels, time) float32, rate)."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        fmt = None
        data = None
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            chunk_id, size = head[:4], struct.unpack("<I", head[4:])[0]
            payload = f.read(size)
            if chunk_id == b"fmt ":
                fmt = payload
            elif chunk_id == b"data":
                data = payload
            if size % 2:
                f.read(1)
        if fmt is None or data is None:
            raise ValueError(f"missing fmt/data chunk: {path}")

    if len(fmt) < 16:
        raise ValueError(f"truncated fmt chunk: {path}")
    (audio_format, n_channels, sample_rate, _, _, bits) = struct.unpack(
        "<HHIIHH", fmt[:16]
    )
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]

    if n_channels < 1 or sample_rate < 1:
        raise ValueError(f"invalid WAV header (channels/rate): {path}")
    sampwidth = bits // 8
    if audio_format == 1:  # PCM
        if sampwidth not in (1, 2, 3, 4):
            raise ValueError(f"unsupported PCM width {bits}: {path}")
        if sampwidth == 3:
            raw = np.frombuffer(data, dtype=np.uint8)
            raw = raw[: len(raw) - len(raw) % 3].reshape(-1, 3)
            ints = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            samples = ints.astype(np.float32) / float(1 << 23)
        else:
            dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[sampwidth]
            n = len(data) - len(data) % sampwidth
            samples = _pcm_to_float(
                np.frombuffer(data[:n], dtype=dtype), sampwidth
            )
    elif audio_format == 3:  # IEEE float
        if sampwidth not in (4, 8):
            raise ValueError(f"unsupported float width {bits}: {path}")
        dtype = {4: np.float32, 8: np.float64}[sampwidth]
        n = len(data) - len(data) % sampwidth
        samples = np.frombuffer(data[:n], dtype=dtype).astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format {audio_format}: {path}")

    samples = samples[: len(samples) - len(samples) % n_channels]
    return samples.reshape(-1, n_channels).T.copy(), sample_rate


def write_wav(path, wav: np.ndarray, sample_rate: int):
    """Write mono/multi-channel float32 [-1,1] as 16-bit PCM WAV to a path or
    a binary file object."""
    wav = np.asarray(wav)
    if wav.ndim == 1:
        wav = wav[None, :]
    pcm = np.rint(np.clip(wav * 32767.0, -32768, 32767)).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(wav.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.T.tobytes())


def write_wav_pcm16(path, pcm: np.ndarray, sample_rate: int):
    """Write int16 PCM, already quantized (on the card, as the bench's
    pipeline mode does: half the bytes of f32 come back), as a 16-bit WAV:
    the bytes ``write_wav`` writes for the floats it was quantized from."""
    pcm = np.asarray(pcm)
    if pcm.dtype != np.int16:
        raise ValueError(f"write_wav_pcm16 takes int16 PCM, got {pcm.dtype}")
    if pcm.ndim == 1:
        pcm = pcm[None, :]
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.T.astype("<i2").tobytes())


def wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    """float32 [-1, 1] -> the bytes of a 16-bit PCM WAV file (``write_wav``'s)."""
    buf = io.BytesIO()
    write_wav(buf, wav, sample_rate)
    return buf.getvalue()


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """(samples (channels, time) float32, rate) of a WAV or FLAC file, by its
    extension (``.flac``: the native decoder; anything else: WAV)."""
    if os.path.splitext(path)[1].lower() == ".flac":
        from .flac import read_flac

        return read_flac(path)
    return read_wav(path)


def resample_poly(wav: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resampling via scipy."""
    if orig_sr == new_sr:
        return wav
    from math import gcd

    from scipy.signal import resample_poly as _rp

    g = gcd(orig_sr, new_sr)
    return _rp(wav, new_sr // g, orig_sr // g, axis=-1).astype(np.float32)


def load_audio(
    path: str, sr: Optional[int] = 16000, mono: bool = True
) -> Tuple[np.ndarray, int]:
    """librosa.load-compatible entry for WAV and FLAC files: mono float32 at
    the requested rate."""
    wav, orig_sr = read_audio(path)
    if mono:
        wav = wav.mean(axis=0) if wav.shape[0] > 1 else wav[0]
    if sr is not None and orig_sr != sr:
        wav = resample_poly(wav, orig_sr, sr)
        orig_sr = sr
    return np.ascontiguousarray(wav, dtype=np.float32), orig_sr
