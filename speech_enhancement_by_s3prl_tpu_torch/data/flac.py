"""FLAC decoding through the repository's native decoder ``native/seio.cpp``
(counterpart of ``speech_enhancement_by_s3prl_tpu/data/flac.py``), loaded
with ctypes.

The library is ``native/libseio.so`` when a build of the JAX package left it
there. Otherwise it is compiled at first use, with the flags of
``native/Makefile`` (``g++ -O3 -fPIC -std=c++17 -shared``), into
``build/native/libseio-<hash>.so`` at the root of the checkout (git-ignored;
the hash covers the source). Nothing is ever written into ``native/``. A
stream the decoder refuses raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
NATIVE = ROOT / "native"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """The library to load: the JAX package's build when present, else this
    package's build of the same source."""
    prebuilt = NATIVE / "libseio.so"
    if prebuilt.exists():
        return prebuilt
    digest = hashlib.sha256((NATIVE / "seio.cpp").read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libseio-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) to build the FLAC decoder native/seio.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(NATIVE / "seio.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the FLAC decoder failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: another process never loads a partial file


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the decoder, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.seio_decode_flac.restype = ctypes.c_int
            lib.seio_decode_flac.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_size_t,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.seio_free.restype = None
            lib.seio_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
            _lib = lib
        return _lib


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file -> (samples (channels, time) float32, rate)."""
    lib = load_library()
    with open(path, "rb") as f:
        raw = f.read()
    buf = (ctypes.c_uint8 * len(raw)).from_buffer_copy(raw)
    out = ctypes.POINTER(ctypes.c_float)()
    n_samples = ctypes.c_int64()
    n_channels = ctypes.c_int()
    rate = ctypes.c_int()
    rc = lib.seio_decode_flac(buf, len(raw), ctypes.byref(out), ctypes.byref(n_samples),
                              ctypes.byref(n_channels), ctypes.byref(rate))
    if rc != 0:
        raise ValueError(f"FLAC decode failed ({rc}): {path}")
    try:
        n = n_samples.value * n_channels.value
        arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.seio_free(out)
    return arr.reshape(n_samples.value, n_channels.value).T.copy(), rate.value
