"""Build the CUDA sources under ``csrc/`` into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/kernels/<name>-<hash>.so`` at the root of
the checkout, then loaded with ``ctypes``. The hash covers the source and the
flags, so an edit rebuilds. The compiler's report (registers, shared memory,
spills from ``-Xptxas -v``) is kept beside the library as ``.log``.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# every source under csrc/, by name
SOURCES = ("lstm_tm", "lstm_tm_cluster", "lstm_tm_bwd", "flash_attn", "flash_attn_bwd",
           "stft_fused", "stft_fft", "decode_ola", "decode_fft", "lstm_bb_cluster")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels of this package are built from csrc/ at first use"
    )


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives. The hash also
    covers every header under ``csrc/``, which a source may include."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library for this source exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name} ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def build_all(names=SOURCES):
    """Compile several sources at once, one ``nvcc`` each, all started
    together; returns {name: library path}."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = {name: pool.submit(build, name) for name in names}
    return {name: f.result() for name, f in futures.items()}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(name)))


def launch_args(x):
    """(device index, stream handle) of a launch on the device of tensor
    ``x``, on torch's current stream there."""
    import torch

    device = x.device.index if x.device.index is not None else torch.cuda.current_device()
    return device, torch.cuda.current_stream(x.device).cuda_stream


def raise_on(err: int, name: str, errstr, **shape):
    """Raise if a launch returned a CUDA error; ``errstr`` is the library's
    error-string function, ``shape`` the sizes to name."""
    if err:
        at = " ".join(f"{k}={v}" for k, v in shape.items())
        raise RuntimeError(
            f"{name} kernel failed: CUDA error {err} ({errstr(err).decode()}) at {at}")
