"""Serving artifacts through ``torch.export`` (counterpart of
``speech_enhancement_by_s3prl_tpu/utils/export_artifact.py``).

The enhance program (``serve.RawEnhancer``: STFT -> [upstream ->] head ->
iSTFT with the noisy phase -> level renorm), with the checkpoint's weights and
the export-time target level baked in, is exported once per duration bucket,
its batch dimension symbolic (one program serves any number of rows) and its
time axis static (the server pads into the buckets). A serving host loads it
with torch and the port's op library (``ops/cuda/library.py``, whose ops the
programs call: the kernels B1, B4 and B5) and needs neither the checkpoint
nor the model code. What the model reads when it is built or traced is baked
in as the JAX package's jitted program bakes it: ``compute_dtype`` and the
forms of its LSTM (``SE_LSTM_XW_BF16``, ``SE_PALLAS_HS_BF16``,
``SE_PALLAS_MXU_BF16``, ``SE_PALLAS_GATES_BF16``, ``SE_LSTM_XW_INT8``, read by
``models/lstm.stream_forms`` at trace time), which the program records as
B1's op arguments (``h_bf16``, ``hs_bf16``, ``gates_bf16``, and an int8 xw
beside its ``xw_scale``).

Layout: a directory of ``enhance_T<samples>.pt2`` files (``torch.export.save``)
and a ``manifest.json`` (``sample_rate``, ``buckets``, ``format``, and the
``device`` the programs were exported on). A program holds the device of its
constants; ``load_enhance`` moves it to another device with
``torch.export.passes.move_to_device_pass`` where the installed torch has it
(so an artifact exported on a CPU host serves on the card, as the JAX
package's default ``platforms=("cpu", "tpu")`` does), and refuses the
mismatch where it has not.

This module imports torch alone at import time; ``load_enhance`` imports only
the op library beside it."""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, Sequence

import torch

FORMAT = "torch.export program (.pt2) per bucket, symbolic batch, ops se_torch::*"
# rows of the example batch a program is traced at: a traced size of 1 would
# fix the batch at 1 (0/1 specialisation)
TRACE_ROWS = 2


def bucket_path(artifact_dir: str, samples: int) -> str:
    return os.path.join(artifact_dir, f"enhance_T{int(samples)}.pt2")


def export_enhance(module: torch.nn.Module, buckets: Sequence[int], out_dir: str,
                   sample_rate: int = 16000) -> Dict[int, str]:
    """Export ``module(wavs (B, T) f32, lengths (B,) int64) -> (B, T)`` for
    each bucket length T, with B symbolic, on the device of its parameters,
    under ``no_grad`` (so the kernels' forward-only routes are traced). Writes
    the programs and ``manifest.json`` into ``out_dir``; returns {T: path}."""
    if not buckets:
        raise ValueError("no duration buckets to export")
    device = next(module.parameters()).device
    os.makedirs(out_dir, exist_ok=True)
    batch = torch.export.Dim("batch")
    paths = {}
    for T in sorted(int(t) for t in buckets):
        wavs = torch.zeros((TRACE_ROWS, T), dtype=torch.float32, device=device)
        lengths = torch.full((TRACE_ROWS,), T, dtype=torch.int64, device=device)
        with torch.no_grad():
            program = torch.export.export(
                module, (wavs, lengths), dynamic_shapes=({0: batch}, {0: batch}),
                strict=False)
        paths[T] = bucket_path(out_dir, T)
        torch.export.save(program, paths[T])
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump({"sample_rate": int(sample_rate), "buckets": sorted(paths),
                   "format": FORMAT, "device": device.type}, f, indent=1)
    return paths


def read_manifest(artifact_dir: str) -> dict:
    with open(os.path.join(artifact_dir, "manifest.json")) as f:
        return json.load(f)


def load_enhance(artifact_dir: str, device) -> Dict[int, Callable]:
    """Load every bucket's program for ``device``; returns {T: fn(wavs,
    lengths)}, each a module to call under ``no_grad`` or inference mode.
    Registers the op library first. A program exported on another device
    type is moved to ``device`` (``move_to_device_pass``) where the
    installed torch has that pass, else refused."""
    from ..ops.cuda import library  # noqa: F401  (registers the programs' ops)

    device = torch.device(device)
    manifest = read_manifest(artifact_dir)
    exported_on = manifest.get("device", "cpu")
    move = None
    if exported_on != device.type:
        try:
            from torch.export.passes import move_to_device_pass as move
        except ImportError:
            raise RuntimeError(
                f"the artifact in {artifact_dir} was exported on {exported_on} and this torch "
                f"({torch.__version__}) cannot move a program to {device.type} (no "
                "torch.export.passes.move_to_device_pass): export it on the serving "
                "device (tools/export_model.py --device)") from None
    fns = {}
    for T in manifest["buckets"]:
        program = torch.export.load(bucket_path(artifact_dir, T))
        if move is not None:
            program = move(program, device)
        fns[int(T)] = program.module()
    return fns
