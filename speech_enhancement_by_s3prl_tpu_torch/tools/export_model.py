"""Export a trained checkpoint as a serving artifact (counterpart of the
repository's ``scripts/export_model.py``).

  python -m speech_enhancement_by_s3prl_tpu_torch.tools.export_model \\
      --ckpt exp/run/states-20000.ckpt --out exp/run/artifact [--max_sec 30]

Writes one ``torch.export`` program per serving duration bucket (the weights
and ``--target_level`` baked in, the batch symbolic) and a manifest
(``utils/export_artifact.py`` documents the layout). It takes a checkpoint of
any of the three training modes (``from_rawfeature``, ``from_waveform``, the
upstream mode), as ``serve.build_raw_enhancer`` does; ``--upstream_ckpt`` /
``--dckpt`` relocate the pretraining checkpoints it records. Serve the result
with ``python -m speech_enhancement_by_s3prl_tpu_torch.serve --artifact <dir>``
or ``... .enhance --artifact <dir>``: the serving host needs torch, the port's
``ops/cuda`` and, on the card, its ``csrc/`` kernels, but neither the
checkpoint nor the model code.

The LSTM forms the JAX package's variables select (``SE_PALLAS_MXU_BF16``,
``SE_PALLAS_GATES_BF16``, ``SE_PALLAS_HS_BF16``, ``SE_LSTM_XW_BF16``,
``SE_LSTM_XW_INT8``) are read when the program is traced and recorded in its
calls of B1's op, as the JAX export bakes them in at trace time: set them for
the export, not for serving.

The export runs on the card unless ``--device cpu`` asks for the CPU; with no
card the default raises. A program exported on the CPU is moved to the card
when it is loaded there, where the serving host's torch can move it.
"""
from __future__ import annotations

import argparse
import os


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="export a checkpoint as a serving artifact")
    ap.add_argument("--ckpt", required=True, help="training checkpoint (file or directory)")
    ap.add_argument("--upstream_ckpt", default="",
                    help="relocated S3PRL pretraining checkpoint for upstream-backed "
                         "checkpoints (default: the path the checkpoint records)")
    ap.add_argument("--dckpt", default="",
                    help="relocated checkpoint holding the downstream feature and model "
                         "config (default: the path the checkpoint records)")
    ap.add_argument("--out", required=True, help="artifact directory to write")
    ap.add_argument("--sample_rate", type=int, default=16000)
    ap.add_argument("--target_level", type=float, default=-25.0,
                    help="output level in dB, baked into the programs")
    ap.add_argument("--max_sec", type=float, default=0.0,
                    help="drop buckets longer than this (0 = keep all)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device to export on: cuda (the default; raises when there is "
                         "no CUDA device) or cpu")
    return ap


def main(argv=None):
    ap = get_parser()
    args = ap.parse_args(argv)
    from ..serve import _serving_device, build_raw_enhancer
    from ..utils.export_artifact import export_enhance

    device = _serving_device(args.device, "export_model")
    _, raw, buckets = build_raw_enhancer(
        args.ckpt, args.sample_rate, args.target_level, device,
        upstream_ckpt=args.upstream_ckpt, dckpt=args.dckpt)
    if args.max_sec:
        buckets = [t for t in buckets if t <= args.max_sec * args.sample_rate]
        if not buckets:
            ap.error(f"--max_sec {args.max_sec} excludes every serving bucket")
    paths = export_enhance(raw, buckets, args.out, sample_rate=args.sample_rate)
    for t, p in sorted(paths.items()):
        print(f"[export] {t / args.sample_rate:5.1f} s bucket -> {p} "
              f"({os.path.getsize(p) / 1e6:.1f} MB)", flush=True)
    print(f"[export] manifest -> {os.path.join(args.out, 'manifest.json')}", flush=True)
    return paths


if __name__ == "__main__":
    main()
