"""Batch enhancement CLI (counterpart of the repository's ``enhance.py``).

Loads a trained downstream checkpoint (``--ckpt``) or an exported artifact
(``--artifact``, ``tools/export_model.py``) and enhances WAV and FLAC files:
decode -> bucketed batches on the device (STFT, model, iSTFT with the noisy
phase, level renorm) -> 16-bit WAV out. A file longer than the largest bucket
(the 30 s ceiling of ``--ckpt``; an artifact's largest) is enhanced in
crossfaded windows of that length. An artifact bakes its export-time level and
pretraining checkpoints in: ``--target_level``, ``--upstream_ckpt`` and
``--dckpt`` are refused with it.

  python -m speech_enhancement_by_s3prl_tpu_torch.enhance --ckpt result/exp1 \\
      --inputs 'noisy/*.wav' --outdir enhanced/
  python -m speech_enhancement_by_s3prl_tpu_torch.enhance --artifact result/art \\
      --inputs 'noisy/*.wav' --outdir enhanced/

It runs on the card unless ``--device cpu`` (or its alias ``--cpu``, the JAX
CLI's flag) asks for the CPU, as ``run_downstream`` does; with no CUDA device
the default raises. ``--mesh N`` enhances each batch on N devices, one replica
a device (``serve.build_enhancer``; N replicas on the CPU under ``--cpu``); it
is refused with ``--artifact``.
"""
from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np

from .data.audio_io import load_audio, write_wav

AUDIO_EXTS = (".wav", ".flac")


def find_audio_files(root: str):
    """The WAV and FLAC files under ``root``, sorted."""
    out = []
    for dirpath, _, names in os.walk(root):
        out += [os.path.join(dirpath, n) for n in names
                if os.path.splitext(n)[1].lower() in AUDIO_EXTS]
    return sorted(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="", help="checkpoint file or dir (or --artifact)")
    ap.add_argument("--upstream_ckpt", default="",
                    help="relocated S3PRL pretraining checkpoint that records "
                         "the STFT geometry")
    ap.add_argument("--dckpt", default="",
                    help="relocated checkpoint that records the downstream "
                         "feature and model config")
    ap.add_argument("--inputs", required=True, help="glob/dir of noisy WAV / FLAC files")
    ap.add_argument("--outdir", default="enhanced")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--sample_rate", type=int, default=16000)
    ap.add_argument("--target_level", type=float, default=None,
                    help="output level in dB (default -25; an artifact bakes its "
                         "export-time level in, so the flag is refused with --artifact)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: cuda (the default; raises "
                         "when there is no CUDA device) or cpu")
    ap.add_argument("--cpu", dest="device", action="store_const", const="cpu",
                    help="alias of --device cpu")
    ap.add_argument("--artifact", default="",
                    help="exported artifact directory (tools/export_model.py) in place "
                         "of a checkpoint")
    ap.add_argument("--mesh", type=int, default=0,
                    help="enhance each batch on N devices, one replica a device; "
                         "0 = one device")
    args = ap.parse_args(argv)
    if bool(args.ckpt) == bool(args.artifact):
        ap.error("pass exactly one of --ckpt / --artifact")
    if args.artifact and args.mesh:
        ap.error("--artifact serving is single-device (no --mesh)")
    if args.artifact and args.target_level is not None:
        ap.error("--target_level is baked into the artifact at export time (re-export "
                 "with tools/export_model.py to change it)")
    if args.artifact and (args.upstream_ckpt or args.dckpt):
        ap.error("--upstream_ckpt/--dckpt are resolved at export time (pass them to "
                 "tools/export_model.py instead)")

    from .serve import build_artifact_enhancer, build_enhancer

    # offline CLI: fixed --batch_size chunks, no power-of-two row rounding,
    # and (for a checkpoint) a 30 s bucket ceiling; longer files stream in
    # crossfaded windows
    if args.artifact:
        enhancer = build_artifact_enhancer(args.artifact, args.sample_rate,
                                           device=args.device, round_pow2=False)
    else:
        enhancer = build_enhancer(
            args.ckpt, args.sample_rate,
            -25.0 if args.target_level is None else args.target_level, device=args.device,
            mesh_n=args.mesh, max_bucket_ms=30000, round_pow2=False,
            upstream_ckpt=args.upstream_ckpt, dckpt=args.dckpt,
        )

    if os.path.isdir(args.inputs):
        files = find_audio_files(args.inputs)
    else:
        files = sorted(glob.glob(args.inputs))
    if not files:
        raise SystemExit(f"no inputs matched {args.inputs}")
    os.makedirs(args.outdir, exist_ok=True)

    t0 = time.time()
    total_audio = 0.0
    for i in range(0, len(files), args.batch_size):
        chunk = files[i : i + args.batch_size]
        wavs = [load_audio(f, sr=args.sample_rate)[0] for f in chunk]
        lengths = np.array([len(w) for w in wavs])
        # short files ride one padded device batch; a file longer than the
        # largest bucket streams through fixed crossfaded windows
        short = [j for j, w in enumerate(wavs) if len(w) <= enhancer.max_len]
        out = [enhancer(w) if len(w) > enhancer.max_len else None for w in wavs]
        if short:
            for j, res in zip(short, enhancer.run_batch([wavs[j] for j in short])):
                out[j] = res
        for j, f in enumerate(chunk):
            name = os.path.splitext(os.path.basename(f))[0] + ".wav"
            write_wav(os.path.join(args.outdir, name),
                      out[j][: lengths[j]], args.sample_rate)
        total_audio += lengths.sum() / args.sample_rate
        print(f"[enhance] {min(i + args.batch_size, len(files))}/{len(files)}",
              flush=True)

    dt = time.time() - t0
    print(f"[enhance] {len(files)} files, {total_audio:.1f}s audio in "
          f"{dt:.1f}s wall ({total_audio / dt:.1f}x realtime incl. I/O)")


if __name__ == "__main__":
    main()
