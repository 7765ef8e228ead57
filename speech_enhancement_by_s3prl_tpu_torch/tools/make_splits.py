"""Frozen LibriSpeech split lists (counterpart of ``scripts/make_splits.py``).

The reference ships libri-test-clean-10s.txt (test-clean utterances of at
most 10 s), split with seed 1227 into libri-adapt.txt (10) and
libri-test.txt (1200), and the libri-dev-all / few lists of dev-clean. This
tool regenerates them from a LibriSpeech root, or from the master lists
alone; from the vendored ``lists/`` masters it writes the vendored lists
byte for byte.

  python -m speech_enhancement_by_s3prl_tpu_torch.tools.make_splits \\
      /data/LibriSpeech --out-dir lists/
  python -m speech_enhancement_by_s3prl_tpu_torch.tools.make_splits \\
      --from-master lists/libri-test-clean-10s.txt \\
      --from-dev-master lists/libri-dev-all.txt --out-dir /tmp/lists
"""
from __future__ import annotations

import argparse
import os
import random

from ..data.audio_io import read_audio
from ..data.datasets import find_audio_files


def duration_filter(root: str, subset: str, max_sec: float):
    """The files of ``root/subset`` of at most ``max_sec`` seconds, relative
    to ``root``, sorted."""
    kept = []
    for path in find_audio_files(os.path.join(root, subset)):
        wav, sr = read_audio(path)
        if wav.shape[-1] / sr <= max_sec:
            kept.append(os.path.relpath(path, root))
    return sorted(kept)


def write_list(path: str, items):
    with open(path, "w") as f:
        for it in items:
            f.write(it + "\n")
    print(f"wrote {path}: {len(items)} files")


def split_master(master_lines, seed: int = 1227, adapt_num: int = 10,
                 test_num: int = 1200):
    """The published adapt / test split (the reference's split-test.py): a
    seed-1227 shuffle of the master list in file order, the first 10 adapt,
    the next 1200 test."""
    lines = list(master_lines)
    random.Random(seed).shuffle(lines)
    return lines[:adapt_num], lines[adapt_num:adapt_num + test_num]


def split_dev(dev_files, seed: int = 1227, few_num: int = 10):
    """The published dev lists (the reference's split-dev.py): the sorted
    dev-clean files shuffled once with seed 1227 (dev-all, in that order),
    then dev-few drawn by ``sample`` from the same generator. The shuffle
    starts from the sorted files, so any order of the input regenerates
    both."""
    files = sorted(dev_files)
    rng = random.Random(seed)
    rng.shuffle(files)
    few = rng.sample(files, few_num)
    return files, few


def _read_list(path):
    with open(path) as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("libri_root", nargs="?")
    ap.add_argument("--from-master",
                    help="derive libri-adapt/test from an existing libri-test-clean-10s"
                    " list instead of scanning a LibriSpeech root")
    ap.add_argument("--from-dev-master",
                    help="derive libri-dev-all/few from an existing dev list "
                    "(order-insensitive: the file set is re-sorted and reshuffled)")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--max-sec", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1227)
    ap.add_argument("--adapt-num", type=int, default=10)
    ap.add_argument("--test-num", type=int, default=1200)
    ap.add_argument("--dev-few-num", type=int, default=10)
    args = ap.parse_args(argv)
    if not (args.libri_root or args.from_master or args.from_dev_master):
        ap.error("need a LibriSpeech root, --from-master, or --from-dev-master")
    os.makedirs(args.out_dir, exist_ok=True)

    ten_s = None
    if args.from_master:
        ten_s = _read_list(args.from_master)
    elif args.libri_root:
        ten_s = duration_filter(args.libri_root, "test-clean", args.max_sec)
    if ten_s is not None:
        write_list(os.path.join(args.out_dir, "libri-test-clean-10s.txt"), ten_s)
        adapt, test = split_master(ten_s, args.seed, args.adapt_num, args.test_num)
        write_list(os.path.join(args.out_dir, "libri-adapt.txt"), adapt)
        write_list(os.path.join(args.out_dir, "libri-test.txt"), test)

    if args.from_dev_master:
        dev = _read_list(args.from_dev_master)
    elif args.libri_root:
        dev = [os.path.relpath(p, args.libri_root)
               for p in find_audio_files(os.path.join(args.libri_root, "dev-clean"))]
    else:
        return
    dev_all, dev_few = split_dev(dev, args.seed, args.dev_few_num)
    write_list(os.path.join(args.out_dir, "libri-dev-all.txt"), dev_all)
    write_list(os.path.join(args.out_dir, "libri-dev-few.txt"), dev_few)


if __name__ == "__main__":
    main()
