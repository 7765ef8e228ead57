"""Scalars of per-run experiment directories into one CSV (counterpart of
``scripts/extract_results.py``; the reference's extract_zeroshot.py /
extract_l1.py in one tool).

Each run directory holds the port's ``scalars.jsonl`` (``runner/runner.py``:
one ``{"step", "tag", "value"}`` object a line). A run is labelled by
``group(1)`` of ``--pattern`` on its directory name (``noise(\\d+)`` by
default, the reference's per-noise-type runs): an integer where the group is
digits, else the group itself. The CSV has one row a run, sorted by label,
the label column ``noise_type`` first and one column a tag; ``--which``
picks each tag's first or last value.

  python -m speech_enhancement_by_s3prl_tpu_torch.tools.extract_results RUNS_ROOT \\
      --tags test_pesq_nb test_sisdr test_stoi
  python -m speech_enhancement_by_s3prl_tpu_torch.tools.extract_results RUNS_ROOT \\
      --tags test_loss --out l1.csv
"""
from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import re
from typing import Dict, List, Optional


def read_scalars(expdir: str) -> Optional[Dict[str, List[tuple]]]:
    """``{tag: [(step, value), ...]}`` in the order written, from
    ``expdir/scalars.jsonl``; None when there is no such file."""
    path = os.path.join(expdir, "scalars.jsonl")
    if not os.path.isfile(path):
        return None
    out: Dict[str, List[tuple]] = {}
    with open(path) as f:
        for line in f:
            if line.strip():
                rec = json.loads(line)
                out.setdefault(rec["tag"], []).append((int(rec["step"]), float(rec["value"])))
    return out


def scrape(expdir: str, tags, which: str = "first") -> Optional[dict]:
    """``{tag: value}`` of the run in ``expdir``: each tag's first or last
    value; None when the run has none of ``tags``."""
    scalars = read_scalars(expdir)
    if scalars is None:
        return None
    row = {tag: scalars[tag][0 if which == "first" else -1][1]
           for tag in tags if scalars.get(tag)}
    return row or None


def _label(group: str):
    return int(group) if group.isdigit() else group


def collect(root: str, tags, which: str = "first", pattern: str = r"noise(\d+)") -> dict:
    """``{label: row}`` of every run directory under ``root`` whose name
    matches ``pattern``."""
    searcher = re.compile(pattern)
    rows = {}
    for d in sorted(glob.glob(os.path.join(root, "*"))):
        if not os.path.isdir(d):
            continue
        m = searcher.search(os.path.basename(d))
        if m is None:
            continue
        row = scrape(d, tags, which)
        if row is not None:
            rows[_label(m.group(1))] = row
    return rows


def write_csv(path: str, rows: dict) -> List[List[str]]:
    """The CSV of ``rows``: ``noise_type`` and the tags in the order they
    first appear, one line a run sorted by label, an empty cell where a run
    lacks a tag. Returns the lines written."""
    columns = []
    for row in rows.values():
        columns.extend(t for t in row if t not in columns)
    labels = sorted(rows, key=lambda k: (isinstance(k, str), k))
    lines = [["noise_type", *columns]]
    lines += [[str(k), *(repr(rows[k][c]) if c in rows[k] else "" for c in columns)]
              for k in labels]
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(lines)
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("root", help="directory holding per-run experiment dirs")
    ap.add_argument("--tags", nargs="+", default=["test_pesq_nb", "test_sisdr", "test_stoi"])
    ap.add_argument("--which", choices=["first", "last"], default="first")
    ap.add_argument("--pattern", default=r"noise(\d+)",
                    help="regex whose group(1) labels each run")
    ap.add_argument("--out", default="results.csv")
    args = ap.parse_args(argv)
    lines = write_csv(args.out, collect(args.root, args.tags, args.which, args.pattern))
    for line in lines:
        print(",".join(line))
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
