"""Reference-scale endurance run on the port: 20,000 steps at the
config/active.yaml cadence (counterpart of ``scripts/endurance_run.py``).

The reference trains ``total_step`` 20000; short runs never exercise the
long-horizon lifecycle. This tool runs ONE continuous training at the
reference cadence (log 500 / eval 1000 / save 2000 / media 4000 /
sampler_refresh 50 / active_refresh 10, with ``--active_sampling
--sync_sampler --save_best``) on the synthetic corpus of
``experiment_active_adaptation`` and checks what only shows over hours:

- checkpoint rotation keeps ``max_keep`` with the per-split best kept;
- every cadence fired as often as expected (the counts of ``scalars.jsonl``);
- the training process's RSS stays bounded (no loader / sampler / log leak):
  read from ``/proc/<pid>/status`` every ``--poll_s`` from outside the
  process, the drift from the post-warm-up plateau to the end held under
  ``--rss_budget_mb``;
- the curves move the right way (loss down), the eval curves written to a
  CSV of (tag, step, value).

The head is small (``--hidden`` / ``--layers``): this is a lifecycle soak,
not a quality run. On the card 20k steps take hours.

  python -m speech_enhancement_by_s3prl_tpu_torch.tools.endurance_run \\
      --workdir /tmp/endurance [--steps 20000] [--hidden 64] [--layers 2] \\
      [--device cpu] [--rss_budget_mb 1500] [--analyze_only]
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

from .experiment_active_adaptation import downstream_config, gen_corpus, pretrain_config
from .experiment_active_adaptation import pretrain_upstreams as experiment_pretrain
from .extract_results import read_scalars

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pretrain_upstreams(args, wd: str) -> dict:
    """The reference's ``--ckpt`` / ``--ckpt2`` pair (noisy2clean /
    noisy2noise): the sampler's pseudo wavs need a SpecHead-bearing
    upstream."""
    pre_path = os.path.join(wd, "pretrain.yaml")
    cfg = pretrain_config(SimpleNamespace(up_hidden=args.up_hidden, up_layers=2,
                                          max_time=args.max_time))
    import yaml

    with open(pre_path, "w") as f:
        yaml.safe_dump(cfg, f)
    return experiment_pretrain(wd, pre_path, args.up_steps, 4, 0, args.device)


def build_config(args, wd: str) -> str:
    """The adaptation experiment's config at the active.yaml cadence."""
    exp_args = SimpleNamespace(
        batch_size=4, active_batch_size=8, query_num=8,
        learning_rate=4e-4, max_time=args.max_time, snrs=[-4, 0, 4],
        objective="L1", hidden=args.hidden,
    )
    cfg = downstream_config(
        wd, exp_args,
        train_noise=os.path.join(wd, "corpus", "noise_pool"),
        test_noise=os.path.join(wd, "corpus", "noise_target"),
        total_step=args.steps,
        pseudo_modes=[0, 1, 2, 3],
    )
    cfg["model"]["LSTM"]["num_layers"] = args.layers
    cfg["runner"].update(
        log_step=500, eval_step=1000, save_step=2000, media_step=4000,
        max_keep=args.max_keep, sampler_refresh_step=50,
        sampler_collect_step=25, sampler_sample_num=10,
        active_refresh_step=10,
        eval_splits=["subtrain", "dev", "query_dev", "test"],
    )
    import yaml

    path = os.path.join(args.workdir, "endurance.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def monitor(proc: subprocess.Popen, rss_csv: str, poll_s: float):
    """Write the child's RSS (``VmRSS`` of ``/proc/<pid>/status``) every
    ``poll_s`` seconds until it exits; returns its exit code."""
    t0 = time.monotonic()
    with open(rss_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["wall_s", "rss_mb"])
        while proc.poll() is None:
            try:
                with open(f"/proc/{proc.pid}/status") as st:
                    for line in st:
                        if line.startswith("VmRSS"):
                            kb = int(line.split()[1])
                            w.writerow([round(time.monotonic() - t0, 1),
                                        round(kb / 1024.0, 1)])
                            f.flush()
                            break
            except FileNotFoundError:
                break
            time.sleep(poll_s)
    return proc.wait()


def run_scalars(expdir: str) -> dict:
    """``{tag: [(step, value), ...]}`` of the first ``scalars.jsonl`` under
    ``expdir``."""
    for root, _dirs, files in sorted(os.walk(expdir)):
        if "scalars.jsonl" in files:
            return read_scalars(root)
    return {}


def analyze(args, expdir: str, rss_csv: str) -> dict:
    scalars = run_scalars(expdir)
    report: dict = {"steps": args.steps, "checks": {}, "curves": {}}

    def check(name, ok, detail):
        report["checks"][name] = {"ok": bool(ok), "detail": detail}
        print(f"[endurance] {'PASS' if ok else 'FAIL'} {name}: {detail}")

    # the cadences fired the expected number of times
    loss_tags = [t for t in scalars if t.endswith("loss") and "eval" not in t]
    train_pts = max((len(scalars[t]) for t in loss_tags), default=0)
    check("log_cadence", train_pts >= args.steps // 500,
          f"{train_pts} train-loss points (expect >= {args.steps // 500})")
    eval_tags = [t for t in scalars if "dev" in t or "test" in t]
    n_evals = max((len(scalars[t]) for t in eval_tags), default=0)
    check("eval_cadence", n_evals >= args.steps // 1000,
          f"{n_evals} eval points across {len(eval_tags)} tags "
          f"(expect >= {args.steps // 1000})")

    # the loss moved down
    if loss_tags:
        pts = scalars[loss_tags[0]]
        first, last = pts[0][1], pts[-1][1]
        check("loss_decreases", last < first, f"{loss_tags[0]}: {first:.4f} -> {last:.4f}")
        report["curves"]["loss"] = pts

    # rotation: the rotating states-*.ckpt capped at max_keep; the best of
    # each split in its own subdirectory (expdir/<name>/<split>/), each
    # capped at max_keep too
    name_dir = None
    for d in sorted(os.listdir(expdir)):
        if os.path.isdir(os.path.join(expdir, d)):
            name_dir = os.path.join(expdir, d)
    ckpts = sorted(os.listdir(name_dir)) if name_dir else []
    rotating = [c for c in ckpts if c.startswith("states-")
                and os.path.isfile(os.path.join(name_dir, c))]
    best = {d: sorted(os.listdir(os.path.join(name_dir, d)))
            for d in ckpts if os.path.isdir(os.path.join(name_dir, d))}
    n_best = sum(len(v) for v in best.values())
    check("ckpt_rotation", 0 < len(rotating) <= args.max_keep,
          f"{len(rotating)} rotating (max_keep={args.max_keep})")
    check("save_best_per_split",
          n_best > 0 and all(0 < len(v) <= args.max_keep for v in best.values()),
          f"{n_best} best ckpts across {len(best)} splits (each capped at max_keep): "
          + ", ".join(f"{d}={len(v)}" for d, v in sorted(best.items())))

    # RSS plateau: the median of the 2nd quarter (after warm-up) against the
    # median of the last quarter
    with open(rss_csv) as f:
        rss = np.array([float(r["rss_mb"]) for r in csv.DictReader(f)])
    if len(rss) >= 8:
        q = len(rss) // 4
        plateau, tail = float(np.median(rss[q:2 * q])), float(np.median(rss[-q:]))
        drift = tail - plateau
        check("rss_bounded", drift < args.rss_budget_mb,
              f"plateau {plateau:.0f} MB -> tail {tail:.0f} MB "
              f"(drift {drift:+.0f} MB, budget {args.rss_budget_mb})")
        report["rss"] = {"plateau_mb": plateau, "tail_mb": tail, "drift_mb": drift,
                         "peak_mb": float(rss.max()), "samples": len(rss)}
    else:
        check("rss_bounded", False, f"only {len(rss)} RSS samples")

    # the eval curves as (tag, step, value) rows
    curves_csv = os.path.join(args.workdir, "eval_curves.csv")
    with open(curves_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["tag", "step", "value"])
        for tag in sorted(eval_tags):
            for step, value in scalars[tag]:
                w.writerow([tag, step, value])
    report["eval_curves_csv"] = curves_csv
    report["ok"] = all(c["ok"] for c in report["checks"].values())
    return report


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", default="/tmp/endurance")
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--up_hidden", type=int, default=64)
    ap.add_argument("--up_steps", type=int, default=300)
    ap.add_argument("--max_time", type=int, default=2000)
    ap.add_argument("--max_keep", type=int, default=3)
    ap.add_argument("--rss_budget_mb", type=float, default=1500.0)
    ap.add_argument("--poll_s", type=float, default=30.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--cpu", dest="device", action="store_const", const="cpu",
                    help="alias of --device cpu")
    ap.add_argument("--analyze_only", action="store_true",
                    help="re-run the checks on an existing workdir")
    return ap


def main(argv=None):
    args = get_parser().parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    expdir = os.path.join(args.workdir, "exp")
    rss_csv = os.path.join(args.workdir, "rss.csv")

    if not args.analyze_only:
        import torch

        if args.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but there is no CUDA device "
                               "(--cpu runs on the CPU)")
        wd = os.path.abspath(args.workdir)
        corpus = os.path.join(wd, "corpus")
        if not os.path.isdir(corpus):
            os.makedirs(corpus)
            gen_corpus(corpus, np.random.default_rng(0))
        ups = pretrain_upstreams(args, wd)
        cfg_path = build_config(args, wd)
        cmd = [
            sys.executable, "-m", "speech_enhancement_by_s3prl_tpu_torch.run_downstream",
            "--name", "endurance", "--config", cfg_path,
            "--upstream", "transformer", "--ckpt", ups["noisy2clean"],
            "--upstream2", "transformer", "--ckpt2", ups["noisy2noise"],
            "--from_rawfeature", "--downstream", "LSTM",
            "--objective", "L1", "--expdir", os.path.abspath(expdir),
            "--dev_num", "3", "--record_num", "4", "--n_jobs", "2",
            "--active_sampling", "--sync_sampler", "--save_best",
            "--device", args.device,
        ]
        print("[endurance] launching:", " ".join(cmd), flush=True)
        t0 = time.monotonic()
        log_path = os.path.join(args.workdir, "train.log")
        with open(log_path, "w") as log:
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=REPO_ROOT)
            rc = monitor(proc, rss_csv, args.poll_s)
        print(f"[endurance] training exited rc={rc} after "
              f"{(time.monotonic() - t0) / 60:.1f} min")
        if rc != 0:
            with open(log_path) as f:
                print("[endurance] tail of train.log:\n" + "".join(f.readlines()[-30:]))
            sys.exit(rc)

    report = analyze(args, expdir, rss_csv)
    out = os.path.join(args.workdir, "report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[endurance] report -> {out} ok={report['ok']}")
    sys.exit(0 if report["ok"] else 1)


if __name__ == "__main__":
    main()
