"""Upstream pretraining on the port (counterpart of
``scripts/pretrain_upstream.py``, flag for flag).

The reference consumes S3PRL ``states-*.ckpt`` upstreams (noisy2clean /
noisy2noise spec-prediction transformers, its run_active.sh) but leaves
producing them to the S3PRL repository. This tool produces them:

1. draw an encoder + SpecHead from ``--seed`` with the architecture of a
   pretraining YAML (config/pretrain_sample.yaml's schema) and write it as a
   SEED S3PRL-layout checkpoint (``models/torch_export.py``);
2. train it as the ``Mockingjay`` downstream (exactly encoder + SpecHead)
   through the port's ``run_downstream`` (OnlineDataset mixing, BertAdam,
   the train step; on the card B3 runs the attention with its dropout and B4
   the STFT of the features), predicting the spectrum of
   ``--target_channel`` (1: clean, a noisy2clean upstream; 2: the scaled
   noise, noisy2noise);
3. export the trained weights as ``<expdir>/<name>/states-<step>.ckpt`` in
   the S3PRL layout, which ``--ckpt`` / ``--ckpt2`` read in either package.

  python -m speech_enhancement_by_s3prl_tpu_torch.tools.pretrain_upstream \\
      --name noisy2clean --config config/pretrain_sample.yaml --expdir exp/up \\
      --speech corpus/speech --noise corpus/noise --target_channel 1 \\
      --total_step 400 [--device cpu]

``--device`` is ``cuda`` (the default; it raises when there is no CUDA
device) or ``cpu``; ``--cpu`` is its alias.
"""
from __future__ import annotations

import argparse
import glob
import os

import torch

from .. import run_downstream
from ..models.convert import flax_to_state_dict
from ..models.torch_export import save_s3prl_ckpt
from ..models.torch_import import _feat_dim_from_online
from ..models.transformer import TransformerConfig
from ..models.upstream import UpstreamTransformer
from ..runner.checkpoint import find_resume_ckpt, load_checkpoint

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_run_config(pretrain: dict, args) -> dict:
    """The downstream-run config (config/vcb.yaml's schema) of the
    pretraining run.

    The Mockingjay head's input feature comes from the seed checkpoint's
    ``online.input`` (``run_downstream.get_preprocessor``'s ``--dckpt``
    branch), so ``preprocessor.baseline`` here only covers the run without
    one."""
    online = pretrain["online"]
    baseline = {k: v for k, v in online["input"].items() if k != "channel"}
    ds_common = dict(
        speech={"filestrs": args.speech},
        noise={"filestrs": args.noise},
        sample_rate=online.get("sample_rate", 16000),
        max_time=online.get("max_time", 10000),
        target_level=online.get("target_level", -25),
        snrs=list(args.snrs),
    )
    return {
        "dataloader": {
            "batch_size": args.batch_size,
            "eval_batch_size": args.batch_size,
            "active_batch_size": args.batch_size,
        },
        "preprocessor": {
            "input_channel": 0,
            "target_channel": args.target_channel,
            "baseline": baseline,
        },
        "runner": {
            "learning_rate": args.learning_rate,
            "warmup_proportion": 0.07,
            "gradient_clipping": 1.0,
            "total_step": args.total_step,
            "log_step": max(args.total_step // 10, 1),
            "eval_step": args.total_step * 10,  # no mid-run eval
            "save_step": args.total_step,
            "max_keep": 2,
            "eval_splits": [],
            "eval_metrics": ["sisdr"],
        },
        "objective": {args.objective: {}},
        "model": {},
        "OnlineDataset_train": {**ds_common, "infinite": True},
        "OnlineDataset_test": {**ds_common, "half_noise": "end"},
    }


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--name", required=True)
    ap.add_argument("--expdir", required=True)
    ap.add_argument("--config", default=os.path.join(REPO_ROOT, "config",
                                                     "pretrain_sample.yaml"),
                    help="pretraining YAML (transformer + online sections)")
    ap.add_argument("--speech", required=True, help="speech filestrs")
    ap.add_argument("--noise", required=True, help="noise filestrs")
    ap.add_argument("--target_channel", type=int, default=1, choices=[1, 2],
                    help="1: predict clean spec (noisy2clean), "
                         "2: predict noise spec (noisy2noise)")
    ap.add_argument("--objective", default="L1")
    ap.add_argument("--total_step", type=int, default=400)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--learning_rate", type=float, default=4e-4)
    ap.add_argument("--snrs", type=float, nargs="+", default=[-4, 0, 4])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--cpu", dest="device", action="store_const", const="cpu",
                    help="alias of --device cpu")
    return ap


def seed_upstream(pretrain: dict, seed: int) -> UpstreamTransformer:
    """The encoder + SpecHead of ``pretrain`` (its ``transformer`` section,
    input width from ``online.input``), drawn from ``seed`` on the CPU."""
    online = pretrain["online"]
    input_dim = _feat_dim_from_online(online, "input")
    cfg = TransformerConfig.from_dict({**pretrain["transformer"], "input_dim": input_dim})
    return UpstreamTransformer(
        cfg, input_dim, output_size=_feat_dim_from_online(online, "target"),
        log_domain=bool(online["target"].get("log", False)),
        generator=torch.Generator().manual_seed(seed))


def export_run(run_dir: str, pretrain: dict, out_dir: str, paras: dict) -> str:
    """Export the newest ``states-*.ckpt`` of a Mockingjay run as an S3PRL
    checkpoint ``<out_dir>/states-<step>.ckpt``."""
    payload = load_checkpoint(find_resume_ckpt(run_dir))
    tree = payload["Downstream"]
    if "params" in tree:
        tree = tree["params"]
    step = int(payload["Global_step"])
    return save_s3prl_ckpt(
        os.path.join(out_dir, f"states-{step}.ckpt"), pretrain,
        encoder_state=flax_to_state_dict(tree["mockingjay"]),
        spechead_state=flax_to_state_dict(tree["spechead"]),
        global_step=step, paras=paras)


def main(argv=None) -> str:
    args = get_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but there is no CUDA device (--cpu runs on the CPU)")
    import yaml

    with open(args.config) as f:
        pretrain = yaml.safe_load(f)
    online = pretrain["online"]
    online["input"] = {**online["input"], "channel": 0}
    online["target"] = {**online["target"], "channel": args.target_channel}
    # the architecture's input width follows the online input feature (the
    # S3PRL convention: transformer.input_dim is derived, not trusted)
    pretrain["transformer"]["input_dim"] = _feat_dim_from_online(online, "input")

    expdir = os.path.join(args.expdir, args.name)
    os.makedirs(expdir, exist_ok=True)
    paras = {"pretrain_upstream": vars(args)}
    seed_up = seed_upstream(pretrain, args.seed)
    seed_path = save_s3prl_ckpt(
        os.path.join(expdir, "seed.ckpt"), pretrain,
        encoder_state=seed_up.encoder.state_dict(),
        spechead_state=seed_up.spechead.state_dict(), global_step=0, paras=paras)
    print(f"[pretrain_upstream] seed checkpoint: {seed_path}", flush=True)

    cfg_path = os.path.join(expdir, "run_config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(build_run_config(pretrain, args), f)
    run_downstream.main([
        "--name", "train",
        "--config", cfg_path,
        "--expdir", expdir,
        "--upstream", "baseline",
        "--upstream2", "baseline",
        "--from_rawfeature",
        "--downstream", "Mockingjay",
        "--dckpt", seed_path,
        "--objective", args.objective,
        "--seed", str(args.seed),
        "--dev_num", "0",
        "--device", args.device,
    ])

    run_dir = os.path.join(expdir, "train")
    if not glob.glob(os.path.join(run_dir, "states-*.ckpt")):
        raise FileNotFoundError(f"no states-*.ckpt produced under {run_dir}")
    out_path = export_run(run_dir, pretrain, expdir, paras)
    print(f"[pretrain_upstream] exported upstream: {out_path}", flush=True)
    return out_path


if __name__ == "__main__":
    main()
