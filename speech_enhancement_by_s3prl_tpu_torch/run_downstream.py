"""CLI for downstream training and evaluation on the port (counterpart of the
repository's ``run_downstream.py``):

  python -m speech_enhancement_by_s3prl_tpu_torch.run_downstream \\
      --config cfg.yaml --name exp --downstream Residual --objective SISDR \\
      --from_rawfeature --device cuda

``--from_rawfeature`` trains a head on the downstream features;
``--from_waveform`` on the upstream-input features (``--downstream
Mockingjay`` trains the whole TERA/Mockingjay encoder and its spec head, the
encoder's structure and weights from ``--dckpt`` or drawn from ``--seed``);
with neither, the head reads the hidden states of the ``--upstream``
(``transformer``: the encoder of the S3PRL checkpoint ``--ckpt``, or one
drawn from ``--seed``; ``--dropout`` overrides its rates and puts it in train
mode while the head trains; ``baseline``: the identity).

The active sampler (``active/sampler.py``): ``--sync_sampler`` scores each
candidate batch in the train loop, ``--sampler_device k`` scores on a thread
on card k, ``--active_sampling`` trains on the matched samples,
``--active_layerid`` embeds one LSTM layer's gradient, ``--test_gradient``
runs the diagnostic (``--n_iterate`` batches). Their pseudo wavs come from
the upstream and the second one (``--upstream2`` / ``--ckpt2`` /
``--dropout2``) over ``--record_num`` record utterances; ``--pseudo_clean`` /
``--pseudo_noise`` add the train batch's pseudo wavs to the media.
``--trainset NoisyCleanDataset`` reads paired corpora.

``--mesh D`` (or ``Dx1``) trains on D data-parallel ranks (``parallel/``),
``batch_size`` the global batch, which D must divide (refused, with the JAX
package's message, before any rank starts); ``--mesh DxM`` on D x M ranks,
the head's wide parameters sharded over the M ranks of each model group
(tensor parallelism, ``parallel/mesh.py``). Under ``torchrun`` (``RANK``
set) each process joins the process group as its rank; otherwise the CLI
starts its D x M ranks itself, with the ``spawn`` start method and a
rendezvous file of its own, so the JAX command line runs as it is
(``--mesh 1x1`` joins a group of one in this process). A rank on ``cuda``
computes on card ``LOCAL_RANK`` over NCCL, so a node needs a card for each
of its ranks (torchrun's ``LOCAL_WORLD_SIZE``, or D x M); one on ``cpu``
(``--device cpu``) runs gloo.

The flag names of the ported subset are the JAX CLI's. Settings take
precedence as there: a ``--resume`` checkpoint's saved args and config win
over the CLI, which wins over the YAML file (the ``--train_speech`` /
``--train_noise`` / ``--test_speech`` / ``--test_noise`` file lists). One
flag is the exception: ``--device`` (``cuda``, the default, or ``cpu``;
``--cpu`` is its alias) names this machine's device, so the CLI's value
holds on resume. Asking for ``cuda`` with no CUDA device raises.

``--profile`` traces the train step at the config's ``runner.profile_step``
(default 10) into ``<expdir>/<name>/profile`` (``utils/profiling.py``), the
run otherwise bit for bit the same. ``--wandb`` starts (or, on a resume,
continues by the saved ``wandbid``) a wandb run that receives the scalars
of ``scalars.jsonl``, as the JAX CLI does; it needs the ``wandb`` package,
imported only under the flag.

PyYAML is imported only to read ``--config``: a run that resumes, or a
program that passes a dict config to :func:`build_runner`, needs none.
"""
from __future__ import annotations

import argparse
import importlib
import os
import random
import sys

import numpy as np
import torch

from . import use_full_fp32
from .models.heads import build_head
from .ops.features import OnlinePreprocessor, get_feat_config
from .models.upstream import build_upstream
from .parallel.distributed import initialize_distributed, topology_summary
from .parallel.mesh import parse_mesh
from .runner.checkpoint import find_resume_ckpt, load_checkpoint, load_settings
from .runner.runner import Runner
from .utils.config import update_args

# The ``online`` section of config/pretrain_sample.yaml, which defines the
# STFT geometry and the upstream-input feature when no --ckpt is given.
PRETRAIN_ONLINE = {
    "sample_rate": 16000,
    "max_time": 10000,
    "target_level": -25,
    "noise_proportion": 0.5,
    "snrs": [3, 6],
    "win_ms": 25,
    "hop_ms": 10,
    "n_freq": 201,
    "n_mels": 40,
    "n_mfcc": 13,
    "input": {"feat_type": "mel", "channel": 0, "log": True, "delta": 1, "cmvn": True},
    "target": {"feat_type": "linear", "channel": 1, "log": True, "delta": 0,
               "cmvn": False},
}


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Speech-enhancement downstream training on the PyTorch port"
    )
    parser.add_argument("--resume", help="checkpoint path/dir for continual training")
    parser.add_argument("--name", help="experiment name")
    parser.add_argument("--n_jobs", default=4, type=int)
    parser.add_argument("--dev_num", default=500, type=int)

    parser.add_argument("--upstream", choices=["transformer", "baseline"],
                        default="transformer")
    parser.add_argument("--ckpt", default="", help="upstream pretraining ckpt")
    parser.add_argument("--dropout", type=float)
    # the second upstream makes the pseudo wavs with the first
    parser.add_argument("--upstream2", choices=["transformer", "baseline"],
                        default="transformer")
    parser.add_argument("--ckpt2", default="")
    parser.add_argument("--dropout2", type=float)
    parser.add_argument("--pseudo_clean", action="store_true")
    parser.add_argument("--pseudo_noise", action="store_true")
    parser.add_argument("--downstream", default="LSTM")
    parser.add_argument("--dckpt", default="", help="downstream warm-start ckpt "
                        "(Mockingjay: the pretraining ckpt)")
    parser.add_argument("--objective", default="L1")
    parser.add_argument("--from_waveform", action="store_true")
    parser.add_argument("--from_rawfeature", action="store_true")
    parser.add_argument("--trainset", default="OnlineDataset",
                        help="dataset class of the train and query splits")
    parser.add_argument("--optim", default="BertAdam", choices=["BertAdam", "Adam"])

    parser.add_argument("--config", default="config/vcb.yaml")
    parser.add_argument("--expdir", default="result")
    parser.add_argument("--seed", default=1337, type=int)
    parser.add_argument("--compute_dtype", default="f32", choices=["f32", "bf16"],
                        help="bf16: the LSTM heads' projections and W_hh^T (and, in a "
                        "one-direction head, h in the step product) and the "
                        "transformer's products in bf16 (parameters and optimizer "
                        "state stay f32); recorded in the checkpoint's Paras")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--cpu", dest="device", action="store_const", const="cpu",
                        help="alias of --device cpu")
    parser.add_argument("--eval_init", action="store_true")
    parser.add_argument("--no_metric", action="store_true")
    parser.add_argument("--save_best", action="store_true")

    parser.add_argument("--train_speech")
    parser.add_argument("--train_noise")
    parser.add_argument("--test_speech")
    parser.add_argument("--test_noise")
    parser.add_argument("--test", action="store_true")

    parser.add_argument("--active_sampling", action="store_true")
    parser.add_argument("--record_num", default=5, type=int)
    parser.add_argument("--sampler_device", type=int)
    parser.add_argument("--active_layerid", type=int)
    parser.add_argument("--n_iterate", type=int)
    parser.add_argument("--sync_sampler", action="store_true")
    parser.add_argument("--test_gradient", action="store_true")
    parser.add_argument("--mesh", default=None,
                        help="D or DxM: training over D x M ranks, the batch split over D "
                        "data ranks and the head's wide parameters over M model ranks")
    parser.add_argument("--profile", action="store_true",
                        help="trace the train step at runner.profile_step (default 10) "
                        "to expdir/profile")
    parser.add_argument("--wandb", action="store_true",
                        help="also log the scalars to a wandb run (needs the wandb package)")
    return parser


def read_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def get_downstream_args(argv=None):
    """(args, config) with the precedence resume > CLI > YAML."""
    args = get_parser().parse_args(argv)
    if args.resume is None:
        config = read_yaml(args.config)
        for overwrite in ["train_speech", "train_noise", "test_speech", "test_noise"]:
            filestrs = getattr(args, overwrite)
            if filestrs is None:
                continue
            dataset_type, data_type = overwrite.split("_")
            section = f"OnlineDataset_{dataset_type}"
            config.setdefault(section, {}).setdefault(data_type, {})[
                "filestrs"
            ] = filestrs
    else:
        device = args.device
        resume_ckpt = find_resume_ckpt(args.resume)
        payload = load_checkpoint(resume_ckpt)
        args = update_args(args, payload["Settings"]["Paras"])
        config = payload["Settings"]["Config"]
        args.resume = resume_ckpt
        args.device = device
    if args.wandb:
        import_wandb()  # refused here, before any rank starts, without the package
    return args, config


WANDB_MISSING = ("--wandb requires the wandb package (not installed in this environment); "
                 "TensorBoard logging is always on")


def import_wandb():
    """The ``wandb`` module; without it ``SystemExit`` with the JAX CLI's
    message."""
    try:
        return importlib.import_module("wandb")
    except ModuleNotFoundError as e:
        raise SystemExit(WANDB_MISSING) from e


def start_wandb(args, config):
    """The JAX CLI's wandb run: a new run named ``--name``, whose id is kept
    in ``args.wandbid`` (saved with the checkpoint's settings) and whose
    config records the args and the config; on a resume, that run again."""
    wandb = import_wandb()
    if getattr(args, "wandbid", None) is None:
        wandb.init(name=args.name)
        args.wandbid = wandb.run.id
        wandb.config.update({"args": vars(args), "config": config})
    else:
        wandb.init(name=args.name, resume=args.wandbid)


def _pretrain_config(args) -> dict:
    if args.ckpt:
        return torch.load(args.ckpt, map_location="cpu", weights_only=False)[
            "Settings"
        ]["Config"]
    return {"online": PRETRAIN_ONLINE}


def get_preprocessor(args, config):
    """(preprocessor, upstream dim, downstream dim, target linear dim)."""
    pretrain_config = _pretrain_config(args)
    if getattr(args, "upstream", "transformer") == "transformer":
        upstream_feat = dict(pretrain_config["online"]["input"])
    else:
        upstream_feat = dict(config["preprocessor"]["baseline"])
    if args.dckpt:
        dconfig, _ = load_settings(args.dckpt)
        downstream_feat = dict(
            dconfig["online"]["input"] if "online" in dconfig
            else dconfig["preprocessor"]["baseline"]
        )
    else:
        downstream_feat = dict(config["preprocessor"]["baseline"])

    channel_inp = config["preprocessor"]["input_channel"]
    channel_tar = config["preprocessor"]["target_channel"]
    upstream_feat["channel"] = channel_inp
    downstream_feat["channel"] = channel_inp
    feat_list = [
        upstream_feat,
        downstream_feat,
        get_feat_config("linear", channel_inp),
        get_feat_config("uphase", channel_inp),
        get_feat_config("linear", channel_tar),
        get_feat_config("uphase", channel_tar),
    ]
    preprocessor = OnlinePreprocessor(**pretrain_config["online"], feat_list=feat_list)
    preprocessor.channel_inp = channel_inp
    preprocessor.channel_tar = channel_tar
    dims = preprocessor.feat_dims()
    return preprocessor, dims[0], dims[1], dims[4]


def get_downstream_model(args, input_dim, output_dim, config, generator=None):
    if not args.dckpt:
        model_config = config.get("model", {}).get(args.downstream, {}) or {}
    elif args.downstream == "Mockingjay":
        model_config = {}  # its structure comes from the pretraining checkpoint
    else:
        dconfig, dparas = load_settings(args.dckpt)
        if "small_model" in dconfig:
            model_config = dconfig["small_model"]["model"]
        else:
            model_config = dconfig["model"][dparas.get("downstream", args.downstream)]
    configs = dict(vars(args))
    configs.update(model_config)
    return build_head(args.downstream, input_size=input_dim, output_size=output_dim,
                      generator=generator, **configs)


def build_runner(args, config) -> Runner:
    """The Runner of a run on ``args.device``, its head's (and a random
    upstream's) weights drawn from ``--seed``. The upstream is built here only
    in the upstream mode, the one mode whose head reads it; the two upstreams
    of the pseudo wavs are built when the Runner first needs them."""
    use_full_fp32()
    expdir = os.path.join(args.expdir, args.name or "default")
    os.makedirs(expdir, exist_ok=True)
    preprocessor, upstream_dim, downstream_dim, tar_linear_dim = get_preprocessor(
        args, config)

    def make_upstream(which: str, ckpt: str, dropout):
        return build_upstream(
            which, upstream_dim, ckpt, dropout, tar_linear_dim, seed=args.seed,
            compute_dtype=getattr(args, "compute_dtype", "f32"))

    upstream = None
    if args.from_waveform:
        input_dim = upstream_dim
    elif args.from_rawfeature:
        input_dim = downstream_dim
    else:
        upstream = make_upstream(args.upstream, args.ckpt, getattr(args, "dropout", None))
        input_dim = upstream.out_dim

    def pseudo_upstreams():
        first = upstream or make_upstream(args.upstream, args.ckpt,
                                          getattr(args, "dropout", None))
        return first, make_upstream(getattr(args, "upstream2", "transformer"),
                                    getattr(args, "ckpt2", ""),
                                    getattr(args, "dropout2", None))

    model = get_downstream_model(
        args, input_dim, tar_linear_dim, config,
        generator=torch.Generator().manual_seed(args.seed),
    )
    device = args.device
    if device == "cuda" and torch.distributed.is_initialized():
        device = f"cuda:{torch.cuda.current_device()}"  # the rank's card
    return Runner(args, config, preprocessor, model, expdir, device, upstream,
                  pseudo_upstreams=pseudo_upstreams)


def _rank_main(rank: int, argv, init_method: str, world: int):
    """A rank that the CLI started itself (``--mesh`` outside torchrun)."""
    os.environ["LOCAL_RANK"] = str(rank)
    main(argv, init_method=init_method, world=world, rank=rank)


def _spawn_ranks(argv, world: int):
    """Run ``main(argv)`` on ``world`` ranks, each a process started with
    ``spawn`` (CUDA cannot be forked), meeting through a file in a fresh
    temporary directory."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        mp.start_processes(_rank_main, args=(list(argv), init, world), nprocs=world,
                           start_method="spawn")


def main(argv=None, init_method=None, world=None, rank=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args, config = get_downstream_args(argv)
    if args.mesh:
        data, model = parse_mesh(args.mesh)
        world_size = data * model
        if init_method is None and "RANK" not in os.environ:
            # refused before any rank starts (a joined rank's Runner refuses it)
            if config["dataloader"]["batch_size"] % data:
                raise ValueError("batch_size must divide the data axis")
            if world_size > 1:
                return _spawn_ranks(argv, world_size)
            import tempfile

            with tempfile.TemporaryDirectory() as tmp:
                return main(argv, "file://" + os.path.join(tmp, "rendezvous"), 1, 0)
        # the ranks of this node each need a card of their own: under torchrun
        # LOCAL_WORLD_SIZE of them, else the D x M that the CLI spawned here
        env = os.environ
        local = (int(env.get("LOCAL_WORLD_SIZE", env.get("WORLD_SIZE", world_size)))
                 if "RANK" in env else world_size)
        if args.device == "cuda" and torch.cuda.device_count() < local:
            raise ValueError(f"mesh {args.mesh}: {local} ranks on this node need {local} "
                             f"cards, have {torch.cuda.device_count()}")
        initialize_distributed(init_method, world, rank, device=args.device)
        try:
            print(f"[distributed] {topology_summary()}", flush=True)
            return _run(args, config)
        finally:
            torch.distributed.destroy_process_group()
    return _run(args, config)


def _run(args, config):
    random.seed(args.seed)
    np.random.seed(args.seed)
    if getattr(args, "wandb", False) and (not torch.distributed.is_initialized()
                                          or torch.distributed.get_rank() == 0):
        start_wandb(args, config)
    runner = build_runner(args, config)
    runner.set_model()
    if args.test:
        runner.evaluate()
    elif args.test_gradient:
        if runner.is_main:
            runner.test_gradient()
    else:
        runner.train()


if __name__ == "__main__":
    main(sys.argv[1:])
