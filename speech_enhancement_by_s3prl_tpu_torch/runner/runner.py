"""Training and evaluation lifecycle (counterpart of
``speech_enhancement_by_s3prl_tpu/runner/runner.py``) in the three modes of
``runner/trainer.py``: ``from_rawfeature`` heads, ``from_waveform`` heads
(``Mockingjay`` finetuning the whole encoder) and heads over a frozen
upstream, on ``OnlineDataset`` or ``NoisyCleanDataset`` (``--trainset``)
splits.

- Dataset modes ``train``, ``subtrain``, ``dev``, ``test`` and the active
  sampler's ``record``, ``query`` and ``query_dev``. A split whose config
  holds a ``pseudo_modes`` list draws pseudo-clean speech and pseudo noise:
  the waveforms the two upstreams (``--ckpt`` and ``--ckpt2``) predict from
  the ``record`` split's noisy channel, decoded with its phase (kernel B5 on
  the card).
- ``train``: log, eval and save cadences, ``max_keep`` rotation, best-per-
  split saves under ``--save_best`` (the best starts at zero), a final save.
  With ``--sync_sampler`` each step scores its candidate batch
  (``active_batch_size`` rows) against a query batch (``active_query_num``
  rows of pseudo case 3) by gradient embeddings (``active/sampler.py``) and
  keeps the matches; with ``--sampler_device`` an ``AsyncSampler`` scores on
  a thread and is drained at ``sampler_collect_step``, restarted at
  ``sampler_refresh_step``; with ``--active_sampling`` the step trains on a
  batch drawn from the kept samples of the last ``active_refresh_step`` steps,
  weighted by case (``active_buffer_weights``). The keys are the JAX
  Runner's: ``PRNGKey(--seed)`` at the start (a resume starts there too, as
  the JAX checkpoint stores no key), split in three for the sync sampler's
  two scoring calls (query, candidates) and in two for the train step, in
  that order each step, on every rank alike (``utils/prng.py``).
- ``evaluate``: reseeds the random modules and returns the per-batch mean of
  means. The eval step scores the metrics that have a batched version on
  the device (``metrics.device_batch_metrics``); PESQ moves to the host, one
  utterance at a time, only where the ITU ``pesq`` wheel imports.
- ``test_gradient``: the cosine of candidate against query embeddings by
  pseudo case, drawn as a box plot to ``expdir/sim_box.png``.
- ``--dckpt``: the pretraining checkpoint for ``Mockingjay`` (its encoder
  and SpecHead weights, like ``--ckpt``'s SpecHead for ``SpecHead``, are
  overlaid onto the new head); a warm start of the whole head otherwise.
- Scalars go to ``expdir/scalars.jsonl`` as one JSON object a line
  (``{"step", "tag", "value"}``), under the JAX package's TensorBoard tags.
- Media (``runner/media.py``) go to files under ``expdir/media/``, listed in
  ``expdir/media.jsonl``, at the JAX package's cadence: at ``media_step``
  the query batch and the matched candidates of the sync sampler
  (``active/query_*``, ``active/match_*``), the noisy, clean and noise
  channels of the train batch, each the whole batch as one clip, and under
  ``--pseudo_clean`` / ``--pseudo_noise`` the train batch's pseudo wavs; at
  a step that ``eval_step`` and ``media_step`` both divide, the noisy, clean
  and enhanced samples that ``evaluate`` returns; at ``log_step``, the
  figure of an objective that has a logger (``WSD``); at step 1, the record
  split and its pseudo wavs (``record/*``) when they are made.

``--mesh D`` (or ``Dx1``): data parallelism over the D ranks of the process
group (``parallel/``): ``batch_size`` is the global batch, which D must
divide; every rank iterates the same loader and trains on its rows of each
batch (``make_parallel_train_step``); an eval batch that the ranks divide is
scored a rank's rows each (``make_parallel_eval_step``), any other batch by
the single-device step on every rank. Rank 0 alone writes ``scalars.jsonl``,
media and checkpoints, and runs the active sampler, whose batch it hands
the other ranks (``broadcast_batch``); every rank reads ``--resume``,
``--dckpt`` and ``--ckpt``.

``--mesh DxM`` with M > 1 adds tensor parallelism over the M ranks of each
model group: the train step trains a sharded copy of the head
(``parallel/mesh.TensorParallel``), and ``downstream_model`` keeps the full
weights, brought up to date from the step's slices (``_gather``, a
collective that every rank reaches at the same point) before an eval, a
save (rank 0 writes the full tree and the full optimizer moments, the format
of a run without a mesh), the objective's figure and the active sampler's
scoring. The eval runs over all D * M ranks.

``--profile`` traces the train step at ``profile_step`` (default 10) into
``expdir/profile`` (``utils/profiling.trace``: one ``*.pt.trace.json``, which
``tools/profile_step.py --parse_only`` reads), the step itself unchanged;
under a mesh every rank traces its own step there, its rank in the file's
name. Under ``--wandb`` rank 0's scalars also go to the active wandb run.
"""
from __future__ import annotations

import contextlib
import copy
import json
import os
import random
import sys
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

from ..active.sampler import ACTIVE_BUFFER_NUM, AsyncSampler, make_scoring_fn, matching
from ..data.datasets import DATASET_REGISTRY
from ..data.loader import DataLoader, default_buckets, device_prefetch, infinite_iterator
from ..metrics import METRIC_REGISTRY, check_metrics, device_batch_metrics, full_f32
from ..models.convert import flax_to_state_dict
from ..models.torch_import import (
    convert_downstream_state,
    overlay_params,
    pretrained_head_params,
)
from ..objectives import build_objective
from ..parallel.mesh import (
    broadcast_batch,
    make_mesh,
    make_parallel_eval_step,
    make_parallel_train_step,
    parse_mesh,
)
from ..utils import prng
from ..utils.plotting import boxplot_png
from ..utils.profiling import trace
from . import checkpoint as ckpt_lib
from .media import MediaLog
from .optim import build_optimizer
from .trainer import StepBuilder, TrainState, decode_wav, make_context

LOG_WAV_NUM = 3


class ScalarLog:
    """Scalars appended to ``expdir/scalars.jsonl``, one JSON object a line,
    and logged to the wandb run that ``run_downstream --wandb`` started, when
    one is active (the JAX package syncs wandb with its TensorBoard
    writer)."""

    def __init__(self, expdir: str):
        os.makedirs(expdir, exist_ok=True)
        self.path = os.path.join(expdir, "scalars.jsonl")

    def add_scalar(self, tag: str, value, global_step: int):
        line = {"step": int(global_step), "tag": tag, "value": float(value)}
        with open(self.path, "a") as f:
            f.write(json.dumps(line) + "\n")
        wandb = sys.modules.get("wandb")  # imported only under --wandb
        if wandb is not None and getattr(wandb, "run", None) is not None:
            wandb.log({tag: line["value"]}, step=line["step"])


class _Silent:
    """The scalar and media logs of a rank other than 0: they write nothing."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


class Runner:
    """The training and evaluation lifecycle on ``device``. ``upstream``
    (models/upstream.py) feeds the head in the upstream mode.
    ``pseudo_upstreams()`` builds the two upstreams of the pseudo wavs (the
    ``--upstream`` / ``--ckpt`` one and the ``--upstream2`` / ``--ckpt2``
    one) when they are first needed; ``upstream_model`` / ``upstream_model2``
    hold them after that, and may be set in its place."""

    def __init__(self, args, config, preprocessor, downstream, expdir, device,
                 upstream=None, pseudo_upstreams=None):
        self.args = args
        self.config = config
        self.rconfig = config["runner"]
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Runner on cuda, but there is no CUDA device")
        # --mesh DxM: this process is one of the D x M ranks
        self.mesh = self.tp = None
        self._stale = False
        if getattr(args, "mesh", None):
            data, model = parse_mesh(args.mesh)
            self.mesh = make_mesh(data, model)
            if config["dataloader"]["batch_size"] % data:
                raise ValueError("batch_size must divide the data axis")
        self.is_main = self.mesh is None or self.mesh.is_main
        self.eval_step_parallel = None

        self.preprocessor = preprocessor
        self.downstream_model = downstream.to(self.device)
        self.upstream = None if upstream is None else upstream.to(self.device)
        self.pseudo_upstreams = pseudo_upstreams
        self.upstream_model = self.upstream_model2 = None
        self.pseudo_clean = self.pseudo_noise = None
        self.sampler: Optional[AsyncSampler] = None
        # the JAX Runner's key chain (the module docstring)
        self.rng = prng.PRNGKey(int(args.seed))
        self.expdir = expdir
        self.global_step = 1
        self.log = ScalarLog(expdir) if self.is_main else _Silent()
        self.media = MediaLog(expdir, preprocessor, self.device) if self.is_main else _Silent()

        self.metric_names = list(self.rconfig["eval_metrics"])
        check_metrics(self.metric_names)
        # the metrics scored on the device in the eval step, and those scored
        # on the host from the eval step's waveforms
        no_metric = getattr(args, "no_metric", False)
        on_device = device_batch_metrics()
        self.device_metric_names = () if no_metric else tuple(
            m for m in self.metric_names if m in on_device)
        self.host_metric_names = [] if no_metric else [
            m for m in self.metric_names if m not in on_device]
        criterion_config = config.get("objective", {}).get(args.objective, {}) or {}
        self.objective = build_objective(args.objective, **criterion_config)
        self.grad_clip = float(self.rconfig["gradient_clipping"])

        sr = preprocessor.config.sample_rate
        train_ms = self._dataset_conf("train").get("max_time", 10000)
        self.buckets = default_buckets(sr, train_ms)

    # ------------------------------------------------------------------
    def _ds_type(self) -> str:
        return getattr(self.args, "trainset", None) or "OnlineDataset"

    def _dataset_conf(self, mode: str) -> dict:
        key = f"{self._ds_type()}_{'test' if mode == 'test' else 'train'}"
        return self.config.get(key, {})

    def set_model(self):
        total = int(self.rconfig["total_step"])
        optimizer = build_optimizer(
            self.args.optim,
            float(self.rconfig["learning_rate"]),
            float(self.rconfig.get("warmup_proportion", 0.07)),
            total,
        )
        self.builder = StepBuilder(
            preprocessor=self.preprocessor,
            model=self.downstream_model,
            objective=self.objective,
            optimizer=optimizer,
            upstream=self.upstream,
            from_waveform=bool(getattr(self.args, "from_waveform", False)),
            from_rawfeature=bool(getattr(self.args, "from_rawfeature", False)),
            channel_inp=self.preprocessor.channel_inp,
            channel_tar=self.preprocessor.channel_tar,
            grad_clip=self.grad_clip,
            # --no_metric skips metric computation entirely
            eval_metrics=self.device_metric_names,
            sample_rate=self.preprocessor.config.sample_rate,
            seed=int(self.args.seed),
        )
        self.state = self.builder.init_state()
        self.train_step = self._keyed(self.builder.train_step)
        self._load_pretrained_head_weights()
        # --dckpt is Mockingjay's pretraining checkpoint, read above; for
        # every other head it is a warm start
        dckpt = getattr(self.args, "dckpt", "")
        if dckpt and self.args.downstream != "Mockingjay":
            self._warm_start_downstream(dckpt)
        if getattr(self.args, "resume", None):
            self.load_model(self.args.resume)
        if self.mesh is not None:
            self.train_step, self.state = make_parallel_train_step(
                self.builder, self.mesh, self.state)
            self.tp = self.train_step.tp
            self.train_step = self._keyed(self.train_step)
            self.eval_step_parallel = make_parallel_eval_step(self.builder, self.mesh)

    def _keyed(self, step):
        """``step`` taking the next step key of the Runner's chain:
        ``self.rng, key = split(self.rng)`` a call, as the JAX Runner splits
        before each train step."""
        def keyed(state, wavs, lengths):
            self.rng, key = prng.split(self.rng)
            return step(state, wavs, lengths, rng=key)

        return keyed

    def _profiled(self):
        """The train step's context: under ``--profile``, at ``profile_step``,
        a trace into ``expdir/profile`` (the module docstring)."""
        if not (getattr(self.args, "profile", False)
                and self.global_step == int(self.rconfig.get("profile_step", 10))):
            return contextlib.nullcontext()
        name = f"train_step{self.global_step}"
        if torch.distributed.is_initialized():
            name += f"_rank{torch.distributed.get_rank()}"
        return trace(os.path.join(self.expdir, "profile"), name)

    def _gather(self):
        """Under a model axis: the train step's slices into the full
        ``downstream_model`` when a step has run since the last gather (a
        collective of the model group, which every rank calls at the same
        point)."""
        if self.tp is not None and self._stale:
            self.tp.gather_into(self.downstream_model, self.state.params)
            self._stale = False

    def _load_pretrained_head_weights(self):
        """SpecHead / Mockingjay: overlay the converted S3PRL blobs onto the
        new head (``random_init`` in the head's model config keeps SpecHead
        random)."""
        name = getattr(self.args, "downstream", "")
        if name not in ("SpecHead", "Mockingjay"):
            return
        model_cfg = self.config.get("model", {}).get(name, {}) or {}
        pre = pretrained_head_params(
            name, ckpt=getattr(self.args, "ckpt", "") or "",
            dckpt=getattr(self.args, "dckpt", "") or "",
            random_init=bool(model_cfg.get("random_init", False)),
        )
        if pre is not None:
            self.downstream_model.load_state_dict(
                overlay_params(self.downstream_model.state_dict(), pre))

    def _dispatch_objective_logger(self, wavs, lengths):
        """Run the forward again with ``train=False`` on this batch and call
        the logger that the objective's aux returns (the objective with TF32
        off, as the steps call it)."""
        ctx = make_context(self.preprocessor, wavs, lengths, self.preprocessor.channel_inp,
                           self.preprocessor.channel_tar)
        with torch.no_grad():
            predicted, aux = self.builder._forward(ctx, train=False)
            with full_f32():
                _, obj_aux = self.objective(**{**ctx, "predicted": predicted, **aux})
        obj_aux["logger"](self.media, self.global_step)

    def _warm_start_downstream(self, dckpt: str):
        """A checkpoint of either package, or a torch one with a
        ``Downstream`` or ``SmallModel`` blob."""
        if ckpt_lib.is_torch_checkpoint(dckpt):
            t = torch.load(dckpt, map_location="cpu", weights_only=False)
            sd = t["Downstream"] if "Downstream" in t else {
                k.split(".", 1)[1]: v for k, v in t["SmallModel"].items()}
            self.downstream_model.load_state_dict(
                convert_downstream_state(sd, self.args.downstream))
        else:
            self._load_downstream(ckpt_lib.load_checkpoint(dckpt))

    def _load_downstream(self, payload):
        """Copy a checkpoint's weights into the model, in place (the train
        state holds the model's own tensors)."""
        self.downstream_model.load_state_dict(flax_to_state_dict(payload["Downstream"]))

    def load_model(self, path: str):
        """Resume from a checkpoint of either package: weights, optimizer
        moments and count, and the global step."""
        payload = ckpt_lib.load_checkpoint(path)
        self._load_downstream(payload)
        opt_state = ckpt_lib.optimizer_state_from_payload(payload["Optimizer"], self.device)
        if opt_state is None:
            opt_state = self.builder.optimizer.init(self.state.params)
        step = int(payload["Global_step"])
        self.state = TrainState(
            self.state.params, opt_state,
            torch.tensor(step, dtype=torch.int32, device=self.device), step,
        )
        self.global_step = step

    def save_model(self, save_type: Optional[str] = None):
        opt_state = self.state.opt_state
        if self.tp is not None:
            self._gather()
            opt_state = self.tp.gather_opt_state(opt_state)
        if not self.is_main:
            return
        save_dir = (
            self.expdir if save_type is None else os.path.join(self.expdir, save_type)
        )
        ckpt_lib.save_checkpoint(
            save_dir,
            self.global_step,
            self.downstream_model,
            ckpt_lib.optimizer_payload(opt_state),
            self.config,
            vars(self.args),
            max_keep=int(self.rconfig.get("max_keep", 2)),
        )

    # -- datasets -------------------------------------------------------
    def get_dataset(self, mode: str = "train"):
        """The dataset of a split, with the JAX package's config surgery."""
        ds_type = self._ds_type()
        if ds_type not in DATASET_REGISTRY:
            raise ValueError(f"unknown dataset type {ds_type}")
        train_conf = copy.deepcopy(self.config[f"{ds_type}_train"])
        test_conf = copy.deepcopy(self.config[f"{ds_type}_test"])

        if mode == "train":
            ds_conf = train_conf
        elif mode == "subtrain":
            ds_conf = train_conf
            ds_conf["infinite"] = False
        elif mode == "dev":
            ds_conf = test_conf
            ds_conf["speech"] = train_conf["speech"]
            ds_conf["speech"]["sample_num"] = self.args.dev_num
            ds_conf["speech"]["select_sampled"] = True
            ds_conf["half_noise"] = "front"
        elif mode == "test":
            ds_conf = test_conf
        elif mode == "record":
            ds_conf = test_conf
            ds_conf["speech"]["sample_num"] = self.args.record_num
            ds_conf["speech"]["select_sampled"] = True
            ds_conf["half_noise"] = "front"
        elif mode == "query":
            ds_conf = train_conf
            ds_conf["pseudo_modes"] = [3]
        elif mode == "query_dev":
            ds_conf = test_conf
            ds_conf["pseudo_modes"] = [3]
            ds_conf["speech"] = train_conf["speech"]
            ds_conf["speech"]["sample_num"] = self.args.dev_num
            ds_conf["speech"]["select_sampled"] = True
        else:
            raise ValueError(f"unknown dataset mode {mode}")

        if isinstance(ds_conf.get("pseudo_modes"), list):
            if self.pseudo_clean is None or self.pseudo_noise is None:
                self._build_pseudo_wavs()

        dataset = DATASET_REGISTRY[ds_type](
            **ds_conf, pseudo_clean=self.pseudo_clean, pseudo_noise=self.pseudo_noise)
        if mode == "subtrain":
            dataset = dataset.get_subset(n_file=100)
        print(f"[runner] {mode} dataset ready: {len(dataset)} utterances", flush=True)
        return dataset

    def get_dataloader(self, dataset, train: bool = True, bsz: Optional[int] = None):
        if bsz is None:
            dl = self.config["dataloader"]
            bsz = dl["batch_size"] if train else dl["eval_batch_size"]
        return DataLoader(
            dataset,
            batch_size=bsz,
            shuffle=train,
            num_workers=self.args.n_jobs,
            buckets=self.buckets,
            drop_last=train,
        )

    # -- pseudo wavs ----------------------------------------------------
    def _upstreams(self):
        """The two upstreams of the pseudo wavs, built at first use, in eval
        mode on the Runner's device."""
        if self.upstream_model is None or self.upstream_model2 is None:
            if self.pseudo_upstreams is None:
                raise ValueError("the pseudo wavs need the two upstreams, and this Runner "
                                 "was given none")
            self.upstream_model, self.upstream_model2 = self.pseudo_upstreams()
        for up in (self.upstream_model, self.upstream_model2):
            up.to(self.device).eval()
        return self.upstream_model, self.upstream_model2

    @torch.no_grad()
    def _pseudo_wav(self, upstream, wavs, phase_inp, lengths, max_len):
        """The upstream's forward and spec head, decoded with the noisy phase
        at -25 dB."""
        hidden = upstream(self.preprocessor(wavs)[0])
        return decode_wav(self.preprocessor, upstream.spec_head(hidden), phase_inp, lengths,
                          max_len, -25)

    def _build_pseudo_wavs(self):
        """Pseudo-clean and pseudo-noise waveforms from the two upstreams over
        the record split, logged at step 1."""
        recordset = self.get_dataset("record")
        loader = self.get_dataloader(recordset, train=False, bsz=len(recordset))
        lengths, wavs = next(iter(loader))[:2]
        for ch, tag in ((0, "noisy"), (1, "clean"), (2, "noise")):
            self.media.media_logging(1, f"record/{tag}", wavs[:, ch, :])
        up, up2 = self._upstreams()
        wavs_t = torch.from_numpy(wavs).to(self.device)
        lengths_t = torch.from_numpy(lengths).to(self.device)
        with torch.no_grad():
            phase_inp = self.preprocessor(wavs_t)[3]
        for attr, upstream, tag in (("pseudo_clean", up, "record/pseudo_clean"),
                                    ("pseudo_noise", up2, "record/pseudo_noise")):
            pw = self._pseudo_wav(upstream, wavs_t, phase_inp, lengths_t,
                                  wavs.shape[-1]).cpu().numpy()
            self.media.media_logging(1, tag, pw)
            setattr(self, attr, [w[:n] for w, n in zip(pw, lengths)])

    # -- sampler lifecycle ---------------------------------------------
    def _sampler_device(self) -> torch.device:
        """``--sampler_device`` k: card k, or the last card when there are
        fewer; the Runner's device when it is the CPU."""
        if self.device.type != "cuda":
            return self.device
        return torch.device(
            f"cuda:{min(int(self.args.sampler_device), torch.cuda.device_count() - 1)}")

    def _scoring_fn(self):
        return make_scoring_fn(self.builder, getattr(self.args, "active_layerid", None))

    def _start_sampler(self):
        queryset = self.get_dataset("query")
        queryloader = self.get_dataloader(
            queryset, train=True, bsz=int(self.rconfig["active_query_num"]))
        query_batch = next(iter(queryloader))
        candidates = self.get_dataset("train")
        candidates.pseudo_modes = list(range(ACTIVE_BUFFER_NUM))
        self.sampler = AsyncSampler(
            scoring_fn=self._scoring_fn(),
            model=self.downstream_model,
            dataset=candidates,
            loader_factory=lambda: self.get_dataloader(
                candidates, train=True, bsz=self.config["dataloader"]["batch_size"]),
            query_batch=query_batch,
            sample_num=int(self.rconfig["sampler_sample_num"]),
            device=self._sampler_device(),
        )
        self.sampler.start()

    def _kill_sampler(self):
        if self.sampler is not None:
            self.sampler.stop()
            sampler, self.sampler = self.sampler, None
            sampler.check()

    # -- train ----------------------------------------------------------
    def train(self):
        total_steps = int(self.rconfig["total_step"])
        log_step = int(self.rconfig["log_step"])
        media_step = int(self.rconfig["media_step"]) if "media_step" in self.rconfig else None

        eval_settings = []
        for split_name in self.rconfig["eval_splits"]:
            split_loader = self.get_dataloader(self.get_dataset(split_name), train=False)
            # the best starts at ZERO, as in the reference: a negative metric
            # (an SI-SDR below 0 dB) triggers no best save until it crosses 0
            eval_settings.append(
                (split_name, split_loader, np.zeros(len(self.metric_names)))
            )

        def eval_and_log(log_media=False):
            for split_name, split_loader, metrics_best in eval_settings:
                loss, scores, *eval_wavs = self.evaluate(split_loader)
                self.log.add_scalar(f"{split_name}_loss", loss, self.global_step)
                for score, mname in zip(scores, self.metric_names):
                    self.log.add_scalar(f"{split_name}_{mname}", score, self.global_step)
                if (scores > metrics_best).sum() > 0:
                    np.maximum(metrics_best, scores, out=metrics_best)
                    if self.args.save_best:
                        self.save_model(split_name)
                if log_media:
                    for idx, ws in enumerate(zip(*eval_wavs)):
                        for tag, wav in zip(("noisy", "clean", "enhanced"), ws):
                            self.media.media_logging(self.global_step,
                                                     f"{split_name}-{tag}-{idx}", wav)

        if self.args.eval_init:
            eval_and_log()

        trainset = self.get_dataset("train")
        sync = bool(getattr(self.args, "sync_sampler", False))
        if sync:
            queryloader = self.get_dataloader(
                self.get_dataset("query"), bsz=int(self.rconfig["active_query_num"]))
            query_iter = iter(queryloader)
            trainloader = self.get_dataloader(
                trainset, bsz=self.config["dataloader"]["active_batch_size"])
            scoring = self._scoring_fn()
        else:
            trainloader = self.get_dataloader(trainset)
        active_sampling = bool(getattr(self.args, "active_sampling", False))
        async_sampler = getattr(self.args, "sampler_device", None) is not None
        # under a mesh of several ranks the sampler runs on rank 0, which
        # hands its batch to the others each step
        shared = self.mesh is not None and self.mesh.size > 1 and (
            sync or async_sampler or active_sampling)
        pseudo_media = [(flag, i) for i, flag in enumerate(("pseudo_clean", "pseudo_noise"))
                        if getattr(self.args, flag, False)]
        active_samples: Dict[int, Dict[int, list]] = defaultdict(lambda: defaultdict(list))

        loss_sum, last_norm = 0.0, 0.0
        t_start = time.time()
        done = False
        while not done:
            for batch in device_prefetch(trainloader, self.device):
                if self.global_step > total_steps:
                    done = True
                    break
                lengths, wavs = batch[0], batch[1]
                cases = batch[2] if len(batch) == 3 else None
                media_loggers = []
                if sync or async_sampler:
                    self._gather()  # the sampler scores with the full model

                if async_sampler and self.is_main:
                    if self.sampler is None or not self.sampler.alive:
                        # a sampler that died raises its error, never restarts
                        self._kill_sampler()
                        self._start_sampler()
                    if self.global_step % int(self.rconfig["sampler_collect_step"]) == 0:
                        for key, samples in self.sampler.collect().items():
                            active_samples[self.global_step][key] += samples

                if sync:
                    # every rank splits, so that the ranks' step keys agree
                    self.rng, q_rng, t_rng = prng.split(self.rng, 3)
                if sync and self.is_main:
                    try:
                        q_lengths, q_wavs, _ = next(query_iter)
                    except StopIteration:
                        query_iter = iter(queryloader)
                        q_lengths, q_wavs, _ = next(query_iter)
                    q_scores = scoring(self.downstream_model, q_wavs, q_lengths, mean=True,
                                       rng=q_rng)
                    t_scores = scoring(self.downstream_model, wavs, lengths, rng=t_rng)
                    match = matching(q_scores, t_scores).cpu().numpy()
                    is_match = np.nonzero(match > 0)[0]
                    matched = wavs[torch.from_numpy(is_match).to(wavs.device)].cpu().numpy()
                    for w, n, case, score in zip(matched, lengths.cpu().numpy()[is_match],
                                                 cases.cpu().numpy()[is_match],
                                                 match[is_match]):
                        active_samples[self.global_step][int(case)].append(
                            {"wavs": w[:, : int(n)].T.copy(), "match_score": float(score)})
                    # the query and the matches as this step scored them
                    media_loggers.append((q_wavs, "active/query"))
                    if len(is_match):
                        media_loggers.append((matched, "active/match"))

                if active_sampling and self.is_main:
                    prev = self.global_step - int(self.rconfig["active_refresh_step"])
                    if prev > 1:
                        active_samples.pop(prev, None)
                    merged: Dict[int, list] = defaultdict(list)
                    for step_samples in active_samples.values():
                        for key, value in step_samples.items():
                            merged[key] += value
                    pairs = [(i, w) for i, w in enumerate(self.rconfig["active_buffer_weights"])
                             if len(merged[i]) > 0]
                    if pairs:
                        types = random.choices([p[0] for p in pairs], [p[1] for p in pairs],
                                               k=self.config["dataloader"]["batch_size"])
                        chosen = [random.choice(merged[t])["wavs"] for t in types]
                        lengths, wavs = (torch.from_numpy(x).to(self.device)
                                         for x in trainloader._collate(chosen)[:2])
                if shared:
                    lengths, wavs = broadcast_batch((lengths, wavs), self.mesh, self.device)

                with self._profiled():
                    self.state, stats = self.train_step(self.state, wavs, lengths)
                self._stale = self.tp is not None
                loss_sum += float(stats["loss"])
                last_norm = float(stats["grad_norm"])

                if self.global_step % log_step == 0:
                    loss_avg = loss_sum / log_step
                    steps_s = log_step / max(time.time() - t_start, 1e-9)
                    self.log.add_scalar("loss", loss_avg, self.global_step)
                    self.log.add_scalar("gradient norm", last_norm, self.global_step)
                    self.log.add_scalar("steps_per_sec", steps_s, self.global_step)
                    if self.is_main:
                        print(
                            f"[runner] step {self.global_step}/{total_steps} | "
                            f"loss {loss_avg:.5f} | grad_norm {last_norm:.4f} | "
                            f"{steps_s:.2f} steps/s",
                            flush=True,
                        )
                    t_start = time.time()
                    loss_sum = 0.0
                    if getattr(self.objective, "has_logger", False):
                        self._gather()
                        if self.is_main:
                            self._dispatch_objective_logger(wavs, lengths)

                media_now = media_step is not None and self.global_step % media_step == 0
                if media_now and self.is_main:
                    for data, prefix in media_loggers:
                        for ch, tag in ((0, "noisy"), (1, "clean"), (2, "noise")):
                            if data.shape[1] > ch:
                                self.media.media_logging(self.global_step, f"{prefix}_{tag}",
                                                         data[:, ch, :])
                    for ch, tag in ((0, "noisy"), (1, "clean"), (2, "noise")):
                        if wavs.shape[1] > ch:
                            self.media.media_logging(self.global_step, tag, wavs[:, ch, :])
                    if pseudo_media:
                        phase_inp = self.preprocessor(wavs)[3]
                        upstreams = self._upstreams()
                        for flag, i in pseudo_media:
                            self.media.media_logging(self.global_step, flag, self._pseudo_wav(
                                upstreams[i], wavs, phase_inp, lengths, wavs.shape[-1]))

                if active_sampling and self.global_step % int(
                        self.rconfig["sampler_refresh_step"]) == 0:
                    self._kill_sampler()

                if self.global_step % int(self.rconfig["eval_step"]) == 0:
                    eval_and_log(media_now)

                if "save_step" in self.rconfig and self.global_step % int(
                    self.rconfig["save_step"]
                ) == 0:
                    self.save_model()

                self.global_step += 1

        self._kill_sampler()
        self.save_model()

    # -- evaluate --------------------------------------------------------
    def evaluate(self, dataloader=None):
        """Per-batch metric means averaged over batches, after reseeding the
        random modules with ``--seed``."""
        random.seed(self.args.seed)
        np.random.seed(self.args.seed)
        self._gather()

        if dataloader is None:
            dataloader = self.get_dataloader(self.get_dataset("test"), train=False)

        n_batches = len(dataloader)
        sample_interval = max(int(n_batches / LOG_WAV_NUM), 1)
        sample_indices = set(range(0, n_batches, sample_interval))
        noisy_wavs, clean_wavs, enhanced_wavs = [], [], []
        score_default = 0.0 if getattr(self.args, "no_metric", False) else np.nan

        loss_sum = 0.0
        scores_sum = np.zeros(len(self.metric_names))
        # the host metrics read every row of the enhanced and clean waveforms;
        # otherwise only utterance 0 comes back (the logged samples)
        wav_out = "full" if self.host_metric_names else "first"
        for indice, batch in enumerate(device_prefetch(dataloader, self.device)):
            lengths, wavs = batch[0], batch[1]
            # under a mesh a batch the ranks divide is scored a rank's rows each
            if self.eval_step_parallel is not None and len(lengths) % self.mesh.size == 0:
                out = self.eval_step_parallel(wavs, lengths, wav_out=wav_out)
            else:
                out = self.builder.eval_step(wavs, lengths, wav_out=wav_out)
            loss_sum += float(out["loss"])
            batch_scores = {
                name: float(vals.mean()) for name, vals in out["scores"].items()
            }
            if self.host_metric_names:
                wp = out["wav_predicted"].cpu().numpy()
                wt = out["wav_tar"].cpu().numpy()
                lens = lengths.cpu().numpy()
                for name in self.host_metric_names:
                    fn = METRIC_REGISTRY[name]
                    batch_scores[name] = float(np.mean(
                        [fn(wp[i][: lens[i]], wt[i][: lens[i]]) for i in range(len(lens))]))
            scores_sum += np.array(
                [batch_scores.get(m, score_default) for m in self.metric_names]
            )
            if indice in sample_indices and len(enhanced_wavs) < LOG_WAV_NUM:
                n = int(lengths[0])
                noisy_wavs.append(out["wav_inp"][0][:n].cpu().numpy())
                clean_wavs.append(out["wav_tar"][0][:n].cpu().numpy())
                enhanced_wavs.append(out["wav_predicted"][0][:n].cpu().numpy())

        loss_avg = loss_sum / n_batches
        scores_avg = scores_sum / n_batches
        named = ", ".join(f"{m} {v:.4f}" for m, v in zip(self.metric_names, scores_avg))
        if self.is_main:
            print(f"[runner] evaluate: loss {loss_avg:.5f} | {named}", flush=True)
        return loss_avg, scores_avg, noisy_wavs, clean_wavs, enhanced_wavs

    # -- gradient diagnostic ---------------------------------------------
    def test_gradient(self):
        """The cosine similarity of each candidate's gradient embedding with
        the query batch's mean embedding, by pseudo case, over ``--n_iterate``
        pairs of batches (10 when unset); drawn as a box plot to
        ``expdir/sim_box.png`` and returned as {case: [similarity, ...]}."""
        self._build_pseudo_wavs()
        scoring = self._scoring_fn()
        queryset = self.get_dataset("query")
        trainset = self.get_dataset("train")
        trainset.pseudo_modes = list(range(ACTIVE_BUFFER_NUM))
        bsz = self.config["dataloader"]["batch_size"]
        query_loader = infinite_iterator(self.get_dataloader(queryset, bsz=bsz))
        train_loader = infinite_iterator(self.get_dataloader(trainset, bsz=bsz))

        similarities = defaultdict(list)
        for _ in range(int(getattr(self.args, "n_iterate", None) or 10)):
            q_lengths, q_wavs, _ = next(query_loader)
            t_lengths, t_wavs, cases = next(train_loader)
            if q_wavs.shape == t_wavs.shape and np.allclose(q_wavs, t_wavs):
                continue
            q = scoring(self.downstream_model, q_wavs, q_lengths, mean=True)
            t = scoring(self.downstream_model, t_wavs, t_lengths)
            for sim, case in zip(matching(q, t).cpu().numpy(), cases):
                similarities[int(case)].append(float(sim))

        with open(os.path.join(self.expdir, "sim_box.png"), "wb") as f:
            f.write(boxplot_png([similarities[i] or [0.0] for i in range(ACTIVE_BUFFER_NUM)]))
        return similarities
