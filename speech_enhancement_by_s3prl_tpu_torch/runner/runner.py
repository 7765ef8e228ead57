"""Training and evaluation lifecycle (counterpart of
``speech_enhancement_by_s3prl_tpu/runner/runner.py``), for the subset that
trains on ``OnlineDataset`` splits in the three modes of
``runner/trainer.py``: ``from_rawfeature`` heads, ``from_waveform`` heads
(``Mockingjay`` finetuning the whole encoder) and heads over a frozen
upstream.

- Dataset modes ``train``, ``subtrain``, ``dev`` and ``test``.
- ``train``: log, eval and save cadences, ``max_keep`` rotation, best-per-
  split saves under ``--save_best`` (the best starts at zero), a final save.
- ``evaluate``: reseeds the random modules and returns the per-batch mean of
  means. The eval step scores the metrics that have a batched version on
  the device (``metrics.device_batch_metrics``); PESQ moves to the host, one
  utterance at a time, only where the ITU ``pesq`` wheel imports.
- ``--dckpt``: the pretraining checkpoint for ``Mockingjay`` (its encoder
  and SpecHead weights, like ``--ckpt``'s SpecHead for ``SpecHead``, are
  overlaid onto the new head); a warm start of the whole head otherwise.
- Scalars go to ``expdir/scalars.jsonl`` as one JSON object a line
  (``{"step", "tag", "value"}``), under the JAX package's TensorBoard tags.

Not ported yet, each refused with its ROADMAP item: the modes ``record``,
``query`` and ``query_dev``, the active sampler and ``--sync_sampler`` /
``--active_sampling``, the second upstream and the pseudo wavs it makes
(``--ckpt2``, ``--dropout2``, ``--pseudo_clean``, ``--pseudo_noise``) (A9),
``--mesh`` (A12), ``--profile`` (A11), media logging (``media_step``, A7,
the port's next slice) and ``test_gradient`` (A9).
"""
from __future__ import annotations

import copy
import json
import os
import random
import time
from typing import Optional

import numpy as np
import torch

from ..data.datasets import DATASET_REGISTRY
from ..data.loader import DataLoader, default_buckets, device_prefetch
from ..metrics import METRIC_REGISTRY, check_metrics, device_batch_metrics
from ..models.convert import flax_to_state_dict
from ..models.torch_import import (
    convert_downstream_state,
    overlay_params,
    pretrained_head_params,
)
from ..objectives import build_objective
from . import checkpoint as ckpt_lib
from .optim import build_optimizer
from .trainer import StepBuilder, TrainState

LOG_WAV_NUM = 3


class ScalarLog:
    """Scalars appended to ``expdir/scalars.jsonl``, one JSON object a line."""

    def __init__(self, expdir: str):
        os.makedirs(expdir, exist_ok=True)
        self.path = os.path.join(expdir, "scalars.jsonl")

    def add_scalar(self, tag: str, value, global_step: int):
        line = {"step": int(global_step), "tag": tag, "value": float(value)}
        with open(self.path, "a") as f:
            f.write(json.dumps(line) + "\n")


def _refuse(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class Runner:
    """The training and evaluation lifecycle on ``device``. ``upstream``
    (models/upstream.py) feeds the head in the upstream mode."""

    def __init__(self, args, config, preprocessor, downstream, expdir, device,
                 upstream=None):
        self.args = args
        self.config = config
        self.rconfig = config["runner"]
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Runner on cuda, but there is no CUDA device")
        for flag, item in (("sync_sampler", "A9"), ("active_sampling", "A9"),
                           ("mesh", "A12"), ("profile", "A11"), ("ckpt2", "A9"),
                           ("dropout2", "A9"), ("pseudo_clean", "A9"),
                           ("pseudo_noise", "A9")):
            if getattr(args, flag, None):
                _refuse(f"--{flag}", item)
        if getattr(args, "sampler_device", None) is not None:
            _refuse("the async active sampler (--sampler_device)", "A9")
        if "media_step" in self.rconfig:
            _refuse("media logging (runner.media_step; it comes with the perceptual "
                    "objectives in the port's next slice)", "A7")

        self.preprocessor = preprocessor
        self.downstream_model = downstream.to(self.device)
        self.upstream = None if upstream is None else upstream.to(self.device)
        self.expdir = expdir
        self.global_step = 1
        self.log = ScalarLog(expdir)

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
        self.train_step = self.builder.train_step
        self._load_pretrained_head_weights()
        # --dckpt is Mockingjay's pretraining checkpoint, read above; for
        # every other head it is a warm start
        dckpt = getattr(self.args, "dckpt", "")
        if dckpt and self.args.downstream != "Mockingjay":
            self._warm_start_downstream(dckpt)
        if getattr(self.args, "resume", None):
            self.load_model(self.args.resume)

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
        save_dir = (
            self.expdir if save_type is None else os.path.join(self.expdir, save_type)
        )
        ckpt_lib.save_checkpoint(
            save_dir,
            self.global_step,
            self.downstream_model,
            ckpt_lib.optimizer_payload(self.state.opt_state),
            self.config,
            vars(self.args),
            max_keep=int(self.rconfig.get("max_keep", 2)),
        )

    # -- datasets -------------------------------------------------------
    def get_dataset(self, mode: str = "train"):
        """The dataset of a split, with the JAX package's config surgery."""
        if mode in ("record", "query", "query_dev"):
            _refuse(f"dataset mode {mode!r} (the active sampler's splits)", "A9")
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
        else:
            raise ValueError(f"unknown dataset mode {mode}")

        dataset = DATASET_REGISTRY[ds_type](**ds_conf)
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

    # -- train ----------------------------------------------------------
    def train(self):
        total_steps = int(self.rconfig["total_step"])
        log_step = int(self.rconfig["log_step"])

        eval_settings = []
        for split_name in self.rconfig["eval_splits"]:
            split_loader = self.get_dataloader(self.get_dataset(split_name), train=False)
            # the best starts at ZERO, as in the reference: a negative metric
            # (an SI-SDR below 0 dB) triggers no best save until it crosses 0
            eval_settings.append(
                (split_name, split_loader, np.zeros(len(self.metric_names)))
            )

        def eval_and_log():
            for split_name, split_loader, metrics_best in eval_settings:
                loss, scores, *_ = self.evaluate(split_loader)
                self.log.add_scalar(f"{split_name}_loss", loss, self.global_step)
                for score, mname in zip(scores, self.metric_names):
                    self.log.add_scalar(f"{split_name}_{mname}", score, self.global_step)
                if (scores > metrics_best).sum() > 0:
                    np.maximum(metrics_best, scores, out=metrics_best)
                    if self.args.save_best:
                        self.save_model(split_name)

        if self.args.eval_init:
            eval_and_log()

        trainloader = self.get_dataloader(self.get_dataset("train"))
        loss_sum, last_norm = 0.0, 0.0
        t_start = time.time()
        done = False
        while not done:
            for batch in device_prefetch(trainloader, self.device):
                if self.global_step > total_steps:
                    done = True
                    break
                lengths, wavs = batch[0], batch[1]
                self.state, stats = self.train_step(self.state, wavs, lengths)
                loss_sum += float(stats["loss"])
                last_norm = float(stats["grad_norm"])

                if self.global_step % log_step == 0:
                    loss_avg = loss_sum / log_step
                    steps_s = log_step / max(time.time() - t_start, 1e-9)
                    self.log.add_scalar("loss", loss_avg, self.global_step)
                    self.log.add_scalar("gradient norm", last_norm, self.global_step)
                    self.log.add_scalar("steps_per_sec", steps_s, self.global_step)
                    print(
                        f"[runner] step {self.global_step}/{total_steps} | "
                        f"loss {loss_avg:.5f} | grad_norm {last_norm:.4f} | "
                        f"{steps_s:.2f} steps/s",
                        flush=True,
                    )
                    t_start = time.time()
                    loss_sum = 0.0

                if self.global_step % int(self.rconfig["eval_step"]) == 0:
                    eval_and_log()

                if "save_step" in self.rconfig and self.global_step % int(
                    self.rconfig["save_step"]
                ) == 0:
                    self.save_model()

                self.global_step += 1

        self.save_model()

    # -- evaluate --------------------------------------------------------
    def evaluate(self, dataloader=None):
        """Per-batch metric means averaged over batches, after reseeding the
        random modules with ``--seed``."""
        random.seed(self.args.seed)
        np.random.seed(self.args.seed)

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
        print(f"[runner] evaluate: loss {loss_avg:.5f} | {named}", flush=True)
        return loss_avg, scores_avg, noisy_wavs, clean_wavs, enhanced_wavs

    def test_gradient(self):
        _refuse("test_gradient (the active sampler's gradient diagnostic)", "A9")
