"""Checkpoint -> enhancer on a device (counterpart of the repository's
``serve.py``, for ``from_rawfeature`` checkpoints).

``build_enhancer(ckpt, device=...)`` returns ``enhance(wav) -> wav`` with
``.run_batch(list_of_wavs)``: requests are padded to a duration bucket and
run as one batch (STFT -> head -> iSTFT with the noisy phase -> level
renorm). ``MicroBatcher`` coalesces concurrent requests of one bucket into
one device batch. The HTTP front end, the upstream and waveform modes,
mesh serving, export artifacts and the crossfaded streaming of requests
longer than the largest bucket are not ported yet (ROADMAP A8, A10, A12).
"""
from __future__ import annotations

import os
import queue
import threading
import time

import numpy as np
import torch

from . import use_full_fp32
from .data.loader import bucket_length, default_buckets
from .models.convert import flax_to_state_dict
from .models.heads import build_head
from .ops.features import OnlinePreprocessor, get_feat_config
from .runner.checkpoint import load_checkpoint
from .runner.trainer import decode_wav


class MicroBatcher:
    """Coalesce concurrent single-utterance requests into one device batch.

    Handler threads call ``submit(wav)`` and block; one dispatcher thread
    drains the queue (waiting at most ``window_ms`` after the first arrival),
    groups the requests by duration bucket, runs each group as one batch and
    hands the results back. One device batch in flight at a time.
    """

    def __init__(self, run_batch, max_batch=16, window_ms=3.0, bucket_of=None):
        self._run = run_batch  # list[np.ndarray] -> list[np.ndarray]
        self.max_batch = max_batch
        self.window = window_ms / 1000.0
        # requests are only coalesced within one duration bucket: the
        # backward LSTM direction and CMVN see the padding, so a short
        # request padded to a long co-rider's bucket would return different
        # audio than it would alone. bucket_of maps a sample COUNT to its
        # bucket; default: every length is its own bucket
        self._bucket_of = bucket_of if bucket_of is not None else (lambda n: n)
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, wav: np.ndarray) -> np.ndarray:
        ev = threading.Event()
        slot: dict = {}
        self._q.put((wav, ev, slot))
        ev.wait()
        if "err" in slot:
            raise slot["err"]
        return slot["out"]

    def _loop(self):
        while True:
            group = [self._q.get()]
            deadline = time.monotonic() + self.window
            while len(group) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    group.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            by_bucket: dict = {}
            for g in group:
                try:
                    key = self._bucket_of(len(g[0]))
                except Exception as e:
                    # a bad bucket_of fails the request, not the dispatcher
                    g[2]["err"] = e
                    g[1].set()
                    continue
                by_bucket.setdefault(key, []).append(g)
            for sub in by_bucket.values():
                try:
                    outs = self._run([g[0] for g in sub])
                    for (_, ev, slot), out in zip(sub, outs):
                        slot["out"] = out
                        ev.set()
                except Exception as e:  # surfaced to every caller of the group
                    for _, ev, slot in sub:
                        slot["err"] = e
                        ev.set()


def _load_ckpt_settings(path: str):
    """Settings of a checkpoint -> (config, paras_dict)."""
    p = load_checkpoint(path)
    return p["Settings"]["Config"], dict(p["Settings"]["Paras"])


def build_raw_enhancer(ckpt: str, sample_rate: int, target_level: float,
                       device, max_bucket_ms: int = 60000,
                       upstream_ckpt: str = "", dckpt: str = ""):
    """Checkpoint -> (model, enhance_raw(wavs (B, T), lengths (B,)),
    buckets), with the model on ``device``. ``upstream_ckpt`` / ``dckpt``
    relocate the pretraining checkpoints recorded in the settings."""
    payload = load_checkpoint(ckpt)
    paras = dict(payload["Settings"]["Paras"])
    config = payload["Settings"]["Config"]
    if paras.get("from_waveform") or not paras.get("from_rawfeature"):
        mode = "waveform" if paras.get("from_waveform") else "upstream"
        raise NotImplementedError(
            f"this checkpoint runs in '{mode}' mode; the port serves "
            "from_rawfeature checkpoints only (the upstream slice is "
            "ROADMAP A8)"
        )
    downstream = paras.get("downstream", "LSTM")
    if upstream_ckpt:
        paras["ckpt"] = upstream_ckpt
    if dckpt:
        paras["dckpt"] = dckpt
    up_ckpt = paras.get("ckpt", "") or ""
    d_path = paras.get("dckpt", "") or ""
    for path, what, flag in ((up_ckpt, "the preprocessor geometry", "--upstream_ckpt"),
                             (d_path, "the downstream feature/model config", "--dckpt")):
        if path and not os.path.exists(path):
            raise FileNotFoundError(
                f"the checkpoint took {what} from '{path}', which is not "
                f"readable here: pass {flag} with the relocated file"
            )
    baseline_feat = dict(config["preprocessor"]["baseline"])
    baseline_feat["channel"] = 0

    online: dict = {}
    if up_ckpt:
        # an S3PRL pretraining checkpoint (a torch pickle) records the STFT
        # geometry the downstream was trained with
        up_payload = torch.load(up_ckpt, map_location="cpu", weights_only=False)
        online = dict(up_payload["Settings"]["Config"]["online"])

    downstream_feat = dict(baseline_feat)
    model_cfg = config.get("model", {}).get(downstream, {}) or {}
    if d_path:
        dconfig, dparas = _load_ckpt_settings(d_path)
        downstream_feat = (
            dict(dconfig["online"]["input"]) if "online" in dconfig
            else dict(dconfig["preprocessor"]["baseline"])
        )
        downstream_feat["channel"] = 0
        model_cfg = (
            dconfig["small_model"]["model"] if "small_model" in dconfig
            else dconfig["model"][dparas.get("downstream", downstream)]
        )

    feat_list = [
        baseline_feat, downstream_feat,
        get_feat_config("linear", 0), get_feat_config("uphase", 0),
        get_feat_config("linear", 0), get_feat_config("uphase", 0),
    ]
    pre = OnlinePreprocessor(**online, feat_list=feat_list)
    dims = pre.feat_dims()
    model = build_head(downstream, input_size=dims[1], output_size=dims[2],
                       **{**paras, **model_cfg})
    model.load_state_dict(flax_to_state_dict(payload["Downstream"]))
    model.eval().to(device)
    buckets = default_buckets(sample_rate, max_bucket_ms)

    @torch.inference_mode()
    def enhance_raw(wavs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        _, down_feat, linear_inp, phase_inp, *_ = pre(wavs[:, None, :])
        predicted, _ = model(down_feat, linear_inp)
        return decode_wav(pre, predicted, phase_inp, lengths, wavs.shape[-1],
                          target_level)

    return model, enhance_raw, buckets


def _pad_group(wavs, buckets, round_pow2: bool = True):
    """Pad a request group to one device shape: the common duration bucket,
    and a row count rounded up to a power of two (bounds the shapes under
    online micro-batching; offline CLIs pass round_pow2=False). Extra rows
    repeat row 0 and are discarded by the caller. Returns (batch (n, T) f32,
    lens (n,) int64)."""
    T = bucket_length(max(len(w) for w in wavs), buckets)
    n = max(1, 1 << (len(wavs) - 1).bit_length()) if round_pow2 else len(wavs)
    batch = np.zeros((n, T), np.float32)
    lens = np.empty((n,), np.int64)
    for k, w in enumerate(wavs):
        batch[k, : len(w)] = w
        lens[k] = len(w)
    batch[len(wavs):] = batch[0]
    lens[len(wavs):] = lens[0]
    return batch, lens


def _finish_enhancer(run_batch, buckets):
    """Wrap a padded-group runner into the serving interface."""

    def enhance(wav: np.ndarray) -> np.ndarray:
        return run_batch([wav])[0]

    enhance.run_batch = run_batch
    enhance.max_len = buckets[-1]
    enhance.bucket_of = lambda n: bucket_length(n, buckets)
    return enhance


def build_enhancer(ckpt: str, sample_rate: int = 16000, target_level: float = -25.0,
                   *, device, max_bucket_ms: int = 60000, round_pow2: bool = True,
                   upstream_ckpt: str = "", dckpt: str = ""):
    """``enhance(wav)`` on ``device``. ``device="cuda"`` with no card raises;
    nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_enhancer(device='cuda'): no CUDA device here")
    use_full_fp32()
    _, enhance_raw, buckets = build_raw_enhancer(
        ckpt, sample_rate, target_level, device, max_bucket_ms,
        upstream_ckpt=upstream_ckpt, dckpt=dckpt,
    )

    def run_batch(wavs) -> list:
        for w in wavs:
            if len(w) > buckets[-1]:
                raise NotImplementedError(
                    f"a request of {len(w)} samples is longer than the "
                    f"largest bucket ({buckets[-1]}); crossfaded streaming "
                    "is not ported yet (ROADMAP A10)"
                )
        batch, lens = _pad_group(wavs, buckets, round_pow2)
        out = enhance_raw(
            torch.from_numpy(batch).to(device), torch.from_numpy(lens).to(device)
        ).cpu().numpy()
        return [out[k, : len(w)] for k, w in enumerate(wavs)]

    return _finish_enhancer(run_batch, buckets)
