"""Checkpoint -> enhancer on a device (counterpart of the repository's
``serve.py``).

``build_enhancer(ckpt, device=...)`` returns ``enhance(wav) -> wav`` with
``.run_batch(list_of_wavs)``: requests are padded to a duration bucket and
run as one batch (STFT -> [upstream ->] head -> iSTFT with the noisy phase ->
level renorm). It serves the checkpoints of all three training modes:
``from_rawfeature``, ``from_waveform`` (``Mockingjay``) and the upstream
mode, whose frozen upstream is rebuilt from the recorded S3PRL checkpoint
(``--ckpt``, relocated by ``upstream_ckpt``); an upstream-mode checkpoint
that records none is refused, as the JAX package refuses it.
``MicroBatcher`` coalesces concurrent requests of one bucket into one device
batch. A request longer than the largest bucket runs through
``ops/streaming.enhance_streaming``: windows of the largest bucket with one
second of cosine crossfade. ``recurrence`` ("tm", "blocked", "fused") names
the kernel the BLSTM layers run (``models/lstm.LSTMStack``); one checkpoint
serves under all three. The HTTP front end, the stateful streamer, mesh
serving and export artifacts are not ported yet (ROADMAP A10, A12).
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
from .models.upstream import build_upstream
from .ops.features import OnlinePreprocessor, get_feat_config
from .ops.streaming import enhance_streaming
from .run_downstream import PRETRAIN_ONLINE
from .runner.checkpoint import load_checkpoint, load_settings
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


def build_raw_enhancer(ckpt: str, sample_rate: int, target_level: float,
                       device, max_bucket_ms: int = 60000,
                       upstream_ckpt: str = "", dckpt: str = "",
                       recurrence: str = "tm"):
    """Checkpoint -> (model, enhance_raw(wavs (B, T), lengths (B,)),
    buckets), with the model on ``device``. ``upstream_ckpt`` / ``dckpt``
    relocate the pretraining checkpoints recorded in the settings;
    ``recurrence`` names the kernel of the head's BLSTM layers."""
    payload = load_checkpoint(ckpt)
    paras = dict(payload["Settings"]["Paras"])
    config = payload["Settings"]["Config"]
    mode = ("waveform" if paras.get("from_waveform")
            else "rawfeature" if paras.get("from_rawfeature") else "upstream")
    downstream = paras.get("downstream", "LSTM")
    up_name = paras.get("upstream", "transformer")
    if upstream_ckpt:
        paras["ckpt"] = upstream_ckpt
    if dckpt:
        paras["dckpt"] = dckpt
    up_ckpt = paras.get("ckpt", "") or ""
    d_path = paras.get("dckpt", "") or ""
    up_what = "the upstream" if mode == "upstream" else "the preprocessor geometry"
    for path, what, flag in ((up_ckpt, up_what, "--upstream_ckpt"),
                             (d_path, "the downstream feature/model config", "--dckpt")):
        if path and not os.path.exists(path):
            raise FileNotFoundError(
                f"the checkpoint took {what} from '{path}', which is not "
                f"readable here: pass {flag} with the relocated file"
            )
    baseline_feat = dict(config["preprocessor"]["baseline"])
    baseline_feat["channel"] = 0

    online: dict = {}
    up_payload = None
    if up_ckpt:
        # an S3PRL pretraining checkpoint (a torch pickle) records the STFT
        # geometry the downstream was trained with
        up_payload = torch.load(up_ckpt, map_location="cpu", weights_only=False)
        online = dict(up_payload["Settings"]["Config"]["online"])
    # the upstream-input feature, as training built it
    # (run_downstream.get_preprocessor)
    upstream_feat = dict(baseline_feat)
    if up_name == "transformer":
        if mode == "upstream" and not up_ckpt:
            # a randomly drawn upstream cannot be drawn again bit for bit
            # (the JAX package draws it from its own PRNG)
            raise ValueError(
                "the checkpoint was trained on the hidden states of an upstream "
                "but records no S3PRL pretraining checkpoint: pass --upstream_ckpt")
        upstream_feat = dict(online.get("input", PRETRAIN_ONLINE["input"]))
        upstream_feat["channel"] = 0

    downstream_feat = dict(baseline_feat)
    model_cfg = config.get("model", {}).get(downstream, {}) or {}
    if d_path:
        dconfig, dparas = load_settings(d_path)
        downstream_feat = (
            dict(dconfig["online"]["input"]) if "online" in dconfig
            else dict(dconfig["preprocessor"]["baseline"])
        )
        downstream_feat["channel"] = 0
        if downstream == "Mockingjay":
            model_cfg = {}  # its structure comes from the pretraining checkpoint
        else:
            model_cfg = (
                dconfig["small_model"]["model"] if "small_model" in dconfig
                else dconfig["model"][dparas.get("downstream", downstream)]
            )

    feat_list = [
        upstream_feat, downstream_feat,
        get_feat_config("linear", 0), get_feat_config("uphase", 0),
        get_feat_config("linear", 0), get_feat_config("uphase", 0),
    ]
    pre = OnlinePreprocessor(**online, feat_list=feat_list)
    dims = pre.feat_dims()
    upstream = None
    if mode == "upstream":
        upstream = build_upstream(
            up_name, dims[0], up_ckpt, payload=up_payload,
            compute_dtype=paras.get("compute_dtype", "f32"),
        ).eval().to(device)
        in_size = upstream.out_dim
    else:
        in_size = dims[0] if mode == "waveform" else dims[1]
    model = build_head(downstream, input_size=in_size, output_size=dims[2],
                       **{**paras, **model_cfg, "recurrence": recurrence})
    model.load_state_dict(flax_to_state_dict(payload["Downstream"]))
    model.eval().to(device)
    buckets = default_buckets(sample_rate, max_bucket_ms)

    @torch.inference_mode()
    def enhance_raw(wavs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        up_feat, down_feat, linear_inp, phase_inp, *_ = pre(wavs[:, None, :])
        if upstream is not None:
            features = upstream(up_feat)
        else:
            features = up_feat if mode == "waveform" else down_feat
        predicted, _ = model(features, linear_inp)
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


def _finish_enhancer(run_batch, buckets, sample_rate: int):
    """Wrap a padded-group runner into the serving interface: the
    single-utterance entry, with crossfaded streaming for a request longer
    than the largest bucket."""

    def _single(wav: np.ndarray) -> np.ndarray:
        return run_batch([wav])[0]

    def enhance(wav: np.ndarray) -> np.ndarray:
        if len(wav) <= buckets[-1]:
            return _single(wav)
        # fixed windows and a cosine crossfade: one device shape and
        # constant memory however long the request is
        return enhance_streaming(
            _single, wav, sample_rate=sample_rate,
            window_sec=buckets[-1] / sample_rate, overlap_sec=1.0,
        )

    enhance.run_batch = run_batch
    enhance.max_len = buckets[-1]
    enhance.bucket_of = lambda n: bucket_length(n, buckets)
    return enhance


def build_enhancer(ckpt: str, sample_rate: int = 16000, target_level: float = -25.0,
                   *, device, max_bucket_ms: int = 60000, round_pow2: bool = True,
                   upstream_ckpt: str = "", dckpt: str = "", recurrence: str = "tm"):
    """``enhance(wav)`` on ``device``. ``device="cuda"`` with no card raises;
    nothing falls back to the CPU. ``enhance`` takes a request of any length
    (longer than the largest bucket: crossfaded windows); ``enhance.run_batch``
    serves groups that fit one bucket. ``recurrence`` other than the default
    ``"tm"`` is an ablation: ``"blocked"`` (kernel B6) and ``"fused"`` (kernel
    B7, slower than the default at every measured shape) serve the same
    checkpoint to the same waveform within f32 rounding."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_enhancer(device='cuda'): no CUDA device here")
    use_full_fp32()
    _, enhance_raw, buckets = build_raw_enhancer(
        ckpt, sample_rate, target_level, device, max_bucket_ms,
        upstream_ckpt=upstream_ckpt, dckpt=dckpt, recurrence=recurrence,
    )

    def run_batch(wavs) -> list:
        for w in wavs:
            if len(w) > buckets[-1]:
                raise ValueError(
                    f"a row of {len(w)} samples is longer than the largest "
                    f"bucket ({buckets[-1]}): run_batch serves bucket-sized "
                    "groups; enhance(wav) streams a longer request"
                )
        batch, lens = _pad_group(wavs, buckets, round_pow2)
        out = enhance_raw(
            torch.from_numpy(batch).to(device), torch.from_numpy(lens).to(device)
        ).cpu().numpy()
        return [out[k, : len(w)] for k, w in enumerate(wavs)]

    return _finish_enhancer(run_batch, buckets, sample_rate)
