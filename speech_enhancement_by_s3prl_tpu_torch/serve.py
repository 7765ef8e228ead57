"""Enhancement HTTP server on a device, and the enhancer it serves
(counterpart of the repository's ``serve.py``).

  python -m speech_enhancement_by_s3prl_tpu_torch.serve --ckpt result/exp1 --port 8080
  python -m speech_enhancement_by_s3prl_tpu_torch.serve --ckpt result/exp1 --workers 16
  curl --data-binary @noisy.wav http://localhost:8080/enhance > out.wav

POST a WAV or FLAC body to ``/enhance`` and receive the enhanced 16-bit WAV.
POST raw float32 PCM to ``/stream`` (chunked or with a Content-Length) and
receive enhanced PCM back incrementally at constant latency, through
``ops/streaming.StatefulStreamer``: available when the served head is
one-direction, ``from_rawfeature`` and CMVN-free (other checkpoints answer
``/stream`` with 400 and the reason). ``GET /healthz`` reports the device and
the served totals. The server runs on the card unless ``--device cpu`` (or
``--cpu``) asks for the CPU; with no card the default raises. ``--workers N``
> 1 handles requests concurrently and coalesces concurrent ``/enhance``
requests of one duration bucket into one device batch (``MicroBatcher``);
``--fixed_batch`` pads every group to ``--max_batch`` rows, so a response
does not depend on its co-riders by a bit. ``--artifact <dir>`` serves an
exported program (``tools/export_model.py``, ``utils/export_artifact.py``) in
place of ``--ckpt``: one ``torch.export`` program per duration bucket, the
weights and the export-time ``--target_level`` baked in, a symbolic batch; it
needs no checkpoint and no model code, only torch, the port's op library
(``ops/cuda/library.py``) and, on the card, its kernels built from ``csrc/``
(``build_artifact_enhancer``). With ``--artifact``, ``--target_level``,
``--upstream_ckpt`` / ``--dckpt`` and ``--fixed_batch`` are refused (they are
export-time choices or need the checkpoint) and ``/stream`` answers 400.
``--mesh N`` serves every group on N devices, one replica of the enhancer a
device (``build_enhancer(mesh_n=)``); with ``--artifact`` it is refused, as
the JAX server refuses it.

``build_enhancer(ckpt, device=...)`` (or ``build_artifact_enhancer(dir,
sample_rate, device=...)``) returns ``enhance(wav) -> wav`` with
``.run_batch(list_of_wavs)``: requests are padded to a duration bucket and
run as one batch (STFT -> [upstream ->] head -> iSTFT with the noisy phase ->
level renorm). It serves the checkpoints of all three training modes:
``from_rawfeature``, ``from_waveform`` (``Mockingjay``) and the upstream
mode, whose frozen upstream is rebuilt from the recorded S3PRL checkpoint
(``--ckpt``, relocated by ``upstream_ckpt``); an upstream-mode checkpoint
that records none is refused, as the JAX package refuses it. A request
longer than the largest bucket runs through ``ops/streaming.enhance_streaming``:
windows of the largest bucket with one second of cosine crossfade. The LSTM
layers run the default recurrence (kernel B1, and B1 continuing from the
carried state on ``/stream``); ``enhance.model`` is the served head and
``enhance.stream_ctx`` what the streamer is built from.

Every handler thread, and the batcher's dispatcher, launches on torch's
current stream of the device, which in a new thread is the default stream:
``/enhance`` batches and ``/stream`` chunks share that one stream and run one
after another on the card. That is correct, and no stream is managed here.
"""
from __future__ import annotations

import argparse
import json
import os
import queue
import socketserver
import sys
import tempfile
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import torch
from torch import nn

from . import use_full_fp32
from .data.loader import bucket_length, default_buckets
from .models.convert import flax_to_state_dict
from .models.heads import build_head
from .data.audio_io import read_audio, resample_poly, wav_bytes
from .models.upstream import build_upstream
from .ops.features import OnlinePreprocessor, get_feat_config
from .ops.streaming import StatefulStreamer, enhance_streaming
from .run_downstream import PRETRAIN_ONLINE
from .runner.checkpoint import load_checkpoint, load_settings
from .runner.trainer import decode_wav


class MicroBatcher:
    """Coalesce concurrent single-utterance requests into one device batch.

    Handler threads call ``submit(wav)`` and block; one dispatcher thread
    drains the queue (waiting at most ``window_ms`` after the first arrival),
    groups the requests by duration bucket, runs each group as one batch and
    hands the results back. One device batch in flight at a time; the group's
    device shape is ``run_batch``'s to choose.
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


class RawEnhancer(nn.Module):
    """``forward(wavs (B, T) f32, lengths (B,) int)`` -> the enhanced (B, T)
    f32: features of the noisy waveform (``preprocessor``), [the frozen
    ``upstream`` ->] the head's predicted power spectrum, iSTFT with the noisy
    phase brought to T samples, renorm to ``target_level`` dB over each row's
    length (``runner/trainer.decode_wav``). ``mode`` is
    "rawfeature", "waveform" (the head reads the upstream-input feature) or
    "upstream". The preprocessor is a plain object: its filterbanks and DFT
    tables are numpy constants, which ``torch.export`` takes into the
    program as constants of its own.

    ``forward`` is what ``utils/export_artifact.export_enhance`` exports,
    under ``no_grad``; ``enhance_raw`` is the eager call, under inference
    mode, so that the recurrence, the STFT and the decode run their kernels
    (B1, B4, B5) and no autograd graph is recorded. ``stream_ctx`` is what a
    ``StatefulStreamer`` is built from."""

    def __init__(self, preprocessor, model: nn.Module, upstream, mode: str,
                 target_level: float):
        super().__init__()
        self.preprocessor = preprocessor
        self.model = model
        self.upstream = upstream
        self.mode = mode
        self.target_level = float(target_level)

    def forward(self, wavs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        up_feat, down_feat, linear_inp, phase_inp, *_ = self.preprocessor(wavs[:, None, :])
        if self.upstream is not None:
            features = self.upstream(up_feat)
        else:
            features = up_feat if self.mode == "waveform" else down_feat
        predicted, _ = self.model(features, linear_inp)
        return decode_wav(self.preprocessor, predicted, phase_inp, lengths, wavs.shape[-1],
                          self.target_level)

    @torch.inference_mode()
    def enhance_raw(self, wavs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        return self(wavs, lengths)

    @property
    def stream_ctx(self) -> dict:
        return {"model": self.model, "preprocessor": self.preprocessor, "mode": self.mode,
                "device": next(self.model.parameters()).device}


def build_raw_enhancer(ckpt: str, sample_rate: int, target_level: float,
                       device, max_bucket_ms: int = 60000,
                       upstream_ckpt: str = "", dckpt: str = ""):
    """Checkpoint -> (model, ``RawEnhancer``, buckets), both modules on
    ``device`` in eval mode: the head, the enhancer around it (its
    ``enhance_raw(wavs (B, T), lengths (B,))``) and the duration buckets.
    ``upstream_ckpt`` / ``dckpt`` relocate the pretraining checkpoints
    recorded in the settings."""
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
                       **{**paras, **model_cfg})
    model.load_state_dict(flax_to_state_dict(payload["Downstream"]))
    model.eval().to(device)
    raw = RawEnhancer(pre, model, upstream, mode, target_level).eval()
    return model, raw, default_buckets(sample_rate, max_bucket_ms)


def _pad_group(wavs, buckets, batch_round: int = 1, round_pow2: bool = True):
    """Pad a request group to one device shape: the common duration bucket,
    and a row count rounded up to a power of two (bounds the shapes under
    online micro-batching; offline CLIs and ``--fixed_batch`` pass
    round_pow2=False), then to a multiple of ``batch_round`` (``--fixed_batch``:
    ``--max_batch``, so every group has the same rows). Extra rows repeat row 0 and are discarded by the caller. Returns
    (batch (n, T) f32, lens (n,) int64)."""
    T = bucket_length(max(len(w) for w in wavs), buckets)
    n = max(1, 1 << (len(wavs) - 1).bit_length()) if round_pow2 else len(wavs)
    n = -(-n // batch_round) * batch_round
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
                   *, device, mesh_n: int = 0, devices=None, max_bucket_ms: int = 60000,
                   round_pow2: bool = True, upstream_ckpt: str = "", dckpt: str = "",
                   fixed_rows: int = 0):
    """``enhance(wav)`` on ``device``. ``device="cuda"`` with no card raises;
    nothing falls back to the CPU. ``enhance`` takes a request of any length
    (longer than the largest bucket: crossfaded windows); ``enhance.run_batch``
    serves groups that fit one bucket; ``enhance.model`` is the served head,
    ``enhance.stream_ctx`` what a ``StatefulStreamer`` is built from.

    ``fixed_rows`` > 0 pads every group, a solo request included, to exactly
    that many rows (a larger group to a multiple of it), with no power-of-two
    step, whatever ``fixed_rows`` is: with groups capped at ``fixed_rows``
    every device batch has one shape, so a response does not depend on its
    co-riders by a bit. By default a group is padded to a power of two, and
    the products of other row counts may sum in another order (at most one
    16-bit step after quantization); the price of ``fixed_rows`` is the full
    batch's compute for every group.

    ``mesh_n`` > 0 serves on ``mesh_n`` devices (the JAX server's data-parallel
    mesh): one replica of the enhancer a device, every group padded to a
    multiple of ``mesh_n`` rows (and ``fixed_rows`` must be one) and cut into
    ``mesh_n`` equal shards, each launched on its replica before any is waited
    on, then joined on the host. Rows do not mix, so the output is the
    single-device enhancer's up to the rounding of another batch shape (as
    above). The devices are the first
    ``mesh_n`` cards, or ``mesh_n`` replicas on the CPU for ``device="cpu"``;
    ``devices`` names them (two replicas may share a card)."""
    device = _serving_device(device, "build_enhancer")
    if mesh_n:
        if devices is None:
            devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                       if device.type == "cuda" else [device] * mesh_n)
        devices = [torch.device(d) for d in devices][:mesh_n]
        if len(devices) != mesh_n:
            raise ValueError(f"--mesh {mesh_n} but only {len(devices)} devices visible")
    else:
        devices = [device]
    replicas = [build_raw_enhancer(ckpt, sample_rate, target_level, d, max_bucket_ms,
                                   upstream_ckpt=upstream_ckpt, dckpt=dckpt)
                for d in devices]
    model, raw, buckets = replicas[0]

    batch_round = mesh_n or 1
    if fixed_rows:
        # every group rounds up to a multiple of fixed_rows, which keeps the
        # mesh's divisibility
        if fixed_rows % batch_round:
            raise ValueError(f"fixed_rows {fixed_rows} must divide evenly over the "
                             f"{batch_round}-way mesh")
        batch_round = fixed_rows
    # --fixed_batch: exactly fixed_rows rows (rounding to a power of two first
    # would give a max_batch of 6 two shapes, 6 and 8 -> 12 rows)
    round_pow2 = round_pow2 and not fixed_rows

    def run_batch(wavs) -> list:
        _check_rows(wavs, buckets)
        batch, lens = _pad_group(wavs, buckets, batch_round, round_pow2)
        # every shard launched before any is waited on, then joined on the host
        per = len(batch) // len(devices)
        outs = [rep_raw.enhance_raw(torch.from_numpy(batch[i * per:(i + 1) * per]).to(d),
                                    torch.from_numpy(lens[i * per:(i + 1) * per]).to(d))
                for i, (d, (_, rep_raw, _)) in enumerate(zip(devices, replicas))]
        outs = [o.cpu().numpy() for o in outs]
        out = outs[0] if len(outs) == 1 else np.concatenate(outs)
        return [out[k, : len(w)] for k, w in enumerate(wavs)]

    enhance = _finish_enhancer(run_batch, buckets, sample_rate)
    enhance.model = model
    enhance.stream_ctx = raw.stream_ctx
    enhance.devices = devices
    return enhance


def _serving_device(device, who: str) -> torch.device:
    """``device`` as a torch.device, with f32 products in full f32 on the
    card; ``"cuda"`` with no card raises (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}(device='cuda'): no CUDA device here")
    use_full_fp32()
    return device


def _check_rows(wavs, buckets):
    for w in wavs:
        if len(w) > buckets[-1]:
            raise ValueError(
                f"a row of {len(w)} samples is longer than the largest "
                f"bucket ({buckets[-1]}): run_batch serves bucket-sized "
                "groups; enhance(wav) streams a longer request"
            )


def build_artifact_enhancer(artifact_dir: str, sample_rate: int = 16000, *, device,
                            round_pow2: bool = True):
    """``enhance(wav)`` served from an exported artifact
    (``tools/export_model.py``) on ``device``: the interface of
    ``build_enhancer``, with no checkpoint and no model code behind it. The
    programs (``utils/export_artifact.load_enhance``) are moved to ``device``
    when they were exported on another, where the card's torch can; else a
    mismatch is refused. Requests pad into the manifest's buckets
    (``_pad_group``; the batch is symbolic, so one program serves every row
    count), a longer one streams in crossfaded windows of the largest
    (``_finish_enhancer``). Refuses a manifest of another sample rate: the
    programs' STFT geometry and buckets are the rate's. There is no
    ``/stream`` context: the programs are whole-utterance ones."""
    device = _serving_device(device, "build_artifact_enhancer")
    from .utils.export_artifact import load_enhance, read_manifest

    manifest = read_manifest(artifact_dir)
    if int(manifest["sample_rate"]) != sample_rate:
        raise ValueError(
            f"the artifact was exported at {manifest['sample_rate']} Hz but {sample_rate} Hz "
            "is asked for: its programs' STFT geometry and bucket durations are the "
            "rate's (re-export it with tools/export_model.py --sample_rate)")
    fns = load_enhance(artifact_dir, device)
    buckets = sorted(fns)

    def run_batch(wavs) -> list:
        _check_rows(wavs, buckets)
        batch, lens = _pad_group(wavs, buckets, round_pow2=round_pow2)
        with torch.inference_mode():
            out = fns[batch.shape[1]](torch.from_numpy(batch).to(device),
                                      torch.from_numpy(lens).to(device)).cpu().numpy()
        return [out[k, : len(w)] for k, w in enumerate(wavs)]

    return _finish_enhancer(run_batch, buckets, sample_rate)


class Server(HTTPServer):
    """The stdlib HTTP server with a listen backlog for a crowd: at the
    stdlib's 5, simultaneous connects past the backlog lose their SYN, and
    the client sends it again only after a second."""

    request_queue_size = 128


class ThreadingServer(socketserver.ThreadingMixIn, Server):
    daemon_threads = True


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="enhancement HTTP server (the port)")
    ap.add_argument("--ckpt", default="", help="training checkpoint to serve (or --artifact)")
    ap.add_argument("--upstream_ckpt", default="",
                    help="relocated S3PRL pretraining checkpoint for upstream-backed "
                         "checkpoints (default: the path the checkpoint records)")
    ap.add_argument("--dckpt", default="",
                    help="relocated checkpoint holding the downstream feature and model "
                         "config (default: the path the checkpoint records)")
    ap.add_argument("--artifact", default="",
                    help="serve an exported artifact directory (tools/export_model.py) "
                         "in place of a checkpoint")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--sample_rate", type=int, default=16000)
    ap.add_argument("--target_level", type=float, default=None,
                    help="output level in dB (default -25; an artifact bakes its "
                         "export-time level in, so the flag is refused with --artifact)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the default; raises when there is no CUDA device) or cpu")
    ap.add_argument("--cpu", dest="device", action="store_const", const="cpu",
                    help="alias of --device cpu")
    ap.add_argument("--workers", type=int, default=1,
                    help=">1 serves requests concurrently and coalesces concurrent "
                         "/enhance requests into micro-batched device batches")
    ap.add_argument("--mesh", type=int, default=0,
                    help="serve each batch on N devices, one replica a device "
                         "(data-parallel; pairs with --workers)")
    ap.add_argument("--max_batch", type=int, default=16,
                    help="micro-batch size cap (workers mode)")
    ap.add_argument("--batch_window_ms", type=float, default=3.0,
                    help="how long the batcher waits for co-riders after the first "
                         "request arrives")
    ap.add_argument("--stream_frames", type=int, default=48,
                    help="frames per model step on /stream (latency = 2 * delta frames "
                         "+ one chunk; 48 frames = 0.48 s at the 10 ms hop)")
    ap.add_argument("--fixed_batch", action="store_true",
                    help="pad every request group to exactly --max_batch rows (any "
                         "--max_batch, not only a power of two): one device shape per bucket, so a response is the same bits under "
                         "any load; costs the full --max_batch compute per group")
    return ap


def _decode_body(raw: bytes, sample_rate: int) -> np.ndarray:
    """A WAV or FLAC request body (FLAC by its ``fLaC`` magic) -> mono
    float32 at ``sample_rate``. Raises on a body it cannot decode."""
    with tempfile.NamedTemporaryFile(suffix=".flac" if raw[:4] == b"fLaC" else ".wav") as f:
        f.write(raw)
        f.flush()
        wav, sr = read_audio(f.name)
    wav = wav.mean(0) if wav.shape[0] > 1 else wav[0]
    if sr != sample_rate:
        wav = resample_poly(wav, sr, sample_rate)
    return np.asarray(wav, np.float32)


def make_server(argv=None) -> HTTPServer:
    """Parse the flags, build the enhancer (and the streamer when the
    checkpoint can stream), warm both, and return the bound HTTP server, not
    yet serving: ``main`` calls its ``serve_forever``. The server carries
    ``enhance`` and ``stream_proto`` (None when /stream is unavailable)."""
    ap = get_parser()
    args = ap.parse_args(argv)
    if bool(args.ckpt) == bool(args.artifact):
        ap.error("pass exactly one of --ckpt / --artifact")
    if args.artifact:
        if args.mesh:
            ap.error("--artifact serving is single-device (no --mesh)")
        if args.target_level is not None:
            ap.error("--target_level is baked into the artifact at export time (re-export "
                     "with tools/export_model.py to change it)")
        if args.upstream_ckpt or args.dckpt:
            ap.error("--upstream_ckpt/--dckpt are resolved at export time (pass them to "
                     "tools/export_model.py instead)")
        if args.fixed_batch:
            ap.error("--fixed_batch needs --ckpt serving (an artifact serves the row counts "
                     "its symbolic batch takes, grouped as the batcher groups them)")
    workers = args.workers
    if args.artifact:
        enhance = build_artifact_enhancer(args.artifact, args.sample_rate, device=args.device)
    else:
        enhance = build_enhancer(
            args.ckpt, args.sample_rate,
            -25.0 if args.target_level is None else args.target_level,
            device=args.device, mesh_n=args.mesh, upstream_ckpt=args.upstream_ckpt,
            dckpt=args.dckpt, fixed_rows=args.max_batch if args.fixed_batch else 0,
        )
    # warm up, so that the first request does not pay the kernels' builds
    enhance(np.zeros(args.sample_rate, np.float32))

    # live streaming: the constant-latency StatefulStreamer for one-direction
    # raw-feature heads; other checkpoints keep serving /enhance and say why
    # on /stream
    stream_proto = None
    stream_err = "artifact serving bakes full-utterance programs (serve a --ckpt)"
    ctx = getattr(enhance, "stream_ctx", None)
    try:
        if ctx is None:
            raise ValueError(stream_err)
        if ctx["mode"] != "rawfeature":
            raise ValueError(
                "stateful streaming serves from_rawfeature heads; this checkpoint runs in "
                f"'{ctx['mode']}' mode (upstream / waveform features need the whole "
                "utterance)")
        stream_proto = StatefulStreamer(ctx["model"], ctx["preprocessor"],
                                        frames_per_chunk=args.stream_frames)
        warm = stream_proto.clone()
        warm.push(np.zeros(args.sample_rate, np.float32))
        warm.flush()
    except ValueError as e:
        stream_proto, stream_err = None, str(e)
    batcher = MicroBatcher(
        enhance.run_batch, max_batch=args.max_batch, window_ms=args.batch_window_ms,
        bucket_of=enhance.bucket_of,
    ) if workers > 1 else None
    if args.device == "cuda":
        devices = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    else:
        devices = ["cpu"]
    stats = {"requests": 0, "audio_seconds": 0.0, "wall_seconds": 0.0}
    stats_lock = threading.Lock()
    sample_rate = args.sample_rate

    class Handler(BaseHTTPRequestHandler):
        # chunked transfer (/stream, both directions) is HTTP/1.1; every
        # response sends Connection: close, so that the single-threaded
        # server never waits on a kept-alive socket
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *a):
            pass

        def _reply(self, code, body, ctype="application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                with stats_lock:
                    body = json.dumps({"status": "ok", "device": args.device,
                                       "devices": devices, **stats}).encode()
                self._reply(200, body, "application/json")
            else:
                self._reply(404, b"not found", "text/plain")

        def _body_pieces(self, chunked, length):
            """The request body's pieces as they arrive: Transfer-Encoding
            chunked decoded (the stdlib handler does not), or blocks of a
            Content-Length body."""
            if chunked:
                while True:
                    line = self.rfile.readline(66)
                    size = int(line.split(b";")[0].strip() or b"0", 16)
                    if size == 0:
                        while True:  # trailer section, up to the blank line
                            t = self.rfile.readline(1026)
                            if t in (b"\r\n", b"\n", b""):
                                return
                    data = self.rfile.read(size)
                    self.rfile.read(2)  # the chunk's CRLF
                    yield data
            else:
                left = length
                while left > 0:
                    piece = self.rfile.read(min(65536, left))
                    if not piece:
                        return
                    left -= len(piece)
                    yield piece

        def _do_stream(self):
            """POST /stream: float32-LE mono PCM at --sample_rate in, the
            enhanced PCM out, both chunked, the output emitted with the
            streamer's fixed latency as the input arrives. Not renormalized
            (the offline per-utterance renorm needs the whole utterance)."""
            if stream_proto is None:
                self._reply(400, f"streaming unavailable: {stream_err}".encode(),
                            "text/plain")
                return
            chunked = "chunked" in (self.headers.get("Transfer-Encoding") or "").lower()
            n = int(self.headers.get("Content-Length") or 0)
            if not chunked and n == 0:
                self._reply(400, b"empty stream body (send chunked or Content-Length "
                            b"float32 PCM)", "text/plain")
                return
            streamer = stream_proto.clone()
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("Connection", "close")
            self.end_headers()
            t0 = time.perf_counter()
            emitted = 0

            def emit(samples):
                nonlocal emitted
                b = np.asarray(samples, "<f4").tobytes()
                if b:
                    self.wfile.write(f"{len(b):x}\r\n".encode() + b + b"\r\n")
                    self.wfile.flush()
                    emitted += len(b) // 4

            rem = b""
            for piece in self._body_pieces(chunked, n):
                data = rem + piece
                cut = len(data) & ~3  # the float32-aligned prefix
                rem = data[cut:]
                if cut:
                    emit(streamer.push(np.frombuffer(data[:cut], "<f4")))
            emit(streamer.flush())
            self.wfile.write(b"0\r\n\r\n")
            with stats_lock:
                stats["requests"] += 1
                stats["audio_seconds"] += emitted / sample_rate
                stats["wall_seconds"] += time.perf_counter() - t0

        def do_POST(self):
            if self.path == "/stream":
                self._do_stream()
                return
            if self.path != "/enhance":
                self._reply(404, b"not found", "text/plain")
                return
            n = int(self.headers.get("Content-Length", 0))
            if n == 0 or n > 200 * 1024 * 1024:
                self._reply(400, b"bad content length", "text/plain")
                return
            raw = self.rfile.read(n)
            try:
                wav = _decode_body(raw, sample_rate)
            except Exception as e:  # a body the decoders refuse is the client's fault
                self._reply(400, f"decode error: {e}".encode(), "text/plain")
                return
            t0 = time.perf_counter()
            try:
                if batcher is not None and len(wav) <= enhance.max_len:
                    out = batcher.submit(wav)
                else:
                    out = enhance(wav)
            except Exception as e:  # the server keeps serving; the client is told
                traceback.print_exc(file=sys.stderr)
                self._reply(500, f"enhance failed: {e}".encode(), "text/plain")
                return
            dt = time.perf_counter() - t0
            with stats_lock:
                stats["requests"] += 1
                stats["audio_seconds"] += len(out) / sample_rate
                stats["wall_seconds"] += dt
            self._reply(200, wav_bytes(out, sample_rate), "audio/wav")

    server_cls = ThreadingServer if workers > 1 else Server
    server = server_cls((args.host, args.port), Handler)
    server.enhance, server.stream_proto = enhance, stream_proto
    print(f"[serve] listening on http://{args.host}:{server.server_address[1]} "
          f"(device={args.device}, workers={workers}, /stream "
          f"{'on' if stream_proto is not None else 'off: ' + stream_err})", flush=True)
    return server


def main(argv=None):
    server = make_server(argv)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
