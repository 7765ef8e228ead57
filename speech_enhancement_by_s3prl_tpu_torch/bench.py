"""Benchmark harness of the port (counterpart of the root ``bench.py``): the
enhancement real-time factor and nine other modes, each one JSON line.

  python -m speech_enhancement_by_s3prl_tpu_torch.bench            # all modes
  BENCH_MODE=enhance python -m speech_enhancement_by_s3prl_tpu_torch.bench
  BENCH_CPU=1 BENCH_BATCH=2 BENCH_UTT_SEC=1 BENCH_ITERS=1 BENCH_MODE=enhance \\
      python -m speech_enhancement_by_s3prl_tpu_torch.bench        # on the CPU

``BENCH_MODE=<mode>`` runs one mode and prints one JSON line: ``metric``,
``value``, ``unit``, ``vs_baseline`` (against the north star of 10x real time
a chip, ``BASELINE.md``), ``card`` (``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader``, or ``cpu``), the batch, and for a device mode the
roofline fields (``roofline_fields``). ``BENCH_MODE`` unset or ``all`` runs
``run_all``: every mode of ``ALL_MODES`` in its own subprocess (a fresh CUDA
context and allocator) with its variables, then one line: the enhance
headline, or the first mode that succeeded, and ``modes`` with every mode's
line. ``BENCH_MODES=a,b`` restricts it, ``BENCH_TOTAL_BUDGET`` (seconds,
default 2400) stops scheduling modes once spent, ``BENCH_MODE_TIMEOUT``
(default 1500) limits each; a mode that fails or prints a non-JSON last line
costs only its own entry.

The modes, each built through the port's builders (``tools/profile_step.
build_mode``, ``entry``) with weights and waveforms (0.05 * N(0, 1), 10 s
rows, ``BENCH_UTT_SEC``) drawn from seed 0 on the device:

- ``enhance`` (``enhance_rtf_per_chip``): the flagship's enhance at 768 rows;
- ``latency`` (``serve_latency_b1_10s_ms``, and ``latency_b1_1s_ms``): one
  row of 10 s and of 1 s, 50 calls each;
- ``train`` (``train_audio_rtf_per_chip``): the flagship's train step, 128
  rows (``ALL_MODES``: 352);
- ``eval`` (``eval_audio_rtf_per_chip``): its eval step at 768 rows, scoring
  ``BENCH_EVAL_METRICS`` (default ``sisdr,stoi``; ``eval_full``: all five);
- ``upstream`` (``upstream_audio_rtf_per_chip``): the TERA encoder's forward
  at dropout 0 on (512, 100 * seconds + 1, 80) features, bf16 by default;
- ``mockingjay`` (``mockingjay_train_audio_rtf_per_chip``): the joint
  finetune's train step, 32 rows (``ALL_MODES``: 64 in bf16, on the JAX
  bench's dropout routes ``SE_ATTN_IMPL=flash SE_HIDDEN_DROPOUT_IMPL=hash``),
  dropout ``BENCH_MJ_DROPOUT`` (default 0.1);
- ``score`` (``sampler_scoring_utts_per_sec_per_chip``): the active sampler's
  per-row scores (``impl="capture"``) at 256 rows of the layer
  ``BENCH_SCORE_LAYERID`` (default 0; ``none``: every parameter);
- ``loader`` (``loader_audio_rtf_per_host``): the host's input pipeline,
  ``BENCH_LOADER_FILES`` files (64) of ``BENCH_LOADER_FORMAT`` (``wav`` or
  ``flac``) mixed on the fly through ``OnlineDataset`` / ``DataLoader`` with
  ``BENCH_LOADER_WORKERS`` workers (4); no device;
- ``pipeline`` (``pipeline_e2e_rtf_per_chip``): disk -> decode -> batch ->
  h2d -> enhance -> int16 on the card -> d2h -> WAV, the stages overlapped
  (``BENCH_PIPE_FILES``, ``_EPOCHS``, ``_WORKERS``, ``_D2H`` ``i16`` / ``f32``,
  ``_SWEEP``), 32 rows a batch.

``BENCH_BATCH`` and ``BENCH_ITERS`` override a mode's batch and calls
(``BENCH_LATENCY_ITERS`` the latency mode's before ``BENCH_ITERS``),
``BENCH_DTYPE`` its compute dtype. The LSTM kernels' forms follow
``SE_LSTM_XW_BF16`` (set to 1 unless given, as the JAX bench sets it),
``SE_PALLAS_HS_BF16``, ``SE_PALLAS_VJP_BF16``, ``SE_PALLAS_MXU_BF16``,
``SE_PALLAS_GATES_BF16`` and ``SE_LSTM_XW_INT8`` (``models/lstm.stream_forms``);
each line names those set to 1 (``lstm_forms``).

Timing: one call warms a mode up (kernel builds and loads fall outside the
window; the latency mode, whose window lasts a few ms, warms with as many
calls as it times); the window's calls are dispatched back to back with one
``torch.cuda.synchronize()`` at the end; each call's output is reduced to a
scalar. ``launches_per_call`` counts each kernel's launches a call in the
window (none on the CPU), and ``seconds`` times the process's stages
(set-up, window, cost); ``run_all`` adds each mode's ``wall_s``. After the
window the mode's step runs once under ``utils/costs.program_cost`` (the
kernels counted by their formulas, so the count is the same whatever
implements them).

Devices: the card unless ``BENCH_CPU=1`` asks for the CPU (plain versions);
with no card and no ``BENCH_CPU`` a device mode raises. Nothing falls back.
The JAX bench's TPU workarounds (its executable cache, compile cache, settle
time, PRNG and kernel-choice variables, ``BENCH_PEAK_TFLOPS`` /
``BENCH_PEAK_HBM_GBPS``) have no counterpart here: the peaks are the card's,
by its name (``utils/costs.PEAKS``).
"""
from __future__ import annotations

import json
import os
import queue
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# (name, variables) of every mode run_all runs: the JAX bench's batches and
# stream forms and dropout routes (its ALL_MODES), the TPU-only variables left out
ALL_MODES = [
    ("enhance", {"BENCH_MODE": "enhance", "SE_PALLAS_HS_BF16": "1"}),
    ("train", {"BENCH_MODE": "train", "BENCH_BATCH": "352", "SE_PALLAS_VJP_BF16": "1"}),
    ("eval", {"BENCH_MODE": "eval", "SE_PALLAS_HS_BF16": "1"}),
    ("eval_full", {"BENCH_MODE": "eval", "SE_PALLAS_HS_BF16": "1",
                   "BENCH_EVAL_METRICS": "sisdr,stoi,estoi,pesq_nb,pesq_wb"}),
    ("upstream", {"BENCH_MODE": "upstream"}),
    ("mockingjay", {"BENCH_MODE": "mockingjay", "BENCH_DTYPE": "bf16", "BENCH_BATCH": "64",
                    "SE_ATTN_IMPL": "flash", "SE_HIDDEN_DROPOUT_IMPL": "hash"}),
    ("score", {"BENCH_MODE": "score", "SE_PALLAS_VJP_BF16": "1", "SE_PALLAS_HS_BF16": "1",
               "BENCH_DTYPE": "bf16"}),
    ("loader", {"BENCH_MODE": "loader"}),
    ("latency", {"BENCH_MODE": "latency", "SE_PALLAS_HS_BF16": "1"}),
    ("pipeline", {"BENCH_MODE": "pipeline", "SE_PALLAS_HS_BF16": "1"}),
]
# rows a call when BENCH_BATCH is unset (the JAX bench's defaults)
DEFAULT_BATCH = {"enhance": 768, "eval": 768, "train": 128, "upstream": 512,
                 "mockingjay": 32, "score": 256, "pipeline": 32, "loader": 16}
DEVICE_MODES = ("enhance", "latency", "train", "eval", "upstream", "mockingjay", "score",
                "pipeline")
SR = 16000
NORTH_STAR = 10.0  # x real time a chip
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_IMPORT = time.perf_counter()


class Stages:
    """Seconds of a mode's stages, each from the end of the one before (the
    first from the module's import, so that set-up counts the process's
    imports)."""

    def __init__(self):
        self.seconds: dict = {}
        self._last = T_IMPORT

    def lap(self, stage: str) -> None:
        now = time.perf_counter()
        self.seconds[stage] = round(now - self._last, 3)
        self._last = now


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them, or ``cpu``
    where the mode runs on the CPU."""
    if os.environ.get("BENCH_CPU") == "1":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def bench_device():
    """The torch device of a device mode: the CPU under ``BENCH_CPU=1``, else
    the card; raises where there is none."""
    import torch

    if os.environ.get("BENCH_CPU") == "1":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench runs on the card (BENCH_CPU=1 runs it "
                           "on the CPU)")
    return torch.device("cuda", torch.cuda.current_device())


def synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def read_back(out) -> None:
    """Reads a call's outputs (a tensor, or a dict or tuple of them) back to
    the host, as the JAX bench fetches its scalar."""
    import torch

    values = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (tuple, list)) else (out,))
    for v in values:
        if isinstance(v, torch.Tensor):
            float(v.float().sum())


def kernel_wrappers() -> dict:
    """The port's kernel wrappers by kernel id, each counting its launches."""
    from .ops.cuda import attention_kernel as A
    from .ops.cuda import decode_kernel as D
    from .ops.cuda import dropout_kernel as R
    from .ops.cuda import lstm_kernel as L
    from .ops.cuda import stft_kernel as S

    return {"B1": L.lstm_bidir_tm, "B2 fwd": L.lstm_bidir_tm_fc, "B2 bwd": L.lstm_bidir_tm_bwd,
            "B2 bwd dW_hh^T bf16": L.lstm_bidir_tm_dw_bf16, "B3 fwd": A.flash_attention_fwd,
            "B3 bwd": A.flash_attention_bwd, "B3 fwd bf16": A.flash_attention_fwd_bf16,
            "B3 bwd bf16": A.flash_attention_bwd_bf16, "B4": S.stft_fused, "B5": D.decode_ola,
            "B6": L.lstm_bidir_bb, "B7": L.lstm_bidir_fused, "D1": R.threefry_dropout_kernel}


def window(fn, iters: int, device, warmup: int = 1):
    """(seconds for ``iters`` calls of ``fn`` dispatched back to back after
    ``warmup`` calls, with one synchronize at the end; the launches a call of
    each kernel in them, those launched)."""
    for _ in range(warmup):
        read_back(fn())
    synchronize(device)
    wrappers = kernel_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    synchronize(device)
    dt = time.perf_counter() - t0
    launched = {k: (w.launches - before[k]) / iters for k, w in wrappers.items()
                if w.launches > before[k]}
    return dt, launched


def roofline_fields(seconds_per_step: float, device, fn, *args, **kwargs) -> dict:
    """The roofline fields of a mode's line (JAX ``roofline_fields``): ``fn``
    run once under ``utils/costs.program_cost`` (the kernels counted by their
    formulas), its flops, products, classes and modelled bytes a step, their
    rates over ``seconds_per_step``, and on a card with a peak table ``mfu``
    (the least time of the step's operations at each class's peak, over the
    step's time) and ``hbm_util_model``. An exception or a card without a
    peak table becomes ``roofline_error``: accounting never sinks a
    measurement."""
    try:
        from .utils.costs import program_cost, roofline

        c = program_cost(fn, *args, **kwargs)
    except Exception as e:  # never let accounting sink the measurement
        return {"roofline_error": f"{type(e).__name__}: {e}"[-300:]}
    out = {
        "flops_per_step": c["flops"],
        "dot_flops_per_step": c["dot_flops"],
        "flops_by_class": c["flops_by_class"],
        "tflops": c["flops"] / seconds_per_step / 1e12,
        "hbm_gbytes_per_step_model": c["hbm_bytes_model"] / 1e9,
        "hbm_gbps_model": c["hbm_bytes_model"] / seconds_per_step / 1e9,
        "flops_src": "torch_dispatch",
        "opaque_calls": c["opaque_calls"],
        "kernels_counted": c["kernels"],
    }
    if device.type != "cuda":
        out["roofline_error"] = "no peak table for the CPU: mfu and hbm_util_model not computed"
        return out
    try:
        import torch

        out.update(roofline(c, seconds_per_step, torch.cuda.get_device_name(device)))
    except Exception as e:
        out["roofline_error"] = f"{type(e).__name__}: {e}"[-300:]
    return out


def emit(payload: dict, stages: "Stages" = None) -> None:
    from .models.lstm import FORM_VARIABLES

    payload.setdefault("card", card_line())
    # the LSTM kernels' forms in effect, as the JAX bench keys its programs on
    # the same variables
    payload.setdefault("lstm_forms", [v for v in FORM_VARIABLES if os.environ.get(v) == "1"])
    if stages is not None:
        payload["seconds"] = stages.seconds
    print(json.dumps(payload), flush=True)


def rtf_line(metric: str, audio_seconds: float, dt: float, **more) -> dict:
    rtf = audio_seconds / dt
    return {"metric": metric, "value": round(rtf, 2), "unit": "x_realtime",
            "vs_baseline": round(rtf / NORTH_STAR, 3), **more}


# -- modes ------------------------------------------------------------------

def bench_loader() -> None:
    """Host input-pipeline throughput: file decode, on-the-fly SNR mixing and
    bucketed collate through ``OnlineDataset`` / ``DataLoader``, no device.
    The number is per host core pool, not per chip."""
    from .data.audio_io import write_wav
    from .data.datasets import OnlineDataset
    from .data.loader import DataLoader, default_buckets

    rng = np.random.default_rng(0)
    n_speech = env_int("BENCH_LOADER_FILES", 64)
    fmt = os.environ.get("BENCH_LOADER_FORMAT", "wav")
    with tempfile.TemporaryDirectory() as root:
        sdir, ndir = os.path.join(root, "s"), os.path.join(root, "n")
        os.makedirs(sdir), os.makedirs(ndir)
        if fmt == "flac":
            # the FLAC encoder lives with the tests (the package decodes only)
            if ROOT not in sys.path:
                sys.path.insert(0, ROOT)
            from tests.torch_port_flac_writer import encode_fixed1_rice, frame_header, streaminfo

            for i in range(n_speech):
                n_frames = int(rng.integers(24, 40))  # 6.1-10.2 s at 16 kHz
                data = streaminfo(SR, 1, 16, n_frames * 4096)
                for fi in range(n_frames):
                    samples = np.cumsum(rng.integers(-7, 8, size=4096)).astype(np.int64)
                    data += frame_header(0b1100, fi) + encode_fixed1_rice(samples).bytes() \
                        + b"\x00\x00"
                with open(os.path.join(sdir, f"s{i:03d}.flac"), "wb") as f:
                    f.write(data)
        else:
            for i in range(n_speech):
                n = int(SR * rng.uniform(6.0, 10.0))
                t = np.arange(n) / SR
                wav = 0.25 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) \
                    + 0.02 * rng.standard_normal(n)
                write_wav(os.path.join(sdir, f"s{i:03d}.wav"), wav.astype(np.float32), SR)
        for i in range(16):
            n = int(SR * rng.uniform(2.0, 5.0))
            write_wav(os.path.join(ndir, f"n{i:03d}.wav"),
                      (0.2 * rng.standard_normal(n)).astype(np.float32), SR)
        dataset = OnlineDataset(speech={"filestrs": [sdir]}, noise={"filestrs": [ndir]},
                                sample_rate=SR, max_time=60000, snrs=(-6, -3, 0, 3, 6),
                                infinite=True)
        workers = env_int("BENCH_LOADER_WORKERS", 4)
        loader = DataLoader(dataset, batch_size=env_int("BENCH_BATCH", DEFAULT_BATCH["loader"]),
                            num_workers=workers, buckets=default_buckets(), seed=0)

        def epoch():
            audio_s, utts = 0.0, 0
            for lengths, *_ in loader:
                audio_s += float(np.sum(lengths)) / SR
                utts += len(lengths)
            return audio_s, utts

        epoch()  # warm-up: page cache, threads, allocator
        dt, audio, utts = 0.0, 0.0, 0
        for _ in range(env_int("BENCH_ITERS", 3)):
            t0 = time.perf_counter()
            a, u = epoch()
            dt += time.perf_counter() - t0
            audio, utts = audio + a, utts + u
    emit(rtf_line("loader_audio_rtf_per_host", audio, dt, utts_per_sec=round(utts / dt, 2),
                  workers=workers, format=fmt, card="host"))


def bench_latency(device) -> None:
    """Single-request serving latency: one row of 10 s and of 1 s through
    the flagship's enhance, ``BENCH_ITERS`` (50) calls dispatched back to back,
    one synchronize."""
    import torch

    from . import entry

    iters = env_int("BENCH_LATENCY_ITERS", env_int("BENCH_ITERS", 50))
    pre, model = entry.build(device=device, generator=torch.Generator().manual_seed(0))
    enhance = entry.make_enhance(pre, model)
    draws = torch.Generator(device=device).manual_seed(0)
    ms, calls, launched, stages = {}, {}, {}, Stages()
    for sec in (10, 1):
        wav = 0.05 * torch.randn((1, 3, SR * sec), generator=draws, device=device)
        length = torch.full((1,), SR * sec, dtype=torch.int64, device=device)
        calls[sec] = (lambda w=wav, n=length: enhance(w, n).sum(), wav, length)
        # a window of a few ms: as many calls again to warm it, so that the
        # card's clocks have risen
        stages.lap("setup" if sec == 10 else "window_10s")
        dt, launched[sec] = window(calls[sec][0], iters, device, warmup=iters)
        ms[sec] = dt / iters * 1e3
    _, wav, length = calls[10]
    stages.lap("window_1s")
    emit({"metric": "serve_latency_b1_10s_ms", "value": round(ms[10], 3), "unit": "ms",
          "vs_baseline": round((10.0 / (ms[10] / 1e3)) / NORTH_STAR, 3),
          "latency_b1_1s_ms": round(ms[1], 3), "batch": 1, "iters": iters,
          "launches_per_call": launched[10],
          **roofline_fields(ms[10] / 1e3, device, lambda m, w, n: enhance(w, n).sum(), model,
                            wav, length)}, stages)


def bench_step(mode: str, device) -> None:
    """enhance, train, eval, upstream, mockingjay, score: the mode's step of
    ``tools/profile_step.build_mode`` at ``BENCH_BATCH`` rows, ``BENCH_ITERS``
    (10) calls."""
    from .tools.profile_step import build_mode

    utt_sec = env_int("BENCH_UTT_SEC", 10)
    batch = env_int("BENCH_BATCH", DEFAULT_BATCH[mode])
    iters = env_int("BENCH_ITERS", 10)
    metrics = [m.strip() for m in os.environ.get("BENCH_EVAL_METRICS", "sisdr,stoi").split(",")
               if m.strip()]
    dropout = os.environ.get("BENCH_MJ_DROPOUT")
    step = build_mode(mode, batch, os.environ.get("BENCH_DTYPE", ""), utt_sec, str(device), 0,
                      None if dropout is None else float(dropout), metrics)
    if mode == "score":
        from .active.sampler import make_scoring_fn

        layer = os.environ.get("BENCH_SCORE_LAYERID", "0")
        layer = None if layer.lower() in ("none", "") else int(layer)
        step.scoring = make_scoring_fn(step.builder, layer, impl="capture")
        step.run_one = lambda: step.scoring(step.builder.model, step.wavs, step.lengths)
    stages = Stages()
    stages.lap("setup")
    dt, launched = window(step, iters, device)
    stages.lap("window")
    more = {"batch": batch, "utt_sec": utt_sec, "iters": iters, "launches_per_call": launched}
    if mode == "eval":
        more["eval_metrics"] = metrics
    if mode == "score":
        line = {"metric": "sampler_scoring_utts_per_sec_per_chip",
                "value": round(batch * iters / dt, 2), "unit": "utts_per_sec",
                "vs_baseline": round(batch * iters / dt, 3), **more}
    else:
        name = {"enhance": "enhance_rtf_per_chip", "train": "train_audio_rtf_per_chip",
                "eval": "eval_audio_rtf_per_chip", "upstream": "upstream_audio_rtf_per_chip",
                "mockingjay": "mockingjay_train_audio_rtf_per_chip"}[mode]
        line = rtf_line(name, batch * utt_sec * iters, dt, **more)
    line.update(roofline_fields(dt / iters, device, *cost_call(step)))
    stages.lap("cost")
    emit(line, stages)


def cost_call(step):
    """(fn, *args) that ``program_cost`` runs for a built mode: the mode's call
    with what it reads as arguments (weights, state, inputs), so that they
    count as the program's inputs."""
    b = step.builder
    if step.mode == "enhance":
        return (lambda m, w, n: step.enhance(w, n).sum(), step.model, step.wavs, step.lengths)
    if step.mode == "upstream":
        return (lambda m, f: step(), step.model, step.feats)
    if step.mode in ("train", "mockingjay"):
        return (lambda s, w, n: b.train_step(s, w, n), step.state[0], step.wavs, step.lengths)
    if step.mode == "eval":
        return (lambda m, w, n: b.eval_step(w, n, wav_out="first"), b.model, step.wavs,
                step.lengths)
    return (lambda m, w, n: step.scoring(m, w, n), b.model, step.wavs, step.lengths)


def bench_pipeline(device) -> None:
    """End-to-end throughput of a corpus through the enhancer: disk -> decode
    (``BENCH_PIPE_WORKERS`` threads) -> batch -> h2d -> enhance -> int16 on the
    card (``BENCH_PIPE_D2H=i16``; ``f32`` ships floats) -> d2h -> WAV, every
    stage overlapped through bounded queues; with the stages' busy shares,
    decode and encode rates, h2d / d2h bandwidth, the device-only rate at the
    batch, the device's idle share and the host cores one card needs at the
    measured decode and encode rates. ``BENCH_PIPE_SWEEP=1,2,4`` reruns it at
    each decode-worker count."""
    import torch

    from . import entry
    from .data.audio_io import load_audio, write_wav, write_wav_pcm16

    utt_sec = env_int("BENCH_UTT_SEC", 10)
    T = SR * utt_sec
    batch = env_int("BENCH_BATCH", DEFAULT_BATCH["pipeline"])
    n_files = env_int("BENCH_PIPE_FILES", batch * 3)
    epochs = env_int("BENCH_PIPE_EPOCHS", 2)
    workers = env_int("BENCH_PIPE_WORKERS", 4)
    d2h = os.environ.get("BENCH_PIPE_D2H", "i16")
    if d2h not in ("i16", "f32"):
        raise ValueError(f"BENCH_PIPE_D2H is i16 or f32, not {d2h!r}")
    sweep = [int(w) for w in os.environ.get("BENCH_PIPE_SWEEP", "").split(",") if w.strip()]
    pre, model = entry.build(device=device, generator=torch.Generator().manual_seed(0))
    enhance = entry.make_enhance(pre, model)
    lengths = torch.full((batch,), T, dtype=torch.int64, device=device)

    def call(wavs):
        out = enhance(wavs, lengths)
        if d2h == "i16":
            # 16-bit PCM on the card, rounded as the WAV writer rounds
            out = torch.clamp(torch.round(out * 32767.0), -32768.0, 32767.0).to(torch.int16)
        return out

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as root:
        indir, outdir = os.path.join(root, "in"), os.path.join(root, "out")
        os.makedirs(indir), os.makedirs(outdir)
        t = np.arange(T) / SR
        for i in range(n_files):
            wav = 0.25 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) \
                + 0.05 * rng.standard_normal(T)
            write_wav(os.path.join(indir, f"u{i:04d}.wav"), wav.astype(np.float32), SR)
        files = sorted(os.path.join(indir, f) for f in os.listdir(indir))
        enc = (0.1 * rng.standard_normal(T)).astype(np.float32)
        t0 = time.perf_counter()
        for i in range(32):
            write_wav(os.path.join(outdir, f"enc{i}.wav"), enc, SR)
        encode_rtf = 32 * utt_sec / (time.perf_counter() - t0)
        total = (n_files * epochs // batch) * batch

        def run_once(n_workers):
            q_dec: queue.Queue = queue.Queue(maxsize=batch * 2)
            q_batch: queue.Queue = queue.Queue(maxsize=2)
            q_out: queue.Queue = queue.Queue(maxsize=2)
            busy = dict.fromkeys(("decode", "h2d", "d2h", "encode"), 0.0)
            lock = threading.Lock()
            done = {"utts": 0}

            def add(stage, dt):
                with lock:
                    busy[stage] += dt

            def decoder(paths):
                for p in paths:
                    t0 = time.perf_counter()
                    wav, _ = load_audio(p, sr=SR)
                    wav = wav[:T] if len(wav) >= T else np.pad(wav, (0, T - len(wav)))
                    add("decode", time.perf_counter() - t0)
                    # channels (noisy, clean, noise): serving reads channel 0
                    q_dec.put(np.ascontiguousarray(np.broadcast_to(wav, (3, T)), np.float32))

            def batcher():
                for _ in range(total // batch):
                    q_batch.put(np.stack([q_dec.get() for _ in range(batch)]))
                q_batch.put(None)

            def device_leg():
                while True:
                    host = q_batch.get()
                    if host is None:
                        q_out.put(None)
                        return
                    t0 = time.perf_counter()
                    dev = torch.from_numpy(host).to(device)
                    synchronize(device)
                    add("h2d", time.perf_counter() - t0)
                    q_out.put(call(dev))  # dispatched; the encoder's copy waits for it

            def encoder():
                idx = 0
                while True:
                    out = q_out.get()
                    if out is None:
                        return
                    t0 = time.perf_counter()
                    rows = out.cpu().numpy()
                    t1 = time.perf_counter()
                    for row in rows:
                        path = os.path.join(outdir, f"o{idx:05d}.wav")
                        (write_wav_pcm16 if d2h == "i16" else write_wav)(path, row, SR)
                        idx += 1
                    add("d2h", t1 - t0)
                    add("encode", time.perf_counter() - t1)
                    done["utts"] = idx

            paths = (files * epochs)[:total]
            threads = [threading.Thread(target=decoder, args=(paths[w::n_workers],), daemon=True)
                       for w in range(n_workers)]
            threads += [threading.Thread(target=batcher, daemon=True),
                        threading.Thread(target=device_leg, daemon=True)]
            enc_thread = threading.Thread(target=encoder, daemon=True)
            t0 = time.perf_counter()
            for th in threads + [enc_thread]:
                th.start()
            enc_thread.join()
            wall = time.perf_counter() - t0
            audio = done["utts"] * utt_sec
            return audio / wall, wall, audio, busy

        warm = torch.from_numpy(np.stack([
            np.broadcast_to(load_audio(files[i % n_files], sr=SR)[0][:T], (3, T))
            for i in range(batch)]).astype(np.float32)).to(device)
        read_back(call(warm))  # warm-up: kernel loads, page cache, pools
        stages = Stages()
        stages.lap("setup")
        worker_sweep = []
        for w in sweep:
            if w != workers:
                rtf_w, wall_w, audio_w, busy_w = run_once(w)
                worker_sweep.append({
                    "workers": w, "e2e_rtf": round(rtf_w, 2),
                    "decode_rtf_per_core": round(audio_w / max(busy_w["decode"], 1e-9), 2),
                    "decode_busy_frac": round(busy_w["decode"] / wall_w, 4)})
        e2e, wall, audio, busy = run_once(workers)
        # the device alone at this batch, from an input already on it
        stages.lap("pipeline")
        device_s, launched = window(lambda: call(warm), 3, device)
        device_s /= 3
        device_rtf = batch * utt_sec / device_s
    bytes_in, bytes_out = total * 3 * T * 4, total * T * (2 if d2h == "i16" else 4)
    cores = device_rtf * (busy["decode"] + busy["encode"]) / max(audio, 1e-9)
    emit({"metric": "pipeline_e2e_rtf_per_chip", "value": round(e2e, 2), "unit": "x_realtime",
          "vs_baseline": round(e2e / NORTH_STAR, 3), "device_rtf": round(device_rtf, 2),
          "device_idle_frac": round(max(0.0, 1.0 - (audio / device_rtf) / wall), 4),
          "decode_rtf_per_core": round(audio / max(busy["decode"], 1e-9), 2),
          "encode_rtf_per_core": round(encode_rtf, 2),
          "h2d_gbps": round(bytes_in / max(busy["h2d"], 1e-9) / 1e9, 4),
          "d2h_gbps": round(bytes_out / max(busy["d2h"], 1e-9) / 1e9, 4),
          "busy_frac": {k: round(v / wall, 4) for k, v in busy.items()},
          "cores_to_saturate_chip": round(cores, 1), "batch": batch, "utts": total,
          "workers": workers, "d2h_dtype": d2h, "launches_per_call": launched,
          **({"worker_sweep": worker_sweep} if worker_sweep else {}),
          **roofline_fields(device_s, device, lambda m, w: call(w), model, warm)}, stages)


# -- all modes --------------------------------------------------------------

def run_all() -> None:
    """Every mode of ``ALL_MODES`` (or ``BENCH_MODES``) in its own
    subprocess, then one line: the enhance headline, or the first mode that
    succeeded, with ``modes``."""
    names = [m.strip() for m in os.environ.get(
        "BENCH_MODES", ",".join(n for n, _ in ALL_MODES)).split(",") if m.strip()]
    budget = float(os.environ.get("BENCH_TOTAL_BUDGET", "2400"))
    timeout = float(os.environ.get("BENCH_MODE_TIMEOUT", "1500"))
    t_start = time.time()
    modes: dict = {}
    skipped = []
    for name, overrides in ALL_MODES:
        if name not in names:
            continue
        if time.time() - t_start > budget:
            skipped.append(name)
            continue
        env = dict(os.environ)
        env.update(overrides)
        env.pop("BENCH_MODES", None)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
        t_mode = time.perf_counter()
        try:
            out = subprocess.run([sys.executable, "-m", "speech_enhancement_by_s3prl_tpu_torch.bench"],
                                 env=env, cwd=ROOT, capture_output=True, text=True,
                                 timeout=timeout)
            line = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
            if out.returncode == 0 and line:
                try:
                    modes[name] = json.loads(line)
                except json.JSONDecodeError:
                    # a stray last line costs only this mode
                    modes[name] = {"error": f"non-JSON output: {line[-300:]}"}
            else:
                modes[name] = {"error": (out.stderr or "no output")[-800:]}
        except subprocess.TimeoutExpired:
            modes[name] = {"error": "timeout"}
        modes[name]["wall_s"] = round(time.perf_counter() - t_mode, 1)
        print(f"[bench:all] {name}: {modes[name].get('value', modes[name].get('error'))} "
              f"({modes[name]['wall_s']} s)", file=sys.stderr, flush=True)
    # the headline: enhance if it succeeded (an error entry has no value),
    # else the first mode that did
    head = modes.get("enhance", {})
    if "value" not in head:
        head = next((v for v in modes.values() if "value" in v), {})
    payload = {"metric": head.get("metric", "enhance_rtf_per_chip"),
               "value": head.get("value", 0.0), "unit": head.get("unit", "x_realtime"),
               "vs_baseline": head.get("vs_baseline", 0.0), "card": head.get("card"),
               "modes": modes}
    if skipped:
        payload["skipped"] = skipped
    print(json.dumps(payload), flush=True)


def main() -> None:
    mode = os.environ.get("BENCH_MODE", "all")
    if mode == "all":
        run_all()
        return
    if mode == "loader":
        bench_loader()
        return
    if mode not in DEVICE_MODES:
        raise ValueError(f"unknown BENCH_MODE {mode!r}; one of all, loader, "
                         + ", ".join(DEVICE_MODES))
    from . import use_full_fp32

    device = bench_device()
    # the JAX bench's inference default: xw stored in bf16 (models/lstm.py
    # reads it at each forward)
    os.environ.setdefault("SE_LSTM_XW_BF16", "1")
    use_full_fp32()
    if mode == "latency":
        bench_latency(device)
    elif mode == "pipeline":
        bench_pipeline(device)
    else:
        bench_step(mode, device)


if __name__ == "__main__":
    main()
