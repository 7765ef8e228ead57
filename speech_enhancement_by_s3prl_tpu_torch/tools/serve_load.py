"""Serving load test of the port: concurrent clients against its HTTP
server (counterpart of ``scripts/serve_load.py``).

What serving delivers under load, across concurrency levels, with request
durations spanning several buckets:

- p50 / p99 / max request latency and the aggregate rate (audio seconds
  served per wall second, ``aggregate_rtf`` as the JAX twin names it) at each
  ``--levels`` entry;
- the bucket-confinement check under load: the responses to fixed probe
  inputs against their solo responses. By default a group is padded to a
  power of two rows, and products over other row counts may sum in another
  order, so a response may differ by at most one 16-bit step (the fraction
  of exact matches is reported); with ``--fixed_batch`` every group has
  ``--max_batch`` rows and the responses must be byte-identical.

The server runs in this process (``serve.make_server``: the threading HTTP
server and the micro-batcher of ``python -m
speech_enhancement_by_s3prl_tpu_torch.serve --workers N``); clients are
threads POSTing ``/enhance`` over localhost.

  python -m speech_enhancement_by_s3prl_tpu_torch.tools.serve_load --make_ckpt --workdir /tmp/sl
  python -m speech_enhancement_by_s3prl_tpu_torch.tools.serve_load --workdir /tmp/sl \\
      [--levels 1,4,16] [--requests 8] [--device cpu]

``--make_ckpt`` writes a seeded flagship checkpoint (3 bidirectional LSTM
layers of 256 on 120-d log-mel features) on the CPU. Prints one JSON line with the results per
level and ``identity_ok``, and exits non-zero when the check fails.
"""
from __future__ import annotations

import argparse
import http.client
import io
import json
import os
import threading
import time
import wave

import numpy as np

from ..data.audio_io import wav_bytes

SR = 16000


def wav_body(wav: np.ndarray) -> bytes:
    """float32 mono -> a 16-bit WAV body at ``SR``."""
    return wav_bytes(wav, SR)


def pcm_of(body: bytes) -> np.ndarray:
    """The int16 samples of a WAV reply, as int32."""
    with wave.open(io.BytesIO(body), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.int32)


def make_ckpt(workdir: str, seed: int = 0) -> str:
    """A seeded flagship checkpoint, written on the CPU; returns its path."""
    import torch

    from ..entry import build, flagship_settings
    from ..runner.checkpoint import save_checkpoint

    _, model = build(device="cpu", generator=torch.Generator().manual_seed(seed))
    config, paras = flagship_settings()
    path = os.path.join(workdir, "ckpt")
    os.makedirs(path, exist_ok=True)
    save_checkpoint(path, 0, model, None, config, paras)
    print(f"[serve_load] checkpoint under {path}", flush=True)
    return path


def start_server(ckpt: str, device: str, workers: int, max_batch: int, window_ms: float,
                 fixed_batch: bool = False):
    """The port's server on a daemon thread; returns the server (its port is
    ``server.server_address[1]``; stop it with ``shutdown()``)."""
    from ..serve import make_server

    argv = ["--ckpt", ckpt, "--port", "0", "--device", device, "--workers", str(workers),
            "--max_batch", str(max_batch), "--batch_window_ms", str(window_ms)]
    server = make_server(argv + (["--fixed_batch"] if fixed_batch else []))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def post(port: int, body: bytes, timeout: float = 600.0) -> bytes:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/enhance", body, {"Content-Type": "application/octet-stream"})
        r = conn.getresponse()
        data = r.read()
        if r.status != 200:
            raise RuntimeError(f"/enhance answered {r.status}: {data[:200]!r}")
        return data
    finally:
        conn.close()


def run_load(port: int, levels, requests: int, durations, fixed_batch: bool,
             seed: int = 0) -> dict:
    """Drive the server at ``port`` at each concurrency level; returns the
    results (the JSON line's fields). Client 0 sends the fixed probes."""
    rng = np.random.default_rng(seed)
    probes = {}
    for d in durations:
        t = np.arange(int(SR * d)) / SR
        wav = (0.3 * np.sin(2 * np.pi * (200 + 37 * d) * t)
               + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
        probes[d] = wav_body(wav)
    for d in durations:  # warm every bucket once, then the solo references
        post(port, probes[d])
    solo = {d: post(port, probes[d]) for d in durations}

    results = {}
    identity_ok = True
    probe_stats = {"total": 0, "exact": 0, "max_delta": 0}
    for level in levels:
        lat, audio_s, ident = [], [0.0], [True]
        lock = threading.Lock()
        errors = []

        def client(cid, n_req):
            r = np.random.default_rng(1000 + cid)
            try:
                for k in range(n_req):
                    d = durations[(cid + k) % len(durations)]
                    if cid == 0:
                        body = probes[d]
                    else:
                        t = np.arange(int(SR * d)) / SR
                        body = wav_body((0.3 * np.sin(2 * np.pi * r.uniform(150, 400) * t)
                                         + 0.02 * r.standard_normal(len(t))).astype(np.float32))
                    t0 = time.perf_counter()
                    out = post(port, body)
                    dt = time.perf_counter() - t0
                    with lock:
                        lat.append(dt)
                        audio_s[0] += d
                    if cid == 0:
                        exact = out == solo[d]
                        delta = 0 if exact else int(np.abs(pcm_of(out) - pcm_of(solo[d])).max())
                        with lock:
                            probe_stats["total"] += 1
                            probe_stats["exact"] += int(exact)
                            probe_stats["max_delta"] = max(probe_stats["max_delta"], delta)
                            if not (exact if fixed_batch else delta <= 1):
                                ident[0] = False
            except Exception as e:  # reported, and fails the run
                with lock:
                    errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(c, requests)) for c in range(level)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        if errors:
            raise RuntimeError(f"level {level}: {len(errors)} clients failed: {errors[:3]}")
        ms = sorted(x * 1000.0 for x in lat)
        results[str(level)] = {
            "requests": len(ms),
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "max_ms": ms[-1],
            "aggregate_rtf": audio_s[0] / wall,
            "identity_ok": ident[0],
        }
        identity_ok = identity_ok and ident[0]
        print(f"[serve_load] level {level}: {results[str(level)]}", flush=True)
    return {
        "levels": results,
        "identity_ok": identity_ok,
        "identity_mode": "byte" if fixed_batch else "pcm<=1",
        "probe_exact_frac": probe_stats["exact"] / max(probe_stats["total"], 1),
        "probe_max_pcm_delta": probe_stats["max_delta"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default="serve_load")
    ap.add_argument("--ckpt", default="", help="checkpoint to serve (default: "
                    "<workdir>/ckpt, written by --make_ckpt)")
    ap.add_argument("--make_ckpt", action="store_true")
    ap.add_argument("--levels", default="1,4,16")
    ap.add_argument("--requests", type=int, default=8, help="requests per client per level")
    ap.add_argument("--durations", default="1,4,10",
                    help="request durations (s), cycled per client")
    ap.add_argument("--workers", type=int, default=32)
    ap.add_argument("--max_batch", type=int, default=16)
    ap.add_argument("--window_ms", type=float, default=3.0)
    ap.add_argument("--fixed_batch", action="store_true",
                    help="serve with --fixed_batch and require byte-identical probes")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--cpu", dest="device", action="store_const", const="cpu")
    args = ap.parse_args(argv)

    os.makedirs(args.workdir, exist_ok=True)
    if args.make_ckpt:
        make_ckpt(args.workdir)
        return
    ckpt = args.ckpt or os.path.join(args.workdir, "ckpt")
    if not os.path.exists(ckpt):
        raise SystemExit(f"no checkpoint at {ckpt}: run --make_ckpt first")
    server = start_server(ckpt, args.device, args.workers, args.max_batch, args.window_ms,
                          args.fixed_batch)
    try:
        out = run_load(server.server_address[1], [int(x) for x in args.levels.split(",")],
                       args.requests, [float(d) for d in args.durations.split(",")],
                       args.fixed_batch)
    finally:
        server.shutdown()
        server.server_close()
    print(json.dumps({"metric": "serve_load_p99_ms_at_max_level",
                      "value": out["levels"][args.levels.split(",")[-1]]["p99_ms"],
                      "unit": "ms", **out, "device": args.device, "workers": args.workers,
                      "max_batch": args.max_batch, "window_ms": args.window_ms,
                      "fixed_batch": args.fixed_batch}))
    if not out["identity_ok"]:
        raise SystemExit("bucket-confinement check failed under load")


if __name__ == "__main__":
    main()
