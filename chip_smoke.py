#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

  python3 chip_smoke.py

Phases, one line each:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. the build of every kernel of the enhance path from csrc/, timed;
  3. each kernel against its plain PyTorch version on the card, at the
     flagship shape and at ragged ones, against a stated limit;
  4. the slice: a seeded flagship checkpoint served through
     ``serve.build_enhancer(device="cuda")`` (4 concurrent requests through
     ``MicroBatcher``) and the ``enhance`` CLI, with the kernel's launch
     count, the output checks, and the error against the same checkpoint
     enhanced by the port on the CPU (plain versions);
  5. times of the kernel and the plain recurrence, and the B=1 10 s enhance
     latency, each beside the card's name and power limit.

Then one JSON line with every kernel's numbers, and last
``{"ok": true, "device": {...}}``. Any failure raises, and the script exits
non-zero without that last line. It needs a CUDA card and the repository
around it.
"""
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
SR = 16000
# |hs| <= 1. The kernel and the plain loop sum each step's 256-term dot
# products in different orders (f32 rounding near 1e-7 a step); the
# recurrence is contractive, so the difference stays near that size.
KERNEL_TOL = 1e-4
# Relative to the output RMS. GPU and CPU runs differ only in f32 summation
# order (STFT, input projections, recurrence, Dense, iSTFT); through 3
# layers and up to 6001 steps that stays orders of magnitude below 1e-3.
SLICE_TOL = 1e-3
REQUEST_SECONDS = (1.3, 2.0, 3.7, 10.0)
CLI_SECONDS = (1.5, 2.5, 4.0)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def request_audio(seconds: float, seed: int) -> np.ndarray:
    """Seeded noise plus a tone, as float32 mono."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * SR))
    t = np.arange(n) / SR
    tone = 0.1 * np.sin(2 * np.pi * (220 + 110 * seed) * t)
    return (tone + 0.05 * rng.standard_normal(n)).astype(np.float32)


def kernel_inputs(torch, B, T, H, seed):
    g = torch.Generator().manual_seed(seed)
    xw = torch.randn(2, B, T, 4 * H, generator=g)
    w_hh = torch.empty(2, 4 * H, H)
    for d in range(2):
        torch.nn.init.orthogonal_(w_hh[d], generator=g)
    return xw.cuda(), w_hh.transpose(1, 2).contiguous().cuda()


def cuda_ms(torch, fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, ROOT)
    from speech_enhancement_by_s3prl_tpu_torch import use_full_fp32
    from speech_enhancement_by_s3prl_tpu_torch.data.audio_io import (
        read_wav,
        write_wav,
    )
    from speech_enhancement_by_s3prl_tpu_torch.enhance import main as enhance_cli
    from speech_enhancement_by_s3prl_tpu_torch.entry import (
        build,
        flagship_settings,
        make_enhance,
    )
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import _build
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda.lstm_kernel import (
        lstm_bidir_tm,
        lstm_bidir_tm_ref,
    )
    from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import (
        save_checkpoint,
    )
    from speech_enhancement_by_s3prl_tpu_torch.serve import (
        MicroBatcher,
        build_enhancer,
    )

    use_full_fp32()

    # 1. the card
    card = card_line()
    print(f"[device] {card} | {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 2. build every kernel of the path from the sources in the checkout
    t0 = time.perf_counter()
    lib_path = _build.build("lstm_tm")
    _build.load("lstm_tm")
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[build] lstm_tm.cu -> {os.path.relpath(lib_path, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s | ptxas: {' ; '.join(ptxas)}", flush=True)

    # 3. kernel against its plain version on the card
    max_err = 0.0
    # the flagship shape, a ragged one, and one past a 64-row staging chunk
    for B, T, H in ((4, 1001, 256), (3, 37, 256), (70, 37, 256)):
        xw, w_hh_t = kernel_inputs(torch, B, T, H, SEED + B)
        hs = lstm_bidir_tm(xw, w_hh_t)
        ref = lstm_bidir_tm_ref(xw, w_hh_t)
        torch.cuda.synchronize()
        err = float((hs - ref).abs().max())
        print(f"[kernel] lstm_bidir_tm B={B} T={T} H={H}: max_abs_err {err:.3e} "
              f"(limit {KERNEL_TOL:.0e})", flush=True)
        if not err <= KERNEL_TOL:
            raise AssertionError(f"lstm_bidir_tm disagrees with its plain version: {err}")
        max_err = max(max_err, err)

    # 4. the slice, on the card and (for comparison) on the CPU
    with tempfile.TemporaryDirectory() as tmp:
        _, model = build(device="cpu", generator=torch.Generator().manual_seed(SEED))
        config, paras = flagship_settings()
        ckpt = save_checkpoint(tmp, 0, model, None, config, paras)
        gpu = build_enhancer(ckpt, device="cuda")
        cpu = build_enhancer(ckpt, device="cpu")
        requests = [request_audio(s, i) for i, s in enumerate(REQUEST_SECONDS)]
        cli_in = os.path.join(tmp, "in")
        cli_out = os.path.join(tmp, "out")
        os.makedirs(cli_in)
        cli_wavs = []
        for i, s in enumerate(CLI_SECONDS):
            w = request_audio(s, 10 + i)
            write_wav(os.path.join(cli_in, f"clip{i}.wav"), w, SR)
            cli_wavs.append(read_wav(os.path.join(cli_in, f"clip{i}.wav"))[0][0])

        batches = []

        def counted(wavs):
            batches.append(len(wavs))
            return gpu.run_batch(wavs)

        batcher = MicroBatcher(counted, max_batch=16, window_ms=50.0,
                               bucket_of=gpu.bucket_of)
        answers = [None] * len(requests)

        def ask(k):
            answers[k] = batcher.submit(requests[k])

        # -- the main path, between the counter reset and its reading --
        lstm_bidir_tm.launches = 0
        threads = [threading.Thread(target=ask, args=(k,)) for k in range(len(requests))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
            if th.is_alive():
                raise AssertionError("a request did not finish within 600 s")
        served_launches = lstm_bidir_tm.launches
        enhance_cli(["--ckpt", ckpt, "--inputs", cli_in, "--outdir", cli_out,
                     "--device", "cuda"])
        launches = lstm_bidir_tm.launches
        # -----------------------------------------------------------------

        if served_launches != 3 * len(batches):
            raise AssertionError(
                f"{served_launches} kernel launches for {len(batches)} device "
                "batches of a 3-layer model"
            )
        if launches - served_launches != 3:
            raise AssertionError(
                f"the CLI's one device batch made {launches - served_launches} "
                "kernel launches, not 3"
            )
        print(f"[slice] served {len(requests)} concurrent requests "
              f"({', '.join(f'{s} s' for s in REQUEST_SECONDS)}) in device batches "
              f"of {batches}; CLI enhanced {len(CLI_SECONDS)} files in 1 batch; "
              f"kernel launches {launches} (3 per device batch)", flush=True)

        worst = 0.0
        for k, (wav, out) in enumerate(zip(requests, answers)):
            if out.shape != wav.shape or not np.isfinite(out).all():
                raise AssertionError(f"request {k}: shape {out.shape}, finite "
                                     f"{np.isfinite(out).all()}")
            ref = cpu(wav)
            rel = float(np.abs(out - ref).max() / np.sqrt(np.mean(ref ** 2)))
            worst = max(worst, rel)
        cli_ref = cpu.run_batch(cli_wavs)
        for i, ref in enumerate(cli_ref):
            out = read_wav(os.path.join(cli_out, f"clip{i}.wav"))[0][0]
            if out.shape != cli_wavs[i].shape or not np.isfinite(out).all():
                raise AssertionError(f"CLI output {i}: shape {out.shape}")
            # the CLI writes 16-bit PCM: allow one quantization step
            err = float(np.abs(out - ref).max())
            if not err <= 1.0 / 32767 + SLICE_TOL * np.sqrt(np.mean(ref ** 2)):
                raise AssertionError(f"CLI output {i} differs from the CPU run by {err}")
        print(f"[slice] GPU vs CPU (plain versions): max |diff| / output RMS "
              f"{worst:.3e} (limit {SLICE_TOL:.0e}); outputs finite, lengths "
              "match the inputs", flush=True)
        if not worst <= SLICE_TOL:
            raise AssertionError(f"GPU output differs from the CPU run: {worst}")

    # 5. times on the card
    times = {}
    for B in (1, 64):
        xw, w_hh_t = kernel_inputs(torch, B, 1001, 256, SEED)
        plain = cuda_ms(torch, lambda: lstm_bidir_tm_ref(xw, w_hh_t), iters=3)
        kern = cuda_ms(torch, lambda: lstm_bidir_tm(xw, w_hh_t), iters=20)
        kern2 = cuda_ms(torch, lambda: lstm_bidir_tm(xw, w_hh_t), iters=20)
        plain2 = cuda_ms(torch, lambda: lstm_bidir_tm_ref(xw, w_hh_t), iters=3)
        times[B] = (min(kern, kern2), min(plain, plain2))
        print(f"[time] lstm_bidir_tm B={B} T=1001 H=256: kernel {kern:.3f} / "
              f"{kern2:.3f} ms, plain {plain:.3f} / {plain2:.3f} ms | {card}",
              flush=True)

    pre, model = build(device="cuda", generator=torch.Generator().manual_seed(SEED))
    enhance = make_enhance(pre, model)
    wav = torch.from_numpy(np.stack([request_audio(10.0, s) for s in range(3)]))
    wavs = wav[None].cuda()
    lengths = torch.tensor([wav.shape[-1]]).cuda()
    for _ in range(3):
        enhance(wavs, lengths)
    torch.cuda.synchronize()
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        enhance(wavs, lengths)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    print(f"[time] enhance B=1 10 s (T=1001 frames): median {statistics.median(lat):.3f} "
          f"ms over 20 calls (min {min(lat):.3f}, max {max(lat):.3f}) | {card}",
          flush=True)

    print(json.dumps({"kernels": [{
        "name": "lstm_bidir_tm",
        "route": "cuda",
        "source": "speech_enhancement_by_s3prl_tpu_torch/csrc/lstm_tm.cu",
        "replaces": "speech_enhancement_by_s3prl_tpu/ops/pallas/lstm_kernel.py:208",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times[1][0],
        "plain_ms": times[1][1],
        "shape": "B=1 T=1001 H=256",
        "ms_b64": times[64][0],
        "plain_ms_b64": times[64][1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
