#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

  python3 chip_smoke.py

Phases, one line each:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. the build of every kernel from csrc/ (one nvcc per source, all started
     together), timed, with ptxas's register report;
  3. each kernel against its plain PyTorch version on the card, at the
     flagship shape and at ragged ones, against a stated limit: B1
     (recurrence) and B2 fwd (recurrence + cell states), on the route the
     hidden size names (thread-block clusters up to H = 256, also with one
     direction, B = 6 and 16 and T = 1, each call twice, across batch blocks
     and in each measurement variant for identical bits; the earlier
     cooperative kernel at H = 36 and 260 and, launched directly, at the
     flagship width), B2 bwd (reverse-time
     VJP: its three-phase route at the flagship width, across a batch-block
     boundary and with one direction, the earlier single-kernel route at a
     hidden size only it takes and, launched directly, at the flagship width
     too; each twice on the same inputs for identical bits), and the
     gradients of ``LstmBidirTm`` against autograd through the
     plain recurrence; B3 fwd (flash attention with hash dropout: out, lse)
     and B3 bwd (dq, dk, dv) at the Mockingjay shape (B=6, T=1001, 12 heads
     of 64) with dropout 0.1 and 0, at ragged T with a key bias, and
     ``FlashAttention`` against autograd through the plain version, B3 bwd
     twice on the same inputs for identical bits, and both once on views whose
     rows start off a 16-byte boundary; B4 (fused STFT) at one
     and twelve rows of 10 s, ragged lengths, lead axes and other geometries,
     each on the route its n_fft names (the FFT kernel, or the matrix-product
     kernel for an n_fft such as 254 = 2 * 127), the product kernel also at
     the flagship geometry, and B5 (fused decode) the same way (the inverse
     FFT, or the product kernel at 254) at T' = 1001, 251, 78, 2 and 1 with a
     carrier from an STFT, an all-zero carrier and powers 1, 2, 3, at B4's
     geometries, each twice for identical bits, and twelve rows in one launch
     against each row alone for identical bits; B6
     (batch-blocked recurrence) and B7 (recurrence with the projection
     inside) on their routes (B6 on B1's cluster kernel, B7 on
     lstm_bb_cluster.cu) at B = 1, 6, 70 and 256, D = 120, 512 and ragged
     ones, a narrow layer and small batch blocks, each twice and with batch
     blocks 8 and 1 for identical bits, and B6 against B1's bits;
  4. the enhance slice: a seeded flagship checkpoint served through
     ``serve.build_enhancer(device="cuda")`` (4 concurrent requests through
     ``MicroBatcher``) and the ``enhance`` CLI, with the launch counts of B1,
     B4 and B5, the output checks, and the error against the same checkpoint
     enhanced by the port on the CPU (plain versions); the same checkpoint
     served with its ``LSTMStack`` switched to ``recurrence="blocked"`` (B6)
     and ``"fused"`` (B7) (an attribute of ``LSTMStack``: no builder takes
     the route) against the default route and the CPU; and the long-form
     entry: one 75 s
     request through ``build_enhancer(max_bucket_ms=10000)``, 9 crossfaded
     windows, against the same request on the CPU; and a one-direction
     3 x 256 head (the shape of config/vcb.yaml) served the same way (3 B1
     launches a device batch), its B=1 10 s latency, and one train step of
     it through ``LstmBidirTm`` against the same step on the CPU;
  5. the training slice at full width: the flagship trained through
     ``run_downstream.build_runner`` / ``Runner`` on a seeded WAV corpus
     the script writes (8 steps with evals and saves, then a 2-step resume),
     with the launch counts of the three recurrence kernels and of B4 and
     B5; then one train step on the card against the same step on the CPU,
     and a NaN-poisoned step that must leave every parameter as it was;
  6. the upstream slice at full width (the TERA/Mockingjay encoder, 6
     layers x 768 x 12 heads, FFN 3072, dropout 0.1): ``Mockingjay`` trained
     ``--from_waveform`` through ``build_runner`` / ``Runner`` (4 steps with
     evals and saves, then a 2-step resume) with B3's launch counts (6 fwd
     and 6 bwd a step, none in eval); one train step on the card against
     the same step on the CPU with the same dropout salts; and the upstream
     mode: a ``Residual`` head trained on the hidden states of a frozen,
     seeded full-width S3PRL checkpoint with ``--dropout`` (B3 fwd in the
     upstream), its checkpoint then served on the card and on the CPU;
  7. times of each kernel and its plain version, B1 and B2 fwd under both
     routes beside B6 at B = 1, 6 and 64 with the cluster design's
     measurement variants, the B=1 10 s enhance
     latency under each recurrence route with its profiler breakdown, B4
     and B5 (both kernels of each, also launched without the wrapper) beside
     the torch-op routes they replace, ``torch.stft`` and ``torch.istft``, B6
     (also at B = 256) and B7, B1 and the
     projection matmul + B1, one cuDNN ``nn.LSTM`` layer (D = 512 and 120)
     as the library yardstick of the recurrences, B2 bwd under both routes
     with the share of each
     phase, the B=6 train step and eval batch, and a profiler
     breakdown of the train step, each beside the card's name and power
     limit; then
     B3 fwd and bwd against their plain versions at B=6 and B=64, B3 at rate
     0 against ``scaled_dot_product_attention`` and its backward (yardsticks,
     not routes),
     the B=6 10 s Mockingjay train step and its profiler breakdown;
  8. the metrics phase (``metrics/``: STOI, ESTOI, the P.862 model,
     SI-SDR): the conformance battery on the card against its pins in
     docs/CONFORMANCE.json and against the CPU, the delay search card
     against CPU on both branches of its fine pass, and one flagship eval
     batch at config/vcb.yaml's eval (12 rows of up to 10 s, eval_metrics
     stoi, pesq_nb, sisdr) through the port's eval step: its B1 / B4 / B5
     launches, card against CPU, its time beside SI-SDR alone, and the
     metrics' share of its device busy time; TF32 checked off in every
     metric call.

Then each kernel's time beside its bound (the least time the card could take
for the same work), the card's line, one JSON line with every kernel's
numbers, and last
``{"ok": true, "device": {...}}``. Any failure raises, and the script exits
non-zero without that last line. It needs a CUDA card and the repository
around it.
"""
import json
import math
import os
import random
import re
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
# the long-form request: 9 windows of 10 s, each starting 9 s after the last
LONG_SECONDS, LONG_WINDOWS = 75.0, 9
CLI_SECONDS = (1.5, 2.5, 4.0)
# B2 vs its plain versions, each error relative to the plain version's
# largest |value| (cs grows with T; dxw and dW_hh^T are sums over T steps and
# B rows, dW_hh^T up to ~20 here). Both sides compute in f32 with other
# summation orders (f32 rounding ~1e-7 relative a term; B2 bwd's gate and
# dW_hh^T products in three TF32 passes, which keep 21 of an operand's 24
# bits); chip runs measured 1.3e-7 to 1.3e-6, so 1e-4 leaves almost two decades.
B2_TOL = 1e-4
# The flagship train step on the card vs on the CPU (plain versions): the
# same f32 arithmetic in other orders through STFT, 3 BLSTM layers forward and
# backward over 401 steps, Dense and the SISDR loss.
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-3
B2_SHAPES = ((6, 1001, 256), (3, 37, 256), (70, 37, 256))
# B2 bwd alone, as (directions, B, T, H): across a batch-block boundary of the
# dh chain (8 rows a cluster) with a ragged last block, one direction, a
# narrow layer, T = 1 (no h_{-1}, dW_hh^T = 0) and hidden sizes that only the
# earlier single-kernel route takes
B2_BWD_SHAPES = ((2, 17, 40, 256), (1, 5, 33, 256), (1, 6, 401, 256), (2, 9, 21, 64),
                 (2, 2, 1, 256), (2, 3, 19, 36), (1, 2, 19, 260))
# B1 / B2 fwd beyond phase 3's flagship shapes, as (directions, B, T, H): one
# direction, B = 6 (twelve clusters of one row) and 16 (clusters of 3 rows),
# T = 1, a narrow layer, and hidden sizes that only the earlier cooperative
# route takes
FWD_SHAPES = ((1, 6, 401, 256), (2, 6, 1001, 256), (2, 16, 57, 256), (2, 3, 1, 256),
              (2, 5, 20, 64), (2, 3, 19, 36), (1, 2, 19, 260))
# batch blocks the cluster route is also launched with: rows are independent
# and summed in an order their block does not enter, so the bits must not move
FWD_BLOCKS = (1, 3, 16)
# B6 / B7 through their wrappers, as (B, T, H, batch block) and (B, T, D, H,
# batch block): the flagship shapes, B = 256 at the flagship width (16 rows a
# cluster for B6, 10 for B7), a batch past two blocks with a ragged last one,
# a narrow layer, small batch blocks and D that are not a multiple of 8 (30,
# 40)
BB_SHAPES = ((1, 1001, 256, 32), (6, 1001, 256, 32), (70, 37, 256, 32), (256, 1001, 256, 32),
             (13, 29, 64, 5), (9, 21, 256, 2))
FUSED_SHAPES = ((1, 1001, 120, 256, 32), (1, 1001, 512, 256, 32), (6, 1001, 120, 256, 32),
                (6, 1001, 512, 256, 32), (70, 37, 120, 256, 32), (70, 37, 512, 256, 32),
                (256, 401, 512, 256, 32), (13, 29, 30, 64, 5), (9, 21, 40, 256, 2))
# batch blocks B6 / B7 are also called with: rows are independent and a row's
# sums run in an order its block does not enter, so the bits must not move
BB_BLOCKS = (8, 1)
TRAIN_STEPS, RESUME_STEPS = 8, 2
# B3 vs its plain version, each error relative to the plain version's largest
# |value|. The kernels fold key tiles into an online softmax and compute their
# tile products on the tensor cores in three TF32 passes (measured ~3e-6 for
# out, dq, dk, dv and ~2e-7 for lse, which sees one product), the plain
# version takes whole rows through cuBLAS in full f32. One flipped mask bit
# moves an output by about 1e-3 of its largest value, so a wrong hash fails.
B3_TOL = 1e-4
# B4 and B5 vs their plain versions, relative to the plain version's largest
# |value|, all in f32. The plain versions sum 400 (B4) or up to 402 (B5)
# products a value in cuBLAS's order. The product kernels sum the same
# products with FMAs in index order; the FFT kernels reach a value through
# four butterfly passes and a split (B4) or pack (B5) pass on f32 twiddles
# built in float64 (error ~1e-6 of the largest value: a rounding near 1e-7 a
# pass). A fast-math sine in place of the tables would lose the limit.
DSP_TOL = 1e-5
B3_CASES = (  # B, T, N, D, dropout rate, key bias
    (6, 1001, 12, 64, 0.1, False),
    (6, 1001, 12, 64, 0.0, False),
    (2, 37, 12, 64, 0.1, True),
    (3, 130, 12, 64, 0.1, True),
    (2, 70, 4, 32, 0.2, True),
    (2, 70, 2, 128, 0.2, False),
)
MJ_LAYERS = 6
# the card's published peaks (NVIDIA H100 SXM data sheet): f32 outside the
# tensor cores, dense TF32 on them, and HBM3. A bound takes the cheapest
# arithmetic the numerics allow: f32 results to f32 accuracy may come from
# the tensor cores as three TF32 passes a product (B3), not from one
PEAK_F32, PEAK_TF32, PEAK_BYTES = 67e12, 495e12, 3.35e12
MJ_STEPS, MJ_RESUME_STEPS, UPSTREAM_STEPS = 4, 2, 2


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


def kernel_inputs(torch, B, T, H, seed, ndir=2):
    g = torch.Generator().manual_seed(seed)
    xw = torch.randn(ndir, B, T, 4 * H, generator=g)
    w_hh = torch.empty(ndir, 4 * H, H)
    for d in range(ndir):
        torch.nn.init.orthogonal_(w_hh[d], generator=g)
    return xw.cuda(), w_hh.transpose(1, 2).contiguous().cuda()


def kernel_grad_inputs(torch, B, T, H, seed, ndir=2):
    xw, w_hh_t = kernel_inputs(torch, B, T, H, seed, ndir)
    g = torch.Generator().manual_seed(seed + 1)
    return xw, w_hh_t, torch.randn(ndir, B, T, H, generator=g).cuda()


def rel_err(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


def bwd_route_checks(torch, L):
    """B2 bwd on each of its routes against its plain version on the card, at
    ``B2_BWD_SHAPES`` on the route the hidden size names and, launched
    directly, on the earlier single-kernel route at the flagship shapes (not
    its route there: the design the three phases replaced). The forward
    kernels run the same direction counts. Every call is made twice on the
    same inputs and must give identical bits. Returns {route: (largest
    relative error, largest absolute error)}."""
    worst = {"phases": [0.0, 0.0], "grid": [0.0, 0.0]}
    cases = [(shape, None) for shape in B2_BWD_SHAPES]
    cases += [((2, B, T, H), "grid") for B, T, H in B2_SHAPES]
    for (ndir, B, T, H), forced in cases:
        xw, w_hh_t, dhs = kernel_grad_inputs(torch, B, T, H, SEED + B + T, ndir)
        ref_hs, ref_cs = L.lstm_bidir_tm_fc_ref(xw, w_hh_t)
        ref = L.lstm_bidir_tm_bwd_ref(xw, w_hh_t, ref_hs, ref_cs, dhs)
        line = ""
        if forced is None:
            route = L.bwd_route(H)
            before = dict(L.lstm_bidir_tm_bwd.by_route)
            out = L.lstm_bidir_tm_bwd(xw, w_hh_t, ref_hs, ref_cs, dhs)
            again = L.lstm_bidir_tm_bwd(xw, w_hh_t, ref_hs, ref_cs, dhs)
            took = [r for r, n in L.lstm_bidir_tm_bwd.by_route.items() if n != before[r]]
            if took != [route]:
                raise AssertionError(f"lstm_bidir_tm_bwd took route {took} at H={H}, want "
                                     f"{route!r}")
            hs, cs = L.lstm_bidir_tm_fc(xw, w_hh_t)
            h1 = L.lstm_bidir_tm(xw, w_hh_t)
            fwd_errs = (float((h1 - ref_hs).abs().max()), float((hs - ref_hs).abs().max()),
                        rel_err(cs, ref_cs))
            line = (f"; B1 hs {fwd_errs[0]:.3e}, B2 fwd hs {fwd_errs[1]:.3e} (limit "
                    f"{KERNEL_TOL:.0e}), cs / max|cs| {fwd_errs[2]:.3e}")
            if not (max(fwd_errs[:2]) <= KERNEL_TOL and fwd_errs[2] <= B2_TOL):
                raise AssertionError(f"the forward kernels disagree at {ndir} direction(s): "
                                     f"{fwd_errs}")
        else:
            route = forced
            out = L._launch_bwd(route, xw, w_hh_t, ref_hs, ref_cs, dhs)
            again = L._launch_bwd(route, xw, w_hh_t, ref_hs, ref_cs, dhs)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f"lstm_bidir_tm_bwd ({route}) gave other bits on the same "
                                 "inputs")
        # at T = 1 dW_hh^T is all zeros on both sides: an absolute error then
        scale = [float(r.abs().max()) or 1.0 for r in ref]
        errs = [float((a - r).abs().max()) for a, r in zip(out, ref)]
        rels = [e / m for e, m in zip(errs, scale)]
        print(f"[kernel] lstm_bidir_tm_bwd route {route!r}"
              f"{'' if forced is None else ' (launched directly, not its route here)'} "
              f"directions={ndir} B={B} T={T} H={H}: dxw err / max|dxw| {rels[0]:.3e}, "
              f"dW_hh^T err / max|dW_hh^T| {rels[1]:.3e} (limit {B2_TOL:.0e}); twice: "
              f"identical bits{line}", flush=True)
        if not max(rels) <= B2_TOL:
            raise AssertionError(f"lstm_bidir_tm_bwd ({route}) disagrees: {rels}")
        worst[route] = [max(worst[route][0], *rels), max(worst[route][1], *errs)]
    return worst


def bwd_phase_times(torch, L, tensors, B, card):
    """B2 bwd's earlier single-kernel route at the same inputs (launched
    directly, in turns with the route taken), and the device time of each
    phase of the route taken, by kernel name under the profiler. Returns
    {"grid": ms, "phases": ms, "gates": ms, "chain": ms, "dw": ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runs = {"phases": [], "grid": []}
    for route in ("grid", "phases", "phases", "grid"):
        runs[route].append(cuda_ms(torch, lambda: L._launch_bwd(route, *tensors), iters=5))
    out = {route: min(ms) for route, ms in runs.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            L.lstm_bidir_tm_bwd(*tensors)
        torch.cuda.synchronize()
    phases = {"gates": 0.0, "chain": 0.0, "dw": 0.0}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        for key, tag in (("gates", "lstm_bwd_gates"), ("chain", "lstm_bwd_seq"),
                         ("dw", "lstm_bwd_dw")):
            if tag in evt.name:
                phases[key] += evt.time_range.elapsed_us() / 1e3 / 5
    out.update(phases)
    total = sum(phases.values())
    print(f"[time] lstm_bidir_tm_bwd B={B} T=1001 H=256 by route: 'phases' (the route taken) "
          f"{' / '.join(f'{x:.3f}' for x in runs['phases'])} ms, 'grid' (the earlier design, "
          f"launched directly) {' / '.join(f'{x:.3f}' for x in runs['grid'])} ms; phases "
          f"under torch.profiler: "
          + ", ".join(f"{k} {v:.3f} ms {v / max(total, 1e-9):.1%}" for k, v in phases.items())
          + f" | {card}", flush=True)
    if not total > 0.0:
        raise AssertionError("the profiler saw no kernel of B2 bwd's phases")
    return out


def fwd_route_checks(torch, L):
    """B1 and B2 fwd through their wrappers on the route ``fwd_route`` names,
    at ``FWD_SHAPES``, and on the earlier ``grid`` route launched directly at
    the flagship shapes (not its route there: the design the clusters
    replaced), against the plain version. Every call is made twice for
    identical bits; on the ``cluster`` route B1 and B2 fwd must also give the
    same hs, and so must every batch block of ``FWD_BLOCKS`` and every
    measurement variant (``L.FWD_VARIANTS``: the same sums in the same order).
    Returns {route: [largest hs error, largest cs error / max|cs|]}."""
    worst = {"cluster": [0.0, 0.0], "grid": [0.0, 0.0]}
    cases = [(shape, None) for shape in FWD_SHAPES]
    cases += [((2, 4, 1001, 256), "grid"), ((2, 6, 1001, 256), "grid")]
    counters = (L.lstm_bidir_tm, L.lstm_bidir_tm_fc)
    for (ndir, B, T, H), forced in cases:
        xw, w_hh_t = kernel_inputs(torch, B, T, H, SEED + B + T, ndir)
        route = forced or L.fwd_route(H)
        if forced is None:
            before = [dict(fn.by_route) for fn in counters]
            runs = [L.lstm_bidir_tm(xw, w_hh_t) for _ in range(2)]
            fcs = [L.lstm_bidir_tm_fc(xw, w_hh_t) for _ in range(2)]
            for fn, was in zip(counters, before):
                took = {r: n - was[r] for r, n in fn.by_route.items() if n != was[r]}
                if took != {route: 2}:
                    raise AssertionError(f"{fn.__name__} took {took} at H={H}, want "
                                         f"{route!r}")
        else:
            runs = [L._launch_fwd(route, xw, w_hh_t) for _ in range(2)]
            fcs = [L._launch_fwd(route, xw, w_hh_t, with_cell=True) for _ in range(2)]
        (hs, cs), again = fcs
        same = {"repeat": torch.equal(runs[0], runs[1])
                and torch.equal(hs, again[0]) and torch.equal(cs, again[1])}
        line = ""
        if route == "cluster":
            block = L.fwd_batch_block(B, ndir, L._fwd_clusters(L.launch_args(xw)[0]))
            others = [bb for bb in FWD_BLOCKS if bb != block]
            same["B1 = B2 fwd"] = torch.equal(runs[0], hs)
            for bb in others:
                h_bb, c_bb = L._launch_fwd(route, xw, w_hh_t, with_cell=True, batch_block=bb)
                same[f"batch block {bb}"] = (
                    torch.equal(L._launch_fwd(route, xw, w_hh_t, batch_block=bb), runs[0])
                    and torch.equal(h_bb, hs) and torch.equal(c_bb, cs))
            for name, variant in L.FWD_VARIANTS.items():
                same[name] = torch.equal(L._launch_fwd(
                    route, xw, w_hh_t, batch_block=min(block, 8), variant=variant), runs[0])
            line = f" batch block {block} (also {others})"
        ref_hs, ref_cs = L.lstm_bidir_tm_fc_ref(xw, w_hh_t)
        torch.cuda.synchronize()
        h_err = max(float((runs[0] - ref_hs).abs().max()), float((hs - ref_hs).abs().max()))
        c_err = rel_err(cs, ref_cs)
        print(f"[kernel] lstm_bidir_tm / lstm_bidir_tm_fc route {route!r}"
              f"{'' if forced is None else ' (launched directly, not its route here)'}"
              f"{line} directions={ndir} B={B} T={T} H={H}: hs max_abs_err {h_err:.3e} "
              f"(limit {KERNEL_TOL:.0e}), cs err / max|cs| {c_err:.3e} (limit "
              f"{B2_TOL:.0e}); identical bits: {', '.join(same)}", flush=True)
        if not (h_err <= KERNEL_TOL and c_err <= B2_TOL):
            raise AssertionError(f"the forward kernels ({route}) disagree: {h_err}, {c_err}")
        if not all(same.values()):
            raise AssertionError(f"the forward kernels ({route}) gave other bits: {same}")
        worst[route] = [max(worst[route][0], h_err), max(worst[route][1], c_err)]
    return worst


def fwd_times(torch, L, card):
    """B1 and B2 fwd at T=1001, H=256 under both routes (the ``grid`` route
    launched directly) beside B6, at B = 1, 6 and 64, and B1 on the
    ``cluster`` route with one element of its design changed
    (``L.FWD_VARIANTS``, and the fewest clusters: a batch block of B rows, at
    most ``L.FWD_MAX_BATCH_BLOCK``, in place of ``fwd_batch_block``'s), all
    in turns forward and back; the smaller of the two timings is kept.
    Returns {(name, B): ms}."""
    T, H = 1001, 256
    out = {}
    for B in (1, 6, 64):
        xw, w_hh_t = kernel_inputs(torch, B, T, H, SEED)
        block = L.fwd_batch_block(B, 2, L._fwd_clusters(L.launch_args(xw)[0]))
        fns = {
            "cluster": lambda: L.lstm_bidir_tm(xw, w_hh_t),
            "grid": lambda: L._launch_fwd("grid", xw, w_hh_t),
            "fc_cluster": lambda: L.lstm_bidir_tm_fc(xw, w_hh_t),
            "fc_grid": lambda: L._launch_fwd("grid", xw, w_hh_t, with_cell=True),
            "b6": lambda: L.lstm_bidir_bb(xw, w_hh_t),
        }
        for name, variant in L.FWD_VARIANTS.items():
            if variant == 1 and block > 8:  # its weights leave room for 8 rows
                continue
            fns[name] = (lambda v=variant: L._launch_fwd("cluster", xw, w_hh_t, variant=v))
        fewest = min(B, L.FWD_MAX_BATCH_BLOCK)
        if fewest != block:
            fns["fewest clusters"] = lambda: L._launch_fwd("cluster", xw, w_hh_t,
                                                           batch_block=fewest)
        runs = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                runs[k].append(cuda_ms(torch, fns[k], iters=10))
        for k, ms in runs.items():
            out[(k, B)] = min(ms)

        def fmt(k):
            return (f"{' / '.join(f'{x:.3f}' for x in runs[k])} ms "
                    f"({min(runs[k]) * 1e3 / T:.2f} us a step)")

        print(f"[time] forward recurrence B={B} T={T} H={H}, two directions: B1 'cluster' "
              f"(the route taken, batch block {block}) {fmt('cluster')}, 'grid' (the "
              f"earlier design, launched directly) {fmt('grid')}; B2 fwd 'cluster' "
              f"{fmt('fc_cluster')}, 'grid' {fmt('fc_grid')}; B6 (batch block 32) "
              f"{fmt('b6')}; B1 'cluster' with one element changed: "
              + ", ".join(f"{k} {fmt(k)}" for k in L.FWD_VARIANTS if k in runs)
              + (f", fewest clusters (batch block {fewest}) {fmt('fewest clusters')}"
                 if "fewest clusters" in runs else "") + f" | {card}", flush=True)
        del xw
    return out


def write_corpus(root, seed):
    """12 speech files of 3-10 s (tone sweeps with a syllable envelope) and
    4 noise files of 4-8 s, 16 kHz WAV, from ``seed``."""
    from speech_enhancement_by_s3prl_tpu_torch.data.audio_io import write_wav

    rng = np.random.default_rng(seed)
    for sub, n, lo, hi in (("speech", 12, 3.0, 10.0), ("noise", 4, 4.0, 8.0)):
        os.makedirs(os.path.join(root, sub))
        for k in range(n):
            L = int(rng.uniform(lo, hi) * SR)
            t = np.arange(L) / SR
            if sub == "speech":
                f0 = 120 + 80 * rng.random()
                env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t + rng.uniform(0, 6))
                wav = env * sum(np.sin(2 * np.pi * f0 * h * t) / h for h in (1, 2, 3))
                wav = 0.1 * wav + 0.002 * rng.standard_normal(L)
            else:
                wav = 0.05 * rng.standard_normal(L) * (1 + 0.5 * np.sin(2 * np.pi * 0.5 * t))
            write_wav(os.path.join(root, sub, f"{sub}{k}.wav"), wav.astype(np.float32), SR)


def train_config(root):
    """A dict config of the flagship training run at full width: batch 6,
    max_time 10000, BertAdam(4e-5, 0.07), SISDR, eval on a dev split."""
    speech = os.path.join(root, "speech")
    noise = os.path.join(root, "noise")
    data = {"sample_rate": SR, "max_time": 10000, "target_level": -25}
    return {
        "dataloader": {"batch_size": 6, "eval_batch_size": 12},
        "preprocessor": {"input_channel": 0, "target_channel": 1,
                         "baseline": {"feat_type": "mel", "log": True, "delta": 2,
                                      "cmvn": False}},
        "runner": {"learning_rate": 4e-5, "warmup_proportion": 0.07,
                   "gradient_clipping": 1.0, "total_step": TRAIN_STEPS, "log_step": 2,
                   "eval_step": 4, "save_step": 4, "max_keep": 2,
                   "eval_splits": ["dev"], "eval_metrics": ["sisdr"]},
        "objective": {"SISDR": {}},
        "model": {"Residual": {"hidden_size": 256, "num_layers": 3,
                               "bidirectional": True, "activation": "Sigmoid",
                               "cmvn": False}},
        "OnlineDataset_train": {"speech": {"filestrs": speech, "sample_num": 3},
                                "noise": {"filestrs": noise},
                                "snrs": [-5, 0, 5], "infinite": True, **data},
        "OnlineDataset_test": {"speech": {"filestrs": speech, "sample_num": 3,
                                          "select_sampled": True},
                               "noise": {"filestrs": noise}, "snrs": [0],
                               "half_noise": "end", **data},
    }


def ckpt_files(directory):
    """The states-*.ckpt files of a directory, by step."""
    return sorted((f for f in os.listdir(directory) if f.endswith(".ckpt")),
                  key=lambda f: int(f[len("states-"):-len(".ckpt")]))


def reset_counts(kernels):
    for fn in kernels:
        fn.launches = 0
        for route in getattr(fn, "by_route", {}):
            fn.by_route[route] = 0


def check_b5_route(decode_ola, where):
    """Every B5 launch since the last reset on the FFT kernel, the route
    ``decode_route`` names at the flagship's n_fft 400."""
    if decode_ola.by_route != {"fft": decode_ola.launches, "product": 0}:
        raise AssertionError(f"{where}: B5 launches by route {decode_ola.by_route}, want all "
                             f"{decode_ola.launches} on 'fft'")


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


def kernel_label(mangled: str) -> str:
    """A kernel's name and template arguments out of its mangled name."""
    m = re.search(r"\d+((?:lstm|flash|stft|decode)[a-z_]*kernel(?:I.*?E)?)E", mangled)
    return m.group(1) if m else mangled


def kernel_op(name: str) -> str:
    """The op of a device kernel, out of its demangled name: the host
    function of an elementwise lambda, else the innermost functor and its
    type, else the kernel's name."""
    m = re.search(r"(\w+)\((?:at::)?TensorIteratorBase&\)", name)
    if m:
        return m.group(1)
    functors = re.findall(r"(\w+(?:Functor|Op))<([\w:]+)", name)
    if functors:
        return "{}<{}>".format(*functors[-1])
    return re.sub(r"^void |<.*$", "", name)[:60]


def write_s3prl_checkpoint(torch, path, seed):
    """A TERA pretraining checkpoint in the S3PRL layout (unfused q/k/v,
    gamma/beta LayerNorms) at the reference's full width
    (config/pretrain_sample.yaml), weights normal(0, 0.02) from ``seed``."""
    from speech_enhancement_by_s3prl_tpu_torch.run_downstream import PRETRAIN_ONLINE

    g = torch.Generator().manual_seed(seed)
    H, I, D_in, D_out = 768, 3072, 80, 201

    def dense(prefix, n_out, n_in):
        return {f"{prefix}.weight": 0.02 * torch.randn(n_out, n_in, generator=g),
                f"{prefix}.bias": torch.zeros(n_out)}

    def layernorm(prefix):
        return {f"{prefix}.gamma": torch.ones(H), f"{prefix}.beta": torch.zeros(H)}

    enc = {**dense("input_representations.spec_transform", H, D_in),
           **layernorm("input_representations.LayerNorm")}
    for i in range(MJ_LAYERS):
        p = f"encoder.layer.{i}"
        for name in ("query", "key", "value"):
            enc.update(dense(f"{p}.attention.self.{name}", H, H))
        enc.update({**dense(f"{p}.attention.output.dense", H, H),
                    **layernorm(f"{p}.attention.output.LayerNorm"),
                    **dense(f"{p}.intermediate.dense", I, H),
                    **dense(f"{p}.output.dense", H, I),
                    **layernorm(f"{p}.output.LayerNorm")})
    head = {**dense("dense", H, H), **layernorm("LayerNorm"), **dense("output", D_out, H)}
    config = {"transformer": {
        "input_dim": 160, "downsample_rate": 1, "hidden_size": H,
        "num_hidden_layers": MJ_LAYERS, "num_attention_heads": 12, "intermediate_size": I,
        "hidden_act": "gelu", "hidden_dropout_prob": 0.1,
        "attention_probs_dropout_prob": 0.1, "initializer_range": 0.02,
        "layer_norm_eps": "1e-12", "share_layer": False, "max_input_length": 0,
    }, "online": PRETRAIN_ONLINE}
    torch.save({"Transformer": enc, "SpecHead": head,
                "Settings": {"Config": config, "Paras": {}}}, path)
    return path


def flash_checks(torch, A):
    """B3 fwd and B3 bwd against their plain versions on the card, q, k and
    v as the three thirds of one fused projection, as the encoder hands them
    over. Returns the largest absolute errors (fwd, bwd)."""
    worst_fwd = worst_bwd = 0.0
    salt, batch0 = (0x9E3779B9, 0xDEADBEEF), 3
    for B, T, N, D, rate, bias in B3_CASES:
        g = torch.Generator().manual_seed(SEED + T)
        qkv = torch.randn(B, T, 3 * N * D, generator=g).cuda()
        q, k, v = qkv.split(N * D, dim=-1)
        kbias = (2.0 * torch.randn(B, T, generator=g)).cuda() if bias else None
        dout = torch.randn(B, T, N * D, generator=g).cuda()
        args = (D ** -0.5, rate, salt, kbias, batch0)
        out, lse = A.flash_attention_fwd(q, k, v, *args, n_heads=N)
        ref_out, ref_lse = A.flash_attention_ref(q, k, v, *args, n_heads=N)
        # both backward passes from the same residuals
        grads = A.flash_attention_bwd(q, k, v, ref_out, ref_lse, dout, *args, n_heads=N)
        ref_grads = A.flash_attention_bwd_ref(q, k, v, ref_out, ref_lse, dout, *args,
                                              n_heads=N)
        again = A.flash_attention_bwd(q, k, v, ref_out, ref_lse, dout, *args, n_heads=N)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError("flash_attention_bwd gave other bits on the same inputs")
        errs = {"out": rel_err(out, ref_out), "lse": rel_err(lse, ref_lse)}
        errs.update({name: rel_err(a, b)
                     for name, a, b in zip(("dq", "dk", "dv"), grads, ref_grads)})
        print(f"[kernel] flash_attention B={B} T={T} N={N} D={D} rate={rate} "
              f"kbias={bias}: err / max|value| "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
              + f" (limit {B3_TOL:.0e}); bwd twice: identical bits", flush=True)
        if not all(e <= B3_TOL for e in errs.values()):
            raise AssertionError(f"flash attention disagrees with its plain version: {errs}")
        worst_fwd = max(worst_fwd, float((out - ref_out).abs().max()),
                        float((lse - ref_lse).abs().max()))
        worst_bwd = max([worst_bwd] + [float((a - b).abs().max())
                                       for a, b in zip(grads, ref_grads)])

    # q, k, v as views whose rows start off a 16-byte boundary (a fused
    # projection one column wider, its first column dropped): B3 then stages
    # its tiles with scalar loads in place of 16-byte copies
    B, T, N, D, rate = 2, 70, 4, 32, 0.2
    g = torch.Generator().manual_seed(SEED + 7)
    wide = torch.randn(B, T, 3 * N * D + 1, generator=g).cuda()
    q, k, v = wide[..., 1:].split(N * D, dim=-1)
    dout = torch.randn(B, T, N * D, generator=g).cuda()
    args = (D ** -0.5, rate, salt, None, batch0)
    ref_out, ref_lse = A.flash_attention_ref(q, k, v, *args, n_heads=N)
    out, lse = A.flash_attention_fwd(q, k, v, *args, n_heads=N)
    grads = A.flash_attention_bwd(q, k, v, ref_out, ref_lse, dout, *args, n_heads=N)
    ref_grads = A.flash_attention_bwd_ref(q, k, v, ref_out, ref_lse, dout, *args, n_heads=N)
    torch.cuda.synchronize()
    errs = [rel_err(out, ref_out), rel_err(lse, ref_lse)]
    errs += [rel_err(a, b) for a, b in zip(grads, ref_grads)]
    print(f"[kernel] flash_attention fwd and bwd on unaligned q, k, v views B={B} T={T} "
          f"N={N} D={D}: err / max|value| out {errs[0]:.3e}, lse {errs[1]:.3e}, dq "
          f"{errs[2]:.3e}, dk {errs[3]:.3e}, dv {errs[4]:.3e} (limit {B3_TOL:.0e})",
          flush=True)
    if not all(e <= B3_TOL for e in errs):
        raise AssertionError(f"flash attention disagrees on unaligned views: {errs}")
    worst_fwd = max(worst_fwd, float((out - ref_out).abs().max()),
                    float((lse - ref_lse).abs().max()))
    worst_bwd = max([worst_bwd] + [float((a - b).abs().max())
                                   for a, b in zip(grads, ref_grads)])

    # FlashAttention (B3 fwd + B3 bwd under autograd) vs autograd through the
    # plain version
    g = torch.Generator().manual_seed(SEED)
    qkv = torch.randn(2, 130, 3 * 768, generator=g).cuda()
    dout = torch.randn(2, 130, 768, generator=g).cuda()
    grads = []
    for fn in (A.flash_attention, lambda *a, **kw: A.flash_attention_ref(*a, **kw)[0]):
        x = qkv.clone().requires_grad_()
        out = fn(*x.split(768, dim=-1), 0.125, 0.1, salt, n_heads=12)
        grads.append(torch.autograd.grad((out * dout).sum(), x)[0])
    fn_err = rel_err(*grads)
    print(f"[kernel] FlashAttention grads vs autograd through flash_attention_ref "
          f"B=2 T=130 N=12 D=64 rate=0.1: err / max|grad| {fn_err:.3e} "
          f"(limit {B3_TOL:.0e})", flush=True)
    if not fn_err <= B3_TOL:
        raise AssertionError(f"FlashAttention gradients disagree: {fn_err}")
    return worst_fwd, worst_bwd


def stft_inputs(torch, shape, seed):
    g = torch.Generator().manual_seed(seed)
    return (0.3 * torch.randn(*shape, generator=g)).cuda()


def decode_inputs(torch, S, B, T, seed, zero_carrier=False, geom=(400, 400, 160)):
    """pred (B, T, F) >= 0 and uph (B, T, 2F), F = n_fft / 2 + 1: the STFT of
    seeded noise (or all zeros: the (1, 0) carrier corner)."""
    n_fft, win, hop = geom
    g = torch.Generator().manual_seed(seed)
    pred = torch.randn(B, T, n_fft // 2 + 1, generator=g).square().cuda()
    if zero_carrier:
        return pred, torch.zeros(B, T, 2 * pred.shape[-1], device="cuda")
    # T frames need more than n_fft / 2 samples (the reflection): at T = 1 the
    # STFT's second frame is dropped
    wav = stft_inputs(torch, (B, max((T - 1) * hop, n_fft // 2 + 1)), seed + 1)
    return pred, S._stft_matmul(wav, n_fft, win, hop)[:, :T].contiguous()


def dsp_checks(torch, S, stft_mod, decode_mod):
    """B4 and B5 (each case on the route its n_fft names, each twice for
    identical bits, and B4's product kernel at the flagship geometry too)
    against their plain versions on the card, and B5's rows independent of
    their launch's batch. Returns the largest absolute errors (B4's FFT
    kernel, B5's FFT kernel, B4's product kernel, B5's product kernel)."""
    geom = (400, 400, 160)
    worst = [0.0, 0.0, 0.0, 0.0]
    cases = [((1, 160000), geom, "fft"), ((6, 2, 160000), geom, "fft"),
             ((3, 12345), geom, "fft"), ((5, 33000), geom, "fft"),
             ((2, 3, 8000), geom, "fft"),  # rows shorter than one block's span
             ((50, 12345), geom, "fft"),  # 32-frame blocks with a ragged last tile
             ((3, 5000), (256, 200, 80), "fft"),  # radices 4 4 4 2, padded window
             ((2, 9000), (512, 400, 160), "fft"),  # a power of two, padded window
             ((2, 7000), (480, 480, 160), "fft"),  # a factor 3: radices 5 3 4 4
             ((2, 3000), (240, 200, 75), "fft"),  # an odd hop
             ((2, 4000), (254, 150, 75), "product"),  # 254 = 2 * 127: no FFT plan
             ((50, 12345), (254, 150, 75), "product")]  # 64-frame blocks, ragged last tile
    for shape, (n_fft, win, hop), route in cases:
        wav = stft_inputs(torch, shape, SEED + shape[-1])
        before = dict(stft_mod.stft_fused.by_route)
        out = stft_mod.stft_fused(wav, n_fft, win, hop)
        took = [r for r, n in stft_mod.stft_fused.by_route.items() if n != before[r]]
        again = stft_mod.stft_fused(wav, n_fft, win, hop)
        ref = stft_mod.stft_fused_ref(wav, n_fft, win, hop)
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        print(f"[kernel] stft_fused {shape} n_fft={n_fft} win={win} hop={hop} -> "
              f"{tuple(out.shape)}, route {took}: err / max|value| {err:.3e} (limit "
              f"{DSP_TOL:.0e}); twice: identical bits", flush=True)
        if took != [route] or stft_mod.stft_route(n_fft) != route:
            raise AssertionError(f"stft_fused took route {took} at n_fft={n_fft}, "
                                 f"want {route!r}")
        if out.shape != ref.shape or not err <= DSP_TOL or not torch.equal(out, again):
            raise AssertionError(f"stft_fused disagrees with its plain version: {err}")
        slot = 0 if route == "fft" else 2
        worst[slot] = max(worst[slot], float((out - ref).abs().max()))
    # the product kernel at the flagship geometry, where the wrapper routes to
    # the FFT kernel: launched directly, for the comparison of the two designs
    for rows in (1, 12):
        wav = stft_inputs(torch, (rows, 10 * SR), SEED + rows)
        out = torch.empty(rows, 1001, 402, device="cuda")
        stft_mod._launch("product", wav, out, *geom)
        ref = stft_mod.stft_fused_ref(wav, *geom)
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        print(f"[kernel] stft_fused's product kernel {(rows, 10 * SR)} at the flagship "
              f"geometry (not its route there): err / max|value| {err:.3e} (limit "
              f"{DSP_TOL:.0e})", flush=True)
        if not err <= DSP_TOL:
            raise AssertionError(f"the product STFT kernel disagrees: {err}")
        worst[2] = max(worst[2], float((out - ref).abs().max()))
    # B5 at the flagship geometry (T' = 1 and 2: one block, frames outside
    # [0, T') on both sides), then at B4's other geometries and on 254
    cases = [(1, 1001, False, 2.0, geom), (6, 1001, False, 2.0, geom),
             (3, 78, False, 2.0, geom), (2, 251, False, 2.0, geom), (2, 251, True, 2.0, geom),
             (2, 78, False, 1.0, geom), (2, 78, False, 3.0, geom), (3, 1, False, 2.0, geom),
             (2, 2, False, 2.0, geom), (3, 77, False, 2.0, (256, 200, 80)),
             (2, 57, False, 2.0, (512, 400, 160)), (2, 45, False, 3.0, (480, 480, 160)),
             (2, 41, False, 2.0, (240, 200, 75)), (2, 54, False, 2.0, (254, 150, 75)),
             (2, 54, True, 1.0, (254, 150, 75))]
    for B, T, zero, power, (n_fft, win, hop) in cases:
        pred, uph = decode_inputs(torch, S, B, T, SEED + T, zero, (n_fft, win, hop))
        route = decode_mod.decode_route(n_fft)
        before = dict(decode_mod.decode_ola.by_route)
        out = decode_mod.decode_ola(pred, uph, n_fft, win, hop, linear_power=power)
        took = [r for r, n in decode_mod.decode_ola.by_route.items() if n != before[r]]
        again = decode_mod.decode_ola(pred, uph, n_fft, win, hop, linear_power=power)
        ref = decode_mod.decode_ola_ref(pred, uph, n_fft, win, hop, linear_power=power)
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        print(f"[kernel] decode_ola B={B} T'={T} n_fft={n_fft} win={win} hop={hop} "
              f"power={power} {'zero carrier' if zero else 'carrier from an STFT'} -> "
              f"{tuple(out.shape)}, route {took}: err / max|value| {err:.3e} (limit "
              f"{DSP_TOL:.0e}); twice: identical bits", flush=True)
        if took != [route] or (route == "fft") != (n_fft != 254):
            raise AssertionError(f"decode_ola took route {took} at n_fft={n_fft}, want "
                                 f"{route!r}")
        if out.shape != ref.shape or not err <= DSP_TOL or not torch.equal(out, again):
            raise AssertionError(f"decode_ola disagrees with its plain version: {err}")
        slot = 1 if route == "fft" else 3
        worst[slot] = max(worst[slot], float((out - ref).abs().max()))
    # a row's bits do not depend on how many rows share its launch (serving's
    # micro-batches): twelve rows of 10 s in one launch and each alone
    pred, uph = decode_inputs(torch, S, 12, 1001, SEED + 12)
    batch = decode_mod.decode_ola(pred, uph, *geom)
    alone = [decode_mod.decode_ola(pred[i:i + 1], uph[i:i + 1], *geom)[0] for i in range(12)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, row) for a, row in zip(alone, batch)):
        raise AssertionError("decode_ola: a row decoded alone differs from the same row in "
                             "a launch of 12")
    print("[kernel] decode_ola 12 rows of 10 s in one launch and each row alone: identical "
          "bits", flush=True)
    return worst


def fused_inputs(torch, B, T, D, H, seed):
    """xs (2, B, T, D), W_ih^T (2, D, 4H) xavier-uniform, bias (2, 4H),
    W_hh^T (2, H, 4H) orthogonal, on the card."""
    g = torch.Generator().manual_seed(seed)
    xs = torch.randn(2, B, T, D, generator=g)
    w_ih = torch.empty(2, 4 * H, D)
    w_hh = torch.empty(2, 4 * H, H)
    for d in range(2):
        torch.nn.init.xavier_uniform_(w_ih[d], generator=g)
        torch.nn.init.orthogonal_(w_hh[d], generator=g)
    bias = 0.1 * torch.randn(2, 4 * H, generator=g)
    return (xs.cuda(), w_ih.transpose(1, 2).contiguous().cuda(), bias.cuda(),
            w_hh.transpose(1, 2).contiguous().cuda())


def bb_checks(torch, L):
    """B6 and B7 against their plain versions on the card, through their
    wrappers (route ``bb_route``, read from the counters: B6 on B1's cluster
    kernel, B7 on ``lstm_bb_cluster.cu``) at ``BB_SHAPES`` /
    ``FUSED_SHAPES``: the flagship shapes, B = 256 at the flagship width, a
    batch past two blocks with a ragged last one, a narrow layer, small batch
    blocks and D that are not a multiple of 8. Each call is made again for
    identical bits, and again with ``batch_block`` 8 and 1 (``BB_BLOCKS``).
    B6 must give B1's bits. Returns the largest absolute errors (B6, B7)."""
    worst = [0.0, 0.0]
    device = torch.cuda.current_device()
    clusters = {False: L._fwd_clusters(device), True: L._fused_clusters(device)}

    def run(fn, name, args, bb, shape):
        before = dict(fn.by_route)
        outs = [fn(*args, batch_block=bb), fn(*args, batch_block=bb)]
        outs += [fn(*args, batch_block=other) for other in BB_BLOCKS]
        took = {k: v - before[k] for k, v in fn.by_route.items()}
        if took != {"cluster": 2 + len(BB_BLOCKS)}:
            raise AssertionError(f"{name} at {shape} took {took}")
        same = {"repeat": torch.equal(outs[0], outs[1])}
        same.update({f"batch_block {b}": torch.equal(outs[0], o)
                     for b, o in zip(BB_BLOCKS, outs[2:])})
        return outs[0], same

    for B, T, H, bb in BB_SHAPES:
        xw, w_hh_t = kernel_inputs(torch, B, T, H, SEED + B)
        hs, same = run(L.lstm_bidir_bb, "lstm_bidir_bb", (xw, w_hh_t), bb,
                       f"B={B} T={T} H={H}")
        ref = L.lstm_bidir_bb_ref(xw, w_hh_t)
        same["= B1"] = torch.equal(hs, L.lstm_bidir_tm(xw, w_hh_t))
        torch.cuda.synchronize()
        err = float((hs - ref).abs().max())
        print(f"[kernel] lstm_bidir_bb route 'cluster' (lstm_tm_cluster.cu) B={B} T={T} H={H} "
              f"batch_block={bb} (rows a cluster {L.bb_batch_block(B, bb, clusters[False], False)}"
              f"): max_abs_err {err:.3e} (limit {KERNEL_TOL:.0e}); identical bits: "
              f"{', '.join(same)}", flush=True)
        if not err <= KERNEL_TOL:
            raise AssertionError(f"lstm_bidir_bb disagrees with its plain version: {err}")
        if not all(same.values()):
            raise AssertionError(f"lstm_bidir_bb gave other bits: {same}")
        worst[0] = max(worst[0], err)
    for B, T, D, H, bb in FUSED_SHAPES:
        args = fused_inputs(torch, B, T, D, H, SEED + B + D)
        hs, same = run(L.lstm_bidir_fused, "lstm_bidir_fused", args, bb,
                       f"B={B} T={T} D={D} H={H}")
        ref = L.lstm_bidir_fused_ref(*args)
        torch.cuda.synchronize()
        err = float((hs - ref).abs().max())
        rows = L.bb_batch_block(B, bb, clusters[True], True)
        print(f"[kernel] lstm_bidir_fused route 'cluster' (lstm_bb_cluster.cu) B={B} T={T} "
              f"D={D} H={H} batch_block={bb} (rows a cluster {rows}, run {L.bb_run(rows)} "
              f"steps): max_abs_err {err:.3e} (limit {KERNEL_TOL:.0e}); identical bits: "
              f"{', '.join(same)}", flush=True)
        if not err <= KERNEL_TOL:
            raise AssertionError(f"lstm_bidir_fused disagrees with its plain version: {err}")
        if not all(same.values()):
            raise AssertionError(f"lstm_bidir_fused gave other bits: {same}")
        worst[1] = max(worst[1], err)
    return worst


def print_build_report(libs, build_s):
    for name, lib_path in libs.items():
        report = []
        for ln in lib_path.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in ln:
                report.append(kernel_label(ln.split("'")[1]))
            elif "registers" in ln or "spill" in ln:
                report.append(ln.replace("ptxas info    : ", "").strip())
        print(f"[build] {name}.cu -> {os.path.relpath(lib_path, ROOT)} (all "
              f"{len(libs)} sources in {build_s:.2f} s) | ptxas: {' ; '.join(report)}",
              flush=True)


def bound(flops, nbytes, peak=PEAK_F32):
    """The least time the card could take, in ms: operations over their peak
    rate (f32 outside the tensor cores unless ``peak`` says otherwise) against
    bytes over the memory rate (each input read once, each output written
    once); and which of the two binds."""
    by_ops, by_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def lstm_bound(B, T, H, products=1, extra_streams=0, D=0, peak=PEAK_F32):
    """B1 / B6: one h @ W_hh^T a step and direction, xw in, hs out.
    ``products`` 3 for the backward; ``extra_streams`` counts further
    (2, B, T, H)-sized tensors moved (cs, dhs) and, for the backward, the
    (2, B, T, 4H) dxw; ``D`` > 0 (B7) swaps the xw stream for xs and W_ih^T
    and adds the projection. ``peak=PEAK_TF32`` counts each product as three
    TF32 passes on the tensor cores (B2 bwd, whose gate and dW_hh^T products
    run there) in place of f32 FMAs."""
    flops = products * 2 * 2 * B * T * H * 4 * H + 2 * 2 * B * T * D * 4 * H
    stream = 2 * B * T * (D if D else 4 * H)
    weights = 2 * H * 4 * H + (2 * D * 4 * H + 2 * 4 * H if D else 0)
    nbytes = 4 * (stream + weights + 2 * B * T * H * (1 + extra_streams))
    if products == 3:
        nbytes += 4 * (2 * B * T * 4 * H + 2 * H * 4 * H)  # dxw and dW_hh^T out
    return bound(3 * flops if peak == PEAK_TF32 else flops, nbytes, peak)


def attention_bound(B, T, N, D, products, peak=PEAK_TF32):
    """B3: ``products`` tile products of 2 * T * T * D operations a head (2
    forward, 5 backward); q, k, v, out (and dout, dq, dk, dv) moved once.
    Each product is three TF32 passes on the tensor cores, the cheapest
    arithmetic that keeps f32 accuracy: products * 3 * 2 * B * N * T * T * D
    over the TF32 peak. ``peak=PEAK_F32`` gives the same products as f32 FMAs
    on the CUDA cores instead (the figure the forward's first design was
    held against)."""
    flops = products * 2 * B * N * T * T * D
    nbytes = 4 * ((4 if products == 2 else 9) * B * T * N * D + B * N * T)
    if peak == PEAK_F32:
        return bound(flops, nbytes)
    return bound(3 * flops, nbytes, PEAK_TF32)


def decode_bound(rows, n_frames, n_fft, hop):
    """B5 by its cheapest algorithm, an inverse FFT of each frame: the rescale
    (~8 operations a bin), the packing (~12 a point), the M-point transform
    (5 M log2 M), the window and the overlap-add a frame on the CUDA cores
    (~13 k operations at n_fft 400), against pred and the carrier in, the raw
    overlap-add and the tables out and in. Bytes bind."""
    m, k = n_fft // 2, -(-n_fft // hop)
    flops = rows * n_frames * (8 * (m + 1) + 12 * m + 5 * m * math.log2(m) + n_fft + k * hop)
    nbytes = 4 * (rows * (3 * n_frames * (m + 1) + (n_frames + k - 1) * hop) + 3 * n_fft + 2)
    return bound(flops, nbytes)


def stft_bound(rows, n_frames, n_fft, hop):
    """B4 by its cheapest algorithm, an FFT of each frame: window (n_fft),
    the n_fft / 2-point complex transform (5 M log2 M) and the split pass
    (~6 n_fft) a frame on the CUDA cores, against the samples and the tables
    in and n_fft + 2 values a frame out. Bytes bind."""
    m = n_fft // 2
    flops = rows * n_frames * (n_fft + 5 * m * math.log2(m) + 6 * n_fft)
    nbytes = 4 * (rows * ((n_frames - 1) * hop + n_frames * (n_fft + 2)) + 3 * n_fft + 2)
    return bound(flops, nbytes)


def serving_times(torch, S, stft_kernel, decode_kernel, L, card):
    """Phase 7: B4 and B5 beside the torch-op routes they replace, and the
    cuDNN ``nn.LSTM`` layer (D = 512 and 120) as the library yardstick of the
    recurrences. The torch-op routes and ``nn.LSTM`` are timed here and used
    nowhere."""
    times = {}
    geom = (400, 400, 160)
    window = torch.hann_window(400, device="cuda")
    for rows in (1, 12, 64):
        wav = stft_inputs(torch, (rows, 10 * SR), SEED)
        pred, uph = decode_inputs(torch, S, rows, 1001, SEED)
        pairs = {
            "stft_fused": (lambda: stft_kernel.stft_fused(wav, *geom),
                           lambda: stft_kernel.stft_fused_ref(wav, *geom)),
            "decode_ola": (lambda: decode_kernel.decode_ola(pred, uph, *geom),
                           lambda: decode_kernel.decode_ola_ref(pred, uph, *geom)),
        }
        for name, (kern_fn, plain_fn) in pairs.items():
            plain = cuda_ms(torch, plain_fn, iters=20, warmup=2)
            kern = cuda_ms(torch, kern_fn, iters=20, warmup=2)
            kern2 = cuda_ms(torch, kern_fn, iters=20)
            plain2 = cuda_ms(torch, plain_fn, iters=20)
            times[(name, rows)] = (min(kern, kern2), min(plain, plain2))
            print(f"[time] {name} {rows} rows of 10 s (1001 frames): kernel {kern:.4f} / "
                  f"{kern2:.4f} ms, the torch-op route it replaces (a yardstick, not a "
                  f"route) {plain:.4f} / {plain2:.4f} ms | {card}", flush=True)
        fft = cuda_ms(torch, lambda: torch.stft(wav, 400, 160, 400, window=window,
                                                return_complex=True), iters=20, warmup=2)
        times[("torch_stft", rows)] = fft
        print(f"[time] torch.stft (cuFFT; a yardstick, not a route) {rows} rows of 10 s: "
              f"{fft:.4f} ms | {card}", flush=True)
        # both of B4's kernels at this geometry, launched directly into one
        # output (no wrapper: at few rows its host work is what 20 back-to-back
        # calls measure). The product kernel's own route is an n_fft with no
        # FFT plan: here it is the design the FFT kernel replaced
        spec = torch.empty(rows, 1001, 402, device="cuda")
        direct = {route: min(cuda_ms(torch, lambda: stft_kernel._launch(route, wav, spec, *geom),
                                     iters=20, warmup=2) for _ in range(2))
                  for route in ("fft", "product")}
        times[("stft_fft_direct", rows)] = direct["fft"]
        times[("stft_product", rows)] = direct["product"]
        print(f"[time] stft_fused's kernels launched without the wrapper, {rows} rows of "
              f"10 s: the FFT kernel {direct['fft']:.4f} ms, the product kernel (not its "
              f"route at n_fft 400) {direct['product']:.4f} ms | {card}", flush=True)
        # B5's kernels the same way, the FFT kernel also with each frames-a-warp
        # it can be given (the wrapper's launch lets it pick by grid size)
        raw = torch.empty(rows, 1003 * 160, device="cuda")

        def decode(route, fpw=0):
            return lambda: decode_kernel._launch(route, pred, uph, raw, *geom, 2.0, fpw)

        for name, fn in (("decode_fft_direct", decode("fft")),
                         ("decode_product", decode("product")),
                         *((f"decode_fft_fpw{f}", decode("fft", f)) for f in (1, 2, 4))):
            times[(name, rows)] = min(cuda_ms(torch, fn, iters=20, warmup=2) for _ in range(2))
        # the library yardstick: torch.istft (cuFFT, center=True, the same
        # window) on the already-rescaled complex spectrum. It computes B5's
        # function without the rescale and with the trim and the envelope
        # division, so it is checked against the port's istft
        re, im = S._rescale_carrier(pred.sqrt(), uph, 201)
        im[..., 0] = im[..., -1] = 0.0  # an inverse real DFT reads neither
        spec = torch.complex(re, im).transpose(1, 2).contiguous()

        def library():
            return torch.istft(spec, 400, 160, 400, window=window, center=True,
                               length=1000 * 160)

        lib_err = rel_err(library(), S.istft(pred, uph, S.StftParams()))
        if not lib_err <= DSP_TOL:
            raise AssertionError(f"torch.istft differs from the port's istft: {lib_err}")
        times[("torch_istft", rows)] = min(cuda_ms(torch, library, iters=20, warmup=2)
                                           for _ in range(2))
        print(f"[time] decode_ola's kernels launched without the wrapper, {rows} rows of 10 "
              f"s: the FFT kernel {times[('decode_fft_direct', rows)]:.4f} ms (frames a warp "
              f"1 / 2 / 4: " + " / ".join(f"{times[(f'decode_fft_fpw{f}', rows)]:.4f}"
                                         for f in (1, 2, 4))
              + f"), the product kernel (not its route at n_fft 400) "
              f"{times[('decode_product', rows)]:.4f} ms; torch.istft (cuFFT; a yardstick, "
              f"not a route; without the rescale, with the envelope division; {lib_err:.1e} "
              f"of the port's istft) {times[('torch_istft', rows)]:.4f} ms | {card}",
              flush=True)

    T, H = 1001, 256
    # the library yardstick of B1 / B2 / B6 / B7: one bidirectional nn.LSTM
    # layer (cuDNN, f32, TF32 off), which computes projection and recurrence
    lstm = torch.nn.LSTM(512, H, num_layers=1, bidirectional=True, batch_first=True).cuda()
    for B in (1, 6, 64):
        x = torch.randn(B, T, 512, device="cuda")
        with torch.no_grad():
            fwd = cuda_ms(torch, lambda: lstm(x), iters=10, warmup=2)
            proj = cuda_ms(torch, lambda: torch.matmul(x, lstm.weight_ih_l0.T), iters=10,
                           warmup=2)
        times[("cudnn_fwd", B)] = (fwd, proj)
        lstm120 = torch.nn.LSTM(120, H, num_layers=1, bidirectional=True,
                                batch_first=True).cuda()
        x120 = torch.randn(B, T, 120, device="cuda")
        with torch.no_grad():
            times[("cudnn_fwd120", B)] = min(cuda_ms(torch, lambda: lstm120(x120), iters=10,
                                                     warmup=2) for _ in range(2))
        line = (f"[time] nn.LSTM (cuDNN; a yardstick, not a route) 1 bidirectional layer "
                f"D=512 H={H} T={T} B={B}: forward {fwd:.3f} ms (one direction's input "
                f"projection alone {proj:.3f} ms); at D=120 forward "
                f"{times[('cudnn_fwd120', B)]:.3f} ms")
        if B > 1:
            def step():
                lstm.zero_grad(set_to_none=True)
                out, _ = lstm(x)
                out.sum().backward()

            def fwd_train():
                return lstm(x)

            both = cuda_ms(torch, step, iters=10, warmup=2)
            fwd_t = cuda_ms(torch, fwd_train, iters=10, warmup=2)
            times[("cudnn_train", B)] = (fwd_t, both - fwd_t)
            line += (f"; under autograd forward {fwd_t:.3f} ms, forward + backward "
                     f"{both:.3f} ms")
        print(line + f" | {card}", flush=True)
    return times


def bb_times(torch, L, card):
    """Phase 7: B6 and B7 at T=1001, H=256 through their wrappers beside B1
    (B7: the projection matmul plus B1) and the plain versions, in turns forward and back (the smaller
    of the two timings is kept); B6 also at B = 256 beside B1. Returns
    {key: ms}."""
    T, H = 1001, 256
    out = {}

    def timed(fns, iters):
        runs = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                runs[k].append(cuda_ms(torch, fns[k], iters=iters[k] if isinstance(
                    iters, dict) else iters))
        return {k: min(v) for k, v in runs.items()}

    device = torch.cuda.current_device()
    for B in (1, 6, 64, 256):
        xw, w_hh_t = kernel_inputs(torch, B, T, H, SEED)
        got = timed({"b6": lambda: L.lstm_bidir_bb(xw, w_hh_t),
                     "b1": lambda: L.lstm_bidir_tm(xw, w_hh_t)}, 5)
        got["plain"] = cuda_ms(torch, lambda: L.lstm_bidir_bb_ref(xw, w_hh_t), iters=1)
        out.update({(f"bb_{k}", B): v for k, v in got.items()})
        rows = L.bb_batch_block(B, 32, L._fwd_clusters(device), False)
        print(f"[time] lstm_bidir_bb B={B} T={T} H={H} batch_block=32 (rows a cluster {rows}): "
              f"kernel {got['b6']:.3f} ms; B1 {got['b1']:.3f} ms; plain {got['plain']:.3f} ms "
              f"| {card}",
              flush=True)
        del xw
    for B in (1, 6, 64):
        for D in (120, 512):
            xs, w_ih_t, bias, w_hh_t = fused_inputs(torch, B, T, D, H, SEED)

            def tm_route():
                xw = torch.matmul(xs, w_ih_t[:, None]) + bias[:, None, None, :]
                return L.lstm_bidir_tm(xw, w_hh_t)

            got = timed({"b7": lambda: L.lstm_bidir_fused(xs, w_ih_t, bias, w_hh_t),
                         "route": tm_route}, 5)
            got["plain"] = cuda_ms(torch, lambda: L.lstm_bidir_fused_ref(xs, w_ih_t, bias,
                                                                         w_hh_t), iters=1)
            out.update({(f"fused_{k}", B, D): v for k, v in got.items()})
            rows = L.bb_batch_block(B, 32, L._fused_clusters(device), True)
            print(f"[time] lstm_bidir_fused B={B} T={T} D={D} H={H} (rows a cluster {rows}, "
                  f"run {L.bb_run(rows)} steps): kernel {got['b7']:.3f} ms; "
                  f"projection matmul + B1 {got['route']:.3f} ms; plain {got['plain']:.3f} ms "
                  f"| {card}", flush=True)
            del xs
    return out


def enhance_times(torch, build, make_enhance, card):
    """Phase 7: the B=1 10 s enhance latency under each recurrence route (the
    flagship's ``LSTMStack`` switched) and where the
    device time of each goes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wav = torch.from_numpy(np.stack([request_audio(10.0, s) for s in range(3)]))
    wavs = wav[None].cuda()
    lengths = torch.tensor([wav.shape[-1]]).cuda()
    out = {}
    for route in ("tm", "blocked", "fused"):
        pre, model = build(device="cuda", generator=torch.Generator().manual_seed(SEED))
        model.lstm.recurrence = route
        enhance = make_enhance(pre, model)
        for _ in range(3):
            enhance(wavs, lengths)
        torch.cuda.synchronize()
        lat = []
        for _ in range(20):
            t0 = time.perf_counter()
            enhance(wavs, lengths)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        out[route] = statistics.median(lat)
        print(f"[time] enhance B=1 10 s (T=1001 frames), recurrence={route!r}, fused STFT "
              f"and decode: median {out[route]:.3f} ms over 20 calls (min {min(lat):.3f}, "
              f"max {max(lat):.3f}) | {card}", flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(10):
                enhance(wavs, lengths)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / 10
        # B6 runs B1's kernel, so it is counted as B1 / B6
        shares = {"B1 / B6": 0.0, "B7": 0.0, "B4": 0.0, "B5": 0.0, "cuBLAS": 0.0, "other": 0.0}
        n_kernels = 0
        for evt in prof.events():
            if evt.device_type != DeviceType.CUDA:
                continue
            n_kernels += 1
            name = evt.name
            if "lstm_tm_cluster_kernel" in name or "lstm_bidir_tm_kernel" in name:
                key = "B1 / B6"
            elif "lstm_bb_cluster_kernel" in name:
                key = "B7"
            elif "stft_fft_kernel" in name or "stft_fused_kernel" in name:
                key = "B4"
            elif "decode_fft_kernel" in name or "decode_ola_kernel" in name:
                key = "B5"
            elif any(tag in name.lower() for tag in ("gemm", "cublas", "xmma", "cutlass")):
                key = "cuBLAS"
            else:
                key = "other"
            shares[key] += evt.time_range.elapsed_us() / 1e3 / 10
        busy = sum(shares.values())
        print(f"[time] enhance B=1 10 s, recurrence={route!r}, under torch.profiler (10 "
              f"calls): wall {wall:.3f} ms "
              f"a call, device busy {busy:.3f} ms ("
              + ", ".join(f"{k} {v:.3f} ms {v / max(busy, 1e-9):.1%}"
                          for k, v in shares.items())
              + f"), idle share {max(0.0, 1 - busy / wall):.3f}, {n_kernels / 10:.0f} device "
              f"kernels a call | {card}", flush=True)
    return out


def one_direction_slice(torch, kernels, all_kernels, dsp_kernels, card):
    """A one-direction 3 x 256 ``Residual`` head (the shape config/vcb.yaml
    ships) on the card: served through ``build_enhancer`` against the CPU, its
    B=1 10 s latency, and one train step through ``LstmBidirTm`` against the
    same step on the CPU. Returns (B1 launches of the served batch, latency
    in ms)."""
    from speech_enhancement_by_s3prl_tpu_torch.entry import (
        build,
        build_train,
        flagship_settings,
        make_enhance,
    )
    from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import save_checkpoint
    from speech_enhancement_by_s3prl_tpu_torch.runner.trainer import make_context
    from speech_enhancement_by_s3prl_tpu_torch.serve import build_enhancer

    b1 = kernels[0]
    requests = [request_audio(s, 40 + i) for i, s in enumerate(REQUEST_SECONDS)]
    with tempfile.TemporaryDirectory() as tmp:
        _, model = build(bidirectional=False, device="cpu",
                         generator=torch.Generator().manual_seed(SEED + 1))
        config, paras = flagship_settings(bidirectional=False)
        ckpt = save_checkpoint(tmp, 0, model, None, config, paras)
        gpu = build_enhancer(ckpt, device="cuda")
        cpu = build_enhancer(ckpt, device="cpu")
        # -- the main path of the one-direction head --
        reset_counts(all_kernels)
        outs = gpu.run_batch(requests)
        counts = [fn.launches for fn in all_kernels]
        # ---------------------------------------------
        served = (b1.launches, *(fn.launches for fn in dsp_kernels))
        check_b5_route(dsp_kernels[1], "the one-direction head")
        refs = cpu.run_batch(requests)
    worst = max(float(np.abs(o - r).max() / np.sqrt(np.mean(r ** 2)))
                for o, r in zip(outs, refs))
    print(f"[slice] one-direction head (Residual 3 x 256, bidirectional=False) served on "
          f"cuda: one device batch of {len(requests)} requests, launches (B1, B4, B5) "
          f"{list(served)}, no other kernel; GPU vs CPU max |diff| / output RMS {worst:.3e} "
          f"(limit {SLICE_TOL:.0e})", flush=True)
    if (served != (3, 1, 1) or sum(counts) != 5 or not worst <= SLICE_TOL or not all(
            o.shape == w.shape and np.isfinite(o).all() for o, w in zip(outs, requests))):
        raise AssertionError(f"one-direction head: launches {counts}, GPU vs CPU {worst}")

    pre, model = build(bidirectional=False, device="cuda",
                       generator=torch.Generator().manual_seed(SEED))
    enhance = make_enhance(pre, model)
    wav = torch.from_numpy(np.stack([request_audio(10.0, s) for s in range(3)]))
    wavs, lengths = wav[None].cuda(), torch.tensor([wav.shape[-1]]).cuda()
    for _ in range(3):
        enhance(wavs, lengths)
    torch.cuda.synchronize()
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        enhance(wavs, lengths)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    latency = statistics.median(lat)
    print(f"[time] enhance B=1 10 s (T=1001 frames), one-direction 3 x 256 head: median "
          f"{latency:.3f} ms over 20 calls (min {min(lat):.3f}, max {max(lat):.3f}) | {card}",
          flush=True)

    # one train step on the card vs on the CPU: the same seeded weights, one
    # batch of 6 rows of 4 s
    rng = np.random.default_rng(SEED)
    clean = np.stack([request_audio(4.0, s) for s in range(6)])
    noise = 0.05 * rng.standard_normal(clean.shape).astype(np.float32)
    wavs_np = np.stack([clean + noise, clean, noise], axis=1)
    sides = {}
    for device in ("cuda", "cpu"):
        trainer = build_train(bidirectional=False, device=device,
                              generator=torch.Generator().manual_seed(SEED))
        state = trainer.init_state()
        wavs = torch.from_numpy(wavs_np).to(device)
        lengths = torch.full((6,), wavs.shape[-1], dtype=torch.long, device=device)
        reset_counts(all_kernels)
        loss, _ = trainer.loss_fn(make_context(trainer.preprocessor, wavs, lengths, 0, 1))
        names = list(state.params)
        g = torch.autograd.grad(loss, [state.params[k] for k in names])
        flat = torch.cat([x.reshape(-1) for x in g]).double().cpu()
        state, stats = trainer.train_step(state, wavs, lengths)
        sides[device] = (float(stats["loss"]), float(stats["grad_norm"]), flat,
                         [fn.launches for fn in kernels])
    (gl, gn, gg, g_counts), (cl, cn, cg, c_counts) = sides["cuda"], sides["cpu"]
    loss_rel, norm_rel = abs(gl - cl) / abs(cl), abs(gn - cn) / abs(cn)
    grad_rel = float((gg - cg).norm() / cg.norm())
    print(f"[train] one-direction head GPU vs CPU one step (B=6, 4 s): loss {gl:.6f} vs "
          f"{cl:.6f} rel {loss_rel:.3e} (limit {TRAIN_LOSS_TOL:.0e}); grad_norm rel "
          f"{norm_rel:.3e} (limit {TRAIN_LOSS_TOL:.0e}); |g_gpu - g_cpu| / |g_cpu| "
          f"{grad_rel:.3e} (limit {TRAIN_GRAD_TOL:.0e}); launches (B1, B2 fwd, B2 bwd) of "
          f"the gradient and the step on cuda {g_counts}, on the CPU {c_counts}", flush=True)
    if g_counts != [0, 6, 6] or c_counts != [0, 0, 0]:
        raise AssertionError(f"one-direction train step: launches {g_counts} / {c_counts}")
    if not (loss_rel <= TRAIN_LOSS_TOL and norm_rel <= TRAIN_LOSS_TOL
            and grad_rel <= TRAIN_GRAD_TOL):
        raise AssertionError("the one-direction train step on the card disagrees with the "
                             "CPU")
    return served[0], latency


def upstream_slice(torch, corpus, tmp, lstm_kernels, flash_kernels):
    """Phase 6: Mockingjay through the Runner (the main path of B3), the
    card against the CPU for one step, and the upstream mode trained and
    served. Returns B3's launch counts of the Mockingjay run."""
    from speech_enhancement_by_s3prl_tpu_torch.entry import build_mockingjay_train
    from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_to_state_dict
    from speech_enhancement_by_s3prl_tpu_torch.models.transformer import SaltStream
    from speech_enhancement_by_s3prl_tpu_torch.data.datasets import OnlineDataset
    from speech_enhancement_by_s3prl_tpu_torch.run_downstream import (
        build_runner,
        get_downstream_args,
        get_parser,
    )
    from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import (
        find_resume_ckpt,
        load_checkpoint,
        optimizer_state_from_payload,
    )
    from speech_enhancement_by_s3prl_tpu_torch.runner.trainer import make_context
    from speech_enhancement_by_s3prl_tpu_torch.serve import build_enhancer

    all_kernels = lstm_kernels + flash_kernels
    fwd, bwd = flash_kernels
    expdir = os.path.join(tmp, "exp")
    config = train_config(corpus)
    config["model"] = {"Mockingjay": {}}  # the full TransformerConfig()
    config["runner"].update(total_step=MJ_STEPS, log_step=2, eval_step=2, save_step=2)
    args = get_parser().parse_args([
        "--name", "mockingjay", "--expdir", expdir, "--downstream", "Mockingjay",
        "--objective", "SISDR", "--optim", "BertAdam", "--from_waveform",
        "--dev_num", "3", "--n_jobs", "4", "--seed", str(SEED), "--device", "cuda",
    ])
    run_dir = os.path.join(expdir, "mockingjay")

    def recorded(runner):
        """Record every train step's stats and B3's launches in each eval."""
        steps, evals = [], []
        train_step, eval_step = runner.train_step, runner.builder.eval_step

        def step(state, wavs, lengths):
            state, stats = train_step(state, wavs, lengths)
            steps.append((tuple(wavs.shape), stats))
            return state, stats

        def evaluate(wavs, lengths, **kw):
            before = fwd.launches + bwd.launches
            out = eval_step(wavs, lengths, **kw)
            evals.append((tuple(wavs.shape), fwd.launches + bwd.launches - before))
            return out

        runner.train_step, runner.builder.eval_step = step, evaluate
        return steps, evals

    def check_run(steps, evals, counts, n_steps, what):
        losses = [float(st["loss"]) for _, st in steps]
        norms = [float(st["grad_norm"]) for _, st in steps]
        if len(steps) != n_steps or not all(map(math.isfinite, losses + norms)):
            raise AssertionError(f"{what}: {len(steps)} steps, losses {losses}, norms {norms}")
        if any(bool(st["skipped"]) for _, st in steps):
            raise AssertionError(f"{what}: a finite train step was skipped")
        want = [0, 0, 0, MJ_LAYERS * n_steps, MJ_LAYERS * n_steps]
        if counts != want or any(n for _, n in evals):
            raise AssertionError(
                f"{what}: launches (B1, B2 fwd, B2 bwd, B3 fwd, B3 bwd) {counts}, want "
                f"{want}; B3 launches in the eval batches {[n for _, n in evals]}")
        return losses, norms

    random.seed(SEED)
    np.random.seed(SEED)
    runner = build_runner(args, config)
    runner.set_model()
    n_params = sum(p.numel() for p in runner.downstream_model.parameters())
    steps, evals = recorded(runner)
    t0 = time.perf_counter()
    # -- the main path of B3, between the counter reset and its reading --
    reset_counts(all_kernels)
    runner.train()
    mj_counts = [fn.launches for fn in all_kernels]
    # -----------------------------------------------------------------------
    train_s = time.perf_counter() - t0
    losses, norms = check_run(steps, evals, mj_counts, MJ_STEPS, "Mockingjay")
    ckpts = ckpt_files(run_dir)
    if len(evals) != 2 or ckpts != [f"states-{MJ_STEPS}.ckpt", f"states-{MJ_STEPS + 1}.ckpt"]:
        raise AssertionError(f"Mockingjay: eval batches {evals}, checkpoints {ckpts}")
    print(f"[upstream] Mockingjay (TERA 6 x 768 x 12 heads, FFN 3072, dropout 0.1, "
          f"{n_params / 1e6:.1f} M parameters) from_waveform through Runner on cuda: "
          f"{MJ_STEPS} steps of batches {sorted({sh for sh, _ in steps})} in {train_s:.2f} s "
          f"(eval batches {[sh for sh, _ in evals]}, loader and saves included); losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; grad norms "
          f"{', '.join(f'{x:.3f}' for x in norms)}; launches B3 fwd {mj_counts[3]}, "
          f"B3 bwd {mj_counts[4]} ({MJ_LAYERS} + {MJ_LAYERS} a step, 0 in eval); "
          f"checkpoints {ckpts}", flush=True)

    args2, config2 = get_downstream_args(["--resume", run_dir, "--device", "cuda"])
    config2["runner"]["total_step"] = MJ_STEPS + MJ_RESUME_STEPS
    runner2 = build_runner(args2, config2)
    runner2.set_model()
    restored = (runner2.global_step, runner2.state.host_step,
                int(runner2.state.opt_state["count"]))
    if restored != (MJ_STEPS + 1, MJ_STEPS + 1, MJ_STEPS):
        raise AssertionError(f"Mockingjay resume restored (global step, salt step, "
                             f"optimizer count) {restored}")
    steps2, evals2 = recorded(runner2)
    reset_counts(all_kernels)
    runner2.train()
    resume_counts = [fn.launches for fn in all_kernels]
    losses2, _ = check_run(steps2, evals2, resume_counts, MJ_RESUME_STEPS, "resume")
    print(f"[upstream] Mockingjay resume: restored global step {restored[0]}, salt step "
          f"{restored[1]}, optimizer count {restored[2]}; {MJ_RESUME_STEPS} more steps, "
          f"losses {', '.join(f'{x:.4f}' for x in losses2)}, launches B3 fwd "
          f"{resume_counts[3]}, B3 bwd {resume_counts[4]}", flush=True)

    # one train step's loss and gradient on the card vs on the CPU: the last
    # checkpoint, one batch of a 4 s bucket, the same dropout salts
    payload = load_checkpoint(find_resume_ckpt(run_dir))
    fixed_set = OnlineDataset(speech={"filestrs": os.path.join(corpus, "speech")},
                              noise={"filestrs": os.path.join(corpus, "noise")},
                              max_time=4000, snrs=[0])
    lengths_np, wavs_np = fixed_set.collate_fn([fixed_set[i] for i in range(6)],
                                               pad_to=4 * SR)
    sides = {}
    for device in ("cuda", "cpu"):
        builder = build_mockingjay_train(device=device)
        builder.model.load_state_dict(flax_to_state_dict(payload["Downstream"]))
        builder.model.train()
        wavs = torch.from_numpy(wavs_np).to(device)
        lengths = torch.from_numpy(lengths_np).to(device)
        params = list(builder.model.parameters())
        loss, _ = builder.loss_fn(make_context(builder.preprocessor, wavs, lengths, 0, 1),
                                  SaltStream(SEED, 1000))
        g = torch.autograd.grad(loss, params)
        flat = torch.cat([x.reshape(-1) for x in g]).double().cpu()
        sides[device] = (float(loss.detach()), float(flat.norm()), flat)
    (gl, gn, gg), (cl, cn, cg) = sides["cuda"], sides["cpu"]
    loss_rel, norm_rel = abs(gl - cl) / abs(cl), abs(gn - cn) / abs(cn)
    grad_rel = float((gg - cg).norm() / cg.norm())
    print(f"[upstream] Mockingjay GPU vs CPU one step (B=6, 4 s bucket, dropout live, "
          f"same salts, checkpoint {os.path.basename(find_resume_ckpt(run_dir))}): loss "
          f"{gl:.6f} vs {cl:.6f} rel {loss_rel:.3e} (limit {TRAIN_LOSS_TOL:.0e}); grad "
          f"norm rel {norm_rel:.3e} (limit {TRAIN_LOSS_TOL:.0e}); |g_gpu - g_cpu| / "
          f"|g_cpu| {grad_rel:.3e} (limit {TRAIN_GRAD_TOL:.0e})", flush=True)
    if not (loss_rel <= TRAIN_LOSS_TOL and norm_rel <= TRAIN_LOSS_TOL
            and grad_rel <= TRAIN_GRAD_TOL):
        raise AssertionError("the Mockingjay step on the card disagrees with the CPU")

    # the upstream mode: a flagship-width Residual head on the hidden states
    # of a frozen, seeded full-width upstream whose dropout --dropout puts live
    up_ckpt = write_s3prl_checkpoint(torch, os.path.join(tmp, "tera-seeded.ckpt"), SEED)
    config = train_config(corpus)
    config["runner"].update(total_step=UPSTREAM_STEPS, eval_step=UPSTREAM_STEPS,
                            save_step=UPSTREAM_STEPS)
    args = get_parser().parse_args([
        "--name", "upstream", "--expdir", expdir, "--downstream", "Residual",
        "--objective", "SISDR", "--optim", "BertAdam", "--upstream", "transformer",
        "--ckpt", up_ckpt, "--dropout", "0.1", "--dev_num", "3", "--n_jobs", "4",
        "--seed", str(SEED), "--device", "cuda",
    ])
    runner = build_runner(args, config)
    runner.set_model()
    steps, evals = recorded(runner)
    reset_counts(all_kernels)
    runner.train()
    up_counts = [fn.launches for fn in all_kernels]
    up_losses = [float(st["loss"]) for _, st in steps]
    want = [3 * len(evals), 3 * UPSTREAM_STEPS, 3 * UPSTREAM_STEPS,
            MJ_LAYERS * UPSTREAM_STEPS, 0]
    if (len(steps) != UPSTREAM_STEPS or not all(map(math.isfinite, up_losses))
            or up_counts != want or any(n for _, n in evals)):
        raise AssertionError(f"upstream mode: {len(steps)} steps, losses {up_losses}, "
                             f"launches {up_counts}, want {want}")
    print(f"[upstream] upstream mode (Residual 3 x 256 BLSTM on the frozen seeded TERA, "
          f"--dropout 0.1) through Runner on cuda: {UPSTREAM_STEPS} steps, losses "
          f"{', '.join(f'{x:.4f}' for x in up_losses)}; launches (B1, B2 fwd, B2 bwd, "
          f"B3 fwd, B3 bwd) {up_counts}", flush=True)

    up_run = os.path.join(expdir, "upstream")
    gpu = build_enhancer(up_run, device="cuda")
    cpu = build_enhancer(up_run, device="cpu")
    requests = [request_audio(s, 20 + i) for i, s in enumerate((2.0, 3.7))]
    reset_counts(all_kernels)
    outs = gpu.run_batch(requests)
    serve_counts = [fn.launches for fn in all_kernels]
    worst = 0.0
    for wav, out, ref in zip(requests, outs, cpu.run_batch(requests)):
        if out.shape != wav.shape or not np.isfinite(out).all():
            raise AssertionError(f"upstream-mode serving: shape {out.shape}")
        worst = max(worst, float(np.abs(out - ref).max() / np.sqrt(np.mean(ref ** 2))))
    print(f"[upstream] upstream-mode checkpoint {os.path.basename(find_resume_ckpt(up_run))} "
          f"served on cuda: 2 requests in one device batch, launches (B1, B2 fwd, B2 bwd, "
          f"B3 fwd, B3 bwd) {serve_counts}; GPU vs CPU max |diff| / output RMS "
          f"{worst:.3e} (limit {SLICE_TOL:.0e})", flush=True)
    if serve_counts != [3, 0, 0, 0, 0] or not worst <= SLICE_TOL:
        raise AssertionError(f"upstream-mode serving: launches {serve_counts}, "
                             f"GPU vs CPU {worst}")
    return mj_counts[3], mj_counts[4]


def upstream_times(torch, A, card):
    """Phase 7, second half: B3 against its plain version and SDPA, and the
    Mockingjay train step with its profiler breakdown."""
    import torch.nn.functional as F

    from speech_enhancement_by_s3prl_tpu_torch.entry import build_mockingjay_train

    times = {}
    N, D, T, salt = 12, 64, 1001, (1, 2)
    for B in (6, 64):
        g = torch.Generator().manual_seed(SEED)
        q, k, v = torch.randn(B, T, 3 * N * D, generator=g).cuda().split(N * D, dim=-1)
        dout = torch.randn(B, T, N * D, generator=g).cuda()
        out, lse = A.flash_attention_fwd(q, k, v, 0.125, 0.1, salt, n_heads=N)
        pairs = {
            "fwd": (lambda: A.flash_attention_fwd(q, k, v, 0.125, 0.1, salt, n_heads=N),
                    lambda: A.flash_attention_ref(q, k, v, 0.125, 0.1, salt, n_heads=N)),
            "bwd": (lambda: A.flash_attention_bwd(q, k, v, out, lse, dout, 0.125, 0.1, salt,
                                                  n_heads=N),
                    lambda: A.flash_attention_bwd_ref(q, k, v, out, lse, dout, 0.125, 0.1,
                                                      salt, n_heads=N)),
        }
        for name, (kern_fn, plain_fn) in pairs.items():
            plain = cuda_ms(torch, plain_fn, iters=2)
            kern = cuda_ms(torch, kern_fn, iters=10)
            kern2 = cuda_ms(torch, kern_fn, iters=10)
            plain2 = cuda_ms(torch, plain_fn, iters=2)
            times[("b3" + name, B)] = (min(kern, kern2), min(plain, plain2))
            print(f"[time] flash_attention_{name} B={B} T={T} N={N} D={D} rate 0.1: kernel "
                  f"{kern:.3f} / {kern2:.3f} ms, plain {plain:.3f} / {plain2:.3f} ms | {card}",
                  flush=True)
        heads = [x.reshape(B, T, N, D).transpose(1, 2) for x in (q, k, v)]
        sdpa = cuda_ms(torch, lambda: F.scaled_dot_product_attention(*heads, scale=0.125), 10)
        rate0 = cuda_ms(torch, lambda: A.flash_attention_fwd(q, k, v, 0.125, 0.0, salt,
                                                            n_heads=N), 10)
        times[("b3sdpa", B)] = (rate0, sdpa)
        print(f"[time] flash_attention_fwd rate 0 vs scaled_dot_product_attention (a "
              f"yardstick, not a route) B={B} T={T}: kernel {rate0:.3f} ms, SDPA {sdpa:.3f} "
              f"ms | {card}", flush=True)
        # the library call of B3 bwd: SDPA's backward at rate 0, as forward +
        # backward minus forward under autograd (as the nn.LSTM backward is)
        out0, lse0 = A.flash_attention_fwd(q, k, v, 0.125, 0.0, salt, n_heads=N)
        bwd0 = cuda_ms(torch, lambda: A.flash_attention_bwd(q, k, v, out0, lse0, dout, 0.125,
                                                            0.0, salt, n_heads=N), 10)
        leaves = [x.detach().requires_grad_() for x in heads]
        dout_h = dout.reshape(B, T, N, D).transpose(1, 2)

        def sdpa_train():
            return F.scaled_dot_product_attention(*leaves, scale=0.125)

        def sdpa_both():
            return torch.autograd.grad(sdpa_train(), leaves, dout_h)

        both = cuda_ms(torch, sdpa_both, iters=10, warmup=2)
        fwd_t = cuda_ms(torch, sdpa_train, iters=10, warmup=2)
        times[("b3sdpa_bwd", B)] = (bwd0, both - fwd_t)
        print(f"[time] flash_attention_bwd rate 0 vs the backward of "
              f"scaled_dot_product_attention (a yardstick, not a route) B={B} T={T}: kernel "
              f"{bwd0:.3f} ms, SDPA under autograd forward {fwd_t:.3f} ms, forward + backward "
              f"{both:.3f} ms, so its backward {both - fwd_t:.3f} ms | {card}", flush=True)
        del q, k, v, dout, out, lse, heads, out0, lse0, leaves, dout_h

    builder = build_mockingjay_train(device="cuda",
                                     generator=torch.Generator().manual_seed(SEED))
    state = builder.init_state()
    rng = np.random.default_rng(SEED)
    clean = np.stack([request_audio(10.0, s) for s in range(6)])
    noise = 0.05 * rng.standard_normal(clean.shape).astype(np.float32)
    wavs = torch.from_numpy(np.stack([clean + noise, clean, noise], axis=1)).cuda()
    lengths = torch.full((6,), wavs.shape[-1], dtype=torch.long).cuda()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        state, _ = builder.train_step(state, wavs, lengths)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        state, stats = builder.train_step(state, wavs, lengths)
    torch.cuda.synchronize()
    step_mean = (time.perf_counter() - t0) * 1e3 / 10
    step_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        state, stats = builder.train_step(state, wavs, lengths)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if not math.isfinite(float(stats["loss"])):
        raise AssertionError(f"Mockingjay timing steps: loss {float(stats['loss'])}")
    print(f"[time] Mockingjay train step B=6 10 s (T=1001 frames, dropout 0.1): "
          f"{step_mean:.3f} ms a step over 10 steps with one synchronize at the end; "
          f"median {statistics.median(step_ms):.3f} ms of 10 synchronized steps (min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | {card}", flush=True)
    times["mj_step"] = (step_mean, statistics.median(step_ms))

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            state, stats = builder.train_step(state, wavs, lengths)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 5
    shares = {"B3 fwd": 0.0, "B3 bwd": 0.0, "cuBLAS": 0.0, "other": 0.0}
    other, launches = {}, 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        name = evt.name
        ms = evt.time_range.elapsed_us() / 1e3 / 5
        launches += 1
        if "flash_bwd" in name:
            key = "B3 bwd"
        elif "flash_fwd" in name:
            key = "B3 fwd"
        elif any(tag in name.lower() for tag in ("gemm", "cublas", "xmma", "cutlass")):
            key = "cuBLAS"
        else:
            key = "other"
            label = kernel_op(name)
            other[label] = other.get(label, 0.0) + ms
        shares[key] += ms
    busy = sum(shares.values())
    print(f"[time] Mockingjay train step B=6 under torch.profiler (5 steps): wall "
          f"{wall:.3f} ms a step, device busy {busy:.3f} ms ("
          + ", ".join(f"{k} {v:.3f} ms {v / max(busy, 1e-9):.1%}" for k, v in shares.items())
          + f"), idle share {max(0.0, 1 - busy / wall):.3f}, {launches / 5:.0f} device "
          f"kernels a step | {card}", flush=True)
    top = sorted(other.items(), key=lambda kv: -kv[1])[:8]
    print("[time] Mockingjay step, largest 'other' kernels (ms a step): "
          + "; ".join(f"{k} {v:.3f}" for k, v in top) + f" | {card}", flush=True)
    return times


# the scoreboard metrics, card against the CPU (metrics/__init__.py): the
# same f32 pipeline in other summation orders and other FFTs (cuFFT against
# pocketfft), as the CPU tests hold the port to the JAX package
METRIC_TOL = {"stoi": 1e-4, "estoi": 1e-4, "pesq_nb": 2e-3, "pesq_wb": 2e-3, "sisdr": 1e-4}
# the whole eval step card against CPU: the enhanced waveforms themselves
# differ by ~1e-5 of their RMS (the [slice] limit is 1e-3), which moves SI-SDR
# by ~1e-4 dB; the other scores keep their limits
EVAL_STEP_TOL = {**METRIC_TOL, "sisdr": 1e-3}
# config/vcb.yaml's eval: eval_batch_size 12, its eval_metrics, 10 s rows
VCB_EVAL_METRICS = ("stoi", "pesq_nb", "sisdr")
VCB_EVAL_BATCH = 12
# per-row delays (samples) for the delay search of the P.862 model, card
# against CPU against the delay put in; at 4 s the fine pass takes its
# 4096-sample window, at 1 s (< 20224 samples) the full-length FFT
DELAYS = (0, 37, -150, 300, -1000, 2500, 7960, -64)


def speech_like(n: int, seed: int) -> np.ndarray:
    """Aperiodic speech-like audio: a harmonic stack whose pitch wanders,
    plus shaped noise, under a syllabic envelope. Its cross-correlation has
    one clear peak, so a delay search has one answer (the battery's strictly
    periodic clean signal has near-ties a period apart)."""
    rng = np.random.default_rng(seed)
    f0 = 110 + 15 * seed + 20 * np.cumsum(rng.standard_normal(n)) / np.sqrt(n)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    x = sum(a * np.sin(k * phase) for k, a in enumerate([0.5, 0.3, 0.2, 0.1], 1))
    x = x + 0.3 * np.convolve(rng.standard_normal(n), np.hanning(9), "same")
    env = (rng.random(n // 1600 + 1) > 0.4).astype(np.float64).repeat(1600)[:n]
    x = x * np.convolve(env, np.hanning(801) / 400, "same")
    return (0.1 * x / np.abs(x).max()).astype(np.float32)


def metrics_phase(torch, M, kernels, all_kernels, dsp_kernels, card):
    """Phase 8, the scoreboard metrics on the card (``metrics/``: STOI,
    ESTOI and the P.862 model; SI-SDR):

    - the conformance battery (``metrics/battery.py``) against its pins in
      ``docs/CONFORMANCE.json`` and against the port on the CPU, and the
      delay search on speech-like rows delayed by ``DELAYS``, at 4 s and 1 s
      (both branches of the fine pass): card, CPU and the delays put in,
      equal;
    - one flagship eval batch at config/vcb.yaml's eval_batch_size (12 rows
      of up to 10 s) with its eval_metrics through the port's eval step:
      its launches of B1, B4 and B5 (the same as with SI-SDR alone), its
      scores against the same step on the CPU and against the CPU's metrics
      on the card's waveforms, its time (median of 10) beside the same batch
      scored with SI-SDR alone, and its device busy time with the metrics'
      share under ``torch.profiler``.

    TF32 is checked off whenever the metrics run. Returns a dict of the
    numbers."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from speech_enhancement_by_s3prl_tpu_torch.entry import build_train
    from speech_enhancement_by_s3prl_tpu_torch.metrics import battery as bat
    from speech_enhancement_by_s3prl_tpu_torch.metrics import pesq_model

    lstm_bidir_tm = kernels[0]
    stft_fused, decode_ola = dsp_kernels
    out = {}

    # every call of a metric family records the TF32 settings it ran under
    seen = []
    families = [(M, "si_sdr_batch"), (M, "stoi_coeff_batch"), (M, "stoi_estoi_batch"),
                (pesq_model, "pesq_batch_modes")]
    originals = [getattr(mod, name) for mod, name in families]

    def watched(fn):
        def run(*args, **kw):
            seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                         torch.get_float32_matmul_precision()))
            return fn(*args, **kw)
        return run

    for (mod, name), fn in zip(families, originals):
        setattr(mod, name, watched(fn))
    try:
        # -- the battery ----------------------------------------------------
        pairs = bat.battery()
        pins = bat.pins(os.path.join(ROOT, "docs", "CONFORMANCE.json"))
        names = ("pesq_nb", "pesq_wb", "stoi", "estoi")
        clean = torch.from_numpy(np.stack([c for _, c, _ in pairs]))
        deg = torch.from_numpy(np.stack([d for _, _, d in pairs]))
        lengths = torch.full((len(pairs),), clean.shape[-1], dtype=torch.long)
        # a caller with TF32 on: the metrics still run in full f32, and the
        # caller's settings come back
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        card_scores = M.batch_scores(names, deg.cuda(), clean.cuda(), lengths.cuda(), SR)
        restored = torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        if not restored:
            raise AssertionError("batch_scores did not restore the caller's TF32 settings")
        cpu_scores = M.batch_scores(names, deg, clean, lengths, SR)
        pin_err = {m: 0.0 for m in names}
        cpu_err = {m: 0.0 for m in names}
        for i, (name, _, _) in enumerate(pairs):
            for m in names:
                got = float(card_scores[m][i])
                pin_err[m] = max(pin_err[m], abs(got - pins[name][m]))
                cpu_err[m] = max(cpu_err[m], abs(got - float(cpu_scores[m][i])))
        pin_tol = {m: bat.PESQ_TOL if m.startswith("pesq") else bat.STOI_TOL for m in names}
        print(f"[metrics] battery ({len(pairs)} pairs of 4 s) on the card: max |card - pin| "
              + ", ".join(f"{m} {pin_err[m]:.2e} (limit {pin_tol[m]:.0e})" for m in names)
              + "; max |card - CPU| "
              + ", ".join(f"{m} {cpu_err[m]:.2e} (limit {METRIC_TOL[m]:.0e})" for m in names),
              flush=True)
        if not all(pin_err[m] < pin_tol[m] and cpu_err[m] <= METRIC_TOL[m] for m in names):
            raise AssertionError(f"battery on the card: pins {pin_err}, CPU {cpu_err}")
        out["battery_pin_err"], out["battery_cpu_err"] = pin_err, cpu_err

        delays = {}
        for seconds in (4, 1):
            n = seconds * SR
            ref = np.stack([speech_like(n, i) for i in range(len(DELAYS))])
            shifted = np.zeros_like(ref)
            for i, d in enumerate(DELAYS):
                shifted[i, max(d, 0): n + min(d, 0)] = ref[i, max(-d, 0): n - max(d, 0)]
            shifted += 0.002 * np.random.default_rng(seconds).standard_normal(ref.shape).astype(
                np.float32)
            r, s = torch.from_numpy(ref), torch.from_numpy(shifted)
            got = pesq_model._align_delay(r.cuda(), s.cuda(), SR // 2).cpu()
            want = pesq_model._align_delay(r, s, SR // 2)
            delays[seconds] = got.tolist()
            branch = "4096-sample window" if n >= 4096 + 2 * (SR // 2 + 64) else "full-length FFT"
            print(f"[metrics] delay search, {len(DELAYS)} speech-like rows of {seconds} s "
                  f"({branch} fine pass), delays put in {list(DELAYS)}: card {got.tolist()}, "
                  f"CPU {want.tolist()}", flush=True)
            if not (torch.equal(got, want) and got.tolist() == list(DELAYS)):
                raise AssertionError(f"delays on the card {got.tolist()}, CPU {want.tolist()}, "
                                     f"put in {list(DELAYS)}")
        out["battery_delays"] = delays

        # -- the flagship eval batch at config/vcb.yaml's eval ---------------
        gen = lambda: torch.Generator().manual_seed(SEED)  # noqa: E731
        builders = {dev: dataclasses.replace(build_train(device=dev, generator=gen()),
                                             eval_metrics=VCB_EVAL_METRICS)
                    for dev in ("cuda", "cpu")}
        sisdr_only = dataclasses.replace(builders["cuda"], eval_metrics=("sisdr",))
        rng = np.random.default_rng(SEED + 8)
        n = 10 * SR
        lens = np.array([n - 4000 * i for i in range(VCB_EVAL_BATCH)])
        clean_b = np.zeros((VCB_EVAL_BATCH, n), np.float32)
        for i, L_ in enumerate(lens):
            clean_b[i, :L_] = request_audio(L_ / SR, 40 + i)
        noise_b = (0.05 * rng.standard_normal(clean_b.shape)).astype(np.float32)
        noise_b *= np.arange(n)[None, :] < lens[:, None]
        wavs_np = np.stack([clean_b + noise_b, clean_b, noise_b], axis=1)
        wavs, lengths = torch.from_numpy(wavs_np).cuda(), torch.from_numpy(lens).cuda()

        sisdr_only.eval_step(wavs, lengths)  # warm
        torch.cuda.synchronize()
        # -- the main path of the metrics' eval batch --
        reset_counts(all_kernels)
        card_out = builders["cuda"].eval_step(wavs, lengths)
        counts = [lstm_bidir_tm.launches, stft_fused.launches, decode_ola.launches]
        others = [fn.launches for fn in all_kernels
                  if fn not in (lstm_bidir_tm, stft_fused, decode_ola)]
        # -----------------------------------------------------------------
        check_b5_route(decode_ola, "the metrics' eval batch")
        reset_counts(all_kernels)
        sisdr_only.eval_step(wavs, lengths)
        counts_sisdr = [lstm_bidir_tm.launches, stft_fused.launches, decode_ola.launches]
        others_sisdr = [fn.launches for fn in all_kernels
                        if fn not in (lstm_bidir_tm, stft_fused, decode_ola)]
        if counts != [3, 1, 1] or counts_sisdr != counts or any(others) or any(others_sisdr):
            raise AssertionError(f"eval batch launches (B1, B4, B5) {counts}, others {others}; "
                                 f"with SI-SDR alone {counts_sisdr}, others {others_sisdr}")
        out["launches"] = counts

        cpu_out = builders["cpu"].eval_step(wavs.cpu(), lengths.cpu())
        on_cpu = M.batch_scores(VCB_EVAL_METRICS, card_out["wav_predicted"].cpu(),
                                card_out["wav_tar"].cpu(), lengths.cpu(), SR)
        step_err, metric_err = {}, {}
        for m in VCB_EVAL_METRICS:
            got = card_out["scores"][m].cpu()
            if got.shape != (VCB_EVAL_BATCH,) or not torch.isfinite(got).all():
                raise AssertionError(f"eval batch {m}: {got}")
            step_err[m] = float((got - cpu_out["scores"][m]).abs().max())
            metric_err[m] = float((got - on_cpu[m]).abs().max())
        wav_rel = float((card_out["wav_predicted"].cpu() - cpu_out["wav_predicted"]).abs().max()
                        / cpu_out["wav_predicted"].pow(2).mean().sqrt())
        print(f"[metrics] flagship eval batch ({VCB_EVAL_BATCH} rows of "
              f"{lens.min() / SR:.2f}-{lens.max() / SR:.0f} s, config/vcb.yaml's eval_metrics "
              f"{list(VCB_EVAL_METRICS)}): launches (B1, B4, B5) {counts}, the same as with "
              f"SI-SDR alone; means "
              + ", ".join(f"{m} {float(card_out['scores'][m].mean()):.4f}"
                          for m in VCB_EVAL_METRICS)
              + "; card vs CPU eval step max |diff| "
              + ", ".join(f"{m} {step_err[m]:.2e} (limit {EVAL_STEP_TOL[m]:.0e})"
                          for m in VCB_EVAL_METRICS)
              + f" (waveforms {wav_rel:.2e} of the RMS); the CPU's metrics on the card's "
              f"waveforms max |diff| "
              + ", ".join(f"{m} {metric_err[m]:.2e} (limit {METRIC_TOL[m]:.0e})"
                          for m in VCB_EVAL_METRICS), flush=True)
        if not all(step_err[m] <= EVAL_STEP_TOL[m] and metric_err[m] <= METRIC_TOL[m]
                   for m in VCB_EVAL_METRICS):
            raise AssertionError(f"eval batch card vs CPU: step {step_err}, metrics "
                                 f"{metric_err}")
        out["step_err"], out["metric_err"] = step_err, metric_err
        del cpu_out, builders["cpu"]

        # -- times --------------------------------------------------------------
        def median_ms(fn, runs=10):
            fn()
            torch.cuda.synchronize()
            ms = []
            for _ in range(runs):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(ms), min(ms), max(ms)

        step3 = median_ms(lambda: builders["cuda"].eval_step(wavs, lengths))
        step1 = median_ms(lambda: sisdr_only.eval_step(wavs, lengths))
        wp, wt = card_out["wav_predicted"], card_out["wav_tar"]
        alone = median_ms(lambda: M.batch_scores(VCB_EVAL_METRICS, wp, wt, lengths, SR))

        def busy(fn, calls=5):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / calls
            device = [evt for evt in prof.events() if evt.device_type == DeviceType.CUDA]
            total = sum(evt.time_range.elapsed_us() for evt in device) / 1e3 / calls
            return total, wall, len(device) / calls

        busy3, wall3, k3 = busy(lambda: builders["cuda"].eval_step(wavs, lengths))
        busy1, wall1, k1 = busy(lambda: sisdr_only.eval_step(wavs, lengths))
        busy_m, wall_m, k_m = busy(lambda: M.batch_scores(VCB_EVAL_METRICS, wp, wt, lengths,
                                                          SR))
        print(f"[time] eval batch {VCB_EVAL_BATCH} x 10 s, {list(VCB_EVAL_METRICS)}: median "
              f"{step3[0]:.3f} ms of 10 (min {step3[1]:.3f}, max {step3[2]:.3f}); SI-SDR "
              f"alone: median {step1[0]:.3f} ms (min {step1[1]:.3f}, max {step1[2]:.3f}); the "
              f"metrics alone on the step's outputs: median {alone[0]:.3f} ms | {card}",
              flush=True)
        print(f"[time] eval batch {VCB_EVAL_BATCH} x 10 s under torch.profiler (5 calls each): "
              f"with {list(VCB_EVAL_METRICS)} wall {wall3:.3f} ms, device busy {busy3:.3f} ms, "
              f"idle share {max(0.0, 1 - busy3 / wall3):.3f}, {k3:.0f} device kernels a call; "
              f"SI-SDR alone wall {wall1:.3f}, busy {busy1:.3f}, {k1:.0f} kernels; the metrics "
              f"alone wall {wall_m:.3f}, busy {busy_m:.3f} ms = {busy_m / max(busy3, 1e-9):.1%} "
              f"of the step's device busy time, {k_m:.0f} kernels | {card}",
              flush=True)
        out.update(eval_ms=step3[0], eval_sisdr_ms=step1[0], metrics_ms=alone[0],
                   busy_ms=busy3, busy_sisdr_ms=busy1, metrics_busy_ms=busy_m,
                   metrics_share=busy_m / max(busy3, 1e-9), metrics_kernels=k_m)
    finally:
        for (mod, name), fn in zip(families, originals):
            setattr(mod, name, fn)
    bad = [s for s in seen if s != (False, False, "highest")]
    if not seen or bad:
        raise AssertionError(f"metrics ran {len(seen)} times, {len(bad)} of them with TF32 "
                             f"allowed: {bad[:3]}")
    print(f"[metrics] TF32 off (matmul and cuDNN, float32 matmul precision 'highest') in "
          f"each of the {len(seen)} metric calls of this phase", flush=True)
    out["metric_calls"] = len(seen)
    return out


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
    from speech_enhancement_by_s3prl_tpu_torch.data.datasets import OnlineDataset
    from speech_enhancement_by_s3prl_tpu_torch.enhance import main as enhance_cli
    from speech_enhancement_by_s3prl_tpu_torch.entry import (
        build,
        build_train,
        flagship_settings,
        make_enhance,
    )
    from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_to_state_dict
    from speech_enhancement_by_s3prl_tpu_torch.ops import stft as S
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import _build
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import attention_kernel as A
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import decode_kernel, stft_kernel
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda.lstm_kernel import (
        lstm_bidir_tm,
        lstm_bidir_tm_bwd,
        lstm_bidir_tm_bwd_ref,
        lstm_bidir_tm_fc,
        lstm_bidir_tm_fc_ref,
        lstm_bidir_tm_ref,
    )
    from speech_enhancement_by_s3prl_tpu_torch.run_downstream import (
        build_runner,
        get_downstream_args,
        get_parser,
    )
    from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import (
        find_resume_ckpt,
        load_checkpoint,
        optimizer_state_from_payload,
        save_checkpoint,
    )
    from speech_enhancement_by_s3prl_tpu_torch.runner.trainer import make_context
    from speech_enhancement_by_s3prl_tpu_torch.serve import (
        MicroBatcher,
        build_enhancer,
    )

    kernels = (lstm_bidir_tm, lstm_bidir_tm_fc, lstm_bidir_tm_bwd)
    flash_kernels = (A.flash_attention_fwd, A.flash_attention_bwd)
    stft_fused, decode_ola = stft_kernel.stft_fused, decode_kernel.decode_ola
    serve_kernels = (stft_fused, lstm_bidir_tm, L.lstm_bidir_bb, L.lstm_bidir_fused,
                     decode_ola)
    all_kernels = kernels + flash_kernels + (stft_fused, decode_ola, L.lstm_bidir_bb,
                                             L.lstm_bidir_fused)
    use_full_fp32()

    # 1. the card
    card = card_line()
    print(f"[device] {card} | {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 2. build every kernel from the sources in the checkout, in parallel
    t0 = time.perf_counter()
    libs = _build.build_all()
    for name in libs:
        _build.load(name)
    build_s = time.perf_counter() - t0
    print_build_report(libs, build_s)

    # 3. kernel against its plain version on the card
    max_err = 0.0
    # the flagship shape, a ragged one, and one past a 64-row staging chunk
    for B, T, H in ((4, 1001, 256), (3, 37, 256), (70, 37, 256)):
        xw, w_hh_t = kernel_inputs(torch, B, T, H, SEED + B)
        hs = lstm_bidir_tm(xw, w_hh_t)
        ref = lstm_bidir_tm_ref(xw, w_hh_t)
        torch.cuda.synchronize()
        err = float((hs - ref).abs().max())
        print(f"[kernel] lstm_bidir_tm route {L.fwd_route(H)!r} B={B} T={T} H={H}: "
              f"max_abs_err {err:.3e} (limit {KERNEL_TOL:.0e})", flush=True)
        if not err <= KERNEL_TOL:
            raise AssertionError(f"lstm_bidir_tm disagrees with its plain version: {err}")
        max_err = max(max_err, err)

    b2_err = {"fc": 0.0, "bwd": 0.0, "bwd_abs": 0.0}
    for B, T, H in B2_SHAPES:
        xw, w_hh_t, dhs = kernel_grad_inputs(torch, B, T, H, SEED + B)
        hs, cs = lstm_bidir_tm_fc(xw, w_hh_t)
        ref_hs, ref_cs = lstm_bidir_tm_fc_ref(xw, w_hh_t)
        dxw, dw = lstm_bidir_tm_bwd(xw, w_hh_t, hs, cs, dhs)
        again = lstm_bidir_tm_bwd(xw, w_hh_t, hs, cs, dhs)
        ref_dxw, ref_dw = lstm_bidir_tm_bwd_ref(xw, w_hh_t, ref_hs, ref_cs, dhs)
        torch.cuda.synchronize()
        if not (torch.equal(dxw, again[0]) and torch.equal(dw, again[1])):
            raise AssertionError("lstm_bidir_tm_bwd gave other bits on the same inputs")
        h_err = float((hs - ref_hs).abs().max())
        c_err = rel_err(cs, ref_cs)
        dx_err = rel_err(dxw, ref_dxw)
        dw_err = rel_err(dw, ref_dw)
        print(f"[kernel] lstm_bidir_tm_fc route {L.fwd_route(H)!r} B={B} T={T} H={H}: hs max_abs_err "
              f"{h_err:.3e} (limit {KERNEL_TOL:.0e}), cs err / max|cs| {c_err:.3e} "
              f"(limit {B2_TOL:.0e})", flush=True)
        print(f"[kernel] lstm_bidir_tm_bwd route {L.bwd_route(H)!r} B={B} T={T} H={H}: dxw "
              f"err / max|dxw| {dx_err:.3e}, dW_hh^T err / max|dW_hh^T| {dw_err:.3e} (max "
              f"{float(ref_dw.abs().max()):.3f}) (limit {B2_TOL:.0e}); twice: identical "
              f"bits", flush=True)
        if not (h_err <= KERNEL_TOL and c_err <= B2_TOL):
            raise AssertionError(f"lstm_bidir_tm_fc disagrees: hs {h_err}, cs {c_err}")
        if not (dx_err <= B2_TOL and dw_err <= B2_TOL):
            raise AssertionError(f"lstm_bidir_tm_bwd disagrees: dxw {dx_err}, dW {dw_err}")
        b2_err["fc"] = max(b2_err["fc"], h_err)
        b2_err["bwd"] = max(b2_err["bwd"], dx_err, dw_err)
        b2_err["bwd_abs"] = max(b2_err["bwd_abs"], float((dxw - ref_dxw).abs().max()),
                                float((dw - ref_dw).abs().max()))

    # LstmBidirTm (B2 fwd + B2 bwd under autograd) vs autograd through the
    # plain recurrence
    xw, w_hh_t, dhs = kernel_grad_inputs(torch, 3, 37, 256, SEED)
    grads = []
    for fn in (lstm_bidir_tm, lstm_bidir_tm_ref):
        x, w = xw.clone().requires_grad_(), w_hh_t.clone().requires_grad_()
        grads.append(torch.autograd.grad((fn(x, w) * dhs).sum(), (x, w)))
    fn_err = max(rel_err(a, b) for a, b in zip(*grads))
    print(f"[kernel] LstmBidirTm grads vs autograd through lstm_bidir_tm_ref "
          f"B=3 T=37 H=256: err / max|grad| {fn_err:.3e} (limit {B2_TOL:.0e})",
          flush=True)
    if not fn_err <= B2_TOL:
        raise AssertionError(f"LstmBidirTm gradients disagree: {fn_err}")

    fwd_routes = fwd_route_checks(torch, L)
    max_err = max(max_err, fwd_routes["cluster"][0])
    b2_err["fc"] = max(b2_err["fc"], fwd_routes["cluster"][0])
    b2_routes = bwd_route_checks(torch, L)
    b2_err["bwd"] = max(b2_err["bwd"], b2_routes["phases"][0])
    b2_err["bwd_abs"] = max(b2_err["bwd_abs"], b2_routes["phases"][1])

    b3_err = flash_checks(torch, A)
    dsp_err = dsp_checks(torch, S, stft_kernel, decode_kernel)
    bb_err = bb_checks(torch, L)

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
        reset_counts(all_kernels)
        threads = [threading.Thread(target=ask, args=(k,)) for k in range(len(requests))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
            if th.is_alive():
                raise AssertionError("a request did not finish within 600 s")
        served_launches = lstm_bidir_tm.launches
        served_routes = dict(lstm_bidir_tm.by_route)
        served_dsp = (stft_fused.launches, decode_ola.launches)
        enhance_cli(["--ckpt", ckpt, "--inputs", cli_in, "--outdir", cli_out,
                     "--device", "cuda"])
        launches = lstm_bidir_tm.launches
        dsp_launches = (stft_fused.launches, decode_ola.launches)
        # -----------------------------------------------------------------
        if (lstm_bidir_tm_fc.launches or lstm_bidir_tm_bwd.launches
                or any(fn.launches for fn in flash_kernels)
                or L.lstm_bidir_bb.launches or L.lstm_bidir_fused.launches):
            raise AssertionError("the inference path launched a training, attention or "
                                 "other-route kernel")
        check_b5_route(decode_ola, "the served requests and the CLI")
        if served_dsp != (len(batches), len(batches)) or dsp_launches != (
                len(batches) + 1, len(batches) + 1):
            raise AssertionError(
                f"(B4, B5) launches {served_dsp} for {len(batches)} served device "
                f"batches and {dsp_launches} with the CLI's one: want one each a batch")

        if served_routes != {"cluster": served_launches, "grid": 0}:
            raise AssertionError(f"B1's served launches by route: {served_routes}")
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
              f"launches B1 {launches} (3 per device batch; served by route "
              f"{served_routes}), B4 {dsp_launches[0]}, B5 "
              f"{dsp_launches[1]} (1 each per device batch; B5 by route "
              f"{decode_ola.by_route})", flush=True)

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

        # the same checkpoint under the other two recurrence routes: one
        # device batch of the four requests each
        tm_outs = gpu.run_batch(requests)
        cpu_outs = cpu.run_batch(requests)
        route_launches = {}
        for route, fn in (("blocked", L.lstm_bidir_bb), ("fused", L.lstm_bidir_fused)):
            routed = build_enhancer(ckpt, device="cuda")
            routed.model.lstm.recurrence = route
            # -- the main path of B6 / B7, between the reset and the reading --
            reset_counts(all_kernels)
            outs = routed.run_batch(requests)
            counts = [k.launches for k in serve_kernels]
            # -------------------------------------------------------------
            check_b5_route(decode_ola, f"recurrence={route!r}")
            want = [1, 0, 3 * (route == "blocked"), 3 * (route == "fused"), 1]
            vs_tm = max(float(np.abs(o - t).max() / np.sqrt(np.mean(t ** 2)))
                        for o, t in zip(outs, tm_outs))
            vs_cpu = max(float(np.abs(o - c).max() / np.sqrt(np.mean(c ** 2)))
                         for o, c in zip(outs, cpu_outs))
            print(f"[slice] recurrence={route!r}: one device batch of {len(requests)} "
                  f"requests, launches (B4, B1, B6, B7, B5) {counts}; max |diff| / output "
                  f"RMS vs the 'tm' route {vs_tm:.3e}, vs the CPU {vs_cpu:.3e} (limit "
                  f"{SLICE_TOL:.0e})", flush=True)
            if counts != want or not (vs_tm <= SLICE_TOL and vs_cpu <= SLICE_TOL) or not all(
                    o.shape == w.shape and np.isfinite(o).all()
                    for o, w in zip(outs, requests)):
                raise AssertionError(f"route {route}: launches {counts}, want {want}; vs tm "
                                     f"{vs_tm}, vs cpu {vs_cpu}")
            route_launches[route] = fn.launches
            if fn.by_route != {"cluster": 3}:
                raise AssertionError(f"route {route}: by_route {fn.by_route}")

        # the long-form entry: a request longer than the largest bucket
        long_gpu = build_enhancer(ckpt, device="cuda", max_bucket_ms=10000)
        long_cpu = build_enhancer(ckpt, device="cpu", max_bucket_ms=10000)
        long_wav = request_audio(LONG_SECONDS, 30)
        long_gpu(long_wav[: 10 * SR])  # warm
        torch.cuda.synchronize()
        # -- the main path of the long-form entry --
        reset_counts(all_kernels)
        t0 = time.perf_counter()
        long_out = long_gpu(long_wav)
        long_s = time.perf_counter() - t0
        long_counts = [k.launches for k in serve_kernels]
        # -----------------------------------------------------------------
        check_b5_route(decode_ola, "the long-form entry")
        # two more calls, timed only: one call on the host's clock can be an outlier
        long_all = [long_s]
        for _ in range(2):
            t0 = time.perf_counter()
            long_gpu(long_wav)
            long_all.append(time.perf_counter() - t0)
        long_s = sorted(long_all)[1]
        long_ref = long_cpu(long_wav)
        long_rel = float(np.abs(long_out - long_ref).max() / np.sqrt(np.mean(long_ref ** 2)))
        print(f"[slice] long-form entry: one {LONG_SECONDS:.0f} s request through "
              f"build_enhancer(max_bucket_ms=10000) in {LONG_WINDOWS} windows of 10 s with "
              f"1 s of crossfade: median {long_s * 1e3:.1f} ms of 3 calls (first "
              f"{long_all[0] * 1e3:.1f}, min {min(long_all) * 1e3:.1f}, max "
              f"{max(long_all) * 1e3:.1f}) on {card}; launches (B4, B1, B6, "
              f"B7, B5) {long_counts}; GPU vs CPU max |diff| / output RMS {long_rel:.3e} "
              f"(limit {SLICE_TOL:.0e})", flush=True)
        if (long_out.shape != long_wav.shape or not np.isfinite(long_out).all()
                or long_counts != [LONG_WINDOWS, 3 * LONG_WINDOWS, 0, 0, LONG_WINDOWS]
                or not long_rel <= SLICE_TOL):
            raise AssertionError(f"long-form entry: shape {long_out.shape}, launches "
                                 f"{long_counts}, GPU vs CPU {long_rel}")

    one_dir_launches, one_dir_ms = one_direction_slice(
        torch, kernels, all_kernels, (stft_fused, decode_ola), card)

    # 5. the training slice at full width, through the Runner
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus")
        write_corpus(corpus, SEED)
        config = train_config(corpus)
        expdir = os.path.join(tmp, "exp")
        args = get_parser().parse_args([
            "--name", "flagship", "--expdir", expdir, "--downstream", "Residual",
            "--objective", "SISDR", "--optim", "BertAdam", "--from_rawfeature",
            "--dev_num", "3", "--n_jobs", "4", "--seed", str(SEED), "--save_best",
            "--device", "cuda",
        ])
        run_dir = os.path.join(expdir, "flagship")

        def recorded(runner):
            """Record every train step's stats and every eval batch."""
            steps, evals = [], []
            train_step, eval_step = runner.train_step, runner.builder.eval_step

            def step(state, wavs, lengths):
                state, stats = train_step(state, wavs, lengths)
                steps.append((tuple(wavs.shape), stats))
                return state, stats

            def evaluate(wavs, lengths, **kw):
                evals.append(tuple(wavs.shape))
                return eval_step(wavs, lengths, **kw)

            runner.train_step, runner.builder.eval_step = step, evaluate
            return steps, evals

        random.seed(SEED)
        np.random.seed(SEED)
        runner = build_runner(args, config)
        runner.set_model()
        steps, evals = recorded(runner)
        t0 = time.perf_counter()
        # -- the main path, between the counter reset and its reading --
        reset_counts(all_kernels)
        runner.train()
        train_counts = [fn.launches for fn in kernels]
        train_dsp = (stft_fused.launches, decode_ola.launches)
        train_routes = [dict(fn.by_route) for fn in kernels]
        # -----------------------------------------------------------------
        check_b5_route(decode_ola, "the flagship's training and eval")
        if [r["grid"] for r in train_routes] != [0, 0, 0]:
            raise AssertionError(f"the flagship's training took a grid route: {train_routes}")
        if any(fn.launches for fn in flash_kernels + (L.lstm_bidir_bb, L.lstm_bidir_fused)):
            raise AssertionError("the flagship's training launched an attention or "
                                 "other-route kernel")
        train_s = time.perf_counter() - t0
        losses = [float(st["loss"]) for _, st in steps]
        norms = [float(st["grad_norm"]) for _, st in steps]
        if len(steps) != TRAIN_STEPS or not all(map(math.isfinite, losses + norms)):
            raise AssertionError(f"{len(steps)} train steps, losses {losses}, norms {norms}")
        if any(bool(st["skipped"]) for _, st in steps):
            raise AssertionError("a finite train step was skipped")
        want = [3 * len(evals), 3 * TRAIN_STEPS, 3 * TRAIN_STEPS]
        if train_counts != want or len(evals) != 2:
            raise AssertionError(
                f"launches (B1, B2 fwd, B2 bwd) {train_counts} for {TRAIN_STEPS} train "
                f"steps and {len(evals)} eval batches of a 3-layer model; want {want}"
            )
        # B4 frames both channels of every train and eval batch in one launch;
        # B5 decodes only where no gradient is taken: the eval batches
        if train_dsp != (TRAIN_STEPS + len(evals), len(evals)):
            raise AssertionError(
                f"launches (B4, B5) {train_dsp} for {TRAIN_STEPS} train steps and "
                f"{len(evals)} eval batches; want {(TRAIN_STEPS + len(evals), len(evals))}")
        ckpts = ckpt_files(run_dir)
        if ckpts != ["states-8.ckpt", "states-9.ckpt"]:
            raise AssertionError(f"checkpoints after max_keep 2 rotation: {ckpts}")
        scalars = [json.loads(ln) for ln in open(os.path.join(run_dir, "scalars.jsonl"))]
        tags = {sc["tag"] for sc in scalars}
        if not {"loss", "gradient norm", "steps_per_sec", "dev_loss", "dev_sisdr"} <= tags:
            raise AssertionError(f"scalars.jsonl tags {sorted(tags)}")
        print(f"[train] flagship (3 BLSTM layers of 256, 120-d input, Dense 512->201) "
              f"through Runner on cuda: {TRAIN_STEPS} steps of batches "
              f"{sorted({sh for sh, _ in steps})} in {train_s:.2f} s (eval batches "
              f"{evals}, loader and saves included); losses "
              f"{', '.join(f'{x:.4f}' for x in losses)}; grad norms "
              f"{', '.join(f'{x:.3f}' for x in norms)}; launches B1 {train_counts[0]}, "
              f"B2 fwd {train_counts[1]}, B2 bwd {train_counts[2]} (3 B2 fwd + 3 B2 bwd "
              f"a step, 3 B1 an eval batch; by route {train_routes}), B4 {train_dsp[0]} "
              f"(1 a step and an eval "
              f"batch), B5 {train_dsp[1]} (1 an eval batch, 0 a step); checkpoints {ckpts}",
              flush=True)

        # resume from the last checkpoint for RESUME_STEPS more steps
        resume_from = os.path.basename(find_resume_ckpt(run_dir))
        args2, config2 = get_downstream_args(["--resume", run_dir, "--device", "cuda"])
        config2["runner"]["total_step"] = TRAIN_STEPS + RESUME_STEPS
        runner2 = build_runner(args2, config2)
        runner2.set_model()
        restored = (runner2.global_step, int(runner2.state.step),
                    int(runner2.state.opt_state["count"]))
        last = load_checkpoint(find_resume_ckpt(run_dir))
        same = all(torch.equal(p.detach().cpu(), last_p) for (_, p), last_p in zip(
            sorted(runner2.state.params.items()),
            [v for _, v in sorted(flax_to_state_dict(last["Downstream"]).items())]))
        if restored != (TRAIN_STEPS + 1, TRAIN_STEPS + 1, TRAIN_STEPS) or not same:
            raise AssertionError(f"resume restored (global step, state step, optimizer "
                                 f"count) {restored}, weights equal {same}")
        steps2, evals2 = recorded(runner2)
        reset_counts(all_kernels)
        runner2.train()
        resume_counts = [fn.launches for fn in kernels]
        count2 = int(runner2.state.opt_state["count"])
        if (len(steps2) != RESUME_STEPS or count2 != TRAIN_STEPS + RESUME_STEPS
                or resume_counts != [0, 3 * RESUME_STEPS, 3 * RESUME_STEPS]
                or not all(math.isfinite(float(st["loss"])) for _, st in steps2)):
            raise AssertionError(f"resume: {len(steps2)} steps, optimizer count "
                                 f"{count2}, launches {resume_counts}")
        final = ckpt_files(run_dir)
        losses2 = ", ".join(f"{float(st['loss']):.4f}" for _, st in steps2)
        print(f"[train] resume from {resume_from}: "
              f"restored global step {restored[0]} and optimizer count {restored[2]}, "
              f"weights equal; {RESUME_STEPS} more steps, losses "
              f"{', '.join(f'{float(st[1]['loss']):.4f}' for st in steps2)}, optimizer "
              f"count {count2}, launches {resume_counts}; checkpoints {final}", flush=True)

        # one train step on the card vs on the CPU, same checkpoint and batch
        ckpt = os.path.join(run_dir, final[-1])
        payload = load_checkpoint(ckpt)
        bucket = 4 * SR
        fixed_set = OnlineDataset(speech={"filestrs": os.path.join(corpus, "speech")},
                                  noise={"filestrs": os.path.join(corpus, "noise")},
                                  max_time=4000, snrs=[0])
        lengths_np, wavs_np = fixed_set.collate_fn([fixed_set[i] for i in range(6)],
                                                   pad_to=bucket)
        sides = {}
        for device in ("cuda", "cpu"):
            builder = build_train(device=device, generator=torch.Generator().manual_seed(0))
            builder.model.load_state_dict(flax_to_state_dict(payload["Downstream"]))
            state = builder.init_state()
            state.opt_state = optimizer_state_from_payload(payload["Optimizer"], device)
            wavs = torch.from_numpy(wavs_np).to(device)
            lengths = torch.from_numpy(lengths_np).to(device)
            ctx_loss, _ = builder.loss_fn(
                make_context(builder.preprocessor, wavs, lengths, 0, 1))
            names = list(state.params)
            g = torch.autograd.grad(ctx_loss, [state.params[k] for k in names])
            flat = torch.cat([x.reshape(-1) for x in g]).double().cpu()
            state, stats = builder.train_step(state, wavs, lengths)
            sides[device] = (float(stats["loss"]), float(stats["grad_norm"]), flat,
                             builder, state, wavs, lengths)
        (gl, gn, gg, builder, state, wavs, lengths), (cl, cn, cg, *_) = (
            sides["cuda"], sides["cpu"])
        loss_rel = abs(gl - cl) / abs(cl)
        norm_rel = abs(gn - cn) / abs(cn)
        grad_rel = float((gg - cg).norm() / cg.norm())
        print(f"[train] GPU vs CPU one step (B=6, 4 s bucket, checkpoint "
              f"{os.path.basename(ckpt)}): loss {gl:.6f} vs {cl:.6f} rel {loss_rel:.3e} "
              f"(limit {TRAIN_LOSS_TOL:.0e}); grad_norm rel {norm_rel:.3e} (limit "
              f"{TRAIN_LOSS_TOL:.0e}); |g_gpu - g_cpu| / |g_cpu| {grad_rel:.3e} (limit "
              f"{TRAIN_GRAD_TOL:.0e})", flush=True)
        if not (loss_rel <= TRAIN_LOSS_TOL and norm_rel <= TRAIN_LOSS_TOL
                and grad_rel <= TRAIN_GRAD_TOL):
            raise AssertionError("the train step on the card disagrees with the CPU")

        # a NaN-poisoned batch: skipped, parameters and optimizer state kept
        before = {k: p.detach().clone() for k, p in state.params.items()}
        count_before, step_before = int(state.opt_state["count"]), int(state.step)
        poisoned = wavs.clone()
        poisoned[0, 0, 1000] = float("nan")
        state, stats = builder.train_step(state, poisoned, lengths)
        kept = all(torch.equal(before[k], p) for k, p in state.params.items())
        if not (bool(stats["skipped"]) and kept and int(state.step) == step_before + 1
                and int(state.opt_state["count"]) == count_before):
            raise AssertionError(
                f"NaN step: skipped {bool(stats['skipped'])}, parameters kept {kept}, "
                f"step {int(state.step)} (was {step_before}), optimizer count "
                f"{int(state.opt_state['count'])} (was {count_before})")
        print(f"[train] NaN-poisoned batch on the card: grad_norm "
              f"{float(stats['grad_norm'])}, skipped; all {len(before)} parameters "
              f"bit-identical, optimizer count kept at {count_before}, step "
              f"{step_before} -> {int(state.step)}", flush=True)

        # 6. the upstream slice at full width, on the same corpus
        del builder, state, sides, before
        mj_launches = upstream_slice(torch, corpus, tmp, kernels, flash_kernels)

    # 7. times on the card
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

    times.update(fwd_times(torch, L, card))
    enhance_ms = enhance_times(torch, build, make_enhance, card)
    times.update(serving_times(torch, S, stft_kernel, decode_kernel, L, card))
    times.update(bb_times(torch, L, card))

    for B in (6, 64):
        xw, w_hh_t, dhs = kernel_grad_inputs(torch, B, 1001, 256, SEED)
        hs, cs = lstm_bidir_tm_fc(xw, w_hh_t)
        pairs = {
            "fc": (lambda: lstm_bidir_tm_fc(xw, w_hh_t),
                   lambda: lstm_bidir_tm_fc_ref(xw, w_hh_t)),
            "bwd": (lambda: lstm_bidir_tm_bwd(xw, w_hh_t, hs, cs, dhs),
                    lambda: lstm_bidir_tm_bwd_ref(xw, w_hh_t, hs, cs, dhs)),
        }
        for name, (kern_fn, plain_fn) in pairs.items():
            plain = cuda_ms(torch, plain_fn, iters=2)
            kern = cuda_ms(torch, kern_fn, iters=10)
            kern2 = cuda_ms(torch, kern_fn, iters=10)
            plain2 = cuda_ms(torch, plain_fn, iters=2)
            times[(name, B)] = (min(kern, kern2), min(plain, plain2))
            print(f"[time] lstm_bidir_tm_{name} B={B} T=1001 H=256: kernel {kern:.3f} / "
                  f"{kern2:.3f} ms, plain {plain:.3f} / {plain2:.3f} ms | {card}",
                  flush=True)
        times[("bwd_phases", B)] = bwd_phase_times(torch, L, (xw, w_hh_t, hs, cs, dhs), B,
                                                   card)

    # the dh chain where its clusters of 8 rows no longer all run at once: 14
    # rows of clusters (B = 56, two directions) against 16 (B = 64, above)
    tensors = kernel_grad_inputs(torch, 56, 1001, 256, SEED)
    times[("bwd_phases", 56)] = bwd_phase_times(
        torch, L, (*tensors[:2], *lstm_bidir_tm_fc(*tensors[:2]), tensors[2]), 56, card)
    del tensors

    # the flagship train step and eval batch at B=6, a 10 s bucket
    builder = build_train(device="cuda", generator=torch.Generator().manual_seed(SEED))
    state = builder.init_state()
    rng = np.random.default_rng(SEED)
    clean = np.stack([request_audio(10.0, s) for s in range(6)])
    noise = 0.05 * rng.standard_normal(clean.shape).astype(np.float32)
    wavs = torch.from_numpy(np.stack([clean + noise, clean, noise], axis=1)).cuda()
    lengths = torch.full((6,), wavs.shape[-1], dtype=torch.long).cuda()
    for _ in range(3):
        state, _ = builder.train_step(state, wavs, lengths)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        state, stats = builder.train_step(state, wavs, lengths)
    torch.cuda.synchronize()
    step_mean = (time.perf_counter() - t0) * 1e3 / 10
    step_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        state, stats = builder.train_step(state, wavs, lengths)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    eval_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        builder.eval_step(wavs, lengths, wav_out="first")
        torch.cuda.synchronize()
        eval_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[time] flagship train step B=6 10 s (T=1001 frames): {step_mean:.3f} ms a "
          f"step over 10 steps with one synchronize at the end; median "
          f"{statistics.median(step_ms):.3f} ms of 10 synchronized steps (min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}) | {card}", flush=True)
    print(f"[time] flagship eval batch B=6 10 s: median {statistics.median(eval_ms):.3f} "
          f"ms of 10 (min {min(eval_ms):.3f}, max {max(eval_ms):.3f}) | {card}",
          flush=True)

    # where a train step's device time goes
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            state, stats = builder.train_step(state, wavs, lengths)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 5
    # device-side events only: a kernel launched through ctypes inside an
    # autograd function also shows as "self" device time of its CPU-side op
    from torch.autograd import DeviceType

    shares = {"B2 fwd": 0.0, "B2 bwd": 0.0, "cuBLAS": 0.0, "other": 0.0}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        name = evt.name
        if "lstm_bwd_" in name or "lstm_bidir_tm_bwd_kernel" in name:
            key = "B2 bwd"  # the three phases (or the earlier single kernel)
        elif "lstm_tm_cluster_kernel" in name or "lstm_bidir_tm_kernel" in name:
            key = "B2 fwd"
        elif any(tag in name.lower() for tag in ("gemm", "cublas", "xmma", "cutlass")):
            key = "cuBLAS"
        else:
            key = "other"
        shares[key] += evt.time_range.elapsed_us() / 1e3 / 5
    busy = sum(shares.values())
    print(f"[time] train step B=6 under torch.profiler (5 steps): wall {wall:.3f} ms a "
          f"step, device busy {busy:.3f} ms ("
          + ", ".join(f"{k} {v:.3f} ms {v / max(busy, 1e-9):.1%}" for k, v in shares.items())
          + f"), idle share {max(0.0, 1 - busy / wall):.3f} | {card}", flush=True)
    if not (shares["B2 fwd"] > 0.0 and shares["B2 bwd"] > 0.0):
        raise AssertionError(f"the profiler attributed no time to a recurrence kernel: "
                             f"{shares}")
    del builder, state
    times.update(upstream_times(torch, A, card))

    # 8. the scoreboard metrics on the card
    from speech_enhancement_by_s3prl_tpu_torch import metrics as M

    metric_nums = metrics_phase(torch, M, kernels, all_kernels, (stft_fused, decode_ola), card)

    pallas = "speech_enhancement_by_s3prl_tpu/ops/pallas/"
    csrc = "speech_enhancement_by_s3prl_tpu_torch/csrc/"
    T, H = 1001, 256
    cudnn = {B: times[("cudnn_fwd", B)][0] for B in (1, 6, 64)}

    def fwd_route_fields(prefix):
        """B1 / B2 fwd (``prefix`` "fc_"): the route taken, the grid route's
        source, errors and times, B6 beside them, and the time a step."""
        fields = {"kernel_route": "cluster (H a multiple of 8, at most 256)",
                  "grid_route": "any other H; timed here at H=256, launched directly",
                  "grid_source": csrc + "lstm_tm.cu",
                  "grid_max_abs_err": fwd_routes["grid"][0]}
        for B, sfx in ((1, ""), (6, "_b6"), (64, "_b64")):
            fields[f"grid_ms{sfx}"] = times[(prefix + "grid", B)]
            fields[f"b6_ms{sfx}"] = times[("b6", B)]
            fields[f"step_us{sfx}"] = times[(prefix + "cluster", B)] * 1e3 / T
        return fields

    def row(name, source, replaces, launches, err, ms, plain_ms, shape, bound_, library_ms,
            **more):
        return {"name": name, "route": "cuda", "source": csrc + source,
                "replaces": pallas + replaces, "launches": launches, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_[0], "bound_by": bound_[1],
                "library_ms": library_ms, "shape": shape,
                "kernel_route": more.pop("kernel_route", "one design"), **more}

    # every bound is worked out from the shape named beside it, by the cheapest
    # arithmetic the numerics allow (f32 FMAs; three TF32 passes a product for
    # B3; an FFT for B4 and B5, so bytes bind them); library_ms is
    # one bidirectional nn.LSTM layer (cuDNN, projection included) for the
    # recurrences, scaled_dot_product_attention and its backward at rate 0 for
    # B3, torch.stft (cuFFT) for B4, and torch.istft (cuFFT) on the rescaled
    # spectrum for B5; none of them is a route of the port
    rows = [
        row("lstm_bidir_tm", "lstm_tm_cluster.cu", "lstm_kernel.py:208", launches, max_err,
            times[1][0], times[1][1], "B=1 T=1001 H=256", lstm_bound(1, T, H), cudnn[1],
            launches_train_eval=train_counts[0], launches_long_form=long_counts[1],
            launches_metrics_eval=metric_nums["launches"][0],
            launches_one_direction=one_dir_launches, one_direction_enhance_ms=one_dir_ms,
            ms_b64=times[64][0], plain_ms_b64=times[64][1],
            bound_ms_b64=lstm_bound(64, T, H)[0], library_ms_b64=cudnn[64],
            ms_b6=times[("cluster", 6)], bound_ms_b6=lstm_bound(6, T, H)[0],
            **fwd_route_fields(""), **{f"{name.replace(' ', '_')}_ms{sfx}": times[(name, B)]
                                       for B, sfx in ((1, ""), (6, "_b6"), (64, "_b64"))
                                       for name in (*L.FWD_VARIANTS, "fewest clusters")
                                       if (name, B) in times}),
        row("lstm_bidir_tm_fc", "lstm_tm_cluster.cu", "lstm_kernel.py:391", train_counts[1],
            b2_err["fc"], times[("fc", 6)][0], times[("fc", 6)][1], "B=6 T=1001 H=256",
            lstm_bound(6, T, H, extra_streams=1), times[("cudnn_train", 6)][0],
            ms_b64=times[("fc", 64)][0], plain_ms_b64=times[("fc", 64)][1],
            bound_ms_b64=lstm_bound(64, T, H, extra_streams=1)[0],
            library_ms_b64=times[("cudnn_train", 64)][0], ms_b1=times[("fc_cluster", 1)],
            bound_ms_b1=lstm_bound(1, T, H, extra_streams=1)[0],
            max_rel_err_cs=fwd_routes["cluster"][1], **fwd_route_fields("fc_")),
        row("lstm_bidir_tm_bwd", "lstm_tm_bwd.cu", "lstm_kernel.py:422", train_counts[2],
            b2_err["bwd_abs"], times[("bwd", 6)][0], times[("bwd", 6)][1],
            "B=6 T=1001 H=256",
            lstm_bound(6, T, H, products=3, extra_streams=3, peak=PEAK_TF32),
            times[("cudnn_train", 6)][1], max_rel_err=b2_err["bwd"],
            ms_b64=times[("bwd", 64)][0], plain_ms_b64=times[("bwd", 64)][1],
            bound_ms_b64=lstm_bound(64, T, H, products=3, extra_streams=3,
                                    peak=PEAK_TF32)[0],
            bound_ms_f32_fma=lstm_bound(6, T, H, products=3, extra_streams=3)[0],
            bound_ms_f32_fma_b64=lstm_bound(64, T, H, products=3, extra_streams=3)[0],
            library_ms_b64=times[("cudnn_train", 64)][1],
            kernel_route="phases (H a multiple of 8, at most 256)",
            grid_route="any other H; timed here at H=256, launched directly",
            grid_max_rel_err=b2_routes["grid"][0], grid_max_abs_err=b2_routes["grid"][1],
            **{f"{key}_ms{sfx}": times[("bwd_phases", B)][key]
               for B, sfx in ((6, ""), (56, "_b56"), (64, "_b64"))
               for key in ("phases", "grid", "gates", "chain", "dw")}),
        row("flash_attention_fwd", "flash_attn.cu", "attention_kernel.py:277",
            mj_launches[0], b3_err[0], times[("b3fwd", 6)][0], times[("b3fwd", 6)][1],
            "B=6 T=1001 N=12 D=64 rate 0.1", attention_bound(6, T, 12, 64, 2),
            times[("b3sdpa", 6)][1], ms_b64=times[("b3fwd", 64)][0],
            plain_ms_b64=times[("b3fwd", 64)][1],
            bound_ms_b64=attention_bound(64, T, 12, 64, 2)[0],
            bound_ms_f32_fma=attention_bound(6, T, 12, 64, 2, PEAK_F32)[0],
            bound_ms_f32_fma_b64=attention_bound(64, T, 12, 64, 2, PEAK_F32)[0],
            library_ms_b64=times[("b3sdpa", 64)][1],
            rate0_ms=times[("b3sdpa", 6)][0], rate0_ms_b64=times[("b3sdpa", 64)][0]),
        row("flash_attention_bwd", "flash_attn_bwd.cu", "attention_kernel.py:314",
            mj_launches[1], b3_err[1], times[("b3bwd", 6)][0], times[("b3bwd", 6)][1],
            "B=6 T=1001 N=12 D=64 rate 0.1", attention_bound(6, T, 12, 64, 5),
            times[("b3sdpa_bwd", 6)][1], ms_b64=times[("b3bwd", 64)][0],
            plain_ms_b64=times[("b3bwd", 64)][1],
            bound_ms_b64=attention_bound(64, T, 12, 64, 5)[0],
            library_ms_b64=times[("b3sdpa_bwd", 64)][1],
            rate0_ms=times[("b3sdpa_bwd", 6)][0], rate0_ms_b64=times[("b3sdpa_bwd", 64)][0]),
    ]
    # B4 at 1 / 12 / 64 rows of 10 s: the FFT kernel (its route at n_fft 400),
    # with the product kernel's times at the same shapes beside it
    dsp_shape = "1 row of 10 s (1001 frames), n_fft 400, hop 160"
    rows.append(row(
        "stft_fused", "stft_fft.cu", "stft_kernel.py:70", dsp_launches[0], dsp_err[0],
        times[("stft_fused", 1)][0], times[("stft_fused", 1)][1], dsp_shape,
        stft_bound(1, 1001, 400, 160), times[("torch_stft", 1)],
        launches_train_eval=train_dsp[0], launches_long_form=long_counts[0],
        launches_metrics_eval=metric_nums["launches"][1],
        kernel_route="fft (n_fft / 2 factors into 2, 3, 4, 5)",
        product_source=csrc + "stft_fused.cu", product_max_abs_err=dsp_err[2],
        product_route="an n_fft with no FFT plan; timed here at n_fft 400",
        product_ms=times[("stft_product", 1)], direct_ms=times[("stft_fft_direct", 1)],
        **{f"{key}_rows{n}": val for n in (12, 64) for key, val in (
            ("ms", times[("stft_fused", n)][0]), ("plain_ms", times[("stft_fused", n)][1]),
            ("library_ms", times[("torch_stft", n)]),
            ("product_ms", times[("stft_product", n)]),
            ("direct_ms", times[("stft_fft_direct", n)]),
            ("bound_ms", stft_bound(n, 1001, 400, 160)[0]))}))
    # B5 at 1 / 12 / 64 rows of 10 s: the inverse-FFT kernel (its route at
    # n_fft 400), bound by bytes; beside it the product kernel's times and
    # its bound as f32 FMAs (the product over the K * 2F rescaled spectra of
    # an output hop-row, which bound that design)
    flops_row, bytes_row = 2 * 1001 * 402 * 400, 4 * (1001 * 201 + 1001 * 402 + 1003 * 160)
    matrix = 4 * 400 * 402
    rows.append(row(
        "decode_ola", "decode_fft.cu", "decode_kernel.py:120", dsp_launches[1], dsp_err[1],
        times[("decode_ola", 1)][0], times[("decode_ola", 1)][1], dsp_shape,
        decode_bound(1, 1001, 400, 160), times[("torch_istft", 1)],
        launches_train_eval=train_dsp[1], launches_long_form=long_counts[4],
        launches_metrics_eval=metric_nums["launches"][2],
        kernel_route="fft (n_fft / 2 factors into 2, 3, 4, 5)",
        product_source=csrc + "decode_ola.cu", product_max_abs_err=dsp_err[3],
        product_route="an n_fft with no FFT plan; timed here at n_fft 400",
        product_ms=times[("decode_product", 1)], direct_ms=times[("decode_fft_direct", 1)],
        bound_ms_product=bound(flops_row, bytes_row + matrix)[0],
        **{f"fpw{f}_ms": times[(f"decode_fft_fpw{f}", 1)] for f in (1, 2, 4)},
        **{f"{key}_rows{n}": val for n in (12, 64) for key, val in (
            ("ms", times[("decode_ola", n)][0]), ("plain_ms", times[("decode_ola", n)][1]),
            ("library_ms", times[("torch_istft", n)]),
            ("product_ms", times[("decode_product", n)]),
            ("direct_ms", times[("decode_fft_direct", n)]),
            *((f"fpw{f}_ms", times[(f"decode_fft_fpw{f}", n)]) for f in (1, 2, 4)),
            ("bound_ms", decode_bound(n, 1001, 400, 160)[0]),
            ("bound_ms_product", bound(n * flops_row, n * bytes_row + matrix)[0]))}))
    # B6 (on B1's lstm_tm_cluster.cu) and B7 (lstm_bb_cluster.cu), bound by
    # three TF32 passes a product on the tensor cores (the cheapest arithmetic
    # that keeps f32 accuracy), the bound as f32 FMAs beside it
    rows.append(row(
        "lstm_bidir_bb", "lstm_tm_cluster.cu", "lstm_kernel.py:629", route_launches["blocked"],
        bb_err[0], times[("bb_b6", 1)], times[("bb_plain", 1)],
        "B=1 T=1001 H=256 batch_block=32", lstm_bound(1, T, H, peak=PEAK_TF32), cudnn[1],
        kernel_route="cluster (H a multiple of 8, at most 256): B1's cluster kernel",
        bound_ms_f32_fma=lstm_bound(1, T, H)[0],
        **{f"{key}{sfx}": val for B, sfx in ((1, ""), (6, "_b6"), (64, "_b64"), (256, "_b256"))
           for key, val in (("ms", times[("bb_b6", B)]), ("plain_ms", times[("bb_plain", B)]),
                            ("b1_ms", times[("bb_b1", B)]),
                            ("bound_ms", lstm_bound(B, T, H, peak=PEAK_TF32)[0]),
                            ("bound_ms_f32_fma", lstm_bound(B, T, H)[0]),
                            ("library_ms", cudnn.get(B)))
           if not (sfx == "" and key in ("ms", "plain_ms", "bound_ms", "library_ms",
                                         "bound_ms_f32_fma"))}))
    rows.append(row(
        "lstm_bidir_fused", "lstm_bb_cluster.cu", "lstm_kernel.py:101", route_launches["fused"],
        bb_err[1], times[("fused_b7", 1, 512)], times[("fused_plain", 1, 512)],
        "B=1 T=1001 D=512 H=256 batch_block=32", lstm_bound(1, T, H, D=512, peak=PEAK_TF32),
        cudnn[1],
        kernel_route="cluster (H a multiple of 8, at most 256; any D); projection a run "
                     "ahead on the tensor cores, step product on FMAs",
        **{f"{key}_b{B}_d{D}": val for B in (1, 6, 64) for D in (120, 512)
           for key, val in (("ms", times[("fused_b7", B, D)]),
                            ("plain_ms", times[("fused_plain", B, D)]),
                            ("projection_plus_b1_ms", times[("fused_route", B, D)]),
                            ("bound_ms", lstm_bound(B, T, H, D=D, peak=PEAK_TF32)[0]),
                            ("bound_ms_f32_fma", lstm_bound(B, T, H, D=D)[0]),
                            ("library_ms", times[("cudnn_fwd", B)][0] if D == 512
                             else times[("cudnn_fwd120", B)]))}))
    # once more, for a reader who is shown only the end of a long output
    print_build_report(libs, build_s)
    for r in rows:
        print(f"[bound] {r['name']} at {r['shape']}: {r['ms']:.4f} ms on the card, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}, plain {r['plain_ms']:.3f} ms, "
              f"library call "
              + (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None else "none")
              + f", {r['launches']} launches on its main path | {card}", flush=True)
    print(f"[time] enhance B=1 10 s medians by route (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in enhance_ms.items()) + f" | {card}",
          flush=True)
    print(f"[metrics] eval batch {VCB_EVAL_BATCH} x 10 s with {list(VCB_EVAL_METRICS)} "
          f"{metric_nums['eval_ms']:.3f} ms (SI-SDR alone {metric_nums['eval_sisdr_ms']:.3f}), "
          f"device busy {metric_nums['busy_ms']:.3f} ms, of it the metrics "
          f"{metric_nums['metrics_busy_ms']:.3f} ({metric_nums['metrics_share']:.1%}); "
          f"battery max |card - pin| {metric_nums['battery_pin_err']}; TF32 off in all "
          f"{metric_nums['metric_calls']} metric calls | {card}", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
