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
     metric call;
  9. the perceptual objectives and media logging: PMSQE at (6, 1001, 201)
     power spectra and the stoi / estoi objectives at 6 rows of 4 s, ragged,
     card against CPU (loss and input gradient; TF32 on for the caller, off
     inside); a ``Runner`` built from config/vcb.yaml (corpus paths and step
     counts changed) trained with ``--objective pmsqe`` and ``media_step``:
     ``media.jsonl`` against the cadence, every WAV and PNG read back at its
     size, the launches of B1, B2 fwd, B2 bwd, B4 (one a media spectrogram
     too) and B5, TF32 off in every objective call; 2 steps with ``--objective
     WSD`` writing its figure; and times: the vcb head's train step with
     pmsqe and SISDR, its 12 x 10 s eval batch with stoi and SISDR, one media
     step;
 10. the serving front end: B1 continuing from a carried (h, c) against its
     plain version (one direction, B = 1 and 6, T = 1001, H = 256 on the
     cluster route and 252 on the grid route), cut into 48-step carried
     pieces against one launch, and with no state against the stateless
     call; the one-direction flagship's ``StatefulStreamer`` (48-frame
     chunks, 10 s pushed in ragged pieces) on the card against the same
     streamer on the CPU and the card's offline enhance, with 3 B1 launches
     and no B4 / B5 a chunk; the HTTP server (``serve.make_server``) in this
     process on the bidirectional and the one-direction flagship:
     ``/healthz``, eight concurrent ``/enhance`` requests of 2-10 s (one of
     them FLAC) under ``--workers 4`` and ``--fixed_batch`` against their
     solo replies (byte-identical under ``--fixed_batch``), ``/stream``
     against the card's streamer bit for bit; and times: ``/enhance`` of 10 s
     over HTTP beside the direct call, ``tools/serve_load.py`` at levels 1, 4
     and 16 (128 requests a level), and at 16 under ``--fixed_batch`` with
     its probes byte-identical, the stream's chunk, RTF and first audio, B1
     at one chunk's shape with and without state;
 11. the active-learning sampler at full width: config/active.yaml (LSTM 3 x
     256 bidirectional, corpus paths and step counts changed, every sampler
     cadence cut to fire) through ``build_runner`` / ``Runner`` with two
     seeded full-width S3PRL upstreams and scripts/run_active.sh's flags
     (``--active_sampling --sync_sampler --eval_init --save_best``): the
     launches of B1, B2 fwd, B2 bwd, B4 and B5 against the count the run's
     calls make (9 B2 fwd and 9 B2 bwd a sync-sampled step); one sync scoring
     call card against CPU at the run's shapes (32 query rows, 12
     candidates, 10 s) under both engines (``vmap``, ``capture``) and
     ``active_layerid`` None and 1, with the same ``match > 0`` set, and the
     same call with TF32 on required to break the limits; the
     async sampler (``--sampler_device 0``) collecting samples;
     ``--test_gradient --n_iterate 2`` writing ``sim_box.png``; one step of
     config/pseudo_noise.yaml; and times: the per-sample scoring call at 12
     x 10 s under each engine, the 32-row ``mean=True`` call, the train step
     with and without the sync sampler, under ``torch.profiler``.
 12. bf16 compute (``--compute_dtype bf16``): B3 fwd bf16 and B3 bwd bf16
     against their plain versions on the card (B=6, T=1001, 12 heads of 64 at
     rates 0.1 and 0, ragged T with a key bias, heads of 32 and 128; the
     backward twice for identical bits; ``FlashAttention`` on a bf16
     projection against the kernels called directly); the Mockingjay joint
     finetune ``--from_waveform --compute_dtype bf16`` through ``Runner`` (4
     steps with evals and saves, a 2-step resume that keeps bf16) with 6 B3 fwd
     bf16 and 6 B3 bwd bf16 launches a step and no f32 B3, and one step on the
     card against the CPU under the window criterion of
     tests/test_torch_port_bf16.py; the flagship head trained 4 steps and the
     upstream mode (``--upstream transformer``, ``--dropout 0.1``) 2 steps in
     bf16, their checkpoints served on the card and the CPU beside the same
     weights in f32, under the window criterion; and times: B3 bf16 beside the
     f32 kernel and its plain version at rate 0.1, and at rate 0 beside SDPA
     bf16 (forward and backward), at B=6 and 64, with the tensor-core bound
     and the CUDA-core floor (an exponential and the hash a logit), the B=6
     10 s Mockingjay and flagship train steps and the B=1 10 s
     enhance in bf16 beside f32 with profiler breakdowns that split the GEMMs
     by type. Head widths between B3's instances (16, 48 and 192, which the
     wrappers zero-pad to 32, 64 and 256) and the widest instance, 256: f32
     and bf16 forward and backward at rate 0.1 (bf16 at 256 also at rate 0)
     against the plain versions under the limits above, their times beside
     the bound of the true and of the padded work (SDPA at rate 0 beside 192
     and 256), and one Mockingjay step at 8 heads of 16 and one at hidden 768
     in 3 heads of 256, dropout live, card against CPU.
 13. the one-direction LSTM in bf16 (the JAX package's lax.scan cell in bf16):
     the bf16-h forms of B1 (also from a carried state), B2 fwd and B2 bwd and
     the step-by-step bf16 dW_hh^T kernel against their plain versions (one
     direction, T = 1001, H = 256 at B = 1 and 6, and H = 36 on the grid
     route; hs by maximum, RMS and share within 1e-4, dW_hh^T by its share
     within one bf16 unit, each beside the f32 form or an f32 sum rounded
     once that the limits must tell apart; the backward twice for identical
     bits); config/vcb.yaml with --compute_dtype bf16 through ``Runner`` (2
     steps and an eval; 3 B2 fwd, 3 B2 bwd and 3 dW_hh^T launches a step, all
     in the bf16-h form); one B=6 10 s train step of its head card against
     CPU under the window, each of its w_hh gradients too; a
     one-direction bf16 checkpoint served at B=1, streamed (3 B1 launches a
     48-frame chunk) and served over HTTP (``/enhance``, ``/stream`` bit for
     bit the card's streamer), card against CPU under the window; the
     scoring of config/active.yaml's head in bf16 under both engines and of
     the vcb head (a backward a row), card against CPU under the window with
     the same ``match > 0`` set; and times: each form beside its f32 form,
     its plain version and its bound, B2 bwd less its dW_hh^T kernel, the
     vcb train step, the B=1 enhance and the stream chunk in bf16 beside
     f32. The dW_hh^T kernel also at 137 and 352 rows (a step's rows staged in
     two and three chunks) under the same limits and timed, and one backward
     of the vcb head in bf16 at 137 rows.
 14. the bf16 stream forms of B1, B2 fwd and B2 bwd, which the JAX package's
     variables select (SE_LSTM_XW_BF16: xw in bf16, dxw written in it;
     SE_PALLAS_HS_BF16: B1's hs in bf16; SE_PALLAS_VJP_BF16: B2's residuals
     in bf16, its backward rounding W_hh^T and the dh product's da): each
     form against its plain version at the flagship shape, with one
     direction, at B = 16 and T = 1 on the cluster / phases routes and at H
     = 36 and 260 on the grid routes, every call twice for identical bits,
     B1 from a carried state and the bf16-h form with a bf16 xw, beside the
     f32 form, which the limits must tell apart; the flagship served at B=1
     10 s under the JAX enhance mode's variables and one B=6 10 s train step
     under its train mode's, card against CPU under the window, with the
     stream-form launches; config/active.yaml's head in bf16 scored under
     its score mode's variables with the CPU's ``match > 0`` set; vcb's
     one-direction head under SE_LSTM_XW_BF16 alone in f32 and bf16, served,
     streamed and one train step, card against CPU under the window; and
     times: each form beside the f32 form and its plain version, with the
     bound of the bytes it moves, the enhance and the train step under their
     modes beside f32. Then B1's forms of other functions, which the JAX
     package's SE_PALLAS_MXU_BF16, SE_PALLAS_GATES_BF16 (its Pallas B1) and
     SE_LSTM_XW_INT8 (its scan) select: the MXU, gates and MXU + gates +
     bf16 hs forms against their plain versions at (2, B, 1001, 256) for B =
     1, 64 and 768 on the cluster route and at H = 60 on the grid route, the
     int8 form at one direction (f32 and bf16-h, also from a carried state
     at T = 48) on both routes, every call twice for identical bits, beside
     the f32 form; the flagship served at B=1 10 s under each form, card
     against CPU under the window, and its enhance mode's 768 rows under
     each on the card, each row against the B=1 call; vcb's one-direction
     head under SE_LSTM_XW_INT8 served, streamed and one B=6 10 s train
     step, card against CPU; and each form's B1 time beside its f32 form and
     its bound.
 15. upstream pretraining, its S3PRL export and the experiment tools:
     ``tools/pretrain_upstream.py`` at config/pretrain_sample.yaml's full
     width (6 x 768 x 12 heads, FFN 3072, dropout 0.1; 80-d log-mel + delta
     in, 201-bin log-linear target) on a corpus of 10 s rows, batch 8, 3
     steps for target channels 1 and 2, with the launches of B3 fwd, B3 bwd
     and B4 a step (no LSTM kernel, no B5); one step of it on the card
     against the CPU (the seed checkpoint, 8 rows of 4 s, the same salts);
     its B=8 10 s step, the median of 10 synchronized steps and the device
     busy time and idle share under the profiler; the export read back bit
     for bit against the trained Mockingjay's encoder and SpecHead, and
     served as ``--ckpt`` (the upstream mode): its features on a seeded 10 s
     batch bit for bit the trained encoder's; then
     ``tools/experiment_active_adaptation.py`` at the script's widths and
     20 / 20 / 10 steps, with the launches of each stage (both upstreams,
     the source warm start, active and uniform adaptation, the enrichment
     scoring), ``results.json`` checked, and ``tools/extract_results.py``
     over the adaptation runs.
 16. the exported serving program: a seeded flagship checkpoint exported by
     ``tools/export_model.py`` on the card (buckets up to 4 s) and served from
     the artifact (``serve.build_artifact_enhancer``) at 1, 3 and 6 rows of
     the 4 s bucket from one program: B1 3, B4 1 and B5 1 launches a device
     batch through the op library and no other kernel, the output against
     the live ``--ckpt`` enhancer (``ARTIFACT_TOL``); an artifact exported on
     the CPU served on the card (moved by ``move_to_device_pass``); ``serve
     --artifact`` (``/enhance``, ``/healthz``, ``/stream`` 400) and ``enhance
     --artifact`` against ``--ckpt``; and times: the B=1 4 s call live and
     from the artifact, and the live B=1 10 s call.
 17. data parallelism (``parallel/``): (a) the flagship trained 3 B=6 steps
     on 10 s rows of ragged lengths through the CLI, ``run_downstream.main``,
     with ``--mesh 1x1`` (the CLI's own rendezvous, card pick and NCCL group)
     and without, losses, gradient norms and parameters bit for bit, with the
     launches of B1, B2 fwd, B2 bwd, B4 and B5;
     (b) two gloo ranks on this one card (NCCL refuses two ranks on one
     device), each on its 3 rows of the same global batches, against one
     process on all 6: the flagship head 3 steps under SISDR and the LSTM
     head at the flagship's width under L1 (the head that predicts the log
     spectrum L1 reads), loss and gradient norm within 1e-5, the update
     within 1e-3 of the single process's, the ranks' parameters bit for bit;
     the full Mockingjay joint finetune (6 x 768 x 12, dropout 0.1), every
     hidden-dropout mask bit for bit the single process's rows, B3 at batch0
     0 and 3, the loss within 1e-5 and the global gradient within 1e-3; B3
     fwd and bwd (f32 and bf16) on each rank's rows at its batch0 bit for bit
     the single launch's rows; (c) a 12 x 10 s eval batch split over the two
     ranks, scores and loss within 1e-5 of the single process; (d)
     ``build_enhancer(mesh_n=2)`` with both replicas on this card, 8 rows of
     4-10 s, within one 16-bit step of the single-device enhancer; and (e)
     times, not judged: the mesh-1 step beside the step without a mesh and
     its all-reduce, the two-rank step (gloo stages through the host).
 18. tensor, pipeline and sequence parallelism (``parallel/``): (a) B3's
     four kernels (f32 and bf16, fwd and bwd) on heads [6, 12) of 12 at
     ``head0`` 6 (B=6, T=1001, D=64, rate 0.1) bit for bit those heads of the
     full launch (out, lse, dq, dk, dv), and the same heads launched as heads
     0-5 of their own giving other outputs; (b) ``--mesh 1x2`` and ``2x2``
     as two and four gloo ranks on this card (spawned, each group with its
     own limit), against one process on the global batches: B3 at each
     rank's rows and heads (batch0, head0) bit for bit the single launch's;
     the flagship 3 B=6 steps of ragged 10 s rows and the full Mockingjay
     finetune (dropout 0.1) 2 steps through the tensor-parallel train step,
     loss and gradient norm within 1e-5, the update of the gathered
     parameters within 1e-3 of the single process's, every hidden-dropout
     mask the single process's rows bit for bit and B3 called at its salts,
     batch0 and head0, the replicated parameters bit for bit in each model
     group, B2 fwd / bwd and B3 fwd / bwd launched on every rank; (c) the
     12 x 10 s eval batch over the four ranks of 2x2, loss and scores within
     1e-5; (d) ``pipeline_lstm`` on three ranks of 2x2 (H = 256, B = 6,
     T = 1001, 7 chunks) within 2e-5 of the one-direction ``LSTMStack``, B1
     launched 7 times a rank with the carried state; (e)
     ``sequence_parallel_encoder`` at full width (B = 4, T = 1000) at (data,
     seq) = (1, 2) and (2, 2) within 1e-4 of the single-process encoder; and
     (f) times, not judged: the mesh steps beside one process (gloo stages
     through the host, and the ranks share the card).

 19. the step tracer (``utils/profiling.py``): (a) the flagship trained 3 B=6
     10 s steps through ``run_downstream.main`` with ``--profile``
     (``profile_step`` 2) and without, scalars and saved parameters bit for
     bit, the trace parsed, its device plane naming B2 fwd and each kernel of
     B2 bwd 3 times and B4 once; (b) ``tools/profile_step``'s modes at the
     JAX bench's batches and variables (enhance and eval at 768 rows under
     SE_PALLAS_HS_BF16, eval with all five metrics, train at 352 under
     SE_PALLAS_VJP_BF16, upstream at 512 in bf16, Mockingjay at 64 in bf16
     with dropout 0.1, score at 256 in bf16 under both variables), each
     traced over 2 calls: the device plane's ms a call and top rows, the
     port's kernels' launches a call read from the table against the code's
     count and the wrappers', the table's total against the profiler's own
     device sum; enhance's rows against a 6-row call, the train step's loss
     and gradient and the per-row scores against the plain versions on the
     card; (c) a probe of 64 small kernels under a bare torch.profiler and
     under ``utils/profiling.trace``, the records each keeps (the bare one
     may lose a session's first records in a process minutes old; trace's
     opening pads must keep them all); and B1 at 768 rows and B2 at 352
     beside their bounds.
 20. the benchmark harness and its cost model: ``python -m
     speech_enhancement_by_s3prl_tpu_torch.bench`` (``run_all``: each of its
     ten modes in a subprocess at the JAX bench's batches and variables, 2
     calls a mode, the latency mode 50, the pipeline over one epoch), every
     line with a positive value and this card's name and power limit, each
     device mode with 0 < mfu <= 1 and 0 < hbm_util_model <= 1 from the
     classes' peaks, no opaque call, no roofline error and the launches a
     call the code gives, the headline the enhance mode's; ``program_cost``
     of the flagship's enhance and train step (2 rows of 1 s, in f32 and
     under their bench modes' stream forms) the same on the card, where the
     kernels run, as on the CPU, where their plain versions run; and the
     bounds the phases above print, now read from ``utils/costs.py``,
     against their values before the move.
 21. JAX's random streams (phases 1-20 run under the flash + hash dropout
     routes they were written for, ``SE_ATTN_IMPL=flash
     SE_HIDDEN_DROPOUT_IMPL=hash``; this phase under the port's defaults,
     JAX's): (a) D1, flax ``nn.Dropout``'s threefry mask, against its plain
     version at the Mockingjay width (64, 1001, 768), f32 and bf16, forward
     and backward, at batch0 0 and 5 and past the counter's high word: masks
     and values identical; (b) B3's mask forms (the explicit path's flax and
     hidden-hash masks, the chunked path's under both): each mask read out of
     the kernels (q = k = 0, v or do one-hot; f32 and bf16, batch0 6000, heads
     1-3 of 5) identical to the plain versions', and each form against its
     plain version f32 at B=6 under phase 3's limit and bf16 at B=64 under
     phase 12's, T=1001, 12 x 64, rate 0.1, with the hash form's time beside
     it; (c) the default dropout-live Mockingjay step at full width, 3 steps
     card against CPU from one seed and key chain within phase 6's step
     limits, 26 D1 and 6 + 6 B3 launches a step; (d) its time beside the
     flash + hash route's at B=6 f32 and B=64 bf16, 10 s, in turns.

Then each kernel's time beside its bound (the least time the card could take
for the same work), the card's line, one JSON line with every kernel's
numbers, and last
``{"ok": true, "device": {...}}``. Any failure raises, and the script exits
non-zero without that last line. It needs a CUDA card and the repository
around it.
"""
import contextlib
import gc
import http.client
import json
import math
import os
import pickle
import random
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import wave

import numpy as np

from speech_enhancement_by_s3prl_tpu_torch.bench import kernel_wrappers
from speech_enhancement_by_s3prl_tpu_torch.utils.costs import (  # the kernels' counts and bounds
    PEAK_F32,
    PEAK_TF32,
    attention_bound,
    attention_bound_bf16,
    b1_form_bound,
    bf16_h_bound,
    bound,
    carried_bound,
    decode_bound,
    dw_first_bound,
    lstm_bound,
    stft_bound,
    stream_bound,
)
from speech_enhancement_by_s3prl_tpu_torch.utils.profiling import kernel_label, kernel_op

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
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
# calls a profiler breakdown averages over (once 5): a session's set-up
# and the events of a Mockingjay step's ~3500 launches cost seconds each, and
# a device time a call agrees to ~1% whatever the count
PROFILED_CALLS = 2
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
MJ_STEPS, MJ_RESUME_STEPS, UPSTREAM_STEPS = 4, 2, 2


def phase_done(n: int) -> None:
    """Marks the end of phase ``n`` with the seconds since the script began."""
    print(f"[phase] {n} done at {time.perf_counter() - T_START:.1f} s", flush=True)


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


def write_corpus(root, seed, speech=(12, 3.0, 10.0), noise=(4, 4.0, 8.0)):
    """``speech`` (count, shortest, longest seconds: 12 files of 3-10 s by
    default) speech files (tone sweeps with a syllable envelope) and
    ``noise`` (4 of 4-8 s) noise files, 16 kHz WAV, from ``seed``."""
    from speech_enhancement_by_s3prl_tpu_torch.data.audio_io import write_wav

    rng = np.random.default_rng(seed)
    for sub, (n, lo, hi) in (("speech", speech), ("noise", noise)):
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
        for count in ("carried", "h_bf16", "xw_bf16", "hs_bf16", "res_bf16", "gates_bf16",
                      "xw_int8"):
            if hasattr(fn, count):
                setattr(fn, count, 0)
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


def synced_ms(torch, fn, runs=10):
    """Host times in ms of ``runs`` calls of ``fn``, each followed by a
    synchronize, after one call to warm it."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def device_events(prof):
    """The card's events of a ``torch.profiler`` run: kernels, copies and
    memsets."""
    from torch.autograd import DeviceType

    return [evt for evt in prof.events() if evt.device_type == DeviceType.CUDA]


def device_busy(torch, fn, calls=PROFILED_CALLS):
    """A call of ``fn`` under ``torch.profiler``, after one call to warm it:
    (device busy ms, wall ms, device kernels, host-to-card copies). Each
    host-to-card copy made from pageable memory waits for the work queued
    before it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    device = device_events(prof)
    htod = sum("HtoD" in evt.name for evt in device) / calls
    return (sum(evt.time_range.elapsed_us() for evt in device) / 1e3 / calls, wall,
            len(device) / calls - htod, htod)


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
        for _ in range(PROFILED_CALLS):
            state, stats = builder.train_step(state, wavs, lengths)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / PROFILED_CALLS
    shares = {"B3 fwd": 0.0, "B3 bwd": 0.0, "cuBLAS": 0.0, "other": 0.0}
    other, launches = {}, 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        name = evt.name
        ms = evt.time_range.elapsed_us() / 1e3 / PROFILED_CALLS
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
    print(f"[time] Mockingjay train step B=6 under torch.profiler ({PROFILED_CALLS} steps): wall "
          f"{wall:.3f} ms a step, device busy {busy:.3f} ms ("
          + ", ".join(f"{k} {v:.3f} ms {v / max(busy, 1e-9):.1%}" for k, v in shares.items())
          + f"), idle share {max(0.0, 1 - busy / wall):.3f}, "
          f"{launches / PROFILED_CALLS:.0f} device "
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
        step3 = synced_ms(torch, lambda: builders["cuda"].eval_step(wavs, lengths))
        step1 = synced_ms(torch, lambda: sisdr_only.eval_step(wavs, lengths))
        wp, wt = card_out["wav_predicted"], card_out["wav_tar"]
        alone = synced_ms(torch, lambda: M.batch_scores(VCB_EVAL_METRICS, wp, wt, lengths, SR))
        step3, step1, alone = ((statistics.median(ms), min(ms), max(ms))
                               for ms in (step3, step1, alone))
        busy3, wall3, k3, h3 = device_busy(torch, lambda: builders["cuda"].eval_step(
            wavs, lengths))
        busy1, wall1, k1, h1 = device_busy(torch, lambda: sisdr_only.eval_step(wavs, lengths))
        busy_m, wall_m, k_m, _ = device_busy(torch, lambda: M.batch_scores(
            VCB_EVAL_METRICS, wp, wt, lengths, SR))
        print(f"[time] eval batch {VCB_EVAL_BATCH} x 10 s, {list(VCB_EVAL_METRICS)}: median "
              f"{step3[0]:.3f} ms of 10 (min {step3[1]:.3f}, max {step3[2]:.3f}); SI-SDR "
              f"alone: median {step1[0]:.3f} ms (min {step1[1]:.3f}, max {step1[2]:.3f}); the "
              f"metrics alone on the step's outputs: median {alone[0]:.3f} ms | {card}",
              flush=True)
        print(f"[time] eval batch {VCB_EVAL_BATCH} x 10 s under torch.profiler "
              f"({PROFILED_CALLS} calls each): "
              f"with {list(VCB_EVAL_METRICS)} wall {wall3:.3f} ms, device busy {busy3:.3f} ms, "
              f"idle share {max(0.0, 1 - busy3 / wall3):.3f}, {k3:.0f} device kernels and "
              f"{h3:.0f} host-to-card copies a call; SI-SDR alone wall {wall1:.3f}, busy "
              f"{busy1:.3f}, {k1:.0f} kernels and {h1:.0f} copies; the metrics alone wall "
              f"{wall_m:.3f}, busy {busy_m:.3f} ms = {busy_m / max(busy3, 1e-9):.1%} of the "
              f"step's device busy time, {k_m:.0f} kernels | {card}",
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


# the perceptual objectives card against CPU (phase 9): the loss relative to
# the CPU's, the input gradient relative to the CPU's largest |value|. Both
# sides compute in full f32 with other summation orders (PMSQE's bark product
# over 201 bins and its frame sums over 1001 frames; STOI's resampling, DFT
# and band products), which moves a value by f32 rounding of its sums
OBJECTIVE_LOSS_TOL = 1e-5
OBJECTIVE_GRAD_TOL = 1e-4
# config/vcb.yaml cut to a few steps for phase 9's run: only the step counts
# and the corpus paths change
VCB_STEPS = {"total_step": 4, "log_step": 2, "eval_step": 4, "media_step": 2}
WSD_STEPS = 2
MEDIA_TAGS = ("noisy", "clean", "noise")
EVAL_MEDIA_TAGS = ("noisy", "clean", "enhanced")


def png_size(path):
    """(height, width) from a PNG's IHDR, after its signature."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def wav_frames(path):
    """The sample count of a mono 16-bit WAV at SR."""
    with wave.open(path, "rb") as w:
        if (w.getnchannels(), w.getsampwidth(), w.getframerate()) != (1, 2, SR):
            raise AssertionError(f"{path}: {w.getparams()}")
        return w.getnframes()


def shipped_config(corpus, name, steps, candidates):
    """config/{name}.yaml with its corpus paths pointing at ``corpus``
    (written by ``write_corpus``) and its step counts replaced by ``steps``.
    Its train split keeps the files after the first ``sample_num`` (1000) of
    its list for training and draws the dev split (and query_dev) from those
    1000, so the train split reads a list of the corpus's speech files
    repeated past 1000 + ``candidates`` lines; the test split reads the
    directory."""
    import yaml

    with open(os.path.join(ROOT, "config", f"{name}.yaml")) as f:
        config = yaml.safe_load(f)
    speech, noise = os.path.join(corpus, "speech"), os.path.join(corpus, "noise")
    train = config["OnlineDataset_train"]["speech"]
    files = sorted(os.listdir(speech))
    listed = os.path.join(corpus, f"{name}_train_speech.txt")
    with open(listed, "w") as f:
        f.writelines(files[k % len(files)] + "\n"
                     for k in range(train["sample_num"] + candidates))
    train.update(filestrs=listed, fileroot=speech)
    config["OnlineDataset_test"]["speech"]["filestrs"] = speech
    for split in ("OnlineDataset_train", "OnlineDataset_test"):
        config[split]["noise"]["filestrs"] = noise
    config["runner"].update(steps)
    return config


def objectives_phase(torch, kernels, all_kernels, dsp_kernels, card, tmp):
    """Phase 9, the perceptual objectives and media logging on the card:

    (a) PMSQE at (6, 1001, 201) power spectra and the ``stoi`` / ``estoi``
        objectives at 6 rows of 4 s, ragged masks (one row padded over 2.75
        s, as much as config/vcb.yaml's eval batches pad): loss and input
        gradient card against CPU, called with TF32 on by the caller and off
        inside (``metrics.full_f32``, as the trainer calls them);
    (b) a ``Runner`` built from config/vcb.yaml (its corpus paths and step
        counts changed) trained 4 steps with ``--objective pmsqe`` and
        ``media_step`` 2: ``media.jsonl`` against the cadence, every WAV and
        PNG read back at its size, the launches of B1, B2 fwd, B2 bwd, B4
        and B5 (one B4 a step, an eval batch and a media spectrogram); then
        2 steps with ``--objective WSD``, whose logger writes
        ``WSD_variables.png``; TF32 off in every objective call the two
        Runners make, the logger's included;
    (c) times: the vcb head's train step at B=6, 10 s with pmsqe and SISDR
        (median of 10 synchronized steps, device busy under the profiler),
        its 12 x 10 s eval batch with stoi and SISDR, and one media step.

    Returns a dict of the numbers."""
    import dataclasses

    import yaml

    from speech_enhancement_by_s3prl_tpu_torch import objectives as O
    from speech_enhancement_by_s3prl_tpu_torch.metrics import full_f32
    from speech_enhancement_by_s3prl_tpu_torch.run_downstream import (
        build_runner,
        get_downstream_args,
    )

    b1, b2f, b2b = kernels
    stft_fused, decode_ola = dsp_kernels
    out = {}

    # every objective call records the TF32 settings it ran under
    seen = []
    watched = (O.pmsqe, O._StoiLoss, O.WSD)
    originals = [cls.__call__ for cls in watched]

    def watch(fn):
        def call(self, **ctx):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            return fn(self, **ctx)
        return call

    for cls, fn in zip(watched, originals):
        cls.__call__ = watch(fn)
    try:
        # -- (a) card against CPU -------------------------------------------
        rng = np.random.default_rng(SEED + 12)
        B, T, F = 6, 1001, 201
        frames = np.array([1001, 950, 800, 640, 501, 233])
        tar = (rng.standard_normal((B, T, F)) ** 2 * 1e2).astype(np.float32)
        src = (tar * (0.5 + 0.25 * rng.standard_normal((B, T, F))) ** 2).astype(np.float32)
        spec_ctx = {"predicted": src, "linear_tar": tar,
                    "stft_length_masks": (np.arange(T)[None, :] < frames[:, None]).astype(
                        np.float32)}
        n = 4 * SR
        clean = np.stack([speech_like(n, 20 + i) for i in range(B)])
        noisy = clean + 0.02 * rng.standard_normal(clean.shape).astype(np.float32)
        # ragged; the last row padded over 2.75 s, many 30-frame segments of
        # silence, which the objectives count (they mask the waveforms and
        # pass no lengths, as in the JAX package). The stoi objective's input
        # gradient is NaN on that row (the correlation's sqrt at 0) on either
        # device; ESTOI scores each such segment 0 (ROADMAP C5)
        samples = n - np.array([0, 700, 1900, 3100, 4800, 44000])
        wav_ctx = {"wav_predicted": noisy, "wav_tar": clean,
                   "length_masks": (np.arange(n)[None, :] < samples[:, None]).astype(np.float32)}
        nan_rows_want = {"pmsqe": [False] * B, "stoi": [False] * (B - 1) + [True],
                         "estoi": [False] * B}
        errs = {}
        for name, ctx, key in (("pmsqe", spec_ctx, "predicted"), ("stoi", wav_ctx, "wav_predicted"),
                               ("estoi", wav_ctx, "wav_predicted")):
            sides = {}
            for dev in ("cuda", "cpu"):
                t = {k: torch.from_numpy(v).to(dev) for k, v in ctx.items()}
                t[key].requires_grad_()
                # a caller with TF32 on, the objective inside full_f32 as the
                # trainer calls it
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
                with full_f32():
                    loss, _ = O.build_objective(name)(**t)
                    (g,) = torch.autograd.grad(loss, t[key])
                restored = torch.backends.cuda.matmul.allow_tf32
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
                if not restored:
                    raise AssertionError("full_f32 did not restore the caller's TF32 settings")
                sides[dev] = (float(loss.detach()), g.detach().cpu())
            (gl, gg), (cl, cg) = sides["cuda"], sides["cpu"]
            loss_rel = abs(gl - cl) / abs(cl)
            nan_rows = [torch.isnan(g).flatten(1).any(dim=1).tolist() for g in (gg, cg)]
            finite = ~torch.tensor(nan_rows[1])
            grad_rel = float((gg[finite] - cg[finite]).abs().max() / cg[finite].abs().max())
            errs[name] = (loss_rel, grad_rel)
            shape = "x".join(map(str, ctx[key].shape))
            print(f"[objectives] {name} at {shape} (ragged masks) card vs CPU: loss {gl:.6f} vs "
                  f"{cl:.6f}, rel {loss_rel:.2e} (limit {OBJECTIVE_LOSS_TOL:.0e}); input "
                  f"gradient max |diff| / max |g| {grad_rel:.2e} (limit "
                  f"{OBJECTIVE_GRAD_TOL:.0e}) over the rows without NaN; rows with a NaN "
                  f"gradient {[i for i, v in enumerate(nan_rows[0]) if v]} on the card, "
                  f"{[i for i, v in enumerate(nan_rows[1]) if v]} on the CPU", flush=True)
            if not (math.isfinite(gl) and loss_rel <= OBJECTIVE_LOSS_TOL
                    and grad_rel <= OBJECTIVE_GRAD_TOL
                    and nan_rows == [nan_rows_want[name]] * 2):
                raise AssertionError(f"{name} card vs CPU: loss {loss_rel}, grad {grad_rel}, "
                                     f"NaN gradient rows {nan_rows}")
        bad = [s for s in seen if s != (False, False)]
        print(f"[objectives] TF32 off in {len(seen) - len(bad)} of the {len(seen)} objective "
              f"calls above (each inside full_f32, as the trainer makes them)", flush=True)
        if bad or len(seen) != 6:
            raise AssertionError(f"objective calls with TF32 allowed: {len(bad)} of {len(seen)}")
        out["errs"] = errs

        # -- (b) config/vcb.yaml through the Runner, --objective pmsqe --------
        corpus = os.path.join(tmp, "corpus")
        write_corpus(corpus, SEED)

        def runner_for(name, objective, steps):
            cfg_path = os.path.join(tmp, f"{name}.yaml")
            with open(cfg_path, "w") as f:
                yaml.safe_dump(shipped_config(corpus, "vcb", steps, 12), f)
            args, config = get_downstream_args([
                "--config", cfg_path, "--name", name, "--expdir", os.path.join(tmp, "exp"),
                "--downstream", "Residual", "--objective", objective, "--from_rawfeature",
                "--dev_num", str(VCB_EVAL_BATCH), "--n_jobs", "4", "--seed", str(SEED),
                "--device", "cuda"])
            random.seed(SEED)
            np.random.seed(SEED)
            runner = build_runner(args, config)
            runner.set_model()
            return runner, os.path.join(tmp, "exp", name)

        runner, run_dir = runner_for("vcb_pmsqe", "pmsqe", VCB_STEPS)
        steps, evals, returned, media_b4 = [], [], [], []
        train_step, eval_step = runner.train_step, runner.builder.eval_step
        evaluate, media_logging = runner.evaluate, runner.media.media_logging

        def step(state, wavs, lengths):
            state, stats = train_step(state, wavs, lengths)
            steps.append((tuple(wavs.shape), stats))
            return state, stats

        def eval_batch(wavs, lengths, **kw):
            evals.append(tuple(wavs.shape))
            return eval_step(wavs, lengths, **kw)

        def evaluate_recorded(loader=None):
            result = evaluate(loader)
            returned.append([len(w) for w in result[4]])
            return result

        def media_recorded(step_, tag, data):
            before = stft_fused.launches
            media_logging(step_, tag, data)
            media_b4.append(stft_fused.launches - before)

        runner.train_step, runner.builder.eval_step = step, eval_batch
        runner.evaluate, runner.media.media_logging = evaluate_recorded, media_recorded
        t0 = time.perf_counter()
        seen.clear()
        # -- the main path of the vcb head with PMSQE and media logging --
        reset_counts(all_kernels)
        runner.train()
        counts = [fn.launches for fn in all_kernels]
        vcb_counts = [b1.launches, b2f.launches, b2b.launches, stft_fused.launches,
                      decode_ola.launches]
        # -----------------------------------------------------------------
        run_s = time.perf_counter() - t0
        check_b5_route(decode_ola, "the vcb run")
        losses = [float(st["loss"]) for _, st in steps]
        if len(steps) != VCB_STEPS["total_step"] or not all(map(math.isfinite, losses)) or any(
                bool(st["skipped"]) for _, st in steps):
            raise AssertionError(f"vcb run: {len(steps)} steps, losses {losses}")
        n_steps, n_evals, n_media = len(steps), len(evals), len(media_b4)
        want = [3 * n_evals, 3 * n_steps, 3 * n_steps, n_steps + n_evals + n_media, n_evals]
        if vcb_counts != want or sum(counts) != sum(want) or media_b4 != [1] * n_media:
            raise AssertionError(f"vcb run launches (B1, B2 fwd, B2 bwd, B4, B5) {vcb_counts}, "
                                 f"want {want}; all kernels {counts}; B4 a media clip "
                                 f"{media_b4}")
        scalars = [json.loads(ln) for ln in open(os.path.join(run_dir, "scalars.jsonl"))]
        eval_losses = [s["value"] for s in scalars if s["tag"].endswith("_loss")]
        if len(eval_losses) != len(runner.rconfig["eval_splits"]) or not all(
                map(math.isfinite, eval_losses + [s["value"] for s in scalars])):
            raise AssertionError(f"vcb run scalars {scalars}")

        # media.jsonl against the cadence: the train batch's channels at every
        # media step (the whole batch as one clip), the samples evaluate
        # returned at the step that eval_step and media_step both divide
        train_len = {i + 1: sh[0] * sh[-1] for i, (sh, _) in enumerate(steps)}
        expect = []
        for s in range(1, n_steps + 1):
            if s % VCB_STEPS["media_step"]:
                continue
            expect += [(s, f"{tag}.{ext}", train_len[s]) for tag in MEDIA_TAGS
                       for ext in ("wav", "png")]
            if s % VCB_STEPS["eval_step"] == 0:
                lens = returned[:len(runner.rconfig["eval_splits"])]
                for split, split_lens in zip(runner.rconfig["eval_splits"], lens):
                    expect += [(s, f"{split}-{tag}-{i}.{ext}", n_) for i, n_ in
                               enumerate(split_lens) for tag in EVAL_MEDIA_TAGS
                               for ext in ("wav", "png")]
        index = [json.loads(ln) for ln in open(os.path.join(run_dir, "media.jsonl"))]
        if [(m["step"], m["tag"]) for m in index] != [(s, t) for s, t, _ in expect]:
            raise AssertionError(f"media.jsonl {[(m['step'], m['tag']) for m in index]}, want "
                                 f"{[(s, t) for s, t, _ in expect]}")
        hop = runner.preprocessor._win_args["hop_length"]
        n_freq = runner.preprocessor.config.n_freq
        for m, (_, _, samples_) in zip(index, expect):
            path = os.path.join(run_dir, m["path"])
            got = wav_frames(path) if m["kind"] == "audio" else png_size(path)
            want_ = samples_ if m["kind"] == "audio" else (n_freq, 1 + samples_ // hop)
            if got != want_:
                raise AssertionError(f"{m['path']}: {got}, want {want_}")
        pmsqe_calls = list(seen)
        print(f"[objectives] config/vcb.yaml (Residual 3 x 256, one direction, linear 201-d; "
              f"corpus paths and step counts {VCB_STEPS} changed) through Runner on cuda with "
              f"--objective pmsqe: {n_steps} steps of {sorted({sh for sh, _ in steps})} in "
              f"{run_s:.2f} s, losses {', '.join(f'{x:.4f}' for x in losses)}, eval losses "
              f"{', '.join(f'{x:.4f}' for x in eval_losses)} ({n_evals} eval batches); "
              f"launches (B1, B2 fwd, B2 bwd, B4, B5) {vcb_counts} = 3 B2 fwd + 3 B2 bwd + 1 "
              f"B4 a step, 3 B1 + 1 B4 + 1 B5 an eval batch, 1 B4 each of {n_media} media "
              f"spectrograms; media.jsonl {len(index)} files as the cadence wants, every WAV "
              f"and PNG read back at its size", flush=True)
        out.update(vcb_counts=vcb_counts, n_media=n_media, media_files=len(index))

        # two steps with --objective WSD: its logger's figure at log_step
        wsd, wsd_dir = runner_for("vcb_wsd", "WSD", {**VCB_STEPS, "total_step": WSD_STEPS})
        wsd_steps = []
        wsd_train = wsd.train_step

        def wsd_step(state, wavs, lengths):
            wsd_steps.append(tuple(wavs.shape))
            return wsd_train(state, wavs, lengths)

        wsd.train_step = wsd_step
        seen.clear()
        wsd.train()
        figures = [m for m in map(json.loads, open(os.path.join(wsd_dir, "media.jsonl")))
                   if m["tag"] == "WSD_variables"]
        sh = wsd_steps[-1]
        want_fig = (5 * n_freq, 1 + sh[-1] // hop)
        got_fig = [png_size(os.path.join(wsd_dir, m["path"])) for m in figures]
        print(f"[objectives] --objective WSD, {WSD_STEPS} steps: WSD_variables.png at steps "
              f"{[m['step'] for m in figures]}, {got_fig} pixels (five panels of "
              f"{n_freq} bins)", flush=True)
        if [m["step"] for m in figures] != [WSD_STEPS] or got_fig != [want_fig]:
            raise AssertionError(f"WSD figures {figures}, sizes {got_fig}, want {want_fig}")
        del wsd
        # the Runners' own objective calls: a train step and an eval batch
        # each one, and the WSD logger one at each figure
        calls = {"pmsqe": (pmsqe_calls, n_steps + n_evals),
                 "WSD": (list(seen), len(wsd_steps) + len(figures))}
        bad = {k: sum(s != (False, False) for s in got) for k, (got, _) in calls.items()}
        print(f"[objectives] TF32 off in every objective call of the Runners: "
              + ", ".join(f"--objective {k} {len(got) - bad[k]} of {len(got)} (want {want})"
                          for k, (got, want) in calls.items()), flush=True)
        if any(bad.values()) or any(len(got) != want for got, want in calls.values()):
            raise AssertionError(f"objective calls of the Runners: {bad} with TF32 allowed, "
                                 f"counts {[(len(g), w) for g, w in calls.values()]}")

        # -- (c) times ---------------------------------------------------------
        builder = runner.builder
        builder.eval_step = eval_step
        wavs = torch.from_numpy(np.stack([np.stack([c + 0.05 * rng.standard_normal(c.shape),
                                                    c, 0.05 * rng.standard_normal(c.shape)])
                                          for c in (request_audio(10.0, 50 + i)
                                                    for i in range(12))]).astype(np.float32))
        wavs = wavs.cuda()
        lengths = torch.full((12,), wavs.shape[-1], dtype=torch.long, device="cuda")
        by_objective = {name: dataclasses.replace(builder, objective=O.build_objective(name))
                        for name in ("pmsqe", "SISDR", "stoi")}
        state = by_objective["pmsqe"].init_state()

        # in turns within this call: pmsqe, SISDR, SISDR, pmsqe
        runs = {"pmsqe": [], "SISDR": []}
        for name in ("pmsqe", "SISDR", "SISDR", "pmsqe"):
            runs[name] += synced_ms(torch, lambda b=by_objective[name]: b.train_step(
                state, wavs[:6], lengths[:6]))
        train_t = {k: statistics.median(v) for k, v in runs.items()}
        train_busy = {k: device_busy(torch, lambda k=k: by_objective[k].train_step(
            state, wavs[:6], lengths[:6])) for k in ("pmsqe", "SISDR")}
        eruns = {"stoi": [], "SISDR": []}
        for name in ("stoi", "SISDR", "SISDR", "stoi"):
            eruns[name] += synced_ms(torch, lambda b=by_objective[name]: b.eval_step(
                wavs, lengths))
        eval_t = {k: statistics.median(v) for k, v in eruns.items()}
        eval_busy = {k: device_busy(torch, lambda k=k: by_objective[k].eval_step(wavs, lengths))
                     for k in ("stoi", "SISDR")}
        print(f"[time] vcb head (Residual 3 x 256, one direction) train step B=6 10 s: median "
              f"of 20 synchronized steps (in turns pmsqe, SISDR, SISDR, pmsqe) pmsqe "
              f"{train_t['pmsqe']:.3f} ms (min {min(runs['pmsqe']):.3f}), SISDR "
              f"{train_t['SISDR']:.3f} ms (min {min(runs['SISDR']):.3f}); under "
              f"torch.profiler ({PROFILED_CALLS} steps): "
              + "; ".join(f"{k} wall {w:.3f} ms, device busy {b_:.3f} ms, idle share "
                          f"{max(0.0, 1 - b_ / w):.3f}, {kn:.0f} kernels and {hd:.0f} "
                          f"host-to-card copies a step"
                          for k, (b_, w, kn, hd) in train_busy.items()) + f" | {card}",
              flush=True)
        print(f"[time] vcb head eval batch 12 x 10 s with eval_metrics "
              f"{list(builder.eval_metrics)}: median of 20 (in turns stoi, SISDR, SISDR, stoi) "
              f"--objective stoi {eval_t['stoi']:.3f} ms, SISDR {eval_t['SISDR']:.3f} ms; under "
              f"torch.profiler ({PROFILED_CALLS} calls): "
              + "; ".join(f"{k} wall {w:.3f} ms, device busy {b_:.3f} ms, {kn:.0f} kernels, "
                          f"{hd:.0f} host-to-card copies"
                          for k, (b_, w, kn, hd) in eval_busy.items()) + f" | {card}",
              flush=True)

        # one media step: the train batch's three channels, each a clip of
        # 6 x 10 s with its spectrogram on the card
        from speech_enhancement_by_s3prl_tpu_torch.runner import media as media_mod

        media = runner.media
        media.media_logging = media_logging
        batch = wavs[:6]
        media_ms, media_counts = [], []
        # host time of the WAV writes and the PNG encodes, the rest being the
        # copies, the spectrogram and the PNG file writes
        parts = {"wav": [0.0], "png": [0.0]}
        encoders = (media_mod.write_wav, media_mod.spectrogram_png)

        def timed(key, fn):
            def run(*a, **kw):
                t2 = time.perf_counter()
                result = fn(*a, **kw)
                parts[key][-1] += (time.perf_counter() - t2) * 1e3
                return result
            return run

        media_mod.write_wav = timed("wav", encoders[0])
        media_mod.spectrogram_png = timed("png", encoders[1])
        try:
            for k in range(4):
                torch.cuda.synchronize()
                before = stft_fused.launches
                t1 = time.perf_counter()
                for ch, tag in enumerate(MEDIA_TAGS):
                    media.media_logging(100 + k, tag, batch[:, ch, :])
                media_ms.append((time.perf_counter() - t1) * 1e3)
                media_counts.append(stft_fused.launches - before)
                parts["wav"].append(0.0)
                parts["png"].append(0.0)
        finally:
            media_mod.write_wav, media_mod.spectrogram_png = encoders
        wav_ms, png_ms = (statistics.median(parts[k][1:4]) for k in ("wav", "png"))
        print(f"[time] one media step (the noisy, clean and noise channels of a 6 x 10 s "
              f"batch: 3 WAVs and 3 spectrogram PNGs of 201 x 6001): median "
              f"{statistics.median(media_ms[1:]):.3f} ms of 3 after a first "
              f"{media_ms[0]:.3f} ms, of it the WAV writes {wav_ms:.3f} ms and the PNG "
              f"encodes {png_ms:.3f} ms (medians); B4 launches a media step {media_counts} | "
              f"{card}", flush=True)
        if media_counts != [3] * 4:
            raise AssertionError(f"a media step launched B4 {media_counts} times, want 3")
        out.update(train_ms=train_t, train_busy=train_busy, eval_ms=eval_t,
                   eval_busy=eval_busy, media_ms=statistics.median(media_ms[1:]),
                   media_wav_ms=wav_ms, media_png_ms=png_ms, media_b4=media_counts[-1])
    finally:
        for cls, fn in zip(watched, originals):
            cls.__call__ = fn
    return out


# the serving front end (phase 10): the stateful streamer's chunk, the served
# requests, the client load
STREAM_FRAMES = 48
STREAM_SECONDS = 10.0
# eight concurrent /enhance requests, in 2, 4, 6, 8 and 60 s buckets; the
# fourth is sent as FLAC (24 frames of 4096 samples, 6.1 s)
FRONT_SECONDS = (2.0, 3.3, 4.7, 6.1, 7.5, 8.2, 9.0, 10.0)
FLAC_FRAMES = 24
# the load tool's levels, each with LOAD_TOTAL requests (LOAD_TOTAL / level a
# client), so that a level's p99 is a percentile of over a hundred, not the
# slowest of a handful (once 256; phase 20 needed the time)
LOAD_LEVELS, LOAD_TOTAL, LOAD_DURATIONS = (1, 4, 16), 128, (1.0, 4.0, 10.0)


def flac_body(pcm: np.ndarray) -> bytes:
    """A mono 16 kHz 16-bit FLAC stream of int16 ``pcm`` (a multiple of 4096
    samples): STREAMINFO, then one frame a 4096-sample block with a verbatim
    subframe (its header byte, then the samples big-endian); CRCs zero."""
    pcm = np.asarray(pcm, np.int16)
    n = len(pcm)
    info = struct.pack(">HH", 4096, 4096) + bytes(6) + (
        (SR << 44) | (0 << 41) | (15 << 36) | n).to_bytes(8, "big") + bytes(16)
    out = b"fLaC" + bytes([0x80]) + len(info).to_bytes(3, "big") + info
    for k in range(n // 4096):
        out += (b"\xff\xf8\xc5\x08" + bytes([k, 0]) + b"\x02"
                + pcm[k * 4096:(k + 1) * 4096].astype(">i2").tobytes() + b"\x00\x00")
    return out


def http_request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def drive_stream(streamer, wav, sizes):
    """Push ``wav`` in pieces of ``sizes`` (the rest in one), flush; the
    concatenated output."""
    out, pos = [], 0
    for size in sizes:
        if pos >= len(wav):
            break
        out.append(streamer.push(wav[pos:pos + int(size)]))
        pos += int(size)
    if pos < len(wav):
        out.append(streamer.push(wav[pos:]))
    out.append(streamer.flush())
    return np.concatenate(out)


def front_end_phase(torch, L, all_kernels, dsp_kernels, card, tmp):
    """Phase 10, the serving front end on the card: (a) B1 continuing from a
    carried (h, c) against its plain version on both routes, in 48-step
    pieces against one launch, and with no state against the stateless call;
    (b) the one-direction flagship's ``StatefulStreamer`` on the card against
    the same streamer on the CPU and against the card's offline enhance
    (renormalized), with its launches a chunk; (c) the HTTP server
    (``serve.make_server``) in this process on the bidirectional and the
    one-direction flagship: ``/healthz``, eight concurrent ``/enhance``
    requests (one FLAC) under ``--workers 4`` and ``--fixed_batch`` against
    their solo responses, ``/stream`` against the card's streamer; (d) times.
    Returns the numbers for the ``kernels`` line and the closing lines."""
    from speech_enhancement_by_s3prl_tpu_torch.entry import build, flagship_settings
    from speech_enhancement_by_s3prl_tpu_torch.ops.audio import masked_normalize_decibel
    from speech_enhancement_by_s3prl_tpu_torch.ops.streaming import StatefulStreamer
    from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import save_checkpoint
    from speech_enhancement_by_s3prl_tpu_torch.runner.trainer import decode_wav
    from speech_enhancement_by_s3prl_tpu_torch.serve import build_enhancer, make_server
    from speech_enhancement_by_s3prl_tpu_torch.tools import serve_load, stream_client
    from speech_enhancement_by_s3prl_tpu_torch.tools.serve_load import pcm_of, wav_body

    b1 = L.lstm_bidir_tm
    stft_fused, decode_ola = dsp_kernels
    nums = {}

    # (a) B1 with a carried state, one direction (the vcb head's layers)
    worst = 0.0
    for H in (256, 252):
        for B in (1, 6):
            xw, w_hh_t = kernel_inputs(torch, B, 1001, H, SEED + H + B, ndir=1)
            g = torch.Generator().manual_seed(SEED + B)
            h0 = (2 * torch.rand(1, B, H, generator=g) - 1).cuda()
            c0 = torch.randn(1, B, H, generator=g).cuda()
            hs, (hT, cT) = b1(xw, w_hh_t, state=(h0, c0), return_state=True)
            ref, (ref_h, ref_c) = L.lstm_bidir_tm_ref(xw, w_hh_t, state=(h0, c0),
                                                      return_state=True)
            stateless = b1(xw, w_hh_t)
            none_hs, _ = b1(xw, w_hh_t, return_state=True)
            zero = torch.zeros_like(h0)
            zero_hs = b1(xw, w_hh_t, state=(zero, zero))
            pieces, st = [], (h0, c0)
            for t0 in range(0, xw.shape[2], STREAM_FRAMES):
                piece, st = b1(xw[:, :, t0:t0 + STREAM_FRAMES].contiguous(), w_hh_t, state=st,
                               return_state=True)
                pieces.append(piece)
            cut = torch.cat(pieces, dim=2)
            torch.cuda.synchronize()
            h_err = max(float((hs - ref).abs().max()), float((hT - ref_h).abs().max()))
            c_err = float((cT - ref_c).abs().max())
            cut_err = max(float((cut - hs).abs().max()), float((st[1] - cT).abs().max()))
            cut_same = torch.equal(cut, hs) and torch.equal(st[1], cT)
            stateless_same = torch.equal(none_hs, stateless) and torch.equal(zero_hs, stateless)
            print(f"[front] lstm_bidir_tm with a carried state, route {L.fwd_route(H)!r} "
                  f"ndir=1 B={B} T=1001 H={H}: h max_abs_err {h_err:.3e}, cT {c_err:.3e} "
                  f"(limit {KERNEL_TOL:.0e}); {len(pieces)} carried pieces of "
                  f"{STREAM_FRAMES} steps vs one launch {cut_err:.3e} (identical bits "
                  f"{cut_same}); no state and a zero state vs the stateless call: identical "
                  f"bits {stateless_same}", flush=True)
            if not (h_err <= KERNEL_TOL and c_err <= KERNEL_TOL and cut_err <= KERNEL_TOL
                    and stateless_same):
                raise AssertionError(f"B1 with a carried state: h {h_err}, cT {c_err}, pieces "
                                     f"{cut_err}, stateless bits {stateless_same}")
            worst = max(worst, h_err, c_err)
    nums["state_err"] = worst

    # (b) the streamer: one-direction flagship (vcb's head), 48-frame chunks
    _, model = build(bidirectional=False, device="cpu",
                     generator=torch.Generator().manual_seed(SEED + 1))
    config, paras = flagship_settings(bidirectional=False)
    uni_ckpt = save_checkpoint(os.path.join(tmp, "uni"), 0, model, None, config, paras)
    _, model = build(device="cpu", generator=torch.Generator().manual_seed(SEED))
    config, paras = flagship_settings()
    bi_ckpt = save_checkpoint(os.path.join(tmp, "bi"), 0, model, None, config, paras)
    del model
    protos = {}
    for device in ("cuda", "cpu"):
        ctx = build_enhancer(uni_ckpt, device=device).stream_ctx
        protos[device] = StatefulStreamer(ctx["model"], ctx["preprocessor"],
                                          frames_per_chunk=STREAM_FRAMES)
    n = int(STREAM_SECONDS * SR)
    wav = speech_like(n, 50)
    sizes = np.random.default_rng(SEED).integers(700, 9000, size=400)  # ragged pushes
    drive_stream(protos["cuda"].clone(), wav, sizes)  # warm
    streamer = protos["cuda"].clone()
    step_ms, analysis_ms = [], []

    def timed(fn, into):
        def call(*a):
            t0 = time.perf_counter()
            out = fn(*a)  # ends in a copy to the host: synchronous
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    streamer._model_step = timed(streamer._model_step, step_ms)
    streamer._analysis = timed(streamer._analysis, analysis_ms)
    torch.cuda.synchronize()
    # -- the main path of the streamer, between the reset and the reading --
    reset_counts(all_kernels)
    t0 = time.perf_counter()
    out_gpu = drive_stream(streamer, wav, sizes)
    stream_s = time.perf_counter() - t0
    counts = [b1.launches, b1.carried, stft_fused.launches, decode_ola.launches]
    # ---------------------------------------------------------------------
    chunks = len(step_ms)
    out_cpu = drive_stream(protos["cpu"].clone(), wav, sizes)
    vs_cpu = float(np.abs(out_gpu - out_cpu).max() / np.sqrt(np.mean(out_cpu ** 2)))
    # the card's offline enhance of the same audio at its own length (the
    # server pads to a duration bucket, whose end the STFT then sees)
    ctx = build_enhancer(uni_ckpt, device="cuda").stream_ctx
    pre, head = ctx["preprocessor"], ctx["model"]
    with torch.inference_mode():
        x = torch.from_numpy(wav)[None].cuda()
        _, down, lin, phase, *_ = pre(x[:, None, :])
        predicted, _ = head(down, lin)
        offline = decode_wav(pre, predicted, phase, torch.tensor([n]).cuda(), n,
                             -25.0)[0].cpu().numpy()
        renormed = masked_normalize_decibel(
            torch.from_numpy(out_gpu)[None].cuda(), -25.0,
            torch.ones((1, len(out_gpu)), dtype=torch.bool).cuda())[0].cpu().numpy()
    vs_offline = float(np.abs(renormed - offline[:len(renormed)]).max()
                       / np.sqrt(np.mean(offline ** 2)))
    want = [3 * chunks, 3 * chunks, 0, 0]
    nums.update(stream_vs_cpu=vs_cpu, stream_vs_offline=vs_offline,
                stream_chunks=chunks, stream_step_ms=statistics.median(step_ms),
                stream_analysis_ms=statistics.median(analysis_ms),
                stream_rtf=stream_s / STREAM_SECONDS, stream_launches=counts[0])
    print(f"[front] StatefulStreamer on cuda (one-direction 3 x 256 head, 120-d log-mel, "
          f"{STREAM_FRAMES}-frame chunks): {STREAM_SECONDS:.0f} s of speech-like audio "
          f"pushed in ragged pieces, {len(out_gpu)} samples out in {chunks} chunks; launches "
          f"(B1, B1 with state, B4, B5) {counts} (want {want}); card vs CPU streamer max "
          f"|diff| / RMS {vs_cpu:.3e}, vs the card's offline enhance (renormalized) "
          f"{vs_offline:.3e} (limit {SLICE_TOL:.0e}); model step median "
          f"{nums['stream_step_ms']:.3f} ms a chunk (min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f}), analysis {nums['stream_analysis_ms']:.3f} ms; "
          f"{stream_s * 1e3:.1f} ms for the stream, RTF {nums['stream_rtf']:.4f} | {card}",
          flush=True)
    if (counts != want or len(out_gpu) != (n // 160) * 160 or not np.isfinite(out_gpu).all()
            or not (vs_cpu <= SLICE_TOL and vs_offline <= SLICE_TOL)):
        raise AssertionError(f"streamer: launches {counts}, want {want}; length "
                             f"{len(out_gpu)}; vs CPU {vs_cpu}, vs offline {vs_offline}")

    # (c) the HTTP server, in this process, on the card
    servers = {}

    def start(name, argv):
        server = make_server(argv)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers[name] = server
        return server.server_address[1]

    try:
        port_bi = start("bi", ["--ckpt", bi_ckpt, "--port", "0"])
        port_bi4 = start("bi4", ["--ckpt", bi_ckpt, "--port", "0", "--workers", "4"])
        port_fixed = start("fixed", ["--ckpt", bi_ckpt, "--port", "0", "--workers", "4",
                                     "--fixed_batch", "--max_batch", "8"])
        port_uni = start("uni", ["--ckpt", uni_ckpt, "--port", "0"])
        status, body = http_request(port_uni, "GET", "/healthz")
        health = json.loads(body)
        status_bi, why = http_request(port_bi, "POST", "/stream", b"\x00" * 64)
        print(f"[front] /healthz {status}: {health}; /stream on the bidirectional "
              f"checkpoint {status_bi}: {why.decode()[:90]}", flush=True)
        if (status != 200 or health["devices"] != [torch.cuda.get_device_name(0)]
                or health["device"] != "cuda" or status_bi != 400
                or b"unidirectional" not in why):
            raise AssertionError(f"/healthz {status} {health}; bidirectional /stream "
                                 f"{status_bi} {why!r}")

        bodies = [wav_body(speech_like(int(s * SR), 60 + k)) for k, s in enumerate(FRONT_SECONDS)]
        flac_pcm = np.rint(np.clip(speech_like(FLAC_FRAMES * 4096, 63) * 32767, -32768, 32767))
        bodies[3] = flac_body(flac_pcm)
        for name, port in (("bi4", port_bi4), ("fixed", port_fixed)):
            solo = []
            for b in bodies:
                st, reply = http_request(port, "POST", "/enhance", b)
                if st != 200:
                    raise AssertionError(f"/enhance answered {st}: {reply[:200]!r}")
                solo.append(reply)
            answers = [None] * len(bodies)

            def ask(k):
                answers[k] = http_request(port, "POST", "/enhance", bodies[k])

            threads = [threading.Thread(target=ask, args=(k,)) for k in range(len(bodies))]
            # -- the main path of /enhance under --workers 4 --
            reset_counts(all_kernels)
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
                if th.is_alive():
                    raise AssertionError("an /enhance request did not finish within 600 s")
            counts = [stft_fused.launches, b1.launches, decode_ola.launches]
            # ----------------------------------------------------------------
            check_b5_route(decode_ola, f"/enhance under {name}")
            if any(a is None or a[0] != 200 for a in answers):
                raise AssertionError(f"{name}: statuses {[a and a[0] for a in answers]}")
            deltas = [int(np.abs(pcm_of(a[1]) - pcm_of(s)).max()) for a, s in zip(answers, solo)]
            exact = sum(a[1] == s for a, s in zip(answers, solo))
            lengths_ok = all(len(pcm_of(a[1])) == (len(flac_pcm) if k == 3 else
                                                   int(FRONT_SECONDS[k] * SR))
                             for k, a in enumerate(answers))
            nums[f"{name}_exact"], nums[f"{name}_batches"] = exact, counts[0]
            if name == "bi4":
                nums["enhance_launches"] = counts[1]
            print(f"[front] {len(bodies)} concurrent /enhance requests of "
                  f"{FRONT_SECONDS[0]:.0f}-{FRONT_SECONDS[-1]:.0f} s (one FLAC) under "
                  f"--workers 4{' --fixed_batch --max_batch 8' if name == 'fixed' else ''}: "
                  f"{counts[0]} device batches, launches (B4, B1, B5) {counts}; max |PCM "
                  f"step| vs solo {max(deltas)} (limit 1), byte-identical {exact} of "
                  f"{len(bodies)}", flush=True)
            # --fixed_batch exists for byte identity: every group has one shape
            if (max(deltas) > 1 or not lengths_ok or counts[1] != 3 * counts[0]
                    or counts[2] != counts[0] or not 1 <= counts[0] <= len(bodies)
                    or (name == "fixed" and exact != len(bodies))):
                raise AssertionError(f"{name}: PCM deltas {deltas}, byte-identical {exact} of "
                                     f"{len(bodies)}, lengths {lengths_ok}, launches {counts}")

        # /stream: 10 s through the one-direction server
        url = f"http://127.0.0.1:{port_uni}/stream"
        stream_client.stream(url, wav[:SR], SR)  # warm the connection path
        # -- the main path of /stream --
        reset_counts(all_kernels)
        status, streamed, stats = stream_client.stream(url, wav, SR, chunk_ms=100.0)
        counts = [b1.launches, b1.carried, stft_fused.launches, decode_ola.launches]
        # -------------------------------
        same = status == 200 and np.array_equal(streamed, out_gpu)
        nums.update(http_stream_launches=counts[0], first_byte_s=stats.get("first_audio_s"),
                    http_stream_rtf=stats.get("wall_s", 0.0) / STREAM_SECONDS)
        print(f"[front] /stream {status}: {STREAM_SECONDS:.0f} s in 100 ms pieces, "
              f"{len(streamed)} samples, identical bits to the card streamer {same}; launches "
              f"(B1, B1 with state, B4, B5) {counts}; first audio after "
              f"{nums['first_byte_s'] * 1e3:.1f} ms, {stats['wall_s'] * 1e3:.1f} ms for the "
              f"stream (RTF {nums['http_stream_rtf']:.4f}), max push -> enhanced lag "
              f"{stats['max_lag_s'] * 1e3:.1f} ms | {card}", flush=True)
        if not same or counts != [3 * chunks, 3 * chunks, 0, 0]:
            raise AssertionError(f"/stream: status {status}, same {same}, launches {counts}")

        # (d) times: /enhance B=1 10 s over HTTP beside the direct call
        ten = wav_body(speech_like(10 * SR, 80))
        ten_wav = pcm_of(ten).astype(np.float32) / 32768.0
        direct = servers["bi"].enhance
        http_ms, direct_ms = [], []
        for k in range(22):
            t0 = time.perf_counter()
            http_request(port_bi, "POST", "/enhance", ten)
            t1 = time.perf_counter()
            direct(ten_wav)
            t2 = time.perf_counter()
            if k >= 2:
                http_ms.append((t1 - t0) * 1e3)
                direct_ms.append((t2 - t1) * 1e3)
        nums.update(http_ms=statistics.median(http_ms), direct_ms=statistics.median(direct_ms))
        print(f"[time] /enhance B=1 10 s (the 60 s bucket) over HTTP: median "
              f"{nums['http_ms']:.3f} ms of 20 (min {min(http_ms):.3f}, max "
              f"{max(http_ms):.3f}); the same enhancer called directly: median "
              f"{nums['direct_ms']:.3f} ms (min {min(direct_ms):.3f}) | {card}", flush=True)

        # the load tool's levels against the --workers 4 server, LOAD_TOTAL
        # requests a level; then level 16 against the --fixed_batch server,
        # whose probes must come back byte-identical to their solo replies
        load = {}
        for level in LOAD_LEVELS:
            load[level] = serve_load.run_load(port_bi4, [level], LOAD_TOTAL // level,
                                              list(LOAD_DURATIONS), fixed_batch=False)
        fixed = serve_load.run_load(port_fixed, [16], LOAD_TOTAL // 16, list(LOAD_DURATIONS),
                                    fixed_batch=True)
        nums["load"] = {lv: r["levels"][str(lv)] for lv, r in load.items()}
        nums["load_fixed"] = fixed["levels"]["16"]
        print(f"[time] tools/serve_load.py --workers 4 at levels {list(LOAD_LEVELS)}, "
              f"{LOAD_TOTAL} requests of {list(LOAD_DURATIONS)} s a level: "
              + "; ".join(f"level {lv}: {r['requests']} requests, p50 {r['p50_ms']:.1f} ms, "
                          f"p99 {r['p99_ms']:.1f} ms, max {r['max_ms']:.1f} ms, "
                          f"{r['aggregate_rtf']:.1f} s of audio a second"
                          for lv, r in nums["load"].items())
              + "; probes within one PCM step "
              + str([r["identity_ok"] for r in load.values()])
              + " (exact " + ", ".join(f"{r['probe_exact_frac']:.2f}" for r in load.values())
              + f") | {card}", flush=True)
        r = nums["load_fixed"]
        print(f"[time] tools/serve_load.py --workers 4 --fixed_batch --max_batch 8 at level "
              f"16, {r['requests']} requests: p50 {r['p50_ms']:.1f} ms, p99 {r['p99_ms']:.1f} "
              f"ms, max {r['max_ms']:.1f} ms, {r['aggregate_rtf']:.1f} s of audio a second; "
              f"probes byte-identical {fixed['identity_ok']} (exact "
              f"{fixed['probe_exact_frac']:.2f}) | {card}", flush=True)
        if not all(r["identity_ok"] for r in load.values()):
            raise AssertionError(f"serve_load: bucket confinement broken {load}")
        if not (fixed["identity_ok"] and fixed["probe_exact_frac"] == 1.0):
            raise AssertionError(f"serve_load --fixed_batch: probes not byte-identical {fixed}")
    finally:
        for server in servers.values():
            server.shutdown()
            server.server_close()

    # B1 at one chunk's shape, with and without the carried state
    xw, w_hh_t = kernel_inputs(torch, 1, STREAM_FRAMES, 256, SEED, ndir=1)
    state = (torch.zeros(1, 1, 256, device="cuda"), torch.zeros(1, 1, 256, device="cuda"))
    plain = cuda_ms(torch, lambda: b1(xw, w_hh_t), iters=200)
    carried = cuda_ms(torch, lambda: b1(xw, w_hh_t, state=state, return_state=True), iters=200)
    plain2 = cuda_ms(torch, lambda: b1(xw, w_hh_t), iters=200)
    ref_ms = cuda_ms(torch, lambda: L.lstm_bidir_tm_ref(xw, w_hh_t, state=state,
                                                       return_state=True), iters=5)
    nums.update(t48_ms=min(plain, plain2), t48_state_ms=carried, t48_plain_ms=ref_ms)
    print(f"[time] lstm_bidir_tm ndir=1 B=1 T={STREAM_FRAMES} H=256: kernel {plain:.4f} / "
          f"{plain2:.4f} ms, with the carried state in and out {carried:.4f} ms, plain "
          f"version {ref_ms:.3f} ms | {card}", flush=True)
    return nums


# the active path (phase 11): config/active.yaml cut to a few steps, every
# cadence of the sampler firing; only the step counts and corpus paths change
ACTIVE_STEPS = {"total_step": 4, "log_step": 2, "eval_step": 4, "save_step": 4,
                "media_step": 2, "sampler_refresh_step": 2, "sampler_collect_step": 2,
                "active_refresh_step": 2}
ASYNC_STEPS = {**ACTIVE_STEPS, "total_step": 6, "eval_step": 100, "save_step": 100,
               "media_step": 100, "sampler_refresh_step": 4}
# a step of the sync sampler: the query's mean=True call, the candidates'
# per-sample call and the train step, each one forward and one backward
# through the three layers (B2 fwd / B2 bwd under LstmBidirTm) and one B4
SYNC_STEP_B2 = 3 * 3
# one sync scoring call, card vs CPU at the main path's shapes (32 query rows
# under mean=True, 12 candidates per sample, the 10 s bucket): the
# embeddings relative to their largest |value|, the match scores absolute.
# Both sides sum the same f32 products in other orders: the recurrence's
# backward over 1001 steps (B2 bwd's products in three TF32 passes) and the
# per-sample sums over the steps. The phase also makes the same call with
# TF32 on (the hazard: a contraction of the scoring or of `matching` outside
# full_f32) and requires it to break a limit. Read on an NVIDIA H100 80GB
# HBM3, 700.00 W, over both engines and layers None and 1: embeddings 4.5e-7
# to 6.6e-7 sound, 3.6e-4 to 2.6e-3 with TF32 on, so the embedding limit
# lies ~15x above the one and ~36x below the other; match scores 9.1e-6 to
# 2.4e-5 sound, 2.5e-5 to 8.9e-5 with TF32 on, too close to separate every
# call: the match limit is ~2x the sound reading, below TF32's on the whole
# head, and the embedding limit is the one that sees TF32 on layer 1
ACTIVE_EMB_TOL = 1e-5
ACTIVE_MATCH_TOL = 5e-5
ACTIVE_QUERY_ROWS, ACTIVE_SCORE_ROWS = 32, 12


@contextlib.contextmanager
def tf32_on(torch):
    """TF32 on for the matmuls and convolutions inside, restored after."""
    seen = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = seen


def active_phase(torch, all_kernels, card, tmp):
    """Phase 11, the active-learning sampler at full width on the card:

    (a) config/active.yaml (LSTM 3 x 256 bidirectional over 120-d log-mel +
        2 deltas; corpus paths and step counts changed, every sampler cadence
        cut to fire) through ``build_runner`` / ``Runner`` with two seeded
        full-width S3PRL upstreams and scripts/run_active.sh's flags
        (``--active_sampling --sync_sampler --eval_init --save_best``): the
        launches of B1, B2 fwd, B2 bwd, B4 and B5 in this single-threaded run
        against the count the run's calls make, B3 none (the upstreams make
        the pseudo wavs in eval mode), the media against the cadence;
    (b) one sync scoring call card against CPU at the run's shapes under
        both engines and ``active_layerid`` None and 1 (and
        ``hist_scoring``), and the card's call with TF32 on, which must break
        a limit;
    (c) the async sampler (``--sampler_device 0``) for a few steps, a
        ``collect`` returning samples;
    (d) ``--test_gradient --n_iterate 2`` writing ``sim_box.png``, and one
        step of config/pseudo_noise.yaml;
    (e) times: the per-sample scoring call at 12 x 10 s under each engine,
        the 32-row ``mean=True`` call, the train step with and without the
        sync sampler, under ``torch.profiler`` for busy and idle share.
    Returns the numbers for the ``kernels`` line and the closing line."""
    import copy

    import yaml

    from speech_enhancement_by_s3prl_tpu_torch.active import sampler as S
    from speech_enhancement_by_s3prl_tpu_torch.run_downstream import (
        build_runner,
        get_downstream_args,
    )

    b1, b2f, b2b, b3f, b3b, stft_fused, decode_ola = all_kernels[:7]
    out = {}
    corpus = os.path.join(tmp, "corpus")
    write_corpus(corpus, SEED)
    ckpts = [write_s3prl_checkpoint(torch, os.path.join(tmp, f"up{k}.ckpt"), SEED + k)
             for k in (1, 2)]

    def runner_for(name, config_name, steps, *flags):
        cfg_path = os.path.join(tmp, f"{name}.yaml")
        with open(cfg_path, "w") as f:
            # 48 candidates: the query batch takes 32
            yaml.safe_dump(shipped_config(corpus, config_name, steps, 48), f)
        args, config = get_downstream_args([
            "--config", cfg_path, "--name", name, "--expdir", os.path.join(tmp, "exp"),
            "--ckpt", ckpts[0], "--ckpt2", ckpts[1], "--downstream", "LSTM",
            "--objective", "L1", "--from_rawfeature", "--dev_num", "12", "--n_jobs", "4",
            "--seed", str(SEED), "--device", "cuda", *flags])
        random.seed(SEED)
        np.random.seed(SEED)
        runner = build_runner(args, config)
        runner.set_model()
        return runner, os.path.join(tmp, "exp", name)

    # -- (a) config/active.yaml, the sync sampler ------------------------------
    runner, run_dir = runner_for("active", "active", ACTIVE_STEPS, "--active_sampling",
                                 "--sync_sampler", "--eval_init", "--save_best")
    steps, evals, media_b4, scored = [], [], [], []
    train_step, eval_step = runner.train_step, runner.builder.eval_step
    media_logging = runner.media.media_logging

    def step(state, wavs, lengths):
        state, stats = train_step(state, wavs, lengths)
        steps.append((tuple(wavs.shape), stats))
        return state, stats

    def eval_batch(wavs, lengths, **kw):
        evals.append(tuple(wavs.shape))
        return eval_step(wavs, lengths, **kw)

    def media_recorded(step_, tag, data):
        before = stft_fused.launches
        media_logging(step_, tag, data)
        media_b4.append((step_, tag, stft_fused.launches - before))

    scoring_fn = runner._scoring_fn

    def scoring_recorded():
        inner = scoring_fn()

        def scoring(model, wavs, lengths, **kw):
            result = inner(model, wavs, lengths, **kw)
            scored.append((tuple(wavs.shape), kw.get("mean", False), tuple(result.shape)))
            return result
        return scoring

    runner.train_step, runner.builder.eval_step = step, eval_batch
    runner.media.media_logging, runner._scoring_fn = media_recorded, scoring_recorded
    t0 = time.perf_counter()
    # -- the main path of the active sampler, between the reset and the reading --
    reset_counts(all_kernels)
    runner.train()
    counts = [fn.launches for fn in all_kernels]
    active_counts = [b1.launches, b2f.launches, b2b.launches, stft_fused.launches,
                     decode_ola.launches]
    # ---------------------------------------------------------------------------
    run_s = time.perf_counter() - t0
    check_b5_route(decode_ola, "the active run")
    n_steps, n_evals, n_media = len(steps), len(evals), len(media_b4)
    losses = [float(st["loss"]) for _, st in steps]
    if n_steps != ACTIVE_STEPS["total_step"] or not all(map(math.isfinite, losses)):
        raise AssertionError(f"active run: {n_steps} steps, losses {losses}")
    # the pseudo wavs: the record split's phase and each upstream's input
    # features (B4 three times), each upstream's decode (B5 twice)
    want = [3 * n_evals, SYNC_STEP_B2 * n_steps, SYNC_STEP_B2 * n_steps,
            3 * n_steps + n_evals + n_media + 3, n_evals + 2]
    if (active_counts != want or sum(counts) != sum(want) or b3f.launches or b3b.launches
            or any(n != 1 for _, _, n in media_b4)):
        raise AssertionError(f"active run launches (B1, B2 fwd, B2 bwd, B4, B5) "
                             f"{active_counts}, want {want}; all kernels {counts}; B4 a "
                             f"media clip {[n for _, _, n in media_b4]}")
    means = [s for s in scored if s[1]]
    per_sample = [s for s in scored if not s[1]]
    if len(means) != n_steps or len(per_sample) != n_steps or any(
            s[0][0] != 32 or s[2][0] != 1 for s in means) or any(
            s[0][0] != 12 or s[2][0] != 12 for s in per_sample):
        raise AssertionError(f"the sync sampler's scoring calls {scored}")
    emb_dim = per_sample[0][2][1]
    media_tags = [(s, t) for s, t, _ in media_b4]
    record = [t for s, t in media_tags if t.startswith("record/")]
    queried = {s for s, t in media_tags if t.startswith("active/query")}
    if record != [f"record/{t}" for t in ("noisy", "clean", "noise", "pseudo_clean",
                                          "pseudo_noise")] or queried != {2, 4}:
        raise AssertionError(f"active run media {media_tags}")
    scalars = [json.loads(ln) for ln in open(os.path.join(run_dir, "scalars.jsonl"))]
    eval_losses = [s["value"] for s in scalars if s["tag"].endswith("_loss")]
    if len(eval_losses) != 2 * len(runner.rconfig["eval_splits"]) or not all(
            map(math.isfinite, [s["value"] for s in scalars])):
        raise AssertionError(f"active run scalars {scalars}")
    matched = sum(t == "active/match_noisy" for _, t in media_tags)
    print(f"[active] config/active.yaml (LSTM 3 x 256 bidirectional, 120-d log-mel + 2 "
          f"deltas; corpus paths and step counts {ACTIVE_STEPS} changed) through Runner on "
          f"cuda with --active_sampling --sync_sampler --eval_init --save_best and two "
          f"seeded full-width S3PRL upstreams: {n_steps} steps in {run_s:.2f} s, losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}, train batches "
          f"{sorted({sh for sh, _ in steps})}, eval losses "
          f"{', '.join(f'{x:.4f}' for x in eval_losses)}; scoring calls: {len(means)} "
          f"mean=True on 32 rows, {len(per_sample)} per-sample on 12 rows, embedding "
          f"{emb_dim} coordinates; launches (B1, B2 fwd, B2 bwd, B4, B5) {active_counts} = "
          f"{SYNC_STEP_B2} B2 fwd + {SYNC_STEP_B2} B2 bwd + 3 B4 a sync step, 3 B1 + 1 B4 + "
          f"1 B5 each of {n_evals} eval batches, 1 B4 each of {n_media} media clips, 3 B4 + "
          f"2 B5 for the pseudo wavs; B3 none; match media at {matched} of the 2 media "
          f"steps", flush=True)
    out.update(counts=active_counts, steps=n_steps, emb_dim=emb_dim)

    # -- (b) one sync scoring call, card vs CPU ---------------------------------
    runner.train_step, runner.builder.eval_step = train_step, eval_step
    runner.media.media_logging, runner._scoring_fn = media_logging, scoring_fn
    q_lengths, q_wavs, _ = next(iter(runner.get_dataloader(runner.get_dataset("query"),
                                                           bsz=ACTIVE_QUERY_ROWS)))
    t_lengths, t_wavs, _ = next(iter(runner.get_dataloader(runner.get_dataset("train"),
                                                           bsz=ACTIVE_SCORE_ROWS)))
    cpu_model = copy.deepcopy(runner.downstream_model).cpu()
    model = runner.downstream_model
    sound_full_f32 = S.full_f32
    errs, tf32_errs, cpu_s = {}, {}, 0.0
    cpu_query = {}

    def compared(a, b):
        """(embedding err / max, match max abs err, same match > 0 set,
        matches on the CPU, embedding shape) of (embeddings, match) pairs."""
        return (float((a[0] - b[0]).abs().max() / b[0].abs().max()),
                float((a[1] - b[1]).abs().max()), torch.equal(a[1] > 0, b[1] > 0),
                int((b[1] > 0).sum()), tuple(b[0].shape))

    for impl in ("vmap", "capture"):
        for layerid in (None, 1):
            fn = S.make_scoring_fn(runner.builder, layerid, impl=impl)
            t1 = time.perf_counter()
            if layerid not in cpu_query:  # mean=True runs no per-sample engine
                cpu_query[layerid] = fn(cpu_model, q_wavs, q_lengths, mean=True)
            t = fn(cpu_model, t_wavs, t_lengths)
            cpu = (t.detach(), S.matching(cpu_query[layerid], t).detach())
            cpu_s += time.perf_counter() - t1
            got = {}
            for name in ("sound", "tf32"):
                # the same call with TF32 on in place of full_f32
                S.full_f32 = sound_full_f32 if name == "sound" else (lambda: tf32_on(torch))
                try:
                    q = fn(model, q_wavs, q_lengths, mean=True)
                    t = fn(model, t_wavs, t_lengths)
                    got[name] = (t.detach().cpu(), S.matching(q, t).detach().cpu())
                finally:
                    S.full_f32 = sound_full_f32
            errs[(impl, layerid)] = compared(got["sound"], cpu)
            tf32_errs[(impl, layerid)] = compared(got["tf32"], cpu)
    hist = [S.hist_scoring(runner.preprocessor, torch.from_numpy(t_wavs).to(dev)).cpu()
            for dev in ("cuda", "cpu")]
    hist_err = float((hist[0] - hist[1]).abs().max())
    print(f"[active] one sync scoring call card vs CPU ({ACTIVE_SCORE_ROWS} candidates and "
          f"{ACTIVE_QUERY_ROWS} query rows of the run's data, "
          f"{t_wavs.shape[-1] / SR:.0f} / {q_wavs.shape[-1] / SR:.0f} s padded, the run's "
          f"head; the CPU side {cpu_s:.1f} s): "
          + "; ".join(f"{impl} layer {lid}: {shape[1]} coordinates, embedding err / max "
                      f"{e:.2e} (limit {ACTIVE_EMB_TOL:.0e}; TF32 on "
                      f"{tf32_errs[(impl, lid)][0]:.2e}), match max abs err {m:.2e} (limit "
                      f"{ACTIVE_MATCH_TOL:.0e}; TF32 on {tf32_errs[(impl, lid)][1]:.2e}), "
                      f"match > 0 for {n} of {shape[0]} on both (TF32 on: same set "
                      f"{tf32_errs[(impl, lid)][2]})"
                      for (impl, lid), (e, m, _, n, shape) in errs.items())
          + f"; hist_scoring max abs err {hist_err:.2e}", flush=True)
    for key, (emb, match, same, _, _) in errs.items():
        if not (emb <= ACTIVE_EMB_TOL and match <= ACTIVE_MATCH_TOL and same):
            raise AssertionError(f"scoring {key} card vs CPU: embedding {emb}, match "
                                 f"{match}, same match>0 set {same}")
    for key, (emb, match, same, _, _) in tf32_errs.items():
        if emb <= ACTIVE_EMB_TOL and match <= ACTIVE_MATCH_TOL and same:
            raise AssertionError(f"scoring {key} with TF32 on passed the limits (embedding "
                                 f"{emb}, match {match}): they cannot see the hazard")
    if not hist_err <= ACTIVE_MATCH_TOL:
        raise AssertionError(f"hist_scoring card vs CPU {hist_err}")
    out.update(errs=errs, tf32_errs=tf32_errs)
    del cpu_model, cpu_query

    # -- (c) the async sampler ----------------------------------------------
    arun, _ = runner_for("async", "active", ASYNC_STEPS, "--active_sampling",
                         "--sampler_device", "0")
    collected, starts = [], []
    a_train, a_start = arun.train_step, arun._start_sampler

    def a_start_recorded():
        a_start()
        starts.append(arun.global_step)

    def a_step(state, wavs, lengths):
        # before a collect step, wait (at most 120 s) until the sampler's
        # thread has kept a sample, so that the collect has one to return
        nxt = arun.global_step + 1
        if nxt % ASYNC_STEPS["sampler_collect_step"] == 0 and arun.sampler is not None:
            t1 = time.perf_counter()
            while (not any(arun.sampler._buffers.values()) and arun.sampler.alive
                   and time.perf_counter() - t1 < 120):
                time.sleep(0.05)
        return a_train(state, wavs, lengths)

    a_collect = S.AsyncSampler.collect

    def collect_recorded(self):
        got = a_collect(self)
        collected.append(sum(len(v) for v in got.values()))
        return got

    arun.train_step, arun._start_sampler = a_step, a_start_recorded
    S.AsyncSampler.collect = collect_recorded
    t0 = time.perf_counter()
    try:
        arun.train()
    finally:
        S.AsyncSampler.collect = a_collect
    async_s = time.perf_counter() - t0
    print(f"[active] async sampler (--sampler_device 0, its own stream, a snapshot of the "
          f"head each start): {ASYNC_STEPS['total_step']} steps in {async_s:.2f} s, started "
          f"at steps {starts}, collects returned {collected} samples, stopped at the end: "
          f"{arun.sampler is None}", flush=True)
    if not (collected and max(collected) > 0 and arun.sampler is None and len(starts) >= 2):
        raise AssertionError(f"async sampler: starts {starts}, collects {collected}")
    out.update(async_collected=collected, async_starts=starts)
    del arun

    # -- (d) --test_gradient and config/pseudo_noise.yaml ----------------------
    grun, gdir = runner_for("gradient", "active", ACTIVE_STEPS, "--test_gradient",
                            "--n_iterate", "2")
    sims = grun.test_gradient()
    box = os.path.join(gdir, "sim_box.png")
    n_sims = {k: len(v) for k, v in sorted(sims.items())}
    if not (os.path.exists(box) and sum(n_sims.values()) > 0):
        raise AssertionError(f"test_gradient: {box} {os.path.exists(box)}, {n_sims}")
    del grun
    prun, _ = runner_for("pseudo_noise", "pseudo_noise", {**ACTIVE_STEPS, "total_step": 1},
                         "--active_sampling", "--sync_sampler")
    p_steps = []
    p_train = prun.train_step

    def p_step(state, wavs, lengths):
        state, stats = p_train(state, wavs, lengths)
        p_steps.append(float(stats["loss"]))
        return state, stats

    prun.train_step = p_step
    prun.train()
    print(f"[active] --test_gradient --n_iterate 2: sim_box.png {png_size(box)} pixels, "
          f"similarities a case {n_sims}; config/pseudo_noise.yaml (buffer weights [1, 0, 0, "
          f"0]) one sync-sampled step, loss {p_steps}", flush=True)
    if len(p_steps) != 1 or not math.isfinite(p_steps[0]):
        raise AssertionError(f"pseudo_noise step {p_steps}")
    del prun

    # -- (e) times ---------------------------------------------------------------
    rng = np.random.default_rng(SEED)
    rows = []
    for i in range(32):
        c = speech_like(10 * SR, 70 + i)
        n = 0.05 * rng.standard_normal(c.shape).astype(np.float32)
        rows.append(np.stack([c + n, c, n]))
    wavs = torch.from_numpy(np.stack(rows)).cuda()
    lengths = torch.full((32,), wavs.shape[-1], dtype=torch.long, device="cuda")
    model, state = runner.downstream_model, runner.state
    fns = {impl: S.make_scoring_fn(runner.builder, impl=impl) for impl in ("vmap", "capture")}
    score_runs = {"vmap": [], "capture": []}
    for impl in ("vmap", "capture", "capture", "vmap"):
        score_runs[impl] += synced_ms(torch, lambda f=fns[impl]: f(model, wavs[:12],
                                                                   lengths[:12]), runs=5)
    score_ms = {k: statistics.median(v) for k, v in score_runs.items()}
    mean_ms = statistics.median(synced_ms(torch, lambda: fns["vmap"](
        model, wavs, lengths, mean=True), runs=5))

    def sync_step():
        q = fns["vmap"](model, wavs, lengths, mean=True)
        t = fns["vmap"](model, wavs[:12], lengths[:12])
        keep = torch.nonzero(S.matching(q, t) > 0).cpu()
        runner.train_step(state, wavs[:6], lengths[:6])
        return keep

    plain = {"plain": [], "sync": []}
    for name in ("plain", "sync", "sync", "plain"):
        plain[name] += synced_ms(torch, (lambda: runner.train_step(state, wavs[:6],
                                                                    lengths[:6]))
                                 if name == "plain" else sync_step, runs=5)
    step_ms = {k: statistics.median(v) for k, v in plain.items()}
    busy = {
        "per-sample vmap 12 rows": device_busy(torch, lambda: fns["vmap"](
            model, wavs[:12], lengths[:12]), calls=3),
        "per-sample capture 12 rows": device_busy(torch, lambda: fns["capture"](
            model, wavs[:12], lengths[:12]), calls=3),
        "mean=True 32 rows": device_busy(torch, lambda: fns["vmap"](
            model, wavs, lengths, mean=True), calls=3),
        "train step B=6": device_busy(torch, lambda: runner.train_step(
            state, wavs[:6], lengths[:6]), calls=3),
        "sync-sampled step": device_busy(torch, sync_step, calls=3),
    }
    print(f"[time] active sampler at full width (LSTM 3 x 256 bidirectional, 10 s rows, "
          f"{emb_dim} coordinates an embedding): per-sample scoring 12 rows, median of 10 "
          f"(in turns vmap, capture, capture, vmap) vmap {score_ms['vmap']:.3f} ms, capture "
          f"{score_ms['capture']:.3f} ms; mean=True 32 rows {mean_ms:.3f} ms; train step B=6 "
          f"{step_ms['plain']:.3f} ms, with the sync sampler (both scoring calls, the match "
          f"read back, the step) {step_ms['sync']:.3f} ms; under torch.profiler: "
          + "; ".join(f"{k} wall {w:.3f} ms, device busy {b_:.3f} ms, idle share "
                      f"{max(0.0, 1 - b_ / w):.3f}, {kn:.0f} kernels"
                      for k, (b_, w, kn, _) in busy.items()) + f" | {card}", flush=True)
    out.update(score_ms=score_ms, mean_ms=mean_ms, step_ms=step_ms, busy=busy)
    return out


# bf16 compute on the card (phase 12): B3 bf16 against its plain version, the
# Mockingjay joint finetune, the flagship head and the upstream mode trained and
# served with --compute_dtype bf16, and the bf16 times beside f32.
# B3 bf16 vs its plain version, errors in bf16 ulps of the plain version's
# largest |value|. The plain version rounds p to bf16 against the row's final
# maximum, the kernel's online softmax against the running one, so out moves by
# a rounding of p here and there: at most 1.00 ulp measured (B=2 T=37), limit 2.
# lse is f32 from the same f32 logits summed in other orders (~1.5e-7 measured).
# dq, dk and dv come from the same bf16 operands rounded at the same points and
# f32 sums in other orders: at most 0.5 ulp measured in the first card run of
# these shapes, so 1 ulp leaves a factor of two; and at least 99.8% of their
# elements came out bit-identical (limit 99%): a mask or operand fault moves
# whole rows.
B3_BF16_OUT_ULPS, B3_BF16_LSE_TOL, B3_BF16_GRAD_ULPS, B3_BF16_GRAD_SAME = 2.0, 1e-5, 1.0, 0.99
B3_BF16_CASES = (  # B, T, N, D, rate, kbias
    (6, 1001, 12, 64, 0.1, False),
    (6, 1001, 12, 64, 0.0, False),
    (3, 130, 12, 64, 0.1, True),
    (2, 37, 12, 64, 0.1, True),
    (2, 70, 4, 32, 0.2, True),
    (2, 70, 2, 128, 0.2, False),
    (2, 77, 3, 256, 0.0, False),
) + tuple((B, T, N, D, 0.1, bias) for B, T, N, D, bias in (
    (3, 130, 8, 16, True), (2, 201, 16, 48, False), (2, 130, 3, 256, True),
    (2, 130, 4, 192, False)))
# head widths between the kernels' instances (ROADMAP C7: the wrappers run
# them zero-padded to 32, 64 and 256) and the widest instance, 256, f32 at
# rate 0.1 against phase 3's limit B3_TOL, bf16 in B3_BF16_CASES above, and
# timed at the Mockingjay length (192 and 256 beside SDPA at rate 0)
B3_PADDED_CASES = ((3, 130, 8, 16, True), (2, 201, 16, 48, False), (2, 130, 3, 256, True),
                   (2, 130, 4, 192, False))
B3_PADDED_TIMES = ((6, 1001, 8, 16), (6, 1001, 16, 48), (6, 1001, 4, 192), (6, 1001, 3, 256))
B3_WIDE = (192, 256)
# the encoders of phase 12's steps card against CPU, dropout 0.1 (B3 in every
# layer): hidden 128 in 8 heads of 16 (zero-padded to 32), FFN 512, 3 layers;
# hidden 768 in 3 heads of 256 (the D = 256 instances), FFN 3072, 2 layers
HEADS16 = dict(hidden_size=128, num_hidden_layers=3, num_attention_heads=8,
               intermediate_size=512, hidden_dropout_prob=0.1,
               attention_probs_dropout_prob=0.1)
HEADS256 = dict(hidden_size=768, num_hidden_layers=2, num_attention_heads=3,
                intermediate_size=3072, hidden_dropout_prob=0.1,
                attention_probs_dropout_prob=0.1)
# the window criterion of tests/test_torch_port_bf16.py, the card against the
# CPU: with d(a, b) = RMS(a - b) / RMS(CPU f32), d(card bf16, CPU bf16) <= 1.5
# d(CPU bf16, CPU f32) and 0.5 <= d(card bf16, card f32) / d(CPU bf16, CPU f32)
# <= 2 (the card rounds where the CPU rounds; a card run in f32 fails)
WINDOW_NEAR, WINDOW_LOW, WINDOW_HIGH = 1.5, 0.5, 2.0
BF16_STEPS, BF16_RESUME_STEPS, BF16_HEAD_STEPS = 4, 2, 4


def bf16_ulp(x) -> float:
    """One bf16 ulp at the largest |value| of x."""
    return 2.0 ** (math.floor(math.log2(float(x.float().abs().max()))) - 7)


def window(torch, card_bf16, card_f32, cpu_bf16, cpu_f32, what):
    """The window criterion on four tensors (or arrays); raises outside it and
    returns (near, ratio). Four CUDA tensors are compared on the card."""
    xs = (card_bf16, card_f32, cpu_bf16, cpu_f32)
    if all(getattr(x, "is_cuda", False) for x in xs):
        a = [x.detach().double() for x in xs]
    else:
        a = [torch.as_tensor(np.asarray(x.detach().cpu() if hasattr(x, "detach") else x,
                                        dtype=np.float64)) for x in xs]
    rms = lambda x: float(x.pow(2).mean().sqrt())  # noqa: E731
    scale = rms(a[3])
    base = rms(a[2] - a[3]) / scale
    near, ratio = rms(a[0] - a[2]) / scale / base, rms(a[0] - a[1]) / scale / base
    if not (base > 0 and near <= WINDOW_NEAR and WINDOW_LOW <= ratio <= WINDOW_HIGH):
        raise AssertionError(f"{what}: d(card bf16, CPU bf16) {near:.3f} x d(CPU bf16, CPU "
                             f"f32) (limit {WINDOW_NEAR}), d(card bf16, card f32) {ratio:.3f} "
                             f"x (limits {WINDOW_LOW}, {WINDOW_HIGH}); d(CPU bf16, f32) {base}")
    return near, ratio


def padded_head_checks(torch, A, corpus, card):
    """Phase 12 (a): B3 at head widths between its instances (16, 48, 192:
    zero-padded to 32, 64, 256 by the wrappers) and at 256, f32 fwd and bwd
    at rate 0.1 against the plain version under phase 3's B3_TOL (bwd twice
    for identical bits; bf16 in B3_BF16_CASES); their times at the Mockingjay
    length beside the plain version and the bound of the true and of the
    padded work, and SDPA at rate 0 beside those of 192 and 256; and one
    Mockingjay joint-finetune step at ``HEADS16`` (8 heads of 16) and one at
    ``HEADS256`` (3 heads of 256) with dropout live, card against CPU with the
    same salts under phase 6's limits, with a B3 fwd and a B3 bwd launch a
    layer."""
    from speech_enhancement_by_s3prl_tpu_torch.data.datasets import OnlineDataset
    from speech_enhancement_by_s3prl_tpu_torch.entry import build_mockingjay_train
    from speech_enhancement_by_s3prl_tpu_torch.models.transformer import (
        SaltStream,
        TransformerConfig,
    )
    from speech_enhancement_by_s3prl_tpu_torch.runner.trainer import make_context

    out = {"err": 0.0, "times": {}}
    salt, batch0 = (0x9E3779B9, 0xDEADBEEF), 3
    for B, T, N, D, bias in B3_PADDED_CASES:
        g = torch.Generator().manual_seed(SEED + T + D)
        q, k, v = torch.randn(B, T, 3 * N * D, generator=g).cuda().split(N * D, dim=-1)
        kbias = (2.0 * torch.randn(B, T, generator=g)).cuda() if bias else None
        dout = torch.randn(B, T, N * D, generator=g).cuda()
        args = (D ** -0.5, 0.1, salt, kbias, batch0)
        reset_counts((A.flash_attention_fwd, A.flash_attention_bwd))
        o, lse = A.flash_attention_fwd(q, k, v, *args, n_heads=N)
        ref_o, ref_lse = A.flash_attention_ref(q, k, v, *args, n_heads=N)
        grads = A.flash_attention_bwd(q, k, v, ref_o, ref_lse, dout, *args, n_heads=N)
        again = A.flash_attention_bwd(q, k, v, ref_o, ref_lse, dout, *args, n_heads=N)
        ref_grads = A.flash_attention_bwd_ref(q, k, v, ref_o, ref_lse, dout, *args, n_heads=N)
        torch.cuda.synchronize()
        counts = (A.flash_attention_fwd.launches, A.flash_attention_bwd.launches)
        errs = {"out": rel_err(o, ref_o), "lse": rel_err(lse, ref_lse)}
        errs.update({n: rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), grads, ref_grads)})
        twice = all(torch.equal(a, b) for a, b in zip(grads, again))
        print(f"[bf16] flash_attention f32 at a padded head width B={B} T={T} N={N} D={D} "
              f"(instance {A.instance_width(D)}) rate=0.1 kbias={bias}: err / max|value| "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f" (limit {B3_TOL:.0e}); launches (fwd, bwd) {counts}; bwd twice: identical "
              f"bits {twice}", flush=True)
        if not (all(e <= B3_TOL for e in errs.values()) and twice and counts == (1, 2)):
            raise AssertionError(f"B3 at D={D}: {errs}, twice {twice}, launches {counts}")
        out["err"] = max([out["err"], float((o - ref_o).abs().max())]
                         + [float((a - b).abs().max()) for a, b in zip(grads, ref_grads)])
    for B, T, N, D in B3_PADDED_TIMES:
        g = torch.Generator().manual_seed(SEED + D)
        q, k, v = torch.randn(B, T, 3 * N * D, generator=g).cuda().split(N * D, dim=-1)
        dout = torch.randn(B, T, N * D, generator=g).cuda()
        args = (D ** -0.5, 0.1, salt, None, 0)
        o, lse = A.flash_attention_fwd(q, k, v, *args, n_heads=N)
        qb, kb, vb, ob, db = (x.to(torch.bfloat16) for x in (q, k, v, o, dout))
        ob, lb = A.flash_attention_fwd(qb, kb, vb, *args, n_heads=N)
        fns = {"fwd": (lambda: A.flash_attention_fwd(q, k, v, *args, n_heads=N),
                       lambda: A.flash_attention_ref(q, k, v, *args, n_heads=N)),
               "bwd": (lambda: A.flash_attention_bwd(q, k, v, o, lse, dout, *args, n_heads=N),
                       lambda: A.flash_attention_bwd_ref(q, k, v, o, lse, dout, *args,
                                                         n_heads=N)),
               "fwd_bf16": (lambda: A.flash_attention_fwd(qb, kb, vb, *args, n_heads=N),
                            lambda: A.flash_attention_ref(qb, kb, vb, *args, n_heads=N)),
               "bwd_bf16": (lambda: A.flash_attention_bwd(qb, kb, vb, ob, lb, db, *args,
                                                          n_heads=N),
                            lambda: A.flash_attention_bwd_ref(qb, kb, vb, ob, lb, db, *args,
                                                              n_heads=N))}
        W = A.instance_width(D)
        if D in B3_WIDE:
            out["times"][("sdpa", D)] = sdpa_times(torch, q, k, v, dout, N, D)
            print(f"[time] scaled_dot_product_attention rate 0 (a yardstick, not a route) "
                  f"B={B} T={T} N={N} D={D}: (f32 fwd, f32 bwd, bf16 fwd, bf16 bwd) "
                  + ", ".join(f"{x:.4f}" for x in out["times"][("sdpa", D)]) + f" ms | {card}",
                  flush=True)
        for name, (kern, plain) in fns.items():
            a, c, a2 = cuda_ms(torch, kern, 10), cuda_ms(torch, plain, 2), cuda_ms(torch, kern, 10)
            products = 2 if name.startswith("fwd") else 5
            fn = attention_bound_bf16 if name.endswith("bf16") else attention_bound
            true_b, pad_b = fn(B, T, N, D, products), fn(B, T, N, W, products)
            out["times"][(name, D)] = (min(a, a2), c, true_b, pad_b)
            print(f"[time] B3 {name} B={B} T={T} N={N} D={D} (padded to {W}), rate 0.1: kernel "
                  f"{a:.4f} / {a2:.4f} ms, plain {c:.3f} ms; bound of the true work "
                  f"{true_b[0]:.4f} ms by {true_b[1]}, of the padded work {pad_b[0]:.4f} ms "
                  f"({W / D:.2f}x the products) | {card}", flush=True)

    # one joint-finetune step at 8 heads of 16 and one at 3 heads of 256, card
    # against CPU
    fixed_set = OnlineDataset(speech={"filestrs": os.path.join(corpus, "speech")},
                              noise={"filestrs": os.path.join(corpus, "noise")},
                              max_time=4000, snrs=[0])
    lengths_np, wavs_np = fixed_set.collate_fn([fixed_set[i] for i in range(6)], pad_to=4 * SR)
    for key, width, seed in (("step", HEADS16, 16), ("step256", HEADS256, 256)):
        cfg = TransformerConfig(input_dim=80, **width)
        weights = build_mockingjay_train(cfg, device="cpu", generator=torch.Generator(
        ).manual_seed(SEED + seed)).model.state_dict()
        sides = {}
        for device in ("cuda", "cpu"):
            builder = build_mockingjay_train(cfg, device=device)
            builder.model.load_state_dict(weights)
            builder.model.train()
            wavs = torch.from_numpy(wavs_np).to(device)
            lengths = torch.from_numpy(lengths_np).to(device)
            params = list(builder.model.parameters())
            reset_counts((A.flash_attention_fwd, A.flash_attention_bwd))
            loss, _ = builder.loss_fn(make_context(builder.preprocessor, wavs, lengths, 0, 1),
                                      SaltStream(SEED, seed))
            g = torch.autograd.grad(loss, params)
            counts = (A.flash_attention_fwd.launches, A.flash_attention_bwd.launches)
            flat = torch.cat([x.reshape(-1) for x in g]).double().cpu()
            sides[device] = (float(loss.detach()), float(flat.norm()), flat, counts)
        (gl, gn, gg, gc), (cl, cn, cg, _) = sides["cuda"], sides["cpu"]
        loss_rel, norm_rel = abs(gl - cl) / abs(cl), abs(gn - cn) / abs(cn)
        grad_rel = float((gg - cg).norm() / cg.norm())
        layers, heads = width["num_hidden_layers"], width["num_attention_heads"]
        hidden = width["hidden_size"]
        print(f"[bf16] Mockingjay step at {heads} heads of {hidden // heads} (hidden {hidden}, "
              f"{layers} layers, dropout 0.1, B=6, 4 s) card vs CPU, same salts: loss rel "
              f"{loss_rel:.3e}, grad norm rel {norm_rel:.3e} (limit {TRAIN_LOSS_TOL:.0e}), "
              f"|g_card - g_cpu| / |g_cpu| {grad_rel:.3e} (limit {TRAIN_GRAD_TOL:.0e}); launches "
              f"(B3 fwd, B3 bwd) {gc} (want {(layers, layers)}) | {card}", flush=True)
        if not (loss_rel <= TRAIN_LOSS_TOL and norm_rel <= TRAIN_LOSS_TOL
                and grad_rel <= TRAIN_GRAD_TOL and gc == (layers, layers)):
            raise AssertionError(f"the {key} Mockingjay step: loss {loss_rel}, norm "
                                 f"{norm_rel}, grad {grad_rel}, launches {gc}")
        out[key] = {"loss_rel": loss_rel, "grad_rel": grad_rel, "launches": gc}
    return out


def sdpa_times(torch, q, k, v, dout, N, D):
    """``scaled_dot_product_attention`` at rate 0 on the (B, T, N * D) q, k,
    v of B3: (f32 forward, f32 backward, bf16 forward, bf16 backward) ms, the
    backward as forward + backward minus forward under autograd (phase 7's
    yardstick, at a wide head)."""
    import torch.nn.functional as F

    B, T, _ = q.shape
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        heads = [x.to(dtype).reshape(B, T, N, D).transpose(1, 2).detach().requires_grad_()
                 for x in (q, k, v)]
        dout_h = dout.to(dtype).reshape(B, T, N, D).transpose(1, 2)

        def forward():
            return F.scaled_dot_product_attention(*heads, scale=D ** -0.5)

        def both():
            return torch.autograd.grad(forward(), heads, dout_h)

        with torch.no_grad():
            fwd = cuda_ms(torch, forward, 10, warmup=2)
        out += [fwd, cuda_ms(torch, both, 10, warmup=2) - cuda_ms(torch, forward, 10, warmup=2)]
    return tuple(out)


def flash_bf16_checks(torch, A):
    """Phase 12 (a): B3 fwd bf16 and B3 bwd bf16 against their plain versions
    on the card, q, k and v the thirds of one bf16 projection. Returns the
    largest absolute errors (fwd, bwd) and the worst readings in ulps."""
    worst = {"fwd": 0.0, "bwd": 0.0, "out_ulps": 0.0, "grad_ulps": 0.0, "lse": 0.0,
             "grad_same": 1.0}
    salt, batch0 = (0x9E3779B9, 0xDEADBEEF), 3
    for B, T, N, D, rate, bias in B3_BF16_CASES:
        g = torch.Generator().manual_seed(SEED + T)
        qkv = torch.randn(B, T, 3 * N * D, generator=g).cuda().to(torch.bfloat16)
        q, k, v = qkv.split(N * D, dim=-1)
        kbias = (2.0 * torch.randn(B, T, generator=g)).cuda() if bias else None
        dout = torch.randn(B, T, N * D, generator=g).cuda().to(torch.bfloat16)
        args = (D ** -0.5, rate, salt, kbias, batch0)
        out, lse = A.flash_attention_fwd(q, k, v, *args, n_heads=N)
        ref_out, ref_lse = A.flash_attention_ref(q, k, v, *args, n_heads=N)
        grads = A.flash_attention_bwd(q, k, v, ref_out, ref_lse, dout, *args, n_heads=N)
        again = A.flash_attention_bwd(q, k, v, ref_out, ref_lse, dout, *args, n_heads=N)
        ref_grads = A.flash_attention_bwd_ref(q, k, v, ref_out, ref_lse, dout, *args,
                                              n_heads=N)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError("flash_attention_bwd_bf16 gave other bits on the same inputs")
        if out.dtype != torch.bfloat16 or any(x.dtype != torch.bfloat16 for x in grads):
            raise AssertionError(f"B3 bf16 returned {out.dtype}, {[x.dtype for x in grads]}")
        out_ulps = float((out.float() - ref_out.float()).abs().max()) / bf16_ulp(ref_out)
        lse_err = float(((lse - ref_lse).abs() / ref_lse.abs().clamp_min(1e-30)).max())
        grad_ulps = {n: float((a.float() - b.float()).abs().max()) / bf16_ulp(b)
                     for n, a, b in zip(("dq", "dk", "dv"), grads, ref_grads)}
        grad_same = {n: float((a == b).float().mean())
                     for n, a, b in zip(("dq", "dk", "dv"), grads, ref_grads)}
        print(f"[bf16] flash_attention bf16 B={B} T={T} N={N} D={D} rate={rate} "
              f"kbias={bias}: out {out_ulps:.2f} ulp of max|out| (limit "
              f"{B3_BF16_OUT_ULPS:.0f}), lse rel {lse_err:.2e} (limit {B3_BF16_LSE_TOL:.0e}), "
              + ", ".join(f"{n} {grad_ulps[n]:.2f} ulp ({grad_same[n]:.4f} identical)"
                          for n in grad_ulps)
              + f" (limits {B3_BF16_GRAD_ULPS:.0f} ulp, {B3_BF16_GRAD_SAME} identical); bwd "
              f"twice: identical bits", flush=True)
        if not (out_ulps <= B3_BF16_OUT_ULPS and lse_err <= B3_BF16_LSE_TOL
                and all(e <= B3_BF16_GRAD_ULPS for e in grad_ulps.values())
                and all(s >= B3_BF16_GRAD_SAME for s in grad_same.values())):
            raise AssertionError(f"B3 bf16 disagrees with its plain version: out {out_ulps}, "
                                 f"lse {lse_err}, grads {grad_ulps}, identical {grad_same}")
        worst["fwd"] = max(worst["fwd"], float((out.float() - ref_out.float()).abs().max()),
                           float((lse - ref_lse).abs().max()))
        worst["bwd"] = max([worst["bwd"]] + [float((a.float() - b.float()).abs().max())
                                             for a, b in zip(grads, ref_grads)])
        worst["out_ulps"] = max(worst["out_ulps"], out_ulps)
        worst["lse"] = max(worst["lse"], lse_err)
        worst["grad_ulps"] = max([worst["grad_ulps"]] + list(grad_ulps.values()))
        worst["grad_same"] = min([worst["grad_same"]] + list(grad_same.values()))

    # views TMA cannot read in place (a projection one column wider, its first
    # column dropped: rows 2 bytes off a 16-byte boundary): the wrappers hand
    # the kernels contiguous copies, so the bits are those of contiguous inputs
    g = torch.Generator().manual_seed(SEED + 1)
    wide = torch.randn(2, 130, 3 * 768 + 1, generator=g).cuda().to(torch.bfloat16)
    views = wide[..., 1:].split(768, dim=-1)
    dout = torch.randn(2, 130, 768, generator=g).cuda().to(torch.bfloat16)
    if any(A.tma_ready(x.data_ptr(), x.stride(), x.element_size()) for x in views):
        raise AssertionError("the unaligned views passed tma_ready")
    copies = [x.contiguous() for x in views]
    got = A.flash_attention_fwd_bf16(*views, 0.125, 0.1, salt, n_heads=12)
    want = A.flash_attention_fwd_bf16(*copies, 0.125, 0.1, salt, n_heads=12)
    got_g = A.flash_attention_bwd_bf16(*views, *want, dout, 0.125, 0.1, salt, n_heads=12)
    want_g = A.flash_attention_bwd_bf16(*copies, *want, dout, 0.125, 0.1, salt, n_heads=12)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got + got_g, want + want_g)):
        raise AssertionError("B3 bf16 on unaligned views differs from contiguous copies")
    print("[bf16] B3 bf16 on views 2 bytes off a 16-byte boundary (copied for TMA): bit for "
          "bit the kernels on contiguous inputs", flush=True)

    # FlashAttention under autograd on a bf16 projection: bf16 out and
    # gradients, the bits of the two wrappers called directly
    g = torch.Generator().manual_seed(SEED)
    qkv = torch.randn(2, 130, 3 * 768, generator=g).cuda().to(torch.bfloat16)
    dout = torch.randn(2, 130, 768, generator=g).cuda().to(torch.bfloat16)
    x = qkv.clone().requires_grad_()
    out = A.flash_attention(*x.split(768, dim=-1), 0.125, 0.1, salt, n_heads=12)
    grad = torch.autograd.grad(out, x, dout)[0]
    q, k, v = qkv.split(768, dim=-1)
    o, lse = A.flash_attention_fwd_bf16(q, k, v, 0.125, 0.1, salt, n_heads=12)
    direct = torch.cat(A.flash_attention_bwd_bf16(q, k, v, o, lse, dout, 0.125, 0.1, salt,
                                                  n_heads=12), dim=-1)
    torch.cuda.synchronize()
    if not (grad.dtype == out.dtype == torch.bfloat16 and torch.equal(out, o)
            and torch.equal(grad, direct)):
        raise AssertionError("FlashAttention in bf16 disagrees with its kernels")
    print("[bf16] FlashAttention on a bf16 (2, 130, 3 x 768) projection: bf16 out and "
          "gradient, bit for bit the kernels called directly", flush=True)
    return worst


# B3 bf16's CUDA-core floor: per logit one exponential (one MUFU.EX2 result;
# an H100 SM gives 16 a clock) and the dropout hash (HASH_INT_OPS 32-bit
# integer operations; 64 a clock), on 132 SMs at the card's top SM clock of
# 1980 MHz (the H100 SXM's clocks.max.sm as nvidia-smi reports it)
SMS, SM_CLOCK, MUFU_PER_CLOCK, INT32_PER_CLOCK, HASH_INT_OPS = 132, 1.98e9, 16, 64, 10


def attention_core_floor_bf16(B, T, N, passes):
    """The least time in ms the CUDA cores need for B3 bf16's per-logit work
    over ``passes`` passes of the B * N * T * T logits (1 forward; 2 backward,
    whose dk/dv and dq kernels both recompute p and the keep bits): the
    exponentials on the special-function units and the hash on the integer
    units run on separate pipes, so the slower of the two (the hash) binds.
    Returns (floor, exponential ms, hash ms)."""
    logits = B * N * T * T * passes
    exp_ms = logits / (SMS * MUFU_PER_CLOCK * SM_CLOCK) * 1e3
    hash_ms = logits * HASH_INT_OPS / (SMS * INT32_PER_CLOCK * SM_CLOCK) * 1e3
    return max(exp_ms, hash_ms), exp_ms, hash_ms


def mockingjay_bf16_run(torch, corpus, tmp, counted):
    """Phase 12 (b): the Mockingjay joint finetune --from_waveform --compute_dtype
    bf16 through build_runner / Runner, 4 steps with evals and saves and a
    2-step resume; the launches of ``counted`` (B1, B2 fwd, B2 bwd, B3 fwd, B3
    bwd, B3 fwd bf16, B3 bwd bf16). Returns (launches of the run, run dir)."""
    from speech_enhancement_by_s3prl_tpu_torch.run_downstream import (
        build_runner,
        get_downstream_args,
        get_parser,
    )

    expdir = os.path.join(tmp, "exp")
    config = train_config(corpus)
    config["model"] = {"Mockingjay": {}}
    config["runner"].update(total_step=BF16_STEPS, log_step=2, eval_step=2, save_step=2)
    args = get_parser().parse_args([
        "--name", "mockingjay_bf16", "--expdir", expdir, "--downstream", "Mockingjay",
        "--objective", "SISDR", "--optim", "BertAdam", "--from_waveform",
        "--compute_dtype", "bf16", "--dev_num", "3", "--n_jobs", "4", "--seed", str(SEED),
        "--device", "cuda",
    ])
    run_dir = os.path.join(expdir, "mockingjay_bf16")

    def run(runner, n_steps, what):
        losses, evals = [], []
        train_step, eval_step = runner.train_step, runner.builder.eval_step

        def step(state, wavs, lengths):
            state, stats = train_step(state, wavs, lengths)
            losses.append(float(stats["loss"]))
            return state, stats

        def evaluate(wavs, lengths, **kw):
            before = sum(fn.launches for fn in counted)
            out = eval_step(wavs, lengths, **kw)
            evals.append(sum(fn.launches for fn in counted) - before)
            return out

        runner.train_step, runner.builder.eval_step = step, evaluate
        # -- the main path of B3 bf16, between the counter reset and its reading --
        reset_counts(counted)
        runner.train()
        counts = [fn.launches for fn in counted]
        # -----------------------------------------------------------------------
        want = [0] * 5 + [MJ_LAYERS * n_steps] * 2
        if (counts != want or any(evals) or len(losses) != n_steps
                or not all(map(math.isfinite, losses))):
            raise AssertionError(f"{what}: launches (B1, B2 fwd, B2 bwd, B3 fwd, B3 bwd, B3 "
                                 f"fwd bf16, B3 bwd bf16) {counts}, want {want}; launches in "
                                 f"the eval batches {evals}; losses {losses}")
        return counts, losses, evals

    random.seed(SEED)
    np.random.seed(SEED)
    runner = build_runner(args, config)
    runner.set_model()
    if runner.downstream_model.compute_dtype != torch.bfloat16:
        raise AssertionError("--compute_dtype bf16 built an f32 Mockingjay")
    t0 = time.perf_counter()
    counts, losses, evals = run(runner, BF16_STEPS, "Mockingjay bf16")
    train_s = time.perf_counter() - t0
    ckpts = ckpt_files(run_dir)
    print(f"[bf16] Mockingjay --compute_dtype bf16 (TERA 6 x 768 x 12, FFN 3072, dropout "
          f"0.1) from_waveform through Runner on cuda: {BF16_STEPS} steps in {train_s:.2f} s "
          f"(2 evals, loader and saves included), losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; launches (B1, B2 fwd, B2 bwd, B3 fwd, "
          f"B3 bwd, B3 fwd bf16, B3 bwd bf16) {counts} ({MJ_LAYERS} + {MJ_LAYERS} bf16 a "
          f"step, no f32 B3, 0 in {len(evals)} eval batches); checkpoints {ckpts}", flush=True)

    args2, config2 = get_downstream_args(["--resume", run_dir, "--device", "cuda"])
    config2["runner"]["total_step"] = BF16_STEPS + BF16_RESUME_STEPS
    runner2 = build_runner(args2, config2)
    runner2.set_model()
    restored = (args2.compute_dtype, runner2.global_step, int(runner2.state.opt_state["count"]))
    if restored != ("bf16", BF16_STEPS + 1, BF16_STEPS) or (
            runner2.downstream_model.compute_dtype != torch.bfloat16):
        raise AssertionError(f"Mockingjay bf16 resume restored {restored}")
    counts2, losses2, _ = run(runner2, BF16_RESUME_STEPS, "Mockingjay bf16 resume")
    print(f"[bf16] Mockingjay bf16 resume: restored compute_dtype {restored[0]}, global step "
          f"{restored[1]}, optimizer count {restored[2]}; {BF16_RESUME_STEPS} more steps, "
          f"losses {', '.join(f'{x:.4f}' for x in losses2)}, launches {counts2}", flush=True)
    return counts, run_dir


def mockingjay_window(torch, corpus, run_dir):
    """Phase 12 (b): one Mockingjay train step (loss and gradient) on the card
    against the same step on the CPU, bf16 and f32, the same salts and
    weights (the bf16 run's last checkpoint), under the window criterion."""
    from speech_enhancement_by_s3prl_tpu_torch.data.datasets import OnlineDataset
    from speech_enhancement_by_s3prl_tpu_torch.entry import build_mockingjay_train
    from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_to_state_dict
    from speech_enhancement_by_s3prl_tpu_torch.models.transformer import SaltStream
    from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import (
        find_resume_ckpt,
        load_checkpoint,
    )
    from speech_enhancement_by_s3prl_tpu_torch.runner.trainer import make_context

    payload = load_checkpoint(find_resume_ckpt(run_dir))
    fixed_set = OnlineDataset(speech={"filestrs": os.path.join(corpus, "speech")},
                              noise={"filestrs": os.path.join(corpus, "noise")},
                              max_time=2000, snrs=[0])
    lengths_np, wavs_np = fixed_set.collate_fn([fixed_set[i] for i in range(3)],
                                               pad_to=2 * SR)
    sides = {}
    for device in ("cuda", "cpu"):
        for dtype in ("bf16", "f32"):
            builder = build_mockingjay_train(device=device, compute_dtype=dtype)
            builder.model.load_state_dict(flax_to_state_dict(payload["Downstream"]))
            builder.model.train()
            wavs = torch.from_numpy(wavs_np).to(device)
            lengths = torch.from_numpy(lengths_np).to(device)
            loss, _ = builder.loss_fn(make_context(builder.preprocessor, wavs, lengths, 0, 1),
                                      SaltStream(SEED, 1000))
            g = torch.autograd.grad(loss, list(builder.model.parameters()))
            sides[(device, dtype)] = (loss.detach().reshape(1).double().cpu(),
                                      torch.cat([x.reshape(-1) for x in g]).double().cpu())
    order = (("cuda", "bf16"), ("cuda", "f32"), ("cpu", "bf16"), ("cpu", "f32"))
    loss_w = window(torch, *(sides[k][0] for k in order), "Mockingjay bf16 step loss")
    grad_w = window(torch, *(sides[k][1] for k in order), "Mockingjay bf16 step gradient")
    print(f"[bf16] Mockingjay one train step (B=3, 2 s bucket, dropout live, same salts) card "
          f"against CPU, bf16 and f32: loss {float(sides[order[0]][0]):.6f} (card bf16) / "
          f"{float(sides[order[2]][0]):.6f} (CPU bf16) / {float(sides[order[3]][0]):.6f} (CPU "
          f"f32); window (d(card bf16, CPU bf16), d(card bf16, card f32)) / d(CPU bf16, CPU "
          f"f32): loss ({loss_w[0]:.3f}, {loss_w[1]:.3f}), gradient ({grad_w[0]:.3f}, "
          f"{grad_w[1]:.3f}) (limits {WINDOW_NEAR}; {WINDOW_LOW}, {WINDOW_HIGH})", flush=True)
    return {"loss": loss_w, "grad": grad_w}


def served_window(torch, run_dir, tmp, what, requests, counted, want):
    """Phase 12 (c): the latest checkpoint of ``run_dir`` (Paras bf16) served
    through ``serve.build_enhancer`` on the card and on the CPU, and the same
    weights with Paras f32, under the window criterion on the waveforms; the
    card's bf16 launches of ``counted`` must be ``want``."""
    from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import (
        find_resume_ckpt,
        load_checkpoint,
    )
    from speech_enhancement_by_s3prl_tpu_torch.serve import build_enhancer

    payload = load_checkpoint(find_resume_ckpt(run_dir))
    if payload["Settings"]["Paras"]["compute_dtype"] != "bf16":
        raise AssertionError(f"{what}: Paras record {payload['Settings']['Paras']['compute_dtype']}")
    f32_dir = os.path.join(tmp, os.path.basename(run_dir) + "_as_f32")
    os.makedirs(f32_dir, exist_ok=True)
    payload["Settings"]["Paras"]["compute_dtype"] = "f32"
    with open(os.path.join(f32_dir, "states-1.ckpt"), "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    outs = {}
    for dtype, path in (("bf16", run_dir), ("f32", f32_dir)):
        for device in ("cuda", "cpu"):
            enhancer = build_enhancer(path, device=device)
            if device == "cuda" and dtype == "bf16":
                reset_counts(counted)
                outs[(device, dtype)] = enhancer.run_batch(requests)
                counts = [fn.launches for fn in counted]
                if counts != want:
                    raise AssertionError(f"{what}: launches {counts}, want {want}")
            else:
                outs[(device, dtype)] = enhancer.run_batch(requests)
    for out, wav in zip(outs[("cuda", "bf16")], requests):
        if out.shape != wav.shape or not np.isfinite(out).all():
            raise AssertionError(f"{what}: served shape {out.shape}")
    order = (("cuda", "bf16"), ("cuda", "f32"), ("cpu", "bf16"), ("cpu", "f32"))
    w = window(torch, *(np.concatenate(outs[k]) for k in order), f"{what} served waveforms")
    print(f"[bf16] {what}: checkpoint with Paras compute_dtype bf16 served on cuda "
          f"({len(requests)} requests, one device batch, launches {counts}) and on the CPU, "
          f"beside the same weights served in f32: window ({w[0]:.3f}, {w[1]:.3f}) (limits "
          f"{WINDOW_NEAR}; {WINDOW_LOW}, {WINDOW_HIGH})", flush=True)
    return w


def flagship_bf16_runs(torch, corpus, tmp, counted):
    """Phase 12 (c): the flagship Residual head trained 4 steps with
    --compute_dtype bf16 through Runner and served; the upstream mode
    (--upstream transformer on a seeded full-width S3PRL checkpoint, --dropout
    0.1) trained 2 steps in bf16 and served."""
    from speech_enhancement_by_s3prl_tpu_torch.run_downstream import build_runner, get_parser

    expdir = os.path.join(tmp, "exp")
    requests = [request_audio(s, 40 + i) for i, s in enumerate((2.0, 3.7))]
    out = {}
    up_ckpt = write_s3prl_checkpoint(torch, os.path.join(tmp, "tera-seeded.ckpt"), SEED)
    for name, steps, flags, want_train, want_serve in (
            ("flagship_bf16", BF16_HEAD_STEPS, ["--from_rawfeature"],
             lambda e: [3 * e, 3 * BF16_HEAD_STEPS, 3 * BF16_HEAD_STEPS, 0, 0, 0, 0],
             [3, 0, 0, 0, 0, 0, 0]),
            ("upstream_bf16", UPSTREAM_STEPS, ["--upstream", "transformer", "--ckpt", up_ckpt,
                                               "--dropout", "0.1"],
             lambda e: [3 * e, 3 * UPSTREAM_STEPS, 3 * UPSTREAM_STEPS, 0, 0,
                        MJ_LAYERS * UPSTREAM_STEPS, 0],
             [3, 0, 0, 0, 0, 0, 0])):
        config = train_config(corpus)
        config["runner"].update(total_step=steps, eval_step=steps, save_step=steps)
        args = get_parser().parse_args([
            "--name", name, "--expdir", expdir, "--downstream", "Residual", "--objective",
            "SISDR", "--optim", "BertAdam", "--compute_dtype", "bf16", "--dev_num", "3",
            "--n_jobs", "4", "--seed", str(SEED), "--device", "cuda", *flags])
        runner = build_runner(args, config)
        runner.set_model()
        losses, evals = [], []
        train_step, eval_step = runner.train_step, runner.builder.eval_step

        def step(state, wavs, lengths, train_step=train_step, losses=losses):
            state, stats = train_step(state, wavs, lengths)
            losses.append(float(stats["loss"]))
            return state, stats

        def evaluate(wavs, lengths, eval_step=eval_step, evals=evals, **kw):
            evals.append(tuple(wavs.shape))
            return eval_step(wavs, lengths, **kw)

        runner.train_step, runner.builder.eval_step = step, evaluate
        reset_counts(counted)
        runner.train()
        counts = [fn.launches for fn in counted]
        if (counts != want_train(len(evals)) or len(losses) != steps
                or not all(map(math.isfinite, losses))
                or runner.downstream_model.compute_dtype != torch.bfloat16):
            raise AssertionError(f"{name}: launches {counts}, want {want_train(len(evals))}; "
                                 f"losses {losses}")
        print(f"[bf16] {name} (Residual 3 x 256 BLSTM, --compute_dtype bf16"
              + (", on the frozen seeded TERA in bf16, --dropout 0.1" if "upstream" in name
                 else "") + f") through Runner on cuda: {steps} steps, losses "
              f"{', '.join(f'{x:.4f}' for x in losses)}; launches (B1, B2 fwd, B2 bwd, B3 fwd, "
              f"B3 bwd, B3 fwd bf16, B3 bwd bf16) {counts}", flush=True)
        out[name] = served_window(torch, os.path.join(expdir, name), tmp, name, requests,
                                  counted, want_serve)
    return out


def step_breakdown(torch, fn, card, what):
    """``PROFILED_CALLS`` calls of ``fn`` under torch.profiler after one to warm it: wall and
    device busy ms a call, idle share, and device time by kind, GEMMs split by
    operand type (bf16 or f32) with the f32 ones named."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / PROFILED_CALLS
    shares = {"B3 fwd bf16": 0.0, "B3 bwd bf16": 0.0, "B3 f32": 0.0, "B2": 0.0,
              "GEMM bf16": 0.0, "GEMM f32": 0.0, "other": 0.0}
    gemms, other = {"GEMM bf16": {}, "GEMM f32": {}}, {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        name, low = evt.name, evt.name.lower()
        ms = evt.time_range.elapsed_us() / 1e3 / PROFILED_CALLS
        if "flash_fwd_bf16" in name:
            key = "B3 fwd bf16"
        elif "flash_bwd" in name and "bf16" in name:
            key = "B3 bwd bf16"
        elif "flash_" in name:
            key = "B3 f32"
        elif "lstm" in name:
            key = "B2"
        elif any(tag in low for tag in ("gemm", "cublas", "xmma", "cutlass", "nvjet")):
            # f32 products (TF32 off) run cuBLAS's f32f32 or SIMT sgemm kernels;
            # the step's other products are bf16 (cuBLAS's nvjet kernels on Hopper)
            key = "GEMM f32" if ("f32f32" in low or "sgemm" in low) else "GEMM bf16"
            label = re.sub(r"^void |\(.*$", "", name)[:70]
            gemms[key][label] = gemms[key].get(label, 0.0) + ms
        else:
            key = "other"
            label = kernel_op(name)
            other[label] = other.get(label, 0.0) + ms
        shares[key] += ms
    busy = sum(shares.values())
    print(f"[time] {what} under torch.profiler ({PROFILED_CALLS} calls): wall {wall:.3f} ms, "
          f"device busy {busy:.3f} ms ("
          + ", ".join(f"{k} {v:.3f} ms {v / max(busy, 1e-9):.1%}" for k, v in shares.items()
                      if v)
          + f"), idle share {max(0.0, 1 - busy / wall):.3f} | {card}", flush=True)

    def top(d, n):
        return "; ".join(f"{k} {v:.3f}" for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n])

    print(f"[time] {what}: f32 GEMMs (ms) {top(gemms['GEMM f32'], 6) or 'none'} | bf16 GEMMs "
          f"(ms) {top(gemms['GEMM bf16'], 4) or 'none'} | largest other kernels (ms) "
          f"{top(other, 6)} | {card}", flush=True)
    return {"wall": wall, "busy": busy, **shares}


def bf16_times(torch, A, card):
    """Phase 12 (d): B3 bf16 at rate 0.1 beside the f32 kernel and its plain
    version, and at rate 0 beside SDPA bf16 (forward and backward) at B=6 and
    64, with the tensor-core bound and the CUDA-core floor; the B=6 10 s
    Mockingjay and flagship train steps and the B=1 10 s enhance, bf16 beside
    f32."""
    import torch.nn.functional as F

    from speech_enhancement_by_s3prl_tpu_torch.entry import (
        build,
        build_mockingjay_train,
        build_train,
        make_enhance,
    )

    times = {}
    N, D, T, salt = 12, 64, 1001, (1, 2)
    for B in (6, 64):
        g = torch.Generator().manual_seed(SEED)
        qkv32 = torch.randn(B, T, 3 * N * D, generator=g).cuda()
        q32, k32, v32 = qkv32.split(N * D, dim=-1)
        q, k, v = qkv32.to(torch.bfloat16).split(N * D, dim=-1)
        dout32 = torch.randn(B, T, N * D, generator=g).cuda()
        dout = dout32.to(torch.bfloat16)
        out, lse = A.flash_attention_fwd_bf16(q, k, v, 0.125, 0.1, salt, n_heads=N)
        out0, lse0 = A.flash_attention_fwd_bf16(q, k, v, 0.125, 0.0, salt, n_heads=N)
        out32, lse32 = A.flash_attention_fwd(q32, k32, v32, 0.125, 0.1, salt, n_heads=N)
        fns = {
            "fwd": (lambda: A.flash_attention_fwd_bf16(q, k, v, 0.125, 0.1, salt, n_heads=N),
                    lambda: A.flash_attention_fwd_bf16(q, k, v, 0.125, 0.0, salt, n_heads=N),
                    lambda: A.flash_attention_fwd(q32, k32, v32, 0.125, 0.1, salt, n_heads=N),
                    lambda: A.flash_attention_ref(q, k, v, 0.125, 0.1, salt, n_heads=N)),
            "bwd": (lambda: A.flash_attention_bwd_bf16(q, k, v, out, lse, dout, 0.125, 0.1,
                                                       salt, n_heads=N),
                    lambda: A.flash_attention_bwd_bf16(q, k, v, out0, lse0, dout, 0.125, 0.0,
                                                       salt, n_heads=N),
                    lambda: A.flash_attention_bwd(q32, k32, v32, out32, lse32, dout32, 0.125,
                                                  0.1, salt, n_heads=N),
                    lambda: A.flash_attention_bwd_ref(q, k, v, out, lse, dout, 0.125, 0.1,
                                                      salt, n_heads=N)),
        }
        for name, (kern, kern0, f32, plain) in fns.items():
            # in turns: kernel, kernel at rate 0, f32 kernel, plain, and back
            a, a0, b = (cuda_ms(torch, fn, 10) for fn in (kern, kern0, f32))
            c, c2 = cuda_ms(torch, plain, 2), cuda_ms(torch, plain, 2)
            b2, a02, a2 = (cuda_ms(torch, fn, 10) for fn in (f32, kern0, kern))
            times[(name, B)] = (min(a, a2), min(b, b2), min(c, c2), min(a0, a02))
            products, passes = (2, 1) if name == "fwd" else (5, 2)
            floor, exp_ms, hash_ms = attention_core_floor_bf16(B, T, N, passes)
            print(f"[time] flash_attention_{name}_bf16 B={B} T={T} N={N} D={D} rate 0.1: "
                  f"kernel {a:.3f} / {a2:.3f} ms, rate 0 {a0:.3f} / {a02:.3f} ms, f32 kernel "
                  f"{b:.3f} / {b2:.3f} ms, plain {c:.3f} / {c2:.3f} ms; bound "
                  f"{attention_bound_bf16(B, T, N, D, products)[0]:.4f} ms (tensor cores), "
                  f"CUDA-core floor {floor:.4f} ms (hash {hash_ms:.4f}, exponential "
                  f"{exp_ms:.4f}) | {card}", flush=True)
        heads = [x.reshape(B, T, N, D).transpose(1, 2) for x in (q, k, v)]
        sdpa = cuda_ms(torch, lambda: F.scaled_dot_product_attention(*heads, scale=0.125), 10)
        leaves = [x.detach().requires_grad_() for x in heads]
        dout_h = dout.reshape(B, T, N, D).transpose(1, 2)

        def sdpa_train():
            return F.scaled_dot_product_attention(*leaves, scale=0.125)

        def sdpa_both():
            return torch.autograd.grad(sdpa_train(), leaves, dout_h)

        both = cuda_ms(torch, sdpa_both, iters=10, warmup=2)
        fwd_t = cuda_ms(torch, sdpa_train, iters=10, warmup=2)
        times[("sdpa", B)] = (sdpa, both - fwd_t)
        print(f"[time] scaled_dot_product_attention bf16 rate 0 (a yardstick, not a route) "
              f"B={B} T={T}: forward {sdpa:.3f} ms, backward {both - fwd_t:.3f} ms (forward + "
              f"backward {both:.3f}); B3 bf16 at rate 0: forward {times[('fwd', B)][3]:.3f} "
              f"ms ({times[('fwd', B)][3] / sdpa:.2f}x), backward {times[('bwd', B)][3]:.3f} "
              f"ms ({times[('bwd', B)][3] / (both - fwd_t):.2f}x) | {card}", flush=True)
        del q, k, v, q32, k32, v32, qkv32, dout, dout32, out, lse, out0, lse0, out32, lse32
        del heads, leaves

    rng = np.random.default_rng(SEED)
    clean = np.stack([request_audio(10.0, s) for s in range(6)])
    noise = 0.05 * rng.standard_normal(clean.shape).astype(np.float32)
    wavs = torch.from_numpy(np.stack([clean + noise, clean, noise], axis=1)).cuda()
    lengths = torch.full((6,), wavs.shape[-1], dtype=torch.long).cuda()
    for model, make in (("Mockingjay", build_mockingjay_train), ("flagship", build_train)):
        for dtype in ("f32", "bf16", "bf16", "f32"):
            builder = make(device="cuda", compute_dtype=dtype,
                           generator=torch.Generator().manual_seed(SEED))
            box = [builder.init_state()]

            def step(builder=builder, box=box):
                box[0], stats = builder.train_step(box[0], wavs, lengths)
                return stats

            ms = synced_ms(torch, step, runs=10)
            if not math.isfinite(float(step()["loss"])):
                raise AssertionError(f"{model} {dtype} timing steps: loss not finite")
            key = (model, dtype)
            times[key] = min(times.get(key, math.inf), statistics.median(ms))
            print(f"[time] {model} train step B=6 10 s, compute_dtype {dtype}: median "
                  f"{statistics.median(ms):.3f} ms of 10 synchronized steps (min {min(ms):.3f}, "
                  f"max {max(ms):.3f}) | {card}", flush=True)
            if (model, dtype, "profile") not in times:
                times[(model, dtype, "profile")] = step_breakdown(
                    torch, step, card, f"{model} train step B=6 10 s, compute_dtype {dtype}")
            del builder, box
    wav = torch.from_numpy(np.stack([request_audio(10.0, s) for s in range(3)]))[None].cuda()
    one = torch.tensor([wav.shape[-1]]).cuda()
    for dtype in ("f32", "bf16", "bf16", "f32"):
        pre, model = build(device="cuda", compute_dtype=dtype,
                           generator=torch.Generator().manual_seed(SEED))
        enhance = make_enhance(pre, model)
        ms = synced_ms(torch, lambda: enhance(wav, one), runs=20)
        key = ("enhance", dtype)
        times[key] = min(times.get(key, math.inf), statistics.median(ms))
        print(f"[time] enhance B=1 10 s, compute_dtype {dtype}: median "
              f"{statistics.median(ms):.3f} ms of 20 (min {min(ms):.3f}, max {max(ms):.3f}) | "
              f"{card}", flush=True)
    return times


def bf16_phase(torch, A, counted, card, tmp):
    """Phase 12: bf16 compute on the card. ``counted`` are the kernels whose
    launches the bf16 runs read: B1, B2 fwd, B2 bwd, B3 fwd, B3 bwd, B3 fwd
    bf16, B3 bwd bf16."""
    corpus = os.path.join(tmp, "corpus")
    write_corpus(corpus, SEED)
    checks = flash_bf16_checks(torch, A)
    checks["padded"] = padded_head_checks(torch, A, corpus, card)
    counts, run_dir = mockingjay_bf16_run(torch, corpus, tmp, counted)
    mj_window = mockingjay_window(torch, corpus, run_dir)
    served = flagship_bf16_runs(torch, corpus, tmp, counted)
    times = bf16_times(torch, A, card)
    return {"checks": checks, "launches": counts[5:], "mj_window": mj_window,
            "served": served, "times": times}


# the one-direction LSTM in bf16 (phase 13): the bf16-h forms of B1, B2 fwd
# and B2 bwd (``h_bf16=True``: h rounded to bf16 for the step product, the
# JAX package's lax.scan cell in bf16) and the bf16 dW_hh^T kernel against
# their plain versions; config/vcb.yaml's one-direction Residual trained,
# served, streamed and scored in bf16, card against CPU; and times.
# The forms against their plain versions on the same inputs. A rounding of h
# to bf16 (2^-9 of |h|) flips wherever the kernel's f32 sum and the plain
# version's fall on the two sides of a rounding boundary, and each flip
# carries into the later steps, so a maximum alone is the wrong statistic:
# two summation orders of the plain version on the CPU (B=6, T=1001, H=256)
# differ by 1.2e-4 at most in hs and 1.2e-6 RMS, with 99.999% of the
# elements within 1e-4, while the f32 form (h not rounded) lies 3.9e-5 RMS
# and 97.3% within 1e-4 from the bf16-h form. hs (cs relative to its largest
# |value|) is held to RMS, share within 1e-4 and maximum:
BF16H_RMS, BF16H_SHARE, BF16H_MAX = 1e-5, 0.999, 1e-3
# dxw relative to its largest |value|: orders differ by 6.9e-7 RMS and 2.9e-4
# at most on the CPU; the f32 backward on the same residuals is 9.8e-6 RMS away
BF16H_DXW_RMS, BF16H_DXW_MAX = 3e-6, 1e-3
# dW_hh^T in bf16 units in the last place: the backward against the plain one
# on the same residuals within one unit on this share (the CPU's two orders
# 99.6%; an f32 sum rounded once 15.7%), the dW_hh^T kernel alone on the same
# (hs, dxw) on the second (the CPU 99.989% for two f32 orders; the kernel sums
# a step's products on the tensor cores in their own order, which its CPU
# model, lstm_bidir_tm_dw_bf16_model, puts at 99.99% identical at T = 1001)
BF16H_DW_SHARE, BF16H_DW_KERNEL_SHARE = 0.99, 0.999
# (B, T, H) where the dW_hh^T kernel alone reaches the edges of its design: B
# above one K slice of 4 rows and one group of 8 with H = 36 (ragged tiles),
# H not a multiple of 4 (4-byte staging) with a half-empty second slice, B at
# the wrapper's DW_BF16_CHUNK_ROWS ("max": one step a run, all rows in one
# chunk), one row past it (two chunks of a step, 72 + 65 rows), two full
# chunks (272), the JAX bench's train batch of 352 (three chunks, 120 + 120 +
# 112) and 1024 (eight of 128) at the vcb width, all under the same limits.
# Past one chunk a step's rows go in wgmma chains of 32 rows
# (``dw_bf16_chains``); the share against the exact step sums
# (``dw_bf16_exact_steps``) and the identical share against the kernel's
# model are printed beside: the model does not reproduce how the tensor cores
# accumulate in f32 (their sums drop low bits as a chain grows), so it is not
# a bit for bit reference.
BF16H_DW_EDGE_SHAPES = ((10, 57, 36), (5, 300, 37), ("max", 20, 64), (137, 201, 256),
                        (272, 201, 256), (352, 201, 256), (1024, 201, 256))
# rows of the vcb head's bf16 backward past one chunk of the dW_hh^T kernel
BF16H_CHUNKED_ROWS = 137
# the vcb head's w_hh gradients, card against CPU through a whole train step,
# are each held to the window (its ratio bound is what tells a bf16 sum taken
# step by step from an f32 sum rounded once: on the CPU at (B, T, H) = (2,
# 400, 64) JAX's reverse scan lies 10x further from f32 than the once-rounded
# sum), not to a share within one bf16 unit: upstream of dW_hh^T the two
# devices differ by f32 summation orders in every da (cuFFT against
# pocketfft, the products, three layers), which flip step roundings of most
# elements at some step, and a step-by-step bf16 sum keeps each flip; read
# 0.25-0.47 within one unit on an NVIDIA H100 80GB HBM3 at 700 W, against
# 0.9999 or more for the kernel alone on the same inputs (phase 13 (a)). The
# share is printed beside the window.
# (B, T, H) of the one-direction checks: the served and streamed B=1 and the
# train step's B=6 at the vcb width, and a hidden size of the grid route
BF16H_SHAPES = ((1, 1001, 256), (6, 1001, 256), (3, 57, 36))
# config/vcb.yaml cut to a few steps for phase 13's bf16 run: only the step
# counts and the corpus paths change
VCB_BF16_STEPS = {"total_step": 2, "log_step": 1, "eval_step": 2, "save_step": 2,
                  "media_step": 100}
# the scoring of phase 13 (c): rows of 10 s (the active.yaml head) and 4 s
# (the vcb head, one backward a row)
BF16H_SCORE_ROWS, BF16H_LOOP_ROWS = 6, 3


def ulp_share(torch, a, b):
    """(share within one bf16 unit in the last place, share identical) of two
    tensors of bf16 values held in f32; raises if either holds another
    value."""
    def ordered(x):
        if not torch.equal(x.to(torch.bfloat16).float(), x):
            raise AssertionError("a dW_hh^T holds a value that is not a bf16 number")
        bits = x.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    u = (ordered(a) - ordered(b)).abs()
    return float((u <= 1).double().mean()), float((u == 0).double().mean())


def spread(torch, out, ref, scale=1.0):
    """(max, RMS, share within 1e-4) of |out - ref| / scale."""
    d = ((out - ref).abs() / scale).double()
    return float(d.max()), float(d.pow(2).mean().sqrt()), float((d <= 1e-4).double().mean())


def worse(a, b):
    """The worse of two ``spread`` readings, statistic by statistic."""
    return max(a[0], b[0]), max(a[1], b[1]), min(a[2], b[2])


def bf16_h_checks(torch, L):
    """Phase 13 (a): the bf16-h forms of B1 (also from a carried state), B2
    fwd and B2 bwd, and the dW_hh^T kernel, against their plain versions at
    ``BF16H_SHAPES`` (one direction, W_hh^T holding bf16 values as
    ``LSTMStack`` hands it), B2 bwd and the dW_hh^T kernel twice for identical
    bits; the f32 form beside them, which the limits must tell apart at T =
    1001, and an f32 sum of dW_hh^T rounded once, which must fail its share.
    Returns the worst readings."""
    worst = {"b1": 0.0, "fc": 0.0, "bwd": 0.0, "dw": 1.0, "dw_kernel": 1.0}
    for B, T, H in BF16H_SHAPES:
        xw, w_hh_t, dhs = kernel_grad_inputs(torch, B, T, H, SEED + 13 + B, ndir=1)
        w_hh_t = w_hh_t.to(torch.bfloat16).float()
        g = torch.Generator().manual_seed(SEED + 13)
        h0 = (2 * torch.rand(1, B, H, generator=g) - 1).cuda()
        c0 = torch.randn(1, B, H, generator=g).cuda()
        hs1 = L.lstm_bidir_tm(xw, w_hh_t, h_bf16=True)
        hs_s, (hT, cT) = L.lstm_bidir_tm(xw, w_hh_t, state=(h0, c0), return_state=True,
                                         h_bf16=True)
        hs2, cs2 = L.lstm_bidir_tm_fc(xw, w_hh_t, h_bf16=True)
        ref_hs, ref_cs = L.lstm_bidir_tm_fc_ref(xw, w_hh_t, h_bf16=True)
        ref_s, (_, ref_cT) = L.lstm_bidir_tm_ref(xw, w_hh_t, state=(h0, c0), return_state=True,
                                                 h_bf16=True)
        f32_hs = L.lstm_bidir_tm_ref(xw, w_hh_t)
        dxw, dw = L.lstm_bidir_tm_bwd(xw, w_hh_t, ref_hs, ref_cs, dhs, h_bf16=True)
        again = L.lstm_bidir_tm_bwd(xw, w_hh_t, ref_hs, ref_cs, dhs, h_bf16=True)
        ref_dxw, ref_dw = L.lstm_bidir_tm_bwd_ref(xw, w_hh_t, ref_hs, ref_cs, dhs, h_bf16=True)
        f32_dxw, f32_dw = L.lstm_bidir_tm_bwd_ref(xw, w_hh_t, ref_hs, ref_cs, dhs)
        kdw = L.lstm_bidir_tm_dw_bf16(ref_hs, ref_dxw)
        kdw2 = L.lstm_bidir_tm_dw_bf16(ref_hs, ref_dxw)
        torch.cuda.synchronize()
        twice = (torch.equal(dxw, again[0]) and torch.equal(dw, again[1])
                 and torch.equal(kdw, kdw2))
        b1 = spread(torch, hs1, ref_hs)
        st = worse(spread(torch, hs_s, ref_s),
                   spread(torch, cT, ref_cT, float(ref_cT.abs().max())))
        fc = spread(torch, hs2, ref_hs)
        cs = spread(torch, cs2, ref_cs, float(ref_cs.abs().max()))
        f32 = spread(torch, f32_hs, ref_hs)
        dx = spread(torch, dxw, ref_dxw, float(ref_dxw.abs().max()))
        f32_dx = spread(torch, f32_dxw, ref_dxw, float(ref_dxw.abs().max()))
        dw_share = ulp_share(torch, dw, ref_dw)
        kernel_share = ulp_share(torch, kdw, ref_dw)
        once_share = ulp_share(torch, f32_dw.to(torch.bfloat16).float(), ref_dw)
        route = f"routes ({L.fwd_route(H)!r}, {L.bwd_route(H)!r})"
        print(f"[bf16h] ndir=1 B={B} T={T} H={H} {route}, (max, RMS, share within 1e-4) "
              f"against the plain bf16-h versions: B1 hs {b1[0]:.2e} / {b1[1]:.2e} / "
              f"{b1[2]:.5f}, B1 from a carried state (hs, cT) {st[0]:.2e} / {st[1]:.2e} / "
              f"{st[2]:.5f}, B2 fwd hs {fc[0]:.2e} / {fc[1]:.2e} / {fc[2]:.5f}, cs / max "
              f"{cs[0]:.2e} / {cs[1]:.2e} / {cs[2]:.5f} (limits {BF16H_MAX:.0e} / "
              f"{BF16H_RMS:.0e} / {BF16H_SHARE}; the f32 form's hs {f32[0]:.2e} / {f32[1]:.2e} / "
              f"{f32[2]:.5f}); B2 bwd dxw / max {dx[0]:.2e} / {dx[1]:.2e} (limits "
              f"{BF16H_DXW_MAX:.0e} / {BF16H_DXW_RMS:.0e}; the f32 backward {f32_dx[0]:.2e} / "
              f"{f32_dx[1]:.2e}), dW_hh^T within one bf16 unit {dw_share[0]:.5f} (identical "
              f"{dw_share[1]:.5f}, limit {BF16H_DW_SHARE}); the dW_hh^T kernel alone "
              f"{kernel_share[0]:.5f} (identical {kernel_share[1]:.5f}, limit "
              f"{BF16H_DW_KERNEL_SHARE}); an f32 sum rounded once {once_share[0]:.5f}; twice: "
              f"identical bits {twice}", flush=True)
        for name, (mx, rms, share) in (("B1", b1), ("B1 carried", st), ("B2 fwd hs", fc),
                                       ("B2 fwd cs", cs)):
            if not (mx <= BF16H_MAX and rms <= BF16H_RMS and share >= BF16H_SHARE):
                raise AssertionError(f"{name} bf16-h B={B} H={H}: {mx}, {rms}, {share}")
        if T == 1001 and not (f32[1] > BF16H_RMS or f32[2] < BF16H_SHARE):
            raise AssertionError(f"the limits do not tell the f32 form apart at B={B} H={H}: "
                                 f"{f32}")
        if not (dx[0] <= BF16H_DXW_MAX and dx[1] <= BF16H_DXW_RMS):
            raise AssertionError(f"B2 bwd bf16-h B={B} H={H}: dxw {dx}")
        if not (dw_share[0] >= BF16H_DW_SHARE and kernel_share[0] >= BF16H_DW_KERNEL_SHARE
                and once_share[0] < BF16H_DW_SHARE and twice):
            raise AssertionError(f"dW_hh^T bf16 B={B} H={H}: {dw_share}, kernel "
                                 f"{kernel_share}, once-rounded {once_share}, twice {twice}")
        worst["b1"] = max(worst["b1"], b1[0], st[0])
        worst["fc"] = max(worst["fc"], fc[0])
        worst["bwd"] = max(worst["bwd"], float((dxw - ref_dxw).abs().max()))
        worst["dw"] = min(worst["dw"], dw_share[0])
        worst["dw_kernel"] = min(worst["dw_kernel"], kernel_share[0])
        worst["dw_kernel_abs"] = max(worst.get("dw_kernel_abs", 0.0),
                                     float((kdw - ref_dw).abs().max()))
        worst["dw_kernel_identical"] = min(worst.get("dw_kernel_identical", 1.0),
                                           kernel_share[1])
    # the dW_hh^T kernel alone at the edges of its design, on the bf16-h
    # backward's own (hs, dxw), under the same limits, past one chunk of a
    # step's rows too
    for B, T, H in BF16H_DW_EDGE_SHAPES:
        B = L.DW_BF16_CHUNK_ROWS if B == "max" else B
        xw, w_hh_t, dhs = kernel_grad_inputs(torch, B, T, H, SEED + 17 + B, ndir=1)
        w_hh_t = w_hh_t.to(torch.bfloat16).float()
        hs, cs = L.lstm_bidir_tm_fc_ref(xw, w_hh_t, h_bf16=True)
        dxw, _ = L.lstm_bidir_tm_bwd_ref(xw, w_hh_t, hs, cs, dhs, h_bf16=True)
        kdw, kdw2 = L.lstm_bidir_tm_dw_bf16(hs, dxw), L.lstm_bidir_tm_dw_bf16(hs, dxw)
        ref_dw = L.lstm_bidir_tm_dw_bf16_ref(hs, dxw)
        once = torch.einsum("dbti,dbtj->dij", hs[:, :, :-1].to(torch.bfloat16).float(),
                            dxw[:, :, 1:])
        chunked = B > L.DW_BF16_CHUNK_ROWS
        if chunked:
            # beside the plain version: the exact step sum and the kernel's
            # model, each read against the kernel (printed, not held)
            exact = dw_bf16_exact_steps(torch, L, hs, dxw)
            model = L.lstm_bidir_tm_dw_bf16_model(hs, dxw)
        torch.cuda.synchronize()
        share = ulp_share(torch, kdw, ref_dw)
        once_share = ulp_share(torch, once.to(torch.bfloat16).float(), ref_dw)
        twice = torch.equal(kdw, kdw2)
        extra = ""
        if chunked:
            exact_share = ulp_share(torch, kdw, exact)
            exact_plain = ulp_share(torch, exact, ref_dw)
            model_share = ulp_share(torch, kdw, model)
            extra = (f"; against the exact step sums {exact_share[0]:.5f} (identical "
                     f"{exact_share[1]:.5f}; the plain version against them "
                     f"{exact_plain[0]:.5f}), against its model lstm_bidir_tm_dw_bf16_model "
                     f"identical {model_share[1]:.5f}")
            worst[f"dw_kernel_b{B}"] = share + exact_share + exact_plain + model_share
        print(f"[bf16h] the dW_hh^T kernel alone at ndir=1 B={B} T={T} H={H} (row chunks "
              f"{L.dw_bf16_chunks(B)}, {len(L.dw_bf16_chains(B))} chains): within one bf16 unit of the plain version "
              f"{share[0]:.5f} (identical {share[1]:.5f}, limit {BF16H_DW_KERNEL_SHARE}); an "
              f"f32 sum rounded once {once_share[0]:.5f}; twice: identical bits {twice}{extra}",
              flush=True)
        if not (share[0] >= BF16H_DW_KERNEL_SHARE and once_share[0] < BF16H_DW_SHARE
                and twice):
            raise AssertionError(f"dW_hh^T kernel B={B} T={T} H={H}: {share}, once-rounded "
                                 f"{once_share}, twice {twice}")
        worst["dw_kernel"] = min(worst["dw_kernel"], share[0])
        worst["dw_kernel_identical"] = min(worst["dw_kernel_identical"], share[1])
        del xw, w_hh_t, dhs, hs, cs, dxw
    worst["chunked_head"] = chunked_head_backward(torch, L)
    return worst


def dw_bf16_exact_steps(torch, L, hs, da):
    """The plain version's function (``lstm_bidir_tm_dw_bf16_ref``) with each
    step's product summed exactly: in float64 (products of a bf16 h and an
    f32 da are exact there, and a few hundred of them sum far below an f32
    unit), rounded to f32 once, then the same bf16 carry."""
    acc = torch.zeros(hs.shape[:-3] + (hs.shape[-1], da.shape[-1]), dtype=torch.float32,
                      device=hs.device)
    for tt in range(hs.shape[-2] - 1, 0, -1):
        step = torch.matmul(L._bf16(hs[..., tt - 1, :]).double().transpose(-1, -2),
                            da[..., tt, :].double()).float()
        acc = L._bf16(acc + L._bf16(step))
    return acc


def chunked_head_backward(torch, L):
    """Phase 13 (a): one backward of the vcb head in bf16 (LSTM 3 x 256, one
    direction, 120-d input) at ``BF16H_CHUNKED_ROWS`` rows of 1 s, past one
    chunk of the dW_hh^T kernel: 3 launches of B2 fwd, B2 bwd and the dW_hh^T
    kernel, all in the bf16-h form, and every w_hh gradient finite and of
    bf16 values (the kernel's own limits are the edge shapes' above).
    Returns the launches."""
    from speech_enhancement_by_s3prl_tpu_torch.entry import build
    from speech_enhancement_by_s3prl_tpu_torch.models.heads import build_head

    pre, _ = build(device="cpu")
    head = build_head("LSTM", input_size=pre.feat_dims()[1], output_size=201, hidden_size=256,
                      num_layers=3, bidirectional=False, compute_dtype="bf16",
                      generator=torch.Generator().manual_seed(SEED + 15)).cuda()
    g = torch.Generator().manual_seed(SEED + 16)
    x, lin, dout = (torch.randn(BF16H_CHUNKED_ROWS, 101, n, generator=g).cuda()
                    for n in (pre.feat_dims()[1], 201, 201))
    kernels = (L.lstm_bidir_tm_fc, L.lstm_bidir_tm_bwd, L.lstm_bidir_tm_dw_bf16)
    reset_counts(kernels)
    out, _ = head(x, lin.abs())
    (out * dout).sum().backward()
    torch.cuda.synchronize()
    counts = [L.lstm_bidir_tm_fc.launches, L.lstm_bidir_tm_fc.h_bf16,
              L.lstm_bidir_tm_bwd.launches, L.lstm_bidir_tm_bwd.h_bf16,
              L.lstm_bidir_tm_dw_bf16.launches]
    grads = [p.grad.float() for k, p in head.named_parameters() if k.endswith("w_hh")]
    ok = len(grads) == 3 and all(bool(torch.isfinite(v).all())
                                 and torch.equal(v.to(torch.bfloat16).float(), v)
                                 for v in grads)
    print(f"[bf16h] the vcb head's bf16 backward at B={BF16H_CHUNKED_ROWS} (1 s, row chunks "
          f"{L.dw_bf16_chunks(BF16H_CHUNKED_ROWS)} of the dW_hh^T kernel): launches (B2 fwd, "
          f"of it bf16-h, B2 bwd, of it bf16-h, dW_hh^T bf16) {counts} (want "
          f"[3, 3, 3, 3, 3]); w_hh gradients finite, bf16 values {ok}", flush=True)
    if counts != [3, 3, 3, 3, 3] or not ok:
        raise AssertionError(f"the vcb head's backward at B={BF16H_CHUNKED_ROWS}: launches "
                             f"{counts}, gradients finite and bf16 {ok}")
    return {"launches": counts}


def bf16_h_times(torch, L, card):
    """Phase 13 (e): each bf16-h form beside its f32 form and its plain
    version, one direction at T=1001, H=256: B1 at B=1, B2 fwd, B2 bwd and the
    dW_hh^T kernel at B=6 (and B=1), kernel and f32 form in turns; B2 bwd's
    first two phases as its time less the dW_hh^T kernel's."""
    T, H, times = 1001, 256, {}
    for B in (1, 6):
        xw, w_hh_t, dhs = kernel_grad_inputs(torch, B, T, H, SEED + 31 + B, ndir=1)
        w_hh_t = w_hh_t.to(torch.bfloat16).float()
        hs, cs = L.lstm_bidir_tm_fc_ref(xw, w_hh_t, h_bf16=True)
        dxw, _ = L.lstm_bidir_tm_bwd_ref(xw, w_hh_t, hs, cs, dhs, h_bf16=True)
        fns = {
            "b1": (lambda: L.lstm_bidir_tm(xw, w_hh_t, h_bf16=True),
                   lambda: L.lstm_bidir_tm(xw, w_hh_t),
                   lambda: L.lstm_bidir_tm_ref(xw, w_hh_t, h_bf16=True)),
            "fc": (lambda: L.lstm_bidir_tm_fc(xw, w_hh_t, h_bf16=True),
                   lambda: L.lstm_bidir_tm_fc(xw, w_hh_t),
                   lambda: L.lstm_bidir_tm_fc_ref(xw, w_hh_t, h_bf16=True)),
            "bwd": (lambda: L.lstm_bidir_tm_bwd(xw, w_hh_t, hs, cs, dhs, h_bf16=True),
                    lambda: L.lstm_bidir_tm_bwd(xw, w_hh_t, hs, cs, dhs),
                    lambda: L.lstm_bidir_tm_bwd_ref(xw, w_hh_t, hs, cs, dhs, h_bf16=True)),
            "dw": (lambda: L.lstm_bidir_tm_dw_bf16(hs, dxw), None,
                   lambda: L.lstm_bidir_tm_dw_bf16_ref(hs, dxw)),
        }
        for name, (kern, f32, plain) in fns.items():
            a = cuda_ms(torch, kern, 10)
            b = cuda_ms(torch, f32, 10) if f32 else None
            c = cuda_ms(torch, plain, 1)
            b2 = cuda_ms(torch, f32, 10) if f32 else None
            a2 = cuda_ms(torch, kern, 10)
            times[(name, B)] = (min(a, a2), None if f32 is None else min(b, b2), c)
            print(f"[time] {name} bf16-h ndir=1 B={B} T={T} H={H}: kernel {a:.4f} / {a2:.4f} "
                  f"ms" + ("" if f32 is None else f", f32 form {b:.4f} / {b2:.4f} ms")
                  + f", plain {c:.3f} ms; bound {bf16_h_bound(B, T, H, name)[0]:.4f} ms by "
                  f"{bf16_h_bound(B, T, H, name)[1]}"
                  + ("" if name != "dw" else
                     f" (the first design's bound {dw_first_bound(B, T, H)[0]:.4f} ms)")
                  + f" | {card}", flush=True)
        bwd, dw = times[("bwd", B)][0], times[("dw", B)][0]
        print(f"[time] B2 bwd bf16-h ndir=1 B={B} T={T} H={H}: its first two phases "
              f"(gates, the dh chain) {bwd - dw:.4f} ms, the wrapper's time less the dW_hh^T "
              f"kernel's ({dw / bwd:.1%} of the call); the f32 form {times[('bwd', B)][1]:.4f} "
              f"ms with its dW_hh^T product | {card}", flush=True)
        del xw, w_hh_t, dhs, hs, cs, dxw
    # the dW_hh^T kernel past one chunk of a step's rows
    for B in (BF16H_CHUNKED_ROWS, 352):
        xw, w_hh_t, dhs = kernel_grad_inputs(torch, B, T, H, SEED + 31 + B, ndir=1)
        w_hh_t = w_hh_t.to(torch.bfloat16).float()
        hs, cs = L.lstm_bidir_tm_fc_ref(xw, w_hh_t, h_bf16=True)
        dxw, _ = L.lstm_bidir_tm_bwd_ref(xw, w_hh_t, hs, cs, dhs, h_bf16=True)
        del xw, w_hh_t, dhs, cs
        kern = lambda: L.lstm_bidir_tm_dw_bf16(hs, dxw)  # noqa: E731
        plain = lambda: L.lstm_bidir_tm_dw_bf16_ref(hs, dxw)  # noqa: E731
        a, c, a2 = cuda_ms(torch, kern, 10), cuda_ms(torch, plain, 1), cuda_ms(torch, kern, 10)
        times[("dw", B)] = (min(a, a2), None, c)
        bnd = bf16_h_bound(B, T, H, "dw")
        print(f"[time] dw bf16-h ndir=1 B={B} T={T} H={H} (row chunks {L.dw_bf16_chunks(B)}): "
              f"kernel {a:.4f} / {a2:.4f} ms, plain {c:.3f} ms; bound {bnd[0]:.4f} ms by "
              f"{bnd[1]} | {card}", flush=True)
        del hs, dxw
    return times


def vcb_bf16_run(torch, corpus, tmp, counted):
    """Phase 13 (b): config/vcb.yaml (Residual 3 x 256, one direction) with
    --compute_dtype bf16 through ``build_runner`` / ``Runner``, its corpus
    paths and step counts changed: the launches of B1, B2 fwd, B2 bwd, the
    dW_hh^T kernel, B4 and B5 and of the bf16-h forms among them. Returns the
    runner and its run directory."""
    import yaml

    from speech_enhancement_by_s3prl_tpu_torch.run_downstream import (
        build_runner,
        get_downstream_args,
    )

    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L
    cfg_path = os.path.join(tmp, "vcb_bf16.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(shipped_config(corpus, "vcb", VCB_BF16_STEPS, 12), f)
    args, config = get_downstream_args([
        "--config", cfg_path, "--name", "vcb_bf16", "--expdir", os.path.join(tmp, "exp"),
        "--downstream", "Residual", "--objective", "SISDR", "--from_rawfeature",
        "--compute_dtype", "bf16", "--dev_num", str(VCB_EVAL_BATCH), "--n_jobs", "4",
        "--seed", str(SEED), "--device", "cuda"])
    random.seed(SEED)
    np.random.seed(SEED)
    runner = build_runner(args, config)
    runner.set_model()
    steps, evals = [], []
    train_step, eval_step = runner.train_step, runner.builder.eval_step

    def step(state, wavs, lengths):
        state, stats = train_step(state, wavs, lengths)
        steps.append((tuple(wavs.shape), float(stats["loss"])))
        return state, stats

    def eval_batch(wavs, lengths, **kw):
        evals.append(tuple(wavs.shape))
        return eval_step(wavs, lengths, **kw)

    runner.train_step, runner.builder.eval_step = step, eval_batch
    # -- the main path of the vcb head in bf16 through the Runner --
    reset_counts(counted)
    runner.train()
    counts = [fn.launches for fn in counted]
    forms = [L.lstm_bidir_tm.h_bf16, L.lstm_bidir_tm_fc.h_bf16, L.lstm_bidir_tm_bwd.h_bf16]
    # ---------------------------------------------------------------
    runner.train_step, runner.builder.eval_step = train_step, eval_step
    n_steps, n_evals = len(steps), len(evals)
    want = [3 * n_evals, 3 * n_steps, 3 * n_steps, 3 * n_steps, n_steps + n_evals, n_evals]
    model = runner.downstream_model
    print(f"[bf16h] config/vcb.yaml (Residual 3 x 256, one direction, linear 201-d; corpus "
          f"paths and step counts {VCB_BF16_STEPS} changed) with --compute_dtype bf16 through "
          f"Runner on cuda: {n_steps} steps of {sorted({sh for sh, _ in steps})}, losses "
          f"{', '.join(f'{x:.4f}' for _, x in steps)}, {n_evals} eval batches; launches (B1, "
          f"B2 fwd, B2 bwd, dW_hh^T bf16, B4, B5) {counts} (want {want}), of them in the bf16-h "
          f"form (B1, B2 fwd, B2 bwd) {forms}", flush=True)
    if (counts != want or forms != want[:3] or n_steps != VCB_BF16_STEPS["total_step"]
            or not all(math.isfinite(x) for _, x in steps)
            or model.compute_dtype != torch.bfloat16 or model.lstm.bidirectional):
        raise AssertionError(f"vcb bf16 run: launches {counts}, forms {forms}, want {want}; "
                             f"steps {steps}")
    return runner, os.path.join(tmp, "exp", "vcb_bf16"), counts


def with_dtype(model, dtype):
    """``model`` (a head with an LSTMStack) computing in ``dtype``, in place."""
    model.compute_dtype = model.lstm.compute_dtype = dtype
    return model


def vcb_step_window(torch, runner, card):
    """Phase 13 (b): one train step of the vcb head (B=6 rows of 10 s) on the
    card against the CPU, bf16 and f32 from the same weights: the window on
    the loss and the whole gradient, every w_hh gradient within one bf16 unit
    the window too (the share within one bf16 unit of the CPU's printed
    beside it), and the launches of one train step; then the step's time in
    bf16 beside f32."""
    import copy
    import dataclasses

    from speech_enhancement_by_s3prl_tpu_torch.runner.trainer import make_context

    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L
    rng = np.random.default_rng(SEED + 13)
    clean = np.stack([request_audio(10.0, 90 + s) for s in range(6)])
    noise = 0.05 * rng.standard_normal(clean.shape).astype(np.float32)
    wavs_np = np.stack([clean + noise, clean, noise], axis=1)
    base = copy.deepcopy(runner.downstream_model).cpu()
    sides, builders = {}, {}
    for device in ("cuda", "cpu"):
        for dtype in (torch.bfloat16, torch.float32):
            model = with_dtype(copy.deepcopy(base), dtype).to(device)
            builder = dataclasses.replace(runner.builder, model=model)
            builders[(device, dtype)] = builder
            wavs = torch.from_numpy(wavs_np).to(device)
            lengths = torch.full((6,), wavs.shape[-1], dtype=torch.long, device=device)
            ctx = make_context(builder.preprocessor, wavs, lengths, builder.channel_inp,
                               builder.channel_tar)
            loss, _ = builder.loss_fn(ctx)
            names = [n for n, _ in model.named_parameters()]
            g = torch.autograd.grad(loss, list(model.parameters()))
            sides[(device, dtype)] = (loss.detach().reshape(1).double().cpu(),
                                      {n: x.detach().cpu() for n, x in zip(names, g)})
    order = [(d, t) for t in (torch.bfloat16, torch.float32) for d in ("cuda", "cpu")]
    order = [order[0], order[2], order[1], order[3]]  # card bf16, card f32, CPU bf16, CPU f32
    loss_w = window(torch, *(sides[k][0] for k in order), "vcb bf16 step loss")
    grad_w = window(torch, *(torch.cat([x.reshape(-1) for x in sides[k][1].values()])
                             for k in order), "vcb bf16 step gradient")
    w_hh = [n for n in sides[order[0]][1] if n.endswith(".w_hh")]
    windows = {n: window(torch, *(sides[k][1][n] for k in order), f"vcb bf16 step d{n}")
               for n in w_hh}
    shares = {n: ulp_share(torch, sides[order[0]][1][n], sides[order[2]][1][n])[0]
              for n in w_hh}
    # the launches of one train step of the bf16 head on the card
    builder = builders[("cuda", torch.bfloat16)]
    state = builder.init_state()
    wavs = torch.from_numpy(wavs_np).cuda()
    lengths = torch.full((6,), wavs.shape[-1], dtype=torch.long).cuda()
    counted = (L.lstm_bidir_tm, L.lstm_bidir_tm_fc, L.lstm_bidir_tm_bwd, L.lstm_bidir_tm_dw_bf16)
    # -- the main path: one train step of the one-direction bf16 head --
    reset_counts(counted)
    state, stats = builder.train_step(state, wavs, lengths)
    counts = [fn.launches for fn in counted]
    forms = [L.lstm_bidir_tm_fc.h_bf16, L.lstm_bidir_tm_bwd.h_bf16]
    # -------------------------------------------------------------------
    print(f"[bf16h] vcb head one train step (B=6, 10 s) card against CPU, bf16 and f32: loss "
          f"{float(sides[order[0]][0]):.6f} (card bf16) / {float(sides[order[2]][0]):.6f} "
          f"(CPU bf16) / {float(sides[order[3]][0]):.6f} (CPU f32); window (d(card bf16, CPU "
          f"bf16), d(card bf16, card f32)) / d(CPU bf16, CPU f32): loss ({loss_w[0]:.3f}, "
          f"{loss_w[1]:.3f}), gradient ({grad_w[0]:.3f}, {grad_w[1]:.3f}) (limits "
          f"{WINDOW_NEAR}; {WINDOW_LOW}, {WINDOW_HIGH}); each w_hh gradient's window (and "
          f"share within one bf16 unit of the CPU's) "
          + ", ".join(f"{n} ({windows[n][0]:.3f}, {windows[n][1]:.3f}; {shares[n]:.4f})"
                      for n in w_hh)
          + f"; launches of a train step (B1, B2 fwd, B2 bwd, dW_hh^T bf16) {counts}, bf16-h "
          f"forms (B2 fwd, B2 bwd) {forms}", flush=True)
    if counts != [0, 3, 3, 3] or forms != [3, 3] or not math.isfinite(float(stats["loss"])):
        raise AssertionError(f"vcb bf16 train step: launches {counts}, forms {forms}")
    # the step's time, bf16 beside f32, in turns
    times = {}
    for dtype in (torch.float32, torch.bfloat16, torch.bfloat16, torch.float32):
        b = builders[("cuda", dtype)]
        box = [b.init_state()]

        def one(b=b, box=box):
            box[0], _ = b.train_step(box[0], wavs, lengths)

        ms = synced_ms(torch, one, runs=10)
        key = "bf16" if dtype == torch.bfloat16 else "f32"
        times[key] = min(times.get(key, math.inf), statistics.median(ms))
        print(f"[time] vcb head (one-direction Residual 3 x 256) train step B=6 10 s, "
              f"compute_dtype {key}: median {statistics.median(ms):.3f} ms of 10 synchronized "
              f"steps (min {min(ms):.3f}, max {max(ms):.3f}) | {card}", flush=True)
    return {"loss": loss_w, "grad": grad_w, "w_hh_share": min(shares.values()),
            "w_hh_window": (max(w[0] for w in windows.values()),
                            min(w[1] for w in windows.values()),
                            max(w[1] for w in windows.values())),
            "step_ms": times, "step_launches": counts}


def one_dir_bf16_serving(torch, counted, dsp_kernels, card, tmp):
    """Phase 13 (b): a one-direction bf16 checkpoint (the flagship's 120-d
    log-mel features into vcb's Residual 3 x 256, Paras compute_dtype bf16)
    served at B=1 on the card and the CPU under the window; its
    ``StatefulStreamer`` (48-frame chunks, 10 s in ragged pushes) on the card
    against the CPU under the window, with 3 B1 launches in the bf16-h form a
    chunk; ``/enhance`` and ``/stream`` of ``serve.make_server`` on it, the
    stream bit for bit the card's streamer; and times: the B=1 10 s enhance
    and the chunk, bf16 beside f32."""
    from speech_enhancement_by_s3prl_tpu_torch.entry import (
        build,
        flagship_settings,
        make_enhance,
    )
    from speech_enhancement_by_s3prl_tpu_torch.ops.streaming import StatefulStreamer
    from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import save_checkpoint
    from speech_enhancement_by_s3prl_tpu_torch.serve import build_enhancer, make_server
    from speech_enhancement_by_s3prl_tpu_torch.tools import stream_client
    from speech_enhancement_by_s3prl_tpu_torch.tools.serve_load import wav_body

    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L
    b1 = L.lstm_bidir_tm
    stft_fused, decode_ola = dsp_kernels
    out = {}
    _, model = build(bidirectional=False, compute_dtype="bf16", device="cpu",
                     generator=torch.Generator().manual_seed(SEED + 13))
    config, paras = flagship_settings(bidirectional=False, compute_dtype="bf16")
    ckpt_dir = os.path.join(tmp, "one_dir_bf16")
    save_checkpoint(ckpt_dir, 0, model, None, config, paras)
    out["served"] = served_window(torch, ckpt_dir, tmp, "one-direction bf16 head (B=1 10 s)",
                                  [request_audio(10.0, 77)], counted, [3, 0, 0, 0, 1, 1])
    out["served_forms"] = b1.h_bf16
    if b1.h_bf16 != 3:
        raise AssertionError(f"served one-direction bf16 head: {b1.h_bf16} bf16-h B1 launches")

    # the streamer, card against CPU, bf16 and f32
    f32_dir = ckpt_dir + "_as_f32"  # served_window's copy with Paras f32
    n = int(STREAM_SECONDS * SR)
    wav = speech_like(n, 51)
    sizes = np.random.default_rng(SEED + 13).integers(700, 9000, size=400)
    streams, chunk_ms = {}, {}
    for dtype, path in (("bf16", ckpt_dir), ("f32", f32_dir)):
        for device in ("cuda", "cpu"):
            ctx = build_enhancer(path, device=device).stream_ctx
            streamer = StatefulStreamer(ctx["model"], ctx["preprocessor"],
                                        frames_per_chunk=STREAM_FRAMES)
            if device == "cuda":
                drive_stream(streamer.clone(), wav, sizes)  # warm
                streamer = streamer.clone()
                step_ms, model_step = [], streamer._model_step

                def timed(*a, model_step=model_step, step_ms=step_ms):
                    t0 = time.perf_counter()
                    res = model_step(*a)  # ends in a copy to the host: synchronous
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    return res

                streamer._model_step = timed
                # -- the main path of the bf16 streamer (f32 beside it) --
                reset_counts(counted)
                streams[(device, dtype)] = drive_stream(streamer, wav, sizes)
                counts = [b1.launches, b1.carried, b1.h_bf16, stft_fused.launches,
                          decode_ola.launches]
                # --------------------------------------------------------
                chunk_ms[dtype] = statistics.median(step_ms)
                chunks = len(step_ms)
                bf16_forms = 3 * chunks if dtype == "bf16" else 0
                if counts != [3 * chunks, 3 * chunks, bf16_forms, 0, 0]:
                    raise AssertionError(f"{dtype} streamer: launches {counts}, {chunks} chunks")
                if dtype == "bf16":
                    out["stream_counts"], out["stream_chunks"] = counts, chunks
            else:
                streams[(device, dtype)] = drive_stream(streamer, wav, sizes)
    order = (("cuda", "bf16"), ("cuda", "f32"), ("cpu", "bf16"), ("cpu", "f32"))
    out["stream"] = window(torch, *(streams[k] for k in order), "bf16 streamer")
    gpu = streams[("cuda", "bf16")]
    vs_cpu = float(np.abs(gpu - streams[("cpu", "bf16")]).max()
                   / np.sqrt(np.mean(streams[("cpu", "bf16")] ** 2)))
    out["chunk_ms"] = chunk_ms
    print(f"[bf16h] StatefulStreamer on the one-direction bf16 head (cuda, {STREAM_FRAMES}-frame "
          f"chunks, {STREAM_SECONDS:.0f} s in ragged pushes): {len(gpu)} samples in "
          f"{out['stream_chunks']} chunks, launches (B1, B1 with state, B1 bf16-h, B4, B5) "
          f"{out['stream_counts']}; window against the CPU ({out['stream'][0]:.3f}, "
          f"{out['stream'][1]:.3f}) (limits {WINDOW_NEAR}; {WINDOW_LOW}, {WINDOW_HIGH}), max "
          f"|card - CPU| / RMS {vs_cpu:.2e}; model step median {chunk_ms['bf16']:.3f} ms a chunk "
          f"in bf16, {chunk_ms['f32']:.3f} in f32 | {card}", flush=True)
    if len(gpu) != (n // 160) * 160 or not np.isfinite(gpu).all():
        raise AssertionError(f"bf16 streamer: {len(gpu)} samples")

    # the HTTP server on the bf16 checkpoint: /enhance and /stream
    server = make_server(["--ckpt", ckpt_dir, "--port", "0"])
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        port = server.server_address[1]
        status, reply = http_request(port, "POST", "/enhance", wav_body(speech_like(4 * SR, 52)))
        url = f"http://127.0.0.1:{port}/stream"
        # -- the main path of /stream on the bf16 checkpoint --
        reset_counts(counted)
        st, streamed, _ = stream_client.stream(url, wav, SR, chunk_ms=100.0)
        counts = [b1.launches, b1.h_bf16]
        # -----------------------------------------------------
        same = st == 200 and np.array_equal(streamed, gpu)
        print(f"[bf16h] serve.make_server on the one-direction bf16 checkpoint: /enhance 4 s "
              f"{status} ({len(reply)} bytes), /stream {st}: {len(streamed)} samples, identical "
              f"bits to the card streamer {same}; launches (B1, B1 bf16-h) {counts}", flush=True)
        if status != 200 or not same or counts != [3 * out["stream_chunks"]] * 2:
            raise AssertionError(f"bf16 server: /enhance {status}, /stream {st} same {same}, "
                                 f"launches {counts}")
    finally:
        server.shutdown()
        server.server_close()

    # the B=1 10 s enhance, bf16 beside f32, in turns
    wav3 = torch.from_numpy(np.stack([request_audio(10.0, s) for s in range(3)]))[None].cuda()
    one = torch.tensor([wav3.shape[-1]]).cuda()
    enh_ms = {}
    for dtype in ("f32", "bf16", "bf16", "f32"):
        pre, model = build(bidirectional=False, compute_dtype=dtype, device="cuda",
                           generator=torch.Generator().manual_seed(SEED + 13))
        enhance = make_enhance(pre, model)
        ms = synced_ms(torch, lambda: enhance(wav3, one), runs=20)
        enh_ms[dtype] = min(enh_ms.get(dtype, math.inf), statistics.median(ms))
        print(f"[time] enhance B=1 10 s, one-direction 3 x 256 head, compute_dtype {dtype}: "
              f"median {statistics.median(ms):.3f} ms of 20 (min {min(ms):.3f}, max "
              f"{max(ms):.3f}) | {card}", flush=True)
    out["enhance_ms"] = enh_ms
    return out


def bf16_scoring(torch, runner, card):
    """Phase 13 (c): per-sample scoring of bf16 heads card against CPU under
    the window (bf16 and f32 from the same weights) and with the same ``match
    > 0`` set: config/active.yaml's head (LSTM 3 x 256, bidirectional, L1, the
    flagship's 120-d log-mel) at ``BF16H_SCORE_ROWS`` rows of 10 s under both
    engines, and the vcb head (one direction, one backward a row through the
    bf16-h forms) at ``BF16H_LOOP_ROWS`` rows of 4 s."""
    import copy
    import dataclasses

    from speech_enhancement_by_s3prl_tpu_torch.active import sampler as S
    from speech_enhancement_by_s3prl_tpu_torch.entry import build
    from speech_enhancement_by_s3prl_tpu_torch.models.heads import build_head
    from speech_enhancement_by_s3prl_tpu_torch.objectives import build_objective
    from speech_enhancement_by_s3prl_tpu_torch.runner.optim import build_optimizer
    from speech_enhancement_by_s3prl_tpu_torch.runner.trainer import StepBuilder

    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L
    pre, _ = build(device="cpu")
    head = build_head("LSTM", input_size=pre.feat_dims()[1], output_size=201, hidden_size=256,
                      num_layers=3, bidirectional=True, compute_dtype="bf16",
                      generator=torch.Generator().manual_seed(SEED + 14))
    active = StepBuilder(preprocessor=pre, model=head, objective=build_objective("L1"),
                         optimizer=build_optimizer("Adam", 1e-4, 0.07, 100), from_rawfeature=True)
    out = {}
    for name, builder, rows, seconds, impls in (
            ("active.yaml head", active, BF16H_SCORE_ROWS, 10.0, ("vmap", "capture")),
            ("vcb head", runner.builder, BF16H_LOOP_ROWS, 4.0, ("vmap",))):
        rng = np.random.default_rng(SEED + rows)
        clean = np.stack([request_audio(seconds, 120 + s) for s in range(rows)])
        noise = 0.05 * rng.standard_normal(clean.shape).astype(np.float32)
        wavs = np.stack([clean + noise, clean, noise], axis=1)
        lengths = np.array([int(seconds * SR) - 1600 * (k % 3) for k in range(rows)])
        base = copy.deepcopy(builder.model).cpu()
        for impl in impls:
            fn = S.make_scoring_fn(builder, None, impl=impl)
            sides = {}
            for device in ("cuda", "cpu"):
                for dtype in (torch.bfloat16, torch.float32):
                    model = with_dtype(copy.deepcopy(base), dtype).to(device)
                    b = dataclasses.replace(builder, model=model)
                    f = S.make_scoring_fn(b, None, impl=impl)
                    if device == "cuda" and dtype == torch.bfloat16:
                        # -- the main path: the scoring call on the card in bf16 --
                        reset_counts((L.lstm_bidir_tm_fc, L.lstm_bidir_tm_bwd,
                                      L.lstm_bidir_tm_dw_bf16))
                        t0 = time.perf_counter()
                        emb = f(model, wavs, lengths).detach().cpu()
                        torch.cuda.synchronize()
                        ms = (time.perf_counter() - t0) * 1e3
                        counts = [L.lstm_bidir_tm_fc.launches, L.lstm_bidir_tm_fc.h_bf16,
                                  L.lstm_bidir_tm_bwd.launches, L.lstm_bidir_tm_bwd.h_bf16,
                                  L.lstm_bidir_tm_dw_bf16.launches]
                        # ---------------------------------------------------------
                    else:
                        emb = f(model, wavs, lengths).detach().cpu()
                    query = f(model, wavs, lengths, mean=True).detach().cpu()
                    sides[(device, dtype)] = (emb, S.matching(query, emb))
            order = ((("cuda", torch.bfloat16)), ("cuda", torch.float32),
                     ("cpu", torch.bfloat16), ("cpu", torch.float32))
            w = window(torch, *(sides[k][0] for k in order), f"{name} {impl} bf16 scoring")
            same = torch.equal(sides[order[0]][1] > 0, sides[order[2]][1] > 0)
            match_err = float((sides[order[0]][1] - sides[order[2]][1]).abs().max())
            one_dir = not builder.model.lstm.bidirectional
            want = ([3 * rows, 3 * rows, 3 * rows, 3 * rows, 3 * rows] if one_dir
                    else [3, 0, 3, 0, 0])
            print(f"[bf16h] scoring the {name} in bf16 ({fn.impl} engine, {rows} rows of "
                  f"{seconds:.0f} s, card {ms:.1f} ms): window against the CPU ({w[0]:.3f}, "
                  f"{w[1]:.3f}) (limits {WINDOW_NEAR}; {WINDOW_LOW}, {WINDOW_HIGH}); match "
                  f"> 0 set the same {same}, max |match card - CPU| {match_err:.2e}; launches "
                  f"(B2 fwd, of it bf16-h, B2 bwd, of it bf16-h, dW_hh^T bf16) {counts} (want "
                  f"{want}) | {card}", flush=True)
            if not same or counts != want:
                raise AssertionError(f"{name} {impl} bf16 scoring: same {same}, launches "
                                     f"{counts}, want {want}")
            out[(name, impl)] = (w, ms, counts)
    return out


def one_direction_bf16_phase(torch, L, counted, dsp_kernels, card, tmp):
    """Phase 13: the one-direction LSTM in bf16 on the card. ``counted``: B1,
    B2 fwd, B2 bwd, the dW_hh^T kernel, B4, B5."""
    corpus = os.path.join(tmp, "corpus")
    write_corpus(corpus, SEED)
    checks = bf16_h_checks(torch, L)
    runner, _, run_counts = vcb_bf16_run(torch, corpus, tmp, counted)
    step = vcb_step_window(torch, runner, card)
    serving = one_dir_bf16_serving(torch, counted, dsp_kernels, card, tmp)
    scoring = bf16_scoring(torch, runner, card)
    times = bf16_h_times(torch, L, card)
    return {"checks": checks, "run_counts": run_counts, "step": step, "serving": serving,
            "scoring": scoring, "times": times}


# the bf16 stream forms of B1 / B2 fwd / B2 bwd (phase 14): the JAX package's
# SE_LSTM_XW_BF16 (xw stored in bf16, dxw written in it), SE_PALLAS_HS_BF16
# (B1 stores hs in bf16) and SE_PALLAS_VJP_BF16 (B2 fwd stores hs and cs in
# bf16; B2 bwd reads them, rounds W_hh^T and the dh product's da), against
# their plain versions on the same inputs, then the models that read those
# variables, card against CPU, and times.
# (ndir, B, T, H) of the checks: the cluster route at the flagship shape, with
# one direction, at B = 16 and at T = 1; the grid route at H = 36 and 260
STREAM_SHAPES = ((2, 6, 1001, 256), (1, 6, 1001, 256), (2, 16, 1001, 256), (2, 3, 1, 256),
                 (2, 3, 57, 36), (2, 2, 57, 260))
# A stored bf16 stream (hs, cs; dxw in the bf16 xw form) against its plain
# version: the kernel's f32 value and the plain version's differ by f32
# summation orders (~1e-7), so their roundings to bf16 agree but where a value
# lies within that of a rounding boundary, and then differ by one bf16 unit;
# the recurrence itself stays f32, so a flip of a stored value moves nothing
# later (a flip of the dh product's rounded da does, by a fraction of a unit).
# Held: within one bf16 unit on this share, identical on the second (read
# on an NVIDIA H100 80GB HBM3 at 700 W: >= 0.99998 / 0.9999 at T = 1001; the
# f32 form's values are no bf16 numbers, identical on ~0). The bf16 dxw of the
# residual backward also carries the flips of its rounded da (below) into the
# earlier steps: the second pair (read >= 0.99904 / 0.99187; the f32 form
# 0.858 / 0).
STREAM_ULP_SHARE, STREAM_SAME_SHARE = 0.999, 0.99
STREAM_CHAIN_ULP_SHARE, STREAM_CHAIN_SAME_SHARE = 0.995, 0.98
# an f32 stream of a form computed from the same rounded inputs in other
# orders (hs and cs of B1 / B2 fwd reading a bf16 xw; dW_hh^T and dxw of B2
# bwd reading a bf16 xw): the f32 limits of phase 3, KERNEL_TOL absolute for
# h and B2_TOL of the largest value else. The residual form's backward rounds
# da to bf16 for its dh product, and where that rounding flips (f32-level
# differences near a boundary) the carried dh moves by a fraction of a bf16
# unit into the earlier steps, so its dxw is held to the limits of the
# bf16-h backward (phase 13: RMS and maximum of the largest value; read 9.8e-7
# / 1.2e-4 at B = 6, T = 1001), and its dW_hh^T, a sum of those da over every
# step, to an RMS of this share of its largest value (read 3.0e-6; the f32
# backward on the unrounded residuals 2.7e-4) and the same maximum (read
# 3.0e-5). At T = 1 dW_hh^T is zero in every form.
STREAM_DW_RMS = 1e-5


def bf16_shares(torch, out, ref):
    """(share within one bf16 unit, share identical) of two tensors of bf16
    values (bf16, or f32 holding them); an f32 tensor of other values is
    compared as its rounding, identical only where it is a bf16 number equal
    to ``ref``."""
    def ordered(x):
        bits = x.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    u = (ordered(out) - ordered(ref)).abs()
    same = out.float() == ref.float()
    return float((u <= 1).double().mean()), float(same.double().mean())


def stream_form_checks(torch, L):
    """Phase 14 (a): each stream form of B1, B2 fwd and B2 bwd against its
    plain version on the card at ``STREAM_SHAPES`` (the route each hidden size
    names), every kernel call twice for identical bits, B1 with one direction
    also from a carried state, and the bf16-h form with a bf16 xw (the
    one-direction layer in bf16 under SE_LSTM_XW_BF16). Beside each form the
    f32 form (f32 xw and streams) on the same inputs, which its limits must
    fail. Returns the worst readings."""
    bf16, f32 = torch.bfloat16, torch.float32
    worst = {"h_abs": 0.0, "ulp": 1.0, "same": 1.0, "rel": 0.0,
             "abs": {"b1": 0.0, "fc": 0.0, "bwd": 0.0}}
    cur = {"k": "b1"}  # the kernel whose outputs the held_* calls check
    def flat(x):
        return [y for z in x for y in flat(z)] if isinstance(x, (tuple, list)) else [x]

    def twice(fn):
        a, b = fn(), fn()
        same = all(torch.equal(p, q) for p, q in zip(flat(a), flat(b)))
        if not same:
            raise AssertionError("a stream-form kernel gave other bits on the same inputs")
        return a

    failed = []

    def held_f32(name, out, ref, form_f32, kind, apart=True):
        """``kind`` "h" (KERNEL_TOL absolute), "rel" (B2_TOL of the largest
        value), "chain" / "chain_dw" (RMS and maximum of the largest value);
        ``apart``: the f32 form must fail the limit."""
        scale = 1.0 if kind == "h" else (float(ref.abs().max()) or 1.0)
        mx, rms, _ = spread(torch, out.float(), ref.float(), scale)
        f_mx, f_rms, _ = spread(torch, form_f32.float(), ref.float(), scale)
        if kind.startswith("chain"):
            rms_tol = STREAM_DW_RMS if kind == "chain_dw" else BF16H_DXW_RMS
            ok = mx <= BF16H_DXW_MAX and rms <= rms_tol and (f_rms > rms_tol or not apart)
        else:
            tol = KERNEL_TOL if kind == "h" else B2_TOL
            ok = mx <= tol and (tol < f_mx or not apart)
        if not ok:
            failed.append(name)
        worst["abs"][cur["k"]] = max(worst["abs"][cur["k"]],
                                     float((out.float() - ref.float()).abs().max()))
        key = {"h": "h_abs", "rel": "rel", "chain": "chain_rms", "chain_dw": "dw_rms"}[kind]
        worst[key] = max(worst.get(key, 0.0), rms if kind.startswith("chain") else mx)
        return f"{name} {mx:.2e} / {rms:.2e} RMS (f32 form {f_mx:.2e} / {f_rms:.2e})"

    def held_bf16(name, out, ref, form_f32, chain=False):
        ulp, same = bf16_shares(torch, out, ref)
        f_ulp, f_same = bf16_shares(torch, form_f32, ref)
        is_bf16 = torch.equal(out.to(bf16).float(), out.float())
        lim = ((STREAM_CHAIN_ULP_SHARE, STREAM_CHAIN_SAME_SHARE) if chain
               else (STREAM_ULP_SHARE, STREAM_SAME_SHARE))
        if not (is_bf16 and ulp >= lim[0] and same >= lim[1]) or (
                f_ulp >= lim[0] and f_same >= lim[1]):
            failed.append(name)
        worst["abs"][cur["k"]] = max(worst["abs"][cur["k"]],
                                     float((out.float() - ref.float()).abs().max()))
        worst["ulp"], worst["same"] = min(worst["ulp"], ulp), min(worst["same"], same)
        return f"{name} {ulp:.5f} / {same:.5f} (f32 form {f_ulp:.3f} / {f_same:.3f})"

    for ndir, B, T, H in STREAM_SHAPES:
        xw, w_hh_t, dhs = kernel_grad_inputs(torch, B, T, H, SEED + 140 + B + T, ndir=ndir)
        xw_b = xw.to(bf16)
        # the plain versions: the recurrence from the bf16 xw and from the f32
        # one (the f32 form), whose roundings give every stored stream
        hs_b, cs_b = L.lstm_bidir_tm_fc_ref(xw_b, w_hh_t)
        hs_f, cs_f = L.lstm_bidir_tm_fc_ref(xw, w_hh_t)
        lines = []
        # B1: bf16 xw; bf16 hs; both
        cur["k"] = "b1"
        out = twice(lambda: L.lstm_bidir_tm(xw_b, w_hh_t))
        lines.append(held_f32("B1 xw", out, hs_b, hs_f, "h"))
        # (B1 hands hs back widened to f32, as the JAX kernel does)
        out = twice(lambda: L.lstm_bidir_tm(xw, w_hh_t, hs_dtype=bf16))
        lines.append(held_bf16("B1 hs", out, hs_f.to(bf16), hs_f))
        out = twice(lambda: L.lstm_bidir_tm(xw_b, w_hh_t, hs_dtype=bf16))
        lines.append(held_bf16("B1 xw+hs", out, hs_b.to(bf16), hs_f))
        # B2 fwd: bf16 xw (f32 residuals); bf16 residuals; both
        cur["k"] = "fc"
        hs, cs = twice(lambda: L.lstm_bidir_tm_fc(xw_b, w_hh_t))
        lines.append(held_f32("B2 fwd xw hs", hs, hs_b, hs_f, "h"))
        lines.append(held_f32("cs", cs, cs_b, cs_f, "rel"))
        for name, x, ref_h, ref_c in (("res", xw, hs_f, cs_f), ("xw+res", xw_b, hs_b, cs_b)):
            hs, cs = twice(lambda x=x: L.lstm_bidir_tm_fc(x, w_hh_t, res_dtype=bf16))
            lines.append(held_bf16(f"B2 fwd {name} hs", hs, ref_h.to(bf16), hs_f))
            lines.append(held_bf16("cs", cs, ref_c.to(bf16), cs_f))
        # B2 bwd on the plain forward's residuals: bf16 xw (f32 residuals,
        # bf16 dxw); bf16 residuals; both. The f32 form: the f32 backward on
        # the f32 xw and residuals
        cur["k"] = "bwd"
        f32_dxw, f32_dw = L.lstm_bidir_tm_bwd_ref(xw, w_hh_t, hs_f, cs_f, dhs)
        res = (hs_b.to(bf16), cs_b.to(bf16), dhs.to(bf16))
        res_f = (hs_f.to(bf16), cs_f.to(bf16), dhs.to(bf16))
        for name, x, r in (("xw", xw_b, (hs_b, cs_b, dhs)), ("res", xw, res_f),
                           ("xw+res", xw_b, res)):
            dxw, dw = twice(lambda x=x, r=r: L.lstm_bidir_tm_bwd(x, w_hh_t, *r))
            ref_dxw, ref_dw = L.lstm_bidir_tm_bwd_ref(x, w_hh_t, *r)
            chain = r[0].dtype == bf16
            if x.dtype == bf16:
                lines.append(held_bf16(f"B2 bwd {name} dxw", dxw, ref_dxw, f32_dxw, chain))
            else:
                lines.append(held_f32(f"B2 bwd {name} dxw", dxw, ref_dxw, f32_dxw,
                                      "chain" if chain else "rel"))
            lines.append(held_f32("dW_hh^T", dw, ref_dw, f32_dw, "chain_dw" if chain else "rel",
                                  apart=T > 1))
        if ndir == 1:
            # the one-direction layer in bf16 under SE_LSTM_XW_BF16: the bf16-h
            # form with a bf16 xw, W_hh^T holding bf16 values; and B1 with a
            # bf16 xw from a carried state
            wb = w_hh_t.to(bf16).float()
            hh, ch = L.lstm_bidir_tm_fc_ref(xw_b, wb, h_bf16=True)
            hh_f = L.lstm_bidir_tm_ref(xw, wb, h_bf16=True)
            out = twice(lambda: L.lstm_bidir_tm(xw_b, wb, h_bf16=True))
            spread_ = spread(torch, out, hh)
            far = spread(torch, hh_f, hh)
            if not (spread_[0] <= BF16H_MAX and spread_[1] <= BF16H_RMS
                    and spread_[2] >= BF16H_SHARE) or far[1] <= BF16H_RMS:
                failed.append("B1 bf16-h xw")
            lines.append(f"B1 bf16-h xw (max, RMS, within 1e-4) {spread_[0]:.2e} / "
                         f"{spread_[1]:.2e} / {spread_[2]:.5f} (xw f32 {far[1]:.2e} RMS)")
            dxw, dw = twice(lambda: L.lstm_bidir_tm_bwd(xw_b, wb, hh, ch, dhs, h_bf16=True))
            ref_dxw, ref_dw = L.lstm_bidir_tm_bwd_ref(xw_b, wb, hh, ch, dhs, h_bf16=True)
            h_dxw = L.lstm_bidir_tm_bwd_ref(xw, wb, hh, ch, dhs, h_bf16=True)[0]
            lines.append(held_bf16("B2 bwd bf16-h xw dxw", dxw, ref_dxw, h_dxw))
            dw_share = ulp_share(torch, dw, ref_dw)[0]
            if dw_share < BF16H_DW_SHARE:
                failed.append("B2 bwd bf16-h xw dW_hh^T")
            lines.append(f"dW_hh^T within one bf16 unit {dw_share:.5f}")
            g = torch.Generator().manual_seed(SEED + 14)
            h0 = (2 * torch.rand(1, B, H, generator=g) - 1).cuda()
            c0 = torch.randn(1, B, H, generator=g).cuda()
            cur["k"] = "b1"
            hs_s, (_, cT) = twice(lambda: L.lstm_bidir_tm(xw_b, w_hh_t, state=(h0, c0),
                                                          return_state=True))
            ref_s, (_, ref_cT) = L.lstm_bidir_tm_ref(xw_b, w_hh_t, state=(h0, c0),
                                                     return_state=True)
            f32_s, (_, f32_cT) = L.lstm_bidir_tm_ref(xw, w_hh_t, state=(h0, c0),
                                                     return_state=True)
            lines.append(held_f32("B1 xw carried hs", hs_s, ref_s, f32_s, "h"))
            lines.append(held_f32("cT", cT, ref_cT, f32_cT, "rel"))
        torch.cuda.synchronize()
        print(f"[streams] ndir={ndir} B={B} T={T} H={H} routes ({L.fwd_route(H)!r}, "
              f"{L.bwd_route(H)!r}), each call twice with identical bits; f32 streams max err "
              f"(limits {KERNEL_TOL:.0e} absolute for h, {B2_TOL:.0e} of the largest value "
              f"else), bf16 streams within one bf16 unit / identical (limits "
              f"{STREAM_ULP_SHARE} / {STREAM_SAME_SHARE}, a bf16 dxw of the residual form "
              f"{STREAM_CHAIN_ULP_SHARE} / {STREAM_CHAIN_SAME_SHARE}; the residual backward's "
              f"(max, RMS) {BF16H_DXW_MAX:.0e} / {BF16H_DXW_RMS:.0e}, dW_hh^T RMS "
              f"{STREAM_DW_RMS:.0e}): " + "; ".join(lines), flush=True)
        if failed:
            raise AssertionError(f"stream forms at ndir={ndir} B={B} T={T} H={H}: {failed}")
        del xw, xw_b, w_hh_t, dhs
    return worst


# the JAX package's bench modes the phase runs (bench.py:48-102, :634): enhance
# / latency (xw and hs in bf16), train (xw and the VJP's residuals), score
# (the VJP's residuals and hs, with --compute_dtype bf16)
ENHANCE_MODE = ("SE_LSTM_XW_BF16", "SE_PALLAS_HS_BF16")
TRAIN_MODE = ("SE_LSTM_XW_BF16", "SE_PALLAS_VJP_BF16")
SCORE_MODE = ("SE_PALLAS_VJP_BF16", "SE_PALLAS_HS_BF16")
# phase 14 (e): vcb's one-direction head streamed and trained on rows of this
# many seconds (served at 10 s)
STREAM_FORM_SECONDS = 4.0


@contextlib.contextmanager
def stream_env(names):
    """The JAX package's LSTM form variables ``names`` set to 1 (the others of
    the six unset) for the block; the environment restored after."""
    every = ("SE_LSTM_XW_BF16", "SE_PALLAS_HS_BF16", "SE_PALLAS_VJP_BF16", *FORM_NAMES)
    saved = {k: os.environ.get(k) for k in every}
    try:
        for k in every:
            if k in names:
                os.environ[k] = "1"
            else:
                os.environ.pop(k, None)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def form_window(torch, run, names, what):
    """The window criterion of a result under the variables ``names`` (the
    form) against the same with none set (the f32 form), card against CPU:
    ``run(device)`` returns the result; returns (near, ratio)."""
    sides = {}
    for device in ("cuda", "cpu"):
        for form in (True, False):
            with stream_env(names if form else ()):
                sides[(device, form)] = run(device)
    order = (("cuda", True), ("cuda", False), ("cpu", True), ("cpu", False))
    return window(torch, *(sides[k] for k in order), what)


def flagship_stream_serving(torch, counted, card):
    """Phase 14 (b): the flagship (3 BLSTM x 256) served at B=1, 10 s, under
    the JAX enhance mode's variables, card against CPU under the window, with
    the launches of the stream-form B1."""
    from speech_enhancement_by_s3prl_tpu_torch.entry import build, make_enhance

    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L
    wav3 = np.stack([request_audio(10.0, 140 + s) for s in range(3)])[None]
    enhancers = {}
    for device in ("cuda", "cpu"):
        pre, model = build(device=device, generator=torch.Generator().manual_seed(SEED + 14))
        enhancers[device] = (make_enhance(pre, model), torch.from_numpy(wav3).to(device),
                             torch.tensor([wav3.shape[-1]]).to(device))
    counts = {}

    def run(device):
        enhance, w, n = enhancers[device]
        if device == "cuda" and os.environ.get("SE_PALLAS_HS_BF16") == "1":
            # -- the main path: the flagship served in the JAX enhance mode --
            reset_counts(counted)
            out = enhance(w, n)
            b1 = L.lstm_bidir_tm
            counts["enhance"] = [b1.launches, b1.xw_bf16, b1.hs_bf16, counted[3].launches,
                                 counted[4].launches]
            # -------------------------------------------------------------
            return out
        return enhance(w, n)

    w = form_window(torch, run, ENHANCE_MODE, "flagship served under the enhance mode")
    print(f"[streams] the flagship (3 BLSTM x 256) served at B=1 10 s under "
          f"{'=1 '.join(ENHANCE_MODE)}=1 on cuda: launches (B1, of it bf16 xw, bf16 hs, B4, B5) "
          f"{counts['enhance']} (want [3, 3, 3, 1, 1]); window against the CPU ({w[0]:.3f}, "
          f"{w[1]:.3f}) (limits {WINDOW_NEAR}; {WINDOW_LOW}, {WINDOW_HIGH}) | {card}", flush=True)
    if counts["enhance"] != [3, 3, 3, 1, 1]:
        raise AssertionError(f"flagship enhance mode: launches {counts['enhance']}")
    # the B=1 10 s call under the mode beside f32, in turns
    enhance, wv, n = enhancers["cuda"]
    ms = {}
    for form in (False, True, True, False):
        with stream_env(ENHANCE_MODE if form else ()):
            t = synced_ms(torch, lambda: enhance(wv, n), runs=20)
        key = "streams" if form else "f32"
        ms[key] = min(ms.get(key, math.inf), statistics.median(t))
    print(f"[time] flagship enhance B=1 10 s: median {ms['streams']:.3f} ms under the enhance "
          f"mode, {ms['f32']:.3f} ms in f32 (medians of 20, better of two turns) | {card}",
          flush=True)
    return {"window": w, "launches": counts["enhance"], "ms": ms}


def step_sides(torch, builders, wavs_np, names, what, counted=None):
    """One loss and gradient of ``builders[device]`` (StepBuilders over the
    same weights) on the card and the CPU, under ``names`` and with none set:
    the window on the loss and the whole gradient. With ``counted`` (the
    kernels, then the form counters' owners) the card's launches under the
    form are returned, from one ``train_step`` of the card's builder."""
    from speech_enhancement_by_s3prl_tpu_torch.runner.trainer import make_context

    def run(device):
        b = builders[device]
        wavs = torch.from_numpy(wavs_np).to(device)
        lengths = torch.full((wavs.shape[0],), wavs.shape[-1], dtype=torch.long, device=device)
        ctx = make_context(b.preprocessor, wavs, lengths, b.channel_inp, b.channel_tar)
        loss, _ = b.loss_fn(ctx)
        g = torch.autograd.grad(loss, list(b.model.parameters()))
        return torch.cat([loss.detach().reshape(1).double().cpu()]
                         + [x.detach().reshape(-1).double().cpu() for x in g])

    sides = {}
    for device in ("cuda", "cpu"):
        for form in (True, False):
            with stream_env(names if form else ()):
                sides[(device, form)] = run(device)
    order = (("cuda", True), ("cuda", False), ("cpu", True), ("cpu", False))
    losses = [float(sides[k][0]) for k in order]
    if abs(losses[2] - losses[3]) > TRAIN_LOSS_TOL * abs(losses[3]):
        loss_w = window(torch, *(sides[k][:1] for k in order), f"{what} loss")
    else:
        # the form moves the loss by no more than f32 summation orders do
        # (the flagship at 10 s: not at all; vcb's head: one f32 unit), so a
        # window has nothing to measure: the card's loss is held to the CPU's
        # as phase 3 holds the f32 step, and reported as (rel, 0)
        loss_w = (abs(losses[0] - losses[2]) / abs(losses[2]), 0.0)
        if not loss_w[0] <= TRAIN_LOSS_TOL:
            raise AssertionError(f"{what} loss: card {losses[0]}, CPU {losses[2]}")
    grad_w = window(torch, *(sides[k][1:] for k in order), f"{what} gradient")
    counts = None
    if counted is not None:
        b = builders["cuda"]
        wavs = torch.from_numpy(wavs_np).cuda()
        lengths = torch.full((wavs.shape[0],), wavs.shape[-1], dtype=torch.long).cuda()
        state = b.init_state()
        with stream_env(names):
            # -- the main path: one train step under the form --
            reset_counts(counted)
            state, stats = b.train_step(state, wavs, lengths)
            counts = form_counts(counted)
            # ---------------------------------------------------
        if not math.isfinite(float(stats["loss"])):
            raise AssertionError(f"{what}: train step loss {stats['loss']}")
    return loss_w, grad_w, counts, sides


def form_counts(counted):
    """Launches of each kernel in ``counted`` and, for B1 / B2 fwd / B2 bwd,
    of their stream forms: [B1, xw, hs, B2 fwd, xw, res, B2 bwd, xw, res,
    then the others' launches]."""
    out = []
    for fn in counted:
        out.append(fn.launches)
        if hasattr(fn, "hs_bf16"):
            out += [fn.xw_bf16, fn.hs_bf16]
        elif hasattr(fn, "res_bf16"):
            out += [fn.xw_bf16, fn.res_bf16]
    return out


def train_batch(seconds, rows, seed):
    clean = np.stack([request_audio(seconds, seed + s) for s in range(rows)])
    noise = 0.05 * np.random.default_rng(seed).standard_normal(clean.shape).astype(np.float32)
    return np.stack([clean + noise, clean, noise], axis=1)


def flagship_stream_step(torch, counted, card):
    """Phase 14 (c): one flagship train step (B=6, 10 s) under the JAX train
    mode's variables, card against CPU under the window, the launches of the
    stream-form B2 fwd / B2 bwd, and the step's time beside f32."""
    from speech_enhancement_by_s3prl_tpu_torch.entry import build_train
    from speech_enhancement_by_s3prl_tpu_torch.runner.trainer import make_context

    builders = {d: build_train(device=d, generator=torch.Generator().manual_seed(SEED + 14))
                for d in ("cuda", "cpu")}
    wavs_np = train_batch(10.0, 6, 150)
    loss_w, grad_w, counts, _ = step_sides(torch, builders, wavs_np, TRAIN_MODE,
                                           "flagship step under the train mode", counted)
    want = [0, 0, 0, 3, 3, 3, 3, 3, 3, 1, 0, 0]
    print(f"[streams] flagship train step B=6 10 s under {'=1 '.join(TRAIN_MODE)}=1: window "
          f"card against CPU loss ({loss_w[0]:.3g}, {loss_w[1]:.3f}; a ratio 0 when the form "
          f"leaves the f32 loss as it is, then the first is card against CPU relative, limit "
          f"{TRAIN_LOSS_TOL:.0e}), gradient "
          f"({grad_w[0]:.3f}, {grad_w[1]:.3f}); launches (B1, xw, hs, B2 fwd, xw, res, B2 bwd, "
          f"xw, res, B4, B5, dW_hh^T bf16) {counts} (want {want}) | {card}", flush=True)
    if counts != want:
        raise AssertionError(f"flagship train mode: launches {counts}")
    b = builders["cuda"]
    wavs = torch.from_numpy(wavs_np).cuda()
    lengths = torch.full((6,), wavs.shape[-1], dtype=torch.long).cuda()
    ms = {}
    for form in (False, True, True, False):
        box = [b.init_state()]

        def one(box=box):
            box[0], _ = b.train_step(box[0], wavs, lengths)

        with stream_env(TRAIN_MODE if form else ()):
            t = synced_ms(torch, one, runs=10)
        key = "streams" if form else "f32"
        ms[key] = min(ms.get(key, math.inf), statistics.median(t))
    del box, one
    # the memory the loss and its gradient take beyond what is allocated
    # before (the model, the batch): what the forward keeps for the backward,
    # and the peak of each pass
    mib = {}
    params = list(b.model.parameters())
    for form in (False, True):
        with stream_env(TRAIN_MODE if form else ()):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ctx = make_context(b.preprocessor, wavs, lengths, b.channel_inp, b.channel_tar)
            loss, _ = b.loss_fn(ctx)
            torch.cuda.synchronize()
            kept, fwd_peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
            bwd_peak = torch.cuda.max_memory_allocated()
            del ctx, loss
        mib["streams" if form else "f32"] = tuple(
            (x - base) / 2**20 for x in (kept, fwd_peak, bwd_peak))
    print(f"[time] flagship train step B=6 10 s: median {ms['streams']:.3f} ms under the train "
          f"mode, {ms['f32']:.3f} ms in f32 (medians of 10 synchronized steps, better of two "
          f"turns); its loss and gradient (MiB beyond what was allocated before: kept by the "
          f"forward, forward peak, backward peak) {' / '.join(f'{x:.1f}' for x in mib['streams'])}"
          f" under the mode, {' / '.join(f'{x:.1f}' for x in mib['f32'])} in f32 | {card}",
          flush=True)
    return {"loss": loss_w, "grad": grad_w, "launches": counts, "ms": ms, "mib": mib}


def active_score_mode(torch, card):
    """Phase 14 (d): config/active.yaml's head (LSTM 3 x 256, bidirectional,
    L1, the flagship's 120-d log-mel) in bf16 scored under the JAX score
    mode's variables, ``BF16H_SCORE_ROWS`` rows of 10 s, under both engines:
    the card's ``match > 0`` set the CPU's, every B2 launch in the residual
    form."""
    import copy
    import dataclasses

    from speech_enhancement_by_s3prl_tpu_torch.active import sampler as S
    from speech_enhancement_by_s3prl_tpu_torch.entry import build
    from speech_enhancement_by_s3prl_tpu_torch.models.heads import build_head
    from speech_enhancement_by_s3prl_tpu_torch.objectives import build_objective
    from speech_enhancement_by_s3prl_tpu_torch.runner.optim import build_optimizer
    from speech_enhancement_by_s3prl_tpu_torch.runner.trainer import StepBuilder

    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L
    pre, _ = build(device="cpu")
    head = build_head("LSTM", input_size=pre.feat_dims()[1], output_size=201, hidden_size=256,
                      num_layers=3, bidirectional=True, compute_dtype="bf16",
                      generator=torch.Generator().manual_seed(SEED + 14))
    builder = StepBuilder(preprocessor=pre, model=head, objective=build_objective("L1"),
                          optimizer=build_optimizer("Adam", 1e-4, 0.07, 100),
                          from_rawfeature=True)
    rows = BF16H_SCORE_ROWS
    wavs = train_batch(10.0, rows, 160)
    lengths = np.array([int(10.0 * SR) - 1600 * (k % 3) for k in range(rows)])
    out = {}
    counted = (L.lstm_bidir_tm, L.lstm_bidir_tm_fc, L.lstm_bidir_tm_bwd)
    for impl in ("vmap", "capture"):
        sides = {}
        for device in ("cuda", "cpu"):
            model = copy.deepcopy(head).to(device)
            f = S.make_scoring_fn(dataclasses.replace(builder, model=model), None, impl=impl)
            with stream_env(SCORE_MODE):
                if device == "cuda":
                    # -- the main path: scoring in the JAX score mode --
                    reset_counts(counted)
                    emb = f(model, wavs, lengths).detach().cpu()
                    counts = form_counts(counted)
                    # ----------------------------------------------------
                else:
                    emb = f(model, wavs, lengths).detach().cpu()
                query = f(model, wavs, lengths, mean=True).detach().cpu()
            sides[device] = (emb, S.matching(query, emb))
        same = torch.equal(sides["cuda"][1] > 0, sides["cpu"][1] > 0)
        rel = float((sides["cuda"][0] - sides["cpu"][0]).pow(2).mean().sqrt()
                    / sides["cpu"][0].pow(2).mean().sqrt())
        forms_ok = counts[3] == counts[5] > 0 and counts[6] == counts[8] == counts[3]
        print(f"[streams] config/active.yaml head in bf16 scored under "
              f"{'=1 '.join(SCORE_MODE)}=1 ({impl} engine, {rows} rows of 10 s): match > 0 set "
              f"the CPU's {same}, embeddings card against CPU {rel:.2e} of their RMS; launches "
              f"(B1, xw, hs, B2 fwd, xw, res, B2 bwd, xw, res) {counts} | {card}", flush=True)
        if not (same and forms_ok):
            raise AssertionError(f"active score mode {impl}: same {same}, launches {counts}")
        out[impl] = (same, rel, counts)
    return out


def vcb_xw_form(torch, counted, card):
    """Phase 14 (e): vcb's one-direction head (Residual 3 x 256 on the
    flagship features) under SE_LSTM_XW_BF16=1 alone, in f32 and in bf16:
    served at B=1 10 s, streamed in 48-frame chunks and one train step (B=6),
    card against CPU under the window, with the launches of the xw form."""
    from speech_enhancement_by_s3prl_tpu_torch.entry import build, build_train, make_enhance
    from speech_enhancement_by_s3prl_tpu_torch.ops.streaming import StatefulStreamer

    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L
    names = ("SE_LSTM_XW_BF16",)
    wav3 = np.stack([request_audio(10.0, 170 + s) for s in range(3)])[None]
    n_stream = int(STREAM_FORM_SECONDS * SR)
    wav = speech_like(n_stream, 53)
    sizes = np.random.default_rng(SEED + 14).integers(700, 9000, size=200)
    out = {}
    for dt in ("f32", "bf16"):
        gen = lambda: torch.Generator().manual_seed(SEED + 15)  # noqa: E731
        built = {d: build(bidirectional=False, compute_dtype=dt, device=d, generator=gen())
                 for d in ("cuda", "cpu")}
        counts = {}

        def served(device):
            pre, model = built[device]
            w = torch.from_numpy(wav3).to(device)
            n = torch.tensor([wav3.shape[-1]]).to(device)
            if device == "cuda" and os.environ.get("SE_LSTM_XW_BF16") == "1":
                # -- the main path: the one-direction head served, xw form --
                reset_counts(counted)
                res = make_enhance(pre, model)(w, n)
                counts["served"] = form_counts(counted[:1]) + [L.lstm_bidir_tm.h_bf16]
                # ----------------------------------------------------------
                return res
            return make_enhance(pre, model)(w, n)

        def streamed(device):
            pre, model = built[device]
            streamer = StatefulStreamer(model, pre, frames_per_chunk=STREAM_FRAMES)
            if device == "cuda" and os.environ.get("SE_LSTM_XW_BF16") == "1":
                # -- the main path: the one-direction head streamed, xw form --
                reset_counts(counted)
                res = drive_stream(streamer, wav, sizes)
                counts["stream"] = [L.lstm_bidir_tm.launches, L.lstm_bidir_tm.carried,
                                    L.lstm_bidir_tm.xw_bf16]
                # ------------------------------------------------------------
                return res
            return drive_stream(streamer, wav, sizes)

        w_served = form_window(torch, served, names, f"vcb head {dt} served, xw form")
        w_stream = form_window(torch, streamed, names, f"vcb head {dt} streamed, xw form")
        builders = {d: build_train(bidirectional=False, compute_dtype=dt, device=d,
                                   generator=gen()) for d in ("cuda", "cpu")}
        loss_w, grad_w, step_counts, _ = step_sides(
            torch, builders, train_batch(STREAM_FORM_SECONDS, 6, 180), names,
            f"vcb head {dt} train step, xw form", counted)
        chunks = counts["stream"][0] // 3
        h = 3 if dt == "bf16" else 0
        want = {"served": [3, 3, 0, h], "stream": [3 * chunks] * 3,
                "step": [0, 0, 0, 3, 3, 0, 3, 3, 0, 1, 0, h]}
        got = {"served": counts["served"], "stream": counts["stream"], "step": step_counts}
        print(f"[streams] vcb's one-direction head (Residual 3 x 256) in {dt} under "
              f"SE_LSTM_XW_BF16=1, card against CPU: served B=1 10 s window ({w_served[0]:.3f}, "
              f"{w_served[1]:.3f}), launches (B1, xw, hs, bf16-h) {got['served']}; streamed "
              f"{STREAM_FORM_SECONDS:.0f} s in {chunks} chunks of {STREAM_FRAMES} frames window "
              f"({w_stream[0]:.3f}, {w_stream[1]:.3f}), launches (B1, with state, xw) "
              f"{got['stream']}; train step B=6 {STREAM_FORM_SECONDS:.0f} s window loss "
              f"({loss_w[0]:.3g}, {loss_w[1]:.3f}; ratio 0: card against CPU relative, the form "
              f"within f32 noise), gradient ({grad_w[0]:.3f}, {grad_w[1]:.3f}), "
              f"launches (B1, xw, hs, B2 fwd, xw, res, B2 bwd, xw, res, B4, B5, dW_hh^T bf16) "
              f"{got['step']} (limits {WINDOW_NEAR}; {WINDOW_LOW}, {WINDOW_HIGH}) | {card}",
              flush=True)
        if got != want or chunks < 1:
            raise AssertionError(f"vcb head {dt} xw form: launches {got}, want {want}")
        out[dt] = {"served": w_served, "stream": w_stream, "loss": loss_w, "grad": grad_w,
                   "launches": got}
    return out


# the forms timed in phase 14 (f), as (xw bf16, out bf16): B1's hs, B2's
# residuals
STREAM_TIMED = {"xw": (True, False), "out": (False, True), "xw+out": (True, True),
                "f32": (False, False)}


def stream_times(torch, L, card):
    """Phase 14 (f): each form of B1 (B=1), B2 fwd and B2 bwd (B=6) at the
    flagship shape (2, B, 1001, 256) beside the f32 form and the plain
    version, kernels in turns (f32 form, forms, forms, f32 form), with the
    bound of each."""
    T, H, bf16 = 1001, 256, torch.bfloat16
    times = {}
    for kind, B in (("b1", 1), ("fc", 6), ("bwd", 6)):
        xw, w_hh_t, dhs = kernel_grad_inputs(torch, B, T, H, SEED + 190 + B)
        xw_b = xw.to(bf16)
        hs, cs = L.lstm_bidir_tm_fc(xw, w_hh_t)
        res = (hs.to(bf16), cs.to(bf16), dhs.to(bf16))

        def call(form, plain=False):
            xb, ob = STREAM_TIMED[form]
            x, out_dt = (xw_b if xb else xw), (bf16 if ob else torch.float32)
            if kind == "b1":  # the kernel launched directly: no widening of hs after it
                if plain:
                    return lambda: L.lstm_bidir_tm_ref(x, w_hh_t, hs_dtype=out_dt)
                return lambda: L._launch_fwd(L.fwd_route(H), x, w_hh_t, out_dtype=out_dt)
            if kind == "fc":
                fn = L.lstm_bidir_tm_fc_ref if plain else L.lstm_bidir_tm_fc
                return lambda: fn(x, w_hh_t, res_dtype=out_dt)
            fn = L.lstm_bidir_tm_bwd_ref if plain else L.lstm_bidir_tm_bwd
            r = res if ob else (hs, cs, dhs)
            return lambda: fn(x, w_hh_t, *r)

        ms = {}
        for form in ("f32", "xw", "out", "xw+out", "xw+out", "out", "xw", "f32"):
            ms[form] = min(ms.get(form, math.inf), cuda_ms(torch, call(form), 10))
        plain = cuda_ms(torch, call("xw+out", plain=True), 1)
        for form, t in ms.items():
            b = stream_bound(B, T, H, kind, *STREAM_TIMED[form])
            times[(kind, form)] = (t, b)
        times[(kind, "plain")] = plain
        print(f"[time] {kind} stream forms B={B} T={T} H={H} (kernel ms, better of two turns; "
              f"bound ms): " + ", ".join(f"{f} {ms[f]:.4f} ({times[(kind, f)][1][0]:.4f} by "
                                         f"{times[(kind, f)][1][1]})" for f in STREAM_TIMED)
              + f"; plain (xw+out) {plain:.3f} | {card}", flush=True)
        del xw, xw_b, w_hh_t, dhs, hs, cs, res
    return times


# B1's forms of other functions (phase 14, since the MXU, gates and int8
# forms): the JAX package's SE_PALLAS_MXU_BF16 and SE_PALLAS_GATES_BF16 (its
# Pallas B1: W_hh^T and h_{t-1} rounded to bf16 for the step product; the
# gate activations and i * g in bf16) and SE_LSTM_XW_INT8 (its scan: an int8
# xw with an f32 scale a row and step), each against its plain version on the
# same inputs, then the models that read them, card against CPU, and times.
# (ndir, B, T, H) of the Pallas forms: the flagship shape at B = 1, 64 and the
# enhance mode's 768 rows (cluster route), and H = 60 (grid route)
FORM_SHAPES = ((2, 1, 1001, 256), (2, 64, 1001, 256), (2, 768, 1001, 256), (2, 6, 201, 60))
# the int8 form, one direction: the flagship width at B = 6 and 16 (cluster)
# and H = 60 (grid); from a carried state at T = 48 on both routes
INT8_SHAPES = ((1, 6, 1001, 256), (1, 16, 401, 256), (1, 6, 201, 60))
INT8_CARRIED_SHAPES = ((1, 6, 48, 256), (1, 6, 48, 60))
# the forms of B1 checked: (name, mxu, gates, hs stored in bf16)
B1_FORM_CASES = (("mxu", True, False, False), ("mxu+hs", True, False, True),
                 ("gates", False, True, False), ("mxu+gates+hs", True, True, True))
# The gates form against its plain version: the kernel and the plain version
# round the gates to bf16 after f32 sums in other orders, and the CUDA tanhf
# and torch's tanh differ by an f32 unit, so where a gate lies that close to
# a bf16 rounding boundary the two round it apart, by one bf16 unit of the
# gate, and the flip carries on through c (the recurrence is contractive).
# Held: the RMS difference and the share within 1e-4, in the manner of the
# bf16-h form's limits (phase 13), the maximum a few bf16 units of a gate;
# the f32 form (no rounding of the gates) must fail the RMS. Read on an
# NVIDIA H100 80GB HBM3 at 700 W at (2, B, 1001, 256), B = 1, 64, 768: max
# 3.2e-3 to 6.5e-3, RMS 6.7e-5 to 7.3e-5, 0.984 to 0.987 within 1e-4; with
# the MXU form and bf16 hs 3.9e-3 to 7.8e-3, 1.2e-4 to 1.65e-4, 0.965 to
# 0.981; the grid route (H = 60) 5e-7 / 2.4e-3; the f32 form 7.1e-4 to 7.8e-4
# RMS.
GATES_MAX, GATES_RMS, GATES_SHARE = 2e-2, 3e-4, 0.9
FORM_NAMES = ("SE_PALLAS_MXU_BF16", "SE_PALLAS_GATES_BF16", "SE_LSTM_XW_INT8")
# the served flagship's forms: the variables of each
SERVE_FORMS = {"mxu": ("SE_PALLAS_MXU_BF16",), "gates": ("SE_PALLAS_GATES_BF16",),
               "mxu+gates+hs": ("SE_PALLAS_MXU_BF16", "SE_PALLAS_GATES_BF16",
                                "SE_PALLAS_HS_BF16")}
# rows of the enhance mode's batch (the JAX bench's), served under each form
ENHANCE_MODE_ROWS = 768


def b1_form_checks(torch, L):
    """Phase 14 (a), the forms of other functions: B1's MXU, gates and
    MXU + gates + bf16 hs forms at ``FORM_SHAPES`` and its int8 form at
    ``INT8_SHAPES`` (also in the bf16-h form, and from a carried state at
    ``INT8_CARRIED_SHAPES``), each against its plain version on the same
    inputs, every kernel call twice for identical bits, beside the f32 form,
    which its limits must fail. Returns the worst readings."""
    bf16, f32 = torch.bfloat16, torch.float32
    worst = {"abs": 0.0, "mxu": (0.0, 0.0, 1.0), "gates": (0.0, 0.0, 1.0), "ulp": 1.0,
             "same": 1.0, "int8_abs": 0.0, "int8_bf16h": (0.0, 0.0, 1.0)}
    failed = []

    def flat(x):
        return [y for z in x for y in flat(z)] if isinstance(x, (tuple, list)) else [x]

    def twice(fn):
        a, b = fn(), fn()
        if not all(torch.equal(p, q) for p, q in zip(flat(a), flat(b))):
            raise AssertionError("a B1 form gave other bits on the same inputs")
        return a

    def held_spread(name, out, ref, f32_form, lim):
        s, far = spread(torch, out.float(), ref.float()), spread(torch, f32_form, ref.float())
        ok = s[0] <= lim[0] and s[1] <= lim[1] and s[2] >= lim[2] and far[1] > lim[1]
        if not ok:
            failed.append(name)
        return s, (f"{name} (max, RMS, within 1e-4) {s[0]:.2e} / {s[1]:.2e} / {s[2]:.5f} "
                   f"(f32 form RMS {far[1]:.2e})")

    for ndir, B, T, H in FORM_SHAPES:
        xw, w_hh_t = kernel_inputs(torch, B, T, H, SEED + 260 + B + H, ndir=ndir)
        wb = L._bf16(w_hh_t)
        f32_form = L.lstm_bidir_tm_ref(xw, w_hh_t)
        lines = []
        plain = {}  # the plain f32 hs of (mxu, gates); bf16 hs is its rounding
        for name, mxu, gates, hs_b in B1_FORM_CASES:
            dt = bf16 if hs_b else f32
            out = twice(lambda: L.lstm_bidir_tm(xw, w_hh_t, hs_dtype=dt, mxu_bf16=mxu,
                                                gates_bf16=gates))
            if (mxu, gates) not in plain:
                plain[(mxu, gates)] = L.lstm_bidir_tm_ref(xw, wb if mxu else w_hh_t,
                                                          h_bf16=mxu, gates_bf16=gates)
            ref = plain[(mxu, gates)].to(dt)
            worst["abs"] = max(worst["abs"], float((out - ref.float()).abs().max()))
            if hs_b and not gates:
                ulp, same = bf16_shares(torch, out, ref)
                f_same = bf16_shares(torch, f32_form, ref)[1]
                if not (ulp >= STREAM_ULP_SHARE and same >= STREAM_SAME_SHARE) or \
                        f_same >= STREAM_SAME_SHARE:
                    failed.append(name)
                worst["ulp"], worst["same"] = min(worst["ulp"], ulp), min(worst["same"], same)
                lines.append(f"{name} within one bf16 unit / identical {ulp:.5f} / {same:.5f} "
                             f"(f32 form identical {f_same:.3f})")
                continue
            lim = ((GATES_MAX, GATES_RMS, GATES_SHARE) if gates
                   else (BF16H_MAX, BF16H_RMS, BF16H_SHARE))
            s, line = held_spread(name, out, ref, f32_form, lim)
            key = "gates" if gates else "mxu"
            worst[key] = worse(worst[key], s)
            lines.append(line)
        del plain
        torch.cuda.synchronize()
        print(f"[forms] B1 ndir={ndir} B={B} T={T} H={H} route {L.fwd_route(H)!r}, each call "
              f"twice with identical bits, against its plain version (MXU limits {BF16H_MAX:.0e}"
              f" / {BF16H_RMS:.0e} / {BF16H_SHARE}; gates {GATES_MAX:.0e} / {GATES_RMS:.0e} / "
              f"{GATES_SHARE}; bf16 hs {STREAM_ULP_SHARE} / {STREAM_SAME_SHARE}): "
              + "; ".join(lines), flush=True)
        del xw, w_hh_t, wb, f32_form
    for ndir, B, T, H in INT8_SHAPES + INT8_CARRIED_SHAPES:
        xw, w_hh_t = kernel_inputs(torch, B, T, H, SEED + 280 + B + T + H, ndir=ndir)
        q, scale = L.quantize_xw_int8(xw)
        carried = T == 48
        state = None
        if carried:
            g = torch.Generator().manual_seed(SEED + 281)
            state = ((2 * torch.rand(ndir, B, H, generator=g) - 1).cuda(),
                     torch.randn(ndir, B, H, generator=g).cuda())
        lines = []
        for h_bf16 in (False, True):
            w = L._bf16(w_hh_t) if h_bf16 else w_hh_t
            kw = dict(state=state, return_state=carried, h_bf16=h_bf16)
            out = twice(lambda: L.lstm_bidir_tm(q, w, xw_scale=scale, **kw))
            ref = L.lstm_bidir_tm_ref(q, w, xw_scale=scale, **kw)
            f32_form = L.lstm_bidir_tm_ref(xw, w, **kw)
            hs, ref_hs, f_hs = ((o[0] if carried else o) for o in (out, ref, f32_form))
            err, far = float((hs - ref_hs).abs().max()), float((f_hs - ref_hs).abs().max())
            worst["int8_abs"] = max(worst["int8_abs"], err)
            tag = "int8 bf16-h" if h_bf16 else "int8"
            if h_bf16:
                s, line = held_spread(tag, hs, ref_hs, f_hs, (BF16H_MAX, BF16H_RMS, BF16H_SHARE))
                worst["int8_bf16h"] = worse(worst["int8_bf16h"], s)
            else:
                if not err <= KERNEL_TOL < far:
                    failed.append(tag)
                line = f"{tag} hs {err:.2e} (f32 xw {far:.2e})"
            if carried:
                c_err = rel_err(out[1][1], ref[1][1])
                if not c_err <= B2_TOL:
                    failed.append(f"{tag} cT")
                line += f", cT {c_err:.2e} of its largest"
            lines.append(line)
        torch.cuda.synchronize()
        print(f"[forms] B1 int8 xw ndir={ndir} B={B} T={T} H={H} route {L.fwd_route(H)!r}"
              + (" from a carried state" if carried else "") + f", each call twice with "
              f"identical bits, against its plain version (limits {KERNEL_TOL:.0e} absolute; "
              f"bf16-h {BF16H_MAX:.0e} / {BF16H_RMS:.0e} / {BF16H_SHARE}; cT {B2_TOL:.0e}): "
              + "; ".join(lines), flush=True)
        del xw, w_hh_t, q, scale
    if failed:
        raise AssertionError(f"B1 forms: {failed}")
    return worst


def form_delta(a, b):
    """The RMS of a - b over b's RMS (numpy arrays)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def flagship_form_serving(torch, counted, card):
    """Phase 14 (b), the forms of other functions: the flagship (3 BLSTM x
    256) served at B=1, 10 s, under SE_PALLAS_MXU_BF16, SE_PALLAS_GATES_BF16
    and both with SE_PALLAS_HS_BF16, card against CPU under the window (the
    card's change of the waveform against f32 within the window of the CPU's,
    whose plain versions the CPU tests hold to the JAX forms), with each
    form's B1 launches; then the enhance mode's 768 rows under each form on
    the card only, each row within SLICE_TOL of the B=1 call's."""
    from speech_enhancement_by_s3prl_tpu_torch.entry import build, make_enhance

    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L
    b1 = L.lstm_bidir_tm
    wav3 = np.stack([request_audio(10.0, 200 + s) for s in range(3)])[None]
    enhancers = {}
    for device in ("cuda", "cpu"):
        pre, model = build(device=device, generator=torch.Generator().manual_seed(SEED + 24))
        enhancers[device] = (make_enhance(pre, model), torch.from_numpy(wav3).to(device),
                             torch.tensor([wav3.shape[-1]]).to(device))

    def run(device):
        enhance, w, n = enhancers[device]
        return enhance(w, n).detach().cpu().numpy()

    with stream_env(()):
        f32 = {d: run(d) for d in ("cuda", "cpu")}
    out = {}
    for form, names in SERVE_FORMS.items():
        with stream_env(names):
            # -- the main path: the flagship served under the form --
            reset_counts(counted)
            card_out = run("cuda")
            counts = [b1.launches, b1.h_bf16, b1.gates_bf16, b1.hs_bf16, counted[3].launches,
                      counted[4].launches]
            # ---------------------------------------------------------
            cpu_out = run("cpu")
        w = window(torch, card_out, f32["cuda"], cpu_out, f32["cpu"],
                   f"flagship served under {form}")
        mxu, gates, hs = ("mxu" in form), ("gates" in form), form.endswith("hs")
        want = [3, 3 * mxu, 3 * gates, 3 * hs, 1, 1]
        deltas = (form_delta(card_out, f32["cuda"]), form_delta(cpu_out, f32["cpu"]))
        print(f"[forms] the flagship (3 BLSTM x 256) served at B=1 10 s under "
              f"{'=1 '.join(names)}=1: launches (B1, bf16-h (the MXU form), gates, bf16 hs, B4, "
              f"B5) {counts} (want {want}); window against the CPU ({w[0]:.3f}, {w[1]:.3f}) "
              f"(limits {WINDOW_NEAR}; {WINDOW_LOW}, {WINDOW_HIGH}); the form's change of the "
              f"waveform against f32 (RMS over the RMS) card {deltas[0]:.3e}, CPU {deltas[1]:.3e}"
              f" | {card}", flush=True)
        if counts != want:
            raise AssertionError(f"flagship under {form}: launches {counts}, want {want}")
        out[form] = {"window": w, "launches": counts, "delta": deltas, "b1": card_out}
    # the enhance mode's batch under each form, on the card only
    enhance, wv, _ = enhancers["cuda"]
    rows = ENHANCE_MODE_ROWS
    big = wv.expand(rows, -1, -1).contiguous()
    n = torch.full((rows,), wv.shape[-1], dtype=torch.long, device="cuda")
    for form, names in SERVE_FORMS.items():
        with stream_env(names):
            reset_counts(counted)
            res = enhance(big, n)
            torch.cuda.synchronize()
            counts = [b1.launches, b1.h_bf16, b1.gates_bf16, b1.hs_bf16]
            got = res.detach().cpu().numpy()
            ms = statistics.median(synced_ms(torch, lambda: enhance(big, n), runs=3))
        ref = out[form]["b1"][0]
        rel = float(np.abs(got - ref[None]).max() / np.sqrt(np.mean(ref ** 2)))
        ok = got.shape == (rows, ref.shape[-1]) and np.isfinite(got).all() and rel <= SLICE_TOL
        print(f"[forms] the flagship's enhance mode batch ({rows} x 10 s) under "
              f"{'=1 '.join(names)}=1 on the card: launches (B1, bf16-h, gates, bf16 hs) "
              f"{counts}, every row within {rel:.2e} of the B=1 call's output (limit "
              f"{SLICE_TOL:.0e} of its RMS), {ms:.2f} ms a call (median of 3) | {card}",
              flush=True)
        if not ok or counts[0] != 3:
            raise AssertionError(f"enhance mode batch under {form}: {rel}, {counts}")
        out[form]["rows768"] = {"rel": rel, "launches": counts, "ms": ms}
        del res, got
    del big
    for v in out.values():
        del v["b1"]
    return out


def vcb_int8_form(torch, counted, card):
    """Phase 14 (e), the int8 form: vcb's one-direction head (Residual 3 x
    256) under SE_LSTM_XW_INT8=1: served at B=1 10 s, streamed through the
    ``StatefulStreamer`` that ``/stream`` runs (each chunk's xw quantized on
    its own) and one train step at B=6 x 10 s (the quantize and dequantize as
    torch ops into B2), card against CPU under the window, with the launches
    of the int8 form."""
    from speech_enhancement_by_s3prl_tpu_torch.entry import build, build_train, make_enhance
    from speech_enhancement_by_s3prl_tpu_torch.ops.streaming import StatefulStreamer

    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L
    names = ("SE_LSTM_XW_INT8",)
    b1 = L.lstm_bidir_tm
    wav3 = np.stack([request_audio(10.0, 210 + s) for s in range(3)])[None]
    wav = speech_like(int(STREAM_FORM_SECONDS * SR), 63)
    sizes = np.random.default_rng(SEED + 26).integers(700, 9000, size=200)
    gen = lambda: torch.Generator().manual_seed(SEED + 27)  # noqa: E731
    built = {d: build(bidirectional=False, device=d, generator=gen()) for d in ("cuda", "cpu")}
    counts = {}

    def served(device):
        pre, model = built[device]
        w = torch.from_numpy(wav3).to(device)
        n = torch.tensor([wav3.shape[-1]]).to(device)
        if device == "cuda" and os.environ.get("SE_LSTM_XW_INT8") == "1":
            # -- the main path: the one-direction head served, int8 form --
            reset_counts(counted)
            res = make_enhance(pre, model)(w, n)
            counts["served"] = [b1.launches, b1.xw_int8, b1.xw_bf16]
            # ------------------------------------------------------------
            return res
        return make_enhance(pre, model)(w, n)

    def streamed(device):
        pre, model = built[device]
        streamer = StatefulStreamer(model, pre, frames_per_chunk=STREAM_FRAMES)
        if device == "cuda" and os.environ.get("SE_LSTM_XW_INT8") == "1":
            # -- the main path: the one-direction head streamed, int8 form --
            reset_counts(counted)
            res = drive_stream(streamer, wav, sizes)
            counts["stream"] = [b1.launches, b1.carried, b1.xw_int8]
            # --------------------------------------------------------------
            return res
        return drive_stream(streamer, wav, sizes)

    w_served = form_window(torch, served, names, "vcb head served, int8 form")
    w_stream = form_window(torch, streamed, names, "vcb head streamed, int8 form")
    builders = {d: build_train(bidirectional=False, device=d, generator=gen())
                for d in ("cuda", "cpu")}
    loss_w, grad_w, step_counts, sides = step_sides(
        torch, builders, train_batch(10.0, 6, 220), names, "vcb head train step, int8 form",
        counted)
    # the form's gradient reaches xw through the scale alone, far from the
    # f32 gradient, so the window's ratio says little there: the card's
    # gradient is also held to the CPU's as phase 3 holds the f32 step's
    card_g, cpu_g = sides[("cuda", True)][1:], sides[("cpu", True)][1:]
    grad_rel = float((card_g - cpu_g).abs().max() / cpu_g.abs().max())
    chunks = counts["stream"][0] // 3
    want = {"served": [3, 3, 0], "stream": [3 * chunks] * 3,
            "step": [0, 0, 0, 3, 0, 0, 3, 0, 0, 1, 0, 0]}
    got = {"served": counts["served"], "stream": counts["stream"], "step": step_counts}
    print(f"[forms] vcb's one-direction head (Residual 3 x 256) under SE_LSTM_XW_INT8=1, card "
          f"against CPU: served B=1 10 s window ({w_served[0]:.3f}, {w_served[1]:.3f}), launches "
          f"(B1, int8, bf16 xw) {got['served']}; streamed {STREAM_FORM_SECONDS:.0f} s in {chunks}"
          f" chunks of {STREAM_FRAMES} frames window ({w_stream[0]:.3f}, {w_stream[1]:.3f}), "
          f"launches (B1, with state, int8) {got['stream']}; train step B=6 10 s window loss "
          f"({loss_w[0]:.3g}, {loss_w[1]:.3f}; ratio 0: card against CPU relative, the form "
          f"within f32 noise), gradient ({grad_w[0]:.3f}, {grad_w[1]:.3f}) and card against CPU "
          f"{grad_rel:.2e} of its largest (limit {TRAIN_GRAD_TOL:.0e}), launches (B1, xw, hs, "
          f"B2 fwd, xw, res, B2 bwd, xw, res, B4, B5, dW_hh^T bf16) {got['step']} (limits "
          f"{WINDOW_NEAR}; {WINDOW_LOW}, {WINDOW_HIGH}) | {card}", flush=True)
    if got != want or chunks < 1 or not grad_rel <= TRAIN_GRAD_TOL:
        raise AssertionError(f"vcb head int8 form: launches {got}, want {want}; gradient "
                             f"{grad_rel}")
    return {"served": w_served, "stream": w_stream, "loss": loss_w, "grad": grad_w,
            "grad_rel": grad_rel, "launches": got}


def b1_form_times(torch, L, card):
    """Phase 14 (f), the forms of other functions: B1 launched directly in
    each form beside its f32 form at the flagship shape, (2, B, 1001, 256) at
    B = 1 and 64 for the MXU and gates forms, (1, 6, 1001, 256) for the int8
    form, in turns (f32, forms, forms, f32), each with its bound from
    ``utils/costs.py``."""
    T, H, bf16 = 1001, 256, torch.bfloat16
    times = {}
    for ndir, B in ((2, 1), (2, 64), (1, 6)):
        xw, w_hh_t = kernel_inputs(torch, B, T, H, SEED + 290 + B, ndir=ndir)
        wb = L._bf16(w_hh_t)
        q, scale = L.quantize_xw_int8(xw)
        route = L.fwd_route(H)
        calls = {"f32": lambda: L._launch_fwd(route, xw, w_hh_t)}
        if ndir == 2:
            calls.update({
                "mxu": lambda: L._launch_fwd(route, xw, wb, h_bf16=True),
                "gates": lambda: L._launch_fwd(route, xw, w_hh_t, gates_bf16=True),
                "mxu+gates+hs": lambda: L._launch_fwd(route, xw, wb, h_bf16=True,
                                                      gates_bf16=True, out_dtype=bf16)})
        else:
            calls["int8"] = lambda: L._launch_fwd(route, q, w_hh_t, xw_scale=scale)
        ms = {}
        order = list(calls) + list(calls)[::-1]
        for form in order:
            ms[form] = min(ms.get(form, math.inf), cuda_ms(torch, calls[form], 10))
        # the plain version of the launch's form (one call; not at B = 64)
        plain = None
        if B != 64:
            plain = cuda_ms(torch, (lambda: L.lstm_bidir_tm_ref(q, w_hh_t, xw_scale=scale))
                            if ndir == 1 else (lambda: L.lstm_bidir_tm_ref(
                                xw, wb, h_bf16=True, hs_dtype=bf16, gates_bf16=True)), 1)
            times[(ndir, B, "plain")] = plain
        for form, t in ms.items():
            kind = "int8" if form == "int8" else ("mxu" if "mxu" in form else "f32")
            times[(ndir, B, form)] = (t, b1_form_bound(B, T, H, kind, ndir,
                                                       hs_bf16=form.endswith("hs")))
        print(f"[time] B1 forms ndir={ndir} B={B} T={T} H={H} route {route!r} (kernel ms, better"
              f" of two turns; bound ms): " + ", ".join(
                  f"{f} {t:.4f} ({times[(ndir, B, f)][1][0]:.4f} by {times[(ndir, B, f)][1][1]})"
                  for f, t in ms.items())
              + ("" if plain is None else f"; plain ({list(calls)[-1]}) {plain:.3f}")
              + f" | {card}", flush=True)
        del xw, w_hh_t, wb, q, scale
    return times


def stream_forms_phase(torch, L, dsp_kernels, card):
    """Phase 14: the bf16 stream forms of the LSTM kernels on the card, then
    B1's forms of other functions (MXU, gates, int8 xw)."""
    counted = (L.lstm_bidir_tm, L.lstm_bidir_tm_fc, L.lstm_bidir_tm_bwd, *dsp_kernels,
               L.lstm_bidir_tm_dw_bf16)
    t0 = time.perf_counter()
    out = {"checks": stream_form_checks(torch, L)}
    out["serve"] = flagship_stream_serving(torch, counted, card)
    out["step"] = flagship_stream_step(torch, counted, card)
    out["score"] = active_score_mode(torch, card)
    out["vcb"] = vcb_xw_form(torch, counted, card)
    out["times"] = stream_times(torch, L, card)
    out["forms"] = {"checks": b1_form_checks(torch, L),
                    "serve": flagship_form_serving(torch, counted, card),
                    "vcb": vcb_int8_form(torch, counted, card),
                    "times": b1_form_times(torch, L, card)}
    print(f"[streams] phase 14 in {time.perf_counter() - t0:.1f} s | {card}", flush=True)
    return out


# upstream pretraining, its export and the active-vs-uniform experiment
# (phase 15). Pretraining runs tools/pretrain_upstream.py at
# config/pretrain_sample.yaml's full width (6 x 768 x 12 heads, FFN 3072,
# dropout 0.1; 80-d log-mel + delta in, 201-bin log-linear target) on 10 s
# rows, batch 8, PRETRAIN_STEPS steps for each target channel
PRETRAIN_STEPS, PRETRAIN_BATCH = 3, 8
# the experiment at the JAX script's default widths (LSTM 2 x 64
# bidirectional, upstreams 2 x 64, 2 s rows, batch 4, 8 candidates, 8 query
# rows, 3 enrichment batches a domain); only the steps are cut: upstreams,
# source warm start, adaptation
EXPERIMENT_STEPS = (20, 20, 10)


def pretrain_step_sides(torch, corpus, run_dir, channel, card):
    """One pretraining step's loss and gradient on the card against the CPU
    (the same seed checkpoint, 8 rows of a 4 s bucket, the same salts), then
    the card's step at B=8 10 s: the median of 10 synchronized steps on the
    host clock and the device busy time under the profiler."""
    from speech_enhancement_by_s3prl_tpu_torch.data.datasets import OnlineDataset
    from speech_enhancement_by_s3prl_tpu_torch.models.transformer import SaltStream
    from speech_enhancement_by_s3prl_tpu_torch.run_downstream import (
        build_runner,
        get_downstream_args,
    )
    from speech_enhancement_by_s3prl_tpu_torch.runner.trainer import make_context

    config = os.path.join(run_dir, "run_config.yaml")
    runners = {}
    for device in ("cuda", "cpu"):
        args, cfg = get_downstream_args([
            "--name", f"sides-{device}", "--config", config,
            "--expdir", os.path.join(run_dir, "sides"), "--upstream", "baseline",
            "--upstream2", "baseline", "--from_rawfeature", "--downstream", "Mockingjay",
            "--dckpt", os.path.join(run_dir, "seed.ckpt"), "--objective", "L1", "--seed",
            str(SEED), "--dev_num", "0",
            "--device", device])
        runners[device] = build_runner(args, cfg)
        runners[device].set_model()

    def batch(seconds):
        ds = OnlineDataset(speech={"filestrs": os.path.join(corpus, "speech")},
                           noise={"filestrs": os.path.join(corpus, "noise")},
                           max_time=seconds * 1000, snrs=[0])
        return ds.collate_fn([ds[i] for i in range(PRETRAIN_BATCH)], pad_to=seconds * SR)

    lengths_np, wavs_np = batch(4)
    sides = {}
    for device, runner in runners.items():
        b = runner.builder
        b.model.train()
        wavs = torch.from_numpy(wavs_np).to(device)
        lengths = torch.from_numpy(lengths_np).to(device)
        params = list(b.model.parameters())
        loss, _ = b.loss_fn(make_context(b.preprocessor, wavs, lengths, b.channel_inp,
                                         b.channel_tar), SaltStream(SEED, 1000))
        g = torch.autograd.grad(loss, params)
        sides[device] = (float(loss.detach()), torch.cat([x.reshape(-1) for x in g])
                         .double().cpu())
    (gl, gg), (cl, cg) = sides["cuda"], sides["cpu"]
    loss_rel = abs(gl - cl) / abs(cl)
    grad_max = float((gg - cg).abs().max() / cg.abs().max())
    grad_rel = float((gg - cg).norm() / cg.norm())
    print(f"[pretrain] channel {channel}: GPU vs CPU one step (B={PRETRAIN_BATCH}, 4 s bucket, "
          f"dropout 0.1 live, same salts, the seed checkpoint): loss {gl:.6f} vs {cl:.6f} rel "
          f"{loss_rel:.3e} (limit {TRAIN_LOSS_TOL:.0e}); max |g_gpu - g_cpu| / max |g_cpu| "
          f"{grad_max:.3e}, |g_gpu - g_cpu| / |g_cpu| {grad_rel:.3e} (limit "
          f"{TRAIN_GRAD_TOL:.0e}) | {card}", flush=True)
    if not (loss_rel <= TRAIN_LOSS_TOL and grad_max <= TRAIN_GRAD_TOL
            and grad_rel <= TRAIN_GRAD_TOL):
        raise AssertionError(f"channel {channel}: the pretraining step on the card disagrees "
                             f"with the CPU: loss {loss_rel}, gradient {grad_max} / {grad_rel}")
    del runners["cpu"], sides

    runner = runners["cuda"]
    lengths_np, wavs_np = batch(10)
    wavs = torch.from_numpy(wavs_np).cuda()
    lengths = torch.from_numpy(lengths_np).cuda()
    holder = [runner.state]

    def step():
        holder[0], _ = runner.builder.train_step(holder[0], wavs, lengths)

    ms = synced_ms(torch, step, runs=10)
    busy, wall, n_kernels, _ = device_busy(torch, step)
    out = {"ms": statistics.median(ms), "busy": busy, "wall": wall,
           "idle": max(0.0, 1 - busy / wall), "loss_rel": loss_rel, "grad_max": grad_max}
    print(f"[time] pretraining step channel {channel} B={PRETRAIN_BATCH} 10 s (T=1001 frames, "
          f"6 x 768 x 12 heads, dropout 0.1): median {out['ms']:.3f} ms of 10 synchronized "
          f"steps (min {min(ms):.3f}, max {max(ms):.3f}); under torch.profiler ({PROFILED_CALLS} "
          f"steps) wall "
          f"{wall:.3f} ms, device busy {busy:.3f} ms, {n_kernels:.0f} kernels a step, idle "
          f"share {out['idle']:.3f} | {card}", flush=True)
    return out


def pretrain_phase(torch, counted, card, tmp):
    """Phase 15: upstream pretraining at full width through
    tools/pretrain_upstream.py, its export read back and served as --ckpt,
    and tools/experiment_active_adaptation.py with tools/extract_results.py
    at reduced steps, each on the card. ``counted`` is (B1, B2 fwd, B2 bwd,
    B3 fwd, B3 bwd, B4, B5).

    Cuts of the experiment's run, against the JAX script's defaults: the
    upstreams 20 steps (300), the source warm start 20 (300), each
    adaptation 10 (200); every width, batch, row length and the corpus are
    the script's own."""
    from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_to_state_dict
    from speech_enhancement_by_s3prl_tpu_torch.models.torch_import import (
        load_s3prl_checkpoint,
    )
    from speech_enhancement_by_s3prl_tpu_torch.models.transformer import TransformerEncoder
    from speech_enhancement_by_s3prl_tpu_torch.run_downstream import build_runner, get_parser
    from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import (
        find_resume_ckpt,
        load_checkpoint,
    )
    from speech_enhancement_by_s3prl_tpu_torch.tools import (
        experiment_active_adaptation as ex,
        extract_results,
        pretrain_upstream,
    )

    t_phase = time.perf_counter()
    b1, fc, bwd, b3f, b3b, b4, b5 = counted
    corpus = os.path.join(tmp, "corpus")
    write_corpus(corpus, SEED, speech=(12, 10.5, 12.0), noise=(4, 10.5, 12.0))
    expdir = os.path.join(tmp, "up")
    out = {"pretrain": {}, "sides": {}}
    for channel in (1, 2):
        name = f"channel{channel}"
        # -- the main path of pretraining, between the reset and the reading --
        reset_counts(counted)
        t0 = time.perf_counter()
        export = pretrain_upstream.main([
            "--name", name, "--expdir", expdir,
            "--config", os.path.join(ROOT, "config", "pretrain_sample.yaml"),
            "--speech", os.path.join(corpus, "speech"), "--noise", os.path.join(corpus, "noise"),
            "--target_channel", str(channel), "--total_step", str(PRETRAIN_STEPS),
            "--batch_size", str(PRETRAIN_BATCH), "--seed", str(SEED), "--device", "cuda"])
        run_s = time.perf_counter() - t0
        counts = [fn.launches for fn in counted]
        # ---------------------------------------------------------------------
        run_dir = os.path.join(expdir, name)
        with open(os.path.join(run_dir, "train", "scalars.jsonl")) as f:
            losses = [json.loads(ln)["value"] for ln in f if '"tag": "loss"' in ln]
        if (len(losses) != PRETRAIN_STEPS or not all(map(math.isfinite, losses))
                or counts[:3] != [0, 0, 0] or counts[6] != 0
                or counts[3:5] != [MJ_LAYERS * PRETRAIN_STEPS] * 2
                or counts[5] < PRETRAIN_STEPS):
            raise AssertionError(
                f"pretraining channel {channel}: losses {losses}, launches (B1, B2 fwd, B2 bwd, "
                f"B3 fwd, B3 bwd, B4, B5) {counts}; want B3 {MJ_LAYERS} + {MJ_LAYERS} and B4 >= 1 "
                f"a step, no LSTM or B5")
        print(f"[pretrain] tools/pretrain_upstream.py --config config/pretrain_sample.yaml "
              f"--target_channel {channel} on cuda: {PRETRAIN_STEPS} steps of batch "
              f"{PRETRAIN_BATCH} x 10 s in {run_s:.2f} s (seed checkpoint, loader, save and "
              f"export included); losses {', '.join(f'{x:.4f}' for x in losses)}; launches "
              f"(B1, B2 fwd, B2 bwd, B3 fwd, B3 bwd, B4, B5) {counts}: a step B3 fwd "
              f"{counts[3] / PRETRAIN_STEPS:g}, B3 bwd {counts[4] / PRETRAIN_STEPS:g}, B4 "
              f"{counts[5] / PRETRAIN_STEPS:g}; exported {os.path.relpath(export, tmp)} | {card}",
              flush=True)

        # the export read back bit for bit: the trained Mockingjay's encoder
        # and SpecHead
        trained = load_checkpoint(find_resume_ckpt(os.path.join(run_dir, "train")))
        tree = trained["Downstream"]["params"]
        lc = load_s3prl_checkpoint(export)
        same = {}
        for blob, sub in (("encoder", "mockingjay"), ("spechead", "spechead")):
            want = flax_to_state_dict(tree[sub])
            got = lc.params[blob]
            same[blob] = set(got) == set(want) and all(torch.equal(got[k], want[k])
                                                       for k in want)
        if not all(same.values()) or lc.pretrain_config["online"]["target"]["channel"] != channel:
            raise AssertionError(f"channel {channel}: the export read back {same}")
        out["pretrain"][channel] = {"counts": counts, "losses": losses, "run_s": run_s,
                                    "export": export}
        out["sides"][channel] = pretrain_step_sides(torch, corpus, run_dir, channel, card)

        # the export serving as --ckpt: a head over the upstream; its features
        # on a seeded 10 s batch against the trained encoder's, both without
        # dropout
        args = get_parser().parse_args([
            "--name", f"served{channel}", "--expdir", os.path.join(tmp, "served"),
            "--downstream", "Residual", "--objective", "SISDR", "--upstream", "transformer",
            "--ckpt", export, "--dev_num", "2", "--seed", str(SEED), "--device", "cuda"])
        runner = build_runner(args, train_config(corpus))
        runner.upstream.eval()
        encoder = TransformerEncoder(lc.config, input_dim=lc.input_dim).cuda().eval()
        encoder.load_state_dict(flax_to_state_dict(tree["mockingjay"]))
        clean = np.stack([request_audio(10.0, 40 + s) for s in range(2)])
        noise = 0.05 * np.random.default_rng(SEED).standard_normal(clean.shape)
        wavs = torch.from_numpy(np.stack([clean + noise, clean, noise], axis=1)
                                .astype(np.float32)).cuda()
        with torch.no_grad():
            feats = runner.preprocessor(wavs)[0]
            served, direct = runner.upstream(feats), encoder(feats)
        identical = torch.equal(served, direct)
        err = float((served - direct).abs().max() / direct.abs().max())
        print(f"[pretrain] channel {channel}: the export as --ckpt (upstream mode, Residual head) "
              f"on cuda: features {tuple(served.shape)} of a seeded 2 x 10 s batch against the "
              f"trained Mockingjay encoder's, both without dropout: "
              + ("identical bits" if identical else f"max |diff| / max {err:.3e}")
              + f"; the export read back bit for bit (encoder, SpecHead) | {card}", flush=True)
        if not identical:
            raise AssertionError(f"channel {channel}: served features differ from the trained "
                                 f"encoder's by {err} of the largest")
        out["pretrain"][channel]["features_identical"] = identical
        del runner, encoder

    # the experiment at reduced steps, stage by stage
    stages, depth = [], [0]

    def staged(fn, name_of):
        def wrapper(*a, **k):
            if depth[0]:
                return fn(*a, **k)
            before = [f.launches for f in counted]
            depth[0] += 1
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
                stages.append((name_of(*a), [f.launches - n for f, n in zip(counted, before)]))
        return wrapper

    def flag(argv, name="--name"):
        return argv[argv.index(name) + 1]

    patched = [(pretrain_upstream, "main", staged(pretrain_upstream.main, flag)),
               (ex.run_downstream, "main", staged(ex.run_downstream.main, flag)),
               (ex, "measure_enrichment", staged(ex.measure_enrichment,
                                                 lambda *a: "enrichment"))]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patched]
    wd = os.path.join(tmp, "experiment")
    up_steps, down_steps, adapt_steps = EXPERIMENT_STEPS
    try:
        for mod, attr, fn in patched:
            setattr(mod, attr, fn)
        # -- the main path of the experiment, between the reset and the reading --
        reset_counts(counted)
        t0 = time.perf_counter()
        results = ex.main(["--workdir", wd, "--device", "cuda", "--seed", str(SEED),
                           "--up_steps", str(up_steps), "--down_steps", str(down_steps),
                           "--adapt_steps", str(adapt_steps)])
        ex_s = time.perf_counter() - t0
        ex_counts = [fn.launches for fn in counted]
        # ---------------------------------------------------------------------
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    names = [n for n, _ in stages]
    if names != ["noisy2clean", "noisy2noise", "source", "active", "uniform", "enrichment"]:
        raise AssertionError(f"experiment stages {names}")
    # (B1, B2 fwd, B2 bwd, B3 fwd, B3 bwd, B4, B5) that each stage must launch
    wanted = {"noisy2clean": (5,), "noisy2noise": (5,), "source": (0, 1, 2, 5, 6),
              "active": (0, 1, 2, 5, 6), "uniform": (0, 1, 2, 5, 6), "enrichment": (1, 2, 5)}
    for name, counts in stages:
        if not all(counts[i] > 0 for i in wanted[name]):
            raise AssertionError(f"experiment stage {name}: launches {counts}")
    if not all(ex_counts[i] > 0 for i in (0, 1, 2, 5, 6)):
        raise AssertionError(f"experiment launches {ex_counts}")
    with open(os.path.join(wd, "results.json")) as f:
        saved_results = json.load(f)
    enrichment = saved_results["enrichment"]
    if (set(saved_results) != {"config", "active", "uniform", "enrichment"}
            or set(enrichment) != {"white", "pink", "tonal_train", "tonal_target"}
            or not all(math.isfinite(v) for r in enrichment.values() for v in r.values())
            or not all(math.isfinite(v[k]) for mode in ("active", "uniform")
                       for v in saved_results[mode].values() for k in ("init", "final"))):
        raise AssertionError(f"results.json: {saved_results}")
    print(f"[pretrain] tools/experiment_active_adaptation.py on cuda ({up_steps} / {down_steps} "
          f"/ {adapt_steps} steps, the script's widths) in {ex_s:.2f} s; launches (B1, B2 fwd, "
          f"B2 bwd, B3 fwd, B3 bwd, B4, B5) by stage "
          + ", ".join(f"{n} {c}" for n, c in stages)
          + f"; adaptation (init -> final) "
          + "; ".join(f"{mode} " + ", ".join(
              f"{t[5:]} {v['init']:.3f} -> {v['final']:.3f}"
              for t, v in sorted(results[mode].items()) if t != "test_loss")
              for mode in ("active", "uniform"))
          + "; enrichment match rate (histogram) "
          + ", ".join(f"{d} {r['match_rate']:.3f} ({r['hist_match_rate']:.3f})"
                      for d, r in enrichment.items()) + f" | {card}", flush=True)

    tags = ["test_stoi", "test_pesq_nb", "test_sisdr"]
    csv_path = extract_results.main([os.path.join(wd, "adapt"), "--pattern",
                                     r"^(active|uniform)$", "--tags", *tags, "--which", "last",
                                     "--out", os.path.join(tmp, "adapt.csv")])
    with open(csv_path) as f:
        rows = [ln.split(",") for ln in f.read().splitlines()]
    want_rows = [["noise_type", *tags]] + [
        [mode, *(repr(saved_results[mode][t]["final"]) for t in tags)]
        for mode in ("active", "uniform")]
    if rows != want_rows:
        raise AssertionError(f"the adaptation CSV {rows}, want {want_rows}")
    out["experiment"] = {"counts": ex_counts, "stages": stages, "seconds": ex_s,
                         "enrichment": enrichment}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[pretrain] tools/extract_results.py over the adaptation runs: {len(rows) - 1} rows "
          f"x {len(rows[0])} columns {rows[0]}, each the run's last value; phase 15 in "
          f"{out['seconds']:.1f} s | {card}", flush=True)
    return out


# the exported serving program (phase 16): the flagship checkpoint exported by
# tools/export_model.py on the card (buckets up to 4 s) and served from the
# artifact; its output against the live --ckpt enhancer on the same card. Both
# run the same operations on the same inputs (the program replays the eager
# path, B1 / B4 / B5 through the op library's CUDA kernels), so bit for bit is
# expected; the limit, of the output RMS, admits a last-bit difference of a
# library product whose algorithm the replay might pick otherwise.
ARTIFACT_TOL = 1e-6
ARTIFACT_MAX_SEC = 4
# rows of one 4 s device batch (the symbolic batch: three row counts, one
# program), each a request of 2.5-4 s
ARTIFACT_ROWS = (1, 3, 6)


def artifact_phase(torch, counted, card, tmp):
    """Phase 16: the exported serving program at full width. ``counted``:
    every kernel wrapper with a launch count, B1, B4 and B5 among them."""
    from speech_enhancement_by_s3prl_tpu_torch.data.audio_io import read_wav, write_wav
    from speech_enhancement_by_s3prl_tpu_torch.enhance import main as enhance_cli
    from speech_enhancement_by_s3prl_tpu_torch.entry import build, flagship_settings
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import decode_kernel, stft_kernel
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L
    from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import save_checkpoint
    from speech_enhancement_by_s3prl_tpu_torch.serve import (
        build_artifact_enhancer,
        build_enhancer,
        make_server,
    )
    from speech_enhancement_by_s3prl_tpu_torch.tools import export_model
    from speech_enhancement_by_s3prl_tpu_torch.tools.serve_load import pcm_of, wav_body
    from speech_enhancement_by_s3prl_tpu_torch.utils.export_artifact import read_manifest

    t_phase = time.perf_counter()
    _, model = build(device="cpu", generator=torch.Generator().manual_seed(SEED))
    config, paras = flagship_settings()
    ckpt = save_checkpoint(os.path.join(tmp, "ckpt"), 0, model, None, config, paras)
    art = os.path.join(tmp, "artifact")
    t0 = time.perf_counter()
    paths = export_model.main(["--ckpt", ckpt, "--out", art, "--max_sec",
                               str(ARTIFACT_MAX_SEC)])
    export_s = time.perf_counter() - t0
    manifest = read_manifest(art)
    T = ARTIFACT_MAX_SEC * SR
    if manifest["device"] != "cuda" or T not in manifest["buckets"] or SR not in paths:
        raise AssertionError(f"the artifact's manifest {manifest}")
    sizes = {t: os.path.getsize(p) for t, p in paths.items()}
    print(f"[artifact] tools/export_model.py on the card: buckets {sorted(paths)} in "
          f"{export_s:.1f} s, files {sizes} bytes; manifest {manifest}", flush=True)

    live = build_enhancer(ckpt, device="cuda", round_pow2=False)
    served = build_artifact_enhancer(art, SR, device="cuda", round_pow2=False)
    requests = [request_audio(2.5 + 0.25 * k, 200 + k) for k in range(max(ARTIFACT_ROWS))]
    served.run_batch(requests[:2])  # warm both
    live.run_batch(requests[:2])
    torch.cuda.synchronize()
    worst, identical, counts = 0.0, True, {}
    for rows in ARTIFACT_ROWS:
        # -- the main path: one device batch of the artifact --
        reset_counts(counted)
        outs = served.run_batch(requests[:rows])
        torch.cuda.synchronize()
        counts[rows] = [fn.launches for fn in counted]
        # ------------------------------------------------------
        b1 = L.lstm_bidir_tm.launches
        b4, b5 = stft_kernel.stft_fused.launches, decode_kernel.decode_ola.launches
        if (b1, b4, b5) != (3, 1, 1) or sum(counts[rows]) != 5:
            raise AssertionError(f"the artifact's device batch of {rows} rows launched "
                                 f"{dict(zip((fn.__name__ for fn in counted), counts[rows]))}")
        for wav, out, ref in zip(requests, outs, live.run_batch(requests[:rows])):
            if out.shape != wav.shape or not np.isfinite(out).all():
                raise AssertionError(f"artifact output shape {out.shape}")
            worst = max(worst, float(np.abs(out - ref).max() / np.sqrt(np.mean(ref ** 2))))
            identical = identical and np.array_equal(out, ref)
    print(f"[artifact] served from the artifact on the card, one 4 s device batch each of "
          f"{list(ARTIFACT_ROWS)} rows (one program, symbolic batch): launches a batch B1 3, "
          f"B4 1, B5 1, no other kernel; against the live --ckpt enhancer max |diff| / output "
          f"RMS {worst:.3e} (limit {ARTIFACT_TOL:.0e}), bit for bit {identical}", flush=True)
    if not worst <= ARTIFACT_TOL:
        raise AssertionError(f"the artifact disagrees with the live enhancer: {worst}")

    # exported on the CPU, served on the card (moved by move_to_device_pass
    # where this torch has it; refused otherwise)
    art_cpu = os.path.join(tmp, "artifact_cpu")
    export_model.main(["--ckpt", ckpt, "--out", art_cpu, "--max_sec", "1", "--device", "cpu"])
    try:
        from torch.export.passes import move_to_device_pass  # noqa: F401
        can_move = True
    except ImportError:
        can_move = False
    if can_move:
        moved = build_artifact_enhancer(art_cpu, SR, device="cuda", round_pow2=False)
        one = [request_audio(0.9, 230)]
        reset_counts(counted)
        got = moved.run_batch(one)[0]
        moved_counts = [fn.launches for fn in counted]
        moved_b1 = L.lstm_bidir_tm.launches
        ref = live.run_batch(one)[0]
        moved_err = float(np.abs(got - ref).max() / np.sqrt(np.mean(ref ** 2)))
        print(f"[artifact] exported on the CPU, moved to the card by move_to_device_pass: "
              f"launches {sum(moved_counts)} (B1 {moved_b1}); against the live enhancer "
              f"{moved_err:.3e} (limit {ARTIFACT_TOL:.0e})", flush=True)
        if moved_b1 != 3 or sum(moved_counts) != 5 or not moved_err <= ARTIFACT_TOL:
            raise AssertionError(f"the moved artifact: launches {moved_counts}, {moved_err}")
    else:
        try:
            build_artifact_enhancer(art_cpu, SR, device="cuda")
        except RuntimeError as e:
            print(f"[artifact] exported on the CPU: this torch cannot move it ({e})", flush=True)
        else:
            raise AssertionError("a CPU artifact loaded on the card without a move")
        moved_err = None

    # the server and the CLI with --artifact
    server = make_server(["--artifact", art, "--port", "0", "--workers", "2"])
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        port = server.server_address[1]
        wav = request_audio(3.3, 240)
        status, body = http_request(port, "POST", "/enhance", wav_body(wav))
        want = pcm_of(wav_body(live(wav)))
        pcm_steps = float(np.abs(pcm_of(body) - want).max()) if status == 200 else None
        s_status, s_body = http_request(port, "POST", "/stream", b"\x00" * 64)
        h_status, h_body = http_request(port, "GET", "/healthz")
    finally:
        server.shutdown()
        server.server_close()
    print(f"[artifact] serve --artifact: /enhance {status} (3.3 s, PCM against the live "
          f"enhancer within {pcm_steps} steps), /stream {s_status} ({s_body.decode()!r}), "
          f"/healthz {h_status} {json.loads(h_body)}", flush=True)
    if (status, s_status, h_status) != (200, 400, 200) or pcm_steps > 1 or \
            b"artifact serving bakes full-utterance programs" not in s_body:
        raise AssertionError(f"serve --artifact: {status}, {pcm_steps}, {s_status} {s_body}, "
                             f"{h_status}")
    cli_in, outs = os.path.join(tmp, "cli_in"), {}
    os.makedirs(cli_in)
    for i, sec in enumerate((1.5, 3.0, 3.9)):
        write_wav(os.path.join(cli_in, f"clip{i}.wav"), request_audio(sec, 250 + i), SR)
    for flag, src in (("--artifact", art), ("--ckpt", ckpt)):
        out_dir = os.path.join(tmp, "cli_" + flag[2:])
        enhance_cli([flag, src, "--inputs", cli_in, "--outdir", out_dir])
        outs[flag] = [read_wav(os.path.join(out_dir, f"clip{i}.wav"))[0][0] for i in range(3)]
    cli_steps = max(float(np.abs(a - b).max()) * 32768 for a, b in zip(*outs.values()))
    print(f"[artifact] enhance --artifact wrote the files enhance --ckpt writes: 3 files, "
          f"largest difference {cli_steps:.1f} PCM steps", flush=True)
    if cli_steps > 1.0:
        raise AssertionError(f"enhance --artifact differs from --ckpt by {cli_steps} steps")

    # times: the B=1, 4 s call live and from the artifact, in turns; the B=1
    # 10 s call of the live enhancer in a 10 s bucket (eager, B1 / B4 / B5
    # through the ops; phase 7 times the same model call without the host's
    # padding and copies)
    one4 = [request_audio(4.0, 260)]
    ms = {"live": [], "artifact": []}
    for _ in range(2):
        for name, fn in (("live", live), ("artifact", served), ("artifact", served),
                         ("live", live)):
            ms[name] += synced_ms(torch, lambda: fn.run_batch(one4), runs=10)
    med = {k: statistics.median(v) for k, v in ms.items()}
    ten = [request_audio(10.0, 261)]
    live10 = build_enhancer(ckpt, device="cuda", max_bucket_ms=10000)
    for _ in range(3):  # its 10 s bucket's first calls (caches, allocator)
        live10.run_batch(ten)
    series = [synced_ms(torch, lambda: live10.run_batch(ten), 20) for _ in range(2)]
    med["live_10s"] = statistics.median(series[0] + series[1])
    med["live_10s_series"] = [(min(v), statistics.median(v), max(v)) for v in series]
    print(f"[time] B=1 4 s enhance (host clock, synchronized, median of 40): live --ckpt "
          f"{med['live']:.3f} ms, artifact {med['artifact']:.3f} ms; live B=1 10 s after 3 "
          f"warm calls {med['live_10s']:.3f} ms (median of 2 x 20; each series min / median "
          f"/ max " + ", ".join("%.3f / %.3f / %.3f" % m for m in med["live_10s_series"])
          + f") | {card}", flush=True)
    dispatch = dispatch_times(torch, card)
    return {"counts": counts, "worst": worst, "identical": identical, "moved_err": moved_err,
            "can_move": can_move, "ms": med, "dispatch": dispatch, "export_s": export_s,
            "seconds": time.perf_counter() - t_phase}


def dispatch_times(torch, card):
    """Phase 16: what the op library costs a call on the serving path. Each
    of B1, B4 and B5 at 1 and 12 rows of 10 s (T=1001, H=256 for B1) three
    ways on the same card tensors: the wrapper (``lstm_bidir_tm``,
    ``stft_fused``, ``decode_ola``: its checks, then the op), the op's
    overload alone (``ops/cuda/library.py``) and its CUDA implementation
    called directly (``_b1_cuda``, ``_stft_cuda``, ``_decode_cuda``: the
    launch, no dispatcher). 50 back-to-back calls on CUDA events, as phase 7
    times B4 / B5 (20 there): where a call's host work outlasts its kernel,
    that host work is what they measure. Five turns of the three; the least
    and the median of each (a shared host's noise is of the size of the
    difference at one row)."""
    from speech_enhancement_by_s3prl_tpu_torch.ops import stft as S
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import decode_kernel, library, stft_kernel
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L

    geom, out = (400, 400, 160), {}
    for rows in (1, 12):
        wav = stft_inputs(torch, (rows, 10 * SR), SEED + 40)
        pred, uph = decode_inputs(torch, S, rows, 1001, SEED + 41)
        xw, w_hh_t = kernel_inputs(torch, rows, 1001, 256, SEED + 42)
        ways = {
            "B1": (lambda: L.lstm_bidir_tm(xw, w_hh_t),
                   lambda: library.lstm_recurrence(xw, w_hh_t, False, False),
                   lambda: L._b1_cuda(xw, w_hh_t)),
            "B4": (lambda: stft_kernel.stft_fused(wav, *geom),
                   lambda: library.stft(wav, *geom),
                   lambda: stft_kernel._stft_cuda(wav, *geom)),
            "B5": (lambda: decode_kernel.decode_ola(pred, uph, *geom),
                   lambda: library.decode(pred, uph, *geom, 2.0),
                   lambda: decode_kernel._decode_cuda(pred, uph, *geom, 2.0)),
        }
        for name, fns in ways.items():
            ms = [[], [], []]
            for _ in range(5):
                for k, fn in enumerate(fns):
                    ms[k].append(cuda_ms(torch, fn, iters=50, warmup=2))
            out[(name, rows)] = [min(v) for v in ms]
            print(f"[time] dispatcher: {name} {rows} rows of 10 s, 50 back-to-back calls, "
                  f"least / median of 5 turns: the wrapper {min(ms[0]):.4f} / "
                  f"{statistics.median(ms[0]):.4f} ms, the op {min(ms[1]):.4f} / "
                  f"{statistics.median(ms[1]):.4f}, its CUDA implementation called directly "
                  f"{min(ms[2]):.4f} / {statistics.median(ms[2]):.4f} | {card}", flush=True)
        del wav, pred, uph, xw, w_hh_t
    return out



# data parallelism on the card (phase 17): the Runner's --mesh 1x1 over NCCL
# against the run without a mesh (bit for bit), then two gloo ranks on this one
# card (NCCL refuses two ranks on one device) against one process on the global
# batch, and --mesh 2 serving with both replicas on this card
DP_STEPS, DP_ROWS, DP_EVAL_ROWS, DP_WORLD = 3, 6, 12, 2
# a rank's own limit: a hung rendezvous fails the phase, not the run
DP_RANK_TIMEOUT = 400
# the global batches' row lengths in seconds (10 s rows, ragged)
DP_SECONDS = (10.0, 8.3, 9.1, 6.4, 7.7, 5.2)
DP_EVAL_SECONDS = (10.0, 9.4, 8.8, 8.1, 7.3, 6.6, 5.9, 5.1, 4.4, 9.7, 7.0, 6.1)
MESH_SERVE_SECONDS = (4.0, 5.1, 6.3, 7.0, 7.9, 8.6, 9.2, 10.0)
# B3 on a rank's rows against the single launch's: bit for bit (a row's
# tiles, sums and mask never read another row); the probe shape
DP_PROBE = (DP_ROWS, 301, 12, 64)


def dp_batch(seconds, seed):
    """(wavs (B, 3, 10 s) f32 zero past each length, lengths (B,) int64)."""
    wavs = train_batch(10.0, len(seconds), seed)
    lengths = np.array([int(s * SR) for s in seconds], np.int64)
    for i, n in enumerate(lengths):
        wavs[i, :, n:] = 0.0
    return wavs, lengths


def dp_builder(torch, kind):
    """The builders of phase 17 (b)-(c) on the card, weights from ``SEED``:
    the flagship (``Residual``, SISDR), the ``LSTM`` head at the flagship's
    width under L1 (it predicts the log spectrum, which L1 reads), and the
    Mockingjay joint finetune at full width (dropout 0.1)."""
    import dataclasses

    from speech_enhancement_by_s3prl_tpu_torch.entry import build_mockingjay_train, build_train
    from speech_enhancement_by_s3prl_tpu_torch.models.heads import build_head
    from speech_enhancement_by_s3prl_tpu_torch.objectives import build_objective

    gen = torch.Generator().manual_seed(SEED + 17)
    if kind == "mockingjay":
        return build_mockingjay_train(device="cuda", generator=gen, seed=SEED)
    builder = build_train(device="cuda", generator=gen)
    if kind == "lstm":
        builder = dataclasses.replace(builder, objective=build_objective("L1"))
        builder.model = build_head(
            "LSTM", input_size=builder.preprocessor.feat_dims()[1], output_size=201,
            hidden_size=256, num_layers=3, bidirectional=True, generator=gen).to("cuda")
    return builder


@contextlib.contextmanager
def dp_recording():
    """The hidden-dropout masks (forward and backward, as bool tensors on
    the host) and B3's (salt, batch0, rows) calls of the transformer, in
    order."""
    import torch

    from speech_enhancement_by_s3prl_tpu_torch.models import transformer as t_tf

    masks, calls = [], []
    hidden, flash = t_tf._hash_mask_apply, t_tf.flash_attention

    def hidden_rec(x, salt, rate, batch0=0):
        masks.append((hidden(torch.ones_like(x), salt, rate, batch0) != 0).cpu())
        return hidden(x, salt, rate, batch0)

    def flash_rec(q, k, v, scale, rate=0.0, salt=(0, 0), kbias=None, batch0=0, *, n_heads):
        calls.append((tuple(int(s) for s in salt), int(batch0), q.shape[0]))
        return flash(q, k, v, scale, rate, salt, kbias, batch0, n_heads=n_heads)

    t_tf._hash_mask_apply, t_tf.flash_attention = hidden_rec, flash_rec
    try:
        yield masks, calls
    finally:
        t_tf._hash_mask_apply, t_tf.flash_attention = hidden, flash


def dp_side(torch, mesh):
    """Phase 17 (b)-(c) on one side: one process on the global batches
    (``mesh`` None) or one of the ranks of ``mesh`` on its rows. Returns
    what the parent compares, on the host."""
    import torch.distributed as dist

    from speech_enhancement_by_s3prl_tpu_torch.models.transformer import SaltStream
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import attention_kernel as A
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import decode_kernel, stft_kernel
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L
    from speech_enhancement_by_s3prl_tpu_torch.parallel.mesh import (
        StepReduce,
        make_parallel_eval_step,
        make_parallel_train_step,
        rank_span,
    )
    from speech_enhancement_by_s3prl_tpu_torch.runner.trainer import make_context

    counted = (L.lstm_bidir_tm, L.lstm_bidir_tm_fc, L.lstm_bidir_tm_bwd, A.flash_attention_fwd,
               A.flash_attention_bwd, A.flash_attention_fwd_bf16, A.flash_attention_bwd_bf16,
               stft_kernel.stft_fused, decode_kernel.decode_ola)
    start, rows = (0, DP_ROWS) if mesh is None else rank_span(DP_ROWS, mesh)
    mine = slice(start, start + rows)
    res = {"counts": {}}

    # B3 at this side's batch0 on its rows of one input, f32 and bf16
    g = torch.Generator().manual_seed(SEED + 170)
    B, T, N, D = DP_PROBE
    probe = [torch.randn(B, T, N * D, generator=g).cuda() for _ in range(4)]
    res["probe"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, dout = (x.to(dtype)[mine] for x in probe)
        args = (D ** -0.5, 0.1, (0x9E3779B9, 0x7F4A7C15), None, start)
        out, lse = A.flash_attention_fwd(q, k, v, *args, n_heads=N)
        grads = A.flash_attention_bwd(q, k, v, out, lse, dout, *args, n_heads=N)
        res["probe"][str(dtype)] = [x.cpu() for x in (out, lse) + grads]

    batches = [dp_batch(DP_SECONDS, SEED + 1700 + i) for i in range(DP_STEPS)]
    for name, kind in (("SISDR", "residual"), ("L1", "lstm")):
        builder = dp_builder(torch, kind)
        state = builder.init_state()
        first = {k: v.detach().cpu().clone() for k, v in state.params.items()}
        step = builder.train_step
        if mesh is not None:
            step, state = make_parallel_train_step(builder, mesh, state)
        stats, ms = [], []
        reset_counts(counted)
        for wavs, lengths in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, st = step(state, torch.from_numpy(wavs).cuda(),
                             torch.from_numpy(lengths).cuda())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            stats.append((float(st["loss"]), float(st["grad_norm"])))
        res["counts"][name] = [fn.launches for fn in counted]
        res[name] = {"stats": stats, "ms": ms, "first": first,
                     "params": {k: v.detach().cpu().clone() for k, v in state.params.items()}}
        del builder, state, step

    # the Mockingjay joint finetune: one global gradient
    builder = dp_builder(torch, "mockingjay")
    builder.model.train()
    wavs, lengths = (torch.from_numpy(x).cuda()[mine] for x in batches[0])
    params = list(builder.model.parameters())
    reset_counts(counted)
    ctx = make_context(builder.preprocessor, wavs, lengths, 0, 1)
    with dp_recording() as (masks, calls):
        loss, _ = builder.loss_fn(ctx, SaltStream(SEED, 0, batch0=start, global_batch=DP_ROWS))
        grads = torch.autograd.grad(loss, params)
    if mesh is not None:
        loss, grads = StepReduce(mesh).combine(loss, builder.objective.weight(**ctx), grads)
    flat = torch.cat([x.reshape(-1) for x in grads])
    res["counts"]["mockingjay"] = [fn.launches for fn in counted]
    res["mockingjay"] = {"loss": float(loss.detach()), "masks": masks, "calls": calls}
    if mesh is None or mesh.is_main:
        res["mockingjay"]["grad"] = flat.cpu()
    if mesh is not None:  # the ranks' global gradients, bit for bit
        theirs = flat.clone()
        dist.broadcast(theirs, 0)
        res["mockingjay"]["same_as_rank0"] = bool(torch.equal(theirs, flat))
    del builder, params, grads, flat, ctx

    # the eval batch of 12 rows of 10 s through the flagship
    builder = dp_builder(torch, "residual")
    eval_wavs, eval_lengths = (torch.from_numpy(x).cuda()
                               for x in dp_batch(DP_EVAL_SECONDS, SEED + 1799))
    reset_counts(counted)
    if mesh is None:
        out = builder.eval_step(eval_wavs, eval_lengths)
    else:
        out = make_parallel_eval_step(builder, mesh)(eval_wavs, eval_lengths)
    res["counts"]["eval"] = [fn.launches for fn in counted]
    res["eval"] = {"loss": float(out["loss"]),
                   "scores": {k: v.cpu() for k, v in out["scores"].items()}}
    return res


def dp_rank(rank, out, init):
    """Phase 17 (b)-(c): one of two gloo ranks on card 0 (a process of its
    own, started with ``spawn``); writes ``dp_side``'s results to ``out``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from speech_enhancement_by_s3prl_tpu_torch import use_full_fp32
    from speech_enhancement_by_s3prl_tpu_torch.parallel.distributed import (
        initialize_distributed,
        topology_summary,
    )
    from speech_enhancement_by_s3prl_tpu_torch.parallel.mesh import make_mesh

    use_full_fp32()
    initialize_distributed(init, DP_WORLD, rank, device="cuda:0", backend="gloo")
    try:
        res = dp_side(torch, make_mesh(DP_WORLD))
        res["topology"] = topology_summary()
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


def rel(a, b) -> float:
    return abs(a - b) / abs(b)


def mesh_one_run(torch, corpus, tmp, counted, card):
    """Phase 17 (a): the flagship through the CLI, ``run_downstream.main``,
    without a mesh and with ``--mesh 1x1`` (a group of one that the CLI sets
    up in this process: its rendezvous file, its pick of the card, NCCL, its
    teardown), 3 B=6 steps each; bit for bit. Returns the launches, the step
    times and the all-reduce time of the gradient bucket."""
    import torch.distributed as dist

    from speech_enhancement_by_s3prl_tpu_torch import run_downstream as rd
    from speech_enhancement_by_s3prl_tpu_torch.parallel.distributed import topology_summary

    config = train_config(corpus)
    config["runner"].update(total_step=DP_STEPS, log_step=1, eval_step=100, save_step=100,
                            max_keep=1)
    config_path = os.path.join(tmp, "mesh_config.yaml")
    with open(config_path, "w") as f:
        json.dump(config, f)  # JSON is YAML
    real_build, real_run = rd.build_runner, rd._run
    sides = {}
    for tag, extra in (("plain", []), ("mesh", ["--mesh", "1x1"])):
        steps, ms, seen = [], [], {}

        def build(args, config):
            # the CLI's runner, the train step that set_model picks timed
            runner = real_build(args, config)
            set_model = runner.set_model

            def timed_set_model():
                set_model()
                del runner.set_model  # no cycle keeps the runner alive after its run
                inner = runner.train_step

                def timed(state, wavs, lengths):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, stats = inner(state, wavs, lengths)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    steps.append((float(stats["loss"]), float(stats["grad_norm"]),
                                  tuple(lengths.tolist())))
                    return state, stats

                runner.train_step = timed

            runner.set_model = timed_set_model
            seen["runner"] = runner
            return runner

        def run(args, config):
            real_run(args, config)
            if dist.is_initialized():  # the CLI's group, before its teardown
                seen["group"] = (topology_summary(), dist.get_backend())
                flat = torch.cat([v.reshape(-1) for v in
                                  seen["runner"].state.params.values()]).clone()
                seen["allreduce_ms"] = cuda_ms(torch, lambda: dist.all_reduce(flat), 20,
                                               warmup=3)

        rd.build_runner, rd._run = build, run
        try:
            # -- the main path of --mesh 1x1, between the reset and the reading --
            reset_counts(counted)
            rd.main([
                "--config", config_path, "--name", tag, "--expdir",
                os.path.join(tmp, "mesh_exp"), "--downstream", "Residual", "--objective",
                "SISDR", "--optim", "BertAdam", "--from_rawfeature", "--dev_num", "3",
                "--n_jobs", "4", "--seed", str(SEED), "--device", "cuda", *extra])
            counts = [fn.launches for fn in counted]
            # ---------------------------------------------------------------
        finally:
            rd.build_runner, rd._run = real_build, real_run
        if extra:
            group = seen.get("group")
            print(f"[mesh] (a) the CLI's group: {group} | {card}", flush=True)
            if group is None or group[1] != "nccl" or dist.is_initialized():
                raise AssertionError(f"--mesh 1x1 did not run in an NCCL group of its own "
                                     f"that the CLI tore down: {group}")
        elif "group" in seen:
            raise AssertionError("the run without --mesh joined a process group")
        if len(steps) != DP_STEPS:
            raise AssertionError(f"{tag}: the CLI took {len(steps)} timed steps, not {DP_STEPS}")
        params = {k: v.detach().cpu().clone() for k, v in seen["runner"].state.params.items()}
        sides[tag] = {"steps": steps, "ms": ms, "params": params, "counts": counts,
                      "allreduce_ms": seen.get("allreduce_ms")}
        del seen
        gc.collect()
    plain, mesh = sides["plain"], sides["mesh"]
    same = (plain["steps"] == mesh["steps"] and set(plain["params"]) == set(mesh["params"])
            and all(torch.equal(plain["params"][k], mesh["params"][k]) for k in plain["params"]))
    print(f"[mesh] (a) flagship through run_downstream.main, {DP_STEPS} B={DP_ROWS} steps "
          f"of ragged 10 s rows (lengths {plain['steps'][0][2]}): --mesh 1x1 over NCCL vs no mesh, losses "
          f"{[x[0] for x in mesh['steps']]} vs {[x[0] for x in plain['steps']]}, bit for bit "
          f"(losses, gradient norms, every parameter) {same}; launches (B1, B2 fwd, B2 bwd, "
          f"B4, B5) {mesh['counts']} vs {plain['counts']} | {card}", flush=True)
    want = [0, 3 * DP_STEPS, 3 * DP_STEPS, DP_STEPS, 0]
    if not same or mesh["counts"] != plain["counts"] or mesh["counts"] != want:
        raise AssertionError(f"--mesh 1x1 differs from the run without a mesh: same {same}, "
                             f"launches {mesh['counts']} / {plain['counts']} (want {want})")
    step_ms = {tag: statistics.median(side["ms"][1:]) for tag, side in sides.items()}
    print(f"[time] (e) flagship train step B={DP_ROWS} 10 s through the CLI, median of steps "
          f"2-{DP_STEPS}: --mesh 1x1 {step_ms['mesh']:.3f} ms, no mesh {step_ms['plain']:.3f} ms; "
          f"NCCL all-reduce of the {sum(v.numel() for v in plain['params'].values())}-float "
          f"gradient bucket {mesh['allreduce_ms']:.4f} ms "
          f"({mesh['allreduce_ms'] / step_ms['mesh']:.2%} of the step); every step "
          f"{[round(x, 3) for x in mesh['ms']]} / {[round(x, 3) for x in plain['ms']]} ms | "
          f"{card}", flush=True)
    return {"counts": mesh["counts"], "step_ms": step_ms, "allreduce_ms": mesh["allreduce_ms"]}


def mesh_serving(torch, counted, card, tmp):
    """Phase 17 (d): ``build_enhancer(mesh_n=2)`` with both replicas on this
    card against the single-device enhancer, 8 rows of 4-10 s in one group."""
    from speech_enhancement_by_s3prl_tpu_torch.entry import build, flagship_settings
    from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import save_checkpoint
    from speech_enhancement_by_s3prl_tpu_torch.serve import build_enhancer

    _, model = build(device="cpu", generator=torch.Generator().manual_seed(SEED + 171))
    config, paras = flagship_settings()
    ckpt = save_checkpoint(os.path.join(tmp, "mesh_ckpt"), 0, model, None, config, paras)
    wavs = [request_audio(s, 170 + i) for i, s in enumerate(MESH_SERVE_SECONDS)]
    one = build_enhancer(ckpt, device="cuda")
    two = build_enhancer(ckpt, device="cuda", mesh_n=2, devices=["cuda:0", "cuda:0"])
    ref = one.run_batch(wavs)
    # -- the main path of --mesh 2 serving, between the reset and the reading --
    reset_counts(counted)
    got = two.run_batch(wavs)
    counts = [fn.launches for fn in counted]
    # -----------------------------------------------------------------------
    worst = max(float(np.abs(a - b).max()) for a, b in zip(got, ref))
    shapes = all(a.shape == w.shape and np.isfinite(a).all() for a, w in zip(got, wavs))
    ms = statistics.median(synced_ms(torch, lambda: two.run_batch(wavs), 5))
    ms_one = statistics.median(synced_ms(torch, lambda: one.run_batch(wavs), 5))
    print(f"[mesh] (d) build_enhancer(mesh_n=2), both replicas on cuda:0, {len(wavs)} rows of "
          f"{MESH_SERVE_SECONDS[0]:.0f}-{MESH_SERVE_SECONDS[-1]:.0f} s in one group: max |diff| "
          f"vs one device {worst:.3e} (limit one 16-bit step {1 / 32767:.3e}); launches (B1, B4, "
          f"B5) {counts} (want 3 B1, 1 B4, 1 B5 a replica); the group "
          f"{ms:.3f} ms on two replicas, {ms_one:.3f} on one | {card}", flush=True)
    if not (shapes and worst <= 1.0 / 32767 and counts == [6, 2, 2]):
        raise AssertionError(f"mesh serving: max diff {worst}, shapes {shapes}, launches "
                             f"{counts}")
    return {"counts": counts, "ms": ms, "ms_one": ms_one, "err": worst}


def data_parallel_phase(torch, card, tmp):
    """Phase 17: data parallelism on the card, (a)-(e) of the module
    docstring. Returns the launches and the times for the summary."""
    import torch.multiprocessing as mp

    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import decode_kernel, stft_kernel
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L

    t_phase = time.perf_counter()
    corpus = os.path.join(tmp, "corpus")
    write_corpus(corpus, SEED)
    one = mesh_one_run(torch, corpus, tmp, (L.lstm_bidir_tm, L.lstm_bidir_tm_fc,
                                           L.lstm_bidir_tm_bwd, stft_kernel.stft_fused,
                                           decode_kernel.decode_ola), card)

    # (b)-(c): two gloo ranks on this card, then one process on the global batch
    init = "file://" + os.path.join(tmp, "rendezvous2")
    outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(DP_WORLD)]
    release_card(torch, "the two gloo ranks")
    spawn = mp.get_context("spawn")
    procs = [spawn.Process(target=dp_rank, args=(r, outs[r], init)) for r in range(DP_WORLD)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + DP_RANK_TIMEOUT
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    if any(p.is_alive() for p in procs):
        for p in procs:
            p.kill()
            p.join()
        raise AssertionError(f"a gloo rank did not finish within {DP_RANK_TIMEOUT} s")
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"a gloo rank failed: exit codes {[p.exitcode for p in procs]}")
    ranks = [torch.load(o, weights_only=False) for o in outs]
    single = dp_side(torch, None)
    print(f"[mesh] (b) ranks: {ranks[0]['topology']}; {ranks[1]['topology']}", flush=True)

    # B3 on each rank's rows at its batch0: bit for bit the single launch's rows
    rows = DP_ROWS // DP_WORLD
    probe_same = all(
        torch.equal(got, want[r * rows:(r + 1) * rows])
        for r, res in enumerate(ranks) for dt in single["probe"]
        for got, want in zip(res["probe"][dt], single["probe"][dt]))
    print(f"[mesh] (b) B3 fwd / bwd, f32 and bf16, on each rank's {rows} rows at batch0 0 and "
          f"{rows} (B={DP_PROBE[0]} T={DP_PROBE[1]} {DP_PROBE[2]} x {DP_PROBE[3]}, rate 0.1): "
          f"out, lse, dq, dk, dv bit for bit the single launch's rows {probe_same}", flush=True)
    if not probe_same:
        raise AssertionError("B3 at a rank's batch0 differs from the single launch's rows")

    # the flagship head under SISDR and the LSTM head under L1, 3 steps
    worst = {}
    for name in ("SISDR", "L1"):
        want, a, b = single[name], ranks[0][name], ranks[1][name]
        loss_rel = max(rel(x[0], y[0]) for x, y in zip(a["stats"], want["stats"]))
        norm_rel = max(rel(x[1], y[1]) for x, y in zip(a["stats"], want["stats"]))
        upd = {k: (a["params"][k] - a["first"][k]).double() for k in a["params"]}
        ref = {k: (want["params"][k] - want["first"][k]).double() for k in want["params"]}
        num = math.sqrt(sum(float((upd[k] - ref[k]).pow(2).sum()) for k in ref))
        den = math.sqrt(sum(float(ref[k].pow(2).sum()) for k in ref))
        upd_rel = num / den
        same = a["stats"] == b["stats"] and all(torch.equal(a["params"][k], b["params"][k])
                                                  for k in a["params"])
        worst[name] = (loss_rel, norm_rel, upd_rel)
        print(f"[mesh] (b) {name} ({'flagship Residual' if name == 'SISDR' else 'LSTM head'} "
              f"3 x 256, {DP_STEPS} steps of {DP_ROWS} ragged 10 s rows) two gloo ranks vs one "
              f"process: loss rel {loss_rel:.3e}, grad norm rel {norm_rel:.3e} (limit "
              f"{TRAIN_LOSS_TOL:.0e}), |update - update_single| / |update_single| "
              f"{upd_rel:.3e} (limit {TRAIN_GRAD_TOL:.0e}), max |param diff| "
              f"{max(float((a['params'][k] - want['params'][k]).abs().max()) for k in a['params']):.3e}; "
              f"ranks bit for bit {same}; launches a rank (B1, B2 fwd, B2 bwd, B3 fwd, B3 bwd, "
              f"B3 fwd bf16, B3 bwd bf16, B4, B5) {ranks[0]['counts'][name]} / "
              f"{ranks[1]['counts'][name]} | {card}", flush=True)
        want_counts = [0, 3 * DP_STEPS, 3 * DP_STEPS, 0, 0, 0, 0, DP_STEPS, 0]
        if not (loss_rel <= TRAIN_LOSS_TOL and norm_rel <= TRAIN_LOSS_TOL
                and upd_rel <= TRAIN_GRAD_TOL and same
                and all(r["counts"][name] == want_counts for r in ranks)):
            raise AssertionError(f"the two-rank {name} steps: {worst[name]}, ranks same "
                                 f"{same}, launches {[r['counts'][name] for r in ranks]}")

    # the Mockingjay joint finetune's global gradient and its masks
    mj, a = single["mockingjay"], ranks[0]["mockingjay"]
    loss_rel = rel(a["loss"], mj["loss"])
    grad_rel = float((a["grad"].double() - mj["grad"].double()).norm()
                     / mj["grad"].double().norm())
    masks_same = all(
        len(r["mockingjay"]["masks"]) == len(mj["masks"]) > 0 and all(
            torch.equal(got, want[i * rows:(i + 1) * rows])
            for got, want in zip(r["mockingjay"]["masks"], mj["masks"]))
        for i, r in enumerate(ranks))
    calls_ok = all(
        [(salt, b0) for salt, b0, _ in r["mockingjay"]["calls"]]
        == [(salt, i * rows) for salt, _, _ in mj["calls"]] and len(mj["calls"]) == MJ_LAYERS
        for i, r in enumerate(ranks))
    ranks_same = ranks[1]["mockingjay"]["same_as_rank0"]
    mj_counts = [r["counts"]["mockingjay"] for r in ranks]
    print(f"[mesh] (b) Mockingjay joint finetune (6 x 768 x 12, dropout 0.1, {DP_ROWS} ragged "
          f"10 s rows) two gloo ranks vs one process: loss rel {loss_rel:.3e} (limit "
          f"{TRAIN_LOSS_TOL:.0e}), |g - g_single| / |g_single| {grad_rel:.3e} (limit "
          f"{TRAIN_GRAD_TOL:.0e}); {len(mj['masks'])} hidden-dropout masks each the single "
          f"process's rows bit for bit {masks_same}; B3 calls at batch0 0 and {rows} with the "
          f"single process's salts {calls_ok}; the ranks' global gradients bit for bit "
          f"{ranks_same}; launches a rank {mj_counts} | {card}", flush=True)
    want_counts = [0, 0, 0, MJ_LAYERS, MJ_LAYERS, 0, 0, 1, 0]
    if not (loss_rel <= TRAIN_LOSS_TOL and grad_rel <= TRAIN_GRAD_TOL and masks_same
            and calls_ok and ranks_same and all(c == want_counts for c in mj_counts)):
        raise AssertionError(f"the two-rank Mockingjay step: loss {loss_rel}, grad {grad_rel}, "
                             f"masks {masks_same}, calls {calls_ok}, ranks {ranks_same}, "
                             f"launches {mj_counts}")
    worst["mockingjay"] = (loss_rel, grad_rel)

    # (c) the eval batch over the two ranks
    ev = single["eval"]
    eval_rel = max(rel(r["eval"]["loss"], ev["loss"]) for r in ranks)
    score_rel = max(float(((r["eval"]["scores"][k] - v).abs() / v.abs()).max())
                    for r in ranks for k, v in ev["scores"].items())
    eval_counts = [r["counts"]["eval"] for r in ranks]
    print(f"[mesh] (c) eval batch {DP_EVAL_ROWS} x 10 s (ragged) over two gloo ranks vs one "
          f"process: loss rel {eval_rel:.3e}, per-row scores rel {score_rel:.3e} (limit 1e-5); "
          f"launches a rank {eval_counts} | {card}", flush=True)
    want_counts = [3, 0, 0, 0, 0, 0, 0, 1, 1]
    if not (eval_rel <= 1e-5 and score_rel <= 1e-5
            and all(c == want_counts for c in eval_counts)):
        raise AssertionError(f"the mesh eval: loss {eval_rel}, scores {score_rel}, launches "
                             f"{eval_counts}")

    # (d) serving on two replicas; (e) the times
    serving = mesh_serving(torch, (L.lstm_bidir_tm, stft_kernel.stft_fused,
                                   decode_kernel.decode_ola), card, tmp)
    two_ms = {name: statistics.median(ranks[0][name]["ms"][1:]) for name in ("SISDR", "L1")}
    one_ms = {name: statistics.median(single[name]["ms"][1:]) for name in ("SISDR", "L1")}
    print(f"[time] (e) two gloo ranks on one card (gloo stages each collective through the "
          f"host; not a measure of a two-card run): flagship step B={DP_ROWS} (3 rows a rank) "
          f"SISDR {two_ms['SISDR']:.3f} ms, L1 {two_ms['L1']:.3f} ms; one process on all 6 "
          f"SISDR {one_ms['SISDR']:.3f} ms, L1 {one_ms['L1']:.3f} ms | {card}", flush=True)
    seconds = time.perf_counter() - t_phase
    print(f"[mesh] phase 17 in {seconds:.1f} s | {card}", flush=True)
    # launches of each kernel of phase 17 by name, over both ranks
    names = ("lstm_bidir_tm", "lstm_bidir_tm_fc", "lstm_bidir_tm_bwd", "flash_attention_fwd",
             "flash_attention_bwd", "flash_attention_fwd_bf16", "flash_attention_bwd_bf16",
             "stft_fused", "decode_ola")
    launches = {n: sum(r["counts"][k][i] for r in ranks for k in r["counts"])
                for i, n in enumerate(names)}
    for n, c in zip(("lstm_bidir_tm", "lstm_bidir_tm_fc", "lstm_bidir_tm_bwd", "stft_fused",
                     "decode_ola"), one["counts"]):
        launches[n] += c
    for n, c in zip(("lstm_bidir_tm", "stft_fused", "decode_ola"), serving["counts"]):
        launches[n] += c
    return {"launches": launches, "one": one, "serving": serving, "worst": worst,
            "two_ms": two_ms, "one_ms": one_ms, "eval": (eval_rel, score_rel),
            "seconds": seconds}


# model parallelism on the card (phase 18): B3 keyed on a head offset, then
# --mesh 1x2 and 2x2 (gloo ranks on this one card: NCCL refuses two ranks on
# one device) against one process on the global batches, the eval over the
# four ranks of 2x2, the wavefront pipeline and the sequence-parallel encoder
# at full width
MP_MESHES = (("1x2", 1, 2), ("2x2", 2, 2))
MP_FLAGSHIP_STEPS, MP_MJ_STEPS, MP_TIMED_STEPS = 3, 2, 2
# B3's four kernels on heads [6, 12) of 12 at head0 6, against the same heads
# of the full launch: bit for bit (a head's tiles, sums and mask never read
# another head)
HEAD0_PROBE, HEAD0_FIRST = (6, 1001, 12, 64), 6
# B3 at a rank's rows and heads against the single launch's: bit for bit
MP_PROBE = (6, 301, 12, 64)
# the pipeline: a layer a rank on the first PIPE_LAYERS ranks of 2x2, (B, T,
# H), chunks, and its limit against the one-direction stack on the card (both
# f32; B1's sums in other orders across the chunks' state hand-offs)
PIPE_LAYERS, PIPE_SHAPE, PIPE_CHUNKS, PIPE_TOL = 3, (6, 1001, 256), 7, 2e-5
# the sequence-parallel encoder (6 x 768 x 12, FFN 3072) on (B, T) frames of
# the 80-d Mockingjay input, (data, seq) (1, 2) in the 1x2 world and (2, 2) in
# 2x2, against the single-process encoder (the gathered keys change only the
# order of the attention's sums)
SEQ_SHAPE, SEQ_TOL = (4, 1000), 1e-4
# a kernel's launches in each main-path run, a rank: (B1, B2 fwd, B2 bwd, B3
# fwd, B3 bwd, B4, B5)
MP_NAMES = ("lstm_bidir_tm", "lstm_bidir_tm_fc", "lstm_bidir_tm_bwd", "flash_attention_fwd",
            "flash_attention_bwd", "stft_fused", "decode_ola")
MP_WANT = {"flagship": [0, 3 * MP_FLAGSHIP_STEPS, 3 * MP_FLAGSHIP_STEPS, 0, 0,
                        MP_FLAGSHIP_STEPS, 0],
           "mockingjay": [0, 0, 0, MJ_LAYERS * MP_MJ_STEPS, MJ_LAYERS * MP_MJ_STEPS,
                          MP_MJ_STEPS, 0],
           "eval": [3, 0, 0, 0, 0, 1, 1], "pipeline": [PIPE_CHUNKS, 0, 0, 0, 0, 0, 0]}


def head_offset_checks(torch, A, card):
    """Phase 18 (a): each of B3's four kernels (f32 and bf16, fwd and bwd)
    launched on heads [6, 12) of 12 at ``head0`` 6 against the same heads of
    the full launch, and the same heads launched as heads 0-5 of their own
    (other masks, so other outputs)."""
    g = torch.Generator().manual_seed(SEED + 180)
    B, T, N, D = HEAD0_PROBE
    h0, n = HEAD0_FIRST, HEAD0_PROBE[2] - HEAD0_FIRST
    cut = slice(h0 * D, N * D)
    base = [torch.randn(B, T, N * D, generator=g).cuda() for _ in range(4)]
    args = (D ** -0.5, 0.1, (0x2545F491, 0x9E3779B9), None, 0)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, dout = (x.to(dtype) for x in base)
        out, lse = A.flash_attention_fwd(q, k, v, *args, n_heads=N)
        grads = A.flash_attention_bwd(q, k, v, out, lse, dout, *args, n_heads=N)
        part = [x[..., cut].contiguous() for x in (q, k, v, out, dout)]
        heads = dict(n_heads=n, head0=h0, n_heads_total=N)
        out2, lse2 = A.flash_attention_fwd(*part[:3], *args, **heads)
        grads2 = A.flash_attention_bwd(*part[:3], part[3], lse[:, h0:].contiguous(), part[4],
                                       *args, **heads)
        out0, _ = A.flash_attention_fwd(*part[:3], *args, n_heads=n)
        torch.cuda.synchronize()
        pairs = [("out", out2, out[..., cut]), ("lse", lse2, lse[:, h0:])] + [
            (name, a, b[..., cut]) for name, a, b in zip(("dq", "dk", "dv"), grads2, grads)]
        same = {name: bool(torch.equal(a, b)) for name, a, b in pairs}
        moved = not torch.equal(out0, out[..., cut])
        res[str(dtype)] = same
        print(f"[model] (a) B3 fwd / bwd {str(dtype)[6:]} on heads [{h0}, {N}) of {N} at head0 "
              f"{h0} (B={B} T={T} D={D}, rate 0.1) against those heads of the full launch, "
              f"bit for bit: {same}; the same heads as heads 0-{n - 1} of their own differ "
              f"{moved} | {card}", flush=True)
        if not (all(same.values()) and moved):
            raise AssertionError(f"B3 at a head offset, {dtype}: {same}, moved {moved}")
    return res


def digest(arr) -> str:
    import hashlib

    return hashlib.sha1(np.ascontiguousarray(arr).tobytes()).hexdigest()


@contextlib.contextmanager
def mp_recording():
    """The hidden-dropout masks (forward and backward) as a digest a row, and
    B3's calls as (salt, batch0, head0, heads in all, heads, rows), in order."""
    import torch

    from speech_enhancement_by_s3prl_tpu_torch.models import transformer as t_tf

    rec = {"hidden": [], "b3": []}
    hidden, flash = t_tf._hash_mask_apply, t_tf.flash_attention

    def hidden_rec(x, salt, rate, batch0=0):
        mask = (hidden(torch.ones_like(x), salt, rate, batch0) != 0).cpu().numpy()
        rec["hidden"].append([digest(row) for row in mask])
        return hidden(x, salt, rate, batch0)

    def flash_rec(q, k, v, scale, rate=0.0, salt=(0, 0), kbias=None, batch0=0, *, n_heads,
                  head0=0, n_heads_total=None):
        rec["b3"].append((tuple(int(s) for s in salt), int(batch0), int(head0),
                          n_heads_total or n_heads, n_heads, q.shape[0]))
        return flash(q, k, v, scale, rate, salt, kbias, batch0, n_heads=n_heads, head0=head0,
                     n_heads_total=n_heads_total)

    t_tf._hash_mask_apply, t_tf.flash_attention = hidden_rec, flash_rec
    try:
        yield rec
    finally:
        t_tf._hash_mask_apply, t_tf.flash_attention = hidden, flash


def mp_side(torch, mesh):
    """Phase 18 (b)-(e) on one side: one process on the global batches
    (``mesh`` None) or a rank of a (data, model) mesh on its rows and shards.
    Returns what the parent compares, on the host."""
    import torch.distributed as dist

    from speech_enhancement_by_s3prl_tpu_torch.models.lstm import LSTMStack
    from speech_enhancement_by_s3prl_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerEncoder,
    )
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import attention_kernel as A
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import decode_kernel, stft_kernel
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L
    from speech_enhancement_by_s3prl_tpu_torch.parallel.mesh import (
        make_parallel_eval_step,
        make_parallel_train_step,
    )
    from speech_enhancement_by_s3prl_tpu_torch.parallel.pipeline import (
        make_pipe_mesh,
        pipeline_lstm,
        stack_lstm_params,
    )
    from speech_enhancement_by_s3prl_tpu_torch.parallel.sequence import (
        make_seq_mesh,
        sequence_parallel_encoder,
    )

    counted = (L.lstm_bidir_tm, L.lstm_bidir_tm_fc, L.lstm_bidir_tm_bwd, A.flash_attention_fwd,
               A.flash_attention_bwd, stft_kernel.stft_fused, decode_kernel.decode_ola)
    data, model = (1, 1) if mesh is None else (mesh.data, mesh.model)
    d, m = (0, 0) if mesh is None else (mesh.d, mesh.m)
    world = data * model
    res = {"counts": {}, "d": d, "m": m}

    # B3 at this side's rows (batch0) and heads (head0), f32 and bf16
    g = torch.Generator().manual_seed(SEED + 181)
    B, T, N, D = MP_PROBE
    rows, heads = B // data, N // model
    mine, cols = slice(d * rows, (d + 1) * rows), slice(m * heads * D, (m + 1) * heads * D)
    probe = [torch.randn(B, T, N * D, generator=g).cuda() for _ in range(4)]
    res["probe"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, dout = (x.to(dtype)[mine][..., cols].contiguous() for x in probe)
        args = (D ** -0.5, 0.1, (0x9E3779B9, 0x7F4A7C15), None, d * rows)
        key = dict(n_heads=heads, head0=m * heads, n_heads_total=N)
        out, lse = A.flash_attention_fwd(q, k, v, *args, **key)
        grads = A.flash_attention_bwd(q, k, v, out, lse, dout, *args, **key)
        res["probe"][str(dtype)] = [x.cpu() for x in (out, lse) + grads]

    # (b) the flagship 3 steps and the Mockingjay joint finetune 2 steps, then
    # timed steps
    batches = [dp_batch(DP_SECONDS, SEED + 1800 + i)
               for i in range(MP_FLAGSHIP_STEPS + MP_TIMED_STEPS)]
    for name, kind, steps in (("flagship", "residual", MP_FLAGSHIP_STEPS),
                              ("mockingjay", "mockingjay", MP_MJ_STEPS)):
        builder = dp_builder(torch, kind)
        state = builder.init_state()
        first = {k: v.detach().cpu().clone() for k, v in state.params.items()}
        step = builder.train_step
        if mesh is not None:
            step, state = make_parallel_train_step(builder, mesh, state)
        stats = []
        with mp_recording() as rec:
            # -- the main path of the mesh step, between the reset and the reading --
            reset_counts(counted)
            for wavs, lengths in batches[:steps]:
                state, st = step(state, torch.from_numpy(wavs).cuda(),
                                 torch.from_numpy(lengths).cuda())
                stats.append((float(st["loss"]), float(st["grad_norm"])))
            res["counts"][name] = [fn.launches for fn in counted]
            # -------------------------------------------------------------------
        tp = getattr(step, "tp", None)
        params = {k: v.detach().cpu().clone() for k, v in (
            state.params if tp is None else tp.gather(state.params)).items()}
        replicated = [v.detach().cpu().numpy() for k, v in sorted(state.params.items())
                      if tp is None or k not in tp.sharded]
        ms = []
        for wavs, lengths in batches[steps:steps + MP_TIMED_STEPS]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, torch.from_numpy(wavs).cuda(),
                            torch.from_numpy(lengths).cuda())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        res[name] = {"stats": stats, "ms": ms, "rec": rec,
                     "sharded": [] if tp is None else sorted(tp.sharded),
                     "replicated": digest(np.concatenate([x.reshape(-1) for x in replicated]))}
        if mesh is None or mesh.is_main:
            res[name]["first"] = first
            res[name]["params"] = params
        del builder, state, step, params, tp
        gc.collect()
        torch.cuda.empty_cache()

    # (c) the 12 x 10 s eval batch over every rank of 2x2 (and the single process)
    if mesh is None or world == 4:
        builder = dp_builder(torch, "residual")
        wavs, lengths = (torch.from_numpy(x).cuda()
                         for x in dp_batch(DP_EVAL_SECONDS, SEED + 1899))
        reset_counts(counted)
        if mesh is None:
            out = builder.eval_step(wavs, lengths)
        else:
            out = make_parallel_eval_step(builder, mesh)(wavs, lengths)
        res["counts"]["eval"] = [fn.launches for fn in counted]
        res["eval"] = {"loss": float(out["loss"]),
                       "scores": {k: v.cpu() for k, v in out["scores"].items()}}
        del builder

    # (d) the wavefront pipeline on the first PIPE_LAYERS ranks of 2x2 (the
    # single process: the one-direction stack)
    if mesh is None or world == 4:
        B, T, H = PIPE_SHAPE
        gp = torch.Generator().manual_seed(SEED + 182)
        stack = LSTMStack(H, H, PIPE_LAYERS, bidirectional=False, generator=gp).cuda()
        x = torch.randn(B, T, H, generator=gp).cuda()
        pipe = None if mesh is None else make_pipe_mesh(PIPE_LAYERS)
        with torch.no_grad():
            reset_counts(counted)
            if mesh is None:
                out = stack(x)
            elif pipe is not None:
                out = pipeline_lstm(x, stack_lstm_params(stack, PIPE_LAYERS), pipe,
                                    n_chunks=PIPE_CHUNKS)
            torch.cuda.synchronize()
            res["counts"]["pipeline"] = [fn.launches for fn in counted]
            res["carried"] = L.lstm_bidir_tm.carried
        if mesh is None or pipe is not None:
            res["pipeline"] = out.cpu()
        del stack

    # (e) the sequence-parallel encoder at full width, (data, seq) = (data, 2)
    ge = torch.Generator().manual_seed(SEED + 183)
    encoder = TransformerEncoder(TransformerConfig(input_dim=80), generator=ge).cuda().eval()
    spec = torch.randn(*SEQ_SHAPE, 80, generator=ge).cuda()
    if mesh is None:
        with torch.no_grad():
            res["sequence"] = encoder(spec).cpu()
    else:
        fn = sequence_parallel_encoder(encoder, make_seq_mesh(world, 2))
        res["sequence"] = fn(spec).cpu()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(spec)
        torch.cuda.synchronize()
        res["sequence_ms"] = (time.perf_counter() - t0) * 1e3
        dist.barrier()
    return res


def mp_rank(rank, world, model, out, init):
    """Phase 18 (b)-(e): one of the gloo ranks of a (world // model, model)
    mesh on card 0 (a process of its own, started with ``spawn``); writes
    ``mp_side``'s results to ``out``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from speech_enhancement_by_s3prl_tpu_torch import use_full_fp32
    from speech_enhancement_by_s3prl_tpu_torch.parallel.distributed import (
        initialize_distributed,
        topology_summary,
    )
    from speech_enhancement_by_s3prl_tpu_torch.parallel.mesh import make_mesh

    use_full_fp32()
    initialize_distributed(init, world, rank, device="cuda:0", backend="gloo")
    try:
        res = mp_side(torch, make_mesh(world // model, model))
        res["topology"] = topology_summary()
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


def release_card(torch, what):
    """Hand this process's cached device memory back before ranks that share
    the card start (each needs room for its own context), and say how much
    this process still holds."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mesh] before {what}: this process holds "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated", flush=True)


def spawn_ranks(target, world, args_of, timeout, what):
    """Start ``world`` processes of ``target`` (``spawn``), wait for all of
    them within ``timeout`` seconds, kill them past it; raise on a failure."""
    import torch
    import torch.multiprocessing as mp

    release_card(torch, what)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(r)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + timeout
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    if any(p.is_alive() for p in procs):
        for p in procs:
            p.kill()
            p.join()
        raise AssertionError(f"{what}: a rank did not finish within {timeout} s")
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"{what}: a rank failed: exit codes {[p.exitcode for p in procs]}")


def model_parallel_phase(torch, card, tmp):
    """Phase 18: tensor, pipeline and sequence parallelism on the card,
    (a)-(f) of the module docstring. Returns the launches and the readings
    for the summary."""
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import attention_kernel as A

    t_phase = time.perf_counter()
    head0 = head_offset_checks(torch, A, card)
    single = mp_side(torch, None)
    groups = {}
    for tag, data, model in MP_MESHES:
        world = data * model
        outs = [os.path.join(tmp, f"mp{tag}_{r}.pt") for r in range(world)]
        init = "file://" + os.path.join(tmp, f"rendezvous_{tag}")
        spawn_ranks(mp_rank, world, lambda r: (r, world, model, outs[r], init),
                    DP_RANK_TIMEOUT, f"--mesh {tag}")
        groups[tag] = [torch.load(o, weights_only=False) for o in outs]
        print(f"[model] (b) --mesh {tag} ranks: "
              + "; ".join(r["topology"] for r in groups[tag]), flush=True)

    worst, launches = {}, dict.fromkeys(MP_NAMES, 0)
    for tag, data, model in MP_MESHES:
        ranks = groups[tag]
        rows, heads = DP_ROWS // data, MP_PROBE[2] // model
        # B3 at each rank's rows and heads: bit for bit the single launch's
        probe_same = all(
            torch.equal(got, want[r["d"] * rows:(r["d"] + 1) * rows]
                        [..., r["m"] * heads * MP_PROBE[3]:(r["m"] + 1) * heads * MP_PROBE[3]]
                        if i != 1 else want[r["d"] * rows:(r["d"] + 1) * rows,
                                            r["m"] * heads:(r["m"] + 1) * heads])
            for r in ranks for dt in single["probe"]
            for i, (got, want) in enumerate(zip(r["probe"][dt], single["probe"][dt])))
        print(f"[model] (b) --mesh {tag}: B3 fwd / bwd, f32 and bf16, on each rank's {rows} "
              f"rows and {heads} heads at its batch0 and head0 (B={MP_PROBE[0]} "
              f"T={MP_PROBE[1]} {MP_PROBE[2]} x {MP_PROBE[3]}, rate 0.1): out, lse, dq, dk, "
              f"dv bit for bit the single launch's rows and heads {probe_same} | {card}",
              flush=True)
        if not probe_same:
            raise AssertionError(f"--mesh {tag}: B3 at a rank's batch0 / head0 differs")
        for name in ("flagship", "mockingjay"):
            want, a = single[name], ranks[0][name]
            loss_rel = max(rel(x[0], y[0]) for x, y in zip(a["stats"], want["stats"]))
            norm_rel = max(rel(x[1], y[1]) for x, y in zip(a["stats"], want["stats"]))
            upd = {k: (a["params"][k] - a["first"][k]).double() for k in a["params"]}
            ref = {k: (want["params"][k] - want["first"][k]).double() for k in want["params"]}
            upd_rel = math.sqrt(sum(float((upd[k] - ref[k]).pow(2).sum()) for k in ref)
                                / sum(float(ref[k].pow(2).sum()) for k in ref))
            stats_same = all(r[name]["stats"] == a["stats"] for r in ranks)
            repl_same = all(r[name]["replicated"] == s[name]["replicated"]
                            for r in ranks for s in ranks if r["d"] == s["d"])
            counts = [r["counts"][name] for r in ranks]
            masks_ok, calls_ok = True, True
            if name == "mockingjay":
                n_all = MP_PROBE[2]
                for r in ranks:
                    got, ref_rec = r[name]["rec"], want["rec"]
                    masks_ok &= len(got["hidden"]) == len(ref_rec["hidden"]) > 0 and all(
                        g == w[r["d"] * rows:(r["d"] + 1) * rows]
                        for g, w in zip(got["hidden"], ref_rec["hidden"]))
                    calls_ok &= len(got["b3"]) == len(ref_rec["b3"]) == MJ_LAYERS * MP_MJ_STEPS
                    calls_ok &= all(
                        g == (w[0], r["d"] * rows, r["m"] * (n_all // model), n_all,
                              n_all // model, rows)
                        for g, w in zip(got["b3"], ref_rec["b3"]))
            worst[(tag, name)] = (loss_rel, norm_rel, upd_rel)
            shape = "3 x BLSTM 256, SISDR" if name == "flagship" else "6 x 768 x 12, dropout 0.1"
            print(f"[model] (b) --mesh {tag} {name} ({shape}, "
                  f"{len(a['stats'])} steps of {DP_ROWS} ragged 10 s rows) against one process: "
                  f"loss rel {loss_rel:.3e}, grad norm rel {norm_rel:.3e} (limit "
                  f"{TRAIN_LOSS_TOL:.0e}), |update - update_single| / |update_single| of the "
                  f"gathered parameters {upd_rel:.3e} (limit {TRAIN_GRAD_TOL:.0e}); "
                  f"{len(a['sharded'])} parameters sharded; every rank's stats the same "
                  f"{stats_same}, replicated parameters bit for bit in each model group "
                  f"{repl_same}"
                  + (f"; {len(want['rec']['hidden'])} hidden-dropout masks the single "
                     f"process's rows bit for bit {masks_ok}, B3 calls at the single process's "
                     f"salts, batch0 and head0 {calls_ok}" if name == "mockingjay" else "")
                  + f"; launches a rank (B1, B2 fwd, B2 bwd, B3 fwd, B3 bwd, B4, B5) {counts} "
                  f"| {card}", flush=True)
            if not (loss_rel <= TRAIN_LOSS_TOL and norm_rel <= TRAIN_LOSS_TOL
                    and upd_rel <= TRAIN_GRAD_TOL and stats_same and repl_same and masks_ok
                    and calls_ok and a["sharded"] and all(c == MP_WANT[name] for c in counts)):
                raise AssertionError(f"--mesh {tag} {name}: {worst[(tag, name)]}, stats "
                                     f"{stats_same}, replicated {repl_same}, masks {masks_ok}, "
                                     f"calls {calls_ok}, launches {counts}")

    # (c) the eval batch over the four ranks of 2x2
    ranks, ev = groups["2x2"], single["eval"]
    eval_rel = max(rel(r["eval"]["loss"], ev["loss"]) for r in ranks)
    score_rel = max(float(((r["eval"]["scores"][k] - v).abs() / v.abs()).max())
                    for r in ranks for k, v in ev["scores"].items())
    eval_counts = [r["counts"]["eval"] for r in ranks]
    print(f"[model] (c) eval batch {len(DP_EVAL_SECONDS)} x 10 s (ragged) over the four ranks "
          f"of 2x2 vs one process: loss rel {eval_rel:.3e}, per-row scores rel "
          f"{score_rel:.3e} (limit 1e-5); launches a rank {eval_counts} | {card}", flush=True)
    if not (eval_rel <= 1e-5 and score_rel <= 1e-5
            and all(c == MP_WANT["eval"] for c in eval_counts)):
        raise AssertionError(f"the 2x2 eval: loss {eval_rel}, scores {score_rel}, launches "
                             f"{eval_counts}")

    # (d) the pipeline on ranks 0-2 of 2x2
    pipe_ranks = [r for r in ranks if "pipeline" in r]
    pipe_err = max(float((r["pipeline"] - single["pipeline"]).abs().max()) for r in pipe_ranks)
    pipe_counts = [(r["counts"]["pipeline"], r["carried"]) for r in pipe_ranks]
    print(f"[model] (d) pipeline_lstm, {PIPE_LAYERS} ranks a layer each (H={PIPE_SHAPE[2]}, "
          f"B={PIPE_SHAPE[0]}, T={PIPE_SHAPE[1]}, {PIPE_CHUNKS} chunks) vs the one-direction "
          f"LSTMStack on the card: max |diff| {pipe_err:.3e} (limit {PIPE_TOL:.0e}); launches a "
          f"rank (B1, ..., B5), B1 with a state {pipe_counts} | {card}", flush=True)
    if not (len(pipe_ranks) == PIPE_LAYERS and pipe_err <= PIPE_TOL
            and all(c == MP_WANT["pipeline"] and k == PIPE_CHUNKS for c, k in pipe_counts)):
        raise AssertionError(f"the pipeline: {len(pipe_ranks)} ranks, err {pipe_err}, launches "
                             f"{pipe_counts}")

    # (e) the sequence-parallel encoder
    seq_err = {tag: max(float((r["sequence"] - single["sequence"]).abs().max())
                        for r in groups[tag]) for tag, _, _ in MP_MESHES}
    print(f"[model] (e) sequence_parallel_encoder (6 x 768 x 12, B={SEQ_SHAPE[0]}, "
          f"T={SEQ_SHAPE[1]}) vs the single-process encoder: max |diff| at (data, seq) = (1, 2) "
          f"{seq_err['1x2']:.3e}, (2, 2) {seq_err['2x2']:.3e} (limit {SEQ_TOL:.0e}) | {card}",
          flush=True)
    if not all(e <= SEQ_TOL for e in seq_err.values()):
        raise AssertionError(f"the sequence-parallel encoder: {seq_err}")

    # (f) times, not judged
    times = {tag: {name: statistics.median(groups[tag][0][name]["ms"])
                   for name in ("flagship", "mockingjay")} for tag, _, _ in MP_MESHES}
    one = {name: statistics.median(single[name]["ms"]) for name in ("flagship", "mockingjay")}
    print(f"[time] (f) gloo ranks on one card (gloo stages each collective through the host; "
          f"not a measure of a run on several cards), median of {MP_TIMED_STEPS} steps of "
          f"B={DP_ROWS} 10 s: flagship " + ", ".join(
              f"--mesh {t} {times[t]['flagship']:.3f} ms" for t in times)
          + f", one process {one['flagship']:.3f} ms; Mockingjay " + ", ".join(
              f"--mesh {t} {times[t]['mockingjay']:.3f} ms" for t in times)
          + f", one process {one['mockingjay']:.3f} ms; the sequence-parallel encoder "
          + ", ".join(f"{t} {groups[t][0]['sequence_ms']:.3f} ms" for t in times) + f" | {card}",
          flush=True)
    # launches of each kernel of phase 18's main-path runs, over every rank
    for tag, _, _ in MP_MESHES:
        for r in groups[tag]:
            for counts in r["counts"].values():
                for n, c in zip(MP_NAMES, counts):
                    launches[n] += c
    seconds = time.perf_counter() - t_phase
    print(f"[model] phase 18 in {seconds:.1f} s | {card}", flush=True)
    return {"launches": launches, "worst": worst, "eval": (eval_rel, score_rel),
            "pipe_err": pipe_err, "seq_err": seq_err, "times": times, "one": one,
            "head0": head0, "seconds": seconds}


# the step tracer (phase 19): (a) run_downstream --profile, 3 B=6 10 s steps of
# the flagship, the second traced; (b) tools/profile_step in each mode at the
# JAX bench's batch (bench.py's ALL_MODES, with its variables), 2 traced calls
PROFILE_RUN_STEPS, PROFILE_RUN_AT = 3, 2
PROFILE_CALLS = 2  # once 3; phase 20 runs the same modes again
HS_FORM, VJP_FORM = ("SE_PALLAS_HS_BF16",), ("SE_PALLAS_VJP_BF16",)
# (label, mode, batch, dtype, stream-form variables, options, launches a call
# of each of the port's kernels, by the code: 3 LSTM layers, one B4 for the
# batch's features, one B5 for its decode, 6 encoder layers)
PROFILE_MODES = (
    ("enhance", "enhance", 768, "", HS_FORM, {}, {"B1": 3, "B4": 1, "B5": 1}),
    ("eval", "eval", 768, "", HS_FORM, {"eval_metrics": ("sisdr", "stoi")},
     {"B1": 3, "B4": 1, "B5": 1}),
    ("eval_full", "eval", 768, "", HS_FORM,
     {"eval_metrics": ("sisdr", "stoi", "estoi", "pesq_nb", "pesq_wb")},
     {"B1": 3, "B4": 1, "B5": 1}),
    ("train", "train", 352, "", VJP_FORM, {}, {"B2 fwd": 3, "B2 bwd": 3, "B4": 1}),
    ("upstream", "upstream", 512, "bf16", (), {}, {}),
    ("mockingjay", "mockingjay", 64, "bf16", (), {"mj_dropout": 0.1},
     {"B3 fwd bf16": 6, "B3 bwd bf16": 6, "B4": 1}),
    ("score", "score", 256, "bf16", VJP_FORM + HS_FORM, {}, {"B2 fwd": 3, "B2 bwd": 3, "B4": 1}),
)
# the parser's device plane against the profiler's own sum of the same events
PARSER_TOL = 0.05
# enhance at 768 rows: rows 0, 383 and 767 against the same rows in a B=6 call
# (the GEMMs may pick other algorithms at another batch), of the row's RMS
PROFILE_ROWS = (0, 383, 767, 1, 384, 766)


@contextlib.contextmanager
def plain_versions(torch):
    """B1, B2 fwd, B2 bwd and B4 run their plain PyTorch versions on CUDA
    tensors inside the block (the names the wrappers and the model call,
    swapped and restored), so that a step's kernels can be held against
    their plain versions on the card where the CPU would take minutes."""
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import library
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import stft_kernel

    swaps = {
        (L, "lstm_bidir_tm_fc"): lambda xw, w_hh_t, h_bf16=False, res_dtype=torch.float32: (
            L.lstm_bidir_tm_fc_ref(xw, w_hh_t, h_bf16, res_dtype)),
        (L, "lstm_bidir_tm_bwd"): L.lstm_bidir_tm_bwd_ref,
        (library, "lstm_recurrence"): lambda xw, w_hh_t, h_bf16, hs_bf16: L.lstm_bidir_tm_ref(
            xw, w_hh_t, h_bf16=h_bf16, hs_dtype=torch.bfloat16 if hs_bf16 else torch.float32),
        (library, "stft"): stft_kernel.stft_fused_ref,
    }
    saved = {key: getattr(*key) for key in swaps}
    try:
        for (mod, name), fn in swaps.items():
            setattr(mod, name, fn)
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def table_launches(tables):
    """(plane, ms, rows, {kernel id: launches}) of the one device plane of a
    parsed trace."""
    from speech_enhancement_by_s3prl_tpu_torch.utils.profiling import hand_written_launches

    planes = [p for p in tables if p.startswith("/device:")]
    if len(planes) != 1:
        raise AssertionError(f"want one device plane in the trace, got {list(tables)}")
    total, rows = tables[planes[0]]
    return planes[0], total, rows, hand_written_launches(rows)


def profile_run(torch, counted, card, tmp):
    """Phase 19 (a): the flagship through ``run_downstream.main`` with
    ``--profile`` (``profile_step`` 2) and without, 3 B=6 10 s steps each:
    scalars and the saved parameters bit for bit, one trace under the run's
    ``profile/`` whose device plane names B2 fwd and each kernel of B2 bwd 3
    times and B4 once (the traced step) and nothing else of the port."""
    from speech_enhancement_by_s3prl_tpu_torch import run_downstream as rd
    from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_to_state_dict
    from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import load_checkpoint
    from speech_enhancement_by_s3prl_tpu_torch.utils.profiling import kernel_id, parse_trace

    corpus = os.path.join(tmp, "corpus")
    write_corpus(corpus, SEED)
    config = train_config(corpus)
    config["runner"].update(total_step=PROFILE_RUN_STEPS, log_step=1, eval_step=100,
                            save_step=100, max_keep=1, profile_step=PROFILE_RUN_AT)
    config_path = os.path.join(tmp, "profile_config.yaml")
    with open(config_path, "w") as f:
        json.dump(config, f)  # JSON is YAML
    sides = {}
    for tag, extra in (("profiled", ["--profile"]), ("plain", [])):
        t0 = time.perf_counter()
        # -- the main path of --profile, between the reset and the reading --
        reset_counts(counted)
        rd.main(["--config", config_path, "--name", tag, "--expdir",
                 os.path.join(tmp, "profile_exp"), "--downstream", "Residual", "--objective",
                 "SISDR", "--from_rawfeature", "--dev_num", "3", "--n_jobs", "4", "--seed",
                 str(SEED), "--device", "cuda", *extra])
        counts = [fn.launches for fn in counted]
        # -----------------------------------------------------------------
        run_dir = os.path.join(tmp, "profile_exp", tag)
        with open(os.path.join(run_dir, "scalars.jsonl")) as f:
            scalars = [(r["step"], r["tag"], r["value"]) for r in map(json.loads, f)
                       if r["tag"] != "steps_per_sec"]
        params = flax_to_state_dict(load_checkpoint(run_dir)["Downstream"])
        sides[tag] = {"scalars": scalars, "params": params, "counts": counts, "run_dir": run_dir,
                      "s": time.perf_counter() - t0}
    on, off = sides["profiled"], sides["plain"]
    same = (on["scalars"] == off["scalars"] and set(on["params"]) == set(off["params"])
            and all(torch.equal(on["params"][k], off["params"][k]) for k in on["params"]))
    trace_dir = os.path.join(on["run_dir"], "profile")
    traces = sorted(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else []
    if len(traces) != 1 or not traces[0].startswith(f"train_step{PROFILE_RUN_AT}."):
        raise AssertionError(f"--profile wrote {traces} under {trace_dir}")
    plane, total, rows, launches = table_launches(parse_trace(os.path.join(trace_dir, traces[0]),
                                                              None))
    by_id = {}
    for name, _, n in rows:
        if kernel_id(name) is not None:
            by_id.setdefault(kernel_id(name), {})[name] = n
    bwd_kernels = {k.split("<")[0] for k in by_id.get("B2 bwd", {})}
    want = [0, 3 * PROFILE_RUN_STEPS, 3 * PROFILE_RUN_STEPS, PROFILE_RUN_STEPS, 0]
    print(f"[profile] (a) run_downstream.main --profile (profile_step {PROFILE_RUN_AT}), "
          f"{PROFILE_RUN_STEPS} B=6 10 s flagship steps, against the run without it: losses "
          f"{[v for _, t, v in on['scalars'] if t == 'loss']}, scalars and saved parameters "
          f"bit for bit {same}; launches (B1, B2 fwd, B2 bwd, B4, B5) {on['counts']} / "
          f"{off['counts']}; runs {on['s']:.1f} / {off['s']:.1f} s; trace {traces[0]}: plane "
          f"{plane} {total:.3f} ms, the port's kernels {by_id} | {card}", flush=True)
    if not same or on["counts"] != want or off["counts"] != want:
        raise AssertionError(f"--profile changed the run (bit for bit {same}) or its launches "
                             f"{on['counts']} / {off['counts']} (want {want})")
    if (set(by_id) != {"B2 fwd", "B2 bwd", "B4"}
            or any(n != 3 for n in by_id["B2 fwd"].values())
            or any(n != 3 for n in by_id["B2 bwd"].values())
            or not {"lstm_bwd_gates_kernel", "lstm_bwd_seq_kernel", "lstm_bwd_dw_kernel"}
            <= bwd_kernels or list(by_id["B4"].values()) != [1]):
        raise AssertionError(f"the traced step's device plane names the port's kernels {by_id}; "
                             "want B2 fwd and each kernel of B2 bwd 3 times, B4 once")
    return {"counts": on["counts"], "by_id": by_id}


def profile_modes(torch, card, tmp):
    """Phase 19 (b): ``tools/profile_step``'s modes at the JAX bench's batches
    (``PROFILE_MODES``), each warmed by one call and traced over
    ``PROFILE_CALLS``: the device plane's ms a call and top 10 rows, the
    port's kernels' launches a call from the table against the code's count
    and the wrappers' counters, the plane's total against the profiler's own
    sum of its device events, and each mode's check at its row count."""
    from speech_enhancement_by_s3prl_tpu_torch.active.sampler import matching
    from speech_enhancement_by_s3prl_tpu_torch.runner.trainer import make_context
    from speech_enhancement_by_s3prl_tpu_torch.tools.profile_step import build_mode, wait
    from speech_enhancement_by_s3prl_tpu_torch.utils.profiling import (
        kernel_id,
        newest_trace,
        parse_trace,
        trace,
    )

    wrappers = kernel_wrappers()
    out = {"launches": {}, "ms": {}, "kernel_ms": {}, "checks": {}}

    def grad_of(builder, wavs, lengths):
        ctx = make_context(builder.preprocessor, wavs, lengths, 0, 1)
        params = [p for _, p in builder.model.named_parameters()]
        with torch.enable_grad():
            loss, _ = builder.loss_fn(ctx)
            g = torch.autograd.grad(loss, params)
        return float(loss.detach()), torch.cat([x.reshape(-1) for x in g]).double()

    for label, mode, batch, dtype, forms, options, want in PROFILE_MODES:
        t0 = time.perf_counter()
        with stream_env(forms):
            step = build_mode(mode, batch, dtype, 10, "cuda", SEED, **options)
            wait(step())  # warm, outside the trace
            torch.cuda.synchronize()
            # -- the main path of the mode, between the reset and the reading --
            reset_counts(wrappers.values())
            with trace(os.path.join(tmp, "profile_step"), label) as prof:
                t1 = time.perf_counter()
                for _ in range(PROFILE_CALLS):
                    last = step()
                wait(last)
                wall = (time.perf_counter() - t1) * 1e3 / PROFILE_CALLS
            counts = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
            # -------------------------------------------------------------
            busy = sum(evt.time_range.elapsed_us() for evt in device_events(prof)) / 1e3
            path = newest_trace(os.path.join(tmp, "profile_step"))
            plane, total, rows, launches = table_launches(parse_trace(path, None))
            per_call = {k: n / PROFILE_CALLS for k, n in launches.items()}
            from_wrappers = {k: n / PROFILE_CALLS for k, n in counts.items()}
            gap = abs(total - busy) / max(busy, 1e-9)
            print(f"[profile] (b) {label} B={batch} 10 s ({mode}, {dtype or 'f32'}"
                  + (f", {'+'.join(forms)}" if forms else "")
                  + (f", {options}" if options else "") + f"): plane "
                  f"{plane} {total / PROFILE_CALLS:.3f} ms/step (the profiler's device sum "
                  f"{busy / PROFILE_CALLS:.3f}, {gap:.2%} apart, limit {PARSER_TOL:.0%}), wall "
                  f"{wall:.3f} ms a call under the profiler; the port's kernels a step from the "
                  f"table {per_call}, from the wrappers {from_wrappers}, want {want} | {card}",
                  flush=True)
            print(f"[profile] (b) {label} top 10 (ms/step  xcount  name): "
                  + "; ".join(f"{ms / PROFILE_CALLS:.3f} x{n} {name[:70]}"
                              for name, ms, n in rows[:10]) + f" | {card}", flush=True)
            if per_call != want or from_wrappers != want or not gap <= PARSER_TOL:
                raise AssertionError(f"{label}: launches a step {per_call} (table) / "
                                     f"{from_wrappers} (wrappers), want {want}; parser "
                                     f"{total} ms against the profiler's {busy} ms")
            out["launches"][label] = counts
            out["ms"][label] = (total / PROFILE_CALLS, wall)
            out["kernel_ms"][label] = {
                name: (ms / n, n) for name, ms, n in rows if kernel_id(name) is not None}

            if mode == "enhance":
                rows_ = torch.tensor(PROFILE_ROWS, device="cuda")
                big = step.enhance(step.wavs, step.lengths)[rows_]
                small = step.enhance(step.wavs[rows_], step.lengths[rows_])
                rel = max(float((b - s).abs().max() / s.pow(2).mean().sqrt())
                          for b, s in zip(big[:3], small[:3]))
                finite = bool(torch.isfinite(big).all())
                out["checks"][label] = rel
                print(f"[profile] (b) enhance: rows {PROFILE_ROWS[:3]} of the {batch}-row call "
                      f"against the same rows in a {len(PROFILE_ROWS)}-row call: max |diff| / "
                      f"row RMS {rel:.3e} (limit {SLICE_TOL:.0e}); finite {finite} | {card}",
                      flush=True)
                if not (rel <= SLICE_TOL and finite):
                    raise AssertionError(f"enhance at {batch} rows: {rel}, finite {finite}")
            elif mode == "train":
                got = grad_of(step.builder, step.wavs, step.lengths)
                reset_counts(wrappers.values())
                with plain_versions(torch):
                    ref = grad_of(step.builder, step.wavs, step.lengths)
                moved = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
                loss_rel = abs(got[0] - ref[0]) / abs(ref[0])
                grad_rel = float((got[1] - ref[1]).norm() / ref[1].norm())
                out["checks"][label] = (loss_rel, grad_rel)
                print(f"[profile] (b) train: loss and gradient at {batch} rows against the same "
                      f"step with the plain versions on the card: loss {got[0]:.6f} vs "
                      f"{ref[0]:.6f} rel {loss_rel:.3e} (limit {TRAIN_LOSS_TOL:.0e}), "
                      f"|g - g_plain| / |g_plain| {grad_rel:.3e} (limit {TRAIN_GRAD_TOL:.0e}); "
                      f"launches under the plain versions {moved} | {card}", flush=True)
                if moved or not (loss_rel <= TRAIN_LOSS_TOL and grad_rel <= TRAIN_GRAD_TOL):
                    raise AssertionError(f"train at {batch} rows: loss {loss_rel}, gradient "
                                         f"{grad_rel}, plain launches {moved}")
            elif mode == "score":
                # the mode's bf16 head under its forms, then the same weights
                # in f32 with no form; each by the kernels and by the plain
                # versions on the card
                sides = {}
                for dt, names in (("bf16", forms), ("f32", ())):
                    with_dtype(step.model, getattr(torch, "bfloat16" if dt == "bf16"
                                                   else "float32"))
                    with stream_env(names):
                        got = step.scoring(step.model, step.wavs, step.lengths)
                        reset_counts(wrappers.values())
                        with plain_versions(torch):
                            ref = step.scoring(step.model, step.wavs, step.lengths)
                    moved = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
                    query = slice(0, ACTIVE_QUERY_ROWS)
                    m_got, m_ref = matching(got[query], got), matching(ref[query], ref)
                    sides[dt] = (got, ref, float((got - ref).abs().max() / ref.abs().max()),
                                 float((m_got - m_ref).abs().max()),
                                 bool(torch.equal(m_got > 0, m_ref > 0)), moved)
                (g16, r16, emb16, match16, same16, moved16), (g32, r32, emb, match, same,
                                                              moved32) = sides.values()
                near, ratio = window(torch, g16, g32, r16, r32, "score mode at 256 rows")
                out["checks"][label] = (emb, match, same, emb16, match16, same16, near, ratio)
                print(f"[profile] (b) score: per-row embeddings ({tuple(g32.shape)}) at {batch} "
                      f"rows against the plain versions on the card: the f32 head max |diff| / "
                      f"max|emb| {emb:.3e} (limit {ACTIVE_EMB_TOL:.0e}), match scores against "
                      f"the first {ACTIVE_QUERY_ROWS} rows {match:.3e} (limit "
                      f"{ACTIVE_MATCH_TOL:.0e}), the same match > 0 set {same}; the mode's bf16 "
                      f"head under its forms {emb16:.3e} / {match16:.3e} (a flipped bf16 "
                      f"residual carries), the same match > 0 set {same16}, window near "
                      f"{near:.3f} (limit {WINDOW_NEAR}), ratio {ratio:.3f} (limits "
                      f"{WINDOW_LOW}, {WINDOW_HIGH}); launches under the plain versions "
                      f"{moved16 or moved32} | {card}", flush=True)
                if moved16 or moved32 or not (emb <= ACTIVE_EMB_TOL and match <= ACTIVE_MATCH_TOL
                                              and same and same16):
                    raise AssertionError(f"score at {batch} rows: f32 embeddings {emb}, match "
                                         f"{match}, same sets {same} / {same16}, plain "
                                         f"{moved16} / {moved32}")
                del sides, g16, r16, g32, r32
            else:
                vals = last.values() if isinstance(last, dict) else (last,)
                if not all(bool(torch.isfinite(v).all()) for v in vals):
                    raise AssertionError(f"{label}: a non-finite result {last}")
        print(f"[profile] (b) {label}: mode {time.perf_counter() - t0:.1f} s | {card}", flush=True)
        del step, last
        gc.collect()
        torch.cuda.empty_cache()
    return out


# phase 19 (c): kernels of a probe session, counted under a bare
# torch.profiler and under utils/profiling.trace
PROBE_KERNELS = 64


def profiler_records(torch, card, tmp):
    """Phase 19 (c): ``PROBE_KERNELS`` small kernels (an in-place add on the
    card) traced by a bare ``torch.profiler`` session and by
    ``utils/profiling.trace``: the records each keeps. In a process some
    minutes old the first records of a session go missing; ``trace``'s
    opening pads take their places, so it must keep every probe kernel.
    Returns (probe records bare, probe records traced, pads kept)."""
    from torch.profiler import ProfilerActivity, profile

    from speech_enhancement_by_s3prl_tpu_torch.utils.profiling import (
        PAD_KERNEL,
        PAD_LAUNCHES,
        trace,
    )

    x = torch.zeros(1, device="cuda")

    def probe():
        for _ in range(PROBE_KERNELS):
            x.add_(1.0)
        torch.cuda.synchronize()

    probe()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as bare:
        probe()
    with trace(os.path.join(tmp, "probe"), "probe") as traced:
        probe()
    counts = []
    for prof in (bare, traced):
        names = [evt.name for evt in device_events(prof)]
        counts.append((sum(PAD_KERNEL not in n for n in names),
                       sum(PAD_KERNEL in n for n in names)))
    (seen_bare, _), (seen, pads) = counts
    print(f"[profile] (c) a probe of {PROBE_KERNELS} kernels at {time.perf_counter() - T_START:.0f} "
          f"s into the run: a bare torch.profiler session recorded {seen_bare}, "
          f"utils/profiling.trace {seen} (want all) and {pads} of its {PAD_LAUNCHES} opening pads "
          f"| {card}", flush=True)
    if seen != PROBE_KERNELS:
        raise AssertionError(f"trace kept {seen} of {PROBE_KERNELS} probe kernels")
    return seen_bare, seen, pads


def profile_phase(torch, card, tmp):
    """Phase 19: ``run_downstream --profile`` and ``tools/profile_step`` on
    the card, and the kernels' times at the bench's row counts beside their
    bounds."""
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import decode_kernel, stft_kernel
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L

    t0 = time.perf_counter()
    run = profile_run(torch, (L.lstm_bidir_tm, L.lstm_bidir_tm_fc, L.lstm_bidir_tm_bwd,
                              stft_kernel.stft_fused, decode_kernel.decode_ola), card, tmp)
    modes = profile_modes(torch, card, tmp)
    records = profiler_records(torch, card, tmp)
    # B1 at 768 rows (hs in bf16), B2 fwd / bwd at 352 (bf16 residuals): each
    # kernel's ms a launch from the trace beside the bound of its form
    T, H = 1001, 256
    bounds = {"enhance": ("B1", stream_bound(768, T, H, "b1", False, True)),
              "train": ("B2", {"fc": stream_bound(352, T, H, "fc", False, True),
                               "bwd": stream_bound(352, T, H, "bwd", False, True)})}
    b1 = {k: v for k, v in modes["kernel_ms"]["enhance"].items() if k.startswith("lstm_")}
    b2 = {k: v for k, v in modes["kernel_ms"]["train"].items() if k.startswith("lstm_")}
    b2_bwd = sum(ms for k, (ms, _) in b2.items() if k.startswith("lstm_bwd"))
    b2_fc = sum(ms for k, (ms, _) in b2.items() if k.startswith("lstm_tm_cluster"))
    print(f"[bound] B1 at B=768 T=1001 H=256 (hs bf16) from the enhance trace: "
          + ", ".join(f"{k} {ms:.3f} ms x{n}" for k, (ms, n) in b1.items())
          + f"; bound {bounds['enhance'][1][0]:.3f} ms by {bounds['enhance'][1][1]} | {card}",
          flush=True)
    print(f"[bound] B2 at B=352 T=1001 H=256 (bf16 residuals) from the train trace, ms a launch: "
          + ", ".join(f"{k} {ms:.3f} x{n}" for k, (ms, n) in b2.items())
          + f"; B2 fwd {b2_fc:.3f} ms (bound {bounds['train'][1]['fc'][0]:.3f} by "
          f"{bounds['train'][1]['fc'][1]}), B2 bwd's phases together {b2_bwd:.3f} ms (bound "
          f"{bounds['train'][1]['bwd'][0]:.3f} by {bounds['train'][1]['bwd'][1]}) | {card}",
          flush=True)
    seconds = time.perf_counter() - t0
    print(f"[profile] phase 19: {seconds:.1f} s | {card}", flush=True)
    return {"run": run, "modes": modes, "seconds": seconds, "records": records,
            "b1_768": (b1, bounds["enhance"][1]),
            "b2_352": (b2, bounds["train"][1]["fc"], bounds["train"][1]["bwd"])}


# the benchmark harness (phase 20): bench.py's run_all, every mode of its
# ALL_MODES at the JAX bench's batches and variables, BENCH_ITERS calls a
# mode, the pipeline over one epoch; the latency mode at the JAX bench's 50
# calls (0.3 s), which a stall of the host shifts less than 10
BENCH_ENV = {"BENCH_ITERS": "2", "BENCH_LATENCY_ITERS": "50", "BENCH_PIPE_EPOCHS": "1",
             "BENCH_MODE_TIMEOUT": "300", "BENCH_TOTAL_BUDGET": "600"}
BENCH_TIMEOUT = 700
BENCH_ALL = ("enhance", "train", "eval", "eval_full", "upstream", "mockingjay", "score",
             "loader", "latency", "pipeline")
# launches a call of each kernel in each device mode's window, by the code:
# 3 LSTM layers, one B4 for the batch's features, one B5 for its decode, 6
# encoder layers (phase 19's PROFILE_MODES)
DSP_PATH = {"B1": 3, "B4": 1, "B5": 1}
STEP_PATH = {"B2 fwd": 3, "B2 bwd": 3, "B4": 1}
BENCH_LAUNCHES = {"enhance": DSP_PATH, "eval": DSP_PATH, "eval_full": DSP_PATH,
                  "latency": DSP_PATH, "pipeline": DSP_PATH, "train": STEP_PATH,
                  "score": STEP_PATH, "upstream": {},
                  "mockingjay": {"B3 fwd bf16": 6, "B3 bwd bf16": 6, "B4": 1}}
# program_cost of the flagship's enhance and train step held card against CPU
# at this shape, in f32 and under each bench mode's stream forms: the kernels
# count by formula, so the card's count must equal the plain versions'
COST_ROWS, COST_SECONDS = 2, 1
COST_CASES = (("enhance", ()), ("enhance", ENHANCE_MODE), ("train", ()),
              ("train", TRAIN_MODE))
# the bounds as this script printed them before their counts moved into
# utils/costs.py: (function, arguments, keywords, ms, what binds)
BOUND_PINS = (
    ("lstm_bound", (1, 1001, 256), {}, 0.015666038447761196, "operations"),
    ("lstm_bound", (64, 1001, 256), {}, 1.0026264606567166, "operations"),
    ("lstm_bound", (6, 1001, 256), {"extra_streams": 1}, 0.09399623068656716, "operations"),
    ("lstm_bound", (6, 1001, 256), {"products": 3, "extra_streams": 3, "peak": PEAK_TF32},
     0.1145044992, "operations"),
    ("lstm_bound", (64, 1001, 256), {"products": 3, "extra_streams": 3},
     3.0078793819701493, "operations"),
    ("lstm_bound", (256, 1001, 256), {"peak": PEAK_TF32}, 1.6285084330666666, "operations"),
    ("lstm_bound", (1, 1001, 256), {"D": 512, "peak": PEAK_TF32}, 0.019084083199999997,
     "operations"),
    ("carried_bound", (1, 48, 256), {}, 0.00038728597014925375, "bytes"),
    ("attention_bound", (6, 1001, 12, 64, 2), {}, 0.11193262080000001, "operations"),
    ("attention_bound", (64, 1001, 12, 64, 5), {}, 2.984869888, "operations"),
    ("attention_bound", (6, 1001, 12, 64, 5), {"peak": PEAK_F32}, 0.6891374041791045,
     "operations"),
    ("attention_bound_bf16", (64, 1001, 12, 64, 5), {}, 0.497981326107179, "operations"),
    ("stft_bound", (64, 1001, 400, 160), {}, 0.04297902089552239, "bytes"),
    ("decode_bound", (12, 1001, 400, 160), {}, 0.01094949014925373, "bytes"),
    ("bf16_h_bound", (6, 1001, 256, "fc"), {}, 0.01132819104477612, "bytes"),
    ("bf16_h_bound", (6, 1001, 256, "bwd"), {}, 0.02226797979049545, "operations"),
    ("bf16_h_bound", (352, 201, 256, "dw"), {}, 0.11196119878665318, "operations"),
    ("dw_first_bound", (6, 1001, 256), {}, 0.04695116417910448, "operations"),
    ("stream_bound", (768, 1001, 256, "b1", False, True), {}, 12.031517527880597, "operations"),
    ("stream_bound", (352, 1001, 256, "bwd", False, True), {}, 2.23995379688071, "operations"),
)
# a class's peak is now divided once (165e12 for three TF32 passes) where it
# multiplied the count: the same number within an ulp or two
BOUND_RTOL = 1e-12


def bench_checks(line, name, card):
    """The checks of one mode's line from ``run_all``; returns the line."""
    if "value" not in line or not line["value"] > 0:
        raise AssertionError(f"bench mode {name} gave no positive value: {str(line)[-1500:]}")
    if line.get("card") != (card if name != "loader" else "host"):
        raise AssertionError(f"bench mode {name} names the card {line.get('card')!r}, not {card!r}")
    if name == "loader":
        return line
    if "roofline_error" in line:
        raise AssertionError(f"bench mode {name}: {line['roofline_error']}")
    for key in ("mfu", "hbm_util_model"):
        if not 0 < line.get(key, 0) <= 1:
            raise AssertionError(f"bench mode {name}: {key} {line.get(key)} outside (0, 1]")
    if line["opaque_calls"]:
        raise AssertionError(f"bench mode {name}: {line['opaque_calls']} opaque calls")
    if line["launches_per_call"] != BENCH_LAUNCHES[name]:
        raise AssertionError(f"bench mode {name} launched {line['launches_per_call']}, the code "
                             f"gives {BENCH_LAUNCHES[name]}")
    return line


def bench_phase(torch, card):
    """Phase 20: ``python -m speech_enhancement_by_s3prl_tpu_torch.bench`` (its
    ``run_all``: a subprocess a mode) with every mode's line checked;
    ``program_cost`` of the enhance call and the train step on the card
    against the CPU; the bounds the earlier phases print against their values
    before the move into ``utils/costs.py``."""
    from speech_enhancement_by_s3prl_tpu_torch import bench
    from speech_enhancement_by_s3prl_tpu_torch.tools.profile_step import build_mode
    from speech_enhancement_by_s3prl_tpu_torch.utils import costs

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_") and k not in ("SE_LSTM_XW_BF16", "SE_PALLAS_HS_BF16",
                                                       "SE_PALLAS_VJP_BF16")}
    env.update(BENCH_ENV)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    out = subprocess.run([sys.executable, "-m", "speech_enhancement_by_s3prl_tpu_torch.bench"],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT)
    lines = out.stdout.strip().splitlines()
    if out.returncode or not lines:
        raise AssertionError(f"bench.py exited {out.returncode}: {out.stderr[-3000:]}")
    payload = json.loads(lines[-1])
    modes = payload["modes"]
    if tuple(modes) != BENCH_ALL:
        raise AssertionError(f"bench.py ran {list(modes)}, not {list(BENCH_ALL)}: "
                             f"{payload.get('skipped')}")
    for name in BENCH_ALL:
        line = bench_checks(modes[name], name, card)
        print(f"[bench] {name}: {line['metric']} {line['value']} {line['unit']}"
              + ("" if name == "loader" else
                 f", mfu {line['mfu']:.4f}, hbm_util_model {line['hbm_util_model']:.4f}, "
                 f"{line['flops_per_step'] / 1e12:.3f} TFLOP a step ("
                 + ", ".join(f"{c} {f / 1e12:.3f}" for c, f in line["flops_by_class"].items()
                             if f) + "), "
                 f"{line['hbm_gbytes_per_step_model']:.3f} GB a step (model), launches a call "
                 f"{line['launches_per_call']}") + f"; {line['wall_s']} s ({line.get('seconds')})"
              + f" | {card}", flush=True)
    if payload["metric"] != "enhance_rtf_per_chip" or payload["value"] != modes["enhance"]["value"]:
        raise AssertionError(f"run_all's headline is not the enhance mode's: {payload['metric']}")
    run_s = time.perf_counter() - t0
    # program_cost on the card (kernels) against the CPU (plain versions)
    same = {}
    for mode, names in COST_CASES:
        got = {}
        with stream_env(names):
            for device in ("cuda", "cpu"):
                step = build_mode(mode, COST_ROWS, utt_sec=COST_SECONDS, device=device)
                got[device] = costs.program_cost(*bench.cost_call(step))
        keys = ("flops", "dot_flops", "hbm_bytes_model", "flops_by_class", "kernels",
                "opaque_calls")
        diff = {k: (got["cuda"][k], got["cpu"][k]) for k in keys if got["cuda"][k] != got["cpu"][k]}
        if diff:
            raise AssertionError(f"program_cost of {mode} under {names} differs, card against "
                                 f"CPU: {diff}")
        same[(mode, "+".join(n[3:] for n in names) or "f32")] = got["cuda"]
        del step
    print("[bench] program_cost card (kernels) = CPU (plain versions) at B="
          f"{COST_ROWS}, {COST_SECONDS} s: " + ", ".join(
              f"{m} {f}: {c['flops']:.6g} flops, {c['dot_flops']:.6g} products, "
              f"{c['hbm_bytes_model']:.6g} bytes, {c['kernels']}" for (m, f), c in same.items())
          + f" | {card}", flush=True)
    for fn, args, kwargs, ms, by in BOUND_PINS:
        got = getattr(costs, fn)(*args, **kwargs)
        if got[1] != by or abs(got[0] - ms) > BOUND_RTOL * ms:
            raise AssertionError(f"{fn}{args} {kwargs} is {got}, before the move {(ms, by)}")
    seconds = time.perf_counter() - t0
    print(f"[bench] the {len(BOUND_PINS)} pinned bounds unchanged by the move into "
          f"utils/costs.py (rel {BOUND_RTOL:.0e}); run_all {run_s:.1f} s; phase 20 in "
          f"{seconds:.1f} s | {card}", flush=True)
    return {"modes": modes, "seconds": seconds, "run_s": run_s}


# JAX's random streams (phase 21): kernel D1 (flax nn.Dropout's threefry
# mask) at the Mockingjay width, B3's mask forms, and the default dropout-live
# step. D1 and B3's forms are integer functions of the key: their masks must be
# identical to the plain versions', and D1's values too (the same IEEE
# division). The variables phases 1-20 run under (the flash + hash routes
# they were written for) and the four the JAX package reads for dropout.
HASH_ROUTES = {"SE_ATTN_IMPL": "flash", "SE_HIDDEN_DROPOUT_IMPL": "hash"}
DROPOUT_VARIABLES = ("SE_ATTN_IMPL", "SE_HIDDEN_DROPOUT_IMPL", "SE_DROPOUT_IMPL",
                     "SE_ATTN_DROPOUT_CHUNK")
D1_SHAPE = (64, 1001, 768)  # a Mockingjay hidden state at B=64, 10 s
D1_KEY, D1_RATE = (0x12345678, 0x9ABCDEF0), 0.1
# a batch0 whose flat indices pass 2^32 (6000 * 1001 * 768 > 2^32): the
# counter's high word
D1_HIGH_BATCH0 = 6000
# B3's forms besides the hash: the explicit path's flax and hidden-hash masks,
# and the chunked path's (SE_ATTN_DROPOUT_CHUNK, per-chunk keys)
B3_FORMS = (("flax", 0), ("hidden_hash", 0), ("flax", 256), ("hidden_hash", 256))
B3_FORM_KEY = (0x9E3779B9, 0xDEADBEEF)
B3_FORM_SHAPES = {"f32": (6, 1001, 12, 64), "bf16": (64, 1001, 12, 64)}
# the mask probe: (B, N, T, D), batch0, head0, heads in all, chunk; batch0 6000
# puts the flax counter's high word at 1 and above
B3_PROBE = (2, 3, 1001, 64)
B3_PROBE_BWD = (2, 3, 200, 256)
B3_PROBE_KEY = (6000, 1, 5)
B3_PROBE_CHUNK = 96
# the default step card against CPU: full width, 3 steps of 4 rows of 2 s
DEFAULT_STEPS, DEFAULT_ROWS, DEFAULT_SECONDS = 3, 4, 2.0
# the step times: (rows, compute dtype) at 10 s
ROUTE_TIMES = ((6, "f32"), (64, "bf16"))


def dropout_env(routes):
    """A context in which the four dropout variables are ``routes`` (unset
    where it names none)."""
    @contextlib.contextmanager
    def ctx():
        saved = {k: os.environ.get(k) for k in DROPOUT_VARIABLES}
        for k in DROPOUT_VARIABLES:
            os.environ.pop(k, None)
        os.environ.update(routes)
        try:
            yield
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return ctx()


def d1_checks(torch, R, prng):
    """Phase 21 (a): D1 against its plain version at the Mockingjay width, f32
    and bf16, forward and (through ``ThreefryDropout``) backward, at batch0 0
    and 5 and past the counter's high word: masks and values identical. Returns
    {dtype: (ms, plain ms, bound)}, and the largest |difference| (0)."""
    from speech_enhancement_by_s3prl_tpu_torch.utils.costs import dropout_bound

    out, worst = {}, 0.0
    inner = D1_SHAPE[1] * D1_SHAPE[2]
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(SEED)
        x = torch.randn(D1_SHAPE, device="cuda", generator=g).to(dtype)
        dy = torch.randn(D1_SHAPE, device="cuda", generator=g).to(dtype)
        for batch0 in (0, 5):
            y = R.threefry_dropout_kernel(x, D1_KEY, D1_RATE, batch0)
            ref = R.threefry_dropout_ref(x, D1_KEY, D1_RATE, batch0)
            xg = x.clone().requires_grad_()
            dx = torch.autograd.grad(R.threefry_dropout(xg, D1_KEY, D1_RATE, batch0), xg, dy)[0]
            dx_ref = R.threefry_dropout_ref(dy, D1_KEY, D1_RATE, batch0)
            mask = R.threefry_dropout_kernel(torch.ones_like(x), D1_KEY, D1_RATE, batch0) != 0
            want = prng.bernoulli(D1_KEY, 1.0 - D1_RATE, D1_SHAPE, batch0 * inner, "cuda")
            torch.cuda.synchronize()
            same = (torch.equal(y, ref), torch.equal(dx, dx_ref), torch.equal(mask, want))
            keep = float(mask.float().mean())
            print(f"[rng] D1 {str(dtype)[6:]} {D1_SHAPE} batch0={batch0}: forward, "
                  f"backward and mask identical to the plain version {same}; kept "
                  f"{keep:.5f} (rate {D1_RATE})", flush=True)
            if not all(same) or abs(keep - (1.0 - D1_RATE)) > 1e-3:
                raise AssertionError(f"D1 disagrees with its plain version: {same}, kept {keep}")
            worst = max(worst, float((y.float() - ref.float()).abs().max()))
        # a rank's rows: rows 5.. alone at batch0 5 are rows 5.. of the launch
        rows = R.threefry_dropout_kernel(x[5:], D1_KEY, D1_RATE, 5)
        high = R.threefry_dropout_kernel(x[:2], D1_KEY, D1_RATE, D1_HIGH_BATCH0)
        high_ref = R.threefry_dropout_ref(x[:2], D1_KEY, D1_RATE, D1_HIGH_BATCH0)
        torch.cuda.synchronize()
        if not (torch.equal(rows, R.threefry_dropout_kernel(x, D1_KEY, D1_RATE)[5:])
                and torch.equal(high, high_ref)):
            raise AssertionError("D1 at a batch offset disagrees")
        ms = cuda_ms(torch, lambda: R.threefry_dropout_kernel(x, D1_KEY, D1_RATE), 20, warmup=2)
        plain = cuda_ms(torch, lambda: R.threefry_dropout_ref(x, D1_KEY, D1_RATE), 3)
        out[str(dtype)[6:]] = (ms, plain, dropout_bound(x.numel(), x.element_size()))
    print(f"[rng] D1 rows 5.. at batch0 5 bit for bit those rows of the whole launch; "
          f"batch0 {D1_HIGH_BATCH0} (counters past 2^32) identical to the plain version",
          flush=True)
    return out, worst


def b3_mask_probe(torch, A):
    """Phase 21 (b), the masks: each form's keep mask read out of B3 itself,
    f32 and bf16, at a batch0 past the flax counter's high word and on heads
    1-3 of 5. Forward: q = k = 0 (uniform p over the keys a -inf key bias
    leaves: D of them a launch, walking the T keys), v one-hot by key, so out
    is keep / (D keep_prob) or 0. Backward: dv = pd^T do / keep_prob with do
    one-hot by query (T <= D). Both must equal the plain versions' mask."""
    batch0, head0, n_total = B3_PROBE_KEY
    checked = 0
    for form, chunk in (("hash", 0),) + tuple(
            (f, B3_PROBE_CHUNK if c else 0) for f, c in B3_FORMS):
        kw = dict(n_heads=B3_PROBE[1], head0=head0, n_heads_total=n_total, form=form,
                  chunk=chunk)
        for dtype in (torch.float32, torch.bfloat16):
            B, N, T, D = B3_PROBE
            want = A._full_mask(B, N, T, B3_FORM_KEY, 0.1, batch0, "cuda", head0, n_total,
                                form, chunk)
            z = torch.zeros(B, T, N * D, device="cuda", dtype=dtype)
            v = torch.zeros(B, T, N, D, device="cuda")
            v[:, torch.arange(T), :, torch.arange(T) % D] = 1.0
            v = v.reshape(B, T, N * D).to(dtype)
            got = torch.zeros(B, N, T, T, dtype=torch.bool, device="cuda")
            for w0 in range(0, T, D):
                kb = torch.full((B, T), -math.inf, device="cuda")
                kb[:, w0:w0 + D] = 0.0
                out, _ = A.flash_attention_fwd(z, z, v, 1.0, 0.1, B3_FORM_KEY, kb, batch0, **kw)
                w = min(D, T - w0)
                got[..., w0:w0 + w] = (out.float().reshape(B, T, N, D).permute(0, 2, 1, 3)
                                       > 0)[..., :w]
            B, N, T, D = B3_PROBE_BWD
            want_b = A._full_mask(B, N, T, B3_FORM_KEY, 0.1, batch0, "cuda", head0, n_total,
                                  form, chunk)
            z = torch.zeros(B, T, N * D, device="cuda", dtype=dtype)
            do = torch.zeros(B, T, N, D, device="cuda")
            do[:, torch.arange(T), :, torch.arange(T)] = 1.0
            do = do.reshape(B, T, N * D).to(dtype)
            o, lse = A.flash_attention_ref(z, z, z, 1.0, 0.1, B3_FORM_KEY, None, batch0, **kw)
            _, _, dv = A.flash_attention_bwd(z, z, z, o, lse, do, 1.0, 0.1, B3_FORM_KEY, None,
                                             batch0, **kw)
            got_b = (dv.float().reshape(B, T, N, D).permute(0, 2, 3, 1)[:, :, :T] > 0)
            torch.cuda.synchronize()
            same = (torch.equal(got, want), torch.equal(got_b, want_b))
            if not all(same):
                raise AssertionError(f"B3's {form} mask (chunk {chunk}, {dtype}) differs from "
                                     f"the plain version's: forward, backward {same}")
            checked += 1
    print(f"[rng] B3's masks read out of the kernels ({checked} form x dtype cases: hash, "
          f"flax, hidden hash, flax and hidden hash in chunks of {B3_PROBE_CHUNK}; f32 and "
          f"bf16; forward {B3_PROBE}, backward {B3_PROBE_BWD}; batch0 {batch0}, heads "
          f"{head0}-{head0 + B3_PROBE[1] - 1} of {n_total}): identical to the plain versions'",
          flush=True)


def b3_form_checks(torch, A):
    """Phase 21 (b), the values: each form against its plain version, f32 at B=6
    under phase 3's B3_TOL and bf16 at B=64 under phase 12's limits, forward
    and backward, with the hash form's time beside each. Returns ({(dtype,
    form, chunk): (fwd ms, bwd ms, plain fwd ms, plain bwd ms)}, worst
    absolute errors (fwd, bwd))."""
    times, worst = {}, [0.0, 0.0]
    for tag, (B, T, N, D) in B3_FORM_SHAPES.items():
        dtype = torch.float32 if tag == "f32" else torch.bfloat16
        g = torch.Generator().manual_seed(SEED + B)
        qkv = torch.randn(B, T, 3 * N * D, generator=g).cuda().to(dtype)
        q, k, v = qkv.split(N * D, dim=-1)
        dout = torch.randn(B, T, N * D, generator=g).cuda().to(dtype)
        for form, chunk in (("hash", 0),) + B3_FORMS:
            kw = dict(n_heads=N, form=form, chunk=chunk)
            args = (D ** -0.5, 0.1, B3_FORM_KEY, None, 3)
            out, lse = A.flash_attention_fwd(q, k, v, *args, **kw)
            grads = A.flash_attention_bwd(q, k, v, out, lse, dout, *args, **kw)
            t_fwd = cuda_ms(torch, lambda: A.flash_attention_fwd(q, k, v, *args, **kw), 5)
            t_bwd = cuda_ms(torch, lambda: A.flash_attention_bwd(q, k, v, out, lse, dout,
                                                                 *args, **kw), 5)
            if form == "hash":
                times[(tag, form, chunk)] = (t_fwd, t_bwd, None, None)
                continue
            t0 = time.perf_counter()
            ref_out, ref_lse = A.flash_attention_ref(q, k, v, *args, **kw)
            torch.cuda.synchronize()
            p_fwd = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            ref_grads = A.flash_attention_bwd_ref(q, k, v, out, lse, dout, *args, **kw)
            torch.cuda.synchronize()
            p_bwd = (time.perf_counter() - t0) * 1e3
            if tag == "f32":
                errs = {"out": rel_err(out, ref_out), "lse": rel_err(lse, ref_lse)}
                errs.update({n: rel_err(a, b)
                             for n, a, b in zip(("dq", "dk", "dv"), grads, ref_grads)})
                ok = all(e <= B3_TOL for e in errs.values())
                reading = (", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                           + f" (limit {B3_TOL:.0e})")
            else:
                out_ulps = float((out.float() - ref_out.float()).abs().max()) / bf16_ulp(ref_out)
                lse_err = float(((lse - ref_lse).abs() / ref_lse.abs().clamp_min(1e-30)).max())
                ulps = [float((a.float() - b.float()).abs().max()) / bf16_ulp(b)
                        for a, b in zip(grads, ref_grads)]
                same = [float((a == b).float().mean()) for a, b in zip(grads, ref_grads)]
                ok = (out_ulps <= B3_BF16_OUT_ULPS and lse_err <= B3_BF16_LSE_TOL
                      and max(ulps) <= B3_BF16_GRAD_ULPS and min(same) >= B3_BF16_GRAD_SAME)
                reading = (f"out {out_ulps:.2f} ulp, lse {lse_err:.2e}, dq/dk/dv "
                           + "/".join(f"{u:.2f}" for u in ulps) + " ulp, identical "
                           + "/".join(f"{s_:.4f}" for s_ in same)
                           + f" (limits {B3_BF16_OUT_ULPS:.0f}, {B3_BF16_LSE_TOL:.0e}, "
                           f"{B3_BF16_GRAD_ULPS:.0f}, {B3_BF16_GRAD_SAME})")
            times[(tag, form, chunk)] = (t_fwd, t_bwd, p_fwd, p_bwd)
            h_fwd, h_bwd = times[(tag, "hash", 0)][:2]
            print(f"[rng] B3 {tag} {form} mask{f' in chunks of {chunk}' if chunk else ''} "
                  f"B={B} T={T} N={N} D={D} rate 0.1 against its plain version: {reading}; ms "
                  f"fwd {t_fwd:.3f} / bwd {t_bwd:.3f} (hash form {h_fwd:.3f} / {h_bwd:.3f})",
                  flush=True)
            if not ok:
                raise AssertionError(f"B3's {form} form (chunk {chunk}, {tag}) disagrees with "
                                     f"its plain version: {reading}")
            worst[0] = max(worst[0], float((out.float() - ref_out.float()).abs().max()))
            worst[1] = max([worst[1]] + [float((a.float() - b.float()).abs().max())
                                         for a, b in zip(grads, ref_grads)])
            del ref_out, ref_lse, ref_grads
        del qkv, q, k, v, dout, out, lse, grads
        torch.cuda.empty_cache()
    return times, tuple(worst)


def default_step_checks(torch, R, A, prng, card):
    """Phase 21 (c): the port's default dropout-live Mockingjay step (no
    dropout variable set: flax masks by D1 at the 13 hidden sites, B3's flax
    form on the explicit path's probabilities) at full width, 3 steps on the
    card against the same 3 on the CPU from the same seed and key chain, with
    the launches of D1 and B3 a step; (d) the step's time beside the flash +
    hash route's at B=6 f32 and B=64 bf16. Returns the readings."""
    from speech_enhancement_by_s3prl_tpu_torch.entry import build_mockingjay_train

    counted = (R.threefry_dropout_kernel, A.flash_attention_fwd, A.flash_attention_bwd,
               A.flash_attention_fwd_bf16, A.flash_attention_bwd_bf16)
    weights = build_mockingjay_train(device="cpu", generator=torch.Generator().manual_seed(
        SEED)).model.state_dict()
    batches = [train_batch(DEFAULT_SECONDS, DEFAULT_ROWS, 40 + k) for k in range(DEFAULT_STEPS)]
    lengths = np.full(DEFAULT_ROWS, int(DEFAULT_SECONDS * SR), dtype=np.int64)
    sides = {}
    with dropout_env({}):
        for device in ("cuda", "cpu"):
            builder = build_mockingjay_train(device=device, seed=SEED)
            builder.model.load_state_dict(weights)
            state, chain, stats, counts = builder.init_state(), prng.PRNGKey(SEED), [], []
            for wavs in batches:
                chain, key = prng.split(chain)
                # -- the main path of D1 and B3's flax form, one step --
                reset_counts(counted)
                state, st = builder.train_step(state, torch.from_numpy(wavs).to(device),
                                               torch.from_numpy(lengths).to(device), rng=key)
                counts.append([fn.launches for fn in counted])
                # -------------------------------------------------------
                stats.append((float(st["loss"]), float(st["grad_norm"])))
            flat = torch.cat([p.detach().reshape(-1).double().cpu()
                              for p in state.params.values()])
            sides[device] = (stats, flat, counts)
    (g_stats, g_flat, g_counts), (c_stats, c_flat, _) = sides["cuda"], sides["cpu"]
    L = MJ_LAYERS
    want = [2 * (1 + 2 * L), L, L, 0, 0]
    loss_rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(g_stats, c_stats))
    norm_rel = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(g_stats, c_stats))
    upd = float((g_flat - c_flat).norm() / (c_flat - torch.cat(
        [w.reshape(-1).double() for w in weights.values()])).norm())
    print(f"[rng] the default dropout-live Mockingjay step (no variable set: flax masks, "
          f"B3's flax form on the explicit path) at full width, {DEFAULT_STEPS} steps of "
          f"{DEFAULT_ROWS} x {DEFAULT_SECONDS:.0f} s from seed {SEED}, card against CPU: loss "
          f"rel {loss_rel:.3e}, grad norm rel {norm_rel:.3e} (limit {TRAIN_LOSS_TOL:.0e}), "
          f"update rel {upd:.3e} (limit {TRAIN_GRAD_TOL:.0e}); launches a step (D1, B3 fwd, B3 "
          f"bwd, B3 fwd bf16, B3 bwd bf16) {g_counts}", flush=True)
    if not (loss_rel <= TRAIN_LOSS_TOL and norm_rel <= TRAIN_LOSS_TOL and upd <= TRAIN_GRAD_TOL
            and all(c == want for c in g_counts)):
        raise AssertionError(f"the default dropout step: loss {loss_rel}, norm {norm_rel}, "
                             f"update {upd}, launches {g_counts} (want {want} a step)")

    step_ms = {}
    for rows, dt in ROUTE_TIMES:
        wavs = torch.from_numpy(train_batch(10.0, rows, 60)).cuda()
        lens = torch.full((rows,), 10 * SR, dtype=torch.int64, device="cuda")
        builder = build_mockingjay_train(compute_dtype=dt, device="cuda", seed=SEED)
        builder.model.load_state_dict(weights)
        state = builder.init_state()
        for name, routes in (("default", {}), ("flash+hash", HASH_ROUTES),
                             ("default again", {}), ("flash+hash again", HASH_ROUTES)):
            with dropout_env(routes):
                step_ms[(rows, dt, name)] = statistics.median(synced_ms(
                    torch, lambda: builder.train_step(state, wavs, lens)[1]["loss"].item(), 3))
        del builder, state, wavs
        torch.cuda.empty_cache()
    print(f"[rng] Mockingjay train step ms at 10 s, default route against flash + hash "
          f"(in turns): " + ", ".join(
              f"B={r} {dt} {step_ms[(r, dt, 'default')]:.2f} / "
              f"{step_ms[(r, dt, 'flash+hash')]:.2f} (again {step_ms[(r, dt, 'default again')]:.2f}"
              f" / {step_ms[(r, dt, 'flash+hash again')]:.2f})" for r, dt in ROUTE_TIMES)
          + f" | {card}", flush=True)
    return {"loss_rel": loss_rel, "norm_rel": norm_rel, "update_rel": upd,
            "launches": g_counts, "step_ms": step_ms}


def random_streams_phase(torch, card):
    """Phase 21: JAX's random streams on the card (the module docstring)."""
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import attention_kernel as A
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import dropout_kernel as R
    from speech_enhancement_by_s3prl_tpu_torch.utils import prng

    t0 = time.perf_counter()
    d1_times, d1_err = d1_checks(torch, R, prng)
    b3_mask_probe(torch, A)
    form_times, form_err = b3_form_checks(torch, A)
    step = default_step_checks(torch, R, A, prng, card)
    seconds = time.perf_counter() - t0
    print(f"[rng] D1 ms / plain / bound "
          + ", ".join(f"{dt} {v[0]:.4f} / {v[1]:.3f} / {v[2][0]:.4f} ({v[2][1]})"
                      for dt, v in d1_times.items())
          + f" at {D1_SHAPE}; phase {seconds:.1f} s | {card}", flush=True)
    return {"d1": d1_times, "d1_err": d1_err, "forms": form_times, "form_err": form_err,
            "step": step, "seconds": seconds}


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, ROOT)
    # phases 1-20 drive the flash + hash dropout routes they were written for
    # (the JAX bench's; their subprocesses inherit them); phase 21 drives the
    # port's default routes, JAX's own
    os.environ.update(HASH_ROUTES)
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

    phase_done(2)

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

    phase_done(3)

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

    phase_done(4)

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

    phase_done(6)

    # 7. times on the card
    times = {}
    for B in (1, 64):
        xw, w_hh_t = kernel_inputs(torch, B, 1001, 256, SEED)
        # the plain versions (~0.2 s a call) once a turn (once 3)
        plain = cuda_ms(torch, lambda: lstm_bidir_tm_ref(xw, w_hh_t), iters=1)
        kern = cuda_ms(torch, lambda: lstm_bidir_tm(xw, w_hh_t), iters=20)
        kern2 = cuda_ms(torch, lambda: lstm_bidir_tm(xw, w_hh_t), iters=20)
        plain2 = cuda_ms(torch, lambda: lstm_bidir_tm_ref(xw, w_hh_t), iters=1)
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
            # the plain versions (0.2-0.6 s a call) once a turn (once 2)
            plain = cuda_ms(torch, plain_fn, iters=1)
            kern = cuda_ms(torch, kern_fn, iters=10)
            kern2 = cuda_ms(torch, kern_fn, iters=10)
            plain2 = cuda_ms(torch, plain_fn, iters=1)
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

    phase_done(7)

    # 8. the scoreboard metrics on the card
    from speech_enhancement_by_s3prl_tpu_torch import metrics as M

    metric_nums = metrics_phase(torch, M, kernels, all_kernels, (stft_fused, decode_ola), card)

    phase_done(8)

    # 9. the perceptual objectives and media logging on the card
    with tempfile.TemporaryDirectory() as tmp:
        obj_nums = objectives_phase(torch, kernels, all_kernels, (stft_fused, decode_ola), card,
                                    tmp)
    vcb_counts = obj_nums["vcb_counts"]

    phase_done(9)

    # 10. the serving front end on the card
    with tempfile.TemporaryDirectory() as tmp:
        front = front_end_phase(torch, L, all_kernels, (stft_fused, decode_ola), card, tmp)

    phase_done(10)

    # 11. the active-learning sampler on the card
    with tempfile.TemporaryDirectory() as tmp:
        active = active_phase(torch, all_kernels, card, tmp)
    active_counts = active["counts"]

    phase_done(11)

    # 12. bf16 compute on the card
    bf16_kernels = (A.flash_attention_fwd_bf16, A.flash_attention_bwd_bf16)
    with tempfile.TemporaryDirectory() as tmp:
        bf16 = bf16_phase(torch, A, kernels + flash_kernels + bf16_kernels, card, tmp)
    bf16_times_ = bf16["times"]

    phase_done(12)

    # 13. the one-direction LSTM in bf16 on the card
    counted13 = (lstm_bidir_tm, lstm_bidir_tm_fc, lstm_bidir_tm_bwd, L.lstm_bidir_tm_dw_bf16,
                 stft_fused, decode_ola)
    with tempfile.TemporaryDirectory() as tmp:
        one_dir = one_direction_bf16_phase(torch, L, counted13, (stft_fused, decode_ola), card,
                                           tmp)

    phase_done(13)

    # 14. the bf16 stream forms of B1 / B2 fwd / B2 bwd on the card
    streams = stream_forms_phase(torch, L, (stft_fused, decode_ola), card)

    phase_done(14)

    # 15. upstream pretraining, its export and the experiment on the card
    with tempfile.TemporaryDirectory() as tmp:
        pretrain = pretrain_phase(torch, kernels + flash_kernels + (stft_fused, decode_ola),
                                  card, tmp)

    phase_done(15)

    # 16. the exported serving program on the card
    with tempfile.TemporaryDirectory() as tmp:
        artifact = artifact_phase(torch, all_kernels + bf16_kernels + (L.lstm_bidir_tm_dw_bf16,),
                                  card, tmp)

    phase_done(16)

    # 17. data parallelism on the card
    with tempfile.TemporaryDirectory() as tmp:
        dp = data_parallel_phase(torch, card, tmp)

    phase_done(17)

    # 18. tensor, pipeline and sequence parallelism on the card
    with tempfile.TemporaryDirectory() as tmp:
        mp_phase = model_parallel_phase(torch, card, tmp)

    phase_done(18)

    # 19. the step tracer on the card
    with tempfile.TemporaryDirectory() as tmp:
        profile = profile_phase(torch, card, tmp)
    phase_done(19)

    # 20. the benchmark harness and its cost model on the card
    bench_run = bench_phase(torch, card)
    phase_done(20)

    # 21. JAX's random streams on the card: D1, B3's mask forms, the default
    # dropout-live step
    jax_streams = random_streams_phase(torch, card)
    phase_done(21)

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

    padded = bf16["checks"]["padded"]["times"]

    def padded_fields(key):
        """B3 at head widths 16, 48, 192 and 256 (B=6, T=1001, rate 0.1;
        zero-padded to 32, 64, 256 and 256): time, plain time, the bound of
        the true work and of the padded work; at 192 and 256 SDPA's time at
        rate 0 (forward, or its backward) as the library call."""
        sdpa = {(f"{'fwd' if f == 0 else 'bwd'}{'_bf16' if b else ''}"): 2 * b + f
                for b in (0, 1) for f in (0, 1)}
        fields = {f"{field}_d{D}": val for D in (16, 48) + B3_WIDE for field, val in zip(
            ("ms", "plain_ms", "bound_ms", "bound_ms_padded_work"),
            (padded[(key, D)][0], padded[(key, D)][1], padded[(key, D)][2][0],
             padded[(key, D)][3][0]))}
        fields.update({f"library_ms_d{D}": padded[("sdpa", D)][sdpa[key]] for D in B3_WIDE})
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
            launches_vcb_pmsqe_run=vcb_counts[0], launches_active_run=active_counts[0],
            launches_one_direction=one_dir_launches, one_direction_enhance_ms=one_dir_ms,
            launches_stream=front["stream_launches"],
            launches_http_stream=front["http_stream_launches"],
            launches_http_enhance_workers4=front["enhance_launches"],
            carried_state_max_abs_err=front["state_err"], ms_t48=front["t48_ms"],
            ms_t48_carried_state=front["t48_state_ms"], plain_ms_t48=front["t48_plain_ms"],
            bound_ms_t48_carried_state=carried_bound(1, STREAM_FRAMES, H)[0],
            stream_chunk_model_step_ms=front["stream_step_ms"],
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
            launches_vcb_pmsqe_run=vcb_counts[1], launches_active_run=active_counts[1],
            bound_ms_b1=lstm_bound(1, T, H, extra_streams=1)[0],
            max_rel_err_cs=fwd_routes["cluster"][1], **fwd_route_fields("fc_")),
        row("lstm_bidir_tm_bwd", "lstm_tm_bwd.cu", "lstm_kernel.py:422", train_counts[2],
            b2_err["bwd_abs"], times[("bwd", 6)][0], times[("bwd", 6)][1],
            "B=6 T=1001 H=256",
            lstm_bound(6, T, H, products=3, extra_streams=3, peak=PEAK_TF32),
            times[("cudnn_train", 6)][1], max_rel_err=b2_err["bwd"],
            launches_vcb_pmsqe_run=vcb_counts[2], launches_active_run=active_counts[2],
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
            rate0_ms=times[("b3sdpa", 6)][0], rate0_ms_b64=times[("b3sdpa", 64)][0],
            **padded_fields("fwd")),
        row("flash_attention_bwd", "flash_attn_bwd.cu", "attention_kernel.py:314",
            mj_launches[1], b3_err[1], times[("b3bwd", 6)][0], times[("b3bwd", 6)][1],
            "B=6 T=1001 N=12 D=64 rate 0.1", attention_bound(6, T, 12, 64, 5),
            times[("b3sdpa_bwd", 6)][1], ms_b64=times[("b3bwd", 64)][0],
            plain_ms_b64=times[("b3bwd", 64)][1],
            bound_ms_b64=attention_bound(64, T, 12, 64, 5)[0],
            library_ms_b64=times[("b3sdpa_bwd", 64)][1],
            rate0_ms=times[("b3sdpa_bwd", 6)][0], rate0_ms_b64=times[("b3sdpa_bwd", 64)][0],
            **padded_fields("bwd")),
    ]
    # B3 bf16 (phase 12): one bf16 tensor-core pass a product; beside it the
    # f32 kernel's time at the same shape, SDPA bf16 at rate 0 (forward, or
    # its backward) as the library call, the kernel's own time at rate 0, and
    # the CUDA-core floor of its exponentials and hash
    for name, source, replaces, products, err, launches in (
            ("flash_attention_fwd_bf16", "flash_attn.cu", "attention_kernel.py:277", 2,
             bf16["checks"]["fwd"], bf16["launches"][0]),
            ("flash_attention_bwd_bf16", "flash_attn_bwd.cu", "attention_kernel.py:314", 5,
             bf16["checks"]["bwd"], bf16["launches"][1])):
        key, lib = ("fwd", 0) if products == 2 else ("bwd", 1)
        rows.append(row(
            name, source, replaces, launches, err, bf16_times_[(key, 6)][0],
            bf16_times_[(key, 6)][2], "B=6 T=1001 N=12 D=64 rate 0.1 bf16",
            attention_bound_bf16(6, T, 12, 64, products), bf16_times_[("sdpa", 6)][lib],
            f32_kernel_ms=bf16_times_[(key, 6)][1], ms_b64=bf16_times_[(key, 64)][0],
            f32_kernel_ms_b64=bf16_times_[(key, 64)][1],
            plain_ms_b64=bf16_times_[(key, 64)][2],
            bound_ms_b64=attention_bound_bf16(64, T, 12, 64, products)[0],
            library_ms_b64=bf16_times_[("sdpa", 64)][lib],
            rate0_ms=bf16_times_[(key, 6)][3], rate0_ms_b64=bf16_times_[(key, 64)][3],
            core_floor_ms=attention_core_floor_bf16(6, T, 12, lib + 1)[0],
            core_floor_ms_b64=attention_core_floor_bf16(64, T, 12, lib + 1)[0],
            max_ulps=bf16["checks"]["out_ulps" if products == 2 else "grad_ulps"],
            **padded_fields(f"{key}_bf16")))
    # B3's mask forms (phase 21): each form's time at B=6 f32 and B=64 bf16,
    # beside the hash form's in the same call, its plain version's time, and
    # B3's launches in the default dropout-live step (the flax form)
    step_launches = jax_streams["step"]["launches"]
    for r in rows:
        if r["name"].startswith("flash_attention_"):
            tag = "bf16" if r["name"].endswith("_bf16") else "f32"
            at = 0 if "_fwd" in r["name"] else 1
            b = B3_FORM_SHAPES[tag][0]
            for (t, form, chunk), v in jax_streams["forms"].items():
                if t != tag:
                    continue
                name = form + (f"_chunk{chunk}" if chunk else "")
                r[f"form_{name}_ms_b{b}"] = v[at]
                if v[2] is not None:
                    r[f"form_{name}_plain_ms_b{b}"] = v[2 + at]
            r["forms_max_abs_err"] = jax_streams["form_err"][at]
            if tag == "f32":
                r["launches_default_dropout_step"] = sum(c[1 + at] for c in step_launches)
    # D1 (phase 21): flax nn.Dropout's threefry mask; no Pallas kernel computes
    # it (JAX leaves it to XLA), and no PyTorch call draws JAX's mask
    d1 = jax_streams["d1"]
    rows.append({
        "name": "threefry_dropout_kernel", "route": "cuda",
        "source": csrc + "threefry_dropout.cu",
        "replaces": "none (no Pallas counterpart: XLA computes flax nn.Dropout, "
                    "speech_enhancement_by_s3prl_tpu/models/transformer.py:176)",
        "launches": sum(c[0] for c in step_launches), "max_abs_err": jax_streams["d1_err"],
        "ms": d1["float32"][0], "plain_ms": d1["float32"][1], "bound_ms": d1["float32"][2][0],
        "bound_by": d1["float32"][2][1], "library_ms": None,
        "shape": f"{D1_SHAPE} f32, rate {D1_RATE}", "kernel_route": "one design",
        "launches_per_default_step": step_launches[0][0], "ms_bf16": d1["bfloat16"][0],
        "plain_ms_bf16": d1["bfloat16"][1], "bound_ms_bf16": d1["bfloat16"][2][0],
        "bound_by_bf16": d1["bfloat16"][2][1],
        "default_step_ms_vs_flash_hash": {f"B={r_} {dt} {name}": v for (r_, dt, name), v
                                          in jax_streams["step"]["step_ms"].items()}})

    # B4 at 1 / 12 / 64 rows of 10 s: the FFT kernel (its route at n_fft 400),
    # with the product kernel's times at the same shapes beside it
    dsp_shape = "1 row of 10 s (1001 frames), n_fft 400, hop 160"
    rows.append(row(
        "stft_fused", "stft_fft.cu", "stft_kernel.py:70", dsp_launches[0], dsp_err[0],
        times[("stft_fused", 1)][0], times[("stft_fused", 1)][1], dsp_shape,
        stft_bound(1, 1001, 400, 160), times[("torch_stft", 1)],
        launches_train_eval=train_dsp[0], launches_long_form=long_counts[0],
        launches_metrics_eval=metric_nums["launches"][1],
        launches_vcb_pmsqe_run=vcb_counts[3], launches_media_step=obj_nums["media_b4"],
        launches_active_run=active_counts[3],
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
        launches_vcb_pmsqe_run=vcb_counts[4], launches_active_run=active_counts[4],
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
    # the bf16-h forms and the bf16 dW_hh^T kernel (phase 13), one direction
    # at T=1001, H=256, bound as bf16_h_bound counts them; no PyTorch call
    # computes this function (cuDNN's bf16 LSTM rounds the gates, c and the
    # output too, and sums dW_hh in f32), so library_ms is null
    ht, hc = one_dir["times"], one_dir["checks"]
    step_counts, serving = one_dir["step"]["step_launches"], one_dir["serving"]
    for name, key, source, replaces, B, launches, err, more in (
            ("lstm_bidir_tm[h_bf16]", "b1", "lstm_tm_cluster.cu", "lstm_kernel.py:208", 1,
             serving["served_forms"], hc["b1"],
             {"launches_stream": serving["stream_counts"][2],
              "launches_vcb_bf16_run": one_dir["run_counts"][0]}),
            ("lstm_bidir_tm_fc[h_bf16]", "fc", "lstm_tm_cluster.cu", "lstm_kernel.py:391", 6,
             step_counts[1], hc["fc"], {"launches_vcb_bf16_run": one_dir["run_counts"][1]}),
            ("lstm_bidir_tm_bwd[h_bf16]", "bwd", "lstm_tm_bwd.cu", "lstm_kernel.py:422", 6,
             step_counts[2], hc["bwd"], {"launches_vcb_bf16_run": one_dir["run_counts"][2],
                                         "dw_within_one_ulp_share": hc["dw"]}),
            ("lstm_bidir_tm_dw_bf16", "dw", "lstm_dw_bf16.cu", "lstm_kernel.py:422", 6,
             step_counts[3], hc["dw_kernel_abs"],
             {"launches_vcb_bf16_run": one_dir["run_counts"][3],
              "within_one_ulp_share": hc["dw_kernel"],
              "identical_share": hc["dw_kernel_identical"],
              "bound_ms_first_design": dw_first_bound(6, T, H)[0],
              "bound_ms_first_design_b1": dw_first_bound(1, T, H)[0],
              **{f"{key}_b{Bc}": val for Bc in (BF16H_CHUNKED_ROWS, 352)
                 for key, val in (("ms", ht[("dw", Bc)][0]), ("plain_ms", ht[("dw", Bc)][2]),
                                  ("bound_ms", bf16_h_bound(Bc, T, H, "dw")[0]),
                                  ("row_chunks", L.dw_bf16_chunks(Bc)),
                                  ("within_one_ulp_share", hc[f"dw_kernel_b{Bc}"][0]),
                                  ("within_one_ulp_share_exact_steps",
                                   hc[f"dw_kernel_b{Bc}"][2]),
                                  ("exact_steps_within_one_ulp_share_plain",
                                   hc[f"dw_kernel_b{Bc}"][4]),
                                  ("identical_share_model", hc[f"dw_kernel_b{Bc}"][7]))},
              **{f"within_one_ulp_share_b{Bc}": hc[f"dw_kernel_b{Bc}"][0] for Bc in (272, 1024)},
              "launches_head_b137": hc["chunked_head"]["launches"][4],
              "replaces_note": "no Pallas kernel of its own: the dW_hh^T of B2 bwd's bf16-h "
                               "form, which JAX sums in its reverse lax.scan"})):
        one_b = ht.get((key, 1))
        rows.append(row(
            name, source, replaces, launches, err, ht[(key, B)][0], ht[(key, B)][2],
            f"ndir=1 B={B} T=1001 H=256, W_hh^T bf16 values", bf16_h_bound(B, T, H, key), None,
            f32_form_ms=ht[(key, B)][1],
            kernel_route=("cluster / phases (H a multiple of 8, at most 256); grid for any "
                          "other H" if key != "dw" else "one design, any H: wgmma products "
                          "of the three-way bf16 split of da, a bf16x2 carry"),
            **({} if one_b is None or B == 1 else {
                "ms_b1": one_b[0], "f32_form_ms_b1": one_b[1], "plain_ms_b1": one_b[2],
                "bound_ms_b1": bf16_h_bound(1, T, H, key)[0]}), **more))
    # the bf16 stream forms (phase 14) at the flagship shape (2, B, 1001, 256):
    # each row times the JAX bench mode's form (B1: bf16 xw and hs, the
    # enhance mode; B2 fwd / bwd: bf16 xw and residuals, the train mode), the
    # other forms and the f32 form beside it, bound as stream_bound counts the
    # bytes the form moves; no PyTorch call computes these functions (cuDNN's
    # bf16 LSTM rounds the gates, c and h), so library_ms is null
    st_t, st_c = streams["times"], streams["checks"]
    for name, key, source, replaces, B, launches, more in (
            ("lstm_bidir_tm[streams]", "b1", "lstm_tm_cluster.cu", "lstm_kernel.py:208", 1,
             streams["serve"]["launches"][1],
             {"launches_vcb_xw_served": streams["vcb"]["f32"]["launches"]["served"][1],
              "launches_vcb_xw_stream": streams["vcb"]["f32"]["launches"]["stream"][2],
              "enhance_ms": streams["serve"]["ms"]["streams"],
              "enhance_ms_f32": streams["serve"]["ms"]["f32"]}),
            ("lstm_bidir_tm_fc[streams]", "fc", "lstm_tm_cluster.cu", "lstm_kernel.py:391", 6,
             streams["step"]["launches"][5],
             {"train_step_ms": streams["step"]["ms"]["streams"],
              "train_step_ms_f32": streams["step"]["ms"]["f32"],
              "loss_grad_mib_kept_fwd_peak_bwd_peak": streams["step"]["mib"]["streams"],
              "loss_grad_mib_kept_fwd_peak_bwd_peak_f32": streams["step"]["mib"]["f32"]}),
            ("lstm_bidir_tm_bwd[streams]", "bwd", "lstm_tm_bwd.cu", "lstm_kernel.py:422", 6,
             streams["step"]["launches"][8],
             {"max_rms_dxw_residual_form": st_c["chain_rms"],
              "max_rms_dw_residual_form": st_c["dw_rms"]})):
        rows.append(row(
            name, source, replaces, launches, st_c["abs"][key], st_t[(key, "xw+out")][0],
            st_t[(key, "plain")], f"ndir=2 B={B} T=1001 H=256, xw and "
            + ("hs" if key == "b1" else "residuals") + " bf16", st_t[(key, "xw+out")][1], None,
            kernel_route=("cluster / phases (H a multiple of 8, at most 256); grid for any "
                          "other H"),
            **{f"{form.replace('+', '_').replace('out', 'hs' if key == 'b1' else 'res')}"
               f"_form_{field}": val for form in ("xw", "out", "f32")
               for field, val in (("ms", st_t[(key, form)][0]),
                                  ("bound_ms", st_t[(key, form)][1][0]))}, **more))
    # B1's forms of other functions (phase 14): the MXU, gates and MXU + gates
    # + bf16 hs forms at the flagship shape (B=1, and B=64) and the int8 form
    # at one direction (B=6), each beside the f32 form of the same launch and
    # its bound; the launches of each form on its main path (the served
    # flagship, vcb's head served and streamed); no PyTorch call computes
    # these functions either
    fm = streams["forms"]
    for r in rows:
        if r["name"] != "lstm_bidir_tm[streams]":
            continue
        for (ndir, B, form), val in fm["times"].items():
            if form == "plain":
                r[f"forms_plain_ms_ndir{ndir}_b{B}"] = val
                continue
            t, b = val
            tag = "forms_" + form.replace("+", "_") + ("" if (ndir, B) == (2, 1) else
                                                       f"_ndir{ndir}_b{B}")
            r[f"{tag}_ms"], r[f"{tag}_bound_ms"], r[f"{tag}_bound_by"] = t, b[0], b[1]
        for form, v in fm["serve"].items():
            key = form.replace("+", "_")
            r[f"launches_{key}_form_served"] = v["launches"][0]
            r[f"launches_{key}_form_enhance_mode_768"] = v["rows768"]["launches"][0]
            r[f"enhance_mode_768_ms_{key}_form"] = v["rows768"]["ms"]
            r[f"waveform_delta_{key}_form_card_cpu"] = list(v["delta"])
        r["launches_int8_form_vcb_served"] = fm["vcb"]["launches"]["served"][1]
        r["launches_int8_form_vcb_stream"] = fm["vcb"]["launches"]["stream"][2]
        fc = fm["checks"]
        r["max_abs_err_forms"] = fc["abs"]
        r["max_abs_err_int8_form"] = fc["int8_abs"]
        r["max_rms_share_mxu_form"] = list(fc["mxu"])
        r["max_rms_share_gates_form"] = list(fc["gates"])
    # phase 15's launches: pretraining (both channels) and the experiment
    pre_counts = [sum(c) for c in zip(*(p["counts"] for p in pretrain["pretrain"].values()))]
    for r in rows:
        k = {"lstm_bidir_tm": 0, "lstm_bidir_tm_fc": 1, "lstm_bidir_tm_bwd": 2,
             "flash_attention_fwd": 3, "flash_attention_bwd": 4, "stft_fused": 5,
             "decode_ola": 6}.get(r["name"])
        if k is not None:
            r["launches_pretrain_upstream"] = pre_counts[k]
            r["launches_experiment"] = pretrain["experiment"]["counts"][k]
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
    print(f"[objectives] card vs CPU (loss rel, gradient rel) "
          + ", ".join(f"{k} ({a:.2e}, {b:.2e})" for k, (a, b) in obj_nums["errs"].items())
          + f"; vcb run with pmsqe: launches (B1, B2 fwd, B2 bwd, B4, B5) {vcb_counts}, "
          f"{obj_nums['media_files']} media files; train step B=6 10 s pmsqe "
          f"{obj_nums['train_ms']['pmsqe']:.3f} ms, SISDR {obj_nums['train_ms']['SISDR']:.3f}; "
          f"eval batch 12 x 10 s stoi {obj_nums['eval_ms']['stoi']:.3f} ms, SISDR "
          f"{obj_nums['eval_ms']['SISDR']:.3f}; one media step {obj_nums['media_ms']:.3f} ms, "
          f"{obj_nums['media_b4']} B4 | {card}", flush=True)
    load = front["load"]
    print(f"[front] streamer: {front['stream_chunks']} chunks of {STREAM_FRAMES} frames, "
          f"model step {front['stream_step_ms']:.3f} ms a chunk, analysis "
          f"{front['stream_analysis_ms']:.3f} ms, card vs CPU {front['stream_vs_cpu']:.2e} and "
          f"vs offline {front['stream_vs_offline']:.2e} of the RMS, B1 with a carried state vs "
          f"plain {front['state_err']:.2e}, RTF {front['stream_rtf']:.4f} (over HTTP "
          f"{front['http_stream_rtf']:.4f}, first audio {front['first_byte_s'] * 1e3:.1f} ms); "
          f"/enhance 10 s over HTTP {front['http_ms']:.3f} ms vs {front['direct_ms']:.3f} "
          f"direct; load p50 / p99 ms "
          + ", ".join(f"{lv}: {r['p50_ms']:.1f} / {r['p99_ms']:.1f} ({r['aggregate_rtf']:.0f} s "
                      f"of audio a second)" for lv, r in load.items())
          + f" ({LOAD_TOTAL} requests a level); --fixed_batch byte-identical "
          f"{front['fixed_exact']} of {len(FRONT_SECONDS)} (under load: p99 "
          f"{front['load_fixed']['p99_ms']:.1f} ms at 16), "
          f"--workers 4 {front['bi4_exact']} of {len(FRONT_SECONDS)}; B1 T=48 "
          f"{front['t48_ms']:.4f} ms, with state {front['t48_state_ms']:.4f} | {card}",
          flush=True)
    busy = active["busy"]
    print(f"[active] config/active.yaml run: launches (B1, B2 fwd, B2 bwd, B4, B5) "
          f"{active_counts} in {active['steps']} sync-sampled steps; scoring card vs CPU "
          + ", ".join(f"{impl} layer {lid} ({e:.1e}, {m:.1e})"
                      for (impl, lid), (e, m, *_) in active["errs"].items())
          + " (embedding rel, match abs; with TF32 on "
          + ", ".join(f"({e:.1e}, {m:.1e})" for e, m, *_ in active["tf32_errs"].values())
          + f"); async collects {active['async_collected']}; "
          f"per-sample scoring 12 x 10 s vmap {active['score_ms']['vmap']:.3f} ms, capture "
          f"{active['score_ms']['capture']:.3f} ms, mean=True 32 rows "
          f"{active['mean_ms']:.3f} ms; train step B=6 {active['step_ms']['plain']:.3f} ms, "
          f"sync-sampled {active['step_ms']['sync']:.3f} ms (idle share "
          f"{max(0.0, 1 - busy['sync-sampled step'][0] / busy['sync-sampled step'][1]):.3f}) "
          f"| {card}", flush=True)
    bt = bf16_times_
    print(f"[bf16] B3 bf16 out <= {bf16['checks']['out_ulps']:.2f} ulp, dq/dk/dv <= "
          f"{bf16['checks']['grad_ulps']:.2f} ulp of their largest values; Mockingjay bf16 run "
          f"launches (B3 fwd bf16, B3 bwd bf16) {bf16['launches']}; windows Mockingjay step "
          f"loss {bf16['mj_window']['loss'][0]:.3f}/{bf16['mj_window']['loss'][1]:.3f}, gradient "
          f"{bf16['mj_window']['grad'][0]:.3f}/{bf16['mj_window']['grad'][1]:.3f}, served "
          + ", ".join(f"{k} {a:.3f}/{b:.3f}" for k, (a, b) in bf16["served"].items())
          + f"; B=6 10 s train step ms bf16 / f32: Mockingjay {bt[('Mockingjay', 'bf16')]:.3f} / "
          f"{bt[('Mockingjay', 'f32')]:.3f}, flagship {bt[('flagship', 'bf16')]:.3f} / "
          f"{bt[('flagship', 'f32')]:.3f}; enhance B=1 10 s {bt[('enhance', 'bf16')]:.3f} / "
          f"{bt[('enhance', 'f32')]:.3f} | {card}", flush=True)
    st, sv = one_dir["step"], one_dir["serving"]
    print(f"[bf16h] the one-direction LSTM in bf16: forms against their plain versions hs <= "
          f"{hc['b1']:.2e}, dW_hh^T within one bf16 unit on >= {hc['dw']:.4f} (the kernel alone "
          f"{hc['dw_kernel']:.5f}, identical {hc['dw_kernel_identical']:.5f}); vcb.yaml bf16 run "
          f"launches (B1, B2 fwd, B2 bwd, dW_hh^T, "
          f"B4, B5) {one_dir['run_counts']}; train step card vs CPU window loss "
          f"{st['loss'][0]:.3f}/{st['loss'][1]:.3f}, gradient {st['grad'][0]:.3f}/"
          f"{st['grad'][1]:.3f}, each w_hh's near <= {st['w_hh_window'][0]:.3f} and ratio "
          f"{st['w_hh_window'][1]:.3f}-{st['w_hh_window'][2]:.3f} (within one unit >= "
          f"{st['w_hh_share']:.4f}); served "
          f"{sv['served'][0]:.3f}/{sv['served'][1]:.3f}, stream {sv['stream'][0]:.3f}/"
          f"{sv['stream'][1]:.3f}; scoring "
          + ", ".join(f"{n} {i} {w[0]:.3f}/{w[1]:.3f}"
                      for (n, i), (w, *_) in one_dir["scoring"].items())
          + f"; ms bf16 / f32: vcb train step B=6 10 s {st['step_ms']['bf16']:.3f} / "
          f"{st['step_ms']['f32']:.3f}, enhance B=1 10 s {sv['enhance_ms']['bf16']:.3f} / "
          f"{sv['enhance_ms']['f32']:.3f}, stream chunk {sv['chunk_ms']['bf16']:.3f} / "
          f"{sv['chunk_ms']['f32']:.3f} | {card}", flush=True)
    sv, ss, vx = streams["serve"], streams["step"], streams["vcb"]
    print(f"[streams] the bf16 stream forms: against their plain versions f32 streams <= "
          f"{st_c['h_abs']:.2e} (h) / {st_c['rel']:.2e} (of the largest), bf16 streams within one "
          f"bf16 unit on >= {st_c['ulp']:.5f}, identical >= {st_c['same']:.5f}, the residual "
          f"backward dxw RMS <= {st_c['chain_rms']:.2e}, dW_hh^T {st_c['dw_rms']:.2e}; flagship "
          f"enhance mode window {sv['window'][0]:.3f}/{sv['window'][1]:.3f}, train mode step "
          f"loss {ss['loss'][0]:.3f}/{ss['loss'][1]:.3f}, gradient {ss['grad'][0]:.3f}/"
          f"{ss['grad'][1]:.3f}; score mode match > 0 sets the CPU's "
          + ", ".join(f"{k} {v[0]}" for k, v in streams["score"].items())
          + "; vcb head xw form windows "
          + ", ".join(f"{dt} served {v['served'][0]:.3f}, stream {v['stream'][0]:.3f}, step "
                      f"{v['grad'][0]:.3f}" for dt, v in vx.items())
          + f"; ms form / f32: enhance B=1 {sv['ms']['streams']:.3f} / {sv['ms']['f32']:.3f}, "
          f"train step B=6 {ss['ms']['streams']:.3f} / {ss['ms']['f32']:.3f} | {card}",
          flush=True)
    fc, fv = fm["checks"], fm["vcb"]
    print(f"[forms] B1's forms of other functions: against their plain versions the MXU form "
          f"(max, RMS, within 1e-4) {' / '.join(f'{x:.3g}' for x in fc['mxu'])}, the gates form "
          f"{' / '.join(f'{x:.3g}' for x in fc['gates'])}, bf16 hs within one unit / identical "
          f">= {fc['ulp']:.5f} / {fc['same']:.5f}, int8 <= {fc['int8_abs']:.2e}; the served "
          f"flagship's windows "
          + ", ".join(f"{k} {v['window'][0]:.3f}/{v['window'][1]:.3f} (change against f32 card "
                      f"{v['delta'][0]:.3e}, CPU {v['delta'][1]:.3e}; 768 rows "
                      f"{v['rows768']['ms']:.2f} ms)" for k, v in fm["serve"].items())
          + f"; vcb head int8 windows served {fv['served'][0]:.3f}, stream {fv['stream'][0]:.3f},"
          f" step {fv['grad'][0]:.3f}; B1 ms (f32 form) at B=1 "
          + ", ".join(f"{f} {v[0]:.4f}" for (nd, B, f), v in fm["times"].items()
                      if B == 1 and f != "plain")
          + f" | {card}", flush=True)
    ps = pretrain["sides"]
    print(f"[pretrain] pretraining at config/pretrain_sample.yaml's width: launches (B1, B2 fwd, "
          f"B2 bwd, B3 fwd, B3 bwd, B4, B5) "
          + ", ".join(f"channel {c} {p['counts']}" for c, p in pretrain["pretrain"].items())
          + "; step card vs CPU (loss rel, gradient of its largest) "
          + ", ".join(f"channel {c} ({v['loss_rel']:.2e}, {v['grad_max']:.2e})"
                      for c, v in ps.items())
          + "; B=8 10 s step median / busy / idle "
          + ", ".join(f"channel {c} {v['ms']:.3f} / {v['busy']:.3f} ms / {v['idle']:.3f}"
                      for c, v in ps.items())
          + f"; experiment launches {pretrain['experiment']['counts']} in "
          f"{pretrain['experiment']['seconds']:.1f} s; phase {pretrain['seconds']:.1f} s | {card}",
          flush=True)
    # the artifact's device batches (phase 16): B1 3, B4 1, B5 1 a batch
    art_names = [fn.__name__ for fn in all_kernels + bf16_kernels + (L.lstm_bidir_tm_dw_bf16,)]
    for r in rows:
        if r["name"] in ("lstm_bidir_tm", "stft_fused", "decode_ola"):
            idx = art_names.index(r["name"])
            r["launches_artifact"] = sum(c[idx] for c in artifact["counts"].values())
            op = {"lstm_bidir_tm": "B1", "stft_fused": "B4", "decode_ola": "B5"}[r["name"]]
            for n in (1, 12):
                # the wrapper, the op alone, its CUDA implementation called directly
                r[f"ms_wrapper_op_direct_{n}_rows"] = artifact["dispatch"][(op, n)]
    # phase 17's launches: the mesh-1 run, both gloo ranks, mesh serving
    for r in rows:
        if r["name"] in dp["launches"]:
            r["launches_data_parallel"] = dp["launches"][r["name"]]
    # phase 18's launches: the mesh steps, the eval and the pipeline, every rank
    for r in rows:
        if r["name"] in mp_phase["launches"]:
            r["launches_model_parallel"] = mp_phase["launches"][r["name"]]
    # phase 19's launches: the --profile run, and each profiled mode's 3 calls
    run_names = ["lstm_bidir_tm", "lstm_bidir_tm_fc", "lstm_bidir_tm_bwd", "stft_fused",
                 "decode_ola"]
    ids = {fn.__name__: kid for kid, fn in kernel_wrappers().items()}
    b1_768, b2_352 = profile["b1_768"], profile["b2_352"]
    for r in rows:
        if r["name"] in run_names:
            r["launches_profile_run"] = profile["run"]["counts"][run_names.index(r["name"])]
        kid = ids.get(r["name"])
        if kid is not None:
            r["launches_profile_step"] = {label: c[kid] for label, c in
                                          profile["modes"]["launches"].items() if kid in c}
        if r["name"] == "lstm_bidir_tm":
            r["ms_b768_hs_bf16"] = sum(ms for ms, _ in b1_768[0].values())
            r["bound_ms_b768_hs_bf16"] = b1_768[1][0]
        elif r["name"] in ("lstm_bidir_tm_fc", "lstm_bidir_tm_bwd"):
            prefix = "lstm_tm_cluster" if r["name"].endswith("fc") else "lstm_bwd"
            r["ms_b352_res_bf16"] = sum(ms for k, (ms, _) in b2_352[0].items()
                                        if k.startswith(prefix))
            r["bound_ms_b352_res_bf16"] = (b2_352[1] if prefix == "lstm_tm_cluster"
                                           else b2_352[2])[0]
    # phase 20's launches a call in each bench mode's timed window
    for r in rows:
        kid = ids.get(r["name"])
        got = {mode: line["launches_per_call"][kid] for mode, line in bench_run["modes"].items()
               if kid in line.get("launches_per_call", {})}
        if got:
            r["launches_bench"] = got
    pm = profile["modes"]["ms"]
    print(f"[profile] the step tracer: --profile bit for bit, its trace's kernels "
          f"{profile['run']['by_id']}; device ms/step (wall under the profiler) at the JAX bench's "
          f"batches: " + ", ".join(f"{k} {d:.3f} ({w:.3f})" for k, (d, w) in pm.items())
          + f"; checks {profile['modes']['checks']}; probe records (bare, traced, pads) "
          f"{profile['records']}; phase {profile['seconds']:.1f} s | {card}",
          flush=True)
    am = artifact["ms"]
    print(f"[artifact] the exported flagship ({len(ARTIFACT_ROWS)} device batches of "
          f"{list(ARTIFACT_ROWS)} rows from one program) against the live enhancer "
          f"{artifact['worst']:.3e} of the RMS (bit for bit {artifact['identical']}), exported "
          f"on the CPU and moved {artifact['moved_err']} (move pass {artifact['can_move']}); "
          f"export {artifact['export_s']:.1f} s; B=1 4 s ms live {am['live']:.3f} / artifact "
          f"{am['artifact']:.3f}, live B=1 10 s {am['live_10s']:.3f}; phase "
          f"{artifact['seconds']:.1f} s | {card}", flush=True)
    one, sv = dp["one"], dp["serving"]
    print(f"[mesh] data parallelism: --mesh 1x1 over NCCL bit for bit the run without a mesh; "
          f"two gloo ranks vs one process (loss rel, grad norm rel, update rel) "
          + ", ".join(f"{k} ({v[0]:.2e}, {v[1]:.2e}, {v[2]:.2e})" for k, v in dp["worst"].items()
                      if k != "mockingjay")
          + f", Mockingjay (loss rel, gradient rel) ({dp['worst']['mockingjay'][0]:.2e}, "
          f"{dp['worst']['mockingjay'][1]:.2e}); eval (loss, scores) rel ({dp['eval'][0]:.2e}, "
          f"{dp['eval'][1]:.2e}); mesh serving max |diff| {sv['err']:.2e}; ms: flagship step "
          f"mesh 1x1 {one['step_ms']['mesh']:.3f} / no mesh {one['step_ms']['plain']:.3f}, "
          f"all-reduce {one['allreduce_ms']:.4f}, two gloo ranks (host-staged) "
          f"{dp['two_ms']['SISDR']:.3f}, 8-row group on two replicas {sv['ms']:.3f} / one "
          f"{sv['ms_one']:.3f}; phase {dp['seconds']:.1f} s | {card}", flush=True)
    mw = mp_phase["worst"]
    print(f"[model] model parallelism: B3 at head0 bit for bit the full launch's heads "
          f"(f32, bf16); (loss rel, grad norm rel, update rel) against one process "
          + ", ".join(f"{tag} {name} ({v[0]:.2e}, {v[1]:.2e}, {v[2]:.2e})"
                      for (tag, name), v in mw.items())
          + f"; 2x2 eval (loss, scores) rel ({mp_phase['eval'][0]:.2e}, "
          f"{mp_phase['eval'][1]:.2e}); pipeline {mp_phase['pipe_err']:.2e}; sequence "
          f"{mp_phase['seq_err']}; ms (gloo, host-staged): "
          + ", ".join(f"{tag} {v['flagship']:.3f} / {v['mockingjay']:.3f}"
                      for tag, v in mp_phase["times"].items())
          + f", one process {mp_phase['one']['flagship']:.3f} / "
          f"{mp_phase['one']['mockingjay']:.3f} (flagship / Mockingjay); phase "
          f"{mp_phase['seconds']:.1f} s | {card}", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
