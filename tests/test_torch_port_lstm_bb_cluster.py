"""The cluster design of the batch-blocked recurrence (kernel B6) and of the
recurrence with the projection inside (kernel B7) as PyTorch models, against
the plain versions and the JAX package.

``lstm_bidir_bb_model`` / ``lstm_bidir_fused_model`` run the algorithms of
the routes: B6 on B1's cluster kernel (``csrc/lstm_tm_cluster.cu``), each batch
block its own recurrence; B7 (``csrc/lstm_bb_cluster.cu``) with B1's step
product on FMAs (16 slices) and its projection a run of steps ahead, in chunks
of 32 inputs added in order. They are held against ``lstm_bidir_bb_ref`` /
``lstm_bidir_fused_ref`` and against the Pallas kernels ``lstm_bidir_pallas``
and ``lstm_bidir_pallas_fused`` run in interpret mode, on the same
numpy-seeded inputs. The route and batch-block pickers are pinned. The CUDA
kernels themselves are held against the plain versions on the card by
chip_smoke.py.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from speech_enhancement_by_s3prl_tpu.ops.pallas.lstm_kernel import (
    lstm_bidir_pallas,
    lstm_bidir_pallas_fused,
)
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L

# Against the plain versions: the same f32 cell, only the order of the sums
# in h @ W_hh^T and x @ W_ih^T differs (rounding near 1e-7 a step; the
# recurrence is contractive and T is short here).
MODEL_TOL = 1e-6
# Against the Pallas kernels in interpret mode (XLA's own sums and
# transcendentals), absolute: |h| <= 1.
PALLAS_TOL = 1e-5
# (B, T, H, D, batch block, run length): ragged B and D (D not a multiple of
# 8 or of the 32-input chunk), runs that do not divide T, batch blocks past B
CASES = [
    (1, 9, 32, 24, 2, 4),
    (13, 29, 64, 30, 5, 6),
    (9, 21, 64, 40, 32, 2),
]


@pytest.fixture(autouse=True)
def _f32_streams(monkeypatch):
    for knob in ("SE_PALLAS_HS_BF16", "SE_PALLAS_MXU_BF16", "SE_PALLAS_GATES_BF16"):
        monkeypatch.delenv(knob, raising=False)


def _inputs(B, T, H, D, seed):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((2, B, T, D)).astype(np.float32)
    w_ih_t = (rng.standard_normal((2, D, 4 * H)) / np.sqrt(D)).astype(np.float32)
    bias = (0.1 * rng.standard_normal((2, 4 * H))).astype(np.float32)
    w_hh_t = (rng.standard_normal((2, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    xw = (np.einsum("dbtk,dkg->dbtg", xs, w_ih_t) + bias[:, None, None, :]).astype(np.float32)
    return [torch.from_numpy(a) for a in (xs, w_ih_t, bias, w_hh_t, xw)]


def _err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    return float(np.abs(a - b).max())


@pytest.mark.parametrize("B,T,H,D,bb,run", CASES)
def test_models_match_plain_versions(B, T, H, D, bb, run):
    xs, w_ih_t, bias, w_hh_t, xw = _inputs(B, T, H, D, seed=B * 10 + T)
    hs = L.lstm_bidir_bb_model(xw, w_hh_t, batch_block=bb)
    assert hs.shape == (2, B, T, H) and hs.dtype == torch.float32
    assert _err(hs, L.lstm_bidir_bb_ref(xw, w_hh_t)) <= MODEL_TOL
    fused = L.lstm_bidir_fused_model(xs, w_ih_t, bias, w_hh_t, batch_block=bb, run=run)
    assert fused.shape == (2, B, T, H) and fused.dtype == torch.float32
    assert _err(fused, L.lstm_bidir_fused_ref(xs, w_ih_t, bias, w_hh_t)) <= MODEL_TOL


@pytest.mark.parametrize("B,T,H,D,bb,run", CASES)
def test_models_match_pallas_kernels_in_interpret_mode(B, T, H, D, bb, run):
    xs, w_ih_t, bias, w_hh_t, xw = _inputs(B, T, H, D, seed=B * 10 + T + 1)
    j_bb = np.asarray(lstm_bidir_pallas(jnp.asarray(xw.numpy()), jnp.asarray(w_hh_t.numpy()),
                                        chunk=8, batch_block=bb, interpret=True))
    j_fused = np.asarray(lstm_bidir_pallas_fused(
        *(jnp.asarray(t.numpy()) for t in (xs, w_ih_t, bias, w_hh_t)), chunk=8,
        batch_block=bb, interpret=True))
    hs = L.lstm_bidir_bb_model(xw, w_hh_t, batch_block=bb)
    fused = L.lstm_bidir_fused_model(xs, w_ih_t, bias, w_hh_t, batch_block=bb, run=run)
    assert _err(hs, j_bb) <= PALLAS_TOL
    assert _err(fused, j_fused) <= PALLAS_TOL


@pytest.mark.parametrize("B,T,H,D,bb,run", CASES)
def test_models_share_b1s_recurrence_bit_for_bit(B, T, H, D, bb, run):
    # B6 runs B1's cluster kernel, and B7's steps are B1's on its projection
    xs, w_ih_t, bias, w_hh_t, xw = _inputs(B, T, H, D, seed=B * 10 + T + 2)
    b1 = L.lstm_bidir_tm_fwd_model(xw, w_hh_t, batch_block=1)
    assert torch.equal(L.lstm_bidir_bb_model(xw, w_hh_t, batch_block=bb), b1)
    projected = L._projection_run(xs, w_ih_t, bias)
    assert torch.equal(L.lstm_bidir_fused_model(xs, w_ih_t, bias, w_hh_t, batch_block=bb,
                                                run=run),
                       L.lstm_bidir_tm_fwd_model(projected, w_hh_t, batch_block=1))


def test_b6_model_gives_identical_bits_for_every_batch_block():
    # a row's sums run in an order that its batch block does not enter
    _, _, _, w_hh_t, xw = _inputs(7, 11, 16, 37, seed=3)
    blocked = [L.lstm_bidir_bb_model(xw, w_hh_t, batch_block=bb) for bb in (1, 3, 16, 32)]
    assert all(torch.equal(blocked[0], h) for h in blocked[1:])


def test_b7_model_gives_identical_bits_for_every_batch_block_and_run():
    # nor does the run that projected its inputs
    xs, w_ih_t, bias, w_hh_t, _ = _inputs(7, 11, 16, 37, seed=3)
    fused = [L.lstm_bidir_fused_model(xs, w_ih_t, bias, w_hh_t, batch_block=bb, run=run)
             for bb, run in ((1, 1), (2, 4), (5, 3), (10, None), (32, 64))]
    assert all(torch.equal(fused[0], h) for h in fused[1:])


def test_models_leave_their_inputs_untouched_and_handle_empty_shapes():
    xs, w_ih_t, bias, w_hh_t, xw = _inputs(2, 4, 8, 5, seed=4)
    before = [t.clone() for t in (xs, w_ih_t, bias, w_hh_t, xw)]
    L.lstm_bidir_bb_model(xw, w_hh_t, batch_block=1)
    L.lstm_bidir_fused_model(xs, w_ih_t, bias, w_hh_t, batch_block=1, run=3)
    assert all(torch.equal(a, b) for a, b in zip(before, (xs, w_ih_t, bias, w_hh_t, xw)))
    assert L.lstm_bidir_bb_model(xw[:, :0], w_hh_t).shape == (2, 0, 4, 8)
    assert L.lstm_bidir_fused_model(xs[:, :, :0], w_ih_t, bias, w_hh_t).shape == (2, 2, 0, 8)


@pytest.mark.parametrize("hidden,inputs,route", [
    (256, 0, "cluster"), (256, 512, "cluster"), (8, 5, "cluster"), (64, 30, "cluster"),
    (248, 120, "cluster"), (264, 0, None), (260, 120, None), (36, 0, None), (4, 0, None),
])
def test_route_is_named_by_the_shape_alone(hidden, inputs, route):
    assert L.bb_route(hidden, inputs) == route


# B6's rows are B1's (``fwd_batch_block``) under the caller's bound; B7's cap
# is what its shared memory leaves beside the projection's buffers
@pytest.mark.parametrize("batch,batch_block,fused,rows", [
    (1, 32, False, 1), (6, 32, False, 1), (64, 32, False, 10), (64, 8, False, 8),
    (64, 32, True, 10), (256, 32, False, 16), (256, 32, True, 10), (256, 1, False, 1),
    (100, 32, True, 10), (100, 32, False, 15), (1000, 32, False, 16), (20, 32, True, 3),
])
def test_batch_block_spreads_the_rows_up_to_the_caps(batch, batch_block, fused, rows):
    assert L.bb_batch_block(batch, batch_block, 14, fused) == rows
    if not fused:
        assert rows == min(batch_block, L.fwd_batch_block(batch, 2, 14))
    cap = L.FUSED_MAX_ROWS if fused else L.FWD_MAX_BATCH_BLOCK
    if rows < min(batch_block, cap):  # all clusters at once
        assert 2 * -(-batch // rows) <= 14


@pytest.mark.parametrize("rows,run", [(1, 64), (2, 32), (5, 12), (7, 9), (10, 6), (3, 21)])
def test_run_fills_sixty_four_row_steps(rows, run):
    assert L.bb_run(rows) == run and rows * run <= L.RUN_PAIRS


def test_wrappers_run_the_plain_versions_on_the_cpu_and_count_nothing():
    xs, w_ih_t, bias, w_hh_t, xw = _inputs(3, 5, 8, 6, seed=6)
    counters = (L.lstm_bidir_bb, L.lstm_bidir_fused)
    before = [(fn.launches, dict(fn.by_route)) for fn in counters]
    assert torch.equal(L.lstm_bidir_bb(xw, w_hh_t, batch_block=2),
                       L.lstm_bidir_bb_ref(xw, w_hh_t))
    assert torch.equal(L.lstm_bidir_fused(xs, w_ih_t, bias, w_hh_t, batch_block=2),
                       L.lstm_bidir_fused_ref(xs, w_ih_t, bias, w_hh_t))
    assert [(fn.launches, dict(fn.by_route)) for fn in counters] == before
    assert all(set(fn.by_route) == {"cluster"} for fn in counters)
