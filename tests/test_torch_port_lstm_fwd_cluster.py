"""The forward recurrence's cluster design (kernels B1 and B2 fwd on the
``cluster`` route) as its PyTorch model, against the plain version and the
JAX package.

``lstm_bidir_tm_fwd_model`` runs the algorithm of ``csrc/lstm_tm_cluster.cu``:
each batch block its own recurrence, at every step the gates summed from
per-slice partial products in the kernel's order, then the cell row by row.
It is held against ``lstm_bidir_tm_ref`` / ``lstm_bidir_tm_fc_ref`` and
against the Pallas kernels ``lstm_bidir_pallas_tm`` and ``_tm_fwd_with_cell``
run in interpret mode, on the same numpy-seeded inputs. The route and
batch-block pickers are pinned. The CUDA kernel itself is held against the
plain version on the card by chip_smoke.py.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from speech_enhancement_by_s3prl_tpu.ops.pallas.lstm_kernel import (
    _tm_fwd_with_cell,
    lstm_bidir_pallas_tm,
)
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L

# Against the plain version: the same f32 cell, only the order of the H-term
# sums in h @ W_hh^T differs (rounding near 1e-7 a step; the recurrence is
# contractive and T is short here).
MODEL_TOL = 1e-6
# Against the Pallas kernels in interpret mode (XLA's own sums and
# transcendentals), each output relative to its largest |value|.
PALLAS_TOL = 1e-5
# (directions, B, T, H, batch block): T = 1, ragged last batch blocks, one and
# two directions, H = 8 (one slice), 24 and 40 (a slice cut by H)
CASES = [
    (2, 3, 1, 8, 2),
    (1, 5, 7, 24, 2),
    (2, 4, 9, 40, 3),
    (1, 2, 6, 8, 1),
    (2, 3, 5, 24, 16),
]
PALLAS_CASES = [CASES[0], CASES[1], CASES[2]]


@pytest.fixture(autouse=True)
def _f32_streams(monkeypatch):
    for knob in ("SE_PALLAS_HS_BF16", "SE_PALLAS_MXU_BF16", "SE_PALLAS_GATES_BF16"):
        monkeypatch.delenv(knob, raising=False)


def _inputs(ndir, B, T, H, seed):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((ndir, B, T, 4 * H)).astype(np.float32)
    w_hh_t = (rng.standard_normal((ndir, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    return torch.from_numpy(xw), torch.from_numpy(w_hh_t)


def _err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    return float(np.abs(a - b).max() / (np.abs(b).max() or 1.0))


@pytest.mark.parametrize("ndir,B,T,H,bb", CASES)
def test_model_matches_plain_version(ndir, B, T, H, bb):
    xw, w_hh_t = _inputs(ndir, B, T, H, seed=B * 10 + T)
    hs = L.lstm_bidir_tm_fwd_model(xw, w_hh_t, batch_block=bb)
    hs_fc, cs = L.lstm_bidir_tm_fwd_model(xw, w_hh_t, batch_block=bb, with_cell=True)
    ref_hs, ref_cs = L.lstm_bidir_tm_fc_ref(xw, w_hh_t)
    assert hs.shape == cs.shape == (ndir, B, T, H) and hs.dtype == torch.float32
    assert torch.equal(hs, hs_fc)
    assert float((hs - L.lstm_bidir_tm_ref(xw, w_hh_t)).abs().max()) <= MODEL_TOL
    assert float((hs - ref_hs).abs().max()) <= MODEL_TOL
    assert _err(cs, ref_cs) <= MODEL_TOL


@pytest.mark.parametrize("ndir,B,T,H,bb", PALLAS_CASES)
def test_model_matches_pallas_kernels_in_interpret_mode(ndir, B, T, H, bb):
    # the Pallas kernels take two directions: one direction runs as the first
    # of a pair whose second repeats it
    xw, w_hh_t = _inputs(ndir, B, T, H, seed=B * 10 + T + 1)
    pair = [t if ndir == 2 else t.repeat(2, *[1] * (t.dim() - 1)) for t in (xw, w_hh_t)]
    j_xw, j_w = jnp.asarray(pair[0].numpy()), jnp.asarray(pair[1].numpy())
    j_hs = np.asarray(lstm_bidir_pallas_tm(j_xw, j_w, interpret=True))[:ndir]
    fc_hs, fc_cs = _tm_fwd_with_cell(jnp.moveaxis(j_xw, 2, 0), j_w, True)
    fc_hs = np.moveaxis(np.asarray(fc_hs), 0, 2)[:ndir]
    fc_cs = np.moveaxis(np.asarray(fc_cs), 0, 2)[:ndir]
    hs = L.lstm_bidir_tm_fwd_model(xw, w_hh_t, batch_block=bb)
    m_hs, m_cs = L.lstm_bidir_tm_fwd_model(xw, w_hh_t, batch_block=bb, with_cell=True)
    assert _err(hs, j_hs) <= PALLAS_TOL
    assert _err(m_hs, fc_hs) <= PALLAS_TOL and _err(m_cs, fc_cs) <= PALLAS_TOL


def test_model_gives_identical_bits_for_any_batch_block():
    # a row's sums run in an order that its batch block does not enter
    xw, w_hh_t = _inputs(2, 5, 6, 16, seed=3)
    a = L.lstm_bidir_tm_fwd_model(xw, w_hh_t, batch_block=1, with_cell=True)
    b = L.lstm_bidir_tm_fwd_model(xw, w_hh_t, batch_block=3, with_cell=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_model_leaves_its_inputs_untouched_and_handles_empty_shapes():
    xw, w_hh_t = _inputs(2, 2, 4, 8, seed=4)
    before = (xw.clone(), w_hh_t.clone())
    L.lstm_bidir_tm_fwd_model(xw, w_hh_t, batch_block=2, with_cell=True)
    assert torch.equal(before[0], xw) and torch.equal(before[1], w_hh_t)
    hs, cs = L.lstm_bidir_tm_fwd_model(xw[:, :0], w_hh_t, with_cell=True)
    assert hs.shape == cs.shape == (2, 0, 4, 8)
    assert L.lstm_bidir_tm_fwd_model(xw[:, :, :0], w_hh_t).shape == (2, 2, 0, 8)


@pytest.mark.parametrize("hidden,route", [
    (256, "cluster"), (8, "cluster"), (64, "cluster"), (248, "cluster"),
    (264, "grid"), (260, "grid"), (512, "grid"), (36, "grid"), (4, "grid"), (255, "grid"),
])
def test_route_is_named_by_the_hidden_size_alone(hidden, route):
    assert L.fwd_route(hidden) == route


@pytest.mark.parametrize("batch,ndir,clusters,rows", [
    (1, 2, 14, 1), (6, 2, 14, 1), (16, 2, 14, 3), (64, 2, 14, 10),
    (1, 1, 14, 1), (16, 1, 14, 2), (64, 1, 14, 5),
    (7, 2, 14, 1), (8, 2, 14, 2), (1000, 2, 14, 16), (64, 2, 1, 16), (6, 2, 1, 6),
])
def test_batch_block_fills_the_card_up_to_the_cap(batch, ndir, clusters, rows):
    assert L.fwd_batch_block(batch, ndir, clusters) == rows
    if rows < L.FWD_MAX_BATCH_BLOCK:  # all clusters at once, and no fewer rows would do
        assert ndir * -(-batch // rows) <= max(clusters, ndir)
        assert rows == 1 or ndir * -(-batch // (rows - 1)) > clusters


@pytest.mark.parametrize("ndir", [1, 2])
def test_wrappers_run_the_plain_versions_on_the_cpu_and_count_nothing(ndir):
    xw, w_hh_t = _inputs(ndir, 3, 5, 8, seed=6 + ndir)
    counters = (L.lstm_bidir_tm, L.lstm_bidir_tm_fc)
    before = [(fn.launches, dict(fn.by_route)) for fn in counters]
    hs = L.lstm_bidir_tm(xw, w_hh_t)
    assert torch.equal(hs, L.lstm_bidir_tm_ref(xw, w_hh_t))
    hs_fc, cs = L.lstm_bidir_tm_fc(xw, w_hh_t)
    ref_hs, ref_cs = L.lstm_bidir_tm_fc_ref(xw, w_hh_t)
    assert torch.equal(hs_fc, ref_hs) and torch.equal(cs, ref_cs)
    # under autograd: LstmBidirTm, B2 fwd's plain version
    x = xw.clone().requires_grad_()
    out = L.lstm_bidir_tm(x, w_hh_t)
    assert out.grad_fn is not None and torch.equal(out.detach(), ref_hs)
    assert torch.equal(L.LstmBidirTm.apply(x, w_hh_t).detach(), ref_hs)
    assert [(fn.launches, dict(fn.by_route)) for fn in counters] == before
    assert all(set(fn.by_route) == {"cluster", "grid"} for fn in counters)
