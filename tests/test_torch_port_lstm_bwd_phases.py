"""The three-phase backward of the recurrence (kernel B2 bwd's ``phases``
route) as its PyTorch model, against the plain version and the JAX package.

``lstm_bidir_tm_bwd_model`` runs the algorithm of ``csrc/lstm_tm_bwd.cu``
phase for phase: the gate activations of every step from one product written
into the dxw buffer, the reverse loop that carries only dh and dc per batch
block, and dW_hh^T as one product over the rows with t >= 1, its contraction
split in a fixed order. It is held against ``lstm_bidir_tm_bwd_ref`` (the
step-for-step plain version) and against the Pallas kernel ``_tm_bwd`` run in
interpret mode, on the same numpy-seeded inputs. The CUDA kernels themselves
are held against the plain version on the card by chip_smoke.py.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from speech_enhancement_by_s3prl_tpu.ops.pallas.lstm_kernel import _tm_bwd
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L

# dxw and dW_hh^T relative to the largest |value| (absolute where that is 0:
# dW_hh^T at T = 1). All sides compute in f32; the model takes its products
# over all rows at once and splits dW_hh^T's contraction, so only summation
# orders differ: rounding near 1e-7 a term, as for the plain version against
# the Pallas kernel (tests/test_torch_port_lstm_grad.py).
TOL = 1e-5
# (directions, B, T, H, batch block, splits): T = 1 (no h_{-1}, no dW term),
# T = 2, a ragged last batch block, H = 8 and 24, one and two directions
CASES = [
    (2, 3, 1, 8, 8, 1),
    (2, 2, 2, 8, 8, 2),
    (2, 11, 9, 8, 4, 3),
    (1, 5, 13, 24, 2, 4),
    (2, 3, 17, 24, 8, None),
    (1, 9, 6, 8, 8, 5),
]


@pytest.fixture(autouse=True)
def _f32_streams(monkeypatch):
    monkeypatch.delenv("SE_PALLAS_VJP_BF16", raising=False)
    monkeypatch.delenv("SE_PALLAS_HS_BF16", raising=False)


def _inputs(ndir, B, T, H, seed):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((ndir, B, T, 4 * H)).astype(np.float32)
    w_hh_t = (rng.standard_normal((ndir, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    dhs = rng.standard_normal((ndir, B, T, H)).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (xw, w_hh_t, dhs))


def _err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    return float(np.abs(a - b).max() / (np.abs(b).max() or 1.0))


def _tm(x):  # (ndir, B, T, ...) -> (T, ndir, B, ...)
    return jnp.moveaxis(jnp.asarray(np.asarray(x)), 2, 0)


@pytest.mark.parametrize("ndir,B,T,H,bb,splits", CASES)
def test_model_matches_plain_version(ndir, B, T, H, bb, splits):
    xw, w_hh_t, dhs = _inputs(ndir, B, T, H, seed=B * 10 + T)
    hs, cs = L.lstm_bidir_tm_fc_ref(xw, w_hh_t)
    dxw, dw = L.lstm_bidir_tm_bwd_model(xw, w_hh_t, hs, cs, dhs, batch_block=bb,
                                        splits=splits)
    ref_dxw, ref_dw = L.lstm_bidir_tm_bwd_ref(xw, w_hh_t, hs, cs, dhs)
    assert dxw.shape == xw.shape and dw.shape == w_hh_t.shape
    assert _err(dxw, ref_dxw) < TOL and _err(dw, ref_dw) < TOL
    if T == 1:  # h_{-1} = 0: one step adds nothing to dW_hh^T
        assert not dw.any() and not ref_dw.any()


@pytest.mark.parametrize("ndir,B,T,H,bb,splits", CASES)
def test_model_matches_pallas_bwd(ndir, B, T, H, bb, splits):
    # the Pallas kernel takes two directions: one direction runs as the
    # first of a pair whose second repeats it
    xw, w_hh_t, dhs = _inputs(ndir, B, T, H, seed=B * 10 + T + 1)
    hs, cs = L.lstm_bidir_tm_fc_ref(xw, w_hh_t)
    pair = [t if ndir == 2 else t.repeat(2, *[1] * (t.dim() - 1))
            for t in (xw, w_hh_t, hs, cs, dhs)]
    j_dxw, j_dw = _tm_bwd(_tm(pair[0]), jnp.asarray(pair[1].numpy()), _tm(pair[2]),
                          _tm(pair[3]), _tm(pair[4]), True)
    j_dxw = np.moveaxis(np.asarray(j_dxw), 0, 2)[:ndir]
    dxw, dw = L.lstm_bidir_tm_bwd_model(xw, w_hh_t, hs, cs, dhs, batch_block=bb,
                                        splits=splits)
    assert _err(dxw, j_dxw) < TOL and _err(dw, np.asarray(j_dw)[:ndir]) < TOL


def test_model_result_does_not_depend_on_the_batch_block():
    # rows are independent, so the blocks only change the shapes of the
    # products a BLAS sums in its own order
    xw, w_hh_t, dhs = _inputs(2, 7, 5, 8, seed=3)
    hs, cs = L.lstm_bidir_tm_fc_ref(xw, w_hh_t)
    a = L.lstm_bidir_tm_bwd_model(xw, w_hh_t, hs, cs, dhs, batch_block=8, splits=1)
    b = L.lstm_bidir_tm_bwd_model(xw, w_hh_t, hs, cs, dhs, batch_block=3, splits=1)
    assert _err(a[0], b[0]) < TOL and _err(a[1], b[1]) < TOL


def test_model_leaves_its_inputs_untouched_and_handles_empty_shapes():
    xw, w_hh_t, dhs = _inputs(2, 2, 4, 8, seed=4)
    hs, cs = L.lstm_bidir_tm_fc_ref(xw, w_hh_t)
    before = [t.clone() for t in (xw, w_hh_t, hs, cs, dhs)]
    L.lstm_bidir_tm_bwd_model(xw, w_hh_t, hs, cs, dhs)
    assert all(torch.equal(a, b) for a, b in zip(before, (xw, w_hh_t, hs, cs, dhs)))
    empty = L.lstm_bidir_tm_bwd_model(xw[:, :0], w_hh_t, hs[:, :0], cs[:, :0], dhs[:, :0])
    assert empty[0].shape == (2, 0, 4, 32) and not empty[1].any()


@pytest.mark.parametrize("hidden,route", [
    (256, "phases"), (8, "phases"), (64, "phases"), (248, "phases"),
    (264, "grid"), (512, "grid"), (36, "grid"), (4, "grid"), (255, "grid"),
])
def test_route_is_named_by_the_hidden_size_alone(hidden, route):
    assert L.bwd_route(hidden) == route


@pytest.mark.parametrize("rows,splits", [(1, 1), (512, 1), (513, 2), (6006, 12),
                                         (64064, 16), (10 ** 7, 16)])
def test_split_count_of_the_dw_contraction(rows, splits):
    assert L.bwd_splits(rows) == splits


@pytest.mark.parametrize("ndir", [1, 2])
def test_wrappers_take_one_or_two_directions(ndir):
    xw, w_hh_t, dhs = _inputs(ndir, 3, 6, 8, seed=5 + ndir)
    for fn in (L.lstm_bidir_tm, L.lstm_bidir_tm_fc, L.lstm_bidir_tm_bwd):
        fn.launches = 0
    hs = L.lstm_bidir_tm(xw, w_hh_t)
    hs_fc, cs = L.lstm_bidir_tm_fc(xw, w_hh_t)
    assert hs.shape == cs.shape == (ndir, 3, 6, 8) and torch.equal(hs, hs_fc)
    # each direction is its own recurrence
    for d in range(ndir):
        assert torch.equal(hs[d], L.lstm_bidir_tm_ref(xw[d], w_hh_t[d]))
    dxw, dw = L.lstm_bidir_tm_bwd(xw, w_hh_t, hs, cs, dhs)
    assert dxw.shape == xw.shape and dw.shape == w_hh_t.shape
    x, w = xw.clone().requires_grad_(), w_hh_t.clone().requires_grad_()
    gx, gw = torch.autograd.grad(L.lstm_bidir_tm(x, w), (x, w), dhs)
    assert torch.equal(gx, dxw) and torch.equal(gw, dw)
    # on the CPU every wrapper takes its plain version
    assert not any(fn.launches for fn in (L.lstm_bidir_tm, L.lstm_bidir_tm_fc,
                                          L.lstm_bidir_tm_bwd))
    assert L.lstm_bidir_tm_bwd.by_route == {"phases": 0, "grid": 0}


@pytest.mark.parametrize("fn", ["tm", "fc", "bwd", "bb"])
def test_wrappers_refuse_three_directions(fn):
    xw, w_hh_t, dhs = _inputs(3, 2, 4, 8, seed=9)
    with pytest.raises(ValueError, match="xw must be"):
        if fn == "tm":
            L.lstm_bidir_tm(xw, w_hh_t)
        elif fn == "fc":
            L.lstm_bidir_tm_fc(xw, w_hh_t)
        elif fn == "bwd":
            L.lstm_bidir_tm_bwd(xw, w_hh_t, dhs, dhs, dhs)
        else:
            L.lstm_bidir_bb(xw, w_hh_t)


def test_batch_blocked_kernels_take_two_directions_only():
    xw, w_hh_t, _ = _inputs(1, 2, 4, 8, seed=10)
    with pytest.raises(ValueError, match=r"xw must be \(2, B, T, 4H\)"):
        L.lstm_bidir_bb(xw, w_hh_t)


def test_residuals_must_carry_the_direction_count_of_xw():
    xw, w_hh_t, dhs = _inputs(1, 2, 4, 8, seed=11)
    hs, cs = L.lstm_bidir_tm_fc(xw, w_hh_t)
    with pytest.raises(ValueError, match="dhs"):
        L.lstm_bidir_tm_bwd(xw, w_hh_t, hs, cs, dhs.repeat(2, 1, 1, 1))
    with pytest.raises(ValueError, match="w_hh_t must be"):
        L.lstm_bidir_tm(xw, w_hh_t.repeat(2, 1, 1))
