"""The port's differentiable recurrence against the JAX package.

The plain versions of kernels B2 fwd and B2 bwd (``lstm_bidir_tm_fc_ref``,
``lstm_bidir_tm_bwd_ref``) are held against the Pallas kernels
``_tm_fwd_with_cell`` / ``_tm_bwd`` run in interpret mode; ``LstmBidirTm``
against the JAX custom VJP ``lstm_bidir_tm`` (interpret mode) and against
plain autograd through ``lstm_bidir_tm_ref``; the LSTM stack's and the
``Residual`` head's parameter gradients against ``jax.grad`` of the flax
modules with bridged weights. On the CPU every route takes the plain
versions and launches nothing; the CUDA kernels are held against the plain
versions on the card by chip_smoke.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_by_s3prl_tpu.models import heads as j_heads
from speech_enhancement_by_s3prl_tpu.models.lstm import LSTMStack as JLSTMStack
from speech_enhancement_by_s3prl_tpu.ops.pallas.lstm_kernel import (
    _tm_bwd,
    _tm_fwd_with_cell,
    lstm_bidir_tm as j_lstm_bidir_tm,
)
from speech_enhancement_by_s3prl_tpu_torch.models import heads as t_heads
from speech_enhancement_by_s3prl_tpu_torch.models.convert import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from speech_enhancement_by_s3prl_tpu_torch.models.lstm import LSTMStack
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda.lstm_kernel import (
    LstmBidirTm,
    lstm_bidir_tm,
    lstm_bidir_tm_bwd,
    lstm_bidir_tm_bwd_ref,
    lstm_bidir_tm_fc,
    lstm_bidir_tm_fc_ref,
    lstm_bidir_tm_ref,
)

# hs, cs: the same f32 recurrence with the H-term sums in another order;
# |h| <= 1 and the recurrence is contractive (as for B1, 2e-6 absolute).
FWD_ATOL = 2e-6
# dxw and dW_hh^T: sums of up to T*B such terms carried backwards through
# the recurrence, relative to the largest |value|.
BWD_RTOL = 1e-5
SHAPES = [(3, 17, 8), (2, 23, 16), (1, 5, 12)]


@pytest.fixture(autouse=True)
def _f32_streams(monkeypatch):
    monkeypatch.delenv("SE_PALLAS_VJP_BF16", raising=False)
    monkeypatch.delenv("SE_PALLAS_HS_BF16", raising=False)


def _inputs(B, T, H, seed):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((2, B, T, 4 * H)).astype(np.float32)
    w_hh_t = (rng.standard_normal((2, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    dhs = rng.standard_normal((2, B, T, H)).astype(np.float32)
    return xw, w_hh_t, dhs


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    return float(np.abs(a - b).max() / np.abs(b).max())


def _tm(x):  # (2, B, T, ...) <-> (T, 2, B, ...)
    return jnp.moveaxis(jnp.asarray(x), 2, 0)


@pytest.mark.parametrize("B,T,H", SHAPES)
def test_fc_ref_matches_pallas_fwd_with_cell(B, T, H):
    xw, w_hh_t, _ = _inputs(B, T, H, seed=B * 10 + T)
    hs_tm, cs_tm = _tm_fwd_with_cell(_tm(xw), jnp.asarray(w_hh_t), True)
    hs, cs = lstm_bidir_tm_fc_ref(torch.from_numpy(xw), torch.from_numpy(w_hh_t))
    assert hs.shape == cs.shape == (2, B, T, H)
    np.testing.assert_allclose(hs.numpy(), np.moveaxis(np.asarray(hs_tm), 0, 2),
                               atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(cs.numpy(), np.moveaxis(np.asarray(cs_tm), 0, 2),
                               atol=FWD_ATOL * 5, rtol=0)  # |c| grows up to ~T


@pytest.mark.parametrize("B,T,H", SHAPES)
def test_bwd_ref_matches_pallas_bwd(B, T, H):
    xw, w_hh_t, dhs = _inputs(B, T, H, seed=B * 10 + T + 1)
    hs, cs = lstm_bidir_tm_fc_ref(torch.from_numpy(xw), torch.from_numpy(w_hh_t))
    dxw_tm, dwhh = _tm_bwd(_tm(xw), jnp.asarray(w_hh_t), _tm(hs.numpy()),
                           _tm(cs.numpy()), _tm(dhs), True)
    dxw, dw = lstm_bidir_tm_bwd_ref(torch.from_numpy(xw), torch.from_numpy(w_hh_t),
                                    hs, cs, torch.from_numpy(dhs))
    assert dxw.shape == xw.shape and dw.shape == w_hh_t.shape
    assert _rel(dxw, np.moveaxis(np.asarray(dxw_tm), 0, 2)) < BWD_RTOL
    assert _rel(dw, dwhh) < BWD_RTOL


@pytest.mark.parametrize("B,T,H", SHAPES)
def test_function_grads_match_jax_vjp_and_plain_autograd(B, T, H):
    xw, w_hh_t, dhs = _inputs(B, T, H, seed=B * 10 + T + 2)
    _, vjp = jax.vjp(lambda a, b: j_lstm_bidir_tm(a, b, True),
                     jnp.asarray(xw), jnp.asarray(w_hh_t))
    j_dxw, j_dw = vjp(jnp.asarray(dhs))

    grads = {}
    for name, fn in (("function", lstm_bidir_tm), ("plain", lstm_bidir_tm_ref)):
        x = torch.from_numpy(xw).requires_grad_()
        w = torch.from_numpy(w_hh_t).requires_grad_()
        out = fn(x, w)
        grads[name] = torch.autograd.grad(out, (x, w), torch.from_numpy(dhs))
    for g, ref in zip(grads["function"], (j_dxw, j_dw)):
        assert _rel(g.numpy(), ref) < BWD_RTOL
    # the CPU takes the same autograd route as the card (LstmBidirTm, with
    # the plain versions inside), and it equals plain autograd
    for g, ref in zip(grads["function"], grads["plain"]):
        assert _rel(g.numpy(), ref.numpy()) < BWD_RTOL


def test_routes_on_cpu_launch_nothing():
    xw, w_hh_t, dhs = (torch.from_numpy(a) for a in _inputs(2, 7, 8, seed=3))
    for fn in (lstm_bidir_tm, lstm_bidir_tm_fc, lstm_bidir_tm_bwd):
        fn.launches = 0
    x, w = xw.clone().requires_grad_(), w_hh_t.clone().requires_grad_()
    out = lstm_bidir_tm(x, w)
    assert type(out.grad_fn).__name__ == "LstmBidirTmBackward"
    torch.autograd.grad(out, (x, w), dhs)
    with torch.no_grad():
        primal = lstm_bidir_tm(x, w)
    assert primal.grad_fn is None and torch.equal(primal, lstm_bidir_tm_ref(xw, w_hh_t))
    assert torch.equal(out.detach(), primal)
    assert lstm_bidir_tm.launches == lstm_bidir_tm_fc.launches == 0
    assert lstm_bidir_tm_bwd.launches == 0


def test_only_requested_grads_are_returned():
    xw, w_hh_t, dhs = (torch.from_numpy(a) for a in _inputs(2, 6, 8, seed=4))
    w = w_hh_t.clone().requires_grad_()
    (dw,) = torch.autograd.grad(LstmBidirTm.apply(xw, w), (w,), dhs)
    _, ref = lstm_bidir_tm_bwd_ref(xw, w_hh_t, *lstm_bidir_tm_fc_ref(xw, w_hh_t), dhs)
    assert torch.equal(dw, ref)


def test_nan_in_xw_gives_nan_grads():
    xw, w_hh_t, dhs = _inputs(2, 9, 8, seed=5)
    xw[1, 0, 4, 3] = np.nan
    x = torch.from_numpy(xw).requires_grad_()
    w = torch.from_numpy(w_hh_t).requires_grad_()
    dx, dw = torch.autograd.grad(lstm_bidir_tm(x, w), (x, w), torch.from_numpy(dhs))
    assert torch.isnan(dx).any() and torch.isnan(dw).any()


@pytest.mark.parametrize("T", [0, 1])
def test_short_sequences(T):
    xw, w_hh_t, dhs = (torch.from_numpy(a) for a in _inputs(2, T, 8, seed=6))
    x, w = xw.clone().requires_grad_(), w_hh_t.clone().requires_grad_()
    out = lstm_bidir_tm(x, w)
    dx, dw = torch.autograd.grad(out, (x, w), dhs)
    assert out.shape == (2, 2, T, 8) and dx.shape == xw.shape and dw.shape == w_hh_t.shape
    if T == 0:
        assert not dw.any()
    else:  # h_{-1} = 0: one step adds nothing to dW_hh^T
        assert not dw.any() and dx.abs().sum() > 0


def test_bwd_rejects_bad_residuals():
    xw, w_hh_t, dhs = (torch.from_numpy(a) for a in _inputs(2, 5, 8, seed=7))
    hs, cs = lstm_bidir_tm_fc(xw, w_hh_t)
    with pytest.raises(ValueError, match="dhs"):
        lstm_bidir_tm_bwd(xw, w_hh_t, hs, cs, dhs[:, :, :4])
    with pytest.raises(ValueError, match="cs"):
        lstm_bidir_tm_bwd(xw, w_hh_t, hs, cs.double(), dhs)


def _loss_weights(shape):
    return np.cos(np.arange(int(np.prod(shape))).reshape(shape) * 0.01).astype(np.float32)


def _assert_param_grads_match(torch_grads, jax_grads, rtol):
    ref = flax_to_state_dict(jax.device_get(jax_grads))
    assert set(ref) == set(torch_grads)
    for k, g in torch_grads.items():
        r = ref[k].numpy()
        err = float(np.abs(g.numpy() - r).max() / (np.abs(r).max() + 1e-12))
        assert err < rtol, (k, err)


def test_lstm_stack_param_grads_match_jax():
    B, T, D, H = 2, 13, 6, 8
    x = np.random.default_rng(8).standard_normal((B, T, D)).astype(np.float32)
    wts = _loss_weights((B, T, 2 * H))
    jstack = JLSTMStack(H, num_layers=2, bidirectional=True, use_pallas=True,
                        pallas_interpret=True)
    params = jstack.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jgrads = jax.grad(
        lambda p: jnp.sum(jnp.sin(jstack.apply(p, jnp.asarray(x))) * wts)
    )(params)

    stack = LSTMStack(D, H, num_layers=2, bidirectional=True)
    stack.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    loss = (torch.sin(stack(torch.from_numpy(x))) * torch.from_numpy(wts)).sum()
    names, tensors = zip(*stack.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, tensors)))
    # every weight and bias of both layers and directions gets its gradient:
    # w_hh through dW_hh^T, w_ih and the biases through the projection
    assert len(grads) == 2 * 2 * 4
    _assert_param_grads_match(grads, jgrads, rtol=BWD_RTOL * 5)


def test_residual_head_param_grads_match_jax():
    B, T, D, F, H = 2, 11, 12, 10, 8
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((B, T, D)).astype(np.float32)
    linears = np.abs(rng.standard_normal((B, T, F))).astype(np.float32)
    cfg = dict(hidden_size=H, num_layers=2, bidirectional=True, activation="Sigmoid",
               cmvn=False)
    jhead = j_heads.build_head("Residual", input_size=D, output_size=F, use_pallas=True,
                               **cfg)
    params = jhead.init(jax.random.PRNGKey(1), features=jnp.asarray(feats),
                        linears=jnp.asarray(linears))
    wts = _loss_weights((B, T, F))

    def jloss(p):
        out, _ = jhead.apply(p, features=jnp.asarray(feats), linears=jnp.asarray(linears))
        return jnp.sum(out * wts)

    jgrads = jax.grad(jloss)(params)
    head = t_heads.build_head("Residual", input_size=D, output_size=F, **cfg)
    head.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    out, _ = head(torch.from_numpy(feats), torch.from_numpy(linears))
    names, tensors = zip(*head.named_parameters())
    grads = dict(zip(names, torch.autograd.grad((out * torch.from_numpy(wts)).sum(),
                                                tensors)))
    _assert_param_grads_match(grads, jgrads, rtol=BWD_RTOL * 5)
    # the grads bridge back onto the flax tree's paths
    assert state_dict_to_flax(grads).keys() == {"params"}
