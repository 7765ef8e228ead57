"""The port's batch-blocked recurrence (B6), the recurrence with the input
projection inside (B7) and the ``recurrence`` routes of ``LSTMStack`` against
the JAX package.

On the CPU the wrappers run their plain versions, held here against the
Pallas kernels ``lstm_bidir_pallas`` / ``lstm_bidir_pallas_fused`` in
interpret mode (as tests/test_pallas_lstm.py runs them); the stack against the
flax ``LSTMStack`` with the Pallas route on under ``SE_PALLAS_TM=0`` /
``SE_PALLAS_FUSED=1``, weights carried over by the bridge. The CUDA kernels
themselves are checked on the card by chip_smoke.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_by_s3prl_tpu.models.lstm import LSTMStack as JLSTMStack
from speech_enhancement_by_s3prl_tpu.ops.pallas.lstm_kernel import (
    lstm_bidir_pallas,
    lstm_bidir_pallas_fused,
)
from speech_enhancement_by_s3prl_tpu_torch.models import heads as t_heads
from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_to_state_dict
from speech_enhancement_by_s3prl_tpu_torch import entry, serve
from speech_enhancement_by_s3prl_tpu_torch.models.lstm import LSTMStack
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda.lstm_kernel import (
    lstm_bidir_bb,
    lstm_bidir_bb_ref,
    lstm_bidir_fused,
    lstm_bidir_fused_ref,
    lstm_bidir_tm_ref,
)

# |h| <= 1 and both sides compute the same f32 recurrence; only the order of
# the H-term sums in h @ W_hh^T differs, and the recurrence is contractive
RECURRENCE_ATOL = 2e-6
# B7 adds the D-term sums of the input projection, also in another order
FUSED_ATOL = 5e-6

ENV_OF = {"tm": {"SE_PALLAS_TM": "1", "SE_PALLAS_FUSED": "0"},
          "blocked": {"SE_PALLAS_TM": "0", "SE_PALLAS_FUSED": "0"},
          "fused": {"SE_PALLAS_TM": "1", "SE_PALLAS_FUSED": "1"}}


def _inputs(B, T, D, H, seed):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((2, B, T, D)).astype(np.float32)
    w_ih_t = (rng.standard_normal((2, D, 4 * H)) / np.sqrt(D)).astype(np.float32)
    bias = (0.1 * rng.standard_normal((2, 4 * H))).astype(np.float32)
    w_hh_t = (rng.standard_normal((2, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    return xs, w_ih_t, bias, w_hh_t


# ragged B and T (neither a multiple of the Pallas chunk 8), and a batch block
# smaller than B with a ragged last block
@pytest.mark.parametrize("B,T,H,bb", [(3, 29, 8, 32), (5, 37, 16, 2), (1, 5, 12, 32),
                                      (7, 11, 8, 3)])
def test_bb_ref_matches_pallas_interpret(B, T, H, bb):
    rng = np.random.default_rng(B * 100 + T)
    xw = rng.standard_normal((2, B, T, 4 * H)).astype(np.float32)
    w_hh_t = (rng.standard_normal((2, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    ref = np.asarray(lstm_bidir_pallas(jnp.asarray(xw), jnp.asarray(w_hh_t), chunk=8,
                                       batch_block=bb, interpret=True))
    port = lstm_bidir_bb_ref(torch.from_numpy(xw), torch.from_numpy(w_hh_t))
    assert port.shape == (2, B, T, H) and port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), ref, atol=RECURRENCE_ATOL, rtol=0)


@pytest.mark.parametrize("B,T,D,H,bb", [(3, 29, 12, 8, 32), (5, 37, 30, 16, 2),
                                        (1, 5, 7, 12, 32), (7, 11, 16, 8, 3)])
def test_fused_ref_matches_pallas_interpret(B, T, D, H, bb):
    xs, w_ih_t, bias, w_hh_t = _inputs(B, T, D, H, seed=B * 100 + T)
    ref = np.asarray(lstm_bidir_pallas_fused(
        jnp.asarray(xs), jnp.asarray(w_ih_t), jnp.asarray(bias), jnp.asarray(w_hh_t),
        chunk=8, batch_block=bb, interpret=True))
    port = lstm_bidir_fused_ref(*map(torch.from_numpy, (xs, w_ih_t, bias, w_hh_t)))
    assert port.shape == (2, B, T, H) and port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), ref, atol=FUSED_ATOL, rtol=0)


def test_wrappers_on_cpu_run_plain_versions_and_launch_nothing():
    xs, w_ih_t, bias, w_hh_t = map(torch.from_numpy, _inputs(3, 9, 10, 8, seed=1))
    xw = torch.matmul(xs, w_ih_t[:, None]) + bias[:, None, None, :]
    before = (lstm_bidir_bb.launches, lstm_bidir_fused.launches)
    out_bb = lstm_bidir_bb(xw, w_hh_t, batch_block=2)
    out_fused = lstm_bidir_fused(xs, w_ih_t, bias, w_hh_t, batch_block=2)
    assert (lstm_bidir_bb.launches, lstm_bidir_fused.launches) == before == (0, 0)
    # one function: B6 is B1's, and B7 is B6 behind the projection
    assert torch.equal(out_bb, lstm_bidir_tm_ref(xw, w_hh_t))
    assert torch.equal(out_fused, out_bb)


@pytest.mark.parametrize("route", ["blocked", "fused"])
def test_forward_only_routes_raise_when_a_gradient_is_needed(route):
    xs, w_ih_t, bias, w_hh_t = map(torch.from_numpy, _inputs(2, 5, 6, 8, seed=2))
    xw = (torch.matmul(xs, w_ih_t[:, None]) + bias[:, None, None, :]).requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        if route == "blocked":
            lstm_bidir_bb(xw, w_hh_t)
        else:
            lstm_bidir_fused(xs, w_ih_t, bias, w_hh_t.clone().requires_grad_())
    # grad mode off: the forward runs although an input requires a gradient
    with torch.no_grad():
        out = lstm_bidir_bb(xw, w_hh_t)
    assert not out.requires_grad


@pytest.mark.parametrize("case", ["batch_block", "xs_rank", "w_ih_shape", "bias_shape",
                                  "dtype"])
def test_wrappers_reject_bad_inputs(case):
    xs, w_ih_t, bias, w_hh_t = map(torch.from_numpy, _inputs(2, 5, 6, 8, seed=3))
    with pytest.raises(ValueError):
        if case == "batch_block":
            lstm_bidir_bb(torch.zeros(2, 2, 5, 32), w_hh_t, batch_block=0)
        elif case == "xs_rank":
            lstm_bidir_fused(xs[0], w_ih_t, bias, w_hh_t)
        elif case == "w_ih_shape":
            lstm_bidir_fused(xs, w_ih_t[:, :5], bias, w_hh_t)
        elif case == "bias_shape":
            lstm_bidir_fused(xs, w_ih_t, bias[:, :8], w_hh_t)
        else:
            lstm_bidir_fused(xs.double(), w_ih_t, bias, w_hh_t)


@pytest.mark.parametrize("route", ["tm", "blocked", "fused"])
def test_lstm_stack_routes_match_jax(route, monkeypatch):
    for knob, value in ENV_OF[route].items():
        monkeypatch.setenv(knob, value)
    B, T, D, H = 3, 23, 12, 8
    x = np.random.default_rng(4).standard_normal((B, T, D)).astype(np.float32)
    jstack = JLSTMStack(H, num_layers=2, bidirectional=True, use_pallas=True,
                        pallas_interpret=True)
    params = jstack.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(jstack.apply(params, jnp.asarray(x)))
    stack = LSTMStack(D, H, num_layers=2, bidirectional=True, recurrence=route)
    stack.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    with torch.no_grad():
        out = stack(torch.from_numpy(x)).numpy()
    # two stacked recurrences; the input projection adds a D-term f32 sum
    np.testing.assert_allclose(out, ref, atol=5e-6, rtol=0)


def test_routes_share_one_state_dict_and_train_through_lstm_bidir_tm():
    """State-dict names do not depend on the route, and under autograd every
    route takes the differentiable recurrence: same output, same gradients."""
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    cfg = dict(hidden_size=8, num_layers=2, bidirectional=True)
    heads = {r: t_heads.build_head("Residual", input_size=12, output_size=10,
                                   generator=gen(), **cfg)
             for r in ("tm", "blocked", "fused")}
    for route, head in heads.items():
        head.lstm.recurrence = route
    ref_sd = heads["tm"].state_dict()
    rng = np.random.default_rng(5)
    feats = torch.from_numpy(rng.standard_normal((2, 9, 12)).astype(np.float32))
    linears = torch.from_numpy(rng.random((2, 9, 10)).astype(np.float32))
    results = {}
    for route, head in heads.items():
        assert head.lstm.recurrence == route
        assert head.state_dict().keys() == ref_sd.keys()
        head.load_state_dict(ref_sd)
        out, _ = head(feats, linears)
        assert out.requires_grad
        grads = torch.autograd.grad(out.square().sum(), list(head.parameters()))
        with torch.no_grad():
            served, _ = head(feats, linears)
        results[route] = (out.detach(), grads, served)
    for route in ("blocked", "fused"):
        assert torch.equal(results[route][0], results["tm"][0])
        assert all(torch.equal(a, b) for a, b in zip(results[route][1], results["tm"][1]))
        # forward-only on the CPU: plain versions, the fused one sums the
        # projection in the same matmul, so the served output is the same
        torch.testing.assert_close(results[route][2], results["tm"][2], atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="recurrence"):
        LSTMStack(12, 8, bidirectional=True, recurrence="scan")
    with pytest.raises(ValueError, match="recurrence"):
        heads["tm"].lstm.recurrence = "scan"


@pytest.mark.parametrize("builder", ["build_head", "entry.build", "serve.build_enhancer",
                                     "serve.build_raw_enhancer"])
def test_builders_take_no_recurrence(builder):
    """The route is a switch of ``LSTMStack`` alone: no builder carries it, so
    every head, enhancer and trainer runs ``"tm"``, which takes every hidden
    size (B6 and B7 refuse one not a multiple of 8 or above 256 on the card)."""
    call = {
        "build_head": lambda: t_heads.build_head(
            "Residual", input_size=12, output_size=10, hidden_size=8,
            bidirectional=True, recurrence="blocked"),
        "entry.build": lambda: entry.build(hidden_size=8, num_layers=1, device="cpu",
                                           recurrence="blocked"),
        "serve.build_enhancer": lambda: serve.build_enhancer(
            "no-checkpoint", device="cpu", recurrence="fused"),
        "serve.build_raw_enhancer": lambda: serve.build_raw_enhancer(
            "no-checkpoint", 16000, -25.0, "cpu", recurrence="fused"),
    }[builder]
    with pytest.raises(TypeError, match="recurrence"):
        call()
    head = t_heads.build_head("Residual", input_size=12, output_size=10, hidden_size=8,
                              bidirectional=True)
    assert head.lstm.recurrence == "tm"
