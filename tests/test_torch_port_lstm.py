"""The port's recurrence, LSTM stack and heads against the JAX package.

The plain recurrence ``lstm_bidir_tm_ref`` is held against the Pallas
kernel ``lstm_bidir_pallas_tm`` run in interpret mode (as
tests/test_pallas_lstm.py runs it); the stack and the heads against the
flax modules with the Pallas route on, their weights carried over by the
bridge. On the CPU the wrapper takes the plain version and launches
nothing; the CUDA kernel itself is checked on the card by chip_smoke.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_by_s3prl_tpu.models import heads as j_heads
from speech_enhancement_by_s3prl_tpu.models.lstm import LSTMStack as JLSTMStack
from speech_enhancement_by_s3prl_tpu.ops.pallas.lstm_kernel import lstm_bidir_pallas_tm
from speech_enhancement_by_s3prl_tpu_torch.models import heads as t_heads
from speech_enhancement_by_s3prl_tpu_torch.models.convert import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from speech_enhancement_by_s3prl_tpu_torch.models.lstm import LSTMStack
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda.lstm_kernel import (
    lstm_bidir_tm,
    lstm_bidir_tm_ref,
)

# |h| <= 1 and both sides compute the same f32 recurrence; only the order
# of the H-term sums in h @ W_hh^T differs, so each step agrees to f32
# rounding and the (contractive) recurrence keeps it there.
RECURRENCE_ATOL = 2e-6


def _recurrence_inputs(B, T, H, seed):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((2, B, T, 4 * H)).astype(np.float32)
    w_hh_t = (rng.standard_normal((2, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    return xw, w_hh_t


@pytest.mark.parametrize("B,T,H", [(3, 29, 8), (2, 37, 16), (1, 5, 12)])
def test_recurrence_ref_matches_pallas_interpret(B, T, H, monkeypatch):
    for knob in ("SE_PALLAS_HS_BF16", "SE_PALLAS_MXU_BF16", "SE_PALLAS_GATES_BF16"):
        monkeypatch.delenv(knob, raising=False)
    xw, w_hh_t = _recurrence_inputs(B, T, H, seed=B * 100 + T)
    ref = np.asarray(
        lstm_bidir_pallas_tm(jnp.asarray(xw), jnp.asarray(w_hh_t), interpret=True)
    )
    port = lstm_bidir_tm_ref(torch.from_numpy(xw), torch.from_numpy(w_hh_t))
    assert port.shape == (2, B, T, H) and port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), ref, atol=RECURRENCE_ATOL, rtol=0)


def test_wrapper_on_cpu_runs_plain_version_and_launches_nothing():
    xw, w_hh_t = _recurrence_inputs(2, 11, 8, seed=7)
    xw, w_hh_t = torch.from_numpy(xw), torch.from_numpy(w_hh_t)
    before = lstm_bidir_tm.launches
    out = lstm_bidir_tm(xw, w_hh_t)
    assert lstm_bidir_tm.launches == before == 0
    assert torch.equal(out, lstm_bidir_tm_ref(xw, w_hh_t))


@pytest.mark.parametrize("case", ["w_hh_shape", "xw_rank", "dtype", "two_dirs"])
def test_wrapper_rejects_bad_inputs(case):
    xw = torch.zeros(2, 2, 5, 32)
    w = torch.zeros(2, 8, 32)
    if case == "w_hh_shape":
        w = torch.zeros(2, 8, 16)
    elif case == "xw_rank":
        xw = torch.zeros(2, 5, 32)
    elif case == "dtype":
        xw, w = xw.double(), w.double()
    else:
        xw = torch.zeros(3, 2, 5, 32)
    with pytest.raises(ValueError):
        lstm_bidir_tm(xw, w)


def _x(B, T, D, seed):
    return np.random.default_rng(seed).standard_normal((B, T, D)).astype(np.float32)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_lstm_stack_matches_jax(bidirectional):
    B, T, D, H = 3, 23, 12, 8
    x = _x(B, T, D, seed=4)
    jstack = JLSTMStack(H, num_layers=2, bidirectional=bidirectional,
                        use_pallas=True, pallas_interpret=True)
    params = jstack.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(jstack.apply(params, jnp.asarray(x)))
    stack = LSTMStack(D, H, num_layers=2, bidirectional=bidirectional)
    stack.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    with torch.no_grad():
        out = stack(torch.from_numpy(x)).numpy()
    # two stacked recurrences; the input projection adds a D-term f32 sum
    np.testing.assert_allclose(out, ref, atol=5e-6, rtol=0)


def test_one_direction_stack_runs_the_kernel_wrapper_with_one_direction(monkeypatch):
    # every layer hands lstm_bidir_tm an xw with a leading axis of 1 (B1
    # without a gradient, LstmBidirTm with one); the plain loop is reached
    # only inside the wrapper, for a CPU tensor
    from speech_enhancement_by_s3prl_tpu_torch.models import lstm as t_lstm

    seen = []

    def recording(xw, w_hh_t, **kw):  # kw: the f32 form's h_bf16=False
        seen.append((tuple(xw.shape), tuple(w_hh_t.shape), xw.is_contiguous()
                     and w_hh_t.is_contiguous()))
        return lstm_bidir_tm(xw, w_hh_t, **kw)

    monkeypatch.setattr(t_lstm, "lstm_bidir_tm", recording)
    B, T, D, H = 2, 9, 6, 8
    stack = LSTMStack(D, H, num_layers=3, bidirectional=False,
                      generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(B, T, D, seed=11))
    with torch.no_grad():
        out = stack(x)
    assert out.shape == (B, T, H) and out.grad_fn is None
    assert seen == [((1, B, T, 4 * H), (1, H, 4 * H), True)] * 3
    out = stack(x)
    assert len(seen) == 6
    # under autograd each layer is one LstmBidirTm node
    nodes, todo, done = 0, [out.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in done:
            continue
        done.add(fn)
        nodes += type(fn).__name__ == "LstmBidirTmBackward"
        todo.extend(f for f, _ in fn.next_functions)
    assert nodes == 3


@pytest.mark.parametrize("num_layers", [1, 3])
def test_one_direction_stack_param_grads_match_jax(num_layers):
    # the JAX package runs its lax.scan cell (LstmCellScan) for a
    # one-direction layer; the port runs LstmBidirTm with one direction
    B, T, D, H = 2, 13, 6, 8
    x = _x(B, T, D, seed=12)
    wts = np.cos(np.arange(B * T * H).reshape(B, T, H) * 0.01).astype(np.float32)
    jstack = JLSTMStack(H, num_layers=num_layers, bidirectional=False)
    params = jstack.init(jax.random.PRNGKey(3), jnp.asarray(x))
    ref = np.asarray(jstack.apply(params, jnp.asarray(x)))
    jgrads = jax.grad(
        lambda p: jnp.sum(jnp.sin(jstack.apply(p, jnp.asarray(x))) * wts))(params)

    stack = LSTMStack(D, H, num_layers=num_layers, bidirectional=False)
    stack.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    out = stack(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=5e-6, rtol=0)
    names, tensors = zip(*stack.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(
        (torch.sin(out) * torch.from_numpy(wts)).sum(), tensors)))
    ref_grads = flax_to_state_dict(jax.device_get(jgrads))
    assert set(ref_grads) == set(grads) and len(grads) == num_layers * 4
    for k, g in grads.items():
        r = ref_grads[k].numpy()
        # sums over T * B terms carried back through the recurrence, relative
        # to the largest |value| (as for the bidirectional stack: 5e-5)
        assert float(np.abs(g.numpy() - r).max() / (np.abs(r).max() + 1e-12)) < 5e-5, k


HEAD_CASES = {
    "Residual": dict(hidden_size=8, num_layers=2, bidirectional=True,
                     activation="Sigmoid", cmvn=False),
    "Residual_cmvn": dict(hidden_size=8, num_layers=1, bidirectional=True,
                          activation="Sigmoid", cmvn=True),
    "LSTM": dict(hidden_size=8, num_layers=2, bidirectional=True,
                 activation="Identity"),
    "Linear": dict(activation="ReLU"),
    "LinearResidual": dict(cmvn=True),
}


@pytest.mark.parametrize("case", sorted(HEAD_CASES))
def test_head_matches_jax(case):
    name = case.split("_")[0]
    cfg = HEAD_CASES[case]
    B, T, D, F = 2, 19, 12, 10
    feats = _x(B, T, D, seed=5)
    linears = np.abs(_x(B, T, F, seed=6))
    jhead = j_heads.build_head(name, input_size=D, output_size=F,
                               use_pallas=True, **cfg)
    params = jhead.init(jax.random.PRNGKey(1), features=jnp.asarray(feats),
                        linears=jnp.asarray(linears))
    ref, ref_aux = jhead.apply(params, features=jnp.asarray(feats),
                               linears=jnp.asarray(linears))
    head = t_heads.build_head(name, input_size=D, output_size=F, **cfg)
    head.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    with torch.no_grad():
        out, aux = head(torch.from_numpy(feats), torch.from_numpy(linears))
    assert set(aux) == set(ref_aux)
    # f32 throughout; LSTM is exp() of the prediction, hence relative
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_bridge_round_trip_is_exact():
    D, F = 12, 10
    jhead = j_heads.build_head("Residual", input_size=D, output_size=F,
                               **HEAD_CASES["Residual"])
    params = jax.device_get(jhead.init(
        jax.random.PRNGKey(2), features=jnp.zeros((1, 5, D)),
        linears=jnp.zeros((1, 5, F)),
    ))
    back = state_dict_to_flax(flax_to_state_dict(params))
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), b)

    head = t_heads.build_head("Residual", input_size=D, output_size=F,
                              generator=torch.Generator().manual_seed(0),
                              **HEAD_CASES["Residual"])
    sd = flax_to_state_dict(state_dict_to_flax(head.state_dict()))
    assert sd.keys() == head.state_dict().keys()
    assert all(torch.equal(sd[k], v) for k, v in head.state_dict().items())
    # Dense kernel (in, out) <-> nn.Linear weight (out, in)
    assert params["params"]["scaling_layer"]["kernel"].shape == (16, F)
    assert head.scaling_layer.weight.shape == (F, 16)


def test_init_is_seeded_and_follows_the_reference_scheme():
    def make(seed):
        return t_heads.build_head(
            "Residual", input_size=12, output_size=10,
            generator=torch.Generator().manual_seed(seed),
            unrelated_cli_flag=True, use_pallas=True, **HEAD_CASES["Residual"],
        ).state_dict()

    a, b, c = make(0), make(0), make(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lstm.l0_fwd.w_hh"], c["lstm.l0_fwd.w_hh"])
    w_hh = a["lstm.l0_fwd.w_hh"]  # (4H, H), orthonormal columns
    torch.testing.assert_close(w_hh.T @ w_hh, torch.eye(8), atol=1e-5, rtol=0)
    assert not a["lstm.l1_bwd.b_ih"].any() and not a["scaling_layer.bias"].any()
    bound = np.sqrt(6.0 / (32 + 12))  # xavier-uniform of W_ih (4H, D)
    assert a["lstm.l0_fwd.w_ih"].abs().max() <= bound


@pytest.mark.parametrize("name,cfg", [
    # one-direction heads in bf16 (JAX's lax.scan cell) build; what they do
    # not take is a gradient through a carried state, as in f32
    ("LSTM", {"compute_dtype": "bf16"}),
    ("Residual", {"compute_dtype": "bf16"}),
    ("Residual", {"compute_dtype": "bfloat16", "num_layers": 1, "bidirectional": False}),
])
def test_build_head_names_what_is_not_ported(name, cfg):
    head = t_heads.build_head(name, input_size=12, output_size=10, hidden_size=8, **cfg)
    assert head.compute_dtype == torch.bfloat16 and not head.lstm.bidirectional
    state = tuple((torch.zeros(2, 8), torch.zeros(2, 8)) for _ in range(head.lstm.num_layers))
    with pytest.raises(RuntimeError, match="ROADMAP.md A3"):
        head(torch.zeros(2, 5, 12), torch.ones(2, 5, 10), lstm_state=state)
