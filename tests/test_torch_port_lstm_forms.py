"""B1's forms that change the function it computes, against the JAX package, on
the CPU.

The JAX package reads three more variables of its LSTM kernels at trace time,
each where its function lives:

- ``SE_PALLAS_MXU_BF16`` (its Pallas B1, ``_kernel_tm``): W_hh^T and h_{t-1}
  rounded to bf16 for the step product, summed in f32;
- ``SE_PALLAS_GATES_BF16`` (the same kernel): the gate pre-activations
  rounded to bf16, the sigmoids spelled tanh(t / 2) / 2 + 1/2 and tanh in
  bf16, i * g in bf16, then c and h in f32;
- ``SE_LSTM_XW_INT8`` (its ``lax.scan`` cell, ``_lstm_scan``): xw quantized
  to int8 a (row, step) with an f32 scale; its Pallas path keeps an f32 xw
  under it.

The port reads the same variables (``models/lstm.stream_forms``) and hands
B1 the forms as arguments (``ops/cuda/lstm_kernel.py``). Held here: the plain
versions, the cluster kernel's model and the wrappers against
``lstm_bidir_pallas_tm`` in interpret mode and ``_lstm_scan``; ``LSTMStack``
against the flax stack (its Pallas path for a bidirectional layer, its scan
for one direction), its gradients, the capture scorer, the exported
program's op arguments, the streamer, and the cost formula.

The gates form meets XLA's excess precision: by default XLA's CPU compiler
drops a rounding to bf16 where the next op widens the value back to f32, so
the interpret-mode kernel leaves f's and o's last pass and i * g unrounded
(1.4e-3 from the kernel's source at the first step). The port computes the
source, every bf16 op rounded: it is held within ``RECURRENCE_ATOL`` of the
JAX kernel run with ``--xla_allow_excess_precision=false`` (a process of its
own, ``tests/torch_port_lstm_forms_worker.py``), and within a stated window
of the default run. Every limit is one the f32 form (no variable set) fails.
JAX reads the variables when it traces: each setting gets a trace of its
own.
"""
import io
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_enhancement_by_s3prl_tpu.models.lstm import LSTMStack as JLSTMStack
from speech_enhancement_by_s3prl_tpu.models.lstm import _lstm_scan
from speech_enhancement_by_s3prl_tpu.ops.pallas import lstm_kernel as JP
from speech_enhancement_by_s3prl_tpu_torch.models.convert import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from speech_enhancement_by_s3prl_tpu_torch.models.lstm import (
    FORM_VARIABLES,
    Capture,
    LstmForms,
    LSTMStack,
    stream_forms,
)
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import library
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L
from speech_enhancement_by_s3prl_tpu_torch.utils import costs

BF16 = torch.bfloat16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INT8, XW, HS, VJP = "SE_LSTM_XW_INT8", "SE_LSTM_XW_BF16", "SE_PALLAS_HS_BF16", "SE_PALLAS_VJP_BF16"
MXU, GATES = "SE_PALLAS_MXU_BF16", "SE_PALLAS_GATES_BF16"
# an f32 recurrence against JAX's: the same f32 arithmetic on the same
# (rounded) operands in other orders (tests/test_torch_port_lstm.py's limit)
RECURRENCE_ATOL = 2e-6
# hs stored in bf16: the two sides' f32 values differ by ~1e-7, so their
# roundings agree but where a value lies that close to a boundary (one bf16
# unit there); every element within one unit, at least this share identical
SAME_SHARE = 0.99
# the gates form against the interpret-mode kernel with XLA's default excess
# precision (three roundings to bf16 dropped there): hs within one bf16 unit
# of its rounding on at least GATES_ULP_SHARE of the elements, and the RMS
# difference at most GATES_RMS of the largest |hs|. Measured at (3, 41, 16):
# 1.4e-3 at the first step, 3.0e-3 at most; shares 0.846 (gates) / 0.841
# (with MXU and HS), RMS 8.6e-4 / 1.1e-3, the same for the JAX kernel with
# every rounding. The dropped roundings move hs as far as the whole gates
# form does (the f32 form reads 0.846 / 0.842, 7.3e-4 / 8.4e-4), so this
# window does not tell the forms apart: the limit that does is the one
# against the kernel with every rounding (RECURRENCE_ATOL).
GATES_ULP_SHARE, GATES_RMS = 0.8, 2e-3
# a stack's output and gradients (tests/test_torch_port_lstm_streams.py's
# limits): within these on at least STACK_SHARE of the elements
STACK_ATOL, STACK_RTOL, STACK_SHARE = 5e-6, 2e-5, 0.99
# the capture scorer's gate cotangent, relative to its largest |value|
REL_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops on one thread (a busy multi-worker run
    starves torch's default pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setenv(mp, *names):
    for name in FORM_VARIABLES:
        mp.delenv(name, raising=False)
    for name in names:
        mp.setenv(name, "1")


def _inputs(B, T, H, seed, ndir=2):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((ndir, B, T, 4 * H)).astype(np.float32)
    w_hh_t = (rng.standard_normal((ndir, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    return xw, w_hh_t


def _ordered(x):
    bits = torch.from_numpy(np.array(x, np.float32)).to(BF16).view(torch.int16)
    bits = bits.to(torch.int32)
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def _bf16_shares(a, b):
    """(share within one bf16 unit, share identical) of two arrays as their
    bf16 roundings."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float((_ordered(a) - _ordered(b)).abs().le(1).double().mean()), float(np.mean(a == b))


def _held(port, ref, f32_form, tol, what):
    err = np.abs(np.asarray(port, np.float64) - ref).max()
    far = np.abs(np.asarray(f32_form, np.float64) - ref).max()
    assert err <= tol < far, f"{what}: {err:.3e} (the f32 form {far:.3e}), limit {tol}"


def _held_bf16(port, ref, f32_form, what):
    ulp, same = _bf16_shares(port, ref)
    assert ulp == 1.0 and same >= SAME_SHARE, f"{what}: {ulp}, {same}"
    assert _bf16_shares(f32_form, ref)[1] < SAME_SHARE, f"{what}: the f32 form passes"


def _window(port, ref):
    """(share within one bf16 unit, RMS difference over the largest |ref|)."""
    rms = float(np.sqrt(np.mean((np.asarray(port, np.float64) - ref) ** 2)) / np.abs(ref).max())
    return _bf16_shares(port, ref)[0], rms


# -- the kernels ---------------------------------------------------------------

B1_SHAPE = (3, 41, 16)
# the Pallas B1's forms held here: (variables, hs stored in bf16)
B1_FORMS = {"mxu": ((MXU,), False), "mxu+hs": ((MXU, HS), True), "gates": ((GATES,), False),
            "all": ((MXU, GATES, HS), True)}

# a bidirectional stack: 2 layers of H = 8 over (B, T, D)
B, T, D, H = 2, 11, 6, 8


def _x_np(seed):
    return np.random.default_rng(seed).standard_normal((B, T, D)).astype(np.float32)


def _cot(H2, seed):
    return np.cos(np.arange(B * T * H2).reshape(B, T, H2) * 0.37 + seed).astype(np.float32)


def _flax_params(bidirectional, seed):
    """Seeded weights (the port's initialization) as a flax tree."""
    port = LSTMStack(D, H, num_layers=2, bidirectional=bidirectional,
                     generator=torch.Generator().manual_seed(seed))
    return jax.tree.map(jnp.asarray, state_dict_to_flax(port.state_dict()))


def _port_stack(bidirectional, params, dt="f32"):
    port = LSTMStack(D, H, num_layers=2, bidirectional=bidirectional,
                     compute_dtype=BF16 if dt == "bf16" else torch.float32)
    port.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    return port


def _jax_stack(bidirectional, dt="f32", **kw):
    return JLSTMStack(H, num_layers=2, bidirectional=bidirectional,
                      compute_dtype=jnp.bfloat16 if dt == "bf16" else jnp.float32,
                      use_pallas=True, pallas_interpret=True, **kw)


# the bidirectional stack's cases without a gradient: the variables
STACK_FORMS = {"mxu": (MXU,), "gates": (GATES,), "all": (MXU, GATES, HS)}


@pytest.fixture(scope="module")
def jax_kernels():
    """``lstm_bidir_pallas_tm`` in interpret mode under each of ``B1_FORMS``
    (XLA's defaults), and the bidirectional flax stack on its Pallas path
    under ``STACK_FORMS`` (no gradient)."""
    out = {}
    xw, w = _inputs(*B1_SHAPE, seed=0)
    params = _flax_params(True, 4)
    x = jnp.asarray(_x_np(3))
    with pytest.MonkeyPatch.context() as mp:
        for name, (names, _) in B1_FORMS.items():
            _setenv(mp, *names)
            out[("b1", name)] = np.asarray(JP.lstm_bidir_pallas_tm(
                jnp.asarray(xw), jnp.asarray(w), interpret=True).astype(jnp.float32))
        for name, names in STACK_FORMS.items():
            _setenv(mp, *names)
            jstack = _jax_stack(True)
            out[("stack", name)] = np.asarray(
                jax.jit(lambda p, jstack=jstack: jstack.apply(p, x))(params))
    return out


@pytest.fixture(scope="module")
def jax_exact(tmp_path_factory):
    """The gates cases of ``jax_kernels`` computed by
    ``tests/torch_port_lstm_forms_worker.py``, with XLA's excess precision
    off."""
    tmp = tmp_path_factory.mktemp("forms")
    xw, w = _inputs(*B1_SHAPE, seed=0)
    params = {"/".join(k.key for k in path): np.asarray(leaf) for path, leaf in
              jax.tree_util.tree_flatten_with_path(_flax_params(True, 4))[0]}
    jobs = {}
    for name in ("gates", "all"):
        env = ",".join(B1_FORMS[name][0])
        jobs.update({f"job/b1_{name}/kind": "kernel", f"job/b1_{name}/env": env,
                     f"job/b1_{name}/xw": xw, f"job/b1_{name}/w_hh_t": w})
        jobs.update({f"job/stack_{name}/kind": "stack", f"job/stack_{name}/env": env,
                     f"job/stack_{name}/x": _x_np(3), f"job/stack_{name}/hidden": H,
                     f"job/stack_{name}/layers": 2})
        jobs.update({f"job/stack_{name}/param/{k}": v for k, v in params.items()})
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **jobs)
    env = {k: v for k, v in os.environ.items() if k not in FORM_VARIABLES}
    run = subprocess.run([sys.executable, os.path.join(ROOT, "tests",
                                                        "torch_port_lstm_forms_worker.py"),
                          str(src), str(dst)], env=env, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    got = np.load(dst)
    return {(kind, name): got[f"{kind}_{name}"] for kind in ("b1", "stack")
            for name in ("gates", "all")}


def _b1_ports(x, w, form):
    """B1 in ``form`` (a key of ``B1_FORMS``): its plain version, the cluster
    kernel's model and the wrapper, each hs widened to f32."""
    names, hs_bf16 = B1_FORMS[form]
    mxu, gates = MXU in names, GATES in names
    dt = BF16 if hs_bf16 else torch.float32
    wk = L._bf16(w) if mxu else w  # the MXU form's W_hh^T, rounded before the kernel
    return [L.lstm_bidir_tm_ref(x, wk, h_bf16=mxu, hs_dtype=dt, gates_bf16=gates).float(),
            L.lstm_bidir_tm_fwd_model(x, wk, batch_block=2, h_bf16=mxu, out_dtype=dt,
                                      gates_bf16=gates).float(),
            L.lstm_bidir_tm(x, w, hs_dtype=dt, mxu_bf16=mxu, gates_bf16=gates)]


@pytest.mark.parametrize("form", ["mxu", "mxu+hs"])
def test_mxu_form_matches_pallas(jax_kernels, form):
    """SE_PALLAS_MXU_BF16, alone and with SE_PALLAS_HS_BF16: the bf16-h form
    on W_hh^T rounded to bf16, its plain version, model and wrapper against
    ``lstm_bidir_pallas_tm``."""
    xw, w = (torch.from_numpy(t) for t in _inputs(*B1_SHAPE, seed=0))
    ref = jax_kernels[("b1", form)]
    f32 = L.lstm_bidir_tm_ref(xw, w).numpy()
    for port in _b1_ports(xw, w, form):
        if B1_FORMS[form][1]:
            _held_bf16(port.numpy(), ref, f32, form)
        else:
            _held(port.numpy(), ref, f32, RECURRENCE_ATOL, form)


@pytest.mark.parametrize("form", ["gates", "all"])
def test_gates_form_matches_pallas_rounding_every_op(jax_exact, form):
    """SE_PALLAS_GATES_BF16 (and with MXU and HS): plain version, model and
    wrapper against the interpret-mode kernel with XLA's excess precision off,
    every bf16 op of its source rounded."""
    xw, w = (torch.from_numpy(t) for t in _inputs(*B1_SHAPE, seed=0))
    ref = jax_exact[("b1", form)]
    f32 = L.lstm_bidir_tm_ref(xw, w).numpy()
    for port in _b1_ports(xw, w, form):
        if B1_FORMS[form][1]:
            _held_bf16(port.numpy(), ref, f32, form)
        else:
            _held(port.numpy(), ref, f32, RECURRENCE_ATOL, form)


@pytest.mark.parametrize("form", ["gates", "all"])
def test_gates_form_within_the_window_of_pallas_with_excess_precision(jax_kernels,
                                                                       jax_exact, form):
    """The same against the interpret-mode kernel as the JAX package's tests
    run it (XLA's defaults, three roundings dropped): inside the stated
    window, as the kernel with every rounding is."""
    xw, w = (torch.from_numpy(t) for t in _inputs(*B1_SHAPE, seed=0))
    ref = jax_kernels[("b1", form)]
    ulp, rms = _window(jax_exact[("b1", form)], ref)
    assert ulp >= GATES_ULP_SHARE and rms <= GATES_RMS, (ulp, rms)
    for port in _b1_ports(xw, w, form):
        ulp, rms = _window(port.numpy(), ref)
        assert ulp >= GATES_ULP_SHARE and rms <= GATES_RMS, (form, ulp, rms)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("carried", [False, True])
def test_int8_form_matches_the_scan(dt, carried, monkeypatch):
    """SE_LSTM_XW_INT8 on one direction: ``quantize_xw_int8`` equals the
    scan's q and scale bit for bit, and B1 on them (plain version, model,
    wrapper), in f32 and in the bf16-h form, stateless and from a carried
    state, against ``_lstm_scan``; the f32 xw fails the limit."""
    Bk, Tk, Hk = 3, 29, 12  # H not a multiple of 8
    xw, w = _inputs(Bk, Tk, Hk, seed=5, ndir=1)
    rng = np.random.default_rng(6)
    state = (np.tanh(rng.standard_normal((1, Bk, Hk))).astype(np.float32),
             rng.standard_normal((1, Bk, Hk)).astype(np.float32))
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    _setenv(monkeypatch, INT8)
    out = _lstm_scan(jnp.asarray(xw), jnp.asarray(w).astype(jdt), Hk, 4, jdt,
                     init_state=tuple(map(jnp.asarray, state)) if carried else None,
                     return_final=carried)
    ref, ref_fin = (out if carried else (out, None))
    ref = np.asarray(ref)
    xj = jnp.asarray(xw)
    sj = jnp.abs(xj).max(axis=-1, keepdims=True) / 127.0 + 1e-12
    qj = jnp.clip(jnp.round(xj / sj), -127, 127).astype(jnp.int8)
    q, scale = L.quantize_xw_int8(torch.from_numpy(xw))
    assert q.dtype == torch.int8 and scale.shape == (1, Bk, Tk, 1)
    assert np.array_equal(q.numpy(), np.asarray(qj))
    assert np.array_equal(scale.numpy(), np.asarray(sj))
    h_bf16 = dt == "bf16"
    wt = torch.from_numpy(np.array(jnp.asarray(w).astype(jdt).astype(jnp.float32)))
    st = tuple(torch.from_numpy(s) for s in state) if carried else None
    f32 = L.lstm_bidir_tm_ref(torch.from_numpy(xw), wt, state=st, h_bf16=h_bf16).numpy()
    ports = [L.lstm_bidir_tm_ref(q, wt, state=st, return_state=carried, h_bf16=h_bf16,
                                 xw_scale=scale),
             L.lstm_bidir_tm(q, wt, state=st, return_state=carried, h_bf16=h_bf16,
                             xw_scale=scale)]
    model = L.lstm_bidir_tm_fwd_model(q, wt, batch_block=2, state=st, h_bf16=h_bf16,
                                      xw_scale=scale)
    for port in ports:
        hs = port[0] if carried else port
        _held(hs.numpy(), ref, f32, RECURRENCE_ATOL, f"int8 {dt}")
        if carried:
            for got, want in zip(port[1], ref_fin):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           atol=RECURRENCE_ATOL, rtol=0)
    _held(model.numpy(), ref, f32, RECURRENCE_ATOL, f"int8 {dt} model")


def test_the_forms_the_kernels_take_and_refuse():
    """The wrappers' forms on the CPU: an int8 xw needs its scale (and the
    scale an int8 xw), is inference only, and reaches neither B2 nor B6;
    the MXU and gates forms change nothing under a gradient; the bf16-h form
    stores bf16 hs in B1."""
    xw, w = (torch.from_numpy(t) for t in _inputs(2, 5, 8, seed=1, ndir=1))
    q, scale = L.quantize_xw_int8(xw)
    with pytest.raises(ValueError):
        L.lstm_bidir_tm(q, w)
    with pytest.raises(ValueError):
        L.lstm_bidir_tm(xw, w, xw_scale=scale)
    with pytest.raises(ValueError):
        L.lstm_bidir_tm(q, w, xw_scale=scale[..., :2, :])
    with pytest.raises(RuntimeError, match="inference only"):
        L.lstm_bidir_tm(q, w.clone().requires_grad_(), xw_scale=scale)
    with pytest.raises(ValueError):
        L.lstm_bidir_tm_fc(q, w)
    x2, w2 = (torch.from_numpy(t) for t in _inputs(2, 5, 8, seed=1))
    with pytest.raises(ValueError):
        L.lstm_bidir_bb(L.quantize_xw_int8(x2)[0], w2)
    hs = L.lstm_bidir_tm(xw, w, h_bf16=True, hs_dtype=BF16)
    assert torch.equal(hs, L.lstm_bidir_tm_ref(xw, w, h_bf16=True).to(BF16).float())
    a, b = (t.clone().requires_grad_() for t in (x2, w2))
    plain = L.lstm_bidir_tm(a, b)
    formed = L.lstm_bidir_tm(a, b, mxu_bf16=True, gates_bf16=True)
    assert torch.equal(plain, formed)
    # on a CPU tensor the wrapper counts no launch
    assert L.lstm_bidir_tm.gates_bf16 == L.lstm_bidir_tm.xw_int8 == 0


def test_stream_forms_reads_every_variable(monkeypatch):
    """Int8 wins over bf16 for the xw, as JAX's ``_xw_mode`` reads them."""
    _setenv(monkeypatch)
    assert stream_forms() == LstmForms("f32", False, False, False, False)
    _setenv(monkeypatch, XW, INT8, MXU)
    assert stream_forms() == LstmForms("int8", False, False, True, False)
    _setenv(monkeypatch, XW, HS, VJP, GATES)
    assert stream_forms() == LstmForms("bf16", True, True, False, True)


# -- the stack -----------------------------------------------------------------

def _port_run(port, x, cot, grads=True):
    with torch.no_grad():
        out_eval = port(torch.from_numpy(x)).numpy()
    if not grads:
        return out_eval, None, None
    out = port(torch.from_numpy(x))
    names, tensors = zip(*port.named_parameters())
    g = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), tensors)
    return out_eval, out.detach().numpy(), {n: t.numpy() for n, t in zip(names, g)}


def _share_within(a, b, tol, relative=False):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max() if relative else 1.0
    return float(np.mean(np.abs(a - b) <= tol * scale))


@pytest.mark.parametrize("form", list(STACK_FORMS))
def test_bidirectional_stack_forms_match_flax(jax_kernels, jax_exact, form, monkeypatch):
    """A bidirectional ``LSTMStack`` without a gradient under MXU, GATES and
    MXU + GATES + HS against the flax stack on its Pallas path (the gates
    cases with every rounding, XLA's excess precision off); the f32 form
    fails. Under a gradient the forms change nothing (bit for bit)."""
    params = _flax_params(True, 4)
    x, cot = _x_np(3), _cot(2 * H, 1)
    ref = (jax_exact if GATES in STACK_FORMS[form] else jax_kernels)[("stack", form)]
    port = _port_stack(True, params)
    _setenv(monkeypatch)
    f32_eval, f32_train, f32_grads = _port_run(port, x, cot)
    _setenv(monkeypatch, *STACK_FORMS[form])
    got_eval, got_train, got_grads = _port_run(port, x, cot)
    assert _share_within(got_eval, ref, STACK_ATOL) >= STACK_SHARE, form
    assert _share_within(f32_eval, ref, STACK_ATOL) < STACK_SHARE, form
    assert np.array_equal(got_train, f32_train)
    assert all(np.array_equal(got_grads[n], f32_grads[n]) for n in got_grads)


def test_jax_gradient_reads_none_of_the_three(monkeypatch):
    """JAX's custom VJP reads neither B1 form, and its Pallas path keeps an
    f32 xw under INT8: its stack's primal and gradients under all three
    variables are the f32 ones bit for bit, as the port's (and the port's
    bidirectional stack under INT8, with XW_BF16 too, is the f32 stack)."""
    params = _flax_params(True, 4)
    x_np, cot_np = _x_np(3), _cot(2 * H, 1)
    x, cot = jnp.asarray(x_np), jnp.asarray(cot_np)
    sides = {}
    for names in ((), (MXU, GATES, INT8)):
        _setenv(monkeypatch, *names)
        jstack = _jax_stack(True)

        def loss(p, jstack=jstack):
            y = jstack.apply(p, x)
            return (y * cot).sum(), y

        (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        sides[names] = (np.asarray(y), jax.tree.leaves(jax.device_get(g)))
    (y0, g0), (y1, g1) = sides.values()
    assert np.array_equal(y0, y1) and all(np.array_equal(a, b) for a, b in zip(g0, g1))
    port = _port_stack(True, params)
    _setenv(monkeypatch)
    base = _port_run(port, x_np, cot_np)
    for names in ((INT8,), (INT8, XW)):
        _setenv(monkeypatch, *names)
        got = _port_run(port, x_np, cot_np)
        assert np.array_equal(got[0], base[0]) and np.array_equal(got[1], base[1])
        assert all(np.array_equal(got[2][n], base[2][n]) for n in base[2])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_one_direction_stack_under_int8_matches_the_scan(dt, monkeypatch):
    """A one-direction ``LSTMStack`` under SE_LSTM_XW_INT8 against the flax
    stack (its ``lax.scan`` cell), in f32 and bf16 compute: the output
    without a gradient, the output and every parameter gradient and the
    input's gradient with one (JAX's gradient through the scale), and from a
    carried state; the f32 form fails each; INT8 with XW_BF16 is INT8."""
    params = _flax_params(False, 6)
    x, cot = _x_np(8), _cot(H, 2)
    rng = np.random.default_rng(10)
    state = [(np.tanh(rng.standard_normal((B, H))).astype(np.float32),
              rng.standard_normal((B, H)).astype(np.float32)) for _ in range(2)]
    _setenv(monkeypatch, INT8)
    jstack = _jax_stack(False, dt)

    def loss(p, xx):
        y = jstack.apply(p, xx)
        return (y * jnp.asarray(cot)).sum(), y

    (_, ref), (ref_g, ref_gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    ref, ref_gx = np.asarray(ref), np.asarray(ref_gx)
    ref_g = {n: t.numpy() for n, t in flax_to_state_dict(jax.device_get(ref_g)).items()}
    ref_s, ref_fin = jstack.apply(params, jnp.asarray(x),
                                  initial_state=[tuple(map(jnp.asarray, s)) for s in state],
                                  return_state=True)
    port = _port_stack(False, params, dt)
    t_state = [tuple(torch.from_numpy(s) for s in st) for st in state]

    def run():
        out_eval, out, grads = _port_run(port, x, cot)
        xt = torch.from_numpy(x).requires_grad_()
        gx = torch.autograd.grad((port(xt) * torch.from_numpy(cot)).sum(), xt)[0].numpy()
        with torch.no_grad():
            carried, fin = port(torch.from_numpy(x), initial_state=t_state, return_state=True)
        return out_eval, out, grads, gx, carried.numpy(), fin

    got = run()
    _setenv(monkeypatch, INT8, XW)
    again = run()
    _setenv(monkeypatch)
    f32 = run()
    for a, b in zip(got[:2] + got[3:5], again[:2] + again[3:5]):
        assert np.array_equal(a, b)
    for i, want in ((0, ref), (1, ref), (4, np.asarray(ref_s))):
        assert _share_within(got[i], want, STACK_ATOL) >= STACK_SHARE, i
        assert _share_within(f32[i], want, STACK_ATOL) < STACK_SHARE, i
    for grads, want, side in ((got, ref_gx, "port"), (f32, ref_gx, "f32")):
        share = _share_within(grads[3], want, STACK_RTOL, relative=True)
        assert (share >= STACK_SHARE) == (side == "port"), (side, share)
    hits = np.concatenate([(np.abs(got[2][n] - ref_g[n])
                            <= STACK_RTOL * np.abs(ref_g[n]).max()).ravel() for n in ref_g])
    far = np.concatenate([(np.abs(f32[2][n] - ref_g[n])
                           <= STACK_RTOL * np.abs(ref_g[n]).max()).ravel() for n in ref_g])
    assert hits.mean() >= STACK_SHARE > far.mean(), (hits.mean(), far.mean())
    for (h, c), (rh, rc) in zip(got[5], ref_fin):
        np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=STACK_ATOL, rtol=0)
        np.testing.assert_allclose(c.numpy(), np.asarray(rc), atol=STACK_ATOL, rtol=0)


def test_capture_gate_cotangent_under_mxu_matches_jax(monkeypatch):
    """The capture scorer under SE_PALLAS_MXU_BF16: the layer below the
    captured one runs B1 in the MXU form (JAX's primal below its
    perturbation), the captured one the f32 B2 (JAX's custom VJP); the gate
    cotangent at the recorded ``l1_xw`` against JAX's at its zero
    perturbation."""
    layer = 1
    x, cot = _x_np(11), _cot(2 * H, 3)
    _setenv(monkeypatch, MXU)
    jstack = _jax_stack(True, capture_layer=layer)
    params = _flax_params(True, 7)["params"]
    zero = {f"l{layer}_xw": jnp.zeros((2, B, T, 4 * H), jnp.float32)}

    def loss(perturbations):
        y, _ = jstack.apply({"params": params, "perturbations": perturbations},
                            jnp.asarray(x), mutable=["intermediates"])
        return (y * jnp.asarray(cot)).sum()

    ref = np.asarray(jax.jit(jax.grad(loss))(zero)[f"l{layer}_xw"])
    port = _port_stack(True, {"params": params})

    def gate_cot():
        cap = Capture(layer)
        out = port(torch.from_numpy(x), capture=cap)
        return torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                   cap[f"l{layer}_xw"])[0].numpy()

    got = gate_cot()
    _setenv(monkeypatch)
    f32 = gate_cot()
    scale = np.abs(ref).max()
    _held(got / scale, ref / scale, f32 / scale, REL_TOL, "gate cotangent")


def test_streamer_under_int8_matches_jax_streamer(monkeypatch):
    """``StatefulStreamer`` of a one-direction ``Residual`` head under
    SE_LSTM_XW_INT8 (each chunk's xw quantized on its own, as JAX's scan
    quantizes a chunk) against the JAX streamer, within the streamer's limit
    of the RMS; the f32 form fails it. A clone made before the variable was
    set follows it: the forms are read at every forward, and nothing caches
    them."""
    from speech_enhancement_by_s3prl_tpu.models.heads import build_head as j_build_head
    from speech_enhancement_by_s3prl_tpu.ops.features import (
        OnlinePreprocessor as JPreprocessor,
    )
    from speech_enhancement_by_s3prl_tpu.ops.streaming import StatefulStreamer as JStreamer
    from speech_enhancement_by_s3prl_tpu_torch.models.heads import build_head
    from speech_enhancement_by_s3prl_tpu_torch.ops.features import (
        OnlinePreprocessor,
        get_feat_config,
    )
    from speech_enhancement_by_s3prl_tpu_torch.ops.streaming import StatefulStreamer

    wav_tol, n_mels = 5e-5, 8  # tests/test_torch_port_stream_stateful.py's
    fl = [get_feat_config("mel", 0, log=True, delta=0, cmvn=False),
          get_feat_config("linear", 0), get_feat_config("uphase", 0)]
    jpre = JPreprocessor(feat_list=fl, n_mels=n_mels)
    cfg = dict(input_size=jpre.feat_dims()[0], output_size=201, hidden_size=16, num_layers=2,
               bidirectional=False, activation="Sigmoid", cmvn=False)
    jmodel = j_build_head("Residual", **cfg)
    f0 = jpre.extract(jnp.zeros((1, 1, 16000), jnp.float32), fl)
    params = jmodel.init(jax.random.PRNGKey(0), features=f0[0], linears=f0[1])
    model = build_head("Residual", **cfg).eval()
    model.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    pre = OnlinePreprocessor(feat_list=fl, n_mels=n_mels)
    t = np.arange(16000 * 2 + 333) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * np.random.default_rng(0).standard_normal(
        t.shape)).astype(np.float32)
    sizes = np.random.default_rng(1).integers(900, 9000, size=64)

    def drive(streamer):
        out, pos = [], 0
        for size in sizes:
            if pos >= len(wav):
                break
            out.append(streamer.push(wav[pos:pos + int(size)]))
            pos += int(size)
        out.append(streamer.push(wav[pos:]))
        out.append(streamer.flush())
        return np.concatenate(out)

    _setenv(monkeypatch)
    proto = StatefulStreamer(model, pre, feat_cfg=fl[0], frames_per_chunk=40)
    f32 = drive(proto.clone())
    _setenv(monkeypatch, INT8)
    want = drive(JStreamer(params, jmodel, jpre, feat_cfg=fl[0], frames_per_chunk=40))
    got = drive(proto.clone())
    rms = np.sqrt(np.mean(want ** 2))
    assert got.shape == want.shape
    err, far = np.abs(got - want).max() / rms, np.abs(f32 - want).max() / rms
    assert err <= wav_tol < far, (err, far)


# -- what records and counts the forms ------------------------------------------

class _Stack(torch.nn.Module):
    def __init__(self, bidirectional):
        super().__init__()
        self.lstm = LSTMStack(D, H, num_layers=1, bidirectional=bidirectional,
                              generator=torch.Generator().manual_seed(2))

    def forward(self, x):
        return self.lstm(x)


def _recurrence_nodes(program_bytes):
    """The inputs of each ``se_torch::lstm_recurrence`` call a saved program
    records, from its serialized graph."""
    z = zipfile.ZipFile(io.BytesIO(program_bytes))
    model = json.loads(z.read(next(n for n in z.namelist() if n.endswith("models/model.json"))))
    found = []

    def walk(o):
        if isinstance(o, dict):
            if o.get("target") == "torch.ops.se_torch.lstm_recurrence.default":
                found.append({i["name"]: i["arg"] for i in o["inputs"]})
            for v in o.values():
                walk(v)
        elif isinstance(o, list):
            for v in o:
                walk(v)

    walk(model)
    return found


def _export(module, x):
    with torch.no_grad():
        program = torch.export.export(module, (x,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


@pytest.mark.parametrize("names,bidirectional", [((), True), ((MXU, GATES, HS), True),
                                                 ((INT8,), False)])
def test_exported_program_records_the_forms(names, bidirectional, monkeypatch):
    """An exported program bakes the forms in as the op's arguments, as the
    JAX export bakes the variables in when it traces. With none set the call
    passes the op's four arguments of before the gates and int8 forms, so
    programs exported then load and replay: the program, loaded, replays the
    stack bit for bit under any setting."""
    x = torch.from_numpy(_x_np(4))
    module = _Stack(bidirectional).eval()
    _setenv(monkeypatch, *names)
    data = _export(module, x)
    with torch.no_grad():
        want = module(x)
    nodes = _recurrence_nodes(data)
    assert len(nodes) == 1
    args = nodes[0]
    if not names:
        assert list(args) == ["xw", "w_hh_t", "h_bf16", "hs_bf16"]
        assert args["h_bf16"] == args["hs_bf16"] == {"as_bool": False}
    elif bidirectional:
        assert args["h_bf16"] == args["hs_bf16"] == args["gates_bf16"] == {"as_bool": True}
    else:
        assert "as_tensor" in args["xw_scale"]
    _setenv(monkeypatch)
    loaded = torch.export.load(io.BytesIO(data)).module()
    assert torch.equal(loaded(x), want)


def test_opcheck_of_the_new_op_arguments():
    """``se_torch::lstm_recurrence`` with the gates form and with an int8 xw
    and its scale passes ``torch.library.opcheck``, and its four-argument
    call is the call with the defaults."""
    xw, w = (torch.from_numpy(t) for t in _inputs(2, 5, 8, seed=3))
    q, scale = L.quantize_xw_int8(xw[:1].contiguous())
    for args in ((xw, w, False, False, True, None), (xw, w, True, True, True, None),
                 (q, w[:1].contiguous(), False, False, False, scale),
                 (q, w[:1].contiguous(), True, False, False, scale)):
        torch.library.opcheck(library.lstm_recurrence, args)
    assert torch.equal(library.lstm_recurrence(xw, w, False, False),
                       library.lstm_recurrence(xw, w, False, False, False, None))


def test_int8_and_mxu_cost(monkeypatch):
    """``b1_call_cost``: an int8 xw at one byte an element plus its f32
    scale a (direction, row, step); the MXU form (the bf16-h form on bf16
    W_hh^T values) at one bf16 pass, as the bf16-h form; the gates form as
    f32."""
    xw, w = (torch.from_numpy(t) for t in _inputs(3, 7, 8, seed=2))
    q, scale = L.quantize_xw_int8(xw)
    f32 = costs.b1_call_cost(xw, w)
    int8 = costs.b1_call_cost(q, w, xw_scale=scale)
    assert f32.nbytes - int8.nbytes == 3 * xw.numel() - 4 * scale.numel()
    assert costs.b1_call_cost(xw, w, True).flops == {"bf16": f32.flops["f32"]}
    assert costs.b1_form_bound(3, 7, 8, "int8") == costs.bound_of(int8)
    assert costs.b1_form_bound(3, 7, 8, "gates") == costs.bound_of(f32)
    _setenv(monkeypatch, MXU, GATES)
    stack = _Stack(True)
    with torch.no_grad():
        counted = costs.program_cost(stack, torch.from_numpy(_x_np(1)))
    assert counted["kernels"] == {"B1": 1} and counted["flops_by_class"].get("bf16", 0) > 0


def test_feature_extraction_leaves_no_reference_cycle():
    """The preprocessor's features go with the call that made them: no
    reference cycle holds them until the garbage collector runs (at the
    enhance mode's 768 rows a cycle held 3.7 GiB a call on the card)."""
    import gc

    from speech_enhancement_by_s3prl_tpu_torch.ops.features import (
        OnlinePreprocessor,
        get_feat_config,
    )

    fl = [get_feat_config("mfcc", 0), get_feat_config("mel", 1, log=True, delta=2),
          get_feat_config("linear", 0), get_feat_config("phase", 1)]
    pre = OnlinePreprocessor(feat_list=fl, n_mels=8)
    wavs = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 2, 4000)).astype(
        np.float32))
    first = [t.clone() for t in pre(wavs)]
    gc.collect()
    gc.disable()
    try:
        again = pre(wavs)
        del again
        assert gc.collect() == 0
    finally:
        gc.enable()
    assert all(torch.equal(a, b) for a, b in zip(first, pre(wavs)))
