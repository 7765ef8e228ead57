"""The bf16 stream forms of the LSTM kernels against the JAX package, on the CPU.

The JAX package reads three variables at trace time: ``SE_LSTM_XW_BF16``
(the input projection stored in bf16, on the scan and the Pallas path),
``SE_PALLAS_HS_BF16`` (B1 stores hs in bf16) and ``SE_PALLAS_VJP_BF16`` (the
custom VJP's forward stores hs and cs in bf16, its backward reads them,
rounds W_hh^T, the dh cotangent and the da of the dh product to bf16). The
port reads the same variables in ``models/lstm.py`` and hands them to its
kernels as arguments (``ops/cuda/lstm_kernel.py``); on the CPU the wrappers
run the plain versions. Held here, each form set through the environment on
both sides:

- the plain versions and the kernels' PyTorch models against the Pallas
  kernels in interpret mode: ``lstm_bidir_pallas_tm``, ``_tm_fwd_with_cell``,
  ``_tm_bwd`` and the custom VJP ``lstm_bidir_tm``;
- ``LSTMStack``, bidirectional (against flax on its Pallas path) and one
  direction (JAX's ``lax.scan`` cell, which honours only the xw variable):
  outputs with and without a gradient and every parameter gradient, each
  variable alone, all three, all three in bf16 compute, the one-direction
  cell from a carried state, and the HS / VJP variables changing nothing of a
  one-direction stack;
- the per-row gate cotangent that the capture scorer reads under the VJP
  form.

The forms that change the function computed (``SE_PALLAS_MXU_BF16``,
``SE_PALLAS_GATES_BF16``, ``SE_LSTM_XW_INT8``) are held in
``tests/test_torch_port_lstm_forms.py``.

Every limit is set apart from the f32 form (no variable set), which fails it
where the form changes the result. JAX reads the variables when it traces:
each setting here gets a function of its own (eager, or a fresh ``jax.jit``),
so no trace made under one setting is reused under another.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_enhancement_by_s3prl_tpu.models.lstm import LSTMStack as JLSTMStack
from speech_enhancement_by_s3prl_tpu.ops.pallas import lstm_kernel as JP
from speech_enhancement_by_s3prl_tpu_torch.models.convert import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from speech_enhancement_by_s3prl_tpu_torch.models.lstm import (
    FORM_VARIABLES,
    Capture,
    LSTMStack,
)
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L

BF16 = torch.bfloat16
XW, HS, VJP = "SE_LSTM_XW_BF16", "SE_PALLAS_HS_BF16", "SE_PALLAS_VJP_BF16"
FORMS = {"f32": (), "xw": (XW,), "hs": (HS,), "vjp": (VJP,), "all": (XW, HS, VJP)}
# an f32 value of a form (hs read from a bf16 xw, dxw and dW_hh^T of the
# residual form) against JAX: both sides run the same f32 arithmetic on the
# same rounded inputs in other orders, absolute for h (|h| <= 1, as
# tests/test_torch_port_lstm.py holds the f32 recurrence) and relative to the
# largest |value| for the rest (the bwd tolerance of the phases tests)
H_ATOL, REL_TOL = 2e-6, 1e-5
# a stream stored in bf16 (hs, cs, a bf16 dxw): the two sides' f32 values
# differ by ~1e-7, so their roundings agree but where a value lies that close
# to a rounding boundary; there they differ by one bf16 unit. Held: every
# element within one unit, at least this share identical. Measured 1.0 at
# every case here; the f32 form's values are not bf16 numbers (share ~0).
SAME_SHARE = 0.99
# a stack's output (absolute) and gradients (relative to the largest |value|
# of each): within these on at least STACK_SHARE of the elements. A rounding
# to bf16 that flips on one side (an xw, an hs of a lower layer, a da of the
# dh product) moves the later values by a fraction of a bf16 unit, so a
# maximum alone would hold the flips, not the function; measured: every
# element within the tolerance at every case here. The f32 form lies ~1e-3
# away on nearly every element where the form changes the result.
STACK_ATOL, STACK_RTOL, STACK_SHARE = 5e-6, 2e-5, 0.99
# each parameter's gradient alone, on this share: a bias gradient (4H
# elements, each a sum of bf16 da terms under the xw form) moves a whole
# element with one flipped rounding (measured 31 of 32 within at one case)
STACK_PARAM_SHARE = 0.9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops on one thread (a busy multi-worker run
    starves torch's default pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setenv(mp, form):
    for name in FORM_VARIABLES:
        mp.delenv(name, raising=False)
    for name in FORMS[form]:
        mp.setenv(name, "1")


def _bf16_shares(a, b):
    """(share within one bf16 unit, share identical) of two arrays, ``b``
    holding bf16 values."""
    def ordered(x):
        bits = torch.from_numpy(np.array(x, np.float32)).to(BF16).view(torch.int16)
        bits = bits.to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float((ordered(a) - ordered(b)).abs().le(1).double().mean()), float(np.mean(a == b))


def _held_bf16(port, ref, f32_form, what):
    ulp, same = _bf16_shares(port, ref)
    assert ulp == 1.0 and same >= SAME_SHARE, f"{what}: {ulp}, {same}"
    assert _bf16_shares(f32_form, ref)[1] < SAME_SHARE, f"{what}: the f32 form passes"


def _held(port, ref, f32_form, tol, relative, what):
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max() if relative else 1.0
    err = np.abs(np.asarray(port, np.float64) - ref).max() / scale
    far = np.abs(np.asarray(f32_form, np.float64) - ref).max() / scale
    assert err <= tol < far, f"{what}: {err:.3e} (the f32 form {far:.3e}), limit {tol}"


def _inputs(B, T, H, seed, ndir=2):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((ndir, B, T, 4 * H)).astype(np.float32)
    w_hh_t = (rng.standard_normal((ndir, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    dhs = rng.standard_normal((ndir, B, T, H)).astype(np.float32)
    return xw, w_hh_t, dhs


def _bf16_np(x):
    """x rounded to bf16, as f32 numpy."""
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


# (B, T, H): H not a multiple of 8 (the stacks below take H = 8)
KERNEL_SHAPES = [(3, 11, 12)]
# (variables, xw dtype) of each kernel comparison: the xw form alone, the hs
# form (B1) and the residual form (B2 and the custom VJP) with either xw
KERNEL_FORMS = [("f32", "bf16"), ("hs", "f32"), ("hs", "bf16"), ("vjp", "f32"),
                ("vjp", "bf16")]


@pytest.fixture(scope="module")
def kernel_results():
    """The Pallas kernels in interpret mode under ``KERNEL_FORMS`` at
    ``KERNEL_SHAPES``: B1's hs (no variable, or HS), B2 fwd's (hs, cs) and B2
    bwd's (dxw, dW_hh^T) (no variable, or VJP), the custom VJP's primal and
    gradients (VJP)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for shape in KERNEL_SHAPES:
            xw, w, dhs = _inputs(*shape, seed=sum(shape))
            for form, xdt in KERNEL_FORMS:
                _setenv(mp, form)
                x = jnp.asarray(xw).astype(jnp.bfloat16 if xdt == "bf16" else jnp.float32)
                key = (shape, form, xdt)
                if form != "vjp":
                    out[key + ("b1",)] = np.asarray(
                        JP.lstm_bidir_pallas_tm(x, jnp.asarray(w), interpret=True))
                if form == "hs":
                    continue
                x_tm = jnp.moveaxis(x, 2, 0)
                hs_tm, cs_tm = JP._tm_fwd_with_cell(x_tm, jnp.asarray(w), True)
                out[key + ("fc",)] = (hs_tm, cs_tm)
                dhs_tm = jnp.moveaxis(jnp.asarray(dhs), 2, 0).astype(hs_tm.dtype)
                out[key + ("bwd",)] = JP._tm_bwd(x_tm, jnp.asarray(w), hs_tm, cs_tm, dhs_tm,
                                                 True)
                if form == "vjp":
                    primal, vjp = jax.vjp(lambda a, b: JP.lstm_bidir_tm(a, b, True), x,
                                          jnp.asarray(w))
                    out[key + ("vjp",)] = (primal, *vjp(jnp.asarray(dhs)))
    return out


def _tm(x):
    """A (T, 2, B, ...) JAX stream as (2, B, T, ...) numpy, widened."""
    return np.asarray(jnp.moveaxis(x, 0, 2).astype(jnp.float32))


@pytest.mark.parametrize("xdt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_b1_forms_match_pallas(kernel_results, shape, xdt):
    """B1 with a bf16 xw and with bf16 hs (SE_PALLAS_HS_BF16), its plain
    version, its cluster model and the wrapper against
    ``lstm_bidir_pallas_tm``."""
    xw, w, _ = _inputs(*shape, seed=sum(shape))
    x = torch.from_numpy(xw).to(BF16 if xdt == "bf16" else torch.float32)
    w = torch.from_numpy(w)
    f32_hs = L.lstm_bidir_tm_ref(torch.from_numpy(xw), w).numpy()
    for form, hs_dtype in (("f32", torch.float32), ("hs", BF16)):
        if (form, xdt) not in KERNEL_FORMS:
            continue
        ref = kernel_results[(shape, form, xdt, "b1")]
        for port in (L.lstm_bidir_tm_ref(x, w, hs_dtype=hs_dtype),
                     L.lstm_bidir_tm_fwd_model(x, w, batch_block=2, out_dtype=hs_dtype),
                     L.lstm_bidir_tm(x, w, hs_dtype=hs_dtype)):
            if hs_dtype == BF16:
                _held_bf16(port.float().numpy(), ref, f32_hs, f"B1 hs {xdt}")
            elif xdt == "bf16":
                _held(port.numpy(), ref, f32_hs, H_ATOL, False, "B1 xw")
    # the wrapper hands hs back widened, whatever it stored
    assert L.lstm_bidir_tm(x, w, hs_dtype=BF16).dtype == torch.float32


@pytest.mark.parametrize("xdt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_b2_fwd_forms_match_pallas(kernel_results, shape, xdt):
    """B2 fwd with a bf16 xw and with bf16 residuals (SE_PALLAS_VJP_BF16):
    plain version and cluster model against ``_tm_fwd_with_cell``."""
    xw, w, _ = _inputs(*shape, seed=sum(shape))
    x = torch.from_numpy(xw).to(BF16 if xdt == "bf16" else torch.float32)
    w = torch.from_numpy(w)
    f32_hs, f32_cs = (t.numpy() for t in L.lstm_bidir_tm_fc_ref(torch.from_numpy(xw), w))
    for form, res in (("f32", torch.float32), ("vjp", BF16)):
        if (form, xdt) not in KERNEL_FORMS:
            continue
        ref_hs, ref_cs = (_tm(t) for t in kernel_results[(shape, form, xdt, "fc")])
        for hs, cs in (L.lstm_bidir_tm_fc_ref(x, w, res_dtype=res),
                       L.lstm_bidir_tm_fwd_model(x, w, batch_block=2, with_cell=True,
                                                 out_dtype=res),
                       L.lstm_bidir_tm_fc(x, w, res_dtype=res)):
            assert hs.dtype == cs.dtype == res
            if res == BF16:
                _held_bf16(hs.float().numpy(), ref_hs, f32_hs, "B2 fwd hs")
                _held_bf16(cs.float().numpy(), ref_cs, f32_cs, "B2 fwd cs")
            elif xdt == "bf16":
                _held(hs.numpy(), ref_hs, f32_hs, H_ATOL, False, "B2 fwd hs")
                _held(cs.numpy(), ref_cs, f32_cs, REL_TOL, True, "B2 fwd cs")


@pytest.mark.parametrize("xdt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_b2_bwd_forms_match_pallas(kernel_results, shape, xdt):
    """B2 bwd on JAX's own residuals: dxw in xw's dtype, and the residual form
    (bf16 hs, cs and dhs; W_hh^T and the dh product's da rounded): plain
    version, three-phase model and wrapper against ``_tm_bwd``. The f32 form:
    the f32 backward on the widened residuals."""
    xw, w, dhs = _inputs(*shape, seed=sum(shape))
    x = torch.from_numpy(xw).to(BF16 if xdt == "bf16" else torch.float32)
    w = torch.from_numpy(w)
    for form in ("f32", "vjp"):
        if (form, xdt) not in KERNEL_FORMS:
            continue
        hs_tm, cs_tm = kernel_results[(shape, form, xdt, "fc")]
        dxw_tm, ref_dw = kernel_results[(shape, form, xdt, "bwd")]
        hs, cs = (torch.from_numpy(np.asarray(jnp.moveaxis(t, 0, 2).astype(jnp.float32)))
                  for t in (hs_tm, cs_tm))
        d = torch.from_numpy(dhs)
        if form == "vjp":
            hs, cs, d = hs.to(BF16), cs.to(BF16), d.to(BF16)
        ref_dxw, ref_dw = _tm(dxw_tm), np.asarray(ref_dw)
        f32_dxw, f32_dw = L.lstm_bidir_tm_bwd_ref(torch.from_numpy(xw), w, hs.float(),
                                                  cs.float(), torch.from_numpy(dhs))
        for dxw, dw in (L.lstm_bidir_tm_bwd_ref(x, w, hs, cs, d),
                        L.lstm_bidir_tm_bwd_model(x, w, hs, cs, d, batch_block=2),
                        L.lstm_bidir_tm_bwd(x, w, hs, cs, d)):
            assert dxw.dtype == x.dtype and dw.dtype == torch.float32
            if xdt == "bf16":
                _held_bf16(dxw.float().numpy(), ref_dxw, f32_dxw.numpy(), "dxw")
            elif form == "vjp":
                _held(dxw.numpy(), ref_dxw, f32_dxw.numpy(), REL_TOL, True, "dxw")
            _held(dw.numpy(), ref_dw, f32_dw.numpy(), REL_TOL, True, "dW_hh^T")


@pytest.mark.parametrize("xdt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_custom_vjp_forms_match_jax(kernel_results, shape, xdt):
    """``lstm_bidir_tm`` under autograd against JAX's custom VJP under
    SE_PALLAS_VJP_BF16: the primal is the rounded hs widened, the cotangent
    is rounded to bf16 on entry, dxw comes back in xw's dtype."""
    xw, w, dhs = _inputs(*shape, seed=sum(shape))
    ref_hs, ref_dxw, ref_dw = (np.asarray(jnp.asarray(t).astype(jnp.float32))
                               for t in kernel_results[(shape, "vjp", xdt, "vjp")])
    f32_x, f32_w = (torch.from_numpy(t).requires_grad_() for t in (xw, w))
    f32_hs = L.lstm_bidir_tm(f32_x, f32_w)
    f32_grads = torch.autograd.grad((f32_hs * torch.from_numpy(dhs)).sum(), (f32_x, f32_w))
    x = torch.from_numpy(xw).to(BF16 if xdt == "bf16" else torch.float32).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    hs = L.lstm_bidir_tm(x, wt, res_dtype=BF16)
    assert hs.dtype == torch.float32
    dxw, dw = torch.autograd.grad((hs * torch.from_numpy(dhs)).sum(), (x, wt))
    assert dxw.dtype == x.dtype and dw.dtype == torch.float32
    _held_bf16(hs.detach().numpy(), ref_hs, f32_hs.detach().numpy(), "primal")
    if xdt == "bf16":
        _held_bf16(dxw.float().numpy(), ref_dxw, f32_grads[0].numpy(), "dxw")
    else:
        _held(dxw.numpy(), ref_dxw, f32_grads[0].numpy(), REL_TOL, True, "dxw")
    _held(dw.numpy(), ref_dw, f32_grads[1].numpy(), REL_TOL, True, "dW_hh^T")


# -- LSTMStack against flax -------------------------------------------------------

B, T, D = 2, 11, 6
STACKS = {"bidir": dict(hidden_size=8, bidirectional=True),
          "one_dir": dict(hidden_size=8, bidirectional=False)}
# (stack, compute dtype, form) of each comparison
STACK_CASES = ([("bidir", "f32", f) for f in ("xw", "hs", "vjp", "all")]
               + [("bidir", "bf16", "all")]
               + [("one_dir", dt, "xw") for dt in ("f32", "bf16")])
# what each form changes: the output without a gradient, or the output and
# the gradients with one (a one-direction layer reads only the xw variable)
CHANGES = {"xw": {"eval", "train"}, "hs": {"eval"}, "vjp": {"train"}, "all": {"eval", "train"}}


def _x_np(seed):
    return np.random.default_rng(seed).standard_normal((B, T, D)).astype(np.float32)


def _cot(H2, seed):
    return np.cos(np.arange(B * T * H2).reshape(B, T, H2) * 0.37 + seed).astype(np.float32)


def _jax_stack(stack, dt, **kw):
    cfg = STACKS[stack]
    return JLSTMStack(cfg["hidden_size"], num_layers=2, bidirectional=cfg["bidirectional"],
                      compute_dtype=jnp.bfloat16 if dt == "bf16" else jnp.float32,
                      use_pallas=True, pallas_interpret=True, **kw)


def _params(stack, seed):
    """Seeded weights of a stack (the port's initialization) as a flax tree
    (cheaper than a flax init in interpret mode)."""
    cfg = STACKS[stack]
    port = LSTMStack(D, cfg["hidden_size"], num_layers=2, bidirectional=cfg["bidirectional"],
                     generator=torch.Generator().manual_seed(seed))
    return jax.tree.map(jnp.asarray, state_dict_to_flax(port.state_dict()))


def _port_stack(stack, dt, params):
    cfg = STACKS[stack]
    port = LSTMStack(D, cfg["hidden_size"], num_layers=2, bidirectional=cfg["bidirectional"],
                     compute_dtype=BF16 if dt == "bf16" else torch.float32)
    port.load_state_dict(flax_to_state_dict(params))
    return port


def _port_run(port, x, cot):
    with torch.no_grad():
        out_eval = port(torch.from_numpy(x)).numpy()
    out = port(torch.from_numpy(x))
    names, tensors = zip(*port.named_parameters())
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), tensors)
    return out_eval, out.detach().numpy(), {n: g.numpy() for n, g in zip(names, grads)}


@pytest.fixture(scope="module")
def stack_results():
    """JAX's stacks under each case's variables: what the form changes of the
    output without a gradient, the primal under ``jax.value_and_grad`` and
    every parameter gradient (None where it changes nothing); the flax
    parameters they start from."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for stack, dt, form in STACK_CASES:
            _setenv(mp, form)
            jstack = _jax_stack(stack, dt)
            x = jnp.asarray(_x_np(3))
            params = _params(stack, 4)
            H2 = STACKS[stack]["hidden_size"] * (2 if STACKS[stack]["bidirectional"] else 1)
            cot = jnp.asarray(_cot(H2, 1))

            def loss(p, jstack=jstack, x=x, cot=cot):
                y = jstack.apply(p, x)
                return (y * cot).sum(), y

            # fresh functions under this setting: traced (and the variables
            # read) here
            y = g = y_eval = None
            if "train" in CHANGES[form]:
                (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
                y, g = np.asarray(y), flax_to_state_dict(jax.device_get(g))
            if "eval" in CHANGES[form]:
                y_eval = np.asarray(
                    jax.jit(lambda p, jstack=jstack, x=x: jstack.apply(p, x))(params))
            out[(stack, dt, form)] = (jax.device_get(params), y_eval, y, g)
    return out


def _within(a, b, tol, relative):
    """Elementwise |a - b| <= tol (of b's largest |value| if relative)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max() if relative else 1.0
    return np.abs(a - b) <= tol * scale


def _share_within(a, b, tol, relative):
    return float(np.mean(_within(a, b, tol, relative)))


def _grad_share(grads, ref_grads, floor=0.0):
    """The share of all parameter gradients' elements within STACK_RTOL of
    their own parameter's largest |value|; each parameter's share at least
    ``floor`` (a small bias gradient is a sum over the steps of bf16 da
    terms, where one flipped rounding is a whole element)."""
    hits = []
    for name, g in grads.items():
        ok = _within(g, ref_grads[name], STACK_RTOL, True).ravel()
        assert ok.mean() >= floor, (name, ok.mean())
        hits.append(ok)
    return float(np.concatenate(hits).mean())


@pytest.mark.parametrize("stack,dt,form", STACK_CASES)
def test_stack_forms_match_flax(stack_results, stack, dt, form, monkeypatch):
    """``LSTMStack`` under the case's variables against flax under them:
    outputs and every parameter gradient within the stack limits; the same
    stack with no variable set (the f32 form) fails them wherever the form
    changes the result, and gives the same bits where it does not (HS leaves
    the gradient path alone, VJP the path without a gradient, in both
    packages)."""
    params, ref_eval, ref_train, ref_grads = stack_results[(stack, dt, form)]
    H2 = STACKS[stack]["hidden_size"] * (2 if STACKS[stack]["bidirectional"] else 1)
    x, cot = _x_np(3), _cot(H2, 1)
    port = _port_stack(stack, dt, params)
    _setenv(monkeypatch, "f32")
    f32_eval, f32_train, f32_grads = _port_run(port, x, cot)
    _setenv(monkeypatch, form)
    got_eval, got_train, got_grads = _port_run(port, x, cot)
    for what, got, ref, f32 in (("eval", got_eval, ref_eval, f32_eval),
                                ("train", got_train, ref_train, f32_train)):
        if ref is None:
            assert np.array_equal(got, f32), what
            continue
        assert _share_within(got, ref, STACK_ATOL, False) >= STACK_SHARE, what
        assert _share_within(f32, ref, STACK_ATOL, False) < STACK_SHARE, what
    if ref_grads is None:
        assert all(np.array_equal(got_grads[n], f32_grads[n]) for n in got_grads)
        return
    assert set(got_grads) == set(ref_grads)
    assert _grad_share(got_grads, ref_grads, floor=STACK_PARAM_SHARE) >= STACK_SHARE
    assert _grad_share(f32_grads, ref_grads) < STACK_SHARE


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_one_direction_reads_only_the_xw_variable(dt, monkeypatch):
    """JAX's one-direction layer is its ``lax.scan`` cell, which reads
    SE_LSTM_XW_BF16 only: HS / VJP change nothing of the port's one-direction
    stack (bit for bit), and with XW set the launches' forms say so."""
    x, cot = _x_np(8), _cot(8, 2)
    port = LSTMStack(D, 8, num_layers=2, bidirectional=False,
                     generator=torch.Generator().manual_seed(1),
                     compute_dtype=BF16 if dt == "bf16" else torch.float32)
    _setenv(monkeypatch, "f32")
    base = _port_run(port, x, cot)
    monkeypatch.setenv(HS, "1")
    monkeypatch.setenv(VJP, "1")
    again = _port_run(port, x, cot)
    assert np.array_equal(base[0], again[0]) and np.array_equal(base[1], again[1])
    assert all(np.array_equal(base[2][n], again[2][n]) for n in base[2])
    seen = []

    def recording(xw, w_hh_t, **kw):
        seen.append((xw.dtype, kw.get("hs_dtype", torch.float32),
                     kw.get("res_dtype", torch.float32), kw.get("h_bf16")))
        return L.lstm_bidir_tm(xw, w_hh_t, **kw)

    from speech_enhancement_by_s3prl_tpu_torch.models import lstm as t_lstm
    monkeypatch.setattr(t_lstm, "lstm_bidir_tm", recording)
    monkeypatch.setenv(XW, "1")
    _port_run(port, x, cot)
    assert seen == [(BF16, torch.float32, torch.float32, dt == "bf16")] * 4


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_one_direction_carried_state_under_xw_matches_the_scan(dt, monkeypatch):
    """The one-direction stack from a carried state under SE_LSTM_XW_BF16
    against the JAX stack's ``initial_state`` / ``return_state`` (its scan
    cell rounds xw the same way); the f32 form fails the limit."""
    H = 8
    x = _x_np(9)
    jstack = _jax_stack("one_dir", dt)
    params = _params("one_dir", 6)
    rng = np.random.default_rng(10)
    state = [(np.tanh(rng.standard_normal((B, H))).astype(np.float32),
              rng.standard_normal((B, H)).astype(np.float32)) for _ in range(2)]
    port = _port_stack("one_dir", dt, params)
    t_state = [tuple(torch.from_numpy(s) for s in st) for st in state]
    _setenv(monkeypatch, "f32")
    with torch.no_grad():
        f32_out, _ = port(torch.from_numpy(x), initial_state=t_state, return_state=True)
    _setenv(monkeypatch, "xw")
    ref, ref_fin = jstack.apply(params, jnp.asarray(x),
                                initial_state=[tuple(map(jnp.asarray, s)) for s in state],
                                return_state=True)
    with torch.no_grad():
        out, fin = port(torch.from_numpy(x), initial_state=t_state, return_state=True)
    _held(out.numpy(), np.asarray(ref), f32_out.numpy(), H_ATOL, False, "carried hs")
    for (h, c), (rh, rc) in zip(fin, ref_fin):
        np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=H_ATOL, rtol=0)
        np.testing.assert_allclose(c.numpy(), np.asarray(rc), atol=H_ATOL, rtol=0)


@pytest.mark.parametrize("form", ["vjp", "all"])
def test_capture_gate_cotangent_under_vjp_matches_jax(form, monkeypatch):
    """The per-row, per-step gate cotangent the capture scorer reads: the
    gradient at the recorded ``l{k}_xw`` (recorded in f32 before the xw
    rounding, where JAX perturbs it) against the cotangent of JAX's zero
    perturbation there, under the VJP form (and all three)."""
    H, layer = 8, 1
    x, cot = _x_np(11), _cot(16, 3)
    _setenv(monkeypatch, form)
    jstack = _jax_stack("bidir", "f32", capture_layer=layer)
    params = _params("bidir", 7)["params"]
    zero = {f"l{layer}_xw": jnp.zeros((2, B, T, 4 * H), jnp.float32)}

    def loss(perturbations):
        y, _ = jstack.apply({"params": params, "perturbations": perturbations},
                            jnp.asarray(x), mutable=["intermediates"])
        return (y * jnp.asarray(cot)).sum()

    ref = np.asarray(jax.jit(jax.grad(loss))(zero)[f"l{layer}_xw"])
    port = LSTMStack(D, H, num_layers=2, bidirectional=True)
    port.load_state_dict(flax_to_state_dict(jax.device_get({"params": params})))

    def gate_cot():
        cap = Capture(layer)
        out = port(torch.from_numpy(x), capture=cap)
        xw = cap[f"l{layer}_xw"]
        assert xw.dtype == torch.float32
        return torch.autograd.grad((out * torch.from_numpy(cot)).sum(), xw)[0].numpy()

    got = gate_cot()
    _setenv(monkeypatch, "f32")
    f32 = gate_cot()
    _held(got, ref, f32, REL_TOL, True, "gate cotangent")
    if form == "all":  # dxw in xw's dtype, widened
        assert np.array_equal(_bf16_np(got), got)


def test_forms_the_kernels_do_not_take_are_refused():
    """The bf16-h form stores f32 residuals; a carried state keeps f32 hs; the
    residuals come all in one dtype."""
    xw, w, dhs = (torch.from_numpy(t) for t in _inputs(2, 5, 8, seed=1, ndir=1))
    with pytest.raises(ValueError):
        L.lstm_bidir_tm_fc(xw, w, h_bf16=True, res_dtype=BF16)
    state = (torch.zeros(1, 2, 8), torch.zeros(1, 2, 8))
    with pytest.raises(ValueError):
        L.lstm_bidir_tm(xw, w, state=state, return_state=True, hs_dtype=BF16)
    hs, cs = L.lstm_bidir_tm_fc(xw, w, res_dtype=BF16)
    with pytest.raises(ValueError):
        L.lstm_bidir_tm_bwd(xw, w, hs, cs, dhs)
    with pytest.raises(ValueError):
        L.lstm_bidir_tm_bwd(xw, w, hs, cs, dhs.to(BF16), h_bf16=True)
    with pytest.raises(ValueError):
        L.lstm_bidir_tm(xw.double(), w)
