"""The port's bf16 compute (``--compute_dtype bf16``) against the JAX package,
on the CPU.

bf16 does not round at the same places in XLA and in PyTorch (an exact gelu
rounded once against op by op, a bf16 sum of a bias gradient), so a model is
held to a window instead of a tolerance. With d(a, b) = RMS(a - b) / RMS(the
JAX f32 result), each case needs both of
  - d(port bf16, JAX bf16) <= 1.5 d(JAX bf16, JAX f32): the port is no
    further from JAX's bf16 run than bf16 itself is from f32;
  - 0.5 <= d(port bf16, port f32) / d(JAX bf16, JAX f32) <= 2: the port rounds
    about as much as JAX does, so a port that ran f32 fails, and so does one
    that rounds far more (an f32 stage run in bf16, such as a LayerNorm).
That holds for every output, and for the gradient of a model as a whole (every
parameter's gradient over its JAX f32 RMS, concatenated). Parameter by
parameter, where the two frameworks round at different places the port's and
JAX's roundings are independent, so d(port bf16, JAX bf16) comes near sqrt(1 +
r^2) d(JAX bf16, JAX f32) for a ratio r near 1: a gradient is held to
d(port bf16, JAX bf16) <= 2 d(JAX bf16, JAX f32) (measured at most 1.57, the
encoder's input_ln.weight with dropout live) and the same ratio bounds. Two
kinds of parameter differ by construction: the bias of a bf16 Dense, whose
gradient XLA on the CPU sums over rows in bf16 (about three roundings' worth,
``test_xla_cpu_sums_a_bf16_bias_gradient_in_bf16``) where the port sums in f32
and rounds once, is held to the upper bounds and to bf16 values (measured
ratio 0.17 to 0.55); and a gradient that no bf16 product reaches (the last
LayerNorm's bias: the cotangent's own sum), equal in JAX's two runs, is held
to 1e-6 of the JAX f32 one.
The cases: the encoder at 2 layers x 32 x 4 heads, FFN 64, at rate 0 (SDPA
against ``jax.nn.dot_product_attention``) and with dropout live (B3 bf16's
plain version with hash dropout against the JAX flash kernel in interpret
mode under ``SE_ATTN_IMPL=flash SE_HIDDEN_DROPOUT_IMPL=hash``, the port
replaying the salts JAX drew, which are the same in f32 and bf16), output and
every parameter gradient; a ``Residual`` head of 2 BLSTM layers of 16 against
JAX ``build_head(..., use_pallas=True)`` (its Pallas path, the port's
reference, in interpret mode), output and gradients; one flagship-shaped
``StepBuilder`` train step at hidden 16, loss and parameter updates; and a
JAX-format checkpoint whose ``Paras`` say bf16 served by both packages,
waveforms. Where bf16 is placed is checked exactly (forward hooks; the
projection's operands and W_hh^T's values), and the projection alone against
JAX's ``einsum(..., preferred_element_type=f32)`` within 1e-6. Then the
entry points: ``run_downstream --compute_dtype bf16`` trains 2 steps and a
resume keeps bf16, and what still refuses bf16 (B7, other dtypes). The
one-direction layer in bf16 has its own file,
``tests/test_torch_port_bf16_one_direction.py``.
"""
import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
import serve as j_serve
from speech_enhancement_by_s3prl_tpu.models import heads as j_heads
from speech_enhancement_by_s3prl_tpu.models import transformer as j_tf
from speech_enhancement_by_s3prl_tpu.runner import optim as j_optim
from speech_enhancement_by_s3prl_tpu.runner.checkpoint import (
    save_checkpoint as j_save_checkpoint,
)
from speech_enhancement_by_s3prl_tpu_torch import entry, serve
from speech_enhancement_by_s3prl_tpu_torch.active.sampler import make_scoring_fn
from speech_enhancement_by_s3prl_tpu_torch.models import heads as t_heads
from speech_enhancement_by_s3prl_tpu_torch.models import lstm as t_lstm
from speech_enhancement_by_s3prl_tpu_torch.models import transformer as t_tf
from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_to_state_dict
from speech_enhancement_by_s3prl_tpu_torch.ops.streaming import StatefulStreamer
from speech_enhancement_by_s3prl_tpu_torch.runner import optim
from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import (
    find_resume_ckpt,
    load_checkpoint,
)
from tests.test_torch_port_runner import _config, _flags, _write_yaml, corpus  # noqa: F401
from tests.test_torch_port_transformer import _port_grads, _spec, configs

BF16 = torch.bfloat16
NEAR, LOW, HIGH = 1.5, 0.5, 2.0
# a single parameter's gradient: roundings at other places are independent
PARAM_NEAR = 2.0
# bf16 Dense layers of the encoder, whose bias gradients XLA's CPU sums in bf16
BF16_DENSE = ("qkv", "attention.output", "intermediate", "output")
HEAD = dict(hidden_size=16, num_layers=2, bidirectional=True, activation="Sigmoid",
            cmvn=False)
FLAGSHIP = dict(hidden_size=16, num_layers=2)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rms(x):
    return float(np.sqrt(np.mean(np.square(np.asarray(x, np.float64)))))


def window(port_bf16, port_f32, jax_bf16, jax_f32, what, near_bound=NEAR, low=LOW):
    """The window criterion; returns (d(port bf16, JAX bf16) / d(JAX bf16, JAX
    f32), d(port bf16, port f32) / d(JAX bf16, JAX f32))."""
    pb, pf, jb, jf = (np.asarray(x, np.float64) for x in (port_bf16, port_f32, jax_bf16,
                                                            jax_f32))
    scale = _rms(jf)
    base = _rms(jb - jf) / scale
    assert base > 0, f"{what}: JAX's bf16 run equals its f32 run"
    near, ratio = _rms(pb - jb) / scale / base, _rms(pb - pf) / scale / base
    assert near <= near_bound, (f"{what}: d(port bf16, JAX bf16) is {near:.3f} x "
                                "d(JAX bf16, JAX f32)")
    assert low <= ratio <= HIGH, (f"{what}: d(port bf16, port f32) is {ratio:.3f} x "
                                  "d(JAX bf16, JAX f32)")
    return near, ratio


def _window_grads(sides, what):
    """The window on the output, the whole gradient and each parameter's
    gradient (the module docstring) of four (output, {name: grad}) runs: port
    bf16, port f32, JAX bf16, JAX f32."""
    window(*(s[0] for s in sides), f"{what} output")
    names = sorted(sides[3][1])
    assert all(sorted(s[1]) == names for s in sides)
    grads = [[np.asarray(s[1][k], np.float64) for k in names] for s in sides]
    scales = [_rms(g) for g in grads[3]]
    window(*(np.concatenate([g.ravel() / c for g, c in zip(gs, scales)]) for gs in grads),
           f"{what} gradient")
    for i, k in enumerate(names):
        pb, pf, jb, jf = (gs[i] for gs in grads)
        if not np.any(jb != jf):
            assert _rms(pb - jf) <= 1e-6 * _rms(jf), f"{what} d{k}"
            continue
        dense_bias = k.endswith(".bias") and k[:-len(".bias")].endswith(BF16_DENSE)
        if dense_bias:
            assert np.array_equal(torch.from_numpy(pb).to(BF16).double().numpy(), pb), k
        window(pb, pf, jb, jf, f"{what} d{k}", PARAM_NEAR, 0.0 if dense_bias else LOW)


# -- the encoder -------------------------------------------------------------------

def _encoder_sides(live, monkeypatch):
    """(output, {name: gradient}) of the encoder, port bf16, port f32, JAX bf16,
    JAX f32; with dropout live the port replays the salts the jitted JAX step
    drew (returned from it: ``jax.random.bits`` is wrapped to keep them)."""
    jcfg, tcfg = configs(**({} if live else {"hidden_dropout_prob": 0.0,
                                             "attention_probs_dropout_prob": 0.0}))
    x = _spec(11, T=41)
    cot = np.random.default_rng(12).standard_normal((2, 41, 32)).astype(np.float32)
    params = j_tf.TransformerEncoder(jcfg).init(
        {"params": jax.random.PRNGKey(3)}, jnp.asarray(x))["params"]
    drawn, bits = [], jax.random.bits

    def recorded_bits(key, shape=(), dtype=None):
        drawn.append(bits(key, shape, dtype))
        return drawn[-1]

    monkeypatch.setattr(jax.random, "bits", recorded_bits)
    sides, salts = {}, {}
    for name, jdt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        module = j_tf.TransformerEncoder(jcfg, compute_dtype=jdt)

        def loss(p, module=module):
            drawn.clear()
            out = module.apply({"params": p}, jnp.asarray(x), deterministic=not live,
                               rngs={"dropout": jax.random.PRNGKey(9)} if live else None)
            return (out * cot).sum(), (out, list(drawn))

        (_, (out, keys)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        sides[("jax", name)] = (np.asarray(out), flax_to_state_dict(jax.device_get(grads)))
        salts[name] = [tuple(int(v) for v in np.asarray(k).reshape(-1)) for k in keys]
    # the dropout sites, so the salts, do not depend on the dtype
    assert salts["bf16"] == salts["f32"] and len(salts["bf16"]) == (1 + 3 * 2) * live
    for name, tdt in (("bf16", BF16), ("f32", torch.float32)):
        port = t_tf.TransformerEncoder(tcfg, input_dim=12, compute_dtype=tdt)
        port.load_state_dict(flax_to_state_dict(params))
        port.train(live)
        args = (t_tf.SaltStream(salts=salts[name]),) if live else ()
        sides[("port", name)] = _port_grads(port, cot, torch.from_numpy(x), *args)
    return [sides[k] for k in (("port", "bf16"), ("port", "f32"), ("jax", "bf16"),
                               ("jax", "f32"))]


@pytest.mark.parametrize("live", [False, True], ids=["rate0_sdpa", "dropout_b3"])
def test_encoder_in_bf16_within_the_window_of_jax(monkeypatch, live):
    if live:
        monkeypatch.setenv("SE_ATTN_IMPL", "flash")
        monkeypatch.setenv("SE_HIDDEN_DROPOUT_IMPL", "hash")
    _window_grads(_encoder_sides(live, monkeypatch), "encoder")


def test_xla_cpu_sums_a_bf16_bias_gradient_in_bf16():
    """Why the encoder's bf16 Dense biases are held apart: flax's
    ``Dense(dtype=bf16)`` on the CPU sums the bias cotangent over rows in bf16
    (two and more times the error of one rounding of the exact sum), the
    port's ``Dense`` sums in f32 and rounds once, as a bf16 product does."""
    import flax.linen as nn

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 41, 32)).astype(np.float32)
    cot = rng.standard_normal((2, 41, 96)).astype(np.float32)
    exact = torch.from_numpy(cot).to(BF16).double().sum((0, 1))
    once = _rms(exact.to(BF16).double() - exact)
    dense = nn.Dense(96, dtype=jnp.bfloat16)
    params = dense.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    jgrad = jax.jit(jax.grad(lambda p: (dense.apply({"params": p}, jnp.asarray(x))
                                        .astype(jnp.float32) * cot).sum()))(params)["bias"]
    port = t_tf.Dense(32, 96)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.asarray(params["kernel"]).T))
        port.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))
    out = port(torch.from_numpy(x).to(BF16))
    pgrad, = torch.autograd.grad((out.float() * torch.from_numpy(cot)).sum(), [port.bias])
    assert _rms(np.asarray(jgrad, np.float64) - exact.numpy()) >= 2 * once
    assert _rms(pgrad.double() - exact) <= 1.01 * once


# -- the Residual head on the Pallas path -------------------------------------------

def _head_inputs(seed, B=2, T=29, D=12, F=10):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T, D)).astype(np.float32)
    linears = (rng.standard_normal((B, T, F)) ** 2).astype(np.float32)
    cot = rng.standard_normal((B, T, F)).astype(np.float32)
    return feats, linears, cot


def test_residual_head_in_bf16_within_the_window_of_jax_pallas_path():
    feats, linears, cot = _head_inputs(21)
    jhead = {dt: j_heads.build_head("Residual", 12, 10, compute_dtype=dt, use_pallas=True,
                                    **HEAD) for dt in ("bf16", "f32")}
    params = jhead["f32"].init(jax.random.PRNGKey(5), jnp.asarray(feats),
                               jnp.asarray(linears))["params"]
    sides = {}
    for dt in ("bf16", "f32"):
        def loss(p, dt=dt):
            out, _ = jhead[dt].apply({"params": p}, jnp.asarray(feats), jnp.asarray(linears))
            return (out * cot).sum(), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        sides[("jax", dt)] = (np.asarray(out), flax_to_state_dict(jax.device_get(grads)))
        port = t_heads.build_head("Residual", 12, 10, compute_dtype=dt, **HEAD)
        port.load_state_dict(flax_to_state_dict(params))
        out, _ = port(torch.from_numpy(feats), torch.from_numpy(linears))
        names = [n for n, _ in port.named_parameters()]
        g = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), list(port.parameters()))
        sides[("port", dt)] = (out.detach().numpy(), dict(zip(names, g)))
        assert out.dtype == torch.float32 and all(x.dtype == torch.float32 for x in g)
    _window_grads([sides[k] for k in (("port", "bf16"), ("port", "f32"), ("jax", "bf16"),
                                      ("jax", "f32"))], "Residual head")


def test_bf16_placement_in_the_encoder_and_the_lstm(monkeypatch):
    """bf16 exactly where the JAX package puts it: into and out of qkv,
    attention output, intermediate and layer output; f32 into every
    LayerNorm, spec_transform and the spec head; the LSTM projection's
    operands bf16 and its result f32; W_hh^T's values bf16 numbers held in
    f32."""
    seen = {}

    def hook(name):
        def record(module, inputs, output):
            seen.setdefault(name, set()).add((inputs[0].dtype, output.dtype))
        return record

    _, tcfg = configs()
    model = t_heads.build_head("Mockingjay", 12, 10, config=tcfg, compute_dtype="bf16")
    for name, module in model.named_modules():
        if isinstance(module, (torch.nn.Linear, torch.nn.LayerNorm)):
            module.register_forward_hook(hook(name))
    model.train()
    out, _ = model(torch.from_numpy(_spec(2, T=17)), salts=t_tf.SaltStream(seed=1))
    assert out.dtype == torch.float32
    for name, dtypes in seen.items():
        leaf = name.split(".")[-1]
        in_layer = ".layer_" in name and "_ln" not in leaf
        want = {(BF16, BF16)} if in_layer else {(torch.float32, torch.float32)}
        assert dtypes == want, f"{name}: {dtypes}"
    assert {n.split(".")[-1] for n in seen if ".layer_" in n} == {
        "qkv", "output", "intermediate", "attention_ln", "output_ln"}
    assert any("spechead" in n for n in seen) and "mockingjay.spec_transform" in seen

    calls = []
    orig_project, orig_tm = t_lstm.project, t_lstm.lstm_bidir_tm

    def project(xs, w_ih, dtype):
        out = orig_project(xs, w_ih, dtype)
        calls.append(("project", xs.to(dtype).dtype, w_ih.to(dtype).dtype, out.dtype))
        return out

    def tm(xw, w_hh_t, **kw):
        calls.append(("w_hh_t", torch.equal(w_hh_t.to(BF16).float(), w_hh_t), xw.dtype))
        return orig_tm(xw, w_hh_t, **kw)

    monkeypatch.setattr(t_lstm, "project", project)
    monkeypatch.setattr(t_lstm, "lstm_bidir_tm", tm)
    head = t_heads.build_head("Residual", 12, 10, compute_dtype="bf16", **HEAD)
    feats, linears, _ = _head_inputs(3)
    head(torch.from_numpy(feats), torch.from_numpy(linears))
    assert calls == [("project", BF16, BF16, torch.float32), ("w_hh_t", True, torch.float32)] * 2


def test_projection_matches_jax_einsum_with_an_f32_result():
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((2, 3, 17, 24)).astype(np.float32)
    w = rng.standard_normal((2, 32, 24)).astype(np.float32)
    want = np.asarray(jnp.einsum("dbtn,dhn->dbth", jnp.asarray(xs).astype(jnp.bfloat16),
                                 jnp.asarray(w).astype(jnp.bfloat16),
                                 preferred_element_type=jnp.float32))
    got = t_lstm.project(torch.from_numpy(xs), torch.from_numpy(w), BF16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # one rounding more (a bf16 result) would be ~1e-3 off
    assert np.abs(got.to(BF16).float().numpy() - want).max() > 1e-4 * np.abs(want).max()


# -- one train step ------------------------------------------------------------------

def _batch(seed, n=8000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    clean = 0.1 * np.sin(2 * np.pi * (220 + 40 * np.arange(2))[:, None] * t)
    noise = 0.1 * rng.standard_normal((2, n))
    wavs = np.stack([clean + noise, clean, noise], axis=1).astype(np.float32)
    return wavs, np.array([n, n * 3 // 4])


def test_flagship_train_step_in_bf16_within_the_window_of_jax():
    wavs, lengths = _batch(0)
    sides, init = {}, None
    for dt, jdt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        builder = dataclasses.replace(
            graft._build(use_pallas=True, compute_dtype=jdt, **FLAGSHIP),
            optimizer=j_optim.build_optimizer("BertAdam", 1e-3, 0.07, 10), donate=False)
        state = builder.init_state(jax.random.PRNGKey(0), jnp.asarray(wavs),
                                   jnp.asarray(lengths))
        init = init or flax_to_state_dict(jax.device_get(state.params))
        state, stats = jax.jit(builder.train_step_raw())(
            state, jnp.asarray(wavs), jnp.asarray(lengths), jax.random.PRNGKey(0), None)
        new = flax_to_state_dict(jax.device_get(state.params))
        sides[("jax", dt)] = (float(stats["loss"]), {k: new[k] - init[k] for k in init})
        port = dataclasses.replace(
            entry.build_train(device="cpu", compute_dtype=dt, **FLAGSHIP),
            optimizer=optim.build_optimizer("BertAdam", 1e-3, 0.07, 10))
        port.model.load_state_dict(init)
        pstate, pstats = port.train_step(port.init_state(), torch.from_numpy(wavs),
                                         torch.from_numpy(lengths))
        new = {k: v.detach() for k, v in port.model.state_dict().items()}
        sides[("port", dt)] = (float(pstats["loss"]), {k: new[k] - init[k] for k in init})
    order = (("port", "bf16"), ("port", "f32"), ("jax", "bf16"), ("jax", "f32"))
    window(*(np.array([sides[k][0]]) for k in order), "train step loss")
    flat = [np.concatenate([sides[k][1][n].numpy().ravel() for n in sorted(init)])
            for k in order]
    window(*flat, "train step parameter updates")


# -- serving a bf16 checkpoint ---------------------------------------------------------

def _audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.1 * np.sin(2 * np.pi * (300 + 40 * seed) * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def test_jax_bf16_checkpoint_served_by_the_port_within_the_window(tmp_path, monkeypatch):
    """A checkpoint the JAX package wrote with ``Paras.compute_dtype`` bf16,
    served by both packages (JAX on its Pallas path, ``SE_PALLAS_LSTM=1``),
    against the same weights under f32."""
    monkeypatch.setenv("SE_PALLAS_LSTM", "1")
    builder = graft._build(use_pallas=True, **FLAGSHIP)
    state = builder.init_state(jax.random.PRNGKey(2), jnp.zeros((1, 3, 4800), jnp.float32),
                               jnp.full((1,), 4800))
    wav = _audio(9000, 1)
    outs = {}
    for dt in ("bf16", "f32"):
        config, paras = entry.flagship_settings(compute_dtype=dt, **FLAGSHIP)
        path = str(tmp_path / dt)
        j_save_checkpoint(path, 1, jax.device_get(state.params),
                          jax.device_get(state.opt_state), config, paras)
        outs[("jax", dt)] = np.asarray(j_serve.build_enhancer(path, 16000, -25.0)(wav))
        port = serve.build_enhancer(path, device="cpu", max_bucket_ms=2000)
        assert port.model.compute_dtype == (BF16 if dt == "bf16" else torch.float32)
        outs[("port", dt)] = port(wav)
    window(*(outs[k] for k in (("port", "bf16"), ("port", "f32"), ("jax", "bf16"),
                               ("jax", "f32"))), "served waveform")


# -- entry points ----------------------------------------------------------------------

def test_run_downstream_trains_in_bf16_and_a_resume_keeps_it(corpus, tmp_path):  # noqa: F811
    from speech_enhancement_by_s3prl_tpu_torch import run_downstream

    cfg = _write_yaml(tmp_path / "cfg.yaml", _config(corpus, total_step=2, eval_step=2,
                                                     save_step=2))
    run_downstream.main(["--config", cfg, *_flags(tmp_path), "--compute_dtype", "bf16"])
    run_dir = tmp_path / "run"
    payload = load_checkpoint(find_resume_ckpt(str(run_dir)))
    assert payload["Settings"]["Paras"]["compute_dtype"] == "bf16"
    assert payload["Global_step"] == 3
    args, config = run_downstream.get_downstream_args(["--resume", str(run_dir), "--cpu"])
    assert args.compute_dtype == "bf16"
    config["runner"]["total_step"] = 3
    runner = run_downstream.build_runner(args, config)
    assert runner.downstream_model.compute_dtype == BF16
    runner.set_model()
    runner.train()
    assert load_checkpoint(find_resume_ckpt(str(run_dir)))["Global_step"] == 4


def test_what_bf16_still_refuses_names_roadmap_a14b(tmp_path):
    """ROADMAP A14b's items 1 and 3 are ported: a one-direction head, its
    checkpoint, the streamer and the scorer take bf16 (held against the JAX
    package in tests/test_torch_port_bf16_one_direction.py). What still
    refuses bf16: B7 (``recurrence='fused'``), which projects in f32 inside
    its kernel, and any dtype but f32 and bf16."""
    head = t_heads.build_head("Residual", 12, 10, compute_dtype="bf16", **HEAD)
    head.lstm.recurrence = "fused"
    feats, linears, _ = _head_inputs(3)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="no bf16 form"):
        head(torch.from_numpy(feats), torch.from_numpy(linears))
    # under autograd every route is LstmBidirTm, so the head still trains
    out, _ = head(torch.from_numpy(feats), torch.from_numpy(linears))
    assert out.requires_grad and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        t_heads.build_head("Residual", 12, 10, compute_dtype="fp16", **HEAD)
    with pytest.raises(ValueError, match="f32 or bf16"):
        t_lstm.LSTMStack(12, 8, 2, bidirectional=False, compute_dtype=torch.float16)
    # what A14b refused builds now
    for name in ("LSTM", "Residual"):
        one_dir = t_heads.build_head(name, 12, 10, compute_dtype="bf16", bidirectional=False)
        assert one_dir.compute_dtype == BF16 and one_dir.lstm.compute_dtype == BF16
    pre, model = entry.build(device="cpu", bidirectional=False, compute_dtype="bf16",
                             **FLAGSHIP)
    StatefulStreamer(model, pre)
    make_scoring_fn(entry.build_train(device="cpu", compute_dtype="bf16", **FLAGSHIP))
    config, paras = entry.flagship_settings(bidirectional=False, compute_dtype="bf16",
                                            **FLAGSHIP)
    from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import save_checkpoint

    save_checkpoint(str(tmp_path), 1, model, None, config, paras)
    assert serve.build_enhancer(str(tmp_path), device="cpu").model.compute_dtype == BF16
