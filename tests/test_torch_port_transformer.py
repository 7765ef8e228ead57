"""The port's transformer modules against the JAX package, on the CPU.

Encoder, layer, spec-prediction head, ``SpecHead``, ``Mockingjay`` and
``UpstreamTransformer`` outputs and parameter gradients against the flax
modules with bridged weights, at hidden 32, 4 heads, 2 layers, T <= 101:
at rate 0 (the port's SDPA route against the JAX default attention), and
with dropout live, the JAX side under ``SE_ATTN_IMPL=flash
SE_HIDDEN_DROPOUT_IMPL=hash`` (its flash kernel in interpret mode) and the
port replaying the salts the un-jitted JAX apply drew. Also
``downsample_rate`` 2, ``share_layer``, ``select_layer``, ``weighted_sum``,
the S3PRL importer against the JAX importer, and the weight bridge's round
trip of a transformer tree (LayerNorm scales included).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_by_s3prl_tpu.models import spec_head as j_spec
from speech_enhancement_by_s3prl_tpu.models import torch_import as j_import
from speech_enhancement_by_s3prl_tpu.models import transformer as j_tf
from speech_enhancement_by_s3prl_tpu.models import upstream as j_up
from speech_enhancement_by_s3prl_tpu_torch.models import heads as t_heads
from speech_enhancement_by_s3prl_tpu_torch.models import spec_head as t_spec
from speech_enhancement_by_s3prl_tpu_torch.models import torch_import as t_import
from speech_enhancement_by_s3prl_tpu_torch.models import transformer as t_tf
from speech_enhancement_by_s3prl_tpu_torch.models import upstream as t_up
from speech_enhancement_by_s3prl_tpu_torch.models.convert import (
    flax_to_state_dict,
    state_dict_to_flax,
)

SMALL = dict(input_dim=12, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=64)
# Outputs and gradients relative to their largest |value|: the same f32
# products, softmax, exact gelu and LayerNorm (flax's fast variance against
# torch's) with sums in other orders, through 2 layers.
RTOL = 1e-5


def configs(**kw):
    cfg = {**SMALL, **kw}
    return j_tf.TransformerConfig(**cfg), t_tf.TransformerConfig(**cfg)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def assert_close(got, want, what=""):
    err = rel_err(got, want)
    assert err <= RTOL, f"{what}: error / max|value| {err:.2e} > {RTOL:.0e}"


class SaltRecorder:
    """Wraps ``jax.random.bits`` while the JAX side runs un-jitted, keeping
    every salt drawn, in order."""

    def __init__(self, monkeypatch):
        self.salts = []
        orig = jax.random.bits

        def bits(key, shape=(), dtype=None):
            out = orig(key, shape, dtype)
            self.salts.append(tuple(int(s) for s in np.asarray(out).reshape(-1)))
            return out

        monkeypatch.setattr(jax.random, "bits", bits)


@pytest.fixture
def hash_dropout_env(monkeypatch):
    monkeypatch.setenv("SE_ATTN_IMPL", "flash")
    monkeypatch.setenv("SE_HIDDEN_DROPOUT_IMPL", "hash")
    return monkeypatch


def _spec(seed, B=2, T=37, D=12):
    return np.random.default_rng(seed).standard_normal((B, T, D)).astype(np.float32)


def _jax_grads(module, params, cot, *args, rngs=None, deterministic=True, **kw):
    """(output, d<sum(output * cot)>/d params) of a flax module, un-jitted."""
    def loss(p):
        out = module.apply({"params": p}, *args, deterministic=deterministic, rngs=rngs, **kw)
        out = out[0] if isinstance(out, tuple) else out
        return (out * cot).sum(), out

    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return np.asarray(out), flax_to_state_dict(jax.device_get(grads))


def _port_grads(module, cot, *args, **kw):
    out = module(*args, **kw)
    out = out[0] if isinstance(out, tuple) else out
    names = [n for n, _ in module.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                [p for _, p in module.named_parameters()])
    return out.detach().numpy(), dict(zip(names, grads))


def _compare(jax_side, port_side, what):
    (jout, jgrads), (pout, pgrads) = jax_side, port_side
    assert_close(pout, jout, f"{what} output")
    assert set(pgrads) == set(jgrads)
    for k in jgrads:
        assert_close(pgrads[k].numpy(), jgrads[k].numpy(), f"{what} d{k}")


ENCODER_CASES = {
    "plain": {},
    "downsample_rate_2": {"downsample_rate": 2},
    "share_layer": {"share_layer": True},
}


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_encoder_at_rate_0_matches_jax(case):
    jcfg, tcfg = configs(**ENCODER_CASES[case])
    x = _spec(1, T=41)
    enc = j_tf.TransformerEncoder(jcfg)
    params = enc.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))["params"]
    port = t_tf.TransformerEncoder(tcfg, input_dim=12)
    port.load_state_dict(flax_to_state_dict(params))
    port.eval()
    T2 = 41 // max(1, tcfg.downsample_rate)
    cot = np.random.default_rng(2).standard_normal((2, T2, 32)).astype(np.float32)
    _compare(_jax_grads(enc, params, cot, jnp.asarray(x)),
             _port_grads(port, cot, torch.from_numpy(x)), case)
    if case == "share_layer":
        assert any(k.startswith("layer_shared.") for k in port.state_dict())


@pytest.mark.parametrize("rates", [(0.1, 0.1), (0.0, 0.3), (0.2, 0.0)])
def test_encoder_with_live_dropout_matches_jax(hash_dropout_env, rates):
    """Dropout live: the JAX encoder under the flash + hash routes draws
    1 + 3 L salts in the order input, then per layer attention probs,
    attention output, FFN output (only the live ones); the port replays
    them and matches output and gradients."""
    hidden, attn = rates
    jcfg, tcfg = configs(hidden_dropout_prob=hidden, attention_probs_dropout_prob=attn)
    x = _spec(3, T=53)
    enc = j_tf.TransformerEncoder(jcfg)
    params = enc.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x))["params"]
    cot = np.random.default_rng(4).standard_normal((2, 53, 32)).astype(np.float32)
    rec = SaltRecorder(hash_dropout_env)
    jax_side = _jax_grads(enc, params, cot, jnp.asarray(x), deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(7)})
    L = jcfg.num_hidden_layers
    assert len(rec.salts) == (1 + 2 * L) * (hidden > 0) + L * (attn > 0)
    port = t_tf.TransformerEncoder(tcfg, input_dim=12)
    port.load_state_dict(flax_to_state_dict(params))
    port.train()
    salts = t_tf.SaltStream(salts=rec.salts)
    _compare(jax_side, _port_grads(port, cot, torch.from_numpy(x), salts), "dropout")
    assert salts.drawn == len(rec.salts)
    # another salt stream gives another mask
    other = port(torch.from_numpy(x), t_tf.SaltStream(seed=5)).detach().numpy()
    assert rel_err(other, jax_side[0]) > 1e-3


def test_live_dropout_without_salts_raises():
    _, tcfg = configs()
    port = t_tf.TransformerEncoder(tcfg).train()
    with pytest.raises(ValueError, match="SaltStream"):
        port(torch.zeros(1, 5, 12))


def test_layer_matches_jax(hash_dropout_env):
    jcfg, tcfg = configs()
    x = np.random.default_rng(5).standard_normal((2, 29, 32)).astype(np.float32)
    layer = j_tf.TransformerLayer(jcfg)
    params = layer.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(x))["params"]
    port = t_tf.TransformerLayer(tcfg)
    port.load_state_dict(flax_to_state_dict(params))
    cot = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    rec = SaltRecorder(hash_dropout_env)
    jax_side = _jax_grads(layer, params, cot, jnp.asarray(x), None, deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(3)})
    port.train()
    _compare(jax_side, _port_grads(port, cot, torch.from_numpy(x),
                                   t_tf.SaltStream(salts=rec.salts)), "layer")


@pytest.mark.parametrize("log_domain", [True, False])
def test_spec_heads_match_jax(log_domain):
    jcfg, tcfg = configs()
    x = np.abs(np.random.default_rng(7).standard_normal((2, 19, 32))).astype(np.float32)
    head = j_tf.TransformerSpecPredictionHead(jcfg, 24)
    hp = head.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    port = t_tf.TransformerSpecPredictionHead(tcfg, 24)
    port.load_state_dict(flax_to_state_dict(hp))
    cot = np.random.default_rng(8).standard_normal((2, 19, 24)).astype(np.float32)
    _compare(_head_grads(head, hp, cot, x), _port_grads(port, cot, torch.from_numpy(x)),
             "spec prediction head")

    sh = j_spec.SpecHead(output_size=24, config=jcfg, log_domain=log_domain)
    sp = sh.init(jax.random.PRNGKey(5), jnp.asarray(x))["params"]
    port_sh = t_spec.SpecHead(32, 24, tcfg, log_domain=log_domain)
    port_sh.load_state_dict(flax_to_state_dict(sp))
    jpred, jaux = sh.apply({"params": sp}, jnp.asarray(x))
    pred, aux = port_sh(torch.from_numpy(x))
    assert_close(pred.detach().numpy(), np.asarray(jpred), "SpecHead predicted")
    lp, jlp = aux["log_predicted"].detach().numpy(), np.asarray(jaux["log_predicted"])
    # log(raw + eps) of a negative raw output is NaN on both sides
    assert np.array_equal(np.isnan(lp), np.isnan(jlp))
    assert_close(np.nan_to_num(lp), np.nan_to_num(jlp), "SpecHead log_predicted")


def _head_grads(head, params, cot, x):
    def loss(p):
        out, _ = head.apply({"params": p}, jnp.asarray(x))
        return (out * cot).sum(), out

    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return np.asarray(out), flax_to_state_dict(jax.device_get(grads))


def _mockingjay_pair(jcfg, tcfg, x, seed=6):
    jm = j_spec.Mockingjay(output_size=24, config=jcfg)
    params = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x))["params"]
    pm = t_spec.Mockingjay(input_size=x.shape[-1], output_size=24, config=tcfg)
    pm.load_state_dict(flax_to_state_dict(params))
    return jm, params, pm


def _mj_loss_grads_jax(jm, params, x, cot, deterministic, rngs=None):
    def loss(p):
        pred, aux = jm.apply({"params": p}, jnp.asarray(x), None, deterministic=deterministic,
                             rngs=rngs)
        return (pred * cot).sum() + (aux["log_predicted"] * cot).sum(), pred

    (_, pred), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return np.asarray(pred), flax_to_state_dict(jax.device_get(grads))


def _mj_loss_grads_port(pm, x, cot, salts=None):
    pred, aux = pm(torch.from_numpy(x), None, salts)
    c = torch.from_numpy(cot)
    loss = (pred * c).sum() + (aux["log_predicted"] * c).sum()
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in pm.named_parameters()])
    return pred.detach().numpy(), dict(zip(names, grads))


@pytest.mark.parametrize("live", [False, True])
def test_mockingjay_matches_jax(hash_dropout_env, live):
    rate = 0.1 if live else 0.0
    jcfg, tcfg = configs(hidden_dropout_prob=rate, attention_probs_dropout_prob=rate)
    x = _spec(9, T=101)
    jm, params, pm = _mockingjay_pair(jcfg, tcfg, x)
    cot = np.random.default_rng(10).standard_normal((2, 101, 24)).astype(np.float32) * 0.1
    rec = SaltRecorder(hash_dropout_env)
    jax_side = _mj_loss_grads_jax(jm, params, x, cot, deterministic=not live,
                                  rngs={"dropout": jax.random.PRNGKey(11)} if live else None)
    pm.train(live)
    assert len(rec.salts) == (7 if live else 0)
    _compare(jax_side, _mj_loss_grads_port(pm, x, cot, t_tf.SaltStream(salts=rec.salts)),
             "Mockingjay")


def test_mockingjay_train_mode_at_rate_0_needs_no_salts():
    _, tcfg = configs(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    pm = t_spec.Mockingjay(12, 24, tcfg).train()
    pred, _ = pm(torch.from_numpy(_spec(1)))
    assert pred.shape == (2, 37, 24) and bool((pred >= 0).all())


UPSTREAM_CASES = {
    "last_layer": t_up.UpstreamOptions(),
    "select_layer_0": t_up.UpstreamOptions(select_layer=0),
    "weighted_sum": t_up.UpstreamOptions(weighted_sum=True),
    "no_grad": t_up.UpstreamOptions(no_grad=True),
}


@pytest.mark.parametrize("case", sorted(UPSTREAM_CASES))
def test_upstream_transformer_matches_jax(case):
    opts = UPSTREAM_CASES[case]
    jcfg, tcfg = configs()
    jopts = j_up.UpstreamOptions(**dataclasses.asdict(opts))
    jup = j_up.UpstreamTransformer(jcfg, 12, jopts, output_size=24, seed=3)
    params = jax.device_get(jup.params)
    if opts.weighted_sum:
        params["layer_weights"] = np.array([0.3, -0.2], np.float32)
    port = t_up.UpstreamTransformer(tcfg, 12, opts, output_size=24).eval()
    port.load_state_dict(flax_to_state_dict(params))
    x = _spec(12, T=33)
    ref = np.asarray(jup(jnp.asarray(x), params=params))
    got = port(torch.from_numpy(x))
    assert_close(got.detach().numpy(), ref, case)
    assert got.requires_grad == (not opts.no_grad)
    ref_spec = np.asarray(jup.spec_head(jnp.asarray(ref), params=params))
    assert_close(port.spec_head(got).detach().numpy(), ref_spec, f"{case} spec_head")


def test_upstream_dropout_override_and_spec_aug_bands():
    _, tcfg = configs()
    up = t_up.UpstreamTransformer(tcfg, 12, t_up.UpstreamOptions(dropout=0.3, spec_aug=True))
    assert up.trainable and up.config.hidden_dropout_prob == 0.3
    assert up.config.attention_probs_dropout_prob == 0.3
    feat = torch.ones(3, 80, 40)
    out = t_up.apply_spec_aug(feat, (0, 0))
    masked_t = (out == 0).all(dim=2)  # whole frames zeroed
    masked_f = (out == 0).all(dim=1)  # whole bins zeroed
    for b in range(3):
        # two bands of width 30 frames and two of 12 bins, possibly overlapping
        assert 30 <= int(masked_t[b].sum()) <= 60
        assert 12 <= int(masked_f[b].sum()) <= 24
    again = t_up.apply_spec_aug(feat, (0, 0))
    assert torch.equal(out, again)
    assert t_up.DummyUpstream(7)(feat) is feat


def _s3prl_state(rng, L=2, H=32, I=64, D_in=12, layernorm="gamma", prefix="", out=24):
    """A synthetic S3PRL ``Transformer`` / ``SpecHead`` state dict."""
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    w, b = ("gamma", "beta") if layernorm == "gamma" else ("weight", "bias")
    sd = {"input_representations.spec_transform.weight": t(H, D_in),
          "input_representations.spec_transform.bias": t(H),
          f"input_representations.LayerNorm.{w}": t(H),
          f"input_representations.LayerNorm.{b}": t(H)}
    for i in range(L):
        p = f"encoder.layer.{i}"
        for name, shape in (("attention.self.query", (H, H)), ("attention.self.key", (H, H)),
                            ("attention.self.value", (H, H)),
                            ("attention.output.dense", (H, H)),
                            ("intermediate.dense", (I, H)), ("output.dense", (H, I))):
            sd[f"{p}.{name}.weight"] = t(*shape)
            sd[f"{p}.{name}.bias"] = t(shape[0])
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{p}.{ln}.{w}"] = t(H)
            sd[f"{p}.{ln}.{b}"] = t(H)
    head = {"dense.weight": t(H, H), "dense.bias": t(H), f"LayerNorm.{w}": t(H),
            f"LayerNorm.{b}": t(H), "output.weight": t(out, H), "output.bias": t(out)}
    return ({prefix + k: v for k, v in sd.items()}, {prefix + k: v for k, v in head.items()})


@pytest.mark.parametrize("layernorm,prefix", [("gamma", ""), ("weight", ""),
                                              ("gamma", "module.")])
def test_s3prl_importer_matches_jax(layernorm, prefix):
    enc, head = _s3prl_state(np.random.default_rng(13), layernorm=layernorm, prefix=prefix)
    for port_fn, jax_fn, sd in ((t_import.convert_transformer_state,
                                 j_import.convert_transformer_state, enc),
                                (t_import.convert_spechead_state,
                                 j_import.convert_spechead_state, head)):
        got = port_fn(sd)
        want = flax_to_state_dict(jax_fn(sd))
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
    # the converted state loads into the port's modules
    _, tcfg = configs()
    t_tf.TransformerEncoder(tcfg).load_state_dict(t_import.convert_transformer_state(enc))
    # and a downstream Mockingjay blob converts like the JAX package's
    blob = {**{f"mockingjay.{k}": v for k, v in enc.items()},
            **{f"spechead.{k}": v for k, v in head.items()}}
    got = t_import.convert_downstream_state(blob, "Mockingjay")
    want = flax_to_state_dict(j_import.convert_downstream_state(blob, "Mockingjay"))
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    t_spec.Mockingjay(12, 24, tcfg).load_state_dict(got)


def test_s3prl_importer_refuses_ambiguous_layernorms():
    enc, _ = _s3prl_state(np.random.default_rng(14))
    no_layers = {k: v for k, v in enc.items() if not k.startswith("encoder.")}
    enc["input_representations.LayerNorm.weight"] = enc["input_representations.LayerNorm.gamma"]
    with pytest.raises(ValueError, match="ambiguous"):
        t_import.convert_transformer_state(enc)
    with pytest.raises(ValueError, match="encoder.layer"):
        t_import.convert_transformer_state(no_layers)
    with pytest.raises(ValueError, match="encoder.layer"):
        j_import.convert_transformer_state(no_layers)


def test_overlay_params_is_strict():
    base = {"a.weight": torch.zeros(2, 3), "a.bias": torch.zeros(2)}
    out = t_import.overlay_params(base, {"a.bias": torch.ones(2)})
    assert torch.equal(out["a.bias"], torch.ones(2)) and out["a.weight"] is base["a.weight"]
    with pytest.raises(KeyError):
        t_import.overlay_params(base, {"b.bias": torch.ones(2)})
    with pytest.raises(ValueError, match="shape"):
        t_import.overlay_params(base, {"a.bias": torch.ones(3)})


def test_weight_bridge_round_trip_of_a_transformer_tree_is_bit_identical():
    """A Mockingjay flax tree (Dense kernels, LayerNorm scales and biases)
    crosses to a state dict and back without a bit changed, and the state
    dict loads into the port's Mockingjay. Before LayerNorm scales crossed,
    ``input_ln.scale`` kept its flax name and the way back raised on the 1-D
    ``.weight``."""
    jcfg, tcfg = configs()
    x = _spec(15)
    _, params, pm = _mockingjay_pair(jcfg, tcfg, x)
    sd = flax_to_state_dict(params)
    assert "mockingjay.input_ln.weight" in sd and "spechead.ln.weight" in sd
    assert not any(k.endswith(".scale") for k in sd)
    back = state_dict_to_flax(sd)["params"]
    flat_a = jax.tree_util.tree_flatten_with_path(jax.device_get(params))[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    assert all(np.array_equal(np.asarray(a), b) and np.asarray(a).dtype == b.dtype
               for (_, a), (_, b) in zip(flat_a, flat_b))
    assert state_dict_to_flax(pm.state_dict())["params"].keys() == back.keys()


def test_bert_adam_exempts_layernorm_weights_by_their_flax_path():
    from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_path
    from speech_enhancement_by_s3prl_tpu_torch.runner.optim import no_decay

    assert flax_path("spechead.ln.weight", 1) == ("params", "spechead", "ln", "scale")
    assert no_decay(flax_path("spechead.ln.weight", 1))
    assert not no_decay(flax_path("spechead.dense.weight", 2))


def test_build_head_takes_the_structure_from_the_pretraining_checkpoint(tmp_path):
    """Mockingjay with --dckpt and SpecHead with --ckpt: the transformer
    config, log-domain flag and (Mockingjay) output width come from the S3PRL
    checkpoint; a YAML path in ``config`` is dropped, a dict promoted."""
    enc, head = _s3prl_state(np.random.default_rng(16), D_in=80, out=201)
    pre_cfg = {"transformer": {**{k: v for k, v in SMALL.items() if k != "input_dim"},
                               "layer_norm_eps": "1e-12"},
               "online": {"input": {"feat_type": "mel", "log": True, "delta": 1,
                                    "cmvn": True},
                          "target": {"feat_type": "linear", "log": True}}}
    path = str(tmp_path / "states-1.ckpt")
    torch.save({"Transformer": enc, "SpecHead": head,
                "Settings": {"Config": pre_cfg, "Paras": {}}}, path)
    mj = t_heads.build_head("Mockingjay", input_size=80, output_size=999, dckpt=path,
                            config="config/vcb.yaml")
    assert isinstance(mj, t_spec.Mockingjay) and mj.log_domain
    assert mj.config.hidden_size == 32 and mj.config.layer_norm_eps == 1e-12
    assert mj.spechead.output.out_features == 201  # the target's width
    pre = t_import.pretrained_head_params("Mockingjay", dckpt=path)
    mj.load_state_dict(t_import.overlay_params(mj.state_dict(), pre))
    assert torch.equal(mj.spechead.dense.weight, head["dense.weight"])
    sh = t_heads.build_head("SpecHead", input_size=32, output_size=201, ckpt=path)
    assert sh.log_domain and sh.spechead.output.out_features == 201
    with pytest.raises(ValueError, match="width"):
        t_heads.build_head("SpecHead", input_size=32, output_size=24, ckpt=path)
    cfg = t_heads.build_head("Mockingjay", input_size=12, output_size=24,
                             config=dict(SMALL)).config
    assert cfg == t_tf.TransformerConfig(**SMALL)
    # the port's loader gives the JAX loader's config and dims
    ours, theirs = t_import.load_s3prl_checkpoint(path), j_import.load_s3prl_checkpoint(path)
    assert dataclasses.asdict(ours.config) == dataclasses.asdict(theirs.config)
    assert (ours.input_dim, ours.output_size, ours.log_domain) == (
        theirs.input_dim, theirs.output_size, theirs.log_domain)


def test_salt_stream_is_a_function_of_seed_and_step():
    a = [t_tf.SaltStream(3, 10)() for _ in range(2)]
    s = t_tf.SaltStream(3, 10)
    assert [s(), s()][0] == a[0]
    assert t_tf.SaltStream(3, 11)() != a[0] and t_tf.SaltStream(4, 10)() != a[0]
    assert all(0 <= v < 2 ** 32 for v in a[0])
    replay = t_tf.SaltStream(salts=[(1, 2)])
    assert replay() == (1, 2)
    with pytest.raises(ValueError, match="ran out"):
        replay()


def test_sinusoidal_table_matches_jax():
    assert np.array_equal(t_tf.sinusoidal_position_encoding(50, 33),
                          j_tf.sinusoidal_position_encoding(50, 33))
    cfg = {"transformer": {"hidden_size": "64", "layer_norm_eps": "1e-5", "extra": 1}}
    assert t_tf.TransformerConfig.from_dict(cfg) == t_tf.TransformerConfig(
        hidden_size=64, layer_norm_eps=1e-5)
