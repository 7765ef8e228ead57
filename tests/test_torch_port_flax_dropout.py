"""The port's dropout streams against the JAX package's on the CPU, from the
same key, with no salt replay.

- flax's key derivation (``utils/flax_rng.py``): ``_fold_in_static`` and its
  separator setting; the key of every dropout site of the encoder (and of a
  ``Mockingjay`` model, whose encoder is the child ``mockingjay``) under the
  flax and the hash routes, read from an un-jitted JAX apply;
- B3's mask forms against the masks the JAX paths draw: the explicit path's
  flax ``nn.Dropout`` and hidden-state hash of the (B, N, T, T)
  probabilities, and the chunked path's per-chunk keys under both, padded
  query axis included, on a rank's rows and heads (batch0, head0);
- spec_aug's band starts (``split(key, 4)``, ``randint``), a rank's rows too;
- the encoder (outputs and parameter gradients) under JAX's defaults and under
  each variable, and in bf16 within the window of tests/test_torch_port_bf16.
The train steps and the two-rank step are in tests/test_torch_port_dropout_steps.py.
"""

import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp
import torch
from flax.core import scope as flax_scope

from speech_enhancement_by_s3prl_tpu.models import spec_head as j_spec
from speech_enhancement_by_s3prl_tpu.models import transformer as j_tf
from speech_enhancement_by_s3prl_tpu.models import upstream as j_up
from speech_enhancement_by_s3prl_tpu_torch.models import heads as t_heads
from speech_enhancement_by_s3prl_tpu_torch.models import transformer as t_tf
from speech_enhancement_by_s3prl_tpu_torch.models import upstream as t_up
from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_to_state_dict
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import attention_kernel as A
from speech_enhancement_by_s3prl_tpu_torch.utils import flax_rng, prng
from tests.test_torch_port_bf16 import window
from tests.test_torch_port_mockingjay import _configs
from tests.test_torch_port_transformer import _compare, _jax_grads, _port_grads, _spec, configs

VARIABLES = ("SE_ATTN_IMPL", "SE_HIDDEN_DROPOUT_IMPL", "SE_DROPOUT_IMPL",
             "SE_ATTN_DROPOUT_CHUNK")
# each selector the JAX package reads, one at a time (SE_ATTN_IMPL=flash in
# the bench's pair: its interpret-mode kernel is the slowest JAX side)
ROUTES = {
    "defaults": {},
    "hidden_hash": {"SE_HIDDEN_DROPOUT_IMPL": "hash"},
    "naive": {"SE_ATTN_IMPL": "naive"},
    "explicit_hash": {"SE_DROPOUT_IMPL": "hash"},
    "chunked_hash": {"SE_ATTN_DROPOUT_CHUNK": "8"},
    "chunked_flax": {"SE_ATTN_DROPOUT_CHUNK": "8", "SE_DROPOUT_IMPL": "flax"},
    "flash_and_hash": {"SE_ATTN_IMPL": "flash", "SE_HIDDEN_DROPOUT_IMPL": "hash"},
}
KEY = 7


def key_of(seed):
    return tuple(int(v) for v in np.asarray(jax.random.PRNGKey(seed)))


@pytest.fixture(autouse=True)
def routes(monkeypatch):
    """Each test starts with no dropout variable set (JAX's defaults) and
    sets the ones it names through ``routes.set``."""
    torch.set_num_threads(1)
    for k in VARIABLES:
        monkeypatch.delenv(k, raising=False)

    class Routes:
        @staticmethod
        def set(env):
            for k in VARIABLES:
                monkeypatch.delenv(k, raising=False)
            for k, v in env.items():
                monkeypatch.setenv(k, v)

    return Routes


# -- flax's key derivation ----------------------------------------------------

def test_fold_in_static_is_flaxs():
    assert flax_rng.FIX_RNG_SEPARATOR == flax.config.flax_fix_rng_separator
    key = jax.random.PRNGKey(3)
    for data in ((), ("Dropout_0", 1), ("mockingjay", "layer_1", "attention", "Dropout_1", 2),
                 (1,), (255, 256, "x"), ("layer_shared", 6)):
        want = tuple(int(v) for v in np.asarray(flax_scope._fold_in_static(key, data)))
        assert flax_rng.fold_in_static(key_of(3), data) == want, data


def _jax_site_keys(module, x, rngs_key, monkeypatch, **kw):
    """Every key a dropout site of an un-jitted JAX apply draws from: the keys
    of ``jax.random.bernoulli`` (flax masks) and ``jax.random.bits`` (the
    hash routes' salts), in call order."""
    keys, bern, bits = [], jax.random.bernoulli, jax.random.bits

    def rec_bern(key, p=0.5, shape=None, mode="low"):
        keys.append(("flax", tuple(int(v) for v in np.asarray(key))))
        return bern(key, p, shape, mode)

    def rec_bits(key, shape=(), dtype=None):
        keys.append(("hash", tuple(int(v) for v in np.asarray(bits(key, shape)).reshape(-1))))
        return bits(key, shape, dtype)

    params = module.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x))["params"]
    monkeypatch.setattr(jax.random, "bernoulli", rec_bern)
    monkeypatch.setattr(jax.random, "bits", rec_bits)
    module.apply({"params": params}, jnp.asarray(x), deterministic=False,
                 rngs={"dropout": jax.random.PRNGKey(rngs_key)}, **kw)
    monkeypatch.setattr(jax.random, "bernoulli", bern)
    monkeypatch.setattr(jax.random, "bits", bits)
    return keys, params


def _port_site_keys(module, x, stream):
    """The keys (flax routes) and salts (hash routes) of the port's sites."""
    keys = []
    drop, flash, hashed = t_tf.threefry_dropout, t_tf.flash_attention, t_tf.hash_dropout

    def rec_drop(x, key, rate, batch0=0):
        keys.append(("flax", tuple(key)))
        return drop(x, key, rate, batch0)

    def rec_flash(q, k, v, scale, rate, salt, *a, form="hash", **kw):
        keys.append(("flax" if form == "flax" else "hash", tuple(salt)))
        return flash(q, k, v, scale, rate, salt, *a, form=form, **kw)

    def rec_hash(x, rate, salt, batch0=0):
        keys.append(("hash", tuple(salt)))
        return hashed(x, rate, salt, batch0)

    t_tf.threefry_dropout, t_tf.flash_attention, t_tf.hash_dropout = rec_drop, rec_flash, rec_hash
    try:
        module.train()
        module(torch.from_numpy(x), salts=stream)
    finally:
        t_tf.threefry_dropout, t_tf.flash_attention, t_tf.hash_dropout = drop, flash, hashed
    return keys


@pytest.mark.parametrize("route", ["defaults", "hidden_hash", "naive", "explicit_hash"])
@pytest.mark.parametrize("share", [False, True], ids=["layers", "shared_layer"])
def test_every_site_draws_jaxs_key(routes, monkeypatch, route, share):
    """The encoder's 1 + 3 L sites (the input, per layer the probabilities,
    the attention output, the FFN output) draw JAX's keys in JAX's order, a
    shared layer's counts carrying over from call to call."""
    routes.set(ROUTES[route])
    jcfg, tcfg = configs(share_layer=share)
    x = _spec(3, T=23)
    keys, params = _jax_site_keys(j_tf.TransformerEncoder(jcfg), x, KEY, monkeypatch)
    L = jcfg.num_hidden_layers
    assert len(keys) == 1 + 3 * L
    port = t_tf.TransformerEncoder(tcfg, input_dim=12)
    port.load_state_dict(flax_to_state_dict(params))
    got = _port_site_keys(port, x, t_tf.SaltStream(key=key_of(KEY)))
    # B3's flash hash takes bits(key, (1, 2)), the pair bits(key, (2,)) gives
    assert got == keys


def test_mockingjay_sites_fold_in_the_encoders_name(monkeypatch):
    """In the ``Mockingjay`` model the encoder is the child ``mockingjay`` of
    the apply's root: its sites' keys fold that name in."""
    jcfg, tcfg = _configs(0.1)
    x = np.random.default_rng(5).standard_normal((2, 19, 80)).astype(np.float32)
    keys, params = _jax_site_keys(j_spec.Mockingjay(output_size=24, config=jcfg), x, KEY,
                                  monkeypatch)
    port = t_heads.build_head("Mockingjay", 80, 24, config=tcfg)
    port.load_state_dict(flax_to_state_dict(params))
    assert _port_site_keys(port, x, t_tf.SaltStream(key=key_of(KEY))) == keys
    # the encoder as the root draws other keys
    alone = _port_site_keys(port.mockingjay, x, t_tf.SaltStream(key=key_of(KEY)))
    assert alone != keys and len(alone) == len(keys)


def test_salt_replay_refuses_a_flax_site():
    _, tcfg = configs()
    port = t_tf.TransformerEncoder(tcfg, input_dim=12).train()
    with pytest.raises(ValueError, match="replayed SaltStream"):
        port(torch.zeros(1, 5, 12), t_tf.SaltStream(salts=[(1, 2)]))


# -- B3's mask forms ------------------------------------------------------------

B, N, T, CHUNK = 3, 4, 21, 8


@pytest.fixture(scope="module")
def jax_masks():
    """The masks the JAX paths draw on (B, N, T, T) probabilities from one key
    (the explicit path's flax and hash masks, the chunked path's per-chunk
    ones on its padded query axis, cut to T)."""
    rng = jax.random.PRNGKey(9)
    keep = 0.9
    ones = jnp.ones((B, N, T, T), jnp.float32)
    salt = jax.random.bits(rng, (2,), jnp.uint32)
    salt_f = jax.lax.bitcast_convert_type(salt, jnp.float32)
    out = {"flax": np.asarray(jax.random.bernoulli(rng, keep, (B, N, T, T))),
           "hidden_hash": np.asarray(j_tf._hash_mask_apply(ones, salt_f, 0.1) != 0)}
    nc = -(-T // CHUNK)
    flax_c, hash_c = [], []
    for i in range(nc):
        k = jax.random.fold_in(rng, i)
        flax_c.append(np.asarray(jax.random.bernoulli(k, keep, (B, N, CHUNK, T))))
        s = jax.lax.bitcast_convert_type(jax.random.bits(k, (2,), jnp.uint32), jnp.float32)
        hash_c.append(np.asarray(j_tf._hash_mask_apply(jnp.ones((B, N, CHUNK, T)), s, 0.1)
                                 != 0))
    out["flax_chunked"] = np.concatenate(flax_c, axis=2)[:, :, :T]
    out["hidden_hash_chunked"] = np.concatenate(hash_c, axis=2)[:, :, :T]
    return out


@pytest.mark.parametrize("form,chunk", [("flax", 0), ("hidden_hash", 0), ("flax", CHUNK),
                                        ("hidden_hash", CHUNK)])
def test_b3_mask_forms_are_the_jax_paths_masks(jax_masks, form, chunk):
    """B3's plain mask in each form, whole and on rows 1.. and heads 1-2 of
    the launch (batch0, head0 of n_heads_total), against the JAX path's."""
    want = jax_masks[form + ("_chunked" if chunk else "")]
    rng = key_of(9)
    words = rng if (form == "flax" or chunk) else prng.host_bits(rng, 2)
    got = A._full_mask(B, N, T, words, 0.1, 0, "cpu", 0, None, form, chunk)
    assert np.array_equal(got.numpy(), want)
    part = A._full_mask(B - 1, 2, T, words, 0.1, 1, "cpu", 1, N, form, chunk)
    assert np.array_equal(part.numpy(), want[1:, 1:3])
    # and through B3's plain forward: q = k = 0, v one-hot by key, so out is
    # keep / (T keep_prob) or 0
    v = torch.zeros(B, T, N, T)
    v[:, torch.arange(T), :, torch.arange(T)] = 1.0
    v = v.reshape(B, T, N * T)
    out, _ = A.flash_attention_fwd(torch.zeros(B, T, N * T), torch.zeros(B, T, N * T), v, 1.0,
                                   0.1, words, n_heads=N, form=form, chunk=chunk)
    assert np.array_equal((out.reshape(B, T, N, T).permute(0, 2, 1, 3) > 0).numpy(), want)


# -- spec_aug -----------------------------------------------------------------

def test_spec_aug_bands_are_jaxs():
    feat = np.ones((5, 97, 40), np.float32)
    key = jax.random.PRNGKey(13)
    want = np.asarray(j_up.apply_spec_aug(jnp.asarray(feat), key))
    got = t_up.apply_spec_aug(torch.from_numpy(feat), key_of(13)).numpy()
    assert np.array_equal(got, want)
    # a rank's rows 2..3 of the 5 draw those rows' bands
    part = t_up.apply_spec_aug(torch.from_numpy(feat[2:4]), key_of(13), batch0=2, global_batch=5)
    assert np.array_equal(part.numpy(), want[2:4])


# -- the encoder, the Mockingjay and the upstream steps ---------------------------

@pytest.mark.parametrize("route", [r for r in ROUTES if r != "flash"])
def test_encoder_matches_jax_from_the_same_key(routes, route):
    """Outputs and every parameter's gradient within RTOL 1e-5, both rates
    live, no salts replayed; another key gives another output."""
    routes.set(ROUTES[route])
    jcfg, tcfg = configs(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.2)
    x = _spec(4, T=29)
    enc = j_tf.TransformerEncoder(jcfg)
    params = enc.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(x))["params"]
    cot = np.random.default_rng(6).standard_normal((2, 29, 32)).astype(np.float32)
    jax_side = _jax_grads(enc, params, cot, jnp.asarray(x), deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(KEY)})
    port = t_tf.TransformerEncoder(tcfg, input_dim=12)
    port.load_state_dict(flax_to_state_dict(params))
    port.train()
    _compare(jax_side, _port_grads(port, cot, torch.from_numpy(x),
                                   t_tf.SaltStream(key=key_of(KEY))), route)
    other = port(torch.from_numpy(x), t_tf.SaltStream(key=key_of(KEY + 1))).detach().numpy()
    assert np.abs(other - jax_side[0]).max() > 1e-3 * np.abs(jax_side[0]).max()


def test_encoder_in_bf16_within_the_window_from_the_same_key():
    """JAX's default routes in bf16: the port's output and input gradient
    within the window of tests/test_torch_port_bf16.py."""
    jcfg, tcfg = configs()
    x = _spec(11, T=41)
    params = j_tf.TransformerEncoder(jcfg).init({"params": jax.random.PRNGKey(3)},
                                                jnp.asarray(x))["params"]
    cot = np.random.default_rng(12).standard_normal((2, 41, 32)).astype(np.float32)
    sides = {}
    for name, jdt, tdt in (("bf16", jnp.bfloat16, torch.bfloat16),
                           ("f32", jnp.float32, torch.float32)):
        module = j_tf.TransformerEncoder(jcfg, compute_dtype=jdt)

        def loss(xx, module=module):
            out = module.apply({"params": params}, xx, deterministic=False,
                               rngs={"dropout": jax.random.PRNGKey(KEY)})
            return (out * cot).sum(), out

        (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(x))
        sides[("jax", name)] = (np.asarray(out, np.float32), np.asarray(g))
        port = t_tf.TransformerEncoder(tcfg, input_dim=12, compute_dtype=tdt)
        port.load_state_dict(flax_to_state_dict(params))
        port.train()
        xt = torch.from_numpy(x).requires_grad_()
        pout = port(xt, t_tf.SaltStream(key=key_of(KEY)))
        (pg,) = torch.autograd.grad((pout * torch.from_numpy(cot)).sum(), xt)
        sides[("port", name)] = (pout.detach().float().numpy(), pg.numpy())
    for i, what in ((0, "output"), (1, "input gradient")):
        window(*(sides[k][i] for k in (("port", "bf16"), ("port", "f32"), ("jax", "bf16"),
                                       ("jax", "f32"))), what)
