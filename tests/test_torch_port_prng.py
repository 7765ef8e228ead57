"""The port's copy of JAX's threefry PRNG (``utils/prng.py``) against
``jax.random`` on the CPU, bit for bit.

Keys (``PRNGKey`` of several seeds, past 2^32 and negative; ``split``;
``fold_in``), ``bits`` / ``uniform`` / ``bernoulli`` / ``randint`` over
several shapes and keys, a slice of a draw through ``offset``, the counter's
high word (indices past 2^32 against JAX's own threefry2x32 on (hi, lo)), the
salts the hash routes take (``bits(key, (2,))`` and ``bits(key, (1, 2))``),
``keep_threshold23`` against float32 ``uniform < p`` at every mantissa near
the threshold, and D1's plain version against flax ``nn.Dropout`` (f32 and
bf16 inputs, a rank's rows, the gradient). The JAX side's draws are shared
through module-scoped fixtures.
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as nn
from jax._src import prng as jax_prng

from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import dropout_kernel as R
from speech_enhancement_by_s3prl_tpu_torch.utils import flax_rng, prng

SEEDS = (0, 1, 7, 12345, 2 ** 32 + 5, -3)
SHAPES = ((5,), (3, 7), (2, 3, 11), (4, 33, 40))
RATES = (0.1, 0.2, 0.3, 0.5, 0.25, 1e-7, 0.9999999)


def key_of(seed):
    return tuple(int(v) for v in np.asarray(jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_draws():
    """Every JAX draw the tests compare with, by (what, seed, shape, ...)."""
    out = {}
    for seed in SEEDS:
        k = jax.random.PRNGKey(seed)
        out[("key", seed)] = key_of(seed)
        out[("split", seed)] = [tuple(map(int, r)) for r in np.asarray(jax.random.split(k, 5))]
        out[("fold_in", seed)] = [tuple(map(int, np.asarray(jax.random.fold_in(k, d))))
                                  for d in (0, 1, 2 ** 31 + 7, 2 ** 32 - 1)]
        out[("salt", seed)] = (np.asarray(jax.random.bits(k, (2,))),
                               np.asarray(jax.random.bits(k, (1, 2))))
        for shape in SHAPES:
            out[("bits", seed, shape)] = np.asarray(jax.random.bits(k, shape))
            out[("uniform", seed, shape)] = np.asarray(jax.random.uniform(k, shape))
            for lo, hi in ((0, 971), (0, 1), (-5, 2 ** 31 - 1), (3, 3)):
                out[("randint", seed, shape, lo, hi)] = np.asarray(
                    jax.random.randint(k, shape, lo, hi))
        for p in RATES:
            out[("bernoulli", seed, p)] = np.asarray(jax.random.bernoulli(k, 1.0 - p, (4096,)))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_match_jax(jax_draws, seed):
    key = prng.PRNGKey(seed)
    assert key == jax_draws[("key", seed)]
    assert list(prng.split(key, 5)) == jax_draws[("split", seed)]
    assert [prng.fold_in(key, d) for d in (0, 1, 2 ** 31 + 7, 2 ** 32 - 1)] == \
        jax_draws[("fold_in", seed)]
    # the partitionable split is a fold_in of the index
    assert all(prng.split(key, 5)[i] == prng.fold_in(key, i) for i in range(5))
    # a hash route's salt: bits(key, (2,)) as the hidden hash draws it and
    # bits(key, (1, 2)) as the flash kernel does, the same pair
    flat, flash = jax_draws[("salt", seed)]
    assert prng.host_bits(key, 2) == tuple(int(v) for v in flat) == tuple(
        int(v) for v in flash.reshape(-1))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_uniform_randint_match_jax(jax_draws, seed, shape):
    key = prng.PRNGKey(seed)
    assert np.array_equal(prng.bits(key, shape).numpy(),
                          jax_draws[("bits", seed, shape)].astype(np.int64))
    assert np.array_equal(prng.uniform(key, shape).numpy(), jax_draws[("uniform", seed, shape)])
    for lo, hi in ((0, 971), (0, 1), (-5, 2 ** 31 - 1), (3, 3)):
        assert np.array_equal(prng.randint(key, shape, lo, hi).numpy(),
                              jax_draws[("randint", seed, shape, lo, hi)]), (lo, hi)
    # a slice of the draw through its offset
    n = math.prod(shape)
    tail = prng.bits(key, (n - 2,), offset=2).numpy()
    assert np.array_equal(tail, jax_draws[("bits", seed, shape)].reshape(-1)[2:].astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli_matches_jax_at_every_rate(jax_draws, seed):
    key = prng.PRNGKey(seed)
    for p in RATES:
        assert np.array_equal(prng.bernoulli(key, 1.0 - p, (4096,)).numpy(),
                              jax_draws[("bernoulli", seed, p)]), p


def test_counters_past_2_to_32_are_jax_threefry_of_hi_and_lo():
    """Flat indices past 2^32 (a Mockingjay batch far into a data-parallel
    run): the counter's high word, against JAX's threefry2x32 of (hi, lo)."""
    key = prng.PRNGKey(11)
    idx = np.array([2 ** 32 - 1, 2 ** 32, 2 ** 32 + 1, 6000 * 1001 * 768 + 5, 2 ** 40 + 3],
                   dtype=np.uint64)
    hi, lo = (idx >> 32).astype(np.uint32), (idx & 0xFFFFFFFF).astype(np.uint32)
    y = np.asarray(jax_prng.threefry_2x32(jnp.asarray(key, jnp.uint32),
                                          jnp.concatenate([hi, lo])))
    want = (y[:len(idx)] ^ y[len(idx):]).astype(np.int64)
    got = prng.bits_of(key, torch.from_numpy(idx.astype(np.int64))).numpy()
    assert np.array_equal(got, want)
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("p", (0.9, 0.8, 0.5, 0.75, 1e-7, 0.9999999, 1.0, 0.0))
def test_keep_threshold23_is_the_float32_compare(p):
    """uniform < float32(p) exactly when bits >> 9 < keep_threshold23(p), at
    every 23-bit mantissa within 64 of the threshold."""
    t = prng.keep_threshold23(p)
    p32 = np.float32(p)
    ms = np.arange(max(t - 64, 0), min(t + 64, 2 ** 23), dtype=np.uint32)
    u = (ms | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    assert np.array_equal(u < p32, ms < t)


@pytest.fixture(scope="module")
def flax_dropout():
    """flax ``nn.Dropout(0.1)`` on (6, 9, 20) inputs, f32 and bf16, from one
    key: outputs and the input cotangent's image."""
    x = np.random.default_rng(3).standard_normal((6, 9, 20)).astype(np.float32)
    g = np.random.default_rng(4).standard_normal((6, 9, 20)).astype(np.float32)
    key = jax.random.PRNGKey(21)
    out = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        def f(v, dt=dt):
            return nn.Dropout(0.1).apply({}, v, deterministic=False, rngs={"dropout": key})

        y, vjp = jax.vjp(f, jnp.asarray(x, dt))
        out[name] = (np.asarray(y.astype(jnp.float32)), np.asarray(
            vjp(jnp.asarray(g, dt))[0].astype(jnp.float32)))
    # the module is the apply's root: its one make_rng folds in (1,)
    return x, g, flax_rng.fold_in_static(key_of(21), (1,)), out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_d1_plain_version_is_flax_dropout(flax_dropout, dtype):
    """D1's plain version (a CPU tensor) against flax ``nn.Dropout`` bit for
    bit: the bf16 division by bf16(0.9), not by 0.9; rows 2.. at batch0 2
    are those rows of the whole draw; the gradient is flax's."""
    x, g, key, out = flax_dropout
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    xt = torch.from_numpy(x).to(tdt)
    y = R.threefry_dropout(xt, key, 0.1)
    assert np.array_equal(y.float().numpy(), out[dtype][0])
    assert np.array_equal(R.threefry_dropout(xt[2:], key, 0.1, batch0=2).float().numpy(),
                          out[dtype][0][2:])
    xg = xt.clone().requires_grad_()
    (dx,) = torch.autograd.grad(R.threefry_dropout(xg, key, 0.1), xg, torch.from_numpy(g).to(tdt))
    assert np.array_equal(dx.float().numpy(), out[dtype][1])
    if dtype == "bf16":
        # 0.9 itself would give other bits on some element
        other = torch.where(y != 0, (xt.float() / 0.9).to(tdt), 0.0)
        assert not torch.equal(other, y)
    assert R.threefry_dropout_kernel.launches == 0  # the CPU runs the plain version
    assert R.threefry_dropout(xt, key, 0.0) is xt
    assert torch.equal(R.threefry_dropout(xt, key, 1.0), torch.zeros_like(xt))
