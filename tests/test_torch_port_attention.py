"""The port's flash attention (kernel B3) against the JAX package, on the CPU.

The plain versions ``flash_attention_ref`` / ``flash_attention_bwd_ref`` are
held against the Pallas kernels ``_fwd_impl`` / ``_bwd_impl`` run in interpret
mode, with the same salt (``jax.random.bits(key, (1, 2), uint32)``), odd T, a
key bias and ``batch0``; ``FlashAttention`` against ``jax.vjp`` of the JAX
``flash_attention`` and against plain autograd through the plain version. Both
dropout hashes (attention, hidden states) are held bit for bit against the JAX
functions and the numpy ``_host_mask`` of the JAX package's tests, with salts
and indices near 2^32. The CUDA kernels are held against the plain versions on
the card by chip_smoke.py. The split-TF32 arithmetic of B3 bwd's tensor-core
products is modelled by ``split_tf32`` / ``matmul_tf32x3`` and held against a
float64 backward: three passes stay inside the kernel's limit, one does not.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_by_s3prl_tpu.models import transformer as j_tf
from speech_enhancement_by_s3prl_tpu.ops.pallas import attention_kernel as J
from speech_enhancement_by_s3prl_tpu_torch.models import transformer as t_tf
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import attention_kernel as A
from tests.test_flash_attention import _host_mask

# out and lse: the same f32 softmax and products with sums in other orders
# (|out| ~ 1, logits ~ 3 here).
FWD_ATOL = 2e-5
# dq, dk, dv: one more product and the softmax Jacobian.
BWD_ATOL = 3e-5
SCALE = 0.3


def _qkv(seed, B, T, N, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, N * D)).astype(np.float32) for _ in range(4)]


def _salt(seed):
    return np.asarray(jax.random.bits(jax.random.PRNGKey(seed), (1, 2), jnp.uint32))


def _jax_impl(q, k, v, salt, b0, kbias, rate, N, D):
    """The Pallas kernels in interpret mode: (out, lse (B, N, T)) and the
    residuals for ``_bwd_impl``."""
    B, T, _ = q.shape
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jax.lax.bitcast_convert_type(jnp.asarray(salt), jnp.float32),
            jnp.full((1, 1), b0, jnp.int32), jnp.asarray(kbias))
    out, lse = J._fwd_impl(*args, SCALE, rate, 256, True, N, D)
    return out, lse, np.asarray(lse).reshape(B, N, -1)[:, :, :T], args


CASES = [  # B, T, N, D, rate, kbias, batch0
    (2, 67, 4, 8, 0.0, False, 0),
    (2, 67, 4, 8, 0.1, True, 0),
    (3, 33, 2, 16, 0.3, True, 5),
    (1, 101, 4, 8, 0.5, False, 2),
    # the card's widest instance (3 heads of 256: a 768 encoder), and 192,
    # which it runs zero-padded to 256 (4 heads)
    (2, 24, 3, 256, 0.0, True, 0),
    (2, 24, 3, 256, 0.1, True, 3),
    (2, 20, 4, 192, 0.0, True, 0),
    (2, 20, 4, 192, 0.1, True, 1),
]


@pytest.mark.parametrize("B,T,N,D,rate,bias,b0", CASES)
def test_forward_matches_pallas_kernel(B, T, N, D, rate, bias, b0):
    q, k, v, kb = _qkv(B * T + N, B, T, N, D)
    kbias = kb[:, :, 0] if bias else np.zeros((B, T), np.float32)
    salt = _salt(T)
    out, _, lse, _ = _jax_impl(q, k, v, salt, b0, kbias, rate, N, D)
    t = [torch.from_numpy(x) for x in (q, k, v, kbias)]
    o, l = A.flash_attention_fwd(*t[:3], SCALE, rate, tuple(salt[0]), t[3] if bias else None,
                                 b0, n_heads=N)
    assert o.shape == (B, T, N * D) and l.shape == (B, N, T)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(l.numpy(), lse, atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("B,T,N,D,rate,bias,b0", CASES)
def test_backward_matches_pallas_kernel(B, T, N, D, rate, bias, b0):
    q, k, v, kb = _qkv(B * T + N + 1, B, T, N, D)
    kbias = kb[:, :, 0] if bias else np.zeros((B, T), np.float32)
    do = np.random.default_rng(B).standard_normal(q.shape).astype(np.float32)
    salt = _salt(T + 1)
    out, lse_j, lse, args = _jax_impl(q, k, v, salt, b0, kbias, rate, N, D)
    ref = J._bwd_impl(*args, out, lse_j, jnp.asarray(do), SCALE, rate, 256, True, N, D)
    t = [torch.from_numpy(x) for x in (q, k, v, kbias)]
    got = A.flash_attention_bwd(*t[:3], torch.from_numpy(np.array(out)),
                                torch.from_numpy(lse), torch.from_numpy(do), SCALE, rate,
                                tuple(salt[0]), t[3] if bias else None, b0, n_heads=N)
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=BWD_ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_flash_attention_gradients_match_jax_vjp(rate):
    """``FlashAttention`` under autograd against ``jax.vjp`` of the JAX
    ``flash_attention`` (custom VJP, interpret mode), and against autograd
    through the plain version."""
    B, T, N, D = 2, 45, 4, 8
    q, k, v, do = _qkv(9, B, T, N, D)
    key = jax.random.PRNGKey(4)
    salt = tuple(np.asarray(jax.random.bits(key, (1, 2), jnp.uint32))[0])

    def jfn(q, k, v):
        r = lambda x: x.reshape(B, T, N, D)  # noqa: E731
        out = J.flash_attention(r(q), r(k), r(v), SCALE, rate=rate,
                                rng=key if rate else None, interpret=True)
        return out.reshape(B, T, N * D)

    jout, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = A.flash_attention(*leaves, SCALE, rate, salt, n_heads=N)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=FWD_ATOL, rtol=0)
    for g, r in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=BWD_ATOL, rtol=0)
    leaves2 = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ref, _ = A.flash_attention_ref(*leaves2, SCALE, rate, salt, n_heads=N)
    ref_grads = torch.autograd.grad(ref, leaves2, torch.from_numpy(do))
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, atol=BWD_ATOL, rtol=0)


def test_function_saves_no_mask_and_counts_no_launch_on_cpu():
    B, T, N, D = 1, 20, 2, 8
    q, k, v, _ = _qkv(3, B, T, N, D)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    A.flash_attention_fwd.launches = A.flash_attention_bwd.launches = 0
    out = A.flash_attention(*leaves, SCALE, 0.5, (1, 2), n_heads=N)
    saved = out.grad_fn.saved_tensors
    assert all(s is None or s.dtype == torch.float32 for s in saved)
    assert sum(s.numel() for s in saved if s is not None) <= 5 * B * T * N * D
    out.sum().backward()
    assert A.flash_attention_fwd.launches == A.flash_attention_bwd.launches == 0


def test_instance_width_pads_to_the_next_kernel_instance():
    assert [A.instance_width(d) for d in (8, 16, 32, 33, 48, 64, 96, 128, 129, 192, 256)] == \
        [32, 32, 32, 64, 64, 64, 128, 128, 256, 256, 256]
    with pytest.raises(ValueError, match="up to 256"):
        A.instance_width(257)
    assert [A.fwd_bf16_keys(d) for d in (32, 64, 128, 256)] == [64, 64, 64, 32]
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 20)
    padded = A.pad_heads(x, 4, 8)
    assert padded.shape == (2, 3, 32) and padded.is_contiguous()
    heads = padded.reshape(2, 3, 4, 8)
    assert torch.equal(heads[..., :5], x.reshape(2, 3, 4, 5)) and not heads[..., 5:].any()
    assert torch.equal(A.unpad_heads(padded, 4, 5), x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 48, 192])
def test_padded_heads_give_the_unpadded_attention(D, dtype):
    """What the CUDA wrappers do at a head width between the kernels'
    instances: each head zero-padded to the next instance (16 -> 32, 48 ->
    64, 192 -> 256), the true D's scale, the padded columns cut off out and off dq, dk,
    dv. On the plain versions the padded call gives the unpadded one (the
    same products plus zeros, the same mask: the hash never reads D), forward
    and gradient, f32 and bf16, with dropout live and a key bias."""
    B, T, N = 2, 45, 3
    W = A.instance_width(D)
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in _qkv(2100 + D, B, T, N, D))
    kbias = torch.from_numpy(np.random.default_rng(D).standard_normal((B, T)).astype(
        np.float32))
    args = (D ** -0.5, 0.2, (0x12345678, 0x9ABCDEF0), kbias, 3)
    pad = lambda x: A.pad_heads(x, N, W)  # noqa: E731
    unpad = lambda x: A.unpad_heads(x, N, D)  # noqa: E731
    out, lse = A.flash_attention_ref(q, k, v, *args, n_heads=N)
    p_out, p_lse = A.flash_attention_ref(pad(q), pad(k), pad(v), *args, n_heads=N)
    grads = A.flash_attention_bwd_ref(q, k, v, out, lse, do, *args, n_heads=N)
    p_grads = A.flash_attention_bwd_ref(pad(q), pad(k), pad(v), pad(out), lse, pad(do), *args,
                                        n_heads=N)
    # f32: sums of the same products in other orders; bf16: the same, then
    # one rounding of the result, which a last-bit difference may flip
    for got, want in [(unpad(p_out), out)] + [(unpad(g), r) for g, r in zip(p_grads, grads)]:
        got, want = got.float(), want.float()
        scale = float(want.abs().max())
        tol = 1e-6 * scale if dtype == torch.float32 else 2.0 ** (
            np.floor(np.log2(scale)) - 7)
        torch.testing.assert_close(got, want, atol=tol, rtol=0)
    torch.testing.assert_close(p_lse, lse, atol=1e-6 * float(lse.abs().max()), rtol=0)
    for g in (p_out,) + tuple(p_grads):
        assert not g.reshape(B, T, N, W)[..., D:].any()


def _np_hash(bn, qi, ki, salt, rate):
    """The attention hash in numpy uint32 (wrapping) arithmetic."""
    u = np.uint32
    with np.errstate(over="ignore"):
        h = (qi.astype(u) * u(J._PHI1)) ^ (ki.astype(u) * u(J._PHI2)) \
            ^ (u(bn) * u(J._PHI4)) ^ u(salt[0])
        h ^= h >> u(16)
        h *= u(J._PHI3)
        h ^= h >> u(13)
        h ^= u(salt[1])
        h *= u(J._PHI1)
        h ^= h >> u(16)
    return h < u(A.keep_threshold(rate))


@pytest.mark.parametrize("salt", [(0, 0), (4294967295, 4294967294), (123456789, 2 ** 31)])
def test_attention_hash_is_bit_exact(salt):
    """The attention mask against the JAX ``_dropout_mask`` (the function
    the Pallas kernels call) at head and query indices near 2^32, against
    numpy uint32 arithmetic at key indices near 2^32, and over a whole
    (B, N, T, T) block against the numpy ``_host_mask``."""
    rate = 0.3
    salt_ref = jnp.asarray(np.array([salt], np.uint32).view(np.float32))
    for bn in (0, 11, 2 ** 32 - 1):
        for q0 in (0, 65534, 2 ** 31 - 2, 2 ** 32 - 3):
            ref = np.asarray(J._dropout_mask(np.uint32(bn), np.uint32(q0), 4, 16,
                                             salt_ref, rate))
            qi = torch.arange(4, dtype=torch.int64)[:, None] + q0
            got = A.dropout_keep_mask(torch.tensor(bn), qi, torch.arange(16)[None, :],
                                      salt, rate)
            assert np.array_equal(got.numpy(), ref), (bn, q0)
    qi = np.array([0, 1, 65535, 65536, 2 ** 31 - 1, 2 ** 32 - 2, 2 ** 32 - 1], np.int64)
    ki = np.array([0, 7, 2 ** 16 + 3, 2 ** 32 - 1, 2 ** 32 - 5], np.int64)
    got = A.dropout_keep_mask(torch.tensor(2 ** 32 - 7), torch.from_numpy(qi)[:, None],
                              torch.from_numpy(ki)[None, :], salt, rate)
    assert np.array_equal(got.numpy(), _np_hash(2 ** 32 - 7, qi[:, None], ki[None, :], salt,
                                                rate))
    B, N, T = 2, 3, 40
    ar = torch.arange
    bn = (ar(B)[:, None] * N + ar(N)[None, :])[:, :, None, None]
    mask = A.dropout_keep_mask(bn, ar(T)[:, None], ar(T)[None, :], salt, rate)
    assert np.array_equal(mask.numpy(), np.asarray(_host_mask(salt, B, N, T, T, rate)))


@pytest.mark.parametrize("shape,salt", [
    ((3, 5, 7), (0, 0)),
    ((2, 33, 16), (4294967295, 4294967295)),
    ((4, 3), (2 ** 31 + 17, 987654321)),
])
def test_hidden_hash_is_bit_exact(shape, salt):
    """``hash_dropout`` of the port against ``_hash_mask_apply`` of the JAX
    package (same salt as its f32 bitcast): the same kept elements and
    values, and its backward re-derives the mask."""
    rate = 0.25
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32) + 3.0
    salt_f = jnp.asarray(np.array(salt, np.uint32).view(np.float32))
    ref = np.asarray(j_tf._hash_mask_apply(jnp.asarray(x), salt_f, rate))
    xt = torch.from_numpy(x).requires_grad_()
    got = t_tf.hash_dropout(xt, rate, salt)
    assert np.array_equal(got.detach().numpy() == 0, ref == 0)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-7, atol=0)
    (g,) = torch.autograd.grad(got.sum(), xt)
    assert np.array_equal(g.numpy() == 0, ref == 0)


def test_hidden_hash_handles_flat_indices_near_2_to_32():
    """The multiply of the hash in 16-bit halves: inner indices and salts
    near 2^32 give numpy's uint32 wraparound."""
    idx = np.array([2 ** 32 - 1, 2 ** 32 - 2, 2 ** 31, 65535, 65536, 0], np.uint64)
    with np.errstate(over="ignore"):
        for c in (A.PHI1, A.PHI2, A.PHI3, A.PHI4, 2246822519, 3266489917, 40503):
            want = (idx.astype(np.uint32) * np.uint32(c)).astype(np.int64)
            got = A.mul32(torch.from_numpy(idx.astype(np.int64)), c).numpy()
            assert np.array_equal(got, want), c


def test_keep_threshold_matches_jax():
    for rate in (0.0, 0.1, 0.25, 0.5, 1e-9):
        keep = 1.0 - rate
        assert A.keep_threshold(rate) == min(int(keep * 4294967296.0), 4294967295)


# chip_smoke.py's limit for B3 against its plain version, relative to the
# largest |value|
B3_TOL = 1e-4


def test_split_tf32_keeps_21_bits_in_two_tf32_values():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32)
                         * np.float32(37.0))
    hi, lo = A.split_tf32(x)
    for part in (hi, lo):  # representable in TF32: the low 13 mantissa bits are clear
        assert not (part.view(torch.int32) & 0x1FFF).any()
    # hi is x rounded to 11 significant bits, hi + lo to 22
    assert float(((x - hi).abs() / x.abs()).max()) <= 2.0 ** -11
    assert float(((x - (hi + lo)).abs() / x.abs()).max()) <= 2.0 ** -21
    # ties round away from zero, as cvt.rna does: 1 + 2^-11 -> 1 + 2^-10
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert torch.equal(A.split_tf32(tie)[0], torch.tensor([1.0 + 2.0 ** -10,
                                                           -(1.0 + 2.0 ** -10)]))
    assert torch.equal(A.split_tf32(torch.zeros(3))[0], torch.zeros(3))


@pytest.mark.parametrize("passes,within", [(3, True), (1, False)])
def test_backward_on_split_tf32_products(passes, within):
    """``flash_attention_bwd_ref`` with its five products computed as the
    kernel computes them, at B=2, T=130, 12 heads of 64, dropout 0.1 and a key
    bias, against the same backward in float64: three passes stay within
    B3_TOL of the largest |value| (and near the f32 products' own error), a
    single TF32 pass does not: the reason the kernel takes three."""
    B, T, N, D = 2, 130, 12, 64
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, T, N * D)).astype(np.float32))
                   for _ in range(4))
    kbias = torch.from_numpy((2.0 * rng.standard_normal((B, T))).astype(np.float32))
    salt, rate, scale, b0 = (0x9E3779B9, 0xDEADBEEF), 0.1, D ** -0.5, 3
    out, lse = A.flash_attention_ref(q, k, v, scale, rate, salt, kbias, b0, n_heads=N)
    want = A.flash_attention_bwd_ref(*(x.double() for x in (q, k, v, out, lse, do)), scale,
                                     rate, salt, kbias.double(), b0, n_heads=N)

    def errs(matmul):
        got = A.flash_attention_bwd_ref(q, k, v, out, lse, do, scale, rate, salt, kbias, b0,
                                        n_heads=N, matmul=matmul)
        return [float((g.double() - w).abs().max() / w.abs().max())
                for g, w in zip(got, want)]

    model = errs(lambda a, b: A.matmul_tf32x3(a, b, passes))
    if within:
        assert max(model) < B3_TOL
        assert max(model) < 4 * max(errs(torch.matmul))  # f32-level, not just in-limit
    else:
        assert min(model) > B3_TOL
