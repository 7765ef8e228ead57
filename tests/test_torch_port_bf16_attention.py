"""The port's flash attention in bf16 (kernels B3 fwd bf16 / B3 bwd bf16)
against the JAX package, on the CPU.

The plain bf16 versions (``flash_attention_ref`` / ``flash_attention_bwd_ref``
on bf16 q, k, v) are held against the Pallas kernels ``_fwd_impl`` /
``_bwd_impl`` run in interpret mode on bf16 inputs, with the same salt, at rate
0, at rate 0.25 and at a ragged T with a key bias: both round at the same
points (scale * q in bf16, f32 logits from exact bf16 products, p rounded to
bf16 into P V, do / keep, the dropped p and ds rounded to bf16, every result
rounded to bf16 once from an f32 sum). An f32 logit summed in another order
can still move one rounding of p, and through it an output element near 0 by
a few of its own ulps (measured: at most 4, 0.06 ulp of the largest element,
in 0.16% of the elements at rate 0; the other cases bit for bit), so out is
required within one bf16 ulp of its largest element with at least 99% of its
elements bit-identical, lse to 1e-6 relative, and dq, dk, dv through
``jax.vjp`` to one bf16 ulp of each tensor's largest element (measured:
identical bits). ``FlashAttention`` in bf16 returns bf16 out and gradients;
``_check`` refuses mixed dtypes. The CUDA kernels are held against
these plain versions on the card by chip_smoke.py (phase 12).

Two pieces of the Hopper kernels are pinned here as well: ``flash_fwd_bf16_model``,
the forward kernel's rounding schedule (an online softmax over 64-key tiles,
p rounded to bf16 against the running maximum), held against the plain
version on chip_smoke.py's small shapes to the card's limits (out within 2
bf16 ulps of its largest element, lse 1e-5 relative); and ``tma_ready``, which
decides whether TMA reads an operand in place or the wrapper copies it.
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_by_s3prl_tpu.ops.pallas import attention_kernel as J
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import attention_kernel as A

BF16 = torch.bfloat16
CASES = [  # B, T, N, D, rate, kbias, batch0
    (2, 40, 2, 16, 0.0, False, 0),
    (2, 40, 2, 16, 0.25, False, 0),
    (2, 37, 2, 16, 0.25, True, 1),
    # the card's widest instance (3 heads of 256), and 192 (4 heads), which
    # it runs zero-padded to 256
    (2, 24, 3, 256, 0.0, True, 0),
    (2, 20, 4, 192, 0.1, True, 1),
]
# lse: the same f32 softmax of the same f32 logits, summed in other orders
LSE_RTOL = 1e-6
# out's bit-identical share: the bf16 roundings are the JAX kernel's, only an
# f32 sum in another order can move one
IDENTICAL_SHARE = 0.99


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, B, T, N, D, bias):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, T, N * D)).astype(np.float32) for _ in range(4))
    kb = (2.0 * rng.standard_normal((B, T))).astype(np.float32) if bias else None
    to_bf16 = lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16))  # noqa: E731
    return [to_bf16(x) for x in (q, k, v, g)], kb


def _torch(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(BF16)


def _ulp_of_max(x):
    """One bf16 ulp at the largest |value| of x."""
    m = float(np.abs(np.asarray(x, np.float32)).max())
    return 2.0 ** (math.floor(math.log2(m)) - 7)


@pytest.fixture(scope="module")
def jax_runs():
    """Each case through the Pallas kernels in interpret mode on bf16 inputs:
    (inputs, kbias, salt, out, lse (B, N, T), (dq, dk, dv) of jax.vjp)."""
    runs = {}
    for B, T, N, D, rate, bias, b0 in CASES:
        (q, k, v, g), kb = _inputs(B * T + N + int(rate * 4), B, T, N, D, bias)
        salt = np.asarray(jax.random.bits(jax.random.PRNGKey(T), (1, 2), jnp.uint32))
        salt_f = jax.lax.bitcast_convert_type(jnp.asarray(salt), jnp.float32)
        b0_a = jnp.full((1, 1), b0, jnp.int32)
        kbias = jnp.zeros((B, T), jnp.float32) if kb is None else jnp.asarray(kb)
        scale = D ** -0.5

        def fn(q3, k3, v3):
            return J._flash_vjp(q3, k3, v3, salt_f, b0_a, kbias, scale, rate, 256, True, N, D)

        args = [jnp.asarray(x) for x in (q, k, v)]
        out, lse = J._fwd_impl(*args, salt_f, b0_a, kbias, scale, rate, 256, True, N, D)
        _, vjp = jax.vjp(fn, *args)
        grads = vjp(jnp.asarray(g))
        runs[(B, T, N, D, rate, bias, b0)] = (
            (q, k, v, g), kb, tuple(int(s) for s in salt[0]), np.asarray(out),
            np.asarray(lse).reshape(B, N, -1)[:, :, :T],
            tuple(np.asarray(x) for x in grads))
    return runs


@pytest.mark.parametrize("case", CASES)
def test_bf16_forward_matches_pallas_kernel_to_an_ulp(jax_runs, case):
    B, T, N, D, rate, bias, b0 = case
    (q, k, v, _), kb, salt, jout, jlse, _ = jax_runs[case]
    kbias = None if kb is None else torch.from_numpy(kb)
    out, lse = A.flash_attention_fwd(_torch(q), _torch(k), _torch(v), D ** -0.5, rate, salt,
                                     kbias, b0, n_heads=N)
    assert out.dtype == BF16 and lse.dtype == torch.float32
    got, jout = out.float().numpy(), jout.astype(np.float32)
    assert float(np.abs(got - jout).max()) <= _ulp_of_max(jout)
    identical = float((got == jout).mean())
    assert identical >= IDENTICAL_SHARE, f"share of identical elements {identical}"
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=LSE_RTOL, atol=0)


@pytest.mark.parametrize("case", CASES)
def test_bf16_backward_matches_pallas_vjp(jax_runs, case):
    """dq, dk, dv of the plain bf16 backward from the forward's own out and
    lse, against ``jax.vjp`` of the JAX custom VJP (its residuals are the
    same bits), each within one bf16 ulp of its largest element."""
    B, T, N, D, rate, bias, b0 = case
    (q, k, v, g), kb, salt, _, _, jgrads = jax_runs[case]
    kbias = None if kb is None else torch.from_numpy(kb)
    tq, tk, tv = _torch(q), _torch(k), _torch(v)
    out, lse = A.flash_attention_ref(tq, tk, tv, D ** -0.5, rate, salt, kbias, b0, n_heads=N)
    grads = A.flash_attention_bwd(tq, tk, tv, out, lse, _torch(g), D ** -0.5, rate, salt,
                                  kbias, b0, n_heads=N)
    for name, got, want in zip(("dq", "dk", "dv"), grads, jgrads):
        assert got.dtype == BF16 and got.shape == (B, T, N * D)
        want = want.astype(np.float32)
        err = float(np.abs(got.float().numpy() - want).max())
        assert err <= _ulp_of_max(want), f"{name}: {err} > one ulp {_ulp_of_max(want)}"


def test_bf16_function_returns_bf16_and_matches_autograd_of_the_plain_version():
    B, T, N, D = 2, 33, 2, 16
    (q, k, v, g), _ = _inputs(5, B, T, N, D, False)
    salt = (11, 22)
    leaves = [_torch(x).requires_grad_() for x in (q, k, v)]
    A.flash_attention_fwd_bf16.launches = A.flash_attention_bwd_bf16.launches = 0
    out = A.flash_attention(*leaves, D ** -0.5, 0.25, salt, n_heads=N)
    grads = torch.autograd.grad(out, leaves, _torch(g))
    assert out.dtype == BF16 and all(x.dtype == BF16 for x in grads)
    assert A.flash_attention_fwd_bf16.launches == A.flash_attention_bwd_bf16.launches == 0
    ref, lse = A.flash_attention_ref(*(x.detach() for x in leaves), D ** -0.5, 0.25, salt,
                                     n_heads=N)
    assert torch.equal(out.detach(), ref)
    want = A.flash_attention_bwd_ref(*(x.detach() for x in leaves), ref, lse, _torch(g),
                                     D ** -0.5, 0.25, salt, n_heads=N)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


@pytest.mark.parametrize("dtypes,match", [
    ((BF16, torch.float32, BF16), "one dtype"),
    ((torch.float32, torch.float32, BF16), "one dtype"),
    ((torch.float16,) * 3, "f32 or bf16"),
])
def test_check_refuses_mixed_and_other_dtypes(dtypes, match):
    q, k, v = (torch.zeros(1, 4, 32, dtype=dt) for dt in dtypes)
    with pytest.raises(ValueError, match=match):
        A.flash_attention_fwd(q, k, v, 0.25, 0.0, (0, 0), n_heads=2)


def test_bf16_wrappers_refuse_f32_and_an_f32_cotangent():
    x = torch.zeros(1, 4, 32)
    with pytest.raises(ValueError, match="bf16"):
        A.flash_attention_fwd_bf16(x, x, x, 0.25, 0.0, (0, 0), n_heads=2)
    b = x.to(BF16)
    out, lse = A.flash_attention_fwd(b, b, b, 0.25, 0.0, (0, 0), n_heads=2)
    with pytest.raises(ValueError, match="dout"):
        A.flash_attention_bwd(b, b, b, out, lse, x, 0.25, 0.0, (0, 0), n_heads=2)
    with pytest.raises(ValueError, match="kbias"):
        A.flash_attention_fwd(b, b, b, 0.25, 0.0, (0, 0), torch.zeros(1, 4, dtype=BF16),
                              n_heads=2)


# chip_smoke.py's B3_BF16_CASES below T = 1001, and one at rate 0: B, T, N, D,
# rate, kbias
MODEL_CASES = [
    (3, 130, 12, 64, 0.1, True),
    (2, 37, 12, 64, 0.1, True),
    (2, 70, 4, 32, 0.2, True),
    (2, 70, 2, 128, 0.2, False),
    (2, 130, 2, 64, 0.0, False),
    (2, 130, 3, 256, 0.1, True),
]
# chip_smoke.py's limits on the kernel against the plain version
MODEL_OUT_ULPS, MODEL_LSE_RTOL = 2.0, 1e-5


@pytest.mark.parametrize("case", MODEL_CASES)
def test_online_softmax_model_meets_the_cards_limits(case):
    """The forward kernel's rounding schedule differs from the plain
    version's only where p is rounded against a running maximum: within 2
    bf16 ulps of out's largest element and 1e-5 of lse."""
    B, T, N, D, rate, bias = case
    (q, k, v, _), kb = _inputs(T + D, B, T, N, D, bias)
    kbias = None if kb is None else torch.from_numpy(kb)
    args = (D ** -0.5, rate, (0x9E3779B9, 0xDEADBEEF), kbias, 3)
    tq, tk, tv = _torch(q), _torch(k), _torch(v)
    out, lse = A.flash_fwd_bf16_model(tq, tk, tv, *args, n_heads=N, keys=A.fwd_bf16_keys(D))
    ref, ref_lse = A.flash_attention_ref(tq, tk, tv, *args, n_heads=N)
    assert out.dtype == BF16 and out.shape == ref.shape and lse.shape == ref_lse.shape
    err = float((out.float() - ref.float()).abs().max())
    assert err <= MODEL_OUT_ULPS * _ulp_of_max(ref.float().numpy())
    rel = float(((lse - ref_lse).abs() / ref_lse.abs().clamp_min(1e-30)).max())
    assert rel <= MODEL_LSE_RTOL


def test_online_softmax_model_is_the_plain_version_within_one_tile():
    """At T <= 64 the running maximum is the final one: the same bits."""
    B, T, N, D = 2, 64, 2, 32
    (q, k, v, _), _ = _inputs(3, B, T, N, D, False)
    args = (D ** -0.5, 0.2, (5, 6))
    out, lse = A.flash_fwd_bf16_model(_torch(q), _torch(k), _torch(v), *args, n_heads=N)
    ref, ref_lse = A.flash_attention_ref(_torch(q), _torch(k), _torch(v), *args, n_heads=N)
    assert torch.equal(out, ref)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-6, atol=0)


def _fused_thirds(B, T, H, extra=0, offset=0):
    """q, k, v as the thirds of one fused bf16 projection (B, T, 3 H +
    extra), each starting ``offset`` columns into its third."""
    qkv = torch.zeros(B, T, 3 * H + extra, dtype=BF16)[..., offset:offset + 3 * H]
    return qkv.split(H, dim=-1)


def _ready(x):
    return A.tma_ready(x.data_ptr(), x.stride(), x.element_size())


def test_tma_ready_takes_aligned_views_of_a_fused_projection():
    for H in (768, 64, 128):
        q, k, v = _fused_thirds(2, 37, H)
        assert all(_ready(x) for x in (q, k, v))
    assert _ready(torch.zeros(3, 5, 96, dtype=BF16))


def test_tma_ready_refuses_unaligned_views_and_odd_row_strides():
    # a projection one column wider with its first column dropped: every row
    # starts 2 bytes off a 16-byte boundary
    q, k, v = _fused_thirds(2, 37, 768, extra=1, offset=1)
    assert not any(_ready(x) for x in (q, k, v))
    # row strides of 3 H + 4 bf16 (8 bytes) and 3 H + 1: the base of q is
    # aligned, the time stride is not a multiple of 16 bytes
    for extra in (4, 1):
        q, _, _ = _fused_thirds(2, 37, 768, extra=extra)
        assert q.data_ptr() % 16 == 0 and not _ready(q)
    # a batch stride off 16 bytes with aligned rows, a column stride of 2
    x = torch.zeros(3 * 40 * 64 + 8, dtype=BF16)[:3 * 40 * 64].view(3, 40, 64)
    assert _ready(x)
    y = torch.zeros(3, 41, 64, dtype=BF16)[:, :40]
    assert _ready(y)
    z = torch.zeros(3, 40 * 64 + 4, dtype=BF16)[:, :40 * 64].view(3, 40, 64)
    assert not _ready(z)
    assert not _ready(torch.zeros(3, 40, 128, dtype=BF16)[..., ::2])
    # the pure function of address, strides and item size
    assert A.tma_ready(1024, (3 * 40 * 64, 64, 1), 2)
    assert not A.tma_ready(1026, (3 * 40 * 64, 64, 1), 2)
    assert not A.tma_ready(1024, (3 * 40 * 64, 60, 1), 2)
    assert not A.tma_ready(1024, (40 * 64 + 4, 64, 1), 2)


def test_bf16_layout_copies_only_what_tma_cannot_read():
    q, k, _ = _fused_thirds(2, 37, 64)
    _, _, v = _fused_thirds(2, 37, 64, extra=1, offset=1)
    B, T, N, D, ops, strides, kb = A._bf16_layout(q, k, v, None, 2)
    assert (B, T, N, D) == (2, 37, 2, 32)
    assert ops[0] is q and ops[1] is k and ops[2] is not v
    assert ops[2].is_contiguous() and torch.equal(ops[2], v) and _ready(ops[2])
    assert strides == [37 * 192, 192, 37 * 192, 192, 37 * 64, 64]
    assert kb is None  # no bias goes to the kernels as a null pointer
    bias = torch.zeros(37, 2).t()
    assert A._bf16_layout(q, k, v, bias, 2)[-1].is_contiguous()


def test_bf16_scalar_rounds_as_torch_does():
    """The kernels' scale: f32, then bf16 to nearest with ties to even, on
    the bits (ties included) as torch's conversion rounds it."""
    ties = [float(torch.tensor([(i << 16) | 0x8000], dtype=torch.int32).view(torch.float32))
            for i in range(0x3E00, 0x3E40)]
    for x in [0.125, 64 ** -0.5, 32 ** -0.5, 128 ** -0.5, 1 / 3, 0.1, 1e-3, 7.77] + ties:
        assert A._bf16_scalar(x) == float(torch.tensor(x, dtype=torch.float32).to(BF16))
