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
