"""The port's fused STFT (B4) and fused decode (B5) against the JAX package.

On the CPU the wrappers ``stft_fused`` / ``decode_ola`` run their plain
versions, which are held here against the JAX ``stft`` / ``istft`` at f32
rounding and against the Pallas kernels ``stft_pallas`` / ``decode_ola_pallas``
in interpret mode (as tests/test_pallas_dsp.py runs them) at the JAX package's
own tolerance: its kernels round both matmul operands to bf16, the port
computes in f32. The CUDA kernels themselves are checked on the card by
chip_smoke.py.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from speech_enhancement_by_s3prl_tpu.ops import stft as j_stft
from speech_enhancement_by_s3prl_tpu.ops.pallas.decode_kernel import decode_ola_pallas
from speech_enhancement_by_s3prl_tpu.ops.pallas.stft_kernel import stft_pallas
from speech_enhancement_by_s3prl_tpu_torch.ops import features as t_feat
from speech_enhancement_by_s3prl_tpu_torch.ops import stft as t_stft
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda.decode_kernel import (
    decode_ola,
    decode_ola_ref,
)
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda.stft_kernel import (
    stft_fused,
    stft_fused_ref,
)

SP = t_stft.StftParams()
J_SP = j_stft.StftParams()
F = SP.n_freq
GEOM = (SP.n_fft, SP.win_length, SP.hop_length)
# both sides f32, the same 400 (402) products a value summed in other orders
F32_REL = 1e-5
# the Pallas kernels cast both matmul operands to bf16 (8 mantissa bits);
# tests/test_pallas_dsp.py allows 5e-3 * max(scale, 1) against the f32 path
BF16_ATOL = 5e-3


def _rel(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def _wavs(shape, seed, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# the shapes of tests/test_pallas_dsp.py, the lead-dims case included
@pytest.mark.parametrize("shape", [(1, 16000), (2, 12345), (5, 33000), (2, 3, 8000)])
def test_stft_fused_ref_matches_jax_and_pallas(shape):
    x = _wavs(shape, shape[-1])
    port = stft_fused_ref(torch.from_numpy(x), *GEOM)
    ref = j_stft.stft(jnp.asarray(x), J_SP, method="matmul")
    assert port.shape == shape[:-1] + (1 + shape[-1] // 160, 2 * F)
    assert _rel(port, ref) < F32_REL
    kernel = np.asarray(stft_pallas(jnp.asarray(x), *GEOM, interpret=True))
    scale = float(np.abs(kernel).max())
    np.testing.assert_allclose(port.numpy(), kernel, atol=BF16_ATOL * max(scale, 1.0))


def _decode_inputs(batch, t, seed):
    rng = np.random.default_rng(seed)
    x = _wavs((batch, t), seed, 0.1)
    uph = np.array(j_stft.stft(jnp.asarray(x), J_SP))
    pred = (rng.standard_normal((batch, uph.shape[1], F)) ** 2).astype(np.float32)
    return pred, uph


@pytest.mark.parametrize("batch,t", [(1, 16000), (3, 12345), (4, 40000)])
def test_decode_ola_ref_matches_pallas_and_jax_istft(batch, t):
    pred, uph = _decode_inputs(batch, t, batch)
    n_frames = pred.shape[1]
    raw = decode_ola_ref(torch.from_numpy(pred), torch.from_numpy(uph), *GEOM)
    assert raw.shape == (batch, (n_frames + 2) * 160)
    # the raw overlap-add is zero past the last frame's last sample
    assert not raw[:, 400 + (n_frames - 1) * 160:].any()
    kernel = np.asarray(decode_ola_pallas(jnp.asarray(pred), jnp.asarray(uph), *GEOM,
                                          interpret=True))
    n = raw.shape[1]
    scale = float(np.abs(kernel).max())
    np.testing.assert_allclose(raw.numpy(), kernel[:, :n], atol=BF16_ATOL * max(scale, 1.0))
    assert not kernel[:, n:].any()
    port = t_stft.istft(torch.from_numpy(pred), torch.from_numpy(uph), SP, fused=True)
    ref = j_stft.istft(jnp.asarray(pred), jnp.asarray(uph), J_SP)
    assert _rel(port, ref) < F32_REL


def test_decode_zero_carrier_is_the_unit_vector():
    # |z| = 0 bins keep the arctan2(0, 0) = 0 convention: the carrier (1, 0)
    n_frames = 31
    pred = (np.random.default_rng(3).random((1, n_frames, F)) ** 2).astype(np.float32)
    uph = np.zeros((1, n_frames, 2 * F), np.float32)
    port = t_stft.istft(torch.from_numpy(pred), torch.from_numpy(uph), SP, fused=True)
    # the radian form with phase 0 everywhere is the same signal
    ref = j_stft.istft(jnp.asarray(pred), jnp.zeros((1, n_frames, F), jnp.float32), J_SP)
    assert float(np.abs(np.asarray(ref)).max()) > 1e-3
    assert _rel(port, ref) < F32_REL
    assert _rel(port, j_stft.istft(jnp.asarray(pred), jnp.asarray(uph), J_SP)) < F32_REL
    kernel = np.asarray(decode_ola_pallas(jnp.asarray(pred), jnp.asarray(uph), *GEOM,
                                          interpret=True))
    raw = decode_ola_ref(torch.from_numpy(pred), torch.from_numpy(uph), *GEOM).numpy()
    np.testing.assert_allclose(raw, kernel[:, : raw.shape[1]], atol=BF16_ATOL)


@pytest.mark.parametrize("power", [1.0, 2.0, 3.0])
def test_decode_linear_power_matches_jax(power):
    pred, uph = _decode_inputs(2, 4000, 5)
    port = t_stft.istft(torch.from_numpy(pred), torch.from_numpy(uph), SP,
                        linear_power=power, fused=True)
    ref = j_stft.istft(jnp.asarray(pred), jnp.asarray(uph), J_SP, linear_power=power)
    assert _rel(port, ref) < F32_REL


@pytest.mark.parametrize("shape", [(3, 4801), (2, 2, 3000)])
def test_fused_and_torch_op_bodies_agree(shape):
    x = torch.from_numpy(_wavs(shape, 9))
    spec = t_stft.stft(x, SP, fused=True)
    assert _rel(spec, t_stft.stft(x, SP, fused=False)) < F32_REL
    assert torch.equal(spec, t_stft.stft(x, SP))  # no gradient needed: the kernel branch
    rng = np.random.default_rng(10)
    pred = torch.from_numpy((rng.random(spec.shape[:-1] + (F,)) ** 2).astype(np.float32))
    wav = t_stft.istft(pred, spec, SP, fused=True)
    assert wav.shape == shape[:-1] + ((spec.shape[-2] - 1) * 160,)
    assert _rel(wav, t_stft.istft(pred, spec, SP, fused=False)) < F32_REL
    assert torch.equal(wav, t_stft.istft(pred, spec, SP))
    # the radian form has no kernel: fused is ignored there
    phase = torch.atan2(spec[..., F:], spec[..., :F])
    assert torch.equal(t_stft.istft(pred, phase, SP, fused=True),
                       t_stft.istft(pred, phase, SP, fused=False))


def test_gradient_takes_the_torch_op_body():
    """``fused=None`` with an input that requires a gradient runs the
    differentiable body (the kernels are forward-only), and the gradient is
    the one autograd gives through ``fused=False``."""
    x = torch.from_numpy(_wavs((2, 3000), 11))
    pred = torch.from_numpy((np.random.default_rng(12).random((2, 19, F)) ** 2
                             ).astype(np.float32))
    uph = t_stft.stft(x, SP)
    cot = torch.from_numpy(_wavs((2, 18 * 160), 13))
    grads = []
    for fused in (None, False):
        p, u = pred.clone().requires_grad_(), uph.clone().requires_grad_()
        out = t_stft.istft(p, u, SP, fused=fused)
        assert out.requires_grad
        grads.append(torch.autograd.grad((out * cot).sum(), (p, u)))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    xs = []
    for fused in (None, False):
        xg = x.clone().requires_grad_()
        spec = t_stft.stft(xg, SP, fused=fused)
        xs.append(torch.autograd.grad(spec.square().sum(), xg)[0])
    assert torch.equal(*xs)
    # asking for the kernel where a gradient is needed raises: no backward kernel
    with pytest.raises(RuntimeError, match="forward-only"):
        t_stft.stft(x.clone().requires_grad_(), SP, fused=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        t_stft.istft(pred.clone().requires_grad_(), uph, SP, fused=True)
    # with grad mode off the kernel branch runs although the input requires one
    with torch.no_grad():
        out = t_stft.istft(pred.clone().requires_grad_(), uph, SP)
    assert not out.requires_grad


def test_wrappers_on_cpu_run_plain_versions_and_launch_nothing():
    x = torch.from_numpy(_wavs((2, 3, 2400), 14))
    before = (stft_fused.launches, decode_ola.launches)
    spec = stft_fused(x, *GEOM)
    assert torch.equal(spec, stft_fused_ref(x, *GEOM))
    pred = spec[..., :F].square().reshape(6, -1, F)
    uph = spec.reshape(6, -1, 2 * F)
    raw = decode_ola(pred, uph, *GEOM)
    assert torch.equal(raw, decode_ola_ref(pred, uph, *GEOM))
    assert (stft_fused.launches, decode_ola.launches) == before == (0, 0)
    # the preprocessor and its istft inherit the default: same values as before
    pre = t_feat.OnlinePreprocessor(feat_list=[t_feat.get_feat_config("uphase", 1)])
    assert torch.equal(pre(x)[0], spec[:, 1])


@pytest.mark.parametrize("case", ["dtype", "short", "pred_rank", "uph_width", "bins", "power"])
def test_wrappers_reject_bad_inputs(case):
    pred, uph = torch.zeros(1, 5, F), torch.zeros(1, 5, 2 * F)
    with pytest.raises(ValueError):
        if case == "dtype":
            stft_fused(torch.zeros(1, 1000, dtype=torch.float64), *GEOM)
        elif case == "short":
            stft_fused(torch.zeros(1, 200), *GEOM)  # needs > n_fft // 2 samples
        elif case == "pred_rank":
            decode_ola(pred[0], uph, *GEOM)
        elif case == "uph_width":
            decode_ola(pred, uph[..., :F], *GEOM)
        elif case == "bins":
            decode_ola(pred[..., :100], uph[..., :200], *GEOM)
        else:
            decode_ola(pred, uph, *GEOM, linear_power=0.0)
