"""The FFT route of the port's fused STFT (kernel B4) on the CPU.

The CUDA kernel ``csrc/stft_fft.cu`` cannot run here. Its algorithm is kept
in Python beside the wrapper: ``fft_plan`` (the radix list), ``fft_tables``
(window, twiddles and split factors, built in float64) and ``stft_fft_model``
(the kernel's passes on those tables, index for index). The model is held
here against the plain version ``stft_fused_ref``, against the JAX package's
``stft`` and against its Pallas kernel ``stft_pallas`` in interpret mode (as
tests/test_pallas_dsp.py runs it). The route predicate, which alone decides
between the FFT kernel and the matrix-product kernel on a CUDA tensor, is
pinned. The kernel itself is held against the plain version on the card by
chip_smoke.py.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from speech_enhancement_by_s3prl_tpu.ops import stft as j_stft
from speech_enhancement_by_s3prl_tpu.ops.pallas.stft_kernel import stft_pallas
from speech_enhancement_by_s3prl_tpu_torch.ops import stft as t_stft
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import stft_kernel as K

# Relative to the largest |value|. Model and plain version compute the same
# sums in f32: the plain version as 400 products a value in the matmul's
# order, the FFT as ~9 butterfly stages of rounded twiddle products; both sit
# near 5e-7, so 1e-5 (chip_smoke.py's limit for the kernel) leaves a decade.
F32_REL = 1e-5
# stft_pallas rounds both matmul operands to bf16; tests/test_pallas_dsp.py
# allows 5e-3 * max(scale, 1) against the f32 path
BF16_ATOL = 5e-3

# (n_fft, win_length, hop): the flagship, a padded window, a power of two, a
# factor 3, and a hop that is odd
GEOMETRIES = [(400, 400, 160), (256, 200, 80), (512, 400, 160), (480, 480, 160),
              (240, 200, 75)]


def _rel(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def _wavs(shape, seed, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("n_fft,want", [
    (400, (5, 5, 4, 2)), (256, (4, 4, 4, 2)), (512, (4, 4, 4, 4)), (480, (5, 3, 4, 4)),
    (240, (5, 3, 4, 2)), (4, (2,)), (2048, (4, 4, 4, 4, 4)),
    (254, None),    # 2 * 127
    (401, None),    # odd
    (2, None), (4096, None), (28, None),  # too short, too long, a factor 7
])
def test_plan_and_route(n_fft, want):
    assert K.fft_plan(n_fft) == want
    assert K.stft_route(n_fft) == ("product" if want is None else "fft")
    if want is not None:
        assert int(np.prod(want)) == n_fft // 2
        # odd radices first, at most one 2 and only at the end
        assert list(want) == sorted(want, key=(5, 3, 4, 2).index)
        assert want.count(2) <= 1


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_tables_are_the_float64_values(geom):
    n_fft, win, _ = geom
    m = n_fft // 2
    tab = K.fft_tables(n_fft, win)
    assert tab.dtype == np.float32 and tab.shape == (3 * n_fft + 2,)
    window, twr, twi, spr, spi = np.split(tab, np.cumsum([n_fft, m, m, m + 1]))
    assert np.array_equal(window, t_stft._padded_window(win, n_fft))
    tw = np.exp(-2j * np.pi * np.arange(m) / m)
    sp = np.exp(-2j * np.pi * np.arange(m + 1) / n_fft)
    np.testing.assert_allclose(twr + 1j * twi, tw, atol=6e-8)
    np.testing.assert_allclose(spr + 1j * spi, sp, atol=6e-8)
    assert (spr[0], spi[0], spr[m], spi[m]) == (1.0, 0.0, -1.0, 0.0)


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("shape", [(2, 12345), (2, 3, 3000)])
def test_model_matches_plain_version(geom, shape):
    n_fft, win, hop = geom
    x = torch.from_numpy(_wavs(shape, n_fft + shape[-1]))
    model = K.stft_fft_model(x, *geom)
    ref = K.stft_fused_ref(x, *geom)
    assert model.shape == shape[:-1] + (1 + shape[-1] // hop, n_fft + 2)
    assert _rel(model, ref) < F32_REL
    # bins 0 and n_fft / 2 of a real frame are real
    n_freq = n_fft // 2 + 1
    assert not model[..., n_freq].any() and not model[..., 2 * n_freq - 1].any()


@pytest.mark.parametrize("shape", [(1, 16000), (3, 5000), (1, 201), (2, 3, 8000)])
def test_model_matches_jax_and_pallas(shape):
    """The flagship geometry, rows shorter than one block's span and one
    just past the reflection's minimum, lead axes."""
    geom = (400, 400, 160)
    x = _wavs(shape, shape[-1])
    model = K.stft_fft_model(torch.from_numpy(x), *geom)
    ref = j_stft.stft(jnp.asarray(x), j_stft.StftParams(), method="matmul")
    assert _rel(model, ref) < F32_REL
    kernel = np.asarray(stft_pallas(jnp.asarray(x), *geom, interpret=True))
    scale = float(np.abs(kernel).max())
    np.testing.assert_allclose(model.numpy(), kernel, atol=BF16_ATOL * max(scale, 1.0))


def test_model_is_exact_on_a_pure_tone():
    """A cosine on bin 25 of an unwindowed-in-effect frame: sign and packing
    of [re | im] (im = -sum x sin) against numpy's rfft."""
    n_fft, hop = 400, 160
    n = np.arange(4000)
    x = np.cos(2 * np.pi * 25 * n / n_fft + 0.3).astype(np.float32)
    model = K.stft_fft_model(torch.from_numpy(x[None]), n_fft, n_fft, hop)[0].numpy()
    # frame 5 starts at sample 5 * hop - n_fft / 2 = 600: no reflection in it
    frame = x[600:1000].astype(np.float64) * t_stft.hann_window(n_fft, np.float64)
    want = np.fft.rfft(frame)
    np.testing.assert_allclose(model[5, :201], want.real, atol=2e-4)
    np.testing.assert_allclose(model[5, 201:], want.imag, atol=2e-4)
    assert abs(model[5, 201 + 25]) > 10  # the tone's imaginary part is not lost


def test_model_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="n_fft = 254"):
        K.stft_fft_model(torch.zeros(1, 1000), 254, 150, 75)


def test_wrapper_on_cpu_takes_the_plain_version_on_both_routes():
    x = torch.from_numpy(_wavs((2, 2400), 3))
    before = (K.stft_fused.launches, dict(K.stft_fused.by_route))
    for geom in ((400, 400, 160), (254, 150, 75)):
        assert torch.equal(K.stft_fused(x, *geom), K.stft_fused_ref(x, *geom))
    assert (K.stft_fused.launches, K.stft_fused.by_route) == before
