"""The FFT route of the port's fused decode (kernel B5) on the CPU.

The CUDA kernel ``csrc/decode_fft.cu`` cannot run here. Its algorithm is kept
in Python beside the wrapper: ``decode_fft_tables`` (window / M, twiddles and
unpack factors, built in float64) and ``decode_fft_model`` (the kernel's
steps on those tables: rescale, pack, the shared Stockham passes on swapped
parts, window and an output-stationary overlap-add). The model is held here
against the plain version ``decode_ola_ref``, against the JAX package's
``istft`` and against its Pallas kernel ``decode_ola_pallas`` in interpret
mode (as tests/test_pallas_dsp.py runs it). The route predicate, which alone
decides between the FFT kernel and the matrix-product kernel on a CUDA
tensor, is pinned, and so is the cached envelope divisor of ``istft``. The
kernel itself is held against the plain version on the card by
chip_smoke.py.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from speech_enhancement_by_s3prl_tpu.ops import stft as j_stft
from speech_enhancement_by_s3prl_tpu.ops.pallas.decode_kernel import decode_ola_pallas
from speech_enhancement_by_s3prl_tpu_torch.ops import stft as t_stft
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import decode_kernel as D
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import stft_kernel as K

# Relative to the largest |value|. Model and plain version compute the same
# sums in f32: the plain version as up to 402 products a sample in the
# matmul's order, the FFT as ~9 butterfly stages of rounded twiddle products;
# both sit near 5e-7, so 1e-5 (chip_smoke.py's limit for the kernel) leaves a
# decade.
F32_REL = 1e-5
# decode_ola_pallas rounds both matmul operands to bf16;
# tests/test_pallas_dsp.py allows 5e-3 * max(scale, 1) against the f32 path
BF16_ATOL = 5e-3

# (n_fft, win_length, hop): the flagship, a padded window, a power of two, a
# factor 3, and a hop that is odd (K = 4)
GEOMETRIES = [(400, 400, 160), (256, 200, 80), (512, 400, 160), (480, 480, 160),
              (240, 200, 75)]


def _rel(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def _inputs(batch, t, n_freq, seed):
    """pred >= 0 and a carrier of normal noise (not normalised), f32."""
    rng = np.random.default_rng(seed)
    pred = (rng.standard_normal((batch, t, n_freq)) ** 2).astype(np.float32)
    uph = rng.standard_normal((batch, t, 2 * n_freq)).astype(np.float32)
    return torch.from_numpy(pred), torch.from_numpy(uph)


@pytest.mark.parametrize("n_fft,want", [
    (400, "fft"), (256, "fft"), (512, "fft"), (480, "fft"), (240, "fft"),
    (254, "product"),  # 2 * 127
    (401, "product"),  # odd
])
def test_route_follows_the_fft_plan(n_fft, want):
    assert D.decode_route(n_fft) == want
    assert (K.fft_plan(n_fft) is not None) == (want == "fft")
    assert K.stft_route(n_fft) == want  # B4 and B5 take the FFT at the same n_fft


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_tables_are_the_float64_values(geom):
    n_fft, win, _ = geom
    m = n_fft // 2
    tab = D.decode_fft_tables(n_fft, win)
    assert tab.dtype == np.float32 and tab.shape == (3 * n_fft + 2,)
    window, twr, twi, spr, spi = np.split(tab, np.cumsum([n_fft, m, m, m + 1]))
    want = t_stft._padded_window(win, n_fft).astype(np.float64) / m
    np.testing.assert_allclose(window, want, rtol=1e-7, atol=0)
    np.testing.assert_allclose(twr + 1j * twi, np.exp(-2j * np.pi * np.arange(m) / m),
                               atol=6e-8)
    np.testing.assert_allclose(spr + 1j * spi,
                               np.exp(2j * np.pi * np.arange(m + 1) / n_fft), atol=6e-8)
    assert (spr[0], spi[0], spr[m], spi[m]) == (1.0, 0.0, -1.0, 0.0)
    # the forward passes' twiddles are the fused STFT's own
    assert np.array_equal(tab[n_fft:2 * n_fft], K.fft_tables(n_fft, win)[n_fft:2 * n_fft])


# every geometry at T' = 1, 2 and 78 (one block, frames outside [0, T') on
# both sides, several blocks), and powers 1 and 3 at the flagship's and the
# odd hop's
@pytest.mark.parametrize("geom,t,power", [
    *((geom, t, 2.0) for geom in GEOMETRIES for t in (1, 2, 78)),
    *((geom, 78, power) for geom in (GEOMETRIES[0], GEOMETRIES[4]) for power in (1.0, 3.0)),
])
def test_model_matches_plain_version(geom, t, power):
    n_fft, _, hop = geom
    pred, uph = _inputs(2, t, n_fft // 2 + 1, n_fft + t)
    model = D.decode_fft_model(pred, uph, *geom, linear_power=power)
    ref = D.decode_ola_ref(pred, uph, *geom, linear_power=power)
    assert model.shape == (2, (t + -(-n_fft // hop) - 1) * hop)
    assert _rel(model, ref) < F32_REL
    # nothing past the last frame's last sample
    assert not model[:, n_fft + (t - 1) * hop:].any()


def test_zero_carrier_is_the_unit_vector():
    """|z| = 0 keeps the arctan2(0, 0) = 0 convention: the carrier (1, 0)."""
    pred, _ = _inputs(2, 9, 201, 3)
    zero = torch.zeros(2, 9, 402)
    unit = torch.cat([torch.ones(2, 9, 201), torch.zeros(2, 9, 201)], dim=-1)
    model = D.decode_fft_model(pred, zero, 400, 400, 160)
    assert float(model.abs().max()) > 1e-3
    assert torch.equal(model, D.decode_fft_model(pred, unit, 400, 400, 160))
    assert _rel(model, D.decode_ola_ref(pred, zero, 400, 400, 160)) < F32_REL


@pytest.mark.parametrize("geom", [(400, 400, 160), (240, 200, 75)])
def test_imaginary_parts_at_dc_and_nyquist_are_not_read(geom):
    """The carrier is normalised, so a bin whose carrier is almost purely
    imaginary rescales to about (0, mag). The inverse real DFT reads no
    imaginary part at bins 0 and n_fft / 2; the packing would fold one into
    Z[0] unless the model (and the kernel) zero it first."""
    n_fft, _, _ = geom
    f = n_fft // 2 + 1
    pred, uph = _inputs(2, 7, f, 11)
    pred[..., 0], pred[..., f - 1] = 4.0, 9.0
    uph[..., 0], uph[..., f - 1] = 1e-3, -1e-3
    uph[..., f], uph[..., 2 * f - 1] = 5.0, -7.0
    ref = D.decode_ola_ref(pred, uph, *geom)
    assert _rel(D.decode_fft_model(pred, uph, *geom), ref) < F32_REL
    # left in, Im X[0] = a and Im X[M] = b would move Z[0] by
    # (-(a + b) + i (a - b)) / 2, every odd sample of a frame by (a - b) / 2M
    # (times the window): far above the limit, so the case is not vacuous
    _, xi = t_stft._rescale_carrier(pred.sqrt(), uph, f)
    leak = float((xi[..., 0] - xi[..., f - 1]).abs().max()) / (n_fft - 2)
    assert leak > 100 * F32_REL * float(ref.abs().max())


def test_model_matches_jax_and_pallas():
    """The flagship geometry on a carrier from the JAX STFT, as the enhance
    path hands it over: the raw overlap-add against the Pallas kernel in
    interpret mode, and the trimmed, envelope-divided waveform against the
    JAX ``istft``, for the model and for ``istft(..., fused=True)``."""
    rng = np.random.default_rng(5)
    x = (0.1 * rng.standard_normal((2, 4000))).astype(np.float32)
    uph = np.array(j_stft.stft(jnp.asarray(x), j_stft.StftParams()))
    pred = (rng.standard_normal((2, uph.shape[1], 201)) ** 2).astype(np.float32)
    n_frames = pred.shape[1]
    raw = D.decode_fft_model(torch.from_numpy(pred), torch.from_numpy(uph), 400, 400, 160)
    kernel = np.asarray(decode_ola_pallas(jnp.asarray(pred), jnp.asarray(uph), 400, 400, 160,
                                          interpret=True))
    scale = float(np.abs(kernel).max())
    np.testing.assert_allclose(raw.numpy(), kernel[:, :raw.shape[1]],
                               atol=BF16_ATOL * max(scale, 1.0))
    ref = np.asarray(j_stft.istft(jnp.asarray(pred), jnp.asarray(uph), j_stft.StftParams()))
    length = (n_frames - 1) * 160
    wav = raw[:, 200:200 + length] / t_stft._ola_divisor(400, 400, 160, n_frames,
                                                           torch.device("cpu"))
    assert _rel(wav, ref) < F32_REL
    port = t_stft.istft(torch.from_numpy(pred), torch.from_numpy(uph), t_stft.StftParams(),
                        fused=True)
    assert _rel(port, ref) < F32_REL


def test_row_bits_do_not_depend_on_the_batch():
    pred, uph = _inputs(3, 40, 201, 7)
    batch = D.decode_fft_model(pred, uph, 400, 400, 160)
    for row in range(3):
        alone = D.decode_fft_model(pred[row:row + 1], uph[row:row + 1], 400, 400, 160)
        assert torch.equal(alone[0], batch[row])


def test_model_refuses_what_the_kernel_does_not_take():
    pred, uph = _inputs(1, 3, 128, 0)
    with pytest.raises(ValueError, match="n_fft = 254"):
        D.decode_fft_model(pred, uph, 254, 150, 75)


def test_wrapper_on_cpu_launches_nothing_on_either_route():
    before = (D.decode_ola.launches, dict(D.decode_ola.by_route))
    for geom in ((400, 400, 160), (254, 150, 75)):
        pred, uph = _inputs(2, 12, geom[0] // 2 + 1, 1)
        assert torch.equal(D.decode_ola(pred, uph, *geom), D.decode_ola_ref(pred, uph, *geom))
    assert (D.decode_ola.launches, D.decode_ola.by_route) == before


def test_istft_envelope_divisor_is_cached_and_keeps_the_bits():
    sp = t_stft.StftParams()
    pred, uph = _inputs(2, 31, 201, 9)
    cpu = torch.device("cpu")
    divisor = t_stft._ola_divisor(400, 400, 160, 31, cpu)
    assert t_stft._ola_divisor(400, 400, 160, 31, cpu) is divisor
    assert not divisor.is_inference()
    env = torch.from_numpy(t_stft._ola_envelope_np(400, 400, 160, 31)[200:200 + 30 * 160])
    assert torch.equal(divisor, torch.where(env > 1e-11, env, torch.ones_like(env)))
    # istft divides by it: the same bits as the fresh envelope gave, call after call
    raw = D.decode_ola_ref(pred, uph, 400, 400, 160)[:, 200:200 + 30 * 160]
    fresh = raw / torch.where(env > 1e-11, env, torch.ones_like(env))
    for _ in range(2):
        assert torch.equal(t_stft.istft(pred, uph, sp, fused=True), fresh)
    with torch.inference_mode():
        assert torch.equal(t_stft.istft(pred, uph, sp, fused=True), fresh)
