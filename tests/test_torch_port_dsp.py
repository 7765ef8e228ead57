"""The port's DSP front and back end against the JAX package: STFT, iSTFT
(radian and packed 'uphase' phase), the flagship six-feature preprocessor,
and the level renorm. Inputs are made with numpy from a seed and fed to
both sides; the host-built constants must be bit-identical."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from speech_enhancement_by_s3prl_tpu.ops import audio as j_audio
from speech_enhancement_by_s3prl_tpu.ops import features as j_feat
from speech_enhancement_by_s3prl_tpu.ops import mel as j_mel
from speech_enhancement_by_s3prl_tpu.ops import stft as j_stft
from speech_enhancement_by_s3prl_tpu_torch.ops import audio as t_audio
from speech_enhancement_by_s3prl_tpu_torch.ops import features as t_feat
from speech_enhancement_by_s3prl_tpu_torch.ops import mel as t_mel
from speech_enhancement_by_s3prl_tpu_torch.ops import stft as t_stft

PARAMS = t_stft.StftParams()
J_PARAMS = j_stft.StftParams()


def _wavs(shape, seed):
    # > n_fft // 2 = 200 samples: the reflect padding needs them
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(port, ref, rel):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err < rel, f"max |diff| / max |ref| = {err:.3e} >= {rel:.0e}"


@pytest.mark.parametrize("name,args", [
    ("mel_filterbank", (201, 40, 16000)),
    ("dct_matrix", (40, 13)),
])
def test_host_constants_identical(name, args):
    np.testing.assert_array_equal(
        getattr(t_mel, name)(*args), getattr(j_mel, name)(*args)
    )


def test_dft_kernels_and_envelope_identical():
    for a, b in zip(t_stft._dft_kernels(400, 400), j_stft._dft_kernels(400, 400)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        t_stft._ola_envelope_np(400, 400, 160, 37),
        j_stft._ola_envelope_np(400, 400, 160, 37),
    )


# f32 throughout: JAX convolves with the window-folded DFT matrix, the port
# multiplies frames by it; both sum the same 400 products per bin in other
# orders, so agreement is at f32 rounding (~1e-6 of the peak), not bitwise.
@pytest.mark.parametrize("shape", [(2, 3, 6400), (1, 4801)])
def test_stft_matches_jax(shape):
    x = _wavs(shape, 0)
    port = t_stft.stft(torch.from_numpy(x), PARAMS)
    ref = j_stft.stft(jnp.asarray(x), J_PARAMS)
    _close(port, ref, 1e-5)


@pytest.mark.parametrize("phase_kind", ["radian", "uphase"])
def test_istft_matches_jax(phase_kind):
    rng = np.random.default_rng(1)
    B, T, F = 2, 41, PARAMS.n_freq
    linear = (rng.random((B, T, F)) ** 2).astype(np.float32)
    if phase_kind == "radian":
        phase = rng.uniform(-np.pi, np.pi, (B, T, F)).astype(np.float32)
    else:
        phase = rng.standard_normal((B, T, 2 * F)).astype(np.float32)
        # the |z| = 0 corner: the carrier is the unit vector (1, 0)
        phase[:, 3, :] = 0.0
        phase[:, 5, [7, F + 7]] = 0.0
    port = t_stft.istft(torch.from_numpy(linear), torch.from_numpy(phase), PARAMS)
    ref = j_stft.istft(jnp.asarray(linear), jnp.asarray(phase), J_PARAMS)
    assert port.shape == (B, (T - 1) * PARAMS.hop_length)
    _close(port, ref, 1e-5)


def _flagship_feat_list(get_feat_config):
    return [
        get_feat_config("mel", 0, log=True, delta=1, cmvn=True),
        get_feat_config("mel", 0, log=True, delta=2, cmvn=False),
        get_feat_config("linear", 0),
        get_feat_config("uphase", 0),
        get_feat_config("linear", 1),
        get_feat_config("uphase", 1),
    ]


def test_preprocessor_flagship_matches_jax():
    # three channels, two referenced: exercises the channel remap
    x = _wavs((2, 3, 7200), 2)
    port = t_feat.OnlinePreprocessor(
        feat_list=_flagship_feat_list(t_feat.get_feat_config)
    )(torch.from_numpy(x))
    ref = j_feat.OnlinePreprocessor(
        feat_list=_flagship_feat_list(j_feat.get_feat_config)
    )(jnp.asarray(x))
    assert len(port) == len(ref) == 6
    # log-mel (+ deltas, + CMVN) of white noise: the log of f32 mel powers
    # carries their ~1e-6 relative STFT error as ~1e-6 absolute; CMVN and
    # deltas are sums of a few such terms
    for k, (p, r) in enumerate(zip(port, ref)):
        _close(p, r, 1e-5 if k >= 2 else 1e-4)


def test_preprocessor_dummy_call_and_dims():
    fl = _flagship_feat_list(t_feat.get_feat_config)
    pre = t_feat.OnlinePreprocessor(feat_list=fl)
    feats = pre(device="cpu")
    assert [f.shape[-1] for f in feats] == pre.feat_dims() == [80, 120, 201, 402, 201, 402]
    assert pre.feat_dims() == j_feat.OnlinePreprocessor(
        feat_list=_flagship_feat_list(j_feat.get_feat_config)
    ).feat_dims()
    with pytest.raises(ValueError):
        pre()


@pytest.mark.parametrize("target_kind", ["scalar", "per_utterance", "waveform"])
def test_masked_normalize_decibel_matches_jax(target_kind):
    rng = np.random.default_rng(3)
    audio = rng.standard_normal((3, 900)).astype(np.float32)
    lengths = np.array([900, 500, 301])
    target = {
        "scalar": -25.0,
        "per_utterance": np.array([-20.0, -25.0, -30.0], np.float32),
        "waveform": 0.2 * rng.standard_normal((3, 900)).astype(np.float32),
    }[target_kind]
    t_masks = t_audio.length_masks(torch.from_numpy(lengths), 900)
    j_masks = j_audio.length_masks(jnp.asarray(lengths), 900)
    np.testing.assert_array_equal(t_masks.numpy(), np.asarray(j_masks))
    t_target = target if np.isscalar(target) else torch.from_numpy(target)
    port = t_audio.masked_normalize_decibel(torch.from_numpy(audio), t_target, t_masks)
    ref = j_audio.masked_normalize_decibel(jnp.asarray(audio), target, j_masks)
    # a masked mean of 900 squares and a sqrt in f32
    _close(port, ref, 1e-5)
