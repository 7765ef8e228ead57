"""The serving slice as a whole on the CPU: one checkpoint served by the port
under the three recurrence routes against the JAX package's serving, and the
long-form entry (crossfaded windows for a request longer than the largest
bucket) against the JAX package's ``enhance_streaming`` and its served
result."""
import numpy as np
import pytest

import torch

import serve as j_serve
from speech_enhancement_by_s3prl_tpu.ops.streaming import (
    enhance_streaming as j_enhance_streaming,
)
from speech_enhancement_by_s3prl_tpu_torch import entry, serve
from speech_enhancement_by_s3prl_tpu_torch.data import audio_io
from speech_enhancement_by_s3prl_tpu_torch.enhance import main as enhance_cli
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda.decode_kernel import decode_ola
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda.lstm_kernel import (
    lstm_bidir_bb,
    lstm_bidir_fused,
    lstm_bidir_tm,
)
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda.stft_kernel import stft_fused
from speech_enhancement_by_s3prl_tpu_torch.ops.streaming import enhance_streaming
from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import save_checkpoint

SMALL = dict(hidden_size=16, num_layers=2)
# Waveforms renormalized to -25 dB; both sides run the same f32 pipeline with
# sums in other orders (tests/test_torch_port_slice.py): ~1e-6 of the RMS.
WAV_TOL = 5e-5


def _audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    tone = 0.1 * np.sin(2 * np.pi * (300 + 50 * seed) * t)
    return (tone + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _rel(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and np.isfinite(port).all()
    return float(np.abs(port - ref).max() / np.sqrt(np.mean(ref ** 2)))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A seeded flagship at hidden 16, 2 layers, written by the port."""
    _, model = entry.build(device="cpu", generator=torch.Generator().manual_seed(3),
                           **SMALL)
    config, paras = entry.flagship_settings(**SMALL)
    path = tmp_path_factory.mktemp("ckpt")
    save_checkpoint(str(path), 1, model, None, config, paras)
    return str(path)


@pytest.fixture(scope="module")
def jax_enhancer(ckpt):
    return j_serve.build_enhancer(ckpt, 16000, -25.0, max_bucket_ms=2000)


@pytest.mark.parametrize("route", ["tm", "blocked", "fused"])
def test_checkpoint_served_under_each_route_matches_jax(route, ckpt, jax_enhancer):
    port = serve.build_enhancer(ckpt, device="cpu", max_bucket_ms=2000)
    port.model.lstm.recurrence = route
    kernels = (stft_fused, decode_ola, lstm_bidir_tm, lstm_bidir_bb, lstm_bidir_fused)
    for wav in (_audio(5000, 1), _audio(20000, 2)):
        assert _rel(port(wav), np.asarray(jax_enhancer(wav))) < WAV_TOL
    assert not any(fn.launches for fn in kernels)  # CPU tensors: plain versions


# 1 s windows with 0.25 s overlap at 1 kHz: shorter than a window, an exact
# multiple of the hop, a ragged tail, and a tail shorter than the overlap
@pytest.mark.parametrize("n", [700, 1000, 1750, 2500, 3137, 1800])
def test_enhance_streaming_is_bit_identical_to_jax(n):
    calls = []

    def enhance_fn(chunk):
        # deterministic and position-dependent within the window
        calls.append(len(chunk))
        return (chunk * np.linspace(0.5, 1.5, len(chunk), dtype=np.float32)).astype(np.float32)

    wav = _audio(n, n)
    kwargs = dict(sample_rate=1000, window_sec=1.0, overlap_sec=0.25)
    ref = j_enhance_streaming(enhance_fn, wav, **kwargs)
    n_ref_calls = len(calls)
    port = enhance_streaming(enhance_fn, wav, **kwargs)
    assert port.dtype == ref.dtype and port.shape == (n,)
    assert np.array_equal(port, ref)
    assert len(calls) == 2 * n_ref_calls and set(calls) == {1000}


def test_enhance_streaming_rejects_an_overlap_as_long_as_its_window():
    with pytest.raises(ValueError, match="overlap"):
        enhance_streaming(lambda w: w, np.zeros(3000, np.float32), sample_rate=1000,
                          window_sec=1.0, overlap_sec=1.0)


def test_long_request_matches_jax_crossfaded_result(ckpt, jax_enhancer):
    port = serve.build_enhancer(ckpt, device="cpu", max_bucket_ms=2000)
    assert port.max_len == jax_enhancer.max_len == 32000
    wav = _audio(80000, 7)  # 5 s: four 2 s windows, each starting 1 s after the last
    windows = []
    run_batch = port.run_batch
    out = port(wav)
    ref = np.asarray(jax_enhancer(wav))
    assert out.shape == (80000,) and _rel(out, ref) < WAV_TOL
    # the long-form entry is enhance_streaming over the single-request runner
    again = enhance_streaming(
        lambda w: (windows.append(len(w)), run_batch([w])[0])[1], wav,
        sample_rate=16000, window_sec=2.0, overlap_sec=1.0)
    assert windows == [32000] * 4 and np.array_equal(again, out)
    # run_batch itself keeps to bucket-sized groups
    with pytest.raises(ValueError, match="largest bucket"):
        port.run_batch([wav])


def test_enhance_cli_streams_a_file_longer_than_its_bucket_ceiling(ckpt, tmp_path,
                                                                   monkeypatch):
    """The CLI hands a file longer than the largest bucket to the long-form
    entry and the others to one padded batch."""
    inputs = tmp_path / "in"
    inputs.mkdir()
    clips = {"long": _audio(40000, 8), "short": _audio(9000, 9)}
    for name, wav in clips.items():
        audio_io.write_wav(str(inputs / f"{name}.wav"), wav, 16000)
    # the CLI's ceiling is 30 s; serve the same code path at a 2 s ceiling
    build = serve.build_enhancer
    monkeypatch.setattr(serve, "build_enhancer",
                        lambda *a, **kw: build(*a, **{**kw, "max_bucket_ms": 2000}))
    enhance_cli(["--ckpt", ckpt, "--inputs", str(inputs),
                 "--outdir", str(tmp_path / "out"), "--device", "cpu"])
    ref = build(ckpt, device="cpu", max_bucket_ms=2000, round_pow2=False)
    for name in clips:
        wav = audio_io.read_wav(str(inputs / f"{name}.wav"))[0][0]
        out, sr = audio_io.read_wav(str(tmp_path / "out" / f"{name}.wav"))
        assert sr == 16000 and out.shape == (1, len(wav))
        # 16-bit PCM output: within one quantization step of the float run
        assert np.abs(out[0] - ref(wav)).max() <= 1.0 / 32767 + 1e-6
