"""FLAC input of the port (``data/flac.py``, ``data/audio_io.read_audio`` /
``load_audio``, the enhance CLI's directory walk) against the JAX package's
``read_flac`` on hand-assembled streams: identical arrays. A corrupt stream
raises. The decoder is built into the git-ignored ``build/`` when
``native/libseio.so`` is absent, never into ``native/``."""
import os

import numpy as np
import pytest

from speech_enhancement_by_s3prl_tpu.data.flac import read_flac as j_read_flac
from speech_enhancement_by_s3prl_tpu_torch.data import audio_io, flac
from speech_enhancement_by_s3prl_tpu_torch.enhance import find_audio_files
from tests import torch_port_flac_writer as W


def _streams():
    rng = np.random.default_rng(0)
    noise = rng.integers(-32768, 32767, size=4096, dtype=np.int64)
    ramp = np.cumsum(rng.integers(-7, 8, size=4096)).astype(np.int64)
    walk = np.cumsum(rng.integers(-25, 26, size=4096)).astype(np.int64)
    left = rng.integers(-20000, 20000, size=4096).astype(np.int64)
    right = rng.integers(-20000, 20000, size=4096).astype(np.int64)
    return {
        "verbatim": W.build_flac(W.encode_verbatim(noise), noise),
        "constant": W.build_flac(W.encode_constant(-1234), np.full(4096, -1234)),
        "fixed1": W.build_flac(W.encode_fixed1_rice(ramp), ramp),
        "lpc1": W.build_flac(W.encode_lpc_rice(walk, [31], 5), walk),
        "lpc8": W.build_flac(W.encode_lpc_rice(walk, [90, -30, 20, -12, 8, -5, 3, -2], 6),
                             walk),
        "left_side": W.build_stereo(left, right, "left_side"),
        "mid_side": W.build_stereo(left, right, "mid_side"),
        "frames3": W.mono16(rng.integers(-30000, 30000, size=3 * 4096)),
    }


@pytest.mark.parametrize("name", list(_streams()))
def test_read_flac_equals_jax(name, tmp_path):
    path = tmp_path / f"{name}.flac"
    path.write_bytes(_streams()[name])
    want, want_sr = j_read_flac(str(path))
    got, sr = flac.read_flac(str(path))
    assert sr == want_sr == 16000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    read, _ = audio_io.read_audio(str(path))
    np.testing.assert_array_equal(read, want)
    mono, _ = audio_io.load_audio(str(path), sr=16000)
    np.testing.assert_array_equal(mono, want.mean(0) if want.shape[0] > 1 else want[0])


def test_load_audio_resamples_flac_as_wav(tmp_path):
    pcm = np.random.default_rng(1).integers(-3000, 3000, size=2 * 4096)
    path = tmp_path / "x.flac"
    path.write_bytes(W.mono16(pcm))
    got, sr = audio_io.load_audio(str(path), sr=8000)
    want = audio_io.resample_poly((pcm / 32768.0).astype(np.float32), 16000, 8000)
    assert sr == 8000
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("data", [b"fLaC", b"RIFF" + b"\x00" * 100,
                                  W.streaminfo(0, 1, 16, 4096) + b"\x00" * 16])
def test_corrupt_stream_raises(data, tmp_path):
    path = tmp_path / "bad.flac"
    path.write_bytes(data)
    with pytest.raises(ValueError, match="FLAC decode failed"):
        flac.read_flac(str(path))
    with pytest.raises(ValueError, match="FLAC decode failed"):
        audio_io.load_audio(str(path))


def test_decoder_built_into_build_dir_when_native_lib_absent(tmp_path, monkeypatch):
    """With no native/libseio.so the decoder is compiled from native/seio.cpp
    into build/native/, and native/ is left as it was."""
    if not any(os.access(os.path.join(d, "g++"), os.X_OK)
               for d in os.environ.get("PATH", "").split(os.pathsep)):
        pytest.skip("no g++ on PATH")
    native_before = sorted(os.listdir(flac.NATIVE))
    monkeypatch.setattr(flac, "NATIVE", tmp_path / "native")
    monkeypatch.setattr(flac, "BUILD_DIR", tmp_path / "build" / "native")
    monkeypatch.setattr(flac, "_lib", None)
    (tmp_path / "native").mkdir()
    (tmp_path / "native" / "seio.cpp").write_bytes(
        (flac.ROOT / "native" / "seio.cpp").read_bytes())
    lib_path = flac.library_path()
    assert lib_path.parent == tmp_path / "build" / "native" and not lib_path.exists()
    path = tmp_path / "c.flac"
    path.write_bytes(W.build_flac(W.encode_constant(1000), np.full(4096, 1000)))
    wav, sr = flac.read_flac(str(path))
    np.testing.assert_array_equal(wav, j_read_flac(str(path))[0])
    assert lib_path.exists()
    assert sorted(os.listdir(tmp_path / "native")) == ["seio.cpp"]
    assert sorted(os.listdir(flac.ROOT / "native")) == native_before


def test_enhance_cli_walk_takes_flac(tmp_path):
    for name in ("a.wav", "b.FLAC", "sub/c.flac", "d.txt", "e.mp3"):
        (tmp_path / name).parent.mkdir(exist_ok=True)
        (tmp_path / name).write_bytes(b"")
    got = [os.path.relpath(p, tmp_path) for p in find_audio_files(str(tmp_path))]
    assert got == ["a.wav", "b.FLAC", "sub/c.flac"]
