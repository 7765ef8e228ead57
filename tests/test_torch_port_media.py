"""The port's media logging against the JAX package on the CPU: ``_prep``,
the greyscale PNG (decoded here with ``zlib``), WSD's figure logger against
the five panels of the JAX closure, ``MediaLog``'s files and index, a failed
write raising, and one small training run through both packages' Runners
with ``media_step`` (the JAX one writing to a recorder in place of
``tensorboardX.SummaryWriter``): the same (step, tag) list, the same audio
within one PCM step, and the same training scalars with and without
``media_step``."""
import json
import os
import struct
import sys
import wave
import zlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import yaml

from speech_enhancement_by_s3prl_tpu import objectives as j_objectives
from speech_enhancement_by_s3prl_tpu.utils import plotting as j_plotting
from speech_enhancement_by_s3prl_tpu_torch import objectives, run_downstream
from speech_enhancement_by_s3prl_tpu_torch.data import audio_io
from speech_enhancement_by_s3prl_tpu_torch.ops.features import (
    OnlinePreprocessor,
    get_feat_config,
)
from speech_enhancement_by_s3prl_tpu_torch.runner.media import MediaLog
from speech_enhancement_by_s3prl_tpu_torch.utils import plotting

SR = 16000
PCM_STEP = 1.0 / 32767


def _read_png(data: bytes) -> np.ndarray:
    """The (height, width) pixels of an 8-bit greyscale PNG, every chunk's
    CRC checked."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(kind + body)
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    width, height, depth, color, _, _, interlace = header
    assert (depth, color, interlace) == (8, 0, 0) and kind == b"IEND"
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(height, width + 1)
    assert not rows[:, 0].any()  # filter type 0 on every scanline
    return rows[:, 1:]


def _read_wav(path):
    with wave.open(path, "rb") as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, SR)
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float64) / 32767


@pytest.mark.parametrize("shape", [(7, 5), (1, 7, 5)])
def test_prep_matches_jax(shape):
    spec = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ours, theirs = plotting._prep(spec), j_plotting._prep(spec)
    assert ours.shape == theirs.shape == (5, 7) and np.array_equal(ours, theirs)


def test_png_holds_one_pixel_a_bin_and_frame():
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((9, 4)), 3.0 * rng.standard_normal((9, 4)) + 7.0
    one = _read_png(plotting.spectrogram_png(a))
    assert one.shape == (4, 9) and one.min() == 0 and one.max() == 255
    assert np.array_equal(one, plotting.grey_levels(np.flipud(a.T)))
    # panels stacked top to bottom, each normalized alone; a flat one is black
    three = _read_png(plotting.spectrograms_png([a, b, np.ones((9, 4))]))
    assert three.shape == (12, 9)
    assert np.array_equal(three[:4], one) and np.array_equal(three[4:8], _read_png(
        plotting.spectrogram_png(b))) and not three[8:].any()


def _wsd_inputs():
    """Power spectra on a 1/64 grid, so that every sum is exact in any
    order and both packages' panels hold the same bits."""
    rng = np.random.default_rng(2)
    Bt, T, F = 2, 30, 21
    tar = np.round(rng.random((Bt, T, F)) * 64 * 8) / 64
    tar[:, 20:] /= 1024  # quiet frames below the voice threshold
    inp = tar + np.round(rng.random((Bt, T, F)) * 64 * 2) / 64
    offset = np.round(rng.random((Bt, T, F)) * 64) / 64
    masks = (np.arange(T)[None, :] < np.array([T, 25])[:, None])
    return {"linear_inp": inp.astype(np.float32), "linear_tar": tar.astype(np.float32),
            "offset": offset.astype(np.float32), "stft_length_masks": masks.astype(np.float32)}


class _Recorder:
    """A stand-in for ``tensorboardX.SummaryWriter``: records every call."""

    def __init__(self, *args, **kwargs):
        self.calls = []

    def add_scalar(self, tag, value, global_step=None):
        self.calls.append(("scalar", global_step, tag, float(value)))

    def add_audio(self, tag, snd, global_step=None, sample_rate=SR):
        self.calls.append(("audio", global_step, tag, np.asarray(snd).reshape(-1).copy()))

    def add_figure(self, tag, figure, global_step=None):
        import matplotlib.pyplot as plt

        plt.close(figure)
        self.calls.append(("figure", global_step, tag, None))

    def flush(self):
        pass


def test_wsd_logger_draws_the_five_jax_panels(tmp_path, monkeypatch):
    ctx = _wsd_inputs()
    cfg = {"alpha": 0.3, "db_interval": 50}
    panels = []
    monkeypatch.setattr(j_plotting, "plot_spectrograms", lambda specs: panels.extend(specs))
    _, jaux = j_objectives.build_objective("WSD", **cfg)(
        **{k: jnp.asarray(v) for k, v in ctx.items()})
    jaux["logger"](_Recorder(), 3)
    assert len(panels) == 5
    want = np.concatenate([plotting.grey_levels(j_plotting._prep(p)) for p in panels])

    _, aux = objectives.build_objective("WSD", **cfg)(
        **{k: torch.from_numpy(v) for k, v in ctx.items()})
    log = MediaLog(str(tmp_path), None, "cpu")
    aux["logger"](log, 3)
    assert [json.loads(line) for line in open(tmp_path / "media.jsonl")] == [
        {"step": 3, "tag": "WSD_variables", "kind": "image",
         "path": os.path.join("media", "step_3", "WSD_variables.png")}]
    got = _read_png((tmp_path / "media" / "step_3" / "WSD_variables.png").read_bytes())
    assert got.shape == (5 * 21, 30) and np.array_equal(got, want)


def test_media_logging_writes_a_clip_and_its_spectrogram(tmp_path):
    """A (2, 8000) batch is one clip of 16000 samples, normalized by its
    peak; its spectrogram is the preprocessor's log-linear feature of that
    clip, one pixel a (bin, frame)."""
    rng = np.random.default_rng(4)
    data = torch.from_numpy((0.3 * rng.standard_normal((2, 8000))).astype(np.float32))
    pre = OnlinePreprocessor()
    MediaLog(str(tmp_path), pre, "cpu").media_logging(6, "noisy", data)
    index = [json.loads(line) for line in open(tmp_path / "media.jsonl")]
    step_dir = os.path.join("media", "step_6")
    assert index == [
        {"step": 6, "tag": f"noisy.{ext}", "kind": kind,
         "path": os.path.join(step_dir, f"noisy.{ext}")}
        for ext, kind in (("wav", "audio"), ("png", "image"))]
    clip = data.numpy().reshape(-1)
    clip = clip / np.abs(clip).max()
    wav = _read_wav(str(tmp_path / step_dir / "noisy.wav"))
    assert wav.shape == (16000,) and np.abs(wav - clip).max() <= 0.5 * PCM_STEP + 1e-7
    (spec,) = pre(torch.from_numpy(clip).reshape(1, 1, -1), [get_feat_config("linear", log=True)])
    png = _read_png((tmp_path / step_dir / "noisy.png").read_bytes())
    assert png.shape == (201, 101)
    assert np.array_equal(png, plotting.grey_levels(plotting._prep(spec[0].numpy())))


def test_a_failed_media_write_raises(tmp_path):
    (tmp_path / "media").write_text("not a directory")
    log = MediaLog(str(tmp_path), OnlinePreprocessor(), "cpu")
    with pytest.raises(OSError):
        log.media_logging(2, "noisy", np.ones(400, np.float32))
    assert not (tmp_path / "media.jsonl").exists()


# -- one run through both Runners -------------------------------------------------------

def _config(corpus, media_step):
    data = {"sample_rate": SR, "max_time": 2000, "target_level": -25}
    runner = {"learning_rate": 1e-3, "warmup_proportion": 0.07, "gradient_clipping": 1.0,
              "total_step": 4, "log_step": 2, "eval_step": 2, "max_keep": 1,
              "eval_splits": ["dev"], "eval_metrics": ["sisdr"]}
    if media_step:
        runner["media_step"] = media_step
    return {
        "dataloader": {"batch_size": 2, "eval_batch_size": 4},
        "preprocessor": {"input_channel": 0, "target_channel": 1,
                         "baseline": {"feat_type": "linear", "log": False, "delta": 0,
                                      "cmvn": False}},
        "runner": runner,
        "objective": {"WSD": {"db_interval": 50, "alpha": 0.3}},
        "model": {"Residual": {"hidden_size": 16, "num_layers": 1, "bidirectional": False,
                               "activation": "Sigmoid", "cmvn": True}},
        "OnlineDataset_train": {"speech": {"filestrs": str(corpus / "speech"), "sample_num": 4},
                                "noise": {"filestrs": str(corpus / "noise")},
                                "snrs": [-5, 0, 5], "infinite": True, **data},
        "OnlineDataset_test": {"speech": {"filestrs": str(corpus / "speech"), "sample_num": 2,
                                          "select_sampled": True},
                               "noise": {"filestrs": str(corpus / "noise")},
                               "snrs": [0], "half_noise": "end", **data},
    }


def _flags(expdir, *extra):
    return ["--name", "run", "--expdir", str(expdir), "--downstream", "Residual",
            "--objective", "WSD", "--from_rawfeature", "--dev_num", "2", "--n_jobs", "1",
            "--seed", "3", "--cpu", *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One seeded head's weights (``--dckpt``) trained 4 steps by the port
    with and without ``media_step`` 2 and by the JAX package with it."""
    import tensorboardX

    root = tmp_path_factory.mktemp("media_runs")
    rng = np.random.default_rng(0)
    for sub, n, lo, hi in (("speech", 6, 1.2, 2.0), ("noise", 2, 2.0, 2.5)):
        os.makedirs(root / "corpus" / sub)
        for k in range(n):
            L = int(rng.uniform(lo, hi) * SR)
            t = np.arange(L) / SR
            tone = (0.1 * np.sin(2 * np.pi * (150 + 30 * k) * t)
                    * (1.0 + 0.5 * np.sin(2 * np.pi * 3 * t)) if sub == "speech" else 0)
            audio_io.write_wav(str(root / "corpus" / sub / f"{k}.wav"),
                               (tone + 0.03 * rng.standard_normal(L)).astype(np.float32), SR)
    cfgs = {}
    for media in (2, None):
        cfgs[media] = str(root / f"cfg{media}.yaml")
        with open(cfgs[media], "w") as f:
            yaml.safe_dump(_config(root / "corpus", media), f)

    args, config = run_downstream.get_downstream_args(["--config", cfgs[2], *_flags(root / "init")])
    init = run_downstream.build_runner(args, config)
    init.set_model()
    init.save_model()
    dckpt = str(root / "init" / "run" / "states-1.ckpt")

    for media in (2, None):
        run_downstream.main(["--config", cfgs[media],
                             *_flags(root / f"port{media}", "--dckpt", dckpt)])

    recorder = _Recorder()
    spectrograms = []

    def plot_spectrogram(spec):
        spectrograms.append(np.asarray(spec))
        return j_plotting.plt.figure()

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tensorboardX, "SummaryWriter", lambda *a, **k: recorder)
        mp.setattr(j_plotting, "plot_spectrogram", plot_spectrogram)
        mp.setattr(sys, "argv", ["run_downstream.py", "--config", cfgs[2],
                                 *_flags(root / "jax", "--dckpt", dckpt)])
        import run_downstream as j_run_downstream

        j_run_downstream.main()
    finally:
        mp.undo()
    return root, recorder, spectrograms


def _media_index(run_dir):
    with open(run_dir / "media.jsonl") as f:
        return [json.loads(line) for line in f]


def test_media_cadence_matches_jax(runs):
    root, recorder, spectrograms = runs
    run_dir = root / "port2" / "run"
    index = _media_index(run_dir)
    jax_media = [c for c in recorder.calls if c[0] != "scalar"]
    assert [(m["step"], m["tag"]) for m in index] == [(c[1], c[2]) for c in jax_media]
    tags = [m["tag"] for m in index if m["step"] == 2]
    assert tags == ["WSD_variables", "noisy.wav", "noisy.png", "clean.wav", "clean.png",
                    "noise.wav", "noise.png", "dev-noisy-0.wav", "dev-noisy-0.png",
                    "dev-clean-0.wav", "dev-clean-0.png", "dev-enhanced-0.wav",
                    "dev-enhanced-0.png"]
    assert [m["tag"] for m in index if m["step"] == 4] == tags
    audio = [(m, c) for m, c in zip(index, jax_media) if m["kind"] == "audio"]
    images = [m for m in index if m["kind"] == "image" and m["tag"] != "WSD_variables"]
    assert len(audio) == len(images) == len(spectrograms) == 12
    for m, c in audio:
        wav = _read_wav(str(run_dir / m["path"]))
        # the train batch's channels are the whole batch of 2 as one clip
        assert wav.shape == c[3].shape and np.abs(wav - c[3]).max() <= PCM_STEP, m["tag"]
    for m, spec in zip(images, spectrograms):
        png = _read_png((run_dir / m["path"]).read_bytes())
        want = plotting.grey_levels(j_plotting._prep(spec))
        assert png.shape == want.shape and png.shape[0] == 201
        assert np.abs(png.astype(int) - want).max() <= 1, m["tag"]


def test_media_logging_changes_no_training_value(runs):
    """The port's scalars with ``media_step`` and without it are the same
    values at the same steps; only the wall-clock ``steps_per_sec`` differs.
    Without ``media_step`` only WSD's figure is written, at ``log_step``."""
    root = runs[0]

    def scalars(name):
        with open(root / name / "run" / "scalars.jsonl") as f:
            return [json.loads(line) for line in f]

    with_media, without = scalars("port2"), scalars("portNone")
    assert [(s["step"], s["tag"]) for s in with_media] == [(s["step"], s["tag"])
                                                            for s in without]
    assert len(with_media) == 2 * 5  # loss, gradient norm, steps/s, dev loss and sisdr
    for a, b in zip(with_media, without):
        if a["tag"] != "steps_per_sec":
            assert a["value"] == b["value"], a
    assert [(m["step"], m["tag"]) for m in _media_index(root / "portNone" / "run")] == [
        (2, "WSD_variables"), (4, "WSD_variables")]


def test_the_runner_calls_the_figure_logger_objective_with_tf32_off(runs, monkeypatch):
    """The Runner's re-run for WSD's figure calls the objective with TF32
    off, as the train and eval steps do, and the caller's settings come
    back."""
    root = runs[0]
    args, config = run_downstream.get_downstream_args(
        ["--config", str(root / "cfgNone.yaml"), *_flags(root / "logger")])
    runner = run_downstream.build_runner(args, config)
    runner.set_model()
    seen, inner = [], runner.objective

    class Watched:
        has_logger = True

        def __call__(self, **ctx):
            seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
            return inner(**ctx)

    runner.objective = Watched()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    rng = np.random.default_rng(5)
    wavs = torch.from_numpy((0.1 * rng.standard_normal((2, 3, SR))).astype(np.float32))
    runner._dispatch_objective_logger(wavs, torch.tensor([SR, 12000]))
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    assert [m["tag"] for m in _media_index(root / "logger" / "run")] == ["WSD_variables"]
