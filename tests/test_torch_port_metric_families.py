"""The fused metric families, the metric registry and ``config/vcb.yaml``'s
eval on the port, on the CPU.

- In the port, stoi with estoi and pesq_nb with pesq_wb run through one
  shared front end each: identical bits to the per-metric calls; each
  row's scores do not depend on the rows scored beside it.
- In the JAX package (nothing there changes): ``batch_scores_unchunked``
  over the fused families equals its per-metric calls bit for bit, the
  prerequisite for holding the port's fused front ends to the reference's.
- The port's ``Runner`` built from a copy of ``config/vcb.yaml`` at full
  width, changed only in its corpus paths and without ``media_step`` (media
  logging is not ported yet), scores ``['stoi', 'pesq_nb', 'sisdr']``.
"""
import os
import random

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import yaml

from speech_enhancement_by_s3prl_tpu.metrics import (
    batch_scores_unchunked as j_batch_scores_unchunked,
)
from speech_enhancement_by_s3prl_tpu_torch import metrics, run_downstream
from speech_enhancement_by_s3prl_tpu_torch.data import audio_io
from speech_enhancement_by_s3prl_tpu_torch.data.loader import device_prefetch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
FAMILIES = {"stoi": ("stoi", "estoi"), "pesq": ("pesq_nb", "pesq_wb")}


def _batch(B, T, seed):
    """A ragged batch of noisy tones with a small lag: (deg, ref, lengths)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / SR
    ref = np.stack([0.1 * np.sin(2 * np.pi * (180 + 40 * b) * t)
                    * (1.2 + np.sin(2 * np.pi * (2 + b) * t))
                    + 0.01 * rng.standard_normal(T) for b in range(B)])
    deg = np.roll(ref, 37, axis=-1) + 0.03 * rng.standard_normal((B, T))
    lengths = np.array([T - 1500 * b for b in range(B)])
    return deg.astype(np.float32), ref.astype(np.float32), lengths


@pytest.mark.parametrize("family", list(FAMILIES))
def test_port_fused_family_is_bit_identical_to_per_metric_calls(family):
    deg, ref, lengths = (torch.from_numpy(a) for a in _batch(3, 24000, 1))
    names = FAMILIES[family]
    fused = metrics.batch_scores(names, deg, ref, lengths, SR)
    for name in names:
        alone = metrics.batch_scores([name], deg, ref, lengths, SR)[name]
        np.testing.assert_array_equal(fused[name].numpy(), alone.numpy(), err_msg=name)


@pytest.mark.parametrize("B,rows", [(3, 1), (4, 2)])
def test_scores_of_sub_batches_match_the_whole_batch(B, rows):
    """Length masks keep the rows apart: the scores of ``rows`` rows at a
    time, padding and all, are those of the whole ragged batch."""
    deg, ref, lengths = (torch.from_numpy(a) for a in _batch(B, 24000, 2))
    names = ["sisdr", "stoi", "estoi", "pesq_nb", "pesq_wb"]
    whole = metrics.batch_scores(names, deg, ref, lengths, SR)
    each = [metrics.batch_scores(names, deg[i:i + rows], ref[i:i + rows],
                                 lengths[i:i + rows], SR) for i in range(0, B, rows)]
    parts = {name: torch.cat([p[name] for p in each]) for name in names}
    for name in names:
        assert parts[name].shape == (B,) and torch.isfinite(parts[name]).all()
        np.testing.assert_allclose(parts[name].numpy(), whole[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_jax_fused_family_equals_its_per_metric_calls(family):
    deg, ref, lengths = (jnp.asarray(a) for a in _batch(2, 24000, 3))
    names = FAMILIES[family]
    fused = j_batch_scores_unchunked(names, deg, ref, lengths, SR)
    for name in names:
        alone = j_batch_scores_unchunked([name], deg, ref, lengths, SR)[name]
        np.testing.assert_array_equal(np.asarray(fused[name]), np.asarray(alone),
                                      err_msg=name)


@pytest.mark.parametrize("name", ["sisdr", "stoi", "estoi", "pesq_nb", "pesq_wb"])
def test_check_metrics_takes_every_registry_name(name):
    metrics.check_metrics([name])
    assert metrics.build_metrics([name]) == [metrics.METRIC_REGISTRY[name]]


def _itu_stub(sr, ref, deg, mode):
    """Stands in for the ITU wheel's ``pesq(sr, ref, deg, mode)``, which
    neither test machine has: a float that depends on both signals."""
    return 1.0 + float(np.abs(deg).mean() / (np.abs(ref).mean() + 1e-9)) + (mode == "wb")


@pytest.fixture
def itu_wheel(monkeypatch):
    from speech_enhancement_by_s3prl_tpu_torch.metrics import pesq

    monkeypatch.setattr(pesq, "itu_pesq_fn", lambda: _itu_stub)


def test_check_metrics_refuses_only_unknown_names():
    with pytest.raises(ValueError, match="unknown metric 'mosnet'"):
        metrics.check_metrics(["stoi", "mosnet"])
    # without the ITU wheel every metric scores on the device
    assert metrics.device_batch_metrics() == metrics.DEVICE_BATCH_METRICS


def test_pesq_moves_to_the_host_where_the_itu_wheel_imports(itu_wheel):
    assert metrics.device_batch_metrics() == ("sisdr", "stoi", "estoi")
    ref, deg = np.ones(800, np.float32), np.full(800, 0.5, np.float32)
    assert metrics.pesq_nb_eval(deg, ref) == pytest.approx(1.5)
    assert metrics.pesq_wb_eval(deg, ref) == pytest.approx(2.5)


def test_batch_scores_runs_in_full_f32_and_restores_the_settings(monkeypatch):
    """TF32 is off while the metrics run, and the caller's settings return."""
    seen = []

    def spy(real):
        def run(*args, **kwargs):
            seen.append((real.__name__, torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            return real(*args, **kwargs)
        return run

    for name in ("si_sdr_batch", "stoi_coeff_batch"):
        monkeypatch.setattr(metrics, name, spy(getattr(metrics, name)))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    deg, ref, lengths = (torch.from_numpy(a) for a in _batch(2, 8000, 4))
    metrics.batch_scores(["sisdr", "stoi"], deg, ref, lengths, SR)
    assert sorted(seen) == [("si_sdr_batch", False, False), ("stoi_coeff_batch", False, False)]
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


# -- config/vcb.yaml on the port ------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """13 speech files of 0.6-1.2 s and 3 noise files: vcb.yaml's test split
    takes the files after the first 10 (sample_num 10, select_sampled
    False), so it holds 3 utterances."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    for sub, n in (("speech", 13), ("noise", 3)):
        os.makedirs(root / sub)
        for k in range(n):
            L = int(rng.uniform(0.6, 1.2) * SR)
            t = np.arange(L) / SR
            tone = (0.1 * np.sin(2 * np.pi * (150 + 30 * k) * t)
                    * (1.0 + 0.5 * np.sin(2 * np.pi * 3 * t)) if sub == "speech" else 0)
            wav = (tone + 0.03 * rng.standard_normal(L)).astype(np.float32)
            audio_io.write_wav(str(root / sub / f"{k}.wav"), wav, SR)
    return root


def test_vcb_yaml_evaluates_its_metrics_on_the_port(corpus, tmp_path):
    with open(os.path.join(REPO, "config", "vcb.yaml")) as f:
        config = yaml.safe_load(f)
    # media logging is not ported yet: the one key still refused
    del config["runner"]["media_step"]
    for split in ("OnlineDataset_train", "OnlineDataset_test"):
        config[split]["speech"]["filestrs"] = str(corpus / "speech")
        config[split]["noise"]["filestrs"] = str(corpus / "noise")
    cfg = tmp_path / "vcb.yaml"
    cfg.write_text(yaml.safe_dump(config))
    args, config = run_downstream.get_downstream_args([
        "--config", str(cfg), "--name", "vcb", "--expdir", str(tmp_path / "exp"),
        "--downstream", "Residual", "--objective", "SISDR", "--from_rawfeature",
        "--n_jobs", "2", "--seed", "3", "--cpu"])
    runner = run_downstream.build_runner(args, config)
    runner.set_model()
    assert runner.metric_names == ["stoi", "pesq_nb", "sisdr"]
    assert runner.builder.eval_metrics == ("stoi", "pesq_nb", "sisdr")
    assert runner.host_metric_names == []
    # full width: vcb.yaml's Residual head, 3 one-direction layers of 256
    assert runner.downstream_model.lstm.hidden_size == 256

    loader = runner.get_dataloader(runner.get_dataset("test"), train=False)
    loss, scores, *_ = runner.evaluate(loader)
    assert np.isfinite(loss) and scores.shape == (3,) and np.isfinite(scores).all()
    # each score is batch_scores of the same eval outputs, averaged as
    # evaluate averages them (per-batch means, then over batches)
    want = np.zeros(3)
    n = 0
    random.seed(args.seed)
    np.random.seed(args.seed)
    for batch in device_prefetch(loader, runner.device):
        lengths, wavs = batch[0], batch[1]
        out = runner.builder.eval_step(wavs, lengths)
        got = metrics.batch_scores(["stoi", "pesq_nb", "sisdr"], out["wav_predicted"],
                                   out["wav_tar"], lengths, SR)
        for name in ("stoi", "pesq_nb", "sisdr"):
            np.testing.assert_array_equal(got[name].numpy(), out["scores"][name].numpy())
        want += [float(got[m].mean()) for m in ("stoi", "pesq_nb", "sisdr")]
        n += 1
    np.testing.assert_allclose(scores, want / n, rtol=1e-6, atol=1e-6)
    assert 0.0 < scores[0] < 1.0 and 1.0 <= scores[1] <= 4.6


def test_runner_scores_a_host_metric_from_every_row(corpus, tmp_path, itu_wheel):
    """Where PESQ goes to the host (the ITU wheel importing), the eval step
    scores the rest on the device and returns every row, and ``evaluate``
    averages the host scores of each utterance, trimmed to its length."""
    config = {
        "dataloader": {"batch_size": 2, "eval_batch_size": 4},
        "preprocessor": {"input_channel": 0, "target_channel": 1,
                         "baseline": {"feat_type": "linear", "log": False, "delta": 0,
                                      "cmvn": False}},
        "runner": {"learning_rate": 1e-3, "gradient_clipping": 1.0, "total_step": 1,
                   "log_step": 1, "eval_step": 1, "eval_splits": ["test"],
                   "eval_metrics": ["pesq_nb", "sisdr"]},
        "objective": {"SISDR": {}},
        "model": {"Residual": {"hidden_size": 8, "num_layers": 1}},
        "OnlineDataset_test": {"speech": {"filestrs": str(corpus / "speech"),
                                          "sample_num": 10},
                               "noise": {"filestrs": str(corpus / "noise")},
                               "sample_rate": SR, "max_time": 2000, "target_level": -25,
                               "snrs": [0], "half_noise": "end"},
    }
    config["OnlineDataset_train"] = config["OnlineDataset_test"]
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(config))
    args, config = run_downstream.get_downstream_args([
        "--config", str(cfg), "--name", "host", "--expdir", str(tmp_path / "exp"),
        "--downstream", "Residual", "--objective", "SISDR", "--from_rawfeature",
        "--n_jobs", "1", "--seed", "3", "--cpu"])
    runner = run_downstream.build_runner(args, config)
    runner.set_model()
    assert runner.builder.eval_metrics == ("sisdr",)
    assert runner.host_metric_names == ["pesq_nb"]
    loader = runner.get_dataloader(runner.get_dataset("test"), train=False)
    _, scores, *_ = runner.evaluate(loader)

    random.seed(args.seed)
    np.random.seed(args.seed)
    want = []
    for batch in device_prefetch(loader, runner.device):
        lengths, wavs = batch[0], batch[1]
        out = runner.builder.eval_step(wavs, lengths)
        assert out["wav_predicted"].shape[0] == len(lengths)
        want.append(np.mean([metrics.pesq_nb_eval(out["wav_predicted"][i, :n].numpy(),
                                                  out["wav_tar"][i, :n].numpy())
                             for i, n in enumerate(lengths.tolist())]))
    assert len(want) == 1 and np.isfinite(scores).all()
    assert scores[0] == pytest.approx(np.mean(want), abs=1e-6)

