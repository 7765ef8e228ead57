"""The port's data pipeline, Runner and training CLI on the CPU: datasets and
the loader against the JAX package's, ``Runner.train`` / ``evaluate`` through
``run_downstream`` on a small seeded WAV corpus, resume from checkpoints of
either package, the settings precedence, the refusals of what is not ported,
and a training run in a process where jax cannot be imported."""
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import yaml

from speech_enhancement_by_s3prl_tpu.data import datasets as j_datasets
from speech_enhancement_by_s3prl_tpu.data import loader as j_loader
from speech_enhancement_by_s3prl_tpu.metrics import si_sdr_batch as j_si_sdr_batch
from speech_enhancement_by_s3prl_tpu.runner import optim as j_optim
from speech_enhancement_by_s3prl_tpu.runner.checkpoint import (
    save_checkpoint as j_save_checkpoint,
)
from speech_enhancement_by_s3prl_tpu.utils import config as j_config
from speech_enhancement_by_s3prl_tpu_torch import metrics, run_downstream
from speech_enhancement_by_s3prl_tpu_torch.data import audio_io, datasets, loader
from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import (
    load_checkpoint,
    optimizer_state_from_payload,
)
from speech_enhancement_by_s3prl_tpu_torch.utils import config as t_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """8 speech files of 0.4-1.4 s and 3 noise files of 0.8-1.6 s."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    for sub, n, lo, hi in (("speech", 8, 0.4, 1.4), ("noise", 3, 0.8, 1.6)):
        os.makedirs(root / sub)
        for k in range(n):
            L = int(rng.uniform(lo, hi) * SR)
            t = np.arange(L) / SR
            tone = 0.1 * np.sin(2 * np.pi * (150 + 30 * k) * t) if sub == "speech" else 0
            wav = (tone + 0.03 * rng.standard_normal(L)).astype(np.float32)
            audio_io.write_wav(str(root / sub / f"{k}.wav"), wav, SR)
    return root


def _dataset_conf(corpus, **extra):
    return dict(speech={"filestrs": str(corpus / "speech"), "sample_num": 2},
                noise={"filestrs": str(corpus / "noise")}, sample_rate=SR,
                max_time=1000, target_level=-25, snrs=[-5, 0, 5], **extra)


def _config(corpus, **runner):
    data = {"sample_rate": SR, "max_time": 1000, "target_level": -25}
    return {
        "dataloader": {"batch_size": 2, "eval_batch_size": 4},
        "preprocessor": {"input_channel": 0, "target_channel": 1,
                         "baseline": {"feat_type": "mel", "log": True, "delta": 2,
                                      "cmvn": False}},
        "runner": {"learning_rate": 1e-3, "warmup_proportion": 0.07,
                   "gradient_clipping": 1.0, "total_step": 3, "log_step": 1,
                   "eval_step": 2, "save_step": 1, "max_keep": 2,
                   "eval_splits": ["dev"], "eval_metrics": ["sisdr"], **runner},
        "objective": {"SISDR": {}},
        "model": {"Residual": {"hidden_size": 8, "num_layers": 2, "bidirectional": True,
                               "activation": "Sigmoid", "cmvn": False}},
        "OnlineDataset_train": {"speech": {"filestrs": str(corpus / "speech"),
                                           "sample_num": 2},
                                "noise": {"filestrs": str(corpus / "noise")},
                                "snrs": [-5, 0, 5], "infinite": True, **data},
        "OnlineDataset_test": {"speech": {"filestrs": str(corpus / "speech"),
                                          "sample_num": 2, "select_sampled": True},
                               "noise": {"filestrs": str(corpus / "noise")},
                               "snrs": [0], "half_noise": "end", **data},
    }


def _flags(expdir, *extra):
    return ["--name", "run", "--expdir", str(expdir), "--downstream", "Residual",
            "--objective", "SISDR", "--from_rawfeature", "--dev_num", "2",
            "--n_jobs", "2", "--seed", "3", "--cpu", *extra]


def _write_yaml(path, config):
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return str(path)


# -- data -----------------------------------------------------------------------

@pytest.mark.parametrize("extra", [{}, {"half_noise": "front"}, {"min_time": 1200}])
def test_online_dataset_items_match_jax(corpus, extra):
    conf = _dataset_conf(corpus, **extra)
    ours, theirs = datasets.OnlineDataset(**conf), j_datasets.OnlineDataset(**conf)
    assert ours.filepths == theirs.filepths and ours.fixed_snrs == theirs.fixed_snrs
    assert ours.fixed_noises == theirs.fixed_noises and len(ours) == len(theirs) == 6
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a.shape == b.shape and a.shape[1] == 3 and np.array_equal(a, b)


def test_infinite_items_follow_the_item_seed_like_jax(corpus):
    conf = _dataset_conf(corpus, infinite=True)
    ours, theirs = datasets.OnlineDataset(**conf), j_datasets.OnlineDataset(**conf)
    for seed in (1, 2, 3):
        datasets.set_item_seed(seed)
        j_datasets.set_item_seed(seed)
        try:
            assert np.array_equal(ours[4], theirs[4])
        finally:
            datasets.set_item_seed(None)
            j_datasets.set_item_seed(None)


@pytest.mark.parametrize("spec", ["dir", "glob", "list"])
def test_file_lists_match_jax(corpus, tmp_path, spec):
    if spec == "dir":
        kw = {"filestrs": str(corpus / "speech")}
    elif spec == "glob":
        kw = {"filestrs": str(corpus / "speech" / "[1-5].wav")}
    else:
        (tmp_path / "list.txt").write_text("1.wav\n3.wav\n\n7.wav\n")
        kw = {"filestrs": str(tmp_path / "list.txt"), "fileroot": str(corpus / "speech")}
    for sample_num, select in ((0, False), (2, True), (2, False)):
        assert datasets.filestrs2list(sample_num=sample_num, select_sampled=select, **kw) \
            == j_datasets.filestrs2list(sample_num=sample_num, select_sampled=select, **kw)


def test_mixing_helpers_match_jax():
    rng = np.random.default_rng(1)
    speech = rng.standard_normal(5000).astype(np.float32)
    for n_noise in (1200, 9000):
        noise = rng.standard_normal(n_noise).astype(np.float32)
        for got, want in zip(datasets.add_noise_np(speech, noise, 3.0),
                             j_datasets.add_noise_np(speech, noise, 3.0)):
            assert np.array_equal(got, want)
    assert np.array_equal(datasets.normalize_wav_decibel_np(speech, -25),
                          j_datasets.normalize_wav_decibel_np(speech, -25))


@pytest.mark.parametrize("workers", [1, 3])
def test_loader_batches_match_jax_and_pad_to_buckets(corpus, workers):
    conf = _dataset_conf(corpus, infinite=True)
    buckets = [8000, 16000]
    batches = {}
    for name, mod, ds in (("port", loader, datasets), ("jax", j_loader, j_datasets)):
        dl = mod.DataLoader(ds.OnlineDataset(**conf), batch_size=4, shuffle=True,
                            num_workers=workers, buckets=buckets, drop_last=False)
        random.seed(7)
        batches[name] = list(dl)
        assert len(dl) == len(batches[name]) == 2
    for (lp, wp), (lj, wj) in zip(batches["port"], batches["jax"]):
        assert np.array_equal(lp, lj) and np.array_equal(wp, wj)
        assert wp.shape[-1] in buckets and wp.shape[-1] >= lp.max()
        assert wp.shape[-1] == loader.bucket_length(int(lp.max()), buckets)
        for i, n in enumerate(lp):  # zero padding past each length
            assert not wp[i, :, n:].any()


def test_loader_drop_last_and_device_prefetch(corpus):
    ds = datasets.OnlineDataset(**_dataset_conf(corpus))
    dl = loader.DataLoader(ds, batch_size=4, shuffle=False, num_workers=2, drop_last=True)
    host = list(dl)
    assert len(dl) == len(host) == 1
    moved = list(loader.device_prefetch(dl, "cpu"))
    assert len(moved) == 1 and all(isinstance(x, torch.Tensor) for x in moved[0])
    assert all(np.array_equal(x.numpy(), y) for x, y in zip(moved[0], host[0]))
    it = loader.infinite_iterator(dl)
    assert [len(next(it)[0]) for _ in range(3)] == [4, 4, 4]


def test_what_the_data_path_does_not_port(corpus, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        datasets.OnlineDataset(**_dataset_conf(corpus, pseudo_modes=[0, 1]))
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        datasets.DATASET_REGISTRY["NoisyCleanDataset"](roots=[str(corpus)])
    (tmp_path / "a.flac").write_bytes(b"fLaC")
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        audio_io.load_audio(str(tmp_path / "a.flac"))


def test_si_sdr_and_batch_scores_match_jax():
    rng = np.random.default_rng(2)
    src = rng.standard_normal((3, 4000)).astype(np.float32)
    tar = (src + 0.3 * rng.standard_normal((3, 4000))).astype(np.float32)
    lengths = np.array([4000, 3000, 1234])
    want = np.asarray(j_si_sdr_batch(jnp.asarray(src), jnp.asarray(tar), jnp.asarray(lengths)))
    got = metrics.batch_scores(["sisdr"], torch.from_numpy(src), torch.from_numpy(tar),
                               torch.from_numpy(lengths))
    np.testing.assert_allclose(got["sisdr"].numpy(), want, rtol=1e-5, atol=1e-5)
    # every metric of the registry scores (tests/test_torch_port_metrics.py
    # holds the others to the JAX package); an unknown name is refused
    with pytest.raises(ValueError, match="unknown metric"):
        metrics.batch_scores(["sisdr", "pesq"], torch.from_numpy(src),
                             torch.from_numpy(tar), torch.from_numpy(lengths))


# -- runner and CLI -----------------------------------------------------------------

def test_runner_trains_evaluates_and_saves(corpus, tmp_path, capsys):
    cfg = _write_yaml(tmp_path / "cfg.yaml", _config(corpus))
    run_downstream.main(["--config", cfg, *_flags(tmp_path / "exp", "--save_best")])
    out = capsys.readouterr().out
    run = tmp_path / "exp" / "run"
    # save_step 1 with max_keep 2 keeps the newest two; the final save is step 4
    assert sorted(p.name for p in run.glob("states-*.ckpt")) == [
        "states-3.ckpt", "states-4.ckpt"]
    for step in (1, 2, 3):
        assert f"[runner] step {step}/3 | loss " in out
    assert out.count("[runner] evaluate: loss ") == 1 and "sisdr " in out
    scalars = [json.loads(line) for line in (run / "scalars.jsonl").read_text().splitlines()]
    tags = {(s["tag"], s["step"]) for s in scalars}
    assert {("loss", 1), ("gradient norm", 3), ("steps_per_sec", 2), ("dev_loss", 2),
            ("dev_sisdr", 2)} <= tags
    assert all(np.isfinite(s["value"]) for s in scalars)
    payload = load_checkpoint(str(run))
    assert payload["Global_step"] == 4 and int(payload["Optimizer"]["count"]) == 3
    assert payload["Settings"]["Paras"]["device"] == "cpu"

    # --test: evaluate the trained weights (--dckpt) on the test split
    run_downstream.main(["--config", cfg, *_flags(tmp_path / "exp2", "--test", "--dckpt",
                                                  str(run / "states-4.ckpt"))])
    out = capsys.readouterr().out
    assert "[runner] test dataset ready: 2 utterances" in out
    assert "[runner] evaluate: loss " in out and "[runner] step" not in out


def test_resume_restores_step_count_and_weights(corpus, tmp_path):
    cfg = _write_yaml(tmp_path / "cfg.yaml", _config(corpus))
    run_downstream.main(["--config", cfg, *_flags(tmp_path / "exp")])
    run = str(tmp_path / "exp" / "run")
    payload = load_checkpoint(run)
    # resume > CLI: the checkpoint's seed and objective win over the CLI's;
    # --device is the machine's and stays the CLI's
    args, config = run_downstream.get_downstream_args(
        ["--resume", run, "--seed", "99", "--objective", "L1", "--cpu"])
    assert args.seed == 3 and args.objective == "SISDR" and args.device == "cpu"
    assert args.resume.endswith("states-4.ckpt") and config == payload["Settings"]["Config"]
    config["runner"]["total_step"] = 5
    runner = run_downstream.build_runner(args, config)
    runner.set_model()
    assert runner.global_step == 4 and int(runner.state.step) == 4
    assert int(runner.state.opt_state["count"]) == 3
    sd = runner.downstream_model.state_dict()
    from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_to_state_dict

    assert all(torch.equal(sd[k], v) for k, v in flax_to_state_dict(
        payload["Downstream"]).items())
    runner.train()
    assert int(runner.state.opt_state["count"]) == 5 and runner.global_step == 6


def test_resume_from_a_jax_written_checkpoint(corpus, tmp_path):
    """Weights, moments and both counts come back from the optax state of a
    checkpoint the JAX package wrote."""
    cfg = _write_yaml(tmp_path / "cfg.yaml", _config(corpus, total_step=1))
    run_downstream.main(["--config", cfg, *_flags(tmp_path / "exp")])
    port = load_checkpoint(str(tmp_path / "exp" / "run"))
    params = jax.tree.map(jnp.asarray, port["Downstream"])
    opt = j_optim.build_optimizer("BertAdam", 1e-3, 0.07, 3)
    state = opt.init(params)
    for _ in range(2):
        _, state = opt.update(jax.tree.map(jnp.ones_like, params), state, params)
    jdir = tmp_path / "jax"
    j_save_checkpoint(str(jdir), 7, params, state, port["Settings"]["Config"],
                      port["Settings"]["Paras"])
    args, config = run_downstream.get_downstream_args(["--resume", str(jdir), "--cpu"])
    runner = run_downstream.build_runner(args, config)
    runner.set_model()
    assert runner.global_step == 7 and int(runner.state.opt_state["count"]) == 2
    mu = optimizer_state_from_payload(load_checkpoint(str(jdir))["Optimizer"], "cpu")["mu"]
    assert all(torch.equal(runner.state.opt_state["mu"][k], v) for k, v in mu.items())
    assert all(float(v.abs().max()) > 0 for v in mu.values())


def test_cli_file_lists_override_yaml(corpus, tmp_path):
    cfg = _write_yaml(tmp_path / "cfg.yaml", _config(corpus))
    args, config = run_downstream.get_downstream_args(
        ["--config", cfg, "--train_speech", "/elsewhere/speech", "--test_noise", "/n", "--cpu"])
    assert config["OnlineDataset_train"]["speech"]["filestrs"] == "/elsewhere/speech"
    assert config["OnlineDataset_train"]["speech"]["sample_num"] == 2  # the rest stays
    assert config["OnlineDataset_test"]["noise"]["filestrs"] == "/n"
    assert config["OnlineDataset_train"]["noise"]["filestrs"] == str(corpus / "noise")
    assert args.device == "cpu" and args.resume is None
    assert run_downstream.get_parser().parse_args([]).device == "cuda"


def test_pretrain_online_copy_matches_the_yaml():
    with open(os.path.join(REPO, "config", "pretrain_sample.yaml")) as f:
        assert yaml.safe_load(f)["online"] == run_downstream.PRETRAIN_ONLINE


def test_config_helpers_match_jax():
    import argparse

    old = argparse.Namespace(a=1, b=2, device="cpu")
    for new in ({"b": 3, "c": 4}, argparse.Namespace(b=5)):
        assert vars(t_config.update_args(old, new)) == vars(j_config.update_args(old, new))
    assert t_config.remove_self({"self": 0, "x": 1}) == j_config.remove_self({"self": 0, "x": 1})


@pytest.mark.parametrize("case,item", [
    ("--mesh=2x1", "A12"), ("--sync_sampler", "A9"), ("--active_sampling", "A9"),
    ("--sampler_device=0", "A9"), ("--profile", "A11"), ("media_step", "A7"),
    ("mode_query", "A9"), ("--test_gradient", "A9"), ("--ckpt2=up.ckpt", "A9"),
    ("--dropout2=0.1", "A9"), ("--compute_dtype=bf16", "A14"),
])
def test_runner_refuses_what_is_not_ported(corpus, tmp_path, case, item):
    config = _config(corpus)
    flags = _flags(tmp_path)
    if case == "media_step":
        config["runner"]["media_step"] = 4
    elif case.startswith("--"):
        flags.append(case)
    if case == "mode_query":
        config["runner"]["eval_splits"] = ["query_dev"]
    cfg = _write_yaml(tmp_path / "cfg.yaml", config)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        run_downstream.main(["--config", cfg, *flags])


def test_cuda_without_a_card_raises(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _write_yaml(tmp_path / "cfg.yaml", _config(corpus))
    args, config = run_downstream.get_downstream_args(
        ["--config", cfg, *_flags(tmp_path)[:-1], "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_downstream.build_runner(args, config)
    from speech_enhancement_by_s3prl_tpu_torch.runner.runner import Runner

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Runner(args, config, None, None, str(tmp_path), "cuda")


_NO_JAX_TRAIN = r"""
import importlib, os, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "speech_enhancement_by_s3prl_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
import speech_enhancement_by_s3prl_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
from speech_enhancement_by_s3prl_tpu_torch.run_downstream import main
main(sys.argv[2:])
print(sorted(mods))
print(sorted(os.listdir(os.path.join(sys.argv[1], "run"))))
"""


def test_port_trains_without_jax(corpus, tmp_path):
    cfg = _write_yaml(tmp_path / "cfg.yaml", _config(corpus, total_step=2))
    exp = tmp_path / "exp"
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_TRAIN, str(exp), "--config", cfg, *_flags(exp)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    mods, files = proc.stdout.strip().splitlines()[-2:]
    for name in ("objectives", "metrics", "runner.optim", "runner.runner", "run_downstream",
                 "data.datasets", "utils.config"):
        assert f"'speech_enhancement_by_s3prl_tpu_torch.{name}'" in mods
    assert "states-3.ckpt" in files and "scalars.jsonl" in files
