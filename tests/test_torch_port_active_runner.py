"""The active side of the port's Runner against the JAX package's on the
CPU, through both packages' CLIs on one tiny corpus with two tiny seeded
S3PRL upstreams: the pseudo wavs of ``_build_pseudo_wavs``, the media tags
and cadence and the losses of a sync-sampled run with ``--pseudo_clean`` /
``--pseudo_noise`` (one head's weights, every candidate matched, in both),
the similarities of ``--test_gradient`` and its ``sim_box.png``; the port's
async sampler through its Runner, and a sampler whose thread fails failing
the run; and config/active.yaml and config/pseudo_noise.yaml, their corpus
paths and step counts changed, trained at full width with
scripts/run_active.sh's flags on the CPU."""
import json
import os
import struct
import sys
import threading

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from speech_enhancement_by_s3prl_tpu.runner import runner as j_runner_mod
from speech_enhancement_by_s3prl_tpu.utils import plotting as j_plotting
from speech_enhancement_by_s3prl_tpu_torch import run_downstream
from speech_enhancement_by_s3prl_tpu_torch.active import sampler as t_sampler
from speech_enhancement_by_s3prl_tpu_torch.data.audio_io import write_wav
from speech_enhancement_by_s3prl_tpu_torch.runner import runner as t_runner_mod

SR = 16000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Pseudo wavs relative to their peak: the same f32 upstream (one transformer
# layer of 16), spec head, exp, inverse STFT and level renormalization, with
# sums in other orders
PSEUDO_RTOL = 1e-4
# The L1 training losses of the first steps from one head's weights: the
# same f32 forward and updates (measured 5e-8 relative; a wrong case drawn
# for the active batch moves them by 0.7)
LOSS_RTOL = 1e-6
# --test_gradient's cosines: f32 gradients of both packages (EMB_RTOL 1e-5 in
# tests/test_torch_port_active.py) through a normalized dot product
SIM_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops on one thread. In a test run of several
    workers every core is busy, and torch's default pool of a thread a core
    waits on threads descheduled for the other processes: measured, a 0.07 s
    scoring call took 4 s on 8 threads and 0.07 s on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _s3prl(path, seed, H=16, I=32):
    """A one-layer S3PRL TERA checkpoint over 80-d log-mel + delta input
    with the reference's online preprocessor."""
    g = torch.Generator().manual_seed(seed)
    t = lambda *shape: 0.2 * torch.randn(*shape, generator=g)
    ln = lambda p: {f"{p}.gamma": torch.ones(H), f"{p}.beta": torch.zeros(H)}
    enc = {"input_representations.spec_transform.weight": t(H, 80),
           "input_representations.spec_transform.bias": t(H),
           **ln("input_representations.LayerNorm")}
    for name, shape in (("attention.self.query", (H, H)), ("attention.self.key", (H, H)),
                        ("attention.self.value", (H, H)), ("attention.output.dense", (H, H)),
                        ("intermediate.dense", (I, H)), ("output.dense", (H, I))):
        enc[f"encoder.layer.0.{name}.weight"] = t(*shape)
        enc[f"encoder.layer.0.{name}.bias"] = t(shape[0])
    enc.update({**ln("encoder.layer.0.attention.output.LayerNorm"),
                **ln("encoder.layer.0.output.LayerNorm")})
    head = {"dense.weight": t(H, H), "dense.bias": t(H), **ln("LayerNorm"),
            "output.weight": 0.05 * t(201, H), "output.bias": t(201) - 3.0}
    config = {"transformer": {"hidden_size": H, "num_hidden_layers": 1,
                              "num_attention_heads": 2, "intermediate_size": I,
                              "hidden_dropout_prob": 0.1,
                              "attention_probs_dropout_prob": 0.1, "layer_norm_eps": "1e-12",
                              "input_dim": 80},
              "online": run_downstream.PRETRAIN_ONLINE}
    torch.save({"Transformer": enc, "SpecHead": head,
                "Settings": {"Config": config, "Paras": {}}}, path)
    return str(path)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """40 speech files and 3 noise files of 0.3-0.5 s, a list of the speech
    files repeated past 1000 lines (the active configs hold out their first
    1000), and two upstream checkpoints."""
    root = tmp_path_factory.mktemp("active")
    rng = np.random.default_rng(0)
    for sub, n in (("speech", 40), ("noise", 3)):
        os.makedirs(root / sub)
        for k in range(n):
            L = int(rng.uniform(0.3, 0.5) * SR)
            tt = np.arange(L) / SR
            tone = 0.1 * np.sin(2 * np.pi * (140 + 9 * k) * tt) if sub == "speech" else 0.0
            write_wav(str(root / sub / f"{sub}{k:02d}.wav"),
                      (tone + 0.03 * rng.standard_normal(L)).astype(np.float32), SR)
    files = sorted(os.listdir(root / "speech"))
    (root / "train.txt").write_text("".join(files[k % 40] + "\n" for k in range(1040)))
    ckpts = [_s3prl(root / f"up{k}.ckpt", k) for k in (1, 2)]
    return root, ckpts


def _active_yaml(root, name, steps, small=False):
    """config/{name}.yaml with its corpus paths at ``root`` and its step
    counts replaced; ``small`` also narrows the head and the batches for the
    runs held against the JAX package."""
    with open(os.path.join(REPO, "config", f"{name}.yaml")) as f:
        config = yaml.safe_load(f)
    config["OnlineDataset_train"]["speech"].update(filestrs=str(root / "train.txt"),
                                                   fileroot=str(root / "speech"))
    config["OnlineDataset_test"]["speech"]["filestrs"] = str(root / "speech")
    for split in ("OnlineDataset_train", "OnlineDataset_test"):
        config[split]["noise"]["filestrs"] = str(root / "noise")
    config["runner"].update(steps)
    if small:
        config["model"]["LSTM"].update(hidden_size=8, num_layers=2)
        config["dataloader"].update(batch_size=2, eval_batch_size=2, active_batch_size=3)
        config["runner"].update(active_query_num=2, eval_splits=[], eval_metrics=["sisdr"])
    path = root / f"{name}-{abs(hash(json.dumps(steps, sort_keys=True)))}-{small}.yaml"
    path.write_text(yaml.safe_dump(config))
    return str(path)


def _flags(root, ckpts, expdir, *extra):
    return ["--name", "run", "--expdir", str(expdir), "--ckpt", ckpts[0], "--ckpt2", ckpts[1],
            "--downstream", "LSTM", "--objective", "L1", "--from_rawfeature",
            "--record_num", "3", "--dev_num", "2", "--n_jobs", "1", "--seed", "3", "--cpu",
            *extra]


class _Recorder:
    """A stand-in for ``tensorboardX.SummaryWriter``."""

    def __init__(self, *args, **kwargs):
        self.calls = []

    def add_scalar(self, tag, value, global_step=None):
        self.calls.append(("scalar", global_step, tag, float(value)))

    def add_audio(self, tag, snd, global_step=None, sample_rate=SR):
        self.calls.append(("audio", global_step, tag, np.asarray(snd).reshape(-1).copy()))

    def add_figure(self, tag, figure, global_step=None):
        j_plotting.plt.close(figure)
        self.calls.append(("figure", global_step, tag, None))

    def flush(self):
        pass


def _run_both(root, ckpts, config, extra, capture):
    """The port's CLI and the JAX package's on the same flags, every
    candidate matched in both. Returns ({"port", "jax"}: what ``capture``
    (a Runner method name) returned or left on the Runner, the JAX
    recorder)."""
    import tensorboardX

    got = {}

    def watch(cls, key):
        inner = getattr(cls, capture)

        def wrapped(self, *a, **kw):
            result = inner(self, *a, **kw)
            got[key] = (result, self.pseudo_clean, self.pseudo_noise)
            return result
        return inner, wrapped

    ones = lambda q, t: (torch.ones(t.shape[0]) if isinstance(t, torch.Tensor)
                         else jnp.ones((t.shape[0],), jnp.float32))
    recorder = _Recorder()
    mp = pytest.MonkeyPatch()
    try:
        for cls, key in ((t_runner_mod.Runner, "port"), (j_runner_mod.Runner, "jax")):
            mp.setattr(cls, capture, watch(cls, key)[1])
        if "--test_gradient" not in extra:
            mp.setattr(t_runner_mod, "matching", ones)
            mp.setattr(j_runner_mod, "matching", ones)
        run_downstream.main(["--config", config, *_flags(root, ckpts, root / "port", *extra)])
        mp.setattr(tensorboardX, "SummaryWriter", lambda *a, **k: recorder)
        mp.setattr(j_plotting, "plot_spectrogram", lambda spec: j_plotting.plt.figure())
        mp.setattr(sys, "argv", ["run_downstream.py", "--config", config,
                                 *_flags(root, ckpts, root / "jax", *extra)])
        import run_downstream as j_run_downstream

        j_run_downstream.main()
    finally:
        mp.undo()
    return got, recorder


STEPS = {"total_step": 4, "log_step": 2, "eval_step": 100, "save_step": 100,
         "media_step": 2, "sampler_refresh_step": 3, "sampler_collect_step": 2,
         "active_refresh_step": 2}


@pytest.fixture(scope="module")
def dckpt(world):
    """One small head's weights, written by the port, that both packages
    start from (``--dckpt``)."""
    root, ckpts = world
    config = _active_yaml(root, "active", STEPS, small=True)
    args, cfg = run_downstream.get_downstream_args(
        ["--config", config, *_flags(root, ckpts, root / "init")])
    init = run_downstream.build_runner(args, cfg)
    init.set_model()
    init.save_model()
    return str(root / "init" / "run" / "states-1.ckpt")


@pytest.fixture(scope="module")
def sync_runs(world, dckpt):
    root, ckpts = world
    config = _active_yaml(root, "active", STEPS, small=True)
    got, recorder = _run_both(root, ckpts, config,
                              ["--sync_sampler", "--active_sampling", "--pseudo_clean",
                               "--pseudo_noise", "--dckpt", dckpt], "_build_pseudo_wavs")
    return root, got, recorder


def test_pseudo_wavs_match_jax(sync_runs):
    """Both upstreams' pseudo wavs of the record split, decoded with its
    noisy phase at -25 dB, one per record utterance at its length."""
    _, got, _ = sync_runs
    (_, pc, pn), (_, jpc, jpn) = got["port"], got["jax"]
    assert len(pc) == len(jpc) == len(pn) == len(jpn) == 3
    for a, b in zip(pc + pn, jpc + jpn):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == np.float32
        assert np.abs(a - b).max() <= PSEUDO_RTOL * np.abs(b).max()
    assert not np.allclose(pc[0], pn[0])  # two upstreams, two waveforms


def test_media_tags_and_cadence_match_jax(sync_runs):
    """``record/*`` at step 1, then at each media step the query and the
    matches of the sync sampler, the train batch's channels and its pseudo
    wavs: the JAX Runner's (step, tag) list, a WAV and a PNG for each of its
    audio and figure calls."""
    root, _, recorder = sync_runs
    with open(root / "port" / "run" / "media.jsonl") as f:
        index = [json.loads(line) for line in f]
    jax_media = [(c[1], c[2]) for c in recorder.calls if c[0] != "scalar"]
    assert [(m["step"], m["tag"]) for m in index] == jax_media
    tags = [t for s, t in jax_media if s == 2]
    assert tags == [f"{p}{ch}.{ext}" for p in ("active/query_", "active/match_", "")
                    for ch in ("noisy", "clean", "noise") for ext in ("wav", "png")] + [
        f"pseudo_{k}.{ext}" for k in ("clean", "noise") for ext in ("wav", "png")]
    assert [t for s, t in jax_media if s == 1] == [
        f"record/{k}.{ext}" for k in ("noisy", "clean", "noise", "pseudo_clean",
                                      "pseudo_noise") for ext in ("wav", "png")]
    assert {s for s, _ in jax_media} == {1, 2, 4}
    for m in index:
        assert os.path.getsize(root / "port" / "run" / m["path"]) > 44


def test_sync_sampled_losses_match_jax(sync_runs):
    """From one head's weights, the logged training losses of the
    sync-sampled run: the same candidates matched, merged across steps and
    resampled by case (``--active_sampling``), so the same batches train."""
    root, _, recorder = sync_runs
    with open(root / "port" / "run" / "scalars.jsonl") as f:
        losses = [(s["step"], s["value"]) for s in map(json.loads, f) if s["tag"] == "loss"]
    jlosses = [(c[1], c[3]) for c in recorder.calls if c[0] == "scalar" and c[2] == "loss"]
    assert [s for s, _ in losses] == [s for s, _ in jlosses] == [2, 4]
    np.testing.assert_allclose([v for _, v in losses], [v for _, v in jlosses],
                               rtol=LOSS_RTOL)


def test_test_gradient_matches_jax_and_draws_the_box_plot(world, dckpt):
    """Both packages from one head's weights (``--dckpt``, written by the
    port): the same batches and the same cosines by case."""
    root, ckpts = world
    config = _active_yaml(root, "active", STEPS, small=True)
    got, _ = _run_both(root, ckpts, config, ["--test_gradient", "--n_iterate", "2",
                                             "--dckpt", dckpt], "test_gradient")
    sims, jsims = got["port"][0], got["jax"][0]
    assert sorted(sims) == sorted(jsims) and sum(map(len, sims.values())) == 4
    for case in sims:
        np.testing.assert_allclose(sims[case], jsims[case], atol=SIM_ATOL)
    png = (root / "port" / "run" / "sim_box.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and png[12:16] == b"IHDR"
    width, height = struct.unpack(">II", png[16:24])
    assert (height, width) == (240, 20 + 4 * 60)


def test_async_sampler_through_the_runner(world, monkeypatch):
    """``--sampler_device 0`` on the CPU: the sampler starts, is drained at
    ``sampler_collect_step`` (steps 2, 4 and 6, here with samples: every
    candidate matched, and the step before a collect waits for the thread),
    stopped at ``sampler_refresh_step`` (4) and started again at the next
    step, and stopped at the end."""
    root, ckpts = world
    steps = {**STEPS, "total_step": 6, "sampler_refresh_step": 4, "media_step": 100}
    config = _active_yaml(root, "active", steps, small=True)
    monkeypatch.setattr(t_sampler, "matching", lambda q, t: torch.ones(t.shape[0]))
    collected, starts = [], []
    collect, start = t_sampler.AsyncSampler.collect, t_sampler.AsyncSampler.start
    monkeypatch.setattr(t_sampler.AsyncSampler, "collect",
                        lambda self: collected.append(collect(self)) or collected[-1])
    monkeypatch.setattr(t_sampler.AsyncSampler, "start",
                        lambda self: starts.append(self) or start(self))
    args, cfg = run_downstream.get_downstream_args(
        ["--config", config, *_flags(root, ckpts, root / "async", "--active_sampling",
                                     "--sampler_device", "0")])
    runner = run_downstream.build_runner(args, cfg)
    runner.set_model()
    train_step = runner.train_step

    def step(state, wavs, lengths):
        if (runner.global_step + 1) % steps["sampler_collect_step"] == 0:
            for _ in range(400):
                if runner.sampler is None or any(runner.sampler._buffers.values()):
                    break
                runner.sampler._stop.wait(0.05)
        return train_step(state, wavs, lengths)

    runner.train_step = step
    runner.train()
    assert runner.global_step == steps["total_step"] + 1 and runner.sampler is None
    assert len(starts) == 2 and all(not s.alive for s in starts)
    assert len(collected) == 3 and all(sum(map(len, c.values())) > 0 for c in collected)
    assert all(len(v) <= 4 for c in collected for v in c.values())  # sampler_sample_num 10


def test_a_failing_async_sampler_fails_the_run(world, monkeypatch):
    """An error on the sampler's thread ends the training with that error:
    the Runner neither restarts a dead sampler nor drops what killed it."""
    root, ckpts = world
    config = _active_yaml(root, "active", {**STEPS, "media_step": 100}, small=True)
    args, cfg = run_downstream.get_downstream_args(
        ["--config", config, *_flags(root, ckpts, root / "failing", "--active_sampling",
                                     "--sampler_device", "0")])
    runner = run_downstream.build_runner(args, cfg)
    runner.set_model()
    scoring_fn = runner._scoring_fn

    def failing():
        inner = scoring_fn()

        def scoring(model, wavs, lengths, **kw):
            if threading.current_thread() is not threading.main_thread():
                raise ArithmeticError("scoring failed on the sampler's thread")
            return inner(model, wavs, lengths, **kw)
        return scoring

    starts = []
    start = t_sampler.AsyncSampler.start
    monkeypatch.setattr(t_sampler.AsyncSampler, "start",
                        lambda self: starts.append(self) or start(self))
    runner._scoring_fn = failing
    with pytest.raises(RuntimeError, match="sampler's thread failed") as info:
        runner.train()
    assert isinstance(info.value.__cause__, ArithmeticError)
    assert len(starts) == 1 and runner.sampler is None
    assert runner.global_step <= STEPS["total_step"]


@pytest.mark.parametrize("name,extra,steps", [
    ("active", ["--eval_init", "--save_best"], {"total_step": 2, "log_step": 1,
                                                "eval_step": 100, "save_step": 100}),
    ("pseudo_noise", [], {"total_step": 1, "log_step": 1, "eval_step": 100,
                          "save_step": 100}),
])
def test_the_active_configs_train_at_full_width_on_the_cpu(world, name, extra, steps):
    """The shipped configs, corpus paths and step counts changed, with
    scripts/run_active.sh's flags (``--eval_init --save_best`` on
    active.yaml): LSTM 3 x 256 bidirectional over 120-d log-mel + 2 deltas,
    the sync sampler scoring 12 candidates against 32 query rows a step."""
    root, ckpts = world
    config = _active_yaml(root, name, steps)
    expdir = root / f"full_{name}"
    run_downstream.main(["--config", config, *_flags(root, ckpts, expdir, "--active_sampling",
                                                     "--sync_sampler", *extra)])
    with open(expdir / "run" / "scalars.jsonl") as f:
        scalars = [json.loads(line) for line in f]
    losses = [s["value"] for s in scalars if s["tag"] == "loss"]
    assert len(losses) == steps["total_step"] and np.isfinite(losses).all()
    if name == "active":
        evals = [s["tag"] for s in scalars if s["tag"].endswith("_loss")]
        assert evals == [f"{split}_loss" for split in ("subtrain", "dev", "query_dev", "test")]
    assert os.path.exists(expdir / "run" / f"states-{steps['total_step'] + 1}.ckpt")
