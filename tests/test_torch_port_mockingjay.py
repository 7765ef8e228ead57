"""The port's upstream slice against the JAX package, end to end on the CPU.

``Mockingjay`` joint finetuning (the whole TERA encoder and its spec head
trained ``from_waveform``) against the JAX ``train_step_raw``: a 3-step
trajectory at rate 0, and 2 steps with dropout live, the JAX side under
``SE_ATTN_IMPL=flash SE_HIDDEN_DROPOUT_IMPL=hash`` (its flash kernel in
interpret mode) and the port replaying the salts the un-jitted JAX step drew.
Then the eval step; the upstream mode (a frozen ``UpstreamTransformer`` from
an S3PRL checkpoint into a ``Residual`` head) train step and the serving of a
checkpoint the JAX package wrote; a ``run_downstream --downstream Mockingjay
--from_waveform`` run through the CLI with a resume; and that run in a
process where jax, flax and the JAX package cannot be imported.

Small widths throughout: hidden 32, 4 heads, 2 layers, FFN 64, 1 s clips
(101 frames).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import yaml

import __graft_entry__ as graft
import serve as j_serve
from speech_enhancement_by_s3prl_tpu.models import heads as j_heads
from speech_enhancement_by_s3prl_tpu.models import spec_head as j_spec
from speech_enhancement_by_s3prl_tpu.models import transformer as j_tf
from speech_enhancement_by_s3prl_tpu.models import upstream as j_up
from speech_enhancement_by_s3prl_tpu.runner import optim as j_optim
from speech_enhancement_by_s3prl_tpu.runner.checkpoint import (
    save_checkpoint as j_save_checkpoint,
)
from speech_enhancement_by_s3prl_tpu_torch import entry, run_downstream, serve
from speech_enhancement_by_s3prl_tpu_torch.data import audio_io
from speech_enhancement_by_s3prl_tpu_torch.models import heads as t_heads
from speech_enhancement_by_s3prl_tpu_torch.models import transformer as t_tf
from speech_enhancement_by_s3prl_tpu_torch.models import upstream as t_up
from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_to_state_dict
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import attention_kernel
from speech_enhancement_by_s3prl_tpu_torch.runner import optim
from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import load_checkpoint
from tests.test_torch_port_transformer import SaltRecorder, _s3prl_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
SMALL = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=64)
# heads of 16, a width between the card's flash kernel instances (it runs them
# zero-padded to 32)
HEADS_OF_16 = dict(SMALL, hidden_size=128, num_attention_heads=8, num_hidden_layers=1)
LR, TOTAL = 1e-3, 10  # a short schedule, so that the updates are not tiny
# Loss and gradient norm: the same f32 pipeline (STFT, log-mel + delta,
# CMVN, 2 transformer layers, spec head, SISDR) with sums in other orders.
LOSS_RTOL = 1e-5
# Parameters after each update (~0.02 in size, updates ~lr): f32 rounding of
# the update, normalized by Adam, stays far below this.
PARAM_ATOL = 1e-6
# Waveforms renormalized to -25 dB, relative to their RMS (as the enhance
# slice's tests hold them).
WAV_TOL = 5e-5


def _batch(seed, n=SR):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    clean = (0.1 * np.sin(2 * np.pi * (200 + 50 * np.arange(2))[:, None] * t)
             + 0.01 * rng.standard_normal((2, n)))
    noise = 0.1 * rng.standard_normal((2, n))
    wavs = np.stack([clean + noise, clean, noise], axis=1).astype(np.float32)
    return wavs, np.array([n, n * 3 // 4])


def _configs(rate, width=SMALL):
    cfg = dict(width, input_dim=80, hidden_dropout_prob=rate,
               attention_probs_dropout_prob=rate)
    return j_tf.TransformerConfig(**cfg), t_tf.TransformerConfig(**cfg)


def _jax_mockingjay(jcfg):
    """The JAX Mockingjay joint finetune (bench.py's builder at small width)
    and its initial state."""
    builder = dataclasses.replace(
        graft._build(delta=1), model=j_spec.Mockingjay(output_size=201, config=jcfg),
        from_waveform=True, from_rawfeature=False, donate=False,
        optimizer=j_optim.build_optimizer("BertAdam", LR, 0.07, TOTAL))
    wavs, lengths = _batch(0)
    state = builder.init_state(jax.random.PRNGKey(0), jnp.asarray(wavs),
                               jnp.asarray(lengths))
    return builder, jax.device_get(state)


def _port_mockingjay(tcfg, params):
    builder = dataclasses.replace(
        entry.build_mockingjay_train(tcfg, device="cpu"),
        optimizer=optim.build_optimizer("BertAdam", LR, 0.07, TOTAL))
    builder.model.load_state_dict(flax_to_state_dict(params))
    return builder


def _assert_params_close(port_model, jax_params):
    ref = flax_to_state_dict(jax.device_get(jax_params))
    got = port_model.state_dict()
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=k)


def _assert_stats_close(stats, jstats):
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(stats[key]), float(jstats[key]), rtol=LOSS_RTOL,
                                   err_msg=key)
    assert not bool(stats["skipped"]) and not bool(jstats["skipped"])


def test_mockingjay_trajectory_at_rate_0_matches_jax():
    """Three steps from identical weights and batches at dropout rate 0:
    loss, gradient norm and every parameter after each step."""
    jcfg, tcfg = _configs(0.0)
    builder, state = _jax_mockingjay(jcfg)
    step = jax.jit(builder.train_step_raw())
    port = _port_mockingjay(tcfg, state.params)
    pstate = port.init_state()
    attention_kernel.flash_attention_fwd.launches = 0
    for k in range(3):
        wavs, lengths = _batch(k)
        state, jstats = step(state, jnp.asarray(wavs), jnp.asarray(lengths),
                             jax.random.PRNGKey(0), None)
        pstate, stats = port.train_step(pstate, torch.from_numpy(wavs),
                                        torch.from_numpy(lengths))
        _assert_stats_close(stats, jstats)
        _assert_params_close(port.model, state.params)
    assert int(pstate.step) == int(state.step) == 3 and pstate.host_step == 3
    assert int(pstate.opt_state["count"]) == 3
    # rate 0 takes the SDPA route: no flash call at all
    assert attention_kernel.flash_attention_fwd.launches == 0


@pytest.mark.parametrize("width", [SMALL, HEADS_OF_16], ids=["heads_of_8", "heads_of_16"])
def test_mockingjay_steps_with_live_dropout_match_jax(monkeypatch, width):
    """Two steps with both dropout rates at 0.1. The un-jitted JAX step
    draws 1 + 3 L salts a step (input, then per layer attention probs,
    attention output, FFN output); the port replays them. Also at 8 heads of
    16, the width the card runs on zero-padded heads."""
    monkeypatch.setenv("SE_ATTN_IMPL", "flash")
    monkeypatch.setenv("SE_HIDDEN_DROPOUT_IMPL", "hash")
    jcfg, tcfg = _configs(0.1, width)
    builder, state = _jax_mockingjay(jcfg)
    step = builder.train_step_raw()
    port = _port_mockingjay(tcfg, state.params)
    pstate = port.init_state()
    rec = SaltRecorder(monkeypatch)
    for k in range(2):
        wavs, lengths = _batch(10 + k)
        rec.salts.clear()
        state, jstats = step(state, jnp.asarray(wavs), jnp.asarray(lengths),
                             jax.random.PRNGKey(5), None)
        assert len(rec.salts) == 1 + 3 * width["num_hidden_layers"]
        salts = t_tf.SaltStream(salts=list(rec.salts))
        pstate, stats = port.train_step(pstate, torch.from_numpy(wavs),
                                        torch.from_numpy(lengths), salts=salts)
        assert salts.drawn == len(rec.salts)
        _assert_stats_close(stats, jstats)
        _assert_params_close(port.model, state.params)


def test_mockingjay_salts_follow_seed_and_step():
    """Without replayed salts a step draws them from (seed, step): the same
    step from the same state gives the same update, the next step another
    mask."""
    _, tcfg = _configs(0.1)
    wavs, lengths = (torch.from_numpy(x) for x in _batch(3))
    results = []
    for host_step in (4, 4, 5):
        builder = entry.build_mockingjay_train(tcfg, device="cpu", seed=7,
                                               generator=torch.Generator().manual_seed(0))
        state = builder.init_state()
        state.host_step = host_step
        _, stats = builder.train_step(state, wavs, lengths)
        results.append(float(stats["loss"]))
    assert results[0] == results[1] != results[2]


def test_mockingjay_eval_step_matches_jax():
    jcfg, tcfg = _configs(0.1)  # eval: dropout off whatever the rates
    builder, state = _jax_mockingjay(jcfg)
    wavs, lengths = _batch(5)
    ref = jax.jit(builder.eval_step_raw("first"))(
        state.params, jnp.asarray(wavs), jnp.asarray(lengths), None)
    port = _port_mockingjay(tcfg, state.params)
    out = port.eval_step(torch.from_numpy(wavs), torch.from_numpy(lengths), wav_out="first")
    np.testing.assert_allclose(float(out["loss"]), float(ref["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(out["scores"]["sisdr"].numpy(),
                               np.asarray(ref["scores"]["sisdr"]), rtol=0, atol=1e-3)
    for key in ("wav_predicted", "wav_inp", "wav_tar"):
        got, want = out[key].numpy(), np.asarray(ref[key])
        assert got.shape == want.shape == (1, wavs.shape[-1])
        assert np.abs(got - want).max() <= WAV_TOL * np.sqrt(np.mean(want ** 2)), key


# -- the upstream mode ------------------------------------------------------------

RESIDUAL = {"hidden_size": 8, "num_layers": 1, "bidirectional": True,
            "activation": "Sigmoid", "cmvn": False}


@pytest.fixture(scope="module")
def s3prl_ckpt(tmp_path_factory):
    """A synthetic S3PRL pretraining checkpoint at small width: 80-d log-mel
    + delta input, 201-bin log-linear target, gamma/beta LayerNorms."""
    rng = np.random.default_rng(21)
    enc, head = _s3prl_state(rng, D_in=80, out=201)
    enc = {k: v * 0.2 for k, v in enc.items()}  # keep the logits moderate
    config = {"transformer": {**SMALL, "input_dim": 80, "layer_norm_eps": "1e-12"},
              "online": run_downstream.PRETRAIN_ONLINE}
    path = str(tmp_path_factory.mktemp("s3prl") / "states-1000.ckpt")
    torch.save({"Transformer": enc, "SpecHead": head,
                "Settings": {"Config": config, "Paras": {}}}, path)
    return path


def test_upstream_mode_train_step_and_serving_match_jax(s3prl_ckpt, tmp_path):
    """A frozen upstream (``--upstream transformer --ckpt``) feeds a
    ``Residual`` head: two train steps against the JAX step, then a
    checkpoint the JAX package wrote is served by both packages."""
    jup = j_up.build_upstream("transformer", 80, s3prl_ckpt)
    jhead = j_heads.build_head("Residual", input_size=32, output_size=201, **RESIDUAL)
    jb = dataclasses.replace(
        graft._build(delta=1), model=jhead, upstream=jup, from_rawfeature=False,
        donate=False, optimizer=j_optim.build_optimizer("BertAdam", LR, 0.07, TOTAL))
    wavs, lengths = _batch(0)
    state = jax.device_get(jb.init_state(jax.random.PRNGKey(1), jnp.asarray(wavs),
                                         jnp.asarray(lengths)))
    jstep = jax.jit(jb.train_step_raw())

    pup = t_up.build_upstream("transformer", 80, s3prl_ckpt)
    assert not pup.trainable
    phead = t_heads.build_head("Residual", input_size=32, output_size=201, **RESIDUAL)
    phead.load_state_dict(flax_to_state_dict(state.params))
    pb = dataclasses.replace(
        entry.build_train(device="cpu", hidden_size=8, num_layers=1), model=phead,
        upstream=pup, from_rawfeature=False,
        optimizer=optim.build_optimizer("BertAdam", LR, 0.07, TOTAL))
    pstate = pb.init_state()
    assert not any(k.startswith("encoder") for k in pstate.params)  # frozen
    for k in range(2):
        wavs, lengths = _batch(k)
        state, jstats = jstep(state, jnp.asarray(wavs), jnp.asarray(lengths),
                              jax.random.PRNGKey(0), jb.upstream_params())
        pstate, stats = pb.train_step(pstate, torch.from_numpy(wavs),
                                      torch.from_numpy(lengths))
        _assert_stats_close(stats, jstats)
        _assert_params_close(phead, state.params)

    config = {"preprocessor": {"baseline": {"feat_type": "mel", "log": True, "delta": 2,
                                            "cmvn": False}},
              "model": {"Residual": RESIDUAL}}
    paras = {"downstream": "Residual", "upstream": "transformer", "ckpt": s3prl_ckpt,
             "from_rawfeature": False, "from_waveform": False}
    path = j_save_checkpoint(str(tmp_path), 2, state.params, state.opt_state, config, paras)
    audio = [_batch(7)[0][0, 0, :12000], _batch(8)[0][0, 0, :9000]]
    ref = j_serve.build_enhancer(path, SR, -25.0).run_batch(audio)
    got = serve.build_enhancer(path, device="cpu").run_batch(audio)
    for r, g in zip(ref, got):
        assert g.shape == r.shape and np.isfinite(g).all()
        assert np.abs(g - r).max() <= WAV_TOL * np.sqrt(np.mean(r ** 2))


def test_upstream_dropout_override_runs_the_upstream_in_train_mode(s3prl_ckpt):
    """``--dropout`` makes the upstream trainable: in a train step its
    dropout is live (salts drawn) while its weights stay out of the
    gradient; in eval it runs deterministically."""
    pup = t_up.build_upstream("transformer", 80, s3prl_ckpt, dropout=0.2)
    assert pup.trainable and pup.config.attention_probs_dropout_prob == 0.2
    phead = t_heads.build_head("Residual", input_size=32, output_size=201, **RESIDUAL)
    pb = dataclasses.replace(entry.build_train(device="cpu", hidden_size=8, num_layers=1),
                             model=phead, upstream=pup, from_rawfeature=False)
    state = pb.init_state()
    wavs, lengths = (torch.from_numpy(x) for x in _batch(2))
    salts = t_tf.SaltStream(seed=1)
    before = {k: v.clone() for k, v in pup.state_dict().items()}
    _, stats = pb.train_step(state, wavs, lengths, salts=salts)
    assert salts.drawn == 1 + 3 * SMALL["num_hidden_layers"] and torch.isfinite(stats["loss"])
    assert all(torch.equal(before[k], v) for k, v in pup.state_dict().items())
    a = pb.eval_step(wavs, lengths)["loss"]
    b = pb.eval_step(wavs, lengths)["loss"]
    assert not pup.training and float(a) == float(b)


# -- the CLI --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """6 speech files of 0.5-1.2 s and 2 noise files of 1-1.5 s."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(3)
    for sub, n, lo, hi in (("speech", 6, 0.5, 1.2), ("noise", 2, 1.0, 1.5)):
        os.makedirs(root / sub)
        for k in range(n):
            L = int(rng.uniform(lo, hi) * SR)
            t = np.arange(L) / SR
            tone = 0.1 * np.sin(2 * np.pi * (150 + 30 * k) * t) if sub == "speech" else 0
            wav = (tone + 0.03 * rng.standard_normal(L)).astype(np.float32)
            audio_io.write_wav(str(root / sub / f"{k}.wav"), wav, SR)
    return root


def _cli_config(corpus, total_step=3):
    data = {"sample_rate": SR, "max_time": 1000, "target_level": -25}
    return {
        "dataloader": {"batch_size": 2, "eval_batch_size": 4},
        "preprocessor": {"input_channel": 0, "target_channel": 1,
                         "baseline": {"feat_type": "mel", "log": True, "delta": 2,
                                      "cmvn": False}},
        "runner": {"learning_rate": 1e-3, "warmup_proportion": 0.07,
                   "gradient_clipping": 1.0, "total_step": total_step, "log_step": 1,
                   "eval_step": 2, "save_step": 2, "max_keep": 2,
                   "eval_splits": ["dev"], "eval_metrics": ["sisdr"]},
        "objective": {"SISDR": {}},
        "model": {"Mockingjay": {"config": dict(SMALL)}},
        "OnlineDataset_train": {"speech": {"filestrs": str(corpus / "speech"),
                                           "sample_num": 2},
                                "noise": {"filestrs": str(corpus / "noise")},
                                "snrs": [-5, 0, 5], "infinite": True, **data},
        "OnlineDataset_test": {"speech": {"filestrs": str(corpus / "speech"),
                                          "sample_num": 2, "select_sampled": True},
                               "noise": {"filestrs": str(corpus / "noise")},
                               "snrs": [0], "half_noise": "end", **data},
    }


def _cli_flags(expdir):
    return ["--name", "mj", "--expdir", str(expdir), "--downstream", "Mockingjay",
            "--objective", "SISDR", "--from_waveform", "--dev_num", "2", "--n_jobs", "2",
            "--seed", "5", "--device", "cpu"]


def _write_yaml(path, config):
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return str(path)


def test_mockingjay_cli_trains_resumes_and_serves(corpus, tmp_path, capsys):
    cfg = _write_yaml(tmp_path / "cfg.yaml", _cli_config(corpus))
    run_downstream.main(["--config", cfg, *_cli_flags(tmp_path / "exp")])
    out = capsys.readouterr().out
    run = tmp_path / "exp" / "mj"
    for step in (1, 2, 3):
        assert f"[runner] step {step}/3 | loss " in out
    assert "[runner] evaluate: loss " in out
    payload = load_checkpoint(str(run))
    assert payload["Global_step"] == 4 and int(payload["Optimizer"]["count"]) == 3
    tree = payload["Downstream"]["params"]
    assert set(tree) == {"mockingjay", "spechead"}
    assert tree["mockingjay"]["layer_1"]["attention"]["qkv"]["kernel"].shape == (32, 96)
    assert "scale" in tree["mockingjay"]["input_ln"]

    # resume for two more steps: step, optimizer count and the salt stream's
    # step come back
    args, config = run_downstream.get_downstream_args(["--resume", str(run), "--cpu"])
    config["runner"]["total_step"] = 5
    runner = run_downstream.build_runner(args, config)
    runner.set_model()
    assert runner.global_step == 4 and runner.state.host_step == 4
    assert int(runner.state.opt_state["count"]) == 3
    runner.train()
    assert int(runner.state.opt_state["count"]) == 5 and runner.global_step == 6
    scalars = [json.loads(ln) for ln in (run / "scalars.jsonl").read_text().splitlines()]
    assert all(np.isfinite(s["value"]) for s in scalars)

    # the from_waveform checkpoint serves, on the upstream-input features
    enhancer = serve.build_enhancer(str(run), device="cpu")
    wav = _batch(9)[0][0, 0, :8000]
    enhanced = enhancer(wav)
    assert enhanced.shape == wav.shape and np.isfinite(enhanced).all()


def test_torch_downstream_checkpoint_warm_starts_like_jax(corpus, tmp_path):
    """``--dckpt`` of a torch (S3PRL-format) downstream checkpoint: its
    settings (an argparse namespace) shape the head, and its nn.LSTM /
    Sequential weights land in the port's head as the JAX importer maps
    them."""
    import argparse

    from speech_enhancement_by_s3prl_tpu.models import torch_import as j_import

    gen = torch.Generator().manual_seed(4)
    lstm = torch.nn.LSTM(120, 8, num_layers=1, bidirectional=True, batch_first=True)
    with torch.no_grad():
        for p in lstm.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    sd = {**{f"lstm.{k}": v for k, v in lstm.state_dict().items()},
          "scaling_layer.0.weight": torch.randn(201, 16, generator=gen),
          "scaling_layer.0.bias": torch.randn(201, generator=gen)}
    dconfig = {"preprocessor": {"baseline": {"feat_type": "mel", "log": True, "delta": 2,
                                             "cmvn": False}},
               "model": {"Residual": RESIDUAL}}
    dckpt = str(tmp_path / "downstream.ckpt")
    torch.save({"Downstream": sd, "Settings": {
        "Config": dconfig, "Paras": argparse.Namespace(downstream="Residual")}}, dckpt)
    config = _cli_config(corpus)
    config["model"] = {"Residual": dict(RESIDUAL, hidden_size=99)}  # the dckpt's wins
    args, config = run_downstream.get_downstream_args(
        ["--config", _write_yaml(tmp_path / "cfg.yaml", config), "--name", "warm",
         "--expdir", str(tmp_path / "exp"), "--downstream", "Residual", "--objective",
         "SISDR", "--from_rawfeature", "--dckpt", dckpt, "--device", "cpu"])
    runner = run_downstream.build_runner(args, config)
    runner.set_model()
    want = flax_to_state_dict(j_import.convert_downstream_state(sd, "Residual"))
    got = runner.downstream_model.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


_NO_JAX_MOCKINGJAY = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "speech_enhancement_by_s3prl_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
import speech_enhancement_by_s3prl_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
from speech_enhancement_by_s3prl_tpu_torch.run_downstream import main
main(sys.argv[1:])
print(sorted(mods))
"""


def test_mockingjay_trains_without_jax(corpus, tmp_path):
    cfg = _write_yaml(tmp_path / "cfg.yaml", _cli_config(corpus, total_step=1))
    exp = tmp_path / "exp"
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_MOCKINGJAY, "--config", cfg, *_cli_flags(exp)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    mods = proc.stdout.strip().splitlines()[-1]
    for name in ("models.transformer", "models.spec_head", "models.upstream",
                 "models.torch_import", "ops.cuda.attention_kernel", "serve", "entry"):
        assert f"'speech_enhancement_by_s3prl_tpu_torch.{name}'" in mods
    assert (exp / "mj" / "states-2.ckpt").exists()
