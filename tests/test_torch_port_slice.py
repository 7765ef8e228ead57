"""The port's enhance slice against the JAX package, end to end on the CPU:
the flagship enhance closure, checkpoints written by either package and
served by both, the micro-batcher, the batch CLI, and a run of the port in
a process where jax, flax and the JAX package cannot be imported."""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
import serve as j_serve
from speech_enhancement_by_s3prl_tpu.data import loader as j_loader
from speech_enhancement_by_s3prl_tpu.runner.checkpoint import (
    load_checkpoint as j_load_checkpoint,
    save_checkpoint as j_save_checkpoint,
)
from speech_enhancement_by_s3prl_tpu_torch import entry, serve
from speech_enhancement_by_s3prl_tpu_torch.data import audio_io, loader
from speech_enhancement_by_s3prl_tpu_torch.enhance import main as enhance_cli
from speech_enhancement_by_s3prl_tpu_torch.models.convert import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda.lstm_kernel import lstm_bidir_tm
from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(hidden_size=16, num_layers=2)
# Waveforms renormalized to -25 dB. Both sides run the same f32 pipeline
# (STFT, log-mel + deltas, two BLSTM layers, Dense, sigmoid mask, iSTFT,
# renorm) with sums in other orders; the differences stay at f32 rounding
# of the output, ~1e-6 of its RMS. The limit leaves a decade and a half.
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
def jax_small():
    """The JAX flagship at hidden 16, 2 layers, Pallas recurrence on (in
    interpret mode on the CPU), with its initialized parameters."""
    builder = graft._build(use_pallas=True, **SMALL)
    wavs = jnp.zeros((1, 3, 4800), jnp.float32)
    state = builder.init_state(jax.random.PRNGKey(0), wavs, jnp.full((1,), 4800))
    return builder, jax.device_get(state.params), jax.device_get(state.opt_state)


@pytest.fixture(scope="module")
def ckpts(jax_small, tmp_path_factory):
    """The same weights saved by the JAX package and by the port."""
    _, params, opt_state = jax_small
    config, paras = entry.flagship_settings(**SMALL)
    jdir = tmp_path_factory.mktemp("jax_ckpt")
    j_save_checkpoint(str(jdir), 3, params, opt_state, config, paras)
    _, model = entry.build(device="cpu", **SMALL)
    model.load_state_dict(flax_to_state_dict(params))
    pdir = tmp_path_factory.mktemp("port_ckpt")
    save_checkpoint(str(pdir), 3, model, None, config, paras)
    return {"jax": str(jdir), "port": str(pdir)}


def test_entry_enhance_matches_jax(jax_small):
    builder, params, _ = jax_small
    rng = np.random.default_rng(0)
    wavs = (0.3 * rng.standard_normal((2, 3, 6400))).astype(np.float32)
    lengths = np.array([6400, 5000], np.int32)
    ref = jax.jit(graft.make_enhance(builder))(
        params, jnp.asarray(wavs), jnp.asarray(lengths)
    )
    pre, model = entry.build(device="cpu", **SMALL)
    model.load_state_dict(flax_to_state_dict(params))
    out = entry.make_enhance(pre, model)(
        torch.from_numpy(wavs), torch.from_numpy(lengths).long()
    )
    assert out.shape == (2, 6400)
    assert _rel(out.numpy(), ref) < WAV_TOL


ONE_DIRECTION = dict(hidden_size=16, num_layers=3, bidirectional=False)


def test_one_direction_head_enhance_and_grads_match_jax(tmp_path):
    """A one-direction 3-layer head (the shape config/vcb.yaml ships, narrow)
    against the JAX package, which runs its lax.scan cell there: the enhanced
    waveform through both entry points, the port's checkpoint served, and the
    head's parameter gradients."""
    jax_side = graft._build(use_pallas=True, **ONE_DIRECTION)
    rng = np.random.default_rng(1)
    wavs = (0.3 * rng.standard_normal((2, 3, 6400))).astype(np.float32)
    lengths = np.array([6400, 5000], np.int32)
    state = jax_side.init_state(jax.random.PRNGKey(4), jnp.asarray(wavs),
                               jnp.asarray(lengths))
    params = jax.device_get(state.params)
    ref = jax.jit(graft.make_enhance(jax_side))(params, jnp.asarray(wavs),
                                               jnp.asarray(lengths))
    pre, model = entry.build(device="cpu", **ONE_DIRECTION)
    model.load_state_dict(flax_to_state_dict(params))
    assert not any("_bwd" in k for k in model.state_dict())
    lstm_bidir_tm.launches = 0
    out = entry.make_enhance(pre, model)(torch.from_numpy(wavs),
                                         torch.from_numpy(lengths).long())
    assert out.shape == (2, 6400) and lstm_bidir_tm.launches == 0
    assert _rel(out.numpy(), ref) < WAV_TOL

    config, paras = entry.flagship_settings(**ONE_DIRECTION)
    save_checkpoint(str(tmp_path), 1, model, None, config, paras)
    served = serve.build_enhancer(str(tmp_path), device="cpu")
    j_served = j_serve.build_enhancer(str(tmp_path), 16000, -25.0)
    request = _audio(5000, 3)
    assert _rel(served(request), np.asarray(j_served(request))) < WAV_TOL

    # the head's gradients: LstmBidirTm with one direction against jax.grad
    # through LstmCellScan
    feats = rng.standard_normal((2, 21, 12)).astype(np.float32)
    linears = np.abs(rng.standard_normal((2, 21, 10))).astype(np.float32)
    wts = np.cos(np.arange(2 * 21 * 10).reshape(2, 21, 10) * 0.01).astype(np.float32)
    cfg = dict(activation="Sigmoid", cmvn=False, **ONE_DIRECTION)
    from speech_enhancement_by_s3prl_tpu.models import heads as j_heads
    from speech_enhancement_by_s3prl_tpu_torch.models import heads as t_heads

    jhead = j_heads.build_head("Residual", input_size=12, output_size=10, **cfg)
    hparams = jhead.init(jax.random.PRNGKey(5), features=jnp.asarray(feats),
                         linears=jnp.asarray(linears))
    jgrads = jax.grad(lambda p: jnp.sum(jhead.apply(
        p, features=jnp.asarray(feats), linears=jnp.asarray(linears))[0] * wts))(hparams)
    head = t_heads.build_head("Residual", input_size=12, output_size=10, **cfg)
    head.load_state_dict(flax_to_state_dict(jax.device_get(hparams)))
    pred, _ = head(torch.from_numpy(feats), torch.from_numpy(linears))
    names, tensors = zip(*head.named_parameters())
    grads = dict(zip(names, torch.autograd.grad((pred * torch.from_numpy(wts)).sum(),
                                                tensors)))
    ref_grads = flax_to_state_dict(jax.device_get(jgrads))
    assert set(ref_grads) == set(grads) and len(grads) == 3 * 4 + 2
    for k, g in grads.items():
        r = ref_grads[k].numpy()
        # as for the bidirectional head (tests/test_torch_port_lstm_grad.py)
        assert float(np.abs(g.numpy() - r).max() / (np.abs(r).max() + 1e-12)) < 5e-5, k


def test_device_prefetch_on_the_cpu_keeps_batches_and_order():
    """Batch for batch what the JAX package's prefetch yields: every batch,
    in order, arrays as tensors of the same content, other entries as they
    are; an iterator shorter than the look-ahead, and an empty one."""
    rng = np.random.default_rng(2)
    batches = [(rng.integers(0, 9, size=(3,)), rng.standard_normal((3, 2, 5 + i))
                .astype(np.float32), f"tag{i}") for i in range(5)]
    ref = list(j_loader.device_prefetch(iter(batches), size=2))
    for size in (1, 2, 4, 9):
        moved = list(loader.device_prefetch(iter(batches), "cpu", size=size))
        assert len(moved) == len(ref) == len(batches)
        for got, want, host in zip(moved, ref, batches):
            assert isinstance(got, tuple) and got[2] == host[2]
            assert all(isinstance(x, torch.Tensor) for x in got[:2])
            assert got[0].dtype == torch.int64 and got[1].dtype == torch.float32
            assert all(np.array_equal(x.numpy(), np.asarray(w))
                       for x, w in zip(got[:2], want[:2]))
            # on the CPU nothing is copied: the tensor shares the array's memory
            assert got[1].data_ptr() == host[1].ctypes.data
    assert list(loader.device_prefetch(iter([]), "cpu")) == []


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_served_by_port_matches_jax_serving(writer, ckpts):
    ckpt = ckpts[writer]
    requests = [_audio(5000, 1), _audio(9000, 2)]
    ref = j_serve.build_enhancer(ckpt, 16000, -25.0)
    port = serve.build_enhancer(ckpt, device="cpu")
    for wav in requests:
        assert _rel(port(wav), np.asarray(ref(wav))) < WAV_TOL


def test_recorded_pretraining_checkpoints_match_jax_serving(jax_small, ckpts, tmp_path):
    """Settings may point at an S3PRL pretraining checkpoint (the STFT
    geometry) and a checkpoint whose settings hold the downstream feature
    and model config; both paths relocate. Served like the JAX package."""
    from speech_enhancement_by_s3prl_tpu_torch.ops.features import get_feat_config

    _, params, _ = jax_small
    upstream = tmp_path / "upstream.ckpt"
    torch.save({"Settings": {"Config": {"online": {
        "win_ms": 25.0, "hop_ms": 10.0, "n_freq": 201, "n_mels": 40,
    }}}}, upstream)
    config, paras = entry.flagship_settings(**SMALL)
    # this checkpoint's own sections disagree; the dckpt's settings win
    stale = {"preprocessor": {"baseline": get_feat_config("linear", 0)},
             "model": {"Residual": {"hidden_size": 4, "num_layers": 1}}}
    _, model = entry.build(device="cpu", **SMALL)
    model.load_state_dict(flax_to_state_dict(params))
    save_checkpoint(str(tmp_path / "main"), 1, model, None, stale,
                    {**paras, "ckpt": str(tmp_path / "gone" / "up.ckpt"),
                     "dckpt": str(tmp_path / "gone" / "d.ckpt")})
    main = str(tmp_path / "main")
    with pytest.raises(FileNotFoundError, match="--upstream_ckpt"):
        serve.build_enhancer(main, device="cpu")
    relocate = dict(upstream_ckpt=str(upstream), dckpt=ckpts["port"])
    ref = j_serve.build_enhancer(main, 16000, -25.0, **relocate)
    port = serve.build_enhancer(main, device="cpu", **relocate)
    wav = _audio(7000, 8)
    assert _rel(port(wav), np.asarray(ref(wav))) < WAV_TOL


def test_checkpoints_cross_read_exactly(ckpts, jax_small):
    _, params, _ = jax_small
    from_jax = load_checkpoint(ckpts["jax"])
    from_port = j_load_checkpoint(ckpts["port"])
    for tree in (from_jax["Downstream"], from_port["Downstream"]):
        a = jax.tree_util.tree_flatten_with_path(tree)[0]
        b = jax.tree_util.tree_flatten_with_path(params)[0]
        assert [p for p, _ in a] == [p for p, _ in b]
        assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))
    assert from_jax["Global_step"] == from_port["Global_step"] == 3
    assert from_jax["Settings"] == from_port["Settings"]
    # optax state unpickles without optax: opaque records, numpy inside
    assert "ScaleByAdamState" in repr(from_jax["Optimizer"])
    assert state_dict_to_flax(flax_to_state_dict(from_jax["Downstream"])).keys() == {
        "params"
    }


def test_micro_batcher_coalesces_by_bucket_and_matches_solo(ckpts):
    enhancer = serve.build_enhancer(ckpts["port"], device="cpu")
    groups = []

    def run_batch(wavs):
        groups.append(sorted(len(w) for w in wavs))
        return enhancer.run_batch(wavs)

    batcher = serve.MicroBatcher(run_batch, window_ms=200.0,
                                 bucket_of=enhancer.bucket_of)
    requests = [_audio(n, k) for k, n in enumerate((7000, 12000, 20000, 9000))]
    answers = [None] * len(requests)

    def ask(k):
        answers[k] = batcher.submit(requests[k])

    threads = [threading.Thread(target=ask, args=(k,)) for k in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    # 7000, 9000 and 12000 share the 1 s bucket; 20000 rides alone in 2 s
    assert sorted(groups) == [[7000, 9000, 12000], [20000]]
    for wav, out in zip(requests, answers):
        # a request's padded rows are independent of its co-riders
        assert _rel(out, enhancer(wav)) < WAV_TOL


def test_micro_batcher_under_contention_answers_each_request_its_own():
    """More submitting threads than cores, with a short switch interval:
    every caller gets the answer to its own request and no group mixes
    buckets."""
    groups = []

    def run_batch(wavs):
        groups.append({len(w) // 100 for w in wavs})
        return [w * 2.0 for w in wavs]

    batcher = serve.MicroBatcher(run_batch, max_batch=8, window_ms=1.0,
                                 bucket_of=lambda n: n // 100)
    n_threads = 4 * (os.cpu_count() or 1) + 8
    requests = [np.full(100 * (k % 5) + 1 + k, k, np.float32) for k in range(n_threads)]
    answers = [None] * n_threads

    def ask(k):
        answers[k] = batcher.submit(requests[k])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask, args=(k,)) for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    for req, out in zip(requests, answers):
        assert out is not None and np.array_equal(out, req * 2.0)
    assert all(len(g) == 1 for g in groups)


def test_cpu_serving_launches_no_kernel(ckpts):
    enhancer = serve.build_enhancer(ckpts["port"], device="cpu")
    lstm_bidir_tm.launches = 0
    enhancer(_audio(4000, 3))
    assert lstm_bidir_tm.launches == 0


def test_enhance_cli_writes_enhanced_wavs(ckpts, tmp_path):
    inputs = tmp_path / "in"
    inputs.mkdir()
    clips = {"a": _audio(6000, 4), "b": _audio(17000, 5)}
    for name, wav in clips.items():
        audio_io.write_wav(str(inputs / f"{name}.wav"), wav, 16000)
    enhance_cli(["--ckpt", ckpts["port"], "--inputs", str(inputs),
                 "--outdir", str(tmp_path / "out"), "--device", "cpu"])
    wavs = [audio_io.read_wav(str(inputs / f"{n}.wav"))[0][0] for n in sorted(clips)]
    # the CLI pads its batch to one bucket (2 s here), as the run below does
    refs = serve.build_enhancer(ckpts["port"], device="cpu").run_batch(wavs)
    for name, wav, ref in zip(sorted(clips), wavs, refs):
        out, sr = audio_io.read_wav(str(tmp_path / "out" / f"{name}.wav"))
        assert sr == 16000 and out.shape == (1, len(wav))
        # 16-bit PCM output: within one quantization step of the float run
        assert np.abs(out[0] - ref).max() <= 1.0 / 32767 + 1e-6


def test_enhance_cli_runs_on_the_card_unless_asked_for_the_cpu(ckpts, tmp_path, monkeypatch):
    """``--device`` defaults to cuda, as in run_downstream; with no CUDA
    device the default raises instead of running on the CPU."""
    inputs = tmp_path / "in"
    inputs.mkdir()
    audio_io.write_wav(str(inputs / "a.wav"), _audio(6000, 4), 16000)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        enhance_cli(["--ckpt", ckpts["port"], "--inputs", str(inputs),
                     "--outdir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_serving_refuses_what_is_not_ported(ckpts, tmp_path, monkeypatch):
    enhancer = serve.build_enhancer(ckpts["port"], device="cpu", max_bucket_ms=2000)
    # a request longer than the largest bucket streams through enhance();
    # run_batch serves bucket-sized groups only
    with pytest.raises(ValueError, match="longer than the largest bucket"):
        enhancer.run_batch([np.zeros(40000, np.float32)])
    with pytest.raises(ValueError, match="recurrence"):
        enhancer.model.lstm.recurrence = "scan"
    payload = load_checkpoint(ckpts["port"])
    _, model = entry.build(device="cpu", **SMALL)
    # an upstream-mode checkpoint must record the upstream's S3PRL checkpoint
    payload["Settings"]["Paras"].update(compute_dtype="f32", from_rawfeature=False)
    save_checkpoint(str(tmp_path), 2, model, None, payload["Settings"]["Config"],
                    payload["Settings"]["Paras"])
    with pytest.raises(ValueError, match="upstream_ckpt"):
        serve.build_enhancer(str(tmp_path), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_enhancer(ckpts["port"], device="cuda")


@pytest.mark.parametrize("max_ms", [1000, 2500, 10000, 60000])
def test_buckets_match_jax(max_ms):
    assert loader.default_buckets(16000, max_ms) == j_loader.default_buckets(16000, max_ms)
    b = loader.default_buckets(16000, max_ms)
    for n in (1, 15999, 16000, 16001, 10 ** 7):
        assert loader.bucket_length(n, b) == j_loader.bucket_length(n, b)


def test_wav_io_matches_jax(tmp_path):
    from speech_enhancement_by_s3prl_tpu.data import audio_io as j_audio_io

    wav = _audio(3001, 6)
    audio_io.write_wav(str(tmp_path / "port.wav"), wav, 16000)
    j_audio_io.write_wav(str(tmp_path / "jax.wav"), wav, 16000)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    back, sr = audio_io.load_audio(str(tmp_path / "jax.wav"), sr=16000)
    ref, ref_sr = j_audio_io.load_audio(str(tmp_path / "jax.wav"), sr=16000)
    assert sr == ref_sr == 16000 and np.array_equal(back, ref)
    # 16-bit PCM written as x * 32767, read back as / 32768
    assert np.abs(back - wav).max() <= 0.5 / 32767 + np.abs(wav).max() / 32767


_NO_JAX_CHILD = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "speech_enhancement_by_s3prl_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
import speech_enhancement_by_s3prl_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import load_checkpoint
from speech_enhancement_by_s3prl_tpu_torch.serve import build_enhancer
import numpy as np
enhance = build_enhancer(sys.argv[1], device="cpu")
out = enhance(np.zeros(3000, np.float32) + 0.01)
assert out.shape == (3000,) and np.isfinite(out).all()
# the kernel modules' plain versions, the recurrence routes and the long-form entry
for name in ("ops.cuda.stft_kernel", "ops.cuda.decode_kernel", "ops.streaming",
             "data.flac", "tools.serve_load", "tools.stream_client"):
    assert pkg.__name__ + "." + name in mods, name
for route in ("blocked", "fused"):
    routed = build_enhancer(sys.argv[1], device="cpu", max_bucket_ms=2000)
    routed.model.lstm.recurrence = route
    streamed = routed(np.zeros(40000, np.float32) + 0.01)
    assert streamed.shape == (40000,) and np.isfinite(streamed).all()
print(len(mods), "modules", sorted(load_checkpoint(sys.argv[1])["Downstream"]["params"]))
"""


def test_port_runs_without_jax(ckpts):
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_CHILD, ckpts["jax"]],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    n_mods = int(proc.stdout.split()[0])
    assert n_mods >= 15, proc.stdout
    assert "'lstm'" in proc.stdout and "'scaling_layer'" in proc.stdout
