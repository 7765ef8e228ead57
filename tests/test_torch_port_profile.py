"""The step tracer and two flags of the JAX command lines, on the CPU.

- ``run_downstream --profile``: the port's Runner and the JAX package's
  (tests/test_e2e.py's ``test_profile_trace_written``), each at
  ``profile_step`` 2, write a trace under ``expdir/profile``; the port's
  parses to a host plane holding the train step's ops, and its run is bit
  for bit the run without ``--profile`` (scalars and checkpoint); in a
  process group the trace's name carries the rank.
- ``utils/profiling.parse_trace`` / ``report`` on hand-written Chrome traces
  (device planes; the host fallback's self-times), and the names of the
  port's kernels (mangled and demangled, B1 apart from B2 fwd).
- ``tools/profile_step`` in each of its six modes at full width (batch 2,
  1 s, one traced step), and ``--parse_only`` on the trace it wrote; its
  ``train`` and ``enhance`` modes against the JAX package's on the same
  weights and inputs.
- ``enhance --cpu`` (the JAX CLI's flag) writes what ``--device cpu`` writes.
- ``run_downstream --wandb``: without the package, the JAX CLI's message;
  with a stand-in module, a run named ``--name`` whose config holds the args
  and the config, the scalars logged from rank 0, the run resumed by the
  saved ``wandbid``.
"""
import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import yaml

import __graft_entry__ as graft
import run_downstream as j_run_downstream
from speech_enhancement_by_s3prl_tpu.runner import optim as j_optim
from speech_enhancement_by_s3prl_tpu_torch import entry, enhance, run_downstream
from speech_enhancement_by_s3prl_tpu_torch.data.audio_io import write_wav
from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_to_state_dict
from speech_enhancement_by_s3prl_tpu_torch.runner import optim
from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from speech_enhancement_by_s3prl_tpu_torch.tools import profile_step
from speech_enhancement_by_s3prl_tpu_torch.utils import profiling
from tests.test_e2e import make_runner as j_make_runner

SR = 16000
# the limits tests/test_torch_port_train.py and test_torch_port_slice.py hold
# these functions to: loss (relative), parameters after an update (absolute),
# the enhanced waveform (of its RMS)
LOSS_RTOL, PARAM_ATOL, WAV_TOL = 1e-5, 1e-6, 5e-5
SMALL = dict(hidden_size=16, num_layers=1)
CFG = {
    "dataloader": {"batch_size": 2, "eval_batch_size": 2},
    "preprocessor": {"input_channel": 0, "target_channel": 1,
                     "baseline": {"feat_type": "mel", "log": True, "delta": 2,
                                  "cmvn": False}},
    "runner": {"learning_rate": 1e-3, "warmup_proportion": 0.07, "gradient_clipping": 1.0,
               "total_step": 3, "log_step": 1, "eval_step": 3, "save_step": 3,
               "max_keep": 1, "eval_splits": ["dev"], "eval_metrics": ["sisdr"],
               "profile_step": 2},
    "objective": {"SISDR": {}},
    "model": {"Residual": {"hidden_size": 8, "num_layers": 2, "bidirectional": True,
                           "activation": "Sigmoid", "cmvn": False}},
}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Speech and noise WAVs of 0.4-1 s, and the port's run config over them."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    for sub in ("speech", "noise"):
        (root / sub).mkdir()
        for i in range(6):
            n = int(rng.integers(6000, 16000))
            write_wav(str(root / sub / f"{i}.wav"), 0.1 * rng.standard_normal(n), SR)
    data = {"speech": {"filestrs": str(root / "speech")},
            "noise": {"filestrs": str(root / "noise")}, "sample_rate": SR,
            "max_time": 1000, "target_level": -25, "snrs": [0, 4]}
    config = {**CFG, "OnlineDataset_train": {**data, "infinite": True},
              "OnlineDataset_test": {**data, "half_noise": "end"}}
    with open(root / "cfg.yaml", "w") as f:
        yaml.safe_dump(config, f)
    return root


def _flags(expdir, *extra):
    return ["--config", None, "--name", "run", "--expdir", str(expdir), "--downstream",
            "Residual", "--objective", "SISDR", "--from_rawfeature", "--dev_num", "2",
            "--n_jobs", "1", "--seed", "3", "--cpu", *extra]


def _train(corpus, expdir, *extra):
    flags = _flags(expdir, *extra)
    flags[1] = str(corpus / "cfg.yaml")
    run_downstream.main(flags)
    return expdir / "run"


def _scalars(run_dir):
    """(step, tag, value) of scalars.jsonl but the wall-clock steps_per_sec."""
    with open(run_dir / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return [(r["step"], r["tag"], r["value"]) for r in rows if r["tag"] != "steps_per_sec"]


@pytest.fixture(scope="module")
def profiled(corpus, tmp_path_factory):
    """The port's run with and without --profile, and the JAX Runner's with."""
    root = tmp_path_factory.mktemp("runs")
    runs = {flag: _train(corpus, root / flag, *(["--profile"] if flag == "on" else []))
            for flag in ("on", "off")}
    jax_dir = root / "jax"
    runner, *_ = j_make_runner(corpus, jax_dir)
    runner.args.profile = True
    runner.rconfig["profile_step"] = 2
    runner.train()
    return runs, jax_dir


def _files(directory):
    return sorted(os.path.join(d, n) for d, _, names in os.walk(directory) for n in names)


def test_profile_writes_a_trace_at_profile_step_like_jax(profiled):
    runs, jax_dir = profiled
    assert _files(jax_dir / "profile"), "the JAX Runner wrote no trace"
    traces = _files(runs["on"] / "profile")
    assert len(traces) == 1 and os.path.basename(traces[0]).startswith("train_step2.")
    assert traces[0].endswith(".pt.trace.json")
    assert not os.path.exists(runs["off"] / "profile")
    (plane, (total, rows)), = profiling.parse_trace(traces[0], top=None).items()
    assert plane == profiling.HOST_PLANE and total > 0 and rows
    counts = {name: n for name, _, n in rows}
    # the one traced step: B2 fwd and B2 bwd (their plain versions here) once a layer
    assert counts["LstmBidirTm"] == counts["LstmBidirTmBackward"] == 2


def test_profile_leaves_the_run_bit_for_bit(profiled):
    runs, _ = profiled
    on, off = _scalars(runs["on"]), _scalars(runs["off"])
    assert [t for _, t, _ in on].count("loss") == 3 and on == off
    a = load_checkpoint(str(runs["on"]))["Downstream"]
    b = load_checkpoint(str(runs["off"]))["Downstream"]
    for (ka, va), (kb, vb) in zip(sorted(flax_to_state_dict(a).items()),
                                  sorted(flax_to_state_dict(b).items())):
        assert ka == kb and torch.equal(va, vb), ka


def _trace_file(path, events):
    with open(path, "w") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)
    return str(path)


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": args.pop("pid", 1),
            "tid": args.pop("tid", 1), "ts": ts, "dur": dur, "args": args}


B1 = "void lstm_tm_cluster_kernel<false, 0>(float const*, float const*, float*, float*, int)"
B2F = "void lstm_tm_cluster_kernel<true, 0>(float const*, float const*, float*, float*, int)"
MUL = ("void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<float, "
       "float, float, at::native::binary_internal::MulFunctor<float> >, std::array<char*, 3ul> "
       ">(int, at::native::BinaryFunctor<float, float, float, "
       "at::native::binary_internal::MulFunctor<float> >, std::array<char*, 3ul>)")


def test_parse_trace_sums_device_planes_by_name(tmp_path, capsys):
    events = [
        _x("cpu_op", "aten::add", 0.0, 50.0),  # host events: not on a device plane
        _x("kernel", B1, 10.0, 100.0, device=0),
        _x("kernel", B1, 200.0, 100.0, device=0),
        _x("kernel", B2F, 400.0, 300.0, device=0),
        _x("kernel", MUL, 800.0, 20.0, device=0),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 900.0, 30.0, device=0),
        _x("gpu_memset", "Memset (Device)", 950.0, 2.0, device=1),
        _x("kernel", B1, 10.0, 40.0, device=1),
        _x("kernel", "at::cuda::(anonymous namespace)::spin_kernel(long)", 1.0, 3.0, device=0),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1.0},
    ]
    tables = profiling.parse_trace(_trace_file(tmp_path / "t.json", events), top=None)
    assert list(tables) == ["/device:GPU:0", "/device:GPU:1"]
    total, rows = tables["/device:GPU:0"]
    assert total == pytest.approx(0.55)
    assert rows == [("lstm_tm_cluster_kernel<true, 0>", pytest.approx(0.3), 1),
                    ("lstm_tm_cluster_kernel<false, 0>", pytest.approx(0.2), 2),
                    ("Memcpy HtoD (Pageable -> Device)", pytest.approx(0.03), 1),
                    ("MulFunctor<float>", pytest.approx(0.02), 1)]
    assert profiling.hand_written_launches(rows) == {"B1": 2, "B2 fwd": 1}
    assert tables["/device:GPU:1"] == (pytest.approx(0.042), [
        ("lstm_tm_cluster_kernel<false, 0>", pytest.approx(0.04), 1),
        ("Memset (Device)", pytest.approx(0.002), 1)])
    top2 = profiling.parse_trace(str(tmp_path / "t.json"), top=2)["/device:GPU:0"]
    assert top2 == (pytest.approx(0.55), rows[:2])

    profiling.report(tables, steps=2)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "== plane /device:GPU:0: 0.28 ms/step (sum of event durations; 2 steps) =="
    assert lines[1] == "    0.150 ms  x1    lstm_tm_cluster_kernel<true, 0>"
    assert lines[2] == "    0.100 ms  x2    lstm_tm_cluster_kernel<false, 0>"
    assert lines[6] == "== plane /device:GPU:1: 0.02 ms/step (sum of event durations; 2 steps) =="


def test_parse_trace_falls_back_to_the_host_plane_with_self_times(tmp_path):
    events = [
        _x("cpu_op", "aten::matmul", 0.0, 100.0),
        _x("cpu_op", "aten::mm", 10.0, 70.0),
        _x("cpu_op", "aten::resolve_conj", 20.0, 5.0),
        _x("cpu_op", "aten::add", 100.0, 10.0),   # starts where matmul ends
        _x("cpu_op", "aten::mm", 5.0, 30.0, tid=2),
        _x("python_function", "train_step", 0.0, 500.0),  # not an op
    ]
    (plane, (total, rows)), = profiling.parse_trace(
        _trace_file(tmp_path / "t.json", events), top=None).items()
    assert plane == "/host:CPU" and total == pytest.approx(0.14)
    assert rows == [("aten::mm", pytest.approx(0.095), 2),
                    ("aten::matmul", pytest.approx(0.03), 1),
                    ("aten::add", pytest.approx(0.01), 1),
                    ("aten::resolve_conj", pytest.approx(0.005), 1)]


@pytest.mark.parametrize("name,label,kid", [
    (B1, "lstm_tm_cluster_kernel<false, 0>", "B1"),
    (B2F, "lstm_tm_cluster_kernel<true, 0>", "B2 fwd"),
    ("_Z22lstm_tm_cluster_kernelILb0ELi0EEvPKfS1_PfS2_", "lstm_tm_cluster_kernelILb0ELi0E",
     "B1"),
    ("_Z22lstm_tm_cluster_kernelILb1ELi2EEvPKfS1_PfS2_", "lstm_tm_cluster_kernelILb1ELi2E",
     "B2 fwd"),
    ("void lstm_bidir_tm_kernel<4, true, 0>(float const*)", "lstm_bidir_tm_kernel<4, true, 0>",
     "B2 fwd"),
    ("void lstm_bwd_seq_kernel<0>(float const*)", "lstm_bwd_seq_kernel<0>", "B2 bwd"),
    ("void flash_fwd_bf16_kernel<64, true>(CUtensorMap_st)", "flash_fwd_bf16_kernel<64, true>",
     "B3 fwd bf16"),
    ("flash_bwd_dot_kernel(float const*, int)", "flash_bwd_dot_kernel", "B3 bwd"),
    ("stft_fft_kernel(float const*)", "stft_fft_kernel", "B4"),
    ("void decode_fft_kernel(float const*)", "decode_fft_kernel", "B5"),
])
def test_kernel_names_and_ids(name, label, kid):
    assert profiling.kernel_label(name) == label
    assert profiling.kernel_id(label) == kid


def test_library_kernels_are_named_by_their_op():
    assert profiling.kernel_op(MUL) == "MulFunctor<float>"
    gemm = "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x32_8x5_nn_align1>(Params)"
    assert profiling.kernel_op(gemm) == "cutlass::Kernel2<cutlass_80_simt_sgemm_128x32_8x5_nn_align1>"
    assert profiling.kernel_id(profiling.kernel_op(gemm)) is None
    assert profiling.kernel_label(MUL) == MUL


@pytest.mark.parametrize("mode", profile_step.MODES)
def test_profile_step_mode_on_the_cpu(mode, tmp_path, capsys):
    path = profile_step.main(["--mode", mode, "--batch", "2", "--utt_sec", "1", "--steps", "1",
                              "--cpu", "--outdir", str(tmp_path), "--top", "8"])
    out = capsys.readouterr().out
    assert os.path.dirname(path) == str(tmp_path) and path.endswith(".pt.trace.json")
    assert os.path.basename(path).startswith(f"{mode}.")
    table = out[out.index("== plane"):].strip().splitlines()
    assert table[0].startswith("== plane /host:CPU: ") and table[0].endswith(
        "ms/step (sum of event durations; 1 steps) ==")
    assert len(table) == 9  # --top 8 rows; the CPU launches none of the port's kernels
    profile_step.main(["--parse_only", path, "--top", "8"])
    assert capsys.readouterr().out.strip().splitlines() == table


def _jax_builder(**replace):
    return dataclasses.replace(graft._build(use_pallas=False, **SMALL), donate=False, **replace)


def test_train_mode_matches_jax():
    """Two updates of the train mode against the JAX train step on the same
    weights and inputs, under a short schedule so that the updates show."""
    lr, total = 1e-3, 10
    mode = profile_step.build_mode("train", batch=2, utt_sec=1, device="cpu", seed=5,
                                   head=SMALL)
    mode.builder.optimizer = optim.build_optimizer("BertAdam", lr, 0.07, total)
    jb = _jax_builder(optimizer=j_optim.build_optimizer("BertAdam", lr, 0.07, total))
    wavs, lengths = jnp.asarray(mode.wavs.numpy()), jnp.asarray(mode.lengths.numpy())
    state = jb.init_state(jax.random.PRNGKey(0), wavs, lengths)
    mode.model.load_state_dict(flax_to_state_dict(jax.device_get(state.params)))
    step = jax.jit(jb.train_step_raw())
    for _ in range(2):
        state, stats = step(state, wavs, lengths, jax.random.PRNGKey(0), None)
        np.testing.assert_allclose(float(mode()), float(stats["loss"]), rtol=LOSS_RTOL)
    ref = flax_to_state_dict(jax.device_get(state.params))
    for k, p in mode.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[k].numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=k)


def test_enhance_mode_matches_jax():
    mode = profile_step.build_mode("enhance", batch=2, utt_sec=1, device="cpu", seed=6,
                                   head=SMALL)
    jb = _jax_builder()
    wavs, lengths = jnp.asarray(mode.wavs.numpy()), jnp.asarray(mode.lengths.numpy())
    params = jax.device_get(jb.init_state(jax.random.PRNGKey(1), wavs, lengths).params)
    mode.model.load_state_dict(flax_to_state_dict(params))
    ref = np.asarray(jax.jit(graft.make_enhance(jb))(params, wavs, lengths))
    out = mode.enhance(mode.wavs, mode.lengths).numpy()
    assert out.shape == ref.shape == (2, SR)
    assert np.abs(out - ref).max() / np.sqrt(np.mean(ref ** 2)) < WAV_TOL
    np.testing.assert_allclose(float(mode()), float(ref.sum()), rtol=1e-4,
                               atol=WAV_TOL * np.sqrt(np.mean(ref ** 2)) * ref.size)


def test_mode_defaults_and_refusals(monkeypatch):
    assert [profile_step.mode_dtype(m) for m in ("upstream", "train")] == ["bf16", "f32"]
    assert profile_step.mode_dtype("upstream", "f32") == "f32"
    assert profile_step.mode_dtype("train", "bfloat16") == "bf16"
    args = profile_step.get_parser().parse_args(["--cpu"])
    assert (args.device, args.batch, args.steps, args.utt_sec, args.top) == ("cpu", 0, 3, 10, 40)
    assert profile_step.get_parser().parse_args([]).device == "cuda"
    with pytest.raises(ValueError, match="unknown mode"):
        profile_step.build_mode("loader", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_step.build_mode("train", batch=1, utt_sec=1)


def test_enhance_cpu_flag_is_device_cpu(tmp_path):
    _, model = entry.build(hidden_size=8, num_layers=1, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    config, paras = entry.flagship_settings(hidden_size=8, num_layers=1)
    ckpt = save_checkpoint(str(tmp_path), 0, model, None, config, paras)
    rng = np.random.default_rng(2)
    (tmp_path / "in").mkdir()
    for i, n in enumerate((7000, 12000, 9000)):
        write_wav(str(tmp_path / "in" / f"{i}.wav"), 0.1 * rng.standard_normal(n), SR)
    outs = {}
    for tag, flags in (("cpu", ["--cpu"]), ("device", ["--device", "cpu"]),
                       ("cpu_mesh", ["--cpu", "--mesh", "2"]),
                       ("device_mesh", ["--device", "cpu", "--mesh", "2"])):
        enhance.main(["--ckpt", ckpt, "--inputs", str(tmp_path / "in"), "--outdir",
                      str(tmp_path / tag), *flags])
        outs[tag] = {n: (tmp_path / tag / n).read_bytes()
                     for n in sorted(os.listdir(tmp_path / tag))}
    assert len(outs["cpu"]) == 3
    assert outs["cpu"] == outs["device"] and outs["cpu_mesh"] == outs["device_mesh"]


def test_wandb_without_the_package_fails_as_jax_does(corpus, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # an import of it fails
    flags = _flags(tmp_path, "--wandb")
    flags[1] = str(corpus / "cfg.yaml")
    with pytest.raises(SystemExit) as port:
        run_downstream.main(flags)
    monkeypatch.setattr(sys, "argv", ["run_downstream.py", *flags])
    with pytest.raises(SystemExit) as ref:
        j_run_downstream.get_downstream_args()
    assert str(port.value) == str(ref.value) == run_downstream.WANDB_MISSING
    assert not os.path.exists(tmp_path / "run")


class _WandbStandIn(types.ModuleType):
    """What the port calls of ``wandb``, recorded."""

    def __init__(self):
        super().__init__("wandb")
        self.calls, self.run = [], None
        self.config = types.SimpleNamespace(
            update=lambda d: self.calls.append(("config.update", d)))

    def init(self, **kwargs):
        self.calls.append(("init", kwargs))
        self.run = types.SimpleNamespace(id=kwargs.get("resume") or "run-id-1")

    def log(self, data, step):
        self.calls.append(("log", data, step))


def test_wandb_run_logs_scalars_and_resumes_by_its_id(corpus, tmp_path, monkeypatch):
    wandb = _WandbStandIn()
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    run_dir = _train(corpus, tmp_path, "--wandb")
    (_, init), (_, update), *logs = wandb.calls
    assert init == {"name": "run"}
    assert set(update) == {"args", "config"} and update["args"]["wandbid"] == "run-id-1"
    assert update["config"]["runner"]["total_step"] == 3
    with open(run_dir / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert logs == [("log", {r["tag"]: r["value"]}, r["step"]) for r in rows]
    payload = load_checkpoint(str(run_dir))
    assert payload["Settings"]["Paras"]["wandbid"] == "run-id-1"

    # the resume continues that run
    resumed = _WandbStandIn()
    monkeypatch.setitem(sys.modules, "wandb", resumed)
    run_downstream.main(["--resume", str(run_dir), "--cpu"])
    assert resumed.calls[0] == ("init", {"name": "run", "resume": "run-id-1"})
    assert not any(c[0] == "config.update" for c in resumed.calls)


def test_wandb_starts_only_on_rank_0(corpus, tmp_path, monkeypatch):
    """A rank other than 0 of a process group (as ``--mesh`` starts them)
    starts no wandb run, so no scalar goes there."""
    wandb = _WandbStandIn()
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 1)
    flags = _flags(tmp_path, "--wandb")
    flags[1] = str(corpus / "cfg.yaml")
    args, config = run_downstream.get_downstream_args(flags)
    run_downstream._run(args, config)
    assert wandb.calls == [] and not hasattr(args, "wandbid")


def test_profile_in_a_process_group_names_the_rank(corpus, tmp_path):
    """Under ``--mesh`` every rank traces its own step into ``profile/``, its
    rank in the file's name (here a gloo group of one)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        flags = _flags(tmp_path, "--profile")
        flags[1] = str(corpus / "cfg.yaml")
        run_downstream._run(*run_downstream.get_downstream_args(flags))
    finally:
        dist.destroy_process_group()
    trace, = os.listdir(tmp_path / "run" / "profile")
    assert trace.startswith("train_step2_rank0.") and trace.endswith(".pt.trace.json")
