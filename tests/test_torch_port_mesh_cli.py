"""``--mesh`` through the port's command lines, on the CPU.

- ``run_downstream --mesh 2x1 --device cpu`` starts its two gloo ranks itself
  and trains 4 steps at hidden 8 (the pattern of tests/test_cli_mesh.py); its
  logged losses are the single-process run's, and rank 0 alone wrote the
  scalars and the checkpoint. ``--mesh 1x2`` does the same with the head's
  gate rows sharded over the two ranks, and its checkpoint is the full tree. So does a sync-sampled run with
  ``--active_sampling`` (config/active.yaml at small width, two seeded
  upstreams): rank 0 scores and chooses, the other rank trains on its
  batches, and the losses and the media rank 0 wrote are the single
  process's.
- ``enhance --mesh 2 --device cpu`` (two replicas on the CPU) writes the
  single-device enhancer's output within 1e-5 (tests/test_enhance_cli.py),
  three files over two replicas (a padded row).
- ``build_enhancer(mesh_n=2)`` serves a group as the single-device enhancer
  does, and refuses a ``fixed_rows`` that the mesh does not divide
  (tests/test_serve.py).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from speech_enhancement_by_s3prl_tpu_torch import entry, enhance, run_downstream, serve
from speech_enhancement_by_s3prl_tpu_torch.data.audio_io import load_audio, write_wav
from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import save_checkpoint
from tests.test_torch_port_active_runner import STEPS, _active_yaml, _flags, world  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
# the CLI run's own limit: a hung rendezvous fails the test, not the suite
CLI_TIMEOUT = 120

CFG = {
    "dataloader": {"batch_size": 4, "eval_batch_size": 4},
    "preprocessor": {"input_channel": 0, "target_channel": 1,
                     "baseline": {"feat_type": "linear", "log": False, "delta": 0,
                                  "cmvn": False}},
    "runner": {"learning_rate": 1e-3, "warmup_proportion": 0.07, "gradient_clipping": 1.0,
               "total_step": 4, "log_step": 1, "eval_step": 4, "save_step": 4,
               "max_keep": 1, "eval_splits": ["dev"], "eval_metrics": ["sisdr"]},
    "objective": {"L1": {}},
    "model": {"LSTM": {"hidden_size": 8, "num_layers": 1, "bidirectional": False,
                       "activation": "ReLU"}},
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    for sub in ("speech", "noise"):
        (root / sub).mkdir()
        for i in range(8):
            n = int(rng.integers(6000, 12000))
            write_wav(str(root / sub / f"{sub}{i}.wav"),
                      rng.standard_normal(n).astype(np.float32) * 0.1, SR)
    return root


def _config(corpus):
    data = {"sample_rate": SR, "max_time": 1000, "target_level": -25, "snrs": [0],
            "speech": {"filestrs": str(corpus / "speech")},
            "noise": {"filestrs": str(corpus / "noise")}}
    return {**CFG, "OnlineDataset_train": data, "OnlineDataset_test": data}


def _losses(expdir):
    with open(os.path.join(expdir, "scalars.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return [(x["step"], x["value"]) for x in lines if x["tag"] == "loss"]


def test_run_downstream_mesh_trains_on_two_gloo_ranks(corpus, tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(_config(corpus)))
    flags = ["--config", str(cfg), "--upstream", "baseline", "--upstream2", "baseline",
             "--from_rawfeature", "--downstream", "LSTM", "--objective", "L1",
             "--dev_num", "2", "--n_jobs", "1", "--device", "cpu"]
    proc = subprocess.run(
        [sys.executable, "-m", "speech_enhancement_by_s3prl_tpu_torch.run_downstream",
         "--name", "mesh", "--expdir", str(tmp_path / "exp"), *flags, "--mesh", "2x1"],
        capture_output=True, text=True, timeout=CLI_TIMEOUT, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "step 4/4" in proc.stdout and proc.stdout.count("step 4/4") == 1  # rank 0 prints
    assert "process 0/2 | gloo" in proc.stdout and "process 1/2 | gloo" in proc.stdout
    mesh_dir = tmp_path / "exp" / "mesh"
    assert any(name.startswith("states-") for name in os.listdir(mesh_dir))

    torch.set_num_threads(1)
    run_downstream.main(["--name", "single", "--expdir", str(tmp_path / "exp"), *flags])
    mesh, single = _losses(mesh_dir), _losses(tmp_path / "exp" / "single")
    assert [s for s, _ in mesh] == [s for s, _ in single] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in mesh], [v for _, v in single], rtol=1e-5)


def test_run_downstream_model_axis_trains_on_two_gloo_ranks(corpus, tmp_path):
    """``--mesh 1x2 --device cpu``: the CLI starts two gloo ranks of one model
    group, which train the LSTM head with its gate rows sharded (hidden 8: 4H =
    32 rows, 16 a rank), evaluate over both ranks and save through rank 0.
    The logged losses are the single process's, and the checkpoint holds the
    full tree, weights and moments, within 2e-6 of the single process's."""
    from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_to_state_dict
    from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import load_checkpoint

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(_config(corpus)))
    flags = ["--config", str(cfg), "--upstream", "baseline", "--upstream2", "baseline",
             "--from_rawfeature", "--downstream", "LSTM", "--objective", "L1",
             "--dev_num", "2", "--n_jobs", "1", "--device", "cpu"]
    proc = subprocess.run(
        [sys.executable, "-m", "speech_enhancement_by_s3prl_tpu_torch.run_downstream",
         "--name", "tp", "--expdir", str(tmp_path / "exp"), *flags, "--mesh", "1x2"],
        capture_output=True, text=True, timeout=CLI_TIMEOUT, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("step 4/4") == 1 and proc.stdout.count("evaluate:") == 1
    assert "process 0/2 | gloo" in proc.stdout and "process 1/2 | gloo" in proc.stdout

    torch.set_num_threads(1)
    run_downstream.main(["--name", "single", "--expdir", str(tmp_path / "exp"), *flags])
    tp_dir, single_dir = tmp_path / "exp" / "tp", tmp_path / "exp" / "single"
    mesh, single = _losses(tp_dir), _losses(single_dir)
    assert [s for s, _ in mesh] == [s for s, _ in single] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in mesh], [v for _, v in single], rtol=1e-5)
    got, want = load_checkpoint(str(tp_dir)), load_checkpoint(str(single_dir))
    assert got["Global_step"] == want["Global_step"]
    for part, tree in (("Downstream", lambda p: p["Downstream"]),
                       ("mu", lambda p: p["Optimizer"]["mu"]),
                       ("nu", lambda p: p["Optimizer"]["nu"])):
        a, b = flax_to_state_dict(tree(got)), flax_to_state_dict(tree(want))
        assert sorted(a) == sorted(b), part
        for k in b:
            assert a[k].shape == b[k].shape, (part, k)
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=2e-6, rtol=0,
                                       err_msg=f"{part} {k}")


def _media_tags(expdir):
    with open(os.path.join(expdir, "media.jsonl")) as f:
        return [(m["step"], m["tag"]) for m in map(json.loads, f)]


def test_sampled_run_on_two_ranks_trains_on_rank_0s_choices(world):  # noqa: F811
    root, ckpts = world
    with open(_active_yaml(root, "active", STEPS, small=True)) as f:
        config = yaml.safe_load(f)
    # the candidate batch trains when nothing is chosen: the ranks divide it
    config["dataloader"]["active_batch_size"] = 4
    cfg = root / "active-mesh.yaml"
    cfg.write_text(yaml.safe_dump(config))
    extra = ["--sync_sampler", "--active_sampling"]
    proc = subprocess.run(
        [sys.executable, "-m", "speech_enhancement_by_s3prl_tpu_torch.run_downstream",
         "--config", str(cfg), *_flags(root, ckpts, root / "mesh", *extra), "--mesh", "2x1"],
        capture_output=True, text=True, timeout=CLI_TIMEOUT, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    torch.set_num_threads(1)
    run_downstream.main(["--config", str(cfg), *_flags(root, ckpts, root / "single", *extra)])
    mesh, single = _losses(root / "mesh" / "run"), _losses(root / "single" / "run")
    assert [s for s, _ in mesh] == [s for s, _ in single] == [2, 4]
    np.testing.assert_allclose([v for _, v in mesh], [v for _, v in single], rtol=1e-5)
    tags = _media_tags(root / "mesh" / "run")
    assert tags == _media_tags(root / "single" / "run")
    assert any("active/match" in tag for _, tag in tags)


def test_async_sampled_run_on_two_ranks_completes(world):  # noqa: F811
    """``--sampler_device 0 --active_sampling`` on two ranks: rank 0's
    sampler thread scores and collects, the other rank trains on the
    batches rank 0 hands it (the thread's timing decides them, so there is
    no single-process run to match), and the run ends."""
    root, ckpts = world
    steps = {**STEPS, "total_step": 4, "media_step": 100}
    proc = subprocess.run(
        [sys.executable, "-m", "speech_enhancement_by_s3prl_tpu_torch.run_downstream",
         "--config", _active_yaml(root, "active", steps, small=True),
         *_flags(root, ckpts, root / "async_mesh", "--active_sampling", "--sampler_device",
                 "0"), "--mesh", "2x1"],
        capture_output=True, text=True, timeout=CLI_TIMEOUT, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("step 4/4") == 1
    assert [s for s, _ in _losses(root / "async_mesh" / "run")] == [2, 4]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A flagship-structure checkpoint at hidden 8, one layer."""
    directory = str(tmp_path_factory.mktemp("ckpt"))
    _, model = entry.build(hidden_size=8, num_layers=1, device="cpu",
                           generator=torch.Generator().manual_seed(4))
    config, paras = entry.flagship_settings(hidden_size=8, num_layers=1)
    return save_checkpoint(directory, 0, model, None, config, paras)


def test_enhance_cli_mesh_matches_one_device(ckpt, tmp_path):
    torch.set_num_threads(1)
    indir = tmp_path / "noisy"
    indir.mkdir()
    rng = np.random.default_rng(1)
    names = {"a": 9000, "b": 16000, "c": 12000}
    for name, n in names.items():
        t = np.arange(n) / SR
        wav = (0.2 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(n))
        write_wav(str(indir / f"{name}.wav"), wav.astype(np.float32), SR)
    outs = {}
    for tag, extra in (("single", []), ("mesh", ["--mesh", "2"])):
        outdir = tmp_path / f"out_{tag}"
        enhance.main(["--ckpt", ckpt, "--inputs", str(indir), "--outdir", str(outdir),
                      "--device", "cpu", *extra])
        outs[tag] = {name: load_audio(str(outdir / f"{name}.wav"), sr=None)[0]
                     for name in names}
    for name, n in names.items():
        assert outs["mesh"][name].shape == (n,)
        np.testing.assert_allclose(outs["mesh"][name], outs["single"][name], atol=1e-5,
                                   err_msg=name)


def test_build_enhancer_mesh_serves_groups_and_refuses_an_odd_fixed_rows(ckpt, monkeypatch):
    torch.set_num_threads(1)
    rng = np.random.default_rng(2)
    wavs = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (7000, 8000, 6000)]
    one = serve.build_enhancer(ckpt, device="cpu")
    two = serve.build_enhancer(ckpt, device="cpu", mesh_n=2)
    assert two.devices == [torch.device("cpu")] * 2
    shards = []
    real = serve.RawEnhancer.enhance_raw

    def recorded(self, wavs_t, lens_t):
        shards.append(tuple(wavs_t.shape))
        return real(self, wavs_t, lens_t)

    monkeypatch.setattr(serve.RawEnhancer, "enhance_raw", recorded)
    for got, want in zip(two.run_batch(wavs), one.run_batch(wavs)):
        np.testing.assert_allclose(got, want, atol=1e-6)
    # 3 rows -> 4 (a power of two, a multiple of 2) -> one shard of 2 a replica
    assert [r for r, _ in shards] == [2, 2, 4]
    with pytest.raises(ValueError, match="divide evenly"):
        serve.build_enhancer(ckpt, device="cpu", mesh_n=2, fixed_rows=5)
    shards.clear()
    six = serve.build_enhancer(ckpt, device="cpu", mesh_n=2, fixed_rows=6)
    six.run_batch(wavs)
    # exactly fixed_rows rows, no power-of-two step, cut in two
    assert [r for r, _ in shards] == [3, 3]
    with pytest.raises(ValueError, match="only 1 devices visible"):
        serve.build_enhancer(ckpt, device="cpu", mesh_n=2, devices=["cpu"])


def test_mesh_1x1_in_one_process_is_the_run_without_a_mesh(corpus, tmp_path):
    """``--mesh 1x1`` outside torchrun: the CLI sets up a group of one in this
    process (its rendezvous file, gloo on the CPU), trains, tears it down,
    and logs the bits of the run without a mesh."""
    torch.set_num_threads(1)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({**_config(corpus), "runner": {
        **CFG["runner"], "total_step": 3, "eval_step": 100, "save_step": 100}}))
    flags = ["--config", str(cfg), "--upstream", "baseline", "--from_rawfeature",
             "--downstream", "LSTM", "--objective", "L1", "--dev_num", "2", "--n_jobs", "1",
             "--device", "cpu", "--expdir", str(tmp_path / "exp")]
    for name, extra in (("plain", []), ("mesh", ["--mesh", "1x1"])):
        run_downstream.main(["--name", name, *flags, *extra])
        assert not torch.distributed.is_initialized()
    mesh, plain = _losses(tmp_path / "exp" / "mesh"), _losses(tmp_path / "exp" / "plain")
    assert [s for s, _ in mesh] == [1, 2, 3] and mesh == plain


def test_under_torchrun_a_node_needs_a_card_for_each_of_its_ranks(corpus, tmp_path,
                                                                   monkeypatch):
    """``--mesh 8x1`` under torchrun on two nodes of 4 ranks: the node's 4
    ranks are held against its cards, not the mesh's 8."""

    class Joined(Exception):
        pass

    def join(*args, **kwargs):
        raise Joined

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(_config(corpus)))
    argv = ["--config", str(cfg), "--upstream", "baseline", "--from_rawfeature",
            "--downstream", "LSTM", "--objective", "L1", "--device", "cuda", "--mesh", "8x1"]
    for key, value in (("RANK", "5"), ("WORLD_SIZE", "8"), ("LOCAL_WORLD_SIZE", "4"),
                       ("LOCAL_RANK", "1")):
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(run_downstream, "initialize_distributed", join)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(Joined):
        run_downstream.main(argv)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(ValueError, match="4 ranks on this node need 4 cards, have 3"):
        run_downstream.main(argv)
