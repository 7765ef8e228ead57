"""Upstream pretraining on the port (``tools/pretrain_upstream.py``) against
the JAX package's on the CPU: ``build_run_config`` equal to
``scripts/pretrain_upstream.py``'s; one seed checkpoint trained 2 steps as
the Mockingjay downstream by both packages' ``run_downstream`` with that run
config (dropout 0; the JAX package through its own CLI), the two exported
upstreams within ``PARAM_ATOL`` and the losses within ``LOSS_RTOL``; the
tool end to end for target channels 1 and 2, its export read by the JAX
package, whose upstream gives the port's features on it within 1e-5 of
their largest value; and the tool in a process where jax, flax and the JAX
package cannot be imported."""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from speech_enhancement_by_s3prl_tpu.models import torch_export as j_export
from speech_enhancement_by_s3prl_tpu.models.torch_import import (
    load_s3prl_checkpoint as j_load_s3prl_checkpoint,
)
from speech_enhancement_by_s3prl_tpu.models.upstream import build_upstream as j_build_upstream
from speech_enhancement_by_s3prl_tpu.runner.checkpoint import (
    find_resume_ckpt as j_find_resume_ckpt,
    load_checkpoint as j_load_checkpoint,
)
from speech_enhancement_by_s3prl_tpu_torch import run_downstream
from speech_enhancement_by_s3prl_tpu_torch.data.audio_io import write_wav
from speech_enhancement_by_s3prl_tpu_torch.models.torch_export import save_s3prl_ckpt
from speech_enhancement_by_s3prl_tpu_torch.models.torch_import import load_s3prl_checkpoint
from speech_enhancement_by_s3prl_tpu_torch.models.upstream import build_upstream
from speech_enhancement_by_s3prl_tpu_torch.tools import pretrain_upstream
from tests.test_pretrain_upstream import _tiny_pretrain_yaml
from tests.test_torch_port_mockingjay import LOSS_RTOL, PARAM_ATOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# features of the upstream through the exported checkpoint, JAX against the
# port: the same f32 encoder (one layer of 16, two heads) in other summation
# orders, relative to the largest |value|
FEATURE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops on one thread (a busy multi-worker run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_pretrain_upstream.py's corpus: 4 speech and 2 noise files."""
    root = tmp_path_factory.mktemp("pretrain_corpus")
    rng = np.random.default_rng(0)
    for sub, n in [("speech", 4), ("noise", 2)]:
        (root / sub).mkdir()
        for i in range(n):
            t = int(rng.integers(6000, 16000))
            write_wav(str(root / sub / f"{sub}{i}.wav"),
                      rng.standard_normal(t).astype(np.float32) * 0.1, 16000)
    return root


def _flags(corpus, channel, expdir, cfg_path):
    return ["--name", f"up{channel}", "--expdir", str(expdir), "--config", str(cfg_path),
            "--speech", str(corpus / "speech"), "--noise", str(corpus / "noise"),
            "--target_channel", str(channel), "--total_step", "2", "--batch_size", "2"]


def test_build_run_config_matches_jax(corpus, tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    import pretrain_upstream as j_pretrain

    with open(_tiny_pretrain_yaml(str(tmp_path / "pre.yaml"), 2)) as f:
        pretrain = yaml.safe_load(f)
    for argv in (_flags(corpus, 2, tmp_path, tmp_path / "pre.yaml"),
                 ["--name", "n", "--expdir", "e", "--speech", "s", "--noise", "n",
                  "--objective", "SISDR", "--total_step", "35", "--snrs", "5", "--seed", "4",
                  "--learning_rate", "1e-3", "--batch_size", "3"]):
        args = pretrain_upstream.get_parser().parse_args(argv)
        assert pretrain_upstream.build_run_config(pretrain, args) == j_pretrain.build_run_config(
            pretrain, args)


class _Recorder:
    """A stand-in for ``tensorboardX.SummaryWriter``: keeps the scalars."""

    def __init__(self, *args, **kwargs):
        self.scalars = []

    def add_scalar(self, tag, value, global_step=None):
        self.scalars.append((global_step, tag, float(value)))

    def flush(self):
        pass


@pytest.fixture(scope="module")
def two_runs(corpus, tmp_path_factory):
    """One seed checkpoint trained 2 steps as the Mockingjay downstream by
    each package's run_downstream on the pretraining run config; the port's
    and the JAX package's exports and logged losses."""
    import tensorboardX

    root = tmp_path_factory.mktemp("two_runs")
    with open(_tiny_pretrain_yaml(str(root / "pre.yaml"), 1)) as f:
        pretrain = yaml.safe_load(f)
    seed = pretrain_upstream.seed_upstream(pretrain, 1)
    seed_path = save_s3prl_ckpt(str(root / "seed.ckpt"), pretrain,
                                seed.encoder.state_dict(), seed.spechead.state_dict())
    args = pretrain_upstream.get_parser().parse_args(
        _flags(corpus, 1, root, root / "pre.yaml"))
    cfg_path = str(root / "run_config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(pretrain_upstream.build_run_config(pretrain, args), f)

    def argv(expdir):
        return ["--name", "train", "--config", cfg_path, "--expdir", str(root / expdir),
                "--upstream", "baseline", "--upstream2", "baseline", "--from_rawfeature",
                "--downstream", "Mockingjay", "--dckpt", seed_path, "--objective", "L1",
                "--seed", "1", "--dev_num", "0"]

    run_downstream.main(argv("port") + ["--device", "cpu"])
    port_export = pretrain_upstream.export_run(str(root / "port" / "train"), pretrain,
                                               str(root / "port"), {})
    with open(root / "port" / "train" / "scalars.jsonl") as f:
        port_losses = [(rec["step"], rec["value"]) for rec in map(json.loads, f)
                       if rec["tag"] == "loss"]

    recorder = _Recorder()
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tensorboardX, "SummaryWriter", lambda *a, **k: recorder)
        mp.setattr(sys, "argv", ["run_downstream.py", *argv("jax"), "--cpu"])
        import run_downstream as j_run_downstream

        j_run_downstream.main()
    finally:
        mp.undo()
    payload = j_load_checkpoint(j_find_resume_ckpt(str(root / "jax" / "train")))
    tree = payload["Downstream"]["params"]
    jax_export = j_export.save_s3prl_ckpt(
        str(root / "jax" / f"states-{payload['Global_step']}.ckpt"), pretrain,
        encoder_params=tree["mockingjay"], spechead_params=tree["spechead"],
        global_step=payload["Global_step"])
    jax_losses = [(step, value) for step, tag, value in recorder.scalars if tag == "loss"]
    return seed_path, (port_export, port_losses), (jax_export, jax_losses)


def test_two_step_pretraining_matches_jax(two_runs):
    seed_path, (port_export, port_losses), (jax_export, jax_losses) = two_runs
    assert os.path.basename(port_export) == os.path.basename(jax_export) == "states-3.ckpt"
    assert [s for s, _ in port_losses] == [s for s, _ in jax_losses] == [1, 2]
    np.testing.assert_allclose([v for _, v in port_losses], [v for _, v in jax_losses],
                               rtol=LOSS_RTOL)
    got = torch.load(port_export, map_location="cpu", weights_only=False)
    want = torch.load(jax_export, map_location="cpu", weights_only=False)
    seed = torch.load(seed_path, map_location="cpu", weights_only=False)
    assert got["Global_step"] == want["Global_step"] == 3
    for blob in ("Transformer", "SpecHead"):
        assert list(got[blob]) == list(want[blob])
        for k in want[blob]:
            np.testing.assert_allclose(got[blob][k].numpy(), want[blob][k].numpy(),
                                       atol=PARAM_ATOL, rtol=0, err_msg=k)
        # the two steps moved the weights
        assert any(not torch.equal(got[blob][k], seed[blob][k]) for k in seed[blob])


@pytest.fixture(scope="module")
def exports(corpus, tmp_path_factory):
    """The tool end to end on the CPU, once for each target channel."""
    root = tmp_path_factory.mktemp("tool")
    out = {}
    for channel in (1, 2):
        cfg = _tiny_pretrain_yaml(str(root / f"pre{channel}.yaml"), channel)
        out[channel] = pretrain_upstream.main(
            _flags(corpus, channel, root / "exp", cfg) + ["--cpu"])
    return root, out


@pytest.mark.parametrize("channel", [1, 2])
def test_pretrain_tool_export_serves_in_both_packages(exports, channel):
    root, outs = exports
    out = outs[channel]
    assert out == str(root / "exp" / f"up{channel}" / "states-3.ckpt")
    lc = load_s3prl_checkpoint(out)
    assert lc.log_domain is True and lc.output_size == 201
    assert lc.pretrain_config["online"]["target"]["channel"] == channel
    assert lc.pretrain_config["online"]["input"]["channel"] == 0
    paras = torch.load(out, map_location="cpu", weights_only=False)["Settings"]["Paras"]
    assert paras["pretrain_upstream"]["target_channel"] == channel
    seed = load_s3prl_checkpoint(str(root / "exp" / f"up{channel}" / "seed.ckpt"))
    assert not torch.equal(seed.params["encoder"]["spec_transform.weight"],
                           lc.params["encoder"]["spec_transform.weight"])

    jlc = j_load_s3prl_checkpoint(out)
    assert jlc.input_dim == lc.input_dim and jlc.pretrain_config == lc.pretrain_config
    feats = np.random.default_rng(channel).standard_normal((2, 7, lc.input_dim)).astype(
        np.float32)
    port_up = build_upstream("transformer", lc.input_dim, ckpt=out).eval()
    jax_up = j_build_upstream("transformer", lc.input_dim, ckpt=out)
    with torch.no_grad():
        hidden = port_up(torch.from_numpy(feats))
        spec = port_up.spec_head(hidden)
    j_hidden = jax_up(jnp.asarray(feats))
    for got, want in ((hidden, j_hidden), (spec, jax_up.spec_head(j_hidden))):
        want = np.asarray(want)
        assert got.shape == want.shape and np.isfinite(want).all()
        assert np.abs(got.numpy() - want).max() <= FEATURE_TOL * np.abs(want).max()
    assert hidden.shape == (2, 7, 16) and spec.shape == (2, 7, 201)


def test_pretrain_tool_refuses_a_missing_card(corpus, tmp_path):
    """The card is the default, and the tool does not carry on on the CPU."""
    cfg = _tiny_pretrain_yaml(str(tmp_path / "pre.yaml"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_upstream.main(_flags(corpus, 1, tmp_path / "exp", cfg))
    assert not (tmp_path / "exp").exists()


_NO_JAX = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "speech_enhancement_by_s3prl_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
from speech_enhancement_by_s3prl_tpu_torch.tools.pretrain_upstream import main
print(main(sys.argv[1:]))
"""


def test_pretrain_tool_runs_without_jax(corpus, tmp_path):
    cfg = _tiny_pretrain_yaml(str(tmp_path / "pre.yaml"), 2)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, *_flags(corpus, 2, tmp_path / "exp", cfg), "--cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.strip().splitlines()[-1]
    assert out == str(tmp_path / "exp" / "up2" / "states-3.ckpt") and os.path.exists(out)
    assert load_s3prl_checkpoint(out).pretrain_config["online"]["target"]["channel"] == 2


def test_pretrain_tool_flags_are_the_jax_scripts(monkeypatch):
    """Flag for flag: every flag of scripts/pretrain_upstream.py with its
    default, ``--device`` in place of ``--cpu`` (which stays as its alias)."""
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    import argparse

    import pretrain_upstream as j_pretrain

    seen = {}

    class Stop(Exception):
        pass

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Stop):
        j_pretrain.main([])
    monkeypatch.undo()
    def flags(parser):
        return {(a.option_strings or [a.dest])[0]: a.default for a in parser._actions
                if a.dest != "help"}

    j_flags, t_flags = flags(seen["parser"]), flags(pretrain_upstream.get_parser())
    assert j_flags.pop("--cpu") is False and t_flags.pop("--cpu") is None
    assert t_flags.pop("--device") == "cuda"
    j_flags["--config"] = os.path.relpath(j_flags["--config"], REPO)
    t_flags["--config"] = os.path.relpath(t_flags["--config"], REPO)
    assert t_flags == j_flags
    args = pretrain_upstream.get_parser().parse_args(
        ["--name", "n", "--expdir", "e", "--speech", "s", "--noise", "n", "--cpu"])
    assert args.device == "cpu"
