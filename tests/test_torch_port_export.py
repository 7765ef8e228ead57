"""The port's S3PRL export (``models/torch_export.py``) and checkpoint
converter (``tools/convert_torch_ckpt.py``) against the JAX package's on the
CPU, bit for bit: a flax encoder and SpecHead drawn by the JAX
``UpstreamTransformer`` at a tiny width, bridged into the port by
``flax_to_state_dict``, exported by both packages to the same keys and
values; a checkpoint written by either read by the other; the weight-tied
(``share_layer``) encoder refused by both; and the converter's payload
against the one ``scripts/convert_torch_ckpt.py`` writes, for an upstream
and for a downstream checkpoint."""
import argparse
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from speech_enhancement_by_s3prl_tpu.models import torch_export as j_export
from speech_enhancement_by_s3prl_tpu.models import torch_import as j_import
from speech_enhancement_by_s3prl_tpu.models.transformer import (
    TransformerConfig as JTransformerConfig,
)
from speech_enhancement_by_s3prl_tpu.models.upstream import UpstreamTransformer as JUpstream
from speech_enhancement_by_s3prl_tpu_torch.models import torch_export, torch_import
from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_to_state_dict
from speech_enhancement_by_s3prl_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerEncoder,
)
from speech_enhancement_by_s3prl_tpu_torch.tools import convert_torch_ckpt
from tests.test_spechead_pretrained import INPUT_DIM, _pretrain_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops on one thread (a busy multi-worker run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_upstream():
    """The JAX package's encoder and SpecHead at a tiny width, drawn once."""
    cfg = JTransformerConfig.from_dict(_pretrain_config())
    up = JUpstream(cfg, input_dim=INPUT_DIM, output_size=201, seed=3, log_domain=True)
    return jax.device_get(up.params)


def _port_states(params):
    return {name: flax_to_state_dict(params[name]) for name in ("encoder", "spechead")}


def _assert_state_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


def _assert_tree_equal(got, want, path=""):
    """Nested dicts of arrays (or tensors) and plain values, equal leaf for
    leaf with the same keys, arrays bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, torch.Tensor)) or hasattr(want, "__array__"):
        a, b = np.asarray(got), np.asarray(want)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("which", ["encoder", "spechead"])
def test_export_state_matches_jax(jax_upstream, which):
    port_fn, jax_fn = {
        "encoder": (torch_export.export_transformer_state, j_export.export_transformer_state),
        "spechead": (torch_export.export_spechead_state, j_export.export_spechead_state),
    }[which]
    got = port_fn(_port_states(jax_upstream)[which])
    want = jax_fn(jax_upstream[which])
    _assert_state_equal(got, want)
    # the inverse of the importer: convert(export(state)) is the state
    back = {"encoder": torch_import.convert_transformer_state,
            "spechead": torch_import.convert_spechead_state}[which](got)
    state = _port_states(jax_upstream)[which]
    assert set(back) == set(state) and all(torch.equal(back[k], state[k]) for k in state)


def test_port_checkpoint_reads_in_jax_bit_for_bit(jax_upstream, tmp_path):
    path = str(tmp_path / "states-7.ckpt")
    states = _port_states(jax_upstream)
    out = torch_export.save_s3prl_ckpt(path, _pretrain_config(), states["encoder"],
                                       states["spechead"], global_step=7,
                                       paras={"exported_by": "port"})
    assert out == path and not os.path.exists(path + ".tmp")
    from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import is_torch_checkpoint

    assert is_torch_checkpoint(path)  # a zip archive, routed as an S3PRL checkpoint
    lc = j_import.load_s3prl_checkpoint(path)
    _assert_tree_equal(lc.params, jax_upstream)
    assert lc.log_domain is True and lc.input_dim == INPUT_DIM
    payload = torch.load(path, map_location="cpu", weights_only=False)
    assert payload["Global_step"] == 7
    assert payload["Settings"] == {"Config": _pretrain_config(),
                                   "Paras": {"exported_by": "port"}}


def test_jax_checkpoint_reads_in_the_port_bit_for_bit(jax_upstream, tmp_path):
    path = str(tmp_path / "states-9.ckpt")
    j_export.save_s3prl_ckpt(path, _pretrain_config(), jax_upstream["encoder"],
                             jax_upstream["spechead"], global_step=9)
    lc = torch_import.load_s3prl_checkpoint(path)
    states = _port_states(jax_upstream)
    for name in ("encoder", "spechead"):
        got = lc.params[name]
        assert set(got) == set(states[name])
        assert all(torch.equal(got[k], states[name][k]) for k in got), name
    assert lc.log_domain is True and lc.input_dim == INPUT_DIM


def test_save_requires_transformer_and_online_sections(jax_upstream, tmp_path):
    states = _port_states(jax_upstream)
    with pytest.raises(ValueError, match="'transformer' and 'online'"):
        torch_export.save_s3prl_ckpt(str(tmp_path / "bad.ckpt"), {"transformer": {}},
                                     states["encoder"])
    assert not os.listdir(tmp_path)


def test_share_layer_is_refused_by_both():
    cfg = {**_pretrain_config()["transformer"], "share_layer": True}
    jax_params = jax.device_get(JUpstream(JTransformerConfig.from_dict(cfg), INPUT_DIM,
                                          seed=1).params["encoder"])
    with pytest.raises(ValueError, match="share_layer=True") as jax_err:
        j_export.export_transformer_state(jax_params)
    port = TransformerEncoder(TransformerConfig.from_dict(cfg), input_dim=INPUT_DIM)
    with pytest.raises(ValueError, match="share_layer=True") as port_err:
        torch_export.export_transformer_state(port.state_dict())
    assert "untie before exporting" in str(jax_err.value) and "untie before exporting" in str(
        port_err.value)
    layerless = {k: v for k, v in port.state_dict().items() if not k.startswith("layer_")}
    with pytest.raises(ValueError, match="no layer_<i>"):
        torch_export.export_transformer_state(layerless)


# -- the converter ----------------------------------------------------------------------

def _jax_convert(argv, monkeypatch):
    """``scripts/convert_torch_ckpt.py`` run as its CLI; its payload."""
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    import convert_torch_ckpt as j_convert

    monkeypatch.setattr(sys, "argv", ["convert_torch_ckpt.py", *argv])
    j_convert.main()
    with open(argv[argv.index("--out") + 1], "rb") as f:
        return pickle.load(f)


def test_converter_upstream_matches_jax(jax_upstream, tmp_path, monkeypatch):
    src = str(tmp_path / "states-3.ckpt")
    j_export.save_s3prl_ckpt(src, _pretrain_config(), jax_upstream["encoder"],
                             jax_upstream["spechead"], global_step=3)
    out = str(tmp_path / "port.pkl")
    assert convert_torch_ckpt.main([src, "--out", out]) == out
    with open(out, "rb") as f:
        got = pickle.load(f)
    want = _jax_convert([src, "--out", str(tmp_path / "jax.pkl")], monkeypatch)
    _assert_tree_equal(got, want)
    _assert_tree_equal(got["Upstream"], jax_upstream)


@pytest.mark.parametrize("blob", ["Downstream", "SmallModel"])
def test_converter_downstream_matches_jax(tmp_path, monkeypatch, blob):
    gen = torch.Generator().manual_seed(4)
    lstm = torch.nn.LSTM(40, 8, num_layers=2, bidirectional=True, batch_first=True)
    with torch.no_grad():
        for p in lstm.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    sd = {**{f"lstm.{k}": v for k, v in lstm.state_dict().items()},
          "scaling_layer.0.weight": torch.randn(201, 16, generator=gen),
          "scaling_layer.0.bias": torch.randn(201, generator=gen)}
    if blob == "SmallModel":  # the reference's own checkpoints: a module prefix
        sd = {f"model.{k}": v for k, v in sd.items()}
    src = str(tmp_path / "downstream.ckpt")
    torch.save({blob: sd, "Global_step": 12, "Settings": {
        "Config": {"model": {"LSTM": {"hidden_size": 8}}},
        "Paras": argparse.Namespace(downstream="LSTM", seed=3)}}, src)
    argv = [src, "--kind", "downstream", "--downstream", "LSTM"]
    out = convert_torch_ckpt.main(argv + ["--out", str(tmp_path / "port.pkl")])
    with open(out, "rb") as f:
        got = pickle.load(f)
    want = _jax_convert(argv + ["--out", str(tmp_path / "jax.pkl")], monkeypatch)
    _assert_tree_equal(got, want)
    assert got["Global_step"] == 12 and got["Settings"]["Paras"] == {"downstream": "LSTM",
                                                                     "seed": 3}
    # the native payload loads as a checkpoint of the port
    from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import load_checkpoint

    _assert_tree_equal(load_checkpoint(out), want)
