"""S3PRL checkpoint export, the inverse of ``models/torch_import.py``
(counterpart of ``speech_enhancement_by_s3prl_tpu/models/torch_export.py``).

``torch_import`` maps an S3PRL ``states-*.ckpt`` onto the port's
``state_dict`` names; this module maps them back, so that an upstream trained
here (the ``Mockingjay`` downstream is exactly encoder + SpecHead) is written
as a standard S3PRL-layout checkpoint and read again through ``--ckpt`` /
``--ckpt2``, by either package or by any S3PRL consumer.

Layout inversions:

- the fused ``qkv`` projection is split back into query / key / value thirds:
  ``nn.Linear`` weights are (out, in), so the split is along dim 0;
- ``input_ln`` / ``attention_ln`` / ``output_ln`` / ``ln`` become the S3PRL
  ``LayerNorm`` names (``weight`` / ``bias``), the Dense layers their S3PRL
  module paths.

Every value is copied exactly, so ``convert(export(state)) == state`` bit for
bit.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch

from .torch_import import StateDict, _t


def _out(sd: StateDict, state: StateDict, src: str, dst: str) -> None:
    sd[f"{dst}.weight"] = _t(state[f"{src}.weight"])
    sd[f"{dst}.bias"] = _t(state[f"{src}.bias"])


def export_transformer_state(state: StateDict) -> StateDict:
    """``TransformerEncoder`` state dict -> S3PRL ``Transformer`` state dict
    (inverse of ``torch_import.convert_transformer_state``)."""
    sd: StateDict = {}
    _out(sd, state, "spec_transform", "input_representations.spec_transform")
    _out(sd, state, "input_ln", "input_representations.LayerNorm")
    layer_ids = sorted({int(m.group(1)) for k in state
                        if (m := re.match(r"layer_(\d+)\.", k)) is not None})
    if not layer_ids:
        # a share_layer=True encoder holds one 'layer_shared' module; the
        # S3PRL layout has no weight tying, and a layer-less checkpoint would
        # load as an encoder without layers
        shared = any(k.startswith("layer_shared.") for k in state)
        raise ValueError(
            "no layer_<i> parameters to export"
            + (" (share_layer=True encoders are weight-tied and have no S3PRL "
               "state-dict layout — untie before exporting)" if shared
               else f"; got keys {sorted(state)}"))
    for i in layer_ids:
        src, pre = f"layer_{i}", f"encoder.layer.{i}"
        qkv_w, qkv_b = state[f"{src}.attention.qkv.weight"], state[f"{src}.attention.qkv.bias"]
        h = qkv_w.shape[0] // 3
        for j, name in enumerate(("query", "key", "value")):
            sd[f"{pre}.attention.self.{name}.weight"] = _t(qkv_w[j * h:(j + 1) * h])
            sd[f"{pre}.attention.self.{name}.bias"] = _t(qkv_b[j * h:(j + 1) * h])
        _out(sd, state, f"{src}.attention.output", f"{pre}.attention.output.dense")
        _out(sd, state, f"{src}.attention_ln", f"{pre}.attention.output.LayerNorm")
        _out(sd, state, f"{src}.intermediate", f"{pre}.intermediate.dense")
        _out(sd, state, f"{src}.output", f"{pre}.output.dense")
        _out(sd, state, f"{src}.output_ln", f"{pre}.output.LayerNorm")
    return sd


def export_spechead_state(state: StateDict) -> StateDict:
    """``TransformerSpecPredictionHead`` state dict -> S3PRL ``SpecHead``
    state dict (inverse of ``torch_import.convert_spechead_state``)."""
    sd: StateDict = {}
    _out(sd, state, "dense", "dense")
    _out(sd, state, "ln", "LayerNorm")
    _out(sd, state, "output", "output")
    return sd


def save_s3prl_ckpt(path: str, pretrain_config: Dict[str, Any],
                    encoder_state: Optional[StateDict] = None,
                    spechead_state: Optional[StateDict] = None, global_step: int = 0,
                    paras: Optional[Dict[str, Any]] = None) -> str:
    """Write an S3PRL-layout ``states-*.ckpt`` by ``torch.save`` (a zip
    archive, which ``runner/checkpoint.is_torch_checkpoint`` routes).

    ``pretrain_config`` is the pretraining YAML dict that travels in the
    checkpoint (``transformer`` + ``online`` sections, the schema of
    config/pretrain_sample.yaml): every consumer reads the architecture and
    the feature geometry from ``Settings.Config``, so it must describe the
    exported weights."""
    if "transformer" not in pretrain_config or "online" not in pretrain_config:
        raise ValueError(
            "pretrain_config needs 'transformer' and 'online' sections "
            "(config/pretrain_sample.yaml schema) — consumers read architecture "
            "and feature geometry from Settings.Config")
    payload: Dict[str, Any] = {
        "Settings": {"Config": pretrain_config, "Paras": dict(paras or {})},
        "Global_step": int(global_step),
    }
    if encoder_state is not None:
        payload["Transformer"] = export_transformer_state(encoder_state)
    if spechead_state is not None:
        payload["SpecHead"] = export_spechead_state(spechead_state)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path
