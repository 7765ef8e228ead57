"""S3PRL checkpoint importers (counterpart of
``speech_enhancement_by_s3prl_tpu/models/torch_import.py``).

S3PRL pretrained upstreams ship as torch ``states-*.ckpt`` dicts holding
``Transformer`` / ``SpecHead`` weight blobs plus ``Settings.Config``. They are
native torch already, so importing them is key remapping onto the port's
``state_dict`` names (``models/transformer.py``):

- LayerNorm parameters come as ``gamma``/``beta`` (the early BERT lineage) or
  ``weight``/``bias``; both are accepted, both at once is an error;
- a uniform ``module.`` prefix (a ``DataParallel`` save) is stripped;
- the unfused ``query``/``key``/``value`` projections are concatenated into
  the fused ``qkv`` projection, in that order.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional

import torch

from .transformer import TransformerConfig

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().to("cpu", torch.float32).clone()


def _linear(sd, prefix: str, into: str) -> StateDict:
    return {f"{into}.weight": _t(sd[f"{prefix}.weight"]),
            f"{into}.bias": _t(sd[f"{prefix}.bias"])}


def _layernorm(sd, prefix: str, into: str) -> StateDict:
    """LayerNorm parameters under either naming of the S3PRL lineage."""
    has_wb = f"{prefix}.weight" in sd
    has_gb = f"{prefix}.gamma" in sd
    if has_wb and has_gb:
        raise ValueError(
            f"both {prefix}.weight and {prefix}.gamma present: ambiguous LayerNorm naming")
    if not (has_wb or has_gb):
        raise KeyError(
            f"no LayerNorm params at {prefix!r} (looked for .weight/.bias and .gamma/.beta)")
    w, b = ("gamma", "beta") if has_gb else ("weight", "bias")
    return {f"{into}.weight": _t(sd[f"{prefix}.{w}"]),
            f"{into}.bias": _t(sd[f"{prefix}.{b}"])}


def _strip_module_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    if sd and all(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    return sd


def convert_transformer_state(sd: Dict[str, Any]) -> StateDict:
    """S3PRL ``Transformer`` state dict -> ``TransformerEncoder`` state dict."""
    sd = _strip_module_prefix(sd)
    out = {
        **_linear(sd, "input_representations.spec_transform", "spec_transform"),
        **_layernorm(sd, "input_representations.LayerNorm", "input_ln"),
    }
    layer_ids = sorted({int(m.group(1)) for k in sd
                        if (m := re.match(r"encoder\.layer\.(\d+)\.", k)) is not None})
    if not layer_ids:
        raise ValueError(
            "no 'encoder.layer.<i>.*' keys in the Transformer state dict: got "
            f"{sorted(sd)[:8]}... (wrong payload section, or a weight-tied layout "
            "this converter does not model)")
    for i in layer_ids:
        pre, to = f"encoder.layer.{i}", f"layer_{i}"
        qkv = [_linear(sd, f"{pre}.attention.self.{p}", "p") for p in ("query", "key", "value")]
        for kind in ("weight", "bias"):  # (out, in) weights: concatenate the outputs
            out[f"{to}.attention.qkv.{kind}"] = torch.cat([p[f"p.{kind}"] for p in qkv])
        out.update(_linear(sd, f"{pre}.attention.output.dense", f"{to}.attention.output"))
        out.update(_layernorm(sd, f"{pre}.attention.output.LayerNorm", f"{to}.attention_ln"))
        out.update(_linear(sd, f"{pre}.intermediate.dense", f"{to}.intermediate"))
        out.update(_linear(sd, f"{pre}.output.dense", f"{to}.output"))
        out.update(_layernorm(sd, f"{pre}.output.LayerNorm", f"{to}.output_ln"))
    return out


def convert_spechead_state(sd: Dict[str, Any]) -> StateDict:
    """S3PRL ``SpecHead`` state dict -> ``TransformerSpecPredictionHead``
    state dict."""
    sd = _strip_module_prefix(sd)
    return {**_linear(sd, "dense", "dense"), **_layernorm(sd, "LayerNorm", "ln"),
            **_linear(sd, "output", "output")}


def _prefixed(sd: StateDict, prefix: str) -> StateDict:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def _section(sd: Dict[str, Any], name: str) -> Dict[str, Any]:
    return {k.split(".", 1)[1]: v for k, v in sd.items() if k.startswith(f"{name}.")}


def convert_lstm_state(sd: Dict[str, Any], prefix: str = "lstm") -> StateDict:
    """torch ``nn.LSTM`` state dict -> ``LSTMStack`` state dict."""
    out: StateDict = {}
    pat = re.compile(rf"{re.escape(prefix)}\.(weight|bias)_(ih|hh)_l(\d+)(_reverse)?$")
    for key, val in sd.items():
        m = pat.match(key)
        if m is None:
            continue
        kind, gate, layer, rev = m.groups()
        node = f"l{layer}_{'bwd' if rev else 'fwd'}"
        out[f"lstm.{node}.{'w' if kind == 'weight' else 'b'}_{gate}"] = _t(val)
    return out


def convert_downstream_state(sd: Dict[str, Any], model_name: str) -> StateDict:
    """A torch downstream head state dict -> the port head's state dict."""
    if model_name in ("LSTM", "Residual"):
        return {**convert_lstm_state(sd, "lstm"),
                **_linear(sd, "scaling_layer.0", "scaling_layer")}
    if model_name in ("Linear", "LinearResidual"):
        return _linear(sd, "linear", "linear")
    if model_name == "SpecHead":
        return _prefixed(convert_spechead_state(_section(sd, "spechead")), "spechead")
    if model_name == "Mockingjay":
        return {
            **_prefixed(convert_transformer_state(_section(sd, "mockingjay")), "mockingjay"),
            **_prefixed(convert_spechead_state(_section(sd, "spechead")), "spechead"),
        }
    raise ValueError(f"no converter for downstream model {model_name}")


def overlay_params(base: StateDict, overlay: StateDict) -> StateDict:
    """Strictly merge ``overlay`` into a copy of ``base``: every overlay key
    must exist in base with the same shape, so that a misnamed or misshaped
    checkpoint entry fails instead of training from random weights."""
    out = dict(base)
    for key, val in overlay.items():
        if key not in base:
            raise KeyError(f"pretrained key {key!r} not in the model's parameters")
        if tuple(base[key].shape) != tuple(val.shape):
            raise ValueError(f"shape mismatch at {key!r}: checkpoint {tuple(val.shape)} vs "
                             f"model {tuple(base[key].shape)}")
        out[key] = val
    return out


@dataclasses.dataclass
class LoadedCheckpoint:
    config: TransformerConfig
    params: Dict[str, StateDict]  # 'encoder' and/or 'spechead'
    input_dim: int
    output_size: int
    log_domain: bool
    pretrain_config: Dict[str, Any]


def _feat_dim_from_online(online: Dict[str, Any], which: str) -> int:
    from ..ops.features import PreprocessorConfig, feat_dim

    pcfg = PreprocessorConfig(
        sample_rate=online.get("sample_rate", 16000),
        win_ms=online.get("win_ms", 25),
        hop_ms=online.get("hop_ms", 10),
        n_freq=online.get("n_freq", 201),
        n_mels=online.get("n_mels", 40),
        n_mfcc=online.get("n_mfcc", 13),
    )
    return feat_dim(online[which], pcfg)


def load_s3prl_checkpoint(path: str, payload=None) -> LoadedCheckpoint:
    """Load and convert an S3PRL pretraining checkpoint (a torch pickle).
    ``payload`` is the already loaded checkpoint dict, to skip a second
    read."""
    ckpt = (payload if payload is not None
            else torch.load(path, map_location="cpu", weights_only=False))
    pretrain_config = ckpt["Settings"]["Config"]
    config = TransformerConfig.from_dict(pretrain_config)
    online = pretrain_config.get("online", {})
    input_dim = (_feat_dim_from_online(online, "input") if "input" in online
                 else config.input_dim)
    output_size = _feat_dim_from_online(online, "target") if "target" in online else 201
    log_domain = bool(online.get("target", {}).get("log", False))
    params: Dict[str, StateDict] = {}
    if "Transformer" in ckpt:
        params["encoder"] = convert_transformer_state(ckpt["Transformer"])
    if "SpecHead" in ckpt:
        params["spechead"] = convert_spechead_state(ckpt["SpecHead"])
    return LoadedCheckpoint(
        config=dataclasses.replace(config, input_dim=input_dim),
        params=params,
        input_dim=input_dim,
        output_size=output_size,
        log_domain=log_domain,
        pretrain_config=pretrain_config,
    )


def pretrained_head_params(model_name: str, ckpt: str = "", dckpt: str = "",
                           random_init: bool = False) -> Optional[StateDict]:
    """The pretrained part of a checkpoint-backed head's state dict, to
    overlay onto the initialized one: ``SpecHead`` takes the SpecHead blob of
    the upstream checkpoint ``ckpt`` (unless ``random_init``), ``Mockingjay``
    the encoder and SpecHead of ``dckpt``. None when there is nothing to
    load."""
    if model_name == "SpecHead":
        if not ckpt or random_init:
            return None
        lc = load_s3prl_checkpoint(ckpt)
        if "spechead" not in lc.params:
            raise KeyError(f"{ckpt} has no SpecHead blob")
        return _prefixed(lc.params["spechead"], "spechead")
    if model_name == "Mockingjay":
        if not dckpt:
            return None
        lc = load_s3prl_checkpoint(dckpt)
        out: StateDict = {}
        if "encoder" in lc.params:
            out.update(_prefixed(lc.params["encoder"], "mockingjay"))
        if "spechead" in lc.params:
            out.update(_prefixed(lc.params["spechead"], "spechead"))
        return out or None
    return None
