"""Downstream enhancement heads (counterpart of
``speech_enhancement_by_s3prl_tpu/models/heads.py``).

Every head maps ``(features, linears) -> (predicted_linear, aux_dict)``:
``features`` is the downstream input (B, T, D) and ``linears`` the noisy
POWER spectrogram (B, T, 201). Parameter names follow the flax modules, so
``models/convert.py`` maps one onto the other. Initialization follows the
JAX package (torch-default Linear for ``Linear``/``LinearResidual``,
xavier-uniform Dense with zero bias behind an LSTM) from a
``torch.Generator``.
"""
from __future__ import annotations

import inspect
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .lstm import LSTMStack

Aux = Dict[str, torch.Tensor]

ACTIVATIONS: Dict[str, Callable] = {
    "Identity": lambda x: x,
    "ReLU": torch.relu,
    "Sigmoid": torch.sigmoid,
    "Tanh": torch.tanh,
    # jax.nn.gelu defaults to the tanh approximation
    "GELU": lambda x: F.gelu(x, approximate="tanh"),
    "LeakyReLU": lambda x: F.leaky_relu(x, 0.01),
    "ELU": F.elu,
    "Softplus": F.softplus,
}

F32_NAMES = ("f32", "float32", "fp32")


def activation(name: str) -> Callable:
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name}")
    return ACTIVATIONS[name]


def torch_linear(fan_in: int, out: int, generator=None) -> nn.Linear:
    """nn.Linear with torch's default init, U(±1/sqrt(fan_in)) for weight
    and bias, drawn from ``generator``."""
    layer = nn.Linear(fan_in, out)
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        nn.init.uniform_(layer.weight, -bound, bound, generator=generator)
        nn.init.uniform_(layer.bias, -bound, bound, generator=generator)
    return layer


def xavier_linear(fan_in: int, out: int, generator=None) -> nn.Linear:
    """nn.Linear with xavier-uniform weight and zero bias."""
    layer = nn.Linear(fan_in, out)
    with torch.no_grad():
        nn.init.xavier_uniform_(layer.weight, generator=generator)
        layer.bias.zero_()
    return layer


def cmvn_t(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-utterance time normalization with unbiased std."""
    mean = x.mean(dim=1, keepdim=True)
    var = ((x - mean) ** 2).sum(dim=1, keepdim=True) / max(x.shape[1] - 1, 1)
    return (x - mean) / (torch.sqrt(var) + eps)


class Linear(nn.Module):
    """Direct spectrum regression."""

    def __init__(self, input_size: int, output_size: int, activation: str = "ReLU",
                 generator=None):
        super().__init__()
        self.activation = activation
        self.linear = torch_linear(input_size, output_size, generator)

    def forward(self, features, linears=None) -> Tuple[torch.Tensor, Aux]:
        return activation(self.activation)(self.linear(features)), {}


class LinearResidual(nn.Module):
    """Sigmoid mask times noisy linear, optional input CMVN."""

    def __init__(self, input_size: int = 201, output_size: int = 201,
                 activation: str = "Sigmoid", cmvn: bool = True, eps: float = 1e-6,
                 generator=None):
        super().__init__()
        self.activation, self.cmvn, self.eps = activation, cmvn, eps
        self.linear = torch_linear(input_size, output_size, generator)

    def forward(self, features, linears) -> Tuple[torch.Tensor, Aux]:
        if self.cmvn:
            features = cmvn_t(features, self.eps)
        offset = activation(self.activation)(self.linear(features))
        return linears * offset, {"offset": offset}


class LSTM(nn.Module):
    """LSTM -> scaling layer -> exp: predicts the log-magnitude spectrum.
    aux carries ``log_predicted``."""

    def __init__(self, input_size: int = 201, output_size: int = 201,
                 hidden_size: int = 201, num_layers: int = 3,
                 bidirectional: bool = False, activation: str = "Identity",
                 generator=None):
        super().__init__()
        self.activation = activation
        self.lstm = LSTMStack(input_size, hidden_size, num_layers, bidirectional,
                              generator)
        out_in = (2 if bidirectional else 1) * hidden_size
        self.scaling_layer = xavier_linear(out_in, output_size, generator)

    def forward(self, features, linears=None) -> Tuple[torch.Tensor, Aux]:
        log_predicted = activation(self.activation)(
            self.scaling_layer(self.lstm(features))
        )
        return torch.exp(log_predicted), {"log_predicted": log_predicted}


class Residual(nn.Module):
    """LSTM mask times noisy linear. aux carries ``offset``."""

    def __init__(self, input_size: int = 201, output_size: int = 201,
                 hidden_size: int = 201, num_layers: int = 3,
                 bidirectional: bool = False, activation: str = "Sigmoid",
                 cmvn: bool = False, eps: float = 1e-6, generator=None):
        super().__init__()
        self.activation, self.cmvn, self.eps = activation, cmvn, eps
        self.lstm = LSTMStack(input_size, hidden_size, num_layers, bidirectional,
                              generator)
        out_in = (2 if bidirectional else 1) * hidden_size
        self.scaling_layer = xavier_linear(out_in, output_size, generator)

    def forward(self, features, linears) -> Tuple[torch.Tensor, Aux]:
        offset = self.lstm(features)
        if self.cmvn:
            offset = cmvn_t(offset, self.eps)
        offset = activation(self.activation)(self.scaling_layer(offset))
        return linears * offset, {"offset": offset}


REGISTRY = {
    "Linear": Linear,
    "LinearResidual": LinearResidual,
    "LSTM": LSTM,
    "Residual": Residual,
}


def build_head(model_name: str, input_size: int, output_size: int,
               generator: Optional[torch.Generator] = None, **cfg) -> nn.Module:
    """Registry of the heads. Extra kwargs (the args namespace a CLI or a
    checkpoint's Settings carry) are filtered to the head's own arguments.
    The module is built on the CPU; move it with ``.to(device)``. The LSTM
    heads run the default recurrence: ``recurrence`` is refused here, as it
    is a switch of ``LSTMStack`` alone.

    ``SpecHead`` and ``Mockingjay`` take their structure (the transformer
    config, ``log_domain`` and, for Mockingjay, the output width) from the
    S3PRL pretraining checkpoint ``ckpt`` (SpecHead) or ``dckpt``
    (Mockingjay) when one is given; their pretrained weights are overlaid by
    the Runner. A ``config`` that is a string (the CLI's YAML path) is
    dropped, and a dict (a YAML model section) becomes a
    ``TransformerConfig``."""
    from .spec_head import Mockingjay, SpecHead  # spec_head imports this module
    from .transformer import TransformerConfig

    registry = {**REGISTRY, "SpecHead": SpecHead, "Mockingjay": Mockingjay}
    if model_name not in registry:
        raise ValueError(f"unknown downstream model {model_name}")
    if "recurrence" in cfg:
        raise TypeError("build_head takes no 'recurrence': every head runs the "
                        "default recurrence (it is an attribute of a built "
                        "model's LSTMStack)")
    if cfg.get("capture_layer") is not None:
        raise NotImplementedError(
            "capture_layer instrumentation for the active sampler is not "
            "ported yet (ROADMAP A9)"
        )
    dtype = cfg.get("compute_dtype", "f32")
    if isinstance(dtype, str) and dtype.lower() not in F32_NAMES:
        raise NotImplementedError(
            f"compute_dtype {dtype!r}: the port computes in f32 only; bf16 "
            "compute is not ported yet (ROADMAP A14)"
        )
    cfg = dict(cfg)
    ckpt_path = cfg.get("dckpt" if model_name == "Mockingjay" else "ckpt", "")
    if model_name in ("SpecHead", "Mockingjay") and ckpt_path:
        from .torch_import import load_s3prl_checkpoint

        lc = load_s3prl_checkpoint(ckpt_path)
        cfg["config"], cfg["log_domain"] = lc.config, lc.log_domain
        if model_name == "Mockingjay":
            # the reference takes the pretraining target's width, not the
            # requested one
            output_size = lc.output_size
        elif "spechead" in lc.params:
            width = lc.params["spechead"]["output.weight"].shape[0]
            if width != output_size:
                raise ValueError(f"checkpoint SpecHead width {width} != requested "
                                 f"{output_size}")
    if isinstance(cfg.get("config"), str):
        cfg.pop("config")
    elif isinstance(cfg.get("config"), dict):
        cfg["config"] = TransformerConfig(**cfg["config"])
    cls = registry[model_name]
    fields = set(inspect.signature(cls).parameters) - {
        "input_size", "output_size", "generator",
    }
    kwargs = {k: v for k, v in cfg.items() if k in fields}
    return cls(input_size=input_size, output_size=output_size,
               generator=generator, **kwargs)
