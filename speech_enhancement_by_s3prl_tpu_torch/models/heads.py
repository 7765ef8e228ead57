"""Downstream enhancement heads (counterpart of
``speech_enhancement_by_s3prl_tpu/models/heads.py``).

Every head maps ``(features, linears) -> (predicted_linear, aux_dict)``:
``features`` is the downstream input (B, T, D) and ``linears`` the noisy
POWER spectrogram (B, T, 201). Parameter names follow the flax modules, so
``models/convert.py`` maps one onto the other. Initialization follows the
JAX package (torch-default Linear for ``Linear``/``LinearResidual``,
xavier-uniform Dense with zero bias behind an LSTM) from a
``torch.Generator``.

A ``capture`` (a ``models.lstm.Capture``: an LSTM layer index or ``"all"``)
handed to a forward records streams for the per-sample gradient scorer
(``active/sampler.py``): the selected LSTM layers' (``models/lstm.py``) and,
under ``"all"``, the input and pre-activation output of the head's Dense
(``scaling_xs`` / ``scaling_xw``, or ``linear_xs`` / ``linear_xw`` in
``Linear`` and ``LinearResidual``, which record them for any ``capture``).
``build_head`` takes the JAX modules' ``capture_layer`` and passes it to no
module: the selection is per call.

``compute_dtype`` ('f32' | 'bf16', the CLI's ``--compute_dtype`` and a
checkpoint's ``Settings.Paras``; ``normalize_compute_dtype`` reads it) is
taken by ``LSTM`` / ``Residual`` (the stack's projection and W_hh^T in
bf16, and in a one-direction stack h in the step product, the JAX scan
cell's bf16 form: ``models/lstm.py``; the ``scaling_layer`` stays f32, as its
flax Dense has no dtype), ``Mockingjay`` (the encoder's bf16 products,
``models/transformer.py``; the spec head stays f32) and ``SpecHead``, which
computes in f32 under either, as the JAX module has no dtype.
"""
from __future__ import annotations

import inspect
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .lstm import LSTMStack, captured

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

DTYPE_ALIASES = {
    "f32": torch.float32, "float32": torch.float32, "fp32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
}


def normalize_compute_dtype(value) -> torch.dtype:
    """The CLI's / a checkpoint's dtype word ('f32' | 'bf16', any case) ->
    torch dtype; None is f32 and a torch dtype of the two passes through (the
    port's copy of the JAX package's ``normalize_compute_dtype``)."""
    if value is None:
        return torch.float32
    if isinstance(value, str):
        try:
            return DTYPE_ALIASES[value.lower()]
        except KeyError:
            raise ValueError(f"unknown compute_dtype {value!r}; use one of "
                             f"{sorted(DTYPE_ALIASES)}") from None
    if value not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be f32 or bf16, got {value!r}")
    return value


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

    def forward(self, features, linears=None, capture=None) -> Tuple[torch.Tensor, Aux]:
        return activation(self.activation)(_dense(self.linear, features, capture,
                                                  "linear")), {}


class LinearResidual(nn.Module):
    """Sigmoid mask times noisy linear, optional input CMVN."""

    def __init__(self, input_size: int = 201, output_size: int = 201,
                 activation: str = "Sigmoid", cmvn: bool = True, eps: float = 1e-6,
                 generator=None):
        super().__init__()
        self.activation, self.cmvn, self.eps = activation, cmvn, eps
        self.linear = torch_linear(input_size, output_size, generator)

    def forward(self, features, linears, capture=None) -> Tuple[torch.Tensor, Aux]:
        if self.cmvn:
            features = cmvn_t(features, self.eps)
        offset = activation(self.activation)(_dense(self.linear, features, capture, "linear"))
        return linears * offset, {"offset": offset}


def _dense(layer: nn.Linear, x, capture, name: str):
    """``layer(x)``, its input and output recorded into ``capture`` as
    ``{name}_xs`` / ``{name}_xw`` when one is given."""
    out = layer(x)
    if capture is not None:
        capture.update({f"{name}_xs": x, f"{name}_xw": out})
    return out


def _run_stack(stack: LSTMStack, features, lstm_state, capture):
    """The stack's output and, when ``lstm_state`` (one (h, c) per layer) is
    given, the aux entry of its final states: the streaming continuation of
    ``ops/streaming.StatefulStreamer``."""
    if lstm_state is None:
        return stack(features, capture=capture), {}
    out, state = stack(features, initial_state=lstm_state, return_state=True,
                       capture=capture)
    return out, {"lstm_state": state}


class LSTM(nn.Module):
    """LSTM -> scaling layer -> exp: predicts the log-magnitude spectrum.
    aux carries ``log_predicted``, and ``lstm_state`` (the final per-layer
    (h, c)) when the call passes ``lstm_state``."""

    def __init__(self, input_size: int = 201, output_size: int = 201,
                 hidden_size: int = 201, num_layers: int = 3,
                 bidirectional: bool = False, activation: str = "Identity",
                 compute_dtype="f32", generator=None):
        super().__init__()
        self.activation = activation
        self.compute_dtype = normalize_compute_dtype(compute_dtype)
        self.lstm = LSTMStack(input_size, hidden_size, num_layers, bidirectional,
                              generator, compute_dtype=self.compute_dtype)
        out_in = (2 if bidirectional else 1) * hidden_size
        self.scaling_layer = xavier_linear(out_in, output_size, generator)

    def forward(self, features, linears=None, lstm_state=None,
                capture=None) -> Tuple[torch.Tensor, Aux]:
        hs, aux = _run_stack(self.lstm, features, lstm_state, capture)
        dense_capture = capture if captured(capture, "scaling") else None
        log_predicted = activation(self.activation)(
            _dense(self.scaling_layer, hs, dense_capture, "scaling"))
        return torch.exp(log_predicted), {"log_predicted": log_predicted, **aux}


class Residual(nn.Module):
    """LSTM mask times noisy linear. aux carries ``offset``, and
    ``lstm_state`` when the call passes ``lstm_state``."""

    def __init__(self, input_size: int = 201, output_size: int = 201,
                 hidden_size: int = 201, num_layers: int = 3,
                 bidirectional: bool = False, activation: str = "Sigmoid",
                 cmvn: bool = False, eps: float = 1e-6, compute_dtype="f32",
                 generator=None):
        super().__init__()
        self.activation, self.cmvn, self.eps = activation, cmvn, eps
        self.compute_dtype = normalize_compute_dtype(compute_dtype)
        self.lstm = LSTMStack(input_size, hidden_size, num_layers, bidirectional,
                              generator, compute_dtype=self.compute_dtype)
        out_in = (2 if bidirectional else 1) * hidden_size
        self.scaling_layer = xavier_linear(out_in, output_size, generator)

    def forward(self, features, linears, lstm_state=None,
                capture=None) -> Tuple[torch.Tensor, Aux]:
        offset, aux = _run_stack(self.lstm, features, lstm_state, capture)
        if self.cmvn:
            offset = cmvn_t(offset, self.eps)
        dense_capture = capture if captured(capture, "scaling") else None
        offset = activation(self.activation)(
            _dense(self.scaling_layer, offset, dense_capture, "scaling"))
        return linears * offset, {"offset": offset, **aux}


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
