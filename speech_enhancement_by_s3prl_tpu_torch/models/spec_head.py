"""Pretrained-head downstream models (counterpart of
``speech_enhancement_by_s3prl_tpu/models/spec_head.py``).

``SpecHead`` is a spectrogram-prediction head used as a downstream model;
``Mockingjay`` is the whole TERA/Mockingjay encoder plus that head, trained
end to end (joint upstream finetuning). Both map ``(features, linears) ->
(predicted, {'log_predicted': ...})`` with the log-domain rule of the
pretraining target: with ``log_domain`` the raw head output is a
log-spectrum (predicted = exp(raw)); else predicted is raw and
log_predicted is log(raw + eps). The activation (ReLU by default) comes
after. Pretrained weights come from ``models/torch_import.py``; random
initialization otherwise.

``compute_dtype`` bf16 runs ``Mockingjay``'s encoder layers in bf16
(``models/transformer.py``); the spectrogram prediction head, of both
models, computes in f32, as the JAX package's has no dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .heads import Aux, activation, normalize_compute_dtype
from .transformer import (
    SaltStream,
    TransformerConfig,
    TransformerEncoder,
    TransformerSpecPredictionHead,
    as_scope,
)


def _domain(raw, log_domain: bool, eps: float, act: str):
    if log_domain:
        predicted, log_predicted = torch.exp(raw), raw
    else:
        predicted, log_predicted = raw, torch.log(raw + eps)
    return activation(act)(predicted), {"log_predicted": log_predicted}


class SpecHead(nn.Module):
    """Spec-prediction head as a downstream model."""

    def __init__(self, input_size: int = 768, output_size: int = 201,
                 config: Optional[TransformerConfig] = None, log_domain: bool = True,
                 activation: str = "ReLU", eps: float = 1e-6, compute_dtype="f32",
                 generator=None):
        super().__init__()
        normalize_compute_dtype(compute_dtype)  # f32 under either (the module docstring)
        self.config = config or TransformerConfig()
        self.log_domain, self.activation, self.eps = log_domain, activation, eps
        self.spechead = TransformerSpecPredictionHead(self.config, output_size, input_size,
                                                      generator)

    def forward(self, features, linears=None) -> Tuple[torch.Tensor, Aux]:
        raw, _ = self.spechead(features)
        return _domain(raw, self.log_domain, self.eps, self.activation)


class Mockingjay(nn.Module):
    """The full transformer + SpecHead as one finetunable downstream.
    ``features`` is the upstream-input feature (80-d log-mel + delta at the
    reference setting). With dropout live (training, rates above 0) the
    forward needs a :class:`SaltStream`."""

    takes_salts = True  # the train step hands its SaltStream to forward()

    def __init__(self, input_size: int = 160, output_size: int = 201,
                 config: Optional[TransformerConfig] = None, log_domain: bool = True,
                 activation: str = "ReLU", eps: float = 1e-6, compute_dtype="f32",
                 generator=None):
        super().__init__()
        self.config = config or TransformerConfig()
        self.log_domain, self.activation, self.eps = log_domain, activation, eps
        self.compute_dtype = normalize_compute_dtype(compute_dtype)
        self.mockingjay = TransformerEncoder(self.config, input_dim=input_size,
                                             generator=generator,
                                             compute_dtype=self.compute_dtype)
        self.spechead = TransformerSpecPredictionHead(self.config, output_size,
                                                      generator=generator)

    def forward(self, features, linears=None,
                salts: Optional[SaltStream] = None) -> Tuple[torch.Tensor, Aux]:
        # the JAX model is the apply's root and its encoder the child
        # "mockingjay", whose scope keys the encoder's sites
        scope = None if salts is None else as_scope(salts).child("mockingjay")
        raw, _ = self.spechead(self.mockingjay(features, scope))
        return _domain(raw, self.log_domain, self.eps, self.activation)
