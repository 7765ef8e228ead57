"""Upstream models (counterpart of
``speech_enhancement_by_s3prl_tpu/models/upstream.py``).

- ``UpstreamTransformer``: the TERA/Mockingjay encoder with its spec head and
  the reference's options: ``no_grad`` (detach), a ``dropout`` override
  (which also makes the upstream run in train mode while the head trains),
  ``select_layer``, ``weighted_sum`` and ``spec_aug``;
- ``DummyUpstream``: the identity, for the no-SSL baseline;
- both map (B, T, feat) input features to (B, T', out_dim) hidden states.

Both are ``nn.Module``s: ``.train()`` puts the encoder's dropout live (it then
needs a ``SaltStream``), ``.to(device)`` moves the weights. Their state dict
keys (``encoder.*``, ``spechead.*``, ``layer_weights``) are the JAX
package's parameter tree under ``models/convert.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..utils import prng
from .heads import normalize_compute_dtype
from .transformer import (
    SaltStream,
    TransformerConfig,
    TransformerEncoder,
    TransformerSpecPredictionHead,
)


def apply_spec_aug(feat: torch.Tensor, key, time_masks: int = 2, time_width: int = 30,
                   freq_masks: int = 2, freq_width: int = 12, batch0: int = 0,
                   global_batch: Optional[int] = None) -> torch.Tensor:
    """SpecAugment-style time and frequency band masking of (B, T, D)
    features, the JAX package's ``apply_spec_aug`` from the same ``key`` (its
    ``rngs["dropout"]``): ``split(key, 4)``, the time starts
    ``randint(keys[0], (rows, time_masks), 0, max(T - time_width, 1))`` and
    the frequency starts from ``keys[1]`` alike (``utils/prng.py``), each
    band [start, start + width). Rows b of ``feat`` are rows ``batch0`` + b of
    a batch of ``global_batch`` (a data-parallel rank's): the starts are
    drawn for the whole batch and the rank keeps its rows."""
    B, T, D = feat.shape
    rows = B if global_batch is None else int(global_batch)
    keys = prng.split(key, 4)

    def band(k, n, width, size):
        starts = prng.randint(k, (rows, n), 0, max(size - width, 1))[batch0:batch0 + B]
        pos = torch.arange(size)[None, None, :]
        s = starts[..., None]
        return ((pos >= s) & (pos < s + width)).any(dim=1)  # (B, size)

    t_mask = band(keys[0], time_masks, time_width, T)
    f_mask = band(keys[1], freq_masks, freq_width, D)
    keep = (~t_mask[:, :, None]) & (~f_mask[:, None, :])
    return feat * keep.to(device=feat.device, dtype=feat.dtype)


class DummyUpstream(nn.Module):
    """The identity upstream."""

    trainable = False

    def __init__(self, input_dim: int):
        super().__init__()
        self.out_dim = input_dim

    def forward(self, features, salts=None):
        return features

    def spec_head(self, hidden):
        raise NotImplementedError("dummy upstream has no SpecHead")


@dataclasses.dataclass
class UpstreamOptions:
    """The upstream options of the reference's ``run_downstream.py``."""

    no_grad: bool = False
    dropout: Optional[float] = None  # None keeps the checkpoint's dropout
    spec_aug: bool = False  # masks the input features, before the encoder
    weighted_sum: bool = False
    select_layer: int = -1


class UpstreamTransformer(nn.Module):
    """The transformer upstream with its spec head. ``forward`` maps input
    features to hidden states; ``spec_head`` maps hidden states to the
    predicted linear power spectrum. ``state`` is a dict with 'encoder' and,
    optionally, 'spechead' state dicts (``torch_import.LoadedCheckpoint.
    params``); random weights from ``generator`` otherwise. ``compute_dtype``
    (f32 or bf16) is the encoder's; its output and the spec head are f32."""

    def __init__(self, config: TransformerConfig, input_dim: int,
                 options: Optional[UpstreamOptions] = None, output_size: int = 201,
                 state=None, log_domain: bool = False,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.options = options or UpstreamOptions()
        if self.options.dropout is not None:
            rate = float(self.options.dropout)
            config = dataclasses.replace(config, hidden_dropout_prob=rate,
                                         attention_probs_dropout_prob=rate)
        self.config = config
        self.encoder = TransformerEncoder(config, input_dim=input_dim, generator=generator,
                                          compute_dtype=compute_dtype)
        self.spechead = TransformerSpecPredictionHead(config, output_size,
                                                      generator=generator)
        if self.options.weighted_sum:
            self.register_buffer("layer_weights", torch.zeros(config.num_hidden_layers))
        if state:
            self.encoder.load_state_dict(state["encoder"])
            if "spechead" in state:
                self.spechead.load_state_dict(state["spechead"])
        self.out_dim = config.hidden_size
        self.log_domain = log_domain
        # a dropout override asks for train-mode finetuning of the upstream
        self.trainable = self.options.dropout is not None

    def forward(self, features: torch.Tensor, salts: Optional[SaltStream] = None):
        opts = self.options
        if opts.spec_aug and self.training and salts is not None:
            features = apply_spec_aug(features, salts.key, batch0=salts.batch0,
                                      global_batch=salts.global_batch)
        use_all = opts.weighted_sum or opts.select_layer != -1
        out = self.encoder(features, salts if self.training else None,
                           output_all_layers=use_all)
        if use_all:
            if opts.weighted_sum:
                w = torch.softmax(self.layer_weights, dim=0)
                out = torch.einsum("l...,l->...", out, w)
            else:
                out = out[opts.select_layer]
        if opts.no_grad and not self.trainable:
            out = out.detach()
        return out

    def spec_head(self, hidden: torch.Tensor) -> torch.Tensor:
        """The predicted linear power spectrum: exp when the pretraining
        target was a log-spectrum, then ReLU."""
        raw, _ = self.spechead(hidden)
        return torch.relu(torch.exp(raw) if self.log_domain else raw)


def build_upstream(upstream: str, input_dim: int, ckpt: str = "",
                   dropout: Optional[float] = None, output_size: int = 201, seed: int = 0,
                   payload=None, compute_dtype=None):
    """'transformer' loads the encoder (and SpecHead) of the S3PRL checkpoint
    ``ckpt``, or draws a full-size one from ``seed``; 'baseline' is the
    identity. ``payload`` is ``ckpt`` already loaded. ``compute_dtype`` ('f32' |
    'bf16' or a torch dtype; None is f32) is the encoder's. Built on the CPU."""
    dt = normalize_compute_dtype(compute_dtype)
    if upstream == "baseline":
        return DummyUpstream(input_dim)
    if upstream != "transformer":
        raise ValueError(f"unknown upstream {upstream}")
    opts = UpstreamOptions(dropout=dropout)
    if ckpt:
        from .torch_import import load_s3prl_checkpoint

        lc = load_s3prl_checkpoint(ckpt, payload=payload)
        return UpstreamTransformer(lc.config, lc.input_dim, opts, lc.output_size,
                                   state=lc.params, log_domain=lc.log_domain,
                                   compute_dtype=dt)
    return UpstreamTransformer(TransformerConfig(input_dim=input_dim), input_dim, opts,
                               output_size, generator=torch.Generator().manual_seed(seed),
                               compute_dtype=dt)
