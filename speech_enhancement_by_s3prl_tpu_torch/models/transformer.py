"""TERA/Mockingjay transformer encoder (counterpart of
``speech_enhancement_by_s3prl_tpu/models/transformer.py``).

A BERT-style post-LN encoder over spectrogram frames (6 layers x 768 x 12
heads x FFN 3072, exact-erf gelu at the reference size) with one fused QKV
projection per layer, sinusoidal position encodings, ``downsample_rate``
frame stacking and an optional shared layer, plus the spectrogram
prediction head. Submodule names follow the flax modules (``layer_0.
attention.qkv``, ``attention_ln``, ``intermediate``, ``output``,
``output_ln``; ``dense`` / ``ln`` / ``output`` in the head), so the weight
bridge of ``models/convert.py`` only renames. Initialization follows the
JAX package: Dense weights normal(0, ``initializer_range``) and zero biases,
LayerNorms at one and zero, drawn from a ``torch.Generator``.

Dropout. Every mask is the JAX package's, drawn from the same key: a
forward takes a :class:`SaltStream` (``utils/flax_rng.KeyStream``), whose
key is JAX's ``rngs["dropout"]`` (the train step's ``fold_in(step key,
step)``, ``runner/trainer.py``), and each module hands its sites flax's keys
(``Scope``: the module path under the apply's root, SHA-1 folded, a count a
scope; ``nn.Dropout`` children auto-named ``Dropout_<k>``). The routes read
the JAX package's variables at each forward, as it reads them at trace time:

==========================  ==================================================
hidden states (13 sites)    ``SE_HIDDEN_DROPOUT_IMPL`` unset / ``flax``: flax
                            ``nn.Dropout``, kernel D1 (``ops/cuda/
                            dropout_kernel``) from the key of the module's
                            ``Dropout_<k>``; ``hash``: the salted hash
                            ``_hash_mask_apply``, its salt ``bits(key, (2,))``
                            of the module's next key
attention probabilities     ``SE_ATTN_IMPL=flash``: B3's hash (the Pallas
(rate > 0, training)        kernel's), salt from the module's next key;
                            ``SE_ATTN_DROPOUT_CHUNK`` > 0 (not ``naive``): the
                            chunked path's per-chunk keys ``fold_in(key, i)``,
                            hash masks unless ``SE_DROPOUT_IMPL=flax``;
                            otherwise (``fused``, the default, or ``naive``)
                            the explicit path's mask of the (B, N, T, T)
                            probabilities: flax ``nn.Dropout`` (key of
                            ``Dropout_0``) unless ``SE_DROPOUT_IMPL=hash``
                            (the hidden-state hash of them). Each is a mask
                            form of B3 (``ops/cuda/attention_kernel``)
attention at rate 0 / eval  ``F.scaled_dot_product_attention`` (the function
                            of ``jax.nn.dot_product_attention``)
==========================  ==================================================

Sites draw in the JAX package's order: the input, then per layer the
probabilities, the attention output and the FFN output. A data-parallel
rank's forward keys every mask on the global rows (``batch0``). Under a
model axis (``--mesh DxM``, M > 1) the JAX package's ``SE_ATTN_IMPL=flash``
falls back to its explicit path (its Pallas kernel does not shard heads); the
port keeps B3's hash there, on the rank's heads (ROADMAP V9). ``salts=`` of a
:class:`SaltStream` replays salts on the hash routes (a flax site refuses a
replay).

Compute dtype. Under ``compute_dtype`` bf16 the layers run the JAX
encoder's ``nn.Dense(dtype=bf16)`` products: ``qkv``, the attention
``output``, ``intermediate`` and the layer ``output`` take bf16 inputs and
weights and give bf16 results, the bias added to the rounded product in bf16
(two roundings, as flax adds it); q, k and v are then bf16, so attention is
B3 fwd / bwd bf16 (dropout live) or ``F.scaled_dot_product_attention`` on
bf16 (rate 0); the exact-erf gelu and the hidden dropouts act on those bf16
tensors (the same keys, drawn in the same order). The residual sums, every
LayerNorm, ``spec_transform``, the position encoding, ``input_ln`` and the
spectrogram prediction head stay f32. Parameters are f32 in either dtype.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.attention_kernel import flash_attention, hidden_hash_keep
from ..ops.cuda.dropout_kernel import threefry_dropout
from ..utils.flax_rng import KeyStream, Scope, as_scope

MAX_POSITIONS = 5001  # rows of the position-encoding table
# the dropout stream of a forward; the name the train steps and tests use
SaltStream = KeyStream


@dataclasses.dataclass
class TransformerConfig:
    """Architecture hyperparameters, in the reference's YAML vocabulary."""

    input_dim: int = 160
    downsample_rate: int = 1
    hidden_size: int = 768
    num_hidden_layers: int = 6
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    share_layer: bool = False
    max_input_length: int = 0

    @classmethod
    def from_dict(cls, cfg: Dict[str, Any]) -> "TransformerConfig":
        """A full pretrain config (with a 'transformer' section) or the
        section itself; unknown keys are ignored and string numbers coerced
        (the YAMLs quote layer_norm_eps)."""
        if "transformer" in cfg:
            cfg = cfg["transformer"]
        fields = {f.name for f in dataclasses.fields(cls)}
        clean = {}
        for k, v in cfg.items():
            if k not in fields:
                continue
            if isinstance(v, str):
                try:
                    v = float(v) if ("." in v or "e" in v.lower()) else int(v)
                except ValueError:
                    pass
            clean[k] = v
        return cls(**clean)


ACT2FN = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "relu": torch.relu,
    "swish": F.silu,
}


def sinusoidal_position_encoding(max_len: int, hidden: int) -> np.ndarray:
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, hidden, 2, dtype=np.float64) * -(math.log(10000.0) / hidden))
    table = np.zeros((max_len, hidden), dtype=np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)[:, : hidden // 2]  # odd-dim safe
    return table


def _hash_mask_apply(x: torch.Tensor, salt, rate: float, batch0: int = 0) -> torch.Tensor:
    """Hidden-state dropout by the salted hash of (flat index within x[0],
    leading index ``batch0`` + b): bit for bit the JAX package's
    ``_hash_mask_apply`` on a batch whose row b is row ``batch0`` + b."""
    keep = 1.0 - rate
    inner_n = math.prod(x.shape[1:])
    inner = torch.arange(inner_n, dtype=torch.int64, device=x.device).reshape(
        (1,) + tuple(x.shape[1:]))
    lead = torch.arange(batch0, batch0 + x.shape[0], dtype=torch.int64,
                        device=x.device).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(hidden_hash_keep(inner, lead, salt, rate), x / keep, torch.zeros_like(x))


class HashDropout(torch.autograd.Function):
    """``_hash_mask_apply`` with a backward that re-derives the mask from the
    8-byte salt (the JAX custom VJP ``_hash_dropout_vjp``): no mask is kept."""

    @staticmethod
    def forward(ctx, x, salt, rate, batch0):
        ctx.salt, ctx.rate, ctx.batch0 = salt, rate, batch0
        return _hash_mask_apply(x, salt, rate, batch0)

    @staticmethod
    def backward(ctx, g):
        return _hash_mask_apply(g, ctx.salt, ctx.rate, ctx.batch0), None, None, None


def hash_dropout(x: torch.Tensor, rate: float, salt, batch0: int = 0) -> torch.Tensor:
    if rate <= 0.0:
        return x
    return HashDropout.apply(x, tuple(salt), rate, int(batch0))


def _need(scope: Optional[Scope]) -> Scope:
    if scope is None:
        raise ValueError("dropout is live (training, rate > 0) but no SaltStream was given")
    return scope


def hidden_dropout(x: torch.Tensor, rate: float, live: bool, scope: Optional[Scope],
                   index: int = 0) -> torch.Tensor:
    """Hidden-state dropout of one site of the module whose scope is
    ``scope``, as the JAX package's ``hidden_dropout`` routes it: under
    ``SE_HIDDEN_DROPOUT_IMPL=hash`` the salted hash from the module's next key,
    else flax ``nn.Dropout`` (D1) from the key of its ``index``-th
    ``Dropout`` child. Draws only when live."""
    if not live or rate <= 0.0:
        return x
    scope = _need(scope)
    if os.environ.get("SE_HIDDEN_DROPOUT_IMPL", "flax") == "hash":
        return hash_dropout(x, rate, scope.salt(), scope.batch0)
    if rate >= 1.0:
        return torch.zeros_like(x)  # flax draws no key at rate 1
    return threefry_dropout(x, scope.dropout_key(index), rate, scope.batch0)


def attention_chunk() -> int:
    """``SE_ATTN_DROPOUT_CHUNK`` (0: the chunked path off)."""
    return int(os.environ.get("SE_ATTN_DROPOUT_CHUNK", "0"))


def attention_route(live: bool) -> str:
    """The route of the JAX package's ``SelfAttention`` under its variables,
    as it reads them (``SE_ATTN_IMPL``: fused by default, ``naive``,
    ``flash``; ``SE_ATTN_DROPOUT_CHUNK``; ``SE_DROPOUT_IMPL``, read as hash
    by default on the chunked path and as flax on the explicit one), with
    ``live`` attention dropout: ``flash`` (B3's hash), ``chunked_flax`` /
    ``chunked_hash`` (per-chunk keys), ``flax`` (the explicit path's
    ``nn.Dropout``) or ``hidden_hash`` (the explicit path's hash of the
    probabilities); without: ``sdpa`` (the function of the fused path), or
    ``plain_named`` (the explicit path, its ``nn.Dropout`` at rate 0 taking a
    name)."""
    impl = os.environ.get("SE_ATTN_IMPL", "fused")
    if live and impl == "flash":
        return "flash"
    if not live and impl != "naive":
        return "sdpa"
    if live and impl != "naive" and attention_chunk() > 0:
        flax = os.environ.get("SE_DROPOUT_IMPL", "hash") == "flax"
        return "chunked_flax" if flax else "chunked_hash"
    if live and os.environ.get("SE_DROPOUT_IMPL") == "hash":
        return "hidden_hash"
    return "flax" if live else "plain_named"


class Dense(nn.Linear):
    """nn.Linear computing in its input's dtype: an f32 input as ``F.linear``;
    a bf16 input with the weight rounded to bf16 and the bias, rounded to
    bf16, added to the rounded bf16 product (flax's ``nn.Dense(dtype=bf16)``).
    Weight and bias stay f32 parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32:
            return F.linear(x, self.weight, self.bias)
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


def dense(fan_in: int, out: int, stddev: float, generator=None) -> Dense:
    """``Dense`` with weight normal(0, stddev) and a zero bias (the JAX
    encoder's ``normal_init`` Dense)."""
    layer = Dense(fan_in, out)
    with torch.no_grad():
        layer.weight.normal_(0.0, stddev, generator=generator)
        layer.bias.zero_()
    return layer


class SelfAttention(nn.Module):
    """Multi-head self-attention over the fused QKV projection.

    ``tp`` (a ``parallel.mesh.ModelAxis``, set by ``parallel.mesh.shard_model``;
    None: the whole layer) makes this the rank's share of a tensor-parallel
    layer: ``qkv`` holds the q, k and v rows of heads [m N / M, (m + 1) N / M)
    and ``output`` those heads' input columns; the input's gradient is
    all-reduced over the model group, the output's partial products are
    all-reduced before the bias, and B3 draws the unsharded masks of these
    heads (``head0``). ``seq`` (``parallel.sequence.SeqAxis``, inference
    only) is the sequence-parallel forward: the rank's queries against the
    keys and values of the whole sequence, gathered over the seq group."""

    def __init__(self, config: TransformerConfig, generator=None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.compute_dtype = compute_dtype
        H, r = config.hidden_size, config.initializer_range
        self.qkv = dense(H, 3 * H, r, generator)  # fused q, k, v, in that order
        self.output = dense(H, H, r, generator)
        self.tp = None

    def forward(self, hidden: torch.Tensor, salts=None, seq=None):
        c = self.config
        H, N = c.hidden_size, c.num_attention_heads
        D = H // N
        scale = 1.0 / math.sqrt(D)
        tp = self.tp
        scope = as_scope(salts)
        x = hidden.to(self.compute_dtype)
        n_local = N if tp is None else N // tp.size
        if tp is not None:
            x = tp.copy_in(x)
        q, k, v = self.qkv(x).split(n_local * D, dim=-1)
        if seq is not None:
            k, v = seq.gather_time(k), seq.gather_time(v)
        rate = c.attention_probs_dropout_prob
        live = self.training and rate > 0.0
        if live and seq is not None:
            raise ValueError("the sequence-parallel forward is deterministic")
        route = attention_route(live)
        # the explicit path's nn.Dropout takes the name Dropout_0 (drawing or
        # not), so the attention output's hidden dropout is then Dropout_1
        hidden_index = int(route in ("flax", "plain_named"))
        if route in ("sdpa", "plain_named"):
            B, Tq, Tk = q.shape[0], q.shape[1], k.shape[1]

            def split(x, T):
                return x.reshape(B, T, n_local, D).transpose(1, 2)

            ctx = F.scaled_dot_product_attention(split(q, Tq), split(k, Tk), split(v, Tk),
                                                 scale=scale)
            ctx = ctx.transpose(1, 2).reshape(B, Tq, n_local * D)
        elif route == "flax" and rate >= 1.0:
            ctx = torch.zeros_like(q)  # flax drops everything, drawing no key
        else:
            scope = _need(scope)
            heads = {} if tp is None else {"head0": tp.index * n_local, "n_heads_total": N}
            if route == "flash":
                # exactly the call of the flash route as it always was
                ctx = flash_attention(q, k, v, scale, rate, scope.salt(), batch0=scope.batch0,
                                      n_heads=n_local, **heads)
            else:
                if route == "flax":
                    words, form, chunk = scope.dropout_key(0), "flax", 0
                elif route == "hidden_hash":
                    words, form, chunk = scope.salt(), "hidden_hash", 0
                else:  # the chunked path: each chunk's key folds from this one
                    form = "flax" if route == "chunked_flax" else "hidden_hash"
                    words, chunk = scope.key(), attention_chunk()
                ctx = flash_attention(q, k, v, scale, rate, words, batch0=scope.batch0,
                                      n_heads=n_local, form=form, chunk=chunk, **heads)
        out = self.output(ctx) if tp is None else tp.row_parallel(self.output, ctx)
        return hidden_dropout(out, c.hidden_dropout_prob, self.training, scope, hidden_index)


class TransformerLayer(nn.Module):
    """Post-LN layer: attention + residual + LayerNorm, FFN + residual +
    LayerNorm, the residual sums in f32 (an f32 hidden plus a bf16 output
    promotes to f32). ``ffn_tp`` (a ``parallel.mesh.ModelAxis``; None: the
    whole FFN) makes the FFN the rank's share of a tensor-parallel one, as
    ``SelfAttention.tp`` does the attention: ``intermediate`` holds the rank's
    columns and ``output`` their rows. The LayerNorms and the hidden dropout
    act on the replicated activations, so they draw the unsharded masks."""

    def __init__(self, config: TransformerConfig, generator=None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.compute_dtype = compute_dtype
        H, r, eps = config.hidden_size, config.initializer_range, config.layer_norm_eps
        self.attention = SelfAttention(config, generator, compute_dtype)
        self.attention_ln = nn.LayerNorm(H, eps=eps)
        self.intermediate = dense(H, config.intermediate_size, r, generator)
        self.output = dense(config.intermediate_size, H, r, generator)
        self.output_ln = nn.LayerNorm(H, eps=eps)
        self.ffn_tp = None

    def forward(self, hidden: torch.Tensor, salts=None, seq=None):
        c = self.config
        scope = as_scope(salts)
        hidden = self.attention_ln(hidden + self.attention(
            hidden, None if scope is None else scope.child("attention"), seq))
        tp = self.ffn_tp
        x = hidden.to(self.compute_dtype)
        if tp is None:
            out = self.output(ACT2FN[c.hidden_act](self.intermediate(x)))
        else:
            out = tp.row_parallel(self.output,
                                  ACT2FN[c.hidden_act](self.intermediate(tp.copy_in(x))))
        out = hidden_dropout(out, c.hidden_dropout_prob, self.training, scope)
        return self.output_ln(hidden + out)


class TransformerEncoder(nn.Module):
    """Input projection + position encoding + LayerNorm + the layers.

    ``forward(spec (B, T, input_dim))`` -> (B, T // dr, hidden), or every
    layer's output stacked (L, B, T // dr, hidden) when
    ``output_all_layers``. ``input_dim`` defaults to the config's; the flax
    module takes it from the data. ``compute_dtype`` (f32 or bf16) is the
    layers' (the module docstring). ``forward(..., seq=)`` (a
    ``parallel.sequence.SeqAxis``) takes the rank's time chunk of a
    sequence-parallel forward: its position encodings start at the chunk's
    offset, and each layer attends over the whole sequence."""

    def __init__(self, config: TransformerConfig, input_dim: Optional[int] = None,
                 generator=None, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be f32 or bf16, got {compute_dtype}")
        self.config = config
        self.compute_dtype = compute_dtype
        H, r = config.hidden_size, config.initializer_range
        dr = max(1, config.downsample_rate)
        self.spec_transform = dense((input_dim or config.input_dim) * dr, H, r, generator)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_position_encoding(MAX_POSITIONS, H)),
            persistent=False)
        self.input_ln = nn.LayerNorm(H, eps=config.layer_norm_eps)
        if config.share_layer:
            self.layer_shared = TransformerLayer(config, generator, compute_dtype)
        else:
            for i in range(config.num_hidden_layers):
                self.add_module(f"layer_{i}",
                                TransformerLayer(config, generator, compute_dtype))

    def layer_names(self):
        c = self.config
        if c.share_layer:
            return ["layer_shared"] * c.num_hidden_layers
        return [f"layer_{i}" for i in range(c.num_hidden_layers)]

    def layers(self):
        return [getattr(self, name) for name in self.layer_names()]

    def forward(self, spec: torch.Tensor, salts=None,
                output_all_layers: bool = False, seq=None):
        c = self.config
        dr = max(1, c.downsample_rate)
        b, t, d = spec.shape
        if dr > 1:
            t2 = t // dr
            spec = spec[:, : t2 * dr].reshape(b, t2, d * dr)
        hidden = self.spec_transform(spec)
        t_local = hidden.shape[1]
        offset = 0 if seq is None else seq.index * t_local
        hidden = self.input_ln(hidden + self.pe[offset:offset + t_local])
        scope = as_scope(salts)
        hidden = hidden_dropout(hidden, c.hidden_dropout_prob, self.training, scope)
        all_layers = []
        for name in self.layer_names():
            hidden = getattr(self, name)(hidden, None if scope is None else scope.child(name),
                                         seq)
            all_layers.append(hidden)
        if output_all_layers:
            return torch.stack(all_layers, dim=0)
        return hidden


class TransformerSpecPredictionHead(nn.Module):
    """hidden -> spectrogram: dense + act + LayerNorm + output. Returns
    (predicted, the normalized hidden). ``input_size`` defaults to the
    hidden size."""

    def __init__(self, config: TransformerConfig, output_size: int = 201,
                 input_size: Optional[int] = None, generator=None):
        super().__init__()
        self.config = config
        H, r = config.hidden_size, config.initializer_range
        self.dense = dense(input_size or H, H, r, generator)
        self.ln = nn.LayerNorm(H, eps=config.layer_norm_eps)
        self.output = dense(H, output_size, r, generator)

    def forward(self, hidden: torch.Tensor):
        x = self.ln(ACT2FN[self.config.hidden_act](self.dense(hidden)))
        return self.output(x), x
