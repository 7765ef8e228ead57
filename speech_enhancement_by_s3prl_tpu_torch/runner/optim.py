"""Optimizers (counterpart of ``speech_enhancement_by_s3prl_tpu/runner/optim.py``,
which builds them as optax chains).

Each optimizer is a pair of plain functions over a state dict, as optax's
are: ``init(params) -> state`` and ``update(grads, state, params) ->
(updates, new_state)``, with ``params``, ``grads`` and ``updates`` keyed by
``state_dict`` name. ``state`` is ``{'count': int32 scalar tensor, 'mu':
{name: tensor}, 'nu': {name: tensor}}``; its count is the optimizer's own,
separate from the trainer's global step. ``update`` never reads a value back
to the host, so the train step can keep or drop its result on the device.

- BertAdam: moments without bias correction and eps 1e-6; decoupled 0.01
  weight decay added to the update before the schedule scales it, on every
  parameter except biases and LayerNorm scales (decided on the parameter's
  flax path, so both packages decay the same tensors); the warmup-linear
  schedule read at the post-increment count; no inner clip (the train step
  clips the global norm).
- Adam: ``optax.adam(lr, 0.9, 0.999, eps=1e-8)``, with bias correction.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..models.convert import flax_path

Tensors = Dict[str, torch.Tensor]


def warmup_linear_schedule(
    lr: float, warmup_proportion: float, total_steps: int
) -> Callable[[torch.Tensor], torch.Tensor]:
    """lr * (x/warmup) while x < warmup else lr * (1-x)/(1-warmup),
    x = step / total_steps, in f32."""

    def schedule(step):
        x = torch.as_tensor(step).to(torch.float32) / max(total_steps, 1)
        warm = x / max(warmup_proportion, 1e-8)
        decay = torch.clamp((1.0 - x) / max(1.0 - warmup_proportion, 1e-8), min=0.0)
        return lr * torch.where(x < warmup_proportion, warm, decay)

    return schedule


def no_decay(path) -> bool:
    """Biases and LayerNorm parameters take no weight decay (the 'no_decay'
    group of S3PRL's get_optimizer). ``path`` is a flax path tuple."""
    flat = "/".join(str(n) for n in path).lower()
    return (
        flat.endswith("bias")
        or "b_ih" in flat
        or "b_hh" in flat
        or "_ln/" in flat
        or flat.endswith("/scale")
        or "layernorm" in flat
    )


def _zeros_state(params: Tensors) -> dict:
    device = next(iter(params.values())).device if params else None
    return {
        "count": torch.zeros((), dtype=torch.int32, device=device),
        "mu": {k: torch.zeros_like(p) for k, p in params.items()},
        "nu": {k: torch.zeros_like(p) for k, p in params.items()},
    }


class BertAdam:
    def __init__(self, lr: float, warmup_proportion: float, total_steps: int,
                 weight_decay: float = 0.01, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-6):
        self.schedule = warmup_linear_schedule(lr, warmup_proportion, total_steps)
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps

    def init(self, params: Tensors) -> dict:
        return _zeros_state(params)

    def update(self, grads: Tensors, state: dict, params: Tensors):
        b1, b2 = self.b1, self.b2
        mu = {k: b1 * state["mu"][k] + (1 - b1) * g for k, g in grads.items()}
        nu = {k: b2 * state["nu"][k] + (1 - b2) * g * g for k, g in grads.items()}
        lr = self.schedule(state["count"] + 1)
        updates = {}
        for k in grads:
            u = mu[k] / (torch.sqrt(nu[k]) + self.eps)
            if not no_decay(flax_path(k, params[k].dim())):
                u = u + self.weight_decay * params[k]
            updates[k] = -1.0 * (lr * u)
        return updates, {"count": state["count"] + 1, "mu": mu, "nu": nu}


class Adam:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params: Tensors) -> dict:
        return _zeros_state(params)

    def update(self, grads: Tensors, state: dict, params: Tensors):
        b1, b2 = self.b1, self.b2
        mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in grads.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state["nu"][k] for k, g in grads.items()}
        count = state["count"] + 1
        c1 = 1 - b1 ** count.to(torch.float32)
        c2 = 1 - b2 ** count.to(torch.float32)
        updates = {
            k: -self.lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps))
            for k in grads
        }
        return updates, {"count": count, "mu": mu, "nu": nu}


def build_optimizer(name: str, lr: float, warmup_proportion: float = 0.07,
                    total_steps: int = 20000):
    if name == "BertAdam":
        return BertAdam(lr, warmup_proportion, total_steps)
    if name == "Adam":
        return Adam(lr)
    raise ValueError(f"unknown optimizer {name}")
