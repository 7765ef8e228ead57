"""Weight bridge between the JAX package's flax parameter trees and the
port's ``state_dict``.

A flax tree ``{'params': {'lstm': {'l0_fwd': {'w_ih': ...}},
'scaling_layer': {'kernel': ..., 'bias': ...}}}`` of numpy arrays maps onto
keys ``lstm.l0_fwd.w_ih`` / ``scaling_layer.weight`` / ``scaling_layer.bias``:

- LSTM weights are stored in torch layout on both sides and are only renamed;
- a flax ``Dense`` kernel is (in, out) and becomes ``nn.Linear.weight``
  (out, in) by a transpose, and back;
- a flax ``LayerNorm`` scale (1-D) is ``nn.LayerNorm.weight``, and back.

Both directions copy values exactly, so a round trip is bit-identical.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, name + ".")
        else:
            yield name, value


def flax_to_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (numpy leaves, optionally under 'params') ->
    ``state_dict`` of CPU tensors."""
    if not isinstance(tree, dict):
        raise TypeError(f"expected a dict parameter tree, got {type(tree).__name__}")
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for name, leaf in _flatten(tree):
        arr = np.asarray(leaf)
        if name.endswith(".kernel"):
            if arr.ndim != 2:
                raise ValueError(f"{name}: Dense kernel must be 2-D, got {arr.shape}")
            name, arr = name[: -len("kernel")] + "weight", arr.T
        elif name.endswith(".scale"):
            if arr.ndim != 1:
                raise ValueError(f"{name}: LayerNorm scale must be 1-D, got {arr.shape}")
            name = name[: -len("scale")] + "weight"
        out[name] = torch.from_numpy(np.array(arr, order="C"))  # a writable copy
    return out


def flax_path(name: str, ndim: int = 2) -> Tuple[str, ...]:
    """The path of ``state_dict`` key ``name`` of a tensor with ``ndim``
    dimensions in the flax tree: ``scaling_layer.weight`` (2-D) ->
    ('params', 'scaling_layer', 'kernel'), ``input_ln.weight`` (1-D) ->
    ('params', 'input_ln', 'scale')."""
    if name.endswith(".weight"):
        name = name[: -len("weight")] + ("kernel" if ndim == 2 else "scale")
    return ("params", *name.split("."))


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """``state_dict`` -> flax tree ``{'params': {...}}`` of numpy arrays."""
    params: Dict[str, Any] = {}
    for name, tensor in state_dict.items():
        arr = tensor.detach().cpu().numpy()
        if name.endswith(".weight"):
            if arr.ndim not in (1, 2):
                raise ValueError(
                    f"{name}: a Linear weight is 2-D and a LayerNorm weight 1-D, "
                    f"got {arr.shape}")
            arr = arr.T
        _, *path, leaf = flax_path(name, arr.ndim)
        node = params
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": params}
