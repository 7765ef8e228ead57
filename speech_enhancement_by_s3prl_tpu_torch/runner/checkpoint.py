"""Checkpoints in the JAX package's format
(``speech_enhancement_by_s3prl_tpu/runner/checkpoint.py``).

A checkpoint is one pickle file ``states-{step}.ckpt`` holding
``{'Downstream', 'Optimizer', 'Global_step', 'Settings': {'Config',
'Paras'}}`` with numpy leaves. ``Downstream`` is the flax-shaped parameter
tree; the port writes it through ``models/convert.py`` so that either
package reads the other's checkpoints.

Reading needs neither jax nor flax: the JAX package's ``Optimizer`` entry
holds optax state classes, which unpickle here as opaque
:class:`ForeignObject` records (the port does not use them). Only numpy and
builtin types are rebuilt as themselves.
"""
from __future__ import annotations

import glob
import os
import pickle
import re
from typing import Any, Dict, Optional

from torch import nn

from ..models.convert import state_dict_to_flax

_SAFE_BUILTINS = frozenset({
    "bool", "bytearray", "bytes", "complex", "dict", "float", "frozenset",
    "int", "list", "object", "range", "set", "slice", "str", "tuple",
})


class ForeignObject:
    """Stand-in for a class of another framework found in a checkpoint
    (optax's optimizer-state tuples, for example): keeps what was pickled."""

    qualname = "?"

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args, obj.kwargs = args, kwargs
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state

    def __repr__(self):
        return f"ForeignObject({self.qualname})"


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        root = module.split(".")[0]
        if root == "numpy" or (module == "collections" and name == "OrderedDict") or (
            module == "builtins" and name in _SAFE_BUILTINS
        ):
            return super().find_class(module, name)
        return type(name, (ForeignObject,), {"qualname": f"{module}.{name}"})


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    return tree


def save_checkpoint(
    directory: str,
    step: int,
    model: nn.Module,
    opt_state: Any,
    config: Dict[str, Any],
    args: Dict[str, Any],
    max_keep: int = 2,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Write ``model``'s weights as the flax-shaped tree, plus ``opt_state``
    (any tree of tensors or arrays; None when there is none)."""
    os.makedirs(directory, exist_ok=True)
    rotate(directory, max_keep)
    payload = {
        "Downstream": state_dict_to_flax(model.state_dict()),
        "Optimizer": _to_host(opt_state),
        "Global_step": int(step),
        "Settings": {"Config": config, "Paras": dict(args)},
    }
    if extra:
        payload.update(_to_host(extra))
    path = os.path.join(directory, f"states-{int(step)}.ckpt")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return path


def _step_of(path: str) -> int:
    m = re.search(r"states-(\d+)\.ckpt$", path)
    return int(m.group(1)) if m else -1


def rotate(directory: str, max_keep: int):
    """Prune to ``max_keep - 1`` checkpoints before a save, so at most
    ``max_keep`` are on disk after it."""
    ckpts = sorted(glob.glob(os.path.join(directory, "states-*.ckpt")), key=_step_of)
    excess = len(ckpts) - max(max_keep - 1, 0)
    for p in ckpts[: max(excess, 0)]:
        os.remove(p)


def find_resume_ckpt(path: str) -> str:
    """Dir -> newest states-*.ckpt; file -> itself."""
    if os.path.isdir(path):
        ckpts = glob.glob(os.path.join(path, "states-*.ckpt"))
        if not ckpts:
            raise FileNotFoundError(f"no checkpoints under {path}")
        return max(ckpts, key=_step_of)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint written by either package. Only load checkpoints
    this program or the JAX package wrote: unpickling runs the file's
    instructions, though classes outside numpy and builtins are never
    imported."""
    with open(find_resume_ckpt(path), "rb") as f:
        return _Unpickler(f).load()
