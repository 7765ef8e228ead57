"""Checkpoints in the JAX package's format
(``speech_enhancement_by_s3prl_tpu/runner/checkpoint.py``).

A checkpoint is one pickle file ``states-{step}.ckpt`` holding
``{'Downstream', 'Optimizer', 'Global_step', 'Settings': {'Config',
'Paras'}}`` with numpy leaves. ``Downstream`` is the flax-shaped parameter
tree; the port writes it through ``models/convert.py`` so that either
package reads the other's checkpoints.

Reading needs neither jax nor flax: the JAX package's ``Optimizer`` entry
holds optax state classes, which unpickle here as :class:`ForeignObject`
records that keep what was pickled; :func:`optimizer_state_from_payload`
reads the moments and counts out of them. Only numpy and builtin types are
rebuilt as themselves.

The port's own ``Optimizer`` entry is ``{'count': int, 'mu': tree, 'nu':
tree}``, the moments as flax-shaped trees keyed by the parameters' flax
paths (Dense moments transposed like the kernels). The JAX package does not
read this entry: a port checkpoint resumes in the port, and serves in
either package.
"""
from __future__ import annotations

import glob
import os
import pickle
import re
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.convert import flax_to_state_dict, state_dict_to_flax

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


def optimizer_payload(opt_state: Optional[dict]) -> Optional[dict]:
    """The port's ``Optimizer`` entry for an optimizer state
    (runner/optim.py) or None."""
    if opt_state is None:
        return None
    return {
        "count": np.int32(int(opt_state["count"])),
        "mu": state_dict_to_flax(opt_state["mu"]),
        "nu": state_dict_to_flax(opt_state["nu"]),
    }


def _is_state(obj, name: str) -> bool:
    return isinstance(obj, ForeignObject) and obj.qualname.endswith("." + name)


def optimizer_state_from_payload(entry: Any, device) -> Optional[dict]:
    """An ``Optimizer`` entry written by either package -> the port's
    optimizer state on ``device`` (None stays None: a fresh state follows).

    A JAX checkpoint holds the optax chain's state tuple. Position 0 is
    ``ScaleByAdamState(count, mu, nu)`` in both chains the JAX package
    builds (BertAdam and Adam): its moments and count are read. For BertAdam,
    position 2 is ``ScaleByScheduleState(count)``, the count the schedule
    reads; the JAX train step advances it with position 0's, and a
    checkpoint where the two differ is refused. Positions 1 and 3 (the decay
    mask's and the sign flip's empty states) hold nothing."""
    if entry is None:
        return None
    if isinstance(entry, dict) and {"count", "mu", "nu"} <= set(entry):
        count, mu, nu = entry["count"], entry["mu"], entry["nu"]
    elif isinstance(entry, tuple) and entry and _is_state(entry[0], "ScaleByAdamState"):
        count, mu, nu = entry[0].args
        if len(entry) > 2 and _is_state(entry[2], "ScaleByScheduleState"):
            (sched_count,) = entry[2].args
            if int(sched_count) != int(count):
                raise ValueError(
                    f"optax state: Adam count {int(count)} but schedule count "
                    f"{int(sched_count)}"
                )
    else:
        raise ValueError(f"unrecognized Optimizer entry: {entry!r:.200}")
    return {
        "count": torch.tensor(int(count), dtype=torch.int32, device=device),
        "mu": {k: v.to(device) for k, v in flax_to_state_dict(mu).items()},
        "nu": {k: v.to(device) for k, v in flax_to_state_dict(nu).items()},
    }


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
    (a tree of tensors or arrays, such as :func:`optimizer_payload` gives;
    None when there is none)."""
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


def is_torch_checkpoint(path: str) -> bool:
    """Whether ``path`` was written by ``torch.save`` (a zip archive, as an
    S3PRL pretraining checkpoint is) rather than pickled by either package."""
    return zipfile.is_zipfile(find_resume_ckpt(path))


def load_settings(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(config, paras) recorded in a checkpoint of either package or in a
    torch (S3PRL) one, whose ``Paras`` may be an argparse namespace."""
    if is_torch_checkpoint(path):
        payload = torch.load(find_resume_ckpt(path), map_location="cpu", weights_only=False)
    else:
        payload = load_checkpoint(path)
    paras = payload["Settings"].get("Paras", {})
    return payload["Settings"]["Config"], dict(paras if isinstance(paras, dict) else vars(paras))
