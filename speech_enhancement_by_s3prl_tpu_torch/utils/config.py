"""Config and args helpers (counterpart of
``speech_enhancement_by_s3prl_tpu/utils/config.py``; the XLA compile-cache
setup there has no counterpart)."""
from __future__ import annotations

from argparse import Namespace
from typing import Any, Dict, Union


def update_args(old: Namespace, new: Union[Namespace, Dict[str, Any]]) -> Namespace:
    """Merge resumed checkpoint args over the current CLI args: the
    checkpoint's values win."""
    old_dict = dict(vars(old))
    new_dict = dict(new) if isinstance(new, dict) else dict(vars(new))
    old_dict.update(new_dict)
    return Namespace(**old_dict)


def remove_self(variables: Dict[str, Any]) -> Dict[str, Any]:
    """``locals()`` -> kwargs, without ``self``."""
    return {k: v for k, v in variables.items() if k != "self"}
