"""Convert torch (S3PRL) checkpoints to the native checkpoint format
(counterpart of ``scripts/convert_torch_ckpt.py``).

The native format is one pickle of numpy trees, which both packages read
without torch: ``Upstream`` (the flax-shaped ``encoder`` / ``spechead``
trees), ``Settings`` and ``Meta`` for ``--kind upstream``; ``Downstream``
(``{'params': tree}``), ``Optimizer``, ``Global_step`` and ``Settings`` for
``--kind downstream``. The trees are the JAX package's layout
(``models/convert.state_dict_to_flax``).

  python -m speech_enhancement_by_s3prl_tpu_torch.tools.convert_torch_ckpt \\
      upstream.ckpt --out tera_native.ckpt
  python -m speech_enhancement_by_s3prl_tpu_torch.tools.convert_torch_ckpt \\
      downstream.ckpt --downstream LSTM --kind downstream --out head_native.ckpt
"""
from __future__ import annotations

import argparse
import pickle
from typing import Any, Dict

import torch

from ..models.convert import state_dict_to_flax
from ..models.torch_import import convert_downstream_state, load_s3prl_checkpoint


def convert(ckpt: str, kind: str = "upstream", downstream: str = "LSTM") -> Dict[str, Any]:
    """The native payload of the torch checkpoint ``ckpt``."""
    if kind == "upstream":
        loaded = load_s3prl_checkpoint(ckpt)
        return {
            "Upstream": {name: state_dict_to_flax(sd)["params"]
                         for name, sd in loaded.params.items()},
            "Settings": {"Config": loaded.pretrain_config, "Paras": {}},
            "Meta": {"input_dim": loaded.input_dim, "output_size": loaded.output_size,
                     "log_domain": loaded.log_domain},
        }
    if kind != "downstream":
        raise ValueError(f"unknown kind {kind!r}: 'upstream' or 'downstream'")
    t = torch.load(ckpt, map_location="cpu", weights_only=False)
    sd = t["Downstream"] if "Downstream" in t else {
        k.split(".", 1)[1]: v for k, v in t["SmallModel"].items()}
    paras = t["Settings"]["Paras"]
    return {
        "Downstream": state_dict_to_flax(convert_downstream_state(sd, downstream)),
        "Optimizer": {},
        "Global_step": int(t.get("Global_step", 0)),
        "Settings": {"Config": t["Settings"]["Config"],
                     "Paras": paras if isinstance(paras, dict) else vars(paras)},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("ckpt")
    ap.add_argument("--out", required=True)
    ap.add_argument("--kind", choices=["upstream", "downstream"], default="upstream")
    ap.add_argument("--downstream", default="LSTM",
                    help="model class for --kind downstream")
    args = ap.parse_args(argv)
    payload = convert(args.ckpt, args.kind, args.downstream)
    with open(args.out, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
