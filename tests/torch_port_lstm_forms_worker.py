"""The JAX package's gates form of B1 with XLA's excess precision off, for
``tests/test_torch_port_lstm_forms.py``.

XLA's CPU compiler by default (``--xla_allow_excess_precision=true``) drops a
rounding to bf16 where the next op widens the value back to f32: in
``_kernel_tm`` under ``SE_PALLAS_GATES_BF16`` it keeps f's and o's last pass
and i * g unrounded. With the flag off it rounds after every bf16 op, as the
kernel's source writes them. The flag is read when XLA starts, so this runs
in a process of its own:

    python tests/torch_port_lstm_forms_worker.py <inputs.npz> <outputs.npz>

The inputs hold the jobs: ``job/<name>/kind`` ("kernel" or "stack"),
``job/<name>/env`` (the variables set to 1, comma-separated), and the
arrays: ``xw`` and ``w_hh_t`` of a kernel (``lstm_bidir_pallas_tm`` in
interpret mode), or ``x``, ``hidden``, ``layers`` and the flax parameters as
``param/<path>`` of a bidirectional ``LSTMStack`` on its Pallas path (no
gradient). The outputs are ``<name>`` each, in f32.
"""
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_allow_excess_precision=false").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from speech_enhancement_by_s3prl_tpu.models.lstm import LSTMStack  # noqa: E402
from speech_enhancement_by_s3prl_tpu.ops.pallas import lstm_kernel as JP  # noqa: E402

VARIABLES = ("SE_LSTM_XW_INT8", "SE_LSTM_XW_BF16", "SE_PALLAS_HS_BF16", "SE_PALLAS_VJP_BF16",
             "SE_PALLAS_MXU_BF16", "SE_PALLAS_GATES_BF16")


def nest(flat):
    tree = {}
    for path, value in flat.items():
        node = tree
        *head, leaf = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(value)
    return tree


def main(src, dst):
    data = np.load(src)
    names = sorted({k.split("/")[1] for k in data.files if k.startswith("job/")})
    out = {}
    for name in names:
        pre = f"job/{name}/"
        for v in VARIABLES:
            os.environ.pop(v, None)
        for v in str(data[pre + "env"]).split(","):
            if v:
                os.environ[v] = "1"
        # each job traces afresh, so the variables are read under its setting
        if str(data[pre + "kind"]) == "kernel":
            y = JP.lstm_bidir_pallas_tm(jnp.asarray(data[pre + "xw"]),
                                        jnp.asarray(data[pre + "w_hh_t"]), interpret=True)
        else:
            params = nest({k[len(pre + "param/"):]: data[k] for k in data.files
                           if k.startswith(pre + "param/")})
            stack = LSTMStack(int(data[pre + "hidden"]), num_layers=int(data[pre + "layers"]),
                              bidirectional=True, use_pallas=True, pallas_interpret=True)
            y = stack.apply(params, jnp.asarray(data[pre + "x"]))
        out[name] = np.asarray(y.astype(jnp.float32))
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
