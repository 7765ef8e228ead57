"""One rank of the two-rank check of tests/test_torch_port_flax_dropout.py.

  python tests/torch_port_flax_dropout_worker.py RANK WORLD INIT_METHOD IN OUT

Joins a gloo process group on the CPU, loads the weights the test wrote to IN,
takes ``mockingjay_case``'s two data-parallel train steps (``parallel/mesh.py``)
on this rank's rows under the port's default dropout routes (D1 at the hidden
sites, B3's flax form), recording every mask it draws (``recording``), and
writes the masks and the stats to OUT. Imports torch and the port only.
"""
import contextlib
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from speech_enhancement_by_s3prl_tpu_torch import entry  # noqa: E402
from speech_enhancement_by_s3prl_tpu_torch.models import transformer as t_tf  # noqa: E402
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import attention_kernel as A  # noqa: E402
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import dropout_kernel as R  # noqa: E402
from speech_enhancement_by_s3prl_tpu_torch.utils import prng  # noqa: E402

MOCKINGJAY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=64, input_dim=80, hidden_dropout_prob=0.1,
                  attention_probs_dropout_prob=0.1)
ROWS, STEPS, SR = 4, 2, 16000


def mockingjay_case():
    """(the port's Mockingjay builder at ``MOCKINGJAY`` on the CPU, ``STEPS``
    global batches of ``ROWS`` rows of 0.5 s)."""
    builder = entry.build_mockingjay_train(t_tf.TransformerConfig(**MOCKINGJAY), device="cpu",
                                           generator=torch.Generator().manual_seed(0))
    batches = []
    for k in range(STEPS):
        rng = np.random.default_rng(30 + k)
        clean = 0.1 * rng.standard_normal((ROWS, SR // 2))
        noise = 0.1 * rng.standard_normal((ROWS, SR // 2))
        wavs = np.stack([clean + noise, clean, noise], axis=1).astype(np.float32)
        batches.append((torch.from_numpy(wavs), torch.full((ROWS,), SR // 2)))
    return builder, batches


@contextlib.contextmanager
def recording():
    """Every mask the default routes draw inside, in order, as (site, bool
    tensor with the batch first): D1's forward sites (its plain version on a
    tensor of ones) and B3's plain version's."""
    masks = []
    drop, full = t_tf.threefry_dropout, A._full_mask

    def drop_rec(x, key, rate, batch0=0):
        masks.append(("hidden", R.threefry_dropout_ref(torch.ones_like(x), key, rate, batch0)
                      != 0))
        return drop(x, key, rate, batch0)

    def full_rec(*args, **kwargs):
        mask = full(*args, **kwargs)
        masks.append(("attention", mask))
        return mask

    t_tf.threefry_dropout, A._full_mask = drop_rec, full_rec
    try:
        yield masks
    finally:
        t_tf.threefry_dropout, A._full_mask = drop, full


def main(rank, world, init, inp, out):
    import torch.distributed as dist

    from speech_enhancement_by_s3prl_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )
    from speech_enhancement_by_s3prl_tpu_torch.parallel.mesh import (
        make_mesh,
        make_parallel_train_step,
    )

    torch.set_num_threads(1)
    initialize_distributed(init, world, rank, device="cpu")
    builder, batches = mockingjay_case()
    builder.model.load_state_dict(torch.load(inp, weights_only=False)["weights"])
    step, state = make_parallel_train_step(builder, make_mesh(world), builder.init_state())
    stats = []
    with recording() as masks:
        for k, (wavs, lengths) in enumerate(batches):
            state, st = step(state, wavs, lengths, rng=prng.PRNGKey(5 + k))
            stats.append((float(st["loss"]), float(st["grad_norm"])))
    torch.save({"masks": masks, "stats": stats}, out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
