"""One rank of the data-parallel checks of tests/test_torch_port_parallel.py.

  python tests/torch_port_parallel_worker.py RANK WORLD INIT_METHOD IN OUT

Joins a gloo process group on the CPU, then reads the cases the test wrote to
IN (``torch.save``): for each, the weights, the global batches and the salts
to replay; takes the data-parallel train step (``parallel/mesh.py``) on this
rank's rows, recording every dropout mask it draws (``recording_masks``), and
the mesh eval of each eval case; and writes what it saw to OUT. Imports torch and
the port only.
"""
import contextlib
import dataclasses
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from speech_enhancement_by_s3prl_tpu_torch import entry  # noqa: E402
from speech_enhancement_by_s3prl_tpu_torch.models import transformer as t_tf  # noqa: E402
from speech_enhancement_by_s3prl_tpu_torch.models.heads import build_head  # noqa: E402
from speech_enhancement_by_s3prl_tpu_torch.objectives import build_objective  # noqa: E402
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import attention_kernel as A  # noqa: E402
from speech_enhancement_by_s3prl_tpu_torch.runner import optim  # noqa: E402

LR, TOTAL = 1e-3, 10  # a short schedule, so that the updates are not tiny
RESIDUAL = dict(hidden_size=8, num_layers=1)
MOCKINGJAY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=64, input_dim=80, hidden_dropout_prob=0.1,
                  attention_probs_dropout_prob=0.1)
# an objective's settings where they are not its defaults: WSD's voice
# threshold 6 dB under the loudest frame, so that the frames it gates weigh
OBJECTIVE_ARGS = {"WSD": {"db_interval": 6.0}}


def port_builder(kind: str, objective: str = "SISDR"):
    """The port's builder of a case on the CPU, BertAdam on a short schedule:
    ``residual``, the flagship structure at ``RESIDUAL``; ``lstm``, the same
    features into the ``LSTM`` head (a BLSTM of ``RESIDUAL``'s size that
    predicts the log spectrum, which ``L1`` reads); ``mockingjay``, the joint
    finetune at ``MOCKINGJAY`` (dropout live). ``objective`` names the loss."""
    opt = optim.build_optimizer("BertAdam", LR, 0.07, TOTAL)
    if kind == "mockingjay":
        return dataclasses.replace(
            entry.build_mockingjay_train(t_tf.TransformerConfig(**MOCKINGJAY), device="cpu"),
            optimizer=opt)
    builder = dataclasses.replace(
        entry.build_train(device="cpu", **RESIDUAL), optimizer=opt,
        objective=build_objective(objective, **OBJECTIVE_ARGS.get(objective, {})))
    if kind == "lstm":
        builder.model = build_head("LSTM", input_size=builder.preprocessor.feat_dims()[1],
                                   output_size=201, bidirectional=True, **RESIDUAL)
    return builder


@contextlib.contextmanager
def recording_masks():
    """Every dropout mask drawn inside: the hidden-state hash dropout's
    (forward and backward) and B3's plain version's, in order, as
    (site, bool tensor with the batch first)."""
    masks = []
    hidden, full = t_tf._hash_mask_apply, A._full_mask

    def hidden_rec(x, salt, rate, batch0=0):
        masks.append(("hidden", hidden(torch.ones_like(x), salt, rate, batch0) != 0))
        return hidden(x, salt, rate, batch0)

    def full_rec(*args):
        mask = full(*args)
        masks.append(("attention", mask))
        return mask

    t_tf._hash_mask_apply, A._full_mask = hidden_rec, full_rec
    try:
        yield masks
    finally:
        t_tf._hash_mask_apply, A._full_mask = hidden, full


def main(rank, world, init, inp, out):
    import torch.distributed as dist

    from speech_enhancement_by_s3prl_tpu_torch.parallel.distributed import (
        initialize_distributed,
        topology_summary,
    )
    from speech_enhancement_by_s3prl_tpu_torch.parallel.mesh import (
        StepReduce,
        broadcast_batch,
        make_mesh,
        make_parallel_eval_step,
        make_parallel_train_step,
    )

    torch.set_num_threads(1)
    initialize_distributed(init, world, rank, device="cpu")
    mesh = make_mesh(world)
    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    res = {"psum": float(x), "topology": topology_summary(),
           "max": float(StepReduce(mesh).max(torch.tensor(float(rank + 5))))}
    # rank 0's batch (the active sampler's choice) on every rank
    mine = (torch.arange(3) + 10 * rank, torch.full((3, 2, 5), float(rank)))
    res["broadcast"] = broadcast_batch(mine if rank == 0 else None, mesh, "cpu")
    data = torch.load(inp, weights_only=False)
    for name, case in data["train"].items():
        builder = port_builder(case["kind"], case.get("objective", "SISDR"))
        builder.model.load_state_dict(case["weights"])
        step, state = make_parallel_train_step(builder, mesh, builder.init_state())
        stats_seen = []
        with recording_masks() as masks:
            for k, (wavs, lengths) in enumerate(case["batches"]):
                salts = case["salts"][k] if case.get("salts") else None
                state, stats = step(state, wavs, lengths, salts=salts)
                stats_seen.append((float(stats["loss"]), float(stats["grad_norm"])))
        res[name] = {"stats": stats_seen, "masks": masks,
                     "params": {k: v.detach().clone() for k, v in state.params.items()}}
    res["eval"] = {}
    for name, ev in data["eval"].items():
        builder = port_builder(ev["kind"], ev["objective"])
        builder.model.load_state_dict(ev["weights"])
        out_eval = make_parallel_eval_step(builder, mesh)(*ev["batch"], wav_out="full")
        res["eval"][name] = {"loss": float(out_eval["loss"]),
                             "scores": {k: v.clone() for k, v in out_eval["scores"].items()},
                             "wav_predicted": out_eval["wav_predicted"].clone()}
    torch.save(res, out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
