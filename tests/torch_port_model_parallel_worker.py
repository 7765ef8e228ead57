"""One rank of the tensor-parallel checks of
tests/test_torch_port_model_parallel.py.

  python tests/torch_port_model_parallel_worker.py RANK WORLD INIT_METHOD IN OUT

Joins a gloo process group on the CPU, reads what the test wrote to IN
(``torch.save``): the mesh shape (D, M), the train cases (the weights, the
global batches, the dropout rate), the eval case and a work directory; takes
the tensor-parallel train step (``parallel/mesh.py``) on this rank's rows and
shards, recording every dropout mask it draws (``recording_masks``), writes a
checkpoint of the full tree and resumes from it, scores the eval batch over
every rank, and writes what it saw to OUT. Imports torch and the port only.
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
from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_to_state_dict  # noqa: E402
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import attention_kernel as A  # noqa: E402
from speech_enhancement_by_s3prl_tpu_torch.runner import optim  # noqa: E402

LR, TOTAL = 1e-3, 10  # a short schedule, so that the updates are not tiny
# the flagship structure at tests/test_parallel.py's width
RESIDUAL = dict(hidden_size=16, num_layers=1)
MOCKINGJAY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=64, input_dim=80)


def port_builder(kind: str, dropout: float = 0.1, seed: int = 0):
    """The port's builder of a case on the CPU, BertAdam on a short schedule,
    SISDR: ``residual``, the flagship structure at ``RESIDUAL``;
    ``mockingjay``, the joint finetune at ``MOCKINGJAY`` with both dropout
    rates at ``dropout``. ``seed`` draws the weights."""
    opt = optim.build_optimizer("BertAdam", LR, 0.07, TOTAL)
    gen = torch.Generator().manual_seed(seed)
    if kind == "mockingjay":
        cfg = t_tf.TransformerConfig(**MOCKINGJAY, hidden_dropout_prob=dropout,
                                     attention_probs_dropout_prob=dropout)
        return dataclasses.replace(
            entry.build_mockingjay_train(cfg, device="cpu", generator=gen), optimizer=opt)
    return dataclasses.replace(entry.build_train(device="cpu", generator=gen, **RESIDUAL),
                               optimizer=opt)


@contextlib.contextmanager
def recording_masks():
    """Every dropout mask drawn inside, in order, as (site, first head,
    bool tensor with the batch first): the hidden-state hash dropout's
    (forward and backward; the first head 0) and B3's plain version's, keyed
    on its head offset."""
    masks = []
    hidden, full = t_tf._hash_mask_apply, A._full_mask

    def hidden_rec(x, salt, rate, batch0=0):
        masks.append(("hidden", 0, hidden(torch.ones_like(x), salt, rate, batch0) != 0))
        return hidden(x, salt, rate, batch0)

    def full_rec(B, N, T, salt, rate, batch0, device, head0=0, n_total=None):
        mask = full(B, N, T, salt, rate, batch0, device, head0, n_total)
        masks.append(("attention", head0, mask))
        return mask

    t_tf._hash_mask_apply, A._full_mask = hidden_rec, full_rec
    try:
        yield masks
    finally:
        t_tf._hash_mask_apply, A._full_mask = hidden, full


def _resume(case, builder, step, state, mesh, workdir, rank):
    """Write the full tree of ``state`` (the weights and the optimizer's
    moments) as a checkpoint on rank 0, take the next step from ``state``
    (the continued run) and from the checkpoint read back into a fresh
    builder (the resumed run): their (loss, grad norm)."""
    import torch.distributed as dist

    from speech_enhancement_by_s3prl_tpu_torch.parallel.mesh import make_parallel_train_step
    from speech_enhancement_by_s3prl_tpu_torch.runner import checkpoint as ckpt_lib
    from speech_enhancement_by_s3prl_tpu_torch.runner.trainer import TrainState

    step.tp.gather_into(builder.model, state.params)
    opt = step.tp.gather_opt_state(state.opt_state)
    ck_dir = os.path.join(workdir, "ckpt")
    if rank == 0:
        ckpt_lib.save_checkpoint(ck_dir, state.host_step, builder.model,
                                 ckpt_lib.optimizer_payload(opt), {}, {})
    dist.barrier()
    payload = ckpt_lib.load_checkpoint(os.path.join(ck_dir, f"states-{state.host_step}.ckpt"))
    wavs, lengths = case["next"]
    _, cont = step(state, wavs, lengths)
    fresh = port_builder(case["kind"], case["dropout"], seed=1)
    fresh.model.load_state_dict(flax_to_state_dict(payload["Downstream"]))
    n = int(payload["Global_step"])
    restored = TrainState(dict(fresh.model.named_parameters()),
                          ckpt_lib.optimizer_state_from_payload(payload["Optimizer"], "cpu"),
                          torch.tensor(n, dtype=torch.int32), n)
    step2, restored = make_parallel_train_step(fresh, mesh, restored)
    _, again = step2(restored, wavs, lengths)
    return {"continued": (float(cont["loss"]), float(cont["grad_norm"])),
            "resumed": (float(again["loss"]), float(again["grad_norm"])),
            "file_keys": sorted(flax_to_state_dict(payload["Downstream"])),
            "file_mu_shapes": {k: tuple(v.shape) for k, v in flax_to_state_dict(
                payload["Optimizer"]["mu"]).items()}}


def row_parallel_case():
    """A Dense 32 -> 16 with a nonzero bias and its (3, 5, 32) input."""
    gen = torch.Generator().manual_seed(7)
    layer = t_tf.dense(32, 16, 0.5, gen)
    with torch.no_grad():
        layer.bias.normal_(generator=gen)
    return layer, torch.randn(3, 5, 32, generator=gen)


def _row_parallel(mesh):
    """``ModelAxis.row_parallel`` on the rank's input columns of
    ``row_parallel_case``'s Dense, in f32 and bf16."""
    from speech_enhancement_by_s3prl_tpu_torch.parallel.mesh import ModelAxis

    layer, x = row_parallel_case()
    width = 32 // mesh.model
    cols = slice(mesh.m * width, (mesh.m + 1) * width)
    with torch.no_grad():
        layer.weight = torch.nn.Parameter(layer.weight[:, cols].clone())
        axis = ModelAxis(mesh.model_group, mesh.m, mesh.model)
        return {str(dt): axis.row_parallel(layer, x[..., cols].to(dt))
                for dt in (torch.float32, torch.bfloat16)}


def main(rank, world, init, inp, out):
    import torch.distributed as dist

    from speech_enhancement_by_s3prl_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )
    from speech_enhancement_by_s3prl_tpu_torch.parallel.mesh import (
        make_mesh,
        make_parallel_eval_step,
        make_parallel_train_step,
    )

    torch.set_num_threads(1)
    initialize_distributed(init, world, rank, device="cpu")
    data = torch.load(inp, weights_only=False)
    mesh = make_mesh(*data["mesh"])
    res = {"d": mesh.d, "m": mesh.m}
    for name, case in data["train"].items():
        builder = port_builder(case["kind"], case["dropout"])
        builder.model.load_state_dict(case["weights"])
        step, state = make_parallel_train_step(builder, mesh, builder.init_state())
        stats = []
        with recording_masks() as masks:
            for wavs, lengths in case["batches"]:
                state, st = step(state, wavs, lengths)
                stats.append((float(st["loss"]), float(st["grad_norm"])))
        sharded = step.tp.sharded
        res[name] = {
            "stats": stats, "masks": masks, "sharded": sorted(sharded),
            "params": {k: v.clone() for k, v in step.tp.gather(state.params).items()},
            "replicated": {k: v.detach().clone() for k, v in state.params.items()
                           if k not in sharded},
            "local_shapes": {k: tuple(v.shape) for k, v in state.params.items()},
            "mu_shapes": {k: tuple(v.shape) for k, v in state.opt_state["mu"].items()},
        }
        if "next" in case:
            res[name]["resume"] = _resume(case, builder, step, state, mesh, data["workdir"],
                                          rank)
    res["row_parallel"] = _row_parallel(mesh)
    ev = data["eval"]
    builder = port_builder(ev["kind"])
    builder.model.load_state_dict(ev["weights"])
    out_eval = make_parallel_eval_step(builder, mesh)(*ev["batch"], wav_out="full")
    res["eval"] = {"loss": float(out_eval["loss"]),
                   "scores": {k: v.clone() for k, v in out_eval["scores"].items()},
                   "wav_predicted": out_eval["wav_predicted"].clone()}
    torch.save(res, out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
