"""Data parallelism over ranks (counterpart of the data-parallel half of
``speech_enhancement_by_s3prl_tpu/parallel/mesh.py``).

``--mesh D`` (or ``Dx1``) runs D ranks, one process each, joined by
``torch.distributed`` (``parallel/distributed.py``). ``batch_size`` stays the
global batch: every rank iterates the same loader (same seed, same order, same
padding) and computes on its contiguous slice of each batch (``rank_rows``),
which is what GSPMD's batch sharding gives each device in the JAX package.
Each rank launches the same kernels on its rows; the JAX package needs
``lstm_bidir_tm_sharded`` and ``flash_attention_sharded`` only because GSPMD
cannot partition a Mosaic call.

The collectives are written out, as GSPMD's psum is in JAX, and use only
``all_reduce`` and ``broadcast``, the two that gloo also runs on CUDA tensors
(two ranks that share one card run gloo; NCCL refuses them):

- the train step (``make_parallel_train_step``): the rank's loss and
  gradients, of its rows with masks keyed on the global rows
  (``SaltStream(batch0=, global_batch=)``), are combined as
  sum_r w_r L_r / sum_r w_r with the objective's weights w_r
  (``objectives``): one all-reduce of the weights, one of the scaled
  gradients as a single flat bucket (it also sums B2 bwd's dW_hh^T partials,
  as JAX's ``f_bwd`` does), one of the loss. Then the global clip, the
  non-finite skip and the optimizer run unchanged on every rank, which end
  the step with the same bits. On one rank the share w / W is exactly 1, so
  the step gives the bits of the step without a mesh.
- the eval step (``make_parallel_eval_step``): each rank scores its rows;
  the per-row scores and the waveforms come back as the all-reduce of
  zero-padded rows, the loss as the weighted sum.

What waits for ROADMAP A12b: ``--mesh DxM`` with M > 1, the tensor-parallel
``param_shardings`` / ``shard_train_state`` and the scan fallback
``_mesh_safe_builder`` of the JAX module, and ``pipeline.py`` /
``sequence.py``. ``make_mesh`` refuses M > 1.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def parse_mesh(spec) -> Tuple[int, int]:
    """``"D"`` or ``"DxM"`` -> (D, M)."""
    parts = [int(p) for p in str(spec).lower().split("x")]
    if len(parts) == 1:
        parts.append(1)
    if len(parts) != 2 or min(parts) < 1:
        raise ValueError(f"--mesh takes D or DxM with D, M >= 1, got {spec!r}")
    return parts[0], parts[1]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis of a run: ``data`` ranks, this process's ``rank``."""

    data: int
    rank: int = 0

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_mesh(data: int, model: int = 1) -> Mesh:
    """The mesh of this process: ``data`` ranks, which must be the process
    group's world (a group of one where none was set up). Refuses a model
    axis (ROADMAP A12b)."""
    if model != 1:
        raise NotImplementedError(
            f"--mesh with a model axis of {model} (tensor parallelism) is not ported yet "
            "(ROADMAP A12b)")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != data:
        raise ValueError(f"--mesh {data}x1 needs {data} ranks, the process group has {world}")
    return Mesh(data, dist.get_rank() if dist.is_initialized() else 0)


def rank_span(batch: int, mesh: Mesh) -> Tuple[int, int]:
    """(first row, rows) of this rank's slice of a global batch of ``batch``
    rows, which the data axis must divide."""
    if batch % mesh.data:
        raise ValueError(f"a batch of {batch} rows does not split over {mesh.data} ranks")
    local = batch // mesh.data
    return mesh.rank * local, local


def rank_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous rows of the global batch ``x``."""
    start, local = rank_span(x.shape[0], mesh)
    return x[start:start + local]


def all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks, in place; ``x`` as it is without a
    process group."""
    if dist.is_initialized():
        dist.all_reduce(x)
    return x


def gather_rows(x: torch.Tensor, batch: int, mesh: Mesh) -> torch.Tensor:
    """The (``batch``, ...) global tensor whose rows are each rank's ``x``:
    an all-reduce of zero-padded rows (x + 0 is x, so the rows keep their
    bits)."""
    start, local = rank_span(batch, mesh)
    full = x.new_zeros((batch,) + tuple(x.shape[1:]))
    full[start:start + local] = x
    return all_reduce(full, mesh)


def broadcast(x: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    if dist.is_initialized():
        dist.broadcast(x, src)
    return x


class StepReduce:
    """What the trainer's step hands the ranks: ``combine`` the loss and
    gradients of the rank's rows into the global ones, and ``max`` for
    ``WSD``'s threshold."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def share(self, weight: torch.Tensor) -> torch.Tensor:
        """w_r / sum_r w_r, 0-d (exactly 1 on one rank)."""
        w = weight.detach().to(torch.float32).reshape(1)
        return (w / all_reduce(w.clone(), self.mesh)).reshape(())

    def combine(self, loss, weight, grads):
        """(global loss, global gradients) from the rank's: each scaled by
        its share, the gradients summed over the ranks as one flat bucket a
        dtype, the loss by its own all-reduce."""
        share = self.share(weight)
        grads = [g * share.to(g.dtype) for g in grads]
        for dtype in {g.dtype for g in grads}:
            idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
            flat = all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]), self.mesh)
            for i, piece in zip(idx, flat.split([grads[i].numel() for i in idx])):
                grads[i] = piece.view_as(grads[i])
        total = all_reduce((loss.detach().float() * share).reshape(1), self.mesh)
        return total.reshape(()), grads

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The largest of the ranks' ``x`` (0-d): their values gathered by a
        summing all-reduce, which gloo runs on CUDA tensors too."""
        return gather_rows(x.reshape(1), self.mesh.data, self.mesh).max()


def broadcast_params(params, mesh: Mesh):
    """Rank 0's parameters on every rank, in place (the ranks build the same
    weights from one seed; this makes the start of the run the same bits
    whatever each rank loaded)."""
    if mesh.data > 1:
        with torch.no_grad():
            for p in params.values():
                broadcast(p.data, mesh)


def make_parallel_train_step(builder, mesh: Mesh, state):
    """(step, state): ``step(state, wavs, lengths)`` takes the global batch
    on the rank's device and runs ``builder.train_step`` on this rank's rows,
    with the step's salts keyed on the global rows and the ranks' losses and
    gradients combined (``StepReduce``). The stats are the global ones.
    ``step(..., salts=pairs)`` replays the step's salts from a list (as a
    test replays those the JAX package drew) in place of (seed, step)."""
    from ..models.transformer import SaltStream

    broadcast_params(state.params, mesh)
    reduce = StepReduce(mesh)

    def step(st, wavs, lengths, salts=None):
        start, _ = rank_span(wavs.shape[0], mesh)
        salts = SaltStream(builder.seed, st.host_step, salts=salts, batch0=start,
                           global_batch=wavs.shape[0])
        return builder.train_step(st, rank_rows(wavs, mesh), rank_rows(lengths, mesh),
                                  salts=salts, reduce=reduce)

    return step, state


def make_parallel_eval_step(builder, mesh: Mesh):
    """``step(wavs, lengths, wav_out)``: ``builder.eval_step`` on this
    rank's rows of the global batch, returned as the global batch's: the
    loss the weighted sum of the ranks', each score (B,) and each waveform
    (B, T) gathered (``wav_out="first"``: rank 0's first row, broadcast).
    The caller feeds batches the data axis divides (the Runner runs the
    single-device step on the others)."""
    reduce = StepReduce(mesh)

    @torch.inference_mode()
    def step(wavs, lengths, wav_out: str = "full"):
        batch = wavs.shape[0]
        out, weight = builder.eval_step_weighted(rank_rows(wavs, mesh),
                                                 rank_rows(lengths, mesh), wav_out=wav_out,
                                                 reduce_max=reduce.max)
        share = reduce.share(weight)
        loss = all_reduce((out["loss"].float() * share).reshape(1), mesh).reshape(())
        scores = {k: gather_rows(v, batch, mesh) for k, v in out["scores"].items()}
        wavs_out = {}
        for key in ("wav_predicted", "wav_inp", "wav_tar"):
            w = out[key]
            if wav_out == "first":
                wavs_out[key] = broadcast(w.contiguous(), mesh)
            else:
                wavs_out[key] = gather_rows(w, batch, mesh)
        return {"loss": loss, "scores": scores, **wavs_out}

    return step


def broadcast_batch(batch: Optional[Tuple[torch.Tensor, torch.Tensor]], mesh: Mesh, device):
    """Rank 0's (lengths, wavs) on every rank (``batch`` is read on rank 0
    only). Under the active sampler the batch a step trains on is rank 0's
    choice: the sampler runs on rank 0 alone (``runner/runner.py``), and its
    thread draws from the process's ``random`` module, which also orders the
    loaders' batches, so the ranks' own loaders need not agree."""
    head = torch.zeros(4, dtype=torch.int64, device=device)
    if mesh.is_main:
        head[:] = torch.tensor([batch[0].shape[0], *batch[1].shape], dtype=torch.int64)
    broadcast(head, mesh)
    B, _, C, T = (int(x) for x in head.tolist())
    if mesh.is_main:
        lengths, wavs = (x.to(device).contiguous() for x in batch)
    else:
        lengths = torch.empty(B, dtype=torch.int64, device=device)
        wavs = torch.empty((B, C, T), dtype=torch.float32, device=device)
    return broadcast(lengths.to(torch.int64), mesh), broadcast(wavs, mesh)
