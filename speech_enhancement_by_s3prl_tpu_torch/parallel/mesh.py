"""Data and tensor parallelism over ranks (counterpart of
``speech_enhancement_by_s3prl_tpu/parallel/mesh.py``).

``--mesh D`` (or ``Dx1``) runs D ranks, ``--mesh DxM`` D * M, one process
each, joined by ``torch.distributed`` (``parallel/distributed.py``). Rank r
sits at (d, m) = (r // M, r % M) of the ('data', 'model') mesh, as the JAX
package's ``reshape(n // M, M)`` of its devices puts them. ``batch_size``
stays the global batch, which D must divide: every rank iterates the same
loader (same seed, same order, same padding) and computes on its data
index's contiguous slice of each batch (``rank_rows``), which is what GSPMD's
batch sharding gives each device in the JAX package; the M ranks of a model
group hold the same rows. Each rank launches the same kernels on its rows;
the JAX package needs ``lstm_bidir_tm_sharded`` and
``flash_attention_sharded`` (and falls back to its scan recurrence and its
non-flash attention under a model axis) only because GSPMD cannot partition
a Mosaic call. A PyTorch rank runs its own kernels on its own shard, so B2
and B3 stay on the card under tensor parallelism too.

The collectives are written out, as GSPMD's psum is in JAX, and use only
``all_reduce`` and ``broadcast``, the two that gloo also runs on CUDA tensors
(ranks that share one card run gloo; NCCL refuses them). A gather is an
all-reduce of zero-padded pieces (x + 0 is x, so the pieces keep their bits).
Under a model axis the mesh has two kinds of group, made by ``dist.new_group``
in the same order on every rank: the data group of the D ranks that share m,
and the model group of the M ranks that share d.

- The train step (``make_parallel_train_step``): the rank's loss and
  gradients, of its rows with masks keyed on the global rows
  (``SaltStream(batch0=, global_batch=)``), are combined over the data group
  as sum_r w_r L_r / sum_r w_r with the objective's weights w_r
  (``objectives``): one all-reduce of the weights, one of the scaled
  gradients as a single flat bucket (it also sums B2 bwd's dW_hh^T partials,
  as JAX's ``f_bwd`` does), one of the loss. Then the global clip, the
  non-finite skip and the optimizer run unchanged on every rank. On one rank
  the share w / W is exactly 1, so the step gives the bits of the step
  without a mesh.
- Tensor parallelism (M > 1): ``param_shardings`` gives each parameter the
  dimension it is cut along over the model axis, by the JAX package's
  ``_param_spec`` (the Megatron pairing: ``attention/qkv`` and
  ``intermediate`` column-parallel, kernel and bias; every ``layer_*``'s
  ``output`` kernel row-parallel; the LSTM's ``w_ih`` / ``w_hh`` / ``b_ih`` /
  ``b_hh`` on their gate rows; the rest replicated) with its divisibility
  guard. ``TensorParallel`` makes the step's model a copy whose sharded
  parameters are the rank's slices (``shard_train_state`` slices their
  BertAdam ``mu`` / ``nu`` alike) and tells its modules their model group:
  ``SelfAttention`` runs its N / M heads (B3 keyed on the head offset,
  ``head0``, so the rank draws the unsharded launch's masks for its heads),
  ``TransformerLayer`` its FFN columns, each pair's input an identity forward
  with an all-reduced gradient and its output an all-reduced forward (the
  bias added once after it) with an identity backward; ``LSTMStack`` gathers
  its gate rows into the full tensors at each forward and keeps its rows of
  the gradient (``models/lstm.py``). The global clip all-reduces the sharded
  parameters' squared norms over the model group and counts the replicated
  ones once (``StepReduce.sq_norm``), so every rank takes the same scale and
  the same skip decision, and BertAdam runs on its slices unchanged.
  ``gather_params`` / ``gather_opt_state`` give the full tree (checkpoints,
  the eval, the sampler and the media read the full model).
- The eval step (``make_parallel_eval_step``): each rank scores its rows,
  over all D * M ranks (``Mesh.flat``: the eval has no gradient to share, so
  the model axis acts as data parallelism, as in the JAX package); the
  per-row scores and the waveforms come back as the all-reduce of zero-padded
  rows, the loss as the weighted sum.

Where the port's layout differs from JAX's: JAX's ``P(None, 'model')`` on
the fused (H, 3H) qkv kernel cuts [q | k | v] into contiguous thirds and
leaves GSPMD to reshard them into heads. A rank here needs whole heads, so
the qkv rows shard by heads (rank m owns the q, k and v rows of heads
[m N / M, (m + 1) N / M)), and the guard of qkv and of the attention output
is N % M (JAX's: 3H % M and H % M); the guard of ``intermediate`` and of the
FFN output is the FFN width, of the LSTM 4H. Where N % M != 0 but 3H % M ==
0 (12 heads over 8 ranks, say) JAX shards the attention and the port
replicates it: the memory differs, the function does not.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..models.convert import flax_path


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
    """The ('data', 'model') mesh of a run: ``data`` x ``model`` ranks, this
    process's ``rank``, and its two groups (None: the whole world, as with
    one model rank, or no group at all)."""

    data: int
    rank: int = 0
    model: int = 1
    data_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    model_group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def d(self) -> int:
        """This rank's index on the data axis."""
        return self.rank // self.model

    @property
    def m(self) -> int:
        """This rank's index on the model axis."""
        return self.rank % self.model

    @property
    def size(self) -> int:
        return self.data * self.model

    def flat(self) -> "Mesh":
        """Every rank a data rank (the eval's mesh)."""
        return Mesh(self.size, self.rank)


def make_mesh(data: int, model: int = 1) -> Mesh:
    """The mesh of this process: ``data`` x ``model`` ranks, which must be
    the process group's world (a group of one where none was set up). Under
    a model axis every rank makes the D data groups and the M model groups,
    in the same order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != data * model:
        raise ValueError(f"--mesh {data}x{model} needs {data * model} ranks, the process "
                         f"group has {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    if model == 1:
        return Mesh(data, rank)
    data_groups = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
    return Mesh(data, rank, model, data_groups[rank % model], model_groups[rank // model])


def rank_span(batch: int, mesh: Mesh) -> Tuple[int, int]:
    """(first row, rows) of this rank's slice of a global batch of ``batch``
    rows, which the data axis must divide."""
    if batch % mesh.data:
        raise ValueError(f"a batch of {batch} rows does not split over {mesh.data} ranks")
    local = batch // mesh.data
    return mesh.d * local, local


def rank_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous rows of the global batch ``x``."""
    start, local = rank_span(x.shape[0], mesh)
    return x[start:start + local]


def all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the data group, in place; ``x`` as it is without
    a process group."""
    if dist.is_initialized():
        dist.all_reduce(x, group=mesh.data_group)
    return x


def gather_rows(x: torch.Tensor, batch: int, mesh: Mesh) -> torch.Tensor:
    """The (``batch``, ...) global tensor whose rows are each data rank's
    ``x``: an all-reduce of zero-padded rows."""
    start, local = rank_span(batch, mesh)
    full = x.new_zeros((batch,) + tuple(x.shape[1:]))
    full[start:start + local] = x
    return all_reduce(full, mesh)


def broadcast(x: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank of the world, in place."""
    if dist.is_initialized():
        dist.broadcast(x, src)
    return x


# -- the model axis -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shard:
    """How a parameter is cut over the model axis: dimension ``dim`` is
    ``blocks`` contiguous blocks (3 for the fused [q | k | v]), each cut into
    M pieces, and rank m holds the m-th piece of every block."""

    dim: int
    blocks: int = 1


def shard_tensor(x: torch.Tensor, spec: Shard, index: int, size: int) -> torch.Tensor:
    """The rank's slice of the full ``x`` (a copy)."""
    return torch.cat([b.chunk(size, dim=spec.dim)[index]
                      for b in x.chunk(spec.blocks, dim=spec.dim)], dim=spec.dim).clone()


def _place(local: torch.Tensor, spec: Shard, shape, index: int, size: int) -> torch.Tensor:
    """The full tensor of ``shape`` that holds ``local`` where
    ``shard_tensor`` took it from, zeros elsewhere."""
    full = local.new_zeros(shape)
    block = shape[spec.dim] // spec.blocks
    piece = block // size
    for b in range(spec.blocks):
        full.narrow(spec.dim, b * block + index * piece, piece).copy_(
            local.narrow(spec.dim, b * piece, piece))
    return full


def _gather_shards(local, specs, shapes, index: int, size: int, group):
    """The full tensors of the slices ``local`` (cut by ``specs`` from
    tensors of ``shapes``): one all-reduce of zero-padded tensors over
    ``group``."""
    fulls = [_place(x, s, shape, index, size) for x, s, shape in zip(local, specs, shapes)]
    flat = torch.cat([f.reshape(-1) for f in fulls])
    dist.all_reduce(flat, group=group)
    return [p.view(shape) for p, shape in zip(flat.split([f.numel() for f in fulls]), shapes)]


def param_shardings(mesh: Mesh, params: Dict[str, torch.Tensor],
                    n_heads: Optional[int] = None) -> Dict[str, Optional[Shard]]:
    """{parameter name: its ``Shard`` over the model axis, or None where it
    is replicated}: the JAX package's ``_param_spec`` read on the flax path
    of each ``state_dict`` name, with the port's guards (the module
    docstring). ``n_heads`` is the encoder's head count (None: no
    attention is sharded)."""
    M = mesh.model

    def one(name, x):
        flat = "/".join(flax_path(name, x.dim())[1:])
        shape = tuple(x.shape)
        heads_ok = n_heads is not None and n_heads % M == 0
        if "w_ih" in flat or "w_hh" in flat or "b_ih" in flat or "b_hh" in flat:
            return Shard(0) if shape[0] % M == 0 else None
        if "qkv" in flat and (flat.endswith("kernel") or flat.endswith("bias")):
            return Shard(0, 3) if heads_ok else None
        if "intermediate" in flat and (flat.endswith("kernel") or flat.endswith("bias")):
            return Shard(0) if shape[0] % M == 0 else None
        if "layer_" in flat and flat.endswith("output/kernel") and x.dim() == 2:
            if "attention/output" in flat:
                return Shard(1) if heads_ok else None
            return Shard(1) if shape[1] % M == 0 else None
        return None

    if M == 1:
        return {k: None for k in params}
    return {k: one(k, v) for k, v in params.items()}


class _CopyIn(torch.autograd.Function):
    """The input of a column-parallel product: identity forward, the
    gradient all-reduced over the model group (each rank's heads or FFN
    columns give a part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceOut(torch.autograd.Function):
    """The output of a row-parallel product: the ranks' partial sums
    all-reduced over the model group, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """A rank's place on the model axis: its ``group``, its ``index`` m and
    the axis ``size`` M. What a module that the axis shards calls."""

    group: Any
    index: int
    size: int

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self.group)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceOut.apply(x, self.group)

    def row_parallel(self, dense: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """``dense`` (the rank's input columns of its weight, the full bias)
        on the rank's part ``x`` of the input: the partial products all-reduced,
        the bias added once after. A bf16 ``x`` sums its exact bf16 products
        in f32 across the ranks, is rounded to bf16 once and takes the bf16
        bias, as ``models/transformer.Dense`` computes it unsharded."""
        if x.dtype == torch.float32:
            return self.reduce_out(torch.nn.functional.linear(x, dense.weight)) + dense.bias
        part = torch.nn.functional.linear(x.float(), dense.weight.to(x.dtype).float())
        return self.reduce_out(part).to(x.dtype) + dense.bias.to(x.dtype)


class _GatherShards(torch.autograd.Function):
    """The full tensors of the rank's slices, gathered over the model group
    as one all-reduce of zero-padded tensors; the backward keeps the rank's
    slice of each gradient (the M ranks of a group compute the same full
    gradient on the same rows)."""

    @staticmethod
    def forward(ctx, gather, *local):
        ctx.gather = gather
        axis = gather.axis
        return tuple(_gather_shards([x.detach() for x in local], gather.specs, gather.shapes,
                                    axis.index, axis.size, axis.group))

    @staticmethod
    def backward(ctx, *grads):
        g = ctx.gather
        return (None,) + tuple(
            None if d is None else shard_tensor(d, s, g.axis.index, g.axis.size)
            for d, s in zip(grads, g.specs))


@dataclasses.dataclass(frozen=True)
class ShardGather:
    """What a module whose parameters are stored sharded gathers at each
    forward: ``names`` (its own parameter names), their ``specs`` and full
    ``shapes``, over ``axis``."""

    axis: ModelAxis
    names: Tuple[str, ...]
    specs: Tuple[Shard, ...]
    shapes: Tuple[Tuple[int, ...], ...]

    def __call__(self, module: nn.Module) -> Dict[str, torch.Tensor]:
        params = dict(module.named_parameters())
        fulls = _GatherShards.apply(self, *(params[n] for n in self.names))
        return dict(zip(self.names, fulls))


def _owner(model: nn.Module, name: str):
    path, _, attr = name.rpartition(".")
    return (model.get_submodule(path) if path else model), attr


def encoder_heads(model: nn.Module) -> Optional[int]:
    """The attention head count of the model's transformer, or None."""
    from ..models.transformer import SelfAttention

    for module in model.modules():
        if isinstance(module, SelfAttention):
            return module.config.num_attention_heads
    return None


def shard_model(model: nn.Module, mesh: Mesh) -> Dict[str, Optional[Shard]]:
    """Cut ``model``'s parameters over the model axis, in place: each
    sharded parameter becomes the rank's slice, and each module that holds
    one is told its ``ModelAxis`` (the module docstring). Returns the
    shardings (``param_shardings``)."""
    from ..models.lstm import LSTMStack
    from ..models.transformer import SelfAttention, TransformerLayer

    params = dict(model.named_parameters())
    specs = param_shardings(mesh, params, encoder_heads(model))
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    axis = ModelAxis(mesh.model_group, mesh.m, mesh.model)
    with torch.no_grad():
        for name, spec in specs.items():
            if spec is not None:
                owner, attr = _owner(model, name)
                old = getattr(owner, attr)
                setattr(owner, attr, nn.Parameter(shard_tensor(old, spec, mesh.m, mesh.model),
                                                  requires_grad=old.requires_grad))
    for prefix, module in model.named_modules():
        pre = prefix + "." if prefix else ""
        if isinstance(module, SelfAttention) and specs.get(pre + "qkv.weight"):
            module.tp = axis
        elif isinstance(module, TransformerLayer) and specs.get(pre + "intermediate.weight"):
            module.ffn_tp = axis
        elif isinstance(module, LSTMStack):
            names = tuple(n for n, _ in module.named_parameters() if specs.get(pre + n))
            if names:
                module.tp = ShardGather(axis, names, tuple(specs[pre + n] for n in names),
                                        tuple(shapes[pre + n] for n in names))
    return specs


def gather_params(mesh: Mesh, params: Dict[str, torch.Tensor],
                  specs: Dict[str, Optional[Shard]],
                  shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, torch.Tensor]:
    """The full tensors of ``params`` (the rank's slices where ``specs``
    shards them, of full ``shapes``), each sharded one gathered over the
    model group in one all-reduce of zero-padded tensors."""
    names = [k for k in params if specs.get(k) is not None]
    out = {k: v.detach() for k, v in params.items()}
    if names:
        out.update(zip(names, _gather_shards(
            [params[k].detach() for k in names], [specs[k] for k in names],
            [shapes[k] for k in names], mesh.m, mesh.model, mesh.model_group)))
    return out


@dataclasses.dataclass
class TensorParallel:
    """The model axis of a train step: ``model``, the step's copy of the
    full model with its parameters sharded (``shard_model``), and what turns
    its state back into the full tree."""

    mesh: Mesh
    model: nn.Module
    specs: Dict[str, Optional[Shard]]
    shapes: Dict[str, Tuple[int, ...]]

    @classmethod
    def of(cls, full: nn.Module, mesh: Mesh) -> "TensorParallel":
        shapes = {k: tuple(v.shape) for k, v in full.named_parameters()}
        model = copy.deepcopy(full)
        return cls(mesh, model, shard_model(model, mesh), shapes)

    @property
    def sharded(self) -> frozenset:
        return frozenset(k for k, s in self.specs.items() if s is not None)

    def shard(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The rank's slices of a full tree keyed by parameter name."""
        m, M = self.mesh.m, self.mesh.model
        return {k: (v if self.specs.get(k) is None else shard_tensor(v, self.specs[k], m, M))
                for k, v in tree.items()}

    def gather(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The full tree of a tree of the rank's slices (a collective of the
        model group)."""
        return gather_params(self.mesh, tree, self.specs, self.shapes)

    def gather_opt_state(self, opt_state: dict) -> dict:
        """The full optimizer state: ``mu`` and ``nu`` gathered as their
        parameters (one collective each)."""
        return {**opt_state, "mu": self.gather(opt_state["mu"]),
                "nu": self.gather(opt_state["nu"])}

    def gather_into(self, full: nn.Module, params: Dict[str, torch.Tensor]):
        """Copy the full tree of the step's ``params`` into the full model
        ``full``, in place."""
        tree = self.gather(params)
        with torch.no_grad():
            for k, p in full.named_parameters():
                p.copy_(tree[k])


def shard_train_state(mesh: Mesh, state, tp: TensorParallel):
    """The train state of ``tp.model``: its parameters (the rank's slices)
    and the optimizer's ``mu`` / ``nu`` sliced as their parameters (matched
    by name, as ``runner/optim.py`` keys them), the counts and the step as
    they are."""
    from ..runner.trainer import TrainState

    opt = state.opt_state
    opt = {**opt, "mu": tp.shard(opt["mu"]), "nu": tp.shard(opt["nu"])}
    return TrainState(dict(tp.model.named_parameters()), opt, state.step, state.host_step)


class StepReduce:
    """What the trainer's step hands the ranks: ``combine`` the loss and
    gradients of the rank's rows into the global ones, ``sq_norm`` the
    squared global norm of the gradients, and ``max`` for ``WSD``'s
    threshold. ``sharded`` names the parameters stored sharded over the
    model axis."""

    def __init__(self, mesh: Mesh, sharded: Iterable[str] = ()):
        self.mesh = mesh
        self.sharded = frozenset(sharded)

    def share(self, weight: torch.Tensor) -> torch.Tensor:
        """w_r / sum_r w_r, 0-d (exactly 1 on one rank)."""
        w = weight.detach().to(torch.float32).reshape(1)
        return (w / all_reduce(w.clone(), self.mesh)).reshape(())

    def combine(self, loss, weight, grads):
        """(global loss, global gradients) from the rank's: each scaled by
        its share, the gradients summed over the data group as one flat
        bucket a dtype, the loss by its own all-reduce."""
        share = self.share(weight)
        grads = [g * share.to(g.dtype) for g in grads]
        for dtype in {g.dtype for g in grads}:
            idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
            flat = all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]), self.mesh)
            for i, piece in zip(idx, flat.split([grads[i].numel() for i in idx])):
                grads[i] = piece.view_as(grads[i])
        total = all_reduce((loss.detach().float() * share).reshape(1), self.mesh)
        return total.reshape(()), grads

    def sq_norm(self, names, grads) -> torch.Tensor:
        """The squared global norm of ``grads`` (named by ``names``): the
        replicated parameters' terms once, the sharded ones' all-reduced over
        the model group. Without a model axis it is the sum of the single
        process, in its order."""
        if not self.sharded:
            return sum((g.float() ** 2).sum() for g in grads)
        terms = dict(zip(names, grads))
        own = torch.stack([(terms[k].float() ** 2).sum() for k in names if k in self.sharded])
        part = own.sum().reshape(1)
        dist.all_reduce(part, group=self.mesh.model_group)
        return sum((g.float() ** 2).sum() for k, g in terms.items()
                   if k not in self.sharded) + part.reshape(())

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The largest of the data ranks' ``x`` (0-d): their values gathered
        by a summing all-reduce, which gloo runs on CUDA tensors too."""
        return gather_rows(x.reshape(1), self.mesh.data, self.mesh).max()


def broadcast_params(params, mesh: Mesh):
    """Rank 0's parameters on every rank, in place (the ranks build the same
    weights from one seed; this makes the start of the run the same bits
    whatever each rank loaded)."""
    if mesh.size > 1:
        with torch.no_grad():
            for p in params.values():
                broadcast(p.data, mesh)


def make_parallel_train_step(builder, mesh: Mesh, state):
    """(step, state): ``step(state, wavs, lengths, rng=None)`` takes the
    global batch on the rank's device and runs ``builder.train_step`` on this
    rank's rows, with the step's global key (``rng``, the JAX step's argument;
    every rank the same) and the masks keyed on the global rows, and the
    ranks' losses and gradients combined (``StepReduce``). The stats are the
    global ones. ``step(..., salts=pairs)`` replays the step's salts from a
    list (as a test replays those the JAX package drew) in place of the key.

    Under a model axis the step trains ``step.tp.model``, a sharded copy of
    ``builder.model`` (``TensorParallel``), and the returned state holds its
    slices; ``builder.model`` keeps the full weights of the start until
    ``step.tp.gather_into`` brings it the step's (``step.tp`` is None
    without a model axis)."""
    from ..models.transformer import SaltStream
    from ..runner.trainer import step_key

    broadcast_params(state.params, mesh)
    tp, train_builder = None, builder
    if mesh.model > 1:
        tp = TensorParallel.of(builder.model, mesh)
        state = shard_train_state(mesh, state, tp)
        train_builder = dataclasses.replace(builder, model=tp.model)
    reduce = StepReduce(mesh, () if tp is None else tp.sharded)

    def step(st, wavs, lengths, salts=None, rng=None):
        start, _ = rank_span(wavs.shape[0], mesh)
        salts = SaltStream(salts=salts, batch0=start, global_batch=wavs.shape[0],
                           key=step_key(builder.seed if rng is None else rng, st.host_step))
        return train_builder.train_step(st, rank_rows(wavs, mesh), rank_rows(lengths, mesh),
                                        salts=salts, reduce=reduce)

    step.tp = tp
    return step, state


def make_parallel_eval_step(builder, mesh: Mesh):
    """``step(wavs, lengths, wav_out)``: ``builder.eval_step`` on this
    rank's rows of the global batch, over all D * M ranks (``Mesh.flat``),
    returned as the global batch's: the loss the weighted sum of the ranks',
    each score (B,) and each waveform (B, T) gathered (``wav_out="first"``:
    rank 0's first row, broadcast). ``builder.model`` holds the full weights
    on every rank. The caller feeds batches that D * M divides (the Runner
    runs the single-device step on the others)."""
    mesh = mesh.flat()
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
