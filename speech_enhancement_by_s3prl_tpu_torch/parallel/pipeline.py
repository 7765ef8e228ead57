"""Wavefront pipeline parallelism for a stacked one-direction LSTM
(counterpart of ``speech_enhancement_by_s3prl_tpu/parallel/pipeline.py``).

Layer l of an L-layer stack at time t needs layer l at t - 1 and layer l - 1
at t. With layer l on rank l and time cut into ``n_chunks`` chunks, rank l
runs chunk s - l at step s, so once the pipe fills all L ranks compute at
once. A bidirectional layer's backward direction needs the whole sequence
of the layer below, which breaks the wavefront, so the stack runs one
direction.

Each rank's chunk is its projection (a ``torch.matmul``, as the JAX
package's einsum lies outside its kernel) and the recurrence as kernel B1 in
one direction from the carried (h, c), writing the final state it carries
into the next chunk: the state path of ``ops/cuda/lstm_kernel.lstm_bidir_tm``
(on a CPU tensor its plain version). So a rank launches B1 ``n_chunks``
times. It is inference only, as B1 with a state is (ROADMAP A3).

The hop down the pipe is the one place that wants point-to-point, which gloo
on CUDA tensors does not run. Each step's hop is an all-reduce of zero-padded
slots instead: rank l writes its chunk's output into slot l of an (L, B, CT,
H) buffer of zeros and reads slot l - 1 of the sum (x + 0 is x, so the chunk
keeps its bits), one collective a step over the pipe's ranks, where JAX
makes one ``ppermute`` hop. The last rank's outputs reach every rank by one
more such all-reduce, as JAX's masked ``psum``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..ops.cuda.lstm_kernel import lstm_bidir_tm
from .mesh import Mesh, make_mesh


def _all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if dist.is_initialized():
        dist.all_reduce(x, group=mesh.data_group)
    return x


def pipeline_lstm(x: torch.Tensor, stacked: Dict[str, torch.Tensor], mesh: Mesh,
                  n_chunks: int = 8) -> torch.Tensor:
    """An L-layer one-direction LSTM with layer l on rank l of ``mesh`` (its
    data axis is the pipe: L = ``mesh.data`` ranks, no model axis).

    ``x`` (B, T, D) is the same on every rank; every layer takes width D
    (D == H past the first layer, as JAX requires). ``stacked`` holds
    ``w_ih`` (L, 4H, D), ``w_hh`` (L, 4H, H) and ``b`` (L, 4H) = b_ih + b_hh
    (``stack_lstm_params``). ``n_chunks`` must divide T. Returns the last
    layer's hidden states (B, T, H) f32 on every rank."""
    if mesh.model != 1:
        raise ValueError("the pipe is the mesh's data axis: build it with make_mesh(L)")
    L, p = mesh.data, mesh.d
    B, T, D = x.shape
    w_ih, w_hh, b = stacked["w_ih"], stacked["w_hh"], stacked["b"]
    if w_hh.shape[0] != L:
        raise ValueError(f"{w_hh.shape[0]} layers over a pipe of {L} ranks")
    H = w_hh.shape[2]
    if w_ih.shape[-1] != D:
        raise ValueError(f"the layers take width {w_ih.shape[-1]}, x has {D}")
    if T % n_chunks:
        raise ValueError(f"n_chunks {n_chunks} must divide the time axis {T}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w_ih, w_hh, b)):
        raise RuntimeError("pipeline_lstm is inference only: the gradient through a carried "
                           "state is not ported (ROADMAP.md A3)")
    CT = T // n_chunks
    x = x.float()
    w_ih_t = w_ih[p].float().T
    w_hh_t = w_hh[p].float().T[None].contiguous()
    bias = b[p].float()
    state = (x.new_zeros((1, B, H)), x.new_zeros((1, B, H)))
    outputs = x.new_zeros((n_chunks, B, CT, H))
    hop = incoming = None
    for s in range(n_chunks + L - 1):
        c = s - p
        out = None
        if 0 <= c < n_chunks:
            inp = x[:, c * CT:(c + 1) * CT] if p == 0 else incoming[..., :D]
            xw = (torch.matmul(inp, w_ih_t) + bias)[None].contiguous()
            hs, state = lstm_bidir_tm(xw, w_hh_t, state=state, return_state=True)
            out = hs[0]
            if p == L - 1:
                outputs[c] = out
        if L > 1 and s < n_chunks + L - 2:
            # the hop: this step's chunk to the next rank, for its next step
            hop = x.new_zeros((L, B, CT, H)) if hop is None else hop.zero_()
            if out is not None:
                hop[p] = out
            _all_reduce(hop, mesh)
            incoming = hop[p - 1] if p > 0 else None
    if p != L - 1:
        outputs.zero_()
    return _all_reduce(outputs, mesh).transpose(0, 1).reshape(B, T, H)


def make_pipe_mesh(n_ranks: int) -> Optional[Mesh]:
    """The pipe of the world's first ``n_ranks`` ranks: ``make_mesh`` when
    they are the whole world, else a group of them (every rank of the world
    calls this; a rank past the pipe gets None)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_ranks == world:
        return make_mesh(n_ranks)
    if n_ranks > world:
        raise ValueError(f"a pipe of {n_ranks} ranks in a world of {world}")
    group = dist.new_group(list(range(n_ranks)))
    rank = dist.get_rank()
    return Mesh(n_ranks, rank, data_group=group) if rank < n_ranks else None


def stack_lstm_params(params, num_layers: int) -> Dict[str, torch.Tensor]:
    """The forward direction of an ``LSTMStack``'s layers (``models/lstm.py``
    names: ``l{k}_fwd.w_ih``, ``w_hh``, ``b_ih``, ``b_hh``, under a head's
    ``lstm.``, or the stack module itself) as the stacked (L, ...) tensors
    ``pipeline_lstm`` takes. The layers must share their width."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    if any(k.startswith("lstm.") for k in params):
        params = {k[len("lstm."):]: v for k, v in params.items() if k.startswith("lstm.")}

    def layer(name):
        return torch.stack([params[f"l{k}_fwd.{name}"].detach() for k in range(num_layers)])

    return {"w_ih": layer("w_ih"), "w_hh": layer("w_hh"), "b": layer("b_ih") + layer("b_hh")}
