"""Sequence parallelism for the TERA/Mockingjay encoder (counterpart of
``speech_enhancement_by_s3prl_tpu/parallel/sequence.py``).

A ('data', 'seq') mesh (``make_seq_mesh``: the port's ``Mesh`` whose model
axis is the seq axis, rank r at (r // S, r % S)). The (B, T, D) features are
split batch over 'data' and time over 'seq': every per-position operation
(the input projection, the LayerNorms, the FFN, the residuals) runs on the
rank's time chunk with no communication, the position encodings start at
the chunk's offset (seq index x local T), and each layer's attention takes
the rank's queries against the keys and values of the whole sequence,
gathered over the seq group as an all-reduce of zero-padded chunks (gloo on
CUDA tensors runs no all-gather) and attended by
``F.scaled_dot_product_attention``, as JAX's non-flash path is. It is
deterministic (dropout off) and forward only, as in the JAX package.

The result is the global (B, T', H) on every rank: the ranks' chunks,
gathered the same way over the whole mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh


@dataclasses.dataclass(frozen=True)
class SeqAxis:
    """A rank's place on the seq axis: its ``group``, its ``index`` and the
    axis ``size``; what ``models/transformer.py`` calls."""

    group: Any
    index: int
    size: int

    def gather_time(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C) chunks of the seq group -> the (B, size * T, C) whole, in
        seq order."""
        B, T, C = x.shape
        full = x.new_zeros((B, self.size * T, C))
        full[:, self.index * T:(self.index + 1) * T] = x
        dist.all_reduce(full, group=self.group)
        return full


def make_seq_mesh(n_ranks: Optional[int] = None, seq_parallel: int = 2) -> Mesh:
    """The ('data', 'seq') mesh of ``n_ranks`` (the process group's world by
    default) with ``seq_parallel`` ranks a seq group, which must divide it."""
    n = n_ranks or (dist.get_world_size() if dist.is_initialized() else 1)
    if n % seq_parallel:
        raise ValueError(f"seq_parallel {seq_parallel} does not divide {n} ranks")
    return make_mesh(n // seq_parallel, seq_parallel)


def sequence_parallel_encoder(encoder, mesh: Mesh):
    """``fn(spec (B, T, D)) -> (B, T', H)``: ``encoder`` (a
    ``models.transformer.TransformerEncoder``) over the rank's block of
    ``spec`` (the same global tensor on every rank), the global output
    returned on every rank. Refuses, as the JAX package asserts, a batch the
    data axis does not divide, a T that seq x ``downsample_rate`` does not
    divide (``pad_frames_for_seq`` pads one) and more positions than the
    position-encoding table holds."""
    from ..models.transformer import MAX_POSITIONS

    seq = mesh.model
    dr = max(1, encoder.config.downsample_rate)
    axis = SeqAxis(mesh.model_group, mesh.m, seq)

    @torch.no_grad()
    def fn(spec: torch.Tensor) -> torch.Tensor:
        B, T, _ = spec.shape
        if B % mesh.data:
            raise ValueError(f"data axis {mesh.data} must divide batch {B}")
        if T % (seq * dr):
            raise ValueError(f"seq*downsample {seq * dr} must divide time {T} "
                             "(pad frames to a multiple first)")
        if T // dr > MAX_POSITIONS:
            raise ValueError(f"{T // dr} encoder positions exceed the position-encoding "
                             f"table ({MAX_POSITIONS})")
        rows, t_local = B // mesh.data, T // seq
        local = spec[mesh.d * rows:(mesh.d + 1) * rows,
                     mesh.m * t_local:(mesh.m + 1) * t_local]
        was = encoder.training
        encoder.eval()
        try:
            out = encoder(local, seq=axis if seq > 1 else None)
        finally:
            encoder.train(was)
        t_out = out.shape[1]
        full = out.new_zeros((B, t_out * seq, out.shape[2]))
        full[mesh.d * rows:(mesh.d + 1) * rows, mesh.m * t_out:(mesh.m + 1) * t_out] = out
        if dist.is_initialized():
            dist.all_reduce(full)
        return full

    return fn


def pad_frames_for_seq(spec: torch.Tensor, seq: int, dr: int = 1):
    """Zero-pad the time axis to a multiple of seq * dr; returns (padded,
    the original T), so that a caller can trim the encoder's output back."""
    t = spec.shape[1]
    pad = (-t) % (seq * dr)
    if pad:
        spec = torch.nn.functional.pad(spec, (0, 0, 0, pad))
    return spec, t
