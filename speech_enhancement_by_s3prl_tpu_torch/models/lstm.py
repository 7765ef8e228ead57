"""Multi-layer (bi)LSTM (counterpart of
``speech_enhancement_by_s3prl_tpu/models/lstm.py``).

- The input projection of a layer is computed once for all steps; only
  h @ W_hh runs inside the recurrence.
- A bidirectional layer runs both directions in one recurrence: direction 1
  gets the time-flipped input on a leading direction axis. A one-direction
  layer runs the same recurrence with a direction axis of 1 (the JAX package
  runs a ``lax.scan`` cell there; zero initial state, no state carried out).
  The recurrence is ``ops/cuda/lstm_kernel.lstm_bidir_tm``: under autograd the
  ``LstmBidirTm`` function (kernels B2 fwd / B2 bwd on a CUDA tensor), whose
  gradients reach ``w_hh`` through dW_hh^T and ``w_ih``, ``b_ih``, ``b_hh``
  through the projection; otherwise kernel B1. A CPU tensor takes the plain
  versions on either route.
- ``recurrence`` picks the kernel a bidirectional layer runs when no gradient
  is needed: ``"tm"`` (B1, the default), ``"blocked"`` (B6,
  ``lstm_bidir_bb``: the JAX package's batch-blocked route) or ``"fused"``
  (B7, ``lstm_bidir_fused``: the input projection inside the kernel). B6 and
  B7 are forward-only, so under autograd every route is ``LstmBidirTm``. The
  parameters are the same under all three. It is a switch of this class
  alone, for the tests and the card script that hold B6 and B7 against the
  JAX package's ``lstm_bidir_pallas`` and ``lstm_bidir_pallas_fused``: no
  builder takes it, so every head, trainer and enhancer runs ``"tm"``, which
  takes every hidden size. B6 runs B1's own kernel, and B7 is slower than the
  projection plus B1 at every measured shape (``PERF.md``). The attribute
  may be set on a built stack (``head.lstm.recurrence = "blocked"``).
- Parameters are in torch layout with gate order i, f, g, o, under
  ``l{k}_fwd`` / ``l{k}_bwd`` with ``w_ih``, ``w_hh``, ``b_ih``, ``b_hh``.
- Sequences run fully padded, as the JAX package runs them: the backward
  direction of a padded batch sees the padding.

Initialization: xavier-uniform W_ih, orthogonal W_hh, zero biases.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.cuda.lstm_kernel import (
    lstm_bidir_bb,
    lstm_bidir_fused,
    lstm_bidir_tm,
)

RECURRENCES = ("tm", "blocked", "fused")


class LstmDirParams(nn.Module):
    """Parameters of one direction of one layer (torch layout)."""

    def __init__(self, hidden_size: int, input_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h4 = 4 * hidden_size
        self.w_ih = nn.Parameter(torch.empty(h4, input_size))
        self.w_hh = nn.Parameter(torch.empty(h4, hidden_size))
        self.b_ih = nn.Parameter(torch.zeros(h4))
        self.b_hh = nn.Parameter(torch.zeros(h4))
        nn.init.xavier_uniform_(self.w_ih, generator=generator)
        nn.init.orthogonal_(self.w_hh, generator=generator)


class LSTMStack(nn.Module):
    """torch ``nn.LSTM(num_layers, bidirectional, batch_first=True)``
    equivalent over (B, T, D). Output dim = hidden_size * (2 if
    bidirectional else 1). ``recurrence`` ("tm", "blocked" or "fused")
    names the forward-only kernel of the bidirectional layers, a switch for
    the tests and the card script; a one-direction layer always runs
    ``lstm_bidir_tm``."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False,
                 generator: Optional[torch.Generator] = None,
                 recurrence: str = "tm"):
        super().__init__()
        self.recurrence = recurrence
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        dirs = ("fwd", "bwd") if bidirectional else ("fwd",)
        d_in = input_size
        for k in range(num_layers):
            for name in dirs:
                # named as the flax tree names them: lstm.l0_fwd.w_ih, ...
                self.add_module(
                    f"l{k}_{name}", LstmDirParams(hidden_size, d_in, generator)
                )
            d_in = hidden_size * len(dirs)

    @property
    def recurrence(self) -> str:
        return self._recurrence

    @recurrence.setter
    def recurrence(self, value: str):
        if value not in RECURRENCES:
            raise ValueError(f"recurrence must be one of {RECURRENCES}, got {value!r}")
        self._recurrence = value

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # B6 and B7 have no backward kernel: a gradient takes LstmBidirTm
        forward_only = not (torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters())))
        for k in range(self.num_layers):
            pf = getattr(self, f"l{k}_fwd")
            if not self.bidirectional:
                # one direction on the leading axis: LstmBidirTm when a
                # gradient is needed, B1 when not
                xw = torch.matmul(x, pf.w_ih.T) + (pf.b_ih + pf.b_hh)
                x = lstm_bidir_tm(xw[None].contiguous(), pf.w_hh.T[None].contiguous())[0]
                continue
            pb = getattr(self, f"l{k}_bwd")
            xs = torch.stack([x, torch.flip(x, dims=[1])], dim=0)  # (2, B, T, D)
            w_ih = torch.stack([pf.w_ih, pb.w_ih], dim=0)  # (2, 4H, D)
            bias = torch.stack([pf.b_ih + pf.b_hh, pb.b_ih + pb.b_hh], dim=0)
            w_hh_t = torch.stack([pf.w_hh.T, pb.w_hh.T], dim=0).contiguous()  # (2, H, 4H)
            if self.recurrence == "fused" and forward_only:
                hs = lstm_bidir_fused(xs, w_ih.transpose(1, 2).contiguous(), bias, w_hh_t)
            else:
                xw = (torch.einsum("dbtn,dhn->dbth", xs, w_ih)
                      + bias[:, None, None, :]).contiguous()
                if self.recurrence == "blocked" and forward_only:
                    hs = lstm_bidir_bb(xw, w_hh_t)
                else:
                    # LstmBidirTm when a gradient is needed, B1 when not
                    hs = lstm_bidir_tm(xw, w_hh_t)
            x = torch.cat([hs[0], torch.flip(hs[1], dims=[1])], dim=-1)
        return x
