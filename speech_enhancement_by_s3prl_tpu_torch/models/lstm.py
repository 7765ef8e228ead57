"""Multi-layer (bi)LSTM (counterpart of
``speech_enhancement_by_s3prl_tpu/models/lstm.py``).

- The input projection of a layer is computed once for all steps; only
  h @ W_hh runs inside the recurrence.
- A bidirectional layer runs both directions in one recurrence: direction 1
  gets the time-flipped input on a leading direction axis. The recurrence is
  ``ops/cuda/lstm_kernel.lstm_bidir_tm``: under autograd the
  ``LstmBidirTm`` function (kernels B2 fwd / B2 bwd on a CUDA tensor), whose
  gradients reach ``w_hh`` through dW_hh^T and ``w_ih``, ``b_ih``, ``b_hh``
  through the einsum; otherwise kernel B1. A CPU tensor takes the plain
  versions on either route.
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

from ..ops.cuda.lstm_kernel import lstm_bidir_tm, lstm_bidir_tm_ref


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
    bidirectional else 1)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for k in range(self.num_layers):
            pf = getattr(self, f"l{k}_fwd")
            if not self.bidirectional:
                # no kernel in the JAX package either: a plain time loop
                xw = torch.matmul(x, pf.w_ih.T) + (pf.b_ih + pf.b_hh)
                x = lstm_bidir_tm_ref(xw, pf.w_hh.T)
                continue
            pb = getattr(self, f"l{k}_bwd")
            xs = torch.stack([x, torch.flip(x, dims=[1])], dim=0)  # (2, B, T, D)
            w_ih = torch.stack([pf.w_ih, pb.w_ih], dim=0)  # (2, 4H, D)
            bias = torch.stack([pf.b_ih + pf.b_hh, pb.b_ih + pb.b_hh], dim=0)
            xw = torch.einsum("dbtn,dhn->dbth", xs, w_ih) + bias[:, None, None, :]
            w_hh_t = torch.stack([pf.w_hh.T, pb.w_hh.T], dim=0)  # (2, H, 4H)
            # LstmBidirTm when a gradient is needed, B1 when not
            hs = lstm_bidir_tm(xw.contiguous(), w_hh_t.contiguous())
            x = torch.cat([hs[0], torch.flip(hs[1], dims=[1])], dim=-1)
        return x
