"""Time-major bidirectional LSTM recurrence: the hand-written CUDA kernel
(``csrc/lstm_tm.cu``, which replaces the Pallas kernel
``speech_enhancement_by_s3prl_tpu/ops/pallas/lstm_kernel.py::
lstm_bidir_pallas_tm``) and its plain PyTorch version.

Both keep the JAX layout: ``xw`` (2, B, T, 4H) holds the input projections
plus biases, direction 1 already time-flipped; ``w_hh_t`` (2, H, 4H) is
W_hh^T per direction; the result ``hs`` is (2, B, T, H) f32. Gate order is
i, f, g, o; h and c start at zero and stay f32. There are no lengths: the
recurrence runs over the whole (padded) T, as the JAX package does.
"""
from __future__ import annotations

import ctypes

import torch


def lstm_bidir_tm_ref(xw: torch.Tensor, w_hh_t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch recurrence: a Python loop over time.

    Works for any leading axes: xw (..., B, T, 4H) with w_hh_t (..., H, 4H)
    gives (..., B, T, H), so the unidirectional layer runs it with none."""
    H = w_hh_t.shape[-2]
    lead = xw.shape[:-2]  # (..., B)
    h = xw.new_zeros(lead + (H,), dtype=torch.float32)
    c = torch.zeros_like(h)
    hs = []
    for t in range(xw.shape[-2]):
        gates = xw[..., t, :].float() + torch.matmul(h, w_hh_t)
        i, f, g, o = gates.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=-2)


def _check(xw: torch.Tensor, w_hh_t: torch.Tensor):
    if xw.dim() != 4 or xw.shape[0] != 2 or xw.shape[-1] % 4:
        raise ValueError(f"xw must be (2, B, T, 4H), got {tuple(xw.shape)}")
    H = xw.shape[-1] // 4
    if tuple(w_hh_t.shape) != (2, H, 4 * H):
        raise ValueError(
            f"w_hh_t must be (2, {H}, {4 * H}) for xw {tuple(xw.shape)}, "
            f"got {tuple(w_hh_t.shape)}"
        )
    if xw.dtype != torch.float32 or w_hh_t.dtype != torch.float32:
        raise ValueError(
            f"lstm_bidir_tm takes f32 tensors, got {xw.dtype} / {w_hh_t.dtype}"
        )
    if xw.device != w_hh_t.device:
        raise ValueError(f"xw on {xw.device} but w_hh_t on {w_hh_t.device}")


def _library():
    from ._build import load

    lib = load("lstm_tm")
    lib.lstm_bidir_tm_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.lstm_bidir_tm_f32.restype = ctypes.c_int
    lib.lstm_tm_error_string.argtypes = [ctypes.c_int]
    lib.lstm_tm_error_string.restype = ctypes.c_char_p
    return lib


def lstm_bidir_tm(xw: torch.Tensor, w_hh_t: torch.Tensor) -> torch.Tensor:
    """(2, B, T, 4H), (2, H, 4H) -> hs (2, B, T, H), all f32.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    or raises; nothing falls back. Forward only: the differentiable pair
    (the Pallas ``_kernel_tm_fc`` / ``_kernel_tm_bwd``) is not ported yet."""
    _check(xw, w_hh_t)
    if xw.device.type == "cpu":
        return lstm_bidir_tm_ref(xw, w_hh_t)
    if xw.device.type != "cuda":
        raise ValueError(f"lstm_bidir_tm runs on cpu or cuda, not {xw.device}")
    if torch.is_grad_enabled() and (xw.requires_grad or w_hh_t.requires_grad):
        raise NotImplementedError(
            "the CUDA recurrence is forward-only; its backward kernel is "
            "ROADMAP B2"
        )
    if not (xw.is_contiguous() and w_hh_t.is_contiguous()):
        raise ValueError("lstm_bidir_tm needs contiguous xw and w_hh_t")
    _, B, T, h4 = xw.shape
    H = h4 // 4
    hs = torch.empty((2, B, T, H), device=xw.device, dtype=torch.float32)
    if B == 0 or T == 0:
        return hs
    lib = _library()
    err = lib.lstm_bidir_tm_f32(
        xw.data_ptr(), w_hh_t.data_ptr(), hs.data_ptr(), B, T, H,
        xw.device.index if xw.device.index is not None
        else torch.cuda.current_device(),
        torch.cuda.current_stream(xw.device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"lstm_bidir_tm kernel failed: CUDA error {err} "
            f"({lib.lstm_tm_error_string(err).decode()}) at B={B} T={T} H={H}"
        )
    lstm_bidir_tm.launches += 1
    return hs


# kernel launches since the last reset (chip_smoke.py reads it to show that
# the main path went through the kernel)
lstm_bidir_tm.launches = 0
