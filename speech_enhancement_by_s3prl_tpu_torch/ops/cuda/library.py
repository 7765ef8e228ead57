"""The kernels of the serving path as ``torch.library`` custom ops, in the
namespace ``se_torch``, so that PyTorch's dispatcher, ``torch.export`` and any
later graph capture see them (a ctypes call is opaque to all three):

- ``se_torch::lstm_recurrence`` (B1, ``lstm_kernel.lstm_bidir_tm`` without a
  carried state): xw (ndir, B, T, 4H) f32, bf16 or int8, w_hh_t (ndir, H,
  4H) f32, ``h_bf16`` (the bf16-h form; on bf16 W_hh^T values the MXU form),
  ``hs_bf16`` (hs stored in bf16), ``gates_bf16`` (the gates form, default
  off) and ``xw_scale`` (ndir, B, T, 1) f32 beside an int8 xw (default None)
  -> hs (ndir, B, T, H) in f32, or bf16 with ``hs_bf16``. The last two
  arguments came with the gates and int8 forms and have defaults, so a
  program exported before them, whose calls pass four, loads and replays as
  it did;
- ``se_torch::stft`` (B4, ``stft_kernel.stft_fused``): rows (N, time) f32 ->
  (N, 1 + time // hop, 2 * (n_fft // 2 + 1)) f32;
- ``se_torch::decode`` (B5, ``decode_kernel.decode_ola``): pred (B, T', F),
  uph (B, T', 2F) f32 -> the raw overlap-add (B, (T' + K - 1) * hop) f32,
  K = ceil(n_fft / hop).

Each op has the kernel wrapper's launch, with its counts, as its CUDA kernel
and the plain PyTorch version as its CPU kernel, so the dispatcher, not the
wrapper, decides by the tensors' device; on any other device it raises. What a
launch needs beyond its arguments (the route, the batch block, the FFT tables
and plans) is worked out inside the CUDA kernel from the concrete shapes and
device, so a traced graph holds none of them. The fake kernels give the output
shapes and dtypes for any batch, a symbolic one included. Flags are ``bool``s,
not dtypes, which an op's schema does not take.

The ops are defined on a ``torch.library.Library`` with a kernel for each of
the ``CPU`` and ``CUDA`` dispatch keys and none for autograd (the wrappers
call them only where no gradient is taken): a call then crosses the
dispatcher once into its Python kernel, without the per-call autograd and
schema layers a ``torch.library.custom_op`` adds on the eager serving path.
The module's names are the ops' overloads (``torch.ops.se_torch.*.default``).

The wrappers call these ops; the autograd paths (B2, B3) and B1 from a carried
state do not. Importing this module registers the ops, which a program
exported with them needs before ``torch.export.load`` (``utils/export_artifact``)."""
from __future__ import annotations

import torch

from . import decode_kernel, lstm_kernel, stft_kernel

_LIB = torch.library.Library("se_torch", "DEF")


def _define(schema: str, cpu, cuda, fake):
    """Defines ``se_torch::<schema>`` with its CPU, CUDA and fake kernels;
    returns its overload."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"se_torch::{name}", fake, lib=_LIB)
    return getattr(torch.ops.se_torch, name).default


def _hs_dtype(hs_bf16: bool) -> torch.dtype:
    return torch.bfloat16 if hs_bf16 else torch.float32


# B1, stateless: hs of the recurrence from zeros (the module docstring)
lstm_recurrence = _define(
    "lstm_recurrence(Tensor xw, Tensor w_hh_t, bool h_bf16, bool hs_bf16, "
    "bool gates_bf16=False, Tensor? xw_scale=None) -> Tensor",
    lambda xw, w_hh_t, h_bf16, hs_bf16, gates_bf16=False, xw_scale=None:
        lstm_kernel.lstm_bidir_tm_ref(xw, w_hh_t, h_bf16=h_bf16, hs_dtype=_hs_dtype(hs_bf16),
                                      gates_bf16=gates_bf16, xw_scale=xw_scale),
    lambda xw, w_hh_t, h_bf16, hs_bf16, gates_bf16=False, xw_scale=None:
        lstm_kernel._b1_cuda(xw, w_hh_t, h_bf16=h_bf16, hs_dtype=_hs_dtype(hs_bf16),
                             gates_bf16=gates_bf16, xw_scale=xw_scale),
    lambda xw, w_hh_t, h_bf16, hs_bf16, gates_bf16=False, xw_scale=None: xw.new_empty(
        xw.shape[:-1] + (w_hh_t.shape[-2],), dtype=_hs_dtype(hs_bf16)))

# B4 on rows (N, time)
stft = _define(
    "stft(Tensor wavs, int n_fft, int win_length, int hop) -> Tensor",
    stft_kernel.stft_fused_ref,
    stft_kernel._stft_cuda,
    lambda wavs, n_fft, win_length, hop: wavs.new_empty(
        (wavs.shape[0], 1 + wavs.shape[1] // hop, 2 * (n_fft // 2 + 1))))

# B5: the raw overlap-add of the rescaled spectrum
decode = _define(
    "decode(Tensor pred, Tensor uph, int n_fft, int win_length, int hop, float linear_power)"
    " -> Tensor",
    decode_kernel.decode_ola_ref,
    decode_kernel._decode_cuda,
    lambda pred, uph, n_fft, win_length, hop, linear_power: pred.new_empty(
        (pred.shape[0], (pred.shape[1] - 1 + -(-n_fft // hop)) * hop)))
