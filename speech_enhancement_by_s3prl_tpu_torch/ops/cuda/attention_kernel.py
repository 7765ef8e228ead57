"""Flash attention with in-kernel hash dropout: the hand-written CUDA kernels
(B3) and their plain PyTorch versions.

Kernels (sources under ``csrc/``), each replacing a Pallas kernel of
``speech_enhancement_by_s3prl_tpu/ops/pallas/attention_kernel.py``:

- B3 fwd ``flash_attention_fwd`` (``flash_attn.cu``): attention with an
  additive key bias and attention-probability dropout, plus the logsumexp
  (``_fwd_impl`` / ``_fwd_kernel``): an online softmax over key tiles whose
  probabilities go from the first product's accumulators straight into the
  second product, never through shared memory.
- B3 bwd ``flash_attention_bwd`` (``flash_attn_bwd.cu``): dq, dk, dv from the
  saved lse, the same dropout mask recomputed from the salt (``_bwd_impl`` /
  ``_bwd_kernel``). One call is three launches (a row-dot pre-pass, a dk/dv
  kernel over key tiles, a dq kernel over query tiles) and counts once.

The tile products of both run on the tensor cores with each f32 operand split
into two TF32 parts and three passes a product (``mma_tf32x3.cuh``): f32-level
accuracy, which one TF32 pass does not give. ``split_tf32`` and
``matmul_tf32x3`` model that arithmetic for the CPU tests.

Under ``compute_dtype`` bf16 (q, k, v bf16, as the encoder's bf16 QKV
projection gives them) the same two functions run as their bf16 kernels, B3
fwd bf16 ``flash_attention_fwd_bf16`` and B3 bwd bf16
``flash_attention_bwd_bf16`` (the same sources, the C entries
``flash_attn_fwd_bf16`` / ``flash_attn_bwd_bf16``), counted apart from the f32
ones; ``flash_attention_fwd`` / ``flash_attention_bwd`` hand bf16 tensors to
them. They round at the JAX kernel's points with bf16 inputs (``_fwd_kernel``
/ ``_bwd_kernel``): the softmax scale and scale * q (and, for dq, scale * k)
rounded to bf16, logits and every product summed in f32 from exact bf16
products, the softmax, hash and lse in f32, p rounded to bf16 into P V, the
cotangent do / keep, the dropped p and ds rounded to bf16 into their
products, and out, dq, dk, dv rounded to bf16 from f32 sums. kbias and lse
stay f32.

The bf16 kernels are built for Hopper (``csrc/hopper.cuh``): a CTA of
consumer warpgroups (64 rows each) and a producer warp that brings tiles in
by TMA through a ring of shared-memory stages on mbarriers, the products as
``wgmma`` with f32 accumulators in registers, the softmax, hash and ds on
those registers, and the rounded probabilities (or ds) packed in registers
as the A operand of the next product. B3 fwd bf16 walks keys 64 a tile for
128 queries a CTA; B3 bwd bf16 is a pre-pass (Di and the rounded qs, ks, do'
as contiguous scratch), a dk/dv kernel over 192 keys a CTA and a dq kernel
over 192 queries a CTA (128 at a head width of 128; 64 at 256, where a dk/dv
CTA computes half of dk's and dv's columns). What bounds them on the
card is the CUDA-core work of each logit (one exponential and the hash's ten
integer operations, twice in the backward), not the products: at B=6,
T=1001, 12 x 64 the products take 0.019 / 0.047 ms of tensor-core time. The
exponential is ``__expf`` (ex2.approx), within the card's limits. B3 fwd bf16
walks ``fwd_bf16_keys(D)`` keys a tile (32 at D = 256, where the output
accumulator takes 128 registers a thread). TMA reads q, k and v in place as
4-D tensors (D, N, T, B) and fills rows t >= T with zeros, which needs
16-byte aligned operands whose batch and time strides are multiples of 16
bytes: ``tma_ready`` decides that from an operand's address and strides, and
the wrapper hands the kernel a contiguous copy of an operand that fails it
(the same kernel either way). ``flash_fwd_bf16_model`` models the forward's
rounding schedule (the online softmax over 64-key tiles) for the CPU tests.

``FlashAttention`` ties them into a ``torch.autograd.Function``, the
counterpart of the JAX custom VJP ``_flash_vjp``: it saves q, k, v, out, lse
and the 8-byte salt, never a mask. ``flash_attention`` routes to it when a
gradient is needed and to B3 fwd alone otherwise.

The kernels are instantiated for head widths 32, 64, 128 and 256
(``HEAD_DIMS``), as the JAX kernel takes any D with P * D % 128 == 0. A
narrower head, or one between two of them, runs the next instance up: the
wrapper zero-pads each head of q, k and v to that width (``instance_width``,
``pad_heads``; 16 -> 32, 48 -> 64, 96 -> 128, 192 -> 256), keeps the caller's
``scale`` (1 / sqrt(D) of the true D), and cuts the padded columns off out and
off dq, dk and dv (``unpad_heads``). That is exact: the added products are
zeros, and the dropout hash depends on (batch, head, query, key), never on D.
A head wider than 256 raises. The D = 256 instances are tiled for their size:
the f32 backward walks 16 rows a stage (two resident 64 x 260 f32 tiles and two
stages of 32-row walked ones would be 266,752 bytes of shared memory, past the
232,448 a block may use), and both backwards compute dk and dv in two halves
of their columns, because 16 rows x 256 columns of each a warp (f32), or 64 x
256 a warpgroup (bf16), would take 256 accumulator registers a thread.

Layout is the JAX kernel's: q, k, v are (B, T, N * D), straight from the fused
QKV projection (views with a shared row stride are taken as they are), head n
in columns n * D .. n * D + D - 1; ``kbias`` is (B, T) f32; ``salt`` is two
uint32 as Python ints (a salt or a key, as the form takes it). The port's lse is (B, N, T) f32 (the JAX kernel's is
(B, N / P, P, nj * bq), its head-grouped and block-padded form).

Dropout draws its mask in one of three forms (``form``, ``MASK_FORMS``; the
kernels take it as a template parameter, ``csrc/flash_attn_common.cuh``),
each the mask one of the JAX package's attention paths draws, bit for bit
whatever the tiling:

- ``"hash"`` (``SE_ATTN_IMPL=flash``): element (b, n, t_q, t_k) is kept where
  the salted hash of (absolute head index bn = (batch0 + b) * N_total + head0
  + n, t_q, t_k) lies below ``keep_threshold(rate)``: the JAX kernel's
  ``_dropout_mask``, ``salt`` its two words;
- ``"flax"`` (the explicit path's flax ``nn.Dropout``, JAX's default): the
  threefry draw ``jax.random.bernoulli(key, 1 - rate)`` over the global (B,
  N_total, Tq, T) probabilities, ``salt`` the key: element (bn, q, t_k) keyed
  on its flat index (bn Tq + q) T + t_k in 64 bits (``csrc/threefry.cuh``,
  ``utils/prng.py``);
- ``"hidden_hash"`` (the explicit path under ``SE_DROPOUT_IMPL=hash``): the
  hidden-state hash ``_hash_mask_apply`` of the same tensor (``hidden_hash_keep``:
  flat index within x[0], (head0 + n) Tq + q) T + t_k, and batch row batch0 +
  b), ``salt`` its salt.

``chunk`` > 0 is the chunked path (``SE_ATTN_DROPOUT_CHUNK``): queries in
chunks of ``chunk`` (Tq = chunk, q the query within its chunk on the padded
query axis), chunk i keyed on ``fold_in(salt, i)`` (the flax form) or salted
by ``bits(fold_in(salt, i), (2,))`` (the hidden hash), the chunk's words
derived in the kernel. ``batch0`` shifts the batch index so that a
data-parallel shard keeps the unsharded mask stream; ``head0`` and
``n_heads_total`` (N_total, by default the launch's own N) place the launch's N
heads at heads head0 .. head0 + N - 1 of N_total, so that a tensor-parallel
rank's heads draw the masks of those heads of the unsharded launch. ``head0``
counts true heads: the zero-padding of ``instance_width`` widens a head, it
adds none. Every form counts the same products (``utils/costs``); the flax
form costs a 20-round threefry block a logit on the CUDA cores, twice in the
backward.

A CPU tensor takes the plain versions. A CUDA tensor launches the kernel or
raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import Optional, Tuple

import torch

from ...utils import costs, prng
from ._build import launch_args, load, raise_on

PHI1 = 2654435761
PHI2 = 2246822519
PHI3 = 3266489917
PHI4 = 40503
_MASK32 = 0xFFFFFFFF
# head widths the CUDA kernels are instantiated for; a narrower head runs the
# next one up on zero-padded heads (``instance_width``)
HEAD_DIMS = (32, 64, 128, 256)
# keys a tile of B3 fwd bf16's online softmax (csrc/flash_attn.cu, FwdCfg)
FWD_BF16_KEYS = 64


def fwd_bf16_keys(d: int) -> int:
    """Keys a tile of B3 fwd bf16's online softmax at instance width ``d``:
    32 at 256, ``FWD_BF16_KEYS`` below (``csrc/flash_attn.cu``, ``FwdCfg``)."""
    return 32 if d == 256 else FWD_BF16_KEYS

Salt = Tuple[int, int]
# B3's mask forms (the module docstring), by their code in the C entries
MASK_FORMS = ("hash", "flax", "hidden_hash")
# elements of (B, N, T, T) a block of the plain versions' threefry masks takes
_MASK_BLOCK = 1 << 24


def keep_threshold(rate: float) -> int:
    """The uint32 threshold below which a hash keeps its element, computed
    in Python float64 as the JAX package does."""
    return min(int((1.0 - rate) * 4294967296.0), 4294967295)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for an int64 tensor of uint32 values and a 32-bit
    constant. The plain product can pass 2^63 and wrap int64, so the
    multiply goes in 16-bit halves: (lo * c) + ((hi * c) mod 2^16) * 2^16."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def dropout_keep_mask(bn, qi, ki, salt: Salt, rate: float) -> torch.Tensor:
    """The keep mask of attention-probability dropout at absolute head index
    ``bn``, query ``qi`` and key ``ki`` (int64 tensors that broadcast
    against each other, values below 2^32): bit for bit ``_dropout_mask``
    of the JAX kernel. Returns a bool tensor of the broadcast shape."""
    s0, s1 = (int(s) & _MASK32 for s in salt)
    h = mul32(qi & _MASK32, PHI1) ^ mul32(ki & _MASK32, PHI2) ^ mul32(bn & _MASK32, PHI4) ^ s0
    h = h ^ (h >> 16)
    h = mul32(h, PHI3)
    h = h ^ (h >> 13)
    h = h ^ s1
    h = mul32(h, PHI1)
    h = h ^ (h >> 16)
    return h < keep_threshold(rate)


def hidden_hash_keep(inner, lead, salt: Salt, rate: float) -> torch.Tensor:
    """The keep mask of the JAX package's hidden-state hash dropout
    (``models/transformer.py::_hash_mask_apply``) at flat index ``inner``
    within x[0] and leading index ``lead`` (int64 tensors that broadcast,
    uint32 values)."""
    s0, s1 = (int(s) & _MASK32 for s in salt)
    h = mul32(inner, PHI1) ^ mul32(lead, PHI4) ^ s0
    h = h ^ (h >> 16)
    h = mul32(h, PHI2)
    h = h ^ (h >> 13)
    h = h ^ s1
    h = mul32(h, PHI3)
    h = h ^ (h >> 16)
    return h < keep_threshold(rate)


def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, T, H = x.shape
    return x.reshape(B, T, n_heads, H // n_heads).transpose(1, 2)  # (B, N, T, D)


def _merge(x: torch.Tensor) -> torch.Tensor:
    B, N, T, D = x.shape
    return x.transpose(1, 2).reshape(B, T, N * D)


def instance_width(d: int) -> int:
    """The head width of the kernel instance a head of width ``d`` runs on a
    CUDA tensor: the narrowest of ``HEAD_DIMS`` at least ``d``. Raises above
    the widest (the module docstring says why)."""
    for width in HEAD_DIMS:
        if d <= width:
            return width
    raise ValueError(f"the CUDA flash kernels take head widths up to {HEAD_DIMS[-1]}, "
                     f"got {d}")


def pad_heads(x: torch.Tensor, n_heads: int, width: int) -> torch.Tensor:
    """(B, T, N * D) -> (B, T, N * width), contiguous: each head's D columns
    followed by ``width - D`` zeros."""
    B, T, H = x.shape
    heads = x.reshape(B, T, n_heads, H // n_heads)
    return torch.nn.functional.pad(heads, (0, width - H // n_heads)).reshape(
        B, T, n_heads * width)


def unpad_heads(x: torch.Tensor, n_heads: int, d: int) -> torch.Tensor:
    """(B, T, N * width) -> (B, T, N * d), contiguous: each head's first
    ``d`` columns (``pad_heads`` undone)."""
    B, T, _ = x.shape
    return x.reshape(B, T, n_heads, -1)[..., :d].reshape(B, T, n_heads * d)


def _padded_width(q, n_heads):
    """(D, the instance width) of a CUDA launch on q (B, T, N * D)."""
    D = q.shape[-1] // n_heads
    return D, instance_width(D)


def check_form(form: str, chunk: int) -> None:
    if form not in MASK_FORMS:
        raise ValueError(f"unknown mask form {form!r}; B3 draws {MASK_FORMS}")
    if chunk < 0 or (chunk and form == "hash"):
        raise ValueError(f"chunk {chunk} with the {form!r} mask (chunks: flax or hidden_hash)")


def _full_mask(B, N, T, salt, rate, batch0, device, head0: int = 0,
               n_total: Optional[int] = None, form: str = "hash",
               chunk: int = 0) -> torch.Tensor:
    """The (B, N, T, T) keep mask of a launch on rows batch0 .. of heads
    head0 .. head0 + N - 1 of ``n_total`` (None: N) in mask form ``form``
    (the module docstring), ``chunk`` queries a chunk (0: one draw)."""
    check_form(form, chunk)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    n_total = N if n_total is None else n_total
    b = (batch0 + ar(B))[:, None, None, None]
    n = (head0 + ar(N))[None, :, None, None]
    if form == "hash":
        return dropout_keep_mask(b * n_total + n, ar(T)[:, None], ar(T)[None, :], salt, rate)
    C = chunk or T
    ki = ar(T)[None, None, None, :]
    out = torch.empty((B, N, T, T), dtype=torch.bool, device=device)
    rows = max(1, _MASK_BLOCK // max(1, N * T * T))
    for c0 in range(0, T, C):
        ql = ar(min(C, T - c0))[None, None, :, None]
        words = prng.fold_in(salt, c0 // C) if chunk else salt
        if form == "hidden_hash" and chunk:
            words = prng.host_bits(words, 2)  # the chunk's salt
        for r0 in range(0, B, rows):
            br = b[r0:r0 + rows]
            if form == "flax":
                keep = prng.bernoulli_of(words, 1.0 - rate, ((br * n_total + n) * C + ql) * T + ki)
            else:
                keep = hidden_hash_keep(((n * C + ql) * T + ki) & _MASK32, br, words, rate)
            out[r0:r0 + rows, :, c0:c0 + C] = keep
    return out


def _bf16_scalar(x: float) -> float:
    """A Python float rounded to f32, then to bf16 (to nearest, ties to
    even), as ``jnp.asarray(x, jnp.bfloat16)`` rounds the JAX kernel's scale:
    on the bits, without a tensor (a launch's host time)."""
    bits = struct.unpack("<I", struct.pack("<f", x))[0]
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 and held as f32: an operand the JAX kernel takes in
    bf16, whose products are exact in f32."""
    return x.to(torch.bfloat16).float()


def _logits(q, k, scale, kbias, n_heads, matmul=torch.matmul):
    # the scale is folded into q, as the JAX kernel folds it into its block
    logits = matmul(_heads(q * scale, n_heads), _heads(k, n_heads).transpose(-1, -2))
    if kbias is not None:
        logits = logits + kbias[:, None, None, :]
    return logits


def flash_attention_ref(q, k, v, scale: float, rate: float, salt: Salt, kbias=None,
                        batch0: int = 0, *, n_heads: int,
                        head0: int = 0, n_heads_total: Optional[int] = None,
                        form: str = "hash", chunk: int = 0):
    """B3 fwd's plain version, step for step ``_fwd_kernel`` without the
    tiling: it materializes the (B, N, T, T) logits. Returns (out (B, T,
    N * D) in the input dtype, lse (B, N, T) f32). Under bf16 inputs it
    rounds where the JAX kernel rounds (the module docstring). ``head0`` and
    ``n_heads_total`` place its heads in a larger launch, ``form`` and
    ``chunk`` name its mask (the module docstring)."""
    key = (batch0, head0, n_heads_total, form, chunk)
    if q.dtype == torch.bfloat16:
        return _flash_ref_bf16(q, k, v, scale, rate, salt, kbias, key, n_heads)
    logits = _logits(q, k, scale, kbias, n_heads)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    s = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(s))[..., 0]
    if rate > 0.0:
        B, N, T, _ = p.shape
        p = torch.where(_mask(B, N, T, salt, rate, key, q.device), p, 0.0)
    ctx = torch.matmul(p, _heads(v, n_heads)) * (1.0 / (s * (1.0 - rate)))
    return _merge(ctx), lse


def _mask(B, N, T, salt, rate, key, device):
    """``_full_mask`` at ``key`` = (batch0, head0, n_heads_total, form,
    chunk)."""
    batch0, head0, n_total, form, chunk = key
    named = {} if (form, chunk) == ("hash", 0) else {"form": form, "chunk": chunk}
    return _full_mask(B, N, T, salt, rate, batch0, device, head0, n_total, **named)


def _flash_ref_bf16(q, k, v, scale, rate, salt, kbias, key, n_heads):
    qs = _bf16(q.float() * _bf16_scalar(scale))
    logits = torch.matmul(_heads(qs, n_heads), _heads(k.float(), n_heads).transpose(-1, -2))
    if kbias is not None:
        logits = logits + kbias[:, None, None, :]
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    s = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(s))[..., 0]
    if rate > 0.0:
        B, N, T, _ = p.shape
        p = torch.where(_mask(B, N, T, salt, rate, key, q.device), p, 0.0)
    ctx = torch.matmul(_bf16(p), _heads(v.float(), n_heads)) * (1.0 / (s * (1.0 - rate)))
    return _merge(ctx).to(torch.bfloat16), lse


def flash_fwd_bf16_model(q, k, v, scale: float, rate: float, salt: Salt, kbias=None,
                         batch0: int = 0, *, n_heads: int,
                         head0: int = 0, n_heads_total: Optional[int] = None,
                         keys: int = FWD_BF16_KEYS, form: str = "hash", chunk: int = 0):
    """B3 fwd bf16's rounding schedule in plain PyTorch: ``_flash_ref_bf16``'s
    roundings with the kernel's online softmax over tiles of ``keys`` keys.
    Per tile the running row maximum m takes the tile's logits, the row sum
    l = l * exp(m_old - m) + sum exp(s - m) takes the undropped p, and the
    dropped p = exp(s - m) is rounded to bf16 against that running maximum
    into acc = acc * exp(m_old - m) + bf16(p) v; out = bf16(acc * (1 / (l *
    (1 - rate)))), lse = m + log l. Returns what ``flash_attention_ref``
    returns."""
    N, keep = n_heads, 1.0 - rate
    B, T, _ = q.shape
    qs = _heads(_bf16(q.float() * _bf16_scalar(scale)), N)
    kh, vh = _heads(k.float(), N), _heads(v.float(), N)
    mask = (_full_mask(B, N, T, salt, rate, batch0, q.device, head0, n_heads_total, form,
                       chunk) if rate > 0.0 else None)
    m = torch.full((B, N, T, 1), -math.inf, device=q.device)
    l = torch.zeros((B, N, T, 1), device=q.device)
    acc = torch.zeros(qs.shape, device=q.device)
    for k0 in range(0, T, keys):
        s = torch.matmul(qs, kh[:, :, k0:k0 + keys].transpose(-1, -2))
        if kbias is not None:
            s = s + kbias[:, None, None, k0:k0 + keys]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # all keys so far at -inf (a -inf key bias): keep exp() finite
        shift = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        alpha = torch.exp(m - shift)
        p = torch.exp(s - shift)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if mask is not None:
            p = torch.where(mask[..., k0:k0 + keys], p, 0.0)
        acc = acc * alpha + torch.matmul(_bf16(p), vh[:, :, k0:k0 + keys])
        m = m_new
    out = acc * (1.0 / (l * keep))
    return _merge(out).to(torch.bfloat16), (m + torch.log(l))[..., 0]


def split_tf32(x: torch.Tensor):
    """An f32 tensor as (hi, lo), both representable in TF32 (10 mantissa
    bits), as the tensor cores see the kernels' split operands: hi = x
    rounded to nearest at mantissa bit 13 (ties away from zero, as
    ``cvt.rna.tf32.f32``: half a unit added to the bits, the low 13 bits
    dropped), lo = x - hi (exact in f32) with its low 13 bits dropped. For
    finite inputs."""
    def cut(bits):
        return (bits & ~0x1FFF).view(torch.float32)

    hi = cut(x.contiguous().view(torch.int32) + 0x1000)
    return hi, cut((x - hi).view(torch.int32))


def matmul_tf32x3(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``a @ b`` as the tensor-core kernels compute it: operands split by
    ``split_tf32``, the products a_lo b_hi + a_hi b_lo + a_hi b_hi summed in
    f32 (``passes=3``), or a_hi b_hi alone (``passes=1``, plain TF32, which
    the kernels do not use: it loses three of f32's seven digits)."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    if passes == 1:
        return torch.matmul(a_hi, b_hi)
    return torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo) + torch.matmul(a_hi, b_hi)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, scale: float, rate: float, salt: Salt,
                            kbias=None, batch0: int = 0, *, n_heads: int, head0: int = 0,
                            n_heads_total: Optional[int] = None, matmul=torch.matmul,
                            form: str = "hash", chunk: int = 0):
    """B3 bwd's plain version, step for step ``_bwd_kernel``: p from the
    saved lse, the same mask, do / keep. Returns (dq, dk, dv), each
    (B, T, N * D) in the input dtype. ``matmul`` computes the f32 version's
    five products (the tests pass ``matmul_tf32x3`` to model the kernel's
    arithmetic). Under bf16 inputs it rounds where the JAX kernel rounds."""
    key = (batch0, head0, n_heads_total, form, chunk)
    if q.dtype == torch.bfloat16:
        return _flash_bwd_ref_bf16(q, k, v, out, lse, dout, scale, rate, salt, kbias, key,
                                   n_heads)
    keep = 1.0 - rate
    qs = _heads(q * scale, n_heads)
    kh, vh = _heads(k, n_heads), _heads(v, n_heads)
    do = _heads(dout / keep, n_heads)
    p = torch.exp(_logits(q, k, scale, kbias, n_heads, matmul) - lse[..., None])
    dp = matmul(do, vh.transpose(-1, -2))
    pd = p
    if rate > 0.0:
        B, N, T, _ = p.shape
        mask = _mask(B, N, T, salt, rate, key, q.device)
        pd = torch.where(mask, p, 0.0)
        dp = torch.where(mask, dp, 0.0)
    drow = keep * (do * _heads(out, n_heads)).sum(dim=-1, keepdim=True)
    ds = p * (dp - drow)
    dq = matmul(ds, kh * scale)
    dk = matmul(ds.transpose(-1, -2), qs)
    dv = matmul(pd.transpose(-1, -2), do)
    return _merge(dq), _merge(dk), _merge(dv)


def _flash_bwd_ref_bf16(q, k, v, out, lse, dout, scale, rate, salt, kbias, key, n_heads):
    keep, sc = 1.0 - rate, _bf16_scalar(scale)
    qs = _heads(_bf16(q.float() * sc), n_heads)
    ks = _heads(_bf16(k.float() * sc), n_heads)
    kh, vh = _heads(k.float(), n_heads), _heads(v.float(), n_heads)
    do = _heads(dout.float() / keep, n_heads)
    do_b = _bf16(do)
    logits = torch.matmul(qs, kh.transpose(-1, -2))
    if kbias is not None:
        logits = logits + kbias[:, None, None, :]
    p = torch.exp(logits - lse[..., None])
    dp = torch.matmul(do_b, vh.transpose(-1, -2))
    pd = p
    if rate > 0.0:
        B, N, T, _ = p.shape
        mask = _mask(B, N, T, salt, rate, key, q.device)
        pd = torch.where(mask, p, 0.0)
        dp = torch.where(mask, dp, 0.0)
    drow = keep * (do * _heads(out.float(), n_heads)).sum(dim=-1, keepdim=True)
    ds = _bf16(p * (dp - drow))
    dq = torch.matmul(ds, ks)
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    dv = torch.matmul(_bf16(pd).transpose(-1, -2), do_b)
    return tuple(_merge(x).to(torch.bfloat16) for x in (dq, dk, dv))


def _check(q, k, v, kbias, n_heads):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must be (B, T, N * D) of one shape, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, T, H = q.shape
    if n_heads <= 0 or H % n_heads:
        raise ValueError(f"width {H} does not split into {n_heads} heads")
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"flash attention takes f32 or bf16 q, k, v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if kbias is not None and (tuple(kbias.shape) != (B, T) or kbias.dtype != torch.float32):
        raise ValueError(f"kbias must be f32 (B, T) = ({B}, {T}), got "
                         f"{kbias.dtype} {tuple(kbias.shape)}")
    devices = {t.device for t in (q, k, v) + (() if kbias is None else (kbias,))}
    if len(devices) != 1:
        raise ValueError(f"flash attention inputs on several devices: {devices}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")


def _kernel_layout(q, k, v, kbias, n_heads):
    """(B, T, N, D, batch stride, time stride, kbias) for a launch; raises on
    what the kernels do not take."""
    B, T, H = q.shape
    D = H // n_heads
    if D not in HEAD_DIMS:
        raise ValueError(f"the CUDA flash kernels are instantiated for head widths "
                         f"{HEAD_DIMS}, got {D}")
    strides = {t.stride() for t in (q, k, v)}
    if len(strides) != 1 or q.stride(2) != 1:
        raise ValueError(
            f"q, k, v must share their strides with unit stride in a row, got "
            f"{[t.stride() for t in (q, k, v)]}"
        )
    if kbias is None:
        kbias = torch.zeros((B, T), device=q.device, dtype=torch.float32)
    return B, T, n_heads, D, q.stride(0), q.stride(1), kbias.contiguous()


def tma_ready(address: int, stride: Tuple[int, ...], itemsize: int) -> bool:
    """Whether TMA can read a (B, T, N * D) operand in place, as the bf16
    kernels' tensor maps describe it: its first element 16-byte aligned
    (``address``, from ``data_ptr()``), unit stride in a row, and batch and
    time strides (in elements of ``itemsize`` bytes) multiples of 16 bytes."""
    sb, st, sh = stride
    return (address % 16 == 0 and sh == 1 and (sb * itemsize) % 16 == 0
            and (st * itemsize) % 16 == 0)


def _bf16_layout(q, k, v, kbias, n_heads):
    """(B, T, N, D, (q, k, v), their (batch, time) strides flattened, the
    contiguous key bias or None) for a bf16 launch: an operand that
    ``tma_ready`` refuses becomes a contiguous copy, so the kernel takes
    every operand by TMA; no bias goes to the kernel as a null pointer."""
    B, T, H = q.shape
    D = H // n_heads
    if D not in HEAD_DIMS:
        raise ValueError(f"the CUDA flash kernels are instantiated for head widths "
                         f"{HEAD_DIMS}, got {D}")
    ops = tuple(x if tma_ready(x.data_ptr(), x.stride(), x.element_size())
                else x.clone(memory_format=torch.contiguous_format) for x in (q, k, v))
    strides = [s for x in ops for s in x.stride()[:2]]
    kb = None if kbias is None else kbias.contiguous()
    return B, T, n_heads, D, ops, strides, kb


@functools.cache
def _fwd_library():
    lib = load("flash_attn")
    p, i, ll, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                      ctypes.c_uint)
    lib.flash_attn_fwd_f32.argtypes = ([p] * 6 + [i] * 4 + [ll] * 2 + [f, f, u, u, u]
                                       + [i] * 7 + [p])
    lib.flash_attn_fwd_f32.restype = i
    lib.flash_attn_fwd_bf16.argtypes = ([p] * 6 + [i] * 4 + [ll] * 6 + [f, f, u, u, u]
                                       + [i] * 7 + [p])
    lib.flash_attn_fwd_bf16.restype = i
    lib.flash_attn_error_string.argtypes = [i]
    lib.flash_attn_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_library():
    lib = load("flash_attn_bwd")
    p, i, ll, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                      ctypes.c_uint)
    lib.flash_attn_bwd_f32.argtypes = ([p] * 11 + [i] * 4 + [ll] * 2 + [f, f, u, u, u]
                                       + [i] * 7 + [p])
    lib.flash_attn_bwd_f32.restype = i
    lib.flash_attn_bwd_bf16.argtypes = ([p] * 14 + [i] * 4 + [ll] * 6 + [f, f, u, u, u]
                                       + [i] * 7 + [p])
    lib.flash_attn_bwd_bf16.restype = i
    lib.flash_attn_bwd_error_string.argtypes = [i]
    lib.flash_attn_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _key_args(batch0, head0, n_heads_total, n_heads):
    """(batch0, head0, N_total) of a launch on ``n_heads`` heads: the C
    entries' HeadKey."""
    n_total = n_heads if n_heads_total is None else int(n_heads_total)
    if not 0 <= head0 <= n_total - n_heads:
        raise ValueError(f"heads {head0} .. {head0 + n_heads - 1} do not lie in {n_total}")
    return int(batch0), int(head0), n_total


def _mask_args(rate, salt, form, chunk):
    """(threshold, the two words, dropout, form code, chunk) of a launch: the
    hash forms test 32 bits against ``keep_threshold``, the flax form the top
    23 against ``prng.keep_threshold23``."""
    check_form(form, chunk)
    s0, s1 = (int(s) & _MASK32 for s in salt)
    thresh = prng.keep_threshold23(1.0 - rate) if form == "flax" else keep_threshold(rate)
    return thresh, s0, s1, int(rate > 0.0), MASK_FORMS.index(form), int(chunk)


def _b3_label(direction):
    return lambda q, *args, **kwargs: f"B3 {direction}" + (
        " bf16" if q.dtype == torch.bfloat16 else "")


def _b3_cost(backward):
    return lambda q, *args, n_heads, **kwargs: costs.attention_call_cost(q, n_heads, backward)


@costs.counted(_b3_label("fwd"), _b3_cost(False))
def flash_attention_fwd(q, k, v, scale: float, rate: float, salt: Salt, kbias=None,
                        batch0: int = 0, *, n_heads: int,
                        head0: int = 0, n_heads_total: Optional[int] = None,
                        form: str = "hash", chunk: int = 0):
    """B3 fwd: (out (B, T, N * D) in the input dtype, lse (B, N, T) f32).
    Kernel on a CUDA tensor (counted in ``flash_attention_fwd.launches``;
    tensor-core products in three TF32 passes), plain version on a CPU
    tensor. bf16 inputs go to ``flash_attention_fwd_bf16``. ``head0`` and
    ``n_heads_total`` key the mask, ``form`` and ``chunk`` name it (the module
    docstring)."""
    _check(q, k, v, kbias, n_heads)
    if q.dtype == torch.bfloat16:
        return flash_attention_fwd_bf16(q, k, v, scale, rate, salt, kbias, batch0,
                                        n_heads=n_heads, head0=head0, n_heads_total=n_heads_total,
                                        form=form, chunk=chunk)
    return _fwd(q, k, v, scale, rate, salt, kbias, (batch0, head0, n_heads_total, form, chunk),
                n_heads)


@costs.counted(_b3_label("fwd"), _b3_cost(False))
def flash_attention_fwd_bf16(q, k, v, scale: float, rate: float, salt: Salt, kbias=None,
                             batch0: int = 0, *, n_heads: int,
                             head0: int = 0, n_heads_total: Optional[int] = None,
                             form: str = "hash", chunk: int = 0):
    """B3 fwd bf16: bf16 q, k, v -> (out (B, T, N * D) bf16, lse (B, N, T)
    f32), rounded where the JAX kernel rounds with bf16 inputs. Kernel on a
    CUDA tensor (counted in ``flash_attention_fwd_bf16.launches``; TMA and
    ``wgmma``, the module docstring), plain version on a CPU tensor."""
    _check(q, k, v, kbias, n_heads)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_fwd_bf16 takes bf16 q, k, v, got {q.dtype}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale, rate, salt, kbias, batch0, n_heads=n_heads,
                                   head0=head0, n_heads_total=n_heads_total, form=form,
                                   chunk=chunk)
    D, width = _padded_width(q, n_heads)
    if width != D:
        out, lse = flash_attention_fwd_bf16(*(pad_heads(x, n_heads, width) for x in (q, k, v)),
                                            scale, rate, salt, kbias, batch0, n_heads=n_heads,
                                            head0=head0, n_heads_total=n_heads_total, form=form,
                                            chunk=chunk)
        return unpad_heads(out, n_heads, D), lse
    B, T, N, D, (q, k, v), strides, kb = _bf16_layout(q, k, v, kbias, n_heads)
    out = torch.empty((B, T, N * D), device=q.device, dtype=q.dtype)
    lse = torch.empty((B, N, T), device=q.device, dtype=torch.float32)
    if B == 0 or T == 0:
        return out, lse
    thresh, s0, s1, *mask = _mask_args(rate, salt, form, chunk)
    lib = _fwd_library()
    err = lib.flash_attn_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if kb is None else kb.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, T, N, D, *strides, _bf16_scalar(scale), 1.0 - rate,
        thresh, s0, s1, *_key_args(batch0, head0, n_heads_total, N), *mask, *launch_args(q))
    raise_on(err, "flash_attention_fwd_bf16", lib.flash_attn_error_string, B=B, T=T, N=N,
             D=D)
    flash_attention_fwd_bf16.launches += 1
    return out, lse


def _fwd(q, k, v, scale, rate, salt, kbias, key, n_heads):
    batch0, head0, n_heads_total, form, chunk = key
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale, rate, salt, kbias, batch0, n_heads=n_heads,
                                   head0=head0, n_heads_total=n_heads_total, form=form,
                                   chunk=chunk)
    D, width = _padded_width(q, n_heads)
    if width != D:
        out, lse = _fwd(*(pad_heads(x, n_heads, width) for x in (q, k, v)), scale, rate, salt,
                        kbias, key, n_heads)
        return unpad_heads(out, n_heads, D), lse
    B, T, N, D, sb, st, kb = _kernel_layout(q, k, v, kbias, n_heads)
    out = torch.empty((B, T, N * D), device=q.device, dtype=q.dtype)
    lse = torch.empty((B, N, T), device=q.device, dtype=torch.float32)
    if B == 0 or T == 0:
        return out, lse
    thresh, s0, s1, *mask = _mask_args(rate, salt, form, chunk)
    lib = _fwd_library()
    err = lib.flash_attn_fwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kb.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, T, N, D, sb, st, float(scale), 1.0 - rate, thresh, s0, s1,
        *_key_args(batch0, head0, n_heads_total, N), *mask, *launch_args(q))
    raise_on(err, "flash_attention_fwd", lib.flash_attn_error_string, B=B, T=T, N=N, D=D)
    flash_attention_fwd.launches += 1
    return out, lse


def _check_bwd(q, k, v, out, lse, dout, kbias, n_heads):
    _check(q, k, v, kbias, n_heads)
    B, T, H = q.shape
    for name, t, want, dtype in (("out", out, (B, T, H), q.dtype),
                                 ("dout", dout, (B, T, H), q.dtype),
                                 ("lse", lse, (B, n_heads, T), torch.float32)):
        if tuple(t.shape) != want or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"{name} must be {dtype} {want} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


@costs.counted(_b3_label("bwd"), _b3_cost(True))
def flash_attention_bwd(q, k, v, out, lse, dout, scale: float, rate: float, salt: Salt,
                        kbias=None, batch0: int = 0, *, n_heads: int,
                        head0: int = 0, n_heads_total: Optional[int] = None,
                        form: str = "hash", chunk: int = 0):
    """B3 bwd: the forward's inputs, out, lse and the cotangent ``dout`` ->
    (dq, dk, dv), each (B, T, N * D) in the input dtype. Kernel on a CUDA
    tensor (one count in ``flash_attention_bwd.launches`` for its three
    launches; tensor-core products in three TF32 passes, deterministic: the
    same inputs give the same bits), plain version on a CPU tensor. bf16
    inputs go to ``flash_attention_bwd_bf16``."""
    _check_bwd(q, k, v, out, lse, dout, kbias, n_heads)
    heads = dict(n_heads=n_heads, head0=head0, n_heads_total=n_heads_total, form=form,
                 chunk=chunk)
    if q.dtype == torch.bfloat16:
        return flash_attention_bwd_bf16(q, k, v, out, lse, dout, scale, rate, salt, kbias,
                                        batch0, **heads)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, scale, rate, salt, kbias,
                                       batch0, **heads)
    D, width = _padded_width(q, n_heads)
    if width != D:
        return tuple(unpad_heads(g, n_heads, D) for g in flash_attention_bwd(
            *(pad_heads(x, n_heads, width) for x in (q, k, v, out)), lse,
            pad_heads(dout, n_heads, width), scale, rate, salt, kbias, batch0, **heads))
    B, T, N, D, sb, st, kb = _kernel_layout(q, k, v, kbias, n_heads)
    if not (out.is_contiguous() and dout.is_contiguous() and lse.is_contiguous()):
        raise ValueError("flash_attention_bwd needs contiguous out, dout and lse")
    dq, dk, dv = (torch.empty((B, T, N * D), device=q.device, dtype=torch.float32)
                  for _ in range(3))
    if B == 0 or T == 0:
        return dq, dk, dv
    di = torch.empty((B, N, T), device=q.device, dtype=torch.float32)
    thresh, s0, s1, *mask = _mask_args(rate, salt, form, chunk)
    lib = _bwd_library()
    err = lib.flash_attn_bwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kb.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, T, N, D, sb, st, float(scale), 1.0 / (1.0 - rate), thresh, s0, s1,
        *_key_args(batch0, head0, n_heads_total, N), *mask, *launch_args(q))
    raise_on(err, "flash_attention_bwd", lib.flash_attn_bwd_error_string, B=B, T=T, N=N, D=D)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


@costs.counted(_b3_label("bwd"), _b3_cost(True))
def flash_attention_bwd_bf16(q, k, v, out, lse, dout, scale: float, rate: float, salt: Salt,
                             kbias=None, batch0: int = 0, *, n_heads: int,
                             head0: int = 0, n_heads_total: Optional[int] = None,
                             form: str = "hash", chunk: int = 0):
    """B3 bwd bf16: bf16 q, k, v, out and ``dout``, f32 lse -> (dq, dk, dv),
    each (B, T, N * D) bf16, rounded where the JAX kernel rounds with bf16
    inputs. Kernel on a CUDA tensor (one count in
    ``flash_attention_bwd_bf16.launches`` for its three launches: a pre-pass
    writing Di and the rounded do / keep, scale * q, scale * k, then the dk/dv
    and dq kernels on TMA and ``wgmma``; deterministic), plain version on a
    CPU tensor."""
    _check_bwd(q, k, v, out, lse, dout, kbias, n_heads)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_bwd_bf16 takes bf16 q, k, v, got {q.dtype}")
    heads = dict(n_heads=n_heads, head0=head0, n_heads_total=n_heads_total, form=form,
                 chunk=chunk)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, scale, rate, salt, kbias,
                                       batch0, **heads)
    D, width = _padded_width(q, n_heads)
    if width != D:
        return tuple(unpad_heads(g, n_heads, D) for g in flash_attention_bwd_bf16(
            *(pad_heads(x, n_heads, width) for x in (q, k, v, out)), lse,
            pad_heads(dout, n_heads, width), scale, rate, salt, kbias, batch0, **heads))
    B, T, N, D, (q, k, v), strides, kb = _bf16_layout(q, k, v, kbias, n_heads)
    if not (out.is_contiguous() and dout.is_contiguous() and lse.is_contiguous()):
        raise ValueError("flash_attention_bwd_bf16 needs contiguous out, dout and lse")
    # dq, dk, dv, then the pre-pass's scratch: scale * q, scale * k, do / keep
    dq, dk, dv, qs, ks, dos = (torch.empty((B, T, N * D), device=q.device,
                                           dtype=torch.bfloat16) for _ in range(6))
    if B == 0 or T == 0:
        return dq, dk, dv
    di = torch.empty((B, N, T), device=q.device, dtype=torch.float32)
    thresh, s0, s1, *mask = _mask_args(rate, salt, form, chunk)
    lib = _bwd_library()
    err = lib.flash_attn_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if kb is None else kb.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), di.data_ptr(), qs.data_ptr(),
        ks.data_ptr(), dos.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, N, D,
        *strides, _bf16_scalar(scale), 1.0 - rate, thresh, s0, s1,
        *_key_args(batch0, head0, n_heads_total, N), *mask, *launch_args(q))
    raise_on(err, "flash_attention_bwd_bf16", lib.flash_attn_bwd_error_string, B=B, T=T, N=N,
             D=D)
    flash_attention_bwd_bf16.launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the JAX custom VJP ``_flash_vjp``):
    forward B3 fwd, saving q, k, v, out, lse (and kbias) with the salt kept
    by value; backward B3 bwd on the contiguous cotangent. out, dq, dk and dv
    come in the input dtype (f32, or bf16 through B3 fwd / bwd bf16).
    Kernels on CUDA tensors, plain versions on CPU tensors. Reach it through
    ``flash_attention``."""

    @staticmethod
    def forward(ctx, q, k, v, kbias, scale, rate, salt, batch0, n_heads, head0=0,
                n_heads_total=None, form="hash", chunk=0):
        heads = dict(n_heads=n_heads, head0=head0, n_heads_total=n_heads_total, form=form,
                     chunk=chunk)
        out, lse = flash_attention_fwd(q, k, v, scale, rate, salt, kbias, batch0, **heads)
        ctx.save_for_backward(q, k, v, out, lse, kbias)
        ctx.args = (scale, rate, tuple(int(s) for s in salt), batch0, heads)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, kbias = ctx.saved_tensors
        scale, rate, salt, batch0, heads = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(), scale, rate,
                                         salt, kbias, batch0, **heads)
        return dq, dk, dv, None, None, None, None, None, None, None, None, None, None


def flash_attention(q, k, v, scale: float, rate: float = 0.0, salt: Salt = (0, 0),
                    kbias: Optional[torch.Tensor] = None, batch0: int = 0, *, n_heads: int,
                    head0: int = 0, n_heads_total: Optional[int] = None,
                    form: str = "hash", chunk: int = 0):
    """Attention over (B, T, N * D) q, k, v -> (B, T, N * D), with dropout
    of the attention probabilities at ``rate`` from ``salt`` (a salt or a
    key, as ``form`` takes it), the masks keyed on rows ``batch0`` .. and
    heads ``head0`` .. of ``n_heads_total``. When a gradient is needed this
    is ``FlashAttention`` (B3 fwd now, B3 bwd in the backward pass);
    otherwise B3 fwd alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, kbias, scale, rate, salt, batch0, n_heads, head0,
                                    n_heads_total, form, chunk)
    return flash_attention_fwd(q, k, v, scale, rate, salt, kbias, batch0, n_heads=n_heads,
                               head0=head0, n_heads_total=n_heads_total, form=form,
                               chunk=chunk)[0]


# kernel launches since the last reset (chip_smoke.py reads them to show that
# the main path went through the kernels)
flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0
flash_attention_fwd_bf16.launches = 0
flash_attention_bwd_bf16.launches = 0
