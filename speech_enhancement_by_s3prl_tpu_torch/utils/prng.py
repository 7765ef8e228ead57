"""JAX's threefry PRNG (``jax.random`` with its default ``threefry2x32``
implementation and ``jax_threefry_partitionable`` on, as jax 0.9 sets it),
computed without JAX.

A key is two uint32, held on the host as a tuple of Python ints:

- ``PRNGKey(seed)``: ``threefry_seed`` of the seed as JAX canonicalizes a
  Python int without x64 (an int32, so the high word is 0 and the low word is
  the seed modulo 2^32);
- ``split(key, n)[i]`` and ``fold_in(key, i)``: both ``threefry2x32(key, (0,
  i))``, the partitionable split (``_threefry_split_foldlike``) and
  ``_threefry_fold_in`` of a uint32;
- ``bits(key, shape)``: ``threefry2x32(key, (hi, lo))`` of every element's flat
  index split into its high and low words (``iota_2x32_shape``), the two
  output words XORed (``_threefry_random_bits_partitionable``);
- ``uniform``, ``bernoulli`` and ``randint``: ``jax.random``'s functions of
  those bits (``_uniform``: the top 23 bits as a mantissa in [1, 2), less 1;
  ``_bernoulli``: uniform < p in float32, which is the integer test
  ``bits >> 9 < keep_threshold23(p)``; ``_randint``: two draws from the split
  key combined by a multiply-mod).

The tensor functions take ``offset``: the flat index of their first element
in a larger array, so a caller draws a slice of a larger draw (a
data-parallel rank's rows) without the whole shape; the index runs in 64 bits.
They compute in int64 tensors holding uint32 values, on the device of
``device`` (the plain versions of kernels D1 and B3's threefry form); the
same arithmetic runs on Python ints for host keys.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
# the threefry2x32 rotations (Salmon et al., 2011), as jax/_src/prng.py
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(key: Key, x0, x1):
    """The 20-round threefry2x32 block of counters (x0, x1) under ``key``:
    Python ints or int64 tensors of uint32 values (broadcasting), returned
    alike."""
    k0, k1 = int(key[0]) & MASK32, int(key[1]) & MASK32
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def PRNGKey(seed: int) -> Key:  # noqa: N802 (JAX's name)
    """``jax.random.PRNGKey(seed)`` for a Python int seed."""
    return (0, int(seed) & MASK32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for data in [0, 2^32)."""
    return threefry2x32(key, 0, int(data) & MASK32)


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, num)`` as a tuple of keys."""
    return tuple(threefry2x32(key, 0, i) for i in range(int(num)))


def host_bits(key: Key, n: int) -> Tuple[int, ...]:
    """``jax.random.bits(key, (n,))`` as Python ints (a salt is ``n`` = 2)."""
    return tuple(a ^ b for a, b in (threefry2x32(key, 0, i) for i in range(n)))


def _counters(shape: Sequence[int], offset: int, device) -> torch.Tensor:
    n = math.prod(int(s) for s in shape)
    return (torch.arange(n, dtype=torch.int64, device=device) + int(offset)).reshape(
        tuple(int(s) for s in shape))


def bits_of(key: Key, index: torch.Tensor) -> torch.Tensor:
    """The 32 random bits of flat indices ``index`` (an int64 tensor, values
    below 2^63): ``jax.random.bits`` of a draw containing them."""
    a, b = threefry2x32(key, index >> 32, index & MASK32)
    return a ^ b


def bits(key: Key, shape: Sequence[int], offset: int = 0, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 values in an int64 tensor), or
    the elements ``offset`` .. of a larger draw."""
    return bits_of(key, _counters(shape, offset, device))


def keep_threshold23(p: float) -> int:
    """The integer t with ``uniform < float32(p)`` exactly when ``bits >> 9 <
    t``: uniform is (bits >> 9) * 2^-23 exactly, so t = ceil(float32(p) *
    2^23), clipped to [0, 2^23]."""
    p32 = float(np.float32(p))
    return int(min(max(math.ceil(p32 * 2.0 ** 23), 0), 2 ** 23))


def uniform(key: Key, shape: Sequence[int], offset: int = 0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32."""
    m = (bits(key, shape, offset, device) >> 9) | 0x3F800000
    return m.to(torch.int32).view(torch.float32) - 1.0


def bernoulli_of(key: Key, p: float, index: torch.Tensor) -> torch.Tensor:
    """``jax.random.bernoulli(key, p)`` (float32 p) at flat indices ``index``."""
    return (bits_of(key, index) >> 9) < keep_threshold23(p)


def bernoulli(key: Key, p: float, shape: Sequence[int], offset: int = 0,
              device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a float32 p (flax
    ``nn.Dropout``'s keep mask at ``p`` = 1 - rate)."""
    return bernoulli_of(key, p, _counters(shape, offset, device))


def randint(key: Key, shape: Sequence[int], minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32, scalar
    bounds within int32) as int64: the span's remainder of two 32-bit draws
    from the split key, combined modulo 2^32 as ``_randint`` does in uint32."""
    k1, k2 = split(key)
    hi, lo = bits(k1, shape, device=device), bits(k2, shape, device=device)
    span = 1 if maxval <= minval else (int(maxval) - int(minval)) & MASK32
    mult = (((2 ** 16 % span) ** 2) & MASK32) % span  # the square wraps in uint32
    off = _mul32(hi % span, mult) + (lo % span)
    return int(minval) + (off & MASK32) % span


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for uint32 values in int64, in 16-bit halves of x so
    that no product passes 2^63."""
    return (((x & 0xFFFF) * c) + ((((x >> 16) * c) & 0xFFFF) << 16)) & MASK32
