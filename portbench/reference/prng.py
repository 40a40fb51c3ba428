"""Counter-based random numbers and keyed permutations, in plain PyTorch.

The study draws every random choice from threefry2x32 keys in the layout
``jax.random`` uses with ``jax_threefry_partitionable=True``: a key is an
int64 tensor ``[..., 2]`` of two uint32 words, ``key(seed) = [0, seed mod
2^32]``; ``fold_in(k, x)`` hashes the counter ``(0, x)``; ``split(k, n)``
and ``bits(k, shape)`` hash the counter ``(i >> 32, i & M32)`` of each
flat output index ``i``, and 32-bit bits are ``o0 ^ o1``.

The keyed permutations sample triplets without replacement and shuffle the
training rows: an invertible mix on ``[0, 2^k)`` (three rounds of an odd
multiply, a xorshift by ``k // 2`` and an add, with per-key constants from
``bits(key, (6,))``), restricted to ``[0, count)`` by cycle walking.

Every word is a uint32 value held in an int64 lane.  Nothing here is fast:
it is the yardstick the measured program is held to.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2^32`` for uint32 words in int64 lanes, without
    overflowing int64."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & M32


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 hash of counters ``(x0, x1)`` under key
    words ``(k0, k1)``; broadcast int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for block in range(5):
        for r in _ROT[block % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & M32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & M32
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``[..., 2]`` keys folded with ``data`` (an int or a tensor that
    broadcasts against the keys' leading dims)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & M32
    o0, o1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([o0, o1], dim=-1)


def _hash_iota(k: torch.Tensor, shape: Sequence[int]):
    shape = tuple(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=k.device).reshape(shape)
    pad = (1,) * len(shape)
    lead = k.shape[:-1]
    return threefry2x32(k[..., 0].reshape(lead + pad),
                        k[..., 1].reshape(lead + pad), idx >> 32, idx & M32)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``[..., 2]`` -> ``[..., num, 2]``."""
    o0, o1 = _hash_iota(k, (num,))
    return torch.stack([o0, o1], dim=-1)


def bits(k: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    o0, o1 = _hash_iota(k, shape)
    return o0 ^ o1


def _uniform_bits(words: torch.Tensor, lo: float, hi: float):
    f = ((words >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo_t = torch.tensor(lo, dtype=torch.float32, device=words.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=words.device)
    return torch.maximum(lo_t, f * (hi_t - lo_t) + lo_t)


def uniform(k: torch.Tensor, shape: Sequence[int] = (), lo: float = 0.0,
            hi: float = 1.0) -> torch.Tensor:
    return _uniform_bits(bits(k, shape), lo, hi)


# Single-precision erfinv (Giles), the polynomial XLA lowers erf_inv to.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for lt, ge in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(small, lt, ge).to(torch.float32)
        p = c if p is None else c + p * w
    return p * x


def normal(k: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    return _erfinv(uniform(k, shape, _NORMAL_LO, 1.0)) * _SQRT2


def randint(k: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """One draw in ``[lo, hi)`` per key (``jax.random.randint``'s
    two-word span formula), int64."""
    k1, k2 = split(k).unbind(-2)
    higher, lower = bits(k1), bits(k2)
    span = (hi - lo) & M32 if hi > lo else 1
    mult = ((2 ** 16 % span) ** 2 & M32) % span
    off = mul32(higher % span, mult)
    return lo + ((off + lower % span) & M32) % span


# -- keyed permutations ------------------------------------------------------

def _constants(k: torch.Tensor):
    w = bits(k, (6,))
    return w[..., :3] | 1, w[..., 3:]


def _mix(x, muls, adds, k_bits: int):
    mask = (1 << k_bits) - 1
    shift = max(k_bits // 2, 1)
    for r in range(3):
        x = mul32(x, muls[..., r:r + 1]) & mask
        x = x ^ (x >> shift)
        x = (x + adds[..., r:r + 1]) & mask
    return x


def _inverse_odd(m: torch.Tensor) -> torch.Tensor:
    v = m
    for _ in range(5):
        v = mul32(v, (2 - mul32(m, v)) & M32)
    return v


def _unmix(y, muls, adds, k_bits: int):
    mask = (1 << k_bits) - 1
    shift = max(k_bits // 2, 1)
    inv = _inverse_odd(muls)
    for r in range(2, -1, -1):
        y = (y - adds[..., r:r + 1]) & mask
        x = y
        for _ in range(-(-k_bits // shift) - 1):
            x = y ^ (x >> shift)
        y = mul32(x, inv[..., r:r + 1]) & mask
    return y


def _walk(x, step, count, limit=None):
    """Apply ``step`` to each lane until it lands below ``count``."""
    it = 0
    while (limit is None or it < limit) and bool((x >= count).any()):
        x = torch.where(x < count, x, step(x))
        it += 1
    return x


def _count_col(count, like: torch.Tensor) -> torch.Tensor:
    c = torch.as_tensor(count, dtype=torch.int64, device=like.device)
    return torch.clamp(c.unsqueeze(-1) & M32, min=1)


def prefix_permutation(k, slots, count, k_bits: int) -> torch.Tensor:
    """The keyed bijection of ``[0, count)`` at ``slots`` (slots at or
    past ``count`` are walked from 0; their values mean nothing)."""
    muls, adds = _constants(k)
    slots = slots.to(torch.int64) & M32
    c = _count_col(count, slots)
    x = _mix(torch.where(slots < c, slots, torch.zeros_like(slots)), muls,
             adds, k_bits)
    return _walk(x, lambda v: _mix(v, muls, adds, k_bits), c)


def prefix_permutation_inverse(k, values, count, k_bits: int):
    muls, adds = _constants(k)
    values = values.to(torch.int64) & M32
    c = _count_col(count, values)
    x = _unmix(torch.where(values < c, values, torch.zeros_like(values)),
               muls, adds, k_bits)
    return _walk(x, lambda v: _unmix(v, muls, adds, k_bits), c)


def capped_permutation(k, slots, count, k_bits: int) -> torch.Tensor:
    """The epoch shuffle's walk: at most 48 steps, then a strided
    fallback ``slot * muls[0] mod count`` for lanes still outside."""
    muls, adds = _constants(k)
    slots = slots.to(torch.int64)
    c = _count_col(count, slots)
    x = _walk(_mix(slots, muls, adds, k_bits),
              lambda v: _mix(v, muls, adds, k_bits), c, 48)
    return torch.where(x < c, x, mul32(slots, muls[..., 0:1]) % c)
