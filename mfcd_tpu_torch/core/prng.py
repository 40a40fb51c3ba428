"""threefry2x32 counter-based random numbers, bit-equal to ``jax.random``.

Counterpart of the parts of jax 0.9.0's ``jax/_src/prng.py`` and
``jax/_src/random.py`` that ``mfcd_tpu`` uses, with
``jax_threefry_partitionable=True`` (that version's default):

- a key is an int64 tensor ``[..., 2]`` holding two uint32 words
  (``jax.random.key_data`` layout); ``key(seed) = [0, seed]``,
- ``fold_in(k, x)`` hashes the counter pair ``(0, x)`` under ``k``,
- ``split(k, num)`` and ``bits(k, shape)`` hash an iota counter pair
  ``(hi, lo)`` per output element; 32-bit bits are ``out1 ^ out2``,
- ``uniform`` fills the mantissa (``(bits >> 9) | 0x3F800000``) minus 1,
- ``normal`` is ``sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))``,
- ``randint`` combines two keyed draws with the span-multiplier formula.

Torch has no full uint32 arithmetic, so every word lives in an int64 lane
masked to 32 bits.  Products of two 32-bit words would overflow int64 and
go through :func:`mul32`, which splits one factor into 16-bit halves.

Every function broadcasts over leading key dimensions: a key ``[R, 2]``
yields ``[R, *shape]`` draws, one independent stream per run.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _u32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return torch.as_tensor(np.asarray(x, dtype=np.int64) & M32,
                           device=device)


def mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a * b) mod 2^32`` for uint32 words held in int64 lanes."""
    a_lo = a & 0xFFFF
    a_hi = a >> 16
    return (a_lo * b + (((a_hi * b) & 0xFFFF) << 16)) & M32


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash (20 rounds) of counters ``(x0, x1)``."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
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
    """``jax.random.key_data(jax.random.key(seed))`` for a 32-bit seed (jax
    without x64 keeps its low word: ``[0, seed mod 2^32]``)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` may be a tensor broadcast against
    the key's leading dims."""
    d = _u32(data, k.device)
    o0, o1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([o0, o1], dim=-1)


def _iota_pair(shape: Sequence[int], device):
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & M32


def _hash_shape(k: torch.Tensor, shape: Sequence[int]):
    shape = tuple(shape)
    hi, lo = _iota_pair(shape, k.device)
    lead = k.shape[:-1]
    pad = (1,) * len(shape)
    k0 = k[..., 0].reshape(lead + pad)
    k1 = k[..., 1].reshape(lead + pad)
    return threefry2x32(k0, k1, hi, lo)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2] -> [..., num, 2]``."""
    b1, b2 = _hash_shape(k, (num,))
    return torch.stack([b1, b2], dim=-1)


def bits(k: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)``: ``[..., *shape]`` words."""
    b1, b2 = _hash_shape(k, shape)
    return b1 ^ b2


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def uniform(k: torch.Tensor, shape: Sequence[int] = (), minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32."""
    words = (bits(k, shape) >> 9) | 0x3F800000
    floats = words.to(torch.int32).view(torch.float32) - 1.0
    lo = _as_f32(minval, k.device)
    hi = _as_f32(maxval, k.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))


# Giles' single-precision erfinv polynomial, the one XLA lowers
# ``lax.erf_inv`` to for float32 (w < 5 branch, w >= 5 branch).
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv on (-1, 1) as XLA computes it (``torch.erfinv``
    differs from it by up to ~6e-6 relative; this by ~2e-7)."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    coef = lambda i: torch.where(small, _ERFINV_LT5[i], _ERFINV_GE5[i]).to(
        torch.float32)
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    return p * x


def normal(k: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32 (erfinv may differ in the last bit)."""
    u = uniform(k, shape, _NORMAL_LO, 1.0)
    return erfinv(u) * _SQRT2


def bernoulli(k: torch.Tensor, p: torch.Tensor,
              shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)`` (mode "low")."""
    return uniform(k, shape) < p


def randint(k: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` into int32 for Python-int bounds."""
    k1, k2 = split(k).unbind(-2)
    higher, lower = bits(k1, shape), bits(k2, shape)
    span = (int(maxval) - int(minval)) & M32 if maxval > minval else 1
    # uint32 arithmetic: the squared multiplier and the product wrap.
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span
    offset = mul32(higher % span, mult)
    offset = ((offset + lower % span) & M32) % span
    return (int(minval) + offset).to(torch.int32)
