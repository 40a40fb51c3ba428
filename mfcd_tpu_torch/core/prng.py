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
- ``randint`` combines two keyed draws with the span-multiplier formula,
- ``gumbel`` is mode "low", ``-log(-log(uniform(tiny, 1)))``, and
  ``categorical`` is ``argmax(gumbel + logits)`` over the last axis,
- ``permutation(k, t)`` sorts ``arange(t)`` by fresh 32-bit keys, stably,
  ``ceil(3 ln t / ln(2^32 - 1))`` times (``random.py::_shuffle``).

Torch has no full uint32 arithmetic, so every word lives in an int64 lane
masked to 32 bits.  Products of two 32-bit words would overflow int64 and
go through :func:`mul32`, which splits one factor into 16-bit halves.

The hash itself (:func:`threefry2x32`, and :func:`fold_in`,
:func:`split`, :func:`bits`, :func:`bits_at` on it) launches the kernel
T1 (``ops/csrc/prng_kernel.cu``) for CUDA tensors, one launch a call
(``THREEFRY_LAUNCHES`` counts them), and runs the plain version
(:func:`threefry2x32_reference`, int64 torch operations) for CPU tensors
only; any other device raises.  The draws built on them (``uniform``,
``normal``, ``randint``, ...) take their words from it.

Every function broadcasts over leading key dimensions: a key ``[R, 2]``
yields ``[R, *shape]`` draws, one independent stream per run.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import numpy as np
import torch

from mfcd_tpu_torch.ops import _build

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
THREEFRY_LAUNCHES = 0   # T1 launches, counted where they are made
_MAX_DIMS = 8           # broadcast dims prng_kernel.cu's hash entry takes


def _u32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    if isinstance(x, (int, np.integer)):
        # a fill, not a host copy: no sync on the card
        return torch.full((), int(x) & M32, dtype=torch.int64, device=device)
    return torch.as_tensor(np.asarray(x, dtype=np.int64) & M32,
                           device=device)


def mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a * b) mod 2^32`` for uint32 words held in int64 lanes."""
    a_lo = a & 0xFFFF
    a_hi = a >> 16
    return (a_lo * b + (((a_hi * b) & 0xFFFF) << 16)) & M32


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & M32


def threefry2x32_reference(k0, k1, x0, x1):
    """The threefry2x32 hash (20 rounds) of counters ``(x0, x1)``, in int64
    torch operations: T1's plain version."""
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


def _on(who: str, device: torch.device) -> bool:
    """True for a CUDA device, False for the CPU; raises for any other."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{who}: unsupported device {device}")


def _t1(entry: str):
    args = {"mfcd_threefry_hash": [ctypes.c_void_p] * 6
            + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
               ctypes.c_int, ctypes.c_void_p],
            "mfcd_threefry_bits": [ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_longlong, ctypes.c_longlong,
                                   ctypes.c_longlong, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_void_p]}[entry]
    lib = _build.bind("prng_kernel.cu", entry, args)
    return lib, getattr(lib, entry)


def _hash_launch(words, pairs: bool) -> torch.Tensor:
    """T1 over int64 word tensors ``(k0, k1, x0, x1)`` on one card,
    broadcast against each other (read through their strides, nothing
    expanded): ``[*shape]`` words ``o0 ^ o1``, or ``[*shape, 2]`` pairs."""
    global THREEFRY_LAUNCHES
    dev = words[0].device
    for w in words:
        if not isinstance(w, torch.Tensor) or w.device != dev:
            raise ValueError(f"threefry2x32: every word tensor must lie on "
                             f"{dev}")
    words = torch.broadcast_tensors(*(w.to(torch.int64) for w in words))
    shape = tuple(words[0].shape)
    if len(shape) > _MAX_DIMS:
        raise ValueError(f"threefry2x32: {len(shape)} dims, the kernel "
                         f"takes at most {_MAX_DIMS}")
    out = torch.empty(shape + ((2,) if pairs else ()), dtype=torch.int64,
                      device=dev)
    n = math.prod(shape)
    if n == 0:
        return out
    lib, fn = _t1("mfcd_threefry_hash")
    nd = len(shape)
    c_shape = (ctypes.c_longlong * max(nd, 1))(*shape)
    c_strides = (ctypes.c_longlong * max(4 * nd, 1))(
        *(s for w in words for s in w.stride()))
    err = fn(*(w.data_ptr() for w in words), c_shape, c_strides, nd, n,
             out.data_ptr(), int(pairs), torch.cuda.current_stream(
                 dev).cuda_stream)
    _build.raise_on(lib, err, "threefry2x32 (T1 hash)")
    THREEFRY_LAUNCHES += 1
    return out


def _bits_launch(k: torch.Tensor, n: int, pairs: bool) -> torch.Tensor:
    """T1's counter entry: ``bits(k, (n,))`` words ``[..., n]``, or the
    hashed pairs ``[..., n, 2]`` (``split``'s keys), for keys ``[..., 2]``
    on one card."""
    global THREEFRY_LAUNCHES
    if k.shape[-1:] != (2,):
        raise ValueError(f"threefry2x32: keys of shape {tuple(k.shape)}, "
                         f"expected [..., 2]")
    lead = tuple(k.shape[:-1])
    kf = k.to(torch.int64).reshape(-1, 2)
    out = torch.empty(lead + (n,) + ((2,) if pairs else ()),
                      dtype=torch.int64, device=k.device)
    if out.numel() == 0:
        return out
    lib, fn = _t1("mfcd_threefry_bits")
    err = fn(kf.data_ptr(), kf.stride(0), kf.stride(1), kf.shape[0], n,
             out.data_ptr(), int(pairs),
             torch.cuda.current_stream(k.device).cuda_stream)
    _build.raise_on(lib, err, "threefry2x32 (T1 bits)")
    THREEFRY_LAUNCHES += 1
    return out


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash (20 rounds) of counters ``(x0, x1)``: word
    tensors, broadcast.  One T1 launch on the card, the plain version on
    the CPU."""
    if not _on("threefry2x32", k0.device):
        return threefry2x32_reference(k0, k1, x0, x1)
    out = _hash_launch((k0, k1, x0, x1), pairs=True)
    return out[..., 0], out[..., 1]


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` for a 32-bit seed (jax
    without x64 keeps its low word: ``[0, seed mod 2^32]``)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def fold_in_reference(k: torch.Tensor, data) -> torch.Tensor:
    """:func:`fold_in` in plain PyTorch, on any device."""
    d = _u32(data, k.device)
    o0, o1 = threefry2x32_reference(k[..., 0], k[..., 1],
                                    torch.zeros_like(d), d)
    return torch.stack([o0, o1], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` may be a tensor broadcast against
    the key's leading dims."""
    if not _on("fold_in", k.device):
        return fold_in_reference(k, data)
    d = _u32(data, k.device)
    return _hash_launch((k[..., 0], k[..., 1], torch.zeros_like(d), d),
                        pairs=True)


def _iota_pair(shape: Sequence[int], device):
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & M32


def _hash_shape_reference(k: torch.Tensor, shape: Sequence[int]):
    shape = tuple(shape)
    hi, lo = _iota_pair(shape, k.device)
    lead = k.shape[:-1]
    pad = (1,) * len(shape)
    k0 = k[..., 0].reshape(lead + pad)
    k1 = k[..., 1].reshape(lead + pad)
    return threefry2x32_reference(k0, k1, hi, lo)


def split_reference(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """:func:`split` in plain PyTorch, on any device."""
    b1, b2 = _hash_shape_reference(k, (num,))
    return torch.stack([b1, b2], dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2] -> [..., num, 2]``."""
    if not _on("split", k.device):
        return split_reference(k, num)
    return _bits_launch(k, num, pairs=True)


def bits_reference(k: torch.Tensor,
                   shape: Sequence[int] = ()) -> torch.Tensor:
    """:func:`bits` in plain PyTorch, on any device."""
    b1, b2 = _hash_shape_reference(k, shape)
    return b1 ^ b2


def bits(k: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)``: ``[..., *shape]`` words."""
    shape = tuple(shape)
    if not _on("bits", k.device):
        return bits_reference(k, shape)
    return _bits_launch(k, math.prod(shape), pairs=False).reshape(
        k.shape[:-1] + shape)


def bits_at_reference(k: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """:func:`bits_at` in plain PyTorch, on any device."""
    index = index.to(torch.int64)
    b1, b2 = threefry2x32_reference(k[..., 0], k[..., 1], index >> 32,
                                    index & M32)
    return b1 ^ b2


def bits_at(k: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The words of ``bits(k, shape)`` at flat (row-major) positions
    ``index`` only; ``k [..., 2]`` broadcasts against ``index``."""
    if not _on("bits_at", k.device):
        return bits_at_reference(k, index)
    index = index.to(torch.int64)
    return _hash_launch((k[..., 0], k[..., 1], index >> 32, index & M32),
                        pairs=False)


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _uniform_from_bits(words: torch.Tensor, minval, maxval) -> torch.Tensor:
    words = (words >> 9) | 0x3F800000
    floats = words.to(torch.int32).view(torch.float32) - 1.0
    lo = _as_f32(minval, words.device)
    hi = _as_f32(maxval, words.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def uniform(k: torch.Tensor, shape: Sequence[int] = (), minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32."""
    return _uniform_from_bits(bits(k, shape), minval, maxval)


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


def permutation(k: torch.Tensor, t: int) -> torch.Tensor:
    """``jax.random.permutation(k, t)`` for an integer ``t``: int32 ``[...,
    t]``.  Each round splits the key, draws one 32-bit word per element
    from the second half and sorts by the words, stably (equal words keep
    their order, as ``lax.sort_key_val`` does)."""
    rounds = int(np.ceil(3 * np.log(max(1, t))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(t, dtype=torch.int32, device=k.device).expand(
        k.shape[:-1] + (t,))
    for _ in range(rounds):
        k, sub = split(k).unbind(-2)
        order = torch.sort(bits(sub, (t,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x


_F32_TINY = float(np.finfo(np.float32).tiny)


def _gumbel_from_bits(words: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(_uniform_from_bits(words, _F32_TINY, 1.0)))


def gumbel(k: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, mode "low" (jax's default)."""
    return _gumbel_from_bits(bits(k, shape))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(k, logits, axis=-1)`` (with replacement):
    ``logits`` carries the key's leading dims, then the batch dims, then
    the categories; returns int64 indices of the first maximum."""
    shape = logits.shape[k.dim() - 1:]
    return torch.argmax(gumbel(k, shape) + logits, dim=-1)


def masked_uniform_choice(k: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``categorical(k, where(mask, 0, -1e30))``, drawing the gumbel words
    only where ``mask`` is True.

    ``mask [..., rows, c]`` carries the key's leading dims.  A row picks the
    first True position of largest gumbel; a row with none picks 0, as the
    dense draw does (every entry is then -1e30 exactly).  One host sync."""
    lead = mask.shape[:k.dim() - 1]
    rows, c = mask.shape[-2:]
    flat = mask.reshape(-1, rows, c)
    kflat = k.reshape(-1, 2)
    g_idx, row, col = flat.nonzero(as_tuple=True)
    g = _gumbel_from_bits(bits_at(kflat[g_idx], row * c + col))
    slot = g_idx * rows + row
    total = flat.shape[0] * rows
    best = torch.full((total,), -math.inf, device=mask.device).scatter_reduce(
        0, slot, g, "amax")
    top = g == best[slot]
    pick = torch.full((total,), c, dtype=torch.int64, device=mask.device)
    pick = pick.scatter_reduce(0, slot[top], col[top], "amin")
    return torch.where(pick == c, 0, pick).reshape(lead + mask.shape[
        k.dim() - 1:-1])
