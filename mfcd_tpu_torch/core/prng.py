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


# How T1 reads each of the four words of a hash (prng_kernel.cu's Kind).
# An operand is (kind, pointer or value, shape, strides, tensor): a
# tensor's metadata, never a view of it, so a launch builds no tensor but
# its output; the tensor rides along to stay alive through the launch.
_VALUE, _INT64, _INT32, _LAST, _INT64_HI, _INT32_HI = range(6)
_HI = {_INT64: _INT64_HI, _INT32: _INT32_HI}
_ZERO = (_VALUE, 0, (), (), None)
_INDEX = (_LAST, 0, (), (), None)


def _t1():
    return _build.bind("prng_kernel.cu", "mfcd_threefry",
                       [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_void_p])


def _bshape(a: tuple, b: tuple) -> tuple:
    """The broadcast of two shapes, in plain Python: it runs on every
    launch, and returns at once where the shapes agree, as they mostly
    do (numpy's and torch's helpers cost more host time a call)."""
    if a == b or not b:
        return a
    if not a:
        return b
    n = max(len(a), len(b))
    a, b = (1,) * (n - len(a)) + a, (1,) * (n - len(b)) + b
    out = []
    for x, y in zip(a, b):
        if x != y and x != 1 and y != 1:
            raise ValueError(f"threefry2x32: shapes {a} and {b} do not "
                             f"broadcast")
        out.append(y if x == 1 else x)
    return tuple(out)


def _word(t, dev) -> tuple:
    """A word tensor as a T1 operand: int64 and int32 read as they lie,
    any other type converted to int64 first."""
    if not isinstance(t, torch.Tensor) or t.device != dev:
        raise ValueError(f"threefry2x32: every word tensor must lie on "
                         f"{dev}")
    if t.dtype == torch.int32:
        kind = _INT32
    else:
        kind = _INT64
        if t.dtype != torch.int64:
            t = t.to(torch.int64)
    return kind, t.data_ptr(), tuple(t.shape), t.stride(), t


def _key_words(k: torch.Tensor, counter: bool = False) -> tuple:
    """Keys ``[..., 2]`` as the k0 and k1 operands (the second word one
    last-dim stride past the first), and their leading shape.  With
    ``counter`` the operands carry a trailing dim of 1, to broadcast over
    the counter's new last dimension."""
    shape = tuple(k.shape)
    if not shape or shape[-1] != 2:
        raise ValueError(f"threefry2x32: keys of shape {shape}, expected "
                         f"[..., 2]")
    if k.dtype != torch.int64:
        k = k.to(torch.int64)
    st = k.stride()
    lead, lead_st = shape[:-1], st[:-1]
    if counter:
        lead_shape, lead_st = lead + (1,), lead_st + (0,)
    else:
        lead_shape = lead
    ptr = k.data_ptr()
    return ((_INT64, ptr, lead_shape, lead_st, k),
            (_INT64, ptr + 8 * st[-1], lead_shape, lead_st, k), lead)


def _hash_launch(shape: tuple, ops, pairs: bool, dev) -> torch.Tensor:
    """One T1 launch: the threefry2x32 hash of the operands ``ops`` (k0,
    k1, x0, x1) over ``shape``: ``[*shape]`` words ``o0 ^ o1``, or
    ``[*shape, 2]`` pairs."""
    global THREEFRY_LAUNCHES
    if len(shape) > _MAX_DIMS:
        raise ValueError(f"threefry2x32: {len(shape)} dims, the kernel "
                         f"takes at most {_MAX_DIMS}")
    out = torch.empty(shape + ((2,) if pairs else ()), dtype=torch.int64,
                      device=dev)
    if out.numel() == 0:
        return out
    run = shape or (1,)
    nd = len(run)
    desc = list(run)
    for kind, ptr, op_shape, op_st, _ in ops:
        desc += (kind, ptr)
        pad = nd - len(op_shape)
        desc += (0,) * pad
        desc += (0 if n == 1 else s for n, s in zip(op_shape, op_st))
    lib = _t1()
    err = lib.mfcd_threefry((ctypes.c_longlong * len(desc))(*desc), nd,
                            int(pairs), out.data_ptr(),
                            _build.stream_ptr(dev))
    _build.raise_on(lib, err, "threefry2x32 (T1)")
    THREEFRY_LAUNCHES += 1
    return out


def _counter_launch(k: torch.Tensor, n: int, pairs: bool) -> torch.Tensor:
    """T1 with the counter ``(0, i)`` of index i along a new last
    dimension of ``n``: ``bits(k, (n,))`` words ``[..., n]`` or
    ``split(k, n)`` pairs ``[..., n, 2]``, for keys ``[..., 2]``."""
    if not 0 <= n < 2 ** 31:
        raise ValueError(f"threefry2x32: {n} counters a key, the kernel "
                         f"takes below 2^31")
    k0, k1, lead = _key_words(k, counter=True)
    return _hash_launch(lead + (n,), (k0, k1, _ZERO, _INDEX), pairs,
                        k.device)


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash (20 rounds) of counters ``(x0, x1)``: word
    tensors, broadcast.  One T1 launch on the card, the plain version on
    the CPU."""
    if not _on("threefry2x32", k0.device):
        return threefry2x32_reference(k0, k1, x0, x1)
    ops = tuple(_word(w, k0.device) for w in (k0, k1, x0, x1))
    shape = ()
    for op in ops:
        shape = _bshape(shape, op[2])
    out = _hash_launch(shape, ops, True, k0.device)
    return out[..., 0], out[..., 1]


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` for a 32-bit seed (jax
    without x64 keeps its low word: ``[0, seed mod 2^32]``).  Made on the
    device, not copied to it: a copy from the host waits for the stream."""
    return torch.arange(2, dtype=torch.int64, device=device) * (
        int(seed) & M32)


def fold_in_reference(k: torch.Tensor, data) -> torch.Tensor:
    """:func:`fold_in` in plain PyTorch, on any device."""
    d = _u32(data, k.device)
    o0, o1 = threefry2x32_reference(k[..., 0], k[..., 1],
                                    torch.zeros_like(d), d)
    return torch.stack([o0, o1], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` may be a tensor broadcast against
    the key's leading dims.  On the card one T1 launch: an integer goes in
    by value, a tensor through its strides."""
    if not _on("fold_in", k.device):
        return fold_in_reference(k, data)
    k0, k1, lead = _key_words(k)
    if isinstance(data, (int, np.integer)):
        d, shape = (_VALUE, int(data) & M32, (), (), None), lead
    else:
        if not isinstance(data, torch.Tensor):
            data = _u32(data, k.device)
        d = _word(data, k.device)
        shape = _bshape(lead, d[2])
    return _hash_launch(shape, (k0, k1, _ZERO, d), True, k.device)


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
    """``jax.random.split``: ``[..., 2] -> [..., num, 2]``.  ``split(k,
    n)[..., i, :]`` is ``fold_in(k, i)``: both hash the counter (0, i)."""
    if not _on("split", k.device):
        return split_reference(k, num)
    return _counter_launch(k, num, pairs=True)


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
    out = _counter_launch(k, math.prod(shape), pairs=False)
    return out if len(shape) == 1 else out.reshape(k.shape[:-1] + shape)


def bits_at_reference(k: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """:func:`bits_at` in plain PyTorch, on any device."""
    index = index.to(torch.int64)
    b1, b2 = threefry2x32_reference(k[..., 0], k[..., 1], index >> 32,
                                    index & M32)
    return b1 ^ b2


def bits_at(k: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The words of ``bits(k, shape)`` at flat (row-major) positions
    ``index`` only; ``k [..., 2]`` broadcasts against ``index``.  On the
    card one T1 launch, the counter split into its words there."""
    if not _on("bits_at", k.device):
        return bits_at_reference(k, index)
    k0, k1, lead = _key_words(k)
    x1 = _word(index, k.device)
    x0 = (_HI[x1[0]],) + x1[1:]
    return _hash_launch(_bshape(lead, x1[2]), (k0, k1, x0, x1), False,
                        k.device)


def _uniform_from_bits(words: torch.Tensor, minval: float,
                       maxval: float) -> torch.Tensor:
    words = (words >> 9) | 0x3F800000
    floats = words.to(torch.int32).view(torch.float32) - 1.0
    # The bounds stay on the host as float32 values (and their float32
    # difference): the same float32 products and sums as jax's, and no
    # copy to the card, which would wait for its stream.
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    return torch.clamp(floats * span + float(lo), min=float(lo))


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
