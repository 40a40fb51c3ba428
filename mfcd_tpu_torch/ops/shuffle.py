"""Sort-free epoch shuffling — a keyed bijection with cycle walking.

Counterpart of ``mfcd_tpu/ops/shuffle.py``; indices are bit-equal to it.
Each epoch uses a keyed pseudorandom permutation computed pointwise: an
invertible mixing function on ``[0, 2^k)`` (odd multiplier, xorshift and
add rounds with per-key constants), restricted to the valid prefix
``[0, count)`` by cycle walking.

Words are uint32 values in int64 lanes.  Every function broadcasts over
leading dimensions: a key ``[R, 2]`` with ``count`` ``[R]`` permutes
``[R, S]`` arrays, one permutation per run.

On CUDA tensors :func:`epoch_permutation`, :func:`exact_prefix_permutation`
and :func:`exact_prefix_permutation_inverse` launch the keyed PRP kernel S1
and :func:`mix_stream` the fused epoch shuffle S2 (``ops/csrc/
shuffle_kernel.cu``; ``PRP_LAUNCHES``, ``SHUFFLE_LAUNCHES`` count them):
each lane walks alone, with no host sync.  On CPU tensors they run the
plain versions, written in the kernels' shape; any other device raises.
The ``*_reference`` functions are those plain versions on any device,
and launch no kernel (their threefry is ``prng``'s plain one too).
A walk's lane that has landed is a fixed point of ``where(x < count, x,
mix(x))``, so the plain walk may stop as soon as no lane is out of range
(a host read costs nothing on the CPU) and still give each lane the bits
of its own walk.
"""

from __future__ import annotations

import ctypes
import os
import sys

import torch

from mfcd_tpu_torch.core import prng
from mfcd_tpu_torch.core.prng import M32, mul32
from mfcd_tpu_torch.ops import _build

_WALK_ITERS = 48
PRP_LAUNCHES = 0        # S1 launches, counted where they are made
SHUFFLE_LAUNCHES = 0    # S2 launches, likewise
_CAPPED, _EXACT, _INVERSE = 0, 1, 2   # S1's walk modes


def _col(count, like: torch.Tensor) -> torch.Tensor:
    """``count`` (int or ``[...]``) as a ``[..., 1]`` int64 column."""
    return torch.as_tensor(count, dtype=torch.int64,
                           device=like.device).unsqueeze(-1)


def _derive_constants(key: torch.Tensor, rounds: int = 3):
    """Per-key odd multipliers and additive constants ``[..., rounds]``,
    from the plain threefry on any device (S1 and S2 derive them in the
    kernel)."""
    words = prng.bits_reference(key, (2 * rounds,))
    return words[..., :rounds] | 1, words[..., rounds:]


def _mix(x: torch.Tensor, muls, adds, k_bits: int) -> torch.Tensor:
    """Invertible mixing on [0, 2^k): rounds of mul-odd, xorshift, add."""
    mask = (1 << k_bits) - 1
    shift = max(k_bits // 2, 1)
    for r in range(muls.shape[-1]):
        x = mul32(x, muls[..., r:r + 1]) & mask
        x = x ^ (x >> shift)
        x = (x + adds[..., r:r + 1]) & mask
    return x


def _walk(x, step, count_u, max_iters=None):
    """Apply ``step`` to each lane until it lands below ``count_u`` (at most
    ``max_iters`` times): the fixed point ``where(x < count, x, step(x))``,
    each lane's result its own; stops once every lane has landed."""
    it = 0
    while (max_iters is None or it < max_iters) and bool(
            (x >= count_u).any()):
        x = torch.where(x < count_u, x, step(x))
        it += 1
    return x


_S1_ARGS = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_S2_ARGS = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
            + [ctypes.c_void_p] * 8 + [ctypes.c_int]
            + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4
            + [ctypes.c_void_p])
_WORDS = (torch.int32, torch.int64)   # the slot and count types S1 reads


def _library():
    _build.bind("shuffle_kernel.cu", "mfcd_prp", _S1_ARGS)
    return _build.bind("shuffle_kernel.cu", "mfcd_mix_stream", _S2_ARGS)


def _check_k_bits(who: str, k_bits: int) -> None:
    if not 1 <= k_bits <= 32:
        raise ValueError(f"{who}: k_bits={k_bits}, expected 1 to 32")


def _lead(*shapes) -> tuple:
    """The broadcast of ``shapes``, in plain Python: numpy's costs S1's
    wrapper microseconds a call, and ``torch.broadcast_shapes`` imports
    the symbolic-shape machinery on first use, seconds of host time in a
    process's first launch."""
    out = list(max(shapes, key=len))
    for shape in shapes:
        for i in range(1, len(shape) + 1):
            d = shape[-i]
            if d != 1 and out[-i] != d:
                if out[-i] != 1:
                    raise ValueError(f"shapes {[tuple(s) for s in shapes]} "
                                     f"do not broadcast")
                out[-i] = d
    return tuple(out)


def _rows(t: torch.Tensor, lead: tuple, rows: int, inner: tuple):
    """``t [..., *inner]`` read as the ``rows`` rows of ``lead``: (tensor,
    row stride in elements), 0 where one row serves every row.  ``t``
    itself wherever one stride walks its rows (a view); a copy only where
    it broadcasts over some leading dims and not others."""
    dims = t.dim() - len(inner)
    if rows == 1 or t.shape[:dims].numel() == 1:
        return t, 0
    if dims == len(lead) == 1:
        return t, t.stride(0)
    v = t.expand(lead + inner)
    try:
        v = v.view((rows,) + inner)
    except RuntimeError:
        v = v.reshape((rows,) + inner)
    return v, v.stride(0)


def _prp_launch(who: str, key: torch.Tensor, slots: torch.Tensor, count,
                k_bits: int, mode: int) -> torch.Tensor:
    """S1: one keyed PRP walk per slot of ``slots [..., N]``, keys
    ``[..., 2]`` and ``count`` (int or ``[...]``) broadcast against its
    leading dims; int32 ``[..., N]``.  S1 reads the key words (int64),
    the slots and a count tensor (int32 or int64) where they lie, by
    pointer and row stride, and an int count by value: the launch builds
    nothing but the output (other types are converted, a slot or key row
    that is not contiguous is copied)."""
    global PRP_LAUNCHES
    _check_k_bits(who, k_bits)
    dev = slots.device
    if slots.dim() < 1 or key.shape[-1:] != (2,):
        raise ValueError(f"{who}: slots {tuple(slots.shape)} and key "
                         f"{tuple(key.shape)}, expected [..., N], [..., 2]")
    on_tensor = isinstance(count, torch.Tensor)
    if key.device != dev or (on_tensor and count.device != dev):
        raise ValueError(f"{who}: key, slots and count must share {dev}")
    n = slots.shape[-1]
    if n >= 2 ** 31:
        raise ValueError(f"{who}: {n} slots a row, S1 takes below 2^31")
    lead = _lead(key.shape[:-1], slots.shape[:-1],
                 count.shape if on_tensor else ())
    out = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    rows = out.numel() // n
    if key.dtype != torch.int64:
        key = key.to(torch.int64)
    if key.stride(-1) != 1:
        key = key.contiguous()
    if slots.dtype not in _WORDS:
        slots = slots.to(torch.int64)
    if n > 1 and slots.stride(-1) != 1:
        slots = slots.contiguous()
    keys, key_row = _rows(key, lead, rows, (2,))
    slots, slot_row = _rows(slots, lead, rows, (n,))
    if on_tensor:
        if count.dtype not in _WORDS:
            count = count.to(torch.int64)
        count, count_row = _rows(count, lead, rows, ())
        counted = (count.data_ptr(), count_row, count.element_size(), 0)
    else:
        counted = (None, 0, 0, int(count) & M32)
    lib = _library()
    err = lib.mfcd_prp(keys.data_ptr(), key_row, *counted, slots.data_ptr(),
                       slot_row, slots.element_size(), out.data_ptr(), rows,
                       n, mode, k_bits, _build.stream_ptr(dev))
    _build.raise_on(lib, err, f"{who} (S1)")
    PRP_LAUNCHES += 1
    return out


def epoch_permutation_reference(key: torch.Tensor, slots: torch.Tensor,
                                count, k_bits: int) -> torch.Tensor:
    """:func:`epoch_permutation` in plain PyTorch (S1's capped mode)."""
    muls, adds = _derive_constants(key)
    slots = slots.to(torch.int64)
    count_u = _col(count, slots) & M32
    x = _mix(slots, muls, adds, k_bits)
    x = _walk(x, lambda v: _mix(v, muls, adds, k_bits), count_u,
              _WALK_ITERS)
    # Residual walk failures degrade to a strided scramble.
    fallback = mul32(slots, muls[..., 0:1]) % torch.clamp(count_u, min=1)
    return torch.where(x < count_u, x, fallback).to(torch.int32)


def epoch_permutation(key: torch.Tensor, slots: torch.Tensor, count,
                      k_bits: int) -> torch.Tensor:
    """Map slot indices ``[..., N]`` -> rows in [0, count), bijectively on
    the prefix ``slots < count`` (48-step walk + strided fallback)."""
    if prng._on("epoch_permutation", slots.device):
        return _prp_launch("epoch_permutation", key, slots, count, k_bits,
                           _CAPPED)
    return epoch_permutation_reference(key, slots, count, k_bits)


def _inverse_odd(m: torch.Tensor) -> torch.Tensor:
    """Multiplicative inverse of odd ``m`` mod 2^32 (Newton; 5 steps)."""
    v = m
    for _ in range(5):
        v = mul32(v, (2 - mul32(m, v)) & M32)
    return v


def _unmix(y: torch.Tensor, muls, adds, k_bits: int) -> torch.Tensor:
    """Exact inverse of :func:`_mix` on [0, 2^k)."""
    mask = (1 << k_bits) - 1
    shift = max(k_bits // 2, 1)
    inv_muls = _inverse_odd(muls)
    for r in range(muls.shape[-1] - 1, -1, -1):
        y = (y - adds[..., r:r + 1]) & mask
        x = y
        for _ in range(-(-k_bits // shift) - 1):
            x = y ^ (x >> shift)
        y = mul32(x, inv_muls[..., r:r + 1]) & mask
    return y


def exact_prefix_permutation_reference(key: torch.Tensor,
                                       slots: torch.Tensor, count,
                                       k_bits: int) -> torch.Tensor:
    """:func:`exact_prefix_permutation` in plain PyTorch (S1's exact
    mode)."""
    muls, adds = _derive_constants(key)
    slots = slots.to(torch.int64) & M32       # uint32, as in JAX: -1 is out
    count_u = torch.clamp(_col(count, slots) & M32, min=1)
    s = torch.where(slots < count_u, slots, torch.zeros_like(slots))
    x = _mix(s, muls, adds, k_bits)
    x = _walk(x, lambda v: _mix(v, muls, adds, k_bits), count_u)
    return x.to(torch.int32)


def exact_prefix_permutation(key: torch.Tensor, slots: torch.Tensor, count,
                             k_bits: int) -> torch.Tensor:
    """Exact bijection of ``slots < count`` onto [0, count) (uncapped walk).

    Lanes with ``slots >= count`` (as uint32: negative slots too) are
    remapped to slot 0 first; their outputs are meaningless and must be
    discarded by the caller."""
    if prng._on("exact_prefix_permutation", slots.device):
        return _prp_launch("exact_prefix_permutation", key, slots, count,
                           k_bits, _EXACT)
    return exact_prefix_permutation_reference(key, slots, count, k_bits)


def exact_prefix_permutation_inverse_reference(
        key: torch.Tensor, values: torch.Tensor, count,
        k_bits: int) -> torch.Tensor:
    """:func:`exact_prefix_permutation_inverse` in plain PyTorch (S1's
    inverse mode)."""
    muls, adds = _derive_constants(key)
    values = values.to(torch.int64) & M32
    count_u = torch.clamp(_col(count, values) & M32, min=1)
    v = torch.where(values < count_u, values, torch.zeros_like(values))
    x = _unmix(v, muls, adds, k_bits)
    x = _walk(x, lambda y: _unmix(y, muls, adds, k_bits), count_u)
    return x.to(torch.int32)


def exact_prefix_permutation_inverse(key: torch.Tensor, values: torch.Tensor,
                                     count, k_bits: int) -> torch.Tensor:
    """Exact inverse of :func:`exact_prefix_permutation` on [0, count)."""
    if prng._on("exact_prefix_permutation_inverse", values.device):
        return _prp_launch("exact_prefix_permutation_inverse", key, values,
                           count, k_bits, _INVERSE)
    return exact_prefix_permutation_inverse_reference(key, values, count,
                                                      k_bits)


# ---------------------------------------------------------------------------
# Carried epoch streams — periodic reshuffle + cheap prefix-preserving mixing
# ---------------------------------------------------------------------------
#
# The trainers carry the already shuffled row stream across epochs and
# advance it each epoch with a bijection on the valid prefix [0, count):
# every ``period``-th epoch a fresh PRP gather, in between a prefix rotation
# composed with a PRP permutation of the full tiles.  Every training row
# still appears exactly once per epoch.

_logged_period: int | None = None


def default_reshuffle_period() -> int:
    """Epoch period of full PRP reshuffles (``MFCD_RESHUFFLE_PERIOD``, 4).

    The active period is logged once per process."""
    global _logged_period
    period = max(1, int(os.environ.get("MFCD_RESHUFFLE_PERIOD", "4")))
    if _logged_period != period:
        _logged_period = period
        regime = ("fresh PRP every epoch" if period == 1
                  else "full reshuffle every %d epochs" % period)
        print(f"mfcd_tpu_torch: reshuffle period = {period} ({regime})",
              file=sys.stderr, flush=True)
    return period


def stream_tile_width(batch_size: int) -> int | None:
    """Largest power-of-two divisor of ``batch_size``, capped at 128;
    ``None`` below 8 (rotation-only cheap epochs)."""
    w = 1
    while batch_size % (w * 2) == 0 and w < 128:
        w *= 2
    return w if w >= 8 else None


def _source_map(key: torch.Tensor, epoch: int, count, s_len: int,
                k_bits: int, period: int, tile_w: int | None,
                folded: bool = False) -> torch.Tensor:
    """The slot each output slot of one epoch's bijection reads, int64
    ``[..., s_len]``: S2's map in plain PyTorch.

    ``key`` is the epochs key ``[..., 2]`` (``epoch`` is folded in here),
    or with ``folded`` the epoch's key itself.
    A fresh epoch maps slot s to ``epoch_permutation(k_prp, s)``; a cheap
    one rotates the prefix left by rho (``bits(k_rho) % count``) and then
    moves each full tile t < count // tile_w to the PRP of t (the partial
    tile and the padding stay), so output slot s reads slot ``rot(p)``,
    ``p = tile_src(s // tile_w) * tile_w + s % tile_w``.  Slots past count
    read in-bounds padding, as JAX's rotation of the doubled array does."""
    if not folded:
        key = prng.fold_in_reference(key, epoch)
    k_prp, k_rho, k_tile = prng.split_reference(key, 3).unbind(-2)
    slots = torch.arange(s_len, dtype=torch.int64, device=key.device)
    if period == 1 or epoch % period == 0:
        return epoch_permutation_reference(k_prp, slots, count,
                                           k_bits).to(torch.int64)
    count_t = torch.as_tensor(count, dtype=torch.int64, device=key.device)
    rho = prng.bits_reference(k_rho, ()) % torch.clamp(count_t & M32,
                                                       min=1)
    p = slots
    if tile_w is not None:
        t_bits = max(k_bits - tile_w.bit_length() + 1, 1)
        full = (count_t // tile_w).unsqueeze(-1)
        tiles = torch.arange(s_len // tile_w, dtype=torch.int64,
                             device=key.device)
        prp = epoch_permutation_reference(k_tile, tiles,
                                          torch.clamp(full[..., 0], min=1),
                                          t_bits).to(torch.int64)
        tile_src = torch.where(tiles < full, prp, tiles)
        p = tile_src[..., slots // tile_w] * tile_w + slots % tile_w
    rho, c = rho.unsqueeze(-1), count_t.unsqueeze(-1)
    return torch.where(p < c - rho, p + rho, p + rho - c)


def mix_stream_reference(arrays, key: torch.Tensor, epoch: int, count,
                         k_bits: int, *, period: int,
                         tile_w: int | None):
    """:func:`mix_stream` in plain PyTorch: the composed source map, then
    one gather per array."""
    return _gather_stream(arrays, _source_map(
        key, epoch, count, arrays[0].shape[-1], k_bits, period, tile_w))


def _gather_stream(arrays, src: torch.Tensor) -> tuple:
    return tuple(torch.gather(a, -1, src.expand(a.shape)) for a in arrays)


def _mix_stream_launch(arrays, key: torch.Tensor, epoch: int, count,
                       k_bits: int, period: int, tile_w: int | None,
                       folded: bool = False):
    """S2: one launch advances every run's arrays ``[..., S]`` (1, 2 or 4
    of 32-bit words, one layout) by one epoch, into fresh outputs.  Every
    check reads shapes, devices and strides only, and nothing is converted
    where the caller passes int32 counts and int64 keys whose words lie
    side by side (the trainer does): one launch a call."""
    global SHUFFLE_LAUNCHES
    who = "mix_stream"
    _check_k_bits(who, k_bits)
    if len(arrays) not in (1, 2, 4):
        raise ValueError(f"{who}: {len(arrays)} arrays, expected 1, 2 or 4")
    a0 = arrays[0]
    dev, shape = a0.device, a0.shape
    for a in arrays:
        if a.device != dev or a.shape != shape:
            raise ValueError(f"{who}: arrays of shapes "
                             f"{[tuple(b.shape) for b in arrays]} on "
                             f"{[str(b.device) for b in arrays]}")
        if a.element_size() != 4 or not a.is_contiguous():
            raise ValueError(f"{who}: arrays must be contiguous 32-bit "
                             f"words, got {a.dtype}")
    if (not shape or key.device != dev
            or key.shape != shape[:-1] + (2,)):
        raise ValueError(f"{who}: key {tuple(key.shape)} on {key.device}, "
                         f"expected {tuple(shape[:-1]) + (2,)} on {dev}")
    if epoch < 0 or period < 1:
        raise ValueError(f"{who}: epoch={epoch}, period={period}")
    s_len = shape[-1]
    rows = a0.numel() // s_len if s_len else 0
    if isinstance(count, torch.Tensor):
        if count.device != dev or count.numel() != rows:
            raise ValueError(f"{who}: count {tuple(count.shape)} on "
                             f"{count.device}, expected {rows} on {dev}")
        if count.dtype != torch.int32 or not count.is_contiguous():
            count = count.to(torch.int32).contiguous()
    else:
        count = torch.full((rows,), int(count), dtype=torch.int32,
                           device=dev)
    if key.dtype != torch.int64 or key.stride(-1) != 1:
        key = key.to(torch.int64).contiguous()
    keys = key.reshape(-1, 2) if key.dim() != 2 else key
    outs = tuple(torch.empty_like(a) for a in arrays)
    if not rows or not s_len:
        return outs
    ptrs = [a.data_ptr() for a in arrays] + [None] * (4 - len(arrays))
    dsts = [o.data_ptr() for o in outs] + [None] * (4 - len(arrays))
    lib = _library()
    err = lib.mfcd_mix_stream(keys.data_ptr(), keys.stride(0),
                              count.data_ptr(), *ptrs, *dsts, len(arrays),
                              rows, s_len, epoch, period, k_bits,
                              tile_w or 0, int(folded),
                              _build.stream_ptr(dev))
    _build.raise_on(lib, err, f"{who} (S2)")
    SHUFFLE_LAUNCHES += 1
    return outs


def mix_stream(arrays, key: torch.Tensor, epoch: int, count, k_bits: int,
               *, period: int, tile_w: int | None, folded: bool = False):
    """Advance a carried epoch stream by one epoch's bijection.

    ``arrays`` is a tuple of ``[..., S]`` row arrays sharing one layout;
    valid rows occupy the prefix [0, count).  ``key`` is the epochs key
    ``[..., 2]``: the epoch's key is ``fold_in(key, epoch)``, as the JAX
    trainers pass it to ``mix_stream``; with ``folded`` ``key`` is that
    epoch's key already (JAX's ``mix_stream`` contract; ``prng.split(key,
    E)[..., e, :]`` is ``fold_in(key, e)``).  Returns the mixed tuple,
    fresh tensors.  CUDA tensors take one S2 launch (32-bit arrays,
    contiguous); CPU tensors the plain version."""
    arrays = tuple(arrays)
    if prng._on("mix_stream", arrays[0].device):
        return _mix_stream_launch(arrays, key, epoch, count, k_bits, period,
                                  tile_w, folded)
    if folded:
        return _gather_stream(arrays, _source_map(
            key, epoch, count, arrays[0].shape[-1], k_bits, period, tile_w,
            folded=True))
    return mix_stream_reference(arrays, key, epoch, count, k_bits,
                                period=period, tile_w=tile_w)
