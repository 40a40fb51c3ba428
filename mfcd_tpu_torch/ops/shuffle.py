"""Sort-free epoch shuffling — a keyed bijection with cycle walking.

Counterpart of ``mfcd_tpu/ops/shuffle.py``; indices are bit-equal to it.
Each epoch uses a keyed pseudorandom permutation computed pointwise: an
invertible mixing function on ``[0, 2^k)`` (odd multiplier, xorshift and
add rounds with per-key constants), restricted to the valid prefix
``[0, count)`` by cycle walking.

Words are uint32 values in int64 lanes.  Every function broadcasts over
leading dimensions: a key ``[R, 2]`` with ``count`` ``[R]`` permutes
``[R, S]`` arrays, one permutation per run.  The data-dependent walks loop
in Python while any lane is outside the prefix (one host sync per
iteration on the card).
"""

from __future__ import annotations

import os
import sys

import torch

from mfcd_tpu_torch.core import prng
from mfcd_tpu_torch.core.prng import M32, mul32

_WALK_ITERS = 48


def _col(count, like: torch.Tensor) -> torch.Tensor:
    """``count`` (int or ``[...]``) as a ``[..., 1]`` int64 column."""
    return torch.as_tensor(count, dtype=torch.int64,
                           device=like.device).unsqueeze(-1)


def _derive_constants(key: torch.Tensor, rounds: int = 3):
    """Per-key odd multipliers and additive constants ``[..., rounds]``."""
    words = prng.bits(key, (2 * rounds,))
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
    it = 0
    while (max_iters is None or it < max_iters) and bool(
            (x >= count_u).any()):
        x = torch.where(x < count_u, x, step(x))
        it += 1
    return x


def epoch_permutation(key: torch.Tensor, slots: torch.Tensor, count,
                      k_bits: int) -> torch.Tensor:
    """Map slot indices ``[..., N]`` -> rows in [0, count), bijectively on
    the prefix ``slots < count`` (48-step walk + strided fallback)."""
    muls, adds = _derive_constants(key)
    slots = slots.to(torch.int64)
    count_u = _col(count, slots) & M32
    x = _mix(slots, muls, adds, k_bits)
    x = _walk(x, lambda v: _mix(v, muls, adds, k_bits), count_u,
              _WALK_ITERS)
    # Residual walk failures degrade to a strided scramble.
    fallback = mul32(slots, muls[..., 0:1]) % torch.clamp(count_u, min=1)
    return torch.where(x < count_u, x, fallback).to(torch.int32)


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


def exact_prefix_permutation(key: torch.Tensor, slots: torch.Tensor, count,
                             k_bits: int) -> torch.Tensor:
    """Exact bijection of ``slots < count`` onto [0, count) (uncapped walk).

    Lanes with ``slots >= count`` are remapped to slot 0 first; their
    outputs are meaningless and must be discarded by the caller."""
    muls, adds = _derive_constants(key)
    slots = slots.to(torch.int64)
    count_u = torch.clamp(_col(count, slots) & M32, min=1)
    s = torch.where(slots < count_u, slots, torch.zeros_like(slots))
    x = _mix(s, muls, adds, k_bits)
    x = _walk(x, lambda v: _mix(v, muls, adds, k_bits), count_u)
    return x.to(torch.int32)


def exact_prefix_permutation_inverse(key: torch.Tensor, values: torch.Tensor,
                                     count, k_bits: int) -> torch.Tensor:
    """Exact inverse of :func:`exact_prefix_permutation` on [0, count)."""
    muls, adds = _derive_constants(key)
    values = values.to(torch.int64)
    count_u = torch.clamp(_col(count, values) & M32, min=1)
    v = torch.where(values < count_u, values, torch.zeros_like(values))
    x = _unmix(v, muls, adds, k_bits)
    x = _walk(x, lambda y: _unmix(y, muls, adds, k_bits), count_u)
    return x.to(torch.int32)


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


def _rotate_prefix(x: torch.Tensor, rho, count) -> torch.Tensor:
    """Cyclically rotate each valid prefix ``x[..., :count]`` left by ``rho``.

    Slots >= count receive in-bounds garbage; callers mask by slot index."""
    s_len = x.shape[-1]
    doubled = torch.cat([x, x], dim=-1)
    s = torch.arange(s_len, dtype=torch.int64, device=x.device)
    rho = _col(rho, x)
    count = _col(count, x)
    a = torch.gather(doubled, -1, (rho + s).expand(x.shape))
    b = torch.gather(doubled, -1, (s_len + rho - count + s).expand(x.shape))
    return torch.where(s < count - rho, a, b)


def _permute_full_tiles(x: torch.Tensor, key: torch.Tensor, count,
                        tile_w: int, t_bits: int) -> torch.Tensor:
    """PRP-permute the fully-valid tiles of ``x`` among themselves."""
    tiles = x.shape[-1] // tile_w
    full = torch.as_tensor(count, dtype=torch.int64, device=x.device) // tile_w
    t_slots = torch.arange(tiles, dtype=torch.int64, device=x.device)
    prp = epoch_permutation(key, t_slots, torch.clamp(full, min=1), t_bits)
    idx = torch.where(t_slots < full.unsqueeze(-1), prp.to(torch.int64),
                      t_slots)
    x3 = x.reshape(*x.shape[:-1], tiles, tile_w)
    idx = idx.expand(x.shape[:-1] + (tiles,)).unsqueeze(-1)
    return torch.gather(x3, -2, idx.expand(*idx.shape[:-1], tile_w)).reshape(
        x.shape)


def mix_stream(arrays, key: torch.Tensor, epoch_idx: int, count, k_bits: int,
               *, period: int, tile_w: int | None):
    """Advance a carried epoch stream by one epoch's bijection.

    ``arrays`` is a tuple of ``[..., S]`` row arrays sharing one layout;
    valid rows occupy the prefix [0, count).  Returns the mixed tuple."""
    k_prp, k_rho, k_tile = prng.split(key, 3).unbind(-2)
    s_len = arrays[0].shape[-1]
    if period == 1 or epoch_idx % period == 0:
        slots = torch.arange(s_len, dtype=torch.int64, device=key.device)
        sel = epoch_permutation(k_prp, slots, count, k_bits).to(torch.int64)
        return tuple(torch.gather(a, -1, sel.expand(a.shape))
                     for a in arrays)

    count_t = torch.as_tensor(count, dtype=torch.int64, device=key.device)
    rho = prng.bits(k_rho, ()) % torch.clamp(count_t & M32, min=1)
    out = tuple(_rotate_prefix(a, rho, count_t) for a in arrays)
    if tile_w is not None:
        t_bits = max(k_bits - tile_w.bit_length() + 1, 1)
        out = tuple(_permute_full_tiles(a, k_tile, count_t, tile_w, t_bits)
                    for a in out)
    return out
