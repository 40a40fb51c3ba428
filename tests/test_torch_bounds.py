"""chip_smoke.py's bounds for the integer kernels S1, S2 and T1: the card's
32-bit integer rate (PEAK_INT32_OPS, from the SM count and the top SM
clock), bound_ms's integer branch, S1's bytes and steps by form and mode,
and which side bounds each kernel at the six shapes of [14]
(``ab_shuffle_kernels.SHUFFLE_CASES``).

The walks' steps are counted on a sample of 4,096 slots a run (the keyed
map is pointwise, so a sample's mean step count is the whole row's to a
fraction of a per cent) and over every tile; an H100 SXM's 132 SMs at its
top SM clock, 1,980 MHz."""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from mfcd_tpu_torch.core import prng  # noqa: E402
from mfcd_tpu_torch.ops import shuffle  # noqa: E402
from mfcd_tpu_torch.scripts import ab_shuffle_kernels as ab  # noqa: E402

torch.set_num_threads(1)

H100_SMS, H100_MHZ = 132, 1980.0
SAMPLE = 4096


@pytest.fixture
def h100(monkeypatch):
    monkeypatch.setattr(cs, "PEAK_INT32_OPS",
                        cs.peak_int32_ops(H100_SMS, H100_MHZ))


def test_int32_rate_is_64_a_clock_an_sm():
    assert cs.INT32_PER_SM == 64
    assert cs.peak_int32_ops(H100_SMS, H100_MHZ) == 132 * 64 * 1.98e9
    # a quarter of the float32 rate (128 FMAs a clock an SM, 2 flops each)
    assert cs.peak_int32_ops(H100_SMS, H100_MHZ) == pytest.approx(
        cs.PEAK_F32_FLOPS / 4, rel=0.002)


def test_bound_ms_integer_branch(h100):
    rate = cs.PEAK_INT32_OPS
    ms, by = cs.bound_ms(0, int_ops=rate)            # a second of issue
    assert (ms, by) == (1e3, "operations")
    ms, by = cs.bound_ms(cs.PEAK_BYTES_PER_S, int_ops=rate / 2)
    assert (ms, by) == (1e3, "bytes")
    # float32 and integer operations add up on the operations side
    ms, by = cs.bound_ms(0, flops=cs.PEAK_F32_FLOPS, int_ops=rate)
    assert (ms, by) == (pytest.approx(2e3), "operations")
    # the float bounds (K1, P1, P2, K2) do not change
    assert cs.bound_ms(1e9, 1e12) == cs.bound_ms(1e9, flops=1e12)


def test_bound_ms_refuses_integer_work_before_the_rate(monkeypatch):
    monkeypatch.setattr(cs, "PEAK_INT32_OPS", None)
    assert cs.bound_ms(1e6, 1e6)[1] == "bytes"
    with pytest.raises(SystemExit, match="PEAK_INT32_OPS"):
        cs.bound_ms(0, int_ops=1)


def test_threefry_bounds_at_the_integer_rate(h100):
    # bits over [2, 2^22]: 8.4 M hashes of 40 ALU-only operations (20
    # rotates, 20 xors), 20.06 us of issue against 20.03 us of stores; over
    # [4, 131,072] 1.254 us.  At the float32 rate the same count gave a
    # quarter of that, 5 us.
    ms, by = cs.threefry_bound(2 << 22, 2 << 22, 2)
    assert by == "operations" and ms == pytest.approx(0.020060, rel=1e-4)
    assert ms == pytest.approx(4 * (2 << 22) * cs.HASH_OPS
                               / cs.PEAK_F32_FLOPS * 1e3, rel=0.002)
    ms, by = cs.threefry_bound(4 * 131_072, 4 * 131_072, 4)
    assert by == "operations" and ms == pytest.approx(0.0012537, rel=1e-4)
    # ALU-only: rotates and xors, half of the hash's 70-odd operations
    assert (cs.HASH_OPS, cs.MIX_OPS, cs.SLOT_OPS) == (40, 14, 2)


def _sides(label, r, s_len, count, k_bits, arrays):
    keys = prng.split_reference(prng.key(r), r)
    counts = torch.clamp(torch.tensor([count - 13 * i for i in range(r)],
                                      dtype=torch.int32), min=1)
    slots = torch.from_numpy(np.sort(np.random.default_rng(0).choice(
        s_len, SAMPLE, replace=False)))
    mean_steps = lambda k: float(ab.walk_steps(
        k, slots, counts, k_bits).double().mean()) * r * s_len
    k_prp = prng.split_reference(prng.fold_in_reference(keys, 0),
                                 3)[..., 0, :]
    fresh = cs.bound_ms(cs.stream_bytes(r, s_len, arrays),
                        int_ops=cs.stream_int_ops(mean_steps(k_prp), r,
                                                  s_len))
    # a cheap epoch: one walk a full tile (epoch 1's tile key)
    k_tile = prng.split_reference(prng.fold_in_reference(keys, 1),
                                  3)[..., 2, :]
    full = counts.to(torch.int64).unsqueeze(-1) // ab.TILE
    tiles = torch.arange(s_len // ab.TILE)
    walked = ab.walk_steps(k_tile, tiles, torch.clamp(full[:, 0], min=1),
                           max(k_bits - ab.TILE.bit_length() + 1, 1))
    cheap = cs.bound_ms(cs.stream_bytes(r, s_len, arrays),
                        int_ops=cs.stream_int_ops(
                            int((walked * (tiles < full)).sum()), r, s_len))
    s1 = cs.bound_ms(cs.prp_bytes(r, s_len, 8, True),
                     int_ops=cs.MIX_OPS * mean_steps(keys)
                     + cs.SLOT_OPS * r * s_len)
    return dict(fresh=fresh, cheap=cheap, s1=s1,
                bits=cs.threefry_bound(r * s_len, r * s_len, r),
                fold_in=cs.threefry_bound(r, 2 * r, r),
                split=cs.threefry_bound(9 * r, 18 * r, r))


# Which side bounds each kernel: S2 moves 8 bytes a slot and array, more
# than its walks' ALU work (1.64 steps of 14 where count is 61 % of 2^k, a
# cheap epoch one walk a tile); S1 writes 4 bytes a run's slot and reads
# its shared slots once, so its walks bound it from 8 runs up; T1's bits
# are their hashes (40 ALU operations against 8 bytes a word), a few keys
# their bytes.
OPS, BYTES = "operations", "bytes"
SIDES = {
    "canonical": dict(s1=BYTES),
    "bench bucket": dict(s1=OPS),
    "sweep": dict(s1=OPS),
    "hard K=10": dict(s1=BYTES),
    "hard K=50": dict(s1=BYTES),
    "scale": dict(s1=BYTES),
}


@pytest.mark.parametrize("case", ab.SHUFFLE_CASES, ids=lambda c: c[0])
def test_which_side_bounds_at_the_six_shapes(case, h100):
    got = _sides(*case)
    want = dict(SIDES[case[0]], fresh=BYTES, cheap=BYTES, bits=OPS,
                fold_in=BYTES, split=BYTES)
    assert {k: v[1] for k, v in got.items()} == want
    # a cheap epoch is its bytes: every word read and written once
    assert got["cheap"][0] == cs.stream_bytes(*case[1:3], case[5]) \
        / cs.PEAK_BYTES_PER_S * 1e3


def test_s1_walk_ops_by_mode():
    # a mix step: 3 rounds of mask, shift, xor, mask and the test; an
    # unmix step: ceil(k / shift) - 1 passes a round, a shift each and one
    # xor of them all, between its two masks, and the test
    assert [cs.walk_ops(m, 17) for m in ("capped", "exact")] == [14, 14]
    assert [cs.walk_ops("inverse", k) for k in (1, 2, 3, 17, 30, 32)] == [
        8, 14, 17, 17, 14, 14]


def test_s1_bytes_by_form():
    r, s = 4, 131_072
    # one shared row of int64 slots, and a row of int32 slots a run
    assert cs.prp_bytes(r, s, 8, True) == 8 * s + 4 * r * s + 20 * r
    assert cs.prp_bytes(r, s, 4, False) == 8 * r * s + 20 * r


# prp_splits' forms bound by their walks: the canonical shape's inverse
# walk, whose 39 % of padding slots (count 80,000 of 131,072) all walk from
# 0, a long walk under that shape's shared key (2.58 unmix steps a slot on
# average, 17 operations each, against 8 bytes).
SPLIT_OPS = {("canonical", "split inverse")}


@pytest.mark.parametrize("case", ab.SHUFFLE_CASES, ids=lambda c: c[0])
def test_s1_split_forms_bound_sides(case, h100):
    """prp_splits' two forms (``ab.prp_forms``) at the six shapes: their
    walks (1.3 unmix steps of 17 operations a slot at c / 2^k = 0.76, 1.08
    mix steps of 14 at k = 30, fewer at the wider counts) mostly stay under
    8 bytes a slot, so their bytes bound them.  On a sample of slots: the
    steps and the bytes both scale with the slots, so the side does not
    change, and a bytes bound scales by S / SAMPLE."""
    label, r, s_len, count, k_bits, _ = case
    keys = prng.split_reference(prng.key(r), r)
    counts = torch.clamp(torch.tensor([count - 13 * i for i in range(r)],
                                      dtype=torch.int32), min=1)
    forms = ab.prp_forms(keys, counts, SAMPLE, k_bits)
    cols = torch.from_numpy(np.sort(np.random.default_rng(1).choice(
        s_len, SAMPLE, replace=False)))
    c = counts.to(torch.int64).unsqueeze(-1)
    y = torch.where(cols < c, (cols + 7 * torch.arange(r).unsqueeze(-1)) % c,
                    0).to(torch.int32)
    rank = shuffle.exact_prefix_permutation_inverse_reference(
        keys[0], y, counts, k_bits)
    for name, slots in (("split inverse", y), ("split exact", rank)):
        mode, key, _, cnt, k = forms[name]
        ms, by = cs.prp_bound(cs.PRP_MODES[mode], key, slots, cnt, k)
        assert by == (OPS if (label, name) in SPLIT_OPS else BYTES), name
        if by == BYTES:
            assert ms * s_len / SAMPLE == pytest.approx(
                cs.prp_bytes(r, s_len, 4, False) / cs.PEAK_BYTES_PER_S
                * 1e3, rel=0.01)


@pytest.mark.parametrize("k_bits,count", [(12, 3000), (17, 80_000)])
def test_s1_probe_rows_walk_one_step(k_bits, count):
    """``ab.walk_probe``'s one-step rows: every slot is below its row's
    count and its inverse walk lands after one unmix (the plain walk's
    result is one unmix of it), as ``ab.walk_steps`` counts it."""
    r, s_len = 3, 4096
    keys = prng.split_reference(prng.key(r), r)
    counts = torch.tensor([count - 13 * i for i in range(r)],
                          dtype=torch.int32)
    key = keys[0]
    rows = ab.one_step_rows(key, counts, s_len, k_bits)
    assert rows.dtype == torch.int32 and rows.shape == (r, s_len)
    assert bool((rows >= 0).all() and (rows < counts.unsqueeze(-1)).all())
    muls, adds = shuffle._derive_constants(key)
    assert torch.equal(
        shuffle.exact_prefix_permutation_inverse_reference(
            key, rows, counts, k_bits).to(torch.int64),
        shuffle._unmix(rows.to(torch.int64), muls, adds, k_bits))
    assert bool((ab.walk_steps(key, rows, counts, k_bits, "inverse")
                 == 1).all())
