"""mfcd_tpu_torch.ops.shuffle vs mfcd_tpu.ops.shuffle: indices bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfcd_tpu.ops import shuffle as J
from mfcd_tpu_torch.convert import key_from_jax
from mfcd_tpu_torch.ops import shuffle as T

torch.set_num_threads(1)

KEY = jax.random.fold_in(jax.random.key(1), 7)
TKEY = key_from_jax(jax.random.key_data(KEY))
# (count, k_bits): full, partial, tiny (fallback-prone), and wide domains.
CASES = [(70, 7), (128, 7), (3, 7), (1000, 10), (5000, 17)]
# The width of hard K = 50's stream (2^22 slots): 4,000,000 rows, a count
# just past 2^21 (the longest walks), and a count far below 2^22 (every
# lane runs the 48 steps and takes the strided fallback).  Every 61st slot
# (the map is pointwise, so any subset of slots maps as in the whole).
WIDE = [(4_000_000, 22), (2 ** 21 + 1, 22), (100, 22)]


@pytest.mark.parametrize("count,k_bits,stride", [
    pytest.param(c, k, 1, id=f"{c}-{k}") for c, k in CASES] + [
    pytest.param(c, k, 61, id=f"{c}-{k}-every61") for c, k in WIDE])
def test_epoch_permutation_bit_equal(count, k_bits, stride):
    slots = np.arange(0, 1 << k_bits, stride, dtype=np.int32)
    want = np.asarray(J.epoch_permutation(KEY, jnp.asarray(slots), count,
                                          k_bits))
    got = T.epoch_permutation(TKEY, torch.from_numpy(slots), count, k_bits)
    assert got.dtype == torch.int32 and (want == got.numpy()).all()


@pytest.mark.parametrize("count,k_bits", CASES)
def test_exact_prefix_permutation_and_inverse_bit_equal(count, k_bits):
    slots = np.arange(1 << k_bits, dtype=np.int32)
    fwd = np.asarray(J.exact_prefix_permutation(KEY, jnp.asarray(slots),
                                                count, k_bits))
    got = T.exact_prefix_permutation(TKEY, torch.from_numpy(slots), count,
                                     k_bits).numpy()
    assert (fwd == got).all()
    assert sorted(got[:count]) == list(range(count))
    inv = np.asarray(J.exact_prefix_permutation_inverse(
        KEY, jnp.asarray(fwd), count, k_bits))
    got_inv = T.exact_prefix_permutation_inverse(
        TKEY, torch.from_numpy(fwd.copy()), count, k_bits).numpy()
    assert (inv == got_inv).all()
    assert (got_inv[:count] == slots[:count]).all()


def test_inverse_odd_and_unmix_roundtrip():
    muls, adds = T._derive_constants(TKEY)
    inv = T._inverse_odd(muls)
    assert ((muls * inv) & 0xFFFFFFFF == 1).all()
    x = torch.arange(1 << 12, dtype=torch.int64)
    assert (T._unmix(T._mix(x, muls, adds, 12), muls, adds, 12) == x).all()


@pytest.mark.parametrize("period,wide", [
    pytest.param(1, False, id="1"), pytest.param(4, False, id="4"),
    pytest.param(4, True, id="4-k50-stream")])
def test_mix_stream_bit_equal(period, wide):
    """Runs batched along a leading axis, counts that leave the last tile
    partial, six epochs (fresh PRP and cheap epochs); and hard K = 50's
    stream at the canonical width, 2^22 slots of which 4,000,000 valid,
    tiles of 64 (bs = 64), a fresh and a cheap epoch."""
    if wide:
        counts = np.array([4_000_000, 3_999_999], np.int32)
        s_len, k_bits, tile_w, epochs = 1 << 22, 22, 64, 2
    else:
        counts = np.array([70, 100, 77], np.int32)
        s_len, k_bits, tile_w, epochs = 128, 7, 8, 6
    r = len(counts)
    keys = jax.random.split(jax.random.key(5), r)
    tkeys = key_from_jax(jax.random.key_data(keys))
    arrs = (np.arange(r * s_len, dtype=np.int32).reshape(r, s_len),
            np.arange(r * s_len, dtype=np.float32).reshape(r, s_len) * 0.5)
    js = tuple(jnp.asarray(a) for a in arrs)
    ts = tuple(torch.from_numpy(a.copy()) for a in arrs)
    for e in range(epochs):
        jk = jax.vmap(lambda kk: jax.random.fold_in(kk, e))(keys)
        js = jax.vmap(lambda a, kk, c: J.mix_stream(
            a, kk, e, c, k_bits, period=period, tile_w=tile_w))(
                js, jk, jnp.asarray(counts))
        ts = T.mix_stream(ts, T.prng.fold_in(tkeys, e), e,
                          torch.from_numpy(counts), k_bits, period=period,
                          tile_w=tile_w)
        for a, b in zip(js, ts):
            assert (np.asarray(a) == b.numpy()).all(), (period, e)
        # every valid row still appears exactly once
        for run, c in enumerate(counts):
            assert (np.sort(ts[0][run, :c].numpy())
                    == np.arange(run * s_len, run * s_len + c)).all()


def test_stream_tile_width_and_period(monkeypatch):
    for bs in (64, 32, 24, 6, 256):
        assert T.stream_tile_width(bs) == J.stream_tile_width(bs)
    monkeypatch.setenv("MFCD_RESHUFFLE_PERIOD", "2")
    assert T.default_reshuffle_period() == 2
