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


@pytest.mark.parametrize("count,k_bits", CASES)
def test_epoch_permutation_bit_equal(count, k_bits):
    slots = np.arange(1 << k_bits, dtype=np.int32)
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


@pytest.mark.parametrize("period", [1, 4])
def test_mix_stream_bit_equal(period):
    """Runs batched along a leading axis, counts that leave the last tile
    partial, six epochs (fresh PRP and cheap epochs)."""
    keys = jax.random.split(jax.random.key(5), 3)
    tkeys = key_from_jax(jax.random.key_data(keys))
    counts = np.array([70, 100, 77], np.int32)
    s_len, k_bits, tile_w = 128, 7, 8
    arrs = (np.arange(3 * s_len, dtype=np.int32).reshape(3, s_len),
            np.arange(3 * s_len, dtype=np.float32).reshape(3, s_len) * 0.5)
    js = tuple(jnp.asarray(a) for a in arrs)
    ts = tuple(torch.from_numpy(a.copy()) for a in arrs)
    for e in range(6):
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
        for r, c in enumerate(counts):
            assert sorted(ts[0][r, :c].tolist()) == list(
                range(r * s_len, r * s_len + c))


def test_stream_tile_width_and_period(monkeypatch):
    for bs in (64, 32, 24, 6, 256):
        assert T.stream_tile_width(bs) == J.stream_tile_width(bs)
    monkeypatch.setenv("MFCD_RESHUFFLE_PERIOD", "2")
    assert T.default_reshuffle_period() == 2
