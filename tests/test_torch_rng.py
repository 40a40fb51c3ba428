"""mfcd_tpu_torch.core.prng / rng vs jax.random: threefry bits bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfcd_tpu.core import rng as jrng
from mfcd_tpu_torch.convert import key_from_jax
from mfcd_tpu_torch.core import prng, rng as trng

torch.set_num_threads(1)

SHAPES = [(1,), (7,), (1001,), (3, 5), (17, 33)]


def _data(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.fixture(scope="module")
def tree():
    """config -> rep -> 9-stream key tree from both packages."""
    out = []
    for seed, cfg_idx in ((0, 0), (0, 3), (12345, 1)):
        jck = jrng.config_key(jax.random.key(seed), cfg_idx)
        tck = trng.config_key(prng.key(seed), cfg_idx)
        jreps = jrng.rep_keys(jck, 3)
        treps = trng.rep_keys(tck, 3)
        jstreams = [jrng.rep_streams(jreps[r]) for r in range(3)]
        out.append((jck, tck, jreps, treps, jstreams, trng.rep_streams(treps)))
    return out


def test_threefry_partitionable_is_on():
    # The port implements the partitionable layout; a jax upgrade that
    # changes the default must fail here first.
    assert jax.config.jax_threefry_partitionable is True


def test_key_tree_bit_equal(tree):
    for jck, tck, jreps, treps, jstreams, tstreams in tree:
        assert (_data(jck) == tck.numpy()).all()
        assert (_data(jreps) == treps.numpy()).all()
        for r in range(3):
            assert (_data(jrng.rep_key(jck, r))
                    == trng.rep_key(tck, r).numpy()).all()
            for name in jrng.STREAMS:
                assert (_data(jstreams[r][name])
                        == tstreams[name][r].numpy()).all(), name
    assert trng.STREAMS == jrng.STREAMS


@pytest.mark.parametrize("num", [2, 3, 9])
def test_split_bit_equal(num):
    k = jax.random.fold_in(jax.random.key(7), 11)
    got = prng.split(key_from_jax(jax.random.key_data(k)), num)
    assert (_data(jax.random.split(k, num)) == got.numpy()).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_bit_equal(shape):
    k = jax.random.fold_in(jax.random.key(3), 5)
    tk = key_from_jax(jax.random.key_data(k))
    bits = np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64)
    assert (bits == prng.bits(tk, shape).numpy()).all()
    uni = np.asarray(jax.random.uniform(k, shape))
    assert (uni == prng.uniform(tk, shape).numpy()).all()


def test_batched_keys_match_per_key_draws(tree):
    _, _, jreps, treps, _, _ = tree[1]
    got = prng.uniform(treps, (4, 6)).numpy()
    for r in range(3):
        assert (np.asarray(jax.random.uniform(jreps[r], (4, 6)))
                == got[r]).all()


@pytest.mark.parametrize("lo,hi,shape", [(0, 37, (999,)), (0, 1000, ()),
                                          (5, 100000, (13, 7)),
                                          (0, 2, (64,))])
def test_randint_bit_equal(lo, hi, shape):
    k = jax.random.key(21)
    tk = key_from_jax(jax.random.key_data(k))
    want = np.asarray(jax.random.randint(k, shape, lo, hi))
    got = prng.randint(tk, shape, lo, hi).numpy()
    assert got.dtype == np.int32 and (want == got).all()


def test_bernoulli_bit_equal():
    k = jax.random.key(4)
    tk = key_from_jax(jax.random.key_data(k))
    p = np.random.default_rng(0).random((50, 1)).astype(np.float32)
    want = np.asarray(jax.random.bernoulli(k, jnp.asarray(p), (50, 3)))
    got = prng.bernoulli(tk, torch.from_numpy(p), (50, 3)).numpy()
    assert (want == got).all()


@pytest.mark.parametrize("shape", [(1000, 2), (3, 5), (20001,)])
def test_normal_allclose(shape):
    # erfinv is Giles' polynomial on both sides, but the log1p and the
    # polynomial round differently in the last bit.
    k = jax.random.fold_in(jax.random.key(9), 2)
    tk = key_from_jax(jax.random.key_data(k))
    np.testing.assert_allclose(prng.normal(tk, shape).numpy(),
                               np.asarray(jax.random.normal(k, shape)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**31, -1, -12345])
def test_key_from_seed_bit_equal(seed):
    assert (_data(jax.random.key(seed)) == prng.key(seed).numpy()).all()


def test_split_permutation_matches():
    assert (jrng.split_permutation(101) == trng.split_permutation(101)).all()
    assert (_data(jrng.split_key()) == trng.split_key().numpy()).all()
