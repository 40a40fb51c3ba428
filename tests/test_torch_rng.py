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


# Counters whose high word is non-zero: bits(k, shape) hashes flat index i
# as the pair (i >> 32, i & 0xFFFFFFFF), so past 2^32 elements the high
# word moves.  Held against jax's own threefry2x32 primitive (the one
# jax.random.bits lowers to), since no test can draw 2^32 words.
M = 0xFFFFFFFF
HIGH = np.array([2**32, 2**32 + 1, 3 * 2**32 + 7, 2**40 + 12345,
                 2**47 - 1, 2**31, M], np.int64)


def _jax_hash(k, x0, x1):
    from jax._src import prng as jprng

    kd = jax.random.key_data(k)
    o0, o1 = jprng.threefry2x32_p.bind(kd[0], kd[1],
                                       jnp.asarray(x0, jnp.uint32),
                                       jnp.asarray(x1, jnp.uint32))
    return np.asarray(o0).astype(np.int64), np.asarray(o1).astype(np.int64)


def test_counter_layout_is_jax_bits_and_split():
    k = jax.random.fold_in(jax.random.key(9), 4)
    o0, o1 = _jax_hash(k, np.zeros(9, np.int64), np.arange(9))
    assert ((o0 ^ o1) == np.asarray(jax.random.bits(k, (9,), jnp.uint32))
            ).all()
    assert (np.stack([o0, o1], -1) == _data(jax.random.split(k, 9))).all()


def test_hash_and_bits_at_with_a_high_counter_word_bit_equal():
    k = jax.random.fold_in(jax.random.key(9), 4)
    tk = key_from_jax(jax.random.key_data(k))
    o0, o1 = _jax_hash(k, HIGH >> 32, HIGH & M)
    g0, g1 = prng.threefry2x32(tk[0], tk[1], torch.from_numpy(HIGH >> 32),
                               torch.from_numpy(HIGH & M))
    assert (g0.numpy() == o0).all() and (g1.numpy() == o1).all()
    assert (prng.bits_at(tk, torch.from_numpy(HIGH)).numpy()
            == (o0 ^ o1)).all()
    # bits_at over the low counters is bits, and split's pairs are the hash
    assert (prng.bits_at(tk, torch.arange(1001)).numpy()
            == np.asarray(jax.random.bits(k, (1001,), jnp.uint32))).all()
    assert (prng.split(tk, 5).numpy() == _data(jax.random.split(k, 5))).all()


@pytest.mark.parametrize("data", [0, 7, 2**31 - 1, 2**31, 2**32 - 1])
def test_fold_in_bit_equal(data):
    k = jax.random.fold_in(jax.random.key(3), 1)
    tk = key_from_jax(jax.random.key_data(k))
    want = _data(jax.random.fold_in(k, np.uint32(data)))
    assert (prng.fold_in(tk, data).numpy() == want).all()
    assert (prng.fold_in(tk, torch.tensor([data])).numpy()[0] == want).all()


def _prng_calls(k):
    idx = torch.arange(5, device=k.device)
    return {"split": lambda: prng.split(k, 3),
            "bits": lambda: prng.bits(k, (4,)),
            "fold_in": lambda: prng.fold_in(k, 5),
            "bits_at": lambda: prng.bits_at(k, idx),
            "threefry2x32": lambda: prng.threefry2x32(
                k[..., 0], k[..., 1], idx, idx)}


@pytest.mark.parametrize("name", ["split", "bits", "fold_in", "bits_at",
                                  "threefry2x32"])
def test_cpu_tensors_take_the_plain_version(name, monkeypatch):
    def no_launch(*a, **kw):
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(prng, "_hash_launch", no_launch)
    monkeypatch.setattr(prng, "_counter_launch", no_launch)
    before = prng.THREEFRY_LAUNCHES
    got = _prng_calls(prng.key(5))[name]()
    assert prng.THREEFRY_LAUNCHES == before
    k = jax.random.key(5)
    want = {"split": lambda: jax.random.split(k, 3),
            "bits": lambda: jax.random.bits(k, (4,), jnp.uint32),
            "fold_in": lambda: jax.random.fold_in(k, 5),
            "bits_at": lambda: jax.random.bits(k, (5,), jnp.uint32),
            "threefry2x32": lambda: _jax_hash(k, np.arange(5),
                                              np.arange(5))}[name]()
    if name == "threefry2x32":
        assert all((g.numpy() == w).all() for g, w in zip(got, want))
    else:
        want = _data(want) if name in ("split", "fold_in") else \
            np.asarray(want).astype(np.int64)
        assert (got.numpy() == want).all()


@pytest.mark.parametrize("name", ["split", "bits", "fold_in", "bits_at",
                                  "threefry2x32"])
def test_meta_tensors_raise(name):
    k = prng.key(5).to("meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        _prng_calls(k)[name]()


# T1's one-launch argument packing.  The wrappers hand the kernel one
# descriptor (the output's shape; for k0, k1, x0, x1 a kind, a pointer or a
# value, and strides aligned to the output).  _FakeT1 stands in for the
# built library on CPU tensors: it reads the descriptor as the kernel does
# (prng_kernel.cu's Kind), through the pointers into the tensors' memory,
# hashes with the plain threefry and writes the output buffer.  So each
# entry's packing is held against jax.random, one launch a call.
class _FakeT1:
    def __init__(self, monkeypatch):
        self.calls = 0
        monkeypatch.setattr(prng, "_on", lambda who, dev: True)
        monkeypatch.setattr(prng, "_t1", lambda: self)
        monkeypatch.setattr(prng._build, "stream_ptr", lambda dev: 0)

    @staticmethod
    def _operand(kind, ptr, strides, shape):
        import ctypes
        from numpy.lib.stride_tricks import as_strided

        if kind == prng._VALUE:
            return np.full(shape, ptr & M, np.int64)
        if kind == prng._LAST:
            return np.broadcast_to(np.arange(shape[-1], dtype=np.int64),
                                   shape)
        wide = kind in (prng._INT64, prng._INT64_HI)
        ctype, dtype = ((ctypes.c_int64, np.int64) if wide
                        else (ctypes.c_int32, np.int32))
        extent = 1 + sum((n - 1) * s for n, s in zip(shape, strides))
        buf = np.ctypeslib.as_array((ctype * extent).from_address(ptr))
        size = np.dtype(dtype).itemsize
        v = as_strided(buf, shape, [s * size for s in strides]).astype(
            np.int64)
        return (v >> 32) & M if kind in (prng._INT64_HI,
                                         prng._INT32_HI) else v & M

    def mfcd_threefry(self, desc, ndim, pairs, out, stream):
        import ctypes

        self.calls += 1
        shape = tuple(desc[i] for i in range(ndim))
        ops = []
        for q in range(4):
            o = desc[ndim + q * (ndim + 2):ndim + (q + 1) * (ndim + 2)]
            ops.append(torch.from_numpy(np.array(
                self._operand(o[0], o[1], o[2:], shape))))
        o0, o1 = prng.threefry2x32_reference(*ops)
        got = torch.stack([o0, o1], -1) if pairs else o0 ^ o1
        n = got.numel()
        dst = np.ctypeslib.as_array((ctypes.c_int64 * n).from_address(out))
        dst[:] = got.reshape(-1).numpy()
        return 0


def _datum(form):
    return {"int": 7, "numpy int": np.uint32(2**32 - 3),
            "0-d tensor": torch.tensor(2**31 + 9),
            "int32 tensor": torch.tensor([5, -1, 0], dtype=torch.int32),
            "broadcast tensor": torch.arange(3, dtype=torch.int64)[:, None]
            * 2**31}[form]


@pytest.mark.parametrize("form", ["int", "numpy int", "0-d tensor",
                                  "int32 tensor", "broadcast tensor"])
def test_fold_in_one_launch_packing_bit_equal(form, monkeypatch):
    fake = _FakeT1(monkeypatch)
    jkeys = jax.random.split(jax.random.key(13), 3)
    tkeys = key_from_jax(jax.random.key_data(jkeys))
    data = _datum(form)
    want = jax.vmap(jax.random.fold_in, in_axes=(0, None))
    if isinstance(data, torch.Tensor):
        # the datum broadcasts against the keys' leading dims
        d = data.numpy().astype(np.int64) & M
        kd = np.broadcast_to(_data(jkeys), np.broadcast_shapes(
            d.shape, (3,)) + (2,))
        dd = np.broadcast_to(d, kd.shape[:-1])
        want = np.stack([_data(jax.random.fold_in(
            jax.random.wrap_key_data(jnp.asarray(kd[ix], jnp.uint32)),
            np.uint32(dd[ix]))) for ix in np.ndindex(dd.shape)]).reshape(
                kd.shape)
    else:
        want = _data(want(jkeys, np.uint32(int(data) & M)))
    before = prng.THREEFRY_LAUNCHES
    got = prng.fold_in(tkeys, data)
    assert prng.THREEFRY_LAUNCHES == before + 1 and fake.calls == 1
    assert tuple(got.shape) == want.shape and (got.numpy() == want).all()


@pytest.mark.parametrize("entry", ["split", "bits", "bits scalar",
                                   "bits_at", "threefry2x32",
                                   "strided keys"])
def test_counter_and_hash_one_launch_packing_bit_equal(entry, monkeypatch):
    fake = _FakeT1(monkeypatch)
    jk = jax.random.split(jax.random.key(17), 4)
    tk = key_from_jax(jax.random.key_data(jk))
    idx = HIGH[:5]
    before = prng.THREEFRY_LAUNCHES
    if entry == "split":
        got = prng.split(tk, 5)
        want = np.stack([_data(jax.random.split(k, 5)) for k in jk])
    elif entry == "bits":
        got = prng.bits(tk, (3, 7))
        want = np.stack([np.asarray(jax.random.bits(k, (3, 7), jnp.uint32))
                         for k in jk]).astype(np.int64)
    elif entry == "bits scalar":
        got = prng.bits(tk[1], ())
        want = np.asarray(jax.random.bits(jk[1], (), jnp.uint32)).astype(
            np.int64)
    elif entry == "bits_at":
        got = prng.bits_at(tk[:1], torch.from_numpy(idx))
        o0, o1 = _jax_hash(jk[0], idx >> 32, idx & M)
        want = o0 ^ o1
    elif entry == "threefry2x32":
        x1 = torch.arange(6, dtype=torch.int32).reshape(2, 3)
        got = torch.stack(prng.threefry2x32(
            tk[:2, None, 0], tk[0, 1], torch.tensor(9), x1), -1)
        want = np.stack(np.broadcast_arrays(*prng.threefry2x32_reference(
            tk[:2, None, 0], tk[0, 1], torch.tensor(9),
            x1.to(torch.int64))), -1)
        o0, o1 = _jax_hash(jk[0], np.full(3, 9), np.arange(3))
        assert (want[0, :, 0] == o0).all() and (want[0, :, 1] == o1).all()
    else:   # keys read through non-unit strides: every other row, a view
        wide = torch.stack([tk, tk ^ 5], 1).reshape(8, 2)[::2]
        assert not wide.is_contiguous()
        got = prng.split(wide, 2)
        want = np.stack([_data(jax.random.split(k, 2)) for k in jk])
    assert prng.THREEFRY_LAUNCHES == before + 1 and fake.calls == 1
    assert tuple(got.shape) == want.shape
    assert (got.numpy() == want).all()


# -- sync-free constants (cell 18's sampler and every draw) -----------------

@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (prng._NORMAL_LO, 1.0),
                                   (prng._F32_TINY, 1.0), (-3.5, 2.25),
                                   (0.1, 0.7)])
def test_uniform_number_bounds_stay_on_the_host_with_the_same_bits(
        lo, hi, monkeypatch):
    # every float32 uniform draws: all 2^23 mantissas, against jax's form
    # with the bounds as float32 tensors (which copied them to the card)
    words = torch.arange(2 ** 23, dtype=torch.int64) << 9
    got = prng._uniform_from_bits(words, lo, hi)
    floats = (((words >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
              - 1.0)
    lo_t, hi_t = torch.tensor(lo), torch.tensor(hi)
    want = torch.maximum(lo_t, floats * (hi_t - lo_t) + lo_t)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    made = []
    for name in ("as_tensor", "tensor"):
        orig = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _o=orig, **k: (
            made.append(a), _o(*a, **k))[1])
    prng._uniform_from_bits(words[:8], lo, hi)
    assert made == []


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 4321, 2 ** 32 + 5,
                                  2 ** 40 - 1])
def test_a_key_is_made_on_its_device_with_jaxs_words(seed):
    k = prng.key(seed)
    assert k.dtype == torch.int64 and k.tolist() == [0, seed & prng.M32]
    assert torch.equal(k, torch.tensor([0, seed & prng.M32]))


def test_init_params_scale_is_the_float32_reciprocal_root():
    from mfcd_tpu_torch.models.mf import init_params

    key = prng.split(prng.key(3), 4)
    for d in (1, 2, 3, 8):
        got = init_params(key, 6, 7, d)
        inv = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
        ku, kv = prng.split(key).unbind(-2)
        assert torch.equal(got.U, prng.normal(ku, (6, d)) * inv)
        assert torch.equal(got.V, prng.normal(kv, (7, d)) * inv)
