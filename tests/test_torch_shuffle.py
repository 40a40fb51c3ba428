"""mfcd_tpu_torch.ops.shuffle vs mfcd_tpu.ops.shuffle: indices bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfcd_tpu.ops import shuffle as J
from mfcd_tpu_torch.convert import key_from_jax
from mfcd_tpu_torch.core import prng
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
        ts = T.mix_stream(ts, tkeys, e,
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


# The rewritten plain mix_stream (S2's composed source map, one gather per
# array) against JAX over the whole [R, S] arrays, pad slots included, for
# epochs 0 to 2 * period (fresh and cheap epochs), per-run counts with one
# of 2^(k-1) + 1 (the longest walks), tile widths none (bs = 4) and 8 to
# 128, and packs of 1, 2 and 4 arrays.
PERIOD = 4
STREAM_COUNTS = np.array([2049, 4096, 3001], np.int32)   # k = 12, S = 4096


def _jax_epoch(period, tile_w, k_bits):
    def one(arrs, kk, c, e):
        return J.mix_stream(arrs, jax.random.fold_in(kk, e), e, c, k_bits,
                            period=period, tile_w=tile_w)
    return jax.jit(jax.vmap(one, in_axes=(0, 0, 0, None)))


@pytest.mark.parametrize("arrays", [1, 2, 4])
@pytest.mark.parametrize("tile_w", [None, 8, 16, 32, 64, 128])
def test_mix_stream_whole_arrays_bit_equal(tile_w, arrays):
    s_len, k_bits, r = 4096, 12, len(STREAM_COUNTS)
    g = np.random.default_rng(tile_w or 4)
    arrs = [g.integers(-2**31, 2**31, (r, s_len)).astype(np.int32)
            for _ in range(arrays - 1)]
    arrs.append(g.standard_normal((r, s_len)).astype(np.float32))
    keys = jax.random.split(jax.random.key(11), r)
    tkeys = key_from_jax(jax.random.key_data(keys))
    step = _jax_epoch(PERIOD, tile_w, k_bits)
    js = tuple(jnp.asarray(a) for a in arrs)
    ts = tuple(torch.from_numpy(a.copy()) for a in arrs)
    for e in range(2 * PERIOD + 1):
        js = step(js, keys, jnp.asarray(STREAM_COUNTS), e)
        ts = T.mix_stream(ts, tkeys, e, torch.from_numpy(STREAM_COUNTS),
                          k_bits, period=PERIOD, tile_w=tile_w)
        for a, b in zip(js, ts):
            assert b.numpy().dtype == np.asarray(a).dtype
            assert (np.asarray(a).view(np.int32)
                    == b.numpy().view(np.int32)).all(), (tile_w, e)


# K = 50's width without its size: k = 22, a count of 4,000,000, a sample of
# 4,096 slots (the map is pointwise), each walk mode.
WIDE_SAMPLE = np.sort(np.random.default_rng(22).choice(
    1 << 22, 4096, replace=False)).astype(np.int32)


@pytest.mark.parametrize("mode", ["capped", "exact", "inverse"])
def test_prp_at_k22_on_a_sample_bit_equal(mode):
    count, k_bits = 4_000_000, 22
    fn = {"capped": "epoch_permutation", "exact": "exact_prefix_permutation",
          "inverse": "exact_prefix_permutation_inverse"}[mode]
    want = np.asarray(getattr(J, fn)(KEY, jnp.asarray(WIDE_SAMPLE), count,
                                     k_bits))
    got = getattr(T, fn)(TKEY, torch.from_numpy(WIDE_SAMPLE), count, k_bits)
    assert got.dtype == torch.int32 and (want == got.numpy()).all()
    if mode != "capped":
        inside = WIDE_SAMPLE < count
        assert (got.numpy()[inside] < count).all()


def _shuffle_calls(dev):
    key = TKEY.to(dev)
    slots = torch.arange(64, device=dev)
    arrs = (torch.arange(2 * 64, dtype=torch.int32,
                         device=dev).reshape(2, 64),)
    keys = torch.stack([key, key])
    return {
        "epoch_permutation": lambda: T.epoch_permutation(key, slots, 50, 6),
        "exact_prefix_permutation":
            lambda: T.exact_prefix_permutation(key, slots, 50, 6),
        "exact_prefix_permutation_inverse":
            lambda: T.exact_prefix_permutation_inverse(key, slots, 50, 6),
        "mix_stream": lambda: T.mix_stream(
            arrs, keys, 1, torch.tensor([50, 60], device=dev), 6,
            period=4, tile_w=8),
    }


SHUFFLE_FNS = ["epoch_permutation", "exact_prefix_permutation",
               "exact_prefix_permutation_inverse", "mix_stream"]


@pytest.mark.parametrize("name", SHUFFLE_FNS)
def test_cpu_tensors_take_the_plain_version(name, monkeypatch):
    def no_launch(*a, **kw):
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(T, "_prp_launch", no_launch)
    monkeypatch.setattr(T, "_mix_stream_launch", no_launch)
    before = (T.PRP_LAUNCHES, T.SHUFFLE_LAUNCHES)
    out = _shuffle_calls("cpu")[name]()
    assert (T.PRP_LAUNCHES, T.SHUFFLE_LAUNCHES) == before
    if name == "mix_stream":
        assert sorted(out[0][0, :50].tolist()) == list(range(50))
    elif name != "exact_prefix_permutation_inverse":
        assert sorted(out[:50].tolist()) == list(range(50))


@pytest.mark.parametrize("name", SHUFFLE_FNS)
def test_plain_versions_use_only_the_plain_threefry(name, monkeypatch):
    """The ``*_reference`` functions derive their keys and constants with
    prng's plain threefry, so on the card they launch no kernel and stay
    independent of ``threefry.cuh``: prng's dispatching entries refused,
    each gives the bits it gives with them."""
    want = _shuffle_calls("cpu")[name]()

    def refused(*a, **kw):
        raise AssertionError("a plain version reached prng's dispatch")

    for fn in ("threefry2x32", "fold_in", "split", "bits", "bits_at"):
        monkeypatch.setattr(prng, fn, refused)
    for fn in SHUFFLE_FNS:
        monkeypatch.setattr(T, fn, getattr(T, fn + "_reference"))
    got = _shuffle_calls("cpu")[name]()
    for a, b in zip(want if name == "mix_stream" else (want,),
                    got if name == "mix_stream" else (got,)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", SHUFFLE_FNS)
def test_meta_tensors_raise(name):
    with pytest.raises(ValueError, match="unsupported device meta"):
        _shuffle_calls("meta")[name]()


class _FakeLaunch:
    """Stands in for the built library and the stream, on CPU tensors:
    records each entry's arguments (the wrappers' shape logic runs here;
    the kernels only on the card)."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(T, "_library", lambda: self)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda dev=None: type("S", (), {"cuda_stream": 0}))
        monkeypatch.setattr(T._build, "stream_ptr", lambda dev: 0)

    def mfcd_prp(self, *args):
        assert len(args) == len(T._S1_ARGS)   # the entry's C signature
        self.calls.append(("prp",) + args)
        return 0

    def mfcd_mix_stream(self, *args):
        assert len(args) == len(T._S2_ARGS)
        self.calls.append(("mix",) + args)
        return 0


def _split_calls():
    """S1's two calls in ``prp_splits`` as the sampler makes them at R = 4
    (``sampling/prp.py:303-306``): the split key ``[2]`` shared by every
    run over int32 slot rows, with the runs' int32 budget broadcast from
    one value (``data/btl.py``'s ``runs``); then each run's sample key, a
    column of the runs' key tree, over the inverse walk's int32 output with
    the domain size as an int (k = 30)."""
    y = torch.arange(4 * 64, dtype=torch.int32).reshape(4, 64) % 50
    count = torch.as_tensor(50, dtype=torch.int32).expand(4)
    sample_keys = prng.split_reference(prng.key(3), 4 * 9).reshape(4, 9, 2)
    return ((TKEY, y, count), (sample_keys[:, 2], y, 999_000_000))


# (keys, slots, count) -> (rows, n, key row, slot row, slot bytes, count row,
# count bytes, count value, out shape) handed to S1.
PRP_FORMS = {
    "one-key": lambda: ((TKEY, torch.arange(40), 30),
                        (1, 40, 0, 0, 8, 0, 0, 30, (40,))),
    "shared-slots": lambda: (
        (torch.stack([TKEY, TKEY ^ 1, TKEY ^ 2]), torch.arange(40),
         torch.tensor([30, 31, 32])), (3, 40, 2, 0, 8, 1, 8, 0, (3, 40))),
    "row-slots": lambda: (
        (torch.stack([TKEY, TKEY ^ 1, TKEY ^ 2]),
         torch.arange(120).reshape(3, 40), 30),
        (3, 40, 2, 40, 8, 0, 0, 30, (3, 40))),
    "split-inverse": lambda: (_split_calls()[0],
                              (4, 64, 0, 64, 4, 0, 4, 0, (4, 64))),
    "split-exact": lambda: (_split_calls()[1],
                            (4, 64, 18, 64, 4, 0, 0, 999_000_000, (4, 64))),
}


@pytest.mark.parametrize("case", list(PRP_FORMS))
def test_prp_wrapper_shapes_its_launch(case, monkeypatch):
    # Slots or a key that serve every row are passed once (row stride 0),
    # and S1 reads every argument where the caller holds it: the key words,
    # the slots (their own type) and a count tensor by pointer, an int
    # count by value.  The only tensor the wrapper makes is the output.
    fake = _FakeLaunch(monkeypatch)
    (key, slots, count), want = PRP_FORMS[case]()
    before = T.PRP_LAUNCHES
    out = T._prp_launch("t", key, slots, count, 6, T._EXACT)
    (_, keys, key_row, cnt, count_row, count_bytes, count_value, sl,
     slot_row, slot_bytes, dst, rows, n, mode, k_bits, _), = fake.calls
    assert (rows, n, key_row, slot_row, slot_bytes, count_row, count_bytes,
            count_value, tuple(out.shape)) == want
    assert (keys, sl, dst) == (key.data_ptr(), slots.data_ptr(),
                               out.data_ptr())
    assert cnt == (count.data_ptr() if count_bytes else None)
    assert (mode, k_bits, out.dtype) == (T._EXACT, 6, torch.int32)
    assert T.PRP_LAUNCHES == before + 1


def test_prp_wrapper_rejects_what_s1_does_not_take(monkeypatch):
    fake = _FakeLaunch(monkeypatch)
    slots = torch.arange(40)
    for args, match in (((TKEY[:1], slots, 30, 6), "key"),
                        ((TKEY, slots[0], 30, 6), "slots"),
                        ((TKEY, slots, 30, 33), "k_bits"),
                        ((TKEY, slots.reshape(4, 10),
                          torch.tensor([1, 2, 3]), 6), "shape"),
                        ((TKEY.to("meta"), slots, 30, 6), "share")):
        with pytest.raises(ValueError, match=match):
            T._prp_launch("t", *args, T._EXACT)
    assert fake.calls == []
    # empty: no launch
    assert T._prp_launch("t", TKEY, slots[:0], 30, 6,
                         T._EXACT).shape == (0,)
    assert fake.calls == []


def test_mix_stream_wrapper_rejects_what_s2_does_not_take(monkeypatch):
    fake = _FakeLaunch(monkeypatch)
    keys = torch.stack([TKEY, TKEY ^ 1])
    a = torch.zeros((2, 64), dtype=torch.int32)
    count = torch.tensor([50, 60], dtype=torch.int32)
    call = lambda arrs, k=keys, c=count, kb=6: T._mix_stream_launch(
        arrs, k, 1, c, kb, 4, 8)
    for bad, match in (((a, a, a), "1, 2 or 4"),
                       ((a.to(torch.int64),), "32-bit"),
                       ((a.t().contiguous().t(),), "32-bit"),
                       ((a, a[:1]), "shapes")):
        with pytest.raises(ValueError, match=match):
            call(bad)
    with pytest.raises(ValueError, match="key"):
        call((a,), k=keys[:1])
    with pytest.raises(ValueError, match="count"):
        call((a,), c=count[:1])
    with pytest.raises(ValueError, match="k_bits"):
        call((a,), kb=33)
    assert fake.calls == []
    outs = call((a, a.float()))
    (_, _, key_row, _, *ptrs, arrays, rows, s_len, epoch, period, k_bits,
     tile_w, folded, _), = fake.calls
    assert (key_row, arrays, rows, s_len, epoch, period, k_bits, tile_w,
            folded) == (2, 2, 2, 64, 1, 4, 6, 8, 0)
    assert ptrs[2:4] == [None, None] and ptrs[6:] == [None, None]
    assert [o.dtype for o in outs] == [torch.int32, torch.float32]


# S2's quad kernel (ops/csrc/shuffle_kernel.cu, mix_stream_kernel) modelled
# on the host: a fresh epoch gathers each quad of 4 output slots' words; a
# cheap epoch walks each full tile once (lane l of a warp's group of T
# tiles), hands each quad of output words its tile's source through the
# group (the warp shuffle), and reads the quad's 4 rotated source words from
# the one or two aligned 16-byte quads that hold them, shifted into place,
# or word by word where the rotation wraps inside the quad.  Shapes with S
# not a multiple of 4 take the per-slot kernel, the plain map.
def _tiles_per_group(rows, s_len, tile_w, sms=132):
    """mfcd_mix_stream's T, tiles a warp, on a card of ``sms`` SMs."""
    tw = tile_w or 128
    tiles = -(-s_len // tw)
    per = 128 // tw if 0 < tile_w < 128 else 1
    while tile_w and per < 32 and rows * -(-tiles // (2 * per)) >= sms * 32:
        per *= 2
    return per


def _quad_model(keys, epoch, count, arrays, k_bits, period, tile_w, folded,
                per):
    rows, s_len = arrays[0].shape
    fresh = period == 1 or epoch % period == 0
    outs = [torch.empty_like(a) for a in arrays]
    words = [a.view(torch.int32).to(torch.int64) for a in arrays]
    for r in range(rows):
        k = keys[r] if folded else prng.fold_in_reference(keys[r], epoch)
        k_prp, k_rho, k_tile = prng.split_reference(k, 3).unbind(-2)
        c = int(count[r])
        if s_len % 4 or fresh:
            src = T._source_map(k, epoch, c, s_len, k_bits, period,
                                tile_w or None, folded=True)
        else:
            rho = int(prng.bits_reference(k_rho, ())) % max(c, 1)
            lim = c - rho
            w_shift = tile_w.bit_length() - 1 if tile_w else 7
            tw = 1 << w_shift
            full = c >> w_shift if tile_w else 0
            tile_src = torch.arange(-(-s_len // tw))
            if full:   # one walk a tile
                tile_src[:full] = T.epoch_permutation_reference(
                    k_tile, torch.arange(full), full,
                    max(k_bits - w_shift, 1)).to(torch.int64)
            w = torch.arange(0, s_len, 4)
            group = per << w_shift
            st = tile_src[(w // group) * per + ((w % group) >> w_shift)]
            p = (st << w_shift) + (w & (tw - 1))
            src0 = torch.where(p + 3 < lim, p + rho, p + rho - c)
            wrap = (p < lim) & (p + 3 >= lim)
            off = src0 & 3
            base = src0 - off
            # the second aligned quad lies inside the row where it is read
            assert (base[~wrap & (off > 0)] + 7 < s_len).all()
            q4 = torch.arange(4)
            pick = (base[:, None] + off[:, None] + q4).clamp(0, s_len - 1)
            word = p[:, None] + q4
            word = torch.where(word < lim, word + rho, word + rho - c)
            src = torch.where(wrap[:, None], word, pick).reshape(-1)
        for o, a in zip(outs, words):
            o.view(torch.int32)[r] = a[r][src].to(torch.int32)
    return outs


class _FakeS2:
    """The S2 entry on CPU tensors: reads the wrapper's arguments through
    the pointers and writes the quad model's words to the outputs."""

    def __init__(self, monkeypatch):
        self.calls = 0
        monkeypatch.setattr(prng, "_on", lambda who, dev: True)
        monkeypatch.setattr(T, "_library", lambda: self)
        monkeypatch.setattr(T._build, "stream_ptr", lambda dev: 0)

    @staticmethod
    def _view(ptr, n, ctype=None):
        import ctypes

        ctype = ctype or ctypes.c_int32
        return torch.from_numpy(np.ctypeslib.as_array(
            (ctype * n).from_address(ptr)))

    def mfcd_mix_stream(self, keys, key_row, count, *args):
        import ctypes

        self.calls += 1
        ins, dsts = args[:4], args[4:8]
        (arrays, rows, s_len, epoch, period, k_bits, tile_w, folded,
         _) = args[8:]
        kv = self._view(keys, (rows - 1) * key_row + 2, ctypes.c_int64)
        k = torch.stack([kv[r * key_row:r * key_row + 2]
                         for r in range(rows)])
        cnt = self._view(count, rows)
        arrs = [self._view(ins[q], rows * s_len).reshape(rows, s_len)
                for q in range(arrays)]
        per = _tiles_per_group(rows, s_len, tile_w)
        for q, o in enumerate(_quad_model(k, epoch, cnt, arrs, k_bits,
                                          period, tile_w, folded, per)):
            self._view(dsts[q], rows * s_len)[:] = o.reshape(-1)
        return 0


def _rho_keys(targets, counts, epoch, seed=0):
    """Epochs keys (one a run) whose cheap epoch ``epoch`` rotates run r by
    ``targets[r]`` (rho = bits(k_rho) % count), found among split(key(seed),
    4096)."""
    cands = prng.split_reference(prng.key(seed), 4096)
    k_rho = prng.split_reference(prng.fold_in_reference(cands, epoch),
                                 3)[:, 1]
    rho_word = prng.bits_reference(k_rho, ())
    out = []
    for want, c in zip(targets, counts):
        hit = torch.nonzero(rho_word % max(c, 1) == want)[0, 0]
        out.append(cands[hit])
    return torch.stack(out)


def _jax_stream(arrays, keys, epoch, counts, k_bits, period, tile_w):
    jk = jax.random.wrap_key_data(jnp.asarray(keys.numpy(), jnp.uint32))
    one = lambda a, kk, c: J.mix_stream(
        a, jax.random.fold_in(kk, epoch), epoch, c, k_bits, period=period,
        tile_w=tile_w)
    return jax.vmap(one)(tuple(jnp.asarray(a.numpy()) for a in arrays), jk,
                         jnp.asarray(counts.numpy()))


# (s_len, tile_w, counts, k_bits, rho targets): every rho the quad copy
# aligns differently (0, 1, 3 and tile_w - 1), ragged lengths (S a multiple
# of tile_w, as JAX's tile reshape needs, but not of a warp's 128 words or
# of a group; S not a multiple of 4: the per-slot kernel), counts 0, 1 and
# S, and k_bits 1, 17 and 32.
QUAD_CASES = {
    "aligned": (256, 8, [200, 201, 130, 256], 8, [0, 1, 3, 7]),
    "ragged-group": (8 * 37, 8, [295, 296, 177, 160], 9, [0, 1, 3, 7]),
    "ragged-tile-4": (4 * 75, 4, [299, 300, 177, 160], 9, [0, 1, 3, 3]),
    "ragged-quad": (301, 0, [300, 301, 150, 99], 9, [0, 1, 3, 7]),
    "counts-0-1-S": (128, 32, [0, 1, 128, 127], 7, [0, 0, 3, 31]),
    "no-tiles": (200, 0, [199, 200, 3, 150], 8, [0, 1, 2, 149]),
    "k-bits-1": (64, 8, [2, 1, 64, 60], 1, [0, 0, 1, 3]),
    "k-bits-17": (512, 64, [500, 512, 300, 64], 17, [0, 1, 3, 63]),
    "k-bits-32": (256, 128, [255, 256, 200, 130], 32, [0, 1, 3, 127]),
}


@pytest.mark.parametrize("arrays", [1, 2, 4])
@pytest.mark.parametrize("case", list(QUAD_CASES))
def test_quad_decomposition_bit_equal(case, arrays, monkeypatch):
    """The wrapper's S2 launch through the quad model, a fresh and a cheap
    epoch (and period 1: fresh every epoch), keys folded by the wrapper's
    caller and not, against mix_stream_reference and JAX's mix_stream."""
    s_len, tile_w, counts, k_bits, rhos = QUAD_CASES[case]
    fake = _FakeS2(monkeypatch)
    counts_t = torch.tensor(counts, dtype=torch.int32)
    g = np.random.default_rng(s_len + arrays)
    arrs = [torch.from_numpy(g.integers(-2**31, 2**31, (4, s_len)).astype(
        np.int32)) for _ in range(arrays - 1)]
    arrs.append(torch.from_numpy(g.standard_normal((4, s_len)).astype(
        np.float32)))
    for epoch, period in ((1, 4), (4, 4), (2, 1)):
        keys = _rho_keys(rhos, counts, epoch)
        want = T.mix_stream_reference(arrs, keys, epoch, counts_t, k_bits,
                                      period=period, tile_w=tile_w or None)
        jax_want = _jax_stream(arrs, keys, epoch, counts_t, k_bits, period,
                               tile_w or None)
        for a, b in zip(jax_want, want):
            assert (np.asarray(a).view(np.int32)
                    == b.view(torch.int32).numpy()).all()
        calls = fake.calls
        got = T.mix_stream(arrs, keys, epoch, counts_t, k_bits,
                           period=period, tile_w=tile_w or None)
        folded = T.mix_stream(arrs, prng.fold_in_reference(keys, epoch),
                              epoch, counts_t, k_bits, period=period,
                              tile_w=tile_w or None, folded=True)
        assert fake.calls == calls + 2
        for a, b, c in zip(got, folded, want):
            assert torch.equal(a.view(torch.int32), c.view(torch.int32))
            assert torch.equal(b.view(torch.int32), c.view(torch.int32))


@pytest.mark.parametrize("per", [2, 4, 8, 16, 32])
def test_quad_decomposition_any_tiles_per_group(per):
    """The group of T tiles a warp walks is an indexing of the tiles: every
    T from the least (128 words) to 32 gives the plain version's bits."""
    s_len, tile_w, counts, k_bits, rhos = QUAD_CASES["k-bits-17"]
    counts_t = torch.tensor(counts, dtype=torch.int32)
    arrs = [torch.arange(4 * s_len, dtype=torch.int32).reshape(4, s_len)]
    keys = _rho_keys(rhos, counts, 1)
    want = T.mix_stream_reference(arrs, keys, 1, counts_t, k_bits, period=4,
                                  tile_w=tile_w)
    got = _quad_model(keys, 1, counts_t, arrs, k_bits, 4, tile_w, False, per)
    assert torch.equal(got[0], want[0])


def test_tiles_per_group_follows_the_stream():
    """T grows with the tiles of the launch: the least at the canonical
    shape (every SM's warps busy), 16 at hard K = 50's 2^22 slots, 32 at
    the sweep chunk's 120 runs."""
    assert _tiles_per_group(4, 131_072, 64) == 2
    assert _tiles_per_group(2, 1 << 22, 64) == 16
    assert _tiles_per_group(120, 131_072, 64) == 32
    assert _tiles_per_group(4, 131_072, 0) == 1
    assert _tiles_per_group(1, 256, 8) == 16


# S1's kernel (ops/csrc/shuffle_kernel.cu, prp_quads) modelled on the host,
# reading the wrapper's arguments through its pointers as the kernel does:
# rows on the grid's y (a loop past 65,535), a row's mixing words derived a
# block (thread t < 6 hashes word t, threads 0-2 of the inverse walk invert
# theirs by Newton), quads of 4 slots walked in step (a quad stops when its 4 have landed, the
# capped walk after 48 steps, then its strided fallback slot by slot; the
# exact and inverse walks, where the count is under 7/8 of 2^k, hand a
# warp's last slots out one to a lane once at most 32 are out), the last
# quad's slots past n walked from 0 and not stored, and 16-byte loads only
# where n % 4 == 0 and the rows are aligned.  Every output word is written
# once.
M32 = 0xFFFFFFFF


def _np_view(ptr, count, ctype):
    import ctypes

    return np.ctypeslib.as_array((ctype * max(count, 1)).from_address(ptr))


def _mixer(keys, k_bits, inverse):
    """Each row's (muls, adds, invs) as a block derives them: word t from
    thread t's bits_at, each inverse from thread t's Newton steps."""
    idx = torch.arange(6)
    words = prng.bits_at_reference(keys[:, None, :], idx).numpy().astype(
        np.uint64)                                             # [rows, 6]
    muls, adds = words[:, :3] | 1, words[:, 3:]
    invs = muls.copy()
    if inverse:
        for _ in range(5):
            invs = (invs * ((2 - muls * invs) & M32)) & M32
    return muls, adds, invs


def _np_step(x, muls, adds, invs, k_bits, inverse):
    mask = (1 << k_bits) - 1
    shift = max(k_bits // 2, 1)
    col = lambda a, r: a[:, r].reshape((-1,) + (1,) * (x.ndim - 1))
    if not inverse:
        for r in range(3):
            x = (x * col(muls, r)) & mask
            x = x ^ (x >> shift)
            x = (x + col(adds, r)) & mask
        return x
    passes = -(-k_bits // shift) - 1
    assert passes <= 2      # the kernel's unrolled loop
    for r in range(2, -1, -1):
        y = (x - col(adds, r)) & mask
        z = y
        for it in range(2):
            if it < passes:
                z = y ^ (z >> shift)
        x = (z * col(invs, r)) & mask
    return x


def _popc(a):
    """Set bits of each word of ``a`` (uint64, below 2^32)."""
    a = a.astype(np.uint64)
    a = a - ((a >> np.uint64(1)) & np.uint64(0x5555555555555555))
    a = ((a & np.uint64(0x3333333333333333))
         + ((a >> np.uint64(2)) & np.uint64(0x3333333333333333)))
    a = (a + (a >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    return (a * np.uint64(0x0101010101010101)) >> np.uint64(56)


def _nth_set(v, j):
    """The kernel's nth_set: the position of the j-th set bit of v."""
    pos = np.zeros_like(v)
    for w in (16, 8, 4, 2, 1):
        w = np.uint64(w)
        low = _popc(v & ((np.uint64(1) << w) - np.uint64(1)))
        go = j >= low
        j = np.where(go, j - low, j)
        v = np.where(go, v >> w, v)
        pos = np.where(go, pos + w, pos)
    return pos


def _walk_quads(v, c, mixer, k_bits, mode):
    """The kernel's walk4 over quads ``v [rows, Q, 4]`` (uint64 words),
    counts ``c [rows]``: a warp's 32 lanes walk quads together; an
    uncapped walk in a row whose count is under 7/8 of 2^k hands the
    warp's last slots out (at most 32) one to a lane, by the places the
    ballots give them.  Returns (the walked words, the warps that handed
    slots out)."""
    inverse = mode == T._INVERSE
    step = lambda x: _np_step(x, *mixer, k_bits, inverse)
    rows, quads = v.shape[:2]
    c = c.reshape(-1, 1, 1)
    c1 = np.maximum(c, 1)
    if mode == T._CAPPED:
        x = step(v)
        live = (x >= c).any(-1)
        for _ in range(48):
            if not live.any():
                break
            y = step(x)
            x = np.where(live[..., None] & (x >= c), y, x)
            live = (x >= c).any(-1)
        fallback = ((v * mixer[0][:, None, None, 0]) & M32) % c1
        return np.where(x >= c, fallback, x), 0
    # a warp's lanes; where a row has few quads, as many as can receive a
    # slot (4 a quad), to keep the model small
    width = min(32, 4 * quads)
    warps = -(-quads // width)
    has = np.arange(width * warps).reshape(warps, width) < quads
    pad = np.zeros((rows, width * warps, 4), np.uint64)
    pad[:, :quads] = v
    x = step(np.where(pad < c1, pad, 0)).reshape(rows, warps, width, 4)
    c1 = c1.reshape(-1, 1, 1, 1)
    has = np.broadcast_to(has[None, :, :, None], x.shape)
    comp = 8 * c1[:, :, 0, 0] < 7 * (1 << k_bits)   # [rows, 1]
    handed = 0
    while True:
        out = has & (x >= c1)
        total = out.sum((2, 3))
        if not total.any():
            break
        more = np.where(comp, total > 32, total > 0)
        if more.any():
            y = step(x)
            x = np.where(more[..., None, None] & (x >= c1), y, x)
        hand = comp & (total > 0) & ~more   # these warps hand slots out
        if hand.any():
            handed += int(hand.sum())
            lanes = np.arange(width, dtype=np.uint64)
            ballot = (out.astype(np.uint64) << lanes[:, None]).sum(2)
            count = out.sum(2)            # [rows, warps, 4]
            base = np.cumsum(count, -1) - count
            p = np.arange(width)[None, None, :, None]
            ends = (base + count)[:, :, None, :]
            kind = (p >= ends).sum(-1)          # [rows, warps, 32]
            got = p[..., 0] < total[..., None]
            kk = np.minimum(kind, 3)
            j = (p[..., 0] - np.take_along_axis(base, kk, -1))
            src = np.where(got, _nth_set(np.take_along_axis(ballot, kk, -1),
                                         np.where(got, j, 0).astype(
                                             np.uint64)), p[..., 0])
            y = x[np.arange(rows)[:, None, None], np.arange(warps)[
                None, :, None], src.astype(np.int64), kk]
            y = np.where(got, y, 0)
            cw = c1[..., 0]
            while (got & (y >= cw)).any():
                y = np.where(got & (y >= cw),
                             _np_step(y, *mixer, k_bits, inverse), y)
            # back: lane l's slot k from the lane at its place
            below = (np.uint64(1) << lanes) - np.uint64(1)
            place = base[:, :, None, :] + _popc(
                ballot[:, :, None, :] & below[:, None]).astype(np.int64)
            back = np.take_along_axis(
                y[..., None].repeat(4, -1), np.minimum(place, width - 1), 2)
            x = np.where(hand[..., None, None] & out, back, x)
            has = has & ~hand[..., None, None]
    return x.reshape(rows, width * warps, 4)[:, :quads], handed


class _FakeS1:
    """The S1 entry on CPU tensors: reads the wrapper's arguments through
    the pointers and writes the model's words to the output."""

    def __init__(self, monkeypatch):
        self.vec, self.handed = [], 0
        monkeypatch.setattr(prng, "_on", lambda who, dev: True)
        monkeypatch.setattr(T, "_library", lambda: self)
        monkeypatch.setattr(T._build, "stream_ptr", lambda dev: 0)

    def mfcd_prp(self, keys, key_row, count, count_row, count_bytes,
                 count_value, slots, slot_row, slot_bytes, out, rows, n,
                 mode, k_bits, stream):
        import ctypes

        assert len(T._S1_ARGS) == 15   # the parameters above
        r = np.arange(rows)
        kv = _np_view(keys, (rows - 1) * key_row + 2, ctypes.c_int64)
        key = torch.from_numpy(np.stack([kv[r * key_row],
                                         kv[r * key_row + 1]], -1))
        if count_bytes:
            cv = _np_view(count, (rows - 1) * count_row + 1,
                          {4: ctypes.c_int32, 8: ctypes.c_int64}[
                              count_bytes])
            c = cv[r * count_row].astype(np.int64) & M32
        else:
            c = np.full(rows, count_value & M32, np.int64)
        sv = _np_view(slots, (rows - 1) * slot_row + n,
                      {4: ctypes.c_int32, 8: ctypes.c_int64}[slot_bytes])
        vals = (sv[r[:, None] * slot_row + np.arange(n)].astype(np.int64)
                & M32).astype(np.uint64)
        c = c.astype(np.uint64)
        self.vec.append(n % 4 == 0 and (slots | out) % 16 == 0
                        and slot_row * slot_bytes % 16 == 0)
        quads = -(-n // 4)
        dst = _np_view(out, rows * n, ctypes.c_int32).reshape(rows, n)
        written = np.zeros((rows, n), np.int64)
        gy = min(rows, 65535)           # the grid's rows
        for y0 in range(0, rows, gy):   # blockIdx.y's row loop
            rs = np.arange(y0, min(y0 + gy, rows))
            mixer = _mixer(key[rs], k_bits, mode == T._INVERSE)
            pad = np.zeros((len(rs), 4 * quads), np.uint64)
            pad[:, :n] = vals[rs]   # vec or slot by slot: the same words
            got, handed = _walk_quads(pad.reshape(len(rs), quads, 4),
                                      c[rs], mixer, k_bits, mode)
            self.handed += handed
            got = got.reshape(len(rs), -1)[:, :n]
            dst[rs] = (got & M32).astype(np.uint32).view(np.int32)
            written[rs] += 1
        assert (written == 1).all()
        return 0


def _jax_prp(mode, keys, slots, counts, k_bits):
    """JAX's function of ``mode`` over rows: one key [2] for all (counts
    broadcast per row) or a key a row (vmapped)."""
    fn = {T._CAPPED: J.epoch_permutation, T._EXACT: J.exact_prefix_permutation,
          T._INVERSE: J.exact_prefix_permutation_inverse}[mode]
    kd = jax.random.wrap_key_data(jnp.asarray(
        keys.numpy().astype(np.uint32)))
    s = jnp.asarray(slots.numpy().astype(np.int64).astype(np.uint32))
    c = jnp.asarray((np.asarray(counts, np.int64) & M32).astype(np.uint32))
    if keys.dim() == 1:
        return np.asarray(fn(kd, s, c.reshape(c.shape + (1,) * (
            s.ndim - c.ndim)), k_bits))
    return np.asarray(jax.vmap(lambda k, sl, cc: fn(k, sl, cc, k_bits))(
        kd, s, jnp.broadcast_to(c, s.shape[:1])))


def _s1_case(name):
    """(keys, slots, count as passed, counts per row, k_bits) of an edge
    case; slots at or above the count and negative ones included."""
    keys = lambda r, seed=0: prng.split_reference(prng.key(seed), r)
    if name == "k-bits-1":        # counts 0, 1, 2^k; S % 4 = 2
        slots = torch.tensor([[0, 1], [1, 0], [0, -1]], dtype=torch.int32)
        counts = torch.tensor([0, 1, 2], dtype=torch.int32)
        return keys(3), slots, counts, counts, 1
    if name == "k-bits-32":       # S % 4 = 3, counts near 2^32 (int64)
        g = np.random.default_rng(32)
        slots = torch.from_numpy(g.integers(-2**31, 2**31, (2, 39)))
        counts = torch.tensor([2**32 - 1, 3_000_000_000])
        return keys(2, 1), slots, counts, counts, 32
    if name == "ragged":          # counts 0, 1, 3, 2^k; S % 4 = 1
        slots = (torch.arange(4 * 37, dtype=torch.int32).reshape(4, 37)
                 - 5) * 3
        counts = torch.tensor([0, 1, 3, 128], dtype=torch.int32)
        return keys(4, 2), slots, counts, counts, 7
    if name == "shared-key-int32-rows":   # prp_splits' inverse call
        slots = torch.arange(4 * 64, dtype=torch.int32).reshape(4, 64) % 61
        count = torch.as_tensor(50, dtype=torch.int32).expand(4)
        return TKEY, slots, count, count, 6
    if name == "int-count-k30":   # prp_splits' exact call (prp_indices)
        slots = torch.arange(4 * 64, dtype=torch.int32).reshape(4, 64) * 7
        return keys(4, 3), slots, 999_000_000, [999_000_000] * 4, 30
    if name == "unaligned-int64":  # off 16-byte alignment, strided rows
        buf = torch.arange(3 * 70 + 1, dtype=torch.int64) - 9
        slots = buf[1:].reshape(3, 70)[:, :64]
        counts = torch.tensor([40, 64, 33])
        return keys(3, 4), slots, counts, counts, 6
    # rows past one grid row (65,535): a key and a count a row
    r = 65_540
    slots = torch.arange(r * 3, dtype=torch.int32).reshape(r, 3) % 17
    counts = (torch.arange(r, dtype=torch.int32) % 16) + 1
    return keys(r, 5), slots, counts, counts, 4


S1_CASES = ["k-bits-1", "k-bits-32", "ragged", "shared-key-int32-rows",
            "int-count-k30", "unaligned-int64", "rows-past-the-grid"]
S1_MODES = {"capped": T._CAPPED, "exact": T._EXACT, "inverse": T._INVERSE}


@pytest.mark.parametrize("mode", list(S1_MODES))
@pytest.mark.parametrize("case", S1_CASES)
def test_s1_decomposition_bit_equal(case, mode, monkeypatch):
    """The wrapper's S1 launch through the kernel's model against the
    plain version and JAX's function."""
    mode = S1_MODES[mode]
    keys, slots, count, counts, k_bits = _s1_case(case)
    fn = {T._CAPPED: "epoch_permutation", T._EXACT: "exact_prefix_permutation",
          T._INVERSE: "exact_prefix_permutation_inverse"}[mode]
    want = _jax_prp(mode, keys, slots, counts, k_bits)
    plain = getattr(T, fn + "_reference")(keys, slots, count, k_bits)
    assert (plain.numpy() == want).all()
    fake = _FakeS1(monkeypatch)
    got = T._prp_launch("t", keys, slots, count, k_bits, mode)
    assert got.dtype == torch.int32 and (got.numpy() == want).all()
    # the exact and inverse walks hand a warp's last slots out (not in
    # "ragged", whose rows start almost every slot from 0 and land together,
    # nor at a count above 7/8 of 2^k)
    if case not in ("ragged", "int-count-k30"):
        assert (fake.handed > 0) == (mode != T._CAPPED)
    # 16-byte loads where n % 4 == 0 and the rows are aligned
    vec = {"shared-key-int32-rows": True, "int-count-k30": True}
    assert fake.vec == [vec.get(case, False)]


def test_prp_splits_reaches_s1_with_its_arguments_as_held(monkeypatch):
    """``prp_splits``' two S1 calls, recorded as chip_smoke [14c] records
    them: the split key [2] shared by the runs over int32 rows with the
    budget broadcast from one int32 (row stride 0), then the runs' sample
    keys over the inverse walk's int32 output with the domain size as an
    int; through the kernels' model, the splits equal the plain run's."""
    from mfcd_tpu_torch.sampling import prp as P
    from mfcd_tpu_torch.scripts import ab_shuffle_kernels as AB

    n, m, r, t_cap = 20, 25, 4, 256
    dom = P.prp_domain_size(n, m)
    train_cap, val_cap = int(0.8 * t_cap), int(0.1 * t_cap)
    args = (prng.split_reference(prng.key(9), r), prng.key(4), dom,
            lambda idx: P.decode_random(idx, n, m), t_cap, train_cap,
            val_cap, t_cap - train_cap - val_cap,
            torch.as_tensor(200, dtype=torch.int32).expand(r))
    want = P.prp_splits(*args)
    _FakeS1(monkeypatch)
    got = []
    calls = AB.record_prp_calls("cpu", {
        "splits": lambda: got.append(P.prp_splits(*args))})["splits"]
    forms = [AB.describe(*c) for c in calls]
    assert [(f["fn"], f["key"], f["slots"], f["slots_dtype"], f["count"],
             f["k_bits"]) for f in forms] == [
        ("exact_prefix_permutation_inverse", [2], [r, t_cap], "int32",
         "int32 [4] stride [0]", 8),
        ("exact_prefix_permutation", [r, 2], [r, t_cap], "int32",
         f"int {dom}", (dom - 1).bit_length())]
    for a, b in zip(want, got[0]):
        assert torch.equal(a, b)
