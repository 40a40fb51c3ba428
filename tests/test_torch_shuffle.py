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
        self.calls.append(("prp",) + args)
        return 0

    def mfcd_mix_stream(self, *args):
        self.calls.append(("mix",) + args)
        return 0


@pytest.mark.parametrize("case", ["one-key", "shared-slots", "row-slots"])
def test_prp_wrapper_shapes_its_launch(case, monkeypatch):
    # (keys, slots, count) -> (rows, n, slot row stride) handed to S1:
    # slots that broadcast over the keys are passed once (stride 0).
    fake = _FakeLaunch(monkeypatch)
    keys = torch.stack([TKEY, TKEY ^ 1, TKEY ^ 2])
    args, want = {
        "one-key": ((TKEY, torch.arange(40), 30), (1, 40, 0, (40,))),
        "shared-slots": ((keys, torch.arange(40), torch.tensor([30, 31, 32])),
                         (3, 40, 0, (3, 40))),
        "row-slots": ((keys, torch.arange(120).reshape(3, 40), 30),
                      (3, 40, 40, (3, 40))),
    }[case]
    before = T.PRP_LAUNCHES
    out = T._prp_launch("t", *args, 6, T._EXACT)
    (_, _, _, _, slot_row, _, rows, n, mode, k_bits, _), = fake.calls
    assert (rows, n, slot_row, tuple(out.shape)) == want
    assert (mode, k_bits, out.dtype) == (T._EXACT, 6, torch.int32)
    assert T.PRP_LAUNCHES == before + 1


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
