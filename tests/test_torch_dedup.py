"""mfcd_tpu_torch.sampling.dedup vs mfcd_tpu.sampling.dedup.

The same candidates, made from a seed with numpy over small (u, i, j)
domains so that duplicates are frequent, go through both packages; the
port takes all runs at once on its leading run axis, JAX one run at a
time.  Every output is an integer function of its inputs, so winners,
buffers and counts are bit-equal.
"""

import jax
import numpy as np
import pytest
import torch

from mfcd_tpu.sampling import dedup as jd
from mfcd_tpu.sampling import strategies as js
from mfcd_tpu_torch.convert import key_from_jax
from mfcd_tpu_torch.sampling import dedup as td
from mfcd_tpu_torch.sampling import strategies as ts

torch.set_num_threads(1)

R, N, M, MC, EX = 3, 12, 9, 400, 150
PACKED = (N, M)             # n * m * m < 2^31: hash or packed sort
UNPACKED = (3000, 1000)     # n * m * m >= 2^31: the lexsort branch


def _inputs(seed):
    g = np.random.default_rng(seed)
    cands = np.stack([g.integers(0, N, (R, MC)), g.integers(0, M, (R, MC)),
                      g.integers(0, M, (R, MC))], axis=-1).astype(np.int32)
    valid = (cands[..., 1] != cands[..., 2]) & (g.random((R, MC)) < 0.9)
    ex = np.stack([g.integers(0, N, (R, EX)), g.integers(0, M, (R, EX)),
                   g.integers(0, M, (R, EX))], axis=-1).astype(np.int32)
    ex_valid = g.random((R, EX)) < 0.7
    return cands, valid, ex, ex_valid


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


METHODS = [("hash", PACKED), ("sort", PACKED), ("sort", None),
           ("sort", UNPACKED)]


@pytest.mark.parametrize("exclude", [False, True], ids=["plain", "exclude"])
@pytest.mark.parametrize("method,nm", METHODS,
                         ids=["hash", "sort-packed", "sort-lexsort",
                              "sort-lexsort-unpackable"])
def test_first_occurrence_winners_bit_equal(method, nm, exclude):
    cands, valid, ex, ex_valid = _inputs(1)
    kw = dict(nm_shape=nm, method=method)
    got = td.first_occurrence_winners(
        _t(cands), _t(valid),
        exclude=_t(ex) if exclude else None,
        exclude_valid=_t(ex_valid) if exclude else None, **kw).numpy()
    for r in range(R):
        want = np.asarray(jd.first_occurrence_winners(
            cands[r], valid[r], exclude=ex[r] if exclude else None,
            exclude_valid=ex_valid[r] if exclude else None, **kw))
        np.testing.assert_array_equal(got[r], want)
    # An exclude set without a mask vetoes all of its rows.
    if exclude:
        got = td.first_occurrence_winners(_t(cands), _t(valid),
                                          exclude=_t(ex), **kw).numpy()
        want = np.asarray(jd.first_occurrence_winners(
            cands[0], valid[0], exclude=ex[0], **kw))
        np.testing.assert_array_equal(got[0], want)


def test_hash_needs_a_packable_shape():
    cands, valid, _, _ = _inputs(2)
    with pytest.raises(ValueError, match="packable"):
        td.first_occurrence_winners(_t(cands), _t(valid),
                                    nm_shape=UNPACKED, method="hash")
    with pytest.raises(ValueError, match="packable"):
        jd.first_occurrence_winners(cands[0], valid[0], nm_shape=UNPACKED,
                                    method="hash")


@pytest.mark.parametrize("budget", [None, "runs"])
def test_select_unique_and_compact_bit_equal(budget):
    cands, valid, ex, ex_valid = _inputs(3)
    target = 96
    budgets = np.asarray([96, 70, 41], np.int32)
    b = None if budget is None else _t(budgets)
    got = td.select_unique(_t(cands), _t(valid), target, exclude=_t(ex),
                           exclude_valid=_t(ex_valid), nm_shape=PACKED,
                           budget=b)
    keep = td.first_occurrence_winners(_t(cands), _t(valid),
                                       nm_shape=PACKED)
    comp = td._compact(_t(cands), keep, target, budget=b)
    for r in range(R):
        jb = None if budget is None else int(budgets[r])
        want = jd.select_unique(cands[r], valid[r], target, exclude=ex[r],
                                exclude_valid=ex_valid[r], nm_shape=PACKED,
                                budget=jb)
        np.testing.assert_array_equal(got.triplets[r].numpy(),
                                      np.asarray(want.triplets))
        assert int(got.count[r]) == int(want.count)
        np.testing.assert_array_equal(got.valid[r].numpy(),
                                      np.asarray(want.valid))
        jkeep = jd.first_occurrence_winners(cands[r], valid[r],
                                            nm_shape=PACKED)
        wc = jd._compact(cands[r], jkeep, target, budget=jb)
        np.testing.assert_array_equal(comp.triplets[r].numpy(),
                                      np.asarray(wc.triplets))
        assert int(comp.count[r]) == int(wc.count)


def _caps(t_cap):
    train = int(0.8 * t_cap)
    val = int(0.1 * t_cap)
    return train, val, t_cap - train - val


@pytest.mark.parametrize("budget", [None, "runs"])
def test_winners_to_splits_bit_equal(budget):
    cands, valid, _, _ = _inputs(4)
    t_cap = 128
    budgets = np.asarray([128, 100, 65], np.int32)
    key = jax.random.key(42)
    win = np.stack([np.asarray(jd.first_occurrence_winners(
        cands[r], valid[r], nm_shape=PACKED)) for r in range(R)])
    b = None if budget is None else _t(budgets)
    got, count = td.winners_to_splits(_t(cands), _t(win), t_cap,
                                      *_caps(t_cap),
                                      key=key_from_jax(jax.random.key_data(
                                          key)), budget=b)
    for r in range(R):
        want, wcount = jd.winners_to_splits(
            cands[r], win[r], t_cap, *_caps(t_cap), key=key,
            budget=None if budget is None else int(budgets[r]))
        assert int(count[r]) == int(wcount)
        for f in want._fields:
            np.testing.assert_array_equal(getattr(got, f)[r].numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)


def test_ranks_to_splits_and_split_triplets_bit_equal():
    g = np.random.default_rng(5)
    t_cap = 200
    cands = g.integers(0, 50, (R, t_cap, 3)).astype(np.int32)
    counts = np.asarray([200, 151, 7], np.int32)
    rank = np.broadcast_to(np.arange(t_cap, dtype=np.int32), (R, t_cap))
    kept = rank < counts[:, None]
    key = jax.random.key(42)
    got = td.ranks_to_splits(_t(cands), _t(kept), _t(rank.copy()),
                             _t(counts), t_cap, *_caps(t_cap),
                             key=key_from_jax(jax.random.key_data(key)))
    perm = np.random.default_rng(42).permutation(t_cap).astype(np.int32)
    sample = td.TripletSet(_t(cands), _t(counts))
    got_split = td.split_triplets(sample, _t(perm), *_caps(t_cap))
    for r in range(R):
        want = jd.ranks_to_splits(cands[r], kept[r], rank[r], counts[r],
                                  t_cap, *_caps(t_cap), key=key)
        want_split = jd.split_triplets(
            jd.TripletSet(cands[r], np.int32(counts[r])), perm,
            *_caps(t_cap))
        for f in want._fields:
            np.testing.assert_array_equal(getattr(got, f)[r].numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
            np.testing.assert_array_equal(
                getattr(got_split, f)[r].numpy(),
                np.asarray(getattr(want_split, f)), err_msg=f)


def test_overdraw_plans_match():
    from mfcd_tpu.sampling import STRATEGIES

    for n, m, t in [(24, 28, 256), (1000, 1000, 131072), (50, 60, 2048),
                    (20, 300, 2001), (3, 4, 10)]:
        for strategy in STRATEGIES:
            for method in ("zipf", "exponential", "uniform"):
                assert (ts.plan_overdraw(strategy, t, n, m, method, 1.5)
                        == js.plan_overdraw(strategy, t, n, m, method, 1.5))
        for args in [(t, n * m, 1.0, 1.3, 512, None),
                     (t, 10 * t, 0.5, 2.0, 0, 3 * t)]:
            assert td.overdraw_size(*args) == jd.overdraw_size(*args)
    with pytest.raises(ValueError, match="Unknown triplet sampling"):
        ts.plan_overdraw("nope", 10, 3, 4)
