"""The port's Draft data layer (``mfcd_tpu_torch.data.movielens`` and
``.preferences``) against the JAX package's: the pairwise dataset, both
splits and the dense matrix equal JAX's arrays on seeded inputs and on a
synthetic MovieLens folder; the three preference rules equal JAX's labels,
ties at score 0 included."""

import doctest
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfcd_tpu.data import movielens as jml
from mfcd_tpu.data import preferences as jpref
from mfcd_tpu_torch.data import movielens as tml
from mfcd_tpu_torch.data import preferences as tpref


def _ratings(seed, users=12, movies=30, count=200):
    g = np.random.default_rng(seed)
    return (g.integers(1, users + 1, count), g.integers(1, movies + 1, count),
            g.integers(1, 6, count))


def _write_movielens(folder, seed):
    """u.user / u.item / u.data in MovieLens-100k's formats."""
    users, movies, ratings = _ratings(seed)
    g = np.random.default_rng(seed + 1)
    with open(os.path.join(folder, "u.user"), "w") as f:
        for u in range(1, 13):
            f.write(f"{u}|{20 + u}|{'MF'[u % 2]}|student|{10000 + u}\n")
    with open(os.path.join(folder, "u.item"), "w", encoding="latin-1") as f:
        for mv in range(1, 31):
            genres = "|".join(str(x) for x in g.integers(0, 2, 19))
            f.write(f"{mv}|Movie {mv} (1995)|01-Jan-1995||http://x/{mv}|"
                    f"{genres}\n")
    with open(os.path.join(folder, "u.data"), "w") as f:
        for k, (u, mv, r) in enumerate(zip(users, movies, ratings)):
            f.write(f"{u}\t{mv}\t{r}\t{880000000 + k}\n")


def _same(a, b):
    assert type(a).__name__ == type(b).__name__
    assert a._fields == b._fields and len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1])
def test_pairwise_dataset_and_splits_match(seed):
    users, movies, ratings = _ratings(seed)
    want = jml.create_pairwise_dataset(users, movies, ratings)
    got = tml.create_pairwise_dataset(users, movies, ratings)
    _same(got, want)
    assert set(np.unique(got.preferences)) <= {-1, 1}
    for p_test, split_seed in ((0.1, 1), (0.3, 7)):
        for a, b in zip(tml.split_pairwise_dataset(got, p_test, split_seed),
                        jml.split_pairwise_dataset(want, p_test, split_seed)):
            _same(a, b)

    ds = (np.asarray(movies) - 1, np.asarray(users) - 1,
          np.asarray(ratings, np.float64))
    tds, jds = tml.RatingsDataset(*ds), jml.RatingsDataset(*ds)
    for a, b in zip(tml.split_dataset(tds, 0.2, seed),
                    jml.split_dataset(jds, 0.2, seed)):
        _same(a, b)
        np.testing.assert_array_equal(tml.to_matrix(a, 30, 12),
                                      jml.to_matrix(b, 30, 12))


def test_movielens_folder_loads_and_builds_the_same_dataset(tmp_path):
    _write_movielens(str(tmp_path), 3)
    want = jml.load_movielens_data(str(tmp_path))
    got = tml.load_movielens_data(str(tmp_path))
    for a, b in zip(got, want):
        assert list(a.columns) == list(b.columns)
        assert a.equals(b)
    users, items, ratings = got
    assert (len(users), len(items), len(ratings)) == (12, 30, 200)
    cols = [ratings[c].to_numpy() for c in ("user_id", "movie_id", "rating")]
    _same(tml.create_pairwise_dataset(*cols), jml.create_pairwise_dataset(*cols))
    m = tml.to_matrix(tml.RatingsDataset(cols[1] - 1, cols[0] - 1, cols[2]),
                      30, 12)
    np.testing.assert_array_equal(m, jml.to_matrix(
        jml.RatingsDataset(cols[1] - 1, cols[0] - 1, cols[2]), 30, 12))


def test_movielens_doctests_pass():
    result = doctest.testmod(tml)
    assert result.attempted >= 4 and result.failed == 0


def _factors(seed, n=15, m=20, d=3, b=400):
    g = np.random.default_rng(seed)
    u_mat = g.standard_normal((n, d)).astype(np.float32)
    v_mat = g.standard_normal((m, d)).astype(np.float32)
    u_mat[0] = 0.0                       # user 0 scores every pair 0
    u = g.integers(0, n, b).astype(np.int32)
    i = g.integers(0, m, b).astype(np.int32)
    j = g.integers(0, m, b).astype(np.int32)
    j[:40] = i[:40]                      # i == j: score 0
    return u_mat, v_mat, u, i, j


@pytest.mark.parametrize("rule,kw", [("sigmoid_preference", {}),
                                     ("sigmoid_preference", {"scale": 3.0}),
                                     ("softmax_preference", {}),
                                     ("softmax_preference", {"temp": 0.5}),
                                     ("max_preference", {})])
def test_preference_rules_match(rule, kw):
    arrays = _factors(4)
    want = np.asarray(getattr(jpref, rule)(*map(jnp.asarray, arrays), **kw))
    got = getattr(tpref, rule)(*map(torch.from_numpy, arrays), **kw)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    u = arrays[2]
    ties = (arrays[3] == arrays[4]) | (u == 0)
    assert ties.sum() > 40 and not got.numpy()[ties].any()
    assert 0 < got.numpy().sum() < len(got)
