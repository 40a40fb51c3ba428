"""mfcd_tpu_torch's samplers vs mfcd_tpu's, given the same X.

X comes from the JAX generator and is fed to both packages; keys are the
same threefry keys.  Integer maps of identical tables (random, proximity,
top_k, the PRP decodes, the splits) are bit-equal.  Where a float decides a
selection (the variance and popularity CDFs, the margin window, k-means,
the randomized-SVD norms, the cosine neighbours, the gumbel ``log``), a
value within float32 rounding of a boundary may fall the other way: those
stages are held to at least 99.9 % equal rows here (at these shapes all
rows agree) and the floats behind them to float32 rounding.

Shapes, each reaching one branch of ``sample_and_split`` (named in the
ids): prefix — proximity at n = 4, m = 200 (m >= 2 * 100), top_k and svd
at n = 40, m = 60, p = 0.2; distinct — margin at n = 50, m = 60, p = 0.7,
K = 5 (2 * extra_cap <= t_cap); overdraw with the exclude top-up — every
strategy but random (a prefix there) at n = 24, m = 28, p = 0.4, with a
capped ``[R]`` budget; random at n = 2,200, m = 1,000, whose packed
triplet overflows int32, through the dedup's lexsort branch.  user_similarity's branches are in
``test_torch_user_similarity.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfcd_tpu.core import rng as jrng
from mfcd_tpu.data import btl as jbtl
from mfcd_tpu.genx import generate_x as jgenerate_x
from mfcd_tpu.sampling import prp as jprp
from mfcd_tpu.sampling import strategies as js
from mfcd_tpu_torch.convert import key_from_jax
from mfcd_tpu_torch.core import prng
from mfcd_tpu_torch.core import rng as trng
from mfcd_tpu_torch.data import btl as tbtl
from mfcd_tpu_torch.genx.clusters import kmeans
from mfcd_tpu_torch.ops.linalg import randomized_svd
from mfcd_tpu_torch.sampling import prp as tprp
from mfcd_tpu_torch.sampling import strategies as ts

torch.set_num_threads(1)

R = 2
EXACT = ("random", "proximity", "top_k")


def _setup(n, m, d=2, seed=0):
    """(JAX keys per run, port keys [R, 2], X [R, n, m] numpy)."""
    jck = jrng.config_key(jax.random.key(seed), 1)
    jkeys = jrng.rep_keys(jck, R)
    xs = np.stack([np.asarray(jgenerate_x(jrng.rep_streams(jkeys[r])[
        "x_gen"], n, m, d, "base")) for r in range(R)])
    return jkeys, key_from_jax(jax.random.key_data(jkeys)), xs


def _share_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    if a.size == 0 or a.ndim == 0:
        return float(np.all(a == b))
    return float(np.mean(np.all(a.reshape(a.shape[0], -1)
                                == b.reshape(b.shape[0], -1), axis=1)))


def _check(want, got, exact, what):
    if exact:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=what)
    else:
        assert _share_equal(want, got) >= 0.999, what


def test_gumbel_and_categorical_match_jax():
    """Gumbel words are bit-equal; the float32 ``log`` may differ by an ulp
    (XLA's against torch's), and the argmax over the draws agrees."""
    k = jax.random.fold_in(jax.random.key(3), 5)
    tk = key_from_jax(jax.random.key_data(k))
    np.testing.assert_allclose(prng.gumbel(tk, (40, 30)).numpy(),
                               np.asarray(jax.random.gumbel(k, (40, 30))),
                               rtol=2e-6, atol=1e-6)
    logits = np.random.default_rng(0).normal(size=(200, 30)).astype(
        np.float32)
    want = np.asarray(jax.random.categorical(k, jnp.asarray(logits)))
    got = prng.categorical(tk, torch.from_numpy(logits)).numpy()
    assert np.mean(want == got) >= 0.999
    assert int(prng.randint(tk, (), 0, 37)) == int(
        jax.random.randint(k, (), 0, 37))


def test_masked_choice_equals_dense_categorical():
    """The sparse draw (gumbel words only where the mask is True) picks
    what the dense ``categorical`` over ``where(mask, 0, -1e30)`` picks,
    rows without a True position included."""
    g = torch.Generator().manual_seed(1)
    k = prng.split(prng.split(prng.key(3), 3), 5)               # [3, 5, 2]
    for density in (0.02, 0.3, 1.0):
        mask = torch.rand(3, 5, 40, 30, generator=g) < density
        dense = prng.categorical(k, torch.where(mask, 0.0, -1e30))
        assert torch.equal(prng.masked_uniform_choice(k, mask), dense)


def test_randomized_svd_matches_jax():
    """Singular values, the row norms of U·s and the leading right
    singular subspace (QR column signs may differ) within float32
    rounding."""
    from mfcd_tpu.ops.linalg import randomized_svd as jsvd

    _, tkeys, xs = _setup(30, 40)
    u, s, vt = randomized_svd(torch.from_numpy(xs), 10, tkeys)
    for r in range(R):
        ju, js_, jvt = jsvd(jnp.asarray(xs[r]), 10, jax.random.wrap_key_data(
            jnp.asarray(tkeys[r].numpy(), jnp.uint32)))
        np.testing.assert_allclose(s[r].numpy(), np.asarray(js_), rtol=1e-5,
                                   atol=1e-6)
        un = np.linalg.norm(np.asarray(ju)[:, :2] * np.asarray(js_)[:2],
                            axis=1)
        np.testing.assert_allclose(
            np.linalg.norm((u[r, :, :2] * s[r, :2]).numpy(), axis=1), un,
            rtol=1e-4, atol=1e-5)
        # X has rank d = 2 with equal singular values (a Haar frame): only
        # the span of the leading two right singular vectors is determined.
        proj = lambda v: v[:2].T @ v[:2]
        np.testing.assert_allclose(proj(vt[r].numpy()),
                                   proj(np.asarray(jvt)), atol=1e-5)


def test_kmeans_matches_jax():
    from mfcd_tpu.genx.clusters import kmeans as jkmeans

    jkeys, tkeys, xs = _setup(24, 28)
    labels, centers = kmeans(tkeys, torch.from_numpy(xs).transpose(-1, -2),
                             10)
    for r in range(R):
        jl, jc = jkmeans(jkeys[r], jnp.asarray(xs[r]).T, 10)
        assert np.mean(labels[r].numpy() == np.asarray(jl)) >= 0.999
        np.testing.assert_allclose(centers[r].numpy(), np.asarray(jc),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("disjoint", [True, False])
def test_tables_match_jax_with_ties(disjoint):
    """A fully tied X (every entry 0) takes the lower index first, as
    ``jax.lax.top_k`` does; ``disjoint`` keeps top and bottom apart."""
    x = np.zeros((3, 220), np.float32)
    x[1, 5:50] = 1.0
    top, bot = tprp.proximity_tables(torch.from_numpy(x)[None],
                                     disjoint=disjoint)
    jtop, jbot = jprp.proximity_tables(jnp.asarray(x), disjoint=disjoint)
    np.testing.assert_array_equal(top[0].numpy(), np.asarray(jtop))
    np.testing.assert_array_equal(bot[0].numpy(), np.asarray(jbot))
    np.testing.assert_array_equal(tprp.topk_table(torch.from_numpy(x)[None])
                                  [0].numpy(), np.asarray(jprp.topk_table(
                                      jnp.asarray(x))))
    assert (not disjoint) == bool(np.intersect1d(np.asarray(jtop[0]),
                                                 np.asarray(jbot[0])).size)


def test_svd_tables_and_rank_mask_match_jax():
    """Top sets from the randomized-SVD norms, with the exact-budget rank
    mask from an ``[R]`` budget (``strategies.py:256-262``)."""
    jkeys, tkeys, xs = _setup(40, 60)
    budgets = np.asarray([240, 130], np.int32)
    for budget in (None, budgets):
        tu, ti = ts.svd_tables(tkeys, torch.from_numpy(xs), 240,
                               budget=None if budget is None
                               else torch.from_numpy(budget))
        for r in range(R):
            ju, ji = js.svd_tables(jkeys[r], jnp.asarray(xs[r]), 240,
                                   budget=None if budget is None
                                   else budget[r])
            assert np.mean(tu[r].numpy() == np.asarray(ju)) >= 0.999
            assert np.mean(ti[r].numpy() == np.asarray(ji)) >= 0.999


def test_margin_window_matches_jax():
    _, _, xs = _setup(50, 60)
    budgets = np.asarray([1050, 700], np.int32)
    got_int = ts.margin_window(torch.from_numpy(xs), 2048).numpy()
    got_runs = ts.margin_window(torch.from_numpy(xs),
                                torch.from_numpy(budgets)).numpy()
    for r in range(R):
        np.testing.assert_allclose(
            got_int[r], np.asarray(js.margin_window(jnp.asarray(xs[r]),
                                                    2048)), rtol=1e-6)
        np.testing.assert_allclose(
            got_runs[r], np.asarray(js.margin_window(
                jnp.asarray(xs[r]), jnp.int32(budgets[r]))), rtol=1e-6)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 50.0])
def test_exact_cdf_is_exact_and_batch_invariant(scale):
    """The variance and popularity CDFs: within float32 rounding of the
    exact probabilities and scan, the last entry 1, and a run's rows the
    same bits alone as beside others (on the card torch splits a float
    sum or scan by the row count; the fixed-point sum and scan do not
    depend on it)."""
    w = torch.from_numpy(np.random.default_rng(5).random((5, 700))) * scale
    probs, cdf = ts._exact_cdf(w.to(torch.float32))
    w64 = w.to(torch.float32).to(torch.float64)
    exact = torch.cumsum(w64, dim=-1) / w64.sum(dim=-1, keepdim=True)
    np.testing.assert_allclose(cdf.numpy(), exact.numpy(), rtol=2**-23,
                               atol=0)
    np.testing.assert_allclose(probs.numpy(),
                               (w64 / w64.sum(-1, keepdim=True)).numpy(),
                               rtol=2**-23, atol=0)
    assert torch.all(cdf[:, -1] == 1.0)
    for lo, hi in ((0, 1), (1, 3), (4, 5)):
        part = ts._exact_cdf(w[lo:hi].to(torch.float32))
        assert torch.equal(part[0], probs[lo:hi])
        assert torch.equal(part[1], cdf[lo:hi])


def test_popularity_probs_match_jax():
    for method in ("zipf", "exponential", "uniform"):
        np.testing.assert_allclose(
            ts.popularity_probs(28, method, 1.5).numpy(),
            np.asarray(js.popularity_probs(28, method, 1.5)), rtol=1e-6,
            atol=1e-9)
    with pytest.raises(ValueError, match="popularity method"):
        ts.popularity_probs(28, "nope")
    assert ts.top_k_value(60) == js.top_k_value(60) == 6
    assert ts.estimate_k(1000) == js.estimate_k(1000)
    assert ts.svd_rank(240, 40, 60) == js.svd_rank(240, 40, 60)


PROPOSALS = [
    # (name, n, m, num_triplets, m_draw, port call, JAX call)
    ("random", 24, 28, 134, 700,
     lambda k, x, md, t: ts.propose_random(k, x, md),
     lambda k, x, md, t: js.propose_random(k, x, md)),
    ("proximity", 24, 28, 134, 700,
     lambda k, x, md, t: ts.propose_proximity(k, x, md),
     lambda k, x, md, t: js.propose_proximity(k, x, md)),
    ("top_k", 24, 28, 134, 700,
     lambda k, x, md, t: ts.propose_top_k(k, x, md),
     lambda k, x, md, t: js.propose_top_k(k, x, md)),
    ("margin", 24, 28, 134, 700,
     lambda k, x, md, t: ts.propose_margin(k, x, md, t),
     lambda k, x, md, t: js.propose_margin(k, x, md, t)),
    ("margin-prp-distinct", 50, 60, 1050, 1500,
     lambda k, x, md, t: ts.propose_margin(k, x, md, t, prp_distinct=True,
                                           slot_offset=900),
     lambda k, x, md, t: js.propose_margin(k, x, md, t, prp_distinct=True,
                                           slot_offset=900)),
    ("variance", 24, 28, 134, 700,
     lambda k, x, md, t: ts.propose_variance(k, x, md),
     lambda k, x, md, t: js.propose_variance(k, x, md)),
    ("popularity-zipf", 24, 28, 134, 700,
     lambda k, x, md, t: ts.propose_popularity(k, x, md),
     lambda k, x, md, t: js.propose_popularity(k, x, md)),
    ("popularity-exponential", 24, 28, 134, 700,
     lambda k, x, md, t: ts.propose_popularity(k, x, md, "exponential", 0.3),
     lambda k, x, md, t: js.propose_popularity(k, x, md, "exponential",
                                               0.3)),
    ("cluster", 24, 28, 134, 700,
     lambda k, x, md, t: ts.propose_cluster(k, x, md),
     lambda k, x, md, t: js.propose_cluster(k, x, md)),
    ("svd", 40, 60, 240, 1200,
     lambda k, x, md, t: ts.propose_svd(k, x, md, t),
     lambda k, x, md, t: js.propose_svd(k, x, md, t)),
    ("user_similarity-direct", 24, 28, 134, 700,
     lambda k, x, md, t: ts.propose_user_similarity(k, x, md, t),
     lambda k, x, md, t: js.propose_user_similarity(k, x, md, t)),
]


@pytest.mark.parametrize("case", PROPOSALS, ids=[c[0] for c in PROPOSALS])
def test_propose_matches_jax(case):
    name, n, m, t, md, tcall, jcall = case
    jkeys, tkeys, xs = _setup(n, m)
    cands, valid = tcall(tkeys, torch.from_numpy(xs), md, t)
    assert cands.dtype == torch.int32 and cands.shape == (R, md, 3)
    exact = name.split("-")[0] in EXACT
    for r in range(R):
        jc, jv = jcall(jkeys[r], jnp.asarray(xs[r]), md, t)
        _check(jc, cands[r].numpy(), exact, name)
        _check(jv, valid[r].numpy(), exact, name)


BRANCHES = [
    # (id, strategy, n, m, t_cap, extra_cap, budget, extra_budget, kind)
    ("prefix-proximity-n4-m200", "proximity", 4, 200, 128, 512, 80, 492,
     "prefix"),
    ("prefix-top_k-n40-m60", "top_k", 40, 60, 256, 512, 240, 476, "prefix"),
    ("prefix-svd-n40-m60", "svd", 40, 60, 240, 476, None, None, "prefix"),
    ("distinct-margin-n50-m60", "margin", 50, 60, 2048, 0, 1050, None,
     "distinct"),
] + [
    (f"overdraw-{s}-n24-m28", s, 24, 28, 256, 512, 134, 486, None)
    for s in ("proximity", "top_k", "margin", "variance", "popularity",
              "cluster")
] + [("overdraw-svd-n24-m28", "svd", 24, 28, 134, 486, None, None, None),
      # n * m * m >= 2^31: no prefix map, and the dedup's lexsort branch.
      ("overdraw-lexsort-random-n2200-m1000", "random", 2200, 1000, 1024,
       512, 550, 445, None)]


@pytest.mark.parametrize("case", BRANCHES, ids=[c[0] for c in BRANCHES])
def test_sample_and_split_branches_match_jax(case):
    """Each branch of ``sample_and_split`` at the shape that reaches it,
    with the exact budgets as ``[R]`` tensors below the capacities; the
    compacted sample too (``keep_sample``)."""
    _, strategy, n, m, t_cap, extra_cap, budget, extra_budget, kind = case
    assert tprp.fast_path_kind(strategy, n, m, t_cap, extra_cap) == kind
    jkeys, _, xs = _setup(n, m, seed=3)
    tst = trng.rep_streams(trng.rep_keys(trng.config_key(prng.key(3), 1), R))
    runs = lambda v: None if v is None else torch.full((R,), v,
                                                       dtype=torch.int32)
    got = tbtl.sample_and_split(tst, torch.from_numpy(xs), t_cap, extra_cap,
                                strategy, budget=runs(budget),
                                extra_budget=runs(extra_budget),
                                keep_sample=True)
    exact = strategy in EXACT
    for r in range(R):
        st = jrng.rep_streams(jkeys[r])
        want = jbtl.sample_and_split(st, jnp.asarray(xs[r]), t_cap,
                                     extra_cap, strategy, budget=budget,
                                     extra_budget=extra_budget,
                                     keep_sample=True)
        for f in ("train", "val", "test"):
            _check(getattr(want, f), getattr(got, f)[r].numpy(), exact, f)
        for f in ("train_count", "val_count", "test_count"):
            a, b = int(getattr(want, f)), int(getattr(got, f)[r])
            assert a == b if exact else abs(a - b) <= 0.005 * max(a, 1), f
        _check(want.sample.triplets, got.sample.triplets[r].numpy(), exact,
               "sample")
        assert int(want.sample.count) == int(got.sample.count[r]) or (
            not exact)


SAMPLE_TRIPLETS = [
    # (strategy, n, m, num_triplets, budget): the prefix map, margin's
    # PRP-distinct branch and the overdraw branch without an exclude set.
    ("random", 24, 28, 256, 134), ("proximity", 4, 200, 128, 80),
    ("top_k", 40, 60, 256, 240), ("svd", 40, 60, 240, None),
    ("margin", 50, 60, 2048, 1050), ("variance", 24, 28, 256, 134),
    ("popularity", 24, 28, 256, 134), ("cluster", 24, 28, 256, 134),
    ("user_similarity", 24, 28, 134, None),
]


@pytest.mark.parametrize("case", SAMPLE_TRIPLETS,
                         ids=[c[0] for c in SAMPLE_TRIPLETS])
def test_sample_triplets_matches_jax(case):
    from mfcd_tpu.sampling import sample_triplets as jsample
    from mfcd_tpu_torch.sampling import sample_triplets as tsample

    strategy, n, m, t, budget = case
    jkeys, tkeys, xs = _setup(n, m, seed=6)
    got = tsample(tkeys, torch.from_numpy(xs), t, strategy=strategy,
                  budget=None if budget is None
                  else torch.full((R,), budget, dtype=torch.int32))
    for r in range(R):
        want = jsample(jkeys[r], jnp.asarray(xs[r]), t, strategy=strategy,
                       budget=budget)
        _check(want.triplets, got.triplets[r].numpy(), strategy in EXACT,
               strategy)
        assert int(want.count) == int(got.count[r])


def test_build_dataset_matches_jax():
    """The whole dataset build at exact capacities (sample, split, top-up,
    labels) for a constrained strategy, hard labels with K = 3."""
    from mfcd_tpu.core.config import RunConfig as JConfig
    from mfcd_tpu_torch.core.config import RunConfig as TConfig

    kw = dict(n=24, m=28, d=2, p=0.4, s=3.0, K=3, strategy="cluster")
    jkeys, _, xs = _setup(24, 28, seed=7)
    tst = trng.rep_streams(trng.rep_keys(trng.config_key(prng.key(7), 1), R))
    got = tbtl.build_dataset(tst, torch.from_numpy(xs), TConfig(**kw))
    for r in range(R):
        want = jbtl.build_dataset(jrng.rep_streams(jkeys[r]),
                                  jnp.asarray(xs[r]), JConfig(**kw))
        _check(want.sample.triplets, got.sample.triplets[r].numpy(), False,
               "sample")
        for split in ("train", "val", "test"):
            a, b = getattr(want, split), getattr(got, split)
            for f in ("u", "i", "j", "valid", "count"):
                _check(getattr(a, f), getattr(b, f)[r].numpy(), False,
                       f"{split}.{f}")
            # Votes: equal unless a uniform draw lies within rounding of
            # its BTL probability (``test_torch_sampling.py``).
            assert np.mean(np.asarray(a.z) == b.z[r].numpy()) >= 0.99
