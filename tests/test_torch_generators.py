"""mfcd_tpu_torch's ground-truth generators vs mfcd_tpu's, the generation
term of the port's per-run bytes, and every generation mode end to end.

The same threefry keys go through both packages, one JAX call per run.
Integer intermediates (the Watts–Strogatz adjacency, the ``structured`` and
``hierarchical`` assignments) are bit-equal; floats agree to rtol 1e-5 /
atol 1e-6 x max|X| (the normals' erfinv and the QR round differently in
the last bits).  ``svd``'s factors agree with their signs (the CPU's
LAPACK picks the same ones on both sides) and X to 1e-4.  The ``clustered``
and ``gmm`` labels agree except for points within float32 rounding of a
tie: at most 0.1 % of rows may differ (none do at these shapes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfcd_tpu
from mfcd_tpu.core import rng as jrng
from mfcd_tpu.genx import GENERATION_MODES as JMODES
from mfcd_tpu.genx import clusters as jclusters
from mfcd_tpu.genx import generate_x as jgenerate_x
from mfcd_tpu.genx import generators as jgenerators
from mfcd_tpu.genx import graphs as jgraphs
import mfcd_tpu_torch
from mfcd_tpu_torch.convert import key_from_jax
from mfcd_tpu_torch.core import prng
from mfcd_tpu_torch.core.config import RunConfig
from mfcd_tpu_torch.genx import GENERATION_MODES, clusters, generate_x
from mfcd_tpu_torch.genx import generators, graphs
from mfcd_tpu_torch.sweep import batched

torch.set_num_threads(1)

N, M, D, R = 24, 30, 3, 2
PAIR_RTOL, PAIR_ATOL = 1e-5, 1e-6     # atol x max|X|
SVD_ATOL = 1e-4
LABEL_SHARE = 0.999


@pytest.fixture(scope="module")
def keys():
    """(JAX keys per run, the same keys for the port ``[R, 2]``)."""
    jkeys = jrng.rep_keys(jrng.config_key(jax.random.key(0), 1), R)
    return jkeys, key_from_jax(jax.random.key_data(jkeys))


def _jax_runs(fn, jkeys):
    """``fn(key)`` per JAX key, stacked over the run axis (tuples too)."""
    outs = [fn(jkeys[r]) for r in range(R)]
    if isinstance(outs[0], tuple):
        return tuple(np.stack([np.asarray(o[i]) for o in outs])
                     for i in range(len(outs[0])))
    return np.stack([np.asarray(o) for o in outs])


def _close(got, want, rtol=PAIR_RTOL, atol=PAIR_ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()))


def _share(a, b) -> float:
    return float(np.mean(np.asarray(a) == np.asarray(b)))


@pytest.mark.parametrize("mode", JMODES)
def test_generate_x_matches_jax(keys, mode):
    jkeys, tkeys = keys
    want = _jax_runs(lambda k: jgenerate_x(k, N, M, D, mode), jkeys)
    got = generate_x(tkeys, N, M, D, mode)
    assert got.shape == (R, N, M) and got.dtype == torch.float32
    if mode == "svd":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SVD_ATOL)
    else:
        _close(got, want)


def test_modes_and_unknown_mode():
    assert GENERATION_MODES == JMODES
    with pytest.raises(ValueError, match="Unknown generation"):
        generate_x(prng.key(0)[None], N, M, D, "nope")


@pytest.mark.parametrize("n", [N, 300])
def test_watts_strogatz_adjacency_bit_equal(keys, n):
    """Bit-equal adjacency, rewired edges that collide collapsed alike; the
    graph is symmetric, self-loop free and rewired away from the ring."""
    jkeys, tkeys = keys
    want = _jax_runs(lambda k: jgraphs.watts_strogatz_adjacency(k, n),
                     jkeys)
    got = graphs.watts_strogatz_adjacency(tkeys, n)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    ring = np.zeros((n, n), bool)
    for off in (1, 2):
        ring[np.arange(n), (np.arange(n) + off) % n] = True
    ring |= ring.T
    for r in range(R):
        assert (want[r] == want[r].T).all() and not want[r].diagonal().any()
        assert (want[r] != ring).any()
    # One key without a run axis gives the same graph.
    np.testing.assert_array_equal(
        graphs.watts_strogatz_adjacency(tkeys[1], n).numpy(), want[1])


@pytest.mark.parametrize("mode,count,size", [("structured", 5, M),
                                             ("hierarchical", 5, N)])
def test_cluster_assignments_bit_equal(keys, mode, count, size):
    """The ``randint`` assignments from the generator's second key, and
    its (U, V) pair, whose rows gather by them."""
    jkeys, tkeys = keys
    jfn = getattr(jgenerators, f"generate_{mode}")
    tfn = getattr(generators, f"generate_{mode}")
    want = _jax_runs(lambda k: jax.random.randint(
        jax.random.split(k, 4)[1], (size,), 0, count), jkeys)
    got = prng.randint(prng.split(tkeys, 4)[:, 1], (size,), 0, count)
    np.testing.assert_array_equal(got.numpy(), want)
    ju, jv = _jax_runs(lambda k: jfn(k, N, M, D), jkeys)
    tu, tv = tfn(tkeys, N, M, D)
    _close(tu, ju)
    _close(tv, jv)


def test_svd_factors_match_with_their_signs(keys):
    jkeys, tkeys = keys
    ju, jv = _jax_runs(lambda k: jgenerators.generate_svd(k, N, M, D), jkeys)
    tu, tv = generators.generate_svd(tkeys, N, M, D)
    for got, want in ((tu, ju), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_low_rank_explicit_rank(keys):
    jkeys, tkeys = keys
    want = _jax_runs(lambda k: jgenerate_x(k, N, M, D, "low_rank", rank=1),
                     jkeys)
    got = generate_x(tkeys, N, M, D, "low_rank", rank=1)
    _close(got, want)
    assert int(torch.linalg.matrix_rank(got[0])) == 1


@pytest.mark.parametrize("mode,kwargs", [
    ("correlated", {"correlation_factor": 0.5}),
    ("temporal", {"timesteps": 2}),
    ("social", {"social_influence": 0.9}),
])
def test_pair_kwargs_pass_through(keys, mode, kwargs):
    jkeys, tkeys = keys
    want = _jax_runs(lambda k: jgenerate_x(k, N, M, D, mode, **kwargs),
                     jkeys)
    got = generate_x(tkeys, N, M, D, mode, **kwargs)
    _close(got, want)
    assert not torch.allclose(got, generate_x(tkeys, N, M, D, mode))


def test_graph_at_d2_zero_width_pads(keys):
    """``d_eff = d = 2``: the noise pads of U and V are zero-width draws."""
    jkeys, tkeys = keys
    ju, jv = _jax_runs(lambda k: jgraphs.generate_graph(k, N, M, 2), jkeys)
    tu, tv = graphs.generate_graph(tkeys, N, M, 2)
    assert tu.shape == (R, N, 2) and tv.shape == (R, M, 2)
    assert prng.normal(tkeys, (N, 0)).shape == (R, N, 0)
    _close(tu, ju)
    _close(tv, jv)
    want = _jax_runs(lambda k: jgenerate_x(k, N, M, 2, "graph"), jkeys)
    _close(generate_x(tkeys, N, M, 2, "graph"), want)


def test_clustered_kmeans_labels_match(keys):
    """The item k-means inside ``clustered``: labels from the same base X
    and key."""
    jkeys, tkeys = keys
    kx, kc = prng.split(tkeys).unbind(-2)
    x = generators.generate_base(kx, N, M, D)
    labels, _ = clusters.kmeans(kc, x.transpose(-1, -2), 5)
    for r in range(R):
        jkx, jkc = jax.random.split(jkeys[r])
        jx = jgenerators.generate_base(jkx, N, M, D)
        jl, _ = jclusters.kmeans(jkc, jx.T, 5)
        assert _share(labels[r].numpy(), jl) >= LABEL_SHARE


def test_gmm_fit_predict_matches_jax(keys):
    """Labels and means of the EM fit on the generator's item points; a key
    without a run axis gives the same X."""
    jkeys, tkeys = keys
    pts = prng.normal(prng.split(tkeys, 4)[:, 1], (M, D))
    labels, means = clusters.gmm_fit_predict(tkeys, pts, 5)
    for r in range(R):
        jl, jm = jclusters.gmm_fit_predict(jkeys[r], jnp.asarray(
            pts[r].numpy()), 5)
        assert _share(labels[r].numpy(), jl) >= LABEL_SHARE
        np.testing.assert_allclose(means[r].numpy(), np.asarray(jm),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        generate_x(tkeys[1], N, M, D, "gmm").numpy(),
        generate_x(tkeys, N, M, D, "gmm")[1].numpy())


def _jax_log_prob(points, weights, means, covs):
    """``mfcd_tpu/genx/clusters.py:98-112`` (a closure there) on one run."""
    d = points.shape[1]
    chol = jnp.linalg.cholesky(covs)
    diff = points[None, :, :] - means[:, None, :]
    sol = jax.vmap(lambda L, b: jax.scipy.linalg.solve_triangular(
        L, b.T, lower=True))(chol, diff)
    maha = jnp.sum(sol ** 2, axis=1)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)),
                           axis=-1)
    logp = (-0.5 * (maha + d * jnp.log(2.0 * jnp.pi) + logdet[:, None])
            + jnp.log(weights + 1e-30)[:, None])
    return logp.T


def test_gmm_log_prob_nan_cholesky_matches_jax():
    """A covariance that is not positive definite: JAX's Cholesky returns
    NaN, and so does the port's (``cholesky_ex``, no host check); the other
    components stay finite and equal."""
    g = np.random.default_rng(0)
    pts = g.standard_normal((2, 12, 2)).astype(np.float32)
    weights = np.asarray([[0.5, 0.3, 0.2]] * 2, np.float32)
    means = g.standard_normal((2, 3, 2)).astype(np.float32)
    covs = np.tile(np.eye(2, dtype=np.float32), (2, 3, 1, 1))
    covs[:, 1] = [[1.0, 2.0], [2.0, 1.0]]          # indefinite
    covs[1, 2] = [[2.0, 0.5], [0.5, 1.0]]
    got = clusters.gmm_log_prob(*(torch.from_numpy(a) for a in
                                  (pts, weights, means, covs))).numpy()
    for r in range(2):
        want = np.asarray(_jax_log_prob(*(jnp.asarray(a[r]) for a in
                                          (pts, weights, means, covs))))
        np.testing.assert_array_equal(np.isnan(got[r]), np.isnan(want))
        assert np.isnan(want[:, 1]).all() and np.isfinite(want[:, 0]).all()
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[r][ok], want[ok], rtol=1e-6,
                                   atol=1e-6)


def test_run_bytes_generation_term():
    """graph and social count their n x n adjacency (at n >> m it
    dominates the n x m planes), svd and clustered their solver planes;
    the chunk shrinks to match."""
    base = RunConfig(n=4000, m=10, d=2, p=0.5, reps=1)
    planes = base.n * base.m * 4 * batched._NM_PLANES
    assert batched.generation_bytes(base) == 0
    for mode in ("graph", "social"):
        cfg = RunConfig(n=4000, m=10, d=2, p=0.5, reps=1, generation=mode)
        extra = batched.generation_bytes(cfg)
        assert extra >= cfg.n * cfg.n * 5 > planes
        assert batched.run_bytes(cfg) == batched.run_bytes(base) + extra
        assert (batched.default_max_bucket(cfg, device="cpu")
                < batched.default_max_bucket(base, device="cpu"))
    canon = RunConfig(n=1000, m=1000, d=2, p=0.2, reps=4)
    for mode in ("svd", "clustered"):
        cfg = RunConfig(n=1000, m=1000, d=2, p=0.2, reps=4, generation=mode)
        assert batched.generation_bytes(cfg) >= 3 * cfg.n * cfg.m * 4
        assert batched.run_bytes(cfg) > batched.run_bytes(canon)
        assert (batched.default_max_bucket(cfg, device="cpu")
                < batched.default_max_bucket(canon, device="cpu"))
    assert batched.generation_bytes(
        RunConfig(n=1000, m=1000, d=2, generation="gmm")) > 0


# End to end: parameter_scan at tests/test_torch_engine.py's CFG shape and
# tolerances (rtol 1e-4 / atol 1e-5 on all 23 keys).
CFG = dict(n=24, m=28, d=2, p=0.4, s=[1.0, 4.0], lr=1e-2,
           weight_decay=1e-5, num_epochs=2, reps=2, K=1)


def _flat(v):
    if isinstance(v, list) and v and isinstance(v[0], (list, np.ndarray)):
        return np.concatenate([np.ravel(np.asarray(x, np.float64))
                               for x in v])
    return np.asarray(v, np.float64)


def _assert_scans_close(want, got, rtol, atol):
    from mfcd_tpu_torch.core.results import RESULT_KEYS, validate_schema

    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a["params"] == b["params"]
        assert not validate_schema(b["results"])
        for k in RESULT_KEYS:
            np.testing.assert_allclose(_flat(b["results"][k]),
                                       _flat(a["results"][k]), rtol=rtol,
                                       atol=atol, err_msg=k)


# svd's top-d factors are as well determined as the gap between the d-th
# and (d+1)-th singular values of its scores: at seed 0 one run's relative
# gap is 1.2 %, and the two LAPACKs' X differ there by 1.5e-4, enough to
# swap two entries of a row in Spearman's ranks.  At seed 2 every run's gap
# is 3 % or more and X agrees to 1e-5.
@pytest.mark.parametrize("mode,seed", [("low_rank", 0), ("svd", 2),
                                       ("gmm", 0), ("social", 0),
                                       ("clustered", 0)])
def test_parameter_scan_matches_jax(mode, seed):
    want = mfcd_tpu.parameter_scan(generation=mode, seed=seed, **CFG)
    got = mfcd_tpu_torch.parameter_scan(device="cpu", generation=mode,
                                        seed=seed, **CFG)
    _assert_scans_close(want, got, rtol=1e-4, atol=1e-5)


def test_fast_scan_over_two_modes_equals_sequential():
    """Two generation modes are two shape buckets; each config keeps its
    global index, so the batched scan equals the sequential one bit for
    bit on the CPU."""
    grid = dict(CFG, s=[2.0], num_epochs=1, generation=["hierarchical",
                                                        "structured"])
    fast = mfcd_tpu_torch.parameter_scan_fast(device="cpu", **grid)
    seq = mfcd_tpu_torch.parameter_scan(device="cpu", **grid)
    assert [e["params"]["generation"] for e in fast] == grid["generation"]
    _assert_scans_close(seq, fast, rtol=0, atol=0)
