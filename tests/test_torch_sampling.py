"""mfcd_tpu_torch sampler, labels, generator and init vs mfcd_tpu.

Split buffers and counts are bit-equal (they are integer functions of the
threefry bits).  Votes are equal unless a uniform draw lies within rounding
of its BTL probability: X differs from the JAX one in the last bits
(erfinv, QR), so the test asserts equality of the votes where the margin
exceeds 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from mfcd_tpu.core import rng as jrng
from mfcd_tpu.data import btl as jbtl
from mfcd_tpu.genx import generate_x as jgenerate_x
from mfcd_tpu.models.mf import init_params as jinit
from mfcd_tpu_torch.core import prng, rng as trng
from mfcd_tpu_torch.data import btl as tbtl
from mfcd_tpu_torch.genx import generate_x as tgenerate_x
from mfcd_tpu_torch.models.mf import forward_prob, init_params as tinit
from mfcd_tpu_torch.models.mf import MFParams

torch.set_num_threads(1)

N, M, D, REPS, K = 24, 28, 2, 2, 3
# (t_cap, budget, extra_cap, extra_budget): exact capacity, and a budget
# below the power-of-two capacity with a top-up block.
BUDGETS = [(134, None, 0, None), (256, 134, 512, 400)]


@pytest.fixture(scope="module", params=BUDGETS, ids=["exact", "capped"])
def both(request):
    t_cap, budget, extra_cap, extra_budget = request.param
    jck = jrng.config_key(jax.random.key(0), 1)
    jreps = jrng.rep_keys(jck, REPS)
    jax_out = []
    for r in range(REPS):
        st = jrng.rep_streams(jreps[r])
        x = jgenerate_x(st["x_gen"], N, M, D, "base")
        sp = jbtl.sample_and_split(st, x, t_cap, extra_cap, "random",
                                   budget=budget, extra_budget=extra_budget)
        hard = jbtl.label_splits(st, x, sp, 3.0, K, False)
        soft = jbtl.label_splits(st, x, sp, 3.0, K, True)
        jax_out.append((x, sp, hard, soft, jinit(st["init"], N, M, D)))

    tst = trng.rep_streams(trng.rep_keys(
        trng.config_key(prng.key(0), 1), REPS))
    x = tgenerate_x(tst["x_gen"], N, M, D, "base")
    sp = tbtl.sample_and_split(tst, x, t_cap, extra_cap, "random",
                               budget=budget, extra_budget=extra_budget)
    hard = tbtl.label_splits(tst, x, sp, 3.0, K, False)
    soft = tbtl.label_splits(tst, x, sp, 3.0, K, True)
    return jax_out, (x, sp, hard, soft, tinit(tst["init"], N, M, D)), tst


def test_splits_bit_equal(both):
    jax_out, (_, sp, _, _, _), _ = both
    for r, (_, jsp, _, _, _) in enumerate(jax_out):
        for f in ("train", "train_count", "val", "val_count", "test",
                  "test_count"):
            a = np.asarray(getattr(jsp, f))
            b = getattr(sp, f)[r].numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, f
            assert (a == b).all(), f
        assert int(sp.sample.count[r]) == int(jsp.sample.count)


def _margin(x, split, tst_key, k, soft, r):
    """|u - p| of every vote, to exclude draws within rounding of p."""
    t = split.u.shape[-1] // (1 if soft else k)
    tri = split.u[r, ::(1 if soft else k)][:t]
    tri_i = split.i[r, ::(1 if soft else k)][:t]
    tri_j = split.j[r, ::(1 if soft else k)][:t]
    xr = x[r]
    p = torch.sigmoid(3.0 * (xr[tri.long(), tri_i.long()]
                             - xr[tri.long(), tri_j.long()]))
    u = prng.uniform(tst_key[r], (t, k))
    return (u - p.unsqueeze(-1)).abs().reshape(-1).numpy()


def test_labels_equal(both):
    jax_out, (x, sp, hard, soft, _), tst = both
    names = ("labels_train", "labels_val", "labels_test")
    for r, (_, _, jhard, jsoft, _) in enumerate(jax_out):
        for li in range(3):
            for f in ("u", "i", "j", "valid", "count"):
                a = np.asarray(getattr(jhard[li], f))
                b = getattr(hard[li], f)[r].numpy()
                assert (a == b).all(), (li, f)
            margin = _margin(x, hard[li], tst[names[li]], K, False, r)
            safe = margin > 1e-5
            za = np.asarray(jhard[li].z)
            zb = hard[li].z[r].numpy()
            assert (za[safe] == zb[safe]).all()
            assert safe.mean() > 0.99
        # soft train labels: k/K rationals, equal where every vote is safe
        for f in ("u", "i", "j", "valid", "count"):
            assert (np.asarray(getattr(jsoft[0], f))
                    == getattr(soft[0], f)[r].numpy()).all()
        m = _margin(x, soft[0], tst["labels_train"], K, True, r)
        safe = (m.reshape(-1, K) > 1e-5).all(axis=1)
        assert (np.asarray(jsoft[0].z)[safe]
                == soft[0].z[r].numpy()[safe]).all()


def test_generate_base_and_init_allclose(both):
    jax_out, (x, _, _, _, params), _ = both
    for r, (jx, _, _, _, jp) in enumerate(jax_out):
        np.testing.assert_allclose(x[r].numpy(), np.asarray(jx),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(params.U[r].numpy(), np.asarray(jp.U),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(params.V[r].numpy(), np.asarray(jp.V),
                                   rtol=1e-6, atol=1e-6)


def test_forward_prob_matches_jax():
    from mfcd_tpu.models.mf import MFParams as JP, forward_prob as jfwd

    g = np.random.default_rng(0)
    U = g.standard_normal((N, D)).astype(np.float32)
    V = g.standard_normal((M, D)).astype(np.float32)
    u, i, j = (g.integers(0, s, 50).astype(np.int32) for s in (N, M, M))
    want = np.asarray(jfwd(JP(U, V), u, i, j))
    got = forward_prob(MFParams(torch.from_numpy(U), torch.from_numpy(V)),
                       *(torch.from_numpy(a) for a in (u, i, j)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_unported_modes_raise():
    key = prng.key(0)[None]
    with pytest.raises(NotImplementedError, match="M14"):
        tgenerate_x(key, N, M, D, "low_rank")
    with pytest.raises(ValueError):
        tgenerate_x(key, N, M, D, "nope")
    st = trng.rep_streams(key)
    x = tgenerate_x(st["x_gen"], N, M, D, "base")
    with pytest.raises(NotImplementedError, match="M11"):
        tbtl.sample_and_split(st, x, 64, 0, "proximity")


def test_fast_path_kind_random_matches():
    from mfcd_tpu.sampling.prp import fast_path_kind as jkind
    from mfcd_tpu_torch.sampling import prp as tprp

    for args in [(24, 28, 256, 512), (1000, 1000, 131072, 0), (3, 2, 64, 0),
                 (2000, 2000, 1024, 0)]:
        assert tprp.fast_path_kind("random", *args) == jkind("random", *args)
    assert tprp.fast_path_kind("proximity", 24, 28, 64, 0) is None
