"""mfcd_tpu_torch.eval.metrics vs mfcd_tpu.eval.metrics.

Same params, X, test split and keys (numpy in, both packages).  All keys
allclose at rtol 1e-5 / atol 1e-6 (float32 reductions in another order; the
spectrum probe's QRs go through another LAPACK); integer-valued outputs
(accuracy counts, masks, sampled rows' indices) and the ordinal ranks are
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfcd_tpu.data.btl import LabeledSplit as JSplit
from mfcd_tpu.eval import metrics as JM
from mfcd_tpu.genx import generate_x as jgenerate_x
from mfcd_tpu.models.mf import MFParams as JParams
from mfcd_tpu_torch.convert import key_from_jax, params_from_jax, split_from_jax
from mfcd_tpu_torch.eval import metrics as TM

torch.set_num_threads(1)

N, M, D, ROWS, BS = 30, 40, 3, 300, 64


@pytest.fixture(scope="module")
def both():
    g = np.random.default_rng(0)
    x = np.asarray(jgenerate_x(jax.random.key(1), N, M, D, "base"))
    U = (g.standard_normal((N, D)) * 2).astype(np.float32)
    V = (g.standard_normal((M, D)) * 2).astype(np.float32)
    u = g.integers(0, N, ROWS).astype(np.int32)
    i = g.integers(0, M, ROWS).astype(np.int32)
    j = ((i + g.integers(1, M, ROWS)) % M).astype(np.int32)
    z = (g.random(ROWS) < 0.6).astype(np.float32)
    count = 260
    split = (u, i, j, z, np.arange(ROWS) < count, np.int32(count))
    key = jax.random.key(7)
    want = JM.compute_all_metrics(JParams(jnp.asarray(U), jnp.asarray(V)),
                                  jnp.asarray(x), 3.0,
                                  JSplit(*map(jnp.asarray, split)), key,
                                  batch_size=BS)
    port_args = (params_from_jax(U[None], V[None]),
                 torch.from_numpy(x[None].copy()))
    port_rest = (split_from_jax(*(np.asarray(a)[None] for a in split)),
                 key_from_jax(jax.random.key_data(key))[None])
    got = TM.compute_all_metrics(*port_args, torch.tensor([3.0]), *port_rest,
                                 batch_size=BS)
    return want, got, (port_args, port_rest)


def test_all_metric_keys_allclose(both):
    want, got, _ = both
    assert set(want) == set(got)
    for k in want:
        a = np.asarray(want[k])
        b = got[k][0].numpy()
        assert a.shape == b.shape, k
        if a.dtype == bool:
            assert (a == b).all(), k
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_sampled_rows_and_accuracies_equal(both):
    want, got, _ = both
    for k in ("accuracy", "gt_accuracy", "sampled_X_rows"):
        assert (np.asarray(want[k]) == got[k][0].numpy()).all(), k


def test_ranks_equal_with_ties():
    g = np.random.default_rng(1)
    a = np.round(g.standard_normal((6, 50)) * 2).astype(np.float32)
    a[0, :] = 0.0                     # a constant row
    a[1, ::7] = -0.0                  # signed zeros tie with zeros
    want = np.asarray(JM._ranks(jnp.asarray(a)))
    got = TM._ranks(torch.from_numpy(a)).numpy()
    assert (want == got).all()


def test_ground_truth_loss_ignores_the_scale(both):
    # Reference quirk: the GT loss uses sigmoid(X[u,i] - X[u,j]) without s,
    # while the reconstruction error scales X by s.
    _, got, (args, rest) = both
    other = TM.compute_all_metrics(*args, torch.tensor([10.0]), *rest,
                                   batch_size=BS)
    assert torch.equal(other["gt_log_likelihoods"], got["gt_log_likelihoods"])
    assert not torch.equal(other["reconstruction_errors"],
                           got["reconstruction_errors"])
