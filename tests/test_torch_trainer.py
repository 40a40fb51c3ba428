"""mfcd_tpu_torch.train.trainer vs mfcd_tpu.train.trainer (eager trainers).

Same params, splits and epoch keys, made with numpy; tolerances are
``tests/test_pallas.py``'s (losses rtol 2e-4 / atol 1e-5, params rtol 2e-3
/ atol 1e-4): the two frameworks' autodiff and pow round differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfcd_tpu.data.btl import LabeledSplit as JSplit
from mfcd_tpu.models.mf import MFParams as JParams
from mfcd_tpu.ops import losses as jlosses
from mfcd_tpu.ops import optim as joptim
from mfcd_tpu.train.trainer import batch_losses as jbatch_losses
from mfcd_tpu.train.trainer import train_model as jtrain
from mfcd_tpu_torch.convert import key_from_jax, params_from_jax, split_from_jax
from mfcd_tpu_torch.ops import losses as tlosses
from mfcd_tpu_torch.ops import optim as toptim
from mfcd_tpu_torch.train.trainer import batch_losses as tbatch_losses
from mfcd_tpu_torch.train.trainer import train_model as ttrain

torch.set_num_threads(1)

N, M, D = 20, 25, 3
ROWS, VROWS, BS, EPOCHS = 100, 40, 32, 2


def make_split(g, n_rows, count):
    u = g.integers(0, N, n_rows).astype(np.int32)
    i = g.integers(0, M, n_rows).astype(np.int32)
    j = ((i + g.integers(1, M, n_rows)) % M).astype(np.int32)
    z = (g.random(n_rows) < 0.5).astype(np.float32)
    return u, i, j, z, np.arange(n_rows) < count, np.int32(count)


def make_runs(seed, counts):
    g = np.random.default_rng(seed)
    r = len(counts)
    U = (g.standard_normal((r, N, D)) / np.sqrt(D)).astype(np.float32)
    V = (g.standard_normal((r, M, D)) / np.sqrt(D)).astype(np.float32)
    train = [make_split(g, ROWS, c) for c in counts]
    val = [make_split(g, VROWS, VROWS) for _ in counts]
    keys = np.stack([np.asarray(jax.random.key_data(jax.random.key(10 + k)))
                     for k in range(r)])
    return U, V, train, val, keys


def stack(splits):
    return [np.stack([s[f] for s in splits]) for f in range(6)]


@pytest.fixture(scope="module", params=[([ROWS, ROWS], [1e-2, 3e-2]),
                                        ([70, ROWS], [1e-2, 1e-2])],
                ids=["full", "shortfall"])
def trained(request):
    counts, lrs = request.param
    U, V, train, val, keys = make_runs(0, counts)
    ref = [jtrain(JParams(jnp.asarray(U[r]), jnp.asarray(V[r])),
                  JSplit(*map(jnp.asarray, train[r])),
                  JSplit(*map(jnp.asarray, val[r])),
                  jax.random.wrap_key_data(jnp.asarray(keys[r])),
                  lrs[r], 1e-3, batch_size=BS, num_epochs=EPOCHS)
           for r in range(len(counts))]
    got = ttrain(params_from_jax(U, V), split_from_jax(*stack(train)),
                 split_from_jax(*stack(val)), key_from_jax(keys),
                 torch.tensor(lrs), 1e-3, batch_size=BS, num_epochs=EPOCHS)
    return ref, got


def test_train_model_matches_jax(trained):
    ref, (params, tl, vl) = trained
    for r, (jp, jtl, jvl) in enumerate(ref):
        np.testing.assert_allclose(tl[r].numpy(), np.asarray(jtl),
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(vl[r].numpy(), np.asarray(jvl),
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(params.U[r].numpy(), np.asarray(jp.U),
                                   rtol=2e-3, atol=1e-4)
        np.testing.assert_allclose(params.V[r].numpy(), np.asarray(jp.V),
                                   rtol=2e-3, atol=1e-4)


def test_masked_rows_do_not_train():
    """Padding a split further (rows past count) changes nothing."""
    U, V, train, val, keys = make_runs(1, [70])
    args = (params_from_jax(U, V),)
    a = ttrain(*args, split_from_jax(*stack(train)),
               split_from_jax(*stack(val)), key_from_jax(keys), 1e-2, 1e-3,
               batch_size=BS, num_epochs=EPOCHS)
    padded = [np.concatenate([f, np.zeros(28, f.dtype)]) if f.ndim else f
              for f in train[0]]
    b = ttrain(*args, split_from_jax(*stack([padded])),
               split_from_jax(*stack(val)), key_from_jax(keys), 1e-2, 1e-3,
               batch_size=BS, num_epochs=EPOCHS)
    for x, y in zip(a[0] + a[1:], b[0] + b[1:]):
        assert torch.equal(x, y)


def test_batch_losses_matches_jax():
    U, V, _, val, _ = make_runs(2, [VROWS])
    want = jbatch_losses(JParams(U[0], V[0]), JSplit(*val[0]), BS)
    got = tbatch_losses(params_from_jax(U, V), split_from_jax(*stack(val)),
                        BS)
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[1][0].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-7)


def test_losses_and_adam_match_jax():
    g = np.random.default_rng(3)
    x = (g.standard_normal(200) * 5).astype(np.float32)
    z = g.random(200).astype(np.float32)
    mask = g.random(200) < 0.7
    np.testing.assert_allclose(
        tlosses.bce_with_logits(torch.from_numpy(x), torch.from_numpy(z)),
        np.asarray(jlosses.bce_with_logits(x, z)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tlosses.masked_batch_mean(torch.from_numpy(x), torch.from_numpy(mask)),
        np.asarray(jlosses.masked_batch_mean(x, mask)), rtol=1e-6)

    p = g.standard_normal((4, 3)).astype(np.float32)
    grads = [g.standard_normal((4, 3)).astype(np.float32) for _ in range(5)]
    jp, js = (p,), joptim.adam_init((p,))
    tp, ts = (torch.from_numpy(p),), toptim.adam_init((torch.from_numpy(p),))
    for gr in grads:
        jp, js = joptim.adam_update(jp, (gr,), js, 1e-2, 1e-3)
        tp, ts = toptim.adam_update(tp, (torch.from_numpy(gr),), ts,
                                    1e-2, 1e-3)
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp[0]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ts.nu[0].numpy(), np.asarray(js.nu[0]),
                               rtol=1e-5, atol=1e-9)
