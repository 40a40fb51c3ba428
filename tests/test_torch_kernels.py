"""The fused training epoch: plain version vs the Pallas kernel (interpret
mode), the kernel trainer vs ``train_runs_pallas``, and the shape gate.
The CUDA kernel vs its plain version is ``tests/test_torch_cuda.py``.

Tolerances: one epoch of the plain version agrees with the Pallas kernel
to rtol 1e-5 / atol 1e-6 (the Pallas kernel sums its one-hot products in
three bf16 parts, so duplicate rows round differently); the kernel
trainer is held to ``tests/test_pallas.py``'s trainer tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfcd_tpu.data.btl import LabeledSplit as JSplit
from mfcd_tpu.models.mf import MFParams as JParams
from mfcd_tpu.ops.kernels import EpochState as JState
from mfcd_tpu.ops.kernels import pallas_epoch_supported, pallas_train_epoch
from mfcd_tpu.train import pallas_trainer as JPT
from mfcd_tpu_torch.convert import (epoch_state_from_jax, key_from_jax,
                                    params_from_jax, split_from_jax)
from mfcd_tpu_torch.ops import kernels as K
from mfcd_tpu_torch.train import kernel_trainer as KT

torch.set_num_threads(1)

N, M, D, BS, B = 20, 25, 3, 32, 4
ROWS, VROWS, EPOCHS = 100, 40, 2


def epoch_inputs(seed, counts, lrs):
    g = np.random.default_rng(seed)
    r = len(counts)
    state = [g.standard_normal((r, D, N)), g.standard_normal((r, D, M))]
    state += [np.abs(g.standard_normal(s.shape)) * 1e-2
              for s in (state[0], state[0], state[1], state[1])]
    state = [a.astype(np.float32) for a in state]
    shape = (r, B, BS)
    u = g.integers(0, N, shape).astype(np.int32)
    i = g.integers(0, M, shape).astype(np.int32)
    j = ((i + g.integers(1, M, shape)) % M).astype(np.int32)
    z = (g.random(shape) < 0.5).astype(np.float32)
    scalars = dict(lr=np.asarray(lrs, np.float32),
                   wd=np.full(r, 1e-3, np.float32),
                   step0=np.arange(r, dtype=np.float32) * 3,
                   count=np.asarray(counts, np.int32))
    return state, (u, i, j, z), scalars


def packed(mode, u, i, j, z):
    bn = bm = 5
    uij = u | (i << bn) | (j << (bn + bm))
    if mode == "full":
        return (uij | (z.astype(np.int32) << (bn + 2 * bm)),), (
            "full", bn, bm, 1, 1)
    if mode == "uij":
        return (uij, z), ("uij", bn, bm, 0, 1)
    return (u, i, j, z), ("none", 0, 0, 0, 1)


@pytest.mark.parametrize("mode", ["full", "uij", "none"])
def test_epoch_reference_matches_pallas(mode):
    state, rows, sc = epoch_inputs(0, [70, 100], [1e-2, 3e-2])
    stream, pack = packed(mode, *rows)
    want_state, want_loss = pallas_train_epoch(
        JState(*map(jnp.asarray, state)), tuple(map(jnp.asarray, stream)),
        jnp.asarray(sc["lr"]), jnp.asarray(sc["wd"]),
        jnp.asarray(sc["step0"]), jnp.asarray(sc["count"]), pack=pack,
        interpret=True)
    got_state, got_loss = K.train_epoch(
        epoch_state_from_jax(*state),
        tuple(torch.from_numpy(a.copy()) for a in stream),
        *(torch.from_numpy(sc[k]) for k in ("lr", "wd", "step0", "count")),
        pack=pack)
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(want_loss),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(want_state, got_state):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)


def _runs(seed, counts, lrs, soft_k=None):
    g = np.random.default_rng(seed)
    r = len(counts)
    U = (g.standard_normal((r, N, D)) / np.sqrt(D)).astype(np.float32)
    V = (g.standard_normal((r, M, D)) / np.sqrt(D)).astype(np.float32)

    def split(n_rows, count):
        u = g.integers(0, N, (r, n_rows)).astype(np.int32)
        i = g.integers(0, M, (r, n_rows)).astype(np.int32)
        j = ((i + g.integers(1, M, (r, n_rows))) % M).astype(np.int32)
        if soft_k:
            z = (g.integers(0, soft_k + 1, (r, n_rows)) / soft_k)
        else:
            z = g.random((r, n_rows)) < 0.5
        valid = np.arange(n_rows)[None, :] < np.asarray(count)[:, None]
        return (u, i, j, z.astype(np.float32), valid,
                np.asarray(count, np.int32))

    keys = np.stack([np.asarray(jax.random.key_data(jax.random.key(40 + k)))
                     for k in range(r)])
    return (U, V, split(ROWS, counts), split(VROWS, [VROWS] * r), keys,
            np.asarray(lrs, np.float32), np.full(r, 1e-3, np.float32))


@pytest.fixture(scope="module",
                params=[("hard", [70, ROWS], [1e-2, 3e-2], 1),
                        ("soft", [ROWS, 90], [1e-2, 1e-2], 4)],
                ids=["hard", "soft"])
def kernel_runs(request):
    _, counts, lrs, denom = request.param
    U, V, tr, va, keys, lr, wd = _runs(1, counts, lrs,
                                       soft_k=denom if denom > 1 else None)
    want = JPT.train_runs_pallas(
        JParams(jnp.asarray(U), jnp.asarray(V)),
        JSplit(*map(jnp.asarray, tr)), JSplit(*map(jnp.asarray, va)),
        jax.random.wrap_key_data(jnp.asarray(keys)), jnp.asarray(lr),
        jnp.asarray(wd), batch_size=BS, num_epochs=EPOCHS,
        label_denom=denom, interpret=True)
    got = KT.train_runs_kernel(
        params_from_jax(U, V), split_from_jax(*tr), split_from_jax(*va),
        key_from_jax(keys), torch.from_numpy(lr), torch.from_numpy(wd),
        batch_size=BS, num_epochs=EPOCHS, label_denom=denom)
    return want, got, denom


def test_train_runs_kernel_matches_pallas(kernel_runs):
    (jp, jtl, jvl), (tp, ttl, tvl), denom = kernel_runs
    assert KT._pack_spec(N, M, denom)[0] == "full"
    np.testing.assert_allclose(ttl.numpy(), np.asarray(jtl), rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tvl.numpy(), np.asarray(jvl), rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tp.U.numpy(), np.asarray(jp.U), rtol=2e-3,
                               atol=1e-4)
    np.testing.assert_allclose(tp.V.numpy(), np.asarray(jp.V), rtol=2e-3,
                               atol=1e-4)


def test_pack_spec_modes():
    for args in [(1000, 1000, 1), (1000, 1000, 10), (100_000, 100_000, 1),
                 (100, 100, 50), (N, M, 1)]:
        assert KT._pack_spec(*args) == JPT._pack_spec(*args)
    assert KT._pack_spec(1000, 1000, 1)[0] == "full"
    assert KT._pack_spec(1000, 1000, 10)[0] == "uij"
    assert KT._pack_spec(100_000, 100_000, 1)[0] == "none"


def test_epoch_kernel_supported_canonical():
    # n = m = 1000, d = 2, bs = 64: 64,000 B of state and gradient plus
    # per-row scratch — well inside one block's 232,448 B.
    assert K.epoch_smem_bytes(1000, 1000, 2, 64) == 66_304
    assert K.epoch_kernel_supported(1000, 1000, 2, 64)
    assert pallas_epoch_supported(1000, 1000, 2, 1250, 64)
    assert not K.epoch_kernel_supported(10_000, 10_000, 2, 64)
    assert not K.epoch_kernel_supported(100, 100, 2, 1024)


def test_cpu_tensors_take_the_plain_version():
    state, rows, sc = epoch_inputs(2, [70, 100], [1e-2, 3e-2])
    stream, pack = packed("full", *rows)
    before = K.EPOCH_LAUNCHES
    args = (tuple(torch.from_numpy(a.copy()) for a in stream),
            *(torch.from_numpy(sc[k]) for k in ("lr", "wd", "step0",
                                                "count")))
    a = K.train_epoch(epoch_state_from_jax(*state), *args, pack=pack)
    b = K.train_epoch_reference(epoch_state_from_jax(*state), *args,
                                pack=pack)
    assert K.EPOCH_LAUNCHES == before
    for x, y in zip(a[0] + (a[1],), b[0] + (b[1],)):
        assert torch.equal(x, y)
