"""The kernel-split profiler's kernels: plain versions vs the Pallas kernels.

``scripts/profile_kernel_split.py`` (the JAX package's profiler) is loaded
from its path and run in interpret mode: its module-level ``pl`` is
replaced by a namespace whose ``pallas_call`` passes ``interpret=True``.
Nothing under ``scripts/`` changes.  The CUDA kernels against these plain
versions are ``tests/test_torch_cuda.py``.

Tolerances: state rtol 1e-5 / atol 1e-6 (the Pallas kernels sum duplicate
rows through one-hot products, in another order than ``index_add_``);
loss rtol 1e-5 / atol 1e-12 (the ablated losses are ~1e-8).  The ablated
variants' ``alive`` sums, which the JAX kernel does not return, are held
at rtol 1e-5 against the same keep-alive stages computed in float64 numpy
from the JAX kernel's formulas (``profile_kernel_split.py:196-250``).
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mfcd_tpu.ops.kernels import EpochState as JState
from mfcd_tpu_torch.ops import kernel_split as KS
from mfcd_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M, D, BS, B = 20, 25, 3, 32, 4
PACK = ("full", 5, 5, 1, 1)


class _Interpret:
    """``pallas`` with every ``pallas_call`` in interpret mode."""

    def __getattr__(self, name):
        return getattr(pl, name)

    pallas_call = staticmethod(functools.partial(pl.pallas_call,
                                                 interpret=True))


@pytest.fixture(scope="module")
def jax_split():
    spec = importlib.util.spec_from_file_location(
        "jax_profile_kernel_split",
        os.path.join(REPO, "scripts", "profile_kernel_split.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = _Interpret()
    return mod


def _inputs(seed=0, counts=(70, 100), lrs=(1e-2, 3e-2)):
    g = np.random.default_rng(seed)
    r = len(counts)
    state = [g.standard_normal((r, D, N)), g.standard_normal((r, D, M))]
    state += [np.abs(g.standard_normal(s.shape)) * 1e-2
              for s in (state[0], state[0], state[1], state[1])]
    shape = (r, B, BS)
    u = g.integers(0, N, shape).astype(np.int32)
    i = g.integers(0, M, shape).astype(np.int32)
    j = ((i + g.integers(1, M, shape)) % M).astype(np.int32)
    z = (g.random(shape) < 0.5).astype(np.int32)
    packed = u | (i << 5) | (j << 10) | (z << 15)
    scalars = [np.asarray(lrs, np.float32), np.full(r, 1e-3, np.float32),
               np.arange(r, dtype=np.float32) * 3,
               np.asarray(counts, np.int32)]
    return [a.astype(np.float32) for a in state], packed, scalars


def _t(a):
    return torch.from_numpy(np.array(a))


def _alive_numpy(state, packed, sc, name):
    """The ``alive`` sums of variant ``name`` in float64: per executed batch,
    the stages the variant keeps (unpack; resolved rows; gathers, BCE and
    g; the gradient scatter, read back at the batch's rows), as the JAX
    kernel computes them, reduced to the unweighted sums
    ``train_epoch_variant_reference`` documents."""
    u_t, v_t = (np.asarray(a, np.float64) for a in state[:2])
    u, i, j = packed & 31, (packed >> 5) & 31, (packed >> 10) & 31
    z = (packed >> 15) & 1
    out = []
    for r, count in enumerate(sc[3]):
        num_exec = -(-int(count) // BS)
        total = 0.0
        for t in range(min(num_exec, B)):
            mask = (t * BS + np.arange(BS)) < count
            ur, ir, jr = u[r, t], i[r, t], j[r, t]
            if name == "loop_only":
                total += ur.sum() + ir.sum() + jr.sum()
                continue
            if name == "oh_only":
                rows = (np.where(ur < N, ur, 0) + np.where(ir < M, ir, 0)
                        + np.where(jr < M, jr, 0))
                total += (rows * mask).sum()
                continue
            ur, ir, jr = (np.where(mask, a, 0) for a in (ur, ir, jr))
            eu = u_t[r][:, ur].T
            dv = (v_t[r][:, ir] - v_t[r][:, jr]).T
            logit = (eu * dv).sum(-1)
            g = (1 / (1 + np.exp(-logit)) - z[r, t]) * mask / max(mask.sum(),
                                                                   1)
            if name == "no_scatter":
                total += np.abs(g).sum()
                continue
            grad_u = np.zeros((N, D))
            grad_v = np.zeros((M, D))
            np.add.at(grad_u, ur, g[:, None] * dv)
            np.add.at(grad_v, ir, g[:, None] * eu)
            np.add.at(grad_v, jr, -g[:, None] * eu)
            total += (np.abs(grad_u[ur]).sum() + np.abs(grad_v[ir]).sum()
                      + np.abs(grad_v[jr]).sum())
        out.append(total / max(num_exec, 1))
    return np.asarray(out)


def _close(got_state, got_loss, want_state, want_loss):
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(want_loss),
                               rtol=1e-5, atol=1e-12)
    for a, b in zip(want_state, got_state):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("name", list(KS.VARIANTS))
def test_variant_reference_matches_pallas(jax_split, name):
    state, packed, sc = _inputs()
    stages = KS.VARIANTS[name]
    want_state, want_loss = jax_split._run_variant(
        JState(*map(jnp.asarray, state)), (jnp.asarray(packed),),
        *map(jnp.asarray, sc), pack=PACK, stages=stages)
    got_state, got_loss, got_alive = KS.train_epoch_variant(
        K.EpochState(*map(_t, state)), (_t(packed),), *map(_t, sc),
        pack=PACK, stages=stages)
    _close(got_state, got_loss, want_state, want_loss)
    if name == "full":  # its state shows its work
        assert not got_alive.any()
        return
    # An ablated variant leaves the state as it was, and its alive sums
    # are far from 0 and follow every stage it keeps.
    for a, b in zip(state, got_state):
        np.testing.assert_array_equal(b.numpy(), a)
    want_alive = _alive_numpy(state, packed, sc, name)
    assert (np.abs(want_alive) > 1e-2).all()
    np.testing.assert_allclose(got_alive.numpy(), want_alive, rtol=1e-5)


def test_alive_sees_a_removed_scatter(monkeypatch):
    # no_adam's loss carries its gradient sums at weight 1e-9; with the
    # scatter gone, the alive sums must no longer match.
    state, packed, sc = _inputs()
    zero = lambda rows, idx, vals, *rest: torch.zeros(
        vals.shape[0], rows, vals.shape[-1])
    monkeypatch.setattr(KS, "_index_add", zero)
    monkeypatch.setattr(KS, "_v_grad_interleaved", zero)
    alive = KS.train_epoch_variant(
        K.EpochState(*map(_t, state)), (_t(packed),), *map(_t, sc),
        pack=PACK, stages=KS.VARIANTS["no_adam"])[2]
    want = _alive_numpy(state, packed, sc, "no_adam")
    assert not np.allclose(alive.numpy(), want, rtol=1e-5)


def test_full_variant_is_the_fused_epoch():
    state, packed, sc = _inputs(1)
    a = KS.train_epoch_variant_reference(
        K.EpochState(*map(_t, state)), (_t(packed),), *map(_t, sc),
        pack=PACK, stages=KS.VARIANTS["full"])
    b = K.train_epoch_reference(K.EpochState(*map(_t, state)), (_t(packed),),
                                *map(_t, sc), pack=PACK)
    assert not a[2].any()
    for x, y in zip(a[0] + (a[1],), b[0] + (b[1],)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_factored_reference_matches_pallas(jax_split):
    state, packed, sc = _inputs(2)
    pad = lambda a: jnp.pad(
        jnp.asarray(a), ((0, 0), (0, 0), (0, KS.FACTORED_ROWS - a.shape[2])))
    want_state, want_loss = jax_split._run_factored(
        tuple(jax_split.to_factored_layout(pad(a)) for a in state),
        (jnp.asarray(packed),), *map(jnp.asarray, sc), pack=PACK)
    got_state, got_loss = KS.train_epoch_factored(
        K.EpochState(*(KS.to_factored_layout(_t(a)) for a in state)),
        (_t(packed),), *map(_t, sc), pack=PACK)
    _close(got_state, got_loss, want_state, want_loss)
    # Back in the [R, d, n] layout, P2 trains as the fused epoch does, and
    # the padding rows stay 0.
    fused, fused_loss = K.train_epoch_reference(
        K.EpochState(*map(_t, state)), (_t(packed),), *map(_t, sc),
        pack=PACK)
    for a, b, rows in zip(got_state, fused, (N, M, N, N, M, M)):
        back = KS.from_factored_layout(a, D)
        torch.testing.assert_close(back[:, :, :rows], b, rtol=1e-5,
                                   atol=1e-6)
        assert not back[:, :, rows:].any()
    torch.testing.assert_close(got_loss, fused_loss, rtol=1e-5, atol=1e-12)


def test_factored_layout_round_trip_matches_jax(jax_split):
    g = np.random.default_rng(3)
    a = g.standard_normal((2, D, M)).astype(np.float32)
    f = KS.to_factored_layout(_t(a))
    assert f.shape == (2, KS.FACTORED_H, D * KS.FACTORED_L)
    want = jax_split.to_factored_layout(
        jnp.pad(jnp.asarray(a), ((0, 0), (0, 0), (0, 1024 - M))))
    np.testing.assert_array_equal(f.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        KS.from_factored_layout(f, D, M).numpy(), a)
    np.testing.assert_array_equal(
        KS.from_factored_layout(f, D).numpy(),
        jax_split.from_factored_layout(want, D))
    with pytest.raises(ValueError, match="H = 9"):
        KS.to_factored_layout(torch.zeros(1, D, 1025))
    with pytest.raises(ValueError, match="not"):
        KS.from_factored_layout(f, D + 1)


@pytest.mark.parametrize("mode", ["uij", "none"])
def test_wrappers_take_pack_full_only(mode):
    state, packed, sc = _inputs()
    pack = (mode,) + PACK[1:]
    st = K.EpochState(*map(_t, state))
    with pytest.raises(ValueError, match="only 'full'"):
        KS.train_epoch_variant(st, (_t(packed),), *map(_t, sc), pack=pack,
                               stages=KS.VARIANTS["full"])
    fst = K.EpochState(*(KS.to_factored_layout(a) for a in st))
    with pytest.raises(ValueError, match="only 'full'"):
        KS.train_epoch_factored(fst, (_t(packed),), *map(_t, sc), pack=pack)


@pytest.mark.parametrize("stages", [("adam",), ("oh", "scatter"),
                                    ("oh", "contract", "scatter", "adam",
                                     "split3d")])
def test_variant_rejects_unknown_stage_sets(stages):
    state, packed, sc = _inputs()
    with pytest.raises(ValueError, match="unknown stage set"):
        KS.train_epoch_variant(K.EpochState(*map(_t, state)), (_t(packed),),
                               *map(_t, sc), pack=PACK, stages=stages)


def test_wrappers_reject_other_devices():
    state, packed, sc = _inputs()
    meta = K.EpochState(*(torch.empty(a.shape, device="meta")
                          for a in state))
    with pytest.raises(ValueError, match="unsupported device"):
        KS.train_epoch_variant(meta, (_t(packed),), *map(_t, sc), pack=PACK,
                               stages=())
    fmeta = K.EpochState(*(torch.empty(2, 8, D * 128, device="meta")
                           for _ in state))
    with pytest.raises(ValueError, match="unsupported device"):
        KS.train_epoch_factored(fmeta, (_t(packed),), *map(_t, sc),
                                pack=PACK)


@pytest.mark.parametrize("cluster", [1, 8, 16, K.PACKED])
@pytest.mark.parametrize("kernel", list(KS.VARIANTS) + [KS.FACTORED])
def test_smem_formulas_at_the_profiler_shape(kernel, cluster):
    # K1's block at the launch shape (P2's over 1,024 rows), plus, for an
    # ablated variant, a third loss term per batch row by step parity and
    # 16 alive partial sums.  Split, K1's block holds the pushed rows
    # (3 * d floats a batch row) and their mbarrier.
    rows = (KS.FACTORED_ROWS if kernel == KS.FACTORED else 1000)
    extra = 0 if kernel in ("full", KS.FACTORED) else 4 * (2 * 64 + 16)
    got = KS.split_smem_bytes(rows, rows, 2, 64, cluster, kernel)
    assert got == K.epoch_smem_bytes(rows, rows, 2, 64, cluster) + extra
    share = 2 * -(-rows // max(cluster, 1))
    pushed = 8 + 4 * 3 * 64 * 2 if cluster > 1 else 0
    assert got == (8 * share + pushed + 4 * (3 * share * 2 + 64 * 18 + 2)
                   + extra)
    if (kernel, cluster) == ("full", 1):  # K1's canonical block
        assert got == 68_616


@pytest.mark.parametrize("kernel", list(KS.VARIANTS) + [KS.FACTORED])
def test_shared_memory_gate(kernel):
    # Any batch size whose block fits (no one-row-per-thread cap): bs = 1024
    # at the profiler's shape; a shape over the limit raises.  P1 takes K1's
    # gate (n = m = 10,000 from C = 4); P2 keeps its layout's row limit.
    rows = KS.FACTORED_ROWS if kernel == KS.FACTORED else 1000
    assert KS.split_kernel_supported(rows, rows, 2, 1024, kernel)
    KS._check_fits("t", rows, rows, 2, 1024, kernel)
    factored = kernel == KS.FACTORED
    assert KS.split_kernel_supported(10_000, 10_000, 2, 64, kernel) \
        == (not factored)
    assert KS.split_min_cluster(10_000, 10_000, 2, 64, kernel) == (
        None if factored else K.min_cluster(10_000, 10_000, 2, 64))
    if factored:
        with pytest.raises(ValueError, match="factored layout holds"):
            KS._check_fits("t", 10_000, 10_000, 2, 64, kernel)
    else:
        assert KS._check_fits("t", 10_000, 10_000, 2, 64, kernel) == 4
        with pytest.raises(ValueError, match="shared memory"):
            KS._check_fits("t", 30_000, 30_000, 2, 64, kernel)
    assert not KS.split_kernel_supported(30_000, 30_000, 2, 64, kernel)
    assert not hasattr(KS, "MAX_BATCH")


@pytest.mark.parametrize("cluster", [3, 32, -1, 512])
def test_private_cluster_rejects_other_shapes(cluster):
    state, packed, sc = _inputs()
    st = K.EpochState(*map(_t, state))
    with pytest.raises(ValueError, match="cluster"):
        KS._train_epoch_variant(st, (_t(packed),), *map(_t, sc), pack=PACK,
                                stages=(), cluster=cluster)
    fst = K.EpochState(*(KS.to_factored_layout(a) for a in st))
    with pytest.raises(ValueError, match="cluster"):
        KS._train_epoch_factored(fst, (_t(packed),), *map(_t, sc),
                                 pack=PACK, cluster=cluster)


@pytest.mark.parametrize("cluster", K.CLUSTER_SIZES + (K.PACKED,))
def test_private_cluster_takes_the_plain_version_on_the_cpu(cluster):
    state, packed, sc = _inputs(4)
    before = dict(KS.VARIANT_LAUNCHES), KS.FACTORED_LAUNCHES
    a = KS._train_epoch_variant(K.EpochState(*map(_t, state)), (_t(packed),),
                                *map(_t, sc), pack=PACK,
                                stages=KS.VARIANTS["no_adam"],
                                cluster=cluster)
    b = KS.train_epoch_variant(K.EpochState(*map(_t, state)), (_t(packed),),
                               *map(_t, sc), pack=PACK,
                               stages=KS.VARIANTS["no_adam"])
    assert all(torch.equal(x, y) for x, y in zip(a[0] + a[1:], b[0] + b[1:]))
    fst = K.EpochState(*(KS.to_factored_layout(_t(a)) for a in state))
    f = KS._train_epoch_factored(fst, (_t(packed),), *map(_t, sc), pack=PACK,
                                 cluster=cluster)
    g = KS.train_epoch_factored(fst, (_t(packed),), *map(_t, sc), pack=PACK)
    assert all(torch.equal(x, y) for x, y in zip(f[0] + f[1:], g[0] + g[1:]))
    assert (dict(KS.VARIANT_LAUNCHES), KS.FACTORED_LAUNCHES) == before


def _split_loop_sum(rows, i, j, vals):
    """P2's V order from 0, one float32 add at a time: the i-entries in
    batch order, the j-entries (subtracted) in batch order, then the two
    sums added."""
    r, bs, d = vals.shape
    si = np.zeros((r, rows, d), np.float32)
    sj = np.zeros((r, rows, d), np.float32)
    for x in range(r):
        for b in range(bs):
            for k in range(d):
                si[x, i[x, b], k] = np.float32(si[x, i[x, b], k]
                                               + vals[x, b, k])
        for b in range(bs):
            for k in range(d):
                sj[x, j[x, b], k] = np.float32(sj[x, j[x, b], k]
                                               - vals[x, b, k])
    return (si + sj).astype(np.float32)


@pytest.mark.parametrize("stream", ["random", "adversarial"])
def test_v_grad_split_sums_in_p2_order(stream):
    # The order P2's kernel reproduces from its even (i) and odd (j) entry
    # ids, bit for bit.
    g = np.random.default_rng(8)
    r, bs = 2, 64
    if stream == "random":
        i = g.integers(0, M, (r, bs))
        j = (i + g.integers(1, M, (r, bs))) % M
    else:  # V alternates rows 3 and 4 as i and j: each named 64 times
        i = np.where(np.arange(bs) % 2 == 0, 3, 4)[None].repeat(r, 0)
        j = 7 - i
    vals = (g.standard_normal((r, bs, D)) * 10.0 ** g.integers(
        -4, 2, (r, bs, 1))).astype(np.float32)
    got = KS._v_grad_split(M, _t(i), _t(j), _t(vals)).numpy()
    np.testing.assert_array_equal(got, _split_loop_sum(M, i, j, vals))
    if stream == "adversarial":
        assert np.count_nonzero(got.any(-1)) == 2 * r


def test_profiler_inputs_and_no_card_exit(monkeypatch):
    from mfcd_tpu_torch.scripts import profile_kernel_split as PKS

    inp = PKS.canonical_inputs("cpu")
    r, nb, bs = inp["stream"][0].shape
    assert (r, nb, bs) == (8, 1250, 64) and inp["pack"] == ("full", 10, 10,
                                                            1, 1)
    y = inp["stream"][0]
    u, i, j, z = y & 1023, (y >> 10) & 1023, (y >> 20) & 1023, y >> 30
    assert max(int(u.max()), int(i.max()), int(j.max())) < 1000
    assert (i != j).all() and set(z.unique().tolist()) == {0, 1}
    assert (inp["count"] == 80_000).all() and not inp["state"].mu_u.any()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert PKS.main() != 0
