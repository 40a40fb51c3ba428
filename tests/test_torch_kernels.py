"""The fused training epoch: plain version vs the Pallas kernel (interpret
mode), the kernel trainer vs ``train_runs_pallas``, the shape gate, the
cluster-size chooser and the summation order the CUDA kernel reproduces.
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


def epoch_inputs(seed, counts, lrs, bs=BS, nb=B, soft_k=None):
    g = np.random.default_rng(seed)
    r = len(counts)
    state = [g.standard_normal((r, D, N)), g.standard_normal((r, D, M))]
    state += [np.abs(g.standard_normal(s.shape)) * 1e-2
              for s in (state[0], state[0], state[1], state[1])]
    state = [a.astype(np.float32) for a in state]
    shape = (r, nb, bs)
    u = g.integers(0, N, shape).astype(np.int32)
    i = g.integers(0, M, shape).astype(np.int32)
    j = ((i + g.integers(1, M, shape)) % M).astype(np.int32)
    z = (g.random(shape) < 0.5).astype(np.float32)
    if soft_k:  # soft labels: fractions k / K
        z = (g.integers(0, soft_k + 1, shape) / soft_k).astype(np.float32)
    scalars = dict(lr=np.asarray(lrs, np.float32),
                   wd=np.full(r, 1e-3, np.float32),
                   step0=np.arange(r, dtype=np.float32) * 3,
                   count=np.asarray(counts, np.int32))
    return state, (u, i, j, z), scalars


def packed(mode, u, i, j, z, denom=1):
    bn = bm = 5
    uij = u | (i << bn) | (j << (bn + bm))
    if mode == "full":
        return (uij | (z.astype(np.int32) << (bn + 2 * bm)),), (
            "full", bn, bm, 1, 1)
    if mode == "uij":
        return (uij, z), ("uij", bn, bm, 0, denom)
    return (u, i, j, z), ("none", 0, 0, 0, 1)


def _check_against_pallas(state, stream, pack, sc):
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


@pytest.mark.parametrize("mode,soft_k", [
    pytest.param("full", None, id="full"),
    pytest.param("uij", None, id="uij"),
    pytest.param("none", None, id="none"),
    # Soft labels at K = 4 and 50 take the "uij" pack on the real path
    # (the numerator does not fit the word): z is a float32 fraction k / K.
    pytest.param("uij", 4, id="uij-soft4"),
    pytest.param("uij", 50, id="uij-soft50")])
def test_epoch_reference_matches_pallas(mode, soft_k):
    state, rows, sc = epoch_inputs(0, [70, 100], [1e-2, 3e-2], soft_k=soft_k)
    stream, pack = packed(mode, *rows, denom=soft_k or 1)
    _check_against_pallas(state, stream, pack, sc)


def test_epoch_reference_matches_pallas_bs1024():
    # A batch of 1,024 rows (above the 512 threads of a block) over 20 U
    # and 25 V rows: every row is named ~50-80 times per batch.
    state, rows, sc = epoch_inputs(3, [2048, 1500], [1e-2, 3e-2], bs=1024,
                                   nb=2)
    stream, pack = packed("full", *rows)
    _check_against_pallas(state, stream, pack, sc)


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
    # n = m = 1000, d = 2, bs = 64: 48,000 B of state and moments, 16,000
    # B of stamped list heads, and per batch row the links, touched-row
    # slots, contributions, (logit, z) pairs and loss sums — inside one
    # block's 232,448 B, three blocks to an SM.
    assert K.epoch_smem_bytes(1000, 1000, 2, 64) == 68_616
    assert 3 * (K.epoch_smem_bytes(1000, 1000, 2, 64) + 1024) <= 233_472
    assert K.epoch_kernel_supported(1000, 1000, 2, 64)
    assert pallas_epoch_supported(1000, 1000, 2, 1250, 64)
    # Past the reach of C = 16, the gate's largest cluster (n = m up to
    # 56,944 fit there: tests/test_torch_scale.py).
    assert K.epoch_kernel_supported(45_552, 45_552, 2, 64)
    assert not K.epoch_kernel_supported(60_000, 60_000, 2, 64)
    # Any batch size whose shared memory fits (no one-row-per-thread cap).
    assert K.epoch_kernel_supported(100, 100, 2, 1024)
    assert K.epoch_kernel_supported(1000, 1000, 2, 2048)
    assert not K.epoch_kernel_supported(1000, 1000, 2, 65_536)


@pytest.mark.parametrize("n,m,d,bs", [(1000, 1000, 2, 64), (20, 25, 3, 32),
                                      (3000, 4000, 4, 1024)])
def test_epoch_smem_at_every_cluster_size(n, m, d, bs):
    # C > 1: each block holds ceil(n / C) + ceil(m / C) rows, the state
    # once (Adam writes it in place), and the buffer the rows' owners push
    # each step's rows into, 3 * d floats a batch row for the whole batch
    # or as many rows as fit (one at least), with its 8-byte mbarrier: at
    # most that buffer above the C = 1 block.  The packed block is the
    # C = 1 block.
    for c in K.CLUSTER_SIZES + (K.PACKED,):
        rows = -(-n // max(c, 1)) + -(-m // max(c, 1))
        rest = 8 * rows + 4 * (3 * rows * d + bs * (14 + 2 * d) + 2)
        held = (min(bs, max(1, (232_448 - rest - 8) // (12 * d)))
                if c > 1 else 0)
        pushed = 8 + 12 * d * held if c > 1 else 0
        assert K.pushed_rows(n, m, d, bs, c) == held
        assert K.epoch_smem_bytes(n, m, d, bs, c) == rest + pushed
        assert (K.epoch_smem_bytes(n, m, d, bs, c)
                <= K.epoch_smem_bytes(n, m, d, bs) + pushed)
    assert K.epoch_smem_bytes(1000, 1000, 2, 64, 16) == 10_192
    # At the cells' shape every C > 1 block is smaller than the one before.
    at = [K.epoch_smem_bytes(1000, 1000, 2, 64, c) for c in (1, 2, 4, 8, 16)]
    assert at == sorted(at, reverse=True)


# Runs resident at once, by cluster size (clusters of C blocks of 512
# threads; C = 1 one block per SM), as a card's occupancy query might report
# them; 0 where the card does not schedule that size.
_OCCUPANCY = {
    "h100-like": {16: 8, 8: 16, 4: 33, 2: 66, 1: 132},
    "no-16": {16: 0, 8: 15, 4: 33, 2: 66, 1: 132},
    "none": {16: 0, 8: 0, 4: 0, 2: 0, 1: 132},
}


@pytest.mark.parametrize("card", list(_OCCUPANCY))
@pytest.mark.parametrize("runs", [1, 4, 8, 120, 310, 2000])
def test_choose_cluster(runs, card):
    table = _OCCUPANCY[card]
    asked = []

    def query(c):
        asked.append(c)
        return table[c]

    c = K.choose_cluster(runs, query)
    # Every run's cluster is resident at once, and no larger size would be;
    # more runs than one-block-per-SM holds take the packed kernel.
    assert c == K.PACKED or table[c] >= runs
    assert all(table[k] < runs for k in K.CLUSTER_SIZES if k > c)
    fits = [k for k in K.CLUSTER_SIZES if table[k] >= runs]
    assert c == (max(fits) if fits else K.PACKED)
    assert (c == K.PACKED) == (runs > table[1])
    assert asked == [k for k in K.CLUSTER_SIZES if k >= c][:len(asked)]
    if runs == 120:  # bench.py's sweep: one 512-thread block per run
        assert c == 1


def test_cluster_size_is_printed_once_per_choice(monkeypatch, capsys):
    table = _OCCUPANCY["h100-like"]
    monkeypatch.setattr(K, "epoch_occupancy",
                        lambda n, m, d, bs, c, idx: (3, table.get(c, 0)))
    monkeypatch.setattr(K, "_printed_clusters", set())
    assert K.cluster_size(8, 1000, 1000, 2, 64, "cuda:0") == 16
    assert "8 runs x 16 blocks per run" in capsys.readouterr().out
    assert K.cluster_size(8, 1000, 1000, 2, 64, "cuda:0") == 16
    assert capsys.readouterr().out == ""
    assert K.cluster_size(120, 1000, 1000, 2, 64, "cuda:0") == 1
    assert ("120 runs x 1 block per run of 512 threads"
            in capsys.readouterr().out)
    assert K.cluster_size(310, 1000, 1000, 2, 64, "cuda:0") == K.PACKED
    assert ("310 runs x 1 block per run of 256 threads"
            in capsys.readouterr().out)


@pytest.mark.parametrize("n,m,d,bs", [(20, 20, 2, 2560), (7071, 7071, 2, 64),
                                      (10_000, 10_000, 2, 2048),
                                      (10_000, 10_000, 3, 2048),
                                      (3000, 4000, 4, 1024),
                                      (300, 300, 8, 1024)])
def test_a_block_fits_at_every_c_from_the_floor(n, m, d, bs, monkeypatch):
    # A larger C takes rows off the block and leaves the pushed buffer more
    # room, so every C from the smallest that fits up fits too, with the
    # same or more batch rows a round; the chooser asks the card about
    # those C alone.  Each shape pushes its batch in rounds at some C.
    floor = K.min_cluster(n, m, d, bs)
    sizes = sorted(c for c in K.CLUSTER_SIZES if c >= floor)
    assert any(0 < K.pushed_rows(n, m, d, bs, c) < bs for c in sizes)
    held = [K.pushed_rows(n, m, d, bs, c) for c in sizes if c > 1]
    assert held == sorted(held)
    assert all(K.epoch_smem_bytes(n, m, d, bs, c) <= K.SMEM_PER_BLOCK
               for c in sizes)
    asked = []

    def occupancy(n_, m_, d_, bs_, c, idx):
        asked.append(c)
        return 1, _OCCUPANCY["h100-like"].get(c, 0)

    monkeypatch.setattr(K, "epoch_occupancy", occupancy)
    monkeypatch.setattr(K, "_printed_clusters", set())
    assert K.cluster_size(4, n, m, d, bs, "cuda:0") == 16
    assert min(asked) >= floor


class _FakeK1:
    """Stands in for the built ``epoch_kernel.cu`` on CPU tensors: records
    each launch's shape and writes a zero loss."""

    def __init__(self, monkeypatch, chosen=None):
        self.clusters = []
        monkeypatch.setattr(K, "_on", lambda dev: True)
        monkeypatch.setattr(K, "_library", lambda: self)
        monkeypatch.setattr(K._build, "stream_ptr", lambda dev: 0)
        if chosen is not None:
            monkeypatch.setattr(K, "cluster_size",
                                lambda *a, **k: chosen)

    def mfcd_train_epoch(self, *args):
        import ctypes

        loss, r = args[14], args[15]
        ctypes.memset(loss, 0, 4 * r)
        self.clusters.append(args[-2])
        return 0


def _epoch_args():
    state, rows, sc = epoch_inputs(2, [70, 100], [1e-2, 3e-2])
    stream, pack = packed("full", *rows)
    args = (tuple(torch.from_numpy(a.copy()) for a in stream),
            *(torch.from_numpy(sc[k]) for k in ("lr", "wd", "step0",
                                                "count")))
    return epoch_state_from_jax(*state), args, pack


@pytest.mark.parametrize("cluster", [None, K.PACKED, 1, 2, 4, 8, 16])
def test_push_launches_count_the_launches_at_c_above_1(cluster,
                                                       monkeypatch):
    # One count a launch at C > 1, the push path, none at C = 1 or packed;
    # with cluster None the chooser's C (here 16) counts.
    from mfcd_tpu_torch.utils import observability as obs

    fake = _FakeK1(monkeypatch, chosen=16)
    state, args, pack = _epoch_args()
    obs.reset()
    with obs.call("train_epoch", "cpu"):
        for _ in range(3):
            K._train_epoch(state, *args, pack=pack, cluster=cluster)
    c = 16 if cluster is None else cluster
    assert fake.clusters == [c] * 3
    counters = obs.calls()[-1]["counters"]
    assert counters.get(K.PUSH_LAUNCHES, 0) == (3 if c > 1 else 0)
    # Outside a call nothing is counted, and nothing raises.
    K._train_epoch(state, *args, pack=pack, cluster=cluster)


@pytest.mark.parametrize("chosen", [16, K.PACKED])
def test_push_launches_read_one_a_scan_epoch(chosen, monkeypatch):
    # A run through the kernel trainer launches K1 once an epoch: at C = 16
    # the call's counter reads the epoch count; at PACKED (the grid's large
    # chunk) it stays absent.
    from mfcd_tpu_torch.core.config import RunConfig
    from mfcd_tpu_torch.sweep.engine import run_config
    from mfcd_tpu_torch.utils import observability as obs

    fake = _FakeK1(monkeypatch, chosen=chosen)
    obs.reset()
    cfg = RunConfig(n=24, m=28, d=2, p=0.4, s=4.0, num_epochs=3, reps=2)
    with obs.call("parameter_scan", "cpu"):
        run_config(cfg, use_kernel=True, device="cpu")
    assert fake.clusters == [chosen] * 3
    counters = obs.calls()[-1]["counters"]
    assert counters.get(K.PUSH_LAUNCHES) == (3 if chosen == 16 else None)


def _loop_sum(rows, idx, vals):
    """Entry-order sums from 0, one float32 add at a time."""
    out = np.zeros((idx.shape[0], rows, vals.shape[-1]), np.float32)
    for r in range(idx.shape[0]):
        for e in range(idx.shape[1]):
            for k in range(vals.shape[-1]):
                out[r, idx[r, e], k] = np.float32(out[r, idx[r, e], k]
                                                  + vals[r, e, k])
    return out


@pytest.mark.parametrize("stream", ["random", "adversarial"])
def test_index_add_sums_in_entry_order(stream):
    # The order the CUDA kernel's entry lists reproduce: U over rows
    # 0..bs-1, V over i_0, j_0, i_1, j_1, ..., each sum starting from 0.
    g = np.random.default_rng(7)
    r, bs = 2, 64
    if stream == "random":
        u = g.integers(0, N, (r, bs))
        i = g.integers(0, M, (r, bs))
        j = (i + g.integers(1, M, (r, bs))) % M
    else:  # every row names U row 5; V alternates rows 3 and 4
        u = np.full((r, bs), 5)
        i = np.where(np.arange(bs) % 2 == 0, 3, 4)[None].repeat(r, 0)
        j = 7 - i
    gu = (g.standard_normal((r, bs, D)) * 10.0 ** g.integers(
        -4, 2, (r, bs, 1))).astype(np.float32)
    gv = g.standard_normal((r, bs, D)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got_u = K._index_add(N, t(u), t(gu)).numpy()
    np.testing.assert_array_equal(got_u, _loop_sum(N, u, gu))
    got_v = K._v_grad_interleaved(M, t(i), t(j), t(gv)).numpy()
    vi = np.stack([i, j], -1).reshape(r, 2 * bs)
    vv = np.stack([gv, -gv], -2).reshape(r, 2 * bs, D)
    np.testing.assert_array_equal(got_v, _loop_sum(M, vi, vv))
    if stream == "adversarial":
        assert np.count_nonzero(got_u.any(-1)) == r
        assert np.count_nonzero(got_v.any(-1)) == 2 * r


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


def test_build_target_follows_included_headers(tmp_path):
    # The library's name hashes the source and every csrc/ header it
    # includes: an edit to the shared epoch header rebuilds both epoch
    # kernel sources and neither the AltSVM kernel's nor the loss pass's,
    # which include no header, nor the threefry ones; an edit to
    # threefry.cuh rebuilds the prng and shuffle kernels only; an edit to a
    # header nothing includes rebuilds none.  No nvcc.
    import os
    import shutil

    from mfcd_tpu_torch.ops import _build

    for name in os.listdir(_build.CSRC):
        shutil.copy(os.path.join(_build.CSRC, name), tmp_path / name)
    every = sorted(str(p) for p in tmp_path.glob("*.cu"))
    assert [os.path.basename(p) for p in every] == [
        "altsvm_dcd.cu", "epoch_kernel.cu", "epoch_variants.cu",
        "loss_pass.cu", "prng_kernel.cu", "shuffle_kernel.cu"]
    alone, sources, fry = [every[0], every[3]], every[1:3], every[4:]
    for src in alone:
        assert _build._local_files(src) == [src]
    for src in sources:
        assert str(tmp_path / "epoch_body.cuh") in _build._local_files(src)
    for src in fry:
        assert _build._local_files(src) == [src,
                                            str(tmp_path / "threefry.cuh")]
    before = [_build._target(src) for src in sources]
    fry_before = [_build._target(src) for src in fry]
    alone_before = [_build._target(src) for src in alone]
    (tmp_path / "unused.cuh").write_text("// included by nothing\n")
    assert [_build._target(src) for src in sources] == before
    with open(tmp_path / "epoch_body.cuh", "a") as f:
        f.write("// touched\n")
    after = [_build._target(src) for src in sources]
    assert all(a != b for a, b in zip(before, after))
    assert all(os.path.basename(a).startswith(os.path.basename(b)[:-len(
        b.split("_")[-1])]) for a, b in zip(after, before))
    assert [_build._target(src) for src in alone] == alone_before
    assert [_build._target(src) for src in fry] == fry_before
    with open(tmp_path / "threefry.cuh", "a") as f:
        f.write("// touched\n")
    assert all(a != b for a, b in zip(
        fry_before, [_build._target(src) for src in fry]))
    assert [_build._target(src) for src in sources] == after
