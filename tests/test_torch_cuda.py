"""The CUDA kernels vs their plain PyTorch versions, on a card: the fused
epoch (K1) at every launch shape, R and batch size it takes, its five stage
variants (P1) and the factored-layout epoch (P2), which are K1's code and
take the same launch shapes and batch sizes (P1's ``full`` bit-equal to
K1), and AltSVM's phase kernel (K2); and every sampler, every generator,
the ground-truth oracle and AltSVM on the card against the CPU or the
sequential loop.

Imports neither jax nor ``mfcd_tpu``, so it runs on a machine with the card
and without jax::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Without a card every test skips (the kernel has no CPU mode).  Bounds: the
kernel rounds every multiply and add on its own, as the plain version
does, and sums gradient rows in batch order; the plain version's
``index_add_`` on the card adds with atomics, and the loss reductions run
in another order, so state, loss and the P1 variants' ``alive`` sums (the
check of each kept stage's work) agree to rtol 1e-5 / atol 1e-6.  K1 has
no float atomics: two launches, and launches at different launch shapes
(cluster sizes, one 512-thread block per run, packed), agree bit for bit;
so do P1's and P2's state and loss (their ``alive`` sums follow the row
split, and are held by the bound).  K2 runs a phase's steps out of pick
order, each row's writes in pick order, and sums and rounds as its plain
version does: bit-equal to it on the card and the CPU, at every launch
shape, and its schedule equal to the plain schedule.  The validation
pass's kernel (L1) sums a batch's rows and the epoch's means in another
order than its plain version: within rtol 1e-5 / atol 1e-6, two launches
a pass, the same bits on every pass and from either layout of the tables.
"""

import math

import numpy as np
import pytest
import torch

from mfcd_tpu_torch.convert import epoch_state_from_jax
from mfcd_tpu_torch.ops import kernel_split as KS
from mfcd_tpu_torch.ops import kernels as K
from mfcd_tpu_torch.train import kernel_trainer as KT

N, M, D, BS, B = 20, 25, 3, 32, 4


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed, n, m, d, bs, nb, counts, lrs, mode, dev, rows=None,
            soft_k=None):
    g = np.random.default_rng(seed)
    r = len(counts)
    state = [g.standard_normal((r, d, n)), g.standard_normal((r, d, m))]
    state += [np.abs(g.standard_normal(s.shape)) * 1e-2
              for s in (state[0], state[0], state[1], state[1])]
    shape = (r, nb, bs)
    u = g.integers(0, n, shape).astype(np.int32)
    i = g.integers(0, m, shape).astype(np.int32)
    j = ((i + g.integers(1, m, shape)) % m).astype(np.int32)
    if rows is not None:  # (u, i, j) drawn from rows(g, shape)
        u, i, j = (np.asarray(a, np.int32) for a in rows(g, shape))
    z = (g.random(shape) < 0.5).astype(np.float32)
    if soft_k:  # soft labels: fractions k / K
        z = (g.integers(0, soft_k + 1, shape) / soft_k).astype(np.float32)
    _, bn, bm, bz = KT._pack_spec(n, m, 1)
    uij = u | (i << bn) | (j << (bn + bm))
    stream, pack = {
        "full": ((uij | (z.astype(np.int32) << (bn + 2 * bm)),),
                 ("full", bn, bm, bz, 1)),
        "uij": ((uij, z), ("uij", bn, bm, 0, soft_k or 1)),
        "none": ((u, i, j, z), ("none", 0, 0, 0, 1)),
    }[mode]
    t = lambda a, dt=None: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                           device=dev)
    args = (tuple(t(a) for a in stream), t(lrs, torch.float32),
            t(np.full(r, 1e-3), torch.float32),
            t(np.arange(r) * 3.0, torch.float32), t(counts, torch.int32))
    return [a.astype(np.float32) for a in state], args, pack


def _compare(state, args, pack, dev, kernel=K.train_epoch,
             plain=K.train_epoch_reference, launches=lambda: K.EPOCH_LAUNCHES,
             layout=lambda a: a):
    make = lambda: K.EpochState(*(layout(a) for a in
                                  epoch_state_from_jax(*state, device=dev)))
    want = plain(make(), *args, pack=pack)
    before = launches()
    got = kernel(make(), *args, pack=pack)
    torch.cuda.synchronize()
    assert launches() == before + 1
    assert len(got) == len(want)
    for x, y in zip(want[0] + tuple(want[1:]), got[0] + tuple(got[1:])):
        torch.testing.assert_close(y, x, rtol=1e-5, atol=1e-6)
    return got


def _flat(out):
    return out[0] + tuple(out[1:])


def _k1(state, args, pack, dev, cluster):
    return _flat(K._train_epoch(epoch_state_from_jax(*state, device=dev),
                                *args, pack=pack, cluster=cluster))


def _large_r(dev) -> int:
    """Runs per chunk of ``parameter_scan_fast`` on this card for the
    reference grid at one p (n = m = 1000, d = 2, p = 0.2, 5 reps)."""
    from mfcd_tpu_torch.core.config import RunConfig
    from mfcd_tpu_torch.sweep import batched
    from mfcd_tpu_torch.sweep.engine import compile_caps

    cfg = RunConfig(n=1000, m=1000, d=2, p=0.2, reps=5)
    return cfg.reps * batched.default_max_bucket(
        cfg, t_cap=compile_caps(cfg)[0], device=dev)


# (mode, soft K, n, m, d, bs, padded batches, counts, lrs): the small shape
# in each pack; soft labels, z = k / K, through "uij" (the pack soft labels
# take at K >= 2); hard K = 10's stream at the canonical width (800,000
# rows: 12,500 of 16,384 padded batches executed, the last one partial).
K1_CASES = {
    "full": ("full", None, N, M, D, BS, B, [70, 100], [1e-2, 3e-2]),
    "uij": ("uij", None, N, M, D, BS, B, [70, 100], [1e-2, 3e-2]),
    "none": ("none", None, N, M, D, BS, B, [70, 100], [1e-2, 3e-2]),
    "uij-soft4": ("uij", 4, N, M, D, BS, B, [70, 100], [1e-2, 3e-2]),
    "uij-soft50": ("uij", 50, N, M, D, BS, B, [70, 100], [1e-2, 3e-2]),
    "full-k10": ("full", None, 1000, 1000, 2, 64, 16_384,
                 [800_000, 799_983], [1e-3, 1e-2]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K1_CASES))
def test_kernel_matches_plain_version(case):
    dev = _card()
    mode, soft_k, n, m, d, bs, nb, counts, lrs = K1_CASES[case]
    state, args, pack = _inputs(3, n, m, d, bs, nb, counts, lrs, mode, dev,
                                soft_k=soft_k)
    _compare(state, args, pack, dev)


@pytest.mark.cuda
def test_soft_label_peak_is_under_run_bytes():
    """Soft labels draw K votes per training triplet and average them: at
    K = 50 and the canonical width the hash words of those votes are a
    run's largest allocation (about 50 bytes a vote), which
    ``batched.run_bytes`` must count for the chunk size to hold."""
    import mfcd_tpu_torch
    from mfcd_tpu_torch.core.config import RunConfig
    from mfcd_tpu_torch.sweep import batched
    from mfcd_tpu_torch.sweep.engine import compile_caps

    dev = _card()
    grid = dict(n=1000, m=1000, d=2, p=0.2, s=5.0, K=50, soft_label=True,
                num_epochs=1, reps=2)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    mfcd_tpu_torch.parameter_scan_fast(device=dev, **grid)
    peak = (torch.cuda.max_memory_allocated(dev) - base) / grid["reps"]
    cfg = RunConfig(**grid)
    assert peak <= batched.run_bytes(cfg, compile_caps(cfg)[0])


@pytest.mark.cuda
def test_kernel_matches_plain_version_canonical_shape():
    dev = _card()
    state, args, pack = _inputs(4, 1000, 1000, 2, 64, 64, [4096, 2500],
                                [1e-3, 1e-2], "full", dev)
    _compare(state, args, pack, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("runs", [1, 4, 8, 120, "large"])
def test_kernel_matches_plain_version_at_every_r(runs):
    # R = 1, 4, 8, 120 (bench.py's sweep) and the large R of
    # parameter_scan_fast: every launch shape the chooser returns at the
    # canonical shape (16 batches).
    dev = _card()
    r = _large_r(dev) if runs == "large" else runs
    counts = [1024] * (r - 1) + [777]
    lrs = list(np.geomspace(1e-3, 1e-2, r))
    state, args, pack = _inputs(11, 1000, 1000, 2, 64, 16, counts, lrs,
                                "full", dev)
    c = K.cluster_size(r, 1000, 1000, 2, 64, dev)
    got = _flat(_compare(state, args, pack, dev))
    for other in (c, 1, K.PACKED):
        again = _k1(state, args, pack, dev, other)
        assert all(torch.equal(x, y) for x, y in zip(got, again)), other


def _edge_rows(n, m, c):
    """Rows drawn from the first and last row of every block's share at
    cluster size c (rows equal to the block's rank modulo c: the first c
    rows and the last c), and from the edges of c contiguous ranges of
    ceil(n / c) U and ceil(m / c) V rows."""
    edges = lambda k: np.unique(np.clip(np.concatenate(
        [np.arange(0, k, -(-k // c)), np.arange(0, k, -(-k // c)) - 1,
         np.arange(c), k - 1 - np.arange(c)]), 0, k - 1))

    def rows(g, shape):
        eu, ev = edges(n), edges(m)
        i = g.choice(ev, shape)
        j = g.choice(ev, shape)
        j = np.where(i == j, (i + 1) % m, j)
        return g.choice(eu, shape), i, j
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [K.PACKED, 1, 2, 4, 8, 16])
def test_kernel_at_every_cluster_size(cluster):
    # Rows at the edges of each block's share; two launches bit-equal, and
    # equal to one block per run, wide and packed, bit for bit.
    dev = _card()
    if cluster > 1 and K.epoch_occupancy(N, M, D, BS, cluster,
                                         dev.index or 0)[1] == 0:
        pytest.skip(f"the card does not schedule clusters of {cluster}")
    state, args, pack = _inputs(12, N, M, D, BS, B, [70, 100, 128],
                                [1e-2, 3e-2, 2e-2], "full", dev,
                                rows=_edge_rows(N, M, max(cluster, 1)))
    want = _flat(K.train_epoch_reference(
        epoch_state_from_jax(*state, device=dev), *args, pack=pack))
    got = _k1(state, args, pack, dev, cluster)
    torch.cuda.synchronize()
    for x, y in zip(want, got):
        torch.testing.assert_close(y, x, rtol=1e-5, atol=1e-6)
    for other in (_k1(state, args, pack, dev, cluster),
                  _k1(state, args, pack, dev, 1),
                  _k1(state, args, pack, dev, K.PACKED)):
        assert all(torch.equal(x, y) for x, y in zip(got, other))


def _scheduled(n, dev, floor):
    """The launch shapes from ``floor`` up that the card schedules."""
    return [c for c in K.CLUSTER_SIZES if c >= floor and K.epoch_occupancy(
        n, n, 2, 64, c, dev.index or 0)[1] > 0]


@pytest.mark.cuda
@pytest.mark.parametrize("n,floor", [(5000, 2), (10_000, 4)])
def test_kernel_at_a_floor(n, floor):
    # n = m past one block a run (smallest C 2 and 4), pack "none": against
    # the plain version, rows at the edges of each share, and bit-equal at
    # every C from the floor the card schedules; below it (and packed) the
    # launch is refused before it reaches the card.
    dev = _card()
    assert K.min_cluster(n, n, 2, 64) == floor
    state, args, pack = _inputs(21, n, n, 2, 64, 16, [1024, 1000, 777],
                                [1e-3, 3e-3, 1e-2], "none", dev,
                                rows=_edge_rows(n, n, floor))
    assert pack[0] == "none"
    got = _flat(_compare(state, args, pack, dev))
    shapes = _scheduled(n, dev, floor)
    assert K.cluster_size(3, n, n, 2, 64, dev) in shapes
    for c in shapes:
        again = _k1(state, args, pack, dev, c)
        assert all(torch.equal(x, y) for x, y in zip(got, again)), c
    for bad in (K.PACKED,) + tuple(k for k in (1, 2) if k < floor):
        before = K.EPOCH_LAUNCHES
        with pytest.raises(ValueError, match="smallest C that fits this "
                                             f"shape is {floor}"):
            _k1(state, args, pack, dev, bad)
        assert K.EPOCH_LAUNCHES == before


@pytest.mark.cuda
def test_kernel_in_two_waves():
    # One run more than the card holds at once at the floor: the clusters
    # queue in a second wave, with the same bits as the plain version's
    # bound and as every other launch shape.
    dev = _card()
    n = 5000
    floor = K.min_cluster(n, n, 2, 64)
    held = K.epoch_occupancy(n, n, 2, 64, floor, dev.index or 0)[1]
    r = held + 1
    state, args, pack = _inputs(22, n, n, 2, 64, 4, [256] * (r - 1) + [200],
                                list(np.geomspace(1e-3, 1e-2, r)), "none",
                                dev)
    assert K.cluster_size(r, n, n, 2, 64, dev) == floor
    got = _flat(_compare(state, args, pack, dev))
    for c in _scheduled(n, dev, floor):
        again = _k1(state, args, pack, dev, c)
        assert all(torch.equal(x, y) for x, y in zip(got, again)), c


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "canonical"])
def test_kernel_matches_plain_version_bs1024(shape):
    # Batches of 1,024 rows, above the block's thread count.
    dev = _card()
    if shape == "small":
        state, args, pack = _inputs(13, N, M, D, 1024, 2, [2048, 1500],
                                    [1e-2, 3e-2], "full", dev)
    else:
        state, args, pack = _inputs(14, 1000, 1000, 2, 1024, 8,
                                    [8192, 5000], [1e-3, 1e-2], "full", dev)
    _compare(state, args, pack, dev)


@pytest.mark.cuda
def test_kernel_matches_plain_version_adversarial_stream():
    # Every row of a batch names one U row and alternates two V rows: each
    # of those rows is named 64 times per batch of 64.
    dev = _card()

    def rows(g, shape):
        alt = np.arange(shape[-1]) % 2 == 0
        i = np.broadcast_to(np.where(alt, 124, 125), shape)
        return np.full(shape, 62), i, 249 - i
    state, args, pack = _inputs(15, 1000, 1000, 2, 64, 16, [1024, 1000],
                                [1e-3, 1e-2], "full", dev, rows=rows)
    _compare(state, args, pack, dev)


def _same_rows(g, shape):
    """Every batch row the same (u, i, j): one owner pushes all of them."""
    return np.full(shape, 517), np.full(shape, 3), np.full(shape, 998)


# The push path (C > 1): (n, d, bs, batches, counts, rows); counts leave a
# masked tail in the last executed batch.  At n = 10,000, bs = 2,048 no
# block holds the whole batch's rows: C = 8 pushes them in rounds of 207
# rows, C = 16 of 1,874 (d = 2) or 377 (d = 3), so each step reuses the
# buffer several times.
PUSH_CASES = {
    "canonical": (1000, 2, 64, 16, [1024, 1000, 961], None),
    "idle-run": (1000, 2, 64, 16, [1024, 0, 65], None),
    "same-row": (1000, 2, 64, 16, [1024, 999, 700], _same_rows),
    "bs1024": (1000, 2, 1024, 4, [4096, 3001, 2048], None),
    "d8": (1000, 8, 64, 16, [1024, 1000, 777], None),
    "d3-edges": (1000, 3, 64, 8, [512, 450, 65], _edge_rows(1000, 1000, 16)),
    "bs2048-rounds": (10_000, 2, 2048, 4, [8192, 3001, 2053], None),
    "d3-rounds": (10_000, 3, 2048, 4, [8192, 2049, 700], None),
    "same-row-rounds": (10_000, 2, 2048, 4, [8192, 4000, 2100], _same_rows),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PUSH_CASES))
def test_push_path_is_bit_equal_at_every_launch_shape(case):
    # Each step's rows pushed by their owners into every block of the
    # cluster: against the plain version, and bit-equal at every C the card
    # schedules (the blocks' C > 1), and at C = 1 and packed where those
    # fit.  A block's pushes into a peer wait only on the cluster barrier,
    # whose arrive, after the peer's reads of its buffer, is relaxed: it
    # orders no memory.  The reads are done by then because every value
    # they load feeds the logit and the stores before the arrive (the
    # built code issues no fence there).  A push that overtook a read
    # would change a row of some step, and so the bits here; the rounds
    # cases reuse the buffer within a step too.
    dev = _card()
    n, d, bs, nb, counts, rows = PUSH_CASES[case]
    r = len(counts)
    state, args, pack = _inputs(51, n, n, d, bs, nb, counts,
                                list(np.geomspace(1e-3, 1e-2, r)), "full",
                                dev, rows=rows)
    floor = K.min_cluster(n, n, d, bs)
    shapes = [c for c in K.CLUSTER_SIZES if c > 1 and c >= floor
              and K.epoch_smem_bytes(n, n, d, bs, c) <= K.SMEM_PER_BLOCK
              and K.epoch_occupancy(n, n, d, bs, c, dev.index or 0)[1] > 0]
    assert shapes
    if bs <= 1024:
        got = _flat(_compare(state, args, pack, dev))
    else:
        # K1 sums the epoch's loss over the batch's rows one after another
        # in float32: over 2,048 rows it reads up to 2.3e-5 (relative) from
        # the plain version's masked means, in the gathered layout's K1 as
        # here (the same bits).  The state is held to the plain version,
        # the loss to every launch shape's.
        state_only = lambda f: lambda *a, **k: (f(*a, **k)[0],)
        _compare(state, args, pack, dev, kernel=state_only(K.train_epoch),
                 plain=state_only(K.train_epoch_reference))
        got = _k1(state, args, pack, dev, shapes[0])
    for c in shapes + ([1, K.PACKED] if floor == 1 else []):
        again = _k1(state, args, pack, dev, c)
        assert all(torch.equal(x, y) for x, y in zip(got, again)), c


# Cell 13's widths (the benchmark's d.scan): n = m = 1000, R = 5 runs of a
# p = 1.0 stream, 400,000 training rows a run less a masked tail in some,
# three epochs carried from one launch to the next.  (d, bs, the launch
# shapes besides the chooser's): at d = 10 the floor is C = 2; at bs = 512
# a block at C = 2 holds 290 of the batch's pushed rows, so each step
# takes its batch in two rounds.  Learning rates 5e-4 to 2e-3, about the
# study's 1e-3: the labels here are coin flips, so training draws U and V
# into the saddle at zero (loss ln 2).  At 5.6e-3 and 1e-2 they reach it
# in the first epoch and sink to float32's subnormal range, where the
# last bits decide when a run leaves the saddle: in the third epoch K1
# and the plain version part there by up to 0.09, at d = 2 as at d = 10.
D_SCAN = {
    "d4": (4, 64, ()),
    "d6": (6, 64, ()),
    "d8": (8, 64, ()),
    "d10": (10, 64, (2,)),
    "d10-bs512-rounds": (10, 512, (2,)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(D_SCAN))
def test_k1_at_cell_13s_widths_for_three_epochs(case):
    # K1 at the chooser's C, and at the floor where it is another, against
    # the plain version epoch by epoch, and bit-equal to each other.
    dev = _card()
    d, bs, others = D_SCAN[case]
    n, rows = 1000, 400_000
    counts = [rows, rows - 37, rows - 19, rows, rows - 63]
    floor = K.min_cluster(n, n, d, bs)
    assert floor == (2 if d == 10 else 1)
    for c in others:
        assert c == floor
        assert (K.pushed_rows(n, n, d, bs, c) < bs) == (bs == 512)
    state, args, pack = _inputs(60 + d, n, n, d, bs, -(-rows // bs), counts,
                                list(np.geomspace(5e-4, 2e-3, 5)), "full",
                                dev)
    stream, lr, wd, _, count = args
    make = lambda: K.EpochState(*epoch_state_from_jax(*state, device=dev))
    want = make()
    got = {c: make() for c in (None,) + others}
    for epoch in range(3):
        step0 = (epoch * ((count + bs - 1) // bs)).to(torch.float32)
        want, want_loss = K.train_epoch_reference(want, stream, lr, wd,
                                                  step0, count, pack=pack)
        out = {}
        for c in got:
            got[c], loss = K._train_epoch(got[c], stream, lr, wd, step0,
                                          count, pack=pack, cluster=c)
            out[c] = tuple(got[c]) + (loss,)
        torch.cuda.synchronize()
        for x, y in zip(tuple(want) + (want_loss,), out[None]):
            torch.testing.assert_close(y, x, rtol=1e-5, atol=1e-6)
        for c in others:
            assert all(torch.equal(x, y) for x, y in zip(out[None], out[c]))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    dev = _card()
    state, args, pack = _inputs(5, N, M, D, BS, B, [70, 100], [1e-2, 3e-2],
                                "full", dev)
    st = epoch_state_from_jax(*state, device=dev)
    with pytest.raises(TypeError):
        K.train_epoch(st, args[0], args[1].double(), *args[2:], pack=pack)
    with pytest.raises(ValueError):
        K.train_epoch(st, args[0], args[1].cpu(), *args[2:], pack=pack)
    with pytest.raises(ValueError):
        K.train_epoch(st._replace(u_t=st.u_t.transpose(1, 2).contiguous()
                                  .transpose(1, 2)), *args, pack=pack)
    with pytest.raises(ValueError, match="cluster"):
        K._train_epoch(st, *args, pack=pack, cluster=3)
    with pytest.raises(TypeError):  # the launch shape is not public
        K.train_epoch(st, *args, pack=pack, cluster=1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(KS.VARIANTS))
@pytest.mark.parametrize("shape", ["small", "canonical"])
def test_variant_kernel_matches_plain_version(name, shape):
    dev = _card()
    if shape == "small":
        state, args, pack = _inputs(6, N, M, D, BS, B, [70, 100],
                                    [1e-2, 3e-2], "full", dev)
    else:
        state, args, pack = _inputs(7, 1000, 1000, 2, 64, 64, [4096, 2500],
                                    [1e-3, 1e-2], "full", dev)
    stages = KS.VARIANTS[name]
    _compare(state, args, pack, dev,
             kernel=lambda *a, **k: KS.train_epoch_variant(*a, **k,
                                                           stages=stages),
             plain=lambda *a, **k: KS.train_epoch_variant_reference(
                 *a, **k, stages=stages),
             launches=lambda: KS.VARIANT_LAUNCHES[name])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "canonical"])
def test_factored_kernel_matches_plain_version(shape):
    dev = _card()
    if shape == "small":
        state, args, pack = _inputs(8, N, M, D, BS, B, [70, 100],
                                    [1e-2, 3e-2], "full", dev)
    else:
        state, args, pack = _inputs(9, 1000, 1000, 2, 64, 64, [4096, 2500],
                                    [1e-3, 1e-2], "full", dev)
    _compare(state, args, pack, dev, kernel=KS.train_epoch_factored,
             plain=KS.train_epoch_factored_reference,
             launches=lambda: KS.FACTORED_LAUNCHES,
             layout=KS.to_factored_layout)


@pytest.mark.cuda
def test_split_kernels_reject_what_they_do_not_take():
    dev = _card()
    state, args, pack = _inputs(10, N, M, D, BS, B, [70, 100], [1e-2, 3e-2],
                                "uij", dev)
    st = epoch_state_from_jax(*state, device=dev)
    with pytest.raises(ValueError, match="only 'full'"):
        KS.train_epoch_variant(st, *args, pack=pack, stages=())
    state, args, pack = _inputs(10, N, M, D, BS, B, [70, 100], [1e-2, 3e-2],
                                "full", dev)
    st = epoch_state_from_jax(*state, device=dev)
    with pytest.raises(TypeError):
        KS.train_epoch_variant(st, args[0], args[1].double(), *args[2:],
                               pack=pack, stages=())
    with pytest.raises(ValueError, match="shape"):
        KS.train_epoch_factored(st, *args, pack=pack)


SPLIT_KERNELS = list(KS.VARIANTS) + [KS.FACTORED]


def _split_call(kernel, cluster=None):
    """(kernel call at ``cluster``, plain version, launch count, layout) of
    P1 variant or P2 ``kernel``."""
    if kernel == KS.FACTORED:
        return (lambda *a, **k: KS._train_epoch_factored(*a, **k,
                                                         cluster=cluster),
                KS.train_epoch_factored_reference,
                lambda: KS.FACTORED_LAUNCHES, KS.to_factored_layout)
    stages = KS.VARIANTS[kernel]
    return (lambda *a, **k: KS._train_epoch_variant(*a, **k, stages=stages,
                                                    cluster=cluster),
            lambda *a, **k: KS.train_epoch_variant_reference(
                *a, **k, stages=stages),
            lambda: KS.VARIANT_LAUNCHES[kernel], lambda a: a)


def _split_flat(state, args, pack, dev, kernel, cluster):
    call, _, _, layout = _split_call(kernel, cluster)
    return _flat(call(K.EpochState(*(layout(a) for a in epoch_state_from_jax(
        *state, device=dev))), *args, pack=pack))


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [K.PACKED, 1, 2, 4, 8, 16])
@pytest.mark.parametrize("kernel", SPLIT_KERNELS)
def test_split_kernel_at_every_cluster_size(kernel, cluster):
    # Rows at the edges of each block's share (P2 over tables of 1,024
    # rows, its layout's own): against the plain version; state and loss
    # bit-equal to two launches at this shape, one block per run and
    # packed.
    dev = _card()
    n, m = (KS.FACTORED_ROWS,) * 2 if kernel == KS.FACTORED else (N, M)
    if cluster > 1 and K.epoch_occupancy(n, m, D, BS, cluster,
                                         dev.index or 0)[1] == 0:
        pytest.skip(f"the card does not schedule clusters of {cluster}")
    state, args, pack = _inputs(16, n, m, D, BS, B, [70, 100, 128],
                                [1e-2, 3e-2, 2e-2], "full", dev,
                                rows=_edge_rows(n, m, max(cluster, 1)))
    call, plain, launches, layout = _split_call(kernel, cluster)
    got = _compare(state, args, pack, dev, kernel=call, plain=plain,
                   launches=launches, layout=layout)
    for other in (cluster, 1, K.PACKED):
        again = _split_flat(state, args, pack, dev, kernel, other)
        assert all(torch.equal(x, y) for x, y in zip(got[0] + got[1:2],
                                                     again[:7])), other


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", SPLIT_KERNELS)
@pytest.mark.parametrize("shape", ["small", "canonical"])
def test_split_kernel_matches_plain_version_bs1024(kernel, shape):
    # Batches of 1,024 rows, above the block's thread count.
    dev = _card()
    if shape == "small":
        state, args, pack = _inputs(17, N, M, D, 1024, 2, [2048, 1500],
                                    [1e-2, 3e-2], "full", dev)
    else:
        state, args, pack = _inputs(18, 1000, 1000, 2, 1024, 8,
                                    [8192, 5000], [1e-3, 1e-2], "full", dev)
    call, plain, launches, layout = _split_call(kernel)
    _compare(state, args, pack, dev, kernel=call, plain=plain,
             launches=launches, layout=layout)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", SPLIT_KERNELS)
def test_split_kernel_matches_plain_version_adversarial_stream(kernel):
    # One U row and two alternating V rows, each named by every batch row:
    # the long lists' scan (and P2's even-then-odd V sums).
    dev = _card()

    def rows(g, shape):
        alt = np.arange(shape[-1]) % 2 == 0
        i = np.broadcast_to(np.where(alt, 124, 125), shape)
        return np.full(shape, 62), i, 249 - i
    state, args, pack = _inputs(19, 1000, 1000, 2, 64, 16, [1024, 1000],
                                [1e-3, 1e-2], "full", dev, rows=rows)
    call, plain, launches, layout = _split_call(kernel)
    _compare(state, args, pack, dev, kernel=call, plain=plain,
             launches=launches, layout=layout)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [K.PACKED, 1, 8])
@pytest.mark.parametrize("shape", ["small", "canonical"])
def test_full_variant_is_k1_bit_for_bit(cluster, shape):
    # P1's full is K1's code built again: the same bits at the same shape.
    dev = _card()
    if shape == "small":
        state, args, pack = _inputs(20, N, M, D, BS, B, [70, 100],
                                    [1e-2, 3e-2], "full", dev)
    else:
        state, args, pack = _inputs(21, 1000, 1000, 2, 64, 64, [4096, 2500],
                                    [1e-3, 1e-2], "full", dev)
    n, m, d, bs = (N, M, D, BS) if shape == "small" else (1000, 1000, 2, 64)
    if cluster > 1 and K.epoch_occupancy(n, m, d, bs, cluster,
                                         dev.index or 0)[1] == 0:
        pytest.skip(f"the card does not schedule clusters of {cluster}")
    k1 = _k1(state, args, pack, dev, cluster)
    full = _split_flat(state, args, pack, dev, "full", cluster)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(k1, full[:7]))
    assert not full[7].any()


SAMPLERS = ("random", "proximity", "top_k", "svd", "margin", "variance",
            "popularity", "cluster", "user_similarity")


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", SAMPLERS)
def test_sampler_on_the_card_matches_the_cpu(strategy):
    """``sample_and_split`` on the card and on the CPU from the same X and
    streams (n = 50, m = 120, p = 0.3, capped budgets): the integer maps
    bit-equal; the strategies that select by a float within the bounds of
    ``chip_smoke.py`` [6], a 99 % share of split rows (as a set) and the
    counts within 0.5 %."""
    from mfcd_tpu_torch.core import prng, rng
    from mfcd_tpu_torch.core.config import RunConfig
    from mfcd_tpu_torch.data.btl import sample_and_split
    from mfcd_tpu_torch.genx import generate_x
    from mfcd_tpu_torch.sweep.engine import compile_caps

    dev = _card()
    cfg = RunConfig(n=50, m=120, d=2, p=0.3, strategy=strategy, reps=2)
    sh = cfg.shapes()
    t_cap, extra_cap = compile_caps(cfg)

    def run(d, x=None):
        keys = rng.rep_keys(rng.config_key(prng.key(0, device=d), 3)[None],
                            2).reshape(2, 2)
        st = rng.rep_streams(keys)
        if x is None:
            x = generate_x(st["x_gen"], cfg.n, cfg.m, cfg.d)
        b = lambda v: torch.full((2,), v, dtype=torch.int32, device=d)
        return x, sample_and_split(st, x, t_cap, extra_cap, strategy,
                                   budget=b(sh.num_triplets),
                                   extra_budget=b(sh.extra_test_triplets))

    x, card = run(dev)
    _, cpu = run(torch.device("cpu"), x.cpu())
    for r in range(2):
        if strategy in ("random", "proximity", "top_k"):
            for f in card._fields[1:]:
                assert torch.equal(getattr(card, f)[r].cpu(),
                                   getattr(cpu, f)[r]), f
            continue
        rows = lambda sp: {tuple(t) for f in ("train", "val", "test")
                           for t in getattr(sp, f)[r, :int(getattr(
                               sp, f + "_count")[r])].cpu().tolist()}
        a, b = rows(card), rows(cpu)
        assert len(a & b) >= 0.99 * len(b)
        for f in ("train_count", "val_count", "test_count"):
            p, q = int(getattr(card, f)[r]), int(getattr(cpu, f)[r])
            assert abs(p - q) <= 0.005 * max(q, 1), f


GENERATIONS = ("low_rank", "clustered", "structured", "svd", "correlated",
               "graph", "social", "temporal", "hierarchical", "gmm")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", GENERATIONS)
def test_generator_on_the_card_matches_the_cpu(mode):
    """``generate_x`` on the card and on the CPU from the same keys (n = 60,
    m = 80, d = 3, R = 2), within ``chip_smoke.py`` [7]'s bound of 1e-4 x
    max|X| + 1e-6; svd's singular vectors up to their signs within its
    conditioning bound, and X where no mode's sign flipped; clustered and
    gmm where every label agrees (at least 99 % of them must)."""
    from mfcd_tpu_torch.core import prng
    from mfcd_tpu_torch.genx import clusters, generate_x, generators

    dev = _card()
    n, m, d = 60, 80, 3
    keys = lambda dv: prng.fold_in(prng.key(7, device=dv),
                                   torch.arange(2, device=dv))
    kc, kp = keys(dev), keys(torch.device("cpu"))
    card = generate_x(kc, n, m, d, mode).cpu()
    cpu = generate_x(kp, n, m, d, mode)
    assert card.shape == (2, n, m) and torch.isfinite(card).all()
    compare = True
    if mode == "svd":
        # Each top singular vector up to its sign, within 10 eps s_1 / gap
        # of the CPU's (gap: from s_k to its nearest neighbour).
        uc = generators.svd_modes(kc, n, m, d)[0].cpu()
        up, sp, _ = generators.svd_modes(kp, n, m, d)
        sign = torch.sign(torch.sum(uc * up, dim=-2, keepdim=True))
        s = sp.double()
        above = torch.cat([torch.full_like(s[:, :1], math.inf),
                           s[:, :d - 1] - s[:, 1:d]], dim=-1)
        gap = torch.minimum(above, s[:, :d] - s[:, 1:d + 1])
        err = (uc * sign - up).norm(dim=-2).double()
        assert (err <= 10 * 2.0 ** -24 * s[:, :1] / gap).all()
        compare = bool((sign > 0).all())
    elif mode in ("clustered", "gmm"):
        def labels(k):     # the items' k-means, or their GMM fit
            if mode == "clustered":
                kx, kk = prng.split(k).unbind(-2)
                x = generators.generate_base(kx, n, m, d)
                return clusters.kmeans(kk, x.transpose(-1, -2), 5)[0].cpu()
            ks = prng.split(k, 4)
            return clusters.gmm_fit_predict(
                ks[..., 3, :], prng.normal(ks[..., 1, :], (m, d)), 5)[0].cpu()
        share = float((labels(kc) == labels(kp)).double().mean())
        assert share >= 0.99
        compare = share == 1.0
    if compare:
        err = float((card - cpu).abs().max())
        assert err <= 1e-4 * float(cpu.abs().max()) + 1e-6, err


@pytest.mark.cuda
def test_ground_truth_on_the_card_matches_the_cpu():
    """``parameter_scan_ground_truth`` with ``device=None`` runs on the card
    and agrees with the CPU within ``chip_smoke.py``'s 2e-3; no epoch
    kernel launch."""
    import mfcd_tpu_torch

    _card()
    grid = dict(n=60, m=80, d=2, p=[0.1, 0.3], s=[1.0, 5.0], reps=2,
                generation=["base", "gmm"])
    before = K.EPOCH_LAUNCHES
    card = mfcd_tpu_torch.parameter_scan_ground_truth(**grid)
    cpu = mfcd_tpu_torch.parameter_scan_ground_truth(device="cpu", **grid)
    assert K.EPOCH_LAUNCHES == before
    assert len(card) == len(cpu) == 8
    for a, b in zip(card, cpu):
        assert a["params"] == b["params"]
        for k in ("gt_loss", "gt_accuracy"):
            np.testing.assert_allclose(a["results"][k], b["results"][k],
                                       rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_study_sweep_on_the_card_reaches_k1_and_matches_the_cpu():
    """The study's sweep ``generation_s_sweep`` (n = m = 20, low_rank, 10
    s values, reps = 1) through the fast path with ``device=None``: it
    launches the epoch kernel, and its 23 keys agree with the same call on
    the CPU within ``chip_smoke.py``'s card-vs-CPU bar (rtol, atol 2e-3)."""
    from mfcd_tpu_torch.core.results import RESULT_KEYS
    from mfcd_tpu_torch.experiments import runs

    _card()
    kw = dict(scale=0.02, reps=1, generations=("low_rank",), fast=True)
    before = K.EPOCH_LAUNCHES
    card = runs.generation_s_sweep(**kw)["low_rank"]
    assert K.EPOCH_LAUNCHES > before
    cpu = runs.generation_s_sweep(device="cpu", **kw)["low_rank"]
    assert len(card) == len(cpu) == 10
    for a, b in zip(card, cpu):
        assert a["params"] == b["params"]
        for k in RESULT_KEYS:
            for x, y in zip(a["results"][k], b["results"][k]):
                np.testing.assert_allclose(np.asarray(x, np.float64),
                                           np.asarray(y, np.float64),
                                           rtol=2e-3, atol=2e-3, err_msg=k)


def _comparisons(dev, n, m, t, seed, skew=False, same=0.0):
    """``t`` comparisons over n users and m items: j and k uniform with
    k != j, or (``skew``) each drawn with probability proportional to
    1 / rank (a few items in most comparisons); then a share ``same`` of
    them made k = j."""
    g = np.random.default_rng(seed)
    users = g.integers(0, n, t)
    if skew:
        p = 1.0 / np.arange(1, m + 1)
        mj, mk = (g.choice(m, t, p=p / p.sum()) for _ in range(2))
    else:
        mj = g.integers(0, m, t)
        mk = (mj + 1 + g.integers(0, m - 1, t)) % m
    if same:
        mk = np.where(g.random(t) < same, mj, mk)
    prefs = np.where(g.random(t) < 0.5, 1.0, -1.0)
    return tuple(torch.as_tensor(a, dtype=dt, device=dev) for a, dt in (
        (users, torch.int32), (mj, torch.int32), (mk, torch.int32),
        (prefs, torch.float32)))


def _dcd_args(dev, phase, n, m, f, t, seed, **kw):
    """One phase's arguments from a random table (items: V, users: U),
    duals in [0, 1] and 3 sweeps of picks."""
    from mfcd_tpu_torch.core import prng
    from mfcd_tpu_torch.models import altsvm

    g = np.random.default_rng(seed)
    rows = {"items": (m, n), "users": (n, m)}[phase]
    table, fixed = (torch.as_tensor(g.standard_normal((r, f)),
                                    dtype=torch.float32, device=dev)
                    for r in rows)
    dual = torch.as_tensor(g.random(t), dtype=torch.float32, device=dev)
    picks = altsvm._picks(prng.key(seed, device=dev), t, 3)
    return (phase, table, fixed, dual, picks,
            *_comparisons(dev, n, m, t, seed, **kw), 0.1, 1.0)


def _assert_bit_equal(ref, got):
    for a, b in zip(ref, got):
        assert torch.equal(a.to(b.device), b), float(
            (a.to(b.device) - b).abs().max())


# (n, m, f, T, comparisons): f = 7 leaves some of a lane's register-held
# components empty; f = 45 reads the rows twice (no components held);
# f = 32 at MovieLens-100k's 943 x 1682 leaves the written table alone in
# shared memory, and f = 64 puts either table past it (the global-table
# instantiation); a 3-row written table makes
# nearly every step wait on the one before; the skewed set lengthens the
# item chain; "same" has a tenth of its comparisons with k == j.
DCD_CASES = {
    "f7": (30, 40, 7, 300, {}),
    "f20": (30, 40, 20, 300, {}),
    "f45": (30, 40, 45, 300, {}),
    "f32": (943, 1682, 32, 300, {}),
    "f64": (943, 1682, 64, 300, {}),
    "three_rows": (3, 3, 20, 300, {}),
    "skewed": (30, 400, 20, 1000, {"skew": True}),
    "same": (30, 40, 20, 300, {"same": 0.1}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["items", "users"])
@pytest.mark.parametrize("case", list(DCD_CASES))
def test_dcd_kernel_matches_plain_version(phase, case):
    """K2 against its plain version on the card and on the CPU: one phase of
    3 sweeps, from a random table and duals in [0, 1].  The kernel runs the
    steps out of pick order, each row's writes in pick order, and sums and
    rounds as the plain version does: bit-equal; the inputs are left as
    they were, one launch of each kernel counted."""
    from mfcd_tpu_torch.ops import altsvm_kernels as AK

    dev = _card()
    n, m, f, t, kw = DCD_CASES[case]
    args = _dcd_args(dev, phase, n, m, f, t, f + t, **kw)
    table, dual = args[1], args[3]
    if case in ("f32", "f64"):
        assert AK.dcd_mode(table.shape[0], args[2].shape[0], f) == {
            "f32": "written", "f64": "global"}[case]
    keep = [table.clone(), dual.clone()]
    want = AK.dcd_phase_reference(*args)
    cpu = AK.dcd_phase(*(a.cpu() if isinstance(a, torch.Tensor) else a
                         for a in args))
    before = dict(AK.DCD_LAUNCHES), dict(AK.SCHEDULE_LAUNCHES)
    got = AK.dcd_phase(*args)
    torch.cuda.synchronize()
    for count, was in zip((AK.DCD_LAUNCHES, AK.SCHEDULE_LAUNCHES), before):
        assert count == dict(was, **{phase: was[phase] + 1})
    assert torch.equal(keep[0], table) and torch.equal(keep[1], dual)
    _assert_bit_equal(want, got)
    _assert_bit_equal(cpu, got)


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["items", "users"])
def test_dcd_launch_shapes_bit_equal(phase):
    """Every table placement, forced, at f = 20 (components held in
    registers) and f = 24 (rows read twice): the same bits as the CPU's
    plain version, on a skewed set with some k == j."""
    from mfcd_tpu_torch.ops import altsvm_kernels as AK

    dev = _card()
    for f in (20, 24):
        args = _dcd_args(dev, phase, 20, 50, f, 500, 3, skew=True,
                         same=0.05)
        cpu = AK.dcd_phase(*(a.cpu() if isinstance(a, torch.Tensor) else a
                             for a in args))
        for mode in AK.MODES:
            _assert_bit_equal(cpu, AK._dcd_phase(*args, mode=mode))


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["items", "users"])
@pytest.mark.parametrize("t", [1, 37, 5000])
def test_dcd_schedule_matches_reference(phase, t):
    """The schedule's kernels against the plain records (comparison, label,
    versions, curvature bits), over one chunk and over many (t = 5000: 59
    warps for users, 118 for items), on a skewed set with some k == j."""
    from mfcd_tpu_torch.ops import altsvm_kernels as AK

    dev = _card()
    args = _dcd_args(dev, phase, 20, 50, 20, t, t, skew=True, same=0.1)
    fixed, picks, ints, prefs = args[2], args[4], args[5:8], args[8]
    rows = args[1].shape[0]
    got = AK.dcd_schedule(phase, fixed, picks, *ints, prefs, 0.1, rows)
    want = AK.dcd_records_reference(phase, *(a.cpu() for a in (
        fixed, picks, *ints, prefs)), 0.1)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_dcd_phase_raises_where_a_launch_does_not_fit():
    """A forced placement past a block's shared memory raises: nothing
    falls back to another launch."""
    from mfcd_tpu_torch.ops import altsvm_kernels as AK

    dev = _card()
    args = _dcd_args(dev, "users", 943, 1682, 64, 50, 1)
    with pytest.raises(ValueError, match="does not fit"):
        AK._dcd_phase(*args, mode="both")
    with pytest.raises(ValueError, match="does not fit"):
        AK._dcd_phase(*args, mode="written")


@pytest.mark.cuda
def test_train_altsvm_on_the_card_matches_the_cpu():
    """``train_altsvm`` on CUDA tensors: 2 K2 launches an epoch, the
    visiting order drawn on the card; 2 epochs agree with the CPU's plain
    version within 1e-5 x max|ref| + 1e-12 per tensor."""
    from mfcd_tpu_torch.core import prng
    from mfcd_tpu_torch.models import altsvm
    from mfcd_tpu_torch.ops import altsvm_kernels as AK

    dev = _card()
    n, m, f, t = 30, 40, 8, 400
    comps = _comparisons(dev, n, m, t, 5)
    card0 = altsvm.init_altsvm(prng.key(0), n, m, f, t)
    assert card0.user_features.device.type == "cuda"
    cpu0 = altsvm.AltSVMState(*(a.cpu() for a in card0))
    before = dict(AK.DCD_LAUNCHES)
    card = altsvm.train_altsvm(card0, prng.key(1), *comps, num_epochs=2)
    torch.cuda.synchronize()
    assert AK.DCD_LAUNCHES == {k: v + 2 for k, v in before.items()}
    cpu = altsvm.train_altsvm(cpu0, prng.key(1), *(c.cpu() for c in comps),
                              num_epochs=2)
    for a, b in zip(cpu, card):
        err = float((a - b.cpu()).abs().max())
        assert err <= 1e-5 * float(a.abs().max()) + 1e-12, err


@pytest.mark.cuda
def test_cdf_samplers_do_not_depend_on_the_chunk():
    """The variance and popularity proposals of a run are the same bits
    alone or beside other runs on the card (their CDFs are summed and
    scanned in fixed point), and the same as the CPU's from the same X;
    the mesh's sharded sweeps rely on it."""
    from mfcd_tpu_torch.core import prng
    from mfcd_tpu_torch.sampling import strategies as S

    dev = _card()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 300, 400, generator=g)
    keys = prng.split(prng.key(3), 8)
    for fn in (S.propose_variance, S.propose_popularity):
        full = fn(keys.to(dev), x.to(dev), 2048)
        cpu = fn(keys, x, 2048)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(full, cpu))
        for lo, hi in ((0, 1), (1, 3), (3, 7)):
            part = fn(keys[lo:hi].to(dev), x[lo:hi].to(dev), 2048)
            assert all(torch.equal(a[lo:hi], b) for a, b in zip(full, part))


# S1, S2 and T1 (ops/csrc/shuffle_kernel.cu, prng_kernel.cu) against their
# plain versions on the card, bit for bit (integer maps), at the main path's
# shapes: (R, S, count, k_bits): the canonical run (R = 4, S = 2,048 x 64),
# hard K = 10 (800,000 rows, S = 2^20) and hard K = 50 (R = 2, S = 2^22).
SHUFFLE_SHAPES = {
    "canonical": (4, 131_072, 80_000, 17),
    "hard-k10": (2, 1 << 20, 800_000, 20),
    "hard-k50": (2, 1 << 22, 4_000_000, 22),
}


def _shuffle_keys(r, dev, seed=0):
    from mfcd_tpu_torch.core import prng

    return prng.split(prng.key(seed), r).to(dev)


def _prp_forms(keys, counts, s_len, k_bits):
    """S1's argument forms at one shape besides prp_splits' (which
    ``ab_shuffle_kernels.prp_forms`` makes): one row of int64 slots for
    every key, then a row each; int32 rows under a shared key with an int
    count; a ragged S (not a multiple of 4) and a sliced input that is not
    contiguous (rows off 16-byte alignment, a row stride past S)."""
    r = keys.shape[0]
    slots = torch.arange(s_len, device=keys.device)
    rows = torch.stack([slots.roll(7 * i) for i in range(r)])
    wide = torch.cat([rows, rows[:, :9]], dim=1).to(torch.int32)
    return {
        "shared-row": (keys, slots, counts),
        "row-each": (keys, rows, counts),
        "int32-shared-key-int-count": (keys[0], rows.to(torch.int32),
                                       int(counts[0])),
        "ragged": (keys, rows[:, :s_len - 3], counts),
        "sliced": (keys, wide[:, 1:s_len - 4], counts.to(torch.int64)),
    }


PRP_NAMES = {"capped": "epoch_permutation",
             "exact": "exact_prefix_permutation",
             "inverse": "exact_prefix_permutation_inverse"}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["capped", "exact", "inverse"])
@pytest.mark.parametrize("shape", list(SHUFFLE_SHAPES))
def test_prp_kernel_matches_plain_version(shape, mode):
    from mfcd_tpu_torch.ops import shuffle as SH

    dev = _card()
    r, s_len, count, k_bits = SHUFFLE_SHAPES[shape]
    keys = _shuffle_keys(r, dev)
    counts = torch.tensor([count - 17 * i for i in range(r)], device=dev)
    name = PRP_NAMES[mode]
    for form, args in _prp_forms(keys, counts, s_len, k_bits).items():
        before = SH.PRP_LAUNCHES
        got = getattr(SH, name)(*args, k_bits)
        assert SH.PRP_LAUNCHES == before + 1
        want = getattr(SH, name + "_reference")(*args, k_bits)
        assert got.dtype == torch.int32 and torch.equal(got, want), form


# prp_splits' two calls (ab_shuffle_kernels.prp_forms) at the canonical
# run's shape and the bench sweep chunk's (120 runs of 131,072 slots).
SPLIT_SHAPES = {"canonical": (4, 131_072, 100_000, 17),
                "sweep": (120, 131_072, 100_000, 17)}


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["split inverse", "split exact"])
@pytest.mark.parametrize("shape", list(SPLIT_SHAPES))
def test_prp_kernel_at_the_samplers_forms(shape, form):
    from mfcd_tpu_torch.ops import shuffle as SH
    from mfcd_tpu_torch.scripts import ab_shuffle_kernels as AB

    dev = _card()
    r, s_len, count, k_bits = SPLIT_SHAPES[shape]
    keys = _shuffle_keys(r, dev, 3)
    counts = torch.full((r,), count, dtype=torch.int32, device=dev)
    mode, *args = AB.prp_forms(keys, counts, s_len, k_bits)[form]
    name = AB.PRP_FNS[mode]
    before = SH.PRP_LAUNCHES
    got = getattr(SH, name)(*args)
    assert SH.PRP_LAUNCHES == before + 1
    want = getattr(SH, name + "_reference")(*args)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arrays", [1, 2, 4])
@pytest.mark.parametrize("tile_w", [None, 64])
@pytest.mark.parametrize("shape", list(SHUFFLE_SHAPES))
def test_mix_stream_kernel_matches_plain_version(shape, tile_w, arrays):
    # Epochs 0 (fresh PRP) to 5 (cheap epochs, then fresh again at 4), the
    # whole [R, S] arrays, pad slots included.
    from mfcd_tpu_torch.ops import shuffle as SH

    dev = _card()
    r, s_len, count, k_bits = SHUFFLE_SHAPES[shape]
    keys = _shuffle_keys(r, dev, 1)
    counts = torch.tensor([count - 37 * i for i in range(r)],
                          dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(arrays)
    arrs = [torch.randint(-2**31, 2**31 - 1, (r, s_len), dtype=torch.int32,
                          device=dev, generator=g)
            for _ in range(arrays - 1)]
    arrs.append(torch.rand((r, s_len), device=dev, generator=g))
    got = want = tuple(arrs)
    for epoch in range(6):
        before = SH.SHUFFLE_LAUNCHES
        got = SH.mix_stream(got, keys, epoch, counts, k_bits, period=4,
                            tile_w=tile_w)
        assert SH.SHUFFLE_LAUNCHES == before + 1
        want = SH.mix_stream_reference(want, keys, epoch, counts, k_bits,
                                       period=4, tile_w=tile_w)
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                epoch


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4,), (2, 3, 1000), (1 << 22,)])
def test_threefry_kernel_matches_plain_version(shape):
    # T1's counter entry (split, bits) and its hash entry (fold_in, bits_at,
    # threefry2x32 over broadcast words), counters past 2^32 included.
    from mfcd_tpu_torch.core import prng

    dev = _card()
    keys = _shuffle_keys(3, dev, 2)
    before = prng.THREEFRY_LAUNCHES
    pairs = [
        (prng.split(keys, 7), prng.split_reference(keys, 7)),
        (prng.bits(keys[:2], shape), prng.bits_reference(keys[:2], shape)),
        (prng.fold_in(keys, 2**31 + 5),
         prng.fold_in_reference(keys, 2**31 + 5)),
        (prng.fold_in(keys, torch.arange(3, device=dev)),
         prng.fold_in_reference(keys, torch.arange(3, device=dev))),
    ]
    idx = torch.arange(1000, device=dev) * 7_777_777_777 + 5
    pairs.append((prng.bits_at(keys[:, None], idx),
                  prng.bits_at_reference(keys[:, None], idx)))
    got = prng.threefry2x32(keys[:, None, 0], keys[0, 1], idx >> 32,
                            idx & 0xFFFFFFFF)
    want = prng.threefry2x32_reference(keys[:, None, 0], keys[0, 1],
                                       idx >> 32, idx & 0xFFFFFFFF)
    pairs += list(zip(got, want))
    assert prng.THREEFRY_LAUNCHES == before + 6
    for a, b in pairs:
        assert torch.equal(a, b)


# S2's and T1's edge cases on the card.  (s_len, tile_w, counts, k_bits, rho
# targets): each rho the quad copy aligns differently (0, 1, 3, tile_w - 1),
# S not a multiple of a warp's 128 words, S not a multiple of 4 (the
# per-slot kernel), counts 0, 1 and S, k_bits 1, 17 and 32.
S2_EDGES = {
    "aligned": (256, 8, [200, 201, 130, 256], 8, [0, 1, 3, 7]),
    "ragged-group": (8 * 37, 8, [295, 296, 177, 160], 9, [0, 1, 3, 7]),
    "ragged-tile-4": (4 * 75, 4, [299, 300, 177, 160], 9, [0, 1, 3, 3]),
    "ragged-quad": (301, None, [300, 301, 150, 99], 9, [0, 1, 3, 7]),
    "counts-0-1-S": (128, 32, [0, 1, 128, 127], 7, [0, 0, 3, 31]),
    "no-tiles": (200, None, [199, 200, 3, 150], 8, [0, 1, 2, 149]),
    "k-bits-1": (64, 8, [2, 1, 64, 60], 1, [0, 0, 1, 3]),
    "k-bits-17": (512, 64, [500, 512, 300, 64], 17, [0, 1, 3, 63]),
    "k-bits-32": (256, 128, [255, 256, 200, 130], 32, [0, 1, 3, 127]),
}


def _rho_keys(targets, counts, epoch):
    """Epochs keys whose cheap epoch ``epoch`` rotates run r by
    ``targets[r]``, found among split(key(0), 4096) with the plain
    threefry."""
    from mfcd_tpu_torch.core import prng

    cands = prng.split_reference(prng.key(0), 4096)
    k_rho = prng.split_reference(prng.fold_in_reference(cands, epoch),
                                 3)[:, 1]
    word = prng.bits_reference(k_rho, ())
    return torch.stack([cands[torch.nonzero(word % max(c, 1) == t)[0, 0]]
                        for t, c in zip(targets, counts)])


def _s2_against_plain(arrs, keys, counts, k_bits, tile_w, epochs,
                      period=4):
    """S2 from the epochs keys and from the epoch's folded keys (the
    trainer's form), each one launch, bit-equal to the plain version."""
    from mfcd_tpu_torch.core import prng
    from mfcd_tpu_torch.ops import shuffle as SH

    for epoch in epochs:
        want = SH.mix_stream_reference(arrs, keys, epoch, counts, k_bits,
                                       period=period, tile_w=tile_w)
        before = SH.SHUFFLE_LAUNCHES
        got = SH.mix_stream(arrs, keys, epoch, counts, k_bits,
                            period=period, tile_w=tile_w)
        ekeys = prng.split(keys, epoch + 1)[:, epoch]
        folded = SH.mix_stream(arrs, ekeys, epoch, counts, k_bits,
                               period=period, tile_w=tile_w, folded=True)
        assert SH.SHUFFLE_LAUNCHES == before + 2
        for a, b, c in zip(got, folded, want):
            assert torch.equal(a.view(torch.int32), c.view(torch.int32)), \
                epoch
            assert torch.equal(b.view(torch.int32), c.view(torch.int32)), \
                epoch


@pytest.mark.cuda
@pytest.mark.parametrize("arrays", [1, 2, 4])
@pytest.mark.parametrize("case", list(S2_EDGES))
def test_mix_stream_kernel_at_the_edges(case, arrays):
    dev = _card()
    s_len, tile_w, counts, k_bits, rhos = S2_EDGES[case]
    g = torch.Generator(device=dev).manual_seed(s_len + arrays)
    arrs = tuple(torch.randint(-2**31, 2**31 - 1, (4, s_len),
                               dtype=torch.int32, device=dev, generator=g)
                 for _ in range(arrays))
    counts_t = torch.tensor(counts, dtype=torch.int32, device=dev)
    for epoch in (0, 1, 3):   # keys rotated by the targets at epoch 1
        _s2_against_plain(arrs, _rho_keys(rhos, counts, 1).to(dev),
                          counts_t, k_bits, tile_w, (epoch,))
    _s2_against_plain(arrs, _rho_keys(rhos, counts, 2).to(dev), counts_t,
                      k_bits, tile_w, (2,), period=1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["many-rows", "2^22+5"])
def test_mix_stream_kernel_past_a_wave_and_odd_lengths(shape):
    # 1,100 runs: more blocks than the card holds at once (about 8 an SM);
    # 2^22 + 5 slots: S not a multiple of 4, the per-slot kernel, at hard
    # K = 50's count.
    dev = _card()
    r, s_len, count, k_bits, tile_w = {
        "many-rows": (1100, 8192, 8000, 13, 64),
        "2^22+5": (2, (1 << 22) + 5, 4_000_000, 22, None)}[shape]
    keys = _shuffle_keys(r, dev, 3)
    counts = torch.tensor([count - 3 * i for i in range(r)],
                          dtype=torch.int32, device=dev)
    arrs = (torch.arange(r * s_len, dtype=torch.int32,
                         device=dev).reshape(r, s_len),)
    _s2_against_plain(arrs, keys, counts, k_bits, tile_w, (0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["many-rows", "2^22+5", "edges"])
def test_threefry_kernel_past_a_wave_and_odd_lengths(shape):
    # 70,000 keys: more output rows than a grid's y (65,535); 2^22 + 5
    # words a key: an odd row, word by word stores; and every datum form.
    from mfcd_tpu_torch.core import prng

    dev = _card()
    if shape == "many-rows":
        keys = _shuffle_keys(70_000, dev, 4)
        pairs = [(prng.bits(keys, (3,)), prng.bits_reference(keys, (3,))),
                 (prng.split(keys, 2), prng.split_reference(keys, 2))]
    elif shape == "2^22+5":
        keys = _shuffle_keys(2, dev, 5)
        n = (1 << 22) + 5
        pairs = [(prng.bits(keys, (n,)), prng.bits_reference(keys, (n,)))]
    else:
        keys = _shuffle_keys(3, dev, 6)
        pairs = []
        for data in (7, np.uint32(2**32 - 3),
                     torch.tensor(2**31 + 9, device=dev),
                     torch.tensor([5, -1, 0], dtype=torch.int32, device=dev),
                     torch.arange(4, device=dev)[:, None] * 2**31):
            pairs.append((prng.fold_in(keys, data),
                          prng.fold_in_reference(keys, data)))
        strided = torch.stack([keys, keys ^ 5], 1).reshape(6, 2)[::2]
        pairs += [(prng.split(strided, 3), prng.split_reference(strided, 3)),
                  (prng.bits(keys[1], ()), prng.bits_reference(keys[1], ())),
                  (prng.bits(keys, (3, 5)),
                   prng.bits_reference(keys, (3, 5)))]
        idx = torch.tensor([0, 2**32 + 1, -7], dtype=torch.int64,
                           device=dev)
        pairs.append((prng.bits_at(keys[:, None], idx),
                      prng.bits_at_reference(keys[:, None], idx)))
        idx32 = torch.tensor([3, -2], dtype=torch.int32, device=dev)
        pairs.append((prng.bits_at(keys[:1], idx32),
                      prng.bits_at_reference(keys[:1], idx32)))
    for a, b in pairs:
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fold_in", "fold_in tensor", "split",
                                  "bits", "bits_at", "threefry2x32"])
def test_key_ops_make_one_kernel_launch(name):
    # torch.profiler's kernel events over one call, after a warm one.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mfcd_tpu_torch.core import prng

    dev = _card()
    keys = _shuffle_keys(4, dev, 7)
    idx = torch.arange(5, device=dev)
    datum = torch.tensor(3, device=dev)
    call = {"fold_in": lambda: prng.fold_in(keys, 5),
            "fold_in tensor": lambda: prng.fold_in(keys[:, None], idx),
            "split": lambda: prng.split(keys[1:, ], 3),
            "bits": lambda: prng.bits(keys, (4, 7)),
            "bits_at": lambda: prng.bits_at(keys[:, None], idx),
            "threefry2x32": lambda: prng.threefry2x32(
                keys[:, 0], keys[:, 1], datum, idx[:, None])}[name]
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert kernels and len(kernels) == 1, kernels


@pytest.mark.cuda
def test_kernel_trainer_epoch_loop_has_no_host_sync(monkeypatch):
    # The canonical run (n = m = 1000, d = 2, p = 0.2, 30 epochs, reps = 4)
    # with train_runs_kernel under sync debug mode "error": any host sync
    # (a read-back, a pageable copy) in the trainer raises.  30 S2 and 30
    # K1 launches.
    from mfcd_tpu_torch.core.config import RunConfig
    from mfcd_tpu_torch.ops import shuffle as SH
    from mfcd_tpu_torch.sweep import engine

    dev = _card()
    inner = KT.train_runs_kernel

    def strict(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(engine, "train_runs_kernel", strict)
    cfg = RunConfig(n=1000, m=1000, d=2, p=0.2, s=5.0, lr=1e-3,
                    weight_decay=5e-6, num_epochs=30, reps=4)
    s2, k1 = SH.SHUFFLE_LAUNCHES, K.EPOCH_LAUNCHES
    res = engine.run_config(cfg, seed=0, device=dev)
    assert SH.SHUFFLE_LAUNCHES - s2 == 30 and K.EPOCH_LAUNCHES - k1 == 30
    assert float(np.mean(res["accuracy"])) > 0.6


@pytest.mark.cuda
def test_kernel_at_d8_takes_c16():
    # n = m = 10,000, d = 8, bs = 64: the block fits only at C = 16, the
    # gate's largest cluster (JAX's n = 7,168 fits at C = 8 since the split
    # block holds the state once).  Against the plain version (its
    # index_add_ adds with atomics on the card: the stated bound), and two
    # launches bit-equal.
    dev = _card()
    n, d = 10_000, 8
    assert K.min_cluster(n, n, d, 64) == 16
    assert K.epoch_kernel_supported(n, n, d, 64)
    state, args, pack = _inputs(31, n, n, d, 64, 16, [1024, 1000],
                                [1e-3, 3e-3], "none", dev)
    assert K.cluster_size(2, n, n, d, 64, dev) == 16
    got = _flat(_compare(state, args, pack, dev))
    again = _k1(state, args, pack, dev, 16)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


# L1, the validation pass (ops/loss_pass.py): (runs, rows, batch size, d,
# counts, soft K, tables' layout).  Counts: None for every row; "mixed"
# gives a run no valid row and others batches past their count that hold
# only padding.  rows is never a multiple of the batch size but at the
# hard K = 10 shape (131,072 rows, 100,000 valid), whose trailing batches
# are padding.  "t" passes the tables as the trainer does: [R, d, n]
# storage read through transpose(1, 2) views.
L1_CASES = {
    "R1": (1, 1000, 64, 2, None, None, "c"),
    "R5-k10": (5, 131_072, 64, 2, [100_000] * 5, None, "t"),
    "R285": (285, 10_000, 64, 2, "mixed", None, "t"),
    "bs1": (3, 777, 1, 2, "mixed", None, "c"),
    "bs1024": (3, 5000, 1024, 2, "mixed", None, "c"),
    "count0-padding": (4, 3001, 64, 2, "mixed", None, "c"),
    "soft10": (5, 10_000, 64, 2, "mixed", 10, "t"),
    "d8": (2, 4999, 64, 8, "mixed", None, "c"),
    "d8-t": (2, 4999, 64, 8, "mixed", None, "t"),
    "k50-rows": (2, 524_288, 64, 2, [500_000, 499_990], None, "t"),
}


def _l1_inputs(dev, runs, rows, bs, d, counts, soft, layout, seed=41,
               n=1000, m=1000):
    from mfcd_tpu_torch.data.btl import LabeledSplit
    from mfcd_tpu_torch.models.mf import MFParams

    g = np.random.default_rng(seed)
    if counts is None:
        counts = [rows] * runs
    elif counts == "mixed":
        counts = [[rows, 0, rows // 3, 1][k % 4] for k in range(runs)]
    u = g.integers(0, n, (runs, rows)).astype(np.int32)
    i = g.integers(0, m, (runs, rows)).astype(np.int32)
    j = ((i + g.integers(1, m, (runs, rows))) % m).astype(np.int32)
    if soft:
        z = (g.integers(0, soft + 1, (runs, rows)) / soft).astype(np.float32)
    else:
        z = (g.random((runs, rows)) < 0.5).astype(np.float32)
    valid = np.arange(rows)[None, :] < np.asarray(counts)[:, None]
    t = lambda a: torch.as_tensor(a, device=dev)
    split = LabeledSplit(t(u), t(i), t(j), t(z), t(valid),
                         t(np.asarray(counts, np.int32)))
    tables = [(g.standard_normal((runs, k, d)) / np.sqrt(d)).astype(
        np.float32) for k in (n, m)]
    if layout == "t":
        tables = [t(np.ascontiguousarray(a.transpose(0, 2, 1))).transpose(1, 2)
                  for a in tables]
    else:
        tables = [t(a) for a in tables]
    return MFParams(*tables), split


def _l1_check(got, want):
    """Per-batch and epoch means within float32 rounding of the plain
    version (the kernel sums in another order); an empty batch's mean is
    +0 exactly, as the plain version's."""
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype and a.is_contiguous()
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    empty = want[0] == 0
    assert torch.equal(got[0][empty].view(torch.int32),
                       torch.zeros_like(got[0][empty]).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(L1_CASES))
def test_loss_pass_matches_plain_version(case):
    from mfcd_tpu_torch.ops import loss_pass as LP

    dev = _card()
    params, split = _l1_inputs(dev, *L1_CASES[case])
    bs = L1_CASES[case][2]
    want = LP.batch_losses_reference(params, split, bs)
    before = LP.LOSS_LAUNCHES
    got = LP.batch_losses(params, split, bs)
    torch.cuda.synchronize()
    assert LP.LOSS_LAUNCHES == before + 2
    _l1_check(got, want)
    if L1_CASES[case][-1] == "t":
        # the same tables, contiguous: the same reads, the same bits
        flat = params._replace(U=params.U.contiguous(),
                               V=params.V.contiguous())
        again = LP.batch_losses(flat, split, bs)
        assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
def test_loss_pass_repeats_its_bits_in_two_launches():
    from mfcd_tpu_torch.ops import loss_pass as LP
    from torch.profiler import DeviceType, ProfilerActivity, profile

    dev = _card()
    params, split = _l1_inputs(dev, *L1_CASES["R5-k10"])
    first = LP.batch_losses(params, split, 64)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        second = LP.batch_losses(params, split, 64)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 2, kernels
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    # no rows: only the epoch launch, every mean 0
    empty = split._replace(**{f: getattr(split, f)[:, :0]
                              for f in ("u", "i", "j", "z", "valid")})
    means, epoch = LP.batch_losses(params, empty, 64)
    assert means.shape == (5, 0) and torch.equal(epoch, torch.zeros_like(epoch))


@pytest.mark.cuda
def test_loss_pass_rejects_what_it_does_not_take():
    from mfcd_tpu_torch.ops import loss_pass as LP

    dev = _card()
    params, split = _l1_inputs(dev, *L1_CASES["R1"])
    bad = [(params, split._replace(u=split.u.long())),
           (params, split._replace(z=split.z.double())),
           (params, split._replace(valid=split.valid.to(torch.uint8))),
           (params._replace(U=params.U.double()), split),
           (params, split._replace(i=split.i.cpu())),
           (params._replace(V=params.V.cpu()), split),
           (params, split._replace(j=split.j[:, :999])),
           (params._replace(U=params.U.expand(2, -1, -1)), split)]
    before = LP.LOSS_LAUNCHES
    for p, s in bad:
        with pytest.raises(ValueError, match="batch_losses"):
            LP.batch_losses(p, s, 64)
    with pytest.raises(ValueError, match="batch_losses"):
        LP.batch_losses(params, split, 0)
    assert LP.LOSS_LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("strategy,p", [
    ("random", 0.0413), ("random", 0.065536), ("proximity", 0.0413),
    ("margin", 0.0413), ("variance", 0.0413), ("popularity", 0.2),
    ("top_k", 0.0413)])
def test_the_sample_stage_has_no_host_sync(strategy, p):
    # Cell 18's shapes (n = m = 1000, reps 3; p = 0.065536 the exact
    # capacity 2^15) under sync debug mode "error": no read-back and no
    # copy from the host (a key, a count, a uniform's bounds) in the
    # sampler.  svd's tables read back torch.linalg.svd's status.
    from mfcd_tpu_torch.core import prng, rng
    from mfcd_tpu_torch.core.config import RunConfig
    from mfcd_tpu_torch.data.btl import sample_and_split
    from mfcd_tpu_torch.genx import generate_x
    from mfcd_tpu_torch.sweep.engine import compile_caps

    dev = _card()
    cfg = RunConfig(n=1000, m=1000, d=2, p=p, reps=3, strategy=strategy)
    t_cap, e_cap = compile_caps(cfg)
    t = cfg.shapes().num_triplets
    keys = rng.rep_keys(rng.config_key(prng.key(11, device=dev), 0), 3)
    st = rng.rep_streams(keys)
    x = generate_x(st["x_gen"], 1000, 1000, 2, "base")
    budget = (None if t == t_cap else
              torch.full((3,), t, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = sample_and_split(st, x, t_cap, e_cap, strategy, budget=budget,
                               extra_budget=None if budget is None else
                               torch.zeros_like(budget))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.train.shape[1] == int(0.8 * t_cap)
