"""The schedule of AltSVM's phase kernel K2 (``ops/altsvm_kernels.py``): a
step's expected version of each row it writes, the chain depth, and the
claim the kernel rests on, on the CPU.

A step writes only its own rows (user phase U[i], item phase V[j] and
V[k]) and its dual, so any order that gives every row its writes in pick
order gives the sequential sweep's bits: the plain phase run level by
level, reversed within each level, is ``torch.equal`` to it.  Integer
paths (versions, levels) are exact.
"""

import numpy as np
import pytest
import torch

from mfcd_tpu_torch.core import prng
from mfcd_tpu_torch.models import altsvm as T
from mfcd_tpu_torch.ops import altsvm_kernels as AK

torch.set_num_threads(1)

LAM, C, SWEEPS = 0.1, 1.0, 3


def _comparisons(n, m, t, seed, same=0.0):
    """(users, j, k, prefs): int32, int32, int32, float32 tensors; k != j
    but for a share ``same`` made k = j."""
    g = np.random.default_rng(seed)
    users = g.integers(0, n, t)
    mj = g.integers(0, m, t)
    mk = (mj + 1 + g.integers(0, m - 1, t)) % m
    mk = np.where(g.random(t) < same, mj, mk)
    prefs = np.where(g.random(t) < 0.5, 1.0, -1.0)
    return tuple(torch.as_tensor(a, dtype=dt) for a, dt in (
        (users, torch.int32), (mj, torch.int32), (mk, torch.int32),
        (prefs, torch.float32)))


def _picks_with_repeat(t, seed):
    """3 sweeps of permutations; the last pick of sweep 0 is also the first
    of sweep 1 (the same comparison twice in a row)."""
    g = np.random.default_rng(seed)
    sweeps = [g.permutation(t) for _ in range(SWEEPS)]
    first = int(np.flatnonzero(sweeps[1] == sweeps[0][-1])[0])
    sweeps[1][[0, first]] = sweeps[1][[first, 0]]
    return torch.as_tensor(np.concatenate(sweeps), dtype=torch.int32)


def _loop_versions(phase, picks, users, mj, mk):
    """Expected versions by a loop over steps and a count per row."""
    seen = {}
    out = []
    for idx in picks.tolist():
        if phase == "users":
            rows = [int(users[idx])]
        else:
            rows = [int(mj[idx]), int(mk[idx])]
        vers = [seen.get(r, 0) for r in rows]
        for r in set(rows):
            seen[r] = seen.get(r, 0) + 1
        out.append(vers)
    return np.asarray(out, np.int64)


@pytest.mark.parametrize("phase", ["users", "items"])
def test_schedule_reference_matches_a_loop(phase):
    """Including k == j (the k column takes j's version, the row counted
    once) and one comparison picked twice in a row across sweeps."""
    users, mj, mk, prefs = _comparisons(7, 9, 60, 1, same=0.2)
    assert bool((mj == mk).any())
    picks = _picks_with_repeat(60, 2)
    assert picks[59] == picks[60]
    got = AK.dcd_schedule_reference(phase, picks, users, mj, mk)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (180, 1 if phase == "users" else 2)
    np.testing.assert_array_equal(
        got.numpy(), _loop_versions(phase, picks, users, mj, mk))
    # The repeated comparison waits on itself: one version apart.
    assert (got[60] == got[59] + 1).all()
    # On CPU tensors the schedule's records are the plain ones.
    fixed = torch.randn(7 if phase == "items" else 9, 5,
                        generator=torch.Generator().manual_seed(3))
    rec = AK.dcd_schedule(phase, fixed, picks, users, mj, mk, prefs, LAM, 9)
    width = got.shape[1]
    assert torch.equal(rec[:, AK.VERSIONS:AK.VERSIONS + width], got)


@pytest.mark.parametrize("phase", ["users", "items"])
@pytest.mark.parametrize("f", [5, 20, 45])
def test_records_carry_the_phase_bits(phase, f):
    """Each record: the step's comparison, its label's bits, versions, and
    the curvature with the bits the plain phase computes for that step
    (users dot(x, x) / lam, items (2 * dot(u, u)) / lam, summed as
    ``warp_dot`` sums)."""
    n, m, t = 6, 8, 30
    users, mj, mk, prefs = _comparisons(n, m, t, f, same=0.1)
    fixed = torch.randn(m if phase == "users" else n, f,
                        generator=torch.Generator().manual_seed(f))
    picks = T._picks(prng.key(f), t, SWEEPS)
    rec = AK.dcd_records_reference(phase, fixed, picks, users, mj, mk,
                                   prefs, LAM)
    assert rec.dtype == torch.int32 and tuple(rec.shape) == (3 * t,
                                                             AK.RECORD)
    lam = torch.tensor(LAM, dtype=torch.float32)
    for s, idx in enumerate(picks.tolist()):
        i, j, k = int(users[idx]), int(mj[idx]), int(mk[idx])
        assert rec[s, :4].tolist() == [i, j, k, idx]
        assert rec[s, 4:5].view(torch.float32).item() == prefs[idx].item()
        if phase == "users":
            x = prefs[idx] * (fixed[j] - fixed[k])
            q = AK.warp_dot(x, x) / lam
        else:
            q = (2.0 * AK.warp_dot(fixed[i], fixed[i])) / lam
        assert rec[s, AK.CURVATURE:].view(torch.float32).item() == q.item()
    ver = AK.dcd_schedule_reference(phase, picks, users, mj, mk)
    assert torch.equal(rec[:, AK.VERSIONS], ver[:, 0])
    assert torch.equal(rec[:, AK.VERSIONS + 1], ver[:, -1])


@pytest.mark.parametrize("slots, rows", [(1, 3), (900, 40), (600_000, 1682),
                                         (10_000, 5_000_000)])
def test_schedule_parts_cover_every_slot(slots, rows):
    """The schedule's warps take chunks of whole 32-slot passes that cover
    every slot, with at most ``SCHEDULE_CELLS`` counts."""
    parts, chunk = AK.schedule_parts(slots, rows)
    assert parts >= 1 and chunk % AK.LANES == 0
    assert parts * chunk >= slots
    assert (parts - 1) * chunk < max(slots, 1)
    assert rows * parts <= max(AK.SCHEDULE_CELLS, rows)


def test_dcd_mode_by_size():
    """MovieLens-100k's 943 users x 1682 items: both tables in a block's
    shared memory at f = 20, the written one only where both do not fit,
    neither at f = 64."""
    assert AK.dcd_mode(943, 1682, 20) == "both"
    assert AK.dcd_mode(1682, 943, 20) == "both"
    assert AK.dcd_mode(1682, 943, 30) == "written"
    assert AK.dcd_mode(943, 1682, 30) == "written"
    assert AK.dcd_mode(943, 1682, 64) == "global"
    assert AK.dcd_mode(1682, 943, 64) == "global"
    for mode in AK.MODES:
        assert AK.smem_bytes(mode, 1682, 943, 20) <= AK.SMEM_BYTES


@pytest.mark.parametrize("phase", ["users", "items"])
@pytest.mark.parametrize("f", [20, 45])
def test_steps_reordered_by_level_are_bit_equal(phase, f):
    """The plain phase's steps run level by level, each level reversed,
    give the pick-order bits; plain reversal, which breaks rows' order,
    does not."""
    n, m, t = 6, 8, 40
    users, mj, mk, prefs = _comparisons(n, m, t, f, same=0.1)
    g = np.random.default_rng(f + 1)
    rows, other = (n, m) if phase == "users" else (m, n)
    table = torch.as_tensor(g.standard_normal((rows, f)), dtype=torch.float32)
    fixed = torch.as_tensor(g.standard_normal((other, f)),
                            dtype=torch.float32)
    dual = torch.as_tensor(g.random(t), dtype=torch.float32)
    picks = T._picks(prng.key(f), t, SWEEPS)
    args = (phase, table, fixed, dual, picks, users, mj, mk, prefs, LAM, C)
    want = AK.dcd_phase_reference(*args)
    levels = AK.dcd_levels(phase, picks, users, mj, mk).tolist()
    order = sorted(range(len(levels)), key=lambda s: (levels[s], -s))
    assert order != list(range(len(levels)))
    got = AK.dcd_phase_reference(*args, order=order)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    broken = AK.dcd_phase_reference(*args, order=range(len(levels))[::-1])
    assert not all(torch.equal(a, b) for a, b in zip(want, broken))


def _numpy_depth(phase, picks, users, mj, mk):
    """The chain depth by a numpy loop: each step one level below the
    deepest earlier step on any row it writes."""
    picks = picks.numpy()
    if phase == "users":
        return int(np.bincount(users.numpy()[picks]).max())
    j, k = mj.numpy()[picks], mk.numpy()[picks]
    depth = np.zeros(int(max(j.max(), k.max())) + 1, np.int64)
    for a, b in zip(j.tolist(), k.tolist()):
        level = max(depth[a], depth[b]) + 1
        depth[a] = depth[b] = level
    return int(depth.max())


@pytest.mark.parametrize("phase", ["users", "items"])
def test_chain_depth_at_the_planted_shape(phase):
    """MovieLens-100k's 943 users x 1682 items, T = 100,000 comparisons, 3
    sweeps: ``dcd_levels``' depth equals a numpy count, and lies hundreds
    of times below the 300,000 steps."""
    n, m, t = 943, 1682, 100_000
    users, mj, mk, _ = _comparisons(n, m, t, 12)
    picks = T._picks(prng.key(7), t, SWEEPS)
    levels = AK.dcd_levels(phase, picks, users, mj, mk)
    depth = int(levels.max())
    assert depth == _numpy_depth(phase, picks, users, mj, mk)
    assert 100 <= depth <= t * SWEEPS // 100
