"""The user_similarity sampler and its neighbour cascade vs mfcd_tpu's.

The cascade is an integer function of (u, i, j): the port's
``cascade_resolve`` and the blocked fixpoint are held bit-equal to the JAX
package's on ``tests/test_sampling.py``'s cases (a sequential oracle on
duplicate-heavy domains, a chained overlap, exclude semantics, block
composition), with several runs on the leading run axis at once.  The
sampler's neighbour table comes from a float32 cosine matmul; at these
shapes it equals the JAX one (checked), so the proposals are bit-equal.

Shapes: n = 24, m = 28 takes the direct path; n = 20, m = 300, p = 0.667
(T = 2,001, tk = 30, blk = 4,096, 10,000 attempts) the blocked path with
the budget's early exit, and its 500-label top-up the blocked path with
an exclude-seeded table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfcd_tpu.core import rng as jrng
from mfcd_tpu.data import btl as jbtl
from mfcd_tpu.genx import generate_x as jgenerate_x
from mfcd_tpu.sampling import strategies as js
from mfcd_tpu_torch.core import prng
from mfcd_tpu_torch.core import rng as trng
from mfcd_tpu_torch.data import btl as tbtl
from mfcd_tpu_torch.sampling import strategies as ts
from mfcd_tpu_torch.sampling.prp import top_k_indices

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_resolve(u, i_all, j_all, m, **kw):
    return np.asarray(js.cascade_resolve(jnp.asarray(u), jnp.asarray(i_all),
                                         jnp.asarray(j_all), m, **kw))


def _oracle(u, i_all, j_all):
    """The reference's loop: each attempt accepts its first fresh rank."""
    nb, a = i_all.shape
    accepted, win = set(), np.zeros((nb, a), bool)
    for at in range(a):
        for r in range(nb):
            key = (int(u[at]), int(i_all[r, at]), int(j_all[r, at]))
            if key[1] != key[2] and key not in accepted:
                accepted.add(key)
                win[r, at] = True
                break
    return win


@pytest.mark.parametrize("trial", range(4))
def test_cascade_matches_jax_and_oracle(trial):
    """Three runs of one shape at once on duplicate-heavy domains."""
    g = np.random.default_rng(trial)
    a, nb = int(g.integers(50, 300)), int(g.integers(3, 15))
    n, m = int(g.integers(5, 25)), int(g.integers(5, 25))
    u = g.integers(0, n, (3, a)).astype(np.int32)
    i_all = g.integers(0, m, (3, nb, a)).astype(np.int32)
    j_all = g.integers(0, m, (3, nb, a)).astype(np.int32)
    got = ts.cascade_resolve(_t(u), _t(i_all), _t(j_all), m).numpy()
    for r in range(3):
        want = _jax_resolve(u[r], i_all[r], j_all[r], m)
        np.testing.assert_array_equal(got[r], want)
        np.testing.assert_array_equal(got[r], _oracle(u[r], i_all[r],
                                                      j_all[r]))


def test_cascade_chained_overlap_runs_until_stable():
    """Attempt k's rank-1 key is attempt k+1's rank-0 key for 40 attempts:
    corrections travel one attempt per pass, so the loop runs until every
    run is stable; a second run without the chain converges sooner and
    must not be disturbed by the extra passes."""
    a, m = 40, 100
    u = np.zeros((2, a), np.int32)
    i_all = np.zeros((2, 2, a), np.int32)
    j_all = np.zeros((2, 2, a), np.int32)
    for k in range(a):
        nxt = (k + 1) % a
        i_all[0, 0, k], j_all[0, 0, k] = k, 50 + k if 50 + k < m else 50
        i_all[0, 1, k] = nxt
        j_all[0, 1, k] = 50 + nxt if 50 + nxt < m else 50
        i_all[1, :, k] = (k, k)
        j_all[1, :, k] = (k + 1, k + 2)
    passes = ts.CASCADE_PASSES
    got = ts.cascade_resolve(_t(u), _t(i_all), _t(j_all), m).numpy()
    assert ts.CASCADE_PASSES - passes > 3
    for r in range(2):
        np.testing.assert_array_equal(
            got[r], _jax_resolve(u[r], i_all[r], j_all[r], m))
    assert got[0, 0].all() and not got[0, 1].any()


def test_cascade_exclude_semantics():
    """An excluded key cascades the attempt to its next rank; a masked
    exclude row vetoes nothing."""
    m = 50
    u = np.array([[3, 4, 5]], np.int32)
    i_all = np.array([[[1, 2, 3], [7, 8, 9]]], np.int32)
    j_all = np.array([[[11, 12, 13], [17, 18, 19]]], np.int32)
    exclude = np.array([[[3, 1, 11], [4, 2, 12], [9, 9, 9]]], np.int32)
    exclude_valid = np.array([[True, False, True]])
    got = ts.cascade_resolve(_t(u), _t(i_all), _t(j_all), m,
                             exclude=_t(exclude),
                             exclude_valid=_t(exclude_valid)).numpy()
    want = _jax_resolve(u[0], i_all[0], j_all[0], m,
                        exclude=jnp.asarray(exclude[0]),
                        exclude_valid=jnp.asarray(exclude_valid[0]))
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(want, [[False, True, True],
                                         [True, False, False]])


@pytest.mark.parametrize("trial", range(3))
def test_cascade_block_composition(trial):
    """Threading the winners' table through per-block fixpoints gives the
    single-shot resolve, in both packages."""
    g = np.random.default_rng(42 + trial)
    a, nb, m = int(g.integers(120, 400)), int(g.integers(2, 10)), int(
        g.integers(6, 20))
    u = g.integers(0, 12, (2, a)).astype(np.int32)
    i_all = g.integers(0, m, (2, nb, a)).astype(np.int32)
    j_all = g.integers(0, m, (2, nb, a)).astype(np.int32)
    single = ts.cascade_resolve(_t(u), _t(i_all), _t(j_all), m).numpy()
    bits = ts._cascade_bits(a, 0)
    h = 1 << bits
    table = ts._cascade_base_table(2, h, bits, "cpu")
    jtables = [js._cascade_base_table(h, bits) for _ in range(2)]
    cut = a // 2 + int(g.integers(-20, 20))
    wins, jwins = [], [[], []]
    for lo, hi in ((0, cut), (cut, a)):
        ib, jb, ub = i_all[..., lo:hi], j_all[..., lo:hi], u[:, lo:hi]
        tags = (np.arange(lo, hi, dtype=np.int32)[None, :] * nb
                + np.arange(nb, dtype=np.int32)[:, None])
        slot = ts._cascade_slot(_t(ub[:, None, :]), _t(ib), _t(jb), bits)
        win, table = ts._cascade_fixpoint(slot, _t(ib != jb), _t(tags),
                                          table, h, cap=hi - lo)
        wins.append(win.numpy())
        for r in range(2):
            jslot = js._cascade_slot(jnp.asarray(ub[r])[None, :],
                                     jnp.asarray(ib[r]), jnp.asarray(jb[r]),
                                     bits)
            np.testing.assert_array_equal(slot[r].numpy(),
                                          np.asarray(jslot))
            jw, jtables[r] = js._cascade_fixpoint(
                jslot, jnp.asarray(ib[r] != jb[r]), jnp.asarray(tags),
                jtables[r], h, cap=hi - lo)
            jwins[r].append(np.asarray(jw))
    blocked = np.concatenate(wins, axis=-1)
    np.testing.assert_array_equal(blocked, single)
    for r in range(2):
        np.testing.assert_array_equal(np.concatenate(jwins[r], axis=1),
                                      single[r])
        np.testing.assert_array_equal(table[r, :h].numpy(),
                                      np.asarray(jtables[r]))


def _streams(n, m, seed=4, reps=2):
    jkeys = jrng.rep_keys(jrng.config_key(jax.random.key(seed), 1), reps)
    xs = np.stack([np.asarray(jgenerate_x(jrng.rep_streams(jkeys[r])[
        "x_gen"], n, m, 2, "base")) for r in range(reps)])
    tst = trng.rep_streams(trng.rep_keys(trng.config_key(prng.key(seed), 1),
                                         reps))
    return jkeys, tst, xs


def _neighbours_equal(xs, nb):
    """The port's cosine neighbour table equals the JAX one at this X."""
    x = jnp.asarray(xs)
    xn = x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    sims = xn @ jnp.swapaxes(xn, -1, -2) - 2.0 * jnp.eye(xs.shape[1])
    want = np.asarray(jax.lax.top_k(sims, nb)[1])
    t = torch.from_numpy(xs)
    tn = t / torch.clamp(torch.sqrt((t * t).sum(-1, keepdim=True)), min=1e-12)
    got = top_k_indices(tn @ tn.transpose(-1, -2)
                        - 2.0 * torch.eye(xs.shape[1]), nb).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(24, 28, 134, 700), (20, 300, 2001,
                                                        10_000)],
                         ids=["direct-n24-m28", "blocked-n20-m300"])
def test_propose_user_similarity_matches_jax(shape):
    n, m, t, attempts = shape
    jkeys, tst, xs = _streams(n, m)
    nb, tk = ts.user_similarity_dims(n, m, t)
    _neighbours_equal(xs, nb)
    blk, nblk = ts.user_similarity_blocks(attempts, tk)
    assert (nblk > 1) == (n == 20) and (blk, tk) == ((4096, 30) if n == 20
                                                      else (700, 3))
    blocks = ts.CASCADE_BLOCKS
    cands, valid = ts.propose_user_similarity(tst["sampling"],
                                              torch.from_numpy(xs),
                                              attempts, t)
    ran = ts.CASCADE_BLOCKS - blocks
    for r in range(2):
        jc, jv = js.propose_user_similarity(
            jrng.rep_streams(jkeys[r])["sampling"], jnp.asarray(xs[r]),
            attempts, t)
        np.testing.assert_array_equal(cands[r].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(valid[r].numpy(), np.asarray(jv))
    if nblk > 1:
        # The early exit: blocks stop once every run has t wins.
        need = [int(np.searchsorted(np.cumsum(valid[r].numpy()), t) // blk)
                + 1 for r in range(2)]
        assert ran == max(need) < nblk


def test_blocked_runs_that_finish_early_stay_frozen():
    """Run 0 fills its budget in the first block.  Run 1 cannot: its users
    are all alike (every neighbour shares the top set, so only the 20 x 30
    x 29 fallback triplets exist), and an exclude set, seeded per run,
    vetoes all of them but user 0's 870.  It runs every block while run 0
    takes no part, as under JAX's per-run ``while_loop``."""
    n, m, t, attempts = 20, 300, 2001, 10_000
    jkeys, tst, xs = _streams(n, m, seed=5)
    xs[1] = xs[1, :1]
    top = np.argsort(-xs[1, 0], kind="stable")[:30]
    ex = np.asarray([(u, a, b) for u in range(n) for a in top for b in top
                     if a != b], np.int32)
    exclude = np.stack([ex, ex])
    exclude_valid = np.stack([np.zeros(len(ex), bool), ex[:, 0] > 0])
    blocks = ts.CASCADE_BLOCKS
    cands, valid = ts.propose_user_similarity(
        tst["sampling"], torch.from_numpy(xs), attempts, t,
        exclude=_t(exclude), exclude_valid=_t(exclude_valid))
    assert ts.CASCADE_BLOCKS - blocks == 3
    for r in range(2):
        jc, jv = js.propose_user_similarity(
            jrng.rep_streams(jkeys[r])["sampling"], jnp.asarray(xs[r]),
            attempts, t, exclude=jnp.asarray(exclude[r]),
            exclude_valid=jnp.asarray(exclude_valid[r]))
        np.testing.assert_array_equal(cands[r].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(valid[r].numpy(), np.asarray(jv))
    assert int(valid[0].sum()) >= t and not valid[0, 4096:].any()
    assert 0 < int(valid[1].sum()) <= 870 and valid[1, 4096:].any()


@pytest.mark.parametrize("shape", [(24, 28, 134, 486), (20, 300, 2001, 299)],
                         ids=["direct-n24-m28", "blocked-n20-m300"])
def test_sample_and_split_matches_jax(shape):
    """The overdraw path with the exclude top-up (its own cascade, seeded
    with the kept sample), every buffer and count bit-equal."""
    n, m, t_cap, extra_cap = shape
    jkeys, tst, xs = _streams(n, m)
    got = tbtl.sample_and_split(tst, torch.from_numpy(xs), t_cap, extra_cap,
                                "user_similarity", keep_sample=True)
    for r in range(2):
        want = jbtl.sample_and_split(jrng.rep_streams(jkeys[r]),
                                     jnp.asarray(xs[r]), t_cap, extra_cap,
                                     "user_similarity", keep_sample=True)
        for f in want._fields:
            if f == "sample":
                np.testing.assert_array_equal(got.sample.triplets[r].numpy(),
                                              np.asarray(want.sample.triplets))
                assert int(got.sample.count[r]) == int(want.sample.count)
                continue
            np.testing.assert_array_equal(getattr(got, f)[r].numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
