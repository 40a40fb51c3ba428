"""Triplet proposal distributions — the 9 reference sampling strategies.

Counterpart of ``mfcd_tpu/sampling/strategies.py``.  Each strategy is a
static-shape proposal function ``(key, x, m_draw) -> (cands [R, M, 3]
int32, valid [R, M])`` that feeds the unique selection of
``sampling/dedup.py``; the reference's rejection loops
(``generation_data.py:11-338``) become overdrawn vectorized draws.  Every
tensor carries a leading run axis ``[R, ...]`` (the JAX engine's ``vmap``
over configs x reps); keys are ``[R, 2]``.

Given the same X, the integer maps (random, proximity, top_k, the cascade)
are bit-equal to the JAX package's.  Where a float decides a selection
(the variance and popularity CDFs, the margin window, the k-means
assignments, the randomized-SVD norms, the cosine neighbours), a value
within float32 rounding of a boundary may fall the other way.  The
variance and popularity CDFs are summed and scanned in fixed point
(``_exact_cdf``), so a run's draws do not depend on the runs beside it
on the card, where torch splits a float sum or scan by the row count.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from mfcd_tpu_torch.core import prng
from mfcd_tpu_torch.core.prng import M32, mul32
from mfcd_tpu_torch.genx.clusters import kmeans
from mfcd_tpu_torch.ops.linalg import randomized_svd
from mfcd_tpu_torch.sampling.prp import (DRAW, TABLES, _take, _take_rows,
                                         top_k_indices, decode_random,
                                         prp_domain_size, prp_indices,
                                         proximity_tables, svd_dims,
                                         topk_table)
from mfcd_tpu_torch.utils import observability as obs

_I32_MAX = 2**31 - 1

# Host syncs of the user_similarity cascade: fixpoint passes, and blocks of
# the blocked resolver (each pass reads one ``any()`` back).
CASCADE_PASSES = 0
CASCADE_BLOCKS = 0


def _keys(key: torch.Tensor, num: int):
    return prng.split(key, num).unbind(-2)


def _stack(u, i, j) -> torch.Tensor:
    return torch.stack([u, i, j], dim=-1).to(torch.int32)


def _x_at(x: torch.Tensor, u, i) -> torch.Tensor:
    """``x[r, u, i]`` for ``x [R, n, m]`` and ``[R, M]`` indices."""
    m = x.shape[-1]
    return _take(x.reshape(x.shape[0], -1),
                 u.to(torch.int64) * m + i.to(torch.int64))


def _exact_cdf(weights: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The probabilities and CDF ``[R, m]`` (float32) of nonnegative
    weights, the same bits whatever R and on either device.

    On the card torch splits a row's float sum and scan by the number of
    rows, so a run's CDF would depend on the chunk around it.  Here each
    row is scaled by a power of two to int64 fixed point below 2^62 (its
    max, which is exact in any order, sets the scale), summed and scanned
    exactly, and each result rounded once to float32."""
    w = weights.to(torch.float64)
    _, top = torch.frexp(w.amax(dim=-1, keepdim=True))
    shift = 62 - (w.shape[-1] - 1).bit_length() - top
    fixed = torch.round(torch.ldexp(w, shift)).to(torch.int64)
    scan = torch.cumsum(fixed, dim=-1).to(torch.float64)
    total = scan[..., -1:]
    return ((fixed.to(torch.float64) / total).to(torch.float32),
            (scan / total).to(torch.float32))


def _categorical_pair_from_cdf(key, cdf, probs, m_draw: int):
    """Exact sampling of (i, j), i != j, i ~ p and j ~ p | j != i: j's
    uniform variate shrinks to the mass 1 - p_i and skips i's CDF span.
    ``cdf``, ``probs`` are ``[R, m]``."""
    k1, k2 = _keys(key, 2)
    last = cdf.shape[-1] - 1
    total = cdf[..., -1:]
    u1 = prng.uniform(k1, (m_draw,))
    i = torch.clamp(torch.searchsorted(cdf, u1 * total, right=True), max=last)
    p_i = torch.gather(probs, 1, i)
    cdf_left = torch.gather(cdf, 1, i) - p_i
    u2 = prng.uniform(k2, (m_draw,)) * torch.clamp(total - p_i, min=1e-30)
    u2 = torch.where(u2 >= cdf_left, u2 + p_i, u2)
    j = torch.clamp(torch.searchsorted(cdf, u2, right=True), max=last)
    return i.to(torch.int32), j.to(torch.int32)


def _distinct_pos(key, m_draw: int, k: int) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Uniform distinct pair of positions in [0, k)."""
    k1, k2 = _keys(key, 2)
    a = prng.randint(k1, (m_draw,), 0, k)
    b = prng.randint(k2, (m_draw,), 0, max(k - 1, 1))
    if k > 1:
        b = torch.where(b >= a, b + 1, b)
    return a, b


# === RANDOM (reference ``generation_data.py:16-26``) =====================

def propose_random(key, x, m_draw):
    n, m = x.shape[-2:]
    obs.detail(DRAW)
    ku, kij = _keys(key, 2)
    u = prng.randint(ku, (m_draw,), 0, n)
    ij = prng.randint(kij, (m_draw, 2), 0, m)
    return _stack(u, ij[..., 0], ij[..., 1]), ij[..., 0] != ij[..., 1]


# === PROXIMITY aka Max-Min (reference ``generation_data.py:29-43``) ======

def propose_proximity(key, x, m_draw, k: int = 100):
    n, m = x.shape[-2:]
    kk = min(k, m)
    # Unmasked tables + the i != j mask: the reference's rejection
    # semantics (the PRP path uses disjoint=True instead).
    obs.detail(TABLES)
    top_idx, bot_idx = proximity_tables(x, k=kk, disjoint=False)
    obs.detail(DRAW)
    ku, ki, kj = _keys(key, 3)
    u = prng.randint(ku, (m_draw,), 0, n)
    i = _take_rows(top_idx, u, prng.randint(ki, (m_draw,), 0, kk))
    j = _take_rows(bot_idx, u, prng.randint(kj, (m_draw,), 0, kk))
    return _stack(u, i, j), i != j


# === MARGIN aka Close-Call (reference ``generation_data.py:46-84``) ======

def margin_window(x, num_triplets):
    """Adaptive margin from the first min(10, n) rows
    (``generation_data.py:56-57``), ``[R]``; ``num_triplets`` is an int or
    an ``[R]`` budget (then divided in float32, as JAX divides a traced
    int32)."""
    n, m = x.shape[-2:]
    sample = x[..., :min(10, n), :]
    margin = torch.mean(sample.amax(dim=-1) - sample.amin(dim=-1), dim=-1)
    if isinstance(num_triplets, torch.Tensor):
        return margin * (num_triplets.to(torch.float32) / (n * m))
    return margin * (num_triplets / (n * m))


def propose_margin(key, x, m_draw, num_triplets, prp_distinct: bool = False,
                   slot_offset: int = 0):
    """Uniform (u, i, j) proposals filtered by the score window.

    ``prp_distinct=True`` draws them as a keyed-PRP prefix over the random
    domain from ``slot_offset`` on: pairwise distinct, so acceptance is the
    only selection, and a later block is disjoint from this one."""
    n, m = x.shape[-2:]
    obs.detail(TABLES)
    margin = margin_window(x, num_triplets).unsqueeze(-1)
    obs.detail(DRAW)
    if prp_distinct:
        slots = slot_offset + torch.arange(m_draw, dtype=torch.int64,
                                           device=x.device)
        cands = decode_random(prp_indices(key, slots, prp_domain_size(n, m)),
                              n, m)
        u, i, j = cands.unbind(-1)
        return cands, (_x_at(x, u, i) - _x_at(x, u, j)).abs() <= margin
    ku, ki, kj = _keys(key, 3)
    u = prng.randint(ku, (m_draw,), 0, n)
    i = prng.randint(ki, (m_draw,), 0, m)
    j = prng.randint(kj, (m_draw,), 0, m)
    accept = (_x_at(x, u, i) - _x_at(x, u, j)).abs() <= margin
    return _stack(u, i, j), (i != j) & accept


# === VARIANCE (reference ``generation_data.py:87-99``) ===================

def _var_ddof1(x):
    """``jnp.var(x, axis=0, ddof=1)`` per run, in jnp's two-pass form."""
    n = x.shape[-2]
    centered = x - x.sum(dim=-2, keepdim=True) / n
    return (centered * centered).sum(dim=-2) / (n - 1)


def propose_variance(key, x, m_draw):
    n = x.shape[-2]
    obs.detail(TABLES)
    probs, cdf = _exact_cdf(_var_ddof1(x))  # torch.var's unbiased form
    obs.detail(DRAW)
    ku, kij = _keys(key, 2)
    u = prng.randint(ku, (m_draw,), 0, n)
    i, j = _categorical_pair_from_cdf(kij, cdf, probs, m_draw)
    return _stack(u, i, j), i != j


# === POPULARITY (reference ``generation_data.py:103-128``) ===============

def popularity_probs(m: int, method: str = "zipf", alpha: float = 1.5,
                     device=None):
    """Item-index popularity distribution ``[m]``; the reference applies
    the law over raw item indices, not score ranks (preserved)."""
    idx = torch.arange(1, m + 1, dtype=torch.float32, device=device)
    if method == "zipf":
        probs = 1.0 / idx ** alpha
    elif method == "exponential":
        probs = torch.exp(-alpha * (idx - 1.0))
    elif method == "uniform":
        probs = torch.ones((m,), dtype=torch.float32, device=device)
    else:
        raise ValueError(f"Unknown popularity method: {method}")
    return probs / probs.sum()


def propose_popularity(key, x, m_draw, method: str = "zipf",
                       alpha: float = 1.5):
    n, m = x.shape[-2:]
    obs.detail(TABLES)
    probs, cdf = _exact_cdf(popularity_probs(m, method, alpha, x.device)
                            .expand(x.shape[0], m))
    obs.detail(DRAW)
    ku, kij = _keys(key, 2)
    u = prng.randint(ku, (m_draw,), 0, n)
    i, j = _categorical_pair_from_cdf(kij, cdf, probs, m_draw)
    return _stack(u, i, j), i != j


# === TOP-K aka Top 10% (reference ``generation_data.py:189-224``) ========

def top_k_value(m: int) -> int:
    """k = min(m, max(5, 0.1 m)) (``generation_data.py:199``)."""
    return min(m, max(5, int(0.1 * m)))


def estimate_k(num_triplets: int) -> int:
    """Smallest k with k(k-1)/2 >= T (``generation_data.py:186-187``)."""
    return math.ceil((1 + math.sqrt(1 + 8 * num_triplets)) / 2)


def propose_top_k(key, x, m_draw, k: int | None = None):
    n = x.shape[-2]
    obs.detail(TABLES)
    top_idx = topk_table(x, k=k)
    obs.detail(DRAW)
    kk = top_idx.shape[-1]
    ku, kp = _keys(key, 2)
    u = prng.randint(ku, (m_draw,), 0, n)
    pa, pb = _distinct_pos(kp, m_draw, kk)
    i = _take_rows(top_idx, u, pa)
    j = _take_rows(top_idx, u, pb)
    return _stack(u, i, j), i != j


# === CLUSTER (reference ``generation_data.py:229-247``) ==================

def propose_cluster(key, x, m_draw, n_clusters: int = 10):
    """Items k-means-clustered on their column vectors; i and j drawn
    from two distinct uniformly chosen clusters."""
    n, m = x.shape[-2:]
    kc, ku, kcl, kii, kjj = _keys(key, 5)
    obs.detail(TABLES)
    labels, _ = kmeans(kc, x.transpose(-1, -2), n_clusters)
    order = torch.argsort(labels, dim=-1, stable=True)
    counts = torch.nn.functional.one_hot(labels, n_clusters).sum(dim=1)
    offsets = torch.cumsum(counts, dim=-1) - counts
    obs.detail(DRAW)

    u = prng.randint(ku, (m_draw,), 0, n)
    c1, c2 = _distinct_pos(kcl, m_draw, n_clusters)
    u1 = prng.uniform(kii, (m_draw,))
    u2 = prng.uniform(kjj, (m_draw,))
    n1, n2 = _take(counts, c1), _take(counts, c2)

    def member(c, cnt, uu):
        # JAX clamps an out-of-range gather index (an empty last cluster).
        pos = _take(offsets, c) + torch.floor(uu * cnt.to(torch.float32)).to(
            torch.int64)
        return _take(order, torch.clamp(pos, 0, m - 1))

    i, j = member(c1, n1, u1), member(c2, n2, u2)
    return _stack(u, i, j), (n1 > 0) & (n2 > 0) & (i != j)


# === SVD projection (reference ``generation_data.py:131-179``) ===========

def svd_rank(num_triplets: int, n: int, m: int) -> int:
    """Budget-derived rank (``generation_data.py:144``)."""
    return max(1, int(num_triplets / (n * m) * max(n, m)))


def svd_tables(key, x, num_triplets: int, top_fraction: float = 0.3,
               budget=None):
    """Top-user / top-item index tables (``[R, nu]``, ``[R, mt]`` int32)
    by latent-projection norm.  ``num_triplets`` sizes the truncated
    decomposition; a ``budget`` (int or ``[R]``) masks the active rank
    down to the exact budget's rank, in integer arithmetic
    (``strategies.py:256-262``)."""
    n, m = x.shape[-2:]
    rank = min(svd_rank(num_triplets, n, m), min(n, m))
    q = min(rank + 8, min(n, m))
    u_full, s, vt = randomized_svd(x, q, key)
    s = s[..., :rank]
    if budget is not None:
        rank_exact = torch.as_tensor(budget, dtype=torch.int64,
                                     device=x.device) // min(n, m)
        rank_exact = torch.clamp(rank_exact, 1, rank).reshape(-1, 1)
        arange = torch.arange(rank, device=x.device)
        s = s * (arange < rank_exact).to(torch.float32)
    u_proj = u_full[..., :rank] * s.unsqueeze(-2)
    v_proj = vt[..., :rank, :].transpose(-1, -2) * s.unsqueeze(-2)
    user_norms = torch.sqrt(torch.sum(u_proj * u_proj, dim=-1))
    item_norms = torch.sqrt(torch.sum(v_proj * v_proj, dim=-1))
    num_top_users, num_top_items = svd_dims(n, m, top_fraction)
    return (top_k_indices(user_norms, num_top_users).to(torch.int32),
            top_k_indices(item_norms, num_top_items).to(torch.int32))


def propose_svd(key, x, m_draw, num_triplets: int, top_fraction: float = 0.3,
                budget=None):
    """Overdraw proposals from the :func:`svd_tables` top sets."""
    kp, key = _keys(key, 2)
    obs.detail(TABLES)
    top_users, top_items = svd_tables(kp, x, num_triplets,
                                      top_fraction=top_fraction,
                                      budget=budget)
    obs.detail(DRAW)
    ku, kp = _keys(key, 2)
    u = _take(top_users, prng.randint(ku, (m_draw,), 0,
                                      top_users.shape[-1]))
    pa, pb = _distinct_pos(kp, m_draw, top_items.shape[-1])
    i, j = _take(top_items, pa), _take(top_items, pb)
    return _stack(u, i, j), i != j


# === USER SIMILARITY (reference ``generation_data.py:251-338``) ==========

# Attempts per block of the blocked resolver: 4096 at tk = 30, floored at
# 1024 (``strategies.py:309-310``; the block layout fixes the RNG stream).
_US_BLOCK_ELEMS = 4096 * 30 * 30
_US_BLOCK_MIN = 1024


def user_similarity_dims(n: int, m: int, num_triplets: int):
    """(num_neighbors, top_k_items) (``generation_data.py:278-280``)."""
    nb = min(min(20, max(3, num_triplets // n)), n - 1)
    tk = min(max(3, min(m // 10, 10 + num_triplets // (5 * n))), m)
    return nb, tk


def user_similarity_blocks(attempts: int, tk: int):
    """(blk, nblk): attempts per block and the block count."""
    blk = min(attempts, max(_US_BLOCK_MIN,
                            _US_BLOCK_ELEMS // max(tk * tk, 1)))
    return blk, -(-attempts // blk)


def propose_user_similarity(key, x, m_draw, num_triplets: int, exclude=None,
                            exclude_valid=None):
    """Cosine-similar users' divergent top items, with the reference's
    per-attempt neighbour cascade resolved in the sampler.

    ``m_draw`` counts attempts.  Each attempt gets one candidate per
    neighbour rank; the cascade (:func:`cascade_resolve`) accepts, for each
    attempt in order, its first rank whose triplet is not yet accepted or
    excluded (``generation_data.py:294-316``).  Returned rows are each
    attempt's accepted candidate.  A single block takes the direct path;
    otherwise blocks run in attempt order, threading the accepted-key
    table, and stop once ``num_triplets`` attempts have resolved (exact:
    attempt a's outcome depends on attempts < a only).  A run that has
    stopped takes no part in later blocks: its candidates are masked out,
    so its table and outputs stay as they were."""
    global CASCADE_BLOCKS
    r, n, m = x.shape
    dev = x.device
    nb, tk = user_similarity_dims(n, m, num_triplets)
    obs.detail(TABLES)
    xn = x / torch.clamp(torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)),
                         min=1e-12)
    sims = xn @ xn.transpose(-1, -2) - 2.0 * torch.eye(n, device=dev)
    neighbors = top_k_indices(sims, nb)                       # [R, n, nb]
    topk_idx = top_k_indices(x, tk)                           # [R, n, tk]

    ku, kc = _keys(key, 2)
    a = m_draw
    u = prng.randint(ku, (a,), 0, n)                          # [R, A]
    ranks = torch.arange(nb, device=dev)

    # member[r, v * m + i]: item i is in top(v).
    member = torch.zeros((r, n * m), dtype=torch.bool, device=dev).scatter_(
        1, (torch.arange(n, device=dev).view(1, n, 1) * m + topk_idx).reshape(
            r, -1), True)
    obs.detail(DRAW)

    def block_candidates(kk_b, u_c):
        """Per-rank (i, j), ``[R, nb, blk]``, in top-set position space:
        top(u) minus top(v) are the positions of top(u) whose item is not
        a member of top(v) (``strategies.py:376-412``)."""
        blk = u_c.shape[-1]
        kki, kkj, kkf = prng.split(prng.split(kk_b, nb), 3).unbind(-2)
        u_c = u_c.to(torch.int64).unsqueeze(1)                # [R, 1, blk]
        v_c = _take_rows(neighbors, u_c, ranks.view(1, nb, 1))  # [R,nb,blk]
        cols = torch.arange(tk, device=dev)
        tk_u = _take_rows(topk_idx, u_c.unsqueeze(-1), cols)  # [R,1,blk,tk]
        tk_v = _take_rows(topk_idx, v_c.unsqueeze(-1), cols)  # [R,nb,blk,tk]
        only_u = ~_take(member, v_c.unsqueeze(-1) * m + tk_u)
        only_v = ~_take(member, u_c.unsqueeze(-1) * m + tk_v)
        have = only_u.any(dim=-1) & only_v.any(dim=-1)
        tk_u = tk_u.expand(-1, nb, -1, -1)
        pick = lambda t, p: torch.gather(
            t, -1, p.to(torch.int64).unsqueeze(-1))[..., 0]
        i_diff = pick(tk_u, prng.masked_uniform_choice(kki, only_u))
        j_diff = pick(tk_v, prng.masked_uniform_choice(kkj, only_v))
        pa, pb = _distinct_pos(kkf, blk, tk)
        return (torch.where(have, i_diff, pick(tk_u, pa)),
                torch.where(have, j_diff, pick(tk_u, pb)))

    def accepted(win, i_all, j_all):
        pick = lambda v: torch.where(win, v, 0).sum(dim=1).to(torch.int32)
        return pick(i_all), pick(j_all), win.any(dim=1)

    blk, nblk = user_similarity_blocks(a, tk)
    if nblk == 1:
        CASCADE_BLOCKS += 1
        i_all, j_all = block_candidates(kc, u)
        wins = cascade_resolve(u, i_all, j_all, m, exclude=exclude,
                               exclude_valid=exclude_valid)
        i, j, resolved = accepted(wins, i_all, j_all)
        return _stack(u, i, j), resolved

    bkeys = prng.split(kc, nblk)                              # [R, nblk, 2]
    ex_rows = 0 if exclude is None else int(exclude.shape[1])
    bits = _cascade_bits(a, ex_rows)
    h = 1 << bits
    table = _cascade_base_table(r, h, bits, dev, exclude=exclude,
                                exclude_valid=exclude_valid)
    arange_blk = torch.arange(blk, device=dev)
    tags_local = (arange_blk.view(1, blk) * nb + ranks.view(nb, 1)).to(
        torch.int32)
    u_p = torch.nn.functional.pad(u, (0, nblk * blk - a))
    i_out = torch.zeros((r, nblk * blk), dtype=torch.int32, device=dev)
    j_out = torch.zeros_like(i_out)
    res_out = torch.zeros((r, nblk * blk), dtype=torch.bool, device=dev)
    wins_n = torch.zeros((r,), dtype=torch.int64, device=dev)
    for k in range(nblk):
        active = wins_n < num_triplets
        if not bool(active.any()):
            break
        CASCADE_BLOCKS += 1
        cols = slice(k * blk, (k + 1) * blk)
        u_blk = u_p[:, cols]
        i_all, j_all = block_candidates(bkeys[:, k], u_blk)
        in_range = (k * blk + arange_blk) < a                 # pad rows
        valid = ((i_all != j_all) & in_range.view(1, 1, blk)
                 & active.view(r, 1, 1))
        slot_all = _cascade_slot(u_blk.unsqueeze(1), i_all, j_all, bits)
        win, table = _cascade_fixpoint(slot_all, valid,
                                       tags_local + k * (blk * nb), table, h,
                                       cap=blk)
        i_out[:, cols], j_out[:, cols], res_out[:, cols] = accepted(
            win, i_all, j_all)
        wins_n += res_out[:, cols].sum(dim=1)
    return _stack(u, i_out[:, :a], j_out[:, :a]), res_out[:, :a]


def cascade_resolve(u, i_all, j_all, m: int, exclude=None,
                    exclude_valid=None, max_passes=None):
    """Resolve the neighbour cascade as the reference's sequential loop
    would: for each attempt in order, the first rank whose (u, i, j) is not
    already accepted wins.  ``u [R, A]``, ``i_all``/``j_all [R, nb, A]``;
    returns an ``[R, nb, A]`` win mask, at most one per attempt.

    The sequential semantics are the fixpoint, under attempt-major tags
    ``a * nb + r``, of: participate(a, r) iff no earlier rank of a won;
    win(a, r) iff it participates and holds the least tag among the
    participants with its key.  Iterating from all-participate until
    stable reaches it (``strategies.py:483-538``).  Keys are 32-bit mixed
    hashes of (u, i, j); exclude keys pre-seed the table with tag -1."""
    r, nb, a = i_all.shape
    ex_rows = 0 if exclude is None else int(exclude.shape[1])
    bits = _cascade_bits(a, ex_rows)
    h = 1 << bits
    slot_all = _cascade_slot(u.unsqueeze(1), i_all, j_all, bits)
    tags = (torch.arange(a, device=u.device).view(1, a) * nb
            + torch.arange(nb, device=u.device).view(nb, 1)).to(torch.int32)
    base = _cascade_base_table(r, h, bits, u.device, exclude=exclude,
                               exclude_valid=exclude_valid)
    win, _ = _cascade_fixpoint(slot_all, i_all != j_all, tags, base, h,
                               a if max_passes is None else max_passes)
    return win


def _cascade_bits(attempts: int, ex_rows: int) -> int:
    """Hash-table size exponent: 16x load over attempts + exclude rows."""
    return min(max((16 * (attempts + ex_rows) - 1).bit_length(), 20), 25)


def _cascade_slot(uu, ii, jj, bits: int) -> torch.Tensor:
    """Multiplicative uint32 mix of the triple (wraparound is part of the
    hash); only the top ``bits`` bits are used, as an int64 slot."""
    s = mul32(uu.to(torch.int64) & M32, 2654435761)
    s = mul32(s ^ (ii.to(torch.int64) & M32), 2246822519)
    s = mul32(s ^ (jj.to(torch.int64) & M32), 3266489917)
    return s >> (32 - bits)


def _cascade_base_table(r: int, h: int, bits: int, device, exclude=None,
                        exclude_valid=None) -> torch.Tensor:
    """Fresh ``[R, h + 1]`` table (int32 max), exclude keys seeded at -1;
    slot ``h`` is the spare that takes what JAX drops."""
    table = torch.full((r, h + 1), _I32_MAX, dtype=torch.int32,
                       device=device)
    if exclude is not None:
        ex_slot = _cascade_slot(exclude[..., 0], exclude[..., 1],
                                exclude[..., 2], bits)
        if exclude_valid is not None:
            ex_slot = torch.where(exclude_valid, ex_slot, h)
        table.scatter_reduce_(1, ex_slot, torch.full_like(
            ex_slot, -1, dtype=torch.int32), "amin")
    return table


def _cascade_any_earlier(win: torch.Tensor) -> torch.Tensor:
    """Some rank r' < r of the same attempt won: an exclusive or-scan down
    the rank axis (dim 1)."""
    inc = torch.cumsum(win, dim=1, dtype=torch.int32) > 0
    return torch.cat([torch.zeros_like(win[:, :1]), inc[:, :-1]], dim=1)


def _cascade_fixpoint(slot_all, valid, tags, base_table, h: int, cap):
    """Iterate (participation -> scatter-min -> wins) until stable.

    Returns ``(win, table_out)``: ``table_out`` is ``base_table`` merged
    with the winners' tags only (the accepted-key set a next block must
    see).  JAX runs this loop per run under ``vmap``; one pass more on a
    run that is stable leaves it unchanged, so the loop here runs until
    every run is stable (one host sync a pass)."""
    global CASCADE_PASSES
    r = slot_all.shape[0]
    tags = tags.expand(slot_all.shape).reshape(r, -1)

    def scatter_min(slot):
        return base_table.clone().scatter_reduce_(1, slot.reshape(r, -1),
                                                  tags, "amin")

    def one_pass(win):
        participate = valid & ~_cascade_any_earlier(win)
        slot = torch.where(participate, slot_all, h)
        table = scatter_min(slot)
        won = torch.gather(table, 1, slot.reshape(r, -1)) == tags
        return participate & won.reshape(slot.shape)

    prev = torch.ones_like(valid)
    cur = torch.zeros_like(valid)
    it = 0
    while it < cap and bool((prev != cur).any()):
        prev, cur = cur, one_pass(cur)
        it += 1
        CASCADE_PASSES += 1
    # Each attempt's first win only (a no-op once converged).
    win = cur & ~_cascade_any_earlier(cur)
    return win, scatter_min(torch.where(win, slot_all, h))


# === Overdraw planning (host-side, static) ================================

def _expected_unique_inverse(target: int, population: float) -> float:
    frac = min(target / max(population, 1.0), 0.999)
    return -max(population, 1.0) * math.log1p(-frac)


def plan_overdraw(strategy: str, num_triplets: int, n: int, m: int,
                  popularity_method: str = "zipf", alpha: float = 1.5) -> int:
    """Static proposal count M for a strategy, budget and shape
    (``strategies.py:628-699``); the caps are the reference's attempt
    limits: margin 5e6, top_k 3x, svd 5x."""
    t = num_triplets

    def generic(population, p_valid=1.0, safety=1.3, cap=None):
        mm = _expected_unique_inverse(t, population) / max(p_valid, 1e-6)
        mm = int(math.ceil(mm * safety)) + 512
        mm = max(mm, t)
        return min(mm, cap) if cap else mm

    if strategy == "random":
        return generic(n * m * (m - 1), p_valid=(m - 1) / m)
    if strategy == "proximity":
        k = min(100, m)
        return generic(n * k * k, safety=1.5)
    if strategy == "margin":
        # Acceptance is roughly proportional to T / (n m): M is O(n m).
        return min(5_000_000, max(4 * t, (n * m) // 2 + 4 * t))
    if strategy == "variance":
        return generic(n * m * (m - 1) / 4.0, safety=1.6)
    if strategy == "popularity":
        import numpy as np

        idx = np.arange(1, m + 1, dtype=np.float64)
        if popularity_method == "zipf":
            p = 1.0 / idx**alpha
        elif popularity_method == "exponential":
            p = np.exp(-alpha * (idx - 1.0))
        else:
            p = np.ones(m)
        p /= p.sum()
        eff_items = 1.0 / float((p**2).sum())  # inverse Simpson index
        population = n * eff_items * max(eff_items - 1.0, 1.0)
        return generic(population, safety=2.0, cap=20_000_000)
    if strategy == "top_k":
        return 3 * t
    if strategy == "cluster":
        c = 10
        return generic(n * m * m * (1.0 - 1.0 / c) / 2.0, safety=1.5)
    if strategy == "user_similarity":
        # Attempts; the blocked resolver stops at the budget.
        return max(3 * t, 10_000)
    if strategy == "svd":
        return 5 * t
    raise ValueError(f"Unknown triplet sampling strategy: {strategy}")
