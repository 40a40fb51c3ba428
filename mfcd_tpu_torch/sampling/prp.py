"""Direct sampling-without-replacement via keyed permutation prefixes.

Counterpart of ``mfcd_tpu/sampling/prp.py``; buffers and counts are
bit-equal to it given the same X.  The reference's ``random`` /
``proximity`` / ``top_k`` / ``svd`` samplers (``generation_data.py:16-43,
128-224``) are rejection loops over a finite proposal domain with uniform
proposals that stop at ``num_triplets``: a uniformly random T-subset in
uniform order.  The first T values of a keyed pseudorandom permutation of
the domain give that directly: no overdraw, no dedup, ``count == target``
by construction, and the test top-up continues the same permutation past
``t_cap`` (disjoint from the main block by bijectivity).

Domains: random, ``[n] x {(i, j) : i != j}``; proximity, ``[n] x [kk] x
[kk]`` positions into the per-user top-kk / bottom-kk tables; top_k,
``[n] x {(a, b) in [kk]^2 : a != b}`` into the per-user top-kk table; svd,
``[n_top] x {(a, b) in [m_top]^2 : a != b}`` into the global top-user /
top-item tables.  ``margin`` draws PRP-distinct proposals filtered by its
acceptance window (``strategies.propose_margin``).  The other strategies
take the overdraw and dedup path.

Every tensor carries a leading run axis ``[R, ...]``.  ``jax.lax.top_k``
puts the lower index first among ties; ``torch.topk`` promises no order,
so the tables come from a stable descending sort.
"""

from __future__ import annotations

import torch

from mfcd_tpu_torch.core.config import TRAIN_RATIO, VAL_RATIO
from mfcd_tpu_torch.ops.shuffle import (exact_prefix_permutation,
                                        exact_prefix_permutation_inverse)
from mfcd_tpu_torch.sampling.dedup import SplitArrays
from mfcd_tpu_torch.utils import observability as obs

PROXIMITY_K = 100  # reference default (generation_data.py:29)

# The sample stage's detail spans (``observability.detail``): a strategy's
# tables for the run's X, and the draw (proposals, the PRP map or the
# first-occurrence winners, the splits, the top-up); and its counter of
# candidates proposed.
TABLES = "mfcd.sample.tables"
DRAW = "mfcd.sample.draw"
CANDIDATES = "sample.candidates"


def prp_domain_size(n: int, m: int) -> int:
    """|D| = n * m * (m - 1) ordered (u, i, j) tuples with i != j."""
    return int(n) * int(m) * (int(m) - 1)


def prp_supported(n: int, m: int, *blocks: int) -> bool:
    """Random-strategy gate: packable domain, blocks fit."""
    dom = prp_domain_size(n, m)
    return m >= 2 and dom < 2**31 and sum(int(b) for b in blocks) <= dom


def prp_indices(key: torch.Tensor, slots: torch.Tensor,
                dom: int) -> torch.Tensor:
    """Evaluate the exact domain PRP at ``slots`` (distinct, in [0, dom))."""
    k_bits = max((dom - 1).bit_length(), 1)
    return exact_prefix_permutation(key, slots, dom, k_bits)


def _pair_decode(pair: torch.Tensor, k: int):
    """Decode pair in [0, k(k-1)) into ordered distinct (a, b), a != b."""
    a = pair // (k - 1)
    bp = pair - a * (k - 1)
    b = bp + (bp >= a).to(pair.dtype)
    return a, b


def decode_random(idx: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Mixed-radix decode of random-domain indices ``[...]`` into
    ``[..., 3]`` int32 (u, i, j), i != j."""
    pairs_per_u = m * (m - 1)
    u = idx // pairs_per_u
    i, j = _pair_decode(idx - u * pairs_per_u, m)
    return torch.stack([u, i, j], dim=-1).to(torch.int32)


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """``jax.lax.top_k(x, k)[1]`` over the last axis as int64: the lower
    index first among ties."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[r, idx[r, ...]]`` for a per-run ``table [R, K]``."""
    r = table.shape[0]
    flat = idx.reshape(r, -1).to(torch.int64)
    return torch.gather(table, 1, flat).reshape(idx.shape)


def _take_rows(table: torch.Tensor, u: torch.Tensor,
               col: torch.Tensor) -> torch.Tensor:
    """``table[r, u, col]`` for a per-run ``table [R, n, k]``."""
    k = table.shape[-1]
    return _take(table.reshape(table.shape[0], -1),
                 u.to(torch.int64) * k + col.to(torch.int64))


def proximity_prp_supported(n: int, m: int, *blocks: int,
                            k: int = PROXIMITY_K) -> bool:
    """Proximity gate; also needs ``m >= 2*kk`` so the top and bottom
    index sets are disjoint and ``i != j`` holds on the whole domain."""
    kk = min(int(k), int(m))
    dom = int(n) * kk * kk
    return (m >= 2 * kk and dom < 2**31
            and sum(int(b) for b in blocks) <= dom)


def proximity_tables(x: torch.Tensor, k: int = PROXIMITY_K,
                     disjoint: bool = True):
    """Per-user top-kk / bottom-kk item-index tables (``[R, n, kk]`` int32
    each).  ``disjoint=True`` (the PRP path) masks the top-kk entries to
    +inf before taking the bottom table, so the tables stay disjoint when
    X has ties; the overdraw path uses ``disjoint=False`` and an explicit
    ``i != j`` mask, the reference's rejection semantics under ties."""
    kk = min(int(k), x.shape[-1])
    top = top_k_indices(x, kk)
    if disjoint:
        x = x.scatter(-1, top, float("inf"))
    bot = top_k_indices(-x, kk)
    return top.to(torch.int32), bot.to(torch.int32)


def decode_proximity(idx: torch.Tensor, kk: int, top_idx: torch.Tensor,
                     bot_idx: torch.Tensor) -> torch.Tensor:
    """(u, a, b) -> (u, top[u, a], bot[u, b]) as ``[R, T, 3]`` int32."""
    per_u = kk * kk
    u = idx // per_u
    rest = idx - u * per_u
    a = rest // kk
    b = rest - a * kk
    return torch.stack([u, _take_rows(top_idx, u, a),
                        _take_rows(bot_idx, u, b)], dim=-1).to(torch.int32)


def topk_prp_supported(n: int, m: int, *blocks: int,
                       k: int | None = None) -> bool:
    """top_k gate: kk >= 2, packable domain, blocks fit; ``kk`` defaults
    to the reference's ``min(m, max(5, 0.1 m))``."""
    from mfcd_tpu_torch.sampling.strategies import top_k_value

    kk = top_k_value(m) if k is None else min(int(k), int(m))
    dom = int(n) * kk * (kk - 1)
    return kk >= 2 and dom < 2**31 and sum(int(b) for b in blocks) <= dom


def topk_table(x: torch.Tensor, k: int | None = None) -> torch.Tensor:
    """Per-user top-kk item-index table (``[R, n, kk]`` int32)."""
    from mfcd_tpu_torch.sampling.strategies import top_k_value

    m = x.shape[-1]
    kk = top_k_value(m) if k is None else min(int(k), m)
    return top_k_indices(x, kk).to(torch.int32)


def decode_top_k(idx: torch.Tensor, kk: int,
                 top_idx: torch.Tensor) -> torch.Tensor:
    """(u, a, b) -> (u, top[u, a], top[u, b]) as ``[R, T, 3]`` int32."""
    per_u = kk * (kk - 1)
    u = idx // per_u
    a, b = _pair_decode(idx - u * per_u, kk)
    return torch.stack([u, _take_rows(top_idx, u, a),
                        _take_rows(top_idx, u, b)], dim=-1).to(torch.int32)


def svd_dims(n: int, m: int, top_fraction: float = 0.3):
    """(num_top_users, num_top_items) (``generation_data.py:156-157``)."""
    return (max(1, int(top_fraction * n)), max(2, int(top_fraction * m)))


def svd_prp_supported(n: int, m: int, *blocks: int,
                      top_fraction: float = 0.3) -> bool:
    """svd gate: packable top-set domain, blocks fit."""
    nu, mt = svd_dims(n, m, top_fraction)
    dom = nu * mt * (mt - 1)
    return mt >= 2 and dom < 2**31 and sum(int(b) for b in blocks) <= dom


def decode_svd(idx: torch.Tensor, mt: int, top_users: torch.Tensor,
               top_items: torch.Tensor) -> torch.Tensor:
    """(us, a, b) -> (top_users[us], top_items[a], top_items[b])."""
    per_u = mt * (mt - 1)
    us = idx // per_u
    a, b = _pair_decode(idx - us * per_u, mt)
    return torch.stack([_take(top_users, us), _take(top_items, a),
                        _take(top_items, b)], dim=-1).to(torch.int32)


def margin_prp_supported(n: int, m: int, t_cap: int,
                         extra_cap: int = 0) -> bool:
    """Margin PRP-distinct gate: both proposal plans fit the random domain,
    and ``2 * extra_cap <= t_cap``, so the top-up's acceptance window is a
    subset of the main one (``prp.py:240-258``)."""
    from mfcd_tpu_torch.sampling.strategies import plan_overdraw

    md = plan_overdraw("margin", t_cap, n, m)
    extra_draw = (plan_overdraw("margin", extra_cap, n, m)
                  if extra_cap > 0 else 0)
    return prp_supported(n, m, md + extra_draw) and 2 * extra_cap <= t_cap


def fast_path_kind(strategy: str, n: int, m: int, t_cap: int,
                   extra_cap: int = 0):
    """Which sampler working set ``sample_and_split`` allocates: 'prefix'
    (a pure PRP map: random, proximity, top_k, svd), 'distinct' (margin's
    PRP-distinct proposals, no hash table) or None (overdraw and dedup).
    Shape-only, shared with the sweep's memory model."""
    blocks = (t_cap, extra_cap)
    if strategy == "random" and prp_supported(n, m, *blocks):
        return "prefix"
    if strategy == "proximity" and proximity_prp_supported(n, m, *blocks):
        return "prefix"
    if strategy == "top_k" and topk_prp_supported(n, m, *blocks):
        return "prefix"
    if strategy == "svd" and svd_prp_supported(n, m, *blocks):
        return "prefix"
    if strategy == "margin" and margin_prp_supported(n, m, t_cap, extra_cap):
        return "distinct"
    return None


def uniform_domain(strategy: str, x: torch.Tensor, *blocks: int,
                   key: torch.Tensor | None = None,
                   svd_num_triplets: int | None = None, svd_budget=None):
    """``(dom, decode, key)`` for a PRP-eligible strategy and shape, else
    ``None``.  ``key`` comes back split for svd, whose table decomposition
    consumes randomness (``prp.py:318``), and unchanged otherwise."""
    n, m = x.shape[-2:]
    if strategy == "random" and prp_supported(n, m, *blocks):
        return (prp_domain_size(n, m),
                lambda idx: decode_random(idx, n, m), key)
    if strategy == "proximity" and proximity_prp_supported(n, m, *blocks):
        kk = min(PROXIMITY_K, m)
        obs.detail(TABLES)
        top_idx, bot_idx = proximity_tables(x)
        return (n * kk * kk,
                lambda idx: decode_proximity(idx, kk, top_idx, bot_idx),
                key)
    if strategy == "top_k" and topk_prp_supported(n, m, *blocks):
        obs.detail(TABLES)
        top_idx = topk_table(x)
        kk = top_idx.shape[-1]
        return (n * kk * (kk - 1),
                lambda idx: decode_top_k(idx, kk, top_idx), key)
    if strategy == "svd" and svd_prp_supported(n, m, *blocks):
        from mfcd_tpu_torch.core import prng
        from mfcd_tpu_torch.sampling.strategies import svd_tables

        k_tbl, key = prng.split(key).unbind(-2)
        obs.detail(TABLES)
        tu, ti = svd_tables(k_tbl, x, svd_num_triplets, budget=svd_budget)
        nu, mt = tu.shape[-1], ti.shape[-1]
        return (nu * mt * (mt - 1),
                lambda idx: decode_svd(idx, mt, tu, ti), key)
    return None


def prp_splits(
    sample_key: torch.Tensor,
    split_key: torch.Tensor,
    dom: int,
    decode,
    t_cap: int,
    train_cap: int,
    val_cap: int,
    test_cap: int,
    count,
    extra_cap: int = 0,
    extra_count=0,
) -> SplitArrays:
    """Assemble the 80/10/10 split buffers by a pure map over output slots.

    Each output slot ``y`` computes its source rank ``r = splitPRP^-1(y)``
    and then its triplet ``decode(domPRP(r))``.  Test slots past the
    dataset's ``test_sz`` read the PRP continuation block at
    ``t_cap + (off - test_sz)`` (the top-up).  ``sample_key`` may carry a
    leading run axis ``[R, 2]``; ``count`` / ``extra_count`` are ints or
    ``[R]`` tensors.  The split sizes are computed in float32, as the JAX
    function does (``prp.py:366-367``).
    """
    dev = sample_key.device
    # an int count is filled in on the device, not copied to it
    i32 = lambda v: (v.to(torch.int32) if isinstance(v, torch.Tensor) else
                     torch.full((), int(v), dtype=torch.int32, device=dev))
    count, extra_count = i32(count), i32(extra_count)
    count_f = count.to(torch.float32)
    train_sz = torch.floor(TRAIN_RATIO * count_f).to(torch.int32)
    val_sz = torch.floor(VAL_RATIO * count_f).to(torch.int32)
    test_sz = count - train_sz - val_sz
    test_fit = torch.clamp(test_sz, max=test_cap)

    col = lambda v: v.unsqueeze(-1)
    total = train_cap + val_cap + (test_cap + extra_cap)
    o = torch.arange(total, dtype=torch.int32, device=dev)
    in_tr = o < train_cap
    in_va = (o >= train_cap) & (o < train_cap + val_cap)
    off = torch.where(in_tr, o,
                      torch.where(in_va, o - train_cap,
                                  o - train_cap - val_cap))
    zero = torch.zeros_like(col(train_sz))
    base = torch.where(in_tr, zero,
                       torch.where(in_va, col(train_sz),
                                   col(train_sz + val_sz)))
    sz = torch.where(in_tr, col(train_sz),
                     torch.where(in_va, col(val_sz), col(test_fit)))
    is_data = off < sz
    # Top-up continuation: test slots just past the dataset rows.
    is_extra = ((~in_tr) & (~in_va) & (off >= col(test_fit))
                & (off - col(test_fit) < col(extra_count)))

    y = torch.where(is_data, base + off, torch.zeros_like(base))
    k_bits = max((t_cap - 1).bit_length(), 1)
    r = exact_prefix_permutation_inverse(split_key, y, count, k_bits)
    slots = torch.where(is_extra, t_cap + (off - col(test_fit)), r)
    tri = decode(prp_indices(sample_key, slots, dom))
    big = torch.where((is_data | is_extra).unsqueeze(-1), tri,
                      torch.zeros_like(tri))

    return SplitArrays(
        train=big[..., :train_cap, :],
        train_count=torch.clamp(train_sz, max=train_cap),
        val=big[..., train_cap:train_cap + val_cap, :],
        val_count=torch.clamp(val_sz, max=val_cap),
        test=big[..., train_cap + val_cap:, :],
        test_count=test_fit + extra_count,
    )
