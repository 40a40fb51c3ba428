"""Triplet sampling — ``sample_triplets`` and ``propose_candidates``.

Counterpart of ``mfcd_tpu/sampling/__init__.py``: unique (u, i, j)
triplets with i != j, exclude-set support, and shortfall as a count below
the budget (reference ``structure.py:533-588``).  Every tensor carries a
leading run axis ``[R, ...]``.
"""

from __future__ import annotations

from typing import Optional

import torch

from mfcd_tpu_torch.sampling import prp, strategies
from mfcd_tpu_torch.sampling.dedup import (  # noqa: F401
    SplitArrays,
    TripletSet,
    _compact,
    first_occurrence_winners,
    overdraw_size,
    select_unique,
    split_triplets,
    winners_to_splits,
)
from mfcd_tpu_torch.sampling.strategies import plan_overdraw

STRATEGIES = (
    "random", "proximity", "margin", "variance", "popularity",
    "top_k", "cluster", "user_similarity", "svd",
)


def sample_triplets(key: torch.Tensor, x: torch.Tensor, num_triplets: int,
                    strategy: str = "random",
                    exclude: Optional[torch.Tensor] = None,
                    exclude_valid: Optional[torch.Tensor] = None,
                    m_draw: Optional[int] = None,
                    popularity_method: str = "zipf", alpha: float = 1.5,
                    n_clusters: int = 10, budget=None) -> TripletSet:
    """Sample ``num_triplets`` unique (u, i, j) comparisons from ``x
    [R, n, m]``; the count may fall short of the budget for constrained
    strategies (``generation_data.py:81-82, 176-177, 221-222``).

    ``budget`` (int or ``[R]``) is the exact target when ``num_triplets``
    is a capacity: the kept count, the margin window and the svd rank
    follow it, while shapes and the overdraw plan follow the capacity."""
    n, m = x.shape[-2:]
    r = x.shape[0]
    eff = num_triplets if budget is None else budget
    if exclude is None:
        # A PRP prefix over the strategy's proposal domain: no overdraw,
        # no dedup, count == budget.
        dom = prp.uniform_domain(strategy, x, num_triplets, key=key,
                                 svd_num_triplets=num_triplets,
                                 svd_budget=budget)
        if dom is not None:
            dom_sz, decode, key = dom
            slots = torch.arange(num_triplets, device=x.device)
            count = torch.as_tensor(eff, dtype=torch.int32,
                                    device=x.device).expand(r)
            return TripletSet(decode(prp.prp_indices(key, slots, dom_sz)),
                              count)
        if strategy == "margin":
            md = m_draw if m_draw is not None else plan_overdraw(
                "margin", num_triplets, n, m)
            if prp.prp_supported(n, m, md):
                # PRP-distinct proposals: acceptance is the only selection.
                cands, accept = strategies.propose_margin(
                    key, x, md, eff, prp_distinct=True)
                return _compact(cands, accept, num_triplets, budget=budget)
    cands, valid = propose_candidates(
        key, x, num_triplets, strategy, m_draw=m_draw,
        popularity_method=popularity_method, alpha=alpha,
        n_clusters=n_clusters, budget=budget, exclude=exclude,
        exclude_valid=exclude_valid)
    return select_unique(cands, valid, num_triplets, exclude=exclude,
                         exclude_valid=exclude_valid, nm_shape=(n, m),
                         budget=budget)


def propose_candidates(key: torch.Tensor, x: torch.Tensor, num_triplets: int,
                       strategy: str, m_draw: Optional[int] = None,
                       popularity_method: str = "zipf", alpha: float = 1.5,
                       n_clusters: int = 10, budget=None,
                       exclude: Optional[torch.Tensor] = None,
                       exclude_valid: Optional[torch.Tensor] = None):
    """Strategy dispatch: overdrawn proposals ``(cands [R, M, 3], valid
    [R, M])`` in draw order.  ``exclude`` is consumed only by
    user_similarity, whose cascade moves an excluded key on to the next
    neighbour; the other strategies leave it to the dedup pass."""
    n, m = x.shape[-2:]
    eff_budget = num_triplets if budget is None else budget
    if m_draw is None:
        m_draw = plan_overdraw(strategy, num_triplets, n, m,
                               popularity_method=popularity_method,
                               alpha=alpha)
    if strategy == "random":
        return strategies.propose_random(key, x, m_draw)
    if strategy == "proximity":
        return strategies.propose_proximity(key, x, m_draw)
    if strategy == "margin":
        return strategies.propose_margin(key, x, m_draw,
                                         num_triplets=eff_budget)
    if strategy == "variance":
        return strategies.propose_variance(key, x, m_draw)
    if strategy == "popularity":
        return strategies.propose_popularity(
            key, x, m_draw, method=popularity_method, alpha=alpha)
    if strategy == "top_k":
        return strategies.propose_top_k(key, x, m_draw)
    if strategy == "cluster":
        return strategies.propose_cluster(key, x, m_draw,
                                          n_clusters=n_clusters)
    if strategy == "user_similarity":
        return strategies.propose_user_similarity(
            key, x, m_draw, num_triplets=num_triplets, exclude=exclude,
            exclude_valid=exclude_valid)
    if strategy == "svd":
        return strategies.propose_svd(key, x, m_draw,
                                      num_triplets=num_triplets,
                                      budget=budget)
    raise ValueError(f"Unknown triplet sampling strategy: {strategy}")
