"""Bradley–Terry–Luce labeling and dataset assembly.

Counterpart of ``mfcd_tpu/data/btl.py``:

- labels follow ``P(u prefers i over j) = sigmoid(scale * (X[u,i] - X[u,j]))``
  (reference ``structure.py:509``),
- hard labels draw K independent Bernoulli votes, each its own row,
- soft labels (train split only) average the K votes into one row,
- the 80/10/10 split uses a fixed keyed permutation of the sample's
  insertion order (reference ``structure.py:710-713``),
- the test split is topped up to >= 500 labels with fresh triplets that
  exclude everything already sampled (reference ``structure.py:721-730``).

Every tensor carries a leading run axis ``[R, ...]``; shapes are fixed and
shortfall is a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from mfcd_tpu_torch.core import prng, rng
from mfcd_tpu_torch.core.config import (TRAIN_RATIO, VAL_RATIO, RunConfig,
                                        ShapeInfo)
from mfcd_tpu_torch.sampling import (first_occurrence_winners, plan_overdraw,
                                     prp, propose_candidates,
                                     sample_triplets)
from mfcd_tpu_torch.sampling.dedup import (TripletSet, _compact, scatter_rows,
                                           winners_to_splits)
from mfcd_tpu_torch.sampling.strategies import propose_margin
from mfcd_tpu_torch.utils import observability as obs


class LabeledSplit(NamedTuple):
    """A labeled comparison split: (u, i, j, z) rows with a validity mask."""

    u: torch.Tensor      # [..., N] int32
    i: torch.Tensor      # [..., N] int32
    j: torch.Tensor      # [..., N] int32
    z: torch.Tensor      # [..., N] float32 labels (0/1 hard, k/K soft)
    valid: torch.Tensor  # [..., N] bool
    count: torch.Tensor  # [...] int32 — number of valid rows


class SampledSplits(NamedTuple):
    """Unlabeled triplet splits (K-free): the output of the sample stage."""

    sample: TripletSet
    train: torch.Tensor        # [R, train_cap, 3]
    train_count: torch.Tensor  # [R]
    val: torch.Tensor
    val_count: torch.Tensor
    test: torch.Tensor         # [R, test_cap + extra_cap, 3]
    test_count: torch.Tensor


def _pair_values(x: torch.Tensor, u, i, j) -> torch.Tensor:
    """``X[r, u, i] - X[r, u, j]`` for ``x [R, n, m]`` and ``[R, T]`` indices."""
    rows = torch.arange(x.shape[0], device=x.device).unsqueeze(-1)
    u, i, j = (a.to(torch.int64) for a in (u, i, j))
    return x[rows, u, i] - x[rows, u, j]


def btl_label(key: torch.Tensor, x: torch.Tensor, triplets: torch.Tensor,
              triplet_count: torch.Tensor, scale, K: int,
              soft_label: bool = False) -> LabeledSplit:
    """Label ``[R, T, 3]`` triplets under the BTL model.

    Hard mode returns T*K rows (votes inlined, row-major per triplet); soft
    mode returns T rows whose labels are the mean of K votes.  ``scale`` is
    a float or a ``[R]`` tensor."""
    r, t = triplets.shape[:2]
    tvalid = (torch.arange(t, device=x.device)
              < triplet_count.unsqueeze(-1))
    u, i, j = triplets.unbind(-1)
    diff = _pair_values(x, u, i, j)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    if scale.dim():
        scale = scale.unsqueeze(-1)
    prob = torch.sigmoid(scale * diff)                       # [R, T]
    votes = prng.bernoulli(key, prob.unsqueeze(-1), (t, K))  # [R, T, K]

    if soft_label:
        z = torch.mean(votes.to(torch.float32), dim=-1)
        return LabeledSplit(u=u, i=i, j=j, z=z, valid=tvalid,
                            count=triplet_count.to(torch.int32))

    z = votes.to(torch.float32).reshape(r, t * K)
    rep = lambda a: torch.repeat_interleave(a, K, dim=-1)
    return LabeledSplit(u=rep(u), i=rep(i), j=rep(j), z=z, valid=rep(tvalid),
                        count=(triplet_count * K).to(torch.int32))


def sample_and_split(streams: dict, x: torch.Tensor, t_cap: int,
                     extra_cap: int, strategy: str,
                     popularity_method: str = "zipf", alpha: float = 1.5,
                     budget=None, extra_budget=None,
                     keep_sample: bool = False) -> SampledSplits:
    """Sample unique triplets, split 80/10/10, and top up the test split.

    ``t_cap`` / ``extra_cap`` are buffer capacities; ``budget`` /
    ``extra_budget`` optionally carry the exact triplet targets (ints or
    ``[R]``).  Three paths, chosen from the shape alone as the JAX package
    chooses them (``prp.fast_path_kind``):

    - prefix (random, proximity, top_k, svd): the sample is a PRP prefix of
      the strategy's domain, and the split buffers a pure map over output
      slots; the top-up continues the same permutation;
    - distinct (margin): PRP-distinct proposals filtered by the window,
      the top-up a later block of the same permutation;
    - overdraw: proposals, first-occurrence winners, one fused scatter into
      the splits, and a top-up drawn by ``sample_triplets`` that excludes
      the kept sample, compacted behind the test rows.

    ``keep_sample=True`` also returns the compacted unique sample
    (``SampledSplits.sample.triplets``; empty otherwise).

    The stage's parts are detail spans (``prp.TABLES``, the strategy's
    tables; ``prp.DRAW``, the rest), and the candidates it proposes add to
    the call's ``prp.CANDIDATES`` counter from shapes the host holds: on
    the prefix path the capacities' slots the permutation walks, on the
    other paths the proposals of the overdraw plan or of margin's window.
    """
    with obs.details():
        return _sample_and_split(streams, x, t_cap, extra_cap, strategy,
                                 popularity_method, alpha, budget,
                                 extra_budget, keep_sample)


def _sample_and_split(streams, x, t_cap, extra_cap, strategy,
                      popularity_method, alpha, budget, extra_budget,
                      keep_sample) -> SampledSplits:
    n, m = x.shape[-2:]
    r = x.shape[0]
    dev = x.device
    train_cap = int(TRAIN_RATIO * t_cap)
    val_cap = int(VAL_RATIO * t_cap)
    test_cap = t_cap - train_cap - val_cap
    runs = lambda c: (c.to(torch.int32).expand(r)
                      if isinstance(c, torch.Tensor) else
                      torch.full((r,), int(c), dtype=torch.int32, device=dev))
    empty = torch.zeros((r, 0, 3), dtype=torch.int32, device=dev)

    fast = prp.uniform_domain(strategy, x, t_cap, extra_cap,
                              key=streams["sampling"],
                              svd_num_triplets=t_cap, svd_budget=budget)
    if fast is not None:
        obs.detail(prp.DRAW)
        obs.count(prp.CANDIDATES, r * (t_cap + extra_cap))
        dom, decode, sample_key = fast
        count = runs(t_cap if budget is None else budget)
        extra_count = ((extra_cap if extra_budget is None else extra_budget)
                       if extra_cap > 0 else 0)
        splits = prp.prp_splits(
            sample_key, rng.split_key(dev), dom, decode,
            t_cap, train_cap, val_cap, test_cap, count,
            extra_cap=extra_cap, extra_count=extra_count,
        )
        sample = (decode(prp.prp_indices(
            sample_key, torch.arange(t_cap, device=dev), dom))
            if keep_sample else empty)
        return SampledSplits(
            sample=TripletSet(sample, count),
            train=splits.train, train_count=runs(splits.train_count),
            val=splits.val, val_count=runs(splits.val_count),
            test=splits.test, test_count=runs(splits.test_count),
        )

    # Margin: PRP-distinct proposals need no dedup, and the top-up block at
    # slot md is disjoint from the main one.  Gate: prp.margin_prp_supported.
    margin_prp = (strategy == "margin"
                  and prp.margin_prp_supported(n, m, t_cap, extra_cap))
    if margin_prp:
        md = plan_overdraw("margin", t_cap, n, m)
        cands, win = propose_margin(
            streams["sampling"], x, md,
            t_cap if budget is None else budget, prp_distinct=True)
        obs.count(prp.CANDIDATES, r * md)
    else:
        cands, cvalid = propose_candidates(
            streams["sampling"], x, t_cap, strategy=strategy,
            popularity_method=popularity_method, alpha=alpha, budget=budget)
        obs.count(prp.CANDIDATES, r * cands.shape[1])
        win = first_occurrence_winners(cands, cvalid, nm_shape=(n, m))
    splits, count = winners_to_splits(
        cands, win, t_cap, train_cap, val_cap, test_cap,
        key=rng.split_key(dev), budget=budget)
    sample = TripletSet(_compact(cands, win, t_cap, budget=budget).triplets
                        if keep_sample else empty, count)

    test_triplets, test_count = splits.test, splits.test_count
    if extra_cap > 0:
        if margin_prp:
            extra_draw = plan_overdraw("margin", extra_cap, n, m)
            ec, ea = propose_margin(
                streams["sampling"], x, extra_draw,
                extra_cap if extra_budget is None else extra_budget,
                prp_distinct=True, slot_offset=md)
            obs.count(prp.CANDIDATES, r * extra_draw)
            extra = _compact(ec, ea, extra_cap, budget=extra_budget)
        else:
            # Exclude the kept winners in place: the first ``budget``
            # winners, the dataset the reference excludes.
            b = t_cap if budget is None else torch.as_tensor(
                budget, device=dev).reshape(-1, 1)
            kept = win & (torch.cumsum(win, dim=1) - 1 < b)
            obs.count(prp.CANDIDATES, r * plan_overdraw(
                strategy, extra_cap, n, m,
                popularity_method=popularity_method, alpha=alpha))
            extra = sample_triplets(
                streams["extra_sampling"], x, extra_cap, strategy=strategy,
                popularity_method=popularity_method, alpha=alpha,
                exclude=cands, exclude_valid=kept, budget=extra_budget)
        # Compact concatenation: valid test rows first, then valid extras.
        both = torch.cat([splits.test, extra.triplets], dim=1)
        both_valid = torch.cat(
            [torch.arange(test_cap, device=dev) < test_count.unsqueeze(-1),
             extra.valid], dim=1)
        cap = test_cap + extra_cap
        pos = torch.cumsum(both_valid, dim=1) - 1
        test_triplets = scatter_rows(both, torch.where(both_valid, pos, cap),
                                     cap)
        test_count = test_count + extra.count

    return SampledSplits(
        sample=sample,
        train=splits.train, train_count=splits.train_count,
        val=splits.val, val_count=splits.val_count,
        test=test_triplets, test_count=test_count.to(torch.int32),
    )


def label_splits(streams: dict, x: torch.Tensor, splits: SampledSplits, s,
                 K: int, soft_label: bool
                 ) -> Tuple[LabeledSplit, LabeledSplit, LabeledSplit]:
    """BTL-label sampled splits: (train, val, test).

    Train follows ``soft_label``; val/test are always hard-labeled
    (reference ``structure.py:733-735``)."""
    train = btl_label(streams["labels_train"], x, splits.train,
                      splits.train_count, s, K, soft_label=soft_label)
    val = btl_label(streams["labels_val"], x, splits.val, splits.val_count,
                    s, K, soft_label=False)
    test = btl_label(streams["labels_test"], x, splits.test,
                     splits.test_count, s, K, soft_label=False)
    return train, val, test


class Dataset(NamedTuple):
    train: LabeledSplit
    val: LabeledSplit
    test: LabeledSplit
    sample: TripletSet  # the full unique triplet sample (diagnostics)


def build_dataset(streams: dict, x: torch.Tensor, cfg: RunConfig,
                  shapes: ShapeInfo | None = None, s=None) -> Dataset:
    """Sample, split 80/10/10, top up the test split and label, at the
    config's exact capacities; ``s`` (float or ``[R]``) overrides
    ``cfg.s``."""
    if shapes is None:
        shapes = cfg.shapes()
    if s is None:
        s = cfg.s
    splits = sample_and_split(
        streams, x, t_cap=shapes.num_triplets,
        extra_cap=shapes.extra_test_triplets, strategy=cfg.strategy,
        popularity_method=cfg.popularity_method, alpha=cfg.alpha,
        keep_sample=True)
    train, val, test = label_splits(streams, x, splits, s, cfg.K,
                                    cfg.soft_label)
    return Dataset(train=train, val=val, test=test, sample=splits.sample)
