"""Bradley–Terry–Luce labeling and dataset assembly.

Counterpart of ``mfcd_tpu/data/btl.py``:

- labels follow ``P(u prefers i over j) = sigmoid(scale * (X[u,i] - X[u,j]))``
  (reference ``structure.py:509``),
- hard labels draw K independent Bernoulli votes, each its own row,
- soft labels (train split only) average the K votes into one row,
- the 80/10/10 split and the 500-label test top-up come from the PRP
  sampler (``mfcd_tpu_torch.sampling.prp``).

Every tensor carries a leading run axis ``[R, ...]``; shapes are fixed and
shortfall is a validity mask.  Only the PRP branch of ``sample_and_split``
(the ``random`` strategy) is ported; the other strategies raise
``NotImplementedError`` (ROADMAP M11-M13).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from mfcd_tpu_torch.core import prng, rng
from mfcd_tpu_torch.core.config import TRAIN_RATIO, VAL_RATIO
from mfcd_tpu_torch.sampling import prp
from mfcd_tpu_torch.sampling.dedup import TripletSet


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
                     budget=None, extra_budget=None) -> SampledSplits:
    """Sample unique triplets, split 80/10/10, and top up the test split.

    ``t_cap`` / ``extra_cap`` are buffer capacities; ``budget`` /
    ``extra_budget`` optionally carry the exact triplet targets (ints or
    ``[R]``).  Capacities are computed in Python float64
    (``btl.py:140-142``); the split sizes inside ``prp_splits`` in float32.
    The unique sample itself is not kept (``sample.triplets`` is empty),
    as the engine never needs it.
    """
    train_cap = int(TRAIN_RATIO * t_cap)
    val_cap = int(VAL_RATIO * t_cap)
    test_cap = t_cap - train_cap - val_cap

    fast = prp.uniform_domain(strategy, x, t_cap, extra_cap,
                              key=streams["sampling"])
    if fast is None:
        raise NotImplementedError(
            f"strategy={strategy!r} at n={x.shape[-2]}, m={x.shape[-1]} "
            "needs a sampler that is not ported to mfcd_tpu_torch yet "
            "(ROADMAP M11-M13)")
    dom, decode, sample_key = fast
    dev = x.device
    count = torch.as_tensor(t_cap if budget is None else budget,
                            dtype=torch.int32, device=dev)
    extra_count = ((extra_cap if extra_budget is None else extra_budget)
                   if extra_cap > 0 else 0)
    splits = prp.prp_splits(
        sample_key, rng.split_key(dev), dom, decode,
        t_cap, train_cap, val_cap, test_cap, count,
        extra_cap=extra_cap, extra_count=extra_count,
    )
    runs = lambda c: c.expand(x.shape[:-2]).to(torch.int32)
    empty = torch.zeros((x.shape[0], 0, 3), dtype=torch.int32, device=dev)
    return SampledSplits(
        sample=TripletSet(empty, runs(count)),
        train=splits.train, train_count=runs(splits.train_count),
        val=splits.val, val_count=runs(splits.val_count),
        test=splits.test, test_count=runs(splits.test_count),
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
