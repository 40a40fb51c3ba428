"""Fixed-shape unique-triplet selection and masked splits.

Counterpart of ``mfcd_tpu/sampling/dedup.py``; winners, buffers and counts
are bit-equal to it.  The reference's samplers are rejection loops that
insert ``(u, i, j)`` into a set until the budget is met
(``generation_data.py:16-26``), with an exclude set for the test top-up
(``structure.py:721-730``).  Here a static overdraw of candidates is drawn
and the first occurrence of each valid triplet in draw order wins:

- ``hash`` (when ``n * m * m < 2^31``): a scatter-min of the draw order on
  a hash table of the packed triplet.  Duplicates share a slot, so at most
  one survives; distinct triplets that collide lose their slot too, a
  uniform thinning the overdraw absorbs.
- ``sort``: one stable sort groups duplicates with the earliest draw (or an
  exclude row) at the head of each run; packed into one key when it fits
  int32, else a lexicographic sort over (u, i, j).

Every tensor carries a leading run axis ``[R, ...]``; ``budget`` is an int
or an ``[R]`` tensor.  Integer words of the hash live in int64 lanes masked
to 32 bits (``core/prng.py``).  Scatter-min has no drop mode in torch, so
each table has one spare slot, at index ``h``, that takes what JAX drops.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from mfcd_tpu_torch.core.config import TRAIN_RATIO, VAL_RATIO
from mfcd_tpu_torch.core.prng import M32, mul32

# Sentinel pushing invalid rows past every real (u, i, j) in the sort.
_SENT = 2**30
_I32_MAX = 2**31 - 1


class TripletSet(NamedTuple):
    """A fixed-capacity triplet buffer with its valid-row count."""

    triplets: torch.Tensor  # [..., T, 3] int32
    count: torch.Tensor     # [...] int32

    @property
    def valid(self) -> torch.Tensor:
        t = self.triplets.shape[-2]
        return (torch.arange(t, device=self.triplets.device)
                < self.count.unsqueeze(-1))


class SplitArrays(NamedTuple):
    """80/10/10 split buffers with their valid-row counts."""

    train: torch.Tensor        # [..., T_train_cap, 3]
    train_count: torch.Tensor  # [...]
    val: torch.Tensor          # [..., T_val_cap, 3]
    val_count: torch.Tensor
    test: torch.Tensor         # [..., T_test_cap, 3]
    test_count: torch.Tensor


def _runs(v, r: int, device) -> torch.Tensor:
    """An int or ``[R]`` value as an ``[R, 1]`` int64 column."""
    v = torch.as_tensor(v, dtype=torch.int64, device=device)
    return v.expand(r).reshape(r, 1)


def scatter_rows(rows: torch.Tensor, pos: torch.Tensor,
                 total: int) -> torch.Tensor:
    """``zeros([R, total, 3]).at[pos].set(rows, mode="drop")``: ``pos``
    ``[R, M]`` is distinct wherever it is below ``total``; rows at
    ``total`` and above are dropped."""
    r = rows.shape[0]
    pos = torch.clamp(pos.to(torch.int64), max=total)
    out = torch.zeros((r, total + 1, 3), dtype=torch.int32,
                      device=rows.device)
    out.scatter_(1, pos.unsqueeze(-1).expand(-1, -1, 3), rows.to(torch.int32))
    return out[:, :total]


def select_unique(cands, valid, target: int, exclude=None, exclude_valid=None,
                  nm_shape: Optional[tuple] = None, method: str = "auto",
                  budget=None) -> TripletSet:
    """First-occurrence selection of unique valid triplets: ``cands
    [R, M, 3]`` in draw order, ``valid [R, M]``; ``target`` is the buffer
    capacity and ``budget`` (int or ``[R]``) the exact target."""
    keep = first_occurrence_winners(
        cands, valid, exclude=exclude, exclude_valid=exclude_valid,
        nm_shape=nm_shape, method=method)
    return _compact(cands, keep, target, budget=budget)


def first_occurrence_winners(cands, valid, *, exclude=None,
                             exclude_valid=None,
                             nm_shape: Optional[tuple] = None,
                             method: str = "auto") -> torch.Tensor:
    """``[R, M]`` mask of first-occurrence unique valid candidates."""
    r, m_cand = valid.shape
    dev = cands.device
    packed_ok = (nm_shape is not None and int(nm_shape[0]) * int(nm_shape[1])
                 * int(nm_shape[1]) < 2**31)
    if method == "auto":
        method = "hash" if packed_ok else "sort"
    if method == "hash" and not packed_ok:
        raise ValueError("hash dedup requires packable (n, m)")
    if method == "hash":
        return _hashed_winners(cands, valid, exclude, exclude_valid, nm_shape)

    rows = torch.where(valid.unsqueeze(-1), cands.to(torch.int64), _SENT)
    is_cand = torch.ones((r, m_cand), dtype=torch.bool, device=dev)
    if exclude is not None:
        ex = exclude.to(torch.int64)
        if exclude_valid is not None:
            ex = torch.where(exclude_valid.unsqueeze(-1), ex, _SENT)
        # Exclude rows go first, so a stable sort puts them at each run head
        # (their draw order -1 is below every candidate's).
        rows = torch.cat([ex, rows], dim=1)
        no = torch.zeros(ex.shape[:2], dtype=torch.bool, device=dev)
        is_cand = torch.cat([no, is_cand], dim=1)
        valid = torch.cat([no, valid], dim=1)

    if packed_ok:
        m = int(nm_shape[1])
        packed = (rows[..., 0] * m + rows[..., 1]) * m + rows[..., 2]
        packed = torch.where(rows[..., 0] >= _SENT, _I32_MAX, packed)
        sort_idx = torch.argsort(packed, dim=-1, stable=True)
        spacked = torch.gather(packed, 1, sort_idx)
        head = spacked[:, 1:] != spacked[:, :-1]
    else:
        # Rows are in draw order already (exclude rows first), so sorting
        # stably by j, then i, then u is jnp.lexsort((order, j, i, u)).
        sort_idx = torch.arange(rows.shape[1], device=dev).expand(
            r, -1).contiguous()
        for c in (2, 1, 0):
            key = torch.gather(rows[..., c], 1, sort_idx)
            sort_idx = torch.gather(
                sort_idx, 1, torch.argsort(key, dim=-1, stable=True))
        srows = torch.gather(rows, 1, sort_idx.unsqueeze(-1).expand(-1, -1, 3))
        head = (srows[:, 1:] != srows[:, :-1]).any(dim=-1)
    run_head = torch.cat(
        [torch.ones((r, 1), dtype=torch.bool, device=dev), head], dim=1)
    keep_sorted = (run_head & torch.gather(is_cand, 1, sort_idx)
                   & torch.gather(valid, 1, sort_idx))
    keep = torch.zeros_like(keep_sorted).scatter_(1, sort_idx, keep_sorted)
    return keep[:, -m_cand:]


def _compact(cands, keep, target: int, budget=None) -> TripletSet:
    """Scatter kept rows (in draw order) into the first slots; at most
    ``budget`` (default ``target``) of them count."""
    r = keep.shape[0]
    b = _runs(target if budget is None else budget, r, keep.device)
    pos = torch.cumsum(keep, dim=1) - 1
    count = torch.minimum(keep.sum(dim=1), b[:, 0]).to(torch.int32)
    to = torch.where(keep & (pos < b), pos, target)
    return TripletSet(scatter_rows(cands, to, target), count)


def _hash_bits(rows: int) -> int:
    return min(max((16 * rows - 1).bit_length(), 20), 24)


def _hashed_winners(cands, valid, exclude, exclude_valid,
                    nm_shape) -> torch.Tensor:
    """Exact-uniqueness winner selection via scatter-min on a hash table.

    Every triplet hashes to one slot; the scatter-min of the draw order
    makes the earliest occupant the slot's winner.  Exclude entries carry
    order -1 and veto any candidate equal to them."""
    r, m_cand = valid.shape
    dev = cands.device
    m = int(nm_shape[1])
    pack = lambda t: ((t[..., 0].to(torch.int64) * m + t[..., 1]) * m
                      + t[..., 2])
    packed = pack(cands)
    order = torch.arange(m_cand, dtype=torch.int32, device=dev).expand(r, -1)
    if exclude is not None:
        ex_valid = (exclude_valid if exclude_valid is not None else
                    torch.ones(exclude.shape[:2], dtype=torch.bool,
                               device=dev))
        packed = torch.cat([pack(exclude), packed], dim=1)
        order = torch.cat([torch.full(exclude.shape[:2], -1,
                                      dtype=torch.int32, device=dev),
                           order], dim=1)
        valid = torch.cat([ex_valid, valid], dim=1)

    bits = _hash_bits(packed.shape[1])
    h = 1 << bits
    slot = mul32(packed & M32, 2654435761) >> (32 - bits)
    slot = torch.where(valid, slot, h)           # invalid rows: spare slot
    table = torch.full((r, h + 1), _I32_MAX, dtype=torch.int32, device=dev)
    table.scatter_reduce_(1, slot, order, "amin")
    winner = (torch.gather(table, 1, slot) == order) & valid
    return winner[:, -m_cand:]


def split_triplets(sample: TripletSet, perm: torch.Tensor, train_cap: int,
                   val_cap: int, test_cap: int, train_ratio: float = 0.8,
                   val_ratio: float = 0.1) -> SplitArrays:
    """80/10/10 split of a compacted sample through a fixed permutation
    ``perm [T]`` (the reference's seed-42 ``random_split``), with the
    split sizes from the actual count."""
    count = sample.count.to(torch.int32)
    permuted = sample.triplets[:, perm.to(torch.int64)]
    perm_valid = perm.unsqueeze(0) < count.unsqueeze(-1)
    train_sz, val_sz, _ = _split_sizes(count, train_ratio, val_ratio)
    col = lambda v: v.to(torch.int64).unsqueeze(-1)
    rank = torch.cumsum(perm_valid, dim=1) - 1
    in_train = perm_valid & (rank < col(train_sz))
    in_val = perm_valid & ~in_train & (rank < col(train_sz + val_sz))
    in_test = perm_valid & (rank >= col(train_sz + val_sz))
    total = train_cap + val_cap + test_cap
    pos = torch.where(
        in_train & (rank < train_cap), rank,
        torch.where(
            in_val & (rank - col(train_sz) < val_cap),
            train_cap + rank - col(train_sz),
            torch.where(
                in_test & (rank - col(train_sz + val_sz) < test_cap),
                train_cap + val_cap + rank - col(train_sz + val_sz),
                total)))
    return _cut(scatter_rows(permuted, pos, total), train_sz, val_sz, count,
                train_cap, val_cap, test_cap)


def _split_sizes(count: torch.Tensor, train_ratio=TRAIN_RATIO,
                 val_ratio=VAL_RATIO):
    """(train, val, test) sizes from ``count``, floored in float32 as the
    JAX package does."""
    count_f = count.to(torch.float32)
    train_sz = torch.floor(train_ratio * count_f).to(torch.int32)
    val_sz = torch.floor(val_ratio * count_f).to(torch.int32)
    return train_sz, val_sz, count - train_sz - val_sz


def _cut(big, train_sz, val_sz, count, train_cap, val_cap,
         test_cap) -> SplitArrays:
    test_sz = count - train_sz - val_sz
    return SplitArrays(
        train=big[:, :train_cap],
        train_count=torch.clamp(train_sz, max=train_cap),
        val=big[:, train_cap:train_cap + val_cap],
        val_count=torch.clamp(val_sz, max=val_cap),
        test=big[:, train_cap + val_cap:],
        test_count=torch.clamp(test_sz, max=test_cap))


def winners_to_splits(cands, win, t_cap: int, train_cap: int, val_cap: int,
                      test_cap: int, key: torch.Tensor, budget=None,
                      train_ratio: float = 0.8, val_ratio: float = 0.1):
    """Fused compaction and fixed-permutation 80/10/10 split: winner rank
    ``r`` goes to split slot ``splitPRP(r)`` on [0, count).  Returns
    ``(SplitArrays, count)``, count = min(#winners, budget)."""
    r = win.shape[0]
    b = _runs(t_cap if budget is None else budget, r, win.device)
    rank = torch.cumsum(win, dim=1) - 1
    count = torch.minimum(win.sum(dim=1), b[:, 0]).to(torch.int32)
    kept = win & (rank < b)
    return ranks_to_splits(cands, kept, rank, count, t_cap, train_cap,
                           val_cap, test_cap, key=key,
                           train_ratio=train_ratio,
                           val_ratio=val_ratio), count


def ranks_to_splits(cands, kept, rank, count, t_cap: int, train_cap: int,
                    val_cap: int, test_cap: int, key: torch.Tensor,
                    train_ratio: float = 0.8,
                    val_ratio: float = 0.1) -> SplitArrays:
    """Rank-indexed core of :func:`winners_to_splits`; ``kept`` rows must
    have ``rank < count``."""
    from mfcd_tpu_torch.ops.shuffle import exact_prefix_permutation

    k_bits = max((t_cap - 1).bit_length(), 1)
    y = exact_prefix_permutation(key, rank, count, k_bits).to(torch.int64)
    train_sz, val_sz, _ = _split_sizes(count, train_ratio, val_ratio)
    col = lambda v: v.to(torch.int64).unsqueeze(-1)
    tr, va = col(train_sz), col(val_sz)
    total = train_cap + val_cap + test_cap
    in_train = kept & (y < tr) & (y < train_cap)
    in_val = kept & (y >= tr) & (y < tr + va) & (y - tr < val_cap)
    in_test = kept & (y >= tr + va) & (y - tr - va < test_cap)
    pos = torch.where(
        in_train, y,
        torch.where(in_val, train_cap + (y - tr),
                    torch.where(in_test, train_cap + val_cap + (y - tr - va),
                                total)))
    return _cut(scatter_rows(cands, pos, total), train_sz, val_sz,
                count.to(torch.int32), train_cap, val_cap, test_cap)


def overdraw_size(target: int, population: float, p_valid: float = 1.0,
                  safety: float = 1.3, slack: int = 512,
                  cap: Optional[int] = None) -> int:
    """Static overdraw M so that ~target unique valid draws survive."""
    n_eff = max(float(population), 1.0)
    frac = min(float(target) / n_eff, 0.999)
    m_unique = -n_eff * math.log1p(-frac)
    m = int(math.ceil(m_unique / max(p_valid, 1e-6) * safety)) + slack
    m = max(m, target)
    if cap is not None:
        m = min(m, max(cap, 1))
    return m
