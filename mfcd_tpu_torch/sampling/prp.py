"""Direct sampling-without-replacement via keyed permutation prefixes.

Counterpart of the random-strategy part of ``mfcd_tpu/sampling/prp.py``;
buffers and counts are bit-equal to it.  The reference's ``random`` sampler
is a rejection loop over ``[n] x {(i, j) : i != j}`` that stops at
``num_triplets`` — a uniformly random T-subset in uniform order.  The first
T values of a keyed pseudorandom permutation of the domain give that
directly: no overdraw, no dedup, ``count == target`` by construction, and
the test top-up continues the same permutation past ``t_cap`` (disjoint
from the main block by bijectivity).

The proximity / top_k / svd / margin fast paths are not ported yet
(ROADMAP M11).
"""

from __future__ import annotations

import torch

from mfcd_tpu_torch.core.config import TRAIN_RATIO, VAL_RATIO
from mfcd_tpu_torch.ops.shuffle import (exact_prefix_permutation,
                                        exact_prefix_permutation_inverse)
from mfcd_tpu_torch.sampling.dedup import SplitArrays


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


def fast_path_kind(strategy: str, n: int, m: int, t_cap: int,
                   extra_cap: int = 0):
    """'prefix' when ``sample_and_split`` takes the PRP map (random only in
    this port), else None."""
    if strategy == "random" and prp_supported(n, m, t_cap, extra_cap):
        return "prefix"
    return None


def uniform_domain(strategy: str, x: torch.Tensor, *blocks: int,
                   key: torch.Tensor | None = None):
    """``(dom, decode, key)`` for a PRP-eligible strategy, else ``None``.

    Only the random branch is ported; the other strategies return ``None``
    and the caller raises (ROADMAP M11)."""
    n, m = x.shape[-2:]
    if strategy == "random" and prp_supported(n, m, *blocks):
        return (prp_domain_size(n, m),
                lambda idx: decode_random(idx, n, m), key)
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
    count = torch.as_tensor(count, dtype=torch.int32, device=dev)
    extra_count = torch.as_tensor(extra_count, dtype=torch.int32, device=dev)
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
