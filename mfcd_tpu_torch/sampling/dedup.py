"""Triplet-set containers.

Counterpart of the types in ``mfcd_tpu/sampling/dedup.py``
(``TripletSet``, ``SplitArrays``).  The overdraw/dedup samplers of that
module are not ported yet (ROADMAP M12); the PRP sampler
(``mfcd_tpu_torch.sampling.prp``) fills these containers directly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TripletSet(NamedTuple):
    """A fixed-capacity triplet buffer with its valid-row count."""

    triplets: torch.Tensor  # [..., T, 3] int32
    count: torch.Tensor     # [...] int32


class SplitArrays(NamedTuple):
    """80/10/10 split buffers with their valid-row counts."""

    train: torch.Tensor        # [..., T_train_cap, 3]
    train_count: torch.Tensor  # [...]
    val: torch.Tensor          # [..., T_val_cap, 3]
    val_count: torch.Tensor
    test: torch.Tensor         # [..., T_test_cap, 3]
    test_count: torch.Tensor
