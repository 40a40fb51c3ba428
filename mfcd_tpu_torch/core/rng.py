"""RNG discipline — the named key tree of every run.

Counterpart of ``mfcd_tpu/core/rng.py``.  Every random choice flows from an
explicit threefry key (``mfcd_tpu_torch.core.prng``, bit-equal to
``jax.random``)::

    base key --fold(config idx)--> config key --fold(rep)--> rep key
    rep key --split--> {x_gen, sampling, labels(train/val/test/extra),
                        init, epochs, sample_rows}

Keys are int64 tensors ``[..., 2]``; a leading run axis carries one key per
repetition.  The split permutation uses its own constant-seed key,
mirroring the reference's deterministic seed-42 split.
"""

from __future__ import annotations

import numpy as np
import torch

from mfcd_tpu_torch.core import prng

# Deterministic split seed (reference ``structure.py:712``).
SPLIT_SEED = 42


def split_key(device=None) -> torch.Tensor:
    return prng.key(SPLIT_SEED, device=device)


def split_permutation(t: int) -> np.ndarray:
    """Deterministic seed-42 permutation of [0, t), computed on the host."""
    return np.random.default_rng(SPLIT_SEED).permutation(t).astype(np.int32)


# Named streams drawn from one rep key.  Order is part of the protocol:
# changing it changes every downstream draw.
STREAMS = (
    "x_gen",          # ground-truth matrix generation
    "sampling",       # triplet sampler proposals
    "extra_sampling", # test-set top-up sampler
    "labels_train",
    "labels_val",
    "labels_test",
    "init",           # model parameter init
    "epochs",         # per-epoch shuffles (folded further by epoch index)
    "sample_rows",    # the 2 inspection rows (reference structure.py:388-392)
)


def rep_streams(rep_key: torch.Tensor) -> dict:
    """``[..., 2]`` rep keys -> {stream name: ``[..., 2]`` keys}."""
    keys = prng.split(rep_key, len(STREAMS))
    return {name: keys[..., s, :] for s, name in enumerate(STREAMS)}


def config_key(base_key: torch.Tensor, config_index: int) -> torch.Tensor:
    return prng.fold_in(base_key, config_index)


def rep_key(cfg_key: torch.Tensor, rep: int) -> torch.Tensor:
    return prng.fold_in(cfg_key, rep)


def rep_keys(cfg_key: torch.Tensor, reps: int) -> torch.Tensor:
    """``[..., 2]`` config keys -> ``[..., reps, 2]`` rep keys."""
    idx = torch.arange(reps, dtype=torch.int64, device=cfg_key.device)
    return prng.fold_in(cfg_key[..., None, :], idx)
