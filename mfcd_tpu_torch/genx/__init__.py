"""Ground-truth matrix generation — ``generate_x`` dispatch.

Counterpart of ``mfcd_tpu/genx/__init__.py``.  Only ``"base"`` is ported;
the other ten modes raise ``NotImplementedError`` (ROADMAP M14).
"""

from __future__ import annotations

import torch

from mfcd_tpu_torch.genx.generators import generate_base, haar_frame  # noqa: F401

GENERATION_MODES = (
    "base", "low_rank", "clustered", "structured", "svd", "correlated",
    "graph", "social", "temporal", "hierarchical", "gmm",
)


def generate_x(key: torch.Tensor, n: int, m: int, d: int,
               generation: str = "base") -> torch.Tensor:
    """Generate the (n, m) ground-truth preference matrix X* per key."""
    if generation == "base":
        return generate_base(key, n, m, d)
    if generation in GENERATION_MODES:
        raise NotImplementedError(
            f"generation={generation!r} is not ported to mfcd_tpu_torch yet "
            "(ROADMAP M14)")
    raise ValueError(f"Unknown generation method: {generation}")
