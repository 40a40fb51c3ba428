"""Ground-truth matrix generation — ``generate_x`` dispatch.

Counterpart of ``mfcd_tpu/genx/__init__.py`` (reference
``structure.py:590-663``): a function of a threefry key dispatching over
the 11 generation keywords.  Pair-returning modes are combined as
``U @ V.T`` exactly as the reference does (``structure.py:618-655``).
Keys ``[..., 2]`` give ``[..., n, m]``.
"""

from __future__ import annotations

import torch

from mfcd_tpu_torch.genx.clusters import (  # noqa: F401
    generate_clustered,
    generate_gmm,
    gmm_fit_predict,
    kmeans,
)
from mfcd_tpu_torch.genx.generators import (  # noqa: F401
    generate_base,
    generate_correlated,
    generate_hierarchical,
    generate_low_rank,
    generate_structured,
    generate_svd,
    generate_temporal,
    haar_frame,
)
from mfcd_tpu_torch.genx.graphs import (  # noqa: F401
    generate_graph,
    generate_social,
    watts_strogatz_adjacency,
)

GENERATION_MODES = (
    "base", "low_rank", "clustered", "structured", "svd", "correlated",
    "graph", "social", "temporal", "hierarchical", "gmm",
)

# Modes returning X directly vs (U, V) pairs (reference structure.py:609-659).
_DIRECT = {"base", "low_rank", "clustered"}

_PAIR_FNS = {
    "structured": generate_structured,
    "svd": generate_svd,
    "correlated": generate_correlated,
    "graph": generate_graph,
    "social": generate_social,
    "temporal": generate_temporal,
    "hierarchical": generate_hierarchical,
    "gmm": generate_gmm,
}


def generate_x(key: torch.Tensor, n: int, m: int, d: int,
               generation: str = "base", **kwargs) -> torch.Tensor:
    """Generate the (n, m) ground-truth preference matrix X* per key.

    ``kwargs`` reach the pair generators, and ``rank`` reaches
    ``low_rank``, as in the JAX package."""
    if generation == "base":
        return generate_base(key, n, m, d)
    if generation == "low_rank":
        return generate_low_rank(key, n, m, d, rank=kwargs.get("rank", d))
    if generation == "clustered":
        return generate_clustered(key, n, m, d)
    if generation in _PAIR_FNS:
        u, v = _PAIR_FNS[generation](key, n, m, d, **kwargs)
        return u @ v.transpose(-1, -2)
    raise ValueError(f"Unknown generation method: {generation}")
