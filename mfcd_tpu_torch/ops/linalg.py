"""Randomized low-rank linear algebra.

Counterpart of ``mfcd_tpu/ops/linalg.py`` (``top_singular_values``):
randomized subspace iteration (Halko et al. 2011) with a keyed Gaussian
probe, thin QRs and one small SVD.  Broadcasts over leading dimensions.
"""

from __future__ import annotations

import torch

from mfcd_tpu_torch.core import prng


def top_singular_values(x: torch.Tensor, q: int, key: torch.Tensor,
                        iters: int = 4) -> torch.Tensor:
    """Top-q singular values of ``x [..., n, m]`` -> ``[..., q]``."""
    y = x @ prng.normal(key, (x.shape[-1], q)).to(x.dtype)
    xt = x.transpose(-1, -2)
    for _ in range(iters):
        y = torch.linalg.qr(y).Q
        y = x @ (xt @ y)
    qmat = torch.linalg.qr(y).Q
    return torch.linalg.svdvals(qmat.transpose(-1, -2) @ x)
