"""Randomized low-rank linear algebra.

Counterpart of ``mfcd_tpu/ops/linalg.py``: randomized subspace iteration
(Halko et al. 2011) with a keyed Gaussian probe, thin QRs and one small
SVD.  Broadcasts over leading dimensions.  QR and SVD signs may differ
from the JAX package's per column; row norms of the factors do not.
"""

from __future__ import annotations

import torch

from mfcd_tpu_torch.core import prng


def randomized_svd(x: torch.Tensor, q: int, key: torch.Tensor,
                   iters: int = 4):
    """Approximate leading-q SVD of ``x [..., n, m]``: ``(U [..., n, q],
    s [..., q], Vt [..., q, m])``."""
    y = x @ prng.normal(key, (x.shape[-1], q)).to(x.dtype)
    xt = x.transpose(-1, -2)
    for _ in range(iters):
        y = torch.linalg.qr(y).Q
        y = x @ (xt @ y)
    qmat = torch.linalg.qr(y).Q
    u_b, s, vt = torch.linalg.svd(qmat.transpose(-1, -2) @ x,
                                  full_matrices=False)
    return qmat @ u_b, s, vt


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
