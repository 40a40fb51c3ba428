"""KMeans with k-means++ seeding, over a leading run axis.

Counterpart of ``kmeans_plusplus_init`` and ``kmeans`` in
``mfcd_tpu/genx/clusters.py``: fixed-iteration Lloyd steps in place of the
reference's sklearn ``KMeans`` (``generation_data.py:235``).  The cluster
sampler needs them; ``gmm_fit_predict`` and the clustered / gmm generators
are not ported yet (ROADMAP M14).

Assignments agree with the JAX package's except for a point whose two
nearest centres lie within float32 rounding of each other.
"""

from __future__ import annotations

import torch

from mfcd_tpu_torch.core import prng


def _take_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points[r, idx[r]]`` for ``points [R, N, D]`` and ``idx [R]``."""
    return torch.gather(points, 1, idx.to(torch.int64).view(-1, 1, 1).expand(
        -1, 1, points.shape[-1]))[:, 0]


def kmeans_plusplus_init(key: torch.Tensor, points: torch.Tensor,
                         k: int) -> torch.Tensor:
    """k-means++ seeding for ``points [R, N, D]`` -> centres ``[R, k, D]``:
    the first centre uniform, then each with probability proportional to
    the squared distance to the nearest chosen centre."""
    npts = points.shape[1]
    k0, kseq = prng.split(key).unbind(-2)
    first = prng.randint(k0, (), 0, npts)
    c = _take_rows(points, first)
    centers = [c]
    d2 = torch.sum((points - c[:, None]) ** 2, dim=-1)
    for i in range(1, k):
        logits = torch.log(torch.clamp(d2, min=1e-30))
        c = _take_rows(points, prng.categorical(prng.fold_in(kseq, i), logits))
        centers.append(c)
        d2 = torch.minimum(d2, torch.sum((points - c[:, None]) ** 2, dim=-1))
    return torch.stack(centers, dim=1)


def kmeans(key: torch.Tensor, points: torch.Tensor, k: int,
           iters: int = 25):
    """Lloyd's algorithm with k-means++ init: ``(labels [R, N] int64,
    centres [R, k, D])``.  Empty clusters keep their previous centre."""
    centers = kmeans_plusplus_init(key, points, k)
    x2 = torch.sum(points ** 2, dim=-1, keepdim=True)

    def assign(centers):
        c2 = torch.sum(centers ** 2, dim=-1).unsqueeze(-2)
        d2 = x2 - 2.0 * points @ centers.transpose(-1, -2) + c2
        return torch.argmin(d2, dim=-1)

    for _ in range(iters):
        onehot = torch.nn.functional.one_hot(assign(centers), k).to(
            points.dtype)                                    # [R, N, k]
        counts = onehot.sum(dim=1)                           # [R, k]
        sums = onehot.transpose(-1, -2) @ points             # [R, k, D]
        new = sums / torch.clamp(counts, min=1.0).unsqueeze(-1)
        centers = torch.where(counts.unsqueeze(-1) > 0, new, centers)
    return assign(centers), centers
