"""KMeans and GMM over a leading run axis, and the generators using them.

Counterpart of ``mfcd_tpu/genx/clusters.py``: fixed-iteration Lloyd and EM
loops in place of the reference's sklearn ``KMeans``
(``generation_data.py:415,235``) and ``GaussianMixture``
(``generation_data.py:705-709``).  The loops have fixed counts and never
read a value back to the host, so a run stays on the card.

Assignments agree with the JAX package's except for a point whose two
nearest centres (or most likely components) lie within float32 rounding
of each other.
"""

from __future__ import annotations

import math

import torch

from mfcd_tpu_torch.core import prng
from mfcd_tpu_torch.genx.generators import generate_base, take_rows


def _take_row(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points[r, idx[r]]`` for ``points [R, N, D]`` and ``idx [R]``."""
    return take_rows(points, idx.unsqueeze(-1)).squeeze(-2)


def kmeans_plusplus_init(key: torch.Tensor, points: torch.Tensor,
                         k: int) -> torch.Tensor:
    """k-means++ seeding for ``points [R, N, D]`` -> centres ``[R, k, D]``:
    the first centre uniform, then each with probability proportional to
    the squared distance to the nearest chosen centre."""
    npts = points.shape[1]
    k0, kseq = prng.split(key).unbind(-2)
    first = prng.randint(k0, (), 0, npts)
    c = _take_row(points, first)
    centers = [c]
    d2 = torch.sum((points - c[:, None]) ** 2, dim=-1)
    for i in range(1, k):
        logits = torch.log(torch.clamp(d2, min=1e-30))
        c = _take_row(points, prng.categorical(prng.fold_in(kseq, i), logits))
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


def gmm_log_prob(points: torch.Tensor, weights: torch.Tensor,
                 means: torch.Tensor, covs: torch.Tensor) -> torch.Tensor:
    """Per-component log-likelihood plus log-weight, ``[R, N, k]``, of
    ``points [R, N, D]`` under ``weights [R, k]``, ``means [R, k, D]`` and
    ``covs [R, k, D, D]``.

    A covariance whose Cholesky factorisation fails gets a factor of NaN,
    as ``jnp.linalg.cholesky`` returns, with no host sync to check."""
    d = points.shape[-1]
    chol, info = torch.linalg.cholesky_ex(covs)                # [R, k, D, D]
    chol = torch.where((info == 0)[..., None, None], chol,
                       torch.full_like(chol, math.nan))
    diff = points.unsqueeze(-3) - means.unsqueeze(-2)          # [R, k, N, D]
    sol = torch.linalg.solve_triangular(chol, diff.transpose(-1, -2),
                                        upper=False)            # [R, k, D, N]
    maha = torch.sum(sol ** 2, dim=-2)                         # [R, k, N]
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)  # [R, k]
    log2pi = torch.log(torch.tensor(2.0 * math.pi, dtype=points.dtype,
                                    device=points.device))
    logp = (-0.5 * (maha + d * log2pi + logdet.unsqueeze(-1))
            + torch.log(weights + 1e-30).unsqueeze(-1))
    return logp.transpose(-1, -2)


def gmm_fit_predict(key: torch.Tensor, points: torch.Tensor, k: int,
                    iters: int = 20):
    """Full-covariance Gaussian mixture EM (KMeans init, seeded with the
    same key) over ``points [R, N, D]``: ``(labels [R, N] int64, means
    [R, k, D])``, the two things the reference consumes from sklearn's
    ``GaussianMixture`` (``generation_data.py:708-713``)."""
    n, d = points.shape[-2:]
    labels0, _ = kmeans(key, points, k)
    eye = torch.eye(d, dtype=points.dtype, device=points.device)

    def m_step(resp):                                           # [R, N, k]
        nk = torch.sum(resp, dim=-2) + 1e-10                    # [R, k]
        resp_t = resp.transpose(-1, -2)                         # [R, k, N]
        means = (resp_t @ points) / nk.unsqueeze(-1)            # [R, k, D]
        diff = points.unsqueeze(-3) - means.unsqueeze(-2)       # [R, k, N, D]
        covs = torch.einsum("...kn,...knd,...kne->...kde", resp_t, diff,
                            diff)
        covs = covs / nk[..., None, None] + 1e-6 * eye
        return nk / n, means, covs

    params = m_step(torch.nn.functional.one_hot(labels0, k).to(points.dtype))
    for _ in range(iters):
        params = m_step(torch.softmax(gmm_log_prob(points, *params), dim=-1))
    return torch.argmax(gmm_log_prob(points, *params), dim=-1), params[1]


def _over_runs(fn, key: torch.Tensor, *args):
    """``fn`` on keys flattened to ``[R, 2]``, its outputs' leading run
    axis restored to the key's leading dims."""
    out = fn(key.reshape(-1, 2), *args)
    lead = key.shape[:-1]
    restore = lambda a: a.reshape(lead + a.shape[1:])
    return (tuple(restore(a) for a in out) if isinstance(out, tuple)
            else restore(out))


def _clustered(key: torch.Tensor, n: int, m: int, d: int, n_clusters: int,
               scale: float, shift_strength: float) -> torch.Tensor:
    kx, kc = prng.split(key).unbind(-2)
    x = generate_base(kx, n, m, d)
    labels, _ = kmeans(kc, x.transpose(-1, -2), n_clusters)  # items [R, m, n]
    onehot = torch.nn.functional.one_hot(labels, n_clusters).to(x.dtype)
    counts = torch.sum(onehot, dim=-2)                           # [R, k]
    cluster_mean_cols = (x @ onehot) / torch.clamp(
        counts, min=1.0).unsqueeze(-2)                           # [R, n, k]
    shifted = (1.0 - shift_strength) * x + shift_strength * (
        cluster_mean_cols @ onehot.transpose(-1, -2))
    return shifted * scale


def generate_clustered(key: torch.Tensor, n: int, m: int, d: int,
                       n_clusters: int = 5, scale: float = 1.0,
                       shift_strength: float = 0.5) -> torch.Tensor:
    """``generation="clustered"`` (reference ``generation_data.py:394-434``):
    base X, KMeans on item columns, each item column soft-shifted toward its
    cluster's mean column by ``shift_strength``."""
    return _over_runs(_clustered, key, n, m, d, n_clusters, scale,
                      shift_strength)


def _gmm(key: torch.Tensor, n: int, m: int, d: int, num_clusters: int):
    k1, k2, k3, k4 = prng.split(key, 4).unbind(-2)
    user_pts = prng.normal(k1, (n, d))
    item_pts = prng.normal(k2, (m, d))
    user_labels, _ = gmm_fit_predict(k3, user_pts, num_clusters)
    item_labels, item_means = gmm_fit_predict(k4, item_pts, num_clusters)
    return (take_rows(item_means, user_labels),
            take_rows(item_means, item_labels))


def generate_gmm(key: torch.Tensor, n: int, m: int, d: int,
                 num_clusters: int = 5):
    """``generation="gmm"`` (reference ``generation_data.py:686-715``).

    Reference quirk kept: the same GMM object is re-fit on item points
    after predicting user labels, so *both* U and V use the item-fit means
    — user embeddings pair user-fit labels with item-fit means
    (``generation_data.py:705-713``)."""
    return _over_runs(_gmm, key, n, m, d, num_clusters)
