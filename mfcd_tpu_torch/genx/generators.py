"""Ground-truth matrix generators (simple families).

Counterpart of ``mfcd_tpu/genx/generators.py``.  Each is a function of a
threefry key (``mfcd_tpu_torch.core.prng``) that broadcasts over leading
key dimensions: a key ``[R, 2]`` yields ``[R, n, m]`` (or a ``[R, n, d]``,
``[R, m, d]`` pair).  ``jax.random.split(key, k)`` is
``prng.split(key, k).unbind(-2)``; Haar frames are QR of a Gaussian with
the R-diagonal sign fix, as in the JAX package.
"""

from __future__ import annotations

import torch

from mfcd_tpu_torch.core import prng


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[..., idx, :]`` per leading index: ``table [..., k, D]`` and
    ``idx [..., N]`` -> ``[..., N, D]``."""
    idx = idx.to(torch.int64).unsqueeze(-1).expand(*idx.shape,
                                                     table.shape[-1])
    return torch.gather(table, -2, idx)


def haar_frame(key: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """Random n x d orthonormal frame, Haar-distributed.

    QR of an i.i.d. Gaussian with the R-diagonal sign fix gives the first d
    columns of a Haar orthogonal matrix."""
    g = prng.normal(key, (n, d))
    q, r = torch.linalg.qr(g)
    sign = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
    return q * sign.unsqueeze(-2)


def generate_base(key: torch.Tensor, n: int, m: int, d: int) -> torch.Tensor:
    """``generation="base"``: X = U S V^T with Haar frames, singular values
    1/sqrt(d), scaled by sqrt(n*m)/2 (reference
    ``generation_data.py:346-370``)."""
    ku, kv = prng.split(key).unbind(-2)
    u = haar_frame(ku, n, d)
    v = haar_frame(kv, m, d)
    f32 = lambda x: _f32(x, key.device)
    scale = torch.sqrt(f32(n * m)) / 2.0 / torch.sqrt(f32(d))
    return (u @ v.transpose(-1, -2)) * scale


def generate_low_rank(key: torch.Tensor, n: int, m: int, d: int,
                      rank=None) -> torch.Tensor:
    """``generation="low_rank"``: X = U diag(S) V^T with orthonormal
    n x d / m x d factors and S = [1]*rank + [0]*(d-rank)."""
    if rank is None:
        rank = d
    ku, kv = prng.split(key).unbind(-2)
    u = haar_frame(ku, n, d)
    v = haar_frame(kv, m, d)
    s = (torch.arange(d, device=key.device) < rank).to(torch.float32)
    return (u * s) @ v.transpose(-1, -2)


def generate_structured(key: torch.Tensor, n: int, m: int, d: int,
                        num_clusters: int = 5, cluster_std: float = 0.1):
    """``generation="structured"``: item clusters with Gaussian jitter;
    users = affinity @ centers."""
    k1, k2, k3, k4 = prng.split(key, 4).unbind(-2)
    centers = prng.normal(k1, (num_clusters, d))
    assign = prng.randint(k2, (m,), 0, num_clusters)
    v = take_rows(centers, assign) + cluster_std * prng.normal(k3, (m, d))
    affinity = prng.normal(k4, (n, num_clusters))
    return affinity @ centers, v


def svd_modes(key: torch.Tensor, n: int, m: int, d: int):
    """The SVD behind ``generate_svd(key, ...)``: the random scores' top-d
    left singular vectors ``[..., n, d]``, all singular values and the
    top-d right singular vectors ``[..., m, d]``, in float32.

    On the card the decomposition runs in float64: on an H100, cuSOLVER's
    float32 drivers leave the top singular vectors of the canonical
    1000 x 1000 scores tens (gesvd) to hundreds (gesvdj, torch's default)
    of eps * s_1 / gap from the exact ones, where the CPU's float32 LAPACK
    stays within a few (``chip_profile.py``, ``svd_solvers``); in float64
    the factors are exact to float32 rounding."""
    scores = prng.normal(prng.split(key, 3)[..., 0, :], (n, m))
    a = scores.to(torch.float64) if scores.is_cuda else scores
    u_full, s, vt = torch.linalg.svd(a, full_matrices=False)
    f32 = lambda t: t.to(torch.float32)
    return (f32(u_full[..., :d]), f32(s),
            f32(vt[..., :d, :].transpose(-1, -2)))


def generate_svd(key: torch.Tensor, n: int, m: int, d: int,
                 noise_level: float = 0.1):
    """``generation="svd"``: SVD of a random matrix, keep the top-d modes
    scaled by sqrt(S), add noise.  Only the joint sign of each mode is
    fixed, so X depends on the sign the solver picks (no convention is
    imposed, as in the JAX package)."""
    _, k2, k3 = prng.split(key, 3).unbind(-2)
    u_top, s, v_top = svd_modes(key, n, m, d)
    sq = torch.sqrt(s[..., :d]).unsqueeze(-2)
    u = u_top * sq
    v = v_top * sq
    u = u + noise_level * prng.normal(k2, (n, d))
    v = v + noise_level * prng.normal(k3, (m, d))
    return u, v


def generate_correlated(key: torch.Tensor, n: int, m: int, d: int,
                        correlation_factor: float = 0.8):
    """``generation="correlated"``: multiply i.i.d. embeddings by
    (1-c) I + c 11^T, then divide by d."""
    k1, k2 = prng.split(key).unbind(-2)
    u = prng.normal(k1, (n, d))
    v = prng.normal(k2, (m, d))
    dev = key.device
    corr = (torch.eye(d, dtype=torch.float32, device=dev)
            * (1.0 - correlation_factor)
            + correlation_factor * torch.ones((d, d), dtype=torch.float32,
                                              device=dev))
    return (u @ corr) / d, (v @ corr) / d


def generate_temporal(key: torch.Tensor, n: int, m: int, d: int,
                      timesteps: int = 5):
    """``generation="temporal"``: base + timesteps * (0.02 * N(0,1))
    drift; V scaled by 1/sqrt(d)."""
    k1, k2, k3, k4 = prng.split(key, 4).unbind(-2)
    u = prng.normal(k1, (n, d))
    v = prng.normal(k2, (m, d))
    u = u + timesteps * 0.02 * prng.normal(k3, (n, d))
    v = v + timesteps * 0.02 * prng.normal(k4, (m, d))
    return u, v / torch.sqrt(_f32(d, key.device))


def generate_hierarchical(key: torch.Tensor, n: int, m: int, d: int,
                          num_groups: int = 5):
    """``generation="hierarchical"``: group centers plus 10x individual
    noise (the group signal is mostly drowned, a reference quirk kept);
    V scaled by 1/log(d+1)."""
    k1, k2, k3, k4 = prng.split(key, 4).unbind(-2)
    groups = prng.normal(k1, (num_groups, d))
    assign = prng.randint(k2, (n,), 0, num_groups)
    u = take_rows(groups, assign) + 10.0 * prng.normal(k3, (n, d))
    v = prng.normal(k4, (m, d))
    return u, v / torch.log(_f32(d + 1, key.device))
