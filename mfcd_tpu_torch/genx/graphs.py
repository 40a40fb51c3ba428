"""Watts–Strogatz social-graph generators, over a leading run axis.

Counterpart of ``mfcd_tpu/genx/graphs.py``.  The reference builds
``networkx.watts_strogatz_graph(n, k=5, p=0.1)`` and applies an in-place,
sequential friend-mean smoothing of user embeddings
(``generation_data.py:539-619``).  Here the small-world graph is a boolean
adjacency built by masked ring rewiring, and the smoothing is a single
vectorized (Jacobi) step ``U <- (1-w) U + w * (A @ U) / deg``.

Documented divergences from the reference (statistical, not behavioral):
- the reference's per-node loop is Gauss–Seidel (node u sees already-smoothed
  friends f < u); the vectorized step uses the pre-update embeddings,
- rewired edges may collide with existing ones and collapse in the boolean
  adjacency, slightly lowering average degree (networkx redraws instead).

The adjacency is bit-equal to the JAX package's: the rewiring draw
compares a float32 uniform with float32 ``p``, as ``jax.random.bernoulli``
does.
"""

from __future__ import annotations

import torch

from mfcd_tpu_torch.core import prng


def watts_strogatz_adjacency(key: torch.Tensor, n: int, k: int = 5,
                             p: float = 0.1) -> torch.Tensor:
    """Boolean ``[..., n, n]`` adjacency of a Watts–Strogatz small-world
    graph per key ``[..., 2]``.

    Each node connects to ``k // 2`` ring neighbors on each side, and each
    ring edge (u, u+off) is rewired to a uniform non-self target with
    probability ``p``."""
    lead = key.shape[:-1]
    dev = key.device
    keys = key.reshape(-1, 2)
    b = keys.shape[0]
    adj = torch.zeros((b, n, n), dtype=torch.bool, device=dev)
    nodes = torch.arange(n, device=dev)
    runs = torch.arange(b, device=dev).unsqueeze(-1)
    p32 = torch.tensor(p, dtype=torch.float32, device=dev)
    for off in range(1, k // 2 + 1):
        kb, kt = prng.split(prng.fold_in(keys, off)).unbind(-2)
        rewire = prng.bernoulli(kb, p32, (n,))
        ring_tgt = (nodes + off) % n
        # Uniform non-self target: draw in [0, n-1) and skip past self.
        raw = prng.randint(kt, (n,), 0, n - 1).to(torch.int64)
        rand_tgt = torch.where(raw >= nodes, raw + 1, raw)
        tgt = torch.where(rewire, rand_tgt, ring_tgt)
        adj[runs, nodes, tgt] = True
        adj[runs, tgt, nodes] = True
    return adj.reshape(lead + (n, n))


def _social_smooth(u: torch.Tensor, adj: torch.Tensor,
                   influence: float) -> torch.Tensor:
    """One smoothing step toward friend means; isolated nodes unchanged
    (reference's ``if friends:`` guard, ``generation_data.py:571-574``)."""
    a = adj.to(u.dtype)
    deg = torch.sum(a, dim=-1, keepdim=True)
    friend_mean = (a @ u) / torch.clamp(deg, min=1.0)
    smoothed = (1.0 - influence) * u + influence * friend_mean
    return torch.where(deg > 0, smoothed, u)


def generate_graph(key: torch.Tensor, n: int, m: int, d: int,
                   social_influence: float = 0.3, noise: float = 0.1):
    """``generation="graph"``: 2-dim base signal smoothed over a
    Watts–Strogatz user graph, noise-padded to d dims (zero-width pads at
    d <= 2); V scaled by 1/sqrt(d)."""
    d_eff = min(d, 2)
    k1, k2, k3, k4, k5 = prng.split(key, 5).unbind(-2)
    u_low = prng.normal(k1, (n, d_eff))
    v_low = prng.normal(k2, (m, d_eff))
    adj = watts_strogatz_adjacency(k3, n, k=5, p=0.1)
    u_low = _social_smooth(u_low, adj, social_influence)
    u = torch.cat([u_low, noise * prng.normal(k4, (n, d - d_eff))], dim=-1)
    v = torch.cat([v_low, noise * prng.normal(k5, (m, d - d_eff))], dim=-1)
    return u, v / torch.sqrt(torch.tensor(d, dtype=torch.float32,
                                          device=key.device))


def generate_social(key: torch.Tensor, n: int, m: int, d: int,
                    social_influence: float = 0.5):
    """``generation="social"``: full-d embeddings smoothed over a
    Watts–Strogatz graph; U scaled by 1/log(d+1)."""
    k1, k2, k3 = prng.split(key, 3).unbind(-2)
    u = prng.normal(k1, (n, d))
    v = prng.normal(k2, (m, d))
    adj = watts_strogatz_adjacency(k3, n, k=5, p=0.1)
    u = _social_smooth(u, adj, social_influence)
    return u / torch.log(torch.tensor(d + 1, dtype=torch.float32,
                                      device=key.device)), v
