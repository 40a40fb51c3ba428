"""Optional preference label models (reference ``generation_data.py:717-742``).

Counterpart of ``mfcd_tpu/data/preferences.py``.  The reference defines
three never-used preference functions alongside the BTL Bernoulli labeler;
they are provided here as vectorized label models so datasets can be built
under alternative decision rules.

Each takes factor tensors U (n x d), V (m x d) and triplet index tensors,
on one device, and returns {0,1} int32 labels.
"""

from __future__ import annotations

import torch


def _score(u_mat, v_mat, u, i, j):
    u, i, j = (t.to(torch.int64) for t in (u, i, j))
    return torch.sum(u_mat[u] * (v_mat[i] - v_mat[j]), dim=-1)


def sigmoid_preference(u_mat, v_mat, u, i, j, scale: float = 1.0):
    """1 iff sigmoid(scale * U[u].(V[i]-V[j])) > 0.5
    (reference ``generation_data.py:723-727``)."""
    score = _score(u_mat, v_mat, u, i, j)
    return (torch.sigmoid(scale * score) > 0.5).to(torch.int32)


def softmax_preference(u_mat, v_mat, u, i, j, temp: float = 1.0):
    """1 iff softmax over all items puts more mass on i than j for user u
    (reference ``generation_data.py:729-735``)."""
    u, i, j = (t.to(torch.int64) for t in (u, i, j))
    scores = (v_mat @ u_mat[u].T).T / temp       # [B, m]
    probs = torch.softmax(scores, dim=-1)
    b = torch.arange(u.shape[0], device=u.device)
    return (probs[b, i] > probs[b, j]).to(torch.int32)


def max_preference(u_mat, v_mat, u, i, j):
    """1 iff U[u].(V[i]-V[j]) > 0 (reference ``generation_data.py:737-742``)."""
    return (_score(u_mat, v_mat, u, i, j) > 0).to(torch.int32)
