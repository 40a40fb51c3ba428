"""Adam with coupled weight decay — torch.optim.Adam semantics, written out.

Counterpart of ``mfcd_tpu/ops/optim.py``.  The reference uses
``torch.optim.Adam(lr, weight_decay)``: coupled L2 (``g <- g + wd * p``
before the moment updates), beta=(0.9, 0.999), eps=1e-8 applied as
``m_hat / (sqrt(v_hat) + eps)``.  The update is spelled out in the order
``optim.py:49-61`` writes it (``torch.optim.Adam`` orders its
bias-correction arithmetic differently), with per-run ``lr`` / ``wd`` /
step tensors so several runs train at once.  The update is dense: weight
decay shrinks rows untouched by the batch.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class AdamState(NamedTuple):
    mu: tuple                 # first moments, one per parameter
    nu: tuple                 # second moments
    step: torch.Tensor        # [R] int32 step counters


def adam_init(params: Sequence[torch.Tensor], runs_shape=()) -> AdamState:
    return AdamState(
        mu=tuple(torch.zeros_like(p) for p in params),
        nu=tuple(torch.zeros_like(p) for p in params),
        step=torch.zeros(runs_shape, dtype=torch.int32,
                         device=params[0].device),
    )


def _runs(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a ``[R]`` (or scalar) tensor against ``[R, ...]``."""
    v = torch.as_tensor(v, dtype=torch.float32, device=like.device)
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def adam_update(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], state: AdamState, lr,
                weight_decay, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8):
    """One torch-Adam step; returns (new_params, new_state)."""
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=t.device), t)

    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(params, grads, state.mu, state.nu):
        g = g + _runs(weight_decay, p) * p          # coupled L2
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        m_hat = m / _runs(bc1, p)
        v_hat = v / _runs(bc2, p)
        new_p.append(p - _runs(lr, p) * m_hat / (torch.sqrt(v_hat) + eps))
        new_m.append(m)
        new_v.append(v)
    return new_p, AdamState(mu=tuple(new_m), nu=tuple(new_v), step=step)
