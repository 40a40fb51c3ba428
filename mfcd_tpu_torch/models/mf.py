"""The matrix-factorization BTL model.

Counterpart of ``mfcd_tpu/models/mf.py``: two embedding tables U (n x d)
and V (m x d), initialised N(0, 1)/sqrt(d), predicting
``sigmoid(sum_d U[u] * (V[i] - V[j]))`` (reference ``structure.py:746-795``).
Tables carry a leading run axis ``[R, n, d]`` where several runs train at
once; the plain functions take ``MFParams`` and the ``nn.Module`` wraps the
same tables for autograd.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from mfcd_tpu_torch.core import prng


class MFParams(NamedTuple):
    U: torch.Tensor  # [..., n, d] user embeddings
    V: torch.Tensor  # [..., m, d] item embeddings


def init_params(key: torch.Tensor, n: int, m: int, d: int) -> MFParams:
    """N(0, 1)/sqrt(d) init (reference ``structure.py:770-771``)."""
    ku, kv = prng.split(key).unbind(-2)
    # float32 1 / sqrt(d), worked out on the host: no copy to the card
    inv_sqrt_d = float(1.0 / torch.sqrt(torch.tensor(d,
                                                     dtype=torch.float32)))
    return MFParams(U=prng.normal(ku, (n, d)) * inv_sqrt_d,
                    V=prng.normal(kv, (m, d)) * inv_sqrt_d)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[..., idx, :]`` per leading index: ``[*L, n, d]`` with
    ``idx [*L, *S]`` -> ``[*L, *S, d]``."""
    lead = table.shape[:-2]
    flat = idx.reshape(*lead, -1).to(torch.int64)
    d = table.shape[-1]
    out = torch.gather(table, -2, flat.unsqueeze(-1).expand(*flat.shape, d))
    return out.reshape(*idx.shape, d)


def forward_logits(params: MFParams, u: torch.Tensor, i: torch.Tensor,
                   j: torch.Tensor) -> torch.Tensor:
    """Pre-sigmoid score ``sum_d U[u] * (V[i] - V[j])``."""
    eu = gather_rows(params.U, u)
    ev = gather_rows(params.V, i) - gather_rows(params.V, j)
    return torch.sum(eu * ev, dim=-1)


def forward_prob(params: MFParams, u, i, j) -> torch.Tensor:
    """Preference probability (reference ``structure.py:795``)."""
    return torch.sigmoid(forward_logits(params, u, i, j))


class MatrixFactorization(nn.Module):
    """U ``[R, n, d]`` and V ``[R, m, d]`` as parameters; ``forward``
    returns logits for index tensors ``[R, ...]``."""

    def __init__(self, params: MFParams):
        super().__init__()
        self.U = nn.Parameter(params.U.detach().clone())
        self.V = nn.Parameter(params.V.detach().clone())

    def params(self) -> MFParams:
        return MFParams(self.U, self.V)

    def forward(self, u, i, j) -> torch.Tensor:
        return forward_logits(self.params(), u, i, j)
