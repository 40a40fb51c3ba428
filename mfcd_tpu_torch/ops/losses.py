"""Loss primitives.

Counterpart of ``mfcd_tpu/ops/losses.py``: binary cross-entropy in the
stable logit form ``max(x, 0) - x*z + log(1 + exp(-|x|))`` and masked
means with the DataLoader batch semantics.
"""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise stable binary cross-entropy on logits."""
    return (torch.clamp(logits, min=0.0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def masked_batch_mean(values: torch.Tensor, mask: torch.Tensor,
                      dim: int = -1) -> torch.Tensor:
    """Mean over masked entries along ``dim``; 0 when the mask is empty."""
    s = torch.sum(torch.where(mask, values, torch.zeros_like(values)), dim)
    c = torch.sum(mask, dim)
    return torch.where(c > 0, s / torch.clamp(c, min=1), torch.zeros_like(s))
