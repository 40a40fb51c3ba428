"""Evaluation — every metric of the reference's results schema.

Counterpart of ``mfcd_tpu/eval/metrics.py`` (reference
``structure.py:881-1127``), with the reference's quirks kept:

- ``reconstruction_errors`` column-centers UV^T while the scaled-alignment
  family row-centers both matrices,
- the ground-truth loss is the MSE between ``sigmoid(X[u,i] - X[u,j])``
  (no scale ``s``) and labels drawn with the scale,
- ground-truth accuracy thresholds ``diff > 0``,
- per-row Pearson/Spearman/slopes skip near-constant rows (masks here),
- test loss/accuracy are mean-of-batch-means / correct-over-total.

Spearman uses ordinal ranks with ties broken by index, from a stable
``torch.argsort`` (the JAX package counts comparisons instead, to keep
sorts out of TPU programs; the ranks are the same).  Every function takes
a leading run axis ``[R, ...]``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from mfcd_tpu_torch.core import prng
from mfcd_tpu_torch.data.btl import LabeledSplit
from mfcd_tpu_torch.models.mf import MFParams
from mfcd_tpu_torch.ops.linalg import top_singular_values
from mfcd_tpu_torch.ops.loss_pass import _pad_to_batches, losses_and_hits

_EPS = 1e-8


def accuracy(correct: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """``correct / total`` in float32, 0 where ``total`` is 0: a run's
    accuracy from its counts of correct and of valid rows."""
    return torch.where(total > 0,
                       correct.to(torch.float32) / torch.clamp(total, min=1),
                       0.0)


def evaluate_split(params: MFParams, split: LabeledSplit,
                   batch_size: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Test BCE (mean of per-batch means) + accuracy at threshold 0.5: on
    a card one pass of L1 (``ops/loss_pass.py::losses_and_hits``), on the
    CPU its plain block loop."""
    _, loss, correct = losses_and_hits(params, split, batch_size)
    return loss, accuracy(correct, torch.sum(split.valid, dim=-1))


def ground_truth_metrics(x: torch.Tensor, split: LabeledSplit,
                         batch_size: int = 64
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GT oracle on the test split: MSE of unscaled sigmoid probabilities
    (mean of batch means) + diff>0 accuracy."""
    u, i, j, z, valid = _pad_to_batches(split, batch_size)
    r = x.shape[0]
    rows = torch.arange(r, device=x.device).reshape(r, 1, 1)
    u, i, j = (a.to(torch.int64) for a in (u, i, j))
    diff = x[rows, u, i] - x[rows, u, j]
    prob = torch.sigmoid(diff)  # NB: no scale factor — reference quirk
    sq = (prob - z) ** 2
    zero = torch.zeros_like(sq)
    per_sum = torch.sum(torch.where(valid, sq, zero), dim=-1)
    per_cnt = torch.sum(valid, dim=-1)
    nonempty = per_cnt > 0
    per_mean = torch.where(nonempty, per_sum / torch.clamp(per_cnt, min=1),
                           torch.zeros_like(per_sum))
    loss = (torch.sum(per_mean, dim=-1)
            / torch.clamp(torch.sum(nonempty, dim=-1), min=1))

    pred = (diff > 0).to(torch.float32)
    correct = torch.sum(torch.where(valid, (pred == z).to(torch.float32),
                                    zero), dim=(-2, -1))
    total = torch.sum(valid, dim=(-2, -1))
    acc = torch.where(total > 0, correct / torch.clamp(total, min=1),
                      torch.zeros_like(correct))
    return loss, acc


def _fro(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(a * a, dim=(-2, -1)))


def compute_reconstruction_error(params: MFParams, x: torch.Tensor,
                                 s) -> torch.Tensor:
    """``||col_center(UV^T) - s X||_F / ||s X||_F``."""
    uvt = params.U @ params.V.transpose(-1, -2)
    uvt = uvt - torch.mean(uvt, dim=-2, keepdim=True)
    s = torch.as_tensor(s, dtype=torch.float32, device=x.device)
    target = s.reshape(s.shape + (1, 1)) * x
    return _fro(uvt - target) / _fro(target)


def _rowwise_pearson(xc: torch.Tensor, uc: torch.Tensor) -> torch.Tensor:
    """Pearson per row for row-centered inputs."""
    num = torch.sum(xc * uc, dim=-1)
    den = torch.sqrt(torch.sum(xc ** 2, dim=-1) * torch.sum(uc ** 2, dim=-1))
    return num / torch.clamp(den, min=1e-30)


def _ranks(a: torch.Tensor) -> torch.Tensor:
    """Ordinal ranks along the last axis, ties broken by index."""
    order = torch.argsort(a, dim=-1, stable=True)
    iota = torch.arange(a.shape[-1], device=a.device).expand(a.shape)
    return torch.empty_like(order).scatter_(-1, order, iota).to(a.dtype)


def _masked_mean_std(vals: torch.Tensor, mask: torch.Tensor):
    cnt = torch.sum(mask, dim=-1)
    zero = torch.zeros_like(vals)
    safe = torch.clamp(cnt, min=1)
    mean = torch.where(cnt > 0,
                       torch.sum(torch.where(mask, vals, zero), dim=-1) / safe,
                       torch.zeros_like(cnt, dtype=vals.dtype))
    dev2 = torch.where(mask, (vals - mean.unsqueeze(-1)) ** 2, zero)
    var = torch.where(cnt > 0, torch.sum(dev2, dim=-1) / safe,
                      torch.zeros_like(mean))
    return mean, torch.sqrt(var)


def compute_alignment_metrics(params: MFParams, x_init: torch.Tensor,
                              spectrum_key: torch.Tensor) -> Dict:
    """The fused alignment block (reference ``structure.py:958-1082``);
    ``spectrum_key`` ``[R, 2]`` seeds the top-singular-value probe."""
    uvt = params.U @ params.V.transpose(-1, -2)
    uvt = uvt - torch.mean(uvt, dim=-1, keepdim=True)   # row-center
    x = x_init - torch.mean(x_init, dim=-1, keepdim=True)

    dot = torch.sum(uvt * x, dim=(-2, -1))
    norm_uvt = _fro(uvt)
    norm_x = _fro(x)
    alpha = dot / (norm_uvt ** 2 + _EPS)
    norm_ratio = norm_uvt / (norm_x + _EPS)
    rec_scaled = _fro(alpha[:, None, None] * uvt - x) / (norm_x + _EPS)

    std_x = torch.std(x, dim=-1, correction=0)
    std_u = torch.std(uvt, dim=-1, correction=0)
    corr_mask = (std_x > _EPS) & (std_u > _EPS)

    pearson = _rowwise_pearson(x, uvt)
    pearson_mean, pearson_std = _masked_mean_std(pearson, corr_mask)

    rx = _ranks(x)
    ru = _ranks(uvt)
    rxc = rx - torch.mean(rx, dim=-1, keepdim=True)
    ruc = ru - torch.mean(ru, dim=-1, keepdim=True)
    spearman = _rowwise_pearson(rxc, ruc)
    spearman_mean, spearman_std = _masked_mean_std(spearman, corr_mask)

    # SVD-free spectrum error: the row-centered UV^T has rank <= d, so its
    # spectrum comes exactly from two thin QRs and a d x d SVD; only X's
    # top-d singular values are needed (randomized subspace iteration).
    v_centered = params.V - torch.mean(params.V, dim=-2, keepdim=True)
    r_u = torch.linalg.qr(params.U).R
    r_v = torch.linalg.qr(v_centered).R
    s2_d = torch.linalg.svdvals(r_u @ r_v.transpose(-1, -2))
    d_rank = s2_d.shape[-1]
    q = min(d_rank + 10, min(x.shape[-2:]))
    s1_top = top_singular_values(x, q, spectrum_key)[..., :d_rank]
    fro2 = torch.sum(x * x, dim=(-2, -1))
    head = torch.sum((alpha[:, None] * s2_d - s1_top) ** 2, dim=-1)
    tail = torch.clamp(fro2 - torch.sum(s1_top ** 2, dim=-1), min=0.0)
    svd_error = torch.sqrt(head + tail) / (torch.sqrt(fro2) + _EPS)

    xx = torch.sum(x * x, dim=-1)
    xu = torch.sum(x * uvt, dim=-1)
    slopes = xu / torch.clamp(xx, min=1e-30)
    slopes_mask = (xx > _EPS) & (std_u > _EPS)

    uu = torch.sum(uvt * uvt, dim=-1)
    alpha_per_row = torch.where(uu > _EPS, xu / torch.clamp(uu, min=1e-30),
                                torch.zeros_like(uu))
    adjusted = alpha_per_row.unsqueeze(-1) * uvt
    rec_per_row = _fro(adjusted - x) / (norm_x + _EPS)

    return {
        "alpha": alpha,
        "norm_X": norm_x,
        "norm_ratio": norm_ratio,
        "reconstruction_error_scaled": rec_scaled,
        "pearson_corr": pearson_mean,
        "pearson_std": pearson_std,
        "spearman_corr": spearman_mean,
        "spearman_std": spearman_std,
        "svd_error_scaled": svd_error,
        "slopes": slopes,
        "slopes_mask": slopes_mask,
        "pearson_corr_matrix": pearson,
        "pearson_mask": corr_mask,
        "spearman_corr_matrix": spearman,
        "spearman_mask": corr_mask,
        "reconstruction_error_scaled_per_row": rec_per_row,
        "alpha_per_row": alpha_per_row,
    }


def compute_all_metrics(params: MFParams, x: torch.Tensor, s,
                        test: LabeledSplit, rows_key: torch.Tensor,
                        batch_size: int = 64) -> Dict:
    """Everything ``run_experiment`` records per repetition (reference
    ``structure.py:375-417``), for ``[R]`` runs."""
    test_loss, test_acc = evaluate_split(params, test, batch_size)
    gt_loss, gt_acc = ground_truth_metrics(x, test, batch_size)
    rec_err = compute_reconstruction_error(params, x, s)
    k_rows, k_spec = prng.split(rows_key).unbind(-2)
    out = compute_alignment_metrics(params, x, k_spec)

    # 2 random distinct rows for visual inspection
    # (reference ``structure.py:388-392``).
    n = x.shape[-2]
    uvt_full = params.U @ params.V.transpose(-1, -2)
    kr0, kr1 = prng.split(k_rows).unbind(-2)
    r0 = prng.randint(kr0, (), 0, n)
    r1 = prng.randint(kr1, (), 0, n - 1)
    r1 = r1 + (r1 >= r0).to(r1.dtype)
    rand = torch.stack([r0, r1], dim=-1).to(torch.int64)       # [R, 2]
    runs = torch.arange(x.shape[0], device=x.device).unsqueeze(-1)
    out.update({
        "accuracy": test_acc,
        "log_likelihoods": -test_loss,
        "gt_log_likelihoods": -gt_loss,
        "gt_accuracy": gt_acc,
        "reconstruction_errors": rec_err,
        "sampled_X_rows": x[runs, rand],
        "sampled_UVT_rows": uvt_full[runs, rand],
    })
    return out
