"""Results schema — byte-compatible export to the reference layout.

Counterpart of ``mfcd_tpu/core/results.py``.  Every experiment yields the
23-key results dict of the reference (``structure.py:420-444``), stored as
``{'params': {...}, 'results': {...}}`` and pickled in lists.  On the
device the same information lives in fixed-shape tensors with validity
masks (per-row Pearson/Spearman/slope values for rows the reference skips,
``structure.py:1006,1027,1043``); this module converts between the two.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

# The result keys, reference order (``structure.py:420-444``).
RESULT_KEYS = (
    "reconstruction_errors",
    "log_likelihoods",
    "accuracy",
    "gt_log_likelihoods",
    "gt_accuracy",
    "train_losses",
    "val_losses",
    "alpha",
    "norm_X",
    "norm_ratio",
    "reconstruction_error_scaled",
    "pearson_corr",
    "pearson_std",
    "spearman_corr",
    "spearman_std",
    "svd_error_scaled",
    "slopes",
    "pearson_corr_matrix",
    "spearman_corr_matrix",
    "reconstruction_error_scaled_per_row",
    "alpha_per_row",
    "sampled_UVT_rows",
    "sampled_X_rows",
)

# Device-side keys that are per-rep scalars.
_SCALAR_KEYS = (
    "reconstruction_errors", "log_likelihoods", "accuracy",
    "gt_log_likelihoods", "gt_accuracy", "alpha", "norm_X", "norm_ratio",
    "reconstruction_error_scaled", "pearson_corr", "pearson_std",
    "spearman_corr", "spearman_std", "svd_error_scaled",
    "reconstruction_error_scaled_per_row",
)

# Per-rep [num_epochs] curves.
_CURVE_KEYS = ("train_losses", "val_losses")

# Per-rep [n] row metrics carrying a mask; the exporter drops masked rows
# to reproduce the reference's list-skipping semantics.
_MASKED_ROW_KEYS = {
    "slopes": "slopes_mask",
    "pearson_corr_matrix": "pearson_mask",
    "spearman_corr_matrix": "spearman_mask",
}


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def export_results(device_results: Dict[str, Any]) -> Dict[str, Any]:
    """Convert stacked per-rep tensors (or arrays) into the reference schema.

    Values have a leading repetition axis.  Scalars become ``list[float]``
    of length reps; curves ``list[list[float]]``; masked row metrics ragged
    ``list[list[float]]`` with masked entries dropped; sampled rows stay
    numpy arrays (``list[np.ndarray (2, m)]``), as ``structure.py:391-392``.
    """
    host = {k: _to_numpy(v) for k, v in device_results.items()}
    reps = host["accuracy"].shape[0]
    out: Dict[str, Any] = {}

    for k in _SCALAR_KEYS + _CURVE_KEYS:
        out[k] = host[k].astype(np.float64).tolist()

    for k, mask_key in _MASKED_ROW_KEYS.items():
        vals = host[k].astype(np.float64)
        mask = host[mask_key].astype(bool)
        out[k] = [vals[r][mask[r]].tolist() for r in range(reps)]

    # alpha_per_row keeps every row (0.0 placeholder when degenerate),
    # matching reference ``structure.py:1054-1059``.
    out["alpha_per_row"] = host["alpha_per_row"].astype(np.float64).tolist()

    for k in ("sampled_UVT_rows", "sampled_X_rows"):
        out[k] = [np.asarray(host[k][r], dtype=np.float32)
                  for r in range(reps)]
    return out


def validate_schema(results: Dict[str, Any]) -> List[str]:
    """Return a list of schema violations (empty = reference-compatible)."""
    problems = []
    for k in RESULT_KEYS:
        if k not in results:
            problems.append(f"missing key: {k}")
    for k in results:
        if k not in RESULT_KEYS:
            problems.append(f"unexpected key: {k}")
    return problems
