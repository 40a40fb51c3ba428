"""Counterpart of ``mfcd_tpu/sweep``."""

from mfcd_tpu_torch.sweep.batched import parameter_scan_fast, run_bucket
from mfcd_tpu_torch.sweep.ground_truth import (evaluate_ground_truth,
                                               parameter_scan_ground_truth)

__all__ = ["evaluate_ground_truth", "parameter_scan_fast",
           "parameter_scan_ground_truth", "run_bucket"]
