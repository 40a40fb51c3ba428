"""Counterpart of ``mfcd_tpu/sweep``."""

from mfcd_tpu_torch.sweep.batched import parameter_scan_fast, run_bucket

__all__ = ["parameter_scan_fast", "run_bucket"]
