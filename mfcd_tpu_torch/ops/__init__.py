"""Counterpart of ``mfcd_tpu/ops``."""
