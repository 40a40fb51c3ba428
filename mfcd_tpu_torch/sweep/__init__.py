"""Counterpart of ``mfcd_tpu/sweep``."""
