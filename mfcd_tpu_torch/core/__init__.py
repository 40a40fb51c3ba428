"""Counterpart of ``mfcd_tpu/core``."""
