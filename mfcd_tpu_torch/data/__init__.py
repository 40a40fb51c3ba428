"""Counterpart of ``mfcd_tpu/data``."""
