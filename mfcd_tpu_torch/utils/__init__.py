"""Counterpart of ``mfcd_tpu/utils``."""
