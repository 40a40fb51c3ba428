"""Counterpart of ``mfcd_tpu/models``."""
