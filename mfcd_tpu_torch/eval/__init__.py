"""Counterpart of ``mfcd_tpu/eval``."""
