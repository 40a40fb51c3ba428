"""Counterpart of ``mfcd_tpu/train``."""
