"""Counterpart of ``mfcd_tpu/sampling``."""
