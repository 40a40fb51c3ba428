"""Counterpart of ``mfcd_tpu/viz``: the figures, host-only (matplotlib).

Nothing on the sweep path imports this package, so a sweep runs where
matplotlib is absent."""
