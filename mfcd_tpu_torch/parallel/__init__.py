"""Counterpart of ``mfcd_tpu/parallel``: ``mesh`` (the sharded step and
its mesh) and ``multihost`` (bring-up, the launcher)."""

from mfcd_tpu_torch.parallel.mesh import (  # noqa: F401
    factor_mesh,
    make_mesh,
    make_sharded_train_step,
    replicate_opt_state_for_grid,
)
