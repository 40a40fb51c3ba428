"""Carry state from the JAX package's types into the port's.

Inputs are numpy arrays (``np.asarray`` of the JAX arrays), so this module
imports no jax.  The tests use these to feed both packages identical
inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from mfcd_tpu_torch.data.btl import LabeledSplit
from mfcd_tpu_torch.models.mf import MFParams
from mfcd_tpu_torch.ops.kernels import EpochState


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a, copy=True), dtype=dtype,
                           device=device)


def params_from_jax(U, V, device="cpu") -> MFParams:
    """``MFParams`` (U ``[..., n, d]``, V ``[..., m, d]``) as float32."""
    return MFParams(_t(U, device, torch.float32), _t(V, device, torch.float32))


def epoch_state_from_jax(u_t, v_t, mu_u, nu_u, mu_v, nu_v,
                         device="cpu") -> EpochState:
    """``EpochState`` in the ``[R, d, rows]`` layout of both packages."""
    return EpochState(*(_t(a, device, torch.float32)
                        for a in (u_t, v_t, mu_u, nu_u, mu_v, nu_v)))


def key_from_jax(key_data, device="cpu") -> torch.Tensor:
    """``jax.random.key_data(k)`` (uint32 ``[..., 2]``) -> a port key."""
    return _t(np.asarray(key_data, dtype=np.uint32).astype(np.int64), device)


def split_from_jax(u, i, j, z, valid, count, device="cpu") -> LabeledSplit:
    """A ``LabeledSplit`` with int32 indices, float32 labels, bool mask."""
    return LabeledSplit(
        u=_t(u, device, torch.int32), i=_t(i, device, torch.int32),
        j=_t(j, device, torch.int32), z=_t(z, device, torch.float32),
        valid=_t(valid, device, torch.bool),
        count=_t(count, device, torch.int32))
