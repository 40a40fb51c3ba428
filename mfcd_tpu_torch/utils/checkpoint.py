"""Model-factor checkpointing (SURVEY §5.4).

Counterpart of ``mfcd_tpu/utils/checkpoint.py``.  The reference keeps no
model checkpoints — only final metrics survive, and resume granularity is
the experiment (``structure.py:175-200``).  This module adds persisting
the learned (U, V) factors per repetition, as one ``.npz`` file with the
JAX package's keys (``U``, ``V``, ``metadata_json``), so a checkpoint
written by either package loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from mfcd_tpu_torch.backend import resolve_device
from mfcd_tpu_torch.models.mf import MFParams


def save_factors(path: str, params: MFParams, metadata: Optional[dict] = None):
    """Persist (U, V) (+ json-able metadata) to ``path`` (.npz)."""
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    meta = {}
    if metadata:
        meta["metadata_json"] = np.asarray(json.dumps(metadata))
    np.savez(path, U=params.U.detach().cpu().numpy(),
             V=params.V.detach().cpu().numpy(), **meta)


def load_factors(path: str, device=None):
    """Returns (MFParams of float32 tensors on ``device``, metadata dict or
    None).  ``device=None`` means the card."""
    device = resolve_device(device)
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        params = MFParams(
            U=torch.as_tensor(data["U"], dtype=torch.float32, device=device),
            V=torch.as_tensor(data["V"], dtype=torch.float32, device=device))
        metadata = None
        if "metadata_json" in data:
            metadata = json.loads(str(data["metadata_json"]))
    return params, metadata
