"""Numeric precision and device selection for the port.

Counterpart of the precision pin in ``mfcd_tpu/cache.py`` (``enable``):
the QR/SVD-based generators and metrics need exact float32 matmuls, so
TF32 is switched off for both cuBLAS and cuDNN and float32 matmuls run at
"highest" precision.  The pin is applied when this module is imported.

``resolve_device`` turns the ``device`` argument of the entry points into a
``torch.device``: ``None`` means the card, and asking for the card where
there is none raises — nothing falls back to the CPU silently.
"""

from __future__ import annotations

import subprocess

import torch


def pin_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mfcd_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {dev}")
    return dev


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


pin_precision()
