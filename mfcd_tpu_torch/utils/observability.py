"""Tracing, profiling, and structured metrics logging (SURVEY §5.1, §5.5).

Counterpart of ``mfcd_tpu/utils/observability.py``.  The reference's
observability is tqdm bars and emoji console prints, plus dead TensorBoard
scaffolding (``structure.py:830-834, 1130-1145``).  Here:

- :func:`trace` wraps ``torch.profiler.profile`` for on-demand profiles of
  the card (or of the CPU when asked), written as a Chrome trace,
- :class:`ThroughputMeter` measures the BASELINE.md counters
  (runs/hour, triplet-grads/sec),
- :class:`JsonlLogger` appends one JSON line per experiment (scalar metrics
  + params), a grep-able companion to the pickle protocol,
- :func:`tensorboard_writer` returns a live SummaryWriter when the optional
  dependency exists (the reference's was hard-disabled; ours is opt-in).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from mfcd_tpu_torch.backend import resolve_device


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, device=None):
    """Profile the enclosed block with ``torch.profiler``: CPU activity, and
    CUDA activity when ``device`` is the card (``None``: the card, which
    raises where there is none).  Writes a Chrome trace into ``log_dir``
    (default: ``mfcd_trace`` under the temp directory) and prints its
    path."""
    device = resolve_device(device)
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "mfcd_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    print(f"profile written to {path}")


class ThroughputMeter:
    """Accumulates run/grad counts against wall-clock."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.time()
        self.runs = 0
        self.triplet_grads = 0

    def add(self, runs: int = 0, triplet_grads: int = 0):
        self.runs += runs
        self.triplet_grads += triplet_grads

    @property
    def elapsed(self) -> float:
        return time.time() - self.t0

    def summary(self) -> Dict[str, float]:
        dt = max(self.elapsed, 1e-9)
        return {
            "elapsed_sec": dt,
            "runs_per_hour": self.runs / dt * 3600.0,
            "triplet_grads_per_sec": self.triplet_grads / dt,
        }


class JsonlLogger:
    """One JSON line per experiment: params + scalar metric summaries."""

    def __init__(self, path: str):
        self.path = path
        dirname = os.path.dirname(path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)

    def log(self, params: Dict[str, Any], results: Dict[str, Any]):
        record = {"params": params, "metrics": {}}
        for k, v in results.items():
            try:
                flat = np.asarray(v, dtype=np.float64).ravel()
            except (ValueError, TypeError):
                continue
            if flat.size:
                record["metrics"][k] = {
                    "mean": float(np.mean(flat)),
                    "std": float(np.std(flat)),
                }
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


def tensorboard_writer(log_dir: str = "runs/mfcd") -> Optional[object]:
    """A live SummaryWriter when tensorboard is installed, else None.

    Replaces the reference's hard-disabled writer + browser launcher
    (``structure.py:830-834, 1130-1145``) with an explicit opt-in.
    """
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:
        return None
    return SummaryWriter(log_dir=log_dir)
