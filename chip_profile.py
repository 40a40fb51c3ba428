"""Where the time of the port's main path goes, on one CUDA card.

    python3 chip_profile.py

Runs the canonical ``parameter_scan`` (``chip_smoke.CANON``: n = m = 1000,
d = 2, p = 0.2, s = 5, 30 epochs, reps = 4; ``bench.py:502-505``) on the
card:

1. once at 2 epochs to warm up (library handles, lazy module loads, the
   kernel build);
2. ``TIMED_CALLS`` times, host wall around ``torch.cuda.synchronize()``:
   median seconds per run (one run = one repetition of one config);
3. once under ``torch.profiler`` (CPU + CUDA): host time of each ``mfcd.*``
   stage span, kernel launches and device time per kernel name, and the
   device's busy share (summed kernel time over the profiled wall).

Prints a readable report and, as its last line, one JSON object with the
numbers and the card's name and power limit.  Exits non-zero without a
card.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from chip_smoke import CANON, smi_line

TIMED_CALLS = 3


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    import mfcd_tpu_torch
    from torch.profiler import ProfilerActivity, profile

    smi = smi_line()
    runs = CANON["reps"] * len(CANON["s"])

    mfcd_tpu_torch.parameter_scan(**dict(CANON, num_epochs=2))
    walls = []
    for _ in range(TIMED_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mfcd_tpu_torch.parameter_scan(**CANON)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    s_per_run = float(np.median(walls)) / runs
    print(f"timed: walls {[round(w, 4) for w in walls]} s, "
          f"{s_per_run:.4f} s/run (median)", flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mfcd_tpu_torch.parameter_scan(**CANON)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Host time of the stage spans, and device time of the kernels.  A span
    # has two entries, its CPU-side range and its GPU-side annotation (host
    # time 0): sum them.  The annotations are not kernels and are left out.
    stats = prof.key_averages()
    spans: dict = {}
    for e in stats:
        if e.key.startswith("mfcd."):
            spans[e.key] = spans.get(e.key, 0.0) + e.cpu_time_total / 1e3
    kernels = sorted(((e.key, _device_us(e) / 1e3, e.count) for e in stats
                      if _device_us(e) > 0 and "CUDA" in str(e.device_type)
                      and not e.key.startswith("mfcd.")),
                     key=lambda kv: -kv[1])
    device_ms = sum(ms for _, ms, _ in kernels)
    launches = sum(n for _, _, n in kernels)
    print(f"profiled wall {wall * 1e3:.1f} ms (profiler on); {launches} "
          f"kernel launches, device kernel time {device_ms:.1f} ms, busy "
          f"share {device_ms / (wall * 1e3):.3f}")
    for k, v in sorted(spans.items(), key=lambda kv: -kv[1]):
        print(f"  span {k:24s} {v:9.1f} ms host")
    for k, ms, n in kernels[:8]:
        print(f"  kernel {k[:60]:60s} {ms:8.2f} ms x{n}")
    print(smi)
    print(json.dumps({
        "card": smi, "s_per_run": s_per_run, "walls_s": walls,
        "profiled_wall_ms": wall * 1e3, "device_kernel_ms": device_ms,
        "kernel_launches": launches,
        "busy_share": device_ms / (wall * 1e3),
        "spans_host_ms": spans,
        "top_kernels_ms": [[k[:80], ms, n] for k, ms, n in kernels[:8]],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
