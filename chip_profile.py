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
   device's busy share (summed kernel time over the profiled wall);
4. ``parameter_scan_fast`` on the bench bucket (s = 5 and 6: one chunk of
   8 runs), timed as in 2 and profiled as in 3; its ``mfcd.sweep.*`` spans
   split the sweep's host time into dispatch, collect and export.
5. the sample stage alone (``sample_and_split``) under each of the nine
   strategies, at the canonical shape and budgets, 4 runs: one warm-up
   call, then one profiled as in 3;
6. the generation stage alone (``generate_x``) for the svd, clustered, gmm
   and social modes, at the canonical shape, 4 runs: one warm-up call,
   then one profiled as in 3;
7. the svd generator's decomposition (the scores of 8 canonical runs) by
   each cuSOLVER driver in float32 and float64, and by the CPU's LAPACK in
   float32: ms per run, and each top-d singular vector's L2 distance from
   the float64 CPU solve in units of eps * s_1 / gap (gap: from s_k to its
   nearest neighbour), the largest and the median.

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

from chip_smoke import CANON

STRATEGIES = ("random", "proximity", "top_k", "svd", "margin", "variance",
              "popularity", "cluster", "user_similarity")

GENERATIONS = ("svd", "clustered", "gmm", "social")

TIMED_CALLS = 3


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def timed(label: str, runs: int, call):
    """``TIMED_CALLS`` calls, host wall around ``torch.cuda.synchronize()``:
    (median seconds per run, the walls)."""
    walls = []
    for _ in range(TIMED_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    s_per_run = float(np.median(walls)) / runs
    print(f"{label} timed: walls {[round(w, 4) for w in walls]} s, "
          f"{s_per_run:.4f} s/run (median)", flush=True)
    return s_per_run, walls


def profiled(label: str, call) -> dict:
    """One ``call()`` under torch.profiler; prints and returns its split."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
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
    print(f"{label}: profiled wall {wall * 1e3:.1f} ms (profiler on); "
          f"{launches} kernel launches, device kernel time {device_ms:.1f} "
          f"ms, busy share {device_ms / (wall * 1e3):.3f}")
    for k, v in sorted(spans.items(), key=lambda kv: -kv[1]):
        print(f"  span {k:24s} {v:9.1f} ms host")
    for k, ms, n in kernels[:8]:
        print(f"  kernel {k[:60]:60s} {ms:8.2f} ms x{n}")
    return {"profiled_wall_ms": wall * 1e3, "device_kernel_ms": device_ms,
            "kernel_launches": launches,
            "busy_share": device_ms / (wall * 1e3), "spans_host_ms": spans,
            "top_kernels_ms": [[k[:80], ms, n] for k, ms, n in kernels[:8]]}


def sampler_call(strategy: str):
    """A warmed-up call of ``sample_and_split`` for ``strategy`` on the
    canonical X of 4 runs, with the engine's capacities and budgets."""
    from mfcd_tpu_torch.core import prng, rng
    from mfcd_tpu_torch.core.config import RunConfig
    from mfcd_tpu_torch.data.btl import sample_and_split
    from mfcd_tpu_torch.genx import generate_x
    from mfcd_tpu_torch.sweep.engine import compile_caps

    cfg = RunConfig(n=CANON["n"], m=CANON["m"], d=CANON["d"], p=CANON["p"],
                    strategy=strategy, reps=CANON["reps"])
    sh, r, dev = cfg.shapes(), cfg.reps, torch.device("cuda")
    t_cap, extra_cap = compile_caps(cfg)
    keys = rng.rep_keys(rng.config_key(prng.key(0, device=dev), 0)[None],
                        r).reshape(r, 2)
    streams = rng.rep_streams(keys)
    x = generate_x(streams["x_gen"], cfg.n, cfg.m, cfg.d)
    exact = (sh.num_triplets, sh.extra_test_triplets) == (t_cap, extra_cap)
    budget = lambda v: None if exact else torch.full(
        (r,), v, dtype=torch.int32, device=dev)
    call = lambda: sample_and_split(
        streams, x, t_cap, extra_cap, strategy,
        budget=budget(sh.num_triplets),
        extra_budget=budget(sh.extra_test_triplets))
    call()
    return call


def generation_call(mode: str):
    """A warmed-up call of ``generate_x`` for ``mode`` on the canonical
    shape's ``x_gen`` keys of 4 runs."""
    from mfcd_tpu_torch.core import prng, rng
    from mfcd_tpu_torch.genx import generate_x

    r, dev = CANON["reps"], torch.device("cuda")
    keys = rng.rep_keys(rng.config_key(prng.key(0, device=dev), 0)[None],
                        r).reshape(r, 2)
    key = rng.rep_streams(keys)["x_gen"]
    call = lambda: generate_x(key, CANON["n"], CANON["m"], CANON["d"], mode)
    call()
    return call


def svd_solvers() -> dict:
    """[7] The svd generator's decomposition by each solver, against the
    float64 CPU solve of the same scores."""
    from mfcd_tpu_torch.core import prng, rng

    r, n, m, d, dev = 8, CANON["n"], CANON["m"], CANON["d"], "cuda"
    keys = rng.rep_keys(rng.config_key(prng.key(0, device=dev), 0)[None],
                        r).reshape(r, 2)
    key = rng.rep_streams(keys)["x_gen"]
    scores = prng.normal(prng.split(key, 3)[..., 0, :], (n, m))
    u64, s64, _ = torch.linalg.svd(scores.cpu().double(),
                                   full_matrices=False)
    above = torch.cat([torch.full_like(s64[:, :1], float("inf")),
                       s64[:, :d - 1] - s64[:, 1:d]], dim=-1)
    gap = torch.minimum(above, s64[:, :d] - s64[:, 1:d + 1])
    unit = 2.0 ** -24 * s64[:, :1] / gap
    solvers = {f"card {dt} {drv}": (lambda drv=drv, dt=dt: torch.linalg.svd(
        scores.to(getattr(torch, dt)), full_matrices=False, driver=drv))
        for dt in ("float32", "float64") for drv in ("gesvdj", "gesvd")}
    solvers["cpu float32 LAPACK"] = lambda: torch.linalg.svd(
        scores.cpu(), full_matrices=False)
    out = {}
    for name, solve in solvers.items():
        solve()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, _, _ = solve()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / r
        u = u.cpu().double()[..., :d]
        sign = torch.sign(torch.sum(u * u64[..., :d], dim=-2, keepdim=True))
        units = (u * sign - u64[..., :d]).norm(dim=-2) / unit
        out[name] = {"ms_per_run": ms, "units_max": float(units.max()),
                     "units_median": float(units.median())}
        print(f"svd {name}: {ms:.2f} ms/run; top-{d} vectors "
              f"{float(units.max()):.3g} (median "
              f"{float(units.median()):.3g}) x eps s_1 / gap from exact",
              flush=True)
    out["relative_gaps"] = (gap / s64[:, :1]).flatten().tolist()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    import mfcd_tpu_torch
    from mfcd_tpu_torch.backend import card_line

    smi = card_line()
    runs = CANON["reps"] * len(CANON["s"])

    mfcd_tpu_torch.parameter_scan(**dict(CANON, num_epochs=2))
    s_per_run, walls = timed("parameter_scan", runs,
                             lambda: mfcd_tpu_torch.parameter_scan(**CANON))
    out = {"card": smi, "s_per_run": s_per_run, "walls_s": walls}
    out.update(profiled("parameter_scan",
                        lambda: mfcd_tpu_torch.parameter_scan(**CANON)))

    grid = dict(CANON, s=[5.0, 6.0])
    fast_call = lambda: mfcd_tpu_torch.parameter_scan_fast(**grid)
    fast_s, fast_walls = timed("parameter_scan_fast",
                               grid["reps"] * len(grid["s"]), fast_call)
    out["fast"] = {"s_per_run": fast_s, "walls_s": fast_walls,
                   **profiled("parameter_scan_fast", fast_call)}
    out["samplers"] = {s: profiled(f"sample_and_split {s}", sampler_call(s))
                       for s in STRATEGIES}
    out["generators"] = {g: profiled(f"generate_x {g}", generation_call(g))
                         for g in GENERATIONS}
    out["svd_solvers"] = svd_solvers()
    print(smi)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
