"""Benchmark: full-training-run throughput of the port, on the card.

    python3 -m mfcd_tpu_torch.bench [--quick | --sweep | --k10 | --k50]
        [--device cuda|cpu] [--jnp-timeout SECONDS]

Counterpart of the root ``bench.py``, with its modes, configurations,
seeds and metric names.  Measures whole experiments (generate X*, sample
triplets, BTL labels, 30 epochs of Adam, the 23 metrics, the copy to the
host) through ``sweep.batched.run_bucket`` and ``parameter_scan_fast``:

- default: ``full_training_runs_per_hour_per_chip_1000x1000_d2_p0.2``,
  n = m = 1000, d = 2, p = 0.2, s = 5 and 6, lr 1e-3, wd 5e-6, 30 epochs,
  reps = 4, K = 1, one warm call at seed 123 and one timed call at seed
  321; then the K = 10 fields (``k10_pallas_runs_per_hour``,
  ``k10_pallas_speedup_vs_jnp``) as ``--k10`` measures them;
- ``--quick``: ``quick_smoke_runs_per_hour_per_chip_100x100``, n = m = 100,
  5 epochs, reps = 2;
- ``--sweep``: ``sweep_runs_per_hour_per_chip_1000x1000_sxwd``, one
  ``parameter_scan_fast`` call over 20 log-spaced s x wd in {5e-6, 5e-4} x
  3 reps (120 runs) at the default's shape;
- ``--k10`` / ``--k50``:
  ``k10_full_training_runs_per_hour_per_chip_pallas`` /
  ``k50_...``, the default's shape at label redundancy K = 10 / 50 with
  hard labels (K x the training rows: 12,500 / 62,500 steps an epoch),
  one configuration, reps = 2, with ``pallas_speedup_vs_jnp``.

``pallas`` names the fused-epoch kernel trainer (K1,
``train/kernel_trainer.py``), ``jnp`` the eager autograd trainer
(``train/trainer.py``): the names are the JAX bench's.  The autograd
comparison runs in a child process with a limit of ``--jnp-timeout``
seconds (2,400, as the JAX bench's; 0 skips it).  A child that runs past
its limit is killed and its field left out, with ``jnp_path`` saying so;
at K = 50 (1,875,000 autograd steps a call) that is the expected outcome.
A child that fails fails the bench.  The kernel path keeps the JAX
bench's full warm-up call; the child warms up at the same shapes for one
epoch, since nothing is compiled per shape.

Stdout gets exactly one JSON line: ``metric``, ``value`` (runs/hour),
``unit`` and ``card`` (the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` prints them, or
``"cpu"``), with the comparison fields.  Everything else, the package's
own prints included, goes to stderr: the device, the configuration, the
warm and steady wall, s/run, triplet-grads/s, the accuracy head and the
K1 launches read around the timed call.

Left out of the JAX bench: ``vs_baseline`` (its 125 runs/hour/chip is a
TPU target, not this port's yardstick); the device probe, the TPU
lock and the compile-cache repair (the card has none of them to guard);
the last-good store and the degraded payload.  A failure raises: no JSON
line, a non-zero exit.  Nothing here writes a file.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

METRICS = {
    "default": "full_training_runs_per_hour_per_chip_1000x1000_d2_p0.2",
    "quick": "quick_smoke_runs_per_hour_per_chip_100x100",
    "sweep": "sweep_runs_per_hour_per_chip_1000x1000_sxwd",
    "k10": "k10_full_training_runs_per_hour_per_chip_pallas",
    "k50": "k50_full_training_runs_per_hour_per_chip_pallas",
}
UNIT = "runs/hour/chip"
JNP_TIMEOUT_S = 2400
WARM_SEED, TIMED_SEED = 123, 321
# The JAX bench's configurations (``bench.py:59-77,497-505``).
CANONICAL = dict(n=1000, m=1000, d=2, p=0.2, s=5.0, lr=1e-3,
                 weight_decay=5e-6, num_epochs=30, reps=4, K=1,
                 strategy="random", generation="base")
QUICK = dict(n=100, m=100, d=2, p=0.2, num_epochs=5, reps=2)
HEADLINE_CONFIGS = 2
KN = dict(CANONICAL, reps=2)
SWEEP = dict(n=1000, m=1000, d=2, p=0.2, s=list(np.logspace(-1, 1, 20)),
             weight_decay=[5e-6, 5e-4], num_epochs=30, reps=3)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(dev: torch.device) -> int:
    """Restart the card's peak count; returns the bytes held now."""
    if dev.type != "cuda":
        return 0
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def _peak(dev: torch.device, held: int) -> Optional[int]:
    """Peak bytes on the card since :func:`_reset_peak`, above ``held``
    (None on the CPU)."""
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) - held


def _measured(label: str, cfg, runs: int, wall: float, launches: int,
              peak, accuracy: List[float], warm: Optional[float]) -> Dict:
    """One timed call's numbers, logged to stderr."""
    rows = cfg.shapes().train_rows * cfg.num_epochs * runs
    m = dict(label=label, cfg=cfg, runs=runs, wall=wall, warm_wall=warm,
             s_per_run=wall / runs, runs_per_hour=3600.0 / wall * runs,
             grads_per_s=rows / wall, k1_launches=launches,
             peak_bytes=peak, accuracy=accuracy)
    log(f"{label}: n={cfg.n} m={cfg.m} d={cfg.d} p={cfg.p} K={cfg.K}"
        f"{' soft' if cfg.soft_label else ''} epochs={cfg.num_epochs}; "
        f"{runs} runs"
        + (f"; warm call {warm:.3f} s" if warm is not None else "")
        + f"; steady {wall:.3f} s ({m['s_per_run']:.4f} s/run, "
        f"{m['runs_per_hour']:.1f} runs/hour); triplet-grads/s "
        f"{m['grads_per_s']:,.0f}; accuracy head "
        f"{[round(a, 4) for a in accuracy[:5]]}; K1 launches {launches}"
        + (f"; peak {peak / 1e6:.1f} MB" if peak is not None else ""))
    return m


def time_bucket(label: str, cfg, n_configs: int, device,
                use_kernel: Optional[bool] = None,
                warm_cfg=None) -> Dict:
    """One warm ``run_bucket`` call at seed 123 (at ``warm_cfg`` where
    given) and one timed call at seed 321, over ``n_configs``
    configurations with s = cfg.s, cfg.s + 1, ...; returns the timed
    call's numbers (:func:`_measured`)."""
    from mfcd_tpu_torch.backend import resolve_device
    from mfcd_tpu_torch.ops import kernels
    from mfcd_tpu_torch.sweep.batched import run_bucket

    dev = resolve_device(device)
    rows = [{"s": cfg.s + k, "lr": cfg.lr, "weight_decay": cfg.weight_decay}
            for k in range(n_configs)]
    idx = list(range(n_configs))
    t0 = time.perf_counter()
    run_bucket(warm_cfg or cfg, rows, idx, seed=WARM_SEED, device=dev,
               use_kernel=use_kernel)
    _sync(dev)
    warm = time.perf_counter() - t0
    held = _reset_peak(dev)
    before = kernels.EPOCH_LAUNCHES
    t0 = time.perf_counter()
    out = run_bucket(cfg, rows, idx, seed=TIMED_SEED, device=dev,
                     use_kernel=use_kernel)
    _sync(dev)
    wall = time.perf_counter() - t0
    peak = _peak(dev, held)
    acc = [float(np.mean(o["accuracy"])) for o in out]
    return _measured(label, cfg, n_configs * cfg.reps, wall,
                     kernels.EPOCH_LAUNCHES - before, peak, acc, warm)


def measure_headline(device, quick: bool = False) -> Dict:
    """The default mode's (or ``--quick``'s) timed call."""
    from mfcd_tpu_torch.core.config import RunConfig

    cfg = RunConfig(**(QUICK if quick else CANONICAL))
    return time_bucket("quick" if quick else "canonical", cfg,
                       HEADLINE_CONFIGS, device)


def measure_kn(k: int, use_kernel: bool, device,
               warm_epochs: Optional[int] = None) -> Dict:
    """The K = ``k`` hard-label bucket (one configuration, reps = 2) on
    the kernel trainer or the eager one; the warm call at ``warm_epochs``
    where given."""
    from mfcd_tpu_torch.core.config import RunConfig

    cfg = RunConfig(**dict(KN, K=k))
    warm = (dataclasses.replace(cfg, num_epochs=warm_epochs)
            if warm_epochs else None)
    return time_bucket(f"K={k} {'pallas' if use_kernel else 'jnp'}", cfg,
                       1, device, use_kernel=use_kernel, warm_cfg=warm)


def measure_sweep(device) -> Dict:
    """One ``parameter_scan_fast`` call over the sweep's 40 configurations
    (no warm call, as the JAX bench; the kernels are built before it)."""
    from mfcd_tpu_torch.backend import resolve_device
    from mfcd_tpu_torch.core.config import RunConfig
    from mfcd_tpu_torch.ops import kernels
    from mfcd_tpu_torch.sweep.batched import parameter_scan_fast

    dev = resolve_device(device)
    held = _reset_peak(dev)
    before = kernels.EPOCH_LAUNCHES
    t0 = time.perf_counter()
    results = parameter_scan_fast(device=dev, **SWEEP)
    _sync(dev)
    wall = time.perf_counter() - t0
    peak = _peak(dev, held)
    cfg = RunConfig(**dict(SWEEP, s=SWEEP["s"][0],
                           weight_decay=SWEEP["weight_decay"][0]))
    acc = [float(np.mean(r["results"]["accuracy"])) for r in results]
    m = _measured("sweep", cfg, len(results) * SWEEP["reps"], wall,
                  kernels.EPOCH_LAUNCHES - before, peak, acc, None)
    m["configs"] = len(results)
    return m


def jnp_s_per_run(k: int, device, timeout_s: float) -> Optional[float]:
    """The eager trainer's s/run at K = ``k`` (:func:`measure_kn`), in a
    child process bounded by ``timeout_s``; None when it runs past the
    limit (the child is killed).  A child that fails raises."""
    cmd = [sys.executable, "-m", "mfcd_tpu_torch.bench", "--_kn-jnp",
           str(k), "--device", torch.device(device).type]
    log(f"K={k} jnp: child process, limit {timeout_s:.0f} s")
    try:
        r = subprocess.run(cmd, stdout=subprocess.PIPE, text=True,
                           timeout=timeout_s, cwd=_REPO)
    except subprocess.TimeoutExpired:
        log(f"K={k} jnp: child killed at its {timeout_s:.0f} s limit")
        return None
    if r.returncode != 0:
        raise RuntimeError(f"K={k} autograd comparison failed in its child "
                           f"process (rc {r.returncode})")
    return float(r.stdout.strip().splitlines()[-1])


def _kn_fields(k: int, device, jnp_timeout_s: float,
               prefix: str = "") -> Tuple[Dict, Dict]:
    """(the K = ``k`` payload fields, the kernel path's measurement)."""
    m = measure_kn(k, True, device)
    fields = {}
    if prefix:
        fields[f"{prefix}pallas_runs_per_hour"] = m["runs_per_hour"]
    if jnp_timeout_s <= 0:
        fields["jnp_path"] = "comparison skipped (--jnp-timeout 0)"
        return fields, m
    t_jnp = jnp_s_per_run(k, device, jnp_timeout_s)
    if t_jnp is None:
        fields["jnp_path"] = (f"unavailable: the K={k} autograd comparison "
                              f"ran past its {jnp_timeout_s:.0f} s limit")
    else:
        fields[f"{prefix}pallas_speedup_vs_jnp"] = t_jnp / m["s_per_run"]
    return fields, m


def run_mode(mode: str, device=None,
             jnp_timeout_s: float = JNP_TIMEOUT_S) -> Tuple[Dict, List[Dict]]:
    """Measure one mode of :data:`METRICS`; returns (the JSON line's dict,
    the timed calls' numbers).  On the card K1 is built first, so no
    timed call holds its build."""
    from mfcd_tpu_torch.backend import card_line, resolve_device
    from mfcd_tpu_torch.ops import _build

    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {name}; mode {mode}; torch {torch.__version__}")
    if dev.type == "cuda":
        t0 = time.perf_counter()
        _build.load("epoch_kernel.cu")
        log(f"K1 built in {time.perf_counter() - t0:.2f} s")
    fields: Dict = {}
    if mode in ("default", "quick"):
        m = measure_headline(dev, quick=mode == "quick")
        measured = [m]
        if mode == "default":
            fields, k10 = _kn_fields(10, dev, jnp_timeout_s, prefix="k10_")
            measured.append(k10)
    elif mode == "sweep":
        m = measure_sweep(dev)
        measured = [m]
    elif mode in ("k10", "k50"):
        fields, m = _kn_fields(int(mode[1:]), dev, jnp_timeout_s)
        measured = [m]
    else:
        raise ValueError(f"unknown mode {mode!r}; expected one of "
                         f"{sorted(METRICS)}")
    payload = {"metric": METRICS[mode], "value": m["runs_per_hour"],
               "unit": UNIT,
               "card": card_line() if dev.type == "cuda" else "cpu",
               **fields}
    return payload, measured


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    modes = ap.add_mutually_exclusive_group()
    for mode in ("quick", "sweep", "k10", "k50"):
        modes.add_argument(f"--{mode}", dest="mode", action="store_const",
                           const=mode)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the card")
    ap.add_argument("--jnp-timeout", type=float, default=JNP_TIMEOUT_S,
                    help="the autograd comparison's limit, s (0: skip it)")
    ap.add_argument("--_kn-jnp", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args._kn_jnp is not None:
        # The child of jnp_s_per_run: prints one float, s/run.
        with contextlib.redirect_stdout(sys.stderr):
            m = measure_kn(args._kn_jnp, False, args.device, warm_epochs=1)
        print(m["s_per_run"], flush=True)
        return 0
    with contextlib.redirect_stdout(sys.stderr):
        payload, _ = run_mode(args.mode or "default", args.device,
                              args.jnp_timeout)
    print(json.dumps(payload), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
