"""One whole experiment at n = m = 10,000, timed, on the card.

    python3 -m mfcd_tpu_torch.scripts.scale_demo [--n 10000] [--p 0.02]
        [--epochs 30] [--strategy random] [--device cuda|cpu] [--smoke]

Counterpart of ``scripts/scale_demo.py``.  Runs the complete pipeline
(generate X*, sample triplets, BTL-label, split, Adam training, the 23
metrics) through ``sweep.engine.run_config`` at n = m = 10,000, d = 2,
p = 0.02: 1,000,000 triplets, 800,000 training rows, 12,500 steps an
epoch, 30 epochs.  Two calls, at seeds 11 and 12: the first wall, and the
second (steady) one.  At that shape the engine trains with the fused-epoch
kernel K1 on clusters of blocks (``ops.kernels.min_cluster``: C >= 4).

Prints one JSON line: the JAX script's keys (``metric``, ``value`` the
steady wall in seconds, ``first_call_s``, ``accuracy``, ``gt_accuracy``,
``reconstruction_error_scaled``), and the trainer the engine chose, K1's
launch shape and smallest cluster size, K1's launches per call, peak
device memory over both calls, and the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
them; null on the CPU).  ``--smoke``: n = m = 128, p = 0.05, 2 epochs,
for the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

SEEDS = (11, 12)
SMOKE = dict(n=128, p=0.05, epochs=2)


def run(n: int = 10_000, p: float = 0.02, epochs: int = 30,
        strategy: str = "random", device="cuda"):
    """The two calls; returns (the JSON line's dict, the second call's
    results)."""
    from mfcd_tpu_torch.backend import card_line, resolve_device
    from mfcd_tpu_torch.core.config import RunConfig
    from mfcd_tpu_torch.ops import kernels
    from mfcd_tpu_torch.sweep.engine import default_use_kernel, run_config

    dev = resolve_device(device)
    card = dev.type == "cuda"
    cfg = RunConfig(n=n, m=n, d=2, p=p, s=5.0, lr=1e-3, weight_decay=1e-5,
                    num_epochs=epochs, reps=1, strategy=strategy)
    sh = cfg.shapes()
    print(f"n=m={n} p={p}: {cfg.num_triplets:,} triplets, "
          f"{sh.train_rows:,} train rows, {epochs} epochs",
          file=sys.stderr, flush=True)
    use_kernel = default_use_kernel(cfg, dev)
    if card:
        torch.cuda.reset_peak_memory_stats(dev)
    walls, launches = [], []
    for seed in SEEDS:
        before = kernels.EPOCH_LAUNCHES
        t0 = time.perf_counter()
        res = run_config(cfg, seed=seed, device=dev)
        if card:
            torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
        launches.append(kernels.EPOCH_LAUNCHES - before)
    floor = kernels.min_cluster(n, n, cfg.d, cfg.batch_size)
    cluster = (kernels.cluster_size(cfg.reps, n, n, cfg.d, cfg.batch_size,
                                    dev) if use_kernel else None)
    line = {
        "metric": f"scale_demo_full_run_seconds_{n}x{n}",
        "value": walls[1],
        "unit": "s/run (steady state)",
        "first_call_s": walls[0],
        "accuracy": res["accuracy"],
        "gt_accuracy": res["gt_accuracy"],
        "reconstruction_error_scaled": res["reconstruction_error_scaled"],
        "trainer": "fused-epoch kernel" if use_kernel else "eager",
        "cluster": cluster,
        "smallest_cluster": floor,
        "k1_launches": launches,
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if card else None,
        "device": torch.cuda.get_device_name(dev) if card else "cpu",
        "card": card_line() if card else None,
    }
    return line, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--p", type=float, default=0.02)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--strategy", default="random")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes (the CPU)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.n, args.p, args.epochs = SMOKE["n"], SMOKE["p"], SMOKE["epochs"]
    line, _ = run(args.n, args.p, args.epochs, args.strategy, args.device)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
