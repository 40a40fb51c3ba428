"""Whole-cell sharded-against-unsharded pickle equality, over N ranks.

    python3 -m mfcd_tpu_torch.scripts.validate_sharded_cell [--ranks N]
        [--scale 0.1] [--reps 3] [--strategies random,margin]
        [--device cpu|cuda] [--backend gloo|nccl] [--out-dir DIR] [--timeout S]

Counterpart of ``scripts/validate_sharded_cell.py``.  Runs the notebook's
cell 18 (``experiments.runs.strategies_p_sweep``: the strategies x 20 p
values x reps, fast path) twice through the port, with the incremental
pickle protocol:

1. sharded: N ranks of one ``torch.distributed`` job
   (``parallel.multihost.launch``; default one rank per card under NCCL,
   ``--device cpu`` gloo), each chunk over ``make_sweep_mesh()``; rank 0
   writes the pickles;
2. unsharded: the same grid with ``mesh=None``, on rank 0 after the
   sharded pass;

then checks that the two pickles hold the same param dicts in the same
order and that all 23 result keys are bit-equal per configuration (on the
card, the metric block's keys that round by the run count of a call,
``dryrun_multichip.ROUNDED_KEYS``, within its bound).  Prints one line per
strategy and a last ``PASS`` line; exits non-zero on any difference.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile
import time
from typing import List, Sequence


def _load(path: str) -> list:
    with open(path, "rb") as f:
        return pickle.load(f)


def validate(out_dir: str, scale: float, reps: int,
             strategies: Sequence[str], device: str) -> List[str]:
    """Every rank's part: the sharded cell, then (rank 0) the unsharded
    one and the comparison; returns rank 0's lines."""
    import torch.distributed as dist

    from mfcd_tpu_torch.experiments.runs import strategies_p_sweep
    from mfcd_tpu_torch.scripts.dryrun_multichip import compare_results
    from mfcd_tpu_torch.sweep.batched import make_sweep_mesh

    mesh = make_sweep_mesh(device=device)
    t0 = time.perf_counter()
    strategies_p_sweep(out=os.path.join(out_dir, "sharded"), fast=True,
                       scale=scale, reps=reps, strategies=strategies,
                       mesh=mesh)
    t_sharded = time.perf_counter() - t0
    if dist.get_rank() != 0:
        return []
    t0 = time.perf_counter()
    strategies_p_sweep(out=os.path.join(out_dir, "single"), fast=True,
                       scale=scale, reps=reps, strategies=strategies,
                       device=device)
    t_single = time.perf_counter() - t0
    lines, n_cfg = [], 0
    for strategy in strategies:
        sh = _load(os.path.join(out_dir, f"sharded_{strategy}.pkl"))
        si = _load(os.path.join(out_dir, f"single_{strategy}.pkl"))
        if not sh:
            raise AssertionError(f"{strategy}: an empty pickle")
        if [e["params"] for e in sh] != [e["params"] for e in si]:
            raise AssertionError(f"{strategy}: the param dicts differ")
        gaps = compare_results([e["results"] for e in sh],
                               [e["results"] for e in si], strategy,
                               card=mesh.device.type == "cuda")
        gaps = {k: v for k, v in gaps.items() if v}
        n_cfg += len(sh)
        lines.append(f"{strategy}: {len(sh)} configs sharded == unsharded "
                     + ("(bit-exact, all result keys)" if not gaps else
                        "(bit-exact but " + ", ".join(
                            f"{k} within {v:.3g}"
                            for k, v in sorted(gaps.items())) + ")"))
    lines.append(f"PASS: {n_cfg} configs x {reps} reps across "
                 f"{len(strategies)} strategies on {mesh.size} ranks "
                 f"({dist.get_backend()}, {device}); sharded "
                 f"{t_sharded:.1f} s, unsharded {t_single:.1f} s")
    return lines


def main(argv=None) -> int:
    import torch

    from mfcd_tpu_torch.experiments.runs import STRATEGIES_P_SWEPT
    from mfcd_tpu_torch.parallel import multihost

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks (default: the card count)")
    ap.add_argument("--scale", type=float, default=0.1,
                    help="matrix-size scale (1.0 = the notebook's n=m=1000)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--strategies", default=None,
                    help="comma list; default = the full cell-18 seven")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="default: nccl on the card, gloo on the CPU")
    ap.add_argument("--timeout", type=float,
                    default=multihost.JOIN_TIMEOUT_S,
                    help="seconds before the ranks are stopped")
    ap.add_argument("--out-dir", default=None,
                    help="where the pickles go (default: a temporary "
                         "folder, removed at the end)")
    args = ap.parse_args(argv)
    strategies = (tuple(args.strategies.split(",")) if args.strategies
                  else STRATEGIES_P_SWEPT)
    ranks = args.ranks or (torch.cuda.device_count()
                           if args.device == "cuda" else 2)
    with tempfile.TemporaryDirectory(prefix="mfcd_sharded_cell_") as tmp:
        out_dir = args.out_dir or tmp
        os.makedirs(out_dir, exist_ok=True)
        outs = multihost.launch(
            validate, ranks, args=(out_dir, args.scale, args.reps,
                                   strategies, args.device),
            device=args.device, backend=args.backend,
            timeout_s=args.timeout)
    for line in outs[0]:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
