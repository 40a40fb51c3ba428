"""Time the 1-deep chunk pipeline (``MFCD_PIPELINE``) off and on, on the card.

    python3 -m mfcd_tpu_torch.scripts.profile_pipeline_ab [--max-bucket K]
        [--pairs N] [--record]

Runs ``bench.py``'s sweep grid (20 s values x 2 weight decays x 3 reps at
n = m = 1000, d = 2, p = 0.2, 30 epochs) through ``parameter_scan_fast``
with the pickle protocol, once to warm up, then ``--pairs`` pairs of
passes with the pipeline off and on (off first in even pairs, on first in
odd ones), and reports each pass's s/run and each side's median.
``--max-bucket`` caps the configurations per chunk (default: the scan's
own choice; with one chunk nothing can overlap).  Reports whether every
pass left the same pickle, byte for byte.

The verdict is on only where the gain stands clear of the spread: the on
pass wins at least 9 in 10 of the pairs, and the medians lie further apart
than the off passes' interquartile range.  With ``--record`` (which needs
at least 10 pairs) the verdict is written as the card's decision artifact
(``docs/decisions_cuda/pipeline.json``); without it nothing is written.
Prints one JSON object as its last line, with the card's name and power
limit.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

GRID = dict(n=1000, m=1000, d=2, p=0.2, s=list(np.logspace(-1, 1, 20)),
            weight_decay=[5e-6, 5e-4], num_epochs=30, reps=3)
RUNS = 20 * 2 * 3
MIN_PAIRS = 10       # fewest pairs a recorded verdict rests on
MIN_WIN_SHARE = 0.9  # share of the pairs the on pass must win


def run_once(pipeline: bool, save_path: str, max_bucket) -> float:
    """Seconds for one pass of the grid with the pipeline ``pipeline``."""
    from mfcd_tpu_torch.sweep.batched import parameter_scan_fast

    os.environ["MFCD_PIPELINE"] = "1" if pipeline else "0"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parameter_scan_fast(save_path=save_path, save_every=4,
                        max_bucket=max_bucket, **GRID)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def verdict(off_s, on_s) -> dict:
    """The evidence for the pipeline from the passes of each side, pair by
    pair in order: medians as s/run, the pairs the on pass won, the off
    passes' interquartile range, and ``enable``, which holds only where
    there are at least ``MIN_PAIRS`` pairs, the on pass wins at least
    ``MIN_WIN_SHARE`` of them and the medians lie further apart than that
    range."""
    off, on = float(np.median(off_s)), float(np.median(on_s))
    q1, q3 = np.percentile(off_s, [25, 75])
    wins = int(sum(b < a for a, b in zip(off_s, on_s)))
    return {"off_s_per_run": off / RUNS, "on_s_per_run": on / RUNS,
            "speedup": off / on, "on_wins": wins, "pairs": len(off_s),
            "off_iqr_s": float(q3 - q1),
            "enable": bool(len(off_s) >= MIN_PAIRS
                           and wins >= MIN_WIN_SHARE * len(off_s)
                           and off - on > q3 - q1),
            "rule": f"enable iff >= {MIN_PAIRS} pairs, the on pass wins "
                    f">= {MIN_WIN_SHARE} of them and median off - median "
                    "on > the off passes' IQR"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--max-bucket", type=int, default=None)
    parser.add_argument("--pairs", type=int, default=MIN_PAIRS)
    parser.add_argument("--record", action="store_true")
    args = parser.parse_args(argv)
    if args.record and args.pairs < MIN_PAIRS:
        parser.error(f"--record needs --pairs >= {MIN_PAIRS}")
    if not torch.cuda.is_available():
        print("profile_pipeline_ab: no CUDA device", file=sys.stderr)
        return 2
    from mfcd_tpu_torch.backend import card_line
    from mfcd_tpu_torch.core.decisions import record_decision

    card = card_line()
    times = {False: [], True: []}
    with tempfile.TemporaryDirectory(prefix="mfcd_pipeline_ab_") as tmp:
        warm = run_once(False, os.path.join(tmp, "warm.pkl"),
                        args.max_bucket)
        print(f"warm-up: {warm:.3f} s", file=sys.stderr, flush=True)
        pickles = []
        order = [on for k in range(args.pairs)
                 for on in ((False, True) if k % 2 == 0 else (True, False))]
        for k, pipeline in enumerate(order):
            path = os.path.join(tmp, f"pass{k}.pkl")
            dt = run_once(pipeline, path, args.max_bucket)
            times[pipeline].append(dt)
            with open(path, "rb") as f:
                pickles.append(f.read())
            print(f"pipeline {'on' if pipeline else 'off'}, pass {k}: "
                  f"{dt:.3f} s ({dt / RUNS:.4f} s/run)", file=sys.stderr,
                  flush=True)
    os.environ.pop("MFCD_PIPELINE", None)
    same = all(p == pickles[0] for p in pickles[1:])
    evidence = verdict(times[False], times[True])
    out = dict(evidence, passes={"off": times[False], "on": times[True]},
               max_bucket=args.max_bucket, same_pickles=same, card=card,
               recorded=None)
    if args.record:
        out["recorded"] = record_decision(
            "pipeline", evidence["enable"], dict(
                evidence, max_bucket=args.max_bucket,
                grid="bench --sweep (20 s x 2 wd x 3 reps, n=m=1000)"),
            device="cuda")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
