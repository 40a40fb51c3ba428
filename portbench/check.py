"""Whether the calls the window drove gave the right answers.

Each checked call is worked out again by the cell's plain reference
(``reference/``, found by the configuration's name: ``spec.reference``)
from the call's seed and arguments, at the shapes its grid expands to,
and its results are compared key by key.  A key's gap in one run is the
norm of the difference over the norm of the reference's value (at least
``FLOOR`` times the root of its size); a key's gap is the worst over the
runs.  The
numbers compared:

- ``data_gap``: what the run draws before it trains: X*'s sampled rows and
  norm, the oracle's loss and accuracy on the labelled test split
  (generation, the sampler and its splits, the labels);
- ``val_gap``: the validation loss of every epoch (the fused epoch and the
  shuffles between epochs, through the state each epoch leaves, and the
  validation pass);
- ``result_gap``: every other result key computed from the trained factors
  (the metric block), over the runs whose model has not collapsed;
- ``oracle_gap``: the oracle's loss and accuracy, for its own entry.

A run collapses where weight decay shrinks U V^T below ``COLLAPSED`` of
X*'s norm (cell 3's wd = 5e-3 arm does at K = 1, and cell 5's wd of 1e-4
and up at K = 10): its factors are then rounding noise or a limit cycle
of Adam around zero, and every metric of them moves with the order of a
sum.  The epoch's train loss is not compared: it is a float32 sum of
1,250 step losses, whose order moves it by up to ~2e-5 in sound runs,
more than TF32 moves it (PERF.md).

A number over its limit (``limits/<cell>.json``), a missing number, or a
call that failed makes the run not correct.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence

import numpy as np

from portbench.reference.pipeline import Shape
from portbench.workload import STUDY_PARAMS

FLOOR = 1e-3
COLLAPSED = 1e-2
DATA_KEYS = ("sampled_X_rows", "norm_X", "gt_log_likelihoods", "gt_accuracy")
CURVE_KEYS = ("val_losses",)
UNCOMPARED = ("train_losses",)
ORACLE_KEYS = ("gt_loss", "gt_accuracy")
# The oracle's scan expands its grid in its own order.
ORACLE_PARAMS = ("n", "m", "p", "d", "s", "K", "strategy",
                 "popularity_method", "alpha", "soft_label", "generation")


def key_gap(prog, ref, keep=None) -> float:
    """The worst over the runs ``keep`` names (all by default) of
    ||prog - ref|| / max(||ref||, FLOOR sqrt(size)); 1.0 where the shapes
    differ (a row kept on one side only)."""
    if len(prog) != len(ref):
        return 1.0
    worst = 0.0
    for k, (a, b) in enumerate(zip(prog, ref)):
        if keep is not None and not keep[k]:
            continue
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        if a.shape != b.shape:
            return 1.0
        if b.size:
            scale = max(float(np.linalg.norm(b)), FLOOR * np.sqrt(b.size))
            worst = max(worst, float(np.linalg.norm(a - b)) / scale)
    return worst


def collapsed(res) -> np.ndarray:
    """Runs whose model holds less than ``COLLAPSED`` of X*'s norm: weight
    decay has shrunk U V^T to rounding noise, whose metrics any order of
    sums changes."""
    return np.asarray(res["norm_ratio"], np.float64) < COLLAPSED


def key_gaps(prog: List[Dict], ref: List[Dict]) -> Dict[str, float]:
    """Each compared result key's gap, the worst over configurations paired
    in order; None where the configurations or their keys do not pair.
    Keys computed from the trained factors leave out the runs the
    reference finds collapsed."""
    if len(prog) != len(ref) or any(set(p) != set(r)
                                    for p, r in zip(prog, ref)):
        return None
    out: Dict[str, float] = {}
    for p, r in zip(prog, ref):
        alive = ~collapsed(r)
        for key in p:
            if key in UNCOMPARED:
                continue
            keep = None if key in DATA_KEYS + CURVE_KEYS else alive
            out[key] = max(out.get(key, 0.0), key_gap(p[key], r[key], keep))
    return out


def study_numbers(prog: List[Dict], ref: List[Dict]) -> Dict[str, float]:
    """The three gaps over configurations' result dicts, paired in order."""
    out = {"data_gap": 0.0, "val_gap": 0.0, "result_gap": 0.0}
    gaps = key_gaps(prog, ref)
    if gaps is None:
        return {k: float("inf") for k in out}
    for key, gap in gaps.items():
        name = ("data_gap" if key in DATA_KEYS else
                "val_gap" if key in CURVE_KEYS else "result_gap")
        out[name] = max(out[name], gap)
    return out


def oracle_numbers(prog: List[Dict], ref: List[Dict]) -> Dict[str, float]:
    gap = 0.0
    if len(prog) != len(ref):
        return {"oracle_gap": float("inf")}
    for p, r in zip(prog, ref):
        for key in ORACLE_KEYS:
            gap = max(gap, key_gap([p[key]], [r[key]]))
    return {"oracle_gap": gap}


def shape_of(conf: dict, args: dict, config: dict) -> Shape:
    """The shape of one configuration of a call, as the program expanded
    it (``conf``, one of :func:`_grid`'s dicts): its sizes and settings,
    the call's batch size (the program's default, 64, where the call
    gives none), and from the configuration file only the epoch period of
    fresh shuffles, which the program takes from its environment."""
    return Shape(n=conf["n"], m=conf["m"], d=conf["d"], p=conf["p"],
                 K=conf["K"], num_epochs=conf.get("num_epochs", 1),
                 batch_size=int(args.get("batch_size", 64)),
                 reshuffle_period=int(config["reshuffle_period"]),
                 soft_label=bool(conf.get("soft_label", False)),
                 strategy=conf.get("strategy", "random"),
                 generation=conf.get("generation", "base"),
                 popularity_method=conf.get("popularity_method"),
                 alpha=conf.get("alpha"), d1=conf.get("d1"))


def _grid(args: dict, order: Sequence[str] = STUDY_PARAMS) -> List[dict]:
    """The configurations of a scan call, in the order the entry expands
    its grid (the first parameter of ``order`` slowest)."""
    keys = [k for k in order if k in args]
    lists = [args[k] if isinstance(args[k], list) else [args[k]]
             for k in keys]
    return [dict(zip(keys, c)) for c in itertools.product(*lists)]


def reference_results(pipe, entry: str, args: dict, config: dict
                      ) -> List[Dict]:
    """The reference's results for one call of an entry: one dict a
    configuration, in the call's order.  ``pipe`` is the cell's reference
    (``spec.Cell.reference``) at its precision.  The configurations of one
    shape are worked out side by side, one shape after another.  Calls are
    worked out one at a time, at the shapes the program ran them with: a
    reference batched over calls rounds its batched linear algebra
    otherwise, which ``svd_error_scaled``'s cancellation reads at 1e-3
    (PERF.md)."""
    oracle = entry == "parameter_scan_ground_truth"
    if not oracle and entry not in ("parameter_scan", "parameter_scan_fast"):
        raise ValueError(f"no reference for entry {entry!r}")
    grid = _grid(args, ORACLE_PARAMS if oracle else STUDY_PARAMS)
    groups: Dict[Shape, List[int]] = {}
    for c, conf in enumerate(grid):
        groups.setdefault(shape_of(conf, args, config), []).append(c)
    out: List[Dict] = [None] * len(grid)
    for sh, idx in groups.items():
        seeds = [args["seed"]] * len(idx)
        col = lambda key: [float(grid[c][key]) for c in idx]
        if oracle:
            loss, acc = pipe.oracle_runs(seeds, idx, col("s"), args["reps"],
                                         sh)
            got = [{"gt_loss": lo, "gt_accuracy": ac}
                   for lo, ac in zip(loss, acc)]
        else:
            got = pipe.study_runs(seeds, idx, col("s"), col("lr"),
                                  col("weight_decay"), args["reps"], sh)
        for c, res in zip(idx, got):
            out[c] = res
    return out


def numbers_against(entry: str, results: List[Dict], ref: List[Dict]
                    ) -> Dict[str, float]:
    """The numbers of one call: its results (the entry's list of
    ``{'params', 'results'}``) against the reference's."""
    prog = [r["results"] for r in results]
    if entry == "parameter_scan_ground_truth":
        return oracle_numbers(prog, ref)
    return study_numbers(prog, ref)


def numbers(pipe, entry: str, checked: Sequence, config: dict
            ) -> Dict[str, float]:
    """The worst of each number over the checked calls, each given as
    (call arguments, the program's results)."""
    worst: Dict[str, float] = {}
    for args, results in checked:
        ref = reference_results(pipe, entry, args, config)
        got = numbers_against(entry, results, ref)
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), float(v))
    return worst


def verdict(nums: Dict[str, float], limits: Dict[str, float],
            failed: int) -> bool:
    """Correct: no failed call, and every limited number present and at or
    under its limit."""
    return failed == 0 and all(
        k in nums and np.isfinite(nums[k]) and nums[k] <= lim
        for k, lim in limits.items())

