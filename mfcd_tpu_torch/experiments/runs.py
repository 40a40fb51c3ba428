"""Scripted equivalents of every ``Runs.ipynb`` sweep cell.

Counterpart of ``experiments/runs.py``: the same sweep functions, grids,
pickles and command line, on the port's scans.  Each function transcribes
one canonical experiment grid of the reference notebook (cells 3-23) with
the notebook's literal parameters — see PARITY.md for the cell-by-cell
audit table.  ``scale`` shrinks the matrix size so CI can run miniature
versions of the same sweeps; ``fast=True`` routes through the bucketed
engine (``parameter_scan_fast``), which ``strategies_p_sweep`` can shard
over a mesh of ranks (``mesh=``); the default is the sequential-compatible
``parameter_scan``.  ``device`` reaches whichever scan a sweep function
calls (``None``: the card).

Usage:
    python -m mfcd_tpu_torch.experiments.runs s_p_sweep --out Data_final/s_p.pkl
    python -m mfcd_tpu_torch.experiments.runs s_p_sweep --out s_p.pkl --scale 0.05 --device cpu
    python -m mfcd_tpu_torch.experiments.runs --list
"""

from __future__ import annotations

import argparse
import pickle
import sys

import numpy as np
import torch

from mfcd_tpu_torch.backend import resolve_device
from mfcd_tpu_torch.sweep.batched import parameter_scan_fast
from mfcd_tpu_torch.sweep.engine import parameter_scan
from mfcd_tpu_torch.sweep.ground_truth import parameter_scan_ground_truth


def _scan(fast, **kw):
    mesh = kw.pop("mesh", None)
    if fast:
        return parameter_scan_fast(mesh=mesh, **kw)
    if mesh is not None:
        raise ValueError("mesh-sharded execution requires fast=True")
    return parameter_scan(**kw)


def s_p_sweep(out=None, save_every=4, fast=False, scale=1.0, reps=5,
              resume=False, device=None):
    """Runs.ipynb cell 3: s x p (x weight_decay) at K=1, soft labels."""
    n = m = int(1000 * scale) or 10
    s_values = np.concatenate([
        np.logspace(-1, 1, 20),     # from 10^-1 to 10^1
        [1e-4, 1e-3, 1e-2],         # specific small values
        np.logspace(1, 2, 10),      # from 10^1 to 10^2
    ])
    return _scan(
        fast, n=n, m=m, d=2,
        p=[0.1, 0.15, 0.2, 0.25, 0.35, 0.5],
        K=[1],
        lr=[1e-3],
        s=list(s_values),
        weight_decay=[5e-6, 5e-3],
        num_epochs=30, reps=reps, linear=False, soft_label=True,
        save_path=out, save_every=save_every, resume=resume, device=device,
    )


def s_k_sweep(out=None, save_every=4, fast=False, scale=1.0, reps=5,
              resume=False, device=None):
    """Runs.ipynb cell 5: s x K (x weight_decay) at p=0.2, soft labels."""
    n = m = int(1000 * scale) or 10
    s_values = np.concatenate([
        np.logspace(-1, 1, 20),
        [1e-4, 1e-3, 1e-2],
        np.logspace(1, 3, 10),
    ])
    return _scan(
        fast, n=n, m=m, d=2, p=0.2,
        lr=1e-3,
        s=list(s_values),
        K=[1, 2, 4, 10, 50],
        weight_decay=[1e-6, 5e-6, 1e-5, 5e-5, 1e-4, 5e-4, 1e-3],
        num_epochs=30, reps=reps, linear=False, soft_label=True,
        save_path=out, save_every=save_every, resume=resume, device=device,
    )


def pk_const_sweep(out=None, save_every=4, fast=False, scale=1.0, reps=5,
                   resume=False, device=None):
    """Runs.ipynb cell 7: p*K held constant (linear scan), soft labels.

    The derived ``pxK`` parameter is patched into the saved params post-hoc,
    exactly as the notebook's enrichment step does.
    """
    n = m = int(1000 * scale) or 10
    s = [1.0, 3, 5, 8]
    target_constants = [0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4, 0.5, 1]
    possible_K = [1, 2, 3, 4, 5, 7, 10]
    p_values, K_values = [], []
    for c in target_constants:
        for K in possible_K:
            p = round(c / K, 5)
            if p <= 1:
                p_values.append(p)
                K_values.append(K)
    s_values = []
    for i in range(len(s)):
        s_values.extend([s[i]] * len(p_values))
    p_values = p_values * len(s)
    K_values = K_values * len(s)
    # Resume matching ignores the post-hoc pxK enrichment (non-PARAM_KEYS
    # entries are dropped by completed_param_sets), so the published pickle
    # keeps its enriched schema at all times — no in-place rewrite.
    results = _scan(
        fast, n=n, m=m, d=2, p=p_values, K=K_values, s=s_values,
        lr=0.001, weight_decay=1e-5, linear=True,
        num_epochs=30, reps=reps, soft_label=True,
        save_path=out, save_every=save_every, resume=resume, device=device,
    )
    if out:
        # The engine returns [] once everything is flushed to disk
        # (reference quirk); enrich the pickle in place like the notebook.
        with open(out, "rb") as f:
            results = pickle.load(f)
    for exp in results:
        exp["params"]["pxK"] = round(exp["params"]["p"] * exp["params"]["K"], 4)
    if out:
        with open(out, "wb") as f:
            pickle.dump(results, f)
    return results


def p_k_sweep(out=None, save_every=4, fast=False, scale=1.0, reps=5,
              resume=False, device=None):
    """Runs.ipynb cell 9: p x K at s=5, soft labels."""
    n = m = int(1000 * scale) or 10
    p_values = np.concatenate([
        np.logspace(-2, np.log10(0.2), 20),  # from 10^-2 to 0.2
        [1e-4, 5e-3, 1e-3, 0.5, 0.8],        # additional specific values
    ])
    return _scan(
        fast, n=n, m=m, d=2, p=list(p_values), K=[1, 2, 3, 5, 10], s=5.0,
        lr=0.001, weight_decay=1e-5,
        num_epochs=30, reps=reps, linear=False, soft_label=True,
        save_path=out, save_every=save_every, resume=resume, device=device,
    )


# Cell 11's (p, s) pair set, precomputed once with the reference's own
# float32 torch.arange semantics (see ps_const_pairs_derived, which
# re-derives it; a test asserts the two stay identical).  Baked as
# literals, as the JAX package's ``experiments/runs.py`` bakes them.
_PS_CONST_PAIRS = (
    (0.25, 2.0), (0.2, 2.5), (0.125, 4.0), (0.1, 5.0), (0.08, 6.25),
    (0.078, 6.41), (0.058, 8.62), (0.054, 9.26), (0.05, 10.0),
    (0.28, 1.25), (0.25, 1.4), (0.2, 1.75), (0.175, 2.0), (0.14, 2.5),
    (0.125, 2.8), (0.1, 3.5), (0.086, 4.07), (0.074, 4.73), (0.07, 5.0),
    (0.057, 6.14), (0.056, 6.25), (0.05, 7.0), (0.043, 8.14),
    (0.04, 8.75), (0.038, 9.21), (0.037, 9.46), (0.035, 10.0),
    (0.25, 1.0), (0.2, 1.25), (0.125, 2.0), (0.1, 2.5), (0.058, 4.31),
    (0.054, 4.63), (0.05, 5.0), (0.04, 6.25), (0.039, 6.41),
    (0.029, 8.62), (0.028, 8.93), (0.027, 9.26), (0.025, 10.0),
    (0.25, 0.8), (0.2, 1.0), (0.16, 1.25), (0.125, 1.6), (0.1, 2.0),
    (0.08, 2.5), (0.059, 3.39), (0.05, 4.0), (0.04, 5.0), (0.033, 6.06),
    (0.032, 6.25), (0.025, 8.0), (0.022, 9.09), (0.02, 10.0),
    (0.3, 0.4), (0.25, 0.48), (0.24, 0.5), (0.2, 0.6), (0.16, 0.75),
    (0.15, 0.8), (0.125, 0.96), (0.12, 1.0), (0.1, 1.2), (0.096, 1.25),
    (0.08, 1.5), (0.075, 1.6), (0.06, 2.0), (0.05, 2.4), (0.048, 2.5),
    (0.04, 3.0), (0.032, 3.75), (0.03, 4.0), (0.025, 4.8), (0.024, 5.0),
    (0.02, 6.0), (0.017, 7.06), (0.016, 7.5), (0.015, 8.0),
    (0.014, 8.57), (0.013, 9.23), (0.012, 10.0), (0.3, 0.5),
    (0.25, 0.6), (0.2, 0.75), (0.15, 1.0), (0.125, 1.2), (0.12, 1.25),
    (0.1, 1.5), (0.075, 2.0), (0.06, 2.5), (0.053, 2.83), (0.05, 3.0),
    (0.04, 3.75), (0.03, 5.0), (0.026, 5.77), (0.025, 6.0),
    (0.024, 6.25), (0.02, 7.5), (0.015, 10.0),
)


def ps_const_pairs():
    """Cell 11's arange-based (p, s) pair enumeration (99 pairs)."""
    p_values = [p for p, _ in _PS_CONST_PAIRS]
    s_values = [s for _, s in _PS_CONST_PAIRS]
    return p_values, s_values


def ps_const_pairs_derived():
    """Re-derive the cell-11 pairs with the reference's exact mechanism.

    The reference builds candidate grids with ``torch.arange`` (float32
    accumulation) and keeps pairs whose rounded p lands exactly in the
    rounded p-grid; reproducing the float32 semantics keeps the pair set
    identical."""
    possible_s = [round(s, 3) for s in torch.arange(0.02, 10.1, 0.01).tolist()]
    possible_p = [round(p, 5) for p in torch.arange(0.001, 0.301, 0.001).tolist()]
    target_constants = [0.5, 0.35, 0.25, 0.20, 0.12, 0.15]
    p_values, s_values = [], []
    for c in target_constants:
        for s in possible_s:
            p = round(c / s, 5)
            if p in possible_p:
                p_values.append(p)
                s_values.append(s)
    return p_values, s_values


def ps_const_sweep(out=None, save_every=4, fast=False, scale=1.0, reps=5,
                   resume=False, device=None):
    """Runs.ipynb cell 11: p*s held constant (linear scan), soft labels."""
    n = m = int(1000 * scale) or 10
    lr = [1e-3]
    p_values, s_values = ps_const_pairs()
    lr_values = []
    for i in range(len(lr)):
        lr_values.extend([lr[i]] * len(p_values))
    p_values = p_values * len(lr)
    s_values = s_values * len(lr)
    return _scan(
        fast, n=n, m=m, d=2, p=p_values, s=s_values, lr=lr_values,
        K=1, weight_decay=1e-5, linear=True,
        num_epochs=30, reps=reps, soft_label=True,
        save_path=out, save_every=save_every, resume=resume, device=device,
    )


def p_d_sweep(out=None, save_every=4, fast=False, scale=1.0, reps=5,
              resume=False, device=None):
    """Runs.ipynb cell 13: p x d at s=5."""
    n = m = int(1000 * scale) or 10
    return _scan(
        fast, n=n, m=m, s=5, K=1,
        p=[0.1, 0.2, 0.5, 0.8, 1.0],
        d=list(range(2, 11, 2)),
        lr=1e-3, weight_decay=1e-5,
        num_epochs=30, reps=reps,
        save_path=out, save_every=save_every, resume=resume, device=device,
    )


# Cell 16 (s-sweep) deliberately omits `random` and includes `cluster`;
# cell 18 (p-sweep) swaps `cluster` for `random`.
STRATEGIES_S_SWEPT = (
    "proximity", "margin", "variance", "popularity", "top_k", "cluster", "svd",
)
STRATEGIES_P_SWEPT = (
    "random", "proximity", "margin", "variance", "popularity", "top_k", "svd",
)


def strategies_s_sweep(out=None, save_every=5, fast=False, scale=1.0,
                       reps=3, strategies=STRATEGIES_S_SWEPT,
                       resume=False, device=None):
    """Runs.ipynb cell 16: 7 strategies x s (x wd), hard labels.

    The notebook writes one pickle per strategy
    (``run_vs_s_K1_{strategy}_wd_sweep.pkl``); with ``out`` set, this
    writes ``{out}_{strategy}.pkl`` files the same way.
    """
    n = m = int(1000 * scale) or 10
    scan_s = np.concatenate([
        np.logspace(-1, 1, 20),
        [1e-4, 1e-3, 1e-2],
        np.logspace(1, 4, 10),
    ])
    all_results = {}
    for strategy in strategies:
        path = f"{out}_{strategy}.pkl" if out else None
        all_results[strategy] = _scan(
            fast, n=n, m=m, d=2, p=0.2, lr=1e-3, K=1,
            s=list(scan_s),
            weight_decay=[1e-6, 1e-5, 1e-4],
            strategy=strategy, num_epochs=30, reps=reps,
            linear=False, soft_label=False,
            save_path=path, save_every=save_every, resume=resume,
            device=device,
        )
    return all_results


def strategies_p_sweep(out=None, save_every=5, fast=False, scale=1.0,
                       reps=3, strategies=STRATEGIES_P_SWEPT,
                       resume=False, mesh=None, device=None):
    """Runs.ipynb cell 18: 7 strategies x p at s=5, soft labels.

    ``mesh`` (requires ``fast=True``; ``sweep.batched.make_sweep_mesh``,
    every rank of the job calling this with the same arguments) shards
    every chunk over the ranks; rank 0 writes the pickles, the same bits
    as without a mesh (``mfcd_tpu_torch/scripts/validate_sharded_cell.py``
    checks it).  ``device`` defaults to the mesh's.
    """
    n = m = int(1000 * scale) or 10
    p_list = np.round(np.logspace(-2, np.log10(0.2), 20), 4).tolist()
    all_results = {}
    for strategy in strategies:
        path = f"{out}_{strategy}.pkl" if out else None
        all_results[strategy] = _scan(
            fast, n=n, m=m, d=2, p=p_list, s=5, K=1,
            lr=1e-3, weight_decay=1e-5,
            strategy=strategy, num_epochs=30, reps=reps,
            linear=False, soft_label=True,
            save_path=path, save_every=save_every, resume=resume,
            mesh=mesh, device=device,
        )
    return all_results


# Every non-"base" dispatch keyword of generate_x (reference
# structure.py:590-663).
GENERATIONS_SWEPT = (
    "gmm", "clustered", "low_rank", "structured", "svd", "correlated",
    "graph", "social", "temporal", "hierarchical",
)


def generation_s_sweep(out=None, save_every=5, fast=False, scale=1.0,
                       reps=3, generations=GENERATIONS_SWEPT, device=None):
    """Production-scale validation sweep over non-`base` generation modes
    (not a notebook cell — proves the jittable KMeans/EM/Watts-Strogatz
    generator paths under the real engine at n=1000; VERDICT r1 item 4).

    Runs with ``resume=True``: modes whose pickle already holds a
    configuration skip it, so interrupted or extended sweeps continue
    where they left off (partial pickles are completed, not trusted
    blindly)."""
    n = m = int(1000 * scale) or 10
    all_results = {}
    for generation in generations:
        path = f"{out}_{generation}.pkl" if out else None
        all_results[generation] = _scan(
            fast, n=n, m=m, d=2, p=0.2, lr=1e-3, K=1,
            s=list(np.logspace(-1, 1, 10)),
            weight_decay=1e-5,
            generation=generation, num_epochs=30, reps=reps,
            linear=False, soft_label=False,
            save_path=path, save_every=save_every,
            resume=path is not None, device=device,
        )
    return all_results


def gt_p_k_sweep(out=None, fast=False, scale=1.0, reps=5, device=None):
    """Runs.ipynb cell 21: ground-truth-only p x K scan."""
    n = m = int(1000 * scale) or 10
    results = parameter_scan_ground_truth(
        n=n, m=m, d=2, s=5,
        p=list(np.logspace(-4, 0, 30)), K=[10, 1], reps=reps, linear=False,
        device=device,
    )
    if out:
        with open(out, "wb") as f:
            pickle.dump(results, f)
    return results


def gt_d_s_sweep(out=None, fast=False, scale=1.0, reps=3, device=None):
    """Runs.ipynb cell 23: ground-truth-only d x s scan at p=0.5."""
    n = m = int(1000 * scale) or 10
    results = parameter_scan_ground_truth(
        n=n, m=m, p=0.5, d=[1, 2, 3, 4, 5, 6, 7], s=[1, 3, 9],
        K=1, linear=False, reps=reps, device=device,
    )
    if out:
        with open(out, "wb") as f:
            pickle.dump(results, f)
    return results


ALL = {
    fn.__name__: fn
    for fn in (
        s_p_sweep, s_k_sweep, pk_const_sweep, p_k_sweep, ps_const_sweep,
        p_d_sweep, strategies_s_sweep, strategies_p_sweep,
        generation_s_sweep, gt_p_k_sweep, gt_d_s_sweep,
    )
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("sweep", nargs="?", choices=sorted(ALL), default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fast", action="store_true",
                    help="bucketed engine (parameter_scan_fast)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="matrix-size scale factor (1.0 = n=m=1000)")
    ap.add_argument("--reps", type=int, default=None,
                    help="override the notebook's rep count")
    ap.add_argument("--resume", action="store_true",
                    help="keep existing pickles and skip completed "
                         "configurations (preemption/failure recovery)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "without one)")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    if args.list or not args.sweep:
        for name, fn in sorted(ALL.items()):
            print(f"{name:24s} {fn.__doc__.splitlines()[0]}")
        return 0
    # Resolve the device before committing to a long sweep: without a card
    # this raises at once.
    device = resolve_device(args.device)

    kw = dict(out=args.out, fast=args.fast, scale=args.scale, device=device)
    if args.reps is not None:
        kw["reps"] = args.reps
    if args.resume:
        import inspect

        if "resume" in inspect.signature(ALL[args.sweep]).parameters:
            kw["resume"] = True
    ALL[args.sweep](**kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
