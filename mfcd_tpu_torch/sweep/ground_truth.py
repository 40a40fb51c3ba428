"""Ground-truth (model-free) oracle paths.

Counterpart of ``mfcd_tpu/sweep/ground_truth.py``
(``evaluate_ground_truth`` / ``parameter_scan_ground_truth``, reference
``structure.py:1154-1269``): generate X, build a test split with the full
sampling/split/top-up pipeline, and evaluate the true matrix on it — the
Bayes-like accuracy ceiling per (s, p, d, K) that Runs.ipynb cells 21/23
sweep and plots overlay as the dashed GT line
(``visualization.py:1240-1253``).  No model is trained, so no epoch kernel
is launched.  ``device=None`` means the card; a missing card raises.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List

import torch

from mfcd_tpu_torch.backend import resolve_device
from mfcd_tpu_torch.core import prng, rng
from mfcd_tpu_torch.core.config import RunConfig, normalize_param
from mfcd_tpu_torch.data.btl import btl_label, sample_and_split
from mfcd_tpu_torch.eval.metrics import ground_truth_metrics
from mfcd_tpu_torch.genx import generate_x
from mfcd_tpu_torch.sweep.engine import compile_caps
from mfcd_tpu_torch.utils import observability as obs


def _gt_runs(cfg_key: torch.Tensor, s: float, cfg: RunConfig, t_cap: int,
             extra_cap: int, budget, extra_budget):
    """GT metrics ``(loss [R], accuracy [R])`` of the ``R = cfg.reps`` runs
    of a config key.  Only the labelled TEST split is built; the train/val
    label work of the full engine is never done here."""
    obs.count_runs(cfg.reps)
    with obs.stages() as stage:
        stage("mfcd.generate")
        streams = rng.rep_streams(rng.rep_keys(cfg_key, cfg.reps))
        x = generate_x(streams["x_gen"], cfg.n, cfg.m, cfg.d, cfg.generation)
        stage("mfcd.sample")
        splits = sample_and_split(
            streams, x, t_cap=t_cap, extra_cap=extra_cap,
            strategy=cfg.strategy, popularity_method=cfg.popularity_method,
            alpha=cfg.alpha, budget=budget, extra_budget=extra_budget)
        stage("mfcd.label")
        test = btl_label(streams["labels_test"], x, splits.test,
                         splits.test_count, s, cfg.K, soft_label=False)
        stage("mfcd.metrics")
        return ground_truth_metrics(x, test, cfg.batch_size)


def evaluate_ground_truth(
    n, m, p, d, s, device=None, K=1, reps=1, strategy="random",
    popularity_method="zipf", alpha=1.5, soft_label=False, generation="base",
    seed: int = 0, config_index: int = 0, pad_compiles: bool = True,
):
    """Returns ``(losses, accuracies)`` lists over repetitions
    (reference ``structure.py:1154-1200``).

    ``pad_compiles`` takes the power-of-two capacity bucket with the exact
    budget (``compile_caps``), as the JAX package does: the PRP bit widths
    follow from the capacities, so the splits are the JAX package's only
    with the same choice.  ``soft_label`` is accepted and ignored (the test
    split is always hard-labelled).  ``device`` places the run (``None``:
    the card)."""
    device = resolve_device(device)
    with obs.call("evaluate_ground_truth", device):
        cfg = RunConfig(
            n=int(n), m=int(m), d=int(d), p=float(p), s=float(s), K=int(K),
            reps=int(reps), strategy=strategy,
            popularity_method=popularity_method, alpha=float(alpha),
            soft_label=bool(soft_label), generation=generation,
        )
        sh = cfg.shapes()
        if pad_compiles:
            t_cap, extra_cap = compile_caps(cfg)
            shape_cfg = dataclasses.replace(cfg, s=0.0, p=0.0)
        else:
            t_cap, extra_cap = sh.num_triplets, sh.extra_test_triplets
            shape_cfg = dataclasses.replace(cfg, s=0.0)
        budget = extra_budget = None
        if (sh.num_triplets, sh.extra_test_triplets) != (t_cap, extra_cap):
            budgets = lambda v: torch.full((cfg.reps,), v, dtype=torch.int32,
                                           device=device)
            budget = budgets(sh.num_triplets)
            extra_budget = budgets(sh.extra_test_triplets)
        cfg_key = rng.config_key(prng.key(seed, device=device), config_index)
        losses, accs = _gt_runs(cfg_key, cfg.s, shape_cfg, t_cap, extra_cap,
                                budget, extra_budget)
        with obs.span("mfcd.export"):
            return ([float(x) for x in losses.cpu().numpy()],
                    [float(x) for x in accs.cpu().numpy()])


def parameter_scan_ground_truth(
    n, m, p, d, s, device=None, K=1, linear=False, reps=1, strategy="random",
    popularity_method="zipf", alpha=1.5, soft_label=False, generation="base",
    seed: int = 0,
) -> List[Dict[str, Any]]:
    """GT-only parameter sweep (reference ``structure.py:1203-1269``):
    same grid/linear scaffold, results ``{'gt_loss', 'gt_accuracy'}``.
    ``device`` reaches every configuration (``None``: the card)."""
    device = resolve_device(device)
    param_dict = {
        "n": n, "m": m, "p": p, "d": d, "s": s, "K": K, "strategy": strategy,
        "popularity_method": popularity_method, "alpha": alpha,
        "soft_label": soft_label, "generation": generation,
    }
    # NB: hand-rolled expansion (not SweepSpec) on purpose — the reference's
    # GT scan silently falls back to a full grid when linear lists are not
    # synchronized instead of raising (``structure.py:1254-1263``).
    param_dict = {k: normalize_param(v) for k, v in param_dict.items()}
    list_params = [v for v in param_dict.values() if isinstance(v, list)]
    synchronized = (
        len(list_params) <= 1
        or all(len(v) == len(list_params[0]) for v in list_params)
    )
    listified = {
        k: (v if isinstance(v, (list, tuple)) else [v])
        for k, v in param_dict.items()
    }

    if linear and synchronized:
        length = len(list_params[0]) if list_params else 1
        param_sets = [
            {k: (v[i] if len(v) > 1 else v[0]) for k, v in listified.items()}
            for i in range(length)
        ]
    else:
        param_sets = [
            dict(zip(listified.keys(), combo))
            for combo in itertools.product(*listified.values())
        ]

    with obs.call("parameter_scan_ground_truth", device):
        results = []
        for idx, params in enumerate(param_sets):
            gt_loss, gt_accuracy = evaluate_ground_truth(
                **params, device=device, reps=reps, seed=seed,
                config_index=idx)
            results.append({
                "params": params,
                "results": {"gt_loss": gt_loss, "gt_accuracy": gt_accuracy},
            })
        return results
