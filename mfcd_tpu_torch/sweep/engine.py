"""Experiment engine — ``run_experiment`` / ``parameter_scan``.

Counterpart of ``mfcd_tpu/sweep/engine.py`` (reference
``structure.py:81-450``).  Each configuration runs as plain function calls
over a leading run axis (configs x repetitions flattened): generate X ->
sample -> label -> pad -> train -> metrics -> export.  Training goes
through the fused-epoch CUDA kernel on the card when the shape fits it
(``default_use_kernel``), else through the eager trainer.

The ``{'params', 'results'}`` schema, grid/linear expansion, and
incremental pickle persistence follow the reference
(``structure.py:120-255``).  ``device=None`` means the card; a missing card
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mfcd_tpu_torch.backend import resolve_device
from mfcd_tpu_torch.core import prng, rng
from mfcd_tpu_torch.core.config import (TRAIN_RATIO, UNCAPPED_STRATEGIES,
                                        RunConfig, SweepSpec, _next_pow2)
from mfcd_tpu_torch.core.results import export_results
from mfcd_tpu_torch.data.btl import LabeledSplit, label_splits, sample_and_split
from mfcd_tpu_torch.eval.metrics import compute_all_metrics
from mfcd_tpu_torch.genx import generate_x
from mfcd_tpu_torch.models.mf import init_params
from mfcd_tpu_torch.ops.kernels import epoch_kernel_supported, min_cluster
from mfcd_tpu_torch.ops.shuffle import default_reshuffle_period
from mfcd_tpu_torch.train.kernel_trainer import train_runs_kernel
from mfcd_tpu_torch.train.trainer import _pad_last, train_model
from mfcd_tpu_torch.utils import observability as obs
from mfcd_tpu_torch.utils.io import (append_results, completed_param_sets,
                                     reset_save_path)

DEFAULT_SEED = 0


def compile_caps(cfg: RunConfig) -> tuple:
    """(t_cap, extra_cap): the power-of-two capacity bucket of a config.

    Capacities set the PRP bit widths (``prp.py:389``), so the port picks
    the same ones as the JAX package.  ``svd`` and ``user_similarity``
    always get exact capacities (``UNCAPPED_STRATEGIES``)."""
    sh = cfg.shapes()
    if cfg.strategy in UNCAPPED_STRATEGIES:
        return sh.num_triplets, sh.extra_test_triplets
    t_cap = _next_pow2(sh.num_triplets)
    extra_cap = (_next_pow2(sh.extra_test_triplets)
                 if sh.extra_test_triplets > 0 else 0)
    return t_cap, extra_cap


def _pad_rows(split: LabeledSplit, rows: int) -> LabeledSplit:
    """Pad a split's row axis (last dim) to ``rows``; counts unchanged."""
    pad = rows - split.u.shape[-1]
    return LabeledSplit(
        u=_pad_last(split.u, pad), i=_pad_last(split.i, pad),
        j=_pad_last(split.j, pad), z=_pad_last(split.z, pad),
        valid=_pad_last(split.valid, pad, False), count=split.count)


_printed_kernel_choices: set = set()


def default_use_kernel(cfg: RunConfig, device) -> bool:
    """The fused-epoch kernel trainer on CUDA when a run fits a cluster of
    at most 16 blocks (``ops.kernels.min_cluster``).

    Mirrors ``default_use_pallas``: decided from the shape alone, before any
    launch and without the card.  Printed once per process and decision,
    with the smallest cluster size that fits."""
    device = torch.device(device)
    floor = min_cluster(cfg.n, cfg.m, cfg.d, cfg.batch_size)
    use = floor is not None and device.type == "cuda"
    choice = (device.type, cfg.n, cfg.m, cfg.d, cfg.batch_size, use)
    if choice not in _printed_kernel_choices:
        _printed_kernel_choices.add(choice)
        print(f"mfcd_tpu_torch: trainer = "
              f"{'fused-epoch kernel' if use else 'eager'} on {device.type} "
              f"(n={cfg.n}, m={cfg.m}, d={cfg.d}, bs={cfg.batch_size}, "
              f"kernel fits: {floor is not None}"
              + (f", smallest C {floor}" if floor else "") + ")", flush=True)
    return use


def resolve_use_kernel(cfg: RunConfig, device,
                       use_kernel: Optional[bool]) -> bool:
    """``use_kernel`` as the entry points take it: ``None`` means
    :func:`default_use_kernel`; ``True`` at a shape the kernel does not fit
    raises ``ValueError``, and on the CPU runs the kernel trainer with the
    plain epoch; ``False`` means the eager trainer."""
    if use_kernel is None:
        return default_use_kernel(cfg, device)
    if use_kernel and not epoch_kernel_supported(cfg.n, cfg.m, cfg.d,
                                                 cfg.batch_size):
        raise ValueError(
            f"use_kernel=True, but the fused-epoch kernel does not fit "
            f"n={cfg.n}, m={cfg.m}, d={cfg.d}, batch_size={cfg.batch_size}")
    return bool(use_kernel)


def _train_rows(cfg: RunConfig, budgets, t_cap: int, r: int) -> List[int]:
    """Each run's training rows as the host plans them, from the bucket's
    triplet budgets (``[B]``, on the host): the sampler's 80 % split of a
    budget, in float32 as it computes it, at most the split's capacity,
    times K under hard labels.  A sampler that draws fewer triplets than
    its budget leaves fewer rows; the random sampler never does."""
    train = np.floor(np.float32(TRAIN_RATIO)
                     * np.asarray(budgets, np.float32)).astype(np.int64)
    train = np.minimum(train, int(TRAIN_RATIO * t_cap))
    k = 1 if cfg.soft_label else cfg.K
    return [int(t) * k for t in train for _ in range(r)]


def _run_bucket_device(cfg: RunConfig, cfg_keys: torch.Tensor, s, lr,
                       weight_decay, use_kernel: bool = False, caps=None,
                       budgets=None, extra_budgets=None) -> Dict:
    """[B] configs x [reps] repetitions of one shape; returns per-run
    metric tensors ``[B, reps, ...]``.

    ``cfg_keys`` ``[B, 2]``; ``s``, ``lr``, ``weight_decay``, ``budgets``,
    ``extra_budgets`` are ``[B]`` (numpy or tensors).  All runs share the
    device of ``cfg_keys``."""
    dev = cfg_keys.device
    b, r = cfg_keys.shape[0], cfg.reps
    runs = lambda v, dt: torch.as_tensor(
        np.asarray(v), dtype=dt, device=dev).repeat_interleave(r)

    sh = cfg.shapes()
    if caps is None:
        caps = (sh.num_triplets, sh.extra_test_triplets)
    t_cap, extra_cap = caps
    if budgets is None:
        budgets = np.full((b,), sh.num_triplets, np.int32)
    if extra_budgets is None:
        extra_budgets = np.full((b,), sh.extra_test_triplets, np.int32)
    if (np.all(np.asarray(budgets) == t_cap)
            and np.all(np.asarray(extra_budgets) == extra_cap)):
        budget = extra_budget = None
    else:
        budget = runs(budgets, torch.int32)
        extra_budget = runs(extra_budgets, torch.int32)

    obs.count_runs(b * r)
    with obs.stages() as stage:
        stage("mfcd.generate")
        rep_keys = rng.rep_keys(cfg_keys, r).reshape(b * r, 2)
        streams = rng.rep_streams(rep_keys)
        x = generate_x(streams["x_gen"], cfg.n, cfg.m, cfg.d, cfg.generation)

        stage("mfcd.sample")
        splits = sample_and_split(
            streams, x, t_cap=t_cap, extra_cap=extra_cap,
            strategy=cfg.strategy, popularity_method=cfg.popularity_method,
            alpha=cfg.alpha, budget=budget, extra_budget=extra_budget)
        params = init_params(streams["init"], cfg.n, cfg.m, cfg.d)

        stage("mfcd.label")
        s_runs = runs(s, torch.float32)
        train, val, test = label_splits(streams, x, splits, s_runs, cfg.K,
                                        cfg.soft_label)
        train = _pad_rows(train, _next_pow2(train.u.shape[-1]))
        val = _pad_rows(val, _next_pow2(val.u.shape[-1]))
        test = _pad_rows(test, _next_pow2(test.u.shape[-1]))

        stage("mfcd.train")
        period = default_reshuffle_period()
        lr_runs = runs(lr, torch.float32)
        wd_runs = runs(weight_decay, torch.float32)
        if use_kernel:
            params, tl, vl = train_runs_kernel(
                params, train, val, streams["epochs"], lr_runs, wd_runs,
                batch_size=cfg.batch_size, num_epochs=cfg.num_epochs,
                label_denom=cfg.K if cfg.soft_label else 1,
                reshuffle_period=period,
                train_rows=_train_rows(cfg, budgets, t_cap, r))
        else:
            params, tl, vl = train_model(
                params, train, val, streams["epochs"], lr_runs, wd_runs,
                batch_size=cfg.batch_size, num_epochs=cfg.num_epochs,
                reshuffle_period=period)

        stage("mfcd.metrics")
        metrics = compute_all_metrics(params, x, s_runs, test,
                                      streams["sample_rows"],
                                      batch_size=cfg.batch_size)
    metrics["train_losses"] = tl
    metrics["val_losses"] = vl
    metrics["sample_count"] = splits.sample.count
    return {k: v.reshape((b, r) + v.shape[1:]) for k, v in metrics.items()}


def run_config(cfg: RunConfig, seed: int = DEFAULT_SEED,
               config_index: int = 0, use_kernel: Optional[bool] = None,
               pad_compiles: bool = True, device=None) -> Dict[str, Any]:
    """Run one RunConfig; returns the reference results dict.

    ``pad_compiles=True`` rounds capacities up to the power-of-two buckets
    the JAX package compiles for (``compile_caps``), with the exact triplet
    budget kept, so results match it.  ``use_kernel``: see
    :func:`resolve_use_kernel`."""
    device = resolve_device(device)
    use_kernel = resolve_use_kernel(cfg, device, use_kernel)
    sh = cfg.shapes()
    caps = compile_caps(cfg) if pad_compiles else None
    cfg_key = rng.config_key(prng.key(seed, device=device), config_index)
    out = _run_bucket_device(
        dataclasses.replace(cfg, s=0.0, lr=0.0, weight_decay=0.0),
        cfg_key[None],
        np.asarray([cfg.s], np.float32), np.asarray([cfg.lr], np.float32),
        np.asarray([cfg.weight_decay], np.float32),
        use_kernel=use_kernel, caps=caps,
        budgets=np.asarray([sh.num_triplets], np.int32),
        extra_budgets=np.asarray([sh.extra_test_triplets], np.int32),
    )
    out = {k: v[0] for k, v in out.items()}
    with obs.span("mfcd.export"):
        counts = out.pop("sample_count").cpu().numpy()
        target = cfg.num_triplets
        for c in counts:
            if int(c) < target:
                print(f"⚠️ Only {int(c)} triplets generated for strategy: "
                      f"{cfg.strategy} (target={target})")
        return export_results(out)


def run_experiment(
    n, m, d, p, s, device=None, lr=1e-3, weight_decay=1e-5, reps=5,
    num_epochs=100, open_browser=False, K=1, d1=None, strategy="random",
    popularity_method="zipf", alpha=1.5, soft_label=False, generation="base",
    seed: int = DEFAULT_SEED, batch_size: int = 64, config_index: int = 0,
) -> Dict[str, Any]:
    """Signature-compatible entry point (reference ``structure.py:306``).

    ``device`` places the run (``None``: the card; ``"cpu"`` on request);
    ``open_browser`` is accepted and ignored."""
    device = resolve_device(device)
    cfg = RunConfig(
        n=int(n), m=int(m), d=int(d), p=float(p), s=float(s), lr=float(lr),
        weight_decay=float(weight_decay), num_epochs=int(num_epochs),
        reps=int(reps), K=int(K), d1=d1, strategy=strategy,
        popularity_method=popularity_method, alpha=float(alpha),
        soft_label=bool(soft_label), generation=generation,
        batch_size=int(batch_size),
    )
    with obs.call("run_experiment", device):
        return run_config(cfg, seed=seed, config_index=config_index,
                          device=device)


def parameter_scan(
    n=1000, m=1000, d=2, p=0.5, s=1.0, device=None,
    lr=1e-3, weight_decay=1e-5, num_epochs=30, reps=1, strategy="random",
    open_browser=False, linear=False, K=1, d1=None,
    save_path: Optional[str] = None, save_every: Optional[int] = None,
    popularity_method="zipf", alpha=1.5, soft_label=False, generation="base",
    seed: int = DEFAULT_SEED, batch_size: int = 64, resume: bool = False,
    pad_compiles: bool = True,
) -> List[Dict[str, Any]]:
    """Grid / linear hyperparameter scan (reference ``structure.py:81-255``).

    Every parameter may be a scalar or a list; ``linear=True`` zips
    equal-length lists instead of taking the Cartesian product.  Results are
    ``[{'params': ..., 'results': ...}]`` and are pickled every
    ``save_every`` experiments; a pre-existing ``save_path`` is removed at
    scan start, and (reference quirk) the returned list is empty when
    everything was flushed to disk.  ``resume=True`` keeps the file and
    skips configurations already recorded in it."""
    device = resolve_device(device)
    spec = SweepSpec(
        params={
            "n": n, "m": m, "d": d, "p": p, "lr": lr,
            "weight_decay": weight_decay, "num_epochs": num_epochs,
            "reps": reps, "s": s, "K": K, "d1": d1, "strategy": strategy,
            "popularity_method": popularity_method, "alpha": alpha,
            "soft_label": soft_label, "generation": generation,
        },
        linear=linear,
        batch_size=batch_size,
    )
    if linear and not spec.linear_possible():
        raise ValueError(
            "The linear scan is not possible because the parameters are "
            "not synchronized."
        )

    with obs.call("parameter_scan", device):
        done: List[Dict[str, Any]] = []
        if save_path:
            if resume:
                done = completed_param_sets(save_path)
                if done:
                    print(f"🔁 Resuming: {len(done)} experiments already in "
                          f"{save_path}")
            else:
                reset_save_path(save_path)

        all_results: List[Dict[str, Any]] = []
        for experiment_index, param_set in enumerate(spec.expand()):
            if param_set in done:
                continue
            print(f"\nRunning experiment with parameters: {param_set}")
            cfg = RunConfig(batch_size=batch_size, **param_set)
            results = run_config(cfg, seed=seed, config_index=experiment_index,
                                 pad_compiles=pad_compiles, device=device)
            all_results.append({"params": param_set, "results": results})

            if save_path and save_every and len(all_results) >= save_every:
                append_results(save_path, all_results)
                all_results = []

        if save_path and all_results:
            append_results(save_path, all_results)
            all_results = []

        return all_results
