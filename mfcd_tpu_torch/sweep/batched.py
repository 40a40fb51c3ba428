"""Batched sweep execution — ``run_bucket`` / ``parameter_scan_fast``.

Counterpart of ``mfcd_tpu/sweep/batched.py``.  Where ``parameter_scan``
runs one configuration at a time, this module runs a whole *shape bucket*
of configurations (``bucket_by_shape``) together: their configs x reps runs
share one ``_run_bucket_device`` call, so each training epoch is one
fused-epoch kernel launch over all of them (one thread block per run).
Per-run values (s, lr, weight_decay, the exact triplet budget) vary inside
a bucket; only shape-changing parameters split buckets.  Run keys are
folded from the global config index, so results do not depend on how the
grid was bucketed or chunked.

``mesh=`` (:func:`make_sweep_mesh`, a 1-D ``("grid",)`` mesh over the
ranks of a ``torch.distributed`` job, ``parallel/``) shards each chunk over
the ranks, as the JAX package shards it over devices: every rank calls the
scan with the same arguments, pads the chunk to a multiple of the rank
count by repeating its last configuration, runs its contiguous block of
it, and gathers every rank's results, so each rank returns the whole list
(the padding dropped).  The chunks are the ones an unsharded scan runs, so
results and the pickle are the same bits; only rank 0 writes it.  The
ranks agree on a chunk's failure before any of them bisects it.  Every
collective runs in chunk order.

Not ported: the TPU-transport retries and compile-cache purge
(``ROADMAP.md``).  The phases are stage spans (``utils/observability``):
``mfcd.sweep.dispatch``, ``mfcd.sweep.collect`` (the copy to the host),
``mfcd.sweep.gather`` (the ranks' results, under a mesh),
``mfcd.sweep.export``, ``mfcd.sweep.persist``.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from mfcd_tpu_torch.backend import resolve_device
from mfcd_tpu_torch.core import prng, rng
from mfcd_tpu_torch.core.config import (TRAIN_RATIO, RunConfig, SweepSpec,
                                        _next_pow2, bucket_by_shape)
from mfcd_tpu_torch.core.results import export_results
from mfcd_tpu_torch.parallel.mesh import Mesh
from mfcd_tpu_torch.sampling import dedup, prp, strategies
from mfcd_tpu_torch.sweep.engine import (DEFAULT_SEED, _run_bucket_device,
                                         compile_caps, resolve_use_kernel)
from mfcd_tpu_torch.utils import observability as obs
from mfcd_tpu_torch.utils.io import (append_results, completed_param_sets,
                                     reset_save_path)

# Per-run device bytes of a bucket, by what the port allocates (see
# ``default_max_bucket``).
_NM_PLANES = 12          # live n x m float32-sized planes at the metrics peak
_TRAIN_ROW_BYTES = 85    # split 17 + packed stream 4 + 8 int64 shuffle temps
_EVAL_ROW_BYTES = 17     # u, i, j int32 + label float32 + valid bool
_VOTE_BYTES = 56         # soft labels: per vote of a training triplet, the
                         # threefry hash's int64 words at its peak
_SAMPLE_SLOT_BYTES = 64  # prefix sampler: 8 int64 temporaries per slot
_DISTINCT_BYTES = 96     # margin: PRP temporaries, candidates, split ranks
_OVERDRAW_BYTES = 128    # candidates, int64 draws and keys, hash slots
_ATTEMPT_BYTES = 96      # user_similarity outputs and split ranks per attempt
_US_POS_BYTES = 26       # per (rank, attempt, top-set position) of a block
_US_RANK_BYTES = 40      # per (rank, attempt): cascade slots, tags, masks
_ADJ_BYTES = 5           # graph, social: per n x n entry, bool + float32 copy
_SVD_F64_NM_PLANES = 3   # svd: float64 scores, the solver's copy, workspace
_CLUSTERED_NM_PLANES = 5 # clustered: k-means temporaries over [m, n] items
                         # and the shifted copies of X
_GMM_POINT_BYTES = 64    # gmm: per (component, point, dim) of the EM step
CPU_BUDGET_BYTES = 2e9   # the JAX package's working budget, for the CPU


def _is_oom(err: BaseException) -> bool:
    """A device out-of-memory: torch's own error, or one whose message says
    so (a launch the allocator could not serve).  Deterministic for a given
    chunk size, so the answer is bisection, not a retry."""
    return (isinstance(err, torch.cuda.OutOfMemoryError)
            or "out of memory" in str(err).lower())


def make_sweep_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A 1-D ``("grid",)`` mesh over every rank of the job, on this rank's
    ``device`` (``None``: its card), for experiment-level DP.
    ``n_devices`` other than the job's rank count raises."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"Need {n_devices} ranks, the job has {world}")
    return Mesh.create((world,), ("grid",), device)


def _mesh_device(mesh: Mesh, device) -> torch.device:
    """The mesh's device; ``device``, where given, must name it."""
    if device is not None:
        asked = resolve_device(device)
        if asked.type != mesh.device.type or asked.index not in (
                None, mesh.device.index):
            raise ValueError(f"device {asked} is not the mesh's "
                             f"{mesh.device}")
    return mesh.device


_OK, _OOM, _FAILED = 0, 1, 2


def _gather(mesh: Mesh, host: Optional[Dict[str, torch.Tensor]],
            err: Optional[BaseException]) -> Dict[str, torch.Tensor]:
    """Every rank's block of a chunk, in rank order.  First the ranks
    agree: if the chunk failed on any, every rank raises, its own error or
    else an OOM where the worst was an OOM (so every rank bisects), else a
    failure.  A rank that bisected alone would wait in a gather no other
    rank joins."""
    code = _OK if err is None else _OOM if _is_oom(err) else _FAILED
    flag = torch.tensor([code], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    worst = int(flag.item())
    if worst != _OK:
        if err is not None and code == worst:
            raise err
        if worst == _OOM:
            raise RuntimeError("out of memory on another rank of the mesh")
        raise RuntimeError("the chunk failed on a rank of the mesh") from err
    with obs.span("mfcd.sweep.gather"):
        blocks = [None] * mesh.size
        dist.all_gather_object(blocks, host)
        return {k: torch.cat([blk[k] for blk in blocks]) for k in blocks[0]}


def run_bucket(
    cfg: RunConfig,
    hyper_rows: Sequence[Dict[str, float]],
    config_indices: Sequence[int],
    seed: int = DEFAULT_SEED,
    caps=None,
    bucket_configs: Optional[Sequence[RunConfig]] = None,
    device=None,
    mesh: Optional[Mesh] = None,
    use_kernel: Optional[bool] = None,
) -> List[Dict[str, Any]]:
    """Run a same-shape bucket of configurations on ``device``; returns one
    reference results dict per configuration, in bucket order.  Under a
    ``mesh`` (on its device) this rank runs its block of the bucket,
    padded to a multiple of the rank count, and gathers the rest.

    ``hyper_rows`` carries ``{'s', 'lr', 'weight_decay'}`` per
    configuration and ``config_indices`` their global experiment indices
    (the keys are folded from them).  With ``caps`` (a ``(t_cap,
    extra_cap)`` capacity bucket) and ``bucket_configs`` (the per-row
    RunConfigs), configurations differing only in sparsity share the
    bucket, each with its exact triplet budget.  ``use_kernel`` is the
    JAX package's ``use_pallas``: ``None`` the shape's default trainer,
    ``True`` the fused-epoch kernel trainer (raises where the kernel does
    not fit), ``False`` the eager trainer
    (:func:`~mfcd_tpu_torch.sweep.engine.resolve_use_kernel`).

    An error of the runs or of the copy to the host raises at once;
    under a mesh the ranks first agree on it (:func:`_gather`), so every
    rank raises."""
    b = len(hyper_rows)
    shs = ([c.shapes() for c in bucket_configs] if bucket_configs is not None
           else [cfg.shapes()] * b)
    targets = [sh.num_triplets for sh in shs]
    idx, rows = list(config_indices), list(hyper_rows)
    if mesh is None:
        device = resolve_device(device)
    else:
        device = _mesh_device(mesh, device)
        pad = (-b) % mesh.size
        per = (b + pad) // mesh.size
        block = slice(mesh.rank * per, (mesh.rank + 1) * per)
        idx = (idx + idx[-1:] * pad)[block]
        rows = (rows + rows[-1:] * pad)[block]
        shs = (shs + shs[-1:] * pad)[block]
    use_kernel = resolve_use_kernel(cfg, device, use_kernel)
    idx = torch.as_tensor(np.asarray(idx, np.int64), device=device)
    cfg_keys = rng.config_key(prng.key(seed, device=device)[None], idx)
    column = lambda key: np.asarray([r[key] for r in rows], np.float32)
    host, err = None, None
    try:
        if device.type == "cuda":
            # The kernels behind C interfaces launch on the current card.
            torch.cuda.set_device(cfg_keys.device.index)
        with obs.span("mfcd.sweep.dispatch"):
            out = _run_bucket_device(
                dataclasses.replace(cfg, s=0.0, lr=0.0, weight_decay=0.0),
                cfg_keys, column("s"), column("lr"), column("weight_decay"),
                use_kernel=use_kernel, caps=caps,
                budgets=np.asarray([sh.num_triplets for sh in shs], np.int32),
                extra_budgets=np.asarray(
                    [sh.extra_test_triplets for sh in shs], np.int32))
        with obs.span("mfcd.sweep.collect"):
            host = {k: v.cpu() for k, v in out.items()}
    except Exception as e:  # noqa: BLE001 - raised here or by _gather
        if mesh is None:
            raise
        err = e
    if mesh is not None:
        host = _gather(mesh, host, err)
    with obs.span("mfcd.sweep.export"):
        results = []
        for bi in range(b):
            per_cfg = {k: v[bi] for k, v in host.items()}
            for c in per_cfg.pop("sample_count").numpy():
                if int(c) < targets[bi]:
                    print(f"⚠️ Only {int(c)} triplets generated for "
                          f"strategy: {cfg.strategy} (target={targets[bi]})",
                          file=sys.stderr)
            results.append(export_results(per_cfg))
        return results


def memory_budget_bytes(device) -> float:
    """Device bytes one chunk may plan for: a quarter of the card's memory,
    leaving room for the allocator's slack and the transient peaks the
    per-run count leaves out; the JAX package's 2 GB on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory / 4
    return CPU_BUDGET_BYTES


def sampler_bytes(cfg: RunConfig, t: int) -> int:
    """Estimated device bytes of one run's sample stage at capacity ``t``,
    by the path ``sample_and_split`` takes (``prp.fast_path_kind``): the
    prefix map's int64 temporaries per slot; margin's PRP-distinct
    proposals; or the overdraw's candidates, draws, keys and hash table
    (16 slots per row, int32), with the exclude top-up's own.
    user_similarity's attempts run in blocks: per attempt its outputs, per
    (rank, attempt) of a block the cascade's slots and masks, per (rank,
    attempt, position) the top-set rows and membership masks, and three
    cascade tables (base, a pass's copy, the winners')."""
    sh = cfg.shapes()
    extra = sh.extra_test_triplets
    kind = prp.fast_path_kind(cfg.strategy, cfg.n, cfg.m, t, extra)
    if kind == "prefix":
        return t * _SAMPLE_SLOT_BYTES
    plan = lambda target: strategies.plan_overdraw(
        cfg.strategy, target, cfg.n, cfg.m,
        popularity_method=cfg.popularity_method, alpha=cfg.alpha)
    md = plan(t)
    if kind == "distinct":
        return (md + (plan(extra) if extra else 0)) * _DISTINCT_BYTES
    md_extra = plan(extra) if extra else 0
    if cfg.strategy == "user_similarity":
        nb, tk = strategies.user_similarity_dims(cfg.n, cfg.m, t)
        blk, _ = strategies.user_similarity_blocks(md, tk)
        bits = max(strategies._cascade_bits(md, 0),
                   strategies._cascade_bits(md_extra, md) if extra else 0)
        return (md * _ATTEMPT_BYTES + nb * blk * (tk * _US_POS_BYTES
                                                  + _US_RANK_BYTES)
                + 3 * 4 * (1 << bits) + cfg.n * cfg.m)
    table = lambda rows: 4 * (1 << dedup._hash_bits(rows))
    return (md * _OVERDRAW_BYTES + table(md)
            + (md_extra * _OVERDRAW_BYTES + table(md + md_extra)
               if extra else 0))


def generation_bytes(cfg: RunConfig) -> int:
    """Estimated device bytes of one run's generator beyond X itself:
    graph and social hold an n x n adjacency (bool and a float32 copy),
    which the n x m planes do not cover where n >> m; svd the n x m
    scores and, in float64 (the card's precision for it), their copy, the
    solver's copy and workspace, U and V^T; clustered its
    k-means over the [m, n] item vectors and the shifted copies of X; gmm
    its EM step per component, point and dimension.  The other modes work
    on n x d and m x d factors."""
    n, m, d = cfg.n, cfg.m, cfg.d
    if cfg.generation in ("graph", "social"):
        return n * n * _ADJ_BYTES
    if cfg.generation == "svd":
        k = min(n, m)
        return 4 * n * m + 8 * (_SVD_F64_NM_PLANES * n * m + (n + m) * k
                                + k)
    if cfg.generation == "clustered":
        return 4 * _CLUSTERED_NM_PLANES * n * m
    if cfg.generation == "gmm":
        return _GMM_POINT_BYTES * 5 * (n + m) * d
    return 0


def run_bytes(cfg: RunConfig, t_cap: Optional[int] = None) -> int:
    """Estimated device bytes of one run of ``cfg`` at capacity ``t_cap``.

    The port allocates, per run: the n x m planes of the generator and the
    metric block (X, U V^T, centred copies, sort indices and ranks);
    the generator's own working set (:func:`generation_bytes`); the
    training split, its packed stream and the epoch shuffle's int64
    temporaries per padded row; under soft labels, the label stage's K
    votes per training triplet (drawn, then averaged into one row); the
    validation and test splits; and the sample stage's working set
    (:func:`sampler_bytes`)."""
    sh = cfg.shapes()
    t = sh.num_triplets if t_cap is None else t_cap
    train_rows = int(TRAIN_RATIO * t) * (1 if cfg.soft_label else cfg.K)
    votes = int(TRAIN_RATIO * t) * cfg.K if cfg.soft_label else 0
    eval_raw = ((t - int(TRAIN_RATIO * t)) * cfg.K
                + sh.extra_test_triplets * cfg.K)
    return (cfg.n * cfg.m * 4 * _NM_PLANES + generation_bytes(cfg)
            + _next_pow2(max(train_rows, 1)) * _TRAIN_ROW_BYTES
            + _next_pow2(max(eval_raw, 1)) * _EVAL_ROW_BYTES
            + votes * _VOTE_BYTES + sampler_bytes(cfg, t))


_logged_max_bucket: Optional[tuple] = None


def default_max_bucket(cfg: RunConfig, t_cap: Optional[int] = None,
                       device=None) -> int:
    """Configurations per chunk: the memory budget over the per-run bytes
    (at least 4 runs), divided by the repetitions per configuration, as in
    the JAX package.  Printed once per process and choice."""
    global _logged_max_bucket
    device = resolve_device(device)
    per_run = run_bytes(cfg, t_cap)
    budget_runs = max(4, int(memory_budget_bytes(device) / per_run))
    chunk = max(1, budget_runs // max(cfg.reps, 1))
    choice = (device.type, per_run, chunk)
    if _logged_max_bucket != choice:
        _logged_max_bucket = choice
        print(f"mfcd_tpu_torch: up to {chunk} configs x {cfg.reps} reps per "
              f"chunk on {device.type} ({per_run / 1e6:.1f} MB per run "
              f"estimated)", flush=True)
    return chunk


def parameter_scan_fast(
    device=None,
    save_path: Optional[str] = None,
    save_every: Optional[int] = None,
    linear: bool = False,
    seed: int = DEFAULT_SEED,
    batch_size: int = 64,
    max_bucket: Optional[int] = None,
    resume: bool = False,
    pad_compiles: bool = True,
    mesh: Optional[Mesh] = None,
    **params,
) -> List[Dict[str, Any]]:
    """``parameter_scan`` over shape buckets, with the same semantics and
    schema.

    Groups the expanded grid into shape buckets, runs each bucket in chunks
    of up to ``max_bucket`` configurations (default
    :func:`default_max_bucket`), and returns the results in grid order.
    Every finished chunk is appended to ``save_path`` at once, and a scan
    that saves returns ``[]``.  ``save_every`` is accepted for
    compatibility with the JAX package's and the sequential scan's
    signature, and ignored.  ``resume=True`` keeps an existing results file and
    skips configurations already in it.  A chunk that runs out of device
    memory is split in two and retried, down to single configurations; a
    chunk that fails otherwise raises, every chunk before it persisted.
    ``device=None`` means the card.

    Under a ``mesh`` (:func:`make_sweep_mesh`; every rank calls the scan
    with the same arguments) each chunk is sharded over the ranks, and
    every rank returns the whole list; only rank 0 writes ``save_path``.
    ``max_bucket`` counts configurations over all ranks, as in the JAX
    package, so the chunks, and the pickle, are those of an unsharded
    scan.  With ``resume`` every rank reads the file before rank 0 writes
    to it.  ``device`` defaults to the mesh's."""
    device = (resolve_device(device) if mesh is None
              else _mesh_device(mesh, device))
    with obs.call("parameter_scan_fast", device):
        writer = mesh is None or mesh.rank == 0
        spec = SweepSpec(params=params, linear=linear, batch_size=batch_size)
        param_sets = spec.expand()
        configs = [RunConfig(batch_size=batch_size, **ps) for ps in param_sets]
        buckets = bucket_by_shape(configs, capped=pad_compiles)

        done: List[Dict[str, Any]] = []
        if save_path:
            if resume:
                done = completed_param_sets(save_path)
                if done and writer:
                    print(f"🔁 Resuming: {len(done)} experiments already in "
                          f"{save_path}")
                if mesh is not None:
                    dist.barrier()
            elif writer:
                reset_save_path(save_path)

        slot_results: List[Optional[Dict]] = [None] * len(configs)
        for indices in buckets.values():
            indices = [i for i in indices if param_sets[i] not in done]
            if not indices:
                continue
            rep_cfg = configs[indices[0]]
            caps = compile_caps(rep_cfg) if pad_compiles else None
            bucket_cap = (max_bucket if max_bucket is not None
                          else default_max_bucket(
                              rep_cfg, t_cap=caps[0] if caps else None,
                              device=device))

            def run_chunk(chunk):
                """A chunk's results; on a device OOM, split it in two and
                run the halves (the per-run estimate is a model: halving
                converges on a chunk that fits)."""
                try:
                    return run_bucket(
                        rep_cfg,
                        [{"s": configs[i].s, "lr": configs[i].lr,
                          "weight_decay": configs[i].weight_decay}
                         for i in chunk],
                        chunk, seed=seed, caps=caps,
                        bucket_configs=[configs[i] for i in chunk],
                        device=device, mesh=mesh)
                except RuntimeError as err:
                    if not _is_oom(err) or len(chunk) <= 1:
                        raise
                print(f"⚠️ device OOM on a {len(chunk)}-config chunk; "
                      "bisecting", file=sys.stderr)
                if device.type == "cuda":
                    torch.cuda.empty_cache()
                mid = len(chunk) // 2
                return run_chunk(chunk[:mid]) + run_chunk(chunk[mid:])

            def store(chunk, outs):
                for i, res in zip(chunk, outs):
                    slot_results[i] = res
                if save_path and writer:
                    with obs.span("mfcd.sweep.persist"):
                        append_results(save_path, [
                            {"params": param_sets[i], "results": res}
                            for i, res in zip(chunk, outs)])

            for lo in range(0, len(indices), bucket_cap):
                chunk = indices[lo:lo + bucket_cap]
                store(chunk, run_chunk(chunk))

        if save_path:
            return []
        return [{"params": ps, "results": res}
                for ps, res in zip(param_sets, slot_results)]
