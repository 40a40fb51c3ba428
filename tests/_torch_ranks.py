"""Rank functions for the port's multi-process tests.

``parallel.multihost.launch`` spawns each rank, which imports this module
by name: it imports nothing of jax or ``mfcd_tpu``, and every rank checks
that its interpreter holds neither.  ``run_all`` runs several calls in
one job, so a test file pays for one launch per world size.
"""

import sys

import torch.distributed as dist


def assert_no_jax() -> None:
    found = [m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mfcd_tpu")]
    if found:
        raise AssertionError(f"a rank imported {sorted(found)[:5]}")


def steps(shape, state, batches, lr, wd, opt=None):
    from mfcd_tpu_torch.scripts.dryrun_multichip import sharded_steps

    return sharded_steps(shape, state, batches, lr, wd, device="cpu",
                         opt=opt)


def roundtrip(shape, arrays):
    """``unshard(shard(x))`` for each (spec, array) on the mesh of
    ``shape``."""
    import torch

    from mfcd_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh(shape=shape, device="cpu")
    return [pm.unshard(mesh, pm.shard(mesh, torch.as_tensor(a), spec),
                       spec).numpy() for spec, a in arrays]


def bucket(cfg, rows, indices):
    from mfcd_tpu_torch.core.config import RunConfig
    from mfcd_tpu_torch.sweep.batched import make_sweep_mesh, run_bucket

    return run_bucket(RunConfig(**cfg), rows, indices,
                      mesh=make_sweep_mesh(device="cpu"))


def scan(kw):
    from mfcd_tpu_torch.sweep.batched import make_sweep_mesh, \
        parameter_scan_fast

    return parameter_scan_fast(mesh=make_sweep_mesh(device="cpu"), **kw)


def scan_oom_on(rank, kw):
    """``scan`` with rank ``rank``'s device run out of memory on every
    block of more than one configuration; returns the scan and the block
    sizes this rank dispatched."""
    import torch

    from mfcd_tpu_torch.sweep import batched

    real = batched._run_bucket_device
    sizes = []

    def flaky(cfg, cfg_keys, *args, **kwargs):
        sizes.append(cfg_keys.shape[0])
        if dist.get_rank() == rank and cfg_keys.shape[0] > 1:
            raise torch.cuda.OutOfMemoryError("out of memory (test)")
        return real(cfg, cfg_keys, *args, **kwargs)

    batched._run_bucket_device = flaky
    try:
        return scan(kw), sizes
    finally:
        batched._run_bucket_device = real


def strided_sweep(grid):
    """This process's strided slice of ``grid`` through ``run_experiment``
    (``tests/_multihost_worker.py``'s sweep)."""
    from mfcd_tpu_torch.parallel.multihost import shard_param_sets
    from mfcd_tpu_torch.sweep.engine import run_experiment

    mine = shard_param_sets(grid, dist.get_rank(), dist.get_world_size())
    return [{"params": ps,
             "results": run_experiment(**ps, seed=7, device="cpu")}
            for ps in mine]


def fail_on_rank(rank):
    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    import torch

    dist.all_reduce(torch.ones(1))


def sleep(seconds):
    import time

    time.sleep(seconds)


def run_all(calls):
    """``{name: fn(*args)}`` for each (name, function name, args), in
    order, every rank alike."""
    assert_no_jax()
    out = {name: globals()[fn](*args) for name, fn, args in calls}
    assert_no_jax()
    return out
