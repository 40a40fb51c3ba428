"""Multi-process bring-up on ``torch.distributed``.

Counterpart of ``mfcd_tpu/parallel/multihost.py``.  The JAX package runs
one controller per host over all of its devices; the port runs one process
per device (SPMD): every rank calls the same entry point with the same
arguments, and collectives run over process groups.

- :func:`initialize` joins this process to the job (``tcp://`` or a file
  store from the coordinator, else ``torchrun``'s environment), on the
  backend its device needs: ``nccl`` on the card, ``gloo`` on the CPU.
  Several ranks may share one card only under ``backend="gloo"``: NCCL
  refuses two ranks on one device, so a world larger than the card count
  raises under it.
- :func:`launch` runs a function in N local ranks (spawned: CUDA cannot
  fork), after building the kernels once in the parent, and returns what
  each rank returned.  A rank's exception fails the launch, and so does the
  join timeout.
- :func:`shard_param_sets` is the strided slice of a sweep grid that one
  process owns, for jobs that merge their pickles instead of sharing a
  mesh.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.multiprocessing.spawn import ProcessException

from mfcd_tpu_torch.backend import resolve_device

INIT_TIMEOUT_S = 300     # rendezvous and every collective of the job
JOIN_TIMEOUT_S = 900     # a launch's whole run
_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device=None,
               timeout_s: float = INIT_TIMEOUT_S) -> torch.device:
    """Join this process to the job as rank ``process_id`` of
    ``num_processes``; returns the rank's device.

    ``coordinator_address`` is ``host:port`` (a ``tcp://`` rendezvous) or
    an ``init_method`` URL (``tcp://``, ``file://``).  Without it the
    rendezvous and both counts come from ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``, as ``torchrun`` sets them.  ``device=None``
    means the card, on which rank r takes card ``LOCAL_RANK`` (else r)
    modulo the card count; ``backend=None`` follows the device."""
    device = resolve_device(device)
    if coordinator_address is None:
        missing = [k for k in _ENV if k not in os.environ]
        if missing:
            raise ValueError("initialize: no coordinator address and no "
                             f"{', '.join(missing)} in the environment")
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"]
                            if num_processes is None else num_processes)
        process_id = int(os.environ["RANK"]
                         if process_id is None else process_id)
    else:
        if num_processes is None or process_id is None:
            raise ValueError("initialize: a coordinator address needs "
                             "num_processes and process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("initialize: nccl runs on the card; pass "
                             "backend='gloo' for the CPU")
        if num_processes > torch.cuda.device_count():
            raise ValueError(
                f"initialize: nccl needs one card per rank, and {num_processes}"
                f" ranks share {torch.cuda.device_count()} card(s); pass "
                "backend='gloo' to share a card")
    if device.type == "cuda":
        index = device.index
        if index is None:
            local = int(os.environ.get("LOCAL_RANK", process_id))
            index = local % torch.cuda.device_count()
        torch.cuda.set_device(index)
        device = torch.device("cuda", index)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def shard_param_sets(param_sets: List[Dict[str, Any]],
                     process_id: int, num_processes: int
                     ) -> List[Dict[str, Any]]:
    """The strided slice of a sweep grid owned by one process.

    Striding (rather than contiguous blocks) balances shape buckets across
    processes, since neighbouring grid points usually share shapes."""
    return param_sets[process_id::num_processes]


def _rank_main(rank: int, nprocs: int, init_method: str, device: str,
               backend: Optional[str], out_dir: str, fn: Callable,
               args: Sequence) -> None:
    """One spawned rank: join the job, run ``fn(*args)``, pickle its
    return value for the parent."""
    if device == "cpu":
        torch.set_num_threads(1)
    initialize(init_method, nprocs, rank, backend=backend, device=device)
    out = fn(*args)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    # Only on success: a failed rank keeps its connections until it has
    # written its traceback, so the others' errors follow its own.
    dist.destroy_process_group()


def _rank_errors(error_files: Sequence[str]) -> str:
    """Every failed rank's traceback, as the spawn wrapper wrote it."""
    reports = []
    for rank, path in enumerate(error_files):
        if os.path.exists(path) and os.path.getsize(path):
            with open(path, "rb") as f:
                reports.append(f"rank {rank}: {pickle.load(f)}")
    return "\n".join(reports)


def launch(fn: Callable, nprocs: int, args: Sequence = (), device=None,
           backend: Optional[str] = None,
           timeout_s: float = JOIN_TIMEOUT_S) -> List[Any]:
    """Run ``fn(*args)`` in ``nprocs`` local ranks of one job on ``device``
    (``None``: the card) and return each rank's return value, by rank.

    ``fn`` must be importable by name (the ranks are spawned).  The ranks
    meet at a file store in a fresh temporary folder, so parallel launches
    never share a port; each rank on the CPU runs one intra-op thread.  On
    the card the kernels are built here first, so the ranks only load
    them.  A rank that raises fails the launch with its traceback, and the
    other ranks are stopped; so are all of them when the launch outlasts
    ``timeout_s``."""
    device = resolve_device(device)
    if device.type == "cuda":
        from mfcd_tpu_torch.ops import _build

        _build.build_all()
    with tempfile.TemporaryDirectory(prefix="mfcd_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(nprocs, init_method, device.type, backend, tmp,
                              fn, tuple(args)),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"launch: {nprocs} ranks still running "
                                       f"after {timeout_s} s")
        except ProcessException as err:
            raise RuntimeError(f"launch: a rank of {nprocs} failed\n"
                               + _rank_errors(ctx.error_files)) from err
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join()
        outs = []
        for rank in range(nprocs):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs
