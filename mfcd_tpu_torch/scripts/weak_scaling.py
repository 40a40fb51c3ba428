"""Fixed total work over 1, 2 and 4 ranks, with a census of collectives.

    python3 -m mfcd_tpu_torch.scripts.weak_scaling [--ranks 1,2,4]
        [--device cuda|cpu] [--backend gloo|nccl] [--out FILE] [--smoke]
        [--timeout S]

Counterpart of ``scripts/weak_scaling.py``:

1. **Fixed total work.**  ``BUCKET`` (n = m = 300, d = 2, p = 0.2, 15
   epochs, 3 reps) over ``CONFIGS`` = 16 configurations, 48 whole runs, as
   one chunk (``sweep.batched.run_bucket``) over ``make_sweep_mesh()`` in
   a ``torch.distributed`` job of N ranks (``parallel.multihost.launch``):
   a warm call (seed 123), then two timed calls (321, 322), the best of
   the two kept; the wall is the slowest rank's.  The ranks are NCCL
   ranks, one a card, where there are as many cards as ranks, else gloo
   ranks sharing the card, which time-slice it: their wall is overhead,
   not scaling.  On the CPU they are gloo ranks of one thread each.
2. **Results.**  Rank 0 runs the same bucket unsharded (``mesh=None``)
   after its timed calls; every rank's results of the last timed call
   must equal it: bit for bit on the CPU, and on the card every key but
   the metric block's, which the card rounds by the run count of a call
   (``dryrun_multichip.ROUNDED_KEYS``, held to its bound).
3. **The census.**  JAX counts the collectives in the partitioned
   program's HLO and finds no data collective.  The port's sharded chunk
   is not collective-free: the ranks agree on the chunk's failure (an
   ``all_reduce`` of one int32 flag) and gather every rank's results (an
   ``all_gather_object``), ``sweep/batched.py::_gather``.  So its claim is
   a constant census: every ``torch.distributed`` collective the port
   calls is counted in each rank (:class:`Census`), per chunk and inside
   the train stage, over the timed calls and a chunk of a quarter of the
   configurations; the train stage holds none, and every chunk exactly
   ``PER_CHUNK``, whatever its size.

Prints one JSON line; writes it to ``--out`` only where that is given.
``--smoke``: ``SMOKE_BUCKET`` over ``SMOKE_CONFIGS``, for the CPU.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

BUCKET = dict(n=300, m=300, d=2, p=0.2, num_epochs=15, reps=3)
CONFIGS = 16
SMOKE_BUCKET = dict(n=24, m=28, d=2, p=0.4, num_epochs=2, reps=1)
SMOKE_CONFIGS = 4
WARM_SEED = 123
TIMED_SEEDS = (321, 322)
# What one sharded chunk calls, whatever its size.
PER_CHUNK = {"all_reduce": 1, "all_gather_object": 1}
# Every collective of torch.distributed the census counts.
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_object",
               "all_gather_into_tensor", "all_to_all", "all_to_all_single",
               "barrier", "monitored_barrier", "broadcast",
               "broadcast_object_list", "gather", "gather_object", "reduce",
               "reduce_scatter", "reduce_scatter_tensor", "scatter",
               "scatter_object_list", "send", "recv", "isend", "irecv")


class Census:
    """Counts the ``torch.distributed`` collectives this process calls
    while :meth:`active`: per chunk (a call of
    ``sweep.batched.run_bucket``, with its configuration count), and
    apart those inside the train stage (the engine's trainers) and those
    outside any chunk.  Calls a collective makes inside torch itself are
    not counted: only the port's own."""

    def __init__(self):
        self.chunks: List[dict] = []
        self.train = collections.Counter()
        self.outside = collections.Counter()
        self.train_calls = 0
        self._train_depth = 0

    def _count(self, name: str) -> None:
        if self._train_depth:
            self.train[name] += 1
        elif self.chunks:
            self.chunks[-1]["collectives"][name] += 1
        else:
            self.outside[name] += 1

    @contextlib.contextmanager
    def active(self):
        import torch.distributed as dist

        from mfcd_tpu_torch.sweep import batched, engine

        saved = []

        def patch(module, name, make):
            saved.append((module, name, getattr(module, name)))
            setattr(module, name, make(getattr(module, name)))

        def collective(name):
            def make(fn):
                def call(*args, **kwargs):
                    self._count(name)
                    return fn(*args, **kwargs)
                return call
            return make

        def chunk(fn):
            def call(cfg, hyper_rows, *args, **kwargs):
                self.chunks.append(dict(configs=len(hyper_rows),
                                        collectives=collections.Counter()))
                return fn(cfg, hyper_rows, *args, **kwargs)
            return call

        def trainer(fn):
            def call(*args, **kwargs):
                self.train_calls += 1
                self._train_depth += 1
                try:
                    return fn(*args, **kwargs)
                finally:
                    self._train_depth -= 1
            return call

        try:
            for name in COLLECTIVES:
                if hasattr(dist, name):
                    patch(dist, name, collective(name))
            patch(batched, "run_bucket", chunk)
            for name in ("train_runs_kernel", "train_model"):
                patch(engine, name, trainer)
            yield self
        finally:
            for module, name, fn in reversed(saved):
                setattr(module, name, fn)

    def report(self) -> dict:
        return dict(
            chunks=[dict(configs=c["configs"],
                         collectives=dict(c["collectives"]))
                    for c in self.chunks],
            train_stage=dict(self.train), train_calls=self.train_calls,
            outside_chunks=dict(self.outside))


def check_census(census: dict, label: str) -> None:
    """Raise unless the train stage holds no collective and every chunk
    exactly ``PER_CHUNK``."""
    if census["train_stage"]:
        raise AssertionError(f"{label}: collectives in the train stage: "
                             f"{census['train_stage']}")
    if not census["chunks"] or not census["train_calls"]:
        raise AssertionError(f"{label}: no chunk or train stage counted")
    for c in census["chunks"]:
        if c["collectives"] != PER_CHUNK:
            raise AssertionError(
                f"{label}: a chunk of {c['configs']} configurations called "
                f"{c['collectives']}, expected {PER_CHUNK}")


def hyper_rows(configs: int) -> List[Dict[str, float]]:
    """The per-configuration values of ``scripts/weak_scaling.py``."""
    return [{"s": 4.0 + 0.2 * k, "lr": 1e-3, "weight_decay": 5e-6}
            for k in range(configs)]


def _config(bucket: dict):
    from mfcd_tpu_torch.core.config import RunConfig

    return RunConfig(s=5.0, lr=1e-3, weight_decay=5e-6, **bucket)


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def rank_work(bucket: dict, configs: int, device: str) -> dict:
    """One rank's part: the warm call, the two timed calls and the quarter
    chunk under the census; rank 0 then the unsharded bucket and the
    comparison with every rank's results, which the ranks gather."""
    import torch.distributed as dist

    from mfcd_tpu_torch.ops import kernels
    from mfcd_tpu_torch.scripts.dryrun_multichip import compare_results
    from mfcd_tpu_torch.sweep import batched

    cfg = _config(bucket)
    rows, idx = hyper_rows(configs), list(range(configs))
    mesh = batched.make_sweep_mesh(device=device)
    batched.run_bucket(cfg, rows, idx, seed=WARM_SEED, mesh=mesh)
    walls, census = [], Census()
    launches = kernels.EPOCH_LAUNCHES
    with census.active():
        # batched.run_bucket, looked up at each call: the census counts it.
        for seed in TIMED_SEEDS:
            _sync(device)
            t0 = time.perf_counter()
            out = batched.run_bucket(cfg, rows, idx, seed=seed, mesh=mesh)
            _sync(device)
            walls.append(time.perf_counter() - t0)
        quarter = max(1, configs // 4)
        batched.run_bucket(cfg, rows[:quarter], idx[:quarter],
                           seed=TIMED_SEEDS[-1], mesh=mesh)
    launches = kernels.EPOCH_LAUNCHES - launches
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    gaps = None
    if dist.get_rank() == 0:
        ref = batched.run_bucket(cfg, rows, idx, seed=TIMED_SEEDS[-1],
                                 device=device)
        gaps = {}
        for r, got in enumerate(every):
            for k, v in compare_results(got, ref, f"rank {r} of "
                                        f"{len(every)}",
                                        card=device == "cuda").items():
                gaps[k] = max(gaps.get(k, 0.0), v)
    return dict(walls=walls, census=census.report(), k1=launches,
                acc_mean=float(np.mean(out[0]["accuracy"])), gaps=gaps,
                backend=dist.get_backend())


def backend_for(ranks: int, device: str, backend: Optional[str]) -> str:
    """NCCL, one rank a card, where there are as many cards as ranks; else
    gloo (ranks sharing a card, or the CPU)."""
    if backend is not None:
        return backend
    cards = torch.cuda.device_count() if device == "cuda" else 0
    return "nccl" if device == "cuda" and ranks <= cards else "gloo"


def scaling(ranks: Sequence[int], device: str = "cuda",
            backend: Optional[str] = None, bucket: dict = BUCKET,
            configs: int = CONFIGS, timeout_s: float = 900.0) -> dict:
    """The fixed work at each rank count; returns the JSON line's dict.
    Raises where the census or the results disagree."""
    from mfcd_tpu_torch.backend import card_line, resolve_device
    from mfcd_tpu_torch.parallel.multihost import launch

    resolve_device(device)
    total = configs * bucket["reps"]
    rows, censuses = [], {}
    for n in ranks:
        be = backend_for(n, device, backend)
        outs = launch(rank_work, n, args=(bucket, configs, device),
                      device=device, backend=be, timeout_s=timeout_s)
        for r, o in enumerate(outs):
            check_census(o["census"], f"{n} ranks, rank {r}")
        wall = max(min(o["walls"]) for o in outs)
        rows.append(dict(ranks=n, backend=be, wall_s=wall,
                         s_per_run=wall / total,
                         walls_by_rank=[o["walls"] for o in outs],
                         acc_mean=outs[0]["acc_mean"],
                         k1_launches_by_rank=[o["k1"] for o in outs],
                         rounded_gaps=outs[0]["gaps"]))
        censuses[str(n)] = outs[0]["census"]
        print(f"ranks={n} ({be}): {wall:.4f} s for {total} runs "
              f"({wall / total * 1e3:.2f} ms/run), acc {rows[-1]['acc_mean']}"
              f"; chunks {[c['configs'] for c in censuses[str(n)]['chunks']]}"
              f" each {PER_CHUNK}", file=sys.stderr, flush=True)
    card = device == "cuda"
    return {
        "fixed_total_work": dict(bucket, configs=configs, total_runs=total),
        "scaling": rows,
        "census": censuses,
        "per_chunk": PER_CHUNK,
        "device": torch.cuda.get_device_name(0) if card else "cpu",
        "card": card_line() if card else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", default="1,2,4",
                    help="comma-separated rank counts")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="default: nccl where there are as many cards as "
                         "ranks, else gloo")
    ap.add_argument("--out", default=None, help="also write the line here")
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny bucket (the CPU)")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds before a launch's ranks are stopped")
    args = ap.parse_args(argv)
    bucket, configs = ((SMOKE_BUCKET, SMOKE_CONFIGS) if args.smoke
                       else (BUCKET, CONFIGS))
    payload = scaling([int(r) for r in args.ranks.split(",")], args.device,
                      args.backend, bucket, configs, args.timeout)
    line = json.dumps(payload)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
