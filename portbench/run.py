"""The port's benchmark: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this directory
and the program (``mfcd_tpu_torch``).  One run:

1. finds the cell's configuration, traffic mix and limits by name;
2. needs as many CUDA cards as the cell asks for, else exits 3 with no
   result;
3. sets up: imports the program, builds or loads its kernels (their build
   directory is inside the checkout) and makes the mix's warm-up calls,
   on the cell's own shapes;
4. makes calls one after another, each after the last has returned its
   results to the host, until ``--seconds`` have passed: the window
   closes at the end of the first call that ends after that;
5. with ``--trace 1``, profiles the mix's traced calls after the window;
6. recomputes a sample of the window's calls, drawn from the seed, with
   the configuration's plain reference (``reference/``, found by its
   name) and compares them (``check.py``);
7. prints one JSON line: ``correct``, ``attempted``, ``failed``,
   ``metrics`` (the cell's end-to-end metrics, or its per-layer ones with
   ``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
   ``checks``, each compared number with its limit.

Everything else, the program's own prints included, goes to standard
error, whose last lines are the compared numbers.  A run whose process
holds jax, jaxlib, flax or mfcd_tpu once the window has closed exits 4
with no result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from typing import Dict  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mfcd_tpu")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list:
    """Top-level names in ``sys.modules`` that the run may not hold,
    compared whole (``mfcd_tpu_torch`` is not ``mfcd_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def set_environment(root: str, config: dict) -> None:
    """Caches at fixed paths inside the checkout, and the epoch period of
    the program's fresh shuffles as the configuration states it (the
    reference follows the same period)."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["MFCD_RESHUFFLE_PERIOD"] = str(int(config["reshuffle_period"]))


def entry_point(program, name: str):
    fn = getattr(program, name, None)
    if fn is None:
        raise KeyError(f"the program has no entry {name!r}")
    return fn


def call_args(fn, args: dict) -> dict:
    """``args`` as ``fn`` takes them: every one where it takes keyword
    arguments freely, else the ones it names."""
    import inspect

    params = inspect.signature(fn).parameters
    if any(p.kind == p.VAR_KEYWORD for p in params.values()):
        return dict(args)
    return {k: v for k, v in args.items() if k in params}


def execute(cell, seed: int, seconds: float, trace: bool, device: str,
            program=None) -> Dict:
    """One run of ``cell`` (a ``spec.Cell``) on ``device``; returns the
    result line's dict.  ``program`` defaults to ``mfcd_tpu_torch``."""
    import torch

    from portbench import check, spec, tracing, workload

    if program is None:
        import mfcd_tpu_torch as program
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    plan = workload.Plan(cell.traffic["entry"], cell.config["study"],
                         cell.traffic, seed)
    fn = entry_point(program, plan.entry)
    per_call = plan.runs_per_call()
    checked = workload.BlockSample(int(cell.traffic.get("check_calls", 1)),
                                   workload.derive(seed, "check"))
    failures = []

    def do_call(k: int, keep: bool = True) -> bool:
        args = plan.call(k)
        try:
            results = fn(device=device, **call_args(fn, args))
            sync()
        except Exception:  # noqa: BLE001 - counted as failed, then judged
            failures.append(traceback.format_exc())
            log(failures[-1])
            return False
        if keep:
            checked.offer((k, args, results))
        return True

    for k in range(int(cell.traffic.get("warmup_calls", 1))):
        if not do_call(-1 - k, keep=False):
            raise RuntimeError("a warm-up call failed:\n" + failures[-1])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - _T0
    window = workload.closed_loop(do_call, per_call, seconds,
                                  setup_s=setup_s)
    attempted = len(window.calls)
    walls = [c.wall for c in window.calls]
    log(f"window: {len(walls)} calls in {window.seconds:.3f} s, a call "
        f"{workload.percentile(walls, 50):.5f} s (p5 "
        f"{workload.percentile(walls, 5):.5f}, p95 "
        f"{workload.percentile(walls, 95):.5f}, max {max(walls):.5f})")
    summary = traced = None
    if trace and cuda:
        first = window.calls[-1].index + 1
        n_traced = int(cell.traffic.get("trace_calls", 1))

        def traced_calls():
            return [do_call(first + i, keep=False) for i in range(n_traced)]

        oks, events, span = tracing.capture(traced_calls)
        attempted += n_traced
        traced = dict(calls=n_traced, runs=per_call * sum(oks))
        summary = tracing.summarise(events, span)
        log(f"trace: {summary.events} events, {summary.launches} kernels "
            f"({summary.unmatched} without their launch), busy "
            f"{summary.busy_s:.4f} s of {summary.window_s:.4f} s; by kind "
            f"{summary.kinds}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = len(failures)

    ctx = dict(cell=cell, plan=plan, window=window, traced=traced,
               runs_per_call=per_call)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = (spec.reader("metrics", m["name"]).read(summary, ctx)
                     if summary is not None else None)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = spec.reader("e2e", m["name"]).read(window, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # The program's state is gone with its calls; the reference follows.
    if cuda:
        torch.cuda.empty_cache()
    sample = checked.sample()
    t_ref = time.perf_counter()
    nums = (check.numbers(cell.reference(device), plan.entry,
                          [(args, res) for _, args, res in sample],
                          cell.config) if sample else {})
    ok = check.verdict(nums, cell.limits, failed)
    line = {"correct": ok, "attempted": attempted, "failed": failed,
            "metrics": metrics,
            "device": {"platform": "gpu" if cuda else "cpu",
                       "kind": (torch.cuda.get_device_name(0) if cuda
                                else "cpu"),
                       "count": cell.chips if cuda else 0,
                       "memory_peak_bytes": int(peak)}}
    if summary is not None:
        line["device"]["busy_s"] = summary.busy_s
        line["device"]["window_s"] = summary.window_s
        line["breakdown"] = {"device_ops": summary.top_device_ops(),
                             "idle_gaps": summary.top_idle()}
    # JSON has no infinity: a number that could not be read prints null.
    finite = {k: v for k, v in nums.items() if math.isfinite(v)}
    line["checks"] = {k: {"value": finite.get(k), "limit": lim}
                      for k, lim in cell.limits.items()}
    log(f"checked calls {[k for k, _, _ in sample]} of {len(window.calls)}"
        f" in the window in {time.perf_counter() - t_ref:.2f} s; failed "
        f"calls {failed}")
    for k, lim in cell.limits.items():
        log(f"check {k} {finite.get(k)!r} limit {lim!r}")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    set_environment(spec.ROOT, cell.config)
    with contextlib.redirect_stdout(sys.stderr):
        line = execute(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda")
    held = forbidden_modules()
    if held:
        log(f"the run holds {held} after its window: no result")
        return 4
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
