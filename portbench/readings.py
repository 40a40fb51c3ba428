"""The readings each correctness limit is set from, at a cell's own size.

    python3 -m portbench.readings --workload <cell> --seed <n>
        [--calls 12] [--controls 3] [--faults] [--device cuda]

In one process: the cell's warm-up calls, then ``--calls`` calls of its
mix as the window makes them (call k with the seed the run at ``--seed``
gives it), each compared with the float32 reference (the program's
readings, the lower ends); then, for the first ``--controls`` blocks of
the cell's ``check_calls`` consecutive calls, the reference computed
with every product's operands in TF32 put in the program's place (the
control's readings, the upper ends); with ``--faults``, for the same
blocks, the reference with each fault a cell can have planted
(``faults.py``).  A block's number is the worst of its calls', as a
run's check takes it.  One JSON line a reading on standard output, then
a summary line: the largest reading of the program and the smallest
block reading of the control and of each fault, per number.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def _args(a: dict) -> dict:
    """A call's cycled values, for the record."""
    return {k: a[k] for k in ("s", "weight_decay")
            if not isinstance(a.get(k), list) and k in a}


def _top(entry: str, results, ref) -> dict:
    """Every result key's gap, and per run the reference's and the
    program's norm ratio with the widest gap of a key computed from the
    trained factors (collapsed or not), for the record."""
    from portbench import check

    if entry == "parameter_scan_ground_truth":
        return {}
    prog = [r["results"] for r in results]
    gaps = check.key_gaps(prog, ref) or {}
    gaps["train_losses"] = max(check.key_gap(p["train_losses"],
                                             r["train_losses"])
                               for p, r in zip(prog, ref))
    runs = []
    for p, r in zip(prog, ref):
        for j in range(len(r["norm_ratio"])):
            keep = [k == j for k in range(len(r["norm_ratio"]))]
            worst = max(check.key_gap(p[key], r[key], keep) for key in p
                        if key not in check.DATA_KEYS + check.CURVE_KEYS
                        + check.UNCOMPARED)
            runs.append([float(r["norm_ratio"][j]),
                         float(p["norm_ratio"][j]), worst])
    return {"keys": gaps, "runs": runs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from portbench import check, faults, spec, workload
    from portbench.run import call_args, entry_point, set_environment

    cell = spec.load_cell(args.workload)
    set_environment(spec.ROOT, cell.config)
    out = sys.stdout
    lows, highs, planted = {}, {}, {}
    with contextlib.redirect_stdout(sys.stderr):
        import torch

        import mfcd_tpu_torch as program

        plan = workload.Plan(cell.traffic["entry"], cell.config["study"],
                             cell.traffic, args.seed)
        fn = entry_point(program, plan.entry)
        sync = (torch.cuda.synchronize if args.device == "cuda"
                else (lambda: None))
        for k in range(int(cell.traffic.get("warmup_calls", 1))):
            fn(device=args.device, **call_args(fn, plan.call(-1 - k)))
        calls = []
        for k in range(args.calls):
            a = plan.call(k)
            calls.append((a, fn(device=args.device, **call_args(fn, a))))
            sync()
        fp32 = cell.reference(args.device)
        refs = []
        t0 = time.perf_counter()
        for a, _ in calls:
            refs.append(check.reference_results(fp32, plan.entry, a,
                                                cell.config))
        sync()
        log(f"reference of {len(calls)} calls: "
            f"{time.perf_counter() - t0:.2f} s")
        for k, ((a, res), ref) in enumerate(zip(calls, refs)):
            nums = check.numbers_against(plan.entry, res, ref)
            for key, v in nums.items():
                lows[key] = max(lows.get(key, 0.0), v)
            print(json.dumps({"side": "program", "call": k,
                              "seed": a["seed"], **_args(a), **nums,
                              **_top(plan.entry, res, ref)}),
                  file=out, flush=True)
        block = int(cell.traffic.get("check_calls", 1))
        picked = calls[:args.controls * block]
        sides = [("control", cell.reference(args.device, tf32=True),
                  highs)]
        if args.faults:
            names = (faults.ORACLE if plan.entry ==
                     "parameter_scan_ground_truth"
                     else faults.TRAINING + faults.READ_ONLY)
            sides += [(name, faults.planted(cell.reference, name)(
                args.device), planted.setdefault(name, {}))
                for name in names]
        for side, pipe, mins in sides:
            got = [check.reference_results(pipe, plan.entry, a,
                                           cell.config) for a, _ in picked]
            worst = {}
            for k, ((a, _), res) in enumerate(zip(picked, got)):
                wrapped = [{"results": r} for r in res]
                nums = check.numbers_against(plan.entry, wrapped, refs[k])
                for key, v in nums.items():
                    worst[key] = max(worst.get(key, 0.0), v)
                if (k + 1) % block == 0:
                    for key, v in worst.items():
                        mins[key] = min(mins.get(key, float("inf")), v)
                    worst = {}
                print(json.dumps({"side": side, "call": k,
                                  "seed": a["seed"], **_args(a), **nums,
                                  **_top(plan.entry, wrapped, refs[k])}),
                      file=out, flush=True)
    print(json.dumps({"workload": args.workload, "calls": args.calls,
                      "controls": args.controls, "program_max": lows,
                      "control_min": highs, "fault_min": planted}),
          file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
