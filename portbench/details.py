"""The program's detail spans and named counters, as the per-layer readers
take them.

A call record of the program (``mfcd_tpu_torch.utils.observability``) may
hold ``details``: per detail span name, the card time between its edges,
a part of a stage's self time (the sampler's ``mfcd.sample.tables`` and
``mfcd.sample.draw``), and ``counters``: per name, a count the host made
(the sampler's ``sample.candidates``).  The window's calls are the last
``len(window.calls)`` records made with no profiler (``stages.py``).  A
program without them, the parent of the change that added them, reads
None.
"""

from __future__ import annotations

from typing import Optional

from portbench import check, stages


def card_ms_per_run(log, ctx, name: str) -> Optional[float]:
    """The card time of the detail span ``name`` over the window's calls,
    in ms a run they completed; None without a card timeline or a record
    that holds the span."""
    records = stages.window_records(log, ctx)
    if not records:
        return None
    runs, ns, seen = 0, 0, False
    for r in records:
        runs += r["runs"]
        st = (r.get("details") or {}).get(name)
        if st is not None:
            if st["card_ns"] is None:
                return None
            ns += st["card_ns"]
            seen = True
    if not seen or not runs:
        return None
    return ns / 1e6 / runs


def asked_triplets(ctx) -> int:
    """The triplets the window's calls asked for: each configuration's
    budget and test top-up, times its repetitions."""
    cell, plan = ctx["cell"], ctx["plan"]
    total = 0
    for k in range(len(ctx["window"].calls)):
        args = plan.call(k)
        for conf in check._grid(args):
            sh = check.shape_of(conf, args, cell.config)
            total += (sh.triplets + sh.extra_test) * int(args["reps"])
    return total


def count_per_triplet(log, ctx, name: str) -> Optional[float]:
    """The counter ``name`` summed over the window's calls, over the
    triplets they asked for; None where no record holds the counter."""
    records = stages.window_records(log, ctx)
    if not records:
        return None
    counts = [(r.get("counters") or {}).get(name) for r in records]
    if all(c is None for c in counts):
        return None
    asked = asked_triplets(ctx)
    return sum(c or 0 for c in counts) / asked if asked else None
