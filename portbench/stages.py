"""The program's own stage records, as the per-layer readers take them.

The program (``mfcd_tpu_torch.utils.observability``) keeps a record of
each call to an entry point: its runs and, per span name, the span's card
self timeline (the card's time between the span's edges, less its
children's) and the syncs counted while a profiler recorded.  The window's
calls are the last ``len(window.calls)`` records made with no profiler, so
their stage times are free of the profiler's cost; the traced calls are the
last ``traced["calls"]`` profiled records.  A program that keeps no such
log, or a log without a card timeline, gives None.
"""

from __future__ import annotations

from typing import Iterable, List, Optional


def program_log() -> Optional[List[dict]]:
    """The program's call records, oldest first; None where it keeps none."""
    try:
        from mfcd_tpu_torch.utils import observability
    except ImportError:
        return None
    calls = getattr(observability, "calls", None)
    return calls() if calls is not None else None


def window_records(log, ctx) -> Optional[List[dict]]:
    """The records of the window's calls, or None where the log lacks any
    of them."""
    n = len(ctx["window"].calls)
    plain = [r for r in log or [] if not r.get("profiled")]
    return plain[-n:] if n and len(plain) >= n else None


def traced_records(log, ctx) -> Optional[List[dict]]:
    """The records of the traced calls, or None where the log lacks any."""
    n = (ctx.get("traced") or {}).get("calls", 0)
    traced = [r for r in log or [] if r.get("profiled")]
    return traced[-n:] if n and len(traced) >= n else None


def card_ms_per_run(log, ctx, names: Iterable[str]) -> Optional[float]:
    """The card self timeline of the spans ``names`` over the window's
    calls, in ms a run they completed; None without a card timeline or a
    span of those names."""
    records = window_records(log, ctx)
    if not records:
        return None
    runs, ns, seen = 0, 0, False
    for r in records:
        if r.get("card_ns") is None:
            return None
        runs += r["runs"]
        for name in names:
            st = r["stages"].get(name)
            if st is not None:
                ns += st["card_ns"]
                seen = True
    if not seen or not runs:
        return None
    return ns / 1e6 / runs


def syncs_per_run(log, ctx) -> Optional[float]:
    """Syncs counted in the traced calls, every span's, a run they
    completed."""
    records = traced_records(log, ctx)
    runs = sum(r["runs"] for r in records or [])
    if not runs:
        return None
    return sum(st["syncs"] for r in records
               for st in r["stages"].values()) / runs
