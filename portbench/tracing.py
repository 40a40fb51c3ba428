"""The traced run: torch.profiler over whole calls, summarised in memory.

:func:`capture` runs calls under ``torch.profiler`` with CPU and CUDA
activity and returns the raw events as :class:`Event` records, without
writing a trace file.  :func:`summarise` reduces them to what the
per-layer readers take:

- device operations (kernels, copies, fills) by name, their count and
  device seconds;
- the device's busy time: the union of the operations' intervals, so that
  operations that overlap count once;
- the device seconds of the kernels launched inside each ``mfcd.*`` span,
  by launch containment: a kernel belongs to every span whose host
  interval holds the start of the runtime call that launched it (or, where
  the trace links no runtime call, of the host operation it was launched
  under);
- the idle gaps of the device, each put to the innermost ``mfcd.*`` span
  the host was in when the gap began.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE = "(outside mfcd spans)"


@dataclass(frozen=True)
class Event:
    """One trace event: ``kind`` is a device kind of :data:`DEVICE_KINDS`,
    ``runtime`` (a host call into the CUDA runtime), ``host`` (another host
    operation) or ``span`` (a host ``record_function`` range); times in
    seconds on one clock."""

    kind: str
    name: str
    start: float
    end: float
    corr: int = 0
    tid: int = 0
    link: int = 0


@dataclass
class Summary:
    window_s: float
    busy_s: float
    launches: int
    by_name: Dict[str, Tuple[int, float]]
    by_span: Dict[str, float]
    idle_by_span: Dict[str, float]
    events: int = 0
    unmatched: int = 0
    kinds: Dict[str, float] = field(default_factory=dict)

    def top_device_ops(self, k: int = 10) -> List[list]:
        rows = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:k]
        return [[name[:160], secs] for name, (_, secs) in rows]

    def top_idle(self, k: int = 10) -> List[list]:
        rows = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:k]
        return [[name, secs] for name, secs in rows]


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``[start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _merged(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _Spans:
    """Host spans as a timeline of segments, each with the spans open over
    it, outermost first: a lookup is one bisection."""

    def __init__(self, spans: List[Event]):
        marks = sorted({t for e in spans for t in (e.start, e.end)})
        self.bounds = marks
        opened: List[List[Event]] = [[] for _ in marks]
        order = sorted(spans, key=lambda e: (e.start, -e.end))
        for e in order:
            lo = bisect.bisect_left(marks, e.start)
            hi = bisect.bisect_left(marks, e.end)
            for k in range(lo, hi):
                opened[k].append(e)
        self.open = opened

    def enclosing(self, t: float) -> List[Event]:
        k = bisect.bisect_right(self.bounds, t) - 1
        return self.open[k] if 0 <= k < len(self.open) else []

    def innermost(self, t: float) -> Optional[Event]:
        inside = self.enclosing(t)
        return inside[-1] if inside else None


def summarise(events: List[Event], window: Tuple[float, float],
              prefix: str = "mfcd.") -> Summary:
    """Reduce ``events`` over ``window`` (start, end) seconds."""
    t0, t1 = window
    device = [e for e in events if e.kind in DEVICE_KINDS]
    runtime = {e.corr: e for e in events if e.kind == "runtime" and e.corr}
    host = {e.corr: e for e in events
            if e.kind in ("host", "span") and e.corr}
    spans_by_tid: Dict[int, List[Event]] = defaultdict(list)
    all_spans: List[Event] = []
    for e in events:
        if e.kind == "span" and e.name.startswith(prefix):
            spans_by_tid[e.tid].append(e)
            all_spans.append(e)
    lookup = {tid: _Spans(s) for tid, s in spans_by_tid.items()}
    anywhere = _Spans(all_spans)

    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    by_span: Dict[str, float] = defaultdict(float)
    launches, unmatched = 0, 0
    clipped = []
    for e in device:
        s, t = max(e.start, t0), min(e.end, t1)
        if t <= s:
            continue
        clipped.append((s, t))
        secs = t - s
        row = by_name[e.name]
        row[0] += 1
        row[1] += secs
        if e.kind != "kernel":
            continue
        launches += 1
        call = runtime.get(e.corr) or host.get(e.link)
        if call is None:
            unmatched += 1
            continue
        spans = lookup.get(call.tid, anywhere).enclosing(call.start)
        for name in {sp.name for sp in spans}:
            by_span[name] += secs

    busy = union_seconds(clipped)
    idle: Dict[str, float] = defaultdict(float)
    prev = t0
    for s, e in _merged(clipped) + [[t1, t1]]:
        if s > prev:
            span = anywhere.innermost(prev)
            idle[span.name if span else OUTSIDE] += s - prev
        prev = max(prev, e)
    return Summary(window_s=t1 - t0, busy_s=busy, launches=launches,
                   by_name={k: (int(v[0]), v[1]) for k, v in by_name.items()},
                   by_span=dict(by_span), idle_by_span=dict(idle),
                   events=len(events),
                   unmatched=unmatched,
                   kinds={k: float(sum(e.kind == k for e in events))
                          for k in DEVICE_KINDS + ("runtime", "host",
                                                   "span")})


def _kind(e, on_device: bool, prefix: str) -> Optional[str]:
    """An event's kind, from its activity type where the profiler gives
    one, else from its device, its annotation flag and its name."""
    name = e.name()
    act = str(e.activity_type()) if hasattr(e, "activity_type") else None
    note = (bool(e.is_user_annotation())
            if hasattr(e, "is_user_annotation") else name.startswith(prefix))
    if on_device:
        if act is not None:
            return act if act in DEVICE_KINDS else None
        if note or name.startswith(prefix):
            return None
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if act is not None:
        return {"cuda_runtime": "runtime", "user_annotation": "span",
                "cpu_op": "host"}.get(act)
    if note:
        return "span"
    return "runtime" if name.startswith("cu") else "host"


def from_kineto(raw, prefix: str = "mfcd.") -> List[Event]:
    """:class:`Event` records from ``torch.profiler``'s kineto events.
    A kernel's ``corr`` is its runtime call's correlation id and its
    ``link`` the id of the host operation it was launched under; a host
    event's ``corr`` is its own id."""
    out = []
    for e in raw:
        on_device = "CUDA" in str(e.device_type())
        kind = _kind(e, on_device, prefix)
        if kind is None:
            continue
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        tid = 0 if on_device else int(e.start_thread_id())
        out.append(Event(kind, e.name(), start, end, int(e.correlation_id()),
                         tid, int(e.linked_correlation_id())))
    return out


def capture(run_calls):
    """Run ``run_calls()`` under torch.profiler (CPU and CUDA activity,
    nothing recorded beyond names and times); returns (its result, the
    events, the window (start, end) on the trace's clock)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False, with_stack=False) as prof:
        torch.cuda.synchronize()
        wall0 = time.time_ns()
        result = run_calls()
        torch.cuda.synchronize()
        wall1 = time.time_ns()
    events = from_kineto(prof.profiler.kineto_results.events())
    return result, events, (wall0 * 1e-9, wall1 * 1e-9)
