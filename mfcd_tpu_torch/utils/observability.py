"""Stage spans, profiling and structured metrics logging (SURVEY §5.1, §5.5).

Counterpart of ``mfcd_tpu/utils/observability.py``.  The reference's
observability is tqdm bars and emoji console prints, plus dead TensorBoard
scaffolding (``structure.py:830-834, 1130-1145``).  Here:

- :func:`call` and :class:`span` record the port's stages.  Every public
  entry point opens ``mfcd.call``; the stages inside it (``mfcd.generate``,
  ``mfcd.sample``, ``mfcd.label``, ``mfcd.train*``, ``mfcd.metrics``,
  ``mfcd.export``, ``mfcd.sweep.*``) are spans.  Each span's host edges are
  stamped with ``time.time_ns()``; on the card each edge also records a
  timed CUDA event on the current stream, so the interval between two
  edges' events is the card's timeline over that stretch of the host's
  issue, busy or waiting.  A span's *self* time (host or card) is the sum
  of the stretches where it is the innermost open span of its thread, so
  the self times of a call's spans add up to the call's own interval.
  Nothing syncs to read the events: a call's are resolved at the next
  call's entry once they have completed, or by :func:`calls` (which then
  waits on the newest call's last event only).
- :func:`details` and :func:`detail` time parts of a stage (the sampler's
  ``mfcd.sample.tables`` and ``mfcd.sample.draw``) as *detail* spans:
  sibling stretches with their own edges, host and card, that take
  nothing from the stage's self time, so the stages still partition the
  call.  :func:`count` adds to a named counter of the open call (the
  sampler's ``sample.candidates``), from numbers the host holds.
- While ``torch.profiler`` records, a span is also a ``record_function``
  range of the same name (the trace's stage markers), and ``mfcd.call``
  counts syncs: on the card it sets ``torch.cuda.set_sync_debug_mode
  ("warn")`` and counts each of PyTorch's "synchronizing CUDA operation"
  warnings on the innermost open span of the thread that raised it,
  showing none.  Without a profiler neither happens.
- :func:`calls` returns the log of call records (the newest
  :data:`CALL_LOG`; raw spans for the newest :data:`RAW_CALLS`), and
  :func:`reset` clears it.
- :func:`trace` wraps ``torch.profiler.profile`` for on-demand profiles of
  the card (or of the CPU when asked), written as a Chrome trace, and
  prints the stage table of the calls it profiled,
- :class:`JsonlLogger` appends one JSON line per experiment (scalar metrics
  + params), a grep-able companion to the pickle protocol.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import tempfile
import threading
import time
import warnings
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from mfcd_tpu_torch.backend import resolve_device

CALL_LOG = 1024        # call records kept, the newest last
RAW_CALLS = 8          # the newest calls whose raw spans are kept
SYNC_TEXT = "called a synchronizing CUDA operation"  # PyTorch's sync warning


_profiling = torch._C._autograd._profiler_enabled   # whether one records


def _timed_event():
    return torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "call", "id", "parent", "thread", "start", "end",
                 "host_ns", "card_ns", "syncs")

    def __init__(self, name, call, span_id, parent, thread):
        self.name, self.call, self.id = name, call, span_id
        self.parent, self.thread = parent, thread
        self.start = self.end = self.host_ns = self.syncs = 0
        self.card_ns = 0.0

    def as_dict(self) -> dict:
        return dict(name=self.name, call=self.call, id=self.id,
                    parent=self.parent, thread=self.thread,
                    start_ns=self.start, end_ns=self.end,
                    host_ns=self.host_ns, card_ns=self.card_ns,
                    syncs=self.syncs)


class _Detail:
    """A detail span: host stamps and card events of its two edges."""

    __slots__ = ("name", "start", "end", "ev0", "ev1")

    def __init__(self, name, start, ev0):
        self.name, self.start, self.ev0 = name, start, ev0
        self.end, self.ev1 = start, ev0


class _Call:
    """An open or unresolved call: its spans, and each thread's timelines
    (``[(event, innermost span after the edge)]`` from the edge that opened
    the thread's first span to the one that closed it); its detail spans,
    the events of their edges, and its counters."""

    __slots__ = ("entry", "id", "card", "profiled", "runs", "spans",
                 "timelines", "record", "details", "detail_events",
                 "counters")

    def __init__(self, entry, call_id, card, profiled):
        self.entry, self.id, self.card = entry, call_id, card
        self.profiled, self.runs = profiled, 0
        self.spans: List[_Span] = []
        self.timelines: List[list] = []
        self.record: Optional[dict] = None
        self.details: List[_Detail] = []
        self.detail_events: list = []
        self.counters: Dict[str, int] = {}


class _Thread:
    """One thread's state (plain slots: a ``threading.local`` attribute
    costs several times as much, and an edge reads a few)."""

    __slots__ = ("ident", "call", "stack", "timeline", "stream", "last",
                 "detail", "detail_depth")

    def __init__(self):
        self.ident = threading.get_ident()
        self.call: Optional[_Call] = None   # the call this thread works for
        self.stack: List[_Span] = []        # open spans, innermost last
        self.timeline: Optional[list] = None
        self.stream = None                  # the stream its events go on
        self.last = 0                       # host ns of the thread's last edge
        self.detail: Optional[_Detail] = None   # the open detail span
        self.detail_depth = 0               # open ``details`` blocks


class Recorder:
    """The process's spans and call records.  ``event`` makes a timed
    event (``record(stream)``, ``query()``, ``synchronize()``,
    ``elapsed_time(other)`` in ms), reused from a pool once resolved;
    ``stream`` gives the current stream, read once a thread a call."""

    def __init__(self, event: Callable[[], Any] = _timed_event,
                 stream: Callable[[], Any] = torch.cuda.current_stream,
                 capacity: int = CALL_LOG, raw_calls: int = RAW_CALLS):
        self._event, self._stream = event, stream
        self._log: collections.deque = collections.deque(maxlen=capacity)
        self._raw: collections.deque = collections.deque(maxlen=raw_calls)
        self._pending: collections.deque = collections.deque()
        self._pool: list = []
        self._call_ids = itertools.count(1)
        self._span_ids = itertools.count(1)
        self._local = threading.local()

    def _thread(self) -> _Thread:
        try:
            return self._local.state
        except AttributeError:
            th = self._local.state = _Thread()
            return th

    # -- edges ------------------------------------------------------------
    def _edge(self, th: _Thread, call: _Call, after: Optional[_Span]) -> int:
        """Stamp an edge: the stretch since the thread's last edge goes to
        the span innermost before it; ``after`` is innermost after it."""
        t = time.time_ns()
        if th.stack:
            th.stack[-1].host_ns += t - th.last
        th.last = t
        if call.card:
            try:
                ev = self._pool.pop()
            except IndexError:
                ev = self._event()
            ev.record(th.stream)
            th.timeline.append((ev, after))
        return t

    def enter(self, name: str) -> Optional[_Span]:
        th = self._thread()
        call = th.call
        if call is None:
            return None
        stack = th.stack
        if not stack:
            th.timeline = []
            call.timelines.append(th.timeline)
            if call.card:
                th.stream = self._stream()
        sp = _Span(name, call.id, next(self._span_ids),
                   stack[-1].id if stack else None, th.ident)
        sp.start = self._edge(th, call, sp)
        stack.append(sp)
        call.spans.append(sp)
        return sp

    def switch(self, sp: _Span, name: str) -> _Span:
        """Close ``sp`` (the innermost open span) and open its sibling
        ``name`` at one edge."""
        th = self._thread()
        call = th.call
        new = _Span(name, call.id, next(self._span_ids), sp.parent,
                    th.ident)
        sp.end = new.start = self._edge(th, call, new)
        th.stack[-1] = new
        call.spans.append(new)
        return new

    def exit(self, sp: _Span) -> None:
        th = self._thread()
        stack = th.stack
        sp.end = self._edge(th, th.call,
                            stack[-2] if len(stack) > 1 else None)
        stack.pop()

    def count_sync(self) -> None:
        stack = self._thread().stack
        if stack:
            stack[-1].syncs += 1

    def count_runs(self, runs: int) -> None:
        call = self._thread().call
        if call is not None:
            call.runs += int(runs)

    def count(self, name: str, n: int) -> None:
        call = self._thread().call
        if call is not None:
            call.counters[name] = call.counters.get(name, 0) + int(n)

    # -- detail spans -------------------------------------------------------
    def detail(self, name: Optional[str]) -> None:
        """Close the thread's open detail span and open ``name`` (None:
        none) at one edge.  Acts only inside a :meth:`details` block that
        a span of an open call encloses; the stack, and so every span's
        self time, is left as it was."""
        th = self._thread()
        call, cur = th.call, th.detail
        if call is None or not th.detail_depth or not th.stack:
            return
        if (cur.name if cur is not None else None) == name:
            return
        t, ev = time.time_ns(), None
        if call.card:
            try:
                ev = self._pool.pop()
            except IndexError:
                ev = self._event()
            ev.record(th.stream)
            call.detail_events.append(ev)
        if cur is not None:
            cur.end, cur.ev1 = t, ev
        th.detail = None
        if name is not None:
            th.detail = _Detail(name, t, ev)
            call.details.append(th.detail)

    @contextlib.contextmanager
    def details(self) -> Iterator[None]:
        """A block in which :meth:`detail` switches detail spans; the
        outermost closes the open one at its exit."""
        th = self._thread()
        th.detail_depth += 1
        try:
            yield
        finally:
            if th.detail_depth == 1:
                self.detail(None)
                th.detail = None
            th.detail_depth -= 1

    # -- calls ------------------------------------------------------------
    @contextlib.contextmanager
    def call(self, entry: str, device) -> Iterator[None]:
        th = self._thread()
        if th.call is not None:       # an entry inside another joins it
            yield
            return
        self.resolve_ready()
        c = _Call(entry, next(self._call_ids),
                  torch.device(device).type == "cuda", _profiling())
        th.call = c
        try:
            with (self._counting_syncs(c.card) if c.profiled
                  else contextlib.nullcontext()):
                with span("mfcd.call", self):
                    yield
        finally:
            th.call = None
            self._close(c)

    @contextlib.contextmanager
    def _counting_syncs(self, card: bool) -> Iterator[None]:
        with warnings.catch_warnings():
            warnings.filterwarnings("always", message=SYNC_TEXT)
            shown = warnings.showwarning

            def count(message, category, filename, lineno, file=None,
                      line=None):
                if SYNC_TEXT in str(message):
                    self.count_sync()
                else:
                    shown(message, category, filename, lineno, file, line)

            warnings.showwarning = count
            mode = torch.cuda.get_sync_debug_mode() if card else None
            if card:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                if card:
                    torch.cuda.set_sync_debug_mode(mode)

    def _close(self, c: _Call) -> None:
        stages: Dict[str, dict] = {}
        for sp in c.spans:
            st = stages.get(sp.name)
            if st is None:
                st = stages[sp.name] = dict(entries=0, host_ns=0,
                                            card_ns=None, syncs=0)
            st["entries"] += 1
            st["host_ns"] += sp.host_ns
            st["syncs"] += sp.syncs
        details: Dict[str, dict] = {}
        for d in c.details:
            st = details.setdefault(d.name, dict(entries=0, host_ns=0,
                                                 card_ns=None))
            st["entries"] += 1
            st["host_ns"] += d.end - d.start
        top = c.spans[0]
        c.record = dict(entry=c.entry, id=c.id, runs=c.runs,
                        profiled=c.profiled, card=c.card,
                        host_ns=top.end - top.start, card_ns=None,
                        stages=stages, details=details,
                        counters=dict(c.counters))
        self._log.append(c.record)
        self._raw.append(c)
        if c.card:
            self._pending.append(c)
        else:
            for sp in c.spans:
                sp.card_ns = None
            c.timelines = []

    def _resolve(self, c: _Call) -> None:
        for timeline in c.timelines:
            for (ev, sp), (nxt, _) in zip(timeline, timeline[1:]):
                if sp is not None:
                    sp.card_ns += ev.elapsed_time(nxt) * 1e6
            self._pool.extend(ev for ev, _ in timeline)
        c.timelines = []
        stages = c.record["stages"]
        for st in stages.values():
            st["card_ns"] = 0
        for sp in c.spans:
            sp.card_ns = int(round(sp.card_ns))
            stages[sp.name]["card_ns"] += sp.card_ns
        c.record["card_ns"] = sum(st["card_ns"] for st in stages.values())
        details = c.record["details"]
        for st in details.values():
            st["card_ns"] = 0.0
        for d in c.details:
            details[d.name]["card_ns"] += d.ev0.elapsed_time(d.ev1) * 1e6
        for st in details.values():
            st["card_ns"] = int(round(st["card_ns"]))
        self._pool.extend(c.detail_events)
        c.details, c.detail_events = [], []

    @staticmethod
    def _last_event(c: _Call):
        return c.timelines[0][-1][0]

    def resolve_ready(self) -> None:
        """Resolve the calls whose events have all completed, oldest first,
        without waiting."""
        while self._pending and self._last_event(self._pending[0]).query():
            self._resolve(self._pending.popleft())

    def calls(self) -> List[dict]:
        """The call records, oldest first, every card timeline resolved;
        the newest :data:`RAW_CALLS` with their raw ``spans``."""
        if self._pending:
            self._last_event(self._pending[-1]).synchronize()
            while self._pending:
                self._resolve(self._pending.popleft())
        raw = {c.id: c for c in self._raw}
        return [dict(r, spans=[sp.as_dict() for sp in raw[r["id"]].spans])
                if r["id"] in raw else r for r in self._log]

    def reset(self) -> None:
        self._pending.clear()
        self._raw.clear()
        self._log.clear()


_RECORDER = Recorder()


class span:
    """``with span("mfcd.<stage>"):`` — a stage of the open call (nothing
    is recorded outside one), and under ``torch.profiler`` a
    ``record_function`` range of the same name inside its host edges."""

    __slots__ = ("name", "_rec", "_sp", "_rf")

    def __init__(self, name: str, recorder: Optional[Recorder] = None):
        self.name = name
        self._rec = recorder or _RECORDER

    def __enter__(self):
        self._sp = self._rec.enter(self.name)
        if _profiling():
            self._rf = record_function(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if self._sp is not None:
            self._rec.exit(self._sp)
        return False


class stages:
    """``with stages() as stage:`` then ``stage("mfcd.a")`` ...
    ``stage("mfcd.b")``: a run of sibling spans, each opened where the last
    closes, at one edge (one card event, where two spans would take two);
    the last closes with the block."""

    __slots__ = ("_rec", "_sp", "_rf")

    def __init__(self, recorder: Optional[Recorder] = None):
        self._rec = recorder or _RECORDER
        self._sp = self._rf = None

    def __enter__(self):
        return self

    def __call__(self, name: str) -> None:
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        if self._sp is None:
            self._sp = self._rec.enter(name)
        else:
            self._sp = self._rec.switch(self._sp, name)
        if _profiling():
            self._rf = record_function(name)
            self._rf.__enter__()
        else:
            self._rf = None

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if self._sp is not None:
            self._rec.exit(self._sp)
        return False


def call(entry: str, device):
    """``with call("parameter_scan", device):`` — the ``mfcd.call`` span
    of a public entry point on a resolved ``device``; an entry called
    inside another joins the open call.  At exit the call's record is
    appended to the log."""
    return _RECORDER.call(entry, device)


def count_runs(runs: int) -> None:
    """Add ``runs`` to the open call's run count."""
    _RECORDER.count_runs(runs)


def count(name: str, n: int) -> None:
    """Add ``n`` (a number the host holds) to the open call's counter
    ``name``."""
    _RECORDER.count(name, n)


def details():
    """``with details():`` — a block in which :func:`detail` times parts
    of the enclosing stage; the open detail span closes with the block."""
    return _RECORDER.details()


def detail(name: Optional[str]) -> None:
    """Close the open detail span of this thread's :func:`details` block
    and open ``name`` (None: none) at one edge: a part of the innermost
    stage, timed on the host and the card, whose time stays in the
    stage's self time.  Nothing happens outside such a block."""
    _RECORDER.detail(name)


def calls() -> List[dict]:
    """The newest :data:`CALL_LOG` call records, oldest first: ``entry``,
    ``id``, ``runs``, ``profiled``, ``card``, ``host_ns`` (the call's host
    interval), ``card_ns`` (its card timeline, None off the card),
    ``stages`` (per span name: ``entries``, ``host_ns`` and ``card_ns``
    self, ``syncs``), ``details`` (per detail span name: ``entries``,
    ``host_ns`` and ``card_ns`` between its edges, inside a stage's self
    time and outside ``card_ns``), ``counters`` (per name, its sum) and,
    for the newest :data:`RAW_CALLS`, ``spans``
    (each with its ``call``, ``id``, ``parent``, ``thread``, host
    ``start_ns`` / ``end_ns`` on ``time.time_ns()``'s clock)."""
    return _RECORDER.calls()


def reset() -> None:
    """Clear the log."""
    _RECORDER.reset()


def stage_table(records: List[dict]) -> List[str]:
    """Lines of a table over ``records``: per span name, its entries and
    its host ms, card ms and syncs a run."""
    runs = max(sum(r["runs"] for r in records), 1)
    rows: Dict[str, list] = {}
    for r in records:
        for name, st in r["stages"].items():
            row = rows.setdefault(name, [0, 0, None, 0])
            row[0] += st["entries"]
            row[1] += st["host_ns"]
            if st["card_ns"] is not None:
                row[2] = (row[2] or 0) + st["card_ns"]
            row[3] += st["syncs"]
    lines = [f"stages of {len(records)} calls, {runs} runs; a run:",
             f"{'span':<20} {'entries':>8} {'host ms':>9} {'card ms':>9} "
             f"{'syncs':>7}"]
    for name, (n, host, card, syncs) in sorted(rows.items()):
        card_ms = "-" if card is None else f"{card / 1e6 / runs:9.4f}"
        lines.append(f"{name:<20} {n / runs:8.2f} {host / 1e6 / runs:9.4f} "
                     f"{card_ms:>9} {syncs / runs:7.2f}")
    return lines


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, device=None):
    """Profile the enclosed block with ``torch.profiler``: CPU activity, and
    CUDA activity when ``device`` is the card (``None``: the card, which
    raises where there is none).  Clears the call log, writes a Chrome
    trace into ``log_dir`` (default: ``mfcd_trace`` under the temp
    directory) and prints its path and the stage table of the calls it
    profiled."""
    device = resolve_device(device)
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "mfcd_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    reset()
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    print(f"profile written to {path}")
    profiled = [r for r in calls() if r["profiled"]]
    if profiled:
        print("\n".join(stage_table(profiled)))


class JsonlLogger:
    """One JSON line per experiment: params + scalar metric summaries."""

    def __init__(self, path: str):
        self.path = path
        dirname = os.path.dirname(path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)

    def log(self, params: Dict[str, Any], results: Dict[str, Any]):
        record = {"params": params, "metrics": {}}
        for k, v in results.items():
            try:
                flat = np.asarray(v, dtype=np.float64).ravel()
            except (ValueError, TypeError):
                continue
            if flat.size:
                record["metrics"][k] = {
                    "mean": float(np.mean(flat)),
                    "std": float(np.std(flat)),
                }
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
