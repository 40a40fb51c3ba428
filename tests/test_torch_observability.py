"""The port's stage recorder (``mfcd_tpu_torch/utils/observability.py``):
the spans of every entry point, their call records, the profiler ranges
they open only under a profiler, the sync counter, and the card timeline's
bookkeeping over stand-in events whose times the test sets."""

import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import mfcd_tpu_torch
from mfcd_tpu_torch.sweep import engine
from mfcd_tpu_torch.utils import observability as obs

SCAN = dict(device="cpu", n=24, m=28, d=2, p=0.4, s=[1.0, 4.0],
            num_epochs=2, reps=2)
STAGES = {"mfcd.call", "mfcd.generate", "mfcd.sample", "mfcd.label",
          "mfcd.train", "mfcd.metrics", "mfcd.export"}
TRAIN = {"mfcd.train.mix", "mfcd.train.epoch", "mfcd.train.val"}
SYNC = obs.SYNC_TEXT + " (Triggered internally at CUDAFunctions.cpp:150.)"


@pytest.fixture
def recorder(monkeypatch):
    """A fresh process recorder, so that no other test's calls show."""
    rec = obs.Recorder()
    monkeypatch.setattr(obs, "_RECORDER", rec)
    return rec


class Clock:
    """The stand-in card: ``now`` is the stream's position in ms, and the
    events recorded at or before ``done`` have completed."""

    def __init__(self):
        self.now, self.done = 0.0, float("inf")
        self.made = self.synced = self.elapsed = 0

    def event(self):
        self.made += 1
        return FakeEvent(self)


class FakeEvent:
    def __init__(self, clock):
        self.clock, self.t = clock, None

    def record(self, stream=None):
        self.t = self.clock.now

    def query(self):
        return self.t <= self.clock.done

    def synchronize(self):
        self.clock.synced += 1
        self.clock.done = max(self.clock.done, self.t)

    def elapsed_time(self, other):
        assert self.query() and other.query()
        self.clock.elapsed += 1
        return other.t - self.t


def _by_id(record):
    return {sp["id"]: sp for sp in record["spans"]}


def _children(record, span_id):
    return [sp for sp in record["spans"] if sp["parent"] == span_id]


def test_no_profiler_no_range_and_one_record_with_every_stage(
        recorder, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(obs, "record_function", refuse)
    mfcd_tpu_torch.parameter_scan(**SCAN)
    (rec,) = obs.calls()
    assert rec["entry"] == "parameter_scan" and rec["runs"] == 4
    assert not rec["profiled"] and not rec["card"]
    assert set(rec["stages"]) == STAGES
    assert rec["stages"]["mfcd.sample"]["entries"] == 2   # one a config
    assert rec["card_ns"] is None
    assert all(st["card_ns"] is None and st["syncs"] == 0
               for st in rec["stages"].values())
    # Host self times add up to the call's interval.
    assert sum(st["host_ns"] for st in rec["stages"].values()) == \
        rec["host_ns"]
    obs.reset()
    assert obs.calls() == []


def test_profiled_spans_hold_their_ranges_and_nest_under_the_call(
        recorder, monkeypatch):
    # The kernel trainer (its epoch's plain version on the CPU) adds the
    # train stage's spans.
    monkeypatch.setattr(engine, "default_use_kernel", lambda cfg, dev: True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mfcd_tpu_torch.parameter_scan(**SCAN)
    (rec,) = obs.calls()
    assert rec["profiled"] and set(rec["stages"]) == STAGES | TRAIN
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("mfcd."):
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    spans = rec["spans"]
    for name in STAGES | TRAIN:
        mine = sorted((sp["start_ns"], sp["end_ns"]) for sp in spans
                      if sp["name"] == name)
        theirs = sorted(ranges[name])
        assert len(mine) == len(theirs) == rec["stages"][name]["entries"]
        for (s0, s1), (r0, r1) in zip(mine, theirs):
            assert r0 >= s0 - 1_000_000 and r1 <= s1 + 1_000_000
    by_id = _by_id(rec)
    (top,) = [sp for sp in spans if sp["parent"] is None]
    assert top["name"] == "mfcd.call" and top["id"] == spans[0]["id"]
    for sp in spans:
        assert sp["call"] == rec["id"]
        if sp["name"] in STAGES - {"mfcd.call"}:
            assert sp["parent"] == top["id"]
        if sp["name"] in TRAIN:
            assert by_id[sp["parent"]]["name"] == "mfcd.train"
        kids = _children(rec, sp["id"])
        assert sp["host_ns"] == (sp["end_ns"] - sp["start_ns"]) - sum(
            k["end_ns"] - k["start_ns"] for k in kids)


def test_the_oracle_records_its_five_stages_in_one_call(recorder):
    mfcd_tpu_torch.parameter_scan_ground_truth(
        24, 28, 0.4, 2, [1.0, 5.0, 9.0], device="cpu", reps=2)
    (rec,) = obs.calls()          # the inner evaluate calls join it
    assert rec["entry"] == "parameter_scan_ground_truth"
    assert rec["runs"] == 6
    stages = {"mfcd.generate", "mfcd.sample", "mfcd.label", "mfcd.metrics",
              "mfcd.export"}
    assert set(rec["stages"]) == stages | {"mfcd.call"}
    assert all(rec["stages"][n]["entries"] == 3 for n in stages)
    top = rec["spans"][0]["id"]
    assert all(sp["parent"] == top for sp in rec["spans"][1:])
    mfcd_tpu_torch.evaluate_ground_truth(24, 28, 0.4, 2, 5.0, device="cpu",
                                         reps=2)
    assert [r["entry"] for r in obs.calls()] == [
        "parameter_scan_ground_truth", "evaluate_ground_truth"]


def test_a_sync_warning_counts_on_its_span_and_the_mode_comes_back(
        monkeypatch):
    clock = Clock()
    rec = obs.Recorder(event=clock.event, stream=lambda: None)
    modes = [2]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    # No profiler: no mode set, nothing counted, the warning shown.
    with rec.call("scan", "cuda"):
        with obs.span("mfcd.sample", rec):
            with pytest.warns(UserWarning, match="synchronizing"):
                warnings.warn(SYNC)
    assert modes == [2]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CPU]):
            with rec.call("scan", "cuda"):
                assert modes[-1] == "warn"
                with obs.span("mfcd.sample", rec):
                    warnings.warn(SYNC)
                    warnings.warn(SYNC)
                    warnings.warn("another warning")
                with obs.span("mfcd.export", rec):
                    warnings.warn(SYNC)
    assert modes == [2, "warn", 2]
    first, second = rec.calls()
    assert first["stages"]["mfcd.sample"]["syncs"] == 0
    st = second["stages"]
    assert (st["mfcd.sample"]["syncs"], st["mfcd.export"]["syncs"],
            st["mfcd.call"]["syncs"]) == (2, 1, 0)
    assert [str(w.message) for w in seen] == ["another warning"]


def test_card_timeline_shares_edges_and_adds_up_to_the_call():
    clock = Clock()
    rec = obs.Recorder(event=clock.event, stream=lambda: None)

    def work(ms):
        clock.now += ms

    with rec.call("scan", "cuda"):
        work(1)
        with obs.span("mfcd.sample", rec):
            work(2)
            with obs.span("mfcd.label", rec):
                work(4)
            work(8)
        with obs.span("mfcd.metrics", rec):
            work(16)
        work(32)
    spans = 4
    assert clock.made == 2 * spans        # one event an edge
    (r,) = rec.calls()
    card = {n: st["card_ns"] for n, st in r["stages"].items()}
    assert card == {"mfcd.call": 33e6, "mfcd.sample": 10e6,
                    "mfcd.label": 4e6, "mfcd.metrics": 16e6}
    assert r["card_ns"] == 63e6 == sum(card.values())
    assert sum(sp["card_ns"] for sp in r["spans"]) == r["card_ns"]


def test_a_call_resolves_at_the_next_entry_or_when_the_log_is_read():
    clock = Clock()
    rec = obs.Recorder(event=clock.event, stream=lambda: None)

    def one_call():
        with rec.call("scan", "cuda"):
            with obs.span("mfcd.sample", rec):
                clock.now += 5

    clock.done = -1.0                     # nothing has completed yet
    one_call()
    clock.done = float("inf")             # the first call has drained
    made = clock.made
    with rec.call("scan", "cuda"):
        # Resolved at this entry, with no wait, its events back in the
        # pool for this call's edges.
        assert clock.elapsed == 3 and clock.synced == 0
        assert rec._log[0]["card_ns"] == 5e6
        with obs.span("mfcd.sample", rec):
            clock.now += 7
        clock.done = clock.now - 1        # the last edge is still queued
    assert clock.made == made
    first, second = rec.calls()
    assert clock.synced == 1              # one wait, on the newest call
    assert (first["card_ns"], second["card_ns"]) == (5e6, 7e6)
    # A call whose events have not completed waits for the log.
    clock.done = -1.0
    one_call()
    with rec.call("scan", "cuda"):
        assert rec._log[-1]["card_ns"] is None
    assert all(r["card_ns"] is not None for r in rec.calls())


def test_the_log_is_bounded_and_keeps_raw_spans_of_the_newest_calls():
    rec = obs.Recorder(capacity=5, raw_calls=2)
    for _ in range(7):
        with rec.call("scan", "cpu"):
            with obs.span("mfcd.sample", rec):
                pass
    log = rec.calls()
    assert [r["id"] for r in log] == [3, 4, 5, 6, 7]
    assert ["spans" in r for r in log] == [False, False, False, True, True]
    assert obs.CALL_LOG >= 1024


def test_results_are_the_same_bits_with_and_without_the_profiler(recorder):
    plain = mfcd_tpu_torch.parameter_scan(**SCAN)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = mfcd_tpu_torch.parameter_scan(**SCAN)
    assert [r["params"] for r in plain] == [r["params"] for r in traced]
    for a, b in zip(plain, traced):
        assert a["results"].keys() == b["results"].keys()
        for k in a["results"]:
            np.testing.assert_array_equal(np.asarray(a["results"][k]),
                                          np.asarray(b["results"][k]))
    assert [r["profiled"] for r in obs.calls()] == [False, True]


def test_trace_clears_the_log_and_prints_the_stage_table(
        recorder, tmp_path, capsys):
    mfcd_tpu_torch.parameter_scan(**SCAN)
    with obs.trace(str(tmp_path), device="cpu"):
        mfcd_tpu_torch.parameter_scan_ground_truth(
            24, 28, 0.4, 2, [1.0, 5.0], device="cpu", reps=2)
    out = capsys.readouterr().out
    assert "profile written to" in out
    assert "stages of 1 calls, 4 runs; a run:" in out
    for name in ("mfcd.generate", "mfcd.sample", "mfcd.label",
                 "mfcd.metrics", "mfcd.export"):
        assert any(line.startswith(name) for line in out.splitlines())
    assert [r["entry"] for r in obs.calls()] == [
        "parameter_scan_ground_truth"]


# -- detail spans and counters ----------------------------------------------

from mfcd_tpu_torch.core.config import RunConfig                # noqa: E402
from mfcd_tpu_torch.sampling import plan_overdraw, prp          # noqa: E402
from mfcd_tpu_torch.sweep.engine import compile_caps            # noqa: E402

STRATEGY_SCAN = dict(device="cpu", n=24, m=28, d=2, p=[0.2, 0.4], s=5.0,
                     num_epochs=2, reps=2)
DETAILS = {prp.TABLES, prp.DRAW}


@pytest.mark.parametrize("strategy,details", [
    ("random", {prp.DRAW}), ("proximity", DETAILS), ("margin", DETAILS),
    ("variance", DETAILS), ("popularity", DETAILS), ("top_k", DETAILS),
    ("svd", DETAILS)])
def test_a_strategies_call_records_the_samplers_detail_spans(
        recorder, strategy, details):
    mfcd_tpu_torch.parameter_scan(strategy=strategy, **STRATEGY_SCAN)
    (rec,) = obs.calls()
    # Detail spans sit beside the stages, never among them: the stages
    # still partition the call.
    assert set(rec["stages"]) == STAGES
    assert set(rec["details"]) == details
    for st in rec["details"].values():
        # tables and draw again for the test top-up
        assert st["entries"] >= 2 and st["host_ns"] > 0
        assert st["card_ns"] is None
    assert sum(st["host_ns"] for st in rec["details"].values()) <= \
        rec["stages"]["mfcd.sample"]["host_ns"]
    assert sum(st["host_ns"] for st in rec["stages"].values()) == \
        rec["host_ns"]


def _cfg(strategy, p):
    return RunConfig(n=24, m=28, d=2, p=p, reps=2, strategy=strategy)


def test_the_candidates_counter_counts_the_shapes_proposed(recorder):
    """On the prefix path the sampler walks its capacities' slots; on the
    overdraw path it proposes its plan for the sample and for the top-up."""
    for strategy in ("random", "variance"):
        mfcd_tpu_torch.parameter_scan(strategy=strategy, **STRATEGY_SCAN)
    rand, var = obs.calls()
    assert rand["counters"] == {prp.CANDIDATES: sum(
        2 * sum(compile_caps(_cfg("random", p))) for p in STRATEGY_SCAN["p"])}
    want = 0
    for p in STRATEGY_SCAN["p"]:
        cfg = _cfg("variance", p)
        assert prp.fast_path_kind("variance", 24, 28,
                                  *compile_caps(cfg)) is None
        want += 2 * sum(plan_overdraw("variance", cap, 24, 28)
                        for cap in compile_caps(cfg))
    assert var["counters"] == {prp.CANDIDATES: want}
    # Outside a call nothing is counted, and a counter needs no span.
    obs.count(prp.CANDIDATES, 5)
    rec = obs.Recorder()
    with rec.call("scan", "cpu"):
        rec.count("x", 2)
        rec.count("x", 3)
    assert rec.calls()[0]["counters"] == {"x": 5}


def _stage_with_details(rec, clock, with_details: bool):
    def work(ms):
        clock.now += ms

    with rec.call("scan", "cuda"):
        with obs.stages(rec) as stage:
            stage("mfcd.generate")
            work(1)
            stage("mfcd.sample")
            with rec.details():
                work(2)
                if with_details:
                    rec.detail(prp.TABLES)
                work(4)
                if with_details:
                    rec.detail(prp.DRAW)
                work(8)
                if with_details:
                    rec.detail(prp.TABLES)   # the top-up's tables
                work(16)
                if with_details:
                    rec.detail(prp.DRAW)
                work(32)
            work(64)
            stage("mfcd.label")
            work(128)


def test_detail_spans_leave_the_stages_self_times_as_they_were():
    made, records = [], []
    for with_details in (False, True):
        clock = Clock()
        rec = obs.Recorder(event=clock.event, stream=lambda: None)
        _stage_with_details(rec, clock, with_details)
        (r,) = rec.calls()
        made.append(clock.made)
        records.append(r)
    plain, detailed = records
    for r in records:
        card = {n: st["card_ns"] for n, st in r["stages"].items()}
        assert card == {"mfcd.call": 0, "mfcd.generate": 1e6,
                        "mfcd.sample": 126e6, "mfcd.label": 128e6}
        assert r["card_ns"] == sum(card.values()) == 255e6
    assert plain["details"] == {}
    assert {n: (st["entries"], st["card_ns"])
            for n, st in detailed["details"].items()} == {
        prp.TABLES: (2, 20e6), prp.DRAW: (2, 40e6)}
    # four switches and the close at the block's end, one event each
    assert made[1] == made[0] + 5


def test_detail_edges_add_no_wait_and_reuse_events(monkeypatch):
    """A detail edge records an event and reads nothing back: no wait, no
    query, no elapsed time until the call resolves, when its events return
    to the pool."""
    clock = Clock()
    rec = obs.Recorder(event=clock.event, stream=lambda: None)
    reads = []
    for name in ("synchronize", "query", "elapsed_time"):
        orig = getattr(FakeEvent, name)

        def counted(self, *a, _orig=orig, _name=name):
            reads.append(_name)
            return _orig(self, *a)
        monkeypatch.setattr(FakeEvent, name, counted)
    with rec.call("scan", "cuda"):
        with obs.span("mfcd.sample", rec):
            with rec.details():
                for name in (prp.TABLES, prp.DRAW) * 3:
                    rec.detail(name)
                    clock.now += 1
    assert reads == []
    made = clock.made
    (r,) = rec.calls()
    assert reads.count("synchronize") == 1        # the log's one wait
    assert r["details"][prp.DRAW]["card_ns"] == 3e6
    _stage_with_details(rec, clock, True)
    assert clock.made == made                     # every event reused


def test_a_detail_outside_a_block_or_a_call_is_nothing(recorder):
    clock = Clock()
    rec = obs.Recorder(event=clock.event, stream=lambda: None)
    rec.detail(prp.DRAW)                      # no call
    with rec.call("scan", "cuda"):
        with obs.span("mfcd.sample", rec):
            rec.detail(prp.DRAW)              # no details block
            with rec.details():
                with rec.details():           # an inner block keeps it open
                    rec.detail(prp.DRAW)
                clock.now += 3
            clock.now += 5
    (r,) = rec.calls()
    assert r["details"][prp.DRAW]["card_ns"] == 3e6
    assert r["stages"]["mfcd.sample"]["card_ns"] == 8e6
