"""The cell ``d.scan`` (configuration ``p_d_1000``, ``Runs.ipynb`` cell 13)
on the CPU: it loads by name, its plan makes one d's whole p sweep a call
and walks d, every launch it makes is bound by K1's operations, and its two
readers (``k1_roofline.d``, ``run_mfu.d``) give the hand count from the
program's K1 counters, and nothing from a program without them."""

import pytest

from portbench import k1_counts, roofline, spec, stages, workload
from portbench.tracing import Summary
from portbench.workload import Window

CELL = "d.scan"
D = [2, 4, 6, 8, 10]
P = [0.1, 0.2, 0.5, 0.8, 1.0]


def test_the_cell_loads_by_name():
    cell = spec.load_cell(CELL)
    st = cell.config["study"]
    assert cell.chips == 1 and cell.config["name"] == "p_d_1000"
    assert cell.config["reduced"] == []
    assert (st["n"], st["m"], st["K"], st["soft_label"]) == (1000, 1000, 1,
                                                              False)
    assert st["d"] == D and st["p"] == P
    assert (st["s"], st["weight_decay"], st["lr"]) == (5.0, 1e-5, 1e-3)
    assert (st["num_epochs"], st["batch_size"]) == (30, 64)
    assert cell.traffic["reps"] == 5
    assert set(cell.limits) == {"data_gap", "val_gap", "result_gap"}
    assert {m["name"] for m in cell.per_layer} == {"k1_roofline.d",
                                                   "run_mfu.d"}
    rates = [m["name"] for m in cell.end_to_end if m["name"] != "setup_s"]
    assert len(rates) == 1 and "runs_per_hour" in rates[0]


def test_the_plan_makes_25_runs_a_call_and_walks_d():
    cell = spec.load_cell(CELL)
    plan = workload.Plan(cell.traffic["entry"], cell.config["study"],
                         cell.traffic, 2**33 + 17)
    assert plan.runs_per_call() == 25
    calls = [plan.call(k) for k in range(10)]
    for a in calls:
        assert a["p"] == P and a["reps"] == 5 and a["K"] == 1
    ds = [a["d"] for a in calls]
    start = D.index(ds[0])
    assert ds == [D[(start + k) % 5] for k in range(10)]
    # the warm-up calls run every d once
    warm = {plan.call(-1 - k)["d"] for k in
            range(cell.traffic["warmup_calls"])}
    assert warm == set(D)
    assert len({a["seed"] for a in calls}) == 10


@pytest.mark.parametrize("d", D)
def test_every_launch_is_bound_by_its_operations(d):
    # a launch is one epoch of the call's 5 runs of one shape
    for p in P:
        rows = roofline.train_rows(1000, 1000, p, 1)
        steps = 5 * roofline.epoch_steps(rows, 64)
        word = roofline.stream_word_bytes(1000, 1000, 1)
        ops_s = roofline.k1_flops(steps, 1000, 1000, d, 64) / \
            roofline.PEAK_F32_FLOPS
        bytes_s = roofline.k1_bytes(5, steps, 1000, 1000, d, 64, word) / \
            roofline.PEAK_BYTES_PER_S
        assert ops_s >= bytes_s
    assert roofline.k1_flops(5 * 625, 1000, 1000, 2, 64) / 67e12 > 7 * (
        roofline.k1_bytes(5, 5 * 625, 1000, 1000, 2, 64, 4) / 3.35e12)


def _record(steps_by_d, profiled, n=1000, m=1000):
    """A call record whose K1 ran ``steps`` executed steps at each d."""
    steps = sum(steps_by_d.values())
    elements = sum(s * (n + m) * d for d, s in steps_by_d.items())
    return {"profiled": profiled, "runs": 25,
            "counters": {k1_counts.RUN_STEPS: steps,
                         k1_counts.ADAM_ELEMENTS: elements}}


def _hand_ops(steps_by_d):
    return sum(s * roofline.k1_flops(1, 1000, 1000, d, 64)
               for d, s in steps_by_d.items())


def test_the_counters_give_k1_flops_summed_over_mixed_d():
    mixed = {2: 3 * 30 * 625, 10: 5 * 30 * 6250, 6: 7}
    got = k1_counts.flops([_record(mixed, False)],
                          spec.load_cell(CELL).config["study"])
    assert got == pytest.approx(_hand_ops(mixed), rel=1e-15)
    st = spec.load_cell(CELL).config["study"]
    assert k1_counts.flops([], st) is None
    assert k1_counts.flops([{"counters": {}}], st) is None
    assert k1_counts.flops([{"runs": 5}], st) is None


def _ctx(window_calls):
    calls = [type("C", (), {"ok": True, "runs": 25})()
             for _ in range(window_calls)]
    return {"cell": spec.load_cell(CELL), "runs_per_call": 25,
            "traced": {"calls": 2, "runs": 50},
            "window": Window(calls, 0.0, 4.0, 0.0)}


def test_the_readers_give_the_hand_count(monkeypatch):
    # two window calls (d = 4, 6), then two traced calls (d = 8, 10)
    window = [{4: 16250 * 150}, {6: 16250 * 150}]
    traced = [{8: 16250 * 150}, {10: 16250 * 150}]
    log = ([_record({2: 1}, False)]      # a warm-up call, read by neither
           + [_record(s, False) for s in window]
           + [_record(s, True) for s in traced])
    monkeypatch.setattr(stages, "program_log", lambda: log)
    k1_s = 2.5
    s = Summary(window_s=3.0, busy_s=2.8, launches=300,
                by_name={"void epoch_kernel<true, 4, false>(float*)":
                         (150, 1.5),
                         "void epoch_kernel<true, 4, true>(float*)":
                         (150, k1_s - 1.5),
                         "mix_stream_kernel": (150, 0.2)},
                by_span={}, idle_by_span={})
    ctx = _ctx(2)
    share = spec.reader("metrics", "k1_roofline.d").read(s, ctx)
    ops = sum(_hand_ops(x) for x in traced)
    assert share == pytest.approx(100 * ops / 67e12 / k1_s, rel=1e-12)
    mfu = spec.reader("metrics", "run_mfu.d").read(s, ctx)
    ops = sum(_hand_ops(x) for x in window)
    assert mfu == pytest.approx(100 * ops / (4.0 * 67e12), rel=1e-12)
    assert 0 < share < 100 and 0 < mfu < 100


def test_a_program_without_the_counters_reads_none(monkeypatch):
    log = [{"profiled": p, "runs": 25, "counters": {"k1.push_launches": 30}}
           for p in (False, False, True, True)]
    monkeypatch.setattr(stages, "program_log", lambda: log)
    s = Summary(window_s=3.0, busy_s=2.8, launches=30,
                by_name={"void epoch_kernel<true, 4, false>(float*)":
                         (30, 1.0)},
                by_span={}, idle_by_span={})
    for name in ("k1_roofline.d", "run_mfu.d"):
        assert spec.reader("metrics", name).read(s, _ctx(2)) is None
    # and a program that keeps no log at all
    monkeypatch.setattr(stages, "program_log", lambda: None)
    for name in ("k1_roofline.d", "run_mfu.d"):
        assert spec.reader("metrics", name).read(s, _ctx(2)) is None
