"""The window's arithmetic and the call plan: the window closes at the end
of the first call that ends after its length, a rate counts every run of
every whole call over the whole window, the tail is over every call, and
every call takes its own seed from the run's."""

import statistics

import pytest

from portbench import spec, workload


class FakeClock:
    def __init__(self, walls):
        self.t, self.walls, self.k = 0.0, list(walls), 0

    def __call__(self):
        return self.t

    def call(self, k):
        self.t += self.walls[self.k % len(self.walls)]
        self.k += 1
        return True


def test_window_closes_after_the_first_call_past_its_length():
    clock = FakeClock([0.3, 0.5, 0.2])
    w = workload.closed_loop(clock.call, 4, 1.0, clock=clock)
    # 0.3, 0.8, 1.0: the third call ends at 1.0 >= 1.0
    assert len(w.calls) == 3 and w.seconds == pytest.approx(1.0)
    clock = FakeClock([0.3, 0.5, 0.3])
    w = workload.closed_loop(clock.call, 4, 1.0, clock=clock)
    assert len(w.calls) == 3 and w.seconds == pytest.approx(1.1)


def test_rate_counts_whole_calls_over_the_whole_window():
    clock = FakeClock([0.25, 0.75])
    w = workload.closed_loop(clock.call, 4, 10.0, clock=clock)
    assert w.runs == 4 * len(w.calls)
    rate = spec.reader("e2e", "runs_per_hour").read(w, {})
    assert rate == pytest.approx(w.runs * 3600 / w.seconds)
    assert rate == pytest.approx(4 * 2 / 1.0 * 3600)


def test_failed_calls_do_not_count_as_runs():
    calls = iter([True, False, True, True])
    clock = FakeClock([1.0])

    def do(k):
        clock.call(k)
        return next(calls)

    w = workload.closed_loop(do, 3, 4.0, clock=clock)
    assert len(w.calls) == 4 and w.runs == 9


def test_p95_is_over_every_call():
    walls = [0.1] * 95 + [1.0] * 5
    clock = FakeClock(walls)
    w = workload.closed_loop(clock.call, 1, sum(walls) - 0.05, clock=clock)
    assert len(w.calls) == 100
    p95 = spec.reader("e2e", "call_s_p95").read(w, {})
    assert p95 == pytest.approx(workload.percentile(walls, 95))
    assert 0.1 <= p95 <= 1.0
    assert statistics.median(c.wall for c in w.calls) == pytest.approx(0.1)


def test_setup_is_reported_as_measured():
    w = workload.Window([], 0.0, 1.0, setup_s=12.5)
    assert spec.reader("e2e", "setup_s").read(w, {}) == 12.5


CELL3_S = ([float(v) for v in __import__("numpy").logspace(-1, 1, 20)]
           + [1e-4, 1e-3, 1e-2]
           + [float(v) for v in __import__("numpy").logspace(1, 2, 10)])


def test_calls_walk_the_cycle_from_a_seeded_offset():
    c = spec.load_cell("canonical.scan")
    plans = [workload.Plan(c.traffic["entry"], c.config["study"],
                           c.traffic, seed) for seed in (1, 2**31 + 12345)]
    for plan in plans:
        args = [plan.call(k) for k in range(132)]
        combos = [(a["s"], a["weight_decay"]) for a in args]
        # every combination of cell 3's 33 s and 2 wd, twice (s = 10 is
        # in both of its logspaces)
        assert len(set(combos)) == 64
        assert sorted(combos) == sorted(
            [(s, wd) for s in CELL3_S for wd in (5e-6, 5e-3)] * 2)
        assert all(a["weight_decay"] != b["weight_decay"]
                   for a, b in zip(args, args[1:]))
        assert len({a["seed"] for a in args}) == 132
        assert all(0 <= a["seed"] < 2**31 for a in args)
        assert all(a["reps"] == 5 and a["n"] == 1000 for a in args)
    again = workload.Plan(c.traffic["entry"], c.config["study"], c.traffic,
                          2**31 + 12345)
    assert again.call(7) == plans[1].call(7)


def test_values_concatenate_and_take_logspaces():
    spec_ = {"concat": [{"logspace": [-1, 1, 20]}, [1e-4, 1e-3, 1e-2],
                        {"logspace": [1, 2, 10]}]}
    assert workload.values(spec_) == CELL3_S
    assert workload.values([1, 2]) == [1, 2]


def test_the_k10_mix_puts_a_small_wd_in_every_two_calls():
    c = spec.load_cell("labels_k10.scan")
    plan = workload.Plan(c.traffic["entry"], c.config["study"], c.traffic, 3)
    args = [plan.call(k) for k in range(2 * 231)]
    assert {a["weight_decay"] for a in args} == {
        1e-6, 5e-6, 1e-5, 5e-5, 1e-4, 5e-4, 1e-3}
    # 33 values, s = 10 in both of its logspaces
    assert len({a["s"] for a in args}) == 32 and max(
        a["s"] for a in args) == pytest.approx(1e3)
    assert all(min(a["weight_decay"], b["weight_decay"]) <= 5e-5
               for a, b in zip(args, args[1:]))


@pytest.mark.parametrize("cell,runs", [("canonical.grid", 330),
                                       ("canonical.oracle", 165)])
def test_a_grid_call_passes_the_whole_grid(cell, runs):
    c = spec.load_cell(cell)
    plan = workload.Plan(c.traffic["entry"], c.config["study"], c.traffic, 5)
    args = plan.call(0)
    assert args["s"] == CELL3_S and args["reps"] == 5
    if cell == "canonical.grid":
        assert args["weight_decay"] == [5e-6, 5e-3]
    assert plan.runs_per_call() == runs


def test_block_sample_is_a_seeded_run_of_consecutive_calls():
    a, b = workload.BlockSample(3, 9), workload.BlockSample(3, 9)
    for k in range(100):
        a.offer(k)
        b.offer(k)
    block = a.sample()
    assert block == b.sample() and len(block) == 3
    assert block == list(range(block[0], block[0] + 3))
    starts = set()
    for seed in range(200):
        s = workload.BlockSample(2, seed)
        for k in range(10):
            s.offer(k)
        starts.add(s.sample()[0])
    assert starts == set(range(9))          # every block can be drawn
    short = workload.BlockSample(5, 1)
    for k in range(2):
        short.offer(k)
    assert short.sample() == [0, 1]
