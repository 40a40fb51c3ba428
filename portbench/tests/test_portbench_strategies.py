"""The configuration ``strategies_1000`` (``Runs.ipynb`` cell 18) on the
CPU: the program's sample stage against the plain reference's
(``reference/strategies_1000.py``) on every path each of the seven
samplers takes, the cell's own shapes among them; whole calls of each
strategy within the cell's limits; the readers of the sampler's detail
spans and counter; and what the reference refuses."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mfcd_tpu_torch
from mfcd_tpu_torch.core import prng, rng
from mfcd_tpu_torch.core.config import RunConfig
from mfcd_tpu_torch.data.btl import sample_and_split
from mfcd_tpu_torch.genx import generate_x
from mfcd_tpu_torch.sampling import prp
from mfcd_tpu_torch.sweep import engine
from portbench import check, run, spec, workload
from portbench.reference import strategies_1000 as ref
from portbench.reference.pipeline import Shape

CELL = "canonical.strategies"
STRATEGIES = list(ref.STRATEGIES)
SEED = 2**31 + 77


def _cell():
    return spec.load_cell(CELL)


def _splits(strategy, n, m, p, K=1, reps=2, seed=SEED):
    """The program's and the reference's sample stage of one shape from
    the same keys and X, and the path the program took."""
    cfg = RunConfig(n=n, m=m, d=2, p=p, reps=reps, K=K, strategy=strategy)
    sh = cfg.shapes()
    t_cap, e_cap = engine.compile_caps(cfg)
    keys = rng.rep_keys(rng.config_key(prng.key(seed), 3), reps)
    st = rng.rep_streams(keys)
    x = generate_x(st["x_gen"], n, m, 2, "base")
    t, e = sh.num_triplets, sh.extra_test_triplets
    budget = extra = None
    if (t, e) != (t_cap, e_cap):
        budget = torch.full((reps,), t, dtype=torch.int32)
        extra = torch.full((reps,), e, dtype=torch.int32)
    got = sample_and_split(st, x, t_cap, e_cap, strategy, budget=budget,
                           extra_budget=extra)
    pipe = ref.Pipeline("cpu")
    rsh = Shape(n=n, m=m, d=2, p=p, K=K, num_epochs=1, batch_size=64,
                reshuffle_period=4, strategy=strategy,
                popularity_method="zipf", alpha=1.5)
    assert (rsh.triplets, rsh.extra_test) == (t, e)
    assert ref.capacities(rsh) == (t_cap, e_cap)
    want = pipe.sample_stage(pipe.streams(keys), x, rsh)
    kind = prp.fast_path_kind(strategy, n, m, t_cap, e_cap)
    return got, want, kind, t


def _assert_same(got, want):
    for (tri, count), g_tri, g_count in zip(
            want, (got.train, got.val, got.test),
            (got.train_count, got.val_count, got.test_count)):
        assert tri.dtype == torch.int32 and tri.shape == g_tri.shape
        assert torch.equal(tri, g_tri.to(torch.int32))
        assert torch.equal(count.to(torch.int64), g_count.to(torch.int64))


# Shapes that take each path: at n = 24, m = 28 and K = 1 the test split
# is topped up with ~500 triplets, which sends all but random to the
# overdraw path; K = 50 needs no top-up, so top_k, svd and random take
# their permutation prefix and margin its distinct proposals; proximity's
# prefix needs m >= 200.
PATHS = ([(s, 24, 28, p, 1, None if s == "random" else "overdraw")
          for s in STRATEGIES for p in (0.1, 0.4, 0.9)]
         + [(s, 24, 28, 0.4, 50, "prefix") for s in ("random", "top_k",
                                                      "svd")]
         + [("margin", 24, 28, 0.4, 50, "distinct"),
            ("proximity", 24, 200, 0.05, 1, "prefix"),
            ("proximity", 24, 200, 0.05, 50, "prefix")])


@pytest.mark.parametrize("strategy,n,m,p,K,path", PATHS)
def test_the_sample_stage_is_the_references_bit_for_bit(strategy, n, m, p,
                                                        K, path):
    # variance and popularity select by float CDFs: from the same X the
    # reference sums and scans them in the same fixed point, so they
    # agree bit for bit too
    got, want, kind, _ = _splits(strategy, n, m, p, K)
    assert (kind or "overdraw") == (path or "prefix")
    _assert_same(got, want)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_the_cells_own_shapes_sample_the_same_triplets(strategy):
    # n = m = 1000 at the grid's ends, one run each: the paths the card
    # takes (four prefixes, margin's distinct proposals, two overdraws)
    for p in (0.01, 0.2):
        got, want, kind, t = _splits(strategy, 1000, 1000, p, reps=1)
        assert kind == {"margin": "distinct", "variance": None,
                        "popularity": None}.get(strategy, "prefix")
        _assert_same(got, want)
        counts = sum(int(c[0]) for _, c in want)
        assert counts <= t


def _small_call(strategy):
    cell = _cell()
    plan = workload.Plan(cell.traffic["entry"], cell.config["study"],
                         cell.traffic, SEED)
    args = dict(plan.call(0), n=24, m=28, num_epochs=3, strategy=strategy,
                p=[0.0137, 0.0663, 0.2])
    return cell, args


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_each_strategy_is_within_the_cells_limits(strategy, monkeypatch):
    monkeypatch.setattr(engine, "default_use_kernel", lambda cfg, dev: True)
    cell, args = _small_call(strategy)
    fn = mfcd_tpu_torch.parameter_scan
    results = fn(device="cpu", **run.call_args(fn, args))
    assert len(results) == 3
    refs = check.reference_results(cell.reference("cpu"), "parameter_scan",
                                   args, cell.config)
    # the 23 result keys, all but the train loss compared
    assert all(len(r["results"]) == 23 for r in results)
    assert set(check.key_gaps([r["results"] for r in results], refs)) == \
        set(results[0]["results"]) - set(check.UNCOMPARED)
    nums = check.numbers_against("parameter_scan", results, refs)
    assert check.verdict(nums, cell.limits, 0), nums
    assert nums["data_gap"] == 0.0


def test_the_cell_finds_its_own_reference():
    cell = _cell()
    assert cell.reference.__module__.endswith("reference_strategies_1000")
    assert issubclass(cell.reference, ref.pipeline.Pipeline)
    assert cell.traffic["warmup_calls"] == len(STRATEGIES)
    assert workload.Plan("parameter_scan", cell.config["study"],
                         cell.traffic, SEED).runs_per_call() == 60
    st = cell.config["study"]
    assert st["strategy"] == STRATEGIES == cell.traffic["cycle"][0][1]
    assert st["p"] == cell.traffic["grid"]["p"] == [
        round(float(p), 4) for p in np.logspace(-2, np.log10(0.2), 20)]


@pytest.mark.parametrize("setting,value", [
    ("strategy", "cluster"), ("strategy", "user_similarity"),
    ("generation", "svd"), ("generation", "gmm"), ("d1", 3),
    ("popularity_method", "pareto")])
def test_the_reference_refuses_what_it_does_not_compute(setting, value):
    sh = Shape(n=6, m=7, d=2, p=0.5, K=1, num_epochs=1, batch_size=8,
               reshuffle_period=4, **{setting: value})
    pipe = ref.Pipeline("cpu")
    with pytest.raises(NotImplementedError,
                       match=f"not {setting}={value!r}"):
        pipe.study_runs([1], [0], [1.0], [1e-3], [0.0], 1, sh)
    with pytest.raises(NotImplementedError, match=setting):
        pipe.oracle_runs([1], [0], [1.0], 1, sh)


# -- the readers of the sampler's detail spans and counter -----------------

def _record(runs, profiled=False, card=True, tables=None, draw=None,
            candidates=None):
    details = {}
    for name, ms in ((prp.TABLES, tables), (prp.DRAW, draw)):
        if ms is not None:
            details[name] = dict(entries=1, host_ns=0,
                                 card_ns=ms * 1e6 if card else None)
    rec = dict(entry="parameter_scan", id=0, runs=runs, profiled=profiled,
               card=card, host_ns=0, card_ns=0 if card else None,
               stages={"mfcd.sample": dict(entries=1, host_ns=0,
                                           card_ns=0 if card else None,
                                           syncs=0)})
    if details or candidates is not None:
        rec["details"] = details
        rec["counters"] = ({} if candidates is None
                           else {prp.CANDIDATES: candidates})
    return rec


def _ctx(calls):
    cell = _cell()
    plan = workload.Plan(cell.traffic["entry"], cell.config["study"],
                         cell.traffic, SEED)
    return dict(cell=cell, plan=plan,
                window=SimpleNamespace(calls=[object()] * calls))


def _read(name, monkeypatch, log, ctx):
    from portbench import stages

    monkeypatch.setattr(stages, "program_log", lambda: log)
    return spec.reader("metrics", name).read(None, ctx)


ASKED = 3 * sum(int(1000 * 1000 * p / 2) for p in
                _cell().traffic["grid"]["p"])


def test_the_readers_take_the_windows_detail_spans_and_counter(monkeypatch):
    assert ASKED == 656_250 * 3
    log = ([_record(60, tables=100.0, draw=100.0, candidates=1)]   # warm-up
           + [_record(60, draw=3.0, candidates=ASKED // 3),
              _record(60, tables=12.0, draw=6.0, candidates=4 * ASKED)]
           + [_record(60, profiled=True, tables=50.0)])
    ctx = _ctx(2)
    assert _read("sample_tables_ms_per_run.strategies", monkeypatch, log,
                 ctx) == pytest.approx(12.0 / 120)
    assert _read("sample_draw_ms_per_run.strategies", monkeypatch, log,
                 ctx) == pytest.approx(9.0 / 120)
    # each call of the 20 p values x 3 reps asked for ASKED triplets
    assert _read("candidates_per_triplet.strategies", monkeypatch, log,
                 ctx) == pytest.approx((ASKED // 3 + 4 * ASKED)
                                       / (2 * ASKED))


def test_a_program_without_detail_spans_reads_none(monkeypatch):
    # the parent's records: stages only
    log = [_record(60)] * 3
    for name in ("sample_tables_ms_per_run.strategies",
                 "sample_draw_ms_per_run.strategies",
                 "candidates_per_triplet.strategies"):
        assert _read(name, monkeypatch, log, _ctx(2)) is None
        assert _read(name, monkeypatch, None, _ctx(2)) is None
    host_only = [_record(60, card=False, tables=1.0, draw=1.0)] * 3
    assert _read("sample_draw_ms_per_run.strategies", monkeypatch,
                 host_only, _ctx(2)) is None


def test_the_cells_files_name_its_configuration_and_limits():
    cell = _cell()
    assert cell.config["name"] == "strategies_1000"
    assert cell.config["reduced"] == []
    assert set(cell.limits) == {"data_gap", "val_gap", "result_gap"}
    assert cell.traffic["check_calls"] == 2
    assert cell.traffic["trace_calls"] == 2


def test_the_metrics_name_the_cell_and_its_rate():
    bench = spec.load_benchmark()
    w = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "strategies_1000", "scan.cell18.reps3", 1)
    rate = next(m for m in bench["end_to_end"]
                if m["name"] == "runs_per_hour.k50")
    assert rate["workloads"] == ["labels_k50.scan", CELL]
    cell = _cell()
    assert [m["name"] for m in cell.end_to_end] == ["runs_per_hour.k50",
                                                    "setup_s"]
    mine = [m for m in cell.per_layer if CELL in m["workloads"]]
    assert [m["name"] for m in mine] == [
        "sample_tables_ms_per_run.strategies",
        "sample_draw_ms_per_run.strategies",
        "candidates_per_triplet.strategies"]
    assert all(m["moves"] == "runs_per_hour.k50" and m["workloads"] == [CELL]
               for m in mine)
