"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, limit and metric is found by its name, and the file keeps to
the benchmark's contract (names, units, sources, lengths, run budget)."""

import copy
import json
import os
import re

import pytest

from portbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in cmd)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) < 65536


def test_check_fits_its_budget_with_24_cells():
    # 2 + 14 x cells runs of run_seconds + 60, 2 x 90 s a cell, 1200 spare.
    cells = 24
    total = ((2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 180
             + 1200)
    assert total <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_are_files_under_paths_with_their_source():
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/")
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.load(open(os.path.join(spec.ROOT, c["file"])))
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            # a cut of the study's scale, never a width
            assert NAME.match(key) and key in cfg["study"]
            assert key not in ("n", "m", "d", "batch_size")
            assert key in cfg["assumed"]
        assert c["source"].startswith("https://")
        assert 1 <= len(c["source"]) <= 200 and "\n" not in c["source"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_cells_keep_to_the_contract():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))


def test_metrics_keep_to_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        for cell in m.get("workloads", CELLS):
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_is_found_by_name(cell):
    c = spec.load_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    assert c.limits and all(v >= 0 for v in c.limits.values())
    for m in c.end_to_end:
        assert callable(spec.reader("e2e", m["name"]).read)
    for m in c.per_layer:
        assert callable(spec.reader("metrics", m["name"]).read)
    assert c.traffic["entry"] in ("parameter_scan", "parameter_scan_fast",
                                  "parameter_scan_ground_truth")


def test_oracle_reports_its_own_rate_only():
    c = spec.load_cell("canonical.oracle")
    names = {m["name"] for m in c.end_to_end}
    assert "oracle_runs_per_hour" in names and "runs_per_hour" not in names
    for cell in CELLS:
        if cell != "canonical.oracle":
            names = {m["name"] for m in spec.load_cell(cell).end_to_end}
            assert "oracle_runs_per_hour" not in names


# The cell each rate was made for, whose spread set its bound: it stays
# first in the rate's ``workloads``.  A later cell joins a rate by being
# appended there, where the bound is at least 5x its own spread (PERF.md).
MADE_FOR = {"runs_per_hour": "canonical.scan",
            "runs_per_hour.k10": "labels_k10.scan",
            "runs_per_hour.grid": "canonical.grid",
            "oracle_runs_per_hour": "canonical.oracle",
            "runs_per_hour.k50": "labels_k50.scan"}


def rate_faults(bench) -> list:
    """How ``bench`` breaks the rule of rates: each cell reports exactly
    one rate, every rate lists its cells with the cell it was made for
    first, and every per-layer metric of a cell moves that cell's rate."""
    rates = {m["name"]: m for m in bench["end_to_end"]
             if "runs_per_hour" in m["name"]}
    faults = []
    for name, m in rates.items():
        cells = m.get("workloads", [])
        if not cells or cells[0] != MADE_FOR.get(name):
            faults.append(f"{name} lists {cells}, not "
                          f"{MADE_FOR.get(name)} first")
    for w in bench["workloads"]:
        cell = w["name"]
        mine = [r for r, m in rates.items() if cell in m.get("workloads", [])]
        if len(mine) != 1:
            faults.append(f"{cell} reports {len(mine)} rates: {mine}")
        for m in bench["per_layer"]:
            if cell in m.get("workloads", [cell]) and m["moves"] not in mine:
                faults.append(f"{m['name']} in {cell} moves {m['moves']}")
    return faults


def test_each_cell_reports_one_rate_that_lists_it():
    assert rate_faults(BENCH) == []


def _with_cell(name="canonical.scan2", rates=("runs_per_hour",)):
    """BENCH with one more cell, appended to each of ``rates``."""
    bench = copy.deepcopy(BENCH)
    bench["workloads"].append({"name": name, "config": "canonical_1000",
                               "traffic": "scan.cell3.reps5", "chips": 1,
                               "why": "a second scan"})
    for m in bench["end_to_end"]:
        if m["name"] in rates:
            m["workloads"].append(name)
    return bench


def test_a_cell_appended_to_a_rate_is_accepted():
    bench = _with_cell()
    assert rate_faults(bench) == []
    runs = next(m for m in bench["end_to_end"]
                if m["name"] == "runs_per_hour")
    assert runs["workloads"] == ["canonical.scan", "canonical.scan2"]


@pytest.mark.parametrize("rates", [("runs_per_hour", "runs_per_hour.k10"),
                                   ()], ids=["two rates", "no rate"])
def test_a_cell_with_two_rates_or_none_is_refused(rates):
    assert rate_faults(_with_cell(rates=rates)) == [
        f"canonical.scan2 reports {len(rates)} rates: {list(rates)}"]


def test_a_cell_put_before_the_one_a_rate_was_made_for_is_refused():
    bench = _with_cell()
    runs = next(m for m in bench["end_to_end"]
                if m["name"] == "runs_per_hour")
    runs["workloads"].reverse()
    assert len(rate_faults(bench)) == 1


def test_a_per_layer_metric_that_moves_another_cells_rate_is_refused():
    bench = _with_cell()
    bench["per_layer"][0]["workloads"].append("canonical.scan2")
    assert rate_faults(bench) == []
    bench["per_layer"][1]["workloads"].append("canonical.scan2")
    assert rate_faults(bench) == [
        "launches_per_run.k10 in canonical.scan2 moves runs_per_hour.k10"]


def test_a_split_metric_falls_back_to_its_base_reader():
    assert not os.path.exists(os.path.join(
        spec.HERE, "metrics", "launches_per_run.oracle.py"))
    assert (spec.reader("metrics", "launches_per_run.oracle")
            is spec.reader("metrics", "launches_per_run"))
    assert (spec.reader("e2e", "oracle_runs_per_hour").read
            is spec.reader("e2e", "runs_per_hour").read)
    assert (spec.reader("e2e", "runs_per_hour.grid")
            is spec.reader("e2e", "runs_per_hour"))
    with pytest.raises(FileNotFoundError):
        spec.reader("metrics", "no_such_metric")


@pytest.mark.parametrize("cell", CELLS)
def test_a_configuration_without_a_reference_of_its_own_gets_the_plain_one(
        cell):
    from portbench.reference import pipeline

    c = spec.load_cell(cell)
    assert not os.path.exists(os.path.join(spec.HERE, "reference",
                                           c.config["name"] + ".py"))
    assert c.reference is pipeline.Pipeline


@pytest.mark.parametrize("setting,value", [
    ("strategy", "margin"), ("generation", "svd"),
    ("popularity_method", "zipf"), ("alpha", 1.5), ("d1", 3)])
def test_the_plain_reference_refuses_what_it_does_not_compute(setting,
                                                              value):
    from portbench.reference.pipeline import Pipeline, Shape

    sh = Shape(n=6, m=7, d=2, p=0.5, K=1, num_epochs=1, batch_size=8,
               reshuffle_period=4, **{setting: value})
    pipe = Pipeline("cpu")
    with pytest.raises(NotImplementedError,
                       match=re.escape(f"not {setting}={value!r}")):
        pipe.study_runs([1], [0], [1.0], [1e-3], [0.0], 1, sh)
    with pytest.raises(NotImplementedError, match=setting):
        pipe.oracle_runs([1], [0], [1.0], 1, sh)


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no.such.cell")


def test_every_file_under_paths_is_named_from_name_characters():
    for dirpath, dirs, files in os.walk(spec.HERE):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if f.endswith(".pyc"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), spec.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
