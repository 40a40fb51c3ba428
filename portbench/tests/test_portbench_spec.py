"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, limit and metric is found by its name, and the file keeps to
the benchmark's contract (names, units, sources, lengths, run budget)."""

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


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_has_one_rate_of_its_own_bound(cell):
    # a cell's rate is its own metric, so its bound follows its own spread
    c = spec.load_cell(cell)
    rates = [m["name"] for m in c.end_to_end if "runs_per_hour" in m["name"]]
    assert len(rates) == 1
    rate = rates[0]
    for m in BENCH["end_to_end"]:
        if m["name"] == rate:
            assert m["workloads"] == [cell]
    assert {m["moves"] for m in c.per_layer} <= {rate}


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
