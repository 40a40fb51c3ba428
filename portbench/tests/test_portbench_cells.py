"""Every cell's run at a tiny size on the CPU: the harness drives the
program's entry through the window, recomputes the sampled calls with the
plain reference and finds them correct; the control (the reference in
TF32, put in the program's place) and each fault a cell can have (a step
that returns its state unchanged, half of each batch left out with the
mean taken over the rest, an answer altered where it is produced: a
run's test accuracy moved by one point, or in the oracle its
ground-truth accuracy by one test label) come out not correct.  The cells run on one card, so no exchange between cards
can be left out.  Without a card, the command refuses to measure."""

import copy
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import faults, run, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SEED = 2**31 + 4321


def tiny(name):
    cell = copy.deepcopy(spec.load_cell(name))
    cell.config["study"].update(n=24, m=28, p=0.4, num_epochs=3)
    cell.traffic.update(check_calls=2, warmup_calls=1)
    if "grid" in cell.traffic:
        cell.traffic["grid"]["s"] = [0.5, 3.0]
    return cell


def _run(cell, program=None):
    return run.execute(cell, SEED, 0.3, False, "cpu", program=program)


@pytest.fixture
def kernel_path(monkeypatch):
    """The program's fused-epoch trainer on the CPU (the kernel's plain
    version), the path the card runs."""
    from mfcd_tpu_torch.sweep import engine

    monkeypatch.setattr(engine, "default_use_kernel", lambda cfg, dev: True)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name, kernel_path):
    line = _run(tiny(name))
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert list(line)[-1] == "checks"
    cell = spec.load_cell(name)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    for k, v in line["checks"].items():
        assert v["value"] is not None and v["value"] <= v["limit"]


class _Control:
    """The reference, by default computed with TF32 products, in the
    program's place."""

    def __init__(self, cell, pipe=None):
        self.cell = cell
        self.pipe = pipe or cell.reference("cpu", tf32=True)

    def _results(self, entry, args):
        from portbench import check

        out = check.reference_results(self.pipe, entry, args,
                                     self.cell.config)
        return [{"params": {}, "results": r} for r in out]

    def parameter_scan(self, device=None, **args):
        return self._results("parameter_scan", args)

    def parameter_scan_fast(self, device=None, **args):
        return self._results("parameter_scan_fast", args)

    def parameter_scan_ground_truth(self, device=None, **args):
        return self._results("parameter_scan_ground_truth", args)


@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_is_not_correct(name):
    cell = tiny(name)
    line = _run(cell, program=_Control(cell))
    assert line["correct"] is False
    assert any(v["value"] > v["limit"] for v in line["checks"].values())


def _state_unchanged(monkeypatch):
    from mfcd_tpu_torch.train import kernel_trainer

    orig = kernel_trainer.train_epoch

    def step(state, *a, **k):
        _, loss = orig(state, *a, **k)
        return state, loss

    monkeypatch.setattr(kernel_trainer, "train_epoch", step)


def _half_batch(monkeypatch):
    from mfcd_tpu_torch.ops import kernels

    orig = kernels._forward

    def forward(p_u, p_v, u, i, j, z, mask):
        mask = mask.clone()
        mask[..., mask.shape[-1] // 2:] = 0
        return orig(p_u, p_v, u, i, j, z, mask)

    monkeypatch.setattr(kernels, "_forward", forward)


def _answer_altered(monkeypatch):
    from mfcd_tpu_torch.sweep import engine, ground_truth

    orig_all = engine.compute_all_metrics

    def metrics(params, x, s, test, *a, **k):
        out = orig_all(params, x, s, test, *a, **k)
        acc = out["accuracy"].clone()
        acc[0] += faults.POINT                    # one point more
        out["accuracy"] = acc
        return out

    orig_gt = ground_truth.ground_truth_metrics

    def gt(x, split, bs):
        loss, acc = orig_gt(x, split, bs)
        acc = acc.clone()
        acc[0] += 1.0 / float(split.count[0])    # one test label more
        return loss, acc

    monkeypatch.setattr(engine, "compute_all_metrics", metrics)
    monkeypatch.setattr(ground_truth, "ground_truth_metrics", gt)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}
TRAINING = [c for c in CELLS if c != "canonical.oracle"]


# The oracle trains nothing: it has no step or batch to fault.
CASES = [(c, f) for c in CELLS for f in sorted(FAULTS)
         if c in TRAINING or f == "answer_altered"]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_fault_is_not_correct(name, fault, kernel_path, monkeypatch):
    FAULTS[fault](monkeypatch)
    line = _run(tiny(name))
    assert line["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_the_float32_reference_in_the_programs_place_is_correct(name):
    cell = tiny(name)
    line = _run(cell, program=_Control(cell, cell.reference("cpu")))
    assert line["correct"] is True


# The same faults planted in the reference put in the program's place, as
# readings.py --faults reads them at a cell's own size on the card.
REF_CASES = [(c, f) for c in CELLS for f in (
    faults.ORACLE if c == "canonical.oracle" else faults.TRAINING)]


@pytest.mark.parametrize("name,fault", REF_CASES)
def test_a_fault_planted_in_the_reference_is_not_correct(name, fault):
    cell = tiny(name)
    pipe = faults.planted(cell.reference, fault)("cpu")
    line = _run(cell, program=_Control(cell, pipe))
    assert line["correct"] is False


def _as_before(pipe, entry, args, config):
    """The reference's results as the check worked them out before it
    followed the call: one shape, read from the configuration file, for
    every configuration of the call."""
    from portbench import check
    from portbench.reference.pipeline import Shape

    st = config["study"]
    sh = Shape(n=st["n"], m=st["m"], d=st["d"], p=st["p"], K=st["K"],
               num_epochs=st["num_epochs"], batch_size=st["batch_size"],
               reshuffle_period=config["reshuffle_period"],
               soft_label=st["soft_label"])
    oracle = entry == "parameter_scan_ground_truth"
    grid = check._grid(args, check.ORACLE_PARAMS if oracle
                       else check.STUDY_PARAMS)
    seeds, idx = [args["seed"]] * len(grid), list(range(len(grid)))
    col = lambda key: [float(c[key]) for c in grid]
    if oracle:
        loss, acc = pipe.oracle_runs(seeds, idx, col("s"), args["reps"], sh)
        return [{"gt_loss": lo, "gt_accuracy": ac}
                for lo, ac in zip(loss, acc)]
    return pipe.study_runs(seeds, idx, col("s"), col("lr"),
                           col("weight_decay"), args["reps"], sh)


BEFORE = ["canonical.scan", "labels_k10.scan", "canonical.oracle",
          "canonical.grid"]


@pytest.mark.parametrize("name", BEFORE)
def test_the_cells_before_a_reference_by_name_get_the_same_results(name):
    from portbench import check, workload

    cell = tiny(name)
    plan = workload.Plan(cell.traffic["entry"], cell.config["study"],
                         cell.traffic, SEED)
    args = plan.call(0)
    pipe = cell.reference("cpu")
    got = check.reference_results(pipe, plan.entry, args, cell.config)
    want = _as_before(pipe, plan.entry, args, cell.config)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in g:
            for a, b in zip(np.atleast_1d(g[key]), np.atleast_1d(w[key])):
                np.testing.assert_array_equal(a, b)


def test_a_call_over_two_shapes_is_checked_shape_by_shape(kernel_path):
    # K differs from the configuration file's and between configurations:
    # the reference follows the call, one shape after another.
    import mfcd_tpu_torch
    from portbench import check, workload

    cell = tiny("canonical.scan")
    plan = workload.Plan("parameter_scan", cell.config["study"],
                         cell.traffic, SEED)
    args = dict(plan.call(0), K=[2, 3], s=[0.5, 4.0])
    results = mfcd_tpu_torch.parameter_scan(device="cpu",
                                            **run.call_args(
                                                mfcd_tpu_torch.parameter_scan,
                                                args))
    # s expands slower than K: the two shapes interleave
    assert [r["params"]["K"] for r in results] == [2, 3, 2, 3]
    pipe = cell.reference("cpu")
    ref = check.reference_results(pipe, "parameter_scan", args, cell.config)
    nums = check.numbers_against("parameter_scan", results, ref)
    assert check.verdict(nums, cell.limits, 0), nums
    # the K = 3 configurations, worked out alone, as the call's 2nd and 4th
    sh = check.shape_of(check._grid(args)[1], args, cell.config)
    assert sh.K == 3
    alone = pipe.study_runs([args["seed"]] * 2, [1, 3], [0.5, 4.0],
                            [1e-3] * 2, [args["weight_decay"]] * 2,
                            args["reps"], sh)
    for got, want in zip(ref[1::2], alone):
        np.testing.assert_array_equal(got["accuracy"], want["accuracy"])
    # the file's K = 1 shape would have been another computation
    assert check.numbers_against(
        "parameter_scan", results,
        _as_before(pipe, "parameter_scan", args, cell.config)
    )["data_gap"] > 0.01


STAND_IN = """
from portbench.reference import pipeline


class Pipeline(pipeline.Pipeline):
    \"\"\"A stand-in configuration's reference: the plain one, counting
    the calls it works out.\"\"\"

    calls, file = 0, __file__

    def study_runs(self, *args, **kwargs):
        type(self).calls += 1
        return super().study_runs(*args, **kwargs)
"""

DRIVE = """
import copy, json
from mfcd_tpu_torch.sweep import engine
from portbench import run, spec

engine.default_use_kernel = lambda cfg, dev: True
cell = copy.deepcopy(spec.load_cell("stand_in.scan"))
cell.config["study"].update(n=24, m=28, p=0.4, num_epochs=3)
cell.traffic.update(check_calls=2, warmup_calls=1)
line = run.execute(cell, %d, 0.3, False, "cpu")
plain = spec.load_cell("canonical.scan").reference
print(json.dumps({"file": cell.reference.file,
                  "calls": cell.reference.calls,
                  "correct": line["correct"],
                  "plain": plain.__module__,
                  "rates": sorted(line["metrics"])}))
"""


def _files(root):
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


def test_a_configuration_joins_by_new_files_and_entries_alone(tmp_path):
    """A copy of the benchmark gains a configuration with its own
    reference, and a cell judged under a rate the benchmark has: only new
    files and appended entries, and the run finds and uses that
    reference."""
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    before = _files(tmp_path / "portbench")
    base = tmp_path / "portbench"
    config = json.load(open(base / "configs" / "canonical_1000.json"))
    config["name"] = "stand_in"
    json.dump(config, open(base / "configs" / "stand_in.json", "w"))
    (base / "reference" / "stand_in.py").write_text(STAND_IN)
    shutil.copy(base / "limits" / "canonical.scan.json",
                base / "limits" / "stand_in.scan.json")
    grown = copy.deepcopy(bench)
    grown["configs"].append(dict(bench["configs"][0], name="stand_in",
                                 file="portbench/configs/stand_in.json"))
    grown["workloads"].append({"name": "stand_in.scan",
                               "config": "stand_in",
                               "traffic": "scan.cell3.reps5", "chips": 1,
                               "why": "a stand-in"})
    for m in grown["end_to_end"]:
        if m["name"] == "runs_per_hour":
            m["workloads"].append("stand_in.scan")
    json.dump(grown, open(tmp_path / "BENCHMARK.json", "w"))
    after = _files(tmp_path / "portbench")
    assert {k: after[k] for k in before} == before
    assert sorted(set(after) - set(before)) == [
        "configs/stand_in.json", "limits/stand_in.scan.json",
        "reference/stand_in.py"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), spec.ROOT]))
    r = subprocess.run([sys.executable, "-c", DRIVE % SEED],
                       capture_output=True, text=True, cwd=tmp_path,
                       env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["file"] == str(base / "reference" / "stand_in.py")
    assert out["calls"] >= 1 and out["correct"] is True
    assert out["plain"] == "portbench.reference.pipeline"
    assert out["rates"] == ["runs_per_hour", "setup_s"]


def test_without_a_card_the_command_measures_nothing(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "canonical.scan", "--seed", str(SEED),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 3 and out.out == ""
    assert "needs 1 CUDA card" in out.err


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run on the card only")
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "canonical.oracle", "--seed", str(SEED), "--seconds",
                        "2", "--trace", "1"], capture_output=True, text=True,
                       cwd=spec.ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    import json

    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
