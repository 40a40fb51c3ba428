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
import subprocess
import sys

import pytest
import torch

from portbench import faults, run, spec
from portbench.reference.pipeline import Pipeline

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
        self.pipe = pipe or Pipeline("cpu", tf32=True)

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
    line = _run(cell, program=_Control(cell, Pipeline("cpu")))
    assert line["correct"] is True


# The same faults planted in the reference put in the program's place, as
# readings.py --faults reads them at a cell's own size on the card.
REF_CASES = [(c, f) for c in CELLS for f in (
    faults.ORACLE if c == "canonical.oracle" else faults.TRAINING)]


@pytest.mark.parametrize("name,fault", REF_CASES)
def test_a_fault_planted_in_the_reference_is_not_correct(name, fault):
    cell = tiny(name)
    pipe = faults.FaultyPipeline("cpu", fault)
    line = _run(cell, program=_Control(cell, pipe))
    assert line["correct"] is False


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
