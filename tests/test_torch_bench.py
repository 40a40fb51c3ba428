"""The port's bench (``mfcd_tpu_torch/bench.py``) and ``run_bucket``'s
``use_kernel``: the one-JSON-line contract on the CPU, the metric names
against the root ``bench.py``'s, a failing measurement, the autograd
comparison's outcomes, and ``run_bucket`` against the JAX package's at
label redundancy K = 1 and 4, hard and soft.

Against JAX, ``run_bucket(use_kernel=False)`` and ``run_bucket(
use_pallas=False)`` from the same seed keep the same rows per rep (the
masked row metrics' lengths are equal) and agree on the 23 keys at
``tests/test_torch_engine.py``'s rtol 1e-4 / atol 1e-5.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mfcd_tpu.core.config import RunConfig as JConfig
from mfcd_tpu.core.results import RESULT_KEYS
from mfcd_tpu.sweep.batched import run_bucket as jax_run_bucket
from mfcd_tpu_torch import bench as B
from mfcd_tpu_torch.core.config import RunConfig
from mfcd_tpu_torch.sweep.batched import run_bucket

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAST_GOOD = os.path.join(REPO, "BENCH_LAST_GOOD.json")
SMALL = dict(n=20, m=25, d=2, p=0.4, s=3.0, lr=1e-2, weight_decay=1e-5,
             num_epochs=2, reps=2)
ROWS = [{"s": 3.0, "lr": 1e-2, "weight_decay": 1e-5},
        {"s": 5.0, "lr": 3e-2, "weight_decay": 1e-4}]


def test_quick_prints_one_json_line_and_writes_nothing():
    before = open(LAST_GOOD, "rb").read()
    proc = subprocess.run(
        [sys.executable, "-m", "mfcd_tpu_torch.bench", "--quick", "--device",
         "cpu"], capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, proc.stdout
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "card"}
    assert rec["metric"] == "quick_smoke_runs_per_hour_per_chip_100x100"
    assert rec["unit"] == "runs/hour/chip" and rec["card"] == "cpu"
    assert rec["value"] > 0
    # The package's own prints and the timings went to stderr.
    assert "trainer = eager on cpu" in proc.stderr
    assert "triplet-grads/s" in proc.stderr
    assert open(LAST_GOOD, "rb").read() == before


def _jax_bench_metric(argv, monkeypatch, capsys) -> str:
    """The metric the root bench.py names for ``argv``, read from its
    degraded payload (device unreachable), as ``tests/test_bench.py``
    does."""
    sys.path.insert(0, REPO)
    try:
        import bench
    finally:
        sys.path.remove(REPO)
    monkeypatch.setattr(bench, "device_reachable", lambda: False)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setattr(bench, "_acquire_tpu_lock", lambda: True)
    monkeypatch.setattr(sys, "argv", ["bench.py"] + argv)
    capsys.readouterr()
    bench.main()
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["value"] == 0.0 and "error" in rec
    return rec["metric"]


@pytest.mark.parametrize("mode", ["default", "quick", "sweep", "k10", "k50"])
def test_metric_names_are_the_jax_benchs(mode, monkeypatch, capsys):
    argv = [] if mode == "default" else [f"--{mode}"]
    assert B.METRICS[mode] == _jax_bench_metric(argv, monkeypatch, capsys)


def test_a_failing_measurement_exits_nonzero_without_json():
    # The bench's main in a fresh interpreter, run_bucket replaced first.
    prog = ("import sys\n"
            "import mfcd_tpu_torch.sweep.batched as b\n"
            "def boom(*a, **k):\n"
            "    raise RuntimeError('measurement failed')\n"
            "b.run_bucket = boom\n"
            "from mfcd_tpu_torch import bench\n"
            "sys.exit(bench.main(['--quick', '--device', 'cpu']))")
    proc = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                          text=True, cwd=REPO, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "measurement failed" in proc.stderr


@pytest.mark.parametrize("outcome", ["finished", "timed_out", "failed"])
def test_autograd_comparison_outcomes(outcome, monkeypatch):
    """The K fields: the speedup where the child finished, ``jnp_path``
    where it ran past its limit, and a raise where it failed."""
    monkeypatch.setattr(B, "measure_kn", lambda k, use_kernel, device: dict(
        s_per_run=2.0, runs_per_hour=1800.0))

    def child(cmd, **kw):
        assert cmd[-4:] == ["--_kn-jnp", "10", "--device", "cpu"]
        assert kw["timeout"] == 60
        if outcome == "timed_out":
            raise subprocess.TimeoutExpired(cmd, kw["timeout"])
        return subprocess.CompletedProcess(
            cmd, 0 if outcome == "finished" else 1, stdout="log\n9.0\n")

    monkeypatch.setattr(B.subprocess, "run", child)
    if outcome == "failed":
        with pytest.raises(RuntimeError, match="rc 1"):
            B._kn_fields(10, "cpu", 60, prefix="k10_")
        return
    fields, m = B._kn_fields(10, "cpu", 60, prefix="k10_")
    assert m["s_per_run"] == 2.0
    assert fields["k10_pallas_runs_per_hour"] == 1800.0
    if outcome == "finished":
        assert fields == {"k10_pallas_runs_per_hour": 1800.0,
                          "k10_pallas_speedup_vs_jnp": 4.5}
    else:
        assert set(fields) == {"k10_pallas_runs_per_hour", "jnp_path"}
        assert "60 s limit" in fields["jnp_path"]
    skipped, _ = B._kn_fields(10, "cpu", 0)
    assert set(skipped) == {"jnp_path"}


def _flat(v):
    if isinstance(v, list) and v and isinstance(v[0], (list, np.ndarray)):
        return np.concatenate([np.ravel(np.asarray(x, np.float64))
                               for x in v])
    return np.asarray(v, np.float64)


@pytest.mark.parametrize("k,soft", [(1, False), (4, False), (4, True)],
                         ids=["K1-hard", "K4-hard", "K4-soft"])
def test_run_bucket_matches_jax(k, soft):
    cfg = dict(SMALL, K=k, soft_label=soft)
    want = jax_run_bucket(JConfig(**cfg), ROWS, [0, 1], seed=7,
                          use_pallas=False)
    got = run_bucket(RunConfig(**cfg), ROWS, [0, 1], seed=7,
                     use_kernel=False, device="cpu")
    assert len(want) == len(got) == len(ROWS)
    for a, b in zip(want, got):
        assert set(b) == set(RESULT_KEYS)
        for key in RESULT_KEYS:
            assert len(a[key]) == len(b[key]) == SMALL["reps"], key
            assert [np.size(x) for x in a[key]] == [
                np.size(y) for y in b[key]], key
            np.testing.assert_allclose(_flat(b[key]), _flat(a[key]),
                                       rtol=1e-4, atol=1e-5, err_msg=key)


def test_run_bucket_use_kernel():
    """``True`` where the kernel does not fit raises before any work;
    ``True`` on the CPU trains with the kernel trainer's plain epoch, which
    agrees with the eager trainer (``False``) as in ``run_config``."""
    wide = RunConfig(n=60000, m=60000, d=2, p=1e-6, num_epochs=1)
    with pytest.raises(ValueError, match="does not fit"):
        run_bucket(wide, ROWS[:1], [0], use_kernel=True, device="cpu")
    cfg = RunConfig(**dict(SMALL, K=4, soft_label=True))
    a = run_bucket(cfg, ROWS, [0, 1], seed=7, use_kernel=True, device="cpu")
    b = run_bucket(cfg, ROWS, [0, 1], seed=7, use_kernel=False, device="cpu")
    for x, y in zip(a, b):
        for key in RESULT_KEYS:
            np.testing.assert_allclose(_flat(x[key]), _flat(y[key]),
                                       rtol=1e-4, atol=1e-5, err_msg=key)
