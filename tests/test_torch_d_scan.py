"""Cell 13's p x d sweep (``Runs.ipynb`` cell 13; the benchmark's
configuration ``p_d_1000``) through the port's ``parameter_scan`` on the
kernel trainer (K1's plain epoch, the card's arithmetic), at a small size:
against the benchmark's plain reference under the cell's limits, K1's
step and Adam counters against the steps the epochs executed, and the
trainer's choice printed once per shape however often d changes."""

import json
import os

import pytest
import torch

import mfcd_tpu_torch
from mfcd_tpu_torch.core.config import RunConfig
from mfcd_tpu_torch.ops import kernels as K
from mfcd_tpu_torch.sweep import engine
from mfcd_tpu_torch.train import kernel_trainer
from mfcd_tpu_torch.utils import observability as obs
from portbench import check
from portbench.reference.pipeline import Pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M, EPOCHS, REPS, BS = 30, 34, 2, 2, 64
SEED = 2**31 + 1313
P = [0.1, 1.0]


def _json(*parts):
    with open(os.path.join(ROOT, "portbench", *parts)) as f:
        return json.load(f)


CONFIG = _json("configs", "p_d_1000.json")
LIMITS = _json("limits", "d.scan.json")


@pytest.fixture
def kernel_path(monkeypatch):
    """The kernel trainer, its epoch's plain version on the CPU, with the
    configuration's epoch period of fresh shuffles."""
    monkeypatch.setattr(engine, "default_use_kernel", lambda cfg, dev: True)
    monkeypatch.setenv("MFCD_RESHUFFLE_PERIOD",
                       str(CONFIG["reshuffle_period"]))


def _args(d, p):
    st = CONFIG["study"]
    return dict(n=N, m=M, d=d, p=p, s=st["s"], lr=st["lr"],
                weight_decay=st["weight_decay"], num_epochs=EPOCHS,
                reps=REPS, K=st["K"], soft_label=st["soft_label"],
                strategy=st["strategy"], generation=st["generation"],
                batch_size=BS, seed=SEED)


@pytest.mark.parametrize("d", [2, 4, 10])
def test_the_sweep_is_the_references_within_the_cells_limits(d,
                                                            kernel_path):
    args = _args(d, P)
    results = mfcd_tpu_torch.parameter_scan(device="cpu", **args)
    assert [r["params"]["p"] for r in results] == P
    nums = check.numbers(Pipeline("cpu"), "parameter_scan",
                         [(args, results)], CONFIG)
    assert set(nums) == set(LIMITS)
    for key, limit in LIMITS.items():
        assert nums[key] <= limit, (key, nums[key], limit)


@pytest.mark.parametrize("p", P)
@pytest.mark.parametrize("d", [2, 4, 10])
def test_k1_counters_read_the_executed_steps(d, p, kernel_path,
                                             monkeypatch):
    # R x ceil(rows / bs) steps an epoch, counted from the rows the host
    # holds, against the steps the epochs executed by the count each
    # epoch reads; (n + m) d Adam element updates a step.
    executed = []
    inner = kernel_trainer.train_epoch

    def train_epoch(state, stream, lr, wd, step0, count, **kw):
        nb = stream[0].shape[1]
        executed.append(int(torch.clamp(-(-count // BS), max=nb).sum()))
        return inner(state, stream, lr, wd, step0, count, **kw)

    monkeypatch.setattr(kernel_trainer, "train_epoch", train_epoch)
    obs.reset()
    mfcd_tpu_torch.parameter_scan(device="cpu", **_args(d, p))
    counters = obs.calls()[-1]["counters"]
    rows = RunConfig(n=N, m=M, d=d, p=p, K=1).shapes().train_rows
    steps = REPS * -(-rows // BS) * EPOCHS
    assert len(executed) == EPOCHS and sum(executed) == steps
    assert counters[K.RUN_STEPS] == steps
    assert counters[K.ADAM_ELEMENTS] == steps * (N + M) * d


def test_k1_counters_sum_over_a_calls_shapes(kernel_path):
    obs.reset()
    mfcd_tpu_torch.parameter_scan(device="cpu", **_args(4, P))
    counters = obs.calls()[-1]["counters"]
    steps = sum(REPS * -(-RunConfig(n=N, m=M, d=4, p=p).shapes().train_rows
                        // BS) * EPOCHS for p in P)
    assert counters[K.RUN_STEPS] == steps
    assert counters[K.ADAM_ELEMENTS] == steps * (N + M) * 4


def test_the_eager_trainer_counts_nothing():
    obs.reset()
    mfcd_tpu_torch.parameter_scan(device="cpu", **_args(2, 0.1))
    counters = obs.calls()[-1]["counters"]
    assert K.RUN_STEPS not in counters and K.ADAM_ELEMENTS not in counters


def test_the_trainer_choice_prints_once_per_shape(capsys, monkeypatch):
    # d.scan's cycle changes d every call: each shape's choice prints the
    # first time only.
    monkeypatch.setattr(engine, "_printed_kernel_choices", set())
    for d in (2, 4, 2, 4, 10, 2):
        assert engine.default_use_kernel(
            RunConfig(n=1000, m=1000, d=d), "cuda")
    out = capsys.readouterr().out
    assert out.count("trainer = fused-epoch kernel") == 3
    assert out.count("d=2,") == 1 and out.count("d=10,") == 1
    assert "d=10, bs=64, kernel fits: True, smallest C 2" in out
