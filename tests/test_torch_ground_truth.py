"""The port's ground-truth oracle vs mfcd_tpu's: ``evaluate_ground_truth``
(capacities padded to the JAX package's buckets and exact, a non-base
generation mode, a sampler with a top-up) and ``parameter_scan_ground_truth``
in grid, linear and unsynchronised-linear mode (which falls back to the full
grid instead of raising, as the reference does).

Splits and votes come from the same keys and capacities, so they are
bit-equal; the losses agree to 1e-6 and the accuracies to 1e-5 (X
differs from the JAX one in the last bits).
"""

import numpy as np
import pytest
import torch

import mfcd_tpu
import mfcd_tpu_torch
from mfcd_tpu_torch.ops import kernels

torch.set_num_threads(1)

LOSS_ATOL, ACC_ATOL = 1e-6, 1e-5
BASE = dict(n=24, m=28, p=0.4, d=2, s=5.0, reps=2)


def _close(want, got):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=LOSS_ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=ACC_ATOL)


@pytest.mark.parametrize("kw", [
    {},
    {"pad_compiles": False},
    {"generation": "social", "d": 3, "p": 0.3, "s": 2.0},
    {"generation": "gmm", "pad_compiles": False},
    {"strategy": "variance", "K": 3, "soft_label": True},
], ids=["padded", "exact", "social", "gmm-exact", "variance-K3"])
def test_evaluate_ground_truth_matches_jax(kw):
    args = dict(BASE, **kw)
    want = mfcd_tpu.evaluate_ground_truth(**args)
    before = kernels.EPOCH_LAUNCHES
    got = mfcd_tpu_torch.evaluate_ground_truth(device="cpu", **args)
    assert kernels.EPOCH_LAUNCHES == before
    assert len(got[0]) == len(got[1]) == args["reps"]
    _close(want, got)


def test_padded_and_exact_capacities_differ():
    """The capacity choice changes the PRP bit widths and so the split: the
    two modes are different draws, each the JAX package's."""
    a = mfcd_tpu_torch.evaluate_ground_truth(device="cpu", **BASE)
    b = mfcd_tpu_torch.evaluate_ground_truth(device="cpu", pad_compiles=False,
                                             **BASE)
    assert a != b


@pytest.mark.parametrize("linear,grid", [
    (False, dict(p=[0.2, 0.4], s=[1.0, 5.0])),
    (True, dict(p=[0.2, 0.4], s=[1.0, 5.0])),
    (True, dict(p=[0.2, 0.4], s=[1.0, 5.0, 7.0])),
], ids=["grid", "linear", "unsynchronised-linear"])
def test_parameter_scan_ground_truth_matches_jax(linear, grid):
    args = dict(BASE, linear=linear, **grid)
    want = mfcd_tpu.parameter_scan_ground_truth(**args)
    got = mfcd_tpu_torch.parameter_scan_ground_truth(device="cpu", **args)
    sizes = [len(v) for v in grid.values()]
    expect = (sizes[0] if linear and len(set(sizes)) == 1
              else int(np.prod(sizes)))
    assert len(got) == len(want) == expect
    for a, b in zip(want, got):
        assert a["params"] == b["params"]
        assert set(b["results"]) == {"gt_loss", "gt_accuracy"}
        _close((a["results"]["gt_loss"], a["results"]["gt_accuracy"]),
               (b["results"]["gt_loss"], b["results"]["gt_accuracy"]))


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mfcd_tpu_torch.evaluate_ground_truth(**BASE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mfcd_tpu_torch.parameter_scan_ground_truth(**BASE)
    from mfcd_tpu_torch import sweep

    assert sweep.evaluate_ground_truth is mfcd_tpu_torch.evaluate_ground_truth
    assert (sweep.parameter_scan_ground_truth
            is mfcd_tpu_torch.parameter_scan_ground_truth)
