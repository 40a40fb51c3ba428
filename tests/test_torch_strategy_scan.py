"""Every sampling strategy end to end: the port's ``parameter_scan`` vs
``mfcd_tpu``'s, and the port's ``parameter_scan_fast`` vs its sequential
scan.

At ``tests/test_torch_engine.py``'s shape (n = 24, m = 28, d = 2, p = 0.4,
two epochs) every strategy takes the overdraw path with the exclude
top-up, and every sampler output is bit-equal to the JAX package's given
its X (``test_torch_strategies.py``), so the 23 keys are held to that
file's bar, rtol 1e-4 / atol 1e-5 (float32 rounding of X, the trainer and
the metrics over two epochs).  Within the port, batching changes no key
or stream: the fast path equals the sequential scan bit for bit on the
CPU.
"""

import numpy as np
import pytest
import torch

import mfcd_tpu
from mfcd_tpu.core.results import RESULT_KEYS
import mfcd_tpu_torch

torch.set_num_threads(1)

CFG = dict(n=24, m=28, d=2, p=0.4, s=[1.0, 4.0], lr=1e-2, weight_decay=1e-5,
           num_epochs=2, reps=2, K=1)
STRATEGIES = ("proximity", "margin", "variance", "popularity", "top_k",
              "cluster", "user_similarity", "svd")


def _flat(v):
    if isinstance(v, list) and v and isinstance(v[0], (list, np.ndarray)):
        return np.concatenate([np.ravel(np.asarray(x, np.float64))
                               for x in v])
    return np.asarray(v, np.float64)


@pytest.fixture(scope="module", params=STRATEGIES)
def scans(request):
    strategy = request.param
    return (strategy,
            mfcd_tpu.parameter_scan(strategy=strategy, **CFG),
            mfcd_tpu_torch.parameter_scan(device="cpu", strategy=strategy,
                                          **CFG),
            mfcd_tpu_torch.parameter_scan_fast(device="cpu",
                                               strategy=strategy, **CFG))


def test_scan_matches_jax(scans):
    strategy, want, got, _ = scans
    assert len(want) == len(got) == len(CFG["s"])
    for a, b in zip(want, got):
        assert a["params"] == b["params"]
        assert a["params"]["strategy"] == strategy
        assert set(b["results"]) == set(RESULT_KEYS)
        for k in RESULT_KEYS:
            np.testing.assert_allclose(_flat(b["results"][k]),
                                       _flat(a["results"][k]), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{strategy} {k}")


def test_fast_scan_equals_sequential(scans):
    strategy, _, seq, fast = scans
    assert len(seq) == len(fast)
    for a, b in zip(seq, fast):
        assert a["params"] == b["params"]
        for k in RESULT_KEYS:
            np.testing.assert_array_equal(_flat(b["results"][k]),
                                          _flat(a["results"][k]),
                                          err_msg=f"{strategy} {k}")


@pytest.mark.parametrize("strategy", ["margin", "variance"])
def test_capped_bucket_with_two_budgets(strategy):
    """p = 0.3 and 0.35 share the capacity bucket (t_cap 128) with budgets
    100 and 117: one chunk whose ``[R]`` budget differs per configuration
    (margin's window follows it).  Fast equals sequential bit for bit and
    matches the JAX package's fast path at the bar above."""
    from mfcd_tpu.sweep.batched import parameter_scan_fast as jfast

    kw = dict(CFG, p=[0.3, 0.35], s=[4.0], strategy=strategy)
    fast = mfcd_tpu_torch.parameter_scan_fast(device="cpu", **kw)
    seq = mfcd_tpu_torch.parameter_scan(device="cpu", **kw)
    want = jfast(**kw)
    for a, b, c in zip(want, seq, fast):
        assert a["params"] == b["params"] == c["params"]
        for k in RESULT_KEYS:
            np.testing.assert_array_equal(_flat(c["results"][k]),
                                          _flat(b["results"][k]), err_msg=k)
            np.testing.assert_allclose(_flat(c["results"][k]),
                                       _flat(a["results"][k]), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_shortfall_warnings_match_jax(capsys):
    """A popularity law too steep for the budget (exponential, alpha = 3):
    both packages fall short and print the same warning per run."""
    kw = dict(CFG, s=[1.0], num_epochs=1, strategy="popularity",
              popularity_method="exponential", alpha=3.0)
    mfcd_tpu.parameter_scan(**kw)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("⚠️ Only")]
    mfcd_tpu_torch.parameter_scan(device="cpu", **kw)
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("⚠️ Only")]
    assert len(want) == kw["reps"] and got == want
