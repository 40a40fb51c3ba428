"""The port's slice as a whole: ``parameter_scan`` vs ``mfcd_tpu``'s, the
pickle protocol, device handling, the pure-Python layer, and the import
rule (no jax, no ``mfcd_tpu`` in the port).

End to end, every one of the 23 result keys agrees at rtol 1e-4 / atol
1e-5: the integer paths (keys, sampler, splits, shuffles) are bit-equal,
and the float paths differ by float32 rounding (erfinv, QR, autodiff) that
two epochs amplify to ~1e-6.
"""

import ast
import os
import pickle

import numpy as np
import pytest
import torch

import mfcd_tpu
from mfcd_tpu.core import config as jconfig
from mfcd_tpu.core import results as jresults
from mfcd_tpu.sweep import engine as jengine
from mfcd_tpu.utils import io as jio
import mfcd_tpu_torch
from mfcd_tpu_torch.core import config as tconfig
from mfcd_tpu_torch.core import results as tresults
from mfcd_tpu_torch.sweep import engine as tengine
from mfcd_tpu_torch.utils import io as tio

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(n=24, m=28, d=2, p=0.4, s=[1.0, 4.0], lr=1e-2,
           weight_decay=1e-5, num_epochs=2, reps=2, K=1)


@pytest.fixture(scope="module")
def scans():
    return mfcd_tpu.parameter_scan(**CFG), mfcd_tpu_torch.parameter_scan(
        device="cpu", **CFG)


def _flat(v):
    if isinstance(v, list) and v and isinstance(v[0], (list, np.ndarray)):
        return np.concatenate([np.ravel(np.asarray(x, np.float64))
                               for x in v])
    return np.asarray(v, np.float64)


def test_parameter_scan_matches_jax(scans):
    want, got = scans
    assert len(want) == len(got) == 2
    for a, b in zip(want, got):
        assert a["params"] == b["params"]
        assert not tresults.validate_schema(b["results"])
        assert set(b["results"]) == set(jresults.RESULT_KEYS)
        for k in jresults.RESULT_KEYS:
            va, vb = a["results"][k], b["results"][k]
            assert len(va) == len(vb) == CFG["reps"], k
            for x, y in zip(va, vb):
                assert np.shape(x) == np.shape(y) or (
                    isinstance(x, list) and len(x) == len(y)), k
            np.testing.assert_allclose(_flat(vb), _flat(va), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_pickle_protocol(tmp_path):
    path = str(tmp_path / "out.pkl")
    with open(path, "wb") as f:
        pickle.dump(["sentinel"], f)  # must be cleared at scan start
    small = dict(CFG, num_epochs=1, reps=1)
    out = mfcd_tpu_torch.parameter_scan(device="cpu", save_path=path,
                                        save_every=1, **small)
    assert out == []  # reference quirk: flushed scans return []
    results = pickle.load(open(path, "rb"))
    assert [e["params"]["s"] for e in results] == [1.0, 4.0]

    # resume keeps the file and runs only the configs not yet in it
    path2 = str(tmp_path / "res.pkl")
    mfcd_tpu_torch.parameter_scan(device="cpu", save_path=path2,
                                  save_every=1, **dict(small, s=[1.0]))
    before = pickle.load(open(path2, "rb"))
    mfcd_tpu_torch.parameter_scan(device="cpu", save_path=path2,
                                  save_every=1, resume=True, **small)
    after = pickle.load(open(path2, "rb"))
    assert len(after) == 2
    assert after[0]["results"]["accuracy"] == before[0]["results"]["accuracy"]
    assert after[1]["results"]["accuracy"] == results[1]["results"]["accuracy"]


def test_device_none_without_cuda_raises_and_linear_checks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mfcd_tpu_torch.parameter_scan(n=10, m=10, d=2, p=0.5, num_epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mfcd_tpu_torch.run_experiment(10, 10, 2, 0.5, 1.0, num_epochs=1)
    with pytest.raises(ValueError, match="not synchronized"):
        mfcd_tpu_torch.parameter_scan(device="cpu", s=[1.0, 2.0],
                                      lr=[1e-3, 1e-2, 1e-1], linear=True)


def test_kernel_trainer_path_matches_eager_path_on_cpu():
    """The engine's kernel branch (packed stream, plain epoch on the CPU)
    against its eager branch: same splits and keys, and the two Adam
    bias-correction forms differ in the last bits only."""
    cfg = tconfig.RunConfig(n=24, m=28, d=2, p=0.4, s=3.0, lr=1e-2,
                            num_epochs=2, reps=2)
    a = tengine.run_config(cfg, use_kernel=True, device="cpu")
    b = tengine.run_config(cfg, use_kernel=False, device="cpu")
    for k in jresults.RESULT_KEYS:
        np.testing.assert_allclose(_flat(a[k]), _flat(b[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_explicit_kernel_at_a_shape_that_does_not_fit_raises():
    cfg = tconfig.RunConfig(n=60000, m=60000, d=2, p=1e-6, num_epochs=1)
    with pytest.raises(ValueError, match="does not fit"):
        tengine.run_config(cfg, use_kernel=True, device="cpu")
    assert not tengine.default_use_kernel(cfg, "cuda")
    small = tconfig.RunConfig(n=1000, m=1000, d=2)
    assert tengine.default_use_kernel(small, "cuda")
    assert not tengine.default_use_kernel(small, "cpu")


def test_batches_above_512_take_the_kernel_trainer():
    """The kernel loops batch rows over its threads, so the shape gate
    alone decides: bs = 1024 runs the kernel trainer on the card, and its
    CPU branch matches the eager one as at bs = 64."""
    assert tengine.default_use_kernel(
        tconfig.RunConfig(n=1000, m=1000, d=2, batch_size=1024), "cuda")
    cfg = tconfig.RunConfig(n=24, m=28, d=2, p=0.9, s=3.0, lr=1e-2,
                            num_epochs=2, reps=1, batch_size=1024)
    a = tengine.run_config(cfg, use_kernel=True, device="cpu")
    b = tengine.run_config(cfg, use_kernel=False, device="cpu")
    for k in jresults.RESULT_KEYS:
        np.testing.assert_allclose(_flat(a[k]), _flat(b[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_config_layer_matches():
    canon = tconfig.RunConfig(n=1000, m=1000, d=2, p=0.2)
    sh = canon.shapes()
    assert sh.train_rows == 80_000 and sh.train_batches == 1_250
    assert sh == tconfig.ShapeInfo(**vars(jconfig.RunConfig(
        n=1000, m=1000, d=2, p=0.2).shapes()))
    for p in (0.2, 0.4, 0.013):
        for K in (1, 3):
            kw = dict(n=24, m=28, d=2, p=p, K=K)
            assert (tengine.compile_caps(tconfig.RunConfig(**kw))
                    == jengine.compile_caps(jconfig.RunConfig(**kw)))
    spec = dict(params={"s": [1.0, 2.0], "lr": [1e-3, 1e-2]}, linear=True)
    assert (tconfig.SweepSpec(**spec).expand()
            == jconfig.SweepSpec(**spec).expand())
    for x in (0, 1, 5, 64, 100_000):
        assert tconfig._next_pow2(x) == jconfig._next_pow2(x)
    assert tconfig.UNCAPPED_STRATEGIES == jconfig.UNCAPPED_STRATEGIES
    assert (tconfig.TRAIN_RATIO, tconfig.VAL_RATIO, tconfig.MIN_TEST_POINTS) \
        == (jconfig.TRAIN_RATIO, jconfig.VAL_RATIO, jconfig.MIN_TEST_POINTS)


def test_export_results_and_pickles_match(tmp_path):
    g = np.random.default_rng(0)
    reps, n, m, e = 2, 5, 6, 3
    dev = {k: g.standard_normal(reps).astype(np.float32)
           for k in tresults._SCALAR_KEYS}
    dev.update({k: g.standard_normal((reps, e)).astype(np.float32)
                for k in tresults._CURVE_KEYS})
    for k, mk in tresults._MASKED_ROW_KEYS.items():
        dev[k] = g.standard_normal((reps, n)).astype(np.float32)
        dev[mk] = g.random((reps, n)) < 0.7
    dev["alpha_per_row"] = g.standard_normal((reps, n)).astype(np.float32)
    dev["sampled_UVT_rows"] = g.standard_normal((reps, 2, m)).astype(
        np.float32)
    dev["sampled_X_rows"] = g.standard_normal((reps, 2, m)).astype(
        np.float32)
    want = jresults.export_results(dict(dev))
    got = tresults.export_results(
        {k: torch.from_numpy(np.asarray(v)) for k, v in dev.items()})
    assert pickle.dumps(want) == pickle.dumps(got)
    assert tresults.RESULT_KEYS == jresults.RESULT_KEYS

    entry = [{"params": {"s": 1.0}, "results": want}]
    a, b = str(tmp_path / "a.pkl"), str(tmp_path / "b.pkl")
    jio.append_results(a, entry)
    tio.append_results(b, entry)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert tio.completed_param_sets(b) == jio.completed_param_sets(a)
    tio.reset_save_path(b)
    assert not os.path.exists(b)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_mfcd_tpu():
    files = [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                             "chip_profile.py")]
    for root, _, names in os.walk(os.path.join(REPO, "mfcd_tpu_torch")):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    assert len(files) > 20
    names = {os.path.relpath(f, REPO) for f in files}
    assert {"chip_profile.py", "mfcd_tpu_torch/ops/kernel_split.py",
            "mfcd_tpu_torch/sweep/batched.py",
            "mfcd_tpu_torch/scripts/profile_kernel_split.py",
            "mfcd_tpu_torch/sampling/strategies.py",
            "mfcd_tpu_torch/sampling/dedup.py",
            "mfcd_tpu_torch/sampling/__init__.py",
            "mfcd_tpu_torch/genx/clusters.py",
            "mfcd_tpu_torch/genx/graphs.py",
            "mfcd_tpu_torch/sweep/ground_truth.py",
            "mfcd_tpu_torch/scripts/ab_epoch_kernel.py",
            "mfcd_tpu_torch/experiments/runs.py",
            "mfcd_tpu_torch/experiments/plots.py",
            "mfcd_tpu_torch/viz/plots.py",
            "mfcd_tpu_torch/viz/report.py",
            "mfcd_tpu_torch/utils/checkpoint.py",
            "mfcd_tpu_torch/utils/observability.py",
            "mfcd_tpu_torch/utils/debug.py",
            "mfcd_tpu_torch/data/movielens.py",
            "mfcd_tpu_torch/data/preferences.py",
            "mfcd_tpu_torch/models/altsvm.py",
            "mfcd_tpu_torch/ops/altsvm_kernels.py"} <= names
    # The repo's JAX-side top-level packages and scripts import mfcd_tpu.
    forbidden = ("jax", "jaxlib", "mfcd_tpu", "experiments", "scripts",
                 "bench", "__graft_entry__")
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in forbidden, (path, mod)
