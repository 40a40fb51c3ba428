"""The port's study sweeps (``mfcd_tpu_torch.experiments.runs``) against
the JAX package's (``experiments/runs.py``).

Each of the 11 sweep functions hands its scan exactly the JAX one's keyword
arguments (``device`` aside) and leaves the same pickles; the command line
lists the same sweeps; and one miniature sweep (``generation_s_sweep`` at
n = m = 20, one shape bucket) runs end to end through both packages on
both paths, its 23 keys within ``tests/test_torch_engine.py``'s rtol 1e-4
/ atol 1e-5, and resumes in the port without running anything.
"""

import ast
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import experiments.runs as jruns
from mfcd_tpu.core import config as jconfig
from mfcd_tpu.core.results import RESULT_KEYS
from mfcd_tpu_torch.experiments import runs as truns
from mfcd_tpu_torch.parallel.mesh import Mesh
from mfcd_tpu_torch.sweep import batched as tbatched
from mfcd_tpu_torch.sweep import engine as tengine

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PARAM_KEYS = ("n", "m", "d", "p", "lr", "weight_decay", "num_epochs", "reps",
              "s", "K", "d1", "strategy", "popularity_method", "alpha",
              "soft_label", "generation")


def _stub(kw):
    """The results a scan of ``kw`` would return, without the run."""
    params = {k: v for k, v in kw.items() if k in PARAM_KEYS}
    spec = jconfig.SweepSpec(params=params, linear=kw.get("linear", False))
    return [{"params": ps, "results": {"accuracy": [0.5]}}
            for ps in spec.expand()]


def _capture(monkeypatch, module, folder):
    """Replace ``module``'s scans by fakes that record their arguments
    (save paths relative to ``folder``) and, like the engines, flush the
    stub results to ``save_path`` and return ``[]``."""
    calls = []

    def rel(kw):
        kw = dict(kw)
        if kw.get("save_path"):
            kw["save_path"] = os.path.relpath(kw["save_path"], folder)
        return kw

    def fake_scan(fast, **kw):
        calls.append(("scan", fast, rel(kw)))
        if kw.get("save_path"):
            with open(kw["save_path"], "wb") as f:
                pickle.dump(_stub(kw), f)
            return []
        return _stub(kw)

    def fake_gt(**kw):
        calls.append(("gt", None, rel(kw)))
        return [{"params": {"n": kw["n"], "p": repr(kw["p"])},
                 "results": {"gt_accuracy": [0.5]}}]

    monkeypatch.setattr(module, "_scan", fake_scan)
    monkeypatch.setattr(module, "parameter_scan_ground_truth", fake_gt)
    return calls


def _files(folder):
    out = {}
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("name", sorted(jruns.ALL))
def test_sweep_hands_its_scan_the_jax_arguments(name, monkeypatch, tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jcalls = _capture(monkeypatch, jruns, str(jdir))
    tcalls = _capture(monkeypatch, truns, str(tdir))
    for fast in (False, True):
        for out in (None, "sweep.pkl"):
            jout = str(jdir / out) if out else None
            tout = str(tdir / out) if out else None
            want = jruns.ALL[name](out=jout, fast=fast, scale=0.1)
            got = truns.ALL[name](out=tout, fast=fast, scale=0.1,
                                  device="cpu")
            assert repr(got) == repr(want)
    assert len(tcalls) == len(jcalls) > 0
    for (jk, jf, jkw), (tk, tf, tkw) in zip(jcalls, tcalls):
        assert tkw.pop("device") == "cpu"
        assert "device" not in jkw
        assert (tk, tf) == (jk, jf)
        assert tkw == jkw
        assert repr(tkw) == repr(jkw)        # same types, same order
    assert _files(str(tdir)) == _files(str(jdir))


def test_pk_const_sweep_enriches_the_flushed_pickle(monkeypatch, tmp_path):
    """The engines return ``[]`` once every result is flushed; the sweep
    reads the pickle back and rewrites it with ``pxK``, as the JAX one."""
    _capture(monkeypatch, truns, str(tmp_path))
    out = str(tmp_path / "pkc.pkl")
    got = truns.pk_const_sweep(out=out, scale=0.1, fast=True, device="cpu")
    saved = pickle.load(open(out, "rb"))
    assert len(saved) == 9 * 7 * 4 and got == saved
    for e in saved:
        assert e["params"]["pxK"] == round(
            e["params"]["p"] * e["params"]["K"], 4)


def test_grids_names_and_pairs_match():
    assert truns.ALL.keys() == jruns.ALL.keys()
    for name, fn in truns.ALL.items():
        assert fn.__name__ == name
    assert truns.STRATEGIES_S_SWEPT == jruns.STRATEGIES_S_SWEPT
    assert truns.STRATEGIES_P_SWEPT == jruns.STRATEGIES_P_SWEPT
    assert truns.GENERATIONS_SWEPT == jruns.GENERATIONS_SWEPT
    assert truns._PS_CONST_PAIRS == jruns._PS_CONST_PAIRS
    assert truns.ps_const_pairs() == truns.ps_const_pairs_derived()
    assert truns.ps_const_pairs() == jruns.ps_const_pairs()


def test_main_list_prints_what_jax_prints(capsys):
    assert jruns.main(["--list"]) == 0
    want = capsys.readouterr().out
    assert truns.main(["--list"]) == 0
    assert truns.main([]) == 0
    got = capsys.readouterr().out
    assert got == want * 2
    assert "s_p_sweep" in got and "gt_d_s_sweep" in got


def test_main_resolves_the_device_and_passes_resume_where_taken(monkeypatch):
    calls = _capture(monkeypatch, truns, os.getcwd())
    assert truns.main(["generation_s_sweep", "--scale", "0.1", "--device",
                       "cpu", "--resume", "--reps", "2", "--fast"]) == 0
    assert calls and all(kw["device"] == torch.device("cpu")
                         and kw["reps"] == 2 and fast
                         for _, fast, kw in calls)
    calls.clear()
    assert truns.main(["p_d_sweep", "--scale", "0.1", "--device", "cpu",
                       "--resume"]) == 0
    assert calls[0][2]["resume"] is True
    calls.clear()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        truns.main(["s_p_sweep", "--scale", "0.1"])
    assert not calls          # raised before any scan


def test_sweep_path_needs_no_matplotlib():
    """The card's machine has no matplotlib or pandas: the package, the
    sweeps, the utilities and ``chip_smoke.py`` must not import the
    figures, directly or through a package ``__init__``."""
    code = ("import sys; sys.modules['matplotlib'] = None; "
            "sys.modules['pandas'] = None; import chip_smoke, "
            "mfcd_tpu_torch.experiments.runs, mfcd_tpu_torch.utils.checkpoint, "
            "mfcd_tpu_torch.utils.observability, mfcd_tpu_torch.utils.debug, "
            "mfcd_tpu_torch.data.movielens, mfcd_tpu_torch.data.preferences")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
    for rel in ("chip_smoke.py", "mfcd_tpu_torch/__init__.py",
                "mfcd_tpu_torch/experiments/__init__.py",
                "mfcd_tpu_torch/experiments/runs.py"):
        tree = ast.parse(open(os.path.join(REPO, rel)).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [f"{node.module}.{a.name}" for a in node.names]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert not name.startswith(
                    ("matplotlib", "pandas", "mfcd_tpu_torch.viz",
                     "mfcd_tpu_torch.experiments.plots")), (rel, name)


def test_mesh_raises_on_both_paths():
    with pytest.raises(ValueError, match="requires fast=True"):
        jruns.strategies_p_sweep(scale=0.01, strategies=("random",),
                                 mesh=object())
    with pytest.raises(ValueError, match="requires fast=True"):
        truns.strategies_p_sweep(scale=0.01, strategies=("random",),
                                 mesh=object(), device="cpu")
    # The fast path takes a mesh (tests/test_torch_parallel.py runs it),
    # and refuses a device other than the mesh's.
    card_mesh = Mesh((1,), ("grid",), 0, torch.device("cuda", 0), {})
    with pytest.raises(ValueError, match="not the mesh's"):
        truns.strategies_p_sweep(scale=0.01, strategies=("random",),
                                 mesh=card_mesh, fast=True, device="cpu")


def _flat(v):
    if isinstance(v, list) and v and isinstance(v[0], (list, np.ndarray)):
        return np.concatenate([np.ravel(np.asarray(x, np.float64))
                               for x in v])
    return np.asarray(v, np.float64)


@pytest.mark.parametrize("fast", [False, True])
def test_miniature_generation_sweep_matches_jax_and_resumes(fast, tmp_path,
                                                            monkeypatch):
    kw = dict(scale=0.02, reps=1, generations=("low_rank",), fast=fast)
    jruns.generation_s_sweep(out=str(tmp_path / "jax"), **kw)
    assert truns.generation_s_sweep(out=str(tmp_path / "port"),
                                    device="cpu", **kw) == {"low_rank": []}
    want = pickle.load(open(tmp_path / "jax_low_rank.pkl", "rb"))
    path = tmp_path / "port_low_rank.pkl"
    got = pickle.load(open(path, "rb"))
    assert len(got) == len(want) == 10
    for a, b in zip(want, got):
        assert a["params"] == b["params"]
        for k in RESULT_KEYS:
            np.testing.assert_allclose(_flat(b["results"][k]),
                                       _flat(a["results"][k]), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    # The pickle holds plain Python and numpy: no tensor reaches it.
    assert b"torch" not in path.read_bytes()

    # A second call resumes: every configuration is in the pickle, so no
    # run starts and the file is not rewritten.
    def no_run(*args, **kwargs):
        raise AssertionError("the resumed sweep ran a configuration")

    monkeypatch.setattr(tengine, "run_config", no_run)
    monkeypatch.setattr(tbatched, "run_bucket", no_run)
    before = path.read_bytes()
    mtime = os.stat(path).st_mtime_ns
    truns.generation_s_sweep(out=str(tmp_path / "port"), device="cpu", **kw)
    assert path.read_bytes() == before
    assert os.stat(path).st_mtime_ns == mtime
