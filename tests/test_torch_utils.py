"""The port's utilities (``mfcd_tpu_torch.utils``: checkpoint,
observability, debug) against the JAX package's: checkpoints cross-load
bit-equal both ways, the JSONL logger writes the same lines, the debug
printer prints the same structure for one small run of each package, and
the profiler context writes a trace."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import mfcd_tpu
from mfcd_tpu.models.mf import MFParams as JParams
from mfcd_tpu.utils import checkpoint as jckpt
from mfcd_tpu.utils import debug as jdebug
from mfcd_tpu.utils import observability as jobs
import mfcd_tpu_torch
from mfcd_tpu_torch.models.mf import MFParams as TParams
from mfcd_tpu_torch.utils import checkpoint as tckpt
from mfcd_tpu_torch.utils import debug as tdebug
from mfcd_tpu_torch.utils import observability as tobs

torch.set_num_threads(1)

# tests/test_torch_engine.py's shape, one config: the JAX program is the
# one that file compiles.
CFG = dict(n=24, m=28, d=2, p=0.4, s=[1.0], lr=1e-2, weight_decay=1e-5,
           num_epochs=2, reps=2, K=1)
META = {"n": 24, "s": 1.5, "strategy": "random", "tags": [1, 2]}


@pytest.fixture(scope="module")
def runs():
    """One small run of each package: (JAX results, port results)."""
    return (mfcd_tpu.parameter_scan(**CFG)[0]["results"],
            mfcd_tpu_torch.parameter_scan(device="cpu", **CFG)[0]["results"])


def _factors(seed):
    g = np.random.default_rng(seed)
    return (g.standard_normal((24, 3)).astype(np.float32),
            g.standard_normal((28, 3)).astype(np.float32))


@pytest.mark.parametrize("meta", [META, None])
def test_checkpoints_cross_load_bit_equal(meta, tmp_path):
    u, v = _factors(0)
    jckpt.save_factors(str(tmp_path / "jax.npz"), JParams(U=u, V=v), meta)
    params, got_meta = tckpt.load_factors(str(tmp_path / "jax"), device="cpu")
    assert got_meta == meta
    assert params.U.dtype == params.V.dtype == torch.float32
    assert params.U.device.type == "cpu"
    np.testing.assert_array_equal(params.U.numpy(), u)
    np.testing.assert_array_equal(params.V.numpy(), v)

    u, v = _factors(1)
    tckpt.save_factors(str(tmp_path / "sub" / "port.npz"),
                       TParams(U=torch.from_numpy(u), V=torch.from_numpy(v)),
                       meta)
    params, got_meta = jckpt.load_factors(str(tmp_path / "sub" / "port.npz"))
    assert got_meta == meta
    assert params.U.dtype == np.float32
    np.testing.assert_array_equal(params.U, u)
    np.testing.assert_array_equal(params.V, v)
    params, _ = tckpt.load_factors(str(tmp_path / "sub" / "port.npz"),
                                   device="cpu")
    np.testing.assert_array_equal(params.V.numpy(), v)


def test_load_factors_defaults_to_the_card(tmp_path, monkeypatch):
    u, v = _factors(2)
    jckpt.save_factors(str(tmp_path / "f.npz"), JParams(U=u, V=v))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tckpt.load_factors(str(tmp_path / "f.npz"))


def test_jsonl_logger_writes_the_jax_lines(runs, tmp_path):
    jres, tres = runs
    params = {"n": 24, "s": 1.0, "strategy": "random"}
    jlog = jobs.JsonlLogger(str(tmp_path / "a" / "jax.jsonl"))
    tlog = tobs.JsonlLogger(str(tmp_path / "b" / "port.jsonl"))
    for _ in range(2):
        jlog.log(params, jres)
        tlog.log(params, jres)
    want = open(tmp_path / "a" / "jax.jsonl").read()
    assert open(tmp_path / "b" / "port.jsonl").read() == want
    assert len(want.splitlines()) == 2
    # The port's own results give the same keys.
    tobs.JsonlLogger(str(tmp_path / "c.jsonl")).log(params, tres)
    got = json.loads(open(tmp_path / "c.jsonl").read())
    assert got["metrics"].keys() == json.loads(
        want.splitlines()[0])["metrics"].keys()


def test_print_return_structure_types_prints_the_jax_text(runs, capsys):
    jres, tres = runs
    jdebug.print_return_structure_types({"results": jres, "e": []})
    want = capsys.readouterr().out
    tdebug.print_return_structure_types({"results": tres, "e": []})
    assert capsys.readouterr().out == want
    assert "root.results.accuracy: list[float]" in want
    assert "root.e: list[empty]" in want


def test_trace_writes_a_chrome_trace(tmp_path, capsys, monkeypatch):
    with tobs.trace(str(tmp_path / "tr"), device="cpu"):
        torch.ones(64).cumsum(0)
    files = glob.glob(str(tmp_path / "tr" / "*.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    assert json.load(open(files[0]))["traceEvents"]
    assert f"profile written to {files[0]}" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with tobs.trace(str(tmp_path / "tr2")):
            pass
    assert not os.path.exists(tmp_path / "tr2")
