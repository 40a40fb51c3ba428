"""The port's chunk loop (``parameter_scan_fast`` over ``run_bucket``), on
the CPU: the cases of ``tests/test_pipeline.py`` and
``tests/test_bucket_future.py`` that have a counterpart in one sequential
loop, its stage spans, and a crashed scan resumed.

Each chunk runs on the caller's thread: dispatch, collect, export and
persist, then the next chunk.  Keys fold from global experiment indices,
so chunk boundaries change no stream.  (The mesh case is in
``tests/test_torch_parallel.py``; the transport retries are not ported.)
"""

import pickle
import threading

import numpy as np
import pytest
import torch

from mfcd_tpu_torch.core.config import RunConfig
from mfcd_tpu_torch.core.results import RESULT_KEYS
from mfcd_tpu_torch.sweep import batched
from mfcd_tpu_torch.sweep.batched import parameter_scan_fast
from mfcd_tpu_torch.utils import observability as obs
from mfcd_tpu_torch.utils.io import load_results

from result_compare import assert_results_equal

torch.set_num_threads(1)

# tests/test_pipeline.py's grid: 10 configurations in chunks of 3.
GRID = dict(n=24, m=24, d=2, p=0.6, s=[1.0, 2.0, 3.0, 5.0, 8.0],
            weight_decay=[1e-5, 1e-4], num_epochs=4, reps=2, max_bucket=3)
SWEEP_STAGES = ("mfcd.sweep.dispatch", "mfcd.sweep.collect",
                "mfcd.sweep.export", "mfcd.sweep.persist")


def _scan(tmp_path, name, **grid):
    path = str(tmp_path / f"{name}.pkl")
    assert parameter_scan_fast(device="cpu", save_path=path, save_every=1,
                               **grid) == []
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_same(want, got):
    assert [r["params"] for r in got] == [r["params"] for r in want]
    for a, b in zip(want, got):
        assert_results_equal(a["results"], b["results"])


def _flat(v):
    if isinstance(v, list) and v and isinstance(v[0], (list, np.ndarray)):
        return np.concatenate([np.ravel(np.asarray(x, np.float64))
                               for x in v])
    return np.asarray(v, np.float64)


@pytest.fixture(scope="module")
def unfailed(tmp_path_factory):
    return _scan(tmp_path_factory.mktemp("unfailed"), "grid", **GRID)


def test_chunks_dispatch_on_the_callers_thread(monkeypatch):
    """Every chunk's runs start on the caller's thread, and each chunk is
    collected before the next is dispatched."""
    events, threads = [], set()
    device_run = batched._run_bucket_device
    export = batched.export_results

    def recording_run(*args, **kwargs):
        events.append("dispatch")
        threads.add(threading.get_ident())
        return device_run(*args, **kwargs)

    def recording_export(*args, **kwargs):
        events.append("collect")
        threads.add(threading.get_ident())
        return export(*args, **kwargs)

    monkeypatch.setattr(batched, "_run_bucket_device", recording_run)
    monkeypatch.setattr(batched, "export_results", recording_export)
    grid = dict(GRID, num_epochs=1, reps=1, weight_decay=1e-5,
                s=[1.0, 2.0, 3.0], max_bucket=1)
    parameter_scan_fast(device="cpu", **grid)
    assert events == ["dispatch", "collect"] * 3
    assert threads == {threading.get_ident()}


def test_oom_at_the_first_chunk_bisects(tmp_path, monkeypatch, capsys):
    """An OOM at the first chunk bisects it; results and pickle equal the
    unfaulted scan's, in the same order."""
    grid = dict(GRID, weight_decay=1e-5, s=[1.0, 2.0, 3.0], max_bucket=2)
    want = _scan(tmp_path, "want", **grid)

    injected, sizes = [], []
    device_run = batched._run_bucket_device

    def failing(cfg, cfg_keys, *args, **kwargs):
        sizes.append(cfg_keys.shape[0])
        if not injected:
            injected.append(True)
            raise torch.cuda.OutOfMemoryError("out of memory (injected)")
        return device_run(cfg, cfg_keys, *args, **kwargs)

    monkeypatch.setattr(batched, "_run_bucket_device", failing)
    got = _scan(tmp_path, "oom", **grid)
    assert injected, "the fault was never exercised"
    assert sizes == [2, 1, 1, 1]
    assert "bisecting" in capsys.readouterr().err
    _assert_same(want, got)


def test_eager_dispatch_failure_persists_previous_chunk(tmp_path,
                                                        monkeypatch):
    """A chunk whose run fails: the chunk before it is already persisted
    when the error surfaces."""
    grid = dict(GRID, num_epochs=1, reps=1, weight_decay=1e-5,
                s=[1.0, 2.0, 3.0], max_bucket=1)
    real = batched.run_bucket
    calls = []

    def failing_second(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("dispatch failed (injected)")
        return real(*args, **kwargs)

    monkeypatch.setattr(batched, "run_bucket", failing_second)
    path = tmp_path / "partial.pkl"
    with pytest.raises(RuntimeError, match="injected"):
        parameter_scan_fast(device="cpu", save_path=str(path), **grid)
    with open(path, "rb") as f:
        saved = pickle.load(f)
    assert [e["params"]["s"] for e in saved] == [1.0]


@pytest.mark.parametrize("error, oom", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (RuntimeError("CUDA error: out of memory"), True),
    (RuntimeError("CUDA error: an illegal memory access"), False),
])
def test_errors_raise_at_once(error, oom, monkeypatch):
    """An OOM goes straight to the bisector and any other error straight
    to the caller: one dispatch, no retry."""
    calls = []

    def failing(*args, **kwargs):
        calls.append(1)
        raise error

    monkeypatch.setattr(batched, "_run_bucket_device", failing)
    cfg = RunConfig(n=24, m=24, d=2, p=0.6, s=1.0, num_epochs=1, reps=1)
    with pytest.raises(RuntimeError) as info:
        batched.run_bucket(cfg, [{"s": 1.0, "lr": 1e-3,
                                  "weight_decay": 1e-5}], [0], device="cpu")
    assert info.value is error
    assert batched._is_oom(info.value) is oom
    assert calls == [1]


@pytest.mark.parametrize("max_bucket", [1, 3, None])
def test_sweep_spans_run_in_chunk_order_on_the_callers_thread(
        max_bucket, tmp_path, monkeypatch):
    """Each chunk's ``mfcd.sweep.*`` spans (dispatch, collect, export,
    persist) follow each other on the caller's thread, chunk after chunk,
    children of ``mfcd.call``; no span waits for a chunk, and the stages
    still partition the call.  The grid's post-stage metric reads these
    spans."""
    rec = obs.Recorder()
    monkeypatch.setattr(obs, "_RECORDER", rec)
    grid = dict(GRID, num_epochs=1, reps=1, max_bucket=max_bucket)
    _scan(tmp_path, "spans", **grid)
    (r,) = rec.calls()
    chunks = 1 if max_bucket is None else -(-10 // max_bucket)
    top = r["spans"][0]
    assert top["name"] == "mfcd.call"
    sweep = sorted((sp for sp in r["spans"]
                    if sp["name"].startswith("mfcd.sweep.")),
                   key=lambda sp: sp["start_ns"])
    assert [sp["name"] for sp in sweep] == list(SWEEP_STAGES) * chunks
    assert all(sp["parent"] == top["id"] for sp in sweep)
    assert {sp["thread"] for sp in r["spans"]} == {threading.get_ident()}
    assert all(a["end_ns"] <= b["start_ns"]
               for a, b in zip(sweep, sweep[1:]))
    assert r["stages"]["mfcd.sweep.dispatch"]["entries"] == chunks
    assert "mfcd.sweep.wait" not in r["stages"]
    assert sum(st["host_ns"] for st in r["stages"].values()) == r["host_ns"]


@pytest.mark.parametrize("fail_at", [0, 1, 2, 3])
def test_a_crashed_scan_resumes_to_the_unfailed_pickle(fail_at, tmp_path,
                                                       monkeypatch, unfailed):
    """The scan fails at chunk ``fail_at`` (of 3, 3, 3 and 1
    configurations); rerun with ``resume=True``, its pickle holds the
    unfailed scan's params in grid order and its results within the
    batched scan's tolerance (re-chunking the rest changes the runs a
    call)."""
    real = batched.run_bucket
    calls = []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == fail_at + 1:
            raise RuntimeError("the chunk failed (injected)")
        return real(*args, **kwargs)

    path = str(tmp_path / "crashed.pkl")
    monkeypatch.setattr(batched, "run_bucket", failing)
    with pytest.raises(RuntimeError, match="injected"):
        parameter_scan_fast(device="cpu", save_path=path, **GRID)
    monkeypatch.setattr(batched, "run_bucket", real)
    assert len(load_results(path)) == 3 * fail_at
    assert parameter_scan_fast(device="cpu", save_path=path, resume=True,
                               **GRID) == []
    with open(path, "rb") as f:
        got = pickle.load(f)
    assert [e["params"] for e in got] == [e["params"] for e in unfailed]
    for a, b in zip(unfailed, got):
        for k in RESULT_KEYS:
            np.testing.assert_allclose(_flat(b["results"][k]),
                                       _flat(a["results"][k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
