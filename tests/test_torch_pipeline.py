"""The port's 1-deep chunk pipeline (``MFCD_PIPELINE``) and its
``BucketFuture``, on the CPU: the cases of ``tests/test_pipeline.py`` and
``tests/test_bucket_future.py`` that have a counterpart.

With the pipeline on, one worker thread dispatches chunk k+1 while the
caller exports chunk k.  Keys fold from global experiment indices and the
arithmetic does not depend on which thread runs it, so results and the
pickle are bit-equal to the sequential loop, in the same order.  (The mesh
case is in ``tests/test_torch_parallel.py``; the transport retries are not
ported.)
"""

import concurrent.futures
import pickle

import pytest
import torch

from mfcd_tpu_torch.sweep import batched
from mfcd_tpu_torch.sweep.batched import parameter_scan_fast

from result_compare import assert_results_equal

torch.set_num_threads(1)

# tests/test_pipeline.py's grid: 10 configurations in chunks of 3.
GRID = dict(n=24, m=24, d=2, p=0.6, s=[1.0, 2.0, 3.0, 5.0, 8.0],
            weight_decay=[1e-5, 1e-4], num_epochs=4, reps=2, max_bucket=3)


def _scan(tmp_path, monkeypatch, name, pipeline, **grid):
    monkeypatch.setenv("MFCD_PIPELINE", "1" if pipeline else "0")
    path = str(tmp_path / f"{name}.pkl")
    assert parameter_scan_fast(device="cpu", save_path=path, save_every=1,
                               **grid) == []
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_same(seq, pipe):
    assert [r["params"] for r in pipe] == [r["params"] for r in seq]
    for a, b in zip(seq, pipe):
        assert_results_equal(a["results"], b["results"])


def test_pipeline_matches_sequential(tmp_path, monkeypatch):
    seq = _scan(tmp_path, monkeypatch, "seq", False, **GRID)
    pipe = _scan(tmp_path, monkeypatch, "pipe", True, **GRID)
    assert len(seq) == len(pipe) == 10
    _assert_same(seq, pipe)


def test_pipeline_dispatches_on_one_worker(monkeypatch):
    """On: chunk k+1 is dispatched before chunk k is collected, and every
    dispatch runs on the worker thread.  Off: dispatch, collect, in the
    caller's thread."""
    import threading

    events, threads = [], set()
    device_run = batched._run_bucket_device
    submit = batched.run_bucket_async
    collect = batched.BucketFuture.collect

    def on_thread(*args, **kwargs):
        threads.add(threading.current_thread().name)
        return device_run(*args, **kwargs)

    def recording_submit(*args, **kwargs):
        events.append("dispatch")
        return submit(*args, **kwargs)

    def recording_collect(self):
        events.append("collect")
        return collect(self)

    monkeypatch.setattr(batched, "_run_bucket_device", on_thread)
    monkeypatch.setattr(batched, "run_bucket_async", recording_submit)
    monkeypatch.setattr(batched.BucketFuture, "collect", recording_collect)
    grid = dict(GRID, num_epochs=1, reps=1, weight_decay=1e-5,
                s=[1.0, 2.0, 3.0], max_bucket=1)
    for pipeline, order, names in (
            (True, ["dispatch", "dispatch", "collect", "dispatch",
                    "collect", "collect"], "mfcd-dispatch"),
            (False, ["dispatch", "collect"] * 3, "MainThread")):
        events.clear()
        threads.clear()
        monkeypatch.setenv("MFCD_PIPELINE", "1" if pipeline else "0")
        parameter_scan_fast(device="cpu", **grid)
        assert events == order
        assert threads and all(t.startswith(names) for t in threads)


def test_pipeline_oom_drains_then_bisects(tmp_path, monkeypatch, capsys):
    """An OOM at the first pipelined collect drains the in-flight chunk,
    then bisects the failed one; results and pickle equal the unfaulted
    sequential scan's, in the same order."""
    grid = dict(GRID, weight_decay=1e-5, s=[1.0, 2.0, 3.0], max_bucket=2)
    seq = _scan(tmp_path, monkeypatch, "seq", False, **grid)

    injected = []
    collect = batched.BucketFuture.collect

    def failing(self):
        if not injected:
            injected.append(True)
            raise torch.cuda.OutOfMemoryError("out of memory (injected)")
        return collect(self)

    monkeypatch.setattr(batched.BucketFuture, "collect", failing)
    pipe = _scan(tmp_path, monkeypatch, "oom", True, **grid)
    assert injected, "the fault was never exercised"
    assert "draining the in-flight chunk, then bisecting" in \
        capsys.readouterr().err
    _assert_same(seq, pipe)


def test_eager_dispatch_failure_persists_previous_chunk(tmp_path,
                                                        monkeypatch):
    """A chunk whose dispatch fails in the caller: the chunk before it is
    collected and persisted first, then the error surfaces."""
    grid = dict(GRID, num_epochs=1, reps=1, weight_decay=1e-5,
                s=[1.0, 2.0, 3.0], max_bucket=1)
    real = batched.run_bucket_async
    calls = []

    def failing_second(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("dispatch failed (injected)")
        return real(*args, **kwargs)

    monkeypatch.setattr(batched, "run_bucket_async", failing_second)
    monkeypatch.setenv("MFCD_PIPELINE", "1")
    path = tmp_path / "partial.pkl"
    with pytest.raises(RuntimeError, match="injected"):
        parameter_scan_fast(device="cpu", save_path=str(path), **grid)
    with open(path, "rb") as f:
        saved = pickle.load(f)
    assert [e["params"]["s"] for e in saved] == [1.0]


def _future(outcome, executor=None):
    calls = []

    def dispatch():
        calls.append(1)
        if isinstance(outcome, Exception):
            raise outcome
        return outcome

    return batched.BucketFuture(dispatch, lambda host: host, executor), calls


@pytest.mark.parametrize("threaded", [False, True])
def test_construction_failure_defers_to_collect(threaded):
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        fut, calls = _future(ValueError("shape mismatch"),
                             pool if threaded else None)
        # The constructor raised nothing.
        with pytest.raises(ValueError, match="shape mismatch"):
            fut.collect()
    assert calls == [1]
    fut, _ = _future({"a": 1})
    assert fut.collect() == {"a": 1}


@pytest.mark.parametrize("error, oom", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (RuntimeError("CUDA error: out of memory"), True),
    (RuntimeError("CUDA error: an illegal memory access"), False),
])
def test_errors_raise_at_once(error, oom):
    """An OOM goes straight to the bisector and any other error straight
    to the caller: one dispatch, no retry."""
    fut, calls = _future(error)
    with pytest.raises(RuntimeError) as info:
        fut.collect()
    assert info.value is error
    assert batched._is_oom(info.value) is oom
    assert calls == [1]



@pytest.mark.parametrize("off, on, enable", [
    # The card's own 4-pass reading at one chunk, on/off 1.054, where
    # nothing can overlap: too few pairs, so no verdict of on.
    ([3.269, 3.307], [3.209, 3.103], False),
    # A steady 5 % gain in 10 of 10 pairs, spread far below it.
    ([3.30 + 0.01 * (k % 3) for k in range(10)],
     [3.14 + 0.01 * (k % 3) for k in range(10)], True),
    # 9 of 10 wins, but by less than the off passes' spread.
    ([3.0, 3.2, 3.4, 3.1, 3.3, 3.0, 3.2, 3.4, 3.1, 3.3],
     [2.99, 3.19, 3.39, 3.09, 3.29, 2.99, 3.19, 3.39, 3.09, 3.5], False),
    # Signs that flip from pair to pair.
    ([3.2, 3.0] * 5, [3.0, 3.2] * 5, False),
])
def test_ab_verdict_needs_a_margin_above_the_spread(off, on, enable):
    from mfcd_tpu_torch.scripts.profile_pipeline_ab import verdict

    got = verdict(off, on)
    assert got["enable"] is enable
    assert got["pairs"] == len(off)
