"""The trace summariser on synthetic events: busy time is the union of the
device operations' intervals, a kernel's time goes to every span that
held its launch, and each idle gap to the span the host was in."""

import pytest

from portbench import spec, tracing
from portbench.tracing import Event


def _events():
    # host: mfcd.train [0, 10) holding mfcd.train.val [6, 9); launches at
    # 1, 2 (inside train) and 7 (inside val); the kernels overlap.
    return [
        Event("span", "mfcd.train", 0.0, 10.0, tid=1),
        Event("span", "mfcd.train.val", 6.0, 9.0, tid=1),
        Event("span", "other.span", 0.0, 10.0, tid=1),
        Event("runtime", "cudaLaunchKernel", 1.0, 1.1, corr=11, tid=1),
        Event("runtime", "cudaLaunchKernel", 2.0, 2.1, corr=12, tid=1),
        Event("runtime", "cudaLaunchKernel", 7.0, 7.1, corr=13, tid=1),
        Event("kernel", "epoch_kernel<true, 4>", 1.5, 4.0, corr=11),
        Event("kernel", "epoch_kernel<true, 4>", 3.0, 5.0, corr=12),
        Event("kernel", "val_kernel", 7.5, 8.0, corr=13),
        Event("gpu_memcpy", "Memcpy DtoH", 8.0, 8.5),
        Event("kernel", "orphan", 9.0, 9.5, corr=99),
    ]


def test_union_of_intervals_counts_overlap_once():
    assert tracing.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert tracing.union_seconds([]) == 0
    assert tracing.union_seconds([(0, 5), (1, 2)]) == 5


def test_summary_busy_launches_and_names():
    s = tracing.summarise(_events(), (0.0, 10.0))
    assert s.window_s == 10.0
    assert s.busy_s == pytest.approx(3.5 + 0.5 + 0.5 + 0.5)
    assert s.launches == 4 and s.unmatched == 1
    assert s.by_name["epoch_kernel<true, 4>"] == (2, pytest.approx(4.5))
    assert s.top_device_ops(1)[0][0] == "epoch_kernel<true, 4>"


def test_kernels_go_to_every_span_that_held_their_launch():
    s = tracing.summarise(_events(), (0.0, 10.0))
    assert s.by_span["mfcd.train"] == pytest.approx(2.5 + 2.0 + 0.5)
    assert s.by_span["mfcd.train.val"] == pytest.approx(0.5)
    assert "other.span" not in s.by_span


def test_idle_gaps_go_to_the_innermost_span():
    s = tracing.summarise(_events(), (0.0, 10.0))
    # gaps: [0, 1.5) train, [5, 7.5) train, [8.5, 9) val, [9.5, 10) train
    assert s.idle_by_span["mfcd.train"] == pytest.approx(1.5 + 2.5 + 0.5)
    assert s.idle_by_span["mfcd.train.val"] == pytest.approx(0.5)
    assert s.busy_s + sum(s.idle_by_span.values()) == pytest.approx(10.0)


def test_window_clips_operations():
    s = tracing.summarise(_events(), (2.0, 4.5))
    assert s.busy_s == pytest.approx(2.5)


def test_a_launch_without_a_runtime_call_uses_its_host_operation():
    ev = [Event("span", "mfcd.metrics", 0.0, 2.0, tid=3),
          Event("host", "aten::mm", 0.5, 0.6, corr=40, tid=3),
          Event("kernel", "gemm", 0.7, 0.9, corr=77, link=40)]
    s = tracing.summarise(ev, (0.0, 2.0))
    assert s.unmatched == 0
    assert s.by_span["mfcd.metrics"] == pytest.approx(0.2)


def test_readers_on_a_summary():
    s = tracing.summarise(_events(), (0.0, 10.0))
    ctx = {"traced": {"calls": 1, "runs": 2}}
    assert spec.reader("metrics", "launches_per_run").read(s, ctx) == 2.0
    assert spec.reader("metrics", "val_ms_per_run").read(
        s, ctx) == pytest.approx(250.0)
    assert spec.reader("metrics", "device_idle_share").read(
        s, ctx) == pytest.approx(50.0)
    empty = tracing.summarise([], (0.0, 1.0))
    assert spec.reader("metrics", "device_idle_share").read(empty, ctx) is None
    assert spec.reader("metrics", "launches_per_run").read(empty, ctx) is None
    assert spec.reader("metrics", "val_ms_per_run").read(empty, ctx) is None


def test_kineto_events_of_a_cpu_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.ones(8, 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("mfcd.sample"):
            (x @ x).sum()
    ev = tracing.from_kineto(prof.profiler.kineto_results.events())
    spans = [e for e in ev if e.kind == "span"]
    assert [e.name for e in spans] == ["mfcd.sample"]
    assert all(e.end >= e.start for e in ev)
    assert not any(e.kind in tracing.DEVICE_KINDS for e in ev)
