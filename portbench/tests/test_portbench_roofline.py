"""The fused epoch's operations and bytes, copied into the benchmark,
against the count the card checks use (``chip_smoke.epoch_bound_ms``), at
the shapes every cell launches K1 with."""

import pytest
import torch

from portbench import roofline, spec, workload

SHAPES = {  # cell: (runs a launch, K, soft labels)
    "canonical.scan": (5, 1, True),
    "labels_k10.scan": (5, 10, True),
    "labels_k50.scan": (5, 50, True),
    "canonical.grid": (330, 1, True),
}


def _inputs(runs, n, m, d, bs, count, words):
    rows = 1 << max(count - 1, 0).bit_length()
    nb = rows // bs
    state = [torch.zeros(runs, d, r) for r in (n, m, n, n, m, m)]
    # the program's packed stream: one int32, or an int32 and a float32
    stream = [torch.zeros(runs, nb, bs, dtype=torch.int32)]
    if words == 8:
        stream.append(torch.zeros(runs, nb, bs))
    return {"count": torch.full((runs,), count, dtype=torch.int32),
            "stream": stream, "state": state}


@pytest.mark.parametrize("cell", sorted(SHAPES))
def test_k1_count_equals_the_card_checks(cell):
    chip_smoke = pytest.importorskip("chip_smoke")
    st = spec.load_cell(cell).config["study"]
    runs, k, soft = SHAPES[cell]
    c = spec.load_cell(cell)
    assert workload.Plan(c.traffic["entry"], st, c.traffic,
                         1).runs_per_call() == runs
    assert st["K"] == k and st["soft_label"] is soft
    n, m, d, bs = st["n"], st["m"], st["d"], st["batch_size"]
    count, word = roofline.study_stream(st)
    steps = runs * roofline.epoch_steps(count, bs)
    ours = roofline.k1_bound_s(runs, steps, n, m, d, bs, word) * 1e3
    theirs, by = chip_smoke.epoch_bound_ms(
        _inputs(runs, n, m, d, bs, count, word), n, m, d, bs)
    assert ours == pytest.approx(theirs, rel=1e-12)
    assert by == "operations"
    assert roofline.PEAK_F32_FLOPS == chip_smoke.PEAK_F32_FLOPS
    assert roofline.PEAK_BYTES_PER_S == chip_smoke.PEAK_BYTES_PER_S


def test_canonical_counts():
    # 66,118 operations a step, 1,250 steps an epoch, 30 epochs.
    assert roofline.k1_flops(1, 1000, 1000, 2, 64) == 66118
    assert roofline.train_rows(1000, 1000, 0.2, 1) == 80000
    assert roofline.train_rows(1000, 1000, 0.2, 10) == 800000
    assert roofline.train_rows(1000, 1000, 0.2, 10, soft=True) == 80000
    # soft K = 10: 10 + 20 bits of u, i, j and 4 of the label's numerator
    # overflow 31, so the label is a float32 of its own
    assert roofline.stream_word_bytes(1000, 1000, 10) == 8
    assert roofline.stream_word_bytes(1000, 1000, 1) == 4
    assert roofline.epoch_steps(80000, 64) == 1250
    assert roofline.stream_word_bytes(1000, 1000) == 4
    assert roofline.stream_word_bytes(512, 2000) == 8
    assert roofline.stream_word_bytes(5000, 5000) == 16


def test_shares_read_from_a_summary():
    from portbench.tracing import Summary
    from portbench.workload import Window

    cell = spec.load_cell("canonical.scan")
    # one traced call of 5 runs: 30 launches, each at 1000 x its bound
    bound = roofline.k1_bound_s(5, 5 * 1250, 1000, 1000, 2, 64, 4)
    s = Summary(window_s=1.0, busy_s=0.5, launches=30,
                by_name={"void epoch_kernel<true, 4, false>(float*)":
                         (30, 30 * bound * 1000)},
                by_span={}, idle_by_span={})
    ctx = {"cell": cell, "runs_per_call": 5, "traced": {"calls": 1,
                                                        "runs": 5},
           "window": Window([], 0.0, 2.0, 0.0)}
    share = spec.reader("metrics", "k1_roofline").read(s, ctx)
    assert share == pytest.approx(0.1)
    assert spec.reader("metrics", "run_mfu").read(s, ctx) is None
    ctx["window"].calls.append(type("C", (), {"ok": True, "runs": 4})())
    mfu = spec.reader("metrics", "run_mfu").read(s, ctx)
    expect = 100 * 4 * 30 * 1250 * 66118 / (2.0 * 67e12)
    assert mfu == pytest.approx(expect)


def test_k50_counts_its_soft_rows_once():
    # 50 votes a triplet averaged into one row: 80,000 training rows a run
    # (1,250 steps of 64), not 50 times that; the label takes a float32
    # of its own beside u, i, j
    from portbench.tracing import Summary
    from portbench.workload import Window

    cell = spec.load_cell("labels_k50.scan")
    st = cell.config["study"]
    assert roofline.study_stream(st) == (80000, 8)
    assert roofline.train_rows(1000, 1000, 0.2, 50) == 4000000
    bound = roofline.k1_bound_s(5, 5 * 1250, 1000, 1000, 2, 64, 8)
    s = Summary(window_s=1.0, busy_s=0.5, launches=30,
                by_name={"void epoch_kernel<true, 8, false>(float*)":
                         (30, 30 * bound * 500)},
                by_span={}, idle_by_span={})
    ctx = {"cell": cell, "runs_per_call": 5,
           "traced": {"calls": 1, "runs": 5},
           "window": Window([type("C", (), {"ok": True, "runs": 5})()],
                            0.0, 2.0, 0.0)}
    assert spec.reader("metrics", "k1_roofline.k50").read(
        s, ctx) == pytest.approx(0.2)
    assert spec.reader("metrics", "run_mfu.k50").read(
        s, ctx) == pytest.approx(100 * 5 * 30 * 1250 * 66118 / (2.0 * 67e12))


def test_a_call_in_two_chunks_counts_each_run_once():
    from portbench.tracing import Summary

    cell = spec.load_cell("canonical.grid")
    big = roofline.k1_bound_s(285, 285 * 1250, 1000, 1000, 2, 64, 4)
    small = roofline.k1_bound_s(45, 45 * 1250, 1000, 1000, 2, 64, 4)
    # one call: 30 launches over 285 runs and 30 over 45, at 50 x bound
    s = Summary(window_s=1.0, busy_s=0.5, launches=60,
                by_name={"void epoch_kernel<false, 4, false>(float*)":
                         (30, 30 * big * 50),
                         "void epoch_kernel<true, 4, false>(float*)":
                         (30, 30 * small * 50)},
                by_span={}, idle_by_span={})
    ctx = {"cell": cell, "runs_per_call": 330,
           "traced": {"calls": 1, "runs": 330}}
    share = spec.reader("metrics", "k1_roofline").read(s, ctx)
    assert share == pytest.approx(2.0)
