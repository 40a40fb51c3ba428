"""The readers of the program's stage records on a synthetic call log:
the window's calls are the last unprofiled records, the traced calls the
last profiled ones, times are card self ns summed over the stages and
divided by the runs, and a log without a card timeline reads None."""

from types import SimpleNamespace

import pytest

from portbench import spec, stages


def _record(runs, profiled=False, card=True, syncs=0, **card_ms):
    st = {name.replace("_", "."): dict(entries=1, host_ns=0,
                                       card_ns=ms * 1e6 if card else None,
                                       syncs=0)
          for name, ms in card_ms.items()}
    st.setdefault("mfcd.call", dict(entries=1, host_ns=0,
                                    card_ns=0 if card else None, syncs=0))
    st["mfcd.call"]["syncs"] = syncs
    return dict(entry="parameter_scan", id=0, runs=runs, profiled=profiled,
                card=card, host_ns=0,
                card_ns=sum(s["card_ns"] for s in st.values()) if card
                else None, stages=st)


def _ctx(window_calls, traced_calls=0):
    window = SimpleNamespace(calls=[object()] * window_calls)
    return dict(window=window,
                traced=dict(calls=traced_calls, runs=5 * traced_calls)
                if traced_calls else None)


def _read(name, monkeypatch, log, ctx):
    monkeypatch.setattr(stages, "program_log", lambda: log)
    return spec.reader("metrics", name).read(None, ctx)


LOG = ([_record(5, mfcd_generate=100.0)] * 2                # warm-up
       + [_record(5, mfcd_generate=1.0, mfcd_sample=2.0, mfcd_label=3.0,
                  mfcd_metrics=4.0, mfcd_export=0.5),
          _record(10, mfcd_generate=2.0, mfcd_sample=2.0, mfcd_label=2.0,
                  mfcd_train_val=9.0, mfcd_sweep_collect=1.5,
                  mfcd_sweep_export=1.0)]                   # the window
       + [_record(5, profiled=True, syncs=7, mfcd_sample=50.0),
          _record(5, profiled=True, syncs=3, mfcd_sample=50.0)])  # traced


def test_the_window_is_the_last_unprofiled_records(monkeypatch):
    ctx = _ctx(2, 2)
    assert stages.window_records(LOG, ctx) == LOG[2:4]
    assert stages.traced_records(LOG, ctx) == LOG[4:]
    # (1 + 2 + 3 + 2 + 2 + 2) ms over 15 runs; no warm-up, no traced call
    assert _read("prep_stage_ms_per_run", monkeypatch, LOG, ctx) == \
        pytest.approx(12.0 / 15)
    assert _read("prep_stage_ms_per_run.oracle", monkeypatch, LOG, ctx) == \
        pytest.approx(12.0 / 15)
    assert _read("val_stage_ms_per_run.k10", monkeypatch, LOG, ctx) == \
        pytest.approx(9.0 / 15)
    assert _read("post_stage_ms_per_run.grid", monkeypatch, LOG, ctx) == \
        pytest.approx((4.0 + 0.5 + 1.5 + 1.0) / 15)
    assert _read("syncs_per_run", monkeypatch, LOG, ctx) == \
        pytest.approx(10 / 10)
    # One call in the window: the last unprofiled record alone.
    assert _read("prep_stage_ms_per_run", monkeypatch, LOG, _ctx(1, 2)) == \
        pytest.approx(6.0 / 10)


def test_none_without_a_card_timeline_or_the_calls(monkeypatch):
    ctx = _ctx(2, 2)
    host_only = [_record(5, card=False, mfcd_sample=1.0)] * 4
    for name in ("prep_stage_ms_per_run", "val_stage_ms_per_run",
                 "post_stage_ms_per_run"):
        assert _read(name, monkeypatch, host_only, ctx) is None
        assert _read(name, monkeypatch, None, ctx) is None   # no log
        assert _read(name, monkeypatch, LOG[:1], ctx) is None  # too short
    # A stage no call opened reads None, not 0.
    no_val = [_record(5, mfcd_sample=1.0)] * 2
    assert _read("val_stage_ms_per_run", monkeypatch, no_val, ctx) is None
    assert _read("syncs_per_run", monkeypatch, LOG[:4], ctx) is None
    assert _read("syncs_per_run", monkeypatch, LOG, _ctx(2)) is None


def test_a_program_without_a_log_reads_none(monkeypatch):
    from mfcd_tpu_torch.utils import observability

    monkeypatch.delattr(observability, "calls")
    assert stages.program_log() is None
    assert spec.reader("metrics", "syncs_per_run").read(None, _ctx(2, 2)) \
        is None
