"""The port's decision records (``mfcd_tpu_torch/core/decisions.py``): the
cases of ``tests/test_decisions.py``, against the card's own artifact
directory, and the rule that the TPU's artifacts set no default on the
card.  Precedence: env var > card artifact > off."""

import json
import os

import pytest

from mfcd_tpu_torch.core import decisions
from mfcd_tpu_torch.sweep.batched import pipeline_enabled

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.fixture()
def decision_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(decisions, "DECISION_DIR", str(tmp_path))
    monkeypatch.setattr(decisions, "_cache", {})
    return tmp_path


@pytest.fixture()
def on_a_card(monkeypatch):
    """A measurement that ran on a CUDA device (this host has none)."""
    monkeypatch.setattr(decisions.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(decisions, "card_line", lambda: CARD)


def test_env_var_overrides_artifact(decision_dir, monkeypatch):
    (decision_dir / "pipeline.json").write_text(
        json.dumps({"enable": True}))
    monkeypatch.setenv("MFCD_PIPELINE", "0")
    assert decisions.flag_enabled("MFCD_PIPELINE", "pipeline") is False
    monkeypatch.setenv("MFCD_PIPELINE", "1")
    assert decisions.flag_enabled("MFCD_PIPELINE", "pipeline") is True


def test_artifact_used_when_env_unset(decision_dir, monkeypatch):
    monkeypatch.delenv("MFCD_PIPELINE", raising=False)
    (decision_dir / "pipeline.json").write_text(
        json.dumps({"enable": True, "evidence": {"speedup": 1.1}}))
    assert decisions.flag_enabled("MFCD_PIPELINE", "pipeline") is True
    decisions._cache.clear()
    (decision_dir / "pipeline.json").write_text(
        json.dumps({"enable": False}))
    assert decisions.flag_enabled("MFCD_PIPELINE", "pipeline") is False


def test_missing_or_malformed_artifact_falls_back(decision_dir, monkeypatch):
    monkeypatch.delenv("MFCD_PIPELINE", raising=False)
    assert decisions.flag_enabled("MFCD_PIPELINE", "pipeline") is False
    assert decisions.flag_enabled("MFCD_PIPELINE", "pipeline",
                                  default=True) is True
    decisions._cache.clear()
    (decision_dir / "pipeline.json").write_text("{not json")
    assert decisions.flag_enabled("MFCD_PIPELINE", "pipeline") is False
    decisions._cache.clear()
    (decision_dir / "pipeline.json").write_text(json.dumps({"enable": "yes"}))
    assert decisions.flag_enabled("MFCD_PIPELINE", "pipeline") is False


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_record_decision_refused_off_the_card(decision_dir, device):
    """A CPU measurement is refused; so is one that names the card on a
    host without one."""
    assert decisions.record_decision("pipeline", True, {"x": 1},
                                     device=device) is None
    assert not (decision_dir / "pipeline.json").exists()


def test_record_decision_persists_with_provenance(decision_dir, monkeypatch,
                                                  on_a_card):
    path = decisions.record_decision(
        "some_feature", False, {"speedup": 1.01, "rule": "r"},
        device="cuda")
    assert os.path.dirname(path) == str(decision_dir)
    rec = json.load(open(path))
    assert rec["enable"] is False
    assert rec["evidence"]["speedup"] == 1.01
    assert rec["platform"] == "cuda"
    assert rec["card"] == CARD
    assert "recorded_at_utc" in rec and "commit" in rec
    # The freshly recorded decision is visible without a cache clear.
    monkeypatch.delenv("MFCD_SOME_FEATURE", raising=False)
    assert decisions.flag_enabled("MFCD_SOME_FEATURE", "some_feature",
                                  default=True) is False


def test_gates_resolve_through_decisions(decision_dir, monkeypatch,
                                         on_a_card):
    """The pipeline's gate consults the module, in both directions."""
    monkeypatch.delenv("MFCD_PIPELINE", raising=False)
    decisions.record_decision("pipeline", True, {}, device="cuda")
    assert pipeline_enabled() is True
    decisions._cache.clear()
    (decision_dir / "pipeline.json").write_text(
        json.dumps({"enable": False}))
    assert pipeline_enabled() is False


def test_tpu_artifact_does_not_turn_the_card_flag_on(monkeypatch):
    """``docs/decisions/pipeline.json`` was measured on a TPU and says
    enable; the card reads its own directory, which holds no artifact, so
    with the env var unset the pipeline stays off."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tpu_dir = os.path.join(repo, "docs", "decisions")
    with open(os.path.join(tpu_dir, "pipeline.json")) as f:
        tpu = json.load(f)
    assert tpu["enable"] is True and tpu["platform"] == "tpu"
    assert decisions.DECISION_DIR == os.path.join(repo, "docs",
                                                  "decisions_cuda")
    assert not os.path.exists(decisions.decision_path("pipeline"))
    monkeypatch.delenv("MFCD_PIPELINE", raising=False)
    monkeypatch.setattr(decisions, "_cache", {})
    assert decisions.load_decision("pipeline") is None
    assert pipeline_enabled() is False
