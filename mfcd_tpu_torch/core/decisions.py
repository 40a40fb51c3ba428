"""Measurement-driven feature decisions for the card.

Counterpart of ``mfcd_tpu/core/decisions.py``.  A gated feature reads its
default from a small JSON *decision artifact* that its A/B script writes
after measuring on the card (``scripts/profile_pipeline_ab.py --record``
for the pipeline), with the measurement, the card, the commit and the time
as provenance.

Precedence, most specific wins:

1. an explicit env var (``MFCD_PIPELINE=1`` / ``=0``), the user's override;
2. the card's decision artifact, ``docs/decisions_cuda/<name>.json``;
3. the built-in default (off).

The card's artifacts live apart from the TPU's (``docs/decisions/``), which
this module never reads: a TPU measurement says nothing of the card.  A
decision is recorded only from a measurement that ran on a CUDA device.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
from typing import Any, Dict, Optional

import torch

from mfcd_tpu_torch.backend import card_line

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DECISION_DIR = os.path.join(_REPO, "docs", "decisions_cuda")

_cache: Dict[str, Optional[dict]] = {}


def decision_path(name: str) -> str:
    return os.path.join(DECISION_DIR, f"{name}.json")


def load_decision(name: str) -> Optional[dict]:
    """The decision record for ``name``, or None (missing or malformed).

    Cached per process: artifacts change only through the A/B scripts."""
    if name not in _cache:
        try:
            with open(decision_path(name)) as f:
                rec = json.load(f)
            _cache[name] = rec if isinstance(rec.get("enable"), bool) \
                else None
        except (OSError, ValueError, AttributeError):
            _cache[name] = None
    return _cache[name]


def flag_enabled(env_var: str, decision_name: str,
                 default: bool = False) -> bool:
    """Resolve a gated-feature flag: env var > decision artifact > default."""
    v = os.environ.get(env_var)
    if v is not None and v != "":
        return v != "0"
    rec = load_decision(decision_name)
    if rec is not None:
        return rec["enable"]
    return default


def _commit() -> str:
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=10,
                             cwd=_REPO)
    except OSError:
        return "unknown"
    return out.stdout.strip() or "unknown"


def record_decision(name: str, enable: bool, evidence: Dict[str, Any],
                    device) -> Optional[str]:
    """Write the decision measured on ``device``; returns the path, or None
    (refused) when ``device`` is not a CUDA device that is present."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return None
    rec = {
        "enable": bool(enable),
        "evidence": evidence,
        "platform": "cuda",
        "card": card_line(),
        "commit": _commit(),
        "recorded_at_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
    }
    os.makedirs(DECISION_DIR, exist_ok=True)
    path = decision_path(name)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    _cache[name] = rec
    return path
