"""Result persistence — the reference's incremental pickle protocol.

Counterpart of ``mfcd_tpu/utils/io.py``, copied (it is pure Python).
``parameter_scan`` deletes any pre-existing save file at scan start
(reference ``structure.py:151-153``), then every ``save_every`` experiments
load-extends-dumps the pickle (reference ``structure.py:175-200``), so a
crash loses at most ``save_every`` runs.  ``resume`` skips configurations
already present in the file.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List


def reset_save_path(save_path: str) -> None:
    """Remove an existing results file (reference ``structure.py:151-153``)."""
    if save_path and os.path.exists(save_path):
        print(f"🧹 Removing existing file at {save_path}")
        os.remove(save_path)


def load_results(save_path: str) -> List[Dict[str, Any]]:
    if not os.path.exists(save_path):
        return []
    with open(save_path, "rb") as f:
        return pickle.load(f)


def append_results(save_path: str, new_results: List[Dict[str, Any]]) -> None:
    """Load-extend-dump (reference ``structure.py:175-200``), atomically.

    The dump goes to a temp file that is ``os.replace``d over the target, so
    a crash mid-write never destroys previously persisted experiments.
    """
    dirname = os.path.dirname(save_path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    previous = load_results(save_path)
    previous.extend(new_results)
    tmp_path = save_path + ".tmp"
    with open(tmp_path, "wb") as f:
        pickle.dump(previous, f)
    os.replace(tmp_path, save_path)
    print(f"✅ Saved {len(new_results)} new experiments to {save_path}")


def completed_param_sets(save_path: str) -> List[Dict[str, Any]]:
    """Params dicts already present in a results file (resume support).

    Post-hoc enrichment keys are dropped before matching so enriched
    pickles resume without being rewritten on disk."""
    from mfcd_tpu_torch.core.config import PARAM_KEYS

    return [
        {k: v for k, v in entry["params"].items() if k in PARAM_KEYS}
        for entry in load_results(save_path)
    ]
