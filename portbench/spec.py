"""Everything the harness runs, found by name.

``BENCHMARK.json`` (at the root of the checkout) names each cell's
configuration and traffic mix and lists the metrics.  The files that
belong to one name sit under this directory:

- ``configs/<config>.json``: the configuration's sizes and settings (the
  file ``BENCHMARK.json`` gives for it);
- ``traffic/<traffic>.json``: the mix of calls (entry point, the values
  the calls walk through, repetitions, warm-up, checked and traced calls);
- ``limits/<cell>.json``: the limit of each number the correctness check
  compares in that cell;
- ``e2e/<metric>.py`` and ``metrics/<metric>.py``: one reader per
  end-to-end and per-layer metric, each a ``read(...)`` that returns a
  number or None;
- ``reference/<config>.py``, where a configuration needs more than the
  plain reference computes: a ``Pipeline`` of its own (as a rule a
  subclass of ``reference/pipeline.py``'s), which the check and the
  faults take in the plain one's place.

A later configuration, cell, mix or metric is a new file and a new entry;
no file here needs an edit for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Type

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    reference: Type


def load_benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    bench = load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    limits = _json(os.path.join(HERE, "limits", name + ".json"))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)],
                reference=reference(w["config"]))


_modules: Dict[str, object] = {}


def _load(kind: str, name: str):
    """The module ``<kind>/<name>.py``, loaded by path once: names may
    hold dots."""
    key = f"{kind}/{name}"
    if key not in _modules:
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
            os.path.join(HERE, kind, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[key] = mod
    return _modules[key]


def reader(kind: str, name: str):
    """The module ``<kind>/<name>.py`` (``kind`` is ``e2e`` or
    ``metrics``).  A name ``<base>.<part>`` with no file of its own (a
    metric split by the end-to-end metric it moves) is read by
    ``<base>``'s reader."""
    if (not os.path.exists(os.path.join(HERE, kind, name + ".py"))
            and "." in name):
        return reader(kind, name.rsplit(".", 1)[0])
    return _load(kind, name)


def reference(config: str) -> Type:
    """Configuration ``config``'s plain reference: the ``Pipeline`` of
    ``reference/<config>.py`` where that file exists, else the plain
    ``reference/pipeline.py``'s, which refuses, by name, any setting it
    does not compute."""
    if os.path.exists(os.path.join(HERE, "reference", config + ".py")):
        return _load("reference", config).Pipeline
    from portbench.reference import pipeline

    return pipeline.Pipeline
