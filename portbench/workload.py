"""The calls a cell makes, and the closed loop that times them.

One general generator reads a traffic file (``traffic/<name>.json``):

- ``entry``: the program's entry point the calls go to;
- ``reps``: repetitions a configuration;
- ``cycle``: ``[[param, values], ...]``; the calls walk the product of
  the value lists in order (the first list slowest), one combination a
  call, from an offset drawn from the seed;
- ``grid``: ``{param: values}`` passed whole to every call (a sweep of
  many configurations in one call);
- ``warmup_calls``, ``check_calls``, ``trace_calls``: the calls run
  before the window, the consecutive calls the correctness check
  recomputes (a block drawn from the seed among those the window
  completed, so that it meets neighbouring values of the cycle), and the
  calls the traced run profiles after the window.

Values are lists, ``{"logspace": [lo, hi, num]}`` for numpy's, or
``{"concat": [values, ...]}`` for such values one after another.  Every
call takes its own seed, drawn from the run's seed and the call's index,
so no two calls of a run repeat one another; every run makes the same
kinds of calls, in another order.
"""

from __future__ import annotations

import hashlib
import itertools
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import numpy as np

# The study's parameters, in the order its grid expands them (the first
# slowest); an entry takes the ones its signature names.
STUDY_PARAMS = ("n", "m", "d", "p", "lr", "weight_decay", "num_epochs",
                "reps", "s", "K", "d1", "strategy", "popularity_method",
                "alpha", "soft_label", "generation")


def values(spec) -> list:
    if isinstance(spec, dict) and "logspace" in spec:
        lo, hi, num = spec["logspace"]
        return [float(v) for v in np.logspace(lo, hi, int(num))]
    if isinstance(spec, dict) and "concat" in spec:
        return [v for part in spec["concat"] for v in values(part)]
    return list(spec)


def derive(seed: int, tag: str, bits: int = 31) -> int:
    """A number of ``bits`` bits drawn from ``seed`` and ``tag``."""
    h = hashlib.blake2b(f"{int(seed)}:{tag}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << bits) - 1)


@dataclass
class Plan:
    """Call ``k``'s arguments: the configuration's study parameters, the
    mix's values for that call, and the call's seed."""

    entry: str
    study: dict
    traffic: dict
    seed: int
    combos: List[Tuple] = field(init=False)
    offset: int = field(init=False)

    def __post_init__(self):
        cyc = self.traffic.get("cycle", [])
        self.names = [name for name, _ in cyc]
        self.combos = list(itertools.product(*(values(v) for _, v in cyc)))
        self.offset = derive(self.seed, "offset") % max(len(self.combos), 1)

    def call(self, k: int) -> Dict:
        args = dict(self.study)
        args["reps"] = int(self.traffic["reps"])
        for name, spec in self.traffic.get("grid", {}).items():
            args[name] = values(spec)
        if self.combos:
            combo = self.combos[(self.offset + k) % len(self.combos)]
            args.update(zip(self.names, combo))
        args["seed"] = derive(self.seed, f"call:{k}")
        return args

    def runs_per_call(self) -> int:
        configs = 1
        for spec in self.traffic.get("grid", {}).values():
            configs *= len(values(spec))
        return configs * int(self.traffic["reps"])


@dataclass
class Call:
    index: int
    start: float
    end: float
    runs: int
    ok: bool

    @property
    def wall(self) -> float:
        return self.end - self.start


@dataclass
class Window:
    """The closed loop's record: every call, the window's bounds, the set-up
    before it."""

    calls: List[Call]
    start: float
    end: float
    setup_s: float

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def runs(self) -> int:
        return sum(c.runs for c in self.calls if c.ok)


def closed_loop(do_call: Callable[[int], bool], runs_per_call: int,
                seconds: float,
                clock: Callable[[], float] = time.perf_counter,
                setup_s: float = 0.0) -> Window:
    """One caller, one call at a time, each after the last has ended; the
    window closes at the end of the first call that ends ``seconds`` or
    more after it opened.  ``do_call(k)`` returns whether call ``k``
    succeeded."""
    calls: List[Call] = []
    start = clock()
    k = 0
    while True:
        t0 = clock()
        ok = do_call(k)
        t1 = clock()
        calls.append(Call(k, t0, t1, runs_per_call, ok))
        k += 1
        if t1 - start >= seconds:
            return Window(calls, start, t1, setup_s)


def percentile(vals: List[float], q: float) -> float:
    """The ``q``-th percentile, linear between the closest ranks."""
    return float(np.percentile(np.asarray(vals, np.float64), q))


class BlockSample:
    """One block of ``size`` consecutive items of a stream of unknown
    length, drawn uniformly from a seed among the stream's blocks: the same
    seed and stream give the same block.  A stream shorter than a block
    gives all of it."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng = max(int(size), 1), random.Random(seed)
        self.last: List = []
        self.block: List = []
        self.blocks = 0

    def offer(self, item) -> None:
        self.last = (self.last + [item])[-self.size:]
        if len(self.last) < self.size:
            return
        self.blocks += 1
        if self.rng.randrange(self.blocks) == 0:
            self.block = list(self.last)

    def sample(self) -> List:
        return list(self.block) if self.blocks else list(self.last)
