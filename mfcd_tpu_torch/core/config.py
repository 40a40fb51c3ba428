"""Experiment configuration dataclasses.

Counterpart of ``mfcd_tpu/core/config.py``, copied verbatim (it is pure
Python): the port keeps its own copy because importing any ``mfcd_tpu``
module pulls in jax.

The reference drives everything through 16 keyword arguments threaded from
``parameter_scan`` into ``run_experiment`` (reference ``structure.py:81-125``).
Here those become a frozen dataclass, ``RunConfig``, whose *static* fields
(sizes, epochs, strategy names) determine all array shapes up front — the
precondition for compiling a whole run as one XLA program — while the
*numeric* fields (``s``, ``lr``, ``weight_decay``) may be traced and
therefore vmapped across a batch of configurations sharing shapes
(``alpha`` stays static: it parameterizes the samplers and their overdraw
plans).

``SweepSpec`` reproduces the scalar-or-list convention with numpy-to-native
normalization and grid/linear expansion of the reference
(``structure.py:128-157, 205-221, 253-255``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# Parameters recorded in every result's ``params`` dict, in reference order
# (reference ``structure.py:121-125``).
PARAM_KEYS = (
    "n", "m", "d", "p", "lr", "weight_decay", "num_epochs", "reps", "s", "K",
    "d1", "strategy", "popularity_method", "alpha", "soft_label", "generation",
)

# Fraction of sampled triplets per split (reference ``structure.py:705-707``).
TRAIN_RATIO = 0.8
VAL_RATIO = 0.1
# Minimum number of *labels* in the test split; topped up with extra triplets
# when short (reference ``structure.py:721-730``).
MIN_TEST_POINTS = 500
# Reference DataLoader batch size (reference ``structure.py:738-740``).
DEFAULT_BATCH_SIZE = 64


def _next_pow2(x: int) -> int:
    """Smallest power of two >= x (1 for x <= 1).

    Single source of truth for every capacity/padding bucket boundary
    (``sampling.dedup`` and the engine import it from here)."""
    return 1 << max(int(x) - 1, 0).bit_length()


# Strategies whose proposal distributions have *static* parameters derived
# from the exact triplet budget (svd: the truncated rank; user_similarity:
# neighbor count and top-set size, reference ``generation_data.py:144,
# 278-280``).  Capping their capacities would silently change those
# parameters — and therefore the sampling distribution — so they always
# compile at exact capacity.
UNCAPPED_STRATEGIES = ("svd", "user_similarity")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """One experiment configuration (the reference's 16 params).

    Fields mirror ``parameter_scan``'s signature (reference
    ``structure.py:81-85``); ``batch_size`` is a new explicit knob that
    defaults to the reference's hard-wired 64.
    """

    n: int = 1000
    m: int = 1000
    d: int = 2
    p: float = 0.5
    s: float = 1.0
    lr: float = 1e-3
    weight_decay: float = 1e-5
    num_epochs: int = 30
    reps: int = 1
    K: int = 1
    d1: Optional[int] = None  # accepted but unused, as in the reference
    strategy: str = "random"
    popularity_method: str = "zipf"
    alpha: float = 1.5
    soft_label: bool = False
    generation: str = "base"
    batch_size: int = DEFAULT_BATCH_SIZE

    def params_dict(self) -> Dict[str, Any]:
        """The ``params`` dict stored next to results (schema parity)."""
        out = {k: getattr(self, k) for k in PARAM_KEYS}
        return out

    # ---- static shape derivations -------------------------------------

    @property
    def num_triplets(self) -> int:
        """Triplet budget ``n*m*p/2`` (reference ``structure.py:356``)."""
        return int(self.n * self.m * self.p / 2)

    def shapes(self) -> "ShapeInfo":
        return ShapeInfo.from_config(self)

    def shape_signature(self, capped: bool = False) -> Tuple:
        """Hashable key identifying the compiled-program bucket.

        Configs with equal signatures share all array shapes and static
        branches, so their runs can be vmapped together / share one cache
        entry.  s/lr/weight_decay are excluded — they are traced.  alpha is
        INCLUDED: it is baked statically into the samplers (it shapes the
        popularity law and the overdraw plan).

        ``capped=True`` keys on the power-of-two *capacity* bucket instead
        of the exact triplet budget (which then varies inside a bucket as a
        traced scalar) — configs differing only in sparsity share programs.
        """
        sh = self.shapes()
        if capped and self.strategy not in UNCAPPED_STRATEGIES:
            t_key = (
                _next_pow2(sh.num_triplets),
                _next_pow2(sh.extra_test_triplets)
                if sh.extra_test_triplets > 0 else 0,
            )
        else:
            t_key = (sh.num_triplets, sh.extra_test_triplets)
        return (
            self.n, self.m, self.d, t_key, self.K,
            self.num_epochs, self.reps, self.strategy,
            self.popularity_method, self.alpha, self.soft_label,
            self.generation, self.batch_size,
        )


@dataclasses.dataclass(frozen=True)
class ShapeInfo:
    """All static array sizes implied by a RunConfig.

    The reference computes these dynamically from python-set sizes
    (``structure.py:704-730``); for XLA they must be known at trace time.
    Shortfall (a sampler returning fewer unique triplets than budgeted)
    is represented downstream with validity masks rather than smaller
    arrays.
    """

    n: int
    m: int
    d: int
    num_triplets: int          # T: sampling target
    train_triplets: int        # int(0.8*T)
    val_triplets: int          # int(0.1*T)
    test_triplets: int         # T - train - val
    extra_test_triplets: int   # top-up so test labels >= MIN_TEST_POINTS
    K: int
    soft_label: bool
    batch_size: int
    num_epochs: int

    @classmethod
    def from_config(cls, cfg: RunConfig) -> "ShapeInfo":
        t = cfg.num_triplets
        train_t = int(TRAIN_RATIO * t)
        val_t = int(VAL_RATIO * t)
        test_t = t - train_t - val_t
        # Top-up (reference ``structure.py:721-730``): if test labels < 500,
        # sample ceil(500/K) - test_t extra triplets excluding seen ones.
        if test_t * cfg.K < MIN_TEST_POINTS:
            needed = -(-MIN_TEST_POINTS // cfg.K) - test_t
            extra = max(0, needed)
        else:
            extra = 0
        return cls(
            n=cfg.n, m=cfg.m, d=cfg.d,
            num_triplets=t,
            train_triplets=train_t,
            val_triplets=val_t,
            test_triplets=test_t,
            extra_test_triplets=extra,
            K=cfg.K,
            soft_label=cfg.soft_label,
            batch_size=cfg.batch_size,
            num_epochs=cfg.num_epochs,
        )

    # label-row counts per split (hard labels multiply by K,
    # soft labels collapse to one row; reference ``structure.py:507-519``)
    @property
    def train_rows(self) -> int:
        return self.train_triplets if self.soft_label else self.train_triplets * self.K

    @property
    def val_rows(self) -> int:
        return self.val_triplets * self.K

    @property
    def test_rows(self) -> int:
        return (self.test_triplets + self.extra_test_triplets) * self.K

    def num_batches(self, rows: int) -> int:
        return -(-rows // self.batch_size)

    @property
    def train_batches(self) -> int:
        return self.num_batches(self.train_rows)

    @property
    def val_batches(self) -> int:
        return self.num_batches(self.val_rows)

    @property
    def test_batches(self) -> int:
        return self.num_batches(self.test_rows)


def _to_native(x: Any) -> Any:
    """numpy scalar -> native python (reference ``structure.py:128-134``)."""
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, np.bool_):
        return bool(x)
    return x


def normalize_param(v: Any) -> Any:
    """Normalize a scalar-or-list parameter value.

    ndarray -> list; numpy scalars -> native; lists normalized elementwise
    (reference ``structure.py:128-134``).
    """
    if isinstance(v, np.ndarray):
        return [_to_native(x) for x in v.tolist()]
    if isinstance(v, list):
        return [_to_native(x) for x in v]
    return _to_native(v)


@dataclasses.dataclass
class SweepSpec:
    """A sweep over the 16 reference parameters, scalar-or-list each.

    ``linear=False`` expands the full Cartesian product
    (reference ``structure.py:157``); ``linear=True`` zips equal-length
    lists (reference ``structure.py:205-221``) and raises when list lengths
    are not synchronized (reference ``structure.py:253-255``).
    """

    params: Dict[str, Any]
    linear: bool = False
    batch_size: int = DEFAULT_BATCH_SIZE

    def __post_init__(self):
        unknown = set(self.params) - set(PARAM_KEYS)
        if unknown:
            raise ValueError(f"Unknown sweep parameters: {sorted(unknown)}")
        full = {k: self.params.get(k, getattr(RunConfig, k)) for k in PARAM_KEYS}
        self.params = {k: normalize_param(v) for k, v in full.items()}

    def _list_values(self) -> List[list]:
        return [v for v in self.params.values() if isinstance(v, list)]

    def linear_possible(self) -> bool:
        lists = self._list_values()
        if len(lists) <= 1:
            return True
        return all(len(v) == len(lists[0]) for v in lists)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return iter(self.expand())

    def expand(self) -> List[Dict[str, Any]]:
        """List of per-experiment ``params`` dicts, in reference order."""
        listified = {
            k: (v if isinstance(v, (list, tuple)) else [v])
            for k, v in self.params.items()
        }
        if not self.linear:
            combos = itertools.product(*listified.values())
            return [dict(zip(listified.keys(), c)) for c in combos]
        if not self.linear_possible():
            raise ValueError(
                "The linear scan is not possible because the parameters "
                "are not synchronized."
            )
        lists = self._list_values()
        length = len(lists[0]) if lists else 1
        return [
            {k: (v[i] if len(v) > 1 else v[0]) for k, v in listified.items()}
            for i in range(length)
        ]

    def configs(self) -> List[RunConfig]:
        return [
            RunConfig(batch_size=self.batch_size, **params)
            for params in self.expand()
        ]


def bucket_by_shape(
    configs: Sequence[RunConfig], capped: bool = False
) -> Dict[Tuple, List[int]]:
    """Group config indices by shape signature (compile-bucket planning).

    ``capped=True`` groups by capacity bucket: configs differing only in
    sparsity land in one bucket and run as one program with traced exact
    budgets."""
    buckets: Dict[Tuple, List[int]] = {}
    for idx, cfg in enumerate(configs):
        buckets.setdefault(cfg.shape_signature(capped=capped), []).append(idx)
    return buckets
