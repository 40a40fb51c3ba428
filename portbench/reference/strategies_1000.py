"""The study's runs under `Runs.ipynb` cell 18's seven triplet samplers,
in plain PyTorch: the reference of the configuration ``strategies_1000``.

Everything but the sample stage is the plain reference's
(``reference/pipeline.py``): generation (``base`` only), labels,
training, metrics.  The sample stage draws a run's triplets from its
``sampling`` key, splits them 80/10/10 by the fixed seed-42 permutation of
their order and tops the test split up to 500 labels with triplets drawn
from its ``extra_sampling`` key that exclude the kept sample.  The
samplers (``generation_data.py``), as the port defines them:

- ``random``: uniform (u, i, j), i != j;
- ``proximity``: u uniform, i uniform among u's 100 highest scores, j
  among its 100 lowest;
- ``margin``: uniform (u, i, j) kept where |X[u, i] - X[u, j]| is at most
  the window: the mean range of the first min(10, n) rows of X times
  T / (n m) (``generation_data.py:57``), T the budget the draw serves;
- ``variance``: u uniform, i and j from the items' score variance over
  users (i ~ w, j ~ w given j != i);
- ``popularity``: the same from a law over item indices (zipf 1 / k^alpha,
  exponential, or uniform);
- ``top_k``: u uniform, i != j uniform among u's k = min(m, max(5, m / 10))
  highest scores;
- ``svd``: u among the 30 % of users, i != j among the 30 % of items,
  whose rows of a rank-r factorisation of X have the largest norms, r =
  T / (n m) x max(n, m) (``generation_data.py:144``).

Departures from the published description, each the port's definition:

- every random choice comes from threefry keys (``reference/prng.py``),
  not from torch's or numpy's global generators;
- ``random``, ``proximity``, ``top_k`` and ``svd``, where their finite
  proposal domain fits, draw the sample as the first T values of a keyed
  permutation of the domain (a uniform T-subset in uniform order, as the
  rejection loops give), the top-up as the values just after the main
  block; ``proximity`` then takes its lowest-score table disjoint from the
  highest (it needs m >= 200);
- ``margin``, where its proposals fit the random domain, proposes the
  first values of a keyed permutation of it, distinct by construction, the
  top-up the values after them, from the same key;
- elsewhere a fixed number of proposals (the port's plan: a capped
  overdraw, not a loop until the budget), of which each triplet's first
  occurrence in draw order wins, where two triplets count as one when
  their packed index ``(u m + i) m + j`` shares its top bits of a
  multiplicative hash (a uniform thinning of distinct triplets, at a
  table of 2^20-2^24 slots, while n m^2 < 2^31); the top-up's winners
  exclude the kept sample the same way; a sample that falls short of its
  budget keeps what it has;
- the variance and popularity draws invert CDFs summed in int64 fixed
  point and rounded once to float32, not ``torch.multinomial``;
- ``svd`` factors X by randomized subspace iteration (a keyed Gaussian
  probe of r + 8 columns, 4 power iterations, thin QRs, one small SVD);
- capacities are powers of two at or above T (exact for ``svd``): they
  set the bit widths of the permutations, the 80/10/10 split is a keyed
  permutation of the sample's order, and the split sizes are floored in
  float32.

A training stream shorter than one batch (a sample of a few triplets, at
the tests' sizes, never at the cell's) is padded to the whole batch before
it is shuffled, its permutations' width still from its rows, as the port
pads it; the plain reference's trainer takes only streams of whole
batches.

``cluster``, ``user_similarity`` and every generation but ``base`` are
refused by name.  Each product goes through :meth:`Pipeline._mm`, which
rounds its operands to TF32 in the control.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench.reference import pipeline, prng
from portbench.reference.pipeline import (SPLIT_SEED, TRAIN_RATIO, VAL_RATIO,
                                          Shape, next_pow2)

STRATEGIES = ("random", "proximity", "margin", "variance", "popularity",
              "top_k", "svd")
EXACT_CAPACITY = ("svd",)
POPULARITY = ("zipf", "exponential", "uniform")
PROXIMITY_K = 100
TOP_FRACTION = 0.3
HASH_MUL = 2654435761


# -- draws from keys ------------------------------------------------------

def _keys(k, num: int):
    return prng.split(k, num).unbind(-2)


def randint(k, shape, lo: int, hi: int) -> torch.Tensor:
    """``[R, *shape]`` draws in ``[lo, hi)`` from ``[R, 2]`` keys
    (``jax.random.randint``'s two-word formula), int64."""
    k1, k2 = _keys(k, 2)
    higher, lower = prng.bits(k1, shape), prng.bits(k2, shape)
    span = (hi - lo) & prng.M32 if hi > lo else 1
    mult = ((2 ** 16 % span) ** 2 & prng.M32) % span
    off = prng.mul32(higher % span, mult)
    return lo + ((off + lower % span) & prng.M32) % span


def distinct_pair(k, draws: int, size: int):
    """``draws`` pairs a != b of positions in ``[0, size)``."""
    k1, k2 = _keys(k, 2)
    a = randint(k1, (draws,), 0, size)
    b = randint(k2, (draws,), 0, max(size - 1, 1))
    if size > 1:
        b = b + (b >= a).to(b.dtype)
    return a, b


def permuted(k, slots: torch.Tensor, domain: int) -> torch.Tensor:
    """The keyed permutation of ``[0, domain)`` at ``slots``."""
    return prng.prefix_permutation(k, slots, domain,
                                   max((domain - 1).bit_length(), 1))


def top(v: torch.Tensor, k: int) -> torch.Tensor:
    """The positions of the ``k`` largest values of each row, largest
    first, the lower position first among ties."""
    return torch.sort(v, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def at(table: torch.Tensor, *idx: torch.Tensor) -> torch.Tensor:
    """``table[r, idx...]`` for each run ``r`` (the leading axis)."""
    rows = torch.arange(table.shape[0], device=table.device).reshape(
        (-1,) + (1,) * (idx[0].dim() - 1))
    return table[(rows,) + tuple(i.to(torch.int64) for i in idx)]


def pair(idx: torch.Tensor, size: int):
    """Index of an ordered pair a != b of ``[0, size)``."""
    a = idx // (size - 1)
    b = idx - a * (size - 1)
    return a, b + (b >= a).to(b.dtype)


def decode_random(idx: torch.Tensor, m: int) -> torch.Tensor:
    """Index of the random domain, ``[0, n m (m - 1))``, as (u, i, j)."""
    u = idx // (m * (m - 1))
    i, j = pair(idx - u * (m * (m - 1)), m)
    return torch.stack([u, i, j], dim=-1)


# -- the port's sizes and paths --------------------------------------------

def top_k_size(m: int) -> int:
    return min(m, max(5, int(0.1 * m)))


def svd_sizes(n: int, m: int):
    return max(1, int(TOP_FRACTION * n)), max(2, int(TOP_FRACTION * m))


def proposals(strategy: str, t: int, n: int, m: int, method: str,
              alpha: float) -> int:
    """How many candidates a draw of ``t`` triplets proposes."""

    def plan(population, p_valid=1.0, safety=1.3, cap=None):
        frac = min(t / max(population, 1.0), 0.999)
        need = -max(population, 1.0) * math.log1p(-frac) / max(p_valid, 1e-6)
        draws = max(int(math.ceil(need * safety)) + 512, t)
        return min(draws, cap) if cap else draws

    if strategy == "random":
        return plan(n * m * (m - 1), p_valid=(m - 1) / m)
    if strategy == "proximity":
        k = min(PROXIMITY_K, m)
        return plan(n * k * k, safety=1.5)
    if strategy == "margin":
        return min(5_000_000, max(4 * t, (n * m) // 2 + 4 * t))
    if strategy == "variance":
        return plan(n * m * (m - 1) / 4.0, safety=1.6)
    if strategy == "popularity":
        w = np.arange(1, m + 1, dtype=np.float64)
        w = (1.0 / w ** alpha if method == "zipf" else
             np.exp(-alpha * (w - 1.0)) if method == "exponential" else
             np.ones(m))
        w /= w.sum()
        eff = 1.0 / float((w ** 2).sum())
        return plan(n * eff * max(eff - 1.0, 1.0), safety=2.0,
                    cap=20_000_000)
    if strategy == "top_k":
        return 3 * t
    return 5 * t                                                  # svd


def prefix_domain(strategy: str, n: int, m: int, blocks: int):
    """The size of the strategy's proposal domain where its sample is a
    permutation prefix of it (``blocks`` slots fit), else None."""
    if strategy == "random":
        dom, ok = n * m * (m - 1), m >= 2
    elif strategy == "proximity":
        k = min(PROXIMITY_K, m)
        dom, ok = n * k * k, m >= 2 * k
    elif strategy == "top_k":
        k = top_k_size(m)
        dom, ok = n * k * (k - 1), k >= 2
    elif strategy == "svd":
        nu, mt = svd_sizes(n, m)
        dom, ok = nu * mt * (mt - 1), mt >= 2
    else:
        return None
    return dom if ok and dom < 2 ** 31 and blocks <= dom else None


def margin_distinct(n: int, m: int, t_cap: int, e_cap: int) -> bool:
    """Whether margin proposes distinct triplets (both blocks fit the
    random domain, and the top-up's window lies inside the main one's)."""
    draws = proposals("margin", t_cap, n, m, "", 0.0) + (
        proposals("margin", e_cap, n, m, "", 0.0) if e_cap else 0)
    dom = n * m * (m - 1)
    return (m >= 2 and dom < 2 ** 31 and draws <= dom
            and 2 * e_cap <= t_cap)


def capacities(sh: Shape):
    """(t_cap, e_cap): the sample's and the top-up's buffer sizes."""
    t, e = sh.triplets, sh.extra_test
    if sh.strategy in EXACT_CAPACITY:
        return t, e
    return next_pow2(t), (next_pow2(e) if e > 0 else 0)


class _Trainer(pipeline._Trainer):
    """The plain trainer, its stream padded to whole batches; on the card
    an epoch's steps replay two CUDA graphs, of ``GRAPH_STEPS`` steps and
    of the rest (the plain trainer's chunk divides the steps, so a prime
    step count, 569 at p = 0.0909, ran one step at a time).

    A temporary copy of ``pipeline._Trainer.run`` that differs only in its
    chunk rule: once the plain trainer takes the chunk-and-remainder rule
    (and the padding), this subclass goes."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        pad = -self.s_len % self.sh.batch_size
        if pad:
            self.stream = tuple(torch.nn.functional.pad(a, (0, pad))
                                for a in self.stream)
            self.s_len += pad

    def run(self):
        if self.P.device.type != "cuda":
            return super().run()
        chunk = min(self.GRAPH_STEPS, self.steps)
        whole, rest = divmod(self.steps, chunk)
        graphs = None
        tl, vl = [], []
        for epoch in range(self.sh.num_epochs):
            z, mask, inv = self._load_epoch(epoch)
            self.e_step.zero_()
            if graphs is None:
                graphs = (self._capture(chunk),
                          self._capture(rest) if rest else None)
            for _ in range(whole):
                graphs[0].replay()
            if rest:
                graphs[1].replay()
            per_step = torch.sum(self.pipe.bce(self.logit_log, z) * mask,
                                 dim=-1) * inv * self.active
            # The epoch's loss sums the steps' in order, in float32.
            total = np.add.accumulate(per_step.cpu().numpy(), axis=-1,
                                      dtype=np.float32)[:, -1]
            tl.append(torch.as_tensor(total, device=self.P.device)
                      / torch.clamp(self.nb.to(torch.float32), min=1.0))
            U, V = self.P[:, :self.n], self.P[:, self.n:]
            vl.append(self.pipe.split_loss(U, V, self.val,
                                           self.sh.batch_size))
        U = self.P[:, :self.n].contiguous()
        V = self.P[:, self.n:].contiguous()
        return U, V, torch.stack(tl, dim=-1), torch.stack(vl, dim=-1)


class Pipeline(pipeline.Pipeline):
    """The plain pipeline with cell 18's samplers.  The sample stage reads
    the run's X and its ``extra_sampling`` key, kept from the two steps
    before it (:meth:`streams`, :meth:`generate_x`)."""

    def refuse(self, sh: Shape) -> None:
        asked = (("strategy", sh.strategy, STRATEGIES),
                 ("generation", sh.generation, ("base",)),
                 ("d1", sh.d1, (None,)),
                 ("popularity_method", sh.popularity_method,
                  (None,) + POPULARITY))
        for name, value, known in asked:
            if value not in known:
                raise NotImplementedError(
                    f"{type(self).__name__} computes {name} in {known}, "
                    f"not {name}={value!r}")

    def streams(self, keys):
        self._streams = pipeline.Pipeline.streams(keys)
        return self._streams

    def generate_x(self, k, sh: Shape):
        self._x = super().generate_x(k, sh)
        return self._x

    def sample_splits(self, k, sh: Shape):
        assert k is self._streams["sampling"]
        return self.sample_stage(self._streams, self._x, sh)

    @property
    def trainer(self):
        return _Trainer

    # -- tables -------------------------------------------------------------

    @staticmethod
    def window(x, budget) -> torch.Tensor:
        """The margin window ``[R, 1]`` (``generation_data.py:57``);
        ``budget`` an int or an ``[R]`` int32 tensor (divided in
        float32)."""
        n, m = x.shape[-2:]
        rows = x[..., :min(10, n), :]
        spread = torch.mean(rows.amax(dim=-1) - rows.amin(dim=-1), dim=-1)
        if isinstance(budget, torch.Tensor):
            return (spread * (budget.to(torch.float32) / (n * m))
                    ).unsqueeze(-1)
        return (spread * (budget / (n * m))).unsqueeze(-1)

    @staticmethod
    def cdf(weights: torch.Tensor):
        """(probabilities, CDF) ``[R, m]`` in float32 of nonnegative
        weights: each row scaled by a power of two to int64 fixed point
        below 2^62, summed and scanned exactly, rounded once."""
        w = weights.to(torch.float64)
        _, top_exp = torch.frexp(w.amax(dim=-1, keepdim=True))
        shift = 62 - (w.shape[-1] - 1).bit_length() - top_exp
        fixed = torch.round(torch.ldexp(w, shift)).to(torch.int64)
        scan = torch.cumsum(fixed, dim=-1).to(torch.float64)
        total = scan[..., -1:]
        return ((fixed.to(torch.float64) / total).to(torch.float32),
                (scan / total).to(torch.float32))

    @staticmethod
    def item_variance(x) -> torch.Tensor:
        """Each item's score variance over the users, ddof 1, two-pass."""
        n = x.shape[-2]
        centred = x - x.sum(dim=-2, keepdim=True) / n
        return (centred * centred).sum(dim=-2) / (n - 1)

    @staticmethod
    def popularity(m: int, method: str, alpha: float, device):
        k = torch.arange(1, m + 1, dtype=torch.float32, device=device)
        if method == "zipf":
            w = 1.0 / k ** alpha
        elif method == "exponential":
            w = torch.exp(-alpha * (k - 1.0))
        else:
            w = torch.ones((m,), dtype=torch.float32, device=device)
        return w / w.sum()

    def svd_tables(self, k, x, t: int, budget):
        """The top users' and top items' indices by the norm of their row
        of a rank-r factorisation of X, r from the draw's size ``t``
        (with an ``[R]`` ``budget``, r as budget // min(n, m) within it)."""
        n, m = x.shape[-2:]
        rank = min(max(1, int(t / (n * m) * max(n, m))), min(n, m))
        q = min(rank + 8, min(n, m))
        y = self._mm(x, prng.normal(k, (m, q)))
        xt = x.transpose(-1, -2)
        for _ in range(4):
            y = torch.linalg.qr(y).Q
            y = self._mm(x, self._mm(xt, y))
        basis = torch.linalg.qr(y).Q
        u_b, s, vt = torch.linalg.svd(self._mm(basis.transpose(-1, -2), x),
                                      full_matrices=False)
        u = self._mm(basis, u_b)
        s = s[..., :rank]
        if budget is not None:
            r = torch.clamp(budget.to(torch.int64) // min(n, m), 1, rank)
            s = s * (torch.arange(rank, device=x.device)
                     < r.reshape(-1, 1)).to(torch.float32)
        users = u[..., :rank] * s.unsqueeze(-2)
        items = vt[..., :rank, :].transpose(-1, -2) * s.unsqueeze(-2)
        nu, mt = svd_sizes(n, m)
        return (top(torch.sqrt(torch.sum(users * users, dim=-1)), nu),
                top(torch.sqrt(torch.sum(items * items, dim=-1)), mt))

    # -- proposals ------------------------------------------------------------

    def categorical_pair(self, k, probs, cdf, draws: int):
        """i ~ p and j ~ p given j != i, by inverting the CDF; j's
        variate shrinks to 1 - p_i and steps over i's span."""
        k1, k2 = _keys(k, 2)
        last = cdf.shape[-1] - 1
        total = cdf[..., -1:]
        i = torch.clamp(torch.searchsorted(
            cdf, prng.uniform(k1, (draws,)) * total, right=True), max=last)
        p_i = torch.gather(probs, 1, i)
        left = torch.gather(cdf, 1, i) - p_i
        v = prng.uniform(k2, (draws,)) * torch.clamp(total - p_i, min=1e-30)
        v = torch.where(v >= left, v + p_i, v)
        j = torch.clamp(torch.searchsorted(cdf, v, right=True), max=last)
        return i, j

    def propose(self, k, x, sh: Shape, t: int, budget):
        """``proposals(...)`` candidates ``[R, M, 3]`` of a draw of
        ``t`` triplets (``budget``: its exact target where one is given)
        and whether each is valid, in draw order."""
        n, m = x.shape[-2:]
        method = sh.popularity_method or "zipf"
        alpha = 1.5 if sh.alpha is None else float(sh.alpha)
        draws = proposals(sh.strategy, t, n, m, method, alpha)
        s = sh.strategy
        if s == "random":
            ku, kij = _keys(k, 2)
            u = randint(ku, (draws,), 0, n)
            ij = randint(kij, (draws, 2), 0, m)
            i, j = ij[..., 0], ij[..., 1]
            ok = i != j
        elif s == "proximity":
            kk = min(PROXIMITY_K, m)
            high, low = top(x, kk), top(-x, kk)
            ku, ki, kj = _keys(k, 3)
            u = randint(ku, (draws,), 0, n)
            i = at(high, u, randint(ki, (draws,), 0, kk))
            j = at(low, u, randint(kj, (draws,), 0, kk))
            ok = i != j
        elif s == "margin":
            win = self.window(x, t if budget is None else budget)
            ku, ki, kj = _keys(k, 3)
            u = randint(ku, (draws,), 0, n)
            i = randint(ki, (draws,), 0, m)
            j = randint(kj, (draws,), 0, m)
            ok = (i != j) & ((at(x, u, i) - at(x, u, j)).abs() <= win)
        elif s in ("variance", "popularity"):
            w = (self.item_variance(x) if s == "variance" else
                 self.popularity(m, method, alpha, x.device).expand(
                     x.shape[0], m))
            probs, cdf = self.cdf(w)
            ku, kij = _keys(k, 2)
            u = randint(ku, (draws,), 0, n)
            i, j = self.categorical_pair(kij, probs, cdf, draws)
            ok = i != j
        elif s == "top_k":
            high = top(x, top_k_size(m))
            ku, kp = _keys(k, 2)
            u = randint(ku, (draws,), 0, n)
            a, b = distinct_pair(kp, draws, high.shape[-1])
            i, j = at(high, u, a), at(high, u, b)
            ok = i != j
        else:                                                     # svd
            kt, k = _keys(k, 2)
            users, items = self.svd_tables(kt, x, t, budget)
            ku, kp = _keys(k, 2)
            u = at(users, randint(ku, (draws,), 0, users.shape[-1]))
            a, b = distinct_pair(kp, draws, items.shape[-1])
            i, j = at(items, a), at(items, b)
            ok = i != j
        return torch.stack([u, i, j], dim=-1).to(torch.int64), ok

    # -- selection ------------------------------------------------------------

    def winners(self, rows, valid, nm, excluded: int = 0):
        """Whether each of ``rows [R, M, 3]`` (in draw order, the first
        ``excluded`` an exclude set that only vetoes) is the first valid
        one of its triplet."""
        n, m = nm
        r, total = valid.shape
        packed = (rows[..., 0] * m + rows[..., 1]) * m + rows[..., 2]
        if n * m * m < 2 ** 31:
            bits = min(max((16 * total - 1).bit_length(), 20), 24)
            ident = prng.mul32(packed & prng.M32, HASH_MUL) >> (32 - bits)
        else:
            ident = packed
        order = torch.arange(total, device=rows.device).expand(r, total)
        # an invalid row is a triplet of its own
        ident = torch.where(valid, ident, 2 ** 40 + order)
        by = torch.argsort(ident, dim=-1, stable=True)
        sorted_ident = torch.gather(ident, 1, by)
        first = torch.ones_like(valid)
        first[:, 1:] = sorted_ident[:, 1:] != sorted_ident[:, :-1]
        head = torch.zeros_like(valid).scatter_(1, by, first)
        return head & valid & (order >= excluded)

    @staticmethod
    def kept(rows, win, budget: int, cap: int):
        """The first ``budget`` winners in order, ``[R, cap, 3]`` (zeros
        past them), and their count ``[R]`` int32."""
        r = rows.shape[0]
        out = torch.zeros((r, cap, 3), dtype=torch.int64, device=rows.device)
        count = torch.zeros((r,), dtype=torch.int32, device=rows.device)
        for run in range(r):
            got = rows[run][win[run]][:budget]
            out[run, :got.shape[0]] = got
            count[run] = got.shape[0]
        return out, count

    def splits(self, sample, count, extra, extra_count, t_cap: int,
               e_cap: int):
        """The train, val and test buffers: output slot y of the sample's
        first ``count`` rows holds the row whose rank the seed-42 keyed
        permutation maps to y; the test split's top-up follows its rows."""
        dev = sample.device
        train_cap = int(TRAIN_RATIO * t_cap)
        val_cap = int(VAL_RATIO * t_cap)
        test_cap = t_cap - train_cap - val_cap
        cf = count.to(torch.float32)
        train_sz = torch.floor(TRAIN_RATIO * cf).to(torch.int32)
        val_sz = torch.floor(VAL_RATIO * cf).to(torch.int32)
        test_fit = torch.clamp(count - train_sz - val_sz, max=test_cap)
        col = lambda v: v.unsqueeze(-1)
        o = torch.arange(t_cap + e_cap, dtype=torch.int32, device=dev)
        in_tr = o < train_cap
        in_va = (o >= train_cap) & (o < train_cap + val_cap)
        off = torch.where(in_tr, o, torch.where(in_va, o - train_cap,
                                                o - train_cap - val_cap))
        base = torch.where(in_tr, 0, torch.where(in_va, col(train_sz),
                                                 col(train_sz + val_sz)))
        size = torch.where(in_tr, col(train_sz),
                           torch.where(in_va, col(val_sz), col(test_fit)))
        is_data = off < size
        is_extra = (~in_tr & ~in_va & (off >= col(test_fit))
                    & (off - col(test_fit) < col(extra_count)))
        y = torch.where(is_data, base + off, 0)
        rank = prng.prefix_permutation_inverse(
            prng.key(SPLIT_SEED, dev), y, count,
            max((t_cap - 1).bit_length(), 1))
        take = lambda buf, idx: torch.gather(
            buf, 1, idx.to(torch.int64).unsqueeze(-1).expand(-1, -1, 3))
        tri = torch.where(is_data.unsqueeze(-1), take(sample, rank), 0)
        if e_cap:
            e = torch.clamp(off - col(test_fit), 0, e_cap - 1)
            tri = torch.where(is_extra.unsqueeze(-1), take(extra, e), tri)
        tri = tri.to(torch.int32)
        return ((tri[:, :train_cap], torch.clamp(train_sz, max=train_cap)),
                (tri[:, train_cap:train_cap + val_cap],
                 torch.clamp(val_sz, max=val_cap)),
                (tri[:, train_cap + val_cap:], test_fit + extra_count))

    # -- the stage ------------------------------------------------------------

    def domain(self, k, x, sh: Shape, t_cap: int, budget):
        """(size, decode, key) of the strategy's prefix domain."""
        n, m = x.shape[-2:]
        s = sh.strategy
        if s == "random":
            return n * m * (m - 1), lambda idx: decode_random(idx, m), k
        if s == "proximity":
            kk = min(PROXIMITY_K, m)
            high = top(x, kk)
            low = top(-x.scatter(-1, high, float("inf")), kk)

            def decode(idx):
                u = idx // (kk * kk)
                a = (idx - u * kk * kk) // kk
                b = idx - u * kk * kk - a * kk
                return torch.stack([u, at(high, u, a), at(low, u, b)],
                                   dim=-1)
            return n * kk * kk, decode, k
        if s == "top_k":
            kk = top_k_size(m)
            high = top(x, kk)

            def decode(idx):
                u = idx // (kk * (kk - 1))
                a, b = pair(idx - u * kk * (kk - 1), kk)
                return torch.stack([u, at(high, u, a), at(high, u, b)],
                                   dim=-1)
            return n * kk * (kk - 1), decode, k
        kt, k = _keys(k, 2)                                       # svd
        users, items = self.svd_tables(kt, x, t_cap, budget)
        mt = items.shape[-1]

        def decode(idx):
            us = idx // (mt * (mt - 1))
            a, b = pair(idx - us * mt * (mt - 1), mt)
            return torch.stack([at(users, us), at(items, a), at(items, b)],
                               dim=-1)
        return users.shape[-1] * mt * (mt - 1), decode, k

    def sample_stage(self, st: Dict[str, torch.Tensor], x, sh: Shape):
        """The train, val and test triplet buffers with their counts of a
        shape's runs, from the runs' key streams ``st`` and their X."""
        self.refuse(sh)
        n, m = sh.n, sh.m
        r, dev = x.shape[0], x.device
        t, e = sh.triplets, sh.extra_test
        t_cap, e_cap = capacities(sh)
        exact = (t, e) == (t_cap, e_cap)
        full = lambda v: torch.full((r,), v, dtype=torch.int32, device=dev)
        budget = None if exact else full(t)
        e_budget = None if exact else full(e)
        ks = st["sampling"]
        span = lambda lo, num: torch.arange(lo, lo + num, device=dev)
        dom = prefix_domain(sh.strategy, n, m, t_cap + e_cap)
        if dom is not None:
            dom, decode, key = self.domain(ks, x, sh, t_cap, budget)
            sample = decode(permuted(key, span(0, t_cap), dom))
            extra = decode(permuted(key, span(t_cap, e_cap), dom))
            return self.splits(sample, full(t), extra, full(e), t_cap, e_cap)
        if sh.strategy == "margin" and margin_distinct(n, m, t_cap, e_cap):
            dom = n * m * (m - 1)
            draws = proposals("margin", t_cap, n, m, "", 0.0)

            def accepted(lo, num, target):
                rows = decode_random(permuted(ks, span(lo, num), dom), m)
                u, i, j = rows.unbind(-1)
                ok = ((at(x, u, i) - at(x, u, j)).abs()
                      <= self.window(x, target))
                return rows, ok

            rows, ok = accepted(0, draws, t_cap if budget is None else budget)
            sample, count = self.kept(rows, ok, t, t_cap)
            extra = torch.zeros((r, e_cap, 3), dtype=torch.int64, device=dev)
            extra_count = full(0)
            if e_cap:
                more, ok2 = accepted(
                    draws, proposals("margin", e_cap, n, m, "", 0.0),
                    e_cap if e_budget is None else e_budget)
                extra, extra_count = self.kept(more, ok2, e, e_cap)
            return self.splits(sample, count, extra, extra_count, t_cap,
                               e_cap)
        rows, ok = self.propose(ks, x, sh, t_cap, budget)
        win = self.winners(rows, ok, (n, m))
        sample, count = self.kept(rows, win, t, t_cap)
        extra = torch.zeros((r, e_cap, 3), dtype=torch.int64, device=dev)
        extra_count = full(0)
        if e_cap:
            rank = torch.cumsum(win, dim=1) - 1
            ex_ok = win & (rank < t)
            more, ok2 = self.propose(st["extra_sampling"], x, sh, e_cap,
                                     e_budget)
            both = torch.cat([rows, more], dim=1)
            win2 = self.winners(both, torch.cat([ex_ok, ok2], dim=1), (n, m),
                                excluded=rows.shape[1])[:, rows.shape[1]:]
            extra, extra_count = self.kept(more, win2, e, e_cap)
        return self.splits(sample, count, extra, extra_count, t_cap, e_cap)
