"""The study's runs, from a seed and a configuration, in plain PyTorch.

A run generates the ground truth X* (``base``: Haar frames, X = U S V^T
scaled by sqrt(n m) / 2), samples triplets without replacement by a keyed
permutation of the ``random`` domain and splits them 80/10/10 by a second,
fixed one, labels them by Bernoulli BTL votes (K votes a triplet: each
its own row, or under soft labels one training row labelled by their
mean; validation and test keep every vote),
trains U V^T with dense, coupled-weight-decay Adam over shuffled batches
for its epochs (recording each epoch's train and validation loss), and
computes the 23 result keys.  The oracle run stops after the labelled
test split and scores X* itself on it.

This is the yardstick the measured program is compared with.  It follows
the study's published protocol and the key tree every run draws from; it
imports nothing of the program and works everything out again from the
seed.  Every product that a lower-precision build would be tempted to
take in TF32 goes through :func:`_p`, which rounds its operands to TF32
when the pipeline is built with ``tf32=True`` (the control a correct
program must be told apart from).  Training runs the steps of an epoch as
replays of a CUDA graph on the card, and eagerly on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench.reference import prng

TRAIN_RATIO, VAL_RATIO = 0.8, 0.1
MIN_TEST_POINTS = 500
SPLIT_SEED = 42
STREAMS = ("x_gen", "sampling", "extra_sampling", "labels_train",
           "labels_val", "labels_test", "init", "epochs", "sample_rows")
B1, B2, EPS = 0.9, 0.999, 1e-8
_EPS = 1e-8


def next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclass(frozen=True)
class Shape:
    """One configuration's sizes and settings, every study parameter but
    the per-run values (s, lr, weight decay): the configurations of one
    shape are worked out side by side."""

    n: int
    m: int
    d: int
    p: float
    K: int
    num_epochs: int
    batch_size: int
    reshuffle_period: int
    soft_label: bool = False
    strategy: str = "random"
    generation: str = "base"
    popularity_method: Optional[str] = None
    alpha: Optional[float] = None
    d1: Optional[int] = None

    @property
    def triplets(self) -> int:
        return int(self.n * self.m * self.p / 2)

    @property
    def extra_test(self) -> int:
        t = self.triplets
        test = t - int(TRAIN_RATIO * t) - int(VAL_RATIO * t)
        if test * self.K < MIN_TEST_POINTS:
            return max(0, -(-MIN_TEST_POINTS // self.K) - test)
        return 0


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits), to nearest even."""
    w = x.contiguous().view(torch.int32).to(torch.int64) & prng.M32
    w = (w + 0xFFF + ((w >> 13) & 1)) & 0xFFFFE000
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32).view(
        torch.float32).reshape(x.shape)


class Pipeline:
    """The study's computations at one precision: float32 (``tf32`` off)
    or with every product's operands rounded to TF32.

    A configuration's own reference (``reference/<config>.py``) subclasses
    it, computes what it adds, and widens :meth:`refuse` to let it
    through."""

    # The value of each setting this reference computes; a shape that asks
    # for another is refused, never worked out as this one.
    COMPUTES = {"strategy": "random", "generation": "base",
                "popularity_method": None, "alpha": None, "d1": None}

    def __init__(self, device, tf32: bool = False):
        self.device = torch.device(device)
        self.tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        torch.set_float32_matmul_precision("high" if tf32 else "highest")

    def _p(self, x: torch.Tensor) -> torch.Tensor:
        return tf32_round(x) if self.tf32 else x

    def refuse(self, sh: Shape) -> None:
        """Raise NotImplementedError, naming the setting and its value,
        where ``sh`` asks for what this reference does not compute."""
        for name, value in self.COMPUTES.items():
            got = getattr(sh, name)
            if got != value:
                raise NotImplementedError(
                    f"{type(self).__name__} computes {name}={value!r} only, "
                    f"not {name}={got!r}: the configuration needs a "
                    f"reference of its own (reference/<config>.py)")

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._p(a) @ self._p(b)

    # -- keys ---------------------------------------------------------------

    def rep_keys(self, seeds: Sequence[int], config_indices: Sequence[int],
                 reps: int) -> torch.Tensor:
        """``[len(config_indices) * reps, 2]`` run keys, config-major: the
        runs of configuration ``config_indices[c]`` of the call seeded
        ``seeds[c]``."""
        base = torch.stack([prng.key(sd, self.device) for sd in seeds])
        idx = torch.as_tensor(list(config_indices), dtype=torch.int64,
                              device=self.device)
        cfg = prng.fold_in(base, idx)
        reps_i = torch.arange(reps, dtype=torch.int64, device=self.device)
        return prng.fold_in(cfg[:, None, :], reps_i).reshape(-1, 2)

    @staticmethod
    def streams(keys: torch.Tensor) -> Dict[str, torch.Tensor]:
        ks = prng.split(keys, len(STREAMS))
        return {name: ks[..., i, :] for i, name in enumerate(STREAMS)}

    # -- ground truth -------------------------------------------------------

    def _haar(self, k, rows: int, d: int) -> torch.Tensor:
        q, r = torch.linalg.qr(prng.normal(k, (rows, d)))
        return q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[..., None, :]

    def generate_x(self, k, sh: Shape) -> torch.Tensor:
        ku, kv = prng.split(k).unbind(-2)
        u = self._haar(ku, sh.n, sh.d)
        v = self._haar(kv, sh.m, sh.d)
        f = lambda x: torch.tensor(x, dtype=torch.float32, device=k.device)
        scale = torch.sqrt(f(sh.n * sh.m)) / 2.0 / torch.sqrt(f(sh.d))
        return self._mm(u, v.transpose(-1, -2)) * scale

    # -- sampling and labels --------------------------------------------------

    def sample_splits(self, k, sh: Shape):
        """Triplet buffers ``[R, cap, 3]`` and counts of the train, val and
        test splits (the ``random`` domain, power-of-two capacities)."""
        dev = k.device
        r = k.shape[0]
        t_cap = next_pow2(sh.triplets)
        extra_cap = next_pow2(sh.extra_test) if sh.extra_test else 0
        train_cap = int(TRAIN_RATIO * t_cap)
        val_cap = int(VAL_RATIO * t_cap)
        test_cap = t_cap - train_cap - val_cap
        count = torch.full((r,), sh.triplets, dtype=torch.int32, device=dev)
        extra = torch.full((r,), sh.extra_test, dtype=torch.int32,
                           device=dev)
        cf = count.to(torch.float32)
        train_sz = torch.floor(TRAIN_RATIO * cf).to(torch.int32)
        val_sz = torch.floor(VAL_RATIO * cf).to(torch.int32)
        test_fit = torch.clamp(count - train_sz - val_sz, max=test_cap)
        col = lambda v: v.unsqueeze(-1)
        o = torch.arange(train_cap + val_cap + test_cap + extra_cap,
                         dtype=torch.int32, device=dev)
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
                    & (off - col(test_fit) < col(extra)))
        y = torch.where(is_data, base + off, 0)
        rank = prng.prefix_permutation_inverse(
            prng.key(SPLIT_SEED, dev), y, count, max((t_cap - 1).bit_length(),
                                                     1))
        slots = torch.where(is_extra, t_cap + (off - col(test_fit)), rank)
        dom = sh.n * sh.m * (sh.m - 1)
        idx = prng.prefix_permutation(k, slots, dom, (dom - 1).bit_length())
        per_u = sh.m * (sh.m - 1)
        u = idx // per_u
        pair = idx - u * per_u
        a = pair // (sh.m - 1)
        b = pair - a * (sh.m - 1)
        b = b + (b >= a).to(b.dtype)
        tri = torch.stack([u, a, b], dim=-1).to(torch.int32)
        tri = torch.where((is_data | is_extra).unsqueeze(-1), tri, 0)
        return ((tri[:, :train_cap], torch.clamp(train_sz, max=train_cap)),
                (tri[:, train_cap:train_cap + val_cap],
                 torch.clamp(val_sz, max=val_cap)),
                (tri[:, train_cap + val_cap:], test_fit + extra))

    def label(self, k, x, split, s, K: int, soft: bool = False
              ) -> Dict[str, torch.Tensor]:
        """K BTL votes a triplet, ``P(i over j) = sigmoid(s (X[u, i] -
        X[u, j]))``: each vote its own row, or with ``soft`` one row whose
        label is the number of votes for i over K."""
        tri, count = split
        r, t = tri.shape[:2]
        u, i, j = (a.to(torch.int64) for a in tri.unbind(-1))
        rows = torch.arange(r, device=x.device).unsqueeze(-1)
        diff = x[rows, u, i] - x[rows, u, j]
        prob = torch.sigmoid(s.unsqueeze(-1) * diff)
        votes = prng.uniform(k, (t, K)) < prob.unsqueeze(-1)
        valid = torch.arange(t, device=x.device) < count.unsqueeze(-1)
        if soft:
            z = torch.sum(votes.to(torch.float32), dim=-1) / float(K)
            return dict(u=u, i=i, j=j, z=z, valid=valid,
                        count=count.to(torch.int64))
        rep = lambda a: torch.repeat_interleave(a, K, dim=-1)
        return dict(u=rep(u), i=rep(i), j=rep(j),
                    z=votes.to(torch.float32).reshape(r, t * K),
                    valid=rep(valid), count=(count * K).to(torch.int64))

    @staticmethod
    def pad(split: Dict[str, torch.Tensor], rows: int):
        out = dict(split)
        pad = rows - split["u"].shape[-1]
        for key in ("u", "i", "j", "z", "valid"):
            out[key] = torch.nn.functional.pad(split[key], (0, pad))
        return out

    # -- model ------------------------------------------------------------------

    def init_params(self, k, sh: Shape):
        ku, kv = prng.split(k).unbind(-2)
        inv = 1.0 / torch.sqrt(torch.tensor(sh.d, dtype=torch.float32,
                                            device=k.device))
        return prng.normal(ku, (sh.n, sh.d)) * inv, prng.normal(
            kv, (sh.m, sh.d)) * inv

    def logits(self, U, V, u, i, j) -> torch.Tensor:
        r = U.shape[0]
        take = lambda t, idx: torch.gather(
            t, 1, idx.reshape(r, -1, 1).expand(-1, -1, t.shape[-1])
        ).reshape(idx.shape + (t.shape[-1],))
        eu = take(U, u)
        dv = take(V, i) - take(V, j)
        return torch.sum(self._p(eu) * self._p(dv), dim=-1)

    @staticmethod
    def bce(logits, z):
        return (torch.clamp(logits, min=0.0) - logits * z
                + torch.log1p(torch.exp(-torch.abs(logits))))

    @staticmethod
    def _batches(split, bs: int):
        rows = split["u"].shape[-1]
        nb = -(-rows // bs)
        pad = nb * bs - rows
        shape = split["u"].shape[:-1] + (nb, bs)
        return tuple(torch.nn.functional.pad(split[k], (0, pad)).reshape(shape)
                     for k in ("u", "i", "j", "z", "valid"))

    def split_loss(self, U, V, split, bs: int) -> torch.Tensor:
        """Mean over non-empty batches of the batch's masked mean BCE."""
        u, i, j, z, valid = self._batches(split, bs)
        losses = self.bce(self.logits(U, V, u, i, j), z)
        total = torch.sum(torch.where(valid, losses, 0.0), dim=-1)
        cnt = torch.sum(valid, dim=-1)
        mean = torch.where(cnt > 0, total / torch.clamp(cnt, min=1), 0.0)
        return torch.sum(mean, dim=-1) / torch.clamp(
            torch.sum(cnt > 0, dim=-1), min=1)

    # -- training -----------------------------------------------------------------

    def _source_map(self, k, epoch: int, count, s_len: int, k_bits: int,
                    period: int, tile_w: int) -> torch.Tensor:
        """The slot each slot of epoch ``epoch``'s shuffled stream reads:
        a fresh keyed permutation every ``period``-th epoch, otherwise a
        keyed permutation of the full tiles of ``tile_w`` rows followed by
        a keyed rotation of the valid prefix."""
        k_prp, k_rho, k_tile = prng.split(k, 3).unbind(-2)
        slots = torch.arange(s_len, dtype=torch.int64, device=k.device)
        if period == 1 or epoch % period == 0:
            return prng.capped_permutation(k_prp, slots, count, k_bits)
        rho = prng.bits(k_rho) % torch.clamp(count & prng.M32, min=1)
        t_bits = max(k_bits - tile_w.bit_length() + 1, 1)
        full = (count // tile_w).unsqueeze(-1)
        tiles = torch.arange(s_len // tile_w, dtype=torch.int64,
                             device=k.device)
        perm = prng.capped_permutation(k_tile, tiles,
                                       torch.clamp(full[..., 0], min=1),
                                       t_bits)
        src = torch.where(tiles < full, perm, tiles)
        p = src[..., slots // tile_w] * tile_w + slots % tile_w
        rho, c = rho.unsqueeze(-1), count.unsqueeze(-1)
        return torch.where(p < c - rho, p + rho, p + rho - c)

    @property
    def trainer(self):
        """The class that trains a call's runs."""
        return _Trainer

    def train(self, U, V, train, val, epochs_key, lr, wd, sh: Shape):
        """Dense coupled-weight-decay Adam over the shuffled training rows;
        returns (U, V, train losses [R, E], val losses [R, E])."""
        return self.trainer(self, U, V, train, val, epochs_key, lr, wd,
                            sh).run()

    # -- metrics --------------------------------------------------------------------

    @staticmethod
    def test_labels(sh: Shape) -> int:
        """Hard labels in one run's test split."""
        t = sh.triplets
        return (t - int(TRAIN_RATIO * t) - int(VAL_RATIO * t)
                + sh.extra_test) * sh.K

    def test_scores(self, U, V, test, bs: int):
        loss = self.split_loss(U, V, test, bs)
        u, i, j, z, valid = self._batches(test, bs)
        pred = (torch.sigmoid(self.logits(U, V, u, i, j)) > 0.5).to(
            torch.float32)
        hits = torch.sum(torch.where(valid, (pred == z).to(torch.float32),
                                     0.0), dim=-1)
        correct = torch.sum(hits, dim=-1)
        total = torch.sum(torch.sum(valid, dim=-1), dim=-1)
        return loss, torch.where(total > 0,
                                 correct / torch.clamp(total, min=1), 0.0)

    def ground_truth_scores(self, x, test, bs: int):
        """The oracle: MSE of sigmoid(X[u, i] - X[u, j]) (no scale) against
        the labels, mean of batch means, and the share of labels the sign
        of the difference predicts."""
        u, i, j, z, valid = self._batches(test, bs)
        rows = torch.arange(x.shape[0], device=x.device).reshape(-1, 1, 1)
        diff = x[rows, u, i] - x[rows, u, j]
        sq = (torch.sigmoid(diff) - z) ** 2
        total = torch.sum(torch.where(valid, sq, 0.0), dim=-1)
        cnt = torch.sum(valid, dim=-1)
        mean = torch.where(cnt > 0, total / torch.clamp(cnt, min=1), 0.0)
        loss = torch.sum(mean, dim=-1) / torch.clamp(
            torch.sum(cnt > 0, dim=-1), min=1)
        hit = torch.where(valid, ((diff > 0).to(torch.float32) == z).to(
            torch.float32), 0.0)
        correct = torch.sum(hit, dim=(-2, -1))
        n = torch.sum(valid, dim=(-2, -1))
        return loss, torch.where(n > 0, correct / torch.clamp(n, min=1), 0.0)

    @staticmethod
    def _fro(a):
        return torch.sqrt(torch.sum(a * a, dim=(-2, -1)))

    @staticmethod
    def _pearson(a, b):
        num = torch.sum(a * b, dim=-1)
        den = torch.sqrt(torch.sum(a ** 2, dim=-1) * torch.sum(b ** 2, dim=-1))
        return num / torch.clamp(den, min=1e-30)

    @staticmethod
    def _ranks(a):
        order = torch.argsort(a, dim=-1, stable=True)
        iota = torch.arange(a.shape[-1], device=a.device).expand(a.shape)
        return torch.empty_like(order).scatter_(-1, order, iota).to(a.dtype)

    @staticmethod
    def _masked_mean_std(vals, mask):
        cnt = torch.sum(mask, dim=-1)
        safe = torch.clamp(cnt, min=1)
        mean = torch.where(cnt > 0, torch.sum(torch.where(mask, vals, 0.0),
                                              dim=-1) / safe, 0.0)
        dev2 = torch.where(mask, (vals - mean.unsqueeze(-1)) ** 2, 0.0)
        var = torch.where(cnt > 0, torch.sum(dev2, dim=-1) / safe, 0.0)
        return mean, torch.sqrt(var)

    def _top_singular_values(self, x, q: int, k, iters: int = 4):
        y = self._mm(x, prng.normal(k, (x.shape[-1], q)))
        xt = x.transpose(-1, -2)
        for _ in range(iters):
            y = torch.linalg.qr(y).Q
            y = self._mm(x, self._mm(xt, y))
        qm = torch.linalg.qr(y).Q
        return torch.linalg.svdvals(self._mm(qm.transpose(-1, -2), x))

    def metrics(self, U, V, x, s, test, rows_key, bs: int) -> Dict:
        """The 23 result keys' values, per run, with the masks that drop
        the rows the study skips."""
        out = {}
        test_loss, out["accuracy"] = self.test_scores(U, V, test, bs)
        gt_loss, out["gt_accuracy"] = self.ground_truth_scores(x, test, bs)
        out["log_likelihoods"] = -test_loss
        out["gt_log_likelihoods"] = -gt_loss
        uvt = self._mm(U, V.transpose(-1, -2))
        col = uvt - torch.mean(uvt, dim=-2, keepdim=True)
        target = s.reshape(-1, 1, 1) * x
        out["reconstruction_errors"] = (self._fro(col - target)
                                        / self._fro(target))
        k_rows, k_spec = prng.split(rows_key).unbind(-2)

        rc = uvt - torch.mean(uvt, dim=-1, keepdim=True)
        xc = x - torch.mean(x, dim=-1, keepdim=True)
        dot = torch.sum(rc * xc, dim=(-2, -1))
        norm_u, norm_x = self._fro(rc), self._fro(xc)
        alpha = dot / (norm_u ** 2 + _EPS)
        out.update(alpha=alpha, norm_X=norm_x, norm_ratio=norm_u / (norm_x
                                                                    + _EPS))
        out["reconstruction_error_scaled"] = self._fro(
            alpha[:, None, None] * rc - xc) / (norm_x + _EPS)
        std_x = torch.std(xc, dim=-1, correction=0)
        std_u = torch.std(rc, dim=-1, correction=0)
        mask = (std_x > _EPS) & (std_u > _EPS)
        pearson = self._pearson(xc, rc)
        out["pearson_corr"], out["pearson_std"] = self._masked_mean_std(
            pearson, mask)
        rx, ru = self._ranks(xc), self._ranks(rc)
        spearman = self._pearson(rx - torch.mean(rx, dim=-1, keepdim=True),
                                 ru - torch.mean(ru, dim=-1, keepdim=True))
        out["spearman_corr"], out["spearman_std"] = self._masked_mean_std(
            spearman, mask)
        vc = V - torch.mean(V, dim=-2, keepdim=True)
        s2 = torch.linalg.svdvals(self._mm(torch.linalg.qr(U).R,
                                           torch.linalg.qr(vc).R.transpose(
                                               -1, -2)))
        dr = s2.shape[-1]
        s1 = self._top_singular_values(xc, min(dr + 10, min(x.shape[-2:])),
                                       k_spec)[..., :dr]
        fro2 = torch.sum(xc * xc, dim=(-2, -1))
        head = torch.sum((alpha[:, None] * s2 - s1) ** 2, dim=-1)
        tail = torch.clamp(fro2 - torch.sum(s1 ** 2, dim=-1), min=0.0)
        out["svd_error_scaled"] = torch.sqrt(head + tail) / (
            torch.sqrt(fro2) + _EPS)
        xx = torch.sum(xc * xc, dim=-1)
        xu = torch.sum(xc * rc, dim=-1)
        uu = torch.sum(rc * rc, dim=-1)
        out["slopes"] = xu / torch.clamp(xx, min=1e-30)
        out["alpha_per_row"] = torch.where(
            uu > _EPS, xu / torch.clamp(uu, min=1e-30), 0.0)
        out["reconstruction_error_scaled_per_row"] = self._fro(
            out["alpha_per_row"].unsqueeze(-1) * rc - xc) / (norm_x + _EPS)
        out["pearson_corr_matrix"], out["spearman_corr_matrix"] = (pearson,
                                                                   spearman)
        masks = {"slopes": (xx > _EPS) & (std_u > _EPS),
                 "pearson_corr_matrix": mask, "spearman_corr_matrix": mask}

        kr0, kr1 = prng.split(k_rows).unbind(-2)
        r0 = prng.randint(kr0, 0, x.shape[-2])
        r1 = prng.randint(kr1, 0, x.shape[-2] - 1)
        pick = torch.stack([r0, r1 + (r1 >= r0).to(r1.dtype)], dim=-1)
        runs = torch.arange(x.shape[0], device=x.device).unsqueeze(-1)
        out["sampled_X_rows"] = x[runs, pick]
        out["sampled_UVT_rows"] = uvt[runs, pick]
        return out, masks

    # -- whole calls ------------------------------------------------------------

    def study_runs(self, seeds: Sequence[int], config_indices: Sequence[int],
                   s: Sequence[float], lr: Sequence[float],
                   wd: Sequence[float], reps: int, sh: Shape) -> List[Dict]:
        """The runs of configurations of one shape, trained side by side:
        configuration c is ``config_indices[c]`` of the call seeded
        ``seeds[c]``, with ``reps`` repetitions; one result dict a
        configuration, whose values carry the repetition axis (masked row
        keys as lists)."""
        self.refuse(sh)
        keys = self.rep_keys(seeds, config_indices, reps)
        st = self.streams(keys)
        runs = lambda v: torch.as_tensor(np.asarray(v, np.float32),
                                         device=self.device
                                         ).repeat_interleave(reps)
        s_r, lr_r, wd_r = runs(s), runs(lr), runs(wd)
        x = self.generate_x(st["x_gen"], sh)
        tr, va, te = self.sample_splits(st["sampling"], sh)
        U, V = self.init_params(st["init"], sh)
        labelled = [self.label(st[name], x, split, s_r, sh.K,
                               soft=sh.soft_label and name == "labels_train")
                    for name, split in (("labels_train", tr),
                                        ("labels_val", va),
                                        ("labels_test", te))]
        train, val, test = (self.pad(a, next_pow2(a["u"].shape[-1]))
                            for a in labelled)
        U, V, tl, vl = self.train(U, V, train, val, st["epochs"], lr_r, wd_r,
                                  sh)
        out, masks = self.metrics(U, V, x, s_r, test, st["sample_rows"],
                                  sh.batch_size)
        out["train_losses"], out["val_losses"] = tl, vl
        host = {k: v.detach().cpu().numpy() for k, v in out.items()}
        kept = {k: v.detach().cpu().numpy() for k, v in masks.items()}
        results = []
        for c in range(len(config_indices)):
            sl = slice(c * reps, (c + 1) * reps)
            res = {k: v[sl] for k, v in host.items()}
            for k, mk in kept.items():
                res[k] = [row[m] for row, m in zip(host[k][sl], mk[sl])]
            results.append(res)
        return results

    def oracle_runs(self, seeds: Sequence[int],
                    config_indices: Sequence[int], s: Sequence[float],
                    reps: int, sh: Shape):
        """The ground-truth oracle's (loss, accuracy), each ``[C, reps]``,
        of configurations of one shape (as :meth:`study_runs` names them)."""
        self.refuse(sh)
        keys = self.rep_keys(seeds, config_indices, reps)
        st = self.streams(keys)
        x = self.generate_x(st["x_gen"], sh)
        _, _, te = self.sample_splits(st["sampling"], sh)
        s_r = torch.as_tensor(np.asarray(s, np.float32),
                              device=self.device).repeat_interleave(reps)
        test = self.label(st["labels_test"], x, te, s_r, sh.K)
        loss, acc = self.ground_truth_scores(x, test, sh.batch_size)
        return (loss.cpu().numpy().reshape(-1, reps),
                acc.cpu().numpy().reshape(-1, reps))


class _Trainer:
    """One call's training: the state of every run as one table of U's
    rows then V's, its Adam moments beside it; per epoch the shuffled
    stream becomes flat row indices and (label, weight) pairs, and the
    steps run in order, as CUDA graph replays on the card."""

    GRAPH_STEPS = 50

    def __init__(self, pipe: Pipeline, U, V, train, val, epochs_key, lr, wd,
                 sh: Shape):
        self.pipe, self.sh, self.val = pipe, sh, val
        dev = U.device
        self.r, self.n, self.m, self.d = U.shape[0], sh.n, sh.m, sh.d
        self.rows = self.n + self.m
        self.P = torch.cat([U, V], dim=1).contiguous()
        self.M1 = torch.zeros_like(self.P)
        self.M2 = torch.zeros_like(self.P)
        self.grad = torch.zeros_like(self.P)
        bs = sh.batch_size
        self.stream = tuple(train[k] for k in ("u", "i", "j", "z"))
        self.s_len = self.stream[0].shape[-1]
        self.count = train["count"].to(torch.int64)
        self.k_bits = max(self.s_len - 1, 1).bit_length()
        w = 1
        while bs % (w * 2) == 0 and w < 128:
            w *= 2
        self.tile_w = w if w >= 8 else None
        self.period = sh.reshuffle_period if self.tile_w else 1
        self.nb = -(-self.count // bs)                      # [R]
        self.steps = int(self.nb.max())
        self.even = bool((self.nb == self.steps).all())
        self.epoch_keys = prng.split(epochs_key, sh.num_epochs)
        col = lambda v: v.reshape(-1, 1, 1).to(torch.float32)
        self.lr, self.wd = col(lr), col(wd)
        f32 = lambda v: float(torch.tensor(v, dtype=torch.float32))
        self.b1, self.omb1 = f32(B1), f32(1.0 - B1)
        self.b2, self.omb2 = f32(B2), f32(1.0 - B2)
        log_b1 = float(torch.log(torch.tensor(B1, dtype=torch.float32)))
        log_b2 = float(torch.log(torch.tensor(B2, dtype=torch.float32)))
        # Adam's bias corrections at every (epoch, step) of every run.
        e = torch.arange(sh.num_epochs, device=dev, dtype=torch.float32)
        t = torch.arange(1, self.steps + 1, device=dev, dtype=torch.float32)
        t_step = (e[None, :, None] * self.nb.to(torch.float32)[:, None, None]
                  + t[None, None, :])                        # [R, E, S]
        self.bc = torch.stack([1.0 - torch.exp(t_step * log_b1),
                               1.0 - torch.exp(t_step * log_b2)],
                              dim=-1).reshape(self.r, -1, 2)
        steps_total = sh.num_epochs * self.steps
        self.active = (torch.arange(self.steps, device=dev)[None, :]
                       < self.nb[:, None]).to(torch.float32)
        # The epoch's batches, written in place before its steps run.
        self.idx = torch.zeros((self.r, self.steps, 3 * bs),
                               dtype=torch.int64, device=dev)
        self.zw = torch.zeros((self.r, self.steps, 2, bs), device=dev)
        self.logit_log = torch.zeros((self.r, self.steps, bs), device=dev)
        self.e_step = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.g_step = torch.zeros((1,), dtype=torch.int64, device=dev)
        assert steps_total > 0
        self.graph = None

    # One Adam step of every run, reading the batch at self.e_step.
    def _step(self):
        p, r, bs, d = self.pipe._p, self.r, self.sh.batch_size, self.d
        pf = self.P.view(-1, d)
        b = self.idx.index_select(1, self.e_step).view(-1)
        rows = pf.index_select(0, b).view(r, 3 * bs, d)
        eu = rows[:, :bs]
        vij = rows[:, bs:].view(r, bs, 2, d)
        dv = vij[:, :, 0] - vij[:, :, 1]
        logits = torch.sum(p(eu) * p(dv), dim=-1)
        self.logit_log.index_copy_(1, self.e_step, logits.unsqueeze(1))
        zw = self.zw.index_select(1, self.e_step).squeeze(1)
        g = (torch.sigmoid(logits) - zw[:, 0]) * zw[:, 1]
        # U's entries in batch order, then V's as i_0, j_0, i_1, j_1, ...
        g = p(g).unsqueeze(-1)
        cv = g * p(eu)
        contrib = torch.cat([g * p(dv), torch.stack([cv, -cv], dim=2).view(
            r, 2 * bs, d)], dim=1)
        self.grad.zero_()
        self.grad.view(-1, d).index_add_(0, b, contrib.reshape(-1, d))
        bc = self.bc.index_select(1, self.g_step).view(r, 1, 1, 2)
        grad = self.grad.add_(self.wd * self.P)
        m1 = self.M1 * self.b1 + self.omb1 * grad
        m2 = self.M2 * self.b2 + self.omb2 * grad * grad
        upd = self.lr * (m1 / bc[..., 0]) / (torch.sqrt(m2 / bc[..., 1])
                                             + EPS)
        if self.even:
            self.P.sub_(upd)
            self.M1.copy_(m1)
            self.M2.copy_(m2)
        else:
            act = self.active.index_select(1, self.e_step).view(r, 1, 1) > 0
            self.P.copy_(torch.where(act, self.P - upd, self.P))
            self.M1.copy_(torch.where(act, m1, self.M1))
            self.M2.copy_(torch.where(act, m2, self.M2))
        self.e_step.add_(1)
        self.g_step.add_(1)

    def _capture(self, steps: int):
        saved = [t.clone() for t in (self.P, self.M1, self.M2, self.e_step,
                                     self.g_step)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                self._step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(steps):
                self._step()
        for t, s in zip((self.P, self.M1, self.M2, self.e_step, self.g_step),
                        saved):
            t.copy_(s)
        return graph

    def _load_epoch(self, epoch: int):
        src = self.pipe._source_map(self.epoch_keys[:, epoch], epoch,
                                    self.count, self.s_len, self.k_bits,
                                    self.period, self.tile_w or 1)
        self.stream = tuple(torch.gather(a, -1, src) for a in self.stream)
        bs, r, n = self.sh.batch_size, self.r, self.n
        used = self.steps * bs
        u, i, j, z = (a[:, :used].reshape(r, self.steps, bs)
                      for a in self.stream)
        off = (torch.arange(r, device=u.device) * self.rows).reshape(r, 1, 1)
        ij = torch.stack([i, j], dim=-1).reshape(r, self.steps, 2 * bs)
        self.idx.copy_(torch.cat([u + off, ij + n + off], dim=-1))
        slot = torch.arange(used, device=u.device).reshape(self.steps, bs)
        mask = (slot[None] < self.count.reshape(r, 1, 1)).to(torch.float32)
        inv = 1.0 / torch.clamp(torch.sum(mask, dim=-1), min=1.0)
        self.zw.copy_(torch.stack([z, mask * inv.unsqueeze(-1)], dim=2))
        return z, mask, inv

    def run(self):
        cuda = self.P.device.type == "cuda"
        tl, vl = [], []
        chunk = max(c for c in range(1, self.GRAPH_STEPS + 1)
                    if self.steps % c == 0)
        for epoch in range(self.sh.num_epochs):
            z, mask, inv = self._load_epoch(epoch)
            self.e_step.zero_()
            if cuda and chunk > 1:
                if self.graph is None:
                    self.graph = self._capture(chunk)
                for _ in range(self.steps // chunk):
                    self.graph.replay()
            else:
                for _ in range(self.steps):
                    self._step()
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
