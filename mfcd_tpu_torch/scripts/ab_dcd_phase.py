"""Time K2's launch shapes against each other, in alternated rounds.

    python3 -m mfcd_tpu_torch.scripts.ab_dcd_phase [--rounds 12] [--f 20]
        [--variant NAME:KEY=VALUE[,KEY=VALUE]] ...

Runs one AltSVM phase of each kind (items, then users) through
``altsvm_kernels._dcd_phase`` at MovieLens-100k's shape (943 users x 1,682
items, f = 20 unless ``--f``, T = 100,000 comparisons, 3 sweeps), on the
first epoch's inputs as ``train_altsvm`` makes them (zeroed written table
and duals; the user phase fed the item phase's V), over two comparison
sets labelled by a planted rank-20 model: items drawn uniformly, and
items drawn with probability proportional to 1 / rank (skewed).  Each ``--variant`` forces the
launch with ``_dcd_phase``'s keyword arguments (e.g. ``global:mode=global``);
the baseline ``default`` is ``dcd_phase``'s own choice.  By default the
variants are every table placement of ``altsvm_kernels.MODES`` that fits
both phases' tables.

Each variant's result must equal the baseline's, bit for bit.  Then
``--rounds`` rounds time every variant, the order reversed every other
round (so each variant and the baseline alternate); a reading is the
median CUDA-event time of 3 whole ``_dcd_phase`` calls (schedule, copies
and phase), the card idle before each.  Prints a line per phase and set
on stderr and, as its last line, one JSON object with each variant's
median, its ratio to the baseline's, the rounds it beat the baseline in,
every reading, and the card's name and power limit.  ``--device cpu
--t 200`` runs the plain version at a small size (no timing of the
kernel: a check of the script).  Exits non-zero without a card otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

N, M, T, SWEEPS = 943, 1682, 100_000, 3
RANK = 20
LAM, C = 0.1, 1.0
READS = 3


def comparisons(t: int, seed: int, skew: bool, device):
    """``t`` comparisons of a seeded planted factor model at N x M, rank
    RANK: (users, j, k) int32 and float32 labels, the sign of
    u . (v_j - v_k), a zero score labelled +1.  ``skew``: j and k drawn apart with
    probability proportional to 1 / rank (then j == k happens); else j
    uniform and k != j."""
    rng = np.random.default_rng(seed)
    u_true = rng.normal(size=(N, RANK))
    v_true = rng.normal(size=(M, RANK))
    users = rng.integers(0, N, t)
    if skew:
        p = 1.0 / np.arange(1, M + 1)
        mj, mk = (rng.choice(M, t, p=p / p.sum()) for _ in range(2))
    else:
        mj = rng.integers(0, M, t)
        mk = (mj + 1 + rng.integers(0, M - 1, t)) % M
    score = np.sum(u_true[users] * (v_true[mj] - v_true[mk]), axis=1)
    prefs = np.where(score < 0, -1.0, 1.0)
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return (as_t(users, torch.int32), as_t(mj, torch.int32),
            as_t(mk, torch.int32), as_t(prefs, torch.float32))


def parse_variant(text: str):
    """``NAME:KEY=VALUE,...`` -> (NAME, kwargs); values are Python
    literals where they parse as one (``True``, ``16``), else strings."""
    import ast

    name, _, spec = text.partition(":")
    kwargs = {}
    for item in filter(None, spec.split(",")):
        key, _, value = item.partition("=")
        try:
            kwargs[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            kwargs[key] = value
    return name, kwargs


def reading_ms(call, device) -> float:
    """Median time of ``READS`` calls, the card idle before each."""
    times = []
    for _ in range(READS):
        if device.type == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            call()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def compare(ak, args, variants, rounds: int, device) -> dict:
    """Bits against the baseline, then ``rounds`` alternated rounds."""
    calls = {name: (lambda kw=kw: ak._dcd_phase(*args, **kw))
             for name, kw in variants}
    names = list(calls)
    base = calls[names[0]]()
    for name in names[1:]:
        got = calls[name]()
        if not all(torch.equal(a, b) for a, b in zip(base, got)):
            raise SystemExit(f"ab_dcd_phase: {name} differs from "
                             f"{names[0]} in phase {args[0]}")
    readings = {name: [] for name in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            readings[name].append(reading_ms(calls[name], device))
    first = readings[names[0]]
    out = {}
    for name in names:
        ms = float(np.median(readings[name]))
        out[name] = dict(ms=ms, ratio=ms / float(np.median(first)),
                         beats_default=sum(a < b for a, b in
                                           zip(readings[name], first)),
                         readings=readings[name])
    return out


def main(argv=None) -> int:
    from mfcd_tpu_torch.core import prng
    from mfcd_tpu_torch.models import altsvm
    from mfcd_tpu_torch.ops import altsvm_kernels as ak

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variant", action="append", default=[])
    parser.add_argument("--rounds", type=int, default=12)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--t", type=int, default=T)
    parser.add_argument("--f", type=int, default=20)
    opts = parser.parse_args(argv)
    device = torch.device(opts.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("ab_dcd_phase: no CUDA device", file=sys.stderr)
        return 2
    variants = [("default", {})] + (
        [parse_variant(v) for v in opts.variant]
        or [(mode, {"mode": mode}) for mode in ak.MODES
            if ak.smem_bytes(mode, M, N, opts.f) <= ak.SMEM_BYTES
            and ak.smem_bytes(mode, N, M, opts.f) <= ak.SMEM_BYTES])
    card = "cpu"
    if device.type == "cuda":
        from mfcd_tpu_torch.backend import card_line
        card = card_line()
    t = opts.t
    state = altsvm.init_altsvm(prng.key(0), N, M, opts.f, t, device=device)
    k1, k2 = prng.split(prng.split(prng.key(1, device=device), 10)[0]
                        ).unbind(-2)
    dual0 = torch.zeros_like(state.alpha)
    cells = []
    for set_name, seed, skew in (("planted", 12, False),
                                 ("skewed", 13, True)):
        comps = comparisons(t, seed, skew, device)
        fixed = state.user_features
        for phase, key, table in (
                ("items", k1, torch.zeros_like(state.movie_features)),
                ("users", k2, torch.zeros_like(state.user_features))):
            picks = altsvm._picks(key, t, SWEEPS)
            args = (phase, table, fixed, dual0, picks, *comps, LAM, C)
            rows = compare(ak, args, variants, opts.rounds, device)
            depth = int(ak.dcd_levels(phase, picks.cpu(),
                                      *(a.cpu() for a in comps[:3])).max())
            cells.append(dict(set=set_name, phase=phase, chain_depth=depth,
                              variants=rows))
            print(f"{set_name} {phase} (chain depth {depth}): " + ", ".join(
                f"{name} {o['ms']:.4f} ms (x{o['ratio']:.4f}, faster in "
                f"{o['beats_default']} of {opts.rounds})"
                for name, o in rows.items()) + f"; {card}", file=sys.stderr)
            fixed = ak.dcd_phase(*args)[0]
    print(json.dumps({"shape": dict(n=N, m=M, f=opts.f, T=t, sweeps=SWEEPS),
                      "rounds": opts.rounds, "reads": READS,
                      "variants": dict(variants), "cells": cells,
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
