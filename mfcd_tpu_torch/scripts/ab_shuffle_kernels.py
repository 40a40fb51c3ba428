"""The shapes, forms and timing helpers of the checks of S1 (the keyed PRP
walks), S2 (the epoch shuffle) and T1 (threefry), and a probe of S1's
inverse walk.

    python3 -m mfcd_tpu_torch.scripts.ab_shuffle_kernels --probe

``SHUFFLE_CASES`` are the main path's shapes (``chip_smoke.py`` [14]'s);
:func:`prp_forms` gives S1's argument forms at one shape and
:func:`record_prp_calls` the calls the main path's configurations make;
:func:`queue_ms` times a call on the card (device ms with the card's
queue kept ahead of the host, and the host's issue ms), and
:func:`in_turns` two calls in turns.  ``--probe`` runs :func:`walk_probe`
at the canonical and sweep shapes: the inverse walk over ``prp_splits``'
own rows against rows whose every slot lands in one step.  Prints a line
per shape on stderr and, as its last line, one JSON object with every
median, every reading, the ratios and the card's name and power limit.
Exits non-zero without a card.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from mfcd_tpu_torch.core import prng
from mfcd_tpu_torch.ops import shuffle

# (label, R, S, count, k_bits, pack arrays), the main path's shapes, also
# chip_smoke.py [14]'s: the canonical run, the bench bucket, the bench's
# sweep chunk, hard K = 10 and 50, and scale_demo's n = m = 10,000 (pack
# "none").
SHUFFLE_CASES = (("canonical", 4, 131_072, 80_000, 17, 1),
                 ("bench bucket", 8, 131_072, 80_000, 17, 1),
                 ("sweep", 120, 131_072, 80_000, 17, 1),
                 ("hard K=10", 2, 1 << 20, 800_000, 20, 1),
                 ("hard K=50", 2, 1 << 22, 4_000_000, 22, 1),
                 ("scale", 1, 800_000, 800_000, 20, 4))
TILE, PERIOD = 64, 4
ROUNDS = 2
# S1's walk modes and the functions that take them.
PRP_FNS = {shuffle._CAPPED: "epoch_permutation",
           shuffle._EXACT: "exact_prefix_permutation",
           shuffle._INVERSE: "exact_prefix_permutation_inverse"}
# prp_indices' count at n = m = 1000: the random domain n m (m - 1), k = 30.
SPLIT_DOMAIN, SPLIT_BITS = 1000 * 1000 * 999, 30
# Cycles a second the spin kernel of ``queue_ms`` counts at most (the
# H100's top SM clock, 1.98 GHz, rounded up): its spin lasts at least
# cycles / SPIN_HZ seconds.
SPIN_HZ = 2.0e9


def queue_ms(fn, reps: int = 20, rounds: int = 5):
    """(device ms, host ms) of one call of ``fn``: medians over ``rounds``
    windows of ``reps`` back-to-back calls, after one warm-up call.  Each
    window is queued behind a spin kernel (``torch.cuda._sleep``) that
    outlasts the host's issue of all ``reps`` calls, so the card runs
    them back to back and the CUDA-event window holds their device time
    alone; the host's clock over the issue gives the host ms.  Raises if
    the card caught up with the host (a host sync in ``fn``) even behind
    a spin 64 times the host's issue time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    cycles = int(4 * SPIN_HZ * max(time.perf_counter() - t0, 1e-3))
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(rounds):
        for _ in range(4):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            issued = time.perf_counter() - t0
            ahead = not start.query()   # the card still spinning
            stop.record()
            stop.synchronize()
            if ahead:
                break
            cycles *= 4
        else:
            raise RuntimeError("queue_ms: the card caught up with the "
                               "host's issue")
        dev.append(start.elapsed_time(stop) / reps)
        host.append(1e3 * issued / reps)
    return float(np.median(dev)), float(np.median(host))


def in_turns(this, other, rounds: int = ROUNDS) -> dict:
    """``queue_ms`` of two calls in turns (this, other, other, this,
    ``rounds`` times): each side's median device and host ms, the
    readings and the ratios this / other."""
    read = {"this": [], "other": []}
    calls = {"this": this, "other": other}
    for side in ("this", "other", "other", "this") * rounds:
        read[side].append(queue_ms(calls[side]))
    out = {}
    for side, vals in read.items():
        out[f"{side}_ms"] = float(np.median([v[0] for v in vals]))
        out[f"{side}_host_ms"] = float(np.median([v[1] for v in vals]))
    out["ratio"] = out["this_ms"] / out["other_ms"]
    out["host_ratio"] = out["this_host_ms"] / out["other_host_ms"]
    out["readings"] = read
    return out


def _same(a, b) -> bool:
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32),
                                                   b.view(torch.int32)))


def case_inputs(r, s_len, count, arrays, device):
    """One shape's inputs: R keys, counts count - 13 i, ``arrays`` random
    int32 word arrays [R, S]."""
    g = torch.Generator(device=device).manual_seed(s_len + r)
    keys = prng.split(prng.key(r, device=device), r)
    counts = torch.clamp(torch.tensor([count - 13 * i for i in range(r)],
                                      dtype=torch.int32, device=device),
                         min=1)
    words = tuple(torch.randint(-2**31, 2**31 - 1, (r, s_len),
                                dtype=torch.int32, device=device,
                                generator=g) for _ in range(arrays))
    return keys, counts, words


def prp_forms(keys, counts, s_len, k_bits) -> dict:
    """S1's argument forms at one shape, {name: (mode, key, slots, count,
    k_bits)}: the three walks over one shared int64 row of the stream's
    slots (``arange``) with the runs' keys and int32 counts; and
    ``prp_splits``' two calls (``sampling/prp.py:303-306``): the inverse
    walk under one shared key [2] over a row of int32 slots a run (slot i
    of run r reads (i + 7 r) mod count inside the count, 0 past it: the
    split's rows and its padding) with the int32 counts, then the exact
    walk under each run's key over the inverse walk's int32 output, with
    the random domain's size at n = m = 1000 as an int count (k = 30)."""
    dev = keys.device
    slots = torch.arange(s_len, device=dev)
    forms = {name: (mode, keys, slots, counts, k_bits)
             for mode, name in ((shuffle._CAPPED, "capped"),
                                (shuffle._EXACT, "exact"),
                                (shuffle._INVERSE, "inverse"))}
    i = torch.arange(s_len, dtype=torch.int64, device=dev)
    c = counts.to(torch.int64).unsqueeze(-1)
    run = torch.arange(keys.shape[0], device=dev).unsqueeze(-1)
    y = torch.where(i < c, (i + 7 * run) % c, 0).to(torch.int32)
    forms["split inverse"] = (shuffle._INVERSE, keys[0], y, counts, k_bits)
    rank = shuffle.exact_prefix_permutation_inverse_reference(
        keys[0], y, counts, k_bits)
    forms["split exact"] = (shuffle._EXACT, keys, rank, SPLIT_DOMAIN,
                            SPLIT_BITS)
    return forms


def record_prp_calls(device, runs=None) -> dict:
    """S1's calls on the main path, {configuration: [(mode, key, slots,
    count, k_bits)]}, recorded by wrapping the wrapper while each
    configuration runs at one epoch (S1 runs in the sample stage alone,
    which the epoch count does not touch): the canonical ``parameter_scan``
    run (``run_config``, capacities padded as ``parameter_scan`` pads them),
    the bench's bucket (its two configurations through ``run_bucket``), the
    bench's ``--sweep`` (``parameter_scan_fast`` over its 40
    configurations), hard K = 10 and 50 (the bench's K buckets) and
    ``scale_demo``'s n = m = 10,000; or ``runs``, {label: a call}."""
    from mfcd_tpu_torch import bench
    from mfcd_tpu_torch.core.config import RunConfig
    from mfcd_tpu_torch.sweep import batched, engine

    one = lambda kw: RunConfig(**dict(kw, num_epochs=1))
    bucket = lambda cfg, k: batched.run_bucket(
        cfg, [{"s": cfg.s + i, "lr": cfg.lr,
               "weight_decay": cfg.weight_decay} for i in range(k)],
        list(range(k)), seed=bench.TIMED_SEED, device=device)
    runs = runs or {
        "canonical": lambda: engine.run_config(one(bench.CANONICAL),
                                               device=device),
        "bench bucket": lambda: bucket(one(bench.CANONICAL),
                                       bench.HEADLINE_CONFIGS),
        "sweep": lambda: batched.parameter_scan_fast(
            device=device, **dict(bench.SWEEP, num_epochs=1)),
        "hard K=10": lambda: bucket(one(dict(bench.KN, K=10)), 1),
        "hard K=50": lambda: bucket(one(dict(bench.KN, K=50)), 1),
        "scale": lambda: engine.run_config(one(dict(
            n=10_000, m=10_000, d=2, p=0.02, s=5.0, lr=1e-3,
            weight_decay=1e-5, reps=1)), device=device),
    }
    launch = shuffle._prp_launch
    out = {}
    for label, run in runs.items():
        calls = out[label] = []

        def recorded(who, key, slots, count, k_bits, mode):
            calls.append((mode, key, slots, count, k_bits))
            return launch(who, key, slots, count, k_bits, mode)

        shuffle._prp_launch = recorded
        try:
            run()
        finally:
            shuffle._prp_launch = launch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return out


def describe(mode, key, slots, count, k_bits) -> dict:
    """One S1 call's argument form, for the logs and the JSON."""
    cnt = (f"{str(count.dtype)[6:]} {list(count.shape)} stride "
           f"{list(count.stride())}" if isinstance(count, torch.Tensor)
           else f"int {count}")
    return dict(fn=PRP_FNS[mode], key=list(key.shape),
                key_stride=list(key.stride()), slots=list(slots.shape),
                slots_dtype=str(slots.dtype)[6:],
                slots_stride=list(slots.stride()), count=cnt, k_bits=k_bits)


def walk_steps(key, slots, count, k_bits, mode="capped") -> torch.Tensor:
    """The mixing steps each keyed walk of ``slots`` takes under ``key``
    and ``count`` (the first mix included), as the plain walk of ``mode``
    ("capped", "exact" or "inverse") applies them; int64, one per lane."""
    muls, adds = shuffle._derive_constants(key)
    step = (shuffle._unmix if mode == "inverse" else shuffle._mix)
    cnt = torch.as_tensor(count, dtype=torch.int64,
                          device=slots.device).unsqueeze(-1) & prng.M32
    x = slots.to(torch.int64) & prng.M32
    if mode != "capped":
        cnt = torch.clamp(cnt, min=1)
        x = torch.where(x < cnt, x, torch.zeros_like(x))
    x = step(x, muls, adds, k_bits)
    steps = torch.ones_like(x)
    it = 0
    while (mode != "capped" or it < 48) and bool((x >= cnt).any()):
        out = x >= cnt
        x = torch.where(out, step(x, muls, adds, k_bits), x)
        steps += out.to(torch.int64)
        it += 1
    return steps


def one_step_rows(key, counts, s_len, k_bits) -> torch.Tensor:
    """int32 [R, S]: row r cycles through the values v < counts[r] whose
    inverse walk under ``key`` lands in one step (unmix(v) < counts[r])."""
    c = counts.to(torch.int64).unsqueeze(-1)
    muls, adds = shuffle._derive_constants(key)
    v = torch.arange(s_len, device=counts.device).expand(c.shape[0], s_len)
    one = (v < c) & (shuffle._unmix(v, muls, adds, k_bits) < c)
    first = torch.argsort((~one).to(torch.int32), dim=-1, stable=True)
    at = torch.arange(s_len, device=counts.device) % one.sum(-1,
                                                             keepdim=True)
    return first.gather(-1, at).to(torch.int32)


def walk_probe(label, r, s_len, count, k_bits) -> dict:
    """What holds ``prp_splits``' inverse walk at one shape: this build's
    walk over the form's own rows against rows of the same shape and
    counts whose every slot lands in one step (values v < count with
    unmix(v) < count, cycled along the row), in turns: the same bytes and
    launch, the walk's length alone differs; with the mean steps a slot of
    each, and the mean over quads of 128 slots (a warp's 32 lanes) of
    their longest walk."""
    keys, counts, _ = case_inputs(r, s_len, count, 1, torch.device("cuda"))
    forms = prp_forms(keys, counts, s_len, k_bits)
    _, key, y, cnt, _ = forms["split inverse"]
    y1 = one_step_rows(key, cnt, s_len, k_bits)
    fn = shuffle.exact_prefix_permutation_inverse
    out = {}
    for name, rows in (("own", y), ("one step", y1)):
        steps = walk_steps(key, rows, cnt, k_bits, "inverse")
        if not _same(fn(key, rows, cnt, k_bits),
                     shuffle.exact_prefix_permutation_inverse_reference(
                         key, rows, cnt, k_bits)):
            raise SystemExit(f"ab_shuffle_kernels: S1 at {label}'s {name} "
                             f"rows differs from its plain version")
        out[f"{name} steps"] = float(steps.double().mean())
        out[f"{name} warp steps"] = float(
            steps.reshape(-1, 128).amax(-1).double().mean())
    out["tail"] = in_turns(lambda: fn(key, y, cnt, k_bits),
                           lambda: fn(key, y1, cnt, k_bits))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv != ["--probe"]:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_shuffle_kernels: no CUDA device", file=sys.stderr)
        return 2
    from mfcd_tpu_torch.backend import card_line

    card = card_line()
    probes = {}
    for label, r, s_len, count, k_bits, _ in SHUFFLE_CASES[:3:2]:
        p = probes[label] = walk_probe(label, r, s_len, count, k_bits)
        print(f"{label}: inverse walk, own rows "
              f"{p['tail']['this_ms']:.4f} against one-step rows "
              f"{p['tail']['other_ms']:.4f} ms (steps a slot "
              f"{p['own steps']:.3f} / {p['one step steps']:.3f}, a "
              f"warp's quads {p['own warp steps']:.3f} / "
              f"{p['one step warp steps']:.3f}); {card}", file=sys.stderr)
    print(json.dumps({"probes": probes, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
