"""Time S1 (the keyed PRP walks), S2 (the epoch shuffle) and T1
(threefry) built from this checkout against another build of them, in
turns.

    python3 -m mfcd_tpu_torch.scripts.ab_shuffle_kernels [DIR] [--main-path]
    python3 -m mfcd_tpu_torch.scripts.ab_shuffle_kernels [DIR] --probe

DIR holds the other ``shuffle_kernel.cu``, ``prng_kernel.cu`` and the
``threefry.cuh`` they include, with the one-slot-a-thread C interface
(``mfcd_prp`` taking int64 keys, counts and slots, ``mfcd_mix_stream``
taking pointer arrays, ``mfcd_threefry_hash`` and ``mfcd_threefry_bits``);
the default, ``scripts/ab_baseline/``, is that design, kept for this
comparison.  Both are built with the port's nvcc flags, and the other
build is called through that design's own wrappers (:class:`Baseline`),
host work included.

At each shape of ``SHUFFLE_CASES`` (also ``chip_smoke.py`` [14]'s):
S2 over a fresh and a cheap epoch (this build as the trainer calls it, the
epoch's keys folded before the loop; the other from the epochs keys, as it
took them), T1's ``bits`` over [R, S], ``fold_in`` of R keys by an
integer (the key tree's form) and ``split`` of R keys into 9 (a run's
streams), and S1 at its forms (:func:`prp_forms`: the three walks over one
shared row of slots, and ``prp_splits``' two calls).  Each pair is checked
bit-equal, then timed by :func:`queue_ms` (device ms a call, the card's
queue kept ahead of the host, and the host's issue ms a call) in turns:
this, other, other, this, twice; the median of each side's four.
With ``--main-path``, S1 also at the calls the main path's configurations
make (:func:`record_prp_calls`), against the other build.  With
``--probe``, only :func:`walk_probe` at the canonical and sweep shapes:
the inverse walk's tail, and each kernel alone over the same int64 rows.
Prints a line per shape on stderr and, as its last line, one JSON object
with every median, every reading, the ratios (this / other) and the
card's name and power limit.  Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import sys
import time

import numpy as np
import torch

from mfcd_tpu_torch.core import prng
from mfcd_tpu_torch.ops import _build, shuffle

BASELINE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "ab_baseline")
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


class Baseline:
    """S1, S2 and T1 of the one-slot-a-thread design, built from
    ``src_dir`` and called as that design's wrappers called them: S1 over
    contiguous int64 keys, counts and slots (a copy, a fill or a cast each
    where the caller's differ); S2 from the epochs keys with ctypes pointer
    arrays; T1's fold_in as a fill, a zeros_like and a hash launch over
    broadcast int64 words; split and bits through the counter entry."""

    def __init__(self, src_dir: str = BASELINE_DIR):
        jobs = [_build._start(os.path.join(src_dir, name), force=True)
                for name in ("shuffle_kernel.cu", "prng_kernel.cu")]
        s2, t1 = (ctypes.CDLL(_build._finish(job)) for job in jobs)
        s2.mfcd_mix_stream.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_longlong] * 3
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        s2.mfcd_prp.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
            + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
            + [ctypes.c_void_p])
        t1.mfcd_threefry_hash.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p])
        t1.mfcd_threefry_bits.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_longlong] * 4
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        for lib, fns in ((s2, ("mfcd_mix_stream", "mfcd_prp")),
                         (t1, ("mfcd_threefry_hash", "mfcd_threefry_bits"))):
            for fn in fns:
                getattr(lib, fn).restype = ctypes.c_int
            lib.mfcd_cuda_error_string.argtypes = [ctypes.c_int]
            lib.mfcd_cuda_error_string.restype = ctypes.c_char_p
        self.s2, self.t1 = s2, t1

    def mix_stream(self, arrays, keys, epoch, count, k_bits, period,
                   tile_w):
        dev = arrays[0].device
        rows, s_len = arrays[0].numel() // arrays[0].shape[-1], \
            arrays[0].shape[-1]
        count = count.to(torch.int32).reshape(-1).contiguous()
        keys = keys.to(torch.int64).reshape(-1, 2).contiguous()
        outs = tuple(torch.empty_like(a) for a in arrays)
        ins = (ctypes.c_void_p * 4)(*(a.data_ptr() for a in arrays))
        dst = (ctypes.c_void_p * 4)(*(o.data_ptr() for o in outs))
        err = self.s2.mfcd_mix_stream(
            keys.data_ptr(), count.data_ptr(), ins, dst, len(arrays), rows,
            s_len, epoch, period, k_bits, tile_w or 0,
            torch.cuda.current_stream(dev).cuda_stream)
        _build.raise_on(self.s2, err, "baseline mix_stream")
        return outs

    def prp(self, key, slots, count, k_bits, mode):
        dev = slots.device
        if isinstance(count, torch.Tensor):
            lead = shuffle._lead(key.shape[:-1], slots.shape[:-1],
                                 count.shape)
            cnt = count.to(torch.int64).expand(lead)
        else:
            lead = shuffle._lead(key.shape[:-1], slots.shape[:-1])
            cnt = torch.full(lead, int(count), dtype=torch.int64, device=dev)
        n = slots.shape[-1]
        keys = key.to(torch.int64).expand(lead + (2,)).reshape(
            -1, 2).contiguous()
        cnt = cnt.reshape(-1).contiguous()
        flat = slots.to(torch.int64)
        if slots.shape[:-1].numel() == 1:
            flat, slot_row = flat.reshape(n).contiguous(), 0
        else:
            flat = flat.expand(lead + (n,)).reshape(-1, n).contiguous()
            slot_row = n
        out = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
        err = self.s2.mfcd_prp(keys.data_ptr(), cnt.data_ptr(),
                               flat.data_ptr(), slot_row, out.data_ptr(),
                               keys.shape[0], n, mode, k_bits,
                               torch.cuda.current_stream(dev).cuda_stream)
        _build.raise_on(self.s2, err, "baseline prp")
        return out

    def _hash(self, words, pairs):
        dev = words[0].device
        words = torch.broadcast_tensors(*(w.to(torch.int64) for w in words))
        shape = tuple(words[0].shape)
        out = torch.empty(shape + ((2,) if pairs else ()), dtype=torch.int64,
                          device=dev)
        nd = len(shape)
        c_shape = (ctypes.c_longlong * max(nd, 1))(*shape)
        c_strides = (ctypes.c_longlong * max(4 * nd, 1))(
            *(s for w in words for s in w.stride()))
        err = self.t1.mfcd_threefry_hash(
            *(w.data_ptr() for w in words), c_shape, c_strides, nd,
            math.prod(shape), out.data_ptr(), int(pairs),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.raise_on(self.t1, err, "baseline threefry hash")
        return out

    def _counter(self, k, n, pairs):
        lead = tuple(k.shape[:-1])
        kf = k.to(torch.int64).reshape(-1, 2)
        out = torch.empty(lead + (n,) + ((2,) if pairs else ()),
                          dtype=torch.int64, device=k.device)
        err = self.t1.mfcd_threefry_bits(
            kf.data_ptr(), kf.stride(0), kf.stride(1), kf.shape[0], n,
            out.data_ptr(), int(pairs),
            torch.cuda.current_stream(k.device).cuda_stream)
        _build.raise_on(self.t1, err, "baseline threefry bits")
        return out

    def fold_in(self, k, data):
        d = prng._u32(data, k.device)
        return self._hash((k[..., 0], k[..., 1], torch.zeros_like(d), d),
                          pairs=True)

    def split(self, k, num):
        return self._counter(k, num, pairs=True)

    def bits(self, k, shape):
        return self._counter(k, math.prod(shape), pairs=False).reshape(
            k.shape[:-1] + tuple(shape))


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


def case_calls(other: Baseline, keys, counts, words, k_bits):
    """{name: (this call, other call)} at one shape, each pair checked
    bit-equal: S2 fresh and cheap, T1 bits, fold_in and split."""
    s_len = words[0].shape[-1]
    epoch_keys = prng.split(keys, 2)
    calls = {}
    for epoch, kind in ((0, "S2 fresh"), (1, "S2 cheap")):
        ek = epoch_keys[:, epoch]
        calls[kind] = (
            lambda ek=ek, epoch=epoch: shuffle.mix_stream(
                words, ek, epoch, counts, k_bits, period=PERIOD, tile_w=TILE,
                folded=True),
            lambda epoch=epoch: other.mix_stream(
                words, keys, epoch, counts, k_bits, PERIOD, TILE))
    calls["T1 bits"] = (lambda: prng.bits(keys, (s_len,)),
                        lambda: other.bits(keys, (s_len,)))
    calls["T1 fold_in"] = (lambda: prng.fold_in(keys, 7),
                           lambda: other.fold_in(keys, 7))
    calls["T1 split"] = (lambda: prng.split(keys, 9),
                         lambda: other.split(keys, 9))
    for name, (this, base) in calls.items():
        a, b = this(), base()
        torch.cuda.synchronize()
        pairs = zip(a, b) if isinstance(a, tuple) else ((a, b),)
        if not all(_same(x, y) for x, y in pairs):
            raise SystemExit(f"ab_shuffle_kernels: {name} at R="
                             f"{keys.shape[0]}, S={s_len}: the two builds "
                             f"differ")
    return calls


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


def prp_calls(other: Baseline, mode, key, slots, count, k_bits):
    """(this build's call, the other's, the plain version's) of one S1
    form."""
    name = PRP_FNS[mode]
    return (lambda: getattr(shuffle, name)(key, slots, count, k_bits),
            lambda: other.prp(key, slots, count, k_bits, mode),
            lambda: getattr(shuffle, name + "_reference")(key, slots, count,
                                                          k_bits))


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


def prp_row(other: Baseline, form) -> dict:
    """One S1 form checked bit-equal across the builds and the plain
    version, then in turns against the other build."""
    this, base, plain = prp_calls(other, *form)
    if not (_same(this(), plain()) and _same(base(), plain())):
        raise SystemExit(f"ab_shuffle_kernels: S1 at {describe(*form)}: "
                         f"a build differs from the plain version")
    return dict(describe(*form), **in_turns(this, base))


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


def walk_probe(other: Baseline, label, r, s_len, count, k_bits) -> dict:
    """What holds ``prp_splits``' walks at one shape, each pair in turns:
    - ``tail``: this build's inverse walk over the form's own rows against
      rows of the same shape and counts whose every slot lands in one step
      (values v < count with unmix(v) < count, cycled along the row): the
      same bytes and launch, the walk's length alone differs; with the
      mean steps a slot of each, and the mean over quads of 128 slots (a
      warp's 32 lanes) of their longest walk;
    - ``body``, for each form: this build against the other over the same
      int64 keys [R, 2], slots and counts, made before the window, so the
      other's casts and copies are no-ops and the two differ in the
      kernel alone."""
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
    out["body"] = {}
    for name in ("split inverse", "split exact"):
        mode, key, slots, count_, k = forms[name]
        args = (key.to(torch.int64).expand(r, 2).contiguous(),
                slots.to(torch.int64).contiguous(),
                torch.as_tensor(count_, device=slots.device).to(
                    torch.int64).expand(r).contiguous(), k)
        out["body"][name] = prp_row(other, (mode,) + args)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dirs = [a for a in argv if not a.startswith("--")]
    flags = set(argv) - set(dirs)
    if len(dirs) > 1 or not flags <= {"--main-path", "--probe"}:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_shuffle_kernels: no CUDA device", file=sys.stderr)
        return 2
    from mfcd_tpu_torch.backend import card_line

    device = torch.device("cuda")
    other = Baseline(dirs[0] if dirs else BASELINE_DIR)
    card = card_line()
    if "--probe" in flags:
        probes = {}
        for label, r, s_len, count, k_bits, _ in SHUFFLE_CASES[:3:2]:
            p = probes[label] = walk_probe(other, label, r, s_len, count,
                                           k_bits)
            body = "; ".join(f"{k} {v['this_ms']:.4f} / {v['other_ms']:.4f}"
                             for k, v in p["body"].items())
            print(f"{label}: inverse walk, own rows "
                  f"{p['tail']['this_ms']:.4f} against one-step rows "
                  f"{p['tail']['other_ms']:.4f} ms (steps a slot "
                  f"{p['own steps']:.3f} / {p['one step steps']:.3f}, a "
                  f"warp's quads {p['own warp steps']:.3f} / "
                  f"{p['one step warp steps']:.3f}); kernel alone over "
                  f"int64 rows, this / other: {body}; {card}",
                  file=sys.stderr)
        print(json.dumps({"probes": probes, "card": card}), flush=True)
        return 0
    rows = []
    for label, r, s_len, count, k_bits, arrays in SHUFFLE_CASES:
        keys, counts, words = case_inputs(r, s_len, count, arrays, device)
        calls = case_calls(other, keys, counts, words, k_bits)
        row = dict(label=label, r=r, s=s_len, count=count, k_bits=k_bits,
                   arrays=arrays)
        for name, (this, base) in calls.items():
            row[name] = in_turns(this, base)
        for name, form in prp_forms(keys, counts, s_len, k_bits).items():
            row[f"S1 {name}"] = prp_row(other, form)
        rows.append(row)
        print(f"{label} (R={r}, S={s_len}): bit-equal; device ms this / "
              f"other (host issue ms): " + "; ".join(
                  f"{k} {v['this_ms']:.4f} / {v['other_ms']:.4f} "
                  f"({v['this_host_ms']:.4f} / {v['other_host_ms']:.4f})"
                  for k, v in row.items() if isinstance(v, dict))
              + f"; {card}", file=sys.stderr)
    main_path = {}
    if "--main-path" in flags:
        for label, calls in record_prp_calls(device).items():
            main_path[label] = [prp_row(other, form) for form in calls]
            print(f"main path, {label}: " + "; ".join(
                f"{v['fn']} slots {v['slots']} {v['slots_dtype']}, count "
                f"{v['count']}, k {v['k_bits']}: {v['this_ms']:.4f} / "
                f"{v['other_ms']:.4f} ({v['this_host_ms']:.4f} / "
                f"{v['other_host_ms']:.4f})" for v in main_path[label]),
                file=sys.stderr)
    print(json.dumps({"rows": rows, "main_path": main_path, "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
