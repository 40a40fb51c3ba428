"""Time S2 (the epoch shuffle) and T1 (threefry) built from this checkout
against another build of them, in turns.

    python3 -m mfcd_tpu_torch.scripts.ab_shuffle_kernels [DIR]

DIR holds the other ``shuffle_kernel.cu``, ``prng_kernel.cu`` and the
``threefry.cuh`` they include, with the one-slot-a-thread C interface
(``mfcd_mix_stream`` taking pointer arrays, ``mfcd_threefry_hash`` and
``mfcd_threefry_bits``); the default, ``scripts/ab_baseline/``, is that
design, kept for this comparison.  Both are built with the port's nvcc
flags, and the other build is called through that design's own wrappers
(:class:`Baseline`), host work included.

At each shape of ``SHUFFLE_CASES`` (also ``chip_smoke.py`` [14]'s):
S2 over a fresh and a cheap epoch (this build as the trainer calls it, the
epoch's keys folded before the loop; the other from the epochs keys, as it
took them) and T1's ``bits`` over [R, S], ``fold_in`` of R keys by an
integer (the key tree's form) and ``split`` of R keys into 9 (a run's
streams).  Each pair is checked bit-equal, then timed by :func:`queue_ms`
(device ms a call, the card's queue kept ahead of the host, and the host's
issue ms a call) in turns: this, other, other, this, twice; the median of
each side's four.  Prints a line per shape on stderr and, as its last
line, one JSON object with every median, every reading, the ratios (this /
other) and the card's name and power limit.  Exits non-zero without a
card.
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
    """S2 and T1 of the one-slot-a-thread design, built from ``src_dir``
    and called as that design's wrappers called them: S2 from the epochs
    keys with ctypes pointer arrays; T1's fold_in as a fill, a zeros_like
    and a hash launch over broadcast int64 words; split and bits through
    the counter entry."""

    def __init__(self, src_dir: str = BASELINE_DIR):
        jobs = [_build._start(os.path.join(src_dir, name), force=True)
                for name in ("shuffle_kernel.cu", "prng_kernel.cu")]
        s2, t1 = (ctypes.CDLL(_build._finish(job)) for job in jobs)
        s2.mfcd_mix_stream.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_longlong] * 3
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        t1.mfcd_threefry_hash.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p])
        t1.mfcd_threefry_bits.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_longlong] * 4
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        for lib, fns in ((s2, ("mfcd_mix_stream",)),
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


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_shuffle_kernels: no CUDA device", file=sys.stderr)
        return 2
    from mfcd_tpu_torch.backend import card_line

    device = torch.device("cuda")
    other = Baseline(argv[0] if argv else BASELINE_DIR)
    card = card_line()
    rows = []
    for label, r, s_len, count, k_bits, arrays in SHUFFLE_CASES:
        calls = case_calls(other, *case_inputs(r, s_len, count, arrays,
                                               device), k_bits)
        row = dict(label=label, r=r, s=s_len, count=count, k_bits=k_bits,
                   arrays=arrays)
        for name, (this, base) in calls.items():
            row[name] = in_turns(this, base)
        rows.append(row)
        print(f"{label} (R={r}, S={s_len}): bit-equal; device ms this / "
              f"other (host issue ms): " + "; ".join(
                  f"{k} {v['this_ms']:.4f} / {v['other_ms']:.4f} "
                  f"({v['this_host_ms']:.4f} / {v['other_host_ms']:.4f})"
                  for k, v in row.items() if isinstance(v, dict))
              + f"; {card}", file=sys.stderr)
    print(json.dumps({"rows": rows, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
