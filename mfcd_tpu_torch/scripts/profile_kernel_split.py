"""Per-stage cost split of the fused-epoch kernel K1, on one CUDA card.

    python3 -m mfcd_tpu_torch.scripts.profile_kernel_split

Counterpart of ``scripts/profile_kernel_split.py::main``.  At the canonical
bench bucket (R = 8 runs: 2 configs x 4 reps, n = m = 1000, d = 2, 80,000
train rows in batches of 64: 1,250 steps per epoch), with inputs drawn from
a seed by numpy, it times one epoch of each stage variant of
``ops/csrc/epoch_variants.cu`` (``loop_only`` ... ``full``: K1's own code
with stages removed, ``full`` being K1's), of the factored-layout epoch
(P2, the same source) and of K1 (``ops/csrc/epoch_kernel.cu``) itself:
the median of per-call CUDA-event times with the card's queue kept full
(see :func:`median_ms`).  Every kernel runs at K1's launch shape for the
shape (C = 8 at R = 8 on an H100; P2's tables have 1,024 rows), or at
the one :func:`profile`'s ``cluster`` forces.  Differences between adjacent
variants estimate each stage's cost per step of K1, and they sum to
K1's step: ``full`` and K1 differ only by noise.

Prints a readable report on stderr (each kernel's time beside its launch
shape, and the card) and, as its last line, one JSON object: ``variants``
(per variant: ``ms_per_epoch``, ``s_per_epoch``, ``us_per_step`` = epoch
/ batches, the chain latency of one step, which compares across R
because the runs go in parallel, ``us_per_run_step`` = epoch / (R *
batches), the JAX script's unit, and ``cluster``, the launch shape),
``stage_deltas_us`` (from ``us_per_step``), ``k1`` (K1's entry and
``full_minus_k1_us_per_step``), ``shape`` (with ``cluster``, K1's launch
shape), and ``card`` (the card's name and power limit from nvidia-smi).
``full_factored`` carries ``allclose_vs_full``: its final U against
``full``'s (rtol 1e-4, atol 1e-6, the JAX script's test).  Exits non-zero
without a card.
"""

from __future__ import annotations

import json
import sys
from typing import Optional

import numpy as np
import torch

from mfcd_tpu_torch.ops import kernels
from mfcd_tpu_torch.ops.kernel_split import (FACTORED_ROWS, VARIANTS,
                                             _train_epoch_factored,
                                             _train_epoch_variant,
                                             from_factored_layout,
                                             to_factored_layout)
from mfcd_tpu_torch.ops.kernels import EpochState

R, N, M, D, BS, ROWS = 8, 1000, 1000, 2, 64, 80_000
ORDER = tuple(VARIANTS)   # each adds one stage to the one before
WARMUP, REPS = 2, 9


def canonical_inputs(device, seed: int = 0) -> dict:
    """The profiler's inputs (``profile_kernel_split.py:554-583``): normal
    U and V, zero moments, uniform rows with i != j, fair labels, packed
    "full"; lr 1e-3, weight decay 5e-6, Adam step 0, every row counted."""
    num_batches = -(-ROWS // BS)
    bits_n, bits_m = (N - 1).bit_length(), (M - 1).bit_length()
    g = np.random.default_rng(seed)
    padded = num_batches * BS
    u = g.integers(0, N, (R, padded))
    i = g.integers(0, M, (R, padded))
    j = (i + 1 + g.integers(0, M - 1, (R, padded))) % M
    z = (g.random((R, padded)) < 0.5).astype(np.int64)
    packed = (u | (i << bits_n) | (j << (bits_n + bits_m))
              | (z << (bits_n + 2 * bits_m))).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    zeros = lambda k: torch.zeros((R, D, k), dtype=torch.float32,
                                  device=device)
    return dict(
        state=EpochState(
            t(g.standard_normal((R, D, N)).astype(np.float32)),
            t(g.standard_normal((R, D, M)).astype(np.float32)),
            zeros(N), zeros(N), zeros(M), zeros(M)),
        stream=(t(packed.reshape(R, num_batches, BS)),),
        lr=t(np.full(R, 1e-3, np.float32)), wd=t(np.full(R, 5e-6, np.float32)),
        step0=t(np.zeros(R, np.float32)), count=t(np.full(R, ROWS, np.int32)),
        pack=("full", bits_n, bits_m, 1, 1))


def _clone(state: EpochState) -> EpochState:
    return EpochState(*(a.clone() for a in state))


def median_ms(call, state: EpochState, warmup: int = WARMUP,
              reps: int = REPS) -> float:
    """Median CUDA-event time of one ``call(copy of state)``, after
    ``warmup`` calls.  Each call gets its own copy, made before timing.
    The timed calls are enqueued back to back with an event between each
    two, behind one untimed call that keeps the card busy meanwhile, so
    the host's time in the wrapper (checks, binding, launch) overlaps the
    card's work instead of falling inside a window."""
    copies = [_clone(state) for _ in range(warmup + 1 + reps)]
    for st in copies[:warmup]:
        call(st)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    call(copies[warmup])
    events[0].record()
    for k, st in enumerate(copies[warmup + 1:]):
        call(st)
        events[k + 1].record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b)
                            for a, b in zip(events, events[1:])]))


def profile(inp: dict, warmup: int = WARMUP, reps: int = REPS,
            cluster: Optional[int] = None) -> dict:
    """Time every variant, the factored epoch and K1 on ``inp`` (CUDA
    tensors), each at the launch shape its wrapper chooses or at
    ``cluster`` (PACKED or a ``kernels.CLUSTER_SIZES`` entry); returns the
    JSON-ready result (without ``card``)."""
    r, num_batches, bs = inp["stream"][0].shape
    args = (inp["stream"], inp["lr"], inp["wd"], inp["step0"], inp["count"])
    pack = inp["pack"]
    d, n = inp["state"].u_t.shape[1:]
    m = inp["state"].v_t.shape[2]
    dev = inp["count"].device

    def entry(ms, c):
        return {"ms_per_epoch": ms, "s_per_epoch": ms / 1e3,
                "us_per_step": ms * 1e3 / num_batches,
                "us_per_run_step": ms * 1e3 / (r * num_batches),
                "cluster": c}

    def shape(rows=None):  # the launch shape of K1 at this shape
        if cluster is not None:
            return cluster
        return kernels.cluster_size(r, rows or n, rows or m, d, bs, dev)

    variants = {}
    for name in ORDER:
        stages = VARIANTS[name]
        variants[name] = entry(median_ms(
            lambda st: _train_epoch_variant(st, *args, pack=pack,
                                            stages=stages, cluster=cluster),
            inp["state"], warmup, reps), shape())

    state_f = EpochState(*(to_factored_layout(a) for a in inp["state"]))
    factored = lambda st: _train_epoch_factored(st, *args, pack=pack,
                                                cluster=cluster)
    variants["full_factored"] = entry(
        median_ms(factored, state_f, warmup, reps),
        shape(FACTORED_ROWS))
    full_u = _train_epoch_variant(_clone(inp["state"]), *args, pack=pack,
                                  stages=VARIANTS["full"],
                                  cluster=cluster)[0].u_t
    fac_u = from_factored_layout(factored(_clone(state_f))[0].u_t, d, n)
    variants["full_factored"]["allclose_vs_full"] = bool(
        torch.allclose(fac_u, full_u, rtol=1e-4, atol=1e-6))
    variants["full_factored"]["max_delta_vs_full"] = float(
        (fac_u - full_u).abs().max())

    deltas = {f"{b}-{a}": variants[b]["us_per_step"]
              - variants[a]["us_per_step"] for a, b in zip(ORDER, ORDER[1:])}
    k1 = entry(median_ms(
        lambda st: kernels._train_epoch(st, *args, pack=pack,
                                        cluster=cluster),
        inp["state"], warmup, reps), shape())
    k1["full_minus_k1_us_per_step"] = (variants["full"]["us_per_step"]
                                       - k1["us_per_step"])
    return {"variants": variants, "stage_deltas_us": deltas, "k1": k1,
            "shape": {"r": r, "n": n, "m": m, "d": d, "bs": bs,
                      "batches": num_batches, "cluster": k1["cluster"]}}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_kernel_split: no CUDA device", file=sys.stderr)
        return 2
    from mfcd_tpu_torch.backend import card_line

    card = card_line()
    out = profile(canonical_inputs(torch.device("cuda")))
    out["card"] = card
    for name, v in out["variants"].items():
        print(f"{name:14s} C={v['cluster']:<2d} {v['ms_per_epoch']:9.4f} "
              f"ms/epoch  {v['us_per_step']:8.4f} us/step  "
              f"{v['us_per_run_step']:8.4f} us/run-step", file=sys.stderr)
    k1 = out["k1"]
    print(f"{'K1':14s} C={k1['cluster']:<2d} {k1['ms_per_epoch']:9.4f} "
          f"ms/epoch  {k1['us_per_step']:8.4f} us/step  (full - K1 "
          f"{k1['full_minus_k1_us_per_step']:.4f} us/step)", file=sys.stderr)
    print(f"stage deltas (us/step): {out['stage_deltas_us']}; {card}",
          file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
