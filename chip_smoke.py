"""Drive mfcd_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught and continued):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every kernel source under mfcd_tpu_torch/ops/csrc, rebuilt;
3. kernels: the fused-epoch kernel against its plain PyTorch version on the
   card, at the canonical shape (n = m = 1000, d = 2, bs = 64, 2048 padded
   batches, R = 4, pack "full") and at a small shape in all three pack
   modes; then its time per epoch, the plain version's, and the bound;
4. main path: ``parameter_scan`` at the canonical configuration
   (n = m = 1000, d = 2, p = 0.2, s = 5, 30 epochs, reps = 4) on the card,
   with the kernel launch count read around it;
5. card vs CPU: the same configuration at 2 epochs, reps = 1, on both.

Prints the ``kernels`` JSON line and the nvidia-smi line before the last
line, and as the last line ``{"ok": true, "device": {...}}``.  Exits
non-zero without a result when no CUDA device is present.
"""

from __future__ import annotations

import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Canonical configuration (``bench.py:502-505``): one config, 4 reps.
CANON = dict(n=1000, m=1000, d=2, p=0.2, s=[5.0], lr=1e-3,
             weight_decay=5e-6, num_epochs=30, reps=4)
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Kernel-vs-plain bound, per tensor: max|diff| <= KERNEL_RTOL * max|ref| +
# KERNEL_ATOL.  The orders of the gradient sums (index_add_ on the card adds
# with atomics) and of the loss reduction differ; every other operation
# rounds alike (--fmad=false).  Scaling by each tensor's own magnitude holds
# the moments (nu ~ 1e-5) as tightly as U and V (~ 1).
KERNEL_RTOL = 1e-5
KERNEL_ATOL = 1e-12
# Card-vs-CPU bound on the 23 result keys: the card's QR, expf and sums
# round differently from the CPU's (~1e-6 relative on X); a BTL vote or a
# 0.5-threshold prediction whose margin is below that can flip, moving a
# metric by ~1e-4 of its 10^4 test rows.
CARD_CPU_RTOL = 2e-3
CARD_CPU_ATOL = 2e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_epoch_inputs(seed, r, n, m, d, bs, num_batches, counts, lrs, mode,
                      device):
    """Random state and a random valid stream, packed as ``mode`` says."""
    from mfcd_tpu_torch.ops.kernels import EpochState
    from mfcd_tpu_torch.train.kernel_trainer import _pack_spec

    g = np.random.default_rng(seed)
    rows = num_batches * bs
    counts = np.asarray(counts, np.int32)
    inv = 1.0 / math.sqrt(d)
    u_t = (g.standard_normal((r, d, n)) * inv).astype(np.float32)
    v_t = (g.standard_normal((r, d, m)) * inv).astype(np.float32)
    mom = lambda k: (np.abs(g.standard_normal((r, d, k))) * 1e-3).astype(
        np.float32)
    state = [u_t, v_t, mom(n) * 0.1, mom(n) * 1e-3, mom(m) * 0.1,
             mom(m) * 1e-3]
    u = g.integers(0, n, (r, rows)).astype(np.int32)
    i = g.integers(0, m, (r, rows)).astype(np.int32)
    j = ((i + g.integers(1, m, (r, rows))) % m).astype(np.int32)
    z = (g.random((r, rows)) < 0.5).astype(np.float32)
    valid = np.arange(rows)[None, :] < counts[:, None]
    u, i, j, z = (np.where(valid, a, 0).astype(a.dtype) for a in (u, i, j, z))
    spec = _pack_spec(n, m, 1)
    if mode == "full":
        assert spec[0] == "full"
        _, bn, bm, bz = spec
        stream = (u | (i << bn) | (j << (bn + bm))
                  | (z.astype(np.int32) << (bn + 2 * bm)),)
        pack = ("full", bn, bm, bz, 1)
    elif mode == "uij":
        _, bn, bm, _ = spec
        stream = (u | (i << bn) | (j << (bn + bm)), z)
        pack = ("uij", bn, bm, 0, 1)
    else:
        stream = (u, i, j, z)
        pack = ("none", 0, 0, 0, 1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    shape = (r, num_batches, bs)
    return dict(
        state=EpochState(*(t(a) for a in state)),
        stream=tuple(t(a).reshape(shape) for a in stream),
        lr=t(np.asarray(lrs, np.float32)),
        wd=t(np.full(r, 5e-6, np.float32)),
        step0=t(np.zeros(r, np.float32)),
        count=t(counts), pack=pack)


def clone_state(state):
    return type(state)(*(a.clone() for a in state))


def compare_epoch(inp, label):
    """Kernel vs plain version on the same inputs; returns max |diff|."""
    from mfcd_tpu_torch.ops import kernels

    args = (inp["stream"], inp["lr"], inp["wd"], inp["step0"], inp["count"])
    ref_state, ref_loss = kernels.train_epoch_reference(
        clone_state(inp["state"]), *args, pack=inp["pack"])
    got_state, got_loss = kernels.train_epoch(
        clone_state(inp["state"]), *args, pack=inp["pack"])
    torch.cuda.synchronize()
    worst = 0.0
    errs = []
    for name, a, b in zip(("loss",) + kernels.EpochState._fields,
                          (ref_loss,) + tuple(ref_state),
                          (got_loss,) + tuple(got_state)):
        if not torch.isfinite(b).all():
            fail(f"{label}: non-finite {name} from the kernel")
        err = float((a - b).abs().max())
        scale = float(a.abs().max())
        worst = max(worst, err)
        errs.append(f"{name} {err:.3g}/{scale:.3g}")
        if err > KERNEL_RTOL * scale + KERNEL_ATOL:
            fail(f"{label}: {name} max|diff| {err:.3g} > {KERNEL_RTOL} x "
                 f"max|ref| {scale:.3g} + {KERNEL_ATOL}")
    log(f"  {label}: kernel vs plain max|diff|/max|ref| "
        + ", ".join(errs)
        + f" (bound {KERNEL_RTOL} x max|ref| + {KERNEL_ATOL} per tensor)")
    return worst


def time_ms(fn, warmup: int, reps: int) -> float:
    """Median of per-call CUDA-event times, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def epoch_bound_ms(inp, n, m, d, bs):
    """Least time for one call on these inputs, from the H100 peaks.

    Bytes: the state read and written once, the executed batches' stream
    words read once, the per-run scalars and the loss.  Operations: per
    executed step, bs * (9d + 15) for the rows (forward, BCE, g, scatter)
    plus 16 per element of the dense Adam over (n + m) * d elements."""
    count = inp["count"].cpu().numpy().astype(np.int64)
    steps = int(np.minimum((count + bs - 1) // bs,
                           inp["stream"][0].shape[1]).sum())
    r = len(count)
    state_bytes = sum(a.numel() * 4 for a in inp["state"])
    stream_bytes = steps * bs * sum(a.element_size() for a in inp["stream"])
    nbytes = 2 * state_bytes + stream_bytes + r * 4 * 5
    flops = steps * (bs * (9 * d + 15) + 16 * (n + m) * d + 6)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def all_finite(results) -> bool:
    def walk(v):
        if isinstance(v, dict):
            return all(walk(x) for x in v.values())
        if isinstance(v, (list, tuple)):
            return all(walk(x) for x in v)
        return bool(np.all(np.isfinite(np.asarray(v, dtype=np.float64))))
    return walk(results)


def compare_results(a, b, label):
    from mfcd_tpu_torch.core.results import RESULT_KEYS

    worst = {}
    for k in RESULT_KEYS:
        va, vb = a[k], b[k]
        if len(va) != len(vb):
            fail(f"{label}: {k} has {len(va)} vs {len(vb)} reps")
        for x, y in zip(va, vb):
            x = np.asarray(x, np.float64)
            y = np.asarray(y, np.float64)
            if x.shape != y.shape:
                fail(f"{label}: {k} shapes {x.shape} vs {y.shape}")
            if not np.allclose(x, y, rtol=CARD_CPU_RTOL, atol=CARD_CPU_ATOL):
                fail(f"{label}: {k} differs: max|diff| "
                     f"{np.abs(x - y).max():.3g}")
            worst[k] = max(worst.get(k, 0.0),
                           float(np.abs(x - y).max()) if x.size else 0.0)
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import mfcd_tpu_torch
    from mfcd_tpu_torch.core.results import validate_schema
    from mfcd_tpu_torch.ops import _build, kernels

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[1] device: {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    built = _build.build_all(force=True)
    log(f"[2] build: {len(built)} librar{'y' if len(built) == 1 else 'ies'} "
        f"in {time.perf_counter() - t0:.2f} s")
    for src, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    # [3] Kernel vs plain version, then timing at the canonical shape.
    n, m, d, bs, nb = 1000, 1000, 2, 64, 2048
    canon = make_epoch_inputs(1, 4, n, m, d, bs, nb,
                              [80000, 80000, 80000, 51234],
                              [1e-3, 3e-3, 1e-3, 1e-2], "full", dev)
    max_err = compare_epoch(canon, "canonical R=4 full")
    for mode in ("full", "uij", "none"):
        small = make_epoch_inputs(2, 2, 20, 25, 3, 32, 4, [70, 100],
                                  [1e-2, 3e-2], mode, dev)
        max_err = max(max_err, compare_epoch(small, f"small {mode}"))

    args = (canon["stream"], canon["lr"], canon["wd"], canon["step0"],
            canon["count"])
    timed = clone_state(canon["state"])
    kernel_ms = time_ms(
        lambda: kernels.train_epoch(timed, *args, pack=canon["pack"]),
        warmup=2, reps=7)
    plain_ms = time_ms(
        lambda: kernels.train_epoch_reference(canon["state"], *args,
                                              pack=canon["pack"]),
        warmup=1, reps=3)
    bound_ms, bound_by = epoch_bound_ms(canon, n, m, d, bs)
    log(f"[3] epoch R=4 canonical: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.2f} ms, bound {bound_ms:.6f} ms ({bound_by})")

    # [4] The main path at full width, launches counted around it.
    with tempfile.TemporaryDirectory(prefix="mfcd_chip_smoke_") as tmp:
        save_path = os.path.join(tmp, "scan.pkl")
        torch.cuda.synchronize()
        kernels.EPOCH_LAUNCHES = 0
        t0 = time.perf_counter()
        out = mfcd_tpu_torch.parameter_scan(save_path=save_path,
                                            save_every=1, **CANON)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.EPOCH_LAUNCHES
        with open(save_path, "rb") as f:
            saved = pickle.load(f)
    if launches != CANON["num_epochs"]:
        fail(f"main path launched the epoch kernel {launches} times, "
             f"expected {CANON['num_epochs']}")
    if out != [] or len(saved) != 1:
        fail("pickle protocol: expected one flushed experiment")
    res = saved[0]["results"]
    problems = validate_schema(res)
    if problems:
        fail(f"schema: {problems}")
    if not all_finite(res):
        fail("non-finite values in the results")
    acc = float(np.mean(res["accuracy"]))
    if not acc > 0.6:
        fail(f"mean accuracy {acc:.4f} is not above 0.6")
    runs = CANON["reps"] * len(CANON["s"])
    log(f"[4] main path: parameter_scan canonical, {runs} runs in "
        f"{wall:.3f} s ({wall / runs:.4f} s/run), {launches} kernel "
        f"launches, mean accuracy {acc:.4f}, gt accuracy "
        f"{float(np.mean(res['gt_accuracy'])):.4f}, final train loss "
        f"{float(np.mean([c[-1] for c in res['train_losses']])):.4f}")

    # [5] Card vs CPU at the same shape, 2 epochs.
    short = dict(CANON, num_epochs=2, reps=1)
    t0 = time.perf_counter()
    on_card = mfcd_tpu_torch.parameter_scan(device="cuda", **short)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = mfcd_tpu_torch.parameter_scan(device="cpu", **short)
    t_cpu = time.perf_counter() - t0
    worst = compare_results(on_card[0]["results"], on_cpu[0]["results"],
                            "card vs cpu")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
    log(f"[5] card vs CPU (2 epochs, reps 1): 23 keys within rtol "
        f"{CARD_CPU_RTOL}, atol {CARD_CPU_ATOL}; largest |diff| "
        + ", ".join(f"{k} {v:.3g}" for k, v in top)
        + f"; card {t_card:.2f} s, CPU {t_cpu:.2f} s")

    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "fused_train_epoch",
        "route": "cuda",
        "source": "mfcd_tpu_torch/ops/csrc/epoch_kernel.cu",
        "replaces": "mfcd_tpu/ops/kernels.py:69",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
