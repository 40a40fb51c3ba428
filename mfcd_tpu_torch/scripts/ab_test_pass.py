"""Time the test pass, L1's counting variant (``ops/loss_pass.py::
losses_and_hits``), against the eager block loop that ``evaluate_split``
ran before L1 counted correct rows, and check its bits.

    python3 -m mfcd_tpu_torch.scripts.ab_test_pass [OTHER/loss_pass.cu]

At each shape of ``TEST_SHAPES`` (R = 5 runs of the canonical, K = 10 and
K = 50 cells' test splits, batch 64, d = 2, n = m = 1000, hard labels, the
tables as the trainer stores them, ``[R, d, n]`` read through transposed
views): the count equal to the plain block path's on the card, the
accuracy's bits equal to :func:`eager_accuracy`'s, the loss bit-equal to
the loss-only pass's (the validation pass) and, where OTHER is given, to
L1 built from that source with the C interface that takes no count (the
parent's); then the device ms and host issue ms a call
(``ab_shuffle_kernels.queue_ms``) of ``evaluate_split`` and of the
loss-only pass, and the wall ms a call, issue to the card's end, of
``evaluate_split`` and of :func:`eager_evaluate`.  Prints a line per shape on stderr
and, as its last line, one JSON object with every reading and the card's
name and power limit.  Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import json
import sys
import time

import numpy as np
import torch

from mfcd_tpu_torch.data.btl import LabeledSplit
from mfcd_tpu_torch.eval.metrics import evaluate_split
from mfcd_tpu_torch.models.mf import MFParams, forward_logits
from mfcd_tpu_torch.ops import _build, loss_pass

N = M = 1000
D, BS = 2, 64
# (label, runs, rows a run, valid rows a run): the test splits of
# ``parameter_scan`` calls of 5 runs at n = m = 1000, p = 0.2 and K = 1,
# 10 and 50, as the ``test_pass.l1_rows`` counter reads them
TEST_SHAPES = (("canonical test", 5, 16_384, 10_000),
               ("k10 test", 5, 262_144, 100_000),
               ("k50 test", 5, 1_048_576, 500_000))


def eager_accuracy(params: MFParams, split, bs: int) -> torch.Tensor:
    """The test accuracy as ``evaluate_split`` computed it before L1
    counted correct rows: float hits summed in blocks of 64 batches, over
    the valid rows' count; some 37 launches a block."""
    u, i, j, z, valid = loss_pass._pad_to_batches(split, bs)

    def block_stats(args):
        bu, bi, bj, bz, bv = args
        pred = (torch.sigmoid(forward_logits(params, bu, bi, bj))
                > 0.5).to(torch.float32)
        hit = torch.where(bv, (pred == bz).to(torch.float32),
                          torch.zeros_like(pred))
        return torch.sum(hit, dim=-1), torch.sum(bv, dim=-1)

    correct_b, cnt_b = loss_pass.map_batch_blocks(
        block_stats, (u, i, j, z, valid), u.shape[-2])
    correct = torch.sum(correct_b, dim=-1)
    total = torch.sum(cnt_b, dim=-1)
    return torch.where(total > 0, correct / torch.clamp(total, min=1),
                       torch.zeros_like(correct))


def eager_evaluate(params: MFParams, split, bs: int):
    """``evaluate_split`` before L1 counted: the loss-only pass, then
    :func:`eager_accuracy`."""
    return (loss_pass.batch_losses(params, split, bs)[1],
            eager_accuracy(params, split, bs))


def inputs(runs: int, rows: int, count: int, device, seed: int = 0):
    """A test split of ``runs`` x ``rows`` rows, the first ``count`` of
    each run valid, and tables stored as ``[R, d, n]``."""
    g = np.random.default_rng(seed + rows)
    t = lambda a: torch.as_tensor(a, device=device)
    u = g.integers(0, N, (runs, rows)).astype(np.int32)
    i = g.integers(0, M, (runs, rows)).astype(np.int32)
    j = ((i + g.integers(1, M, (runs, rows))) % M).astype(np.int32)
    z = (g.random((runs, rows)) < 0.5).astype(np.float32)
    valid = np.tile(np.arange(rows) < count, (runs, 1))
    split = LabeledSplit(t(u), t(i), t(j), t(z), t(valid),
                         t(np.full(runs, count, np.int32)))
    params = MFParams(*[t((g.standard_normal((runs, D, k)) / np.sqrt(D))
                          .astype(np.float32)).transpose(1, 2)
                        for k in (N, M)])
    return params, split


def _other_library(path: str) -> ctypes.CDLL:
    """L1 built from ``path``, whose ``mfcd_loss_pass`` takes no count."""
    lib = ctypes.CDLL(_build._finish(_build._start(path, force=True)))
    lib.mfcd_loss_pass.argtypes = loss_pass._ARGS[:-3] + loss_pass._ARGS[-1:]
    lib.mfcd_loss_pass.restype = ctypes.c_int
    lib.mfcd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mfcd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _other_pass(lib, params: MFParams, split, bs: int):
    U, V = params.U, params.V
    r, rows = split.u.shape
    batches = -(-rows // bs)
    means = torch.empty((r, batches), dtype=torch.float32, device=U.device)
    epoch = torch.empty((r,), dtype=torch.float32, device=U.device)
    strided = []
    for name, _ in loss_pass._FIELDS:
        f = getattr(split, name)
        strided += [f.data_ptr(), f.stride(0), f.stride(1)]
    err = lib.mfcd_loss_pass(U.data_ptr(), *U.stride(), V.data_ptr(),
                             *V.stride(), *strided, r, rows, bs, U.shape[2],
                             means.data_ptr(), epoch.data_ptr(),
                             _build.stream_ptr(U.device))
    _build.raise_on(lib, err, "other L1")
    return means, epoch


def _bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def measure(label: str, runs: int, rows: int, count: int, device,
            other=None) -> dict:
    """One shape of ``TEST_SHAPES``: bits checked (raises on a mismatch),
    then each path's device and host ms a call."""
    from mfcd_tpu_torch.scripts.ab_shuffle_kernels import queue_ms

    params, split = inputs(runs, rows, count, device)
    want = loss_pass.losses_and_hits_reference(params, split, BS)
    loss_only = loss_pass.batch_losses(params, split, BS)
    before = loss_pass.LOSS_LAUNCHES
    got = loss_pass.losses_and_hits(params, split, BS)
    launches = loss_pass.LOSS_LAUNCHES - before
    loss, acc = evaluate_split(params, split, BS)
    eager_loss, eager_acc = eager_evaluate(params, split, BS)
    checks = {
        "count": torch.equal(got[2], want[2]),
        "accuracy": _bits(acc, eager_acc),
        "loss": all(_bits(a, b) for a, b in zip(got[:2], loss_only))
        and _bits(loss, eager_loss),
        "launches": launches == 2,
    }
    if other is not None:
        parent = _other_pass(other, params, split, BS)
        checks["parent_loss"] = all(_bits(a, b)
                                    for a, b in zip(parent, loss_only))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{label}: {bad} differ")
    entry = dict(label=label, runs=runs, rows=rows, valid=count,
                 correct=got[2].tolist(), checks=sorted(checks))
    for name, fn in (("test_pass", lambda: evaluate_split(params, split, BS)),
                     ("loss_only", lambda: loss_pass.batch_losses(
                         params, split, BS))):
        entry[f"{name}_ms"], entry[f"{name}_host_ms"] = queue_ms(fn)
    entry["test_pass_wall_ms"] = wall_ms(
        lambda: evaluate_split(params, split, BS))
    entry["eager_wall_ms"] = wall_ms(
        lambda: eager_evaluate(params, split, BS))
    return entry


def wall_ms(fn, reps: int = 10) -> float:
    """Host ms a call of ``fn`` from issue to the card's end, calls back
    to back after a warm-up: what the caller waits, the eager path's
    allocator syncs included (they let the card catch up with the host,
    so ``queue_ms`` cannot hold the eager path's queue full)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_test_pass: no CUDA device", file=sys.stderr)
        return 2
    from mfcd_tpu_torch.backend import card_line

    device = torch.device("cuda")
    other = _other_library(argv[0]) if argv else None
    card = card_line()
    out = []
    for shape in TEST_SHAPES:
        e = measure(*shape, device, other)
        out.append(e)
        print(f"{e['label']} (R={e['runs']}, {e['rows']} rows, {e['valid']} "
              f"valid): {', '.join(e['checks'])} bit-equal; test pass "
              f"{e['test_pass_ms']:.6f} ms device, {e['test_pass_host_ms']:.4f}"
              f" host; loss-only {e['loss_only_ms']:.6f} / "
              f"{e['loss_only_host_ms']:.4f}; wall a call: test pass "
              f"{e['test_pass_wall_ms']:.4f}, eager {e['eager_wall_ms']:.4f};"
              f" {card}", file=sys.stderr)
    print(json.dumps({"shapes": out, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
