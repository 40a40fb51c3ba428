"""Time K1 built from this checkout against K1 built from another source.

    git show HEAD~1:mfcd_tpu_torch/ops/csrc/epoch_kernel.cu > other/epoch_kernel.cu
    python3 -m mfcd_tpu_torch.scripts.ab_epoch_kernel other/epoch_kernel.cu

Builds the other ``epoch_kernel.cu`` (it must keep this checkout's C
interface, ``mfcd_train_epoch``) with the port's nvcc flags beside this
checkout's, and times one epoch of each at the benchmark cells' R (3 in
the sampler sweep, 5 in the scans, 45 in the grid's second chunk), at
R = 4, 8, 120 and at the large R that ``parameter_scan_fast`` chunks the
reference grid into (n = m = 1000, d = 2, bs = 64, 1,250 batches, pack
"full"), both at the launch shape this checkout's K1 chooses:
``profile_kernel_split.median_ms`` windows in turns (this, other, other,
this, twice), the median of each side's four.  Checks that both give the same bits.  Prints a line per R
on stderr and, as its last line, one JSON object with each R's medians,
their ratio (this / other), every reading and the card's name and power
limit.  Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import json
import sys

import numpy as np
import torch

from mfcd_tpu_torch.ops import _build, kernels
from mfcd_tpu_torch.scripts.profile_kernel_split import median_ms

N = M = 1000
D, BS, ROWS = 2, 64, 80_000
ROUNDS = 2


def large_r() -> int:
    """Runs per chunk that ``parameter_scan_fast`` picks on this card for
    the reference grid at one p (n = m = 1000, d = 2, p = 0.2, 5 reps)."""
    from mfcd_tpu_torch.core.config import RunConfig
    from mfcd_tpu_torch.sweep import batched
    from mfcd_tpu_torch.sweep.engine import compile_caps

    cfg = RunConfig(n=N, m=M, d=D, p=0.2, reps=5)
    return cfg.reps * batched.default_max_bucket(
        cfg, t_cap=compile_caps(cfg)[0], device="cuda")


def inputs(r: int, device, seed: int = 0) -> dict:
    """Normal U and V, small moments, uniform rows with i != j, fair
    labels, packed "full"; every row counted."""
    nb = -(-ROWS // BS)
    bits = (N - 1).bit_length()
    g = np.random.default_rng(seed)
    u = g.integers(0, N, (r, nb * BS))
    i = g.integers(0, M, (r, nb * BS))
    j = (i + 1 + g.integers(0, M - 1, (r, nb * BS))) % M
    z = (g.random((r, nb * BS)) < 0.5).astype(np.int64)
    packed = (u | (i << bits) | (j << 2 * bits) | (z << 3 * bits))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    normal = lambda k, s: t((g.standard_normal((r, D, k)) * s).astype(
        np.float32))
    state = kernels.EpochState(normal(N, 1.0), normal(M, 1.0),
                               normal(N, 1e-3).abs(), normal(N, 1e-6).abs(),
                               normal(M, 1e-3).abs(), normal(M, 1e-6).abs())
    return dict(state=state,
                stream=(t(packed.astype(np.int32).reshape(r, nb, BS)),),
                lr=t(np.full(r, 1e-3, np.float32)),
                wd=t(np.full(r, 5e-6, np.float32)),
                step0=t(np.zeros(r, np.float32)),
                count=t(np.full(r, ROWS, np.int32)),
                pack=("full", bits, bits, 1, 1))


def launch(lib, state, inp, cluster: int):
    """One epoch through ``lib``'s ``mfcd_train_epoch`` (pack "full"), as
    :func:`kernels._train_epoch` launches it; returns (state, loss)."""
    r, nb, bs = inp["stream"][0].shape
    _, bits_n, bits_m, bits_z, denom = inp["pack"]
    b1f, omb1, b2f, omb2, log_b1, log_b2 = kernels._adam_consts(0.9, 0.999)
    loss = torch.empty(r, dtype=torch.float32, device=state.u_t.device)
    err = lib.mfcd_train_epoch(
        *(a.data_ptr() for a in state), inp["stream"][0].data_ptr(), None,
        None, None, *(inp[k].data_ptr() for k in ("lr", "wd", "step0",
                                                  "count")),
        loss.data_ptr(), r, N, M, D, nb, bs, 0, bits_n, bits_m, bits_z, denom,
        b1f, omb1, b2f, omb2, 1e-8, log_b1, log_b2, cluster,
        torch.cuda.current_stream().cuda_stream)
    _build.raise_on(lib, err, "epoch kernel")
    return state, loss


def compare(this, other, r: int, device) -> dict:
    """Both libraries at R = ``r``: bits, then timings in turns."""
    inp = inputs(r, device)
    c = kernels.cluster_size(r, N, M, D, BS, device)
    clone = lambda: kernels.EpochState(*(a.clone() for a in inp["state"]))
    a, b = launch(this, clone(), inp, c), launch(other, clone(), inp, c)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a[0] + (a[1],),
                                                 b[0] + (b[1],))):
        raise SystemExit(f"ab_epoch_kernel: R={r}: the two kernels differ")
    calls = {"this": lambda st: launch(this, st, inp, c),
             "other": lambda st: launch(other, st, inp, c)}
    times = {"this": [], "other": []}
    for side in ("this", "other", "other", "this") * ROUNDS:
        times[side].append(median_ms(calls[side], inp["state"], warmup=1,
                                     reps=5))
    ms = {k: float(np.median(v)) for k, v in times.items()}
    return dict(r=r, cluster=c, this_ms=ms["this"], other_ms=ms["other"],
                ratio=ms["this"] / ms["other"], readings=times)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_epoch_kernel: no CUDA device", file=sys.stderr)
        return 2
    from mfcd_tpu_torch.backend import card_line

    this = kernels._library()
    other = ctypes.CDLL(_build._finish(_build._start(argv[0], force=True)))
    other.mfcd_train_epoch.argtypes = kernels._ARGTYPES
    other.mfcd_train_epoch.restype = ctypes.c_int
    other.mfcd_cuda_error_string.argtypes = [ctypes.c_int]
    other.mfcd_cuda_error_string.restype = ctypes.c_char_p
    device = torch.device("cuda")
    card = card_line()
    out = []
    for r in (3, 4, 5, 8, 45, 120, large_r()):
        row = compare(this, other, r, device)
        out.append(row)
        print(f"R={r:4d} C={row['cluster']:2d}: this {row['this_ms']:.4f} ms,"
              f" other {row['other_ms']:.4f} ms, ratio {row['ratio']:.4f}; "
              f"bit-equal; {card}", file=sys.stderr)
    print(json.dumps({"rows": out, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
