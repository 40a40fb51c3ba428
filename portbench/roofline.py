"""The card's peaks and the operations and bytes the fused epoch needs.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates): 67
TFLOP/s in float32 outside the tensor cores and 3.35 TB/s of HBM, both at
the full 700 W power limit.  A card set below it (``nvidia-smi
--query-gpu=power.limit``) runs slower under load; every result line
carries the card's name, and PERF.md its limit beside each reading.

The fused training epoch (K1) trains one epoch of every run of a call in
one launch.  Its least time is the larger of its operations at the
float32 rate and its bytes at the memory rate:

- operations, per executed step (one batch of one run): ``bs * (9 d +
  15)`` for the batch's rows (gathers, logit, BCE, gradient, scatter) and
  16 per element of the dense Adam over the ``(n + m) d`` parameters,
  plus 6 for the step's scalars;
- bytes: the state (U, V and their two Adam moments) read and written
  once, the executed batches' stream words read once, and five 4-byte
  scalars a run.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def stream_word_bytes(n: int, m: int, label_denom: int = 1) -> int:
    """Bytes a training row takes in the program's packed stream: one
    int32 where u, i, j and the label's numerator over ``label_denom`` (K
    under soft labels, else 1) fit 31 bits, an int32 and a float32 label
    where u, i, j alone do, else four 4-byte words."""
    bits_n = max((n - 1).bit_length(), 1)
    bits_m = max((m - 1).bit_length(), 1)
    bits_z = max(int(label_denom).bit_length(), 1)
    if bits_n + 2 * bits_m + bits_z <= 31:
        return 4
    if bits_n + 2 * bits_m <= 31:
        return 8
    return 16


def train_rows(n: int, m: int, p: float, K: int, soft: bool = False
               ) -> int:
    """Training rows of one run: 80 % of the ``n m p / 2`` triplets, K
    hard votes each, or one row each whose label is their mean."""
    return int(0.8 * int(n * m * p / 2)) * (1 if soft else int(K))


def study_stream(study: dict):
    """(training rows of one run, bytes a row) of a configuration's study
    settings."""
    soft = bool(study.get("soft_label", False))
    rows = train_rows(study["n"], study["m"], study["p"], study["K"], soft)
    word = stream_word_bytes(study["n"], study["m"],
                             study["K"] if soft else 1)
    return rows, word


def epoch_steps(count: int, batch_size: int) -> int:
    """Executed steps of one run's epoch over ``count`` training rows."""
    return -(-int(count) // batch_size)


def k1_flops(steps: int, n: int, m: int, d: int, batch_size: int) -> float:
    """float32 operations of ``steps`` executed steps."""
    return float(steps) * (batch_size * (9 * d + 15) + 16 * (n + m) * d + 6)


def k1_bytes(runs: int, steps: int, n: int, m: int, d: int,
             batch_size: int, word_bytes: int) -> float:
    """Bytes one launch over ``runs`` runs and ``steps`` executed steps
    (summed over the runs) must move."""
    state = runs * d * (3 * n + 3 * m) * 4
    return 2.0 * state + steps * batch_size * word_bytes + runs * 4 * 5


def k1_bound_s(runs: int, steps: int, n: int, m: int, d: int,
               batch_size: int, word_bytes: int) -> float:
    """Least seconds of one launch: operations or bytes, whichever bounds."""
    return max(k1_flops(steps, n, m, d, batch_size) / PEAK_F32_FLOPS,
               k1_bytes(runs, steps, n, m, d, batch_size, word_bytes)
               / PEAK_BYTES_PER_S)
