"""Drive mfcd_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught and continued):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every kernel source under mfcd_tpu_torch/ops/csrc, rebuilt;
3. kernels: the fused-epoch kernel K1 against its plain PyTorch version on
   the card, at the canonical shape (n = m = 1000, d = 2, bs = 64, 2048
   padded batches, R = 4, pack "full"), at a small shape in all three pack
   modes, at bs = 1024, on an adversarial stream (every row of a batch
   names one row of U and alternates two rows of V), at the profiler's
   R = 8, at R = 120 (``bench.py``'s sweep) and at the large R that
   ``parameter_scan_fast`` chunks the reference grid into (the last two
   over 64 batches); two launches bit-equal, the chosen launch shape
   bit-equal to one 512-thread block per run and to the packed kernel,
   and, in pack "full", P1's ``full`` (K1's code built in
   ``epoch_variants.cu``) bit-equal to K1 at the chosen shape; then at
   R = 4, 8, 120 and the large R, on the adversarial stream and at
   bs = 1024 (n = 20, m = 25, 64 steps), its time per epoch (the card's
   queue kept full) beside P1's ``full`` and itself at the other two
   launch shapes, the plain version's time, and the bound;
3b. kernel split: the five stage variants of K1 (P1: loss, state and the
   ``alive`` sums that show each kept stage's work) and the
   factored-layout epoch (P2) against their plain versions at the
   profiler's shape (R = 8, n = m = 1000, d = 2, bs = 64, 1,250 batches,
   pack "full"), each at its chosen launch shape, at C = 1 and packed,
   state and loss bit-equal across the three; P2 against the fused epoch;
   then the profiler's path
   (``mfcd_tpu_torch.scripts.profile_kernel_split.profile``) with the
   launch counts read around it: each kernel's time, K1's beside
   ``full``'s, the per-step stage split, the plain versions' times and the
   bounds; and the split again with every kernel forced to C = 1;
4. main path: ``parameter_scan`` at the canonical configuration
   (n = m = 1000, d = 2, p = 0.2, s = 5, 30 epochs, reps = 4) on the card,
   with the launch counts read around it: 30 of K1 and 30 of the epoch
   shuffle S2, and S1 and T1 launched;
4b. fast path: ``parameter_scan_fast`` on the bench bucket (s = 5 and 6:
   one chunk of 8 runs), launches read around it, against the sequential
   ``parameter_scan`` on the same grid;
5. card vs CPU: the same configuration at 2 epochs, reps = 1, on both;
6. strategies, the eight samplers besides ``random``: (a) the sample stage
   alone (``sample_and_split``) at the canonical shape, reps = 2, on the
   card and on the CPU from the same X (copied from the card) and streams:
   proximity and top_k bit-equal, the others within the bounds below;
   (b) ``parameter_scan_fast`` over all eight (one shape bucket each,
   30 epochs, reps = 4), one epoch kernel launch per epoch per chunk;
   (c) the sequential ``parameter_scan`` for user_similarity and margin
   against (b)'s results.  Per strategy: the sampler's path, the sample
   stage's card time per run, s/run, count against target, accuracy,
   the cascade's fixpoint passes and blocks, and peak memory per run
   beside ``sweep/batched.py``'s estimate;
7. generators, the ten modes besides ``base``: (a) ``generate_x`` at the
   canonical shape, reps = 2, on the card and on the CPU from the same
   keys, within the bounds below, with each mode's warm card ms per run;
   (b) ``parameter_scan_fast`` over all ten (one shape bucket each, 30
   epochs, reps = 4), one epoch kernel launch per epoch per chunk, peak
   memory per run under ``run_bytes``; (c) ``parameter_scan_ground_truth``
   on the card against the CPU (base over s in {1, 5} and p in {0.05,
   0.2}, and one gmm configuration), ``evaluate_ground_truth`` timed at
   reps = 4, and no epoch kernel launch in (c);
8. the study's sweeps (``mfcd_tpu_torch.experiments.runs``) at n = m =
   1000, their pickles in one temporary folder: (a) ``strategies_p_sweep``
   for random on the fast path (notebook cell 18: 20 p values, s = 5, 30
   epochs, reps = 1), 30 epoch kernel launches per chunk, the grid's params
   in order, accuracy above 0.6 at p = 0.2; (b) the same grid on the
   sequential path, its 23 keys within the card-vs-CPU bound of (a)'s;
   (c) ``generation_s_sweep`` for gmm (10 s values), then the same call
   again, which resumes: no launch, the pickle's bytes unchanged; (d)
   ``gt_d_s_sweep`` (7 d x 3 s at p = 0.5, reps = 3), finite, no launch.
   Per sweep: configurations, runs, wall, s/run, launches, peak memory;
9. AltSVM at MovieLens-100k's users and items (n = 943, m = 1682, f = 20):
   (a) the DCD phase kernel K2 bit-equal to its plain version on the card
   and on the CPU, from the same state and picks (T = 4,096 planted
   comparisons, one item phase and one user phase of 3 sweeps each), at
   f = 20 (there also at every table placement), at f = 64 (the tables
   past a block's shared memory), on a skewed set (items drawn with
   probability proportional to 1 / rank) and with 5 % of comparisons
   k = j, with K2's time beside the plain version's; (b) each phase at
   T = 100,000 on the first epoch's inputs bit-equal to the CPU's plain
   version, K2's ms (and at every table placement), its schedule's ms
   alone, the chain depth and us per level beside the bound, and the
   same on a skewed set, whose item phase is held bit-equal to the CPU's
   plain version too; then ``init_altsvm`` -> ``train_altsvm`` at the
   defaults (10 epochs, lambda = 0.1, C = 1, 3 sweeps) on T = 100,000
   planted comparisons: 20 K2 launches and 20 of its schedule, finite
   state, pairwise accuracy above 0.8, the wall, ms per phase and us per
   coordinate step;
10. chunks: ``parameter_scan_fast`` at n = m = 1000, d = 2, p = 0.2,
   30 epochs, 8 s values x 3 reps in chunks of 2 configurations (4
   chunks) with ``save_path``, twice: the params in grid order, 30 K1
   launches per chunk, the schema and every key finite, and the two
   pickles equal byte for byte (or within [5]'s bound where the card does
   not repeat its bits); s/run and peak memory;
11. the mesh (``mfcd_tpu_torch.parallel``), in ``torch.distributed`` jobs
   started by the port's launcher (kernels built here first, ranks
   spawned): (a) the (grid, data, tp)-sharded step at the canonical width
   (n = m = 1000, d = 2, bs = 64, G = the grid size, lr 1e-3, wd 5e-6, 30
   steps), one NCCL rank per card (mesh ``factor_mesh`` of the card count:
   (1, 1, 1) on one card) and 2 gloo ranks sharing the card at (1, 2, 1),
   (1, 1, 2) and (2, 1, 1), each against the unsharded step on the card
   (loss rtol 1e-5; U, V, mu, nu rtol 1e-4, atol 1e-6); (b)
   ``parameter_scan_fast(mesh=make_sweep_mesh())`` on [4b]'s bench bucket
   at 2 gloo ranks (and one NCCL rank per card where there are more
   cards), 30 K1 launches a rank, against [4b]'s results; (c)
   ``strategies_p_sweep(mesh=..., fast=True)`` for random at [8a]'s shape
   over 2 gloo ranks against [8a]'s pickle, written by rank 0 alone, 30 K1
   launches a rank per chunk.  (b) and (c) are bit-equal on every key but
   the metric block's whole-matrix reductions, which the card rounds by
   the run count of a call (``dryrun_multichip.ROUNDED_KEYS``, within
   rtol 1e-5, atol 1e-5, svd_error_scaled on its square).  Per case: wall
   and s/run (or ms/step) sharded and unsharded, ranks, backend, peak
   memory per rank;
12. scale: (a) K1 where the shape needs a cluster of blocks, n = m = 5,000
   (smallest C 2) and 10,000 (smallest C 4), d = 2, bs = 64, pack "none",
   64 batches, at R = 1, 4 and one past the runs the card holds at the
   smallest C (a second wave): against its plain version, bit-equal at
   every C from the smallest that the card schedules, a forced C below it
   (and packed) raising ``ValueError``; ms an epoch, us a step, the bound;
   and at d = 8, n = m = 10,000, R = 2, where only C = 16 fits: against its
   plain version, two launches bit-equal, C = 8 refused;
   (b) ``mfcd_tpu_torch.scripts.scale_demo`` at n = m = 10,000, p = 0.02,
   30 epochs (two ``run_config`` calls): K1 the trainer, 30 launches a
   call at the chosen C, every key finite, accuracy above 0.6 and within
   0.2 of the ground truth's; the first and the steady wall, peak memory
   and, in a third call, the stage spans on the card's clock (the
   recorder's events at their edges); then at
   n = m = 5,000, p = 0.02, 2 epochs, ``run_config`` with K1 against the
   autograd trainer on the card, within [5]'s bound; (c)
   ``mfcd_tpu_torch.scripts.weak_scaling``'s fixed work at 1 and 2 gloo
   ranks sharing the card (and 4 NCCL ranks where there are 4 cards):
   wall, s/run, the collective census (none in the train stage, one
   failure-flag all_reduce and one all_gather_object a chunk, whatever
   its size), results equal to the unsharded bucket's within (b)'s bound
   of [11]; (d) the forward probe (``scripts/graft_entry.py``) on the card
   against the same params on the CPU, within 1e-6 x max|p| + 1e-7;
13. label redundancy at the canonical width: (a) K1 against its plain
   version on hard K = 10's stream (pack "full", 12,500 of 16,384 padded
   batches, R = 2) and soft K = 50's (pack "uij", z = k / 50, 1,250 of
   2,048), two launches and the chosen launch shape bit-equal to C = 1
   and packed, with ms an epoch, us a step, the bound and the plain
   version's ms; (b) ``python3 -m mfcd_tpu_torch.bench --quick`` in a
   subprocess (one JSON line: the JAX bench's metric name, a value above
   0, the card), then the bench's default headline (with its K = 10 kernel
   path), ``--sweep`` and ``--k50`` through ``bench.run_mode`` without the
   autograd child: runs/hour, s/run, 30 K1 launches a call or chunk, peak
   memory per run beside ``run_bytes``, accuracy above 0.6 at the
   canonical configuration and at K = 50, and a K = 50 call with the
   stage spans on the card's clock; (c) ``run_config`` at hard K = 10 (1 epoch)
   with K1 against the autograd trainer on the card, within [5]'s bound,
   and the autograd ms a step; (d) ``parameter_scan_fast`` over the
   notebook's soft K axis (K = 1, 2, 4, 10, 50 at s = 5, wd = 5e-6, 30
   epochs, reps = 2): one chunk a K, 30 K1 launches each, every key
   finite, accuracy above 0.6, peak memory per run under ``run_bytes``,
   s/run by K; then soft K = 10 at 2 epochs
   on the card against the CPU, within [5]'s bound;
14. the epoch shuffle and threefry: (a) at each shape of
   ``ab_shuffle_kernels.SHUFFLE_CASES`` (the canonical run, the bench
   bucket, the bench's sweep chunk, hard K = 10 and 50, scale_demo's
   n = m = 10,000), the fused epoch shuffle S2 over a fresh and a cheap
   epoch (from the epoch's folded keys, as the trainer calls it), the
   keyed PRP S1 at its forms (its three walk modes over one shared row
   of int64 slots, and ``prp_splits``' two calls: a shared key over
   int32 rows with int32 counts, and a key a row over int32 rows with an
   int count at k = 30) and threefry T1's ``bits``, ``fold_in`` and
   ``split``, each bit-equal to its plain version on the card, each with
   its device ms (CUDA events over calls queued behind a spin
   kernel, so the host's issue is not in them) and its host issue ms
   beside the plain version's and the bound (bytes at the memory rate,
   32-bit integer operations at PEAK_INT32_OPS, from the SM count and the
   top SM clock that [1] prints), and the launches of [4]'s call; (b) the
   canonical ``run_config`` with ``train_runs_kernel`` under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync in the
   trainer's epoch loop), 30 S2 and 30 K1 launches a call, s/run, and a
   call with its stage spans on the card's clock; (c) S1 at the calls the main
   path makes: the canonical run, the bench bucket, the bench's sweep,
   hard K = 10 and 50 and scale_demo's configuration run at one epoch
   with S1's arguments recorded (``ab_shuffle_kernels.record_prp_calls``),
   each call replayed as in (a);
15. the validation pass's kernel L1 (``ops/csrc/loss_pass.cu``) against
   its plain version on the card at the hard K = 10 cell's validation
   split (R = 5, 131,072 rows, 100,000 valid) and the canonical one
   (R = 5, 16,384 rows, 10,000 valid), the tables as the trainer passes
   them (``transpose(1, 2)`` views): per-batch and epoch means within
   rtol 1e-5 / atol 1e-6, two passes bit-equal; its device ms a pass
   (queued behind a spin kernel, as in [14]) and host issue ms beside the
   plain version's and the bound (its bytes at the memory rate); and the
   launches of [4]'s call: two a pass, 30 validation passes and one test
   pass; then the test pass, L1's counting variant, at the canonical, hard
   K = 10 and K = 50 test splits (``scripts/ab_test_pass.py``): its count
   and accuracy bit-equal to the plain block path's on the card, its loss
   bit-equal to the loss-only pass's, two launches, and its device, host
   and wall ms beside the eager path's wall ms.

Prints the ``kernels`` JSON line and the nvidia-smi line before the last
line, and as the last line ``{"ok": true, "device": {...}}``.  Exits
non-zero without a result when no CUDA device is present.
"""

from __future__ import annotations

import json
import math
import os
import pickle
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
# 32-bit integer add, logic, shift and funnel shift a clock per SM on
# compute capability 9.0 (the CUDA C++ Programming Guide's arithmetic
# instruction throughput table): a quarter of the float32 rate's 128 FMAs
# counted as 2.  PEAK_INT32_OPS is this card's rate, SMs x INT32_PER_SM x
# the top SM clock, set by ``main`` from the card (``card_int_rate``).
# Logic, shifts and compares issue on the integer ALU pipe alone; adds and
# multiplies the compiler also issues as IMAD on the FMA pipe, 64 a clock
# more (``cuobjdump -sass`` of T1 shows its adds as IMADs).  So
# the operations bound counts the ALU-only operations at this rate: they
# outnumber half of all the integer operations in every count below.
INT32_PER_SM = 64
PEAK_INT32_OPS = None
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
# bench.py's sweep (20 s x 2 weight decays x 3 reps): one parameter_scan_fast
# chunk of this many runs at the canonical shape.
MID_R = 120
# [6] The samplers besides random.  proximity and top_k are integer maps of
# the same tables: bit-equal.  The others select by a float (a CDF, the
# margin window, k-means, SVD norms, cosine neighbours) that the card
# rounds differently from the CPU; one flipped acceptance moves every later
# winner's split slot, so their split rows are compared as a set over
# train, val and test, and their counts.
STRATEGIES = ("proximity", "margin", "variance", "popularity", "top_k",
              "cluster", "user_similarity", "svd")
BIT_EQUAL = ("proximity", "top_k")
SPLIT_ROWS_MIN = 0.99       # share of split rows the card and the CPU share
COUNT_DIFF_MAX = 0.005      # relative difference of the split counts
# [7] The generation modes besides base.  Card against CPU from the same
# keys: the integer intermediates (Watts-Strogatz adjacency, cluster
# assignments) bit-equal; X within GEN_RTOL x max|X| + GEN_ATOL per mode
# (the card's QR, SVD, matmuls and sums round differently); svd's factors
# up to each mode's sign (only the joint sign of (u_k, v_k) is defined),
# within a bound that scales with each run's conditioning, and X against
# the card's own factors; clustered's and gmm's labels shared >= 99 %, X
# where all agree.
GENERATIONS = ("low_rank", "clustered", "structured", "svd", "correlated",
               "graph", "social", "temporal", "hierarchical", "gmm")
GEN_RTOL = 1e-4
GEN_ATOL = 1e-6
LABEL_SHARE_MIN = 0.99
# svd's top singular vectors, card against CPU, in units of eps * s_1 /
# gap_k (L2): the CPU's float32 LAPACK lies a few such units from the
# exact vectors at the canonical shape, the card's float64 solve far less
# (``chip_profile.py``'s ``svd_solvers``).
SVD_C = 10.0
EPS32 = 2.0 ** -24
# [9] AltSVM at MovieLens-100k's users and items, f = 20: K2 against its
# plain version on the card and the CPU at ALT_T_CHECK comparisons (on the
# card the plain version's step is a dozen launches), then at the main
# path's ALT_T (one comparison per rating of ML-100k) against the CPU's
# plain version on the first epoch's inputs, then the model at ALT_T.  K2
# runs the steps out of pick order, each row's writes in pick order, sums
# its dots in its plain version's butterfly order and rounds every
# operation alike (--fmad=false): bit-equal, a gate.
ALT_N, ALT_M, ALT_F = 943, 1682, 20
ALT_T_CHECK = 4096
ALT_T = 100_000
ALT_EPOCHS = 10
ALT_SWEEPS = 3
ALT_ACC_MIN = 0.8
# [10] Chunks: 8 s values x 3 reps in chunks of 2 configs.
CHUNK_GRID = dict(n=1000, m=1000, d=2, p=0.2,
                 s=[0.5, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0], lr=1e-3,
                 weight_decay=5e-6, num_epochs=30, reps=3, max_bucket=2)
# [11] The sharded step: 30 steps at the canonical width and lr / wd; the
# gloo meshes of 2 ranks sharing the card (NCCL takes one rank per card).
MESH_STEPS = 30
MESH_LR, MESH_WD = 1e-3, 5e-6
GLOO_MESHES = ((1, 2, 1), (1, 1, 2), (2, 1, 1))
MESH_TIMEOUT_S = 600
# [12] K1 past one block a run: n = m, d = 2, bs = 64, pack "none"; the
# scale demo, the trainer check at the new shape, weak scaling's ranks and
# the forward probe's bound (the card's and the CPU's sigmoid round apart).
SCALE_ROWS = (5000, 10_000)
D8_ROWS = 10_000   # d = 8, bs = 64: K1 fits only at C = 16
SCALE_BATCHES = 64
SCALE_DEMO = dict(n=10_000, p=0.02, epochs=30)
TRAINER_CHECK = dict(n=5000, m=5000, d=2, p=0.02, s=5.0, lr=1e-3,
                     weight_decay=1e-5, num_epochs=2, reps=1)
WEAK_RANKS = (1, 2)
PROBE_RTOL, PROBE_ATOL = 1e-6, 1e-7
# [13] Label redundancy at the canonical width (n = m = 1000, d = 2,
# bs = 64).  K1's cases, at the streams the main path gives it: (label,
# seed, pack, soft K, padded batches, counts).  Hard K = 10 multiplies the
# training rows by 10 (800,000: 12,500 steps of 16,384 padded batches);
# soft K = 50 keeps 80,000 rows, z = k / 50 as float32 in pack "uij"
# (1,250 steps of the fast path's 2,048).
K_CASES = (("hard K=10", 21, "full", None, 16_384, [800_000, 799_983]),
           ("soft K=50", 22, "uij", 50, 2048, [80_000, 79_990]))
# K1 against the autograd trainer at hard K = 10 (one epoch), and the
# notebook's K axis (cell 5's K values at one s and one wd) on the fast
# path, then soft K = 10 card against CPU.
K_TRAINER_CHECK = dict(n=1000, m=1000, d=2, p=0.2, s=5.0, lr=1e-3,
                       weight_decay=5e-6, num_epochs=1, reps=1, K=10)
K_AXIS = dict(n=1000, m=1000, d=2, p=0.2, s=5.0, K=[1, 2, 4, 10, 50],
              soft_label=True, weight_decay=5e-6, lr=1e-3, num_epochs=30,
              reps=2)
K_CARD_CPU = dict(n=1000, m=1000, d=2, p=0.2, s=[5.0], K=10,
                  soft_label=True, weight_decay=5e-6, lr=1e-3, num_epochs=2,
                  reps=1)
ACC_MIN = 0.6
# [14] The epoch shuffle and threefry on the card: S1, S2 and T1 against
# their plain versions (integer maps: bit-equal) at the main path's shapes,
# ``SHUFFLE_CASES`` of mfcd_tpu_torch/scripts/ab_shuffle_kernels.py (the
# canonical run, the bench bucket, the bench's sweep chunk, hard K = 10 and
# 50, and scale_demo's n = m = 10,000); S2 at bs = 64's tile width, over
# one fresh and one cheap epoch; its ms an epoch is the period's mean (1
# fresh, 3 cheap).
# ALU-only 32-bit integer operations, for the operations bound at
# PEAK_INT32_OPS: a step of the keyed walk (3 rounds of mask, shift, xor,
# mask, and the test's compare and select; its 3 multiplies and 3 adds can
# issue as IMAD), a threefry2x32 hash (20 rotates and 20 xors; its 30 adds
# can issue as IMAD) and a slot's rotation (a compare and a select), or
# S1's start of a slot's exact or inverse walk (the same two).
MIX_OPS, HASH_OPS, SLOT_OPS = 14, 40, 2
# Windows of 20 calls each that a kernel's device and host ms are the
# median of (``ab_shuffle_kernels.queue_ms``).
QUEUE_ROUNDS = 20
# [15] L1 at the cells' validation splits: (label, runs, rows, valid rows a
# run), n = m = 1000, d = 2, bs = 64; its bound per tensor, as K1's loss.
L1_SHAPES = (("hard K=10 val", 5, 131_072, 100_000),
             ("canonical val", 5, 16_384, 10_000))
L1_RTOL, L1_ATOL = 1e-5, 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def make_epoch_inputs(seed, r, n, m, d, bs, num_batches, counts, lrs, mode,
                      device, rows_fn=None, soft_k=None):
    """Random state and a random valid stream, packed as ``mode`` says;
    ``rows_fn(r, rows)`` replaces the random (u, i, j); ``soft_k`` draws
    soft labels, z = k / soft_k (pack "uij" only)."""
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
    if rows_fn is not None:
        u, i, j = (np.asarray(a, np.int32) for a in rows_fn(r, rows))
    z = (g.random((r, rows)) < 0.5).astype(np.float32)
    if soft_k:
        assert mode == "uij"
        z = (g.integers(0, soft_k + 1, (r, rows)) / soft_k).astype(
            np.float32)
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
        pack = ("uij", bn, bm, 0, soft_k or 1)
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


def compare_epoch(inp, label, kernel=None, plain=None, state=None):
    """Kernel vs plain version on the same inputs (default: the fused epoch
    on ``inp["state"]``), every output per tensor; returns (max |diff|, the
    plain call's ms, the kernel's outputs ``(state, loss[, alive])``)."""
    from mfcd_tpu_torch.ops import kernels

    kernel = kernel or kernels.train_epoch
    plain = plain or kernels.train_epoch_reference
    state = inp["state"] if state is None else state
    args = (inp["stream"], inp["lr"], inp["wd"], inp["step0"], inp["count"])
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain(clone_state(state), *args, pack=inp["pack"])
    stop.record()
    got = kernel(clone_state(state), *args, pack=inp["pack"])
    torch.cuda.synchronize()
    worst = check_close(want, got, label)
    return worst, start.elapsed_time(stop), got


def check_close(want, got, label):
    """Per tensor (the six state tensors, the loss, and ``alive`` where the
    call returns it): max |diff| <= KERNEL_RTOL * max|ref| + KERNEL_ATOL;
    returns the largest max |diff|."""
    from mfcd_tpu_torch.ops.kernels import EpochState

    names = EpochState._fields + ("loss", "alive")
    want = tuple(want[0]) + tuple(want[1:])
    got = tuple(got[0]) + tuple(got[1:])
    if len(want) != len(got):
        fail(f"{label}: {len(got)} outputs, expected {len(want)}")
    worst = 0.0
    errs = []
    for name, a, b in zip(names, want, got):
        if not torch.isfinite(b).all():
            fail(f"{label}: non-finite {name} from the kernel")
        err = float((a - b).abs().max())
        scale = float(a.abs().max())
        worst = max(worst, err)
        errs.append(f"{name} {err:.3g}/{scale:.3g}")
        if err > KERNEL_RTOL * scale + KERNEL_ATOL:
            fail(f"{label}: {name} max|diff| {err:.3g} > {KERNEL_RTOL} x "
                 f"max|ref| {scale:.3g} + {KERNEL_ATOL}")
    log(f"  {label}: max|diff|/max|ref| " + ", ".join(errs)
        + f" (bound {KERNEL_RTOL} x max|ref| + {KERNEL_ATOL} per tensor)")
    return worst


def time_ms(fn, warmup: int, reps: int) -> float:
    """Median of per-call CUDA-event times, after ``warmup`` calls, the card
    idle before each: for the plain versions, whose host time is part of
    their cost (the kernels are timed by ``profile_kernel_split.median_ms``
    with the queue kept full)."""
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


def peak_int32_ops(sms: int, clock_mhz: float) -> float:
    """32-bit integer operations a second: ``sms`` SMs at ``clock_mhz``."""
    return sms * INT32_PER_SM * clock_mhz * 1e6


def card_int_rate():
    """(SM count, top SM clock in MHz) of card 0, from
    ``torch.cuda.get_device_properties`` and ``nvidia-smi
    --query-gpu=clocks.max.sm``."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return (torch.cuda.get_device_properties(0).multi_processor_count,
            float(out.stdout.split()[0]))


def bound_ms(nbytes: float, flops: float = 0.0, int_ops: float = 0.0):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    H100's memory rate and the operations, float32 ``flops`` at its float32
    rate plus 32-bit ``int_ops`` at PEAK_INT32_OPS."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    if int_ops:
        if not PEAK_INT32_OPS:
            fail("bound_ms: integer operations before PEAK_INT32_OPS is set")
        t_ops += int_ops / PEAK_INT32_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def executed_steps(inp, bs) -> int:
    count = inp["count"].cpu().numpy().astype(np.int64)
    return int(np.minimum((count + bs - 1) // bs,
                          inp["stream"][0].shape[1]).sum())


def epoch_bound_ms(inp, n, m, d, bs):
    """Least time for one call on these inputs, from the H100 peaks.

    Bytes: the state read and written once, the executed batches' stream
    words read once, the per-run scalars and the loss.  Operations: per
    executed step, bs * (9d + 15) for the rows (forward, BCE, g, scatter)
    plus 16 per element of the dense Adam over (n + m) * d elements."""
    steps = executed_steps(inp, bs)
    r = inp["count"].numel()
    state_bytes = sum(a.numel() * 4 for a in inp["state"])
    stream_bytes = steps * bs * sum(a.element_size() for a in inp["stream"])
    nbytes = 2 * state_bytes + stream_bytes + r * 4 * 5
    flops = steps * (bs * (9 * d + 15) + 16 * (n + m) * d + 6)
    return bound_ms(nbytes, flops)


def variant_bound_ms(inp, name, n, m, d, bs):
    """``epoch_bound_ms`` restricted to the stages a P1 variant keeps, plus
    its keep-alive terms.  Per executed step: contract bs * (4d + 15)
    (gathers, logits, BCE, g, loss) and scatter bs * 5d, which together
    are the fused epoch's bs * (9d + 15); Adam 16 * (n + m) * d + 6; the
    keep-alive terms 5 * bs (loop_only: z * mask and four sums), 9 * bs
    (oh_only: three masked planes and their sums), 2 * bs (no_scatter: sum
    g and sum |g|) and 9d * bs (no_adam: the sum of its 3 * bs * d
    contributions, and |.| and the sum of the 3 * bs * d values read
    back).  Bytes: the stream words, scalars, loss
    and alive; U and V read once from no_scatter on; the whole state read
    and written once by full."""
    if name == "full":
        return epoch_bound_ms(inp, n, m, d, bs)
    steps = executed_steps(inp, bs)
    r = inp["count"].numel()
    nbytes = steps * bs * 4 + r * 4 * 6
    per_step = {"loop_only": 5 * bs, "oh_only": 9 * bs,
                "no_scatter": bs * (4 * d + 15) + 2 * bs,
                "no_adam": bs * (9 * d + 15) + 9 * d * bs}[name]
    if name in ("no_scatter", "no_adam"):
        nbytes += r * (n + m) * d * 4
    return bound_ms(nbytes, steps * per_step)


def factored_bound_ms(inp, d, bs, rows=1024):
    """``epoch_bound_ms`` over P2's tables of ``rows`` rows each, plus the
    add of V's i- and j-sums per element of V."""
    steps = executed_steps(inp, bs)
    r = inp["count"].numel()
    nbytes = 2 * 6 * r * rows * d * 4 + steps * bs * 4 + r * 4 * 5
    flops = steps * (bs * (9 * d + 15) + 16 * 2 * rows * d + rows * d + 6)
    return bound_ms(nbytes, flops)


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


def adversarial_rows(r, rows, u_row=62, v_rows=(124, 125)):
    """Every row of every batch names U row ``u_row``; V alternates
    (i, j) = (a, b), (b, a), ...: one U row and two V rows each named 64
    times per batch of 64, at the edge of a 16-block share (63 rows)."""
    a, b = v_rows
    alt = np.arange(rows) % 2 == 0
    row = lambda x: np.broadcast_to(x, (r, rows))
    return row(np.full(rows, u_row)), row(np.where(alt, a, b)), row(
        np.where(alt, b, a))


def bit_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in
               zip(tuple(a[0]) + (a[1],), tuple(b[0]) + (b[1],)))


def k1_launch_checks(inp, label):
    """Two launches at the chosen launch shape, one at one 512-thread block
    per run and one packed, on the same inputs: all four bit-equal; in pack
    "full", P1's ``full`` at the chosen shape bit-equal to them."""
    from mfcd_tpu_torch.ops import kernel_split as ks
    from mfcd_tpu_torch.ops import kernels

    args = (inp["stream"], inp["lr"], inp["wd"], inp["step0"], inp["count"])
    r, d, n = inp["state"].u_t.shape
    c = kernels.cluster_size(r, n, inp["state"].v_t.shape[2], d,
                             inp["stream"][0].shape[2], inp["count"].device)
    shapes = (c, c, 1, kernels.PACKED)
    outs = [kernels._train_epoch(clone_state(inp["state"]), *args,
                                 pack=inp["pack"], cluster=k)
            for k in shapes]
    torch.cuda.synchronize()
    for k, out in zip(shapes[1:], outs[1:]):
        if not bit_equal(outs[0], out):
            fail(f"{label}: launch shape C={c} and C={k} differ")
    said = ""
    if inp["pack"][0] == "full":
        full = ks._train_epoch_variant(clone_state(inp["state"]), *args,
                                       pack=inp["pack"],
                                       stages=ks.VARIANTS["full"], cluster=c)
        torch.cuda.synchronize()
        if not bit_equal(outs[0], full[:2]):
            fail(f"{label}: P1 full and K1 differ at C={c}")
        said = f"; P1 full at C={c} bit-equal to K1"
    log(f"  {label}: two launches at C={c}, one at C=1 and one packed "
        f"(C={kernels.PACKED}) bit-equal{said}")


def k1_timing(inp, label):
    """K1 at the chosen launch shape, at one 512-thread block per run
    (C = 1), packed, and P1's ``full`` (K1's code built in
    ``epoch_variants.cu``, at its own chosen shape) on the same inputs, in
    turns; returns the entry."""
    from mfcd_tpu_torch.ops import kernel_split as ks
    from mfcd_tpu_torch.ops import kernels
    from mfcd_tpu_torch.scripts.profile_kernel_split import median_ms

    args = (inp["stream"], inp["lr"], inp["wd"], inp["step0"], inp["count"])
    r, num_batches, bs = inp["stream"][0].shape
    d, n = inp["state"].u_t.shape[1:]
    m = inp["state"].v_t.shape[2]
    c = kernels.cluster_size(r, n, m, d, bs, inp["count"].device)
    idx = inp["count"].device.index or 0
    k1 = lambda k: (lambda st: kernels._train_epoch(
        st, *args, pack=inp["pack"], cluster=k))
    calls = {"k1": k1(c), "k1_c1": k1(1), "k1_packed": k1(kernels.PACKED),
             "full": lambda st: ks.train_epoch_variant(
                 st, *args, pack=inp["pack"], stages=ks.VARIANTS["full"])}
    times = {k: [] for k in calls}
    for name in list(calls) + list(calls)[::-1]:
        times[name].append(median_ms(calls[name], inp["state"], warmup=1,
                                     reps=5))
    ms = {k: float(np.median(v)) for k, v in times.items()}
    executed = executed_steps(inp, bs) / r
    occ = lambda k: kernels.epoch_occupancy(n, m, d, bs, k, idx)[0]
    entry = dict(label=label, r=r, bs=bs, cluster=c,
                 threads=kernels.block_threads(c), blocks_per_sm=occ(c),
                 blocks_per_sm_c1=occ(1),
                 blocks_per_sm_packed=occ(kernels.PACKED),
                 ms=ms["k1"], ms_c1=ms["k1_c1"], ms_packed=ms["k1_packed"],
                 full_ms=ms["full"], us_per_step=ms["k1"] * 1e3 / executed,
                 runs_per_s=r / ms["k1"] * 1e3,
                 full_runs_per_s=r / ms["full"] * 1e3)
    log(f"[3] K1 {label} R={r} bs={bs}: C={c} ({entry['threads']} threads, "
        f"{entry['blocks_per_sm']} blocks per SM) {ms['k1']:.4f} ms "
        f"({entry['us_per_step']:.4f} us/step, {entry['runs_per_s']:.1f} "
        f"runs/s); C=1 ({entry['blocks_per_sm_c1']} per SM) "
        f"{ms['k1_c1']:.4f} ms; packed ({entry['blocks_per_sm_packed']} per "
        f"SM) {ms['k1_packed']:.4f} ms; P1 full {ms['full']:.4f} ms "
        f"({entry['full_runs_per_s']:.1f} runs/s); readings "
        + json.dumps(times))
    return entry


def large_r() -> int:
    """Runs per chunk that ``parameter_scan_fast`` picks on this card for
    the reference grid at one p (n = m = 1000, d = 2, p = 0.2, 5 reps)."""
    from mfcd_tpu_torch.core.config import RunConfig
    from mfcd_tpu_torch.sweep import batched
    from mfcd_tpu_torch.sweep.engine import compile_caps

    cfg = RunConfig(n=1000, m=1000, d=2, p=0.2, reps=5)
    return cfg.reps * batched.default_max_bucket(
        cfg, t_cap=compile_caps(cfg)[0], device="cuda")


def k1_phase(dev, n, m, d, bs, nb):
    """[3] K1 against its plain version in every case, the launch checks,
    and its timings at R = 4, 8 and the large R; returns (max |diff| over
    the cases, the R = 4 inputs, the timing entries)."""
    from mfcd_tpu_torch.scripts import profile_kernel_split as pks

    canon = make_epoch_inputs(1, 4, n, m, d, bs, nb,
                              [80000, 80000, 80000, 51234],
                              [1e-3, 3e-3, 1e-3, 1e-2], "full", dev)
    cases = [("canonical R=4 full", canon)]
    cases += [("small " + mode, make_epoch_inputs(
        2, 2, 20, 25, 3, 32, 4, [70, 100], [1e-2, 3e-2], mode, dev))
        for mode in ("full", "uij", "none")]
    cases += [
        ("small bs=1024", make_epoch_inputs(
            11, 2, 20, 25, 3, 1024, 2, [2048, 1500], [1e-2, 3e-2], "full",
            dev)),
        ("canonical shape bs=1024 R=4", make_epoch_inputs(
            12, 4, n, m, d, 1024, 8, [8192, 8192, 8192, 5000],
            [1e-3, 3e-3, 1e-3, 1e-2], "full", dev)),
        ("adversarial R=4", make_epoch_inputs(
            13, 4, n, m, d, bs, 64, [4096] * 3 + [3000],
            [1e-3, 3e-3, 1e-3, 1e-2], "full", dev,
            rows_fn=adversarial_rows)),
    ]
    r8 = pks.canonical_inputs(dev)
    cases.append(("profiler R=8", r8))
    rl = large_r()
    log(f"[3] large R: parameter_scan_fast chunks n = m = 1000, d = 2, "
        f"p = 0.2, 5 reps into {rl} runs on this card")
    g = np.random.default_rng(14)
    for r in (MID_R, rl):
        cases.append((f"R={r} (64 batches)", make_epoch_inputs(
            14, r, n, m, d, bs, 64, [4096] * (r - 1) + [3000],
            list(10.0 ** g.uniform(-3.5, -2, r)), "full", dev)))
    max_err = 0.0
    for label, inp in cases:
        max_err = max(max_err, compare_epoch(inp, label)[0])
        k1_launch_checks(inp, label)

    epoch = lambda seed, r: make_epoch_inputs(
        seed, r, n, m, d, bs, -(-80000 // bs), [80000] * r, [1e-3] * r,
        "full", dev)
    timings = [k1_timing(canon, "canonical"), k1_timing(r8, "profiler"),
               k1_timing(epoch(16, MID_R), "bench sweep"),
               k1_timing(epoch(15, rl), "large"),
               k1_timing(dict(cases)["adversarial R=4"], "adversarial"),
               k1_timing(make_epoch_inputs(
                   17, 2, 20, 25, 3, 1024, 64, [65536, 60000], [1e-2, 3e-2],
                   "full", dev), "small bs=1024")]
    return max_err, canon, timings


def split_shapes_check(inp, label, kernel, plain, state, cluster):
    """[3b] One P1 / P2 kernel against its plain version on the same inputs
    at its chosen launch shape, at C = 1 and packed (each within the
    bound), state and loss bit-equal across the three; returns (max |diff|,
    the plain call's ms)."""
    from mfcd_tpu_torch.ops import kernels

    args = (inp["stream"], inp["lr"], inp["wd"], inp["step0"], inp["count"])
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain(clone_state(state), *args, pack=inp["pack"])
    stop.record()
    shapes = (cluster, 1, kernels.PACKED)
    outs = [kernel(clone_state(state), *args, pack=inp["pack"], cluster=k)
            for k in shapes]
    torch.cuda.synchronize()
    worst = max(check_close(want, got, f"{label} C={k}")
                for k, got in zip(shapes, outs))
    for k, out in zip(shapes[1:], outs[1:]):
        if not bit_equal(outs[0], out[:2]):
            fail(f"{label}: state or loss at C={cluster} and C={k} differ")
    log(f"  {label}: state and loss bit-equal at C={cluster}, C=1 and "
        f"packed")
    return worst, start.elapsed_time(stop)


def kernel_split_phase(dev, n, m, d, bs):
    """[3b] P1's variants and P2 against their plain versions at the
    profiler's shape and three launch shapes, P2 against the fused epoch,
    then the profiler's path with its launch counts, and the split at
    C = 1; returns the ``kernels`` entries."""
    import functools

    from mfcd_tpu_torch.ops import kernel_split as ks
    from mfcd_tpu_torch.ops import kernels
    from mfcd_tpu_torch.scripts import profile_kernel_split as pks

    nb = -(-pks.ROWS // bs)
    r = pks.R
    inp = make_epoch_inputs(3, r, n, m, d, bs, nb, [pks.ROWS] * r,
                            [1e-3, 3e-3] * (r // 2), "full", dev)
    errs, plain = {}, {}
    for name, stages in ks.VARIANTS.items():
        c = kernels.cluster_size(r, n, m, d, bs, dev)
        errs[name], plain[name] = split_shapes_check(
            inp, f"P1 {name} R={r}",
            functools.partial(ks._train_epoch_variant, stages=stages),
            functools.partial(ks.train_epoch_variant_reference,
                              stages=stages), inp["state"], c)
    state_f = type(inp["state"])(*(ks.to_factored_layout(a)
                                   for a in inp["state"]))
    rows = ks.FACTORED_ROWS
    c = kernels.cluster_size(r, rows, rows, d, bs, dev)
    errs["factored"], plain["factored"] = split_shapes_check(
        inp, f"P2 factored R={r}", ks._train_epoch_factored,
        ks.train_epoch_factored_reference, state_f, c)
    args = (inp["stream"], inp["lr"], inp["wd"], inp["step0"], inp["count"])
    fac_state, fac_loss = ks.train_epoch_factored(clone_state(state_f), *args,
                                                  pack=inp["pack"])
    k1 = kernels.train_epoch(clone_state(inp["state"]), *args,
                             pack=inp["pack"])
    torch.cuda.synchronize()
    check_close(k1, (tuple(ks.from_factored_layout(a, d, k) for a, k in
                           zip(fac_state, (n, m, n, n, m, m))), fac_loss),
                f"P2 vs fused epoch R={r}")

    # The profiler's own path, as `python3 -m
    # mfcd_tpu_torch.scripts.profile_kernel_split` runs it.
    prof_inp = pks.canonical_inputs(dev)
    torch.cuda.synchronize()
    for name in ks.VARIANT_LAUNCHES:
        ks.VARIANT_LAUNCHES[name] = 0
    ks.FACTORED_LAUNCHES = 0
    prof = pks.profile(prof_inp)
    torch.cuda.synchronize()
    launches = dict(ks.VARIANT_LAUNCHES, factored=ks.FACTORED_LAUNCHES)
    for name, count in launches.items():
        if count == 0:
            fail(f"the profiler launched {name} no time")
    prof_c1 = pks.profile(prof_inp, cluster=1)
    for label, out in (("chosen shapes", prof), ("C = 1", prof_c1)):
        if not out["variants"]["full_factored"]["allclose_vs_full"]:
            fail(f"profiler ({label}): P2's final U is not allclose to "
                 f"full's")
        v = out["variants"]
        log(f"[3b] kernel split R={r}, {nb} steps, {label}: "
            + ", ".join(f"{k} C={v[k]['cluster']} "
                        f"{v[k]['ms_per_epoch']:.4f} ms "
                        f"({v[k]['us_per_step']:.4f} us/step)" for k in v)
            + "; stage deltas us/step: "
            + ", ".join(f"{k} {x:.4f}" for k, x in
                        out["stage_deltas_us"].items())
            + f"; P2 max|U - full U| "
            f"{v['full_factored']['max_delta_vs_full']:.3g}; K1 C="
            f"{out['k1']['cluster']} {out['k1']['ms_per_epoch']:.4f} ms "
            f"({out['k1']['us_per_step']:.4f} us/step), full - K1 "
            f"{out['k1']['full_minus_k1_us_per_step']:.4f} us/step")
    log("[3b] split JSON: " + json.dumps({"chosen": prof, "c1": prof_c1}))

    v = prof["variants"]
    entries = []
    for name in ks.VARIANTS:
        b, by = variant_bound_ms(prof_inp, name, n, m, d, bs)
        entries.append(dict(
            name=f"epoch_variant:{name}", route="cuda",
            source="mfcd_tpu_torch/ops/csrc/epoch_variants.cu",
            replaces="scripts/profile_kernel_split.py:64",
            launches=launches[name], max_abs_err=errs[name],
            ms=v[name]["ms_per_epoch"], plain_ms=plain[name], bound_ms=b,
            bound_by=by, library_ms=None, cluster=v[name]["cluster"],
            ms_c1=prof_c1["variants"][name]["ms_per_epoch"]))
        log(f"  P1 {name}: plain {plain[name]:.2f} ms, bound {b:.6f} ms "
            f"({by}), {launches[name]} launches")
    b, by = factored_bound_ms(prof_inp, d, bs)
    entries.append(dict(
        name="epoch_factored", route="cuda",
        source="mfcd_tpu_torch/ops/csrc/epoch_variants.cu",
        replaces="scripts/profile_kernel_split.py:329",
        launches=launches["factored"], max_abs_err=errs["factored"],
        ms=v["full_factored"]["ms_per_epoch"], plain_ms=plain["factored"],
        bound_ms=b, bound_by=by, library_ms=None,
        cluster=v["full_factored"]["cluster"],
        ms_c1=prof_c1["variants"]["full_factored"]["ms_per_epoch"]))
    log(f"  P2 factored: plain {plain['factored']:.2f} ms, bound {b:.6f} ms "
        f"({by}), {launches['factored']} launches")
    return entries


def fast_path_phase():
    """[4b] ``parameter_scan_fast`` on the bench bucket against the
    sequential scan of the same grid."""
    import mfcd_tpu_torch
    from mfcd_tpu_torch.core.config import RunConfig
    from mfcd_tpu_torch.core.results import validate_schema
    from mfcd_tpu_torch.ops import kernels
    from mfcd_tpu_torch.sweep import batched
    from mfcd_tpu_torch.sweep.engine import compile_caps

    grid = dict(CANON, s=[5.0, 6.0])
    runs = grid["reps"] * len(grid["s"])
    with tempfile.TemporaryDirectory(prefix="mfcd_chip_smoke_") as tmp:
        save_path = os.path.join(tmp, "fast.pkl")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.EPOCH_LAUNCHES = 0
        t0 = time.perf_counter()
        out = mfcd_tpu_torch.parameter_scan_fast(save_path=save_path,
                                                 **grid)
        torch.cuda.synchronize()
        wall_fast = time.perf_counter() - t0
        launches = kernels.EPOCH_LAUNCHES
        peak = torch.cuda.max_memory_allocated()
        with open(save_path, "rb") as f:
            saved = pickle.load(f)
    if launches != grid["num_epochs"]:
        fail(f"fast path launched the epoch kernel {launches} times, "
             f"expected {grid['num_epochs']} (one chunk of {runs} runs)")
    if out != [] or [e["params"]["s"] for e in saved] != grid["s"]:
        fail("fast path pickle protocol: expected both configs, in order")
    for e in saved:
        problems = validate_schema(e["results"])
        if problems:
            fail(f"fast path schema: {problems}")
        if not all_finite(e["results"]):
            fail("fast path: non-finite values in the results")
    t0 = time.perf_counter()
    seq = mfcd_tpu_torch.parameter_scan(**grid)
    torch.cuda.synchronize()
    wall_seq = time.perf_counter() - t0
    worst = {}
    for a, b in zip(seq, saved):
        for k, x in compare_results(a["results"], b["results"],
                                    "fast vs sequential").items():
            worst[k] = max(worst.get(k, 0.0), x)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    cfg = RunConfig(**{k: (v[0] if isinstance(v, list) else v)
                       for k, v in grid.items()})
    est = batched.run_bytes(cfg, t_cap=compile_caps(cfg)[0])
    log(f"[4b] fast path: parameter_scan_fast, {runs} runs in "
        f"{wall_fast:.3f} s ({wall_fast / runs:.4f} s/run), {launches} "
        f"kernel launches; sequential parameter_scan {wall_seq:.3f} s "
        f"({wall_seq / runs:.4f} s/run); 23 keys within rtol "
        f"{CARD_CPU_RTOL}, atol {CARD_CPU_ATOL}, largest |diff| "
        + ", ".join(f"{k} {x:.3g}" for k, x in top)
        + f"; peak device memory {peak / runs / 1e6:.1f} MB/run, "
        f"estimated {est / 1e6:.1f} MB/run")
    return dict(entries=saved, wall=wall_fast, runs=runs, peak=peak)


def _split_rows(sp, r):
    """Run ``r``'s valid split rows as packed int64 keys, train then val
    then test; and the three counts."""
    rows, counts = [], []
    for f in ("train", "val", "test"):
        c = int(getattr(sp, f + "_count")[r])
        t = getattr(sp, f)[r, :c].to(torch.int64).cpu()
        rows.append((t[:, 0] * 2**21 + t[:, 1]) * 2**21 + t[:, 2])
        counts.append(c)
    return torch.cat(rows).numpy(), counts


def sampler_phase(dev):
    """[6a] ``sample_and_split`` on the card and on the CPU at the canonical
    shape, same X and streams, per strategy; returns each strategy's path,
    warm card ms per run, cascade passes and blocks, and sample-stage peak
    bytes per run."""
    from mfcd_tpu_torch.core import prng, rng
    from mfcd_tpu_torch.core.config import RunConfig
    from mfcd_tpu_torch.data.btl import sample_and_split
    from mfcd_tpu_torch.genx import generate_x
    from mfcd_tpu_torch.models.mf import init_params
    from mfcd_tpu_torch.sampling import prp, strategies
    from mfcd_tpu_torch.sweep import batched
    from mfcd_tpu_torch.sweep.engine import compile_caps

    reps, info = 2, {}
    for strategy in STRATEGIES:
        cfg = RunConfig(n=CANON["n"], m=CANON["m"], d=CANON["d"],
                        p=CANON["p"], strategy=strategy, reps=reps)
        sh = cfg.shapes()
        t_cap, extra_cap = compile_caps(cfg)
        exact = (sh.num_triplets, sh.extra_test_triplets) == (t_cap,
                                                              extra_cap)
        budgets = lambda v, d: None if exact else torch.full(
            (reps,), v, dtype=torch.int32, device=d)

        def stage(d, x=None):
            keys = rng.rep_keys(rng.config_key(
                prng.key(0, device=d), 0)[None], reps).reshape(reps, 2)
            streams = rng.rep_streams(keys)
            if x is None:
                x = generate_x(streams["x_gen"], cfg.n, cfg.m, cfg.d)
            sp = sample_and_split(
                streams, x, t_cap, extra_cap, strategy,
                budget=budgets(sh.num_triplets, d),
                extra_budget=budgets(sh.extra_test_triplets, d))
            init_params(streams["init"], cfg.n, cfg.m, cfg.d)
            return x, sp

        x, card = stage(dev)                         # warm-up, and the result
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        passes, blocks = strategies.CASCADE_PASSES, strategies.CASCADE_BLOCKS
        t0 = time.perf_counter()
        stage(dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        passes = strategies.CASCADE_PASSES - passes
        blocks = strategies.CASCADE_BLOCKS - blocks
        peak = (torch.cuda.max_memory_allocated() - base) / reps
        t0 = time.perf_counter()
        _, cpu = stage(torch.device("cpu"), x.cpu())
        cpu_s = time.perf_counter() - t0

        shared, positional, count_diff = 1.0, 1.0, 0.0
        for r in range(reps):
            if strategy in BIT_EQUAL:
                for f in card._fields[1:]:
                    if not torch.equal(getattr(card, f)[r].cpu(),
                                       getattr(cpu, f)[r]):
                        fail(f"[6a] {strategy}: card and CPU {f} differ")
            a, ca = _split_rows(card, r)
            b, cb = _split_rows(cpu, r)
            shared = min(shared, len(np.intersect1d(a, b)) / max(len(b), 1))
            positional = min(positional, float(np.mean(a == b))
                             if len(a) == len(b) else 0.0)
            count_diff = max(count_diff, max(abs(p - q) / max(q, 1)
                                             for p, q in zip(ca, cb)))
            if ca[2] < 500:
                fail(f"[6a] {strategy}: {ca[2]} test labels, fewer than 500")
        if shared < SPLIT_ROWS_MIN or count_diff > COUNT_DIFF_MAX:
            fail(f"[6a] {strategy}: card and CPU share {shared:.5f} of the "
                 f"split rows (bound {SPLIT_ROWS_MIN}), counts differ by "
                 f"{count_diff:.5f} (bound {COUNT_DIFF_MAX})")
        kind = prp.fast_path_kind(strategy, cfg.n, cfg.m, t_cap, extra_cap)
        path = {"prefix": "prefix", "distinct": "distinct"}.get(kind,
                                                                "overdraw")
        if strategy == "user_similarity":
            _, tk = strategies.user_similarity_dims(cfg.n, cfg.m, t_cap)
            attempts = strategies.plan_overdraw(strategy, t_cap, cfg.n, cfg.m)
            nblk = strategies.user_similarity_blocks(attempts, tk)[1]
            path += ", blocked" if nblk > 1 else ", direct"
        est = batched.sampler_bytes(cfg, t_cap)
        info[strategy] = dict(path=path, sample_ms=ms, passes=passes,
                              blocks=blocks, sample_peak=peak,
                              sample_est=est)
        log(f"[6a] {strategy}: {path}; sample stage {ms:.2f} ms/run on the "
            f"card (warm; CPU {cpu_s:.2f} s for {reps} runs); card vs CPU "
            f"{'bit-equal, ' if strategy in BIT_EQUAL else ''}split rows "
            f"shared {shared:.5f}, equal in place {positional:.5f}, counts "
            f"within {count_diff:.5f}; cascade {passes} passes, {blocks} "
            f"blocks; sample-stage peak {peak / 1e6:.1f} MB/run, estimated "
            f"{est / 1e6:.1f} MB/run")
    return info


def fast_scan_by_chunk(grid, field, phase):
    """``parameter_scan_fast(**grid)`` on the card, each chunk's wall, peak
    memory per run, counts against their budgets, cascade passes and
    blocks and fewest test labels recorded.  Fails unless the epoch kernel
    launched once per epoch per chunk, each value of ``grid[field]`` took
    one chunk, every result has the schema and finite values, no count is
    above its target and every run has at least 500 test labels.  A
    chunk's ``peak`` counts what the process held before it, ``own_peak``
    only what the chunk added.  Returns
    (the scan's results, results by value, chunks by value, launches,
    wall)."""
    import mfcd_tpu_torch
    from mfcd_tpu_torch.core.results import validate_schema
    from mfcd_tpu_torch.ops import kernels
    from mfcd_tpu_torch.sampling import strategies
    from mfcd_tpu_torch.sweep import batched, engine

    chunks = []
    device_run = batched._run_bucket_device
    label = engine.label_splits

    def timed_run(cfg, keys, *args, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        passes, blocks = strategies.CASCADE_PASSES, strategies.CASCADE_BLOCKS
        t0 = time.perf_counter()
        out = device_run(cfg, keys, *args, **kw)
        torch.cuda.synchronize()
        runs = keys.shape[0] * cfg.reps
        chunks.append(dict(
            cfg=cfg, runs=runs,
            s=time.perf_counter() - t0,
            peak=torch.cuda.max_memory_allocated() / runs,
            own_peak=(torch.cuda.max_memory_allocated() - held) / runs,
            counts=out["sample_count"].reshape(-1).tolist(),
            budgets=np.repeat(kw["budgets"], cfg.reps).tolist(),
            passes=strategies.CASCADE_PASSES - passes,
            blocks=strategies.CASCADE_BLOCKS - blocks,
            test_labels=min_test.pop()))
        return out

    min_test = []

    def labels(streams, x, splits, *args):
        out = label(streams, x, splits, *args)
        min_test.append(int(out[2].count.min()))
        return out

    batched._run_bucket_device, engine.label_splits = timed_run, labels
    try:
        torch.cuda.synchronize()
        kernels.EPOCH_LAUNCHES = 0
        t0 = time.perf_counter()
        fast = mfcd_tpu_torch.parameter_scan_fast(**grid)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.EPOCH_LAUNCHES
    finally:
        batched._run_bucket_device, engine.label_splits = device_run, label
    if launches != grid["num_epochs"] * len(chunks):
        fail(f"{phase} {launches} epoch kernel launches for {len(chunks)} "
             f"chunks, expected {grid['num_epochs']} per chunk")
    values = [getattr(c["cfg"], field) for c in chunks]
    if sorted(values) != sorted(grid[field]):
        fail(f"{phase} chunks {values}")
    by_value = {}
    for e in fast:
        value = e["params"][field]
        problems = validate_schema(e["results"])
        if problems:
            fail(f"{phase} {value} schema: {problems}")
        if not all_finite(e["results"]):
            fail(f"{phase} {value}: non-finite values in the results")
        by_value[value] = e["results"]
    for value, c in zip(values, chunks):
        if any(n > b for n, b in zip(c["counts"], c["budgets"])):
            fail(f"{phase} {value}: counts {c['counts']} above the target "
                 f"{c['budgets']}")
        if c["test_labels"] < 500:
            fail(f"{phase} {value}: {c['test_labels']} test labels")
    return fast, by_value, dict(zip(values, chunks)), launches, wall


def strategy_scan_phase(info, smi):
    """[6b] ``parameter_scan_fast`` over the eight strategies, then [6c]
    the sequential scan for user_similarity and margin against it."""
    import mfcd_tpu_torch
    from mfcd_tpu_torch.sweep import batched, engine
    from mfcd_tpu_torch.utils.io import append_results

    grid = dict(CANON, s=5.0, strategy=list(STRATEGIES))
    fast, by_strategy, chunks, launches, wall = fast_scan_by_chunk(
        grid, "strategy", "[6b]")
    for strategy, c in chunks.items():
        est = batched.run_bytes(c["cfg"], engine.compile_caps(c["cfg"])[0])
        acc = float(np.mean(by_strategy[strategy]["accuracy"]))
        a = info[strategy]
        log(f"[6] {strategy}: {a['path']}; sample stage "
            f"{a['sample_ms']:.2f} ms/run; {c['s'] / c['runs']:.4f} s/run in "
            f"parameter_scan_fast; count {min(c['counts'])}-"
            f"{max(c['counts'])} of {c['budgets'][0]}; mean accuracy "
            f"{acc:.4f}; at least {c['test_labels']} test labels; cascade "
            f"{c['passes']} passes, {c['blocks']} blocks; peak "
            f"{c['peak'] / 1e6:.1f} MB/run, estimated {est / 1e6:.1f} "
            f"MB/run; {smi}")
    log(f"[6b] parameter_scan_fast: {len(STRATEGIES)} strategies, "
        f"{len(chunks)} chunks of {CANON['reps']} runs in {wall:.3f} s, "
        f"{launches} epoch kernel launches")

    # The sequential scan over the same grid (so each configuration keeps
    # its global index and keys), resuming from a file that holds the other
    # six strategies: it runs user_similarity and margin only.
    seq_only = ("user_similarity", "margin")
    with tempfile.TemporaryDirectory(prefix="mfcd_chip_smoke_") as tmp:
        save_path = os.path.join(tmp, "seq.pkl")
        append_results(save_path, [e for e in fast if e["params"]["strategy"]
                                   not in seq_only])
        t0 = time.perf_counter()
        mfcd_tpu_torch.parameter_scan(save_path=save_path, resume=True,
                                      **grid)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(save_path, "rb") as f:
            seq = {e["params"]["strategy"]: e["results"]
                   for e in pickle.load(f)}
    for strategy in seq_only:
        w = compare_results(seq[strategy], by_strategy[strategy],
                            f"[6c] {strategy} sequential vs fast")
        top = max(w.items(), key=lambda kv: kv[1])
        log(f"[6c] {strategy}: parameter_scan (resumed over the same grid), "
            f"23 keys within rtol {CARD_CPU_RTOL}, atol {CARD_CPU_ATOL} of "
            f"parameter_scan_fast (largest |diff| {top[0]} {top[1]:.3g})")
    log(f"[6c] parameter_scan: {len(seq_only)} configurations x "
        f"{CANON['reps']} runs in {wall:.3f} s "
        f"({wall / (len(seq_only) * CANON['reps']):.4f} s/run)")
    return launches


def _runs_keys(device, reps):
    """The ``x_gen`` keys of config 0's first ``reps`` runs (seed 0)."""
    from mfcd_tpu_torch.core import prng, rng

    keys = rng.rep_keys(rng.config_key(prng.key(0, device=device), 0)[None],
                        reps).reshape(reps, 2)
    return rng.rep_streams(keys)["x_gen"]


def _within(got, want, label, rtol=GEN_RTOL, atol=GEN_ATOL):
    """max|got - want| <= rtol * max|want| + atol, else fail; returns (max
    |diff|, max|want|)."""
    err = float((got.cpu() - want).abs().max())
    scale = float(want.abs().max())
    if not torch.isfinite(got).all():
        fail(f"{label}: non-finite values on the card")
    if err > rtol * scale + atol:
        fail(f"{label}: max|diff| {err:.3g} > {rtol} x max|ref| "
             f"{scale:.3g} + {atol}")
    return err, scale


def _label_share(a, b) -> float:
    return float((a.cpu() == b).to(torch.float64).mean())


def generation_check(mode, kc, kp, x_card, x_cpu, n, m, d):
    """[7a] card against CPU for one mode, from keys ``kc`` (card) and
    ``kp`` (CPU): returns the line's check text."""
    from mfcd_tpu_torch.core import prng
    from mfcd_tpu_torch.genx import clusters, generators, graphs

    label = f"[7a] {mode}"
    if mode in ("graph", "social"):
        sub = lambda k: prng.split(k, 5 if mode == "graph" else 3)[..., 2, :]
        a = graphs.watts_strogatz_adjacency(sub(kc), n)
        b = graphs.watts_strogatz_adjacency(sub(kp), n)
        if not torch.equal(a.cpu(), b):
            fail(f"{label}: the Watts-Strogatz adjacency differs")
        text = f"adjacency bit-equal ({int(b.sum())} entries)"
    elif mode in ("structured", "hierarchical"):
        size = m if mode == "structured" else n
        sub = lambda k: prng.split(k, 4)[..., 1, :]
        a, b = (prng.randint(sub(k), (size,), 0, 5) for k in (kc, kp))
        if not torch.equal(a.cpu(), b):
            fail(f"{label}: the cluster assignments differ")
        text = "assignments bit-equal"
    elif mode == "svd":
        return svd_check(label, kc, kp, x_card, n, m, d)
    elif mode == "clustered":
        def labels(k):
            kx, kk = prng.split(k).unbind(-2)
            x = generators.generate_base(kx, n, m, d)
            return clusters.kmeans(kk, x.transpose(-1, -2), 5)[0]
        share = _label_share(labels(kc), labels(kp))
        if share < LABEL_SHARE_MIN:
            fail(f"{label}: card and CPU share {share:.5f} of the item "
                 f"labels (bound {LABEL_SHARE_MIN})")
        text = f"item labels shared {share:.5f}"
        if share < 1.0:
            return text + "; X not compared (labels differ)"
    elif mode == "gmm":
        def labels(k):
            k1, k2, k3, k4 = prng.split(k, 4).unbind(-2)
            return torch.cat([
                clusters.gmm_fit_predict(k3, prng.normal(k1, (n, d)), 5)[0],
                clusters.gmm_fit_predict(k4, prng.normal(k2, (m, d)), 5)[0]],
                dim=-1)
        share = _label_share(labels(kc), labels(kp))
        if share < LABEL_SHARE_MIN:
            fail(f"{label}: card and CPU share {share:.5f} of the user and "
                 f"item labels (bound {LABEL_SHARE_MIN})")
        text = f"user and item labels shared {share:.5f}"
        if share < 1.0:
            return text + "; X not compared (labels differ)"
    else:
        text = "floats only"
    err, scale = _within(x_card, x_cpu, f"{label} X")
    return text + f"; X max|diff| {err:.3g} of max|X| {scale:.3g}"


def svd_check(label, kc, kp, x_card, n, m, d):
    """[7a] svd: the top-d singular vectors up to each mode's sign, each
    within SVD_C * eps * s_1 / gap_k (L2) of the CPU's, where gap_k is the
    distance from s_k to its nearest neighbour (the CPU's float32 LAPACK
    itself lies a few such units from the exact vectors); the singular
    values within GEN_RTOL * s_1; and the card's X, in every run, within
    GEN_RTOL * max|X| + GEN_ATOL of U V^T assembled on the CPU from the
    card's factors and the CPU's noise draws (X follows the sign each
    solver picks, so the two solvers' X differ where a mode flipped)."""
    from mfcd_tpu_torch.core import prng
    from mfcd_tpu_torch.genx import generators

    uc, sc, vc = (a.cpu() for a in generators.svd_modes(kc, n, m, d))
    up, sp, vp = generators.svd_modes(kp, n, m, d)
    sign = torch.sign(torch.sum(uc * up, dim=-2, keepdim=True))  # [R, 1, d]
    s = sp.to(torch.float64)
    above = torch.cat([torch.full_like(s[:, :1], math.inf),
                       s[:, :d - 1] - s[:, 1:d]], dim=-1)
    gap = torch.minimum(above, s[:, :d] - s[:, 1:d + 1])
    err = torch.maximum((uc * sign - up).norm(dim=-2),
                        (vc * sign - vp).norm(dim=-2)).to(torch.float64)
    units = float((err / (EPS32 * s[:, :1] / gap)).max())
    if units > SVD_C:
        fail(f"{label}: singular vectors {units:.3g} x eps s_1 / gap from "
             f"the CPU's (bound {SVD_C})")
    _within(sc, sp, f"{label} singular values", atol=0.0)
    _, k2, k3 = prng.split(kp, 3).unbind(-2)
    sq = torch.sqrt(sc[..., :d]).unsqueeze(-2)
    u = uc * sq + 0.1 * prng.normal(k2, (n, d))
    v = vc * sq + 0.1 * prng.normal(k3, (m, d))
    x_err, scale = _within(x_card, u @ v.transpose(-1, -2), f"{label} X")
    return (f"{int((sign < 0).sum())} of {sign.numel()} modes flipped sign; "
            f"vectors within {units:.3g} x eps s_1 / gap of the CPU's "
            f"(bound {SVD_C}; relative gaps "
            + ", ".join(f"{g:.4f}" for g in (gap / s[:, :1]).flatten())
            + f"); X max|diff| {x_err:.3g} of max|X| {scale:.3g} against "
            f"the card's factors assembled on the CPU")


def generation_phase(dev):
    """[7a] ``generate_x`` for the ten modes besides ``base`` at the
    canonical shape, R = 2, on the card and on the CPU from the same keys;
    returns each mode's warm card ms per run and generation peak bytes per
    run."""
    from mfcd_tpu_torch.core.config import RunConfig
    from mfcd_tpu_torch.genx import generate_x
    from mfcd_tpu_torch.sweep import batched

    n, m, d, reps = CANON["n"], CANON["m"], CANON["d"], 2
    kc, kp = _runs_keys(dev, reps), _runs_keys(torch.device("cpu"), reps)
    info = {}
    for mode in GENERATIONS:
        x_card = generate_x(kc, n, m, d, mode)                     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        x_card = generate_x(kc, n, m, d, mode)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        peak = (torch.cuda.max_memory_allocated() - base) / reps
        t0 = time.perf_counter()
        x_cpu = generate_x(kp, n, m, d, mode)
        cpu_s = time.perf_counter() - t0
        if tuple(x_card.shape) != (reps, n, m):
            fail(f"[7a] {mode}: X has shape {tuple(x_card.shape)}")
        text = generation_check(mode, kc, kp, x_card, x_cpu, n, m, d)
        est = batched.generation_bytes(RunConfig(
            n=n, m=m, d=d, generation=mode)) + n * m * 4
        info[mode] = dict(ms=ms, peak=peak)
        log(f"[7a] {mode}: {ms:.2f} ms/run on the card (warm; CPU "
            f"{cpu_s:.2f} s for {reps} runs); {text}; generation peak "
            f"{peak / 1e6:.1f} MB/run, X and generation_bytes "
            f"{est / 1e6:.1f} MB/run")
    return info


def generation_scan_phase(gen_info, smi):
    """[7b] ``parameter_scan_fast`` over the ten modes, one shape bucket
    each; fails if a chunk's peak memory per run is above ``run_bytes``."""
    from mfcd_tpu_torch.sweep import batched, engine

    grid = dict(CANON, s=5.0, generation=list(GENERATIONS))
    _, by_mode, chunks, launches, wall = fast_scan_by_chunk(
        grid, "generation", "[7b]")
    for mode, c in chunks.items():
        est = batched.run_bytes(c["cfg"], engine.compile_caps(c["cfg"])[0])
        res = by_mode[mode]
        log(f"[7] {mode}: generation {gen_info[mode]['ms']:.2f} ms/run; "
            f"{c['s'] / c['runs']:.4f} s/run in parameter_scan_fast; count "
            f"{min(c['counts'])}-{max(c['counts'])} of {c['budgets'][0]}; "
            f"mean accuracy {float(np.mean(res['accuracy'])):.4f}, "
            f"gt_accuracy {float(np.mean(res['gt_accuracy'])):.4f}; at "
            f"least {c['test_labels']} test labels; peak "
            f"{c['peak'] / 1e6:.1f} MB/run, estimated {est / 1e6:.1f} "
            f"MB/run; {smi}")
        if c["peak"] > est:
            fail(f"[7b] {mode}: peak {c['peak'] / 1e6:.1f} MB/run above "
                 f"run_bytes's {est / 1e6:.1f} MB/run")
    log(f"[7b] parameter_scan_fast: {len(GENERATIONS)} generation modes, "
        f"{len(chunks)} chunks of {CANON['reps']} runs in {wall:.3f} s, "
        f"{launches} epoch kernel launches")
    return launches


def ground_truth_phase():
    """[7c] ``parameter_scan_ground_truth`` on the card against the CPU
    (base over s and p, and one gmm configuration), then
    ``evaluate_ground_truth`` at reps = 4 timed; no epoch kernel launch."""
    import mfcd_tpu_torch
    from mfcd_tpu_torch.ops import kernels

    shape = dict(n=CANON["n"], m=CANON["m"], d=CANON["d"])
    scans = [dict(shape, s=[1.0, 5.0], p=[0.05, 0.2], reps=2),
             dict(shape, s=5.0, p=CANON["p"], reps=2, generation="gmm")]
    torch.cuda.synchronize()
    kernels.EPOCH_LAUNCHES = 0
    worst, configs = 0.0, 0
    for grid in scans:
        t0 = time.perf_counter()
        card = mfcd_tpu_torch.parameter_scan_ground_truth(**grid)
        t_card = time.perf_counter() - t0
        cpu = mfcd_tpu_torch.parameter_scan_ground_truth(device="cpu",
                                                         **grid)
        for a, b in zip(card, cpu):
            if a["params"] != b["params"]:
                fail(f"[7c] params {a['params']} vs {b['params']}")
            for k in ("gt_loss", "gt_accuracy"):
                x = np.asarray(a["results"][k], np.float64)
                y = np.asarray(b["results"][k], np.float64)
                if not (np.all(np.isfinite(x)) and np.allclose(
                        x, y, rtol=CARD_CPU_RTOL, atol=CARD_CPU_ATOL)):
                    fail(f"[7c] {a['params']}: {k} card {x} vs CPU {y}")
                worst = max(worst, float(np.abs(x - y).max()))
        configs += len(card)
        mode = grid.get("generation", "base")
        log(f"[7c] parameter_scan_ground_truth {mode}: {len(card)} "
            f"configs x {grid['reps']} runs in "
            f"{t_card:.3f} s on the card; gt_accuracy "
            + ", ".join(f"{np.mean(e['results']['gt_accuracy']):.4f}"
                        for e in card))
    reps = CANON["reps"]
    mfcd_tpu_torch.evaluate_ground_truth(p=CANON["p"], s=5.0, reps=reps,
                                         **shape)                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, accs = mfcd_tpu_torch.evaluate_ground_truth(
        p=CANON["p"], s=5.0, reps=reps, **shape)
    torch.cuda.synchronize()
    s_run = (time.perf_counter() - t0) / reps
    if kernels.EPOCH_LAUNCHES:
        fail(f"[7c] the ground truth launched the epoch kernel "
             f"{kernels.EPOCH_LAUNCHES} times")
    log(f"[7c] ground truth: {configs} configurations card vs CPU within "
        f"rtol {CARD_CPU_RTOL}, atol {CARD_CPU_ATOL} (largest |diff| "
        f"{worst:.3g}); evaluate_ground_truth {s_run:.4f} s/run (reps "
        f"{reps}, gt_accuracy {np.mean(accs):.4f}, gt_loss "
        f"{np.mean(losses):.4f}); 0 epoch kernel launches")


def _drive(fn, **kw):
    """One sweep call on the card: (its return, K1 launches, chunks of
    ``parameter_scan_fast``, wall s, peak device bytes)."""
    from mfcd_tpu_torch.ops import kernels
    from mfcd_tpu_torch.sweep import batched

    chunks = []
    device_run = batched._run_bucket_device

    def counted(*args, **kwargs):
        chunks.append(1)
        return device_run(*args, **kwargs)

    batched._run_bucket_device = counted
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.EPOCH_LAUNCHES = 0
        t0 = time.perf_counter()
        out = fn(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.EPOCH_LAUNCHES
    finally:
        batched._run_bucket_device = device_run
    return out, launches, len(chunks), wall, torch.cuda.max_memory_allocated()


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _check_entries(entries, label):
    from mfcd_tpu_torch.core.results import validate_schema

    for e in entries:
        problems = validate_schema(e["results"])
        if problems:
            fail(f"{label} {e['params']}: schema {problems}")
        if not all_finite(e["results"]):
            fail(f"{label} {e['params']}: non-finite values")


def study_phase(smi):
    """[8] The study's sweeps (``mfcd_tpu_torch.experiments.runs``) at
    full width: (a) ``strategies_p_sweep`` for random on the fast path
    (notebook cell 18: 20 p values, s = 5, 30 epochs, reps = 1), (b) the
    same grid on the sequential path against it, (c) ``generation_s_sweep``
    for gmm (10 s values, one bucket) and its resume, which must launch
    nothing and leave the pickle's bytes as they were, (d) ``gt_d_s_sweep``
    (7 d x 3 s at p = 0.5, reps = 3), no K1 launch.  Returns the K1
    launches of each call, and (a)'s entries, wall, chunks and peak."""
    from mfcd_tpu_torch.experiments import runs

    t_all = time.perf_counter()
    launches = {}
    p_grid = np.round(np.logspace(-2, np.log10(0.2), 20), 4).tolist()

    def report(label, what, configs, reps, wall, k1, peak):
        n_runs = configs * reps
        log(f"[{label}] {what}: {configs} configurations, {n_runs} runs in "
            f"{wall:.3f} s ({wall / n_runs:.4f} s/run), {k1} K1 launches, "
            f"peak device memory {peak / 1e6:.1f} MB; {smi}")

    with tempfile.TemporaryDirectory(prefix="mfcd_chip_smoke_") as tmp:
        # [8a] cell 18, random, fast path.
        sp = os.path.join(tmp, "sp")
        _, k1, chunks, wall, peak = _drive(
            runs.strategies_p_sweep, out=sp, scale=1.0, reps=1,
            strategies=("random",), fast=True)
        fast = _load(f"{sp}_random.pkl")
        if [e["params"]["p"] for e in fast] != p_grid or any(
                (e["params"]["s"], e["params"]["n"], e["params"]["m"],
                 e["params"]["strategy"]) != (5, 1000, 1000, "random")
                for e in fast):
            fail(f"[8a] params {[e['params'] for e in fast]}")
        _check_entries(fast, "[8a]")
        acc = float(np.mean(fast[-1]["results"]["accuracy"]))
        if not acc > 0.6:
            fail(f"[8a] accuracy {acc:.4f} at p = 0.2 is not above 0.6")
        if not (k1 > 0 and k1 == 30 * chunks):
            fail(f"[8a] {k1} K1 launches for {chunks} chunks, expected 30 "
                 f"per chunk")
        launches["8a"] = k1
        cell18 = dict(entries=fast, wall=wall, chunks=chunks, peak=peak)
        report("8a", f"strategies_p_sweep random, fast, {chunks} chunks, "
               f"accuracy {acc:.4f} at p = 0.2", len(fast), 1, wall, k1, peak)

        # [8b] the same grid, sequential path, against [8a].
        seq_prefix = os.path.join(tmp, "seq")
        _, k1, _, wall, peak = _drive(
            runs.strategies_p_sweep, out=seq_prefix, scale=1.0, reps=1,
            strategies=("random",), fast=False)
        seq = _load(f"{seq_prefix}_random.pkl")
        if [e["params"] for e in seq] != [e["params"] for e in fast]:
            fail("[8b] the sequential pickle's params differ from [8a]'s")
        worst = {}
        for a, b in zip(seq, fast):
            for k, x in compare_results(a["results"], b["results"],
                                        "[8b] sequential vs fast").items():
                worst[k] = max(worst.get(k, 0.0), x)
        if k1 != 30 * len(seq):
            fail(f"[8b] {k1} K1 launches, expected 30 per configuration")
        launches["8b"] = k1
        top = max(worst.items(), key=lambda kv: kv[1])
        report("8b", f"strategies_p_sweep random, sequential, 23 keys "
               f"within rtol {CARD_CPU_RTOL}, atol {CARD_CPU_ATOL} of [8a] "
               f"(largest |diff| {top[0]} {top[1]:.3g})", len(seq), 1, wall,
               k1, peak)

        # [8c] generation_s_sweep for gmm, then its resume.
        gen = os.path.join(tmp, "gen")
        _, k1, chunks, wall, peak = _drive(
            runs.generation_s_sweep, out=gen, scale=1.0, reps=1,
            generations=("gmm",), fast=True)
        entries = _load(f"{gen}_gmm.pkl")
        if len(entries) != 10:
            fail(f"[8c] {len(entries)} entries, expected 10")
        _check_entries(entries, "[8c]")
        if not (k1 > 0 and k1 == 30 * chunks):
            fail(f"[8c] {k1} K1 launches for {chunks} chunks")
        launches["8c"] = k1
        report("8c", f"generation_s_sweep gmm, fast, {chunks} chunk(s)",
               len(entries), 1, wall, k1, peak)
        with open(f"{gen}_gmm.pkl", "rb") as f:
            before = f.read()
        _, k1, chunks, wall, _ = _drive(
            runs.generation_s_sweep, out=gen, scale=1.0, reps=1,
            generations=("gmm",), fast=True)
        with open(f"{gen}_gmm.pkl", "rb") as f:
            after = f.read()
        if k1 or chunks or after != before:
            fail(f"[8c] the resume ran: {k1} K1 launches, {chunks} chunks, "
                 f"pickle {'unchanged' if after == before else 'changed'}")
        launches["8c_resume"] = k1
        log(f"[8c] resume: 0 K1 launches, 0 chunks, pickle bytes unchanged, "
            f"{wall:.3f} s")

        # [8d] the ground-truth d x s sweep.
        gt = os.path.join(tmp, "gt.pkl")
        _, k1, _, wall, peak = _drive(runs.gt_d_s_sweep, out=gt, scale=1.0,
                                      reps=3)
        entries = _load(gt)
        if len(entries) != 21:
            fail(f"[8d] {len(entries)} entries, expected 21")
        for e in entries:
            for k in ("gt_loss", "gt_accuracy"):
                v = np.asarray(e["results"][k], np.float64)
                if v.shape != (3,) or not np.all(np.isfinite(v)):
                    fail(f"[8d] {e['params']}: {k} {v}")
        if k1:
            fail(f"[8d] the ground truth launched K1 {k1} times")
        launches["8d"] = k1
        accs = [np.mean(e["results"]["gt_accuracy"]) for e in entries]
        report("8d", f"gt_d_s_sweep, gt_accuracy {min(accs):.4f}-"
               f"{max(accs):.4f}", len(entries), 3, wall, k1, peak)
    log(f"[8] study sweeps: {time.perf_counter() - t_all:.1f} s")
    return launches, cell18


def planted_comparisons(t: int, seed: int, skew: bool = False,
                        same: float = 0.0):
    """``t`` comparisons of a seeded planted factor model at ALT_N x ALT_M,
    rank ALT_F, drawn as ``tests/test_legacy.py`` draws them: (users, j,
    k, prefs) as int64, int64, int64, int32 numpy arrays, j != k, prefs the
    sign of u . (v_j - v_k).  ``skew``: j and k drawn apart, each with
    probability proportional to 1 / rank (a few items in most
    comparisons); ``same``: that share of them then made k = j.  A zero
    score labels +1."""
    rng = np.random.default_rng(seed)
    u_true = rng.normal(size=(ALT_N, ALT_F))
    v_true = rng.normal(size=(ALT_M, ALT_F))
    users = rng.integers(0, ALT_N, t)
    if skew:
        p = 1.0 / np.arange(1, ALT_M + 1)
        mj, mk = (rng.choice(ALT_M, t, p=p / p.sum()) for _ in range(2))
    else:
        mj = rng.integers(0, ALT_M, t)
        mk = (mj + 1 + rng.integers(0, ALT_M - 1, t)) % ALT_M
    if same:
        mk = np.where(rng.random(t) < same, mj, mk)
    scores = np.sum(u_true[users] * (v_true[mj] - v_true[mk]), axis=1)
    prefs = np.sign(scores).astype(np.int32)
    return users, mj, mk, np.where(prefs == 0, 1, prefs).astype(np.int32)


def dcd_bound_ms(phase: str, t: int, steps: int, f: int):
    """Least time for one ``phase`` of ``steps`` coordinate steps over ``t``
    comparisons: bytes, each input read once and each output written once
    (the phase's own table read and written, the fixed table read, the
    comparisons' three indices and label, the picks, the duals read and
    written), over the memory rate; operations, per step the two dots and
    the row update (about 6f + 12 for either phase)."""
    rows, other = (ALT_N, ALT_M) if phase == "users" else (ALT_M, ALT_N)
    nbytes = (2 * rows + other) * f * 4 + t * 16 + steps * 4 + t * 8
    return bound_ms(nbytes, steps * (6 * f + 12))


def step_bytes_ms(phase: str, steps: int, f: int) -> float:
    """The bytes each step touches (its pick, indices, label and dual read
    and written; the item phase U's row and V's two rows read and written,
    the user phase V's two rows and U's row read and written) times the
    steps, over the memory rate: what a phase's chain of dependent steps
    would take if each step waited only on its own bytes."""
    per_step = 28 + (20 if phase == "items" else 16) * f
    return steps * per_step / PEAK_BYTES_PER_S * 1e3


def dcd_compare(tag, phase, got, refs) -> float:
    """Hold K2's ``(table, dual)`` bit-equal to each ``(label, result)``
    (max|diff| 0, a gate); returns the largest max|diff|."""
    names = ("V", "beta") if phase == "items" else ("U", "alpha")
    worst, errs = 0.0, []
    for label, ref in refs:
        for name, a, b in zip(names, ref, got):
            a = a.to(b.device)
            if not torch.isfinite(b).all():
                fail(f"{tag} K2 {phase}: non-finite {name}")
            err = float((a - b).abs().max())
            worst = max(worst, err)
            errs.append(f"{name} vs {label} {err:.3g}")
            if not torch.equal(a, b):
                fail(f"{tag} K2 {phase}: {name} differs from {label} "
                     f"(max|diff| {err:.3g}); it must be bit-equal")
    log(f"  {tag} K2 {phase} phase: max|diff| " + ", ".join(errs)
        + " (gate: bit-equal)")
    return worst


def _on_cpu(args):
    return tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)


def _alt_comparisons(dev, t, seed, **kw):
    users, mj, mk, prefs = (torch.from_numpy(np.ascontiguousarray(a)).to(
        dev, torch.int32) for a in planted_comparisons(t, seed, **kw))
    return users, mj, mk, prefs.float()


def chain_depth(phase, picks, comps) -> int:
    """The phase's chain depth (``altsvm_kernels.dcd_levels``, on the
    host)."""
    from mfcd_tpu_torch.ops import altsvm_kernels as ak

    return int(ak.dcd_levels(phase, picks.cpu(),
                             *(a.cpu() for a in comps[:3])).max())


# [9a] The check's cases: (name, f, comparison options).
ALT_CASES = (("f20", ALT_F, {}), ("f64", 64, {}),
             ("skewed", ALT_F, {"skew": True}),
             ("same", ALT_F, {"same": 0.05}))


def altsvm_check(dev, smi):
    """[9a] K2 bit-equal to its plain version, on the card and on the CPU,
    from the same state and picks at ALT_T_CHECK comparisons, in each of
    ALT_CASES (at f = 20 also at every table placement); returns per phase the largest difference, and at f = 20
    K2's ms and the card's plain ms."""
    from mfcd_tpu_torch.core import prng
    from mfcd_tpu_torch.models import altsvm
    from mfcd_tpu_torch.ops import altsvm_kernels as ak

    out = {ph: dict(err=0.0) for ph in ak.PHASES}
    for case, f, kw in ALT_CASES:
        comps = _alt_comparisons(dev, ALT_T_CHECK, 11, **kw)
        state = altsvm.init_altsvm(prng.key(0), ALT_N, ALT_M, f,
                                   ALT_T_CHECK, device=dev)
        # The epoch's two phases, each from the zero origin, each fed the
        # same inputs on every side: the item phase U's init, the user
        # phase the plain item phase's V.
        dual0 = torch.zeros_like(state.alpha)
        fixed = state.user_features
        for seed, phase, table in (
                (21, "items", torch.zeros_like(state.movie_features)),
                (22, "users", torch.zeros_like(state.user_features))):
            picks = altsvm._picks(prng.key(seed, device=dev), ALT_T_CHECK,
                                  ALT_SWEEPS)
            args = (phase, table, fixed, dual0, picks, *comps, 0.1, 1.0)
            mode = ak.dcd_mode(table.shape[0], fixed.shape[0], f)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = ak.dcd_phase_reference(*args)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            got = ak.dcd_phase(*args)
            cpu = ak.dcd_phase(*_on_cpu(args))
            err = dcd_compare(f"[9a] {case} ({mode})", phase, got,
                              (("the card's plain", want),
                               ("the CPU's plain", cpu)))
            if case == "f20":
                for m in ak.MODES:
                    err = max(err, dcd_compare(
                        f"[9a] {case} {m}", phase,
                        ak._dcd_phase(*args, mode=m),
                        (("the card's plain", want),)))
                out[phase].update(plain_card_ms=plain_ms, ms=time_ms(
                    lambda: ak.dcd_phase(*args), warmup=1, reps=5))
            out[phase]["err"] = max(out[phase]["err"], err)
            fixed = want[0]
    steps = ALT_T_CHECK * ALT_SWEEPS
    log(f"[9a] K2 bit-equal at n={ALT_N}, m={ALT_M}, T={ALT_T_CHECK} in "
        + ", ".join(c for c, _, _ in ALT_CASES) + f"; at f={ALT_F}, "
        f"{steps} steps a phase: "
        + "; ".join(f"{ph} {o['ms']:.4f} ms ({1e3 * o['ms'] / steps:.4f} us "
                    f"a step), plain on the card {o['plain_card_ms']:.1f} ms"
                    for ph, o in out.items()) + f"; {smi}")
    return out


def _phase_timing(ak, phase, args, rows, placements=False):
    """K2's ms a phase (the whole ``dcd_phase`` call) and its schedule's ms
    alone; ``placements``: also the call's ms with the tables forced into
    each placement of ``MODES`` that fits."""
    _, table, fixed, _, picks = args[:5]
    comps, lam = args[5:9], args[9]
    out = dict(
        ms=time_ms(lambda: ak.dcd_phase(*args), warmup=1, reps=5),
        schedule_ms=time_ms(lambda: ak.dcd_schedule(
            phase, fixed, picks, *comps, lam, rows), warmup=1, reps=5))
    if placements:
        shape = (rows, fixed.shape[0], table.shape[1])
        out["placement_ms"] = {
            m: time_ms(lambda m=m: ak._dcd_phase(*args, mode=m), warmup=1,
                       reps=5)
            for m in ak.MODES if ak.smem_bytes(m, *shape) <= ak.SMEM_BYTES}
    return out


def _plain_phase_on_cpu(args):
    """The CPU's plain DCD phase on ``args`` (numpy arrays in place of the
    tensors), in a worker process; returns ((table, dual) as numpy arrays,
    its ms)."""
    from mfcd_tpu_torch.ops import altsvm_kernels as ak

    args = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                 for a in args)
    t0 = time.perf_counter()
    out = ak.dcd_phase(*args)
    return tuple(a.numpy() for a in out), (time.perf_counter() - t0) * 1e3


def altsvm_main_shape_check(dev, state, comps, key, smi):
    """[9b] K2 at the main path's shape bit-equal to the CPU's plain
    version, on the first epoch's inputs as ``train_altsvm`` makes them
    (its keys, picks and zeroed tables and duals; the user phase fed the
    item phase's V), K2 timed at every table placement; then the same
    phases on a skewed set, the item phase (its chain the deepest)
    bit-equal to the CPU's plain version too.  The three CPU phases run
    side by side in worker processes while the card is timed.  Returns
    per phase the difference, K2's and its schedule's ms, the chain
    depth, the plain version's ms and the bound."""
    import concurrent.futures
    import multiprocessing

    from mfcd_tpu_torch.core import prng
    from mfcd_tpu_torch.models import altsvm
    from mfcd_tpu_torch.ops import altsvm_kernels as ak

    k1, k2 = prng.split(prng.split(key.to(dev), ALT_EPOCHS)[0]).unbind(-2)
    dual0 = torch.zeros_like(state.alpha)
    steps = ALT_T * ALT_SWEEPS
    skewed = _alt_comparisons(dev, ALT_T, 13, skew=True)
    picks = {"items": altsvm._picks(k1, ALT_T, ALT_SWEEPS),
             "users": altsvm._picks(k2, ALT_T, ALT_SWEEPS)}
    tables = {"items": torch.zeros_like(state.movie_features),
              "users": torch.zeros_like(state.user_features)}
    phase_args = lambda phase, fixed, cs: (
        phase, tables[phase], fixed, dual0, picks[phase], *cs, 0.1, 1.0)
    # The item phases first; each user phase is fed its item phase's V
    # (the card's, held bit-equal to the CPU's below).
    args = {"items": phase_args("items", state.user_features, comps)}
    sargs = {"items": phase_args("items", state.user_features, skewed)}
    got = {"items": ak.dcd_phase(*args["items"])}
    sgot = {"items": ak.dcd_phase(*sargs["items"])}
    args["users"] = phase_args("users", got["items"][0], comps)
    sargs["users"] = phase_args("users", sgot["items"][0], skewed)
    got["users"] = ak.dcd_phase(*args["users"])
    sgot["users"] = ak.dcd_phase(*sargs["users"])
    to_numpy = lambda a: tuple(x.cpu().numpy() if isinstance(x, torch.Tensor)
                               else x for x in a)
    out = {}
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=3,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = {name: pool.submit(_plain_phase_on_cpu, to_numpy(a))
                for name, a in (("items", args["items"]),
                                ("users", args["users"]),
                                ("skewed", sargs["items"]))}
        for phase in ("items", "users"):
            rows = tables[phase].shape[0]
            out[phase] = dict(
                chain_depth=chain_depth(phase, picks[phase], comps),
                skewed=dict(_phase_timing(ak, phase, sargs[phase], rows),
                            chain_depth=chain_depth(phase, picks[phase],
                                                    skewed),
                            checked=phase == "items"),
                **_phase_timing(ak, phase, args[phase], rows,
                                placements=True))
        cpu = {name: job.result() for name, job in jobs.items()}
    as_ref = lambda name: (("the CPU's plain",
                            tuple(torch.from_numpy(a) for a in cpu[name][0])),)
    for phase in ("items", "users"):
        err = dcd_compare("[9b]", phase, got[phase], as_ref(phase))
        if phase == "items":
            err = max(err, dcd_compare("[9b] skewed", phase, sgot[phase],
                                       as_ref("skewed")))
        least, by = dcd_bound_ms(phase, ALT_T, steps, ALT_F)
        o = out[phase]
        o.update(err=err, plain_ms=cpu[phase][1], bound_ms=least,
                 bound_by=by)
        skew, depth = o["skewed"], o["chain_depth"]
        log(f"  [9b] K2 {phase} phase at T={ALT_T}, {steps} steps: "
            f"{o['ms']:.4f} ms ({1e3 * o['ms'] / steps:.5f} us a step; "
            + ", ".join(f"{m} {ms:.4f}" for m, ms in
                        o["placement_ms"].items())
            + f" ms by placement), the schedule alone "
            f"{o['schedule_ms']:.4f} ms; chain depth {depth} "
            f"({1e3 * o['ms'] / depth:.3f} us a level); plain on the CPU "
            f"{o['plain_ms']:.1f} ms (three CPU phases side by side); bound "
            f"{least:.6f} ms ({by}; "
            f"{step_bytes_ms(phase, steps, ALT_F):.6f} ms by the bytes each "
            f"step touches); skewed set: {skew['ms']:.4f} ms, schedule "
            f"{skew['schedule_ms']:.4f}, chain depth {skew['chain_depth']}"
            f"{', bit-equal to the CPU' if skew['checked'] else ''}; {smi}")
    return out


def altsvm_phase(dev, smi):
    """[9] K2 against its plain version at the check's shape and at the
    main path's, then the model at full size with the kernel launches read
    around ``train_altsvm``."""
    from mfcd_tpu_torch.core import prng
    from mfcd_tpu_torch.models import altsvm
    from mfcd_tpu_torch.ops import altsvm_kernels as ak

    t_all = time.perf_counter()
    small = altsvm_check(dev, smi)
    users, mj, mk, prefs = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                            for a in planted_comparisons(ALT_T, 12))
    state = altsvm.init_altsvm(prng.key(0), ALT_N, ALT_M, ALT_F, ALT_T,
                               device=dev)
    key = prng.key(1)
    full = altsvm_main_shape_check(
        dev, state, altsvm._comparisons(state.user_features, users, mj, mk,
                                        prefs), key, smi)
    torch.cuda.synchronize()
    ak.DCD_LAUNCHES = dict.fromkeys(ak.PHASES, 0)
    ak.SCHEDULE_LAUNCHES = dict.fromkeys(ak.PHASES, 0)
    t0 = time.perf_counter()
    state = altsvm.train_altsvm(state, key, users, mj, mk, prefs,
                                num_epochs=ALT_EPOCHS,
                                sweeps_per_phase=ALT_SWEEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ak.DCD_LAUNCHES)
    schedules = dict(ak.SCHEDULE_LAUNCHES)
    expected = dict.fromkeys(ak.PHASES, ALT_EPOCHS)
    if launches != expected or schedules != expected:
        fail(f"[9b] train_altsvm launched K2 {launches} and its schedule "
             f"{schedules} times, expected {ALT_EPOCHS} a phase")
    if not all(bool(torch.isfinite(a).all()) for a in state):
        fail("[9b] non-finite AltSVM state")
    for name, a in (("alpha", state.alpha), ("beta", state.beta)):
        if float(a.min()) < 0.0 or float(a.max()) > 1.0:
            fail(f"[9b] {name} outside [0, C]")
    acc = float(altsvm.pairwise_accuracy(state, users, mj, mk, prefs))
    if not acc > ALT_ACC_MIN:
        fail(f"[9b] pairwise accuracy {acc:.4f} is not above {ALT_ACC_MIN}")
    steps = ALT_T * ALT_SWEEPS
    phase_ms = 1e3 * wall / sum(launches.values())
    log(f"[9b] train_altsvm n={ALT_N}, m={ALT_M}, f={ALT_F}, T={ALT_T}, "
        f"{ALT_EPOCHS} epochs x {ALT_SWEEPS} sweeps: {wall:.4f} s, K2 "
        f"launches {launches}, schedule launches {schedules}, "
        f"{phase_ms:.4f} ms a phase ({1e3 * phase_ms / steps:.5f} us a "
        f"step, picks and copies included); pairwise accuracy {acc:.4f}; "
        f"{smi}")
    log(f"[9] AltSVM: {time.perf_counter() - t_all:.1f} s")
    return [{
        "name": f"altsvm_dcd_phase:{phase}",
        "route": "cuda",
        "source": "mfcd_tpu_torch/ops/csrc/altsvm_dcd.cu",
        "replaces": ("mfcd_tpu/models/altsvm.py:136" if phase == "items"
                     else "mfcd_tpu/models/altsvm.py:109"),
        "tpu_kernel": None,
        "launches": launches[phase],
        "schedule_launches": schedules[phase],
        "max_abs_err": max(small[phase]["err"], full[phase]["err"]),
        "ms": full[phase]["ms"],
        "plain_ms": full[phase]["plain_ms"],
        "plain_device": "cpu",
        "bound_ms": full[phase]["bound_ms"],
        "bound_by": full[phase]["bound_by"],
        "library_ms": None,
        "schedule_ms": full[phase]["schedule_ms"],
        "chain_depth": full[phase]["chain_depth"],
        "us_per_level": 1e3 * full[phase]["ms"] / full[phase]["chain_depth"],
        "placement_ms": full[phase]["placement_ms"],
        "skewed": full[phase]["skewed"],
        "shape": {"n": ALT_N, "m": ALT_M, "f": ALT_F, "T": ALT_T,
                  "sweeps": ALT_SWEEPS},
        "us_per_step": 1e3 * full[phase]["ms"] / steps,
        "check_T": ALT_T_CHECK,
        "check_cases": [c for c, _, _ in ALT_CASES],
        "check_ms": small[phase]["ms"],
        "check_plain_card_ms": small[phase]["plain_card_ms"],
        "train_s": wall,
        "ms_per_phase_main_path": phase_ms,
        "accuracy": acc,
    } for phase in ("items", "users")]


def chunk_phase(smi):
    """[10] ``parameter_scan_fast`` over ``CHUNK_GRID``'s 4 chunks, twice:
    the params in grid order, 30 K1 launches a chunk, the entries checked,
    and the two pickles equal byte for byte (else within [5]'s bound);
    s/run and peak memory."""
    from mfcd_tpu_torch.sweep import batched

    t_all = time.perf_counter()
    configs = len(CHUNK_GRID["s"])
    runs = configs * CHUNK_GRID["reps"]
    chunks_expected = -(-configs // CHUNK_GRID["max_bucket"])
    passes = []
    with tempfile.TemporaryDirectory(prefix="mfcd_chip_smoke_") as tmp:
        for k in range(2):
            path = os.path.join(tmp, f"chunks{k}.pkl")
            out, k1, chunks, wall, peak = _drive(
                batched.parameter_scan_fast, save_path=path, **CHUNK_GRID)
            with open(path, "rb") as f:
                raw = f.read()
            passes.append(dict(wall=wall, k1=k1, peak=peak, raw=raw,
                               entries=pickle.loads(raw)))
            if out != [] or chunks != chunks_expected or \
                    k1 != 30 * chunks:
                fail(f"[10] pass {k}: {chunks} chunks, {k1} K1 launches, "
                     f"expected {chunks_expected} and 30 a chunk")
    ref, again = passes
    params = [e["params"] for e in ref["entries"]]
    if [p["s"] for p in params] != CHUNK_GRID["s"]:
        fail(f"[10] params {params}")
    _check_entries(ref["entries"], "[10]")
    if [e["params"] for e in again["entries"]] != params:
        fail("[10] pass 1: params differ from pass 0's")
    # Bit-equal where the card repeats its own bits; else [5]'s card bound
    # on the 23 keys.
    bit_equal = again["raw"] == ref["raw"]
    if not bit_equal:
        for a, b in zip(ref["entries"], again["entries"]):
            compare_results(a["results"], b["results"], "[10] pass 1 vs 0")
    s_run = min(p["wall"] for p in passes) / runs
    peak = max(p["peak"] for p in passes)
    log(f"[10] chunks: parameter_scan_fast, {configs} configurations x "
        f"{CHUNK_GRID['reps']} reps in {chunks_expected} chunks, passes "
        + ", ".join(f"{p['wall']:.3f} s" for p in passes)
        + f"; best {s_run:.4f} s/run; peak device memory "
        f"{peak / 1e6:.1f} MB; "
        + ("pickles byte-equal" if bit_equal else
           "the two passes differ on the card: 23 keys within rtol "
           f"{CARD_CPU_RTOL}, atol {CARD_CPU_ATOL}")
        + f"; {ref['k1']} K1 launches a pass; {smi}")
    log(f"[10] chunks: {time.perf_counter() - t_all:.1f} s")
    return dict(s_per_run=s_run, peak=peak, bit_equal=bit_equal,
                launches=[p["k1"] for p in passes])


def mesh_rank(tasks, out_dir):
    """One rank of a [11] job: each task's outputs, with this rank's K1
    launches, wall and peak device bytes around it.  Tasks: ("steps",
    label, shape, state, batches) the sharded step; ("sweep", label,
    grid) the bench bucket over ``make_sweep_mesh()``, twice (the rank's
    first call pays its lazy kernel loads and library handles; the second,
    ``label_warm``, does not); ("cell18", label) ``strategies_p_sweep``
    for random into ``out_dir``, with the pickle writes counted."""
    import torch.distributed as dist

    from mfcd_tpu_torch.experiments import runs
    from mfcd_tpu_torch.ops import kernels
    from mfcd_tpu_torch.scripts.dryrun_multichip import sharded_steps
    from mfcd_tpu_torch.sweep import batched

    out = {}
    for task in tasks:
        kind, label = task[0], task[1]
        if kind == "steps":
            out[label] = sharded_steps(task[2], task[3], task[4], MESH_LR,
                                       MESH_WD, device="cuda")
            continue
        for rep in range(2 if kind == "sweep" else 1):
            writes = []
            append = batched.append_results
            batched.append_results = lambda *a: (writes.append(1),
                                                 append(*a))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.EPOCH_LAUNCHES = 0
            t0 = time.perf_counter()
            try:
                if kind == "sweep":
                    got = batched.parameter_scan_fast(
                        mesh=batched.make_sweep_mesh(), **task[2])
                else:
                    runs.strategies_p_sweep(
                        out=os.path.join(out_dir, "sp"), scale=1.0, reps=1,
                        strategies=("random",), fast=True,
                        mesh=batched.make_sweep_mesh())
                    got = None
                torch.cuda.synchronize()
            finally:
                batched.append_results = append
            out[label + ("_warm" if rep else "")] = dict(
                results=got, wall=time.perf_counter() - t0,
                k1=kernels.EPOCH_LAUNCHES, writes=len(writes),
                peak=torch.cuda.max_memory_allocated())
    out["rank"] = (dist.get_rank(), dist.get_backend())
    return out


def mesh_phase(smi, fast_ref, cell18_ref):
    """[11] The multi-device layer on the card, in ``torch.distributed``
    jobs of the port's launcher (kernels built here, ranks spawned): (a)
    the (grid, data, tp)-sharded step at the canonical width over 30
    steps, one NCCL rank per card and gloo ranks sharing the card at
    (1, 2, 1), (1, 1, 2) and (2, 1, 1), each against the unsharded step on
    the card; (b) [4b]'s bench bucket over ``make_sweep_mesh()`` at 2 gloo
    ranks (and one NCCL rank per card where there are more cards), against
    [4b]'s results; (c) cell 18 for random over 2 gloo ranks against
    [8a]'s pickle, written by rank 0 alone.  Returns K1's launches per
    rank in (b) and (c)."""
    import mfcd_tpu_torch.scripts.dryrun_multichip as dm
    from mfcd_tpu_torch.parallel.mesh import factor_mesh
    from mfcd_tpu_torch.parallel.multihost import launch

    t_all = time.perf_counter()
    cards = torch.cuda.device_count()
    bench = dict(CANON, s=[5.0, 6.0])
    n, m, d, bs = CANON["n"], CANON["m"], CANON["d"], 64

    def step_task(shape):
        rs = np.random.default_rng(11)
        state = dm.toy_batch(shape[0], n, m, d, bs, seed=sum(shape))
        batches = [dm.batch_of(rs, shape[0], n, m, bs)
                   for _ in range(MESH_STEPS)]
        return ("steps", f"11a {shape}", tuple(shape), state, batches)

    jobs = {"nccl": [step_task(factor_mesh(cards))],
            "gloo": [step_task(sh) for sh in GLOO_MESHES]
            + [("sweep", "11b", bench), ("cell18", "11c")]}
    if cards > 1:
        jobs["nccl"].append(("sweep", "11b", bench))
    outs = {}
    with tempfile.TemporaryDirectory(prefix="mfcd_chip_smoke_") as tmp:
        for backend, ranks in (("nccl", cards), ("gloo", 2)):
            t0 = time.perf_counter()
            outs[backend] = launch(mesh_rank, ranks,
                                   args=(jobs[backend], tmp),
                                   device="cuda", backend=backend,
                                   timeout_s=MESH_TIMEOUT_S)
            log(f"[11] {backend} job: {ranks} rank(s) on {cards} card(s), "
                f"{time.perf_counter() - t0:.1f} s with the spawn")
        sharded_cell = _load(os.path.join(tmp, "sp_random.pkl"))

    # (a) each mesh against the unsharded step on the card.
    for backend, tasks in jobs.items():
        for task in tasks:
            if task[0] != "steps":
                continue
            label, shape = task[1], task[2]
            want = dm.plain_steps(task[3], task[4], MESH_LR, MESH_WD,
                                  device="cuda")
            got = [o[label] for o in outs[backend]]
            errs = dm.compare_steps(got[0], want, f"[{label}]")
            for other in got[1:]:
                for k in ("U", "V", "loss"):
                    if not np.array_equal(other[k], got[0][k]):
                        fail(f"[{label}] the ranks disagree on {k}")
            log(f"[{label}] sharded step, {backend}, {len(got)} rank(s), G "
                f"= {shape[0]}: {MESH_STEPS} steps in "
                + ", ".join(f"{o['wall']:.4f}" for o in got)
                + f" s a rank ({1e3 * max(o['wall'] for o in got) / MESH_STEPS:.3f}"
                f" ms/step), unsharded {want['wall']:.4f} s "
                f"({1e3 * want['wall'] / MESH_STEPS:.3f} ms/step); peak "
                + ", ".join(f"{o['peak'] / 1e6:.2f}" for o in got)
                + f" MB a rank, unsharded {want['peak'] / 1e6:.2f} MB; loss "
                f"within rtol {dm.LOSS_RTOL}, U V mu nu within rtol "
                f"{dm.STATE_RTOL}, atol {dm.STATE_ATOL} (largest |diff| "
                + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                + f"); {smi}")

    # (b) the bench bucket against [4b], cold and warm.
    launches = {}
    runs_b = fast_ref["runs"]
    for backend in outs:
        if "11b" not in outs[backend][0]:
            continue
        gaps = {}
        for label in ("11b", "11b_warm"):
            got = [o[label] for o in outs[backend]]
            for r, o in enumerate(got):
                if [e["params"] for e in o["results"]] != \
                        [e["params"] for e in fast_ref["entries"]]:
                    fail(f"[{label}] {backend} rank {r}: params differ from "
                         "[4b]'s")
                for k, v in dm.compare_results(
                        [e["results"] for e in o["results"]],
                        [e["results"] for e in fast_ref["entries"]],
                        f"[{label}] {backend} rank {r} vs [4b]",
                        card=True).items():
                    gaps[k] = max(gaps.get(k, 0.0), v)
                if o["k1"] != CANON["num_epochs"]:
                    fail(f"[{label}] {backend} rank {r}: {o['k1']} K1 "
                         f"launches, expected {CANON['num_epochs']}")
            launches[f"{label}_{backend}"] = [o["k1"] for o in got]
        cold = max(o["wall"] for o in (o["11b"] for o in outs[backend]))
        warm = max(o["wall"] for o in (o["11b_warm"]
                                       for o in outs[backend]))
        peaks = [o["11b_warm"]["peak"] for o in outs[backend]]
        log(f"[11b] parameter_scan_fast over make_sweep_mesh(), {backend}, "
            f"{len(peaks)} ranks: {runs_b} runs in {warm:.3f} s warm "
            f"({warm / runs_b:.4f} s/run; a rank's first call {cold:.3f} s), "
            f"[4b] unsharded {fast_ref['wall']:.3f} s "
            f"({fast_ref['wall'] / runs_b:.4f} s/run)"
            + ("; the ranks share one card, so this is correctness and "
               "overhead, not scaling" if len(peaks) > cards else "")
            + f"; K1 launches a rank {launches[f'11b_{backend}']} and "
            f"{launches[f'11b_warm_{backend}']}; peak "
            + ", ".join(f"{p / 1e6:.1f}" for p in peaks)
            + f" MB a rank, [4b] {fast_ref['peak'] / 1e6:.1f} MB; every key "
            "bit-equal to [4b]'s but the metric block's: "
            + _gap_text(gaps) + f"; {smi}")

    # (c) cell 18 against [8a]'s pickle.
    got = [o["11c"] for o in outs["gloo"]]
    ref = cell18_ref["entries"]
    if [e["params"] for e in sharded_cell] != [e["params"] for e in ref]:
        fail("[11c] the sharded pickle's params differ from [8a]'s")
    gaps = dm.compare_results([e["results"] for e in sharded_cell],
                              [e["results"] for e in ref],
                              "[11c] vs [8a]", card=True)
    chunks = cell18_ref["chunks"]
    if [o["writes"] for o in got] != [chunks, 0]:
        fail(f"[11c] pickle writes by rank {[o['writes'] for o in got]}, "
             f"expected {chunks} by rank 0 alone")
    if any(o["k1"] != 30 * chunks for o in got):
        fail(f"[11c] K1 launches a rank {[o['k1'] for o in got]}, expected "
             f"30 for each of {chunks} chunks")
    launches["11c_gloo"] = [o["k1"] for o in got]
    wall = max(o["wall"] for o in got)
    log(f"[11c] strategies_p_sweep random over 2 gloo ranks: "
        f"{len(ref)} runs in {wall:.3f} s ({wall / len(ref):.4f} s/run), "
        f"[8a] unsharded {cell18_ref['wall']:.3f} s "
        f"({cell18_ref['wall'] / len(ref):.4f} s/run); {chunks} chunks, "
        f"K1 launches a rank {launches['11c_gloo']}, pickle written by rank 0"
        f" alone; peak " + ", ".join(f"{o['peak'] / 1e6:.1f}" for o in got)
        + f" MB a rank, [8a] {cell18_ref['peak'] / 1e6:.1f} MB; every key "
        "bit-equal to [8a]'s but the metric block's: " + _gap_text(gaps)
        + f"; {smi}")
    log(f"[11] mesh: {time.perf_counter() - t_all:.1f} s")
    return launches


def scale_kernel_phase(dev, smi):
    """[12a] K1 at n = m = 5,000 and 10,000 (smallest C 2 and 4), d = 2,
    bs = 64, pack "none", 64 batches, at R = 1, 4 and one past the runs the
    card holds at once at the smallest C: against its plain version; bit-
    equal at every C from the smallest that the card schedules (the
    largest R in waves at each); a forced C below the smallest, and
    packed, raising; timed beside the bound.  Returns (the entries, the
    largest max |diff|)."""
    from mfcd_tpu_torch.ops import kernels
    from mfcd_tpu_torch.scripts.profile_kernel_split import median_ms

    idx = dev.index or 0
    d, bs, nb = 2, 64, SCALE_BATCHES
    entries, worst = [], 0.0
    for n in SCALE_ROWS:
        floor = kernels.min_cluster(n, n, d, bs)
        occ = lambda c: kernels.epoch_occupancy(n, n, d, bs, c, idx)
        held = occ(floor)[1]
        shapes = [c for c in kernels.CLUSTER_SIZES
                  if c >= floor and occ(c)[1] > 0]
        g = np.random.default_rng(n)
        for r in (1, 4, held + 1):
            label = f"n=m={n} R={r}"
            inp = make_epoch_inputs(
                20 + r, r, n, n, d, bs, nb, [nb * bs] * (r - 1)
                + [nb * bs - 37], list(10.0 ** g.uniform(-3.5, -2, r)),
                "none", dev)
            args = (inp["stream"], inp["lr"], inp["wd"], inp["step0"],
                    inp["count"])
            err, plain_ms, got = compare_epoch(inp, label)
            worst = max(worst, err)
            c = kernels.cluster_size(r, n, n, d, bs, dev)
            if c < floor:
                fail(f"{label}: chose C={c} below the smallest C {floor}")
            for k in shapes:
                out = kernels._train_epoch(clone_state(inp["state"]), *args,
                                           pack=inp["pack"], cluster=k)
                torch.cuda.synchronize()
                if not bit_equal(got, out):
                    fail(f"{label}: C={c} and C={k} differ")
            for bad in (kernels.PACKED,) + tuple(
                    k for k in (1, 2) if k < floor):
                try:
                    kernels._train_epoch(clone_state(inp["state"]), *args,
                                         pack=inp["pack"], cluster=bad)
                except ValueError as e:
                    if "smallest C that fits" not in str(e):
                        fail(f"{label}: C={bad}: {e}")
                else:
                    fail(f"{label}: a forced C={bad} below {floor} ran")
            ms = median_ms(lambda st: kernels.train_epoch(
                st, *args, pack=inp["pack"]), inp["state"], warmup=1,
                reps=5)
            steps = executed_steps(inp, bs) / r
            bound, by = epoch_bound_ms(inp, n, n, d, bs)
            entry = dict(label=label, n=n, r=r, bs=bs, pack="none",
                         smallest_cluster=floor, cluster=c,
                         resident_runs=occ(c)[1],
                         waves=-(-r // occ(c)[1]), ms=ms,
                         us_per_step=ms * 1e3 / steps, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, max_abs_err=err,
                         bit_equal_at=shapes)
            entries.append(entry)
            log(f"[12a] K1 {label}: C={c} (smallest {floor}, "
                f"{entry['resident_runs']} runs resident, {entry['waves']} "
                f"wave(s)), {ms:.4f} ms/epoch ({entry['us_per_step']:.4f} "
                f"us/step), plain {plain_ms:.2f} ms, bound {bound:.6f} ms "
                f"({by}); bit-equal at C={shapes}, C={kernels.PACKED} "
                f"(packed) and C<{floor} refused; {smi}")
    # d = 8 past C = 8's reach: the gate's floor is C = 16.  Against the
    # plain version, two launches bit-equal, C = 8 refused.
    n, d8, r = D8_ROWS, 8, 2
    floor = kernels.min_cluster(n, n, d8, bs)
    if floor != 16:
        fail(f"[12a] d=8, n=m={n}: smallest C {floor}, expected 16")
    label = f"d=8 n=m={n} R={r}"
    inp = make_epoch_inputs(40, r, n, n, d8, bs, nb, [nb * bs, nb * bs - 37],
                            [1e-3, 3e-3], "none", dev)
    args = (inp["stream"], inp["lr"], inp["wd"], inp["step0"], inp["count"])
    err, plain_ms, got = compare_epoch(inp, f"[12a] K1 {label}")
    worst = max(worst, err)
    c = kernels.cluster_size(r, n, n, d8, bs, dev)
    again = kernels._train_epoch(clone_state(inp["state"]), *args,
                                 pack=inp["pack"], cluster=16)
    torch.cuda.synchronize()
    if c != 16 or not bit_equal(got, again):
        fail(f"[12a] {label}: chose C={c}; two launches at C = 16 differ: "
             f"{not bit_equal(got, again)}")
    try:
        kernels._train_epoch(clone_state(inp["state"]), *args,
                             pack=inp["pack"], cluster=8)
    except ValueError as e:
        if "smallest C that fits" not in str(e):
            fail(f"[12a] {label}: C=8: {e}")
    else:
        fail(f"[12a] {label}: a forced C=8 below 16 ran")
    ms = median_ms(lambda st: kernels.train_epoch(
        st, *args, pack=inp["pack"]), inp["state"], warmup=1, reps=5)
    steps = executed_steps(inp, bs) / r
    bound, by = epoch_bound_ms(inp, n, n, d8, bs)
    entries.append(dict(label=label, n=n, d=d8, r=r, bs=bs, pack="none",
                        smallest_cluster=floor, cluster=c, ms=ms,
                        us_per_step=ms * 1e3 / steps, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=by, max_abs_err=err,
                        bit_equal_at=[16]))
    log(f"[12a] K1 {label}: C={c} (smallest {floor}), {ms:.4f} ms/epoch "
        f"({ms * 1e3 / steps:.4f} us/step), plain {plain_ms:.2f} ms, bound "
        f"{bound:.6f} ms ({by}); max|diff| {err:.3g} against the plain "
        f"version (its index_add_ adds with atomics on the card), two "
        f"launches bit-equal, C=8 refused; {smi}")
    return entries, worst


def _card_spans(call):
    """One ``call()`` as a call of the port's stage recorder
    (``utils/observability``), its spans timed on the card's clock by the
    recorder's CUDA events, with no sync: returns (the call's wall, seconds
    by span name, each span's own card timeline and its children's)."""
    from mfcd_tpu_torch.utils import observability

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with observability.call("chip_smoke", "cuda"):
        call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    raw = observability.calls()[-1]["spans"]
    parent = {sp["id"]: sp["parent"] for sp in raw}
    inclusive = {sp["id"]: 0 for sp in raw}
    for sp in raw:
        up = sp["id"]
        while up is not None:
            inclusive[up] += sp["card_ns"]
            up = parent[up]
    spans = {}
    for sp in raw:
        spans[sp["name"]] = spans.get(sp["name"], 0.0) + \
            inclusive[sp["id"]] * 1e-9
    return wall, spans


def scale_demo_phase(smi):
    """[12b] ``scale_demo`` at n = m = 10,000 (K1 the trainer, 30 launches
    a call, every key finite, learning; its first call with its stage
    spans on the card's clock, so a slow first call shows where it went),
    a third call for the span split; then K1 against the autograd trainer
    at n = m = 5,000.  Returns the demo's line."""
    from mfcd_tpu_torch.core.config import RunConfig
    from mfcd_tpu_torch.core.results import validate_schema
    from mfcd_tpu_torch.ops import kernels
    from mfcd_tpu_torch.scripts import scale_demo
    from mfcd_tpu_torch.sweep import engine
    from mfcd_tpu_torch.sweep.engine import run_config

    first = {}

    def spanned_once(*args, **kwargs):
        engine.run_config = run_config
        out = []
        first["wall"], first["spans"] = _card_spans(
            lambda: out.append(run_config(*args, **kwargs)))
        return out[0]

    kernels.EPOCH_LAUNCHES = 0
    engine.run_config = spanned_once
    try:
        line, res = scale_demo.run(**SCALE_DEMO, device="cuda")
    finally:
        engine.run_config = run_config
    launches = kernels.EPOCH_LAUNCHES
    epochs, n = SCALE_DEMO["epochs"], SCALE_DEMO["n"]
    if line["trainer"] != "fused-epoch kernel":
        fail(f"[12b] scale_demo trained with {line['trainer']}")
    if line["k1_launches"] != [epochs] * 2 or launches != 2 * epochs:
        fail(f"[12b] K1 launches {line['k1_launches']} ({launches} in all),"
             f" expected {epochs} a call")
    if line["cluster"] < line["smallest_cluster"]:
        fail(f"[12b] C={line['cluster']} below {line['smallest_cluster']}")
    problems = validate_schema(res)
    if problems or not all_finite(res):
        fail(f"[12b] results: schema {problems}, finite {all_finite(res)}")
    acc, gt = float(res["accuracy"][0]), float(res["gt_accuracy"][0])
    if not (acc > 0.6 and gt - acc < 0.2):
        fail(f"[12b] accuracy {acc:.4f}, ground truth {gt:.4f}")
    cfg = RunConfig(n=n, m=n, d=2, p=SCALE_DEMO["p"], s=5.0, lr=1e-3,
                    weight_decay=1e-5, num_epochs=epochs, reps=1)
    wall, spans = _card_spans(lambda: run_config(
        cfg, seed=scale_demo.SEEDS[1], device="cuda"))
    keep = ("mfcd.generate", "mfcd.sample", "mfcd.label", "mfcd.train",
            "mfcd.train.mix", "mfcd.train.epoch", "mfcd.train.val",
            "mfcd.metrics", "mfcd.export")
    outside = first["wall"] - sum(
        first["spans"].get(k, 0.0) for k in keep if k.count(".") == 1)
    log(f"[12b] scale_demo n=m={n} p={SCALE_DEMO['p']}: first call "
        f"{line['first_call_s']:.3f} s (spans on the card's clock: "
        + ", ".join(f"{k} {1e3 * first['spans'].get(k, 0.0):.1f}"
                    for k in keep)
        + f", outside them {1e3 * outside:.1f} ms), steady "
        f"{line['value']:.3f} s; K1 at "
        f"C={line['cluster']} (smallest {line['smallest_cluster']}), "
        f"launches {line['k1_launches']}; peak "
        f"{line['peak_bytes'] / 1e9:.3f} GB; accuracy {acc:.4f}, gt {gt:.4f}"
        f"; a third call, spans on the card's clock, {wall:.3f} s: "
        + ", ".join(f"{k} {1e3 * spans.get(k, 0.0):.1f}" for k in keep)
        + f" ms; {smi}")
    log("[12b] line " + json.dumps(line))

    chk = RunConfig(**TRAINER_CHECK)
    t0 = time.perf_counter()
    with_k1 = run_config(chk, seed=3, use_kernel=True, device="cuda")
    t_k1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    autograd = run_config(chk, seed=3, use_kernel=False, device="cuda")
    t_ag = time.perf_counter() - t0
    worst = compare_results(with_k1, autograd, "[12b] K1 vs autograd")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    log(f"[12b] trainers at n=m={chk.n}, p={chk.p}, {chk.num_epochs} epochs:"
        f" K1 {t_k1:.2f} s, autograd {t_ag:.2f} s; 23 keys within rtol "
        f"{CARD_CPU_RTOL}, atol {CARD_CPU_ATOL}; largest |diff| "
        + ", ".join(f"{k} {v:.3g}" for k, v in top) + f"; {smi}")
    return line


def weak_scaling_phase(smi):
    """[12c] ``weak_scaling``'s fixed work over gloo ranks sharing the card
    (and NCCL ranks, one a card, where there are 4 cards): the census and
    the results are checked inside.  Returns K1's launches a rank."""
    from mfcd_tpu_torch.scripts import weak_scaling

    runs = [weak_scaling.scaling(WEAK_RANKS, "cuda", backend="gloo",
                                 timeout_s=MESH_TIMEOUT_S)]
    if torch.cuda.device_count() >= 4:
        runs.append(weak_scaling.scaling([4], "cuda",
                                         timeout_s=MESH_TIMEOUT_S))
    launches = {}
    for out in runs:
        for row in out["scaling"]:
            key = f"{row['ranks']}_{row['backend']}"
            launches[key] = row["k1_launches_by_rank"]
            census = out["census"][str(row["ranks"])]
            log(f"[12c] weak scaling, {row['ranks']} {row['backend']} "
                f"rank(s): {out['fixed_total_work']['total_runs']} runs in "
                f"{row['wall_s']:.4f} s ({row['s_per_run']:.5f} s/run; walls "
                f"by rank {row['walls_by_rank']}), acc {row['acc_mean']:.4f};"
                f" census a chunk {out['per_chunk']} at "
                f"{[c['configs'] for c in census['chunks']]} configs, train "
                f"stage {census['train_stage'] or 'none'}; K1 launches a rank"
                f" {row['k1_launches_by_rank']}; every key equal to the "
                f"unsharded bucket's but the metric block's: "
                + _gap_text(row["rounded_gaps"]) + f"; {smi}")
    return launches


def forward_probe_phase(smi):
    """[12d] The forward probe on the card against the same params and
    indices on the CPU."""
    from mfcd_tpu_torch.scripts import graft_entry

    fn, args = graft_entry.entry("cuda")
    out = fn(*args)
    torch.cuda.synchronize()
    ms = time_ms(lambda: fn(*args), warmup=2, reps=20)
    params, u, i, j = args
    cpu = type(params)(params.U.cpu(), params.V.cpu())
    want = fn(cpu, u.cpu(), i.cpu(), j.cpu())
    err = float((out.cpu() - want).abs().max())
    bound = PROBE_RTOL * float(want.abs().max()) + PROBE_ATOL
    if out.shape != (graft_entry.BATCH,) or not torch.isfinite(out).all():
        fail(f"[12d] forward probe: shape {tuple(out.shape)}, finite "
             f"{bool(torch.isfinite(out).all())}")
    if err > bound:
        fail(f"[12d] forward probe: max|diff| {err:.3g} > {bound:.3g}")
    log(f"[12d] forward probe: {graft_entry.BATCH} triplets at n=m="
        f"{graft_entry.N}, d={graft_entry.D}: {ms:.4f} ms, max|diff| to the "
        f"CPU {err:.3g} (bound {bound:.3g}), mean {float(out.mean()):.6f}; "
        f"{smi}")


def _gap_text(gaps) -> str:
    """The rounded keys' largest |diff|, or that there was none."""
    from mfcd_tpu_torch.scripts.dryrun_multichip import (ROUNDED_ATOL,
                                                         ROUNDED_RTOL)

    moved = {k: v for k, v in gaps.items() if v}
    if not moved:
        return "bit-equal too"
    return (", ".join(f"{k} {v:.3g}" for k, v in sorted(moved.items()))
            + f" (bound rtol {ROUNDED_RTOL}, atol {ROUNDED_ATOL}; "
            "svd_error_scaled squared)")


def k_kernel_phase(dev, smi):
    """[13a] K1 against its plain version on the card at the label
    redundancy streams of ``K_CASES`` (R = 2), two launches and the chosen
    launch shape bit-equal to C = 1 and packed; ms an epoch, us a step,
    the bound and the plain version's ms.  Returns (max |diff|, entries)."""
    from mfcd_tpu_torch.ops import kernels
    from mfcd_tpu_torch.scripts.profile_kernel_split import median_ms

    n = m = 1000
    d, bs, r = 2, 64, 2
    worst, entries = 0.0, []
    for label, seed, mode, soft_k, nb, counts in K_CASES:
        inp = make_epoch_inputs(seed, r, n, m, d, bs, nb, counts,
                                [1e-3, 3e-3], mode, dev, soft_k=soft_k)
        tag = f"[13a] {label} ({nb} batches, pack {mode})"
        err, plain_ms, _ = compare_epoch(inp, tag)
        worst = max(worst, err)
        k1_launch_checks(inp, tag)
        args = (inp["stream"], inp["lr"], inp["wd"], inp["step0"],
                inp["count"])
        ms = median_ms(lambda st: kernels.train_epoch(
            st, *args, pack=inp["pack"]), inp["state"], warmup=1, reps=5)
        steps = executed_steps(inp, bs) / r
        bound, by = epoch_bound_ms(inp, n, m, d, bs)
        entry = dict(label=label, r=r, pack=mode, padded_batches=nb,
                     steps=steps, max_abs_err=err,
                     cluster=kernels.cluster_size(r, n, m, d, bs, dev),
                     ms=ms, us_per_step=ms * 1e3 / steps, bound_ms=bound,
                     bound_by=by, plain_ms=plain_ms)
        log(f"{tag}: K1 at C={entry['cluster']} {ms:.4f} ms an epoch "
            f"({entry['us_per_step']:.4f} us a step over {steps:.0f} "
            f"steps), plain {plain_ms:.2f} ms, bound {bound:.6f} ms ({by});"
            f" {smi}")
        entries.append(entry)
    return worst, entries


def bench_phase(smi):
    """[13b] ``python3 -m mfcd_tpu_torch.bench --quick`` in a subprocess
    (rc 0, one JSON line: the JAX bench's metric name, a value above 0,
    the card); then ``bench.run_mode`` for the default headline (with its
    K = 10 kernel path), ``--sweep`` and ``--k50``, the autograd child
    skipped: 30 K1 launches a call (30 a chunk in the sweep), peak memory
    per run beside ``run_bytes``, accuracy above ACC_MIN at the canonical
    configuration and at K = 50; then one more K = 50 call with its stage
    spans on the card's clock.  Returns the numbers by mode."""
    import subprocess

    from mfcd_tpu_torch import bench
    from mfcd_tpu_torch.sweep import batched
    from mfcd_tpu_torch.sweep.batched import run_bucket
    from mfcd_tpu_torch.sweep.engine import compile_caps

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mfcd_tpu_torch.bench", "--quick"],
        stdout=subprocess.PIPE, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    if proc.returncode != 0 or len(lines) != 1:
        fail(f"[13b] bench --quick: rc {proc.returncode}, stdout "
             f"{proc.stdout[-2000:]!r}")
    rec = json.loads(lines[0])
    if (rec.get("metric") != bench.METRICS["quick"]
            or not rec.get("value", 0) > 0 or rec.get("card") != smi
            or rec.get("unit") != bench.UNIT):
        fail(f"[13b] bench --quick line {rec}")
    log(f"[13b] python3 -m mfcd_tpu_torch.bench --quick: one JSON line in "
        f"{time.perf_counter() - t0:.1f} s: {lines[0]}")

    out = {"quick": rec}
    for mode in ("default", "sweep", "k50"):
        payload, measured = bench.run_mode(mode, "cuda", jnp_timeout_s=0)
        if payload["metric"] != bench.METRICS[mode] or payload["card"] != smi:
            fail(f"[13b] {mode}: line {payload}")
        for meas in measured:
            cfg = meas["cfg"]
            if mode == "sweep":
                t_cap = compile_caps(cfg)[0]
                per_chunk = min(meas["configs"], batched.default_max_bucket(
                    cfg, t_cap=t_cap, device="cuda"))
                chunks = -(-meas["configs"] // per_chunk)
                chunk_runs = per_chunk * cfg.reps
            else:
                t_cap, chunks, chunk_runs = None, 1, meas["runs"]
            want = cfg.num_epochs * chunks
            if meas["k1_launches"] != want:
                fail(f"[13b] {meas['label']}: {meas['k1_launches']} K1 "
                     f"launches, expected {want}")
            if not all(math.isfinite(a) for a in meas["accuracy"]):
                fail(f"[13b] {meas['label']}: accuracy {meas['accuracy']}")
            if (meas["label"] in ("canonical", "K=50 pallas")
                    and not min(meas["accuracy"]) > ACC_MIN):
                fail(f"[13b] {meas['label']}: accuracy {meas['accuracy']} "
                     f"not above {ACC_MIN}")
            peak = meas["peak_bytes"] / chunk_runs
            est = batched.run_bytes(cfg, t_cap)
            out[meas["label"]] = dict(
                metric=payload["metric"] if meas is measured[0] else None,
                runs=meas["runs"], wall=meas["wall"],
                warm_wall=meas["warm_wall"], s_per_run=meas["s_per_run"],
                runs_per_hour=meas["runs_per_hour"],
                k1_launches=meas["k1_launches"], peak_per_run=peak,
                run_bytes=est, accuracy=meas["accuracy"][:5])
            log(f"[13b] bench {mode}, {meas['label']}: {meas['runs']} runs, "
                f"{meas['runs_per_hour']:.1f} runs/hour, "
                f"{meas['s_per_run']:.4f} s/run (steady {meas['wall']:.3f} "
                f"s" + (f", warm {meas['warm_wall']:.3f} s"
                        if meas["warm_wall"] is not None else "")
                + f"), {meas['k1_launches']} K1 launches ({chunks} "
                f"chunk{'s' if chunks > 1 else ''}), peak "
                f"{peak / 1e6:.1f} MB/run, run_bytes {est / 1e6:.1f} MB/run, "
                f"accuracy head {[round(a, 4) for a in meas['accuracy'][:5]]}"
                f"; {smi}")
        log(f"[13b] bench {mode} line {json.dumps(payload)}")

    k50 = out["K=50 pallas"]
    cfg = measured[0]["cfg"]  # the K = 50 call's
    wall, spans = _card_spans(lambda: run_bucket(
        cfg, [{"s": cfg.s, "lr": cfg.lr, "weight_decay": cfg.weight_decay}],
        [0], seed=bench.TIMED_SEED, device="cuda", use_kernel=True))
    keep = ("mfcd.generate", "mfcd.sample", "mfcd.label", "mfcd.train.mix",
            "mfcd.train.epoch", "mfcd.train.val", "mfcd.metrics")
    k50["spans_ms"] = {k: 1e3 * spans.get(k, 0.0) for k in keep}
    log(f"[13b] K=50 hard, one call, spans on the card's clock, {wall:.3f} s "
        f"(steady {k50['wall']:.3f} s): "
        + ", ".join(f"{k} {1e3 * spans.get(k, 0.0):.1f} ms "
                    f"({spans.get(k, 0.0) / wall:.1%})" for k in keep)
        + f"; {smi}")
    return out


def k_trainer_phase(smi):
    """[13c] ``run_config`` at hard K = 10 (one epoch, reps = 1) with K1
    and with the autograd trainer on the card: the 23 keys within [5]'s
    bound.  Returns the autograd ms a step (the call's wall over its
    steps)."""
    from mfcd_tpu_torch.core.config import RunConfig
    from mfcd_tpu_torch.sweep.engine import run_config

    cfg = RunConfig(**K_TRAINER_CHECK)
    t0 = time.perf_counter()
    with_k1 = run_config(cfg, seed=5, use_kernel=True, device="cuda")
    t_k1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    autograd = run_config(cfg, seed=5, use_kernel=False, device="cuda")
    t_ag = time.perf_counter() - t0
    worst = compare_results(with_k1, autograd, "[13c] K1 vs autograd")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    steps = cfg.shapes().train_batches * cfg.num_epochs
    ms_step = t_ag * 1e3 / steps
    log(f"[13c] trainers at hard K={cfg.K}, n=m={cfg.n}, "
        f"{cfg.num_epochs} epoch ({steps} steps): K1 {t_k1:.2f} s, "
        f"autograd {t_ag:.2f} s ({ms_step:.4f} ms a step, the call's wall "
        f"over its steps); 23 keys within rtol {CARD_CPU_RTOL}, atol "
        f"{CARD_CPU_ATOL}; largest |diff| "
        + ", ".join(f"{k} {v:.3g}" for k, v in top) + f"; {smi}")
    return dict(k1_s=t_k1, autograd_s=t_ag, autograd_ms_per_step=ms_step)


def k_axis_phase(smi):
    """[13d] ``parameter_scan_fast`` over the notebook's soft K axis
    (``K_AXIS``): one chunk a K, 30 K1 launches each, every key finite,
    the schema valid, accuracy above ACC_MIN at every K, peak memory per
    run under ``run_bytes``; s/run by K.  Then soft K = 10 at 2 epochs,
    reps = 1, on the card against the CPU within [5]'s bound.  Returns
    the launches and s/run by K."""
    import mfcd_tpu_torch
    from mfcd_tpu_torch.sweep import batched
    from mfcd_tpu_torch.sweep.engine import compile_caps

    _, by_k, chunks, launches, wall = fast_scan_by_chunk(K_AXIS, "K",
                                                         "[13d]")
    s_per_run = {}
    for k in K_AXIS["K"]:
        acc = by_k[k]["accuracy"]
        if not min(acc) > ACC_MIN:
            fail(f"[13d] K={k}: accuracy {acc} not above {ACC_MIN}")
        c = chunks[k]
        s_per_run[k] = c["s"] / c["runs"]
        est = batched.run_bytes(c["cfg"], compile_caps(c["cfg"])[0])
        if c["own_peak"] > est:
            fail(f"[13d] soft K={k}: peak {c['own_peak'] / 1e6:.1f} MB/run "
                 f"above run_bytes {est / 1e6:.1f} MB/run")
        log(f"[13d] soft K={k}: {c['runs']} runs in {c['s']:.3f} s "
            f"({s_per_run[k]:.4f} s/run), accuracy "
            f"{[round(a, 4) for a in acc]}, peak {c['own_peak'] / 1e6:.1f} "
            f"MB/run above what was held before the chunk, run_bytes "
            f"{est / 1e6:.1f} MB/run; {smi}")
    log(f"[13d] parameter_scan_fast over soft K {K_AXIS['K']}: "
        f"{len(chunks)} chunks, {launches} K1 launches, {wall:.3f} s")
    t0 = time.perf_counter()
    on_card = mfcd_tpu_torch.parameter_scan(device="cuda", **K_CARD_CPU)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = mfcd_tpu_torch.parameter_scan(device="cpu", **K_CARD_CPU)
    t_cpu = time.perf_counter() - t0
    worst = compare_results(on_card[0]["results"], on_cpu[0]["results"],
                            "[13d] soft K=10 card vs cpu")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    log(f"[13d] soft K=10, 2 epochs, reps 1: card {t_card:.2f} s, CPU "
        f"{t_cpu:.2f} s; 23 keys within rtol {CARD_CPU_RTOL}, atol "
        f"{CARD_CPU_ATOL}; largest |diff| "
        + ", ".join(f"{k} {v:.3g}" for k, v in top) + f"; {smi}")
    return dict(launches=launches, s_per_run=s_per_run, wall=wall)


def stream_ops(keys, epoch, counts, s_len, k_bits) -> int:
    """32-bit integer operations one S2 epoch needs on these inputs: the
    walks of a fresh epoch over every slot, or of a cheap one over the full
    tiles (one walk a tile), plus each slot's rotation test, plus the
    keys' hashes (11 a run)."""
    from mfcd_tpu_torch.core import prng
    from mfcd_tpu_torch.scripts import ab_shuffle_kernels as ab

    r = keys.shape[0]
    k_prp, _, k_tile = prng.split_reference(
        prng.fold_in_reference(keys, epoch), 3).unbind(-2)
    slots = torch.arange(s_len, device=keys.device)
    if epoch % ab.PERIOD == 0:
        steps = int(ab.walk_steps(k_prp, slots, counts, k_bits).sum())
    else:
        t_bits = max(k_bits - ab.TILE.bit_length() + 1, 1)
        full = counts.to(torch.int64).unsqueeze(-1) // ab.TILE
        tiles = torch.arange(s_len // ab.TILE, device=keys.device)
        walked = ab.walk_steps(k_tile, tiles,
                               torch.clamp(full[:, 0], min=1), t_bits)
        steps = int((walked * (tiles < full)).sum())
    return stream_int_ops(steps, r, s_len)


def stream_int_ops(steps: int, r: int, s_len: int) -> int:
    """S2's integer operations from its walks' ``steps``, over ``r`` runs
    of ``s_len`` slots."""
    return MIX_OPS * steps + SLOT_OPS * r * s_len + HASH_OPS * 11 * r


def stream_bytes(r: int, s_len: int, arrays: int) -> int:
    """S2's bytes: every word of every array read and written once, and a
    key and a count a run."""
    return 8 * r * s_len * arrays + 20 * r


def prp_bytes(r: int, s_len: int, slot_bytes: int = 8,
              shared: bool = True) -> int:
    """S1's bytes: the slots read once (one row of ``slot_bytes``-byte
    slots where ``shared``, else R rows), R rows of int32 written, a key
    and a count a row."""
    return slot_bytes * s_len * (1 if shared else r) + 4 * r * s_len + 20 * r


def walk_ops(mode: str, k_bits: int) -> int:
    """ALU operations of one step of S1's walk of ``mode``: a mix step
    (MIX_OPS), or an unmix step, whose rounds undo the xorshift in
    ceil(k / shift) - 1 passes (2 at k = 17, 1 at k = 30, 0 at k = 1):
    a shift each and one xor of them all (unmix's three-input xor, one
    LOP3) between their two masks; and the test."""
    if mode != "inverse":
        return MIX_OPS
    shift = max(k_bits // 2, 1)
    passes = -(-k_bits // shift) - 1
    return 3 * (2 + passes + (passes > 0)) + 2


def prp_bound(mode: str, key, slots, count, k_bits):
    """S1's bound at one call: its bytes (``prp_bytes``) against its
    walks' steps on these inputs (``ab_shuffle_kernels.walk_steps``) at
    ``walk_ops`` each, a start a slot and 6 hashes a key."""
    from mfcd_tpu_torch.scripts import ab_shuffle_kernels as ab

    r = int(np.prod(np.broadcast_shapes(
        tuple(key.shape[:-1]), tuple(slots.shape[:-1]),
        tuple(count.shape) if isinstance(count, torch.Tensor) else ())))
    s_len = slots.shape[-1]
    steps = int(ab.walk_steps(key, slots, count, k_bits, mode).sum())
    ops = (walk_ops(mode, k_bits) * steps + SLOT_OPS * r * s_len
           + HASH_OPS * 6 * key[..., 0].numel())
    return bound_ms(prp_bytes(r, s_len, slots.element_size(),
                              slots.shape[:-1].numel() == 1), int_ops=ops)


def threefry_bound(n_out: int, words_out: int, r: int):
    """T1's bound: ``words_out`` int64 words written and R keys read,
    ``n_out`` hashes at the integer rate."""
    return bound_ms(8 * words_out + 16 * r, int_ops=HASH_OPS * n_out)


def shuffle_case(dev, label, r, s_len, count, k_bits, arrays, smi):
    """[14a] One shape: S2 (a fresh and a cheap epoch, from the epoch's
    folded keys as the trainer calls it), T1 (``bits`` over [R, S],
    ``fold_in`` of R keys by an integer, ``split`` of R keys into 9) and S1
    at its forms, each bit-equal to its plain version, with its device and
    host issue ms (``ab_shuffle_kernels.queue_ms``) beside the plain
    version's and the bound at PEAK_INT32_OPS.  Returns the entry."""
    from mfcd_tpu_torch.core import prng
    from mfcd_tpu_torch.ops import shuffle
    from mfcd_tpu_torch.scripts import ab_shuffle_kernels as ab

    keys, counts, words = ab.case_inputs(r, s_len, count, arrays, dev)
    kw = dict(period=ab.PERIOD, tile_w=ab.TILE)
    entry = dict(label=label, r=r, s=s_len, count=count, k_bits=k_bits,
                 arrays=arrays)

    def timed(name, this, plain, bound):
        got, want = this(), plain()
        torch.cuda.synchronize()
        pairs = zip(got, want) if isinstance(got, tuple) else ((got, want),)
        if not all(ab._same(a, b) for a, b in pairs):
            fail(f"[14a] {label}: {name} differs from its plain version")
        ms, host_ms = ab.queue_ms(this, rounds=QUEUE_ROUNDS)
        return dict(ms=ms, host_ms=host_ms, plain_ms=time_ms(plain, 1, 3),
                    bound_ms=bound[0], bound_by=bound[1])

    # S2: epoch 0 is a fresh PRP gather, epoch 1 a cheap one.
    epoch_keys = prng.split(keys, 2)
    s2 = {}
    for epoch, kind in ((0, "fresh"), (1, "cheap")):
        s2[kind] = timed(
            f"S2 {kind}",
            lambda ek=epoch_keys[:, epoch], epoch=epoch: shuffle.mix_stream(
                words, ek, epoch, counts, k_bits, folded=True, **kw),
            lambda epoch=epoch: shuffle.mix_stream_reference(
                words, keys, epoch, counts, k_bits, **kw),
            bound_ms(stream_bytes(r, s_len, arrays), int_ops=stream_ops(
                keys, epoch, counts, s_len, k_bits)))
    mean = lambda k: (s2["fresh"][k] + 3 * s2["cheap"][k]) / 4
    entry["mix_stream"] = dict(
        s2, **{k: mean(k) for k in ("ms", "host_ms", "plain_ms",
                                    "bound_ms")},
        bound_by=s2["cheap"]["bound_by"])
    # S1 at its forms (ab.prp_forms): the three walks over one shared row
    # of the stream's int64 slots, and prp_splits' two calls.
    entry["shuffle_prp"] = {
        name: prp_entry(*form)
        for name, form in ab.prp_forms(keys, counts, s_len, k_bits).items()}
    # T1: the counter entry's bits and split, the hash entry's fold_in.
    entry["threefry2x32"] = {
        "bits": timed("T1 bits", lambda: prng.bits(keys, (s_len,)),
                      lambda: prng.bits_reference(keys, (s_len,)),
                      threefry_bound(r * s_len, r * s_len, r)),
        "fold_in": timed("T1 fold_in", lambda: prng.fold_in(keys, 7),
                         lambda: prng.fold_in_reference(keys, 7),
                         threefry_bound(r, 2 * r, r)),
        "split": timed("T1 split", lambda: prng.split(keys, 9),
                       lambda: prng.split_reference(keys, 9),
                       threefry_bound(9 * r, 18 * r, r)),
    }
    log(f"[14a] {label} (R={r}, S={s_len}, count {count}, k={k_bits}, "
        f"{arrays} array{'s' if arrays > 1 else ''}): S1, S2, T1 bit-equal "
        f"to their plain versions; device ms a call (host issue ms): S2 "
        f"fresh {_row(s2['fresh'])}; S2 cheap {_row(s2['cheap'])}; period "
        f"mean {entry['mix_stream']['ms']:.4f}; "
        + "; ".join(f"T1 {k} {_row(v)}"
                    for k, v in entry["threefry2x32"].items())
        + "; " + "; ".join(f"S1 {k} {_row(v)}"
                           for k, v in entry["shuffle_prp"].items())
        + f"; {smi}")
    return entry


def _row(v) -> str:
    return (f"{v['ms']:.4f} ({v['host_ms']:.4f}); plain "
            f"{v['plain_ms']:.2f}, bound {v['bound_ms']:.6f} {v['bound_by']}")


PRP_MODES = {0: "capped", 1: "exact", 2: "inverse"}
# The keys of an S1 entry that the kernels line carries.
PRP_KEYS = ("ms", "host_ms", "plain_ms", "bound_ms", "bound_by")


def prp_entry(mode, key, slots, count, k_bits):
    """One S1 call, bit-equal to its plain version, with its device and
    host issue ms, its plain version's ms and its bound."""
    from mfcd_tpu_torch.ops import shuffle
    from mfcd_tpu_torch.scripts import ab_shuffle_kernels as ab

    form = (mode, key, slots, count, k_bits)
    name = ab.PRP_FNS[mode]
    this = lambda: getattr(shuffle, name)(key, slots, count, k_bits)
    plain = lambda: getattr(shuffle, name + "_reference")(key, slots, count,
                                                          k_bits)
    if not ab._same(this(), plain()):
        fail(f"[14] S1 at {ab.describe(*form)} differs from its plain "
             f"version")
    ms, host_ms = ab.queue_ms(this, rounds=QUEUE_ROUNDS)
    bound, by = prp_bound(PRP_MODES[mode], key, slots, count, k_bits)
    return dict(ab.describe(*form), ms=ms, host_ms=host_ms,
                plain_ms=time_ms(plain, 1, 3), bound_ms=bound, bound_by=by)


def main_path_prp_phase(smi):
    """[14c] S1 at the calls the main path makes: each configuration of
    ``ab.record_prp_calls`` run at one epoch with S1's arguments recorded,
    then each call replayed through ``prp_entry``.  Returns {configuration:
    [entries]}."""
    from mfcd_tpu_torch.scripts import ab_shuffle_kernels as ab

    t0 = time.perf_counter()
    recorded = ab.record_prp_calls(torch.device("cuda"))
    wall = time.perf_counter() - t0
    out = {}
    for label, calls in recorded.items():
        if not calls:
            log(f"[14c] {label}: no S1 call")
        out[label] = [prp_entry(*call) for call in calls]
        for e in out[label]:
            log(f"[14c] {label}: {e['fn']}, key {e['key']} stride "
                f"{e['key_stride']}, slots {e['slots']} {e['slots_dtype']} "
                f"stride {e['slots_stride']}, count {e['count']}, k "
                f"{e['k_bits']}: bit-equal; {_row(e)}; {smi}")
    log(f"[14c] main-path S1 calls recorded in {wall:.1f} s")
    return out


def strict_loop_phase(smi):
    """[14b] The canonical configuration through ``run_config`` with
    ``train_runs_kernel`` under ``torch.cuda.set_sync_debug_mode("error")``:
    a host sync anywhere in the trainer (the epoch loop included) raises.
    Two calls, the second timed (s/run); 30 S2 and 30 K1 launches a call.
    Then one call with the stage spans on the card's clock
    (``_card_spans``).
    Returns the numbers."""
    from mfcd_tpu_torch.core.config import RunConfig
    from mfcd_tpu_torch.ops import kernels, shuffle
    from mfcd_tpu_torch.sweep import engine

    cfg = RunConfig(n=CANON["n"], m=CANON["m"], d=CANON["d"],
                    p=CANON["p"], s=CANON["s"][0], lr=CANON["lr"],
                    weight_decay=CANON["weight_decay"],
                    num_epochs=CANON["num_epochs"], reps=CANON["reps"])
    inner = engine.train_runs_kernel

    def strict(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    engine.train_runs_kernel = strict
    try:
        walls = []
        for _ in range(2):
            s2, k1 = shuffle.SHUFFLE_LAUNCHES, kernels.EPOCH_LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = engine.run_config(cfg, seed=0, device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            s2 = shuffle.SHUFFLE_LAUNCHES - s2
            k1 = kernels.EPOCH_LAUNCHES - k1
            if s2 != cfg.num_epochs or k1 != cfg.num_epochs:
                fail(f"[14b] {s2} S2 and {k1} K1 launches, expected "
                     f"{cfg.num_epochs} each")
    finally:
        engine.train_runs_kernel = inner
    if not all_finite(res) or not float(np.mean(res["accuracy"])) > ACC_MIN:
        fail(f"[14b] accuracy {res['accuracy']}")
    wall, spans = _card_spans(lambda: engine.run_config(
        cfg, seed=0, device="cuda"))
    keep = ("mfcd.generate", "mfcd.sample", "mfcd.label", "mfcd.train",
            "mfcd.train.mix", "mfcd.train.epoch", "mfcd.train.val",
            "mfcd.metrics", "mfcd.export")
    out = dict(s_per_run=walls[1] / cfg.reps, walls=walls,
               spans_wall=wall,
               spans_ms={k: 1e3 * spans.get(k, 0.0) for k in keep})
    log(f"[14b] canonical run_config, train_runs_kernel under sync debug "
        f"mode 'error': no host sync; {cfg.num_epochs} S2 and "
        f"{cfg.num_epochs} K1 launches a call; walls "
        f"{', '.join(f'{w:.4f}' for w in walls)} s, "
        f"{out['s_per_run']:.4f} s/run; accuracy "
        f"{[round(float(a), 4) for a in res['accuracy']]}; a call with "
        f"spans on the card's clock {wall:.4f} s: "
        + ", ".join(f"{k} {v:.1f} ms ({v / 1e3 / wall:.1%})"
                    for k, v in out["spans_ms"].items()) + f"; {smi}")
    return out


def shuffle_phase(dev, smi, main_launches):
    """[14] S1, S2 and T1 at every shape of ``ab.SHUFFLE_CASES`` against
    their plain versions, the canonical epoch loop with no host sync, then
    S1 at the main path's own calls.  Returns (cases, loop, main-path S1
    calls)."""
    from mfcd_tpu_torch.scripts import ab_shuffle_kernels as ab

    t0 = time.perf_counter()
    log(f"[14] launches of a canonical parameter_scan call ([4]): S2 "
        f"{main_launches['s2']}, T1 {main_launches['t1']}, S1 "
        f"{main_launches['s1']}")
    cases = [shuffle_case(dev, *case, smi) for case in ab.SHUFFLE_CASES]
    loop = strict_loop_phase(smi)
    main_path = main_path_prp_phase(smi)
    log(f"[14] epoch shuffle and threefry: {time.perf_counter() - t0:.1f} s")
    return cases, loop, main_path


def loss_pass_bytes(runs: int, rows: int, n: int, m: int, d: int,
                    bs: int) -> int:
    """L1's bytes, each once: a row's u, i, j, z and valid (17), the
    tables, the per-batch and epoch means written."""
    batches = -(-rows // bs)
    return runs * (rows * 17 + (n + m) * d * 4 + (batches + 1) * 4)


def loss_pass_phase(smi, main_launches):
    """[15] L1 against its plain version at ``L1_SHAPES``, its device and
    host ms a pass against the plain version's and the bound.  Returns
    the entries."""
    from mfcd_tpu_torch.data.btl import LabeledSplit
    from mfcd_tpu_torch.models.mf import MFParams
    from mfcd_tpu_torch.ops import loss_pass
    from mfcd_tpu_torch.scripts import ab_shuffle_kernels as ab

    n, m, d, bs = 1000, 1000, 2, 64
    entries = []
    for label, runs, rows, count in L1_SHAPES:
        g = np.random.default_rng(rows)
        dev = torch.device("cuda")
        t = lambda a: torch.as_tensor(a, device=dev)
        u = g.integers(0, n, (runs, rows)).astype(np.int32)
        i = g.integers(0, m, (runs, rows)).astype(np.int32)
        j = ((i + g.integers(1, m, (runs, rows))) % m).astype(np.int32)
        z = (g.random((runs, rows)) < 0.5).astype(np.float32)
        valid = np.tile(np.arange(rows) < count, (runs, 1))
        split = LabeledSplit(t(u), t(i), t(j), t(z), t(valid),
                             t(np.full(runs, count, np.int32)))
        # the trainer's [R, d, n] storage, read as [R, n, d] views
        params = MFParams(*[t((g.standard_normal((runs, d, k)) / np.sqrt(d))
                              .astype(np.float32)).transpose(1, 2)
                            for k in (n, m)])
        want = loss_pass.batch_losses_reference(params, split, bs)
        before = loss_pass.LOSS_LAUNCHES
        got = loss_pass.batch_losses(params, split, bs)
        again = loss_pass.batch_losses(params, split, bs)
        torch.cuda.synchronize()
        if loss_pass.LOSS_LAUNCHES != before + 4:
            fail(f"[15] {label}: {loss_pass.LOSS_LAUNCHES - before} L1 "
                 f"launches for two passes, expected 4")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"[15] {label}: two passes differ")
        errs = []
        for name, a, b in zip(("per-batch means", "epoch means"), want, got):
            err = float((a - b).abs().max())
            scale = float(a.abs().max())
            errs.append(err)
            if not torch.isfinite(b).all() or err > L1_RTOL * scale + L1_ATOL:
                fail(f"[15] {label}: {name} max|diff| {err:.3g} > {L1_RTOL}"
                     f" x max|ref| {scale:.3g} + {L1_ATOL}")
        ms, host_ms = ab.queue_ms(
            lambda: loss_pass.batch_losses(params, split, bs))
        plain_ms = time_ms(
            lambda: loss_pass.batch_losses_reference(params, split, bs),
            warmup=1, reps=5)
        nbytes = loss_pass_bytes(runs, rows, n, m, d, bs)
        bound, by = bound_ms(nbytes)
        entries.append(dict(label=label, runs=runs, rows=rows, valid=count,
                            max_abs_err=max(errs), ms=ms, host_ms=host_ms,
                            plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                            bytes=nbytes))
        log(f"[15] L1 {label} (R={runs}, {rows} rows, {count} valid): "
            f"max|diff| per-batch {errs[0]:.3g}, epoch {errs[1]:.3g}; two "
            f"passes bit-equal; device {ms:.6f} ms a pass (host issue "
            f"{host_ms:.6f}), plain {plain_ms:.4f} ms, bound {bound:.6f} ms "
            f"({by}, {nbytes} bytes); {smi}")
    log(f"[15] L1 launches of [4]'s call: {main_launches['l1']}")
    from mfcd_tpu_torch.scripts import ab_test_pass as tp
    tests = []
    for shape in tp.TEST_SHAPES:
        try:
            e = tp.measure(*shape, torch.device("cuda"))
        except AssertionError as exc:
            fail(f"[15] test pass: {exc}")
        tests.append(e)
        log(f"[15] test pass {e['label']} (R={e['runs']}, {e['rows']} rows, "
            f"{e['valid']} valid): {', '.join(e['checks'])} bit-equal; "
            f"device {e['test_pass_ms']:.6f} ms a call (host issue "
            f"{e['test_pass_host_ms']:.4f}), wall {e['test_pass_wall_ms']:.4f}"
            f" against the eager path's {e['eager_wall_ms']:.4f}; {smi}")
    return entries, tests


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import mfcd_tpu_torch
    from mfcd_tpu_torch.backend import card_line
    from mfcd_tpu_torch.core.results import validate_schema
    from mfcd_tpu_torch.core import prng
    from mfcd_tpu_torch.ops import _build, kernels, loss_pass, shuffle

    global PEAK_INT32_OPS
    t_all = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = card_line()
    sms, clock_mhz = card_int_rate()
    PEAK_INT32_OPS = peak_int32_ops(sms, clock_mhz)
    log(f"[1] device: {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s); "
        f"{sms} SMs, max SM clock {clock_mhz:g} MHz: PEAK_INT32_OPS "
        f"{PEAK_INT32_OPS:.6g} a second ({INT32_PER_SM} a clock an SM)")

    t0 = time.perf_counter()
    built = _build.build_all(force=True)
    log(f"[2] build: {len(built)} librar{'y' if len(built) == 1 else 'ies'} "
        f"in {time.perf_counter() - t0:.2f} s")
    for src, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    # [3] K1 vs plain version in every case, then timing.
    n, m, d, bs, nb = 1000, 1000, 2, 64, 2048
    max_err, canon, timings = k1_phase(dev, n, m, d, bs, nb)
    args = (canon["stream"], canon["lr"], canon["wd"], canon["step0"],
            canon["count"])
    kernel_ms = timings[0]["ms"]
    plain_ms = time_ms(
        lambda: kernels.train_epoch_reference(canon["state"], *args,
                                              pack=canon["pack"]),
        warmup=1, reps=3)
    k1_bound, k1_by = epoch_bound_ms(canon, n, m, d, bs)
    log(f"[3] epoch R=4 canonical: kernel {kernel_ms:.4f} ms at C="
        f"{timings[0]['cluster']}, plain {plain_ms:.2f} ms, bound "
        f"{k1_bound:.6f} ms ({k1_by})")

    split_entries = kernel_split_phase(dev, n, m, d, bs)
    # [4] The main path at full width, launches counted around it.
    with tempfile.TemporaryDirectory(prefix="mfcd_chip_smoke_") as tmp:
        save_path = os.path.join(tmp, "scan.pkl")
        torch.cuda.synchronize()
        kernels.EPOCH_LAUNCHES = 0
        shuffle.SHUFFLE_LAUNCHES = shuffle.PRP_LAUNCHES = 0
        prng.THREEFRY_LAUNCHES = 0
        loss_pass.LOSS_LAUNCHES = 0
        t0 = time.perf_counter()
        out = mfcd_tpu_torch.parameter_scan(save_path=save_path,
                                            save_every=1, **CANON)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.EPOCH_LAUNCHES
        main_launches = dict(s2=shuffle.SHUFFLE_LAUNCHES,
                             s1=shuffle.PRP_LAUNCHES,
                             t1=prng.THREEFRY_LAUNCHES,
                             l1=loss_pass.LOSS_LAUNCHES)
        with open(save_path, "rb") as f:
            saved = pickle.load(f)
    if launches != CANON["num_epochs"]:
        fail(f"main path launched the epoch kernel {launches} times, "
             f"expected {CANON['num_epochs']}")
    if main_launches["s2"] != CANON["num_epochs"]:
        fail(f"main path launched the epoch shuffle S2 "
             f"{main_launches['s2']} times, expected {CANON['num_epochs']}")
    if not (main_launches["s1"] > 0 and main_launches["t1"] > 0):
        fail(f"main path launched S1 {main_launches['s1']} and T1 "
             f"{main_launches['t1']} times")
    if main_launches["l1"] != 2 * (CANON["num_epochs"] + 1):
        fail(f"main path launched L1 {main_launches['l1']} times, expected "
             f"2 for each of {CANON['num_epochs']} validation passes and "
             f"the test loss")
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
        f"{wall:.3f} s ({wall / runs:.4f} s/run), {launches} K1 launches, "
        f"{main_launches['s2']} S2, {main_launches['s1']} S1, "
        f"{main_launches['t1']} T1, {main_launches['l1']} L1, mean accuracy "
        f"{acc:.4f}, gt accuracy "
        f"{float(np.mean(res['gt_accuracy'])):.4f}, final train loss "
        f"{float(np.mean([c[-1] for c in res['train_losses']])):.4f}")

    fast_ref = fast_path_phase()

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

    # [6] The other eight samplers: the sample stage card vs CPU, then both
    # sweep paths.
    t0 = time.perf_counter()
    info = sampler_phase(dev)
    strategy_launches = strategy_scan_phase(info, smi)
    log(f"[6] strategies: {time.perf_counter() - t0:.1f} s")

    # [7] The other ten generators: the generation stage card vs CPU, the
    # batched scan over all ten, and the ground-truth oracle.
    t0 = time.perf_counter()
    gen_info = generation_phase(dev)
    generation_launches = generation_scan_phase(gen_info, smi)
    ground_truth_phase()
    log(f"[7] generators and ground truth: {time.perf_counter() - t0:.1f} s")

    # [8] The study's sweeps at full width.
    study_launches, cell18_ref = study_phase(smi)

    # [9] AltSVM: K2 against its plain version, then the model at full size.
    alt_entries = altsvm_phase(dev, smi)

    # [10] A scan over four chunks, twice.
    chunk_run = chunk_phase(smi)

    # [11] The mesh: the sharded step, the grid-sharded sweep and cell 18
    # over ranks of torch.distributed jobs on the card.
    mesh_launches = mesh_phase(smi, fast_ref, cell18_ref)

    # [12] K1 where the shape needs a cluster, the scale demo, weak scaling
    # and the forward probe.
    t0 = time.perf_counter()
    scale_entries, scale_err = scale_kernel_phase(dev, smi)
    demo = scale_demo_phase(smi)
    weak = weak_scaling_phase(smi)
    forward_probe_phase(smi)
    log(f"[12] scale: {time.perf_counter() - t0:.1f} s")

    # [13] Label redundancy: K1 at hard K = 10's and soft K = 50's
    # streams, the bench, K1 against autograd at K = 10, the soft K axis.
    t0 = time.perf_counter()
    k_err, k_entries = k_kernel_phase(dev, smi)
    bench_info = bench_phase(smi)
    k_trainers = k_trainer_phase(smi)
    k_axis = k_axis_phase(smi)
    log(f"[13] label redundancy: {time.perf_counter() - t0:.1f} s")

    # [14] The epoch shuffle (S1, S2) and threefry (T1) against their plain
    # versions at the main path's shapes, and the canonical epoch loop with
    # no host sync.
    shuffle_cases, strict_loop, prp_main = shuffle_phase(dev, smi,
                                                         main_launches)
    canon_shuffle = shuffle_cases[0]
    canon_prp = prp_main["canonical"][0]

    # [15] The validation pass's kernel against its plain version at the
    # cells' validation splits.
    l1_entries, test_pass_entries = loss_pass_phase(smi, main_launches)

    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "fused_train_epoch",
        "route": "cuda",
        "source": "mfcd_tpu_torch/ops/csrc/epoch_kernel.cu",
        "replaces": "mfcd_tpu/ops/kernels.py:69",
        "launches": launches,
        "max_abs_err": max(max_err, scale_err, k_err),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
        "strategy_launches": strategy_launches,
        "generation_launches": generation_launches,
        "study_launches": study_launches,
        "mesh_launches": mesh_launches,
        "scale_demo_launches": demo["k1_launches"],
        "weak_scaling_launches": weak,
        "scale_shapes": scale_entries,
        "label_redundancy": k_entries,
        "bench": bench_info,
        "k_trainers": k_trainers,
        "k_axis_launches": k_axis["launches"],
        "k_axis_s_per_run": k_axis["s_per_run"],
        "cluster": timings[0]["cluster"],
        "blocks_per_sm": timings[0]["blocks_per_sm"],
        "regimes": timings,
        "chunks": chunk_run,
    }, {
        "name": "shuffle_prp",
        "route": "cuda",
        "source": "mfcd_tpu_torch/ops/csrc/shuffle_kernel.cu",
        "replaces": "mfcd_tpu/ops/shuffle.py:57",
        "launches": main_launches["s1"],
        "max_abs_err": 0,
        "redesigned": True,
        # ms to bound_by: the capped walk over [14a]'s shared int64 row,
        # as in every PR before; main_path_*: the canonical run's first S1
        # call as it makes it.
        **{k: canon_shuffle["shuffle_prp"]["capped"][k] for k in PRP_KEYS},
        **{f"main_path_{k}": canon_prp[k] for k in PRP_KEYS},
        "library_ms": None,
        "modes": {c["label"]: c["shuffle_prp"] for c in shuffle_cases},
        "main_path": prp_main,
    }, {
        "name": "mix_stream",
        "route": "cuda",
        "source": "mfcd_tpu_torch/ops/csrc/shuffle_kernel.cu",
        "replaces": "mfcd_tpu/ops/shuffle.py:284",
        "launches": main_launches["s2"],
        "max_abs_err": 0,
        "redesigned": True,
        "ms": canon_shuffle["mix_stream"]["ms"],
        "host_ms": canon_shuffle["mix_stream"]["host_ms"],
        "plain_ms": canon_shuffle["mix_stream"]["plain_ms"],
        "bound_ms": canon_shuffle["mix_stream"]["bound_ms"],
        "bound_by": canon_shuffle["mix_stream"]["bound_by"],
        "library_ms": None,
        "cases": {c["label"]: c["mix_stream"] for c in shuffle_cases},
        "strict_loop": strict_loop,
    }, {
        "name": "threefry2x32",
        "route": "cuda",
        "source": "mfcd_tpu_torch/ops/csrc/prng_kernel.cu",
        "replaces": "mfcd_tpu/ops/shuffle.py:39",
        "launches": main_launches["t1"],
        "max_abs_err": 0,
        "redesigned": True,
        "ms": canon_shuffle["threefry2x32"]["bits"]["ms"],
        "host_ms": canon_shuffle["threefry2x32"]["bits"]["host_ms"],
        "plain_ms": canon_shuffle["threefry2x32"]["bits"]["plain_ms"],
        "bound_ms": canon_shuffle["threefry2x32"]["bits"]["bound_ms"],
        "bound_by": canon_shuffle["threefry2x32"]["bits"]["bound_by"],
        "library_ms": None,
        "cases": {c["label"]: c["threefry2x32"] for c in shuffle_cases},
    }, {
        "name": "loss_pass",
        "route": "cuda",
        "source": "mfcd_tpu_torch/ops/csrc/loss_pass.cu",
        "replaces": "none: XLA's fusion of mfcd_tpu/train/trainer.py:91",
        "launches": main_launches["l1"],
        "max_abs_err": max(e["max_abs_err"] for e in l1_entries),
        **{k: l1_entries[0][k] for k in ("ms", "host_ms", "plain_ms",
                                         "bound_ms", "bound_by")},
        "library_ms": None,
        "cases": l1_entries,
        "test_pass": test_pass_entries,
    }] + split_entries + alt_entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
