"""mfcd_tpu_torch — the PyTorch/CUDA port of ``mfcd_tpu``.

Matrix factorization with comparison data, on an NVIDIA H100: the same
sweep engine (sequential and batched), samplers, labels, trainer and
metrics as the JAX package, with its fused training epoch as a
hand-written CUDA kernel (``ops/csrc/epoch_kernel.cu``) and the
kernel-split profiler's two kernels beside it (``ops/kernel_split.py``).
Every generation mode and sampling strategy of the JAX package runs, and
so does the ground-truth-only oracle.  The entry points run on the card
unless the caller passes ``device="cpu"``.  ``parallel`` runs them over
several devices on ``torch.distributed``, one process per device: the
(grid, data, tp)-sharded training step, and ``parameter_scan_fast`` with
``mesh=`` sharding each chunk's configurations over the ranks
(``parallel.multihost`` brings the job up and launches local ranks).
``python3 -m mfcd_tpu_torch.bench`` times whole runs in runs/hour under
the root ``bench.py``'s modes and metric names.
The study's sweeps are in ``experiments.runs``; its figures (``viz``,
``experiments.plots``) need matplotlib and are not imported here.  The package imports neither jax nor
``mfcd_tpu``; kernels are built with ``nvcc`` at first use.
"""

from mfcd_tpu_torch import backend  # noqa: F401  (precision pin)
from mfcd_tpu_torch.core.config import RunConfig, SweepSpec
from mfcd_tpu_torch.sweep.batched import parameter_scan_fast
from mfcd_tpu_torch.sweep.engine import parameter_scan, run_experiment
from mfcd_tpu_torch.sweep.ground_truth import (evaluate_ground_truth,
                                               parameter_scan_ground_truth)

__all__ = ["RunConfig", "SweepSpec", "evaluate_ground_truth", "parameter_scan",
           "parameter_scan_fast", "parameter_scan_ground_truth",
           "run_experiment"]
