"""mfcd_tpu_torch — the PyTorch/CUDA port of ``mfcd_tpu``.

Matrix factorization with comparison data, on an NVIDIA H100: the same
sweep engine, samplers, labels, trainer and metrics as the JAX package,
with its fused training epoch as a hand-written CUDA kernel
(``ops/csrc/epoch_kernel.cu``).  The entry points run on the card unless
the caller passes ``device="cpu"``.  The package imports neither jax nor
``mfcd_tpu``; kernels are built with ``nvcc`` at first use.
"""

from mfcd_tpu_torch import backend  # noqa: F401  (precision pin)
from mfcd_tpu_torch.sweep.engine import parameter_scan, run_experiment

__all__ = ["parameter_scan", "run_experiment"]
