"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.  Builds land in
``mfcd_tpu_torch/_build/`` keyed on a hash of the source and the flags, so
the first call in a fresh checkout builds and later calls reuse the
library.  Only the repository's own sources are compiled.

``--fmad=false`` keeps every multiply and add rounding on its own, as the
plain PyTorch versions' separate operations do, so a kernel and its plain
version differ only where their summation orders differ.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}   # source name -> nvcc/ptxas output


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _target(src: str) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def _start(src: str, force: bool = False):
    """Start ``nvcc`` on ``src`` unless its library exists (and not
    ``force``); returns (source, library path, process or None)."""
    out = _target(src)
    if os.path.exists(out) and not force:
        return src, out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", f"{out}.{os.getpid()}.tmp", src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return src, out, proc


def _finish(job) -> str:
    src, out, proc = job
    if proc is None:
        return out
    stdout, stderr = proc.communicate()
    BUILD_LOGS[os.path.basename(src)] = stdout + stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{stderr}")
    os.replace(f"{out}.{os.getpid()}.tmp", out)
    return out


def build_all(force: bool = False) -> Dict[str, str]:
    """Compile every source (``force``) or every one not yet built, one
    ``nvcc`` per source, all started together; returns {source name:
    library path}."""
    jobs = [_start(src, force) for src in sources()]
    return {os.path.basename(job[0]): _finish(job) for job in jobs}


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>``, building it if needed."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_finish(_start(os.path.join(CSRC,
                                                                  name))))
        return _libs[name]
