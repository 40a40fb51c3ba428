"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.  Builds land in
``mfcd_tpu_torch/_build/`` keyed on a hash of the source and the flags, so
the first call in a fresh checkout builds and later calls reuse the
library.  The hash covers the headers of ``csrc/`` a source includes
(``#include "..."``), so an edit to a shared header rebuilds every source
that includes it.  Only the repository's own sources are compiled.

``--fmad=false`` keeps every multiply and add rounding on its own, as the
plain PyTorch versions' separate operations do, so a kernel and its plain
version differ only where their summation orders differ.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict

import torch

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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _local_files(src: str) -> list:
    """``src`` and every header it includes by quoted name from its own
    directory, directly or through another such header, each once."""
    files, todo = [], [src]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        with open(path, "rb") as f:
            text = f.read()
        for name in _INCLUDE.findall(text):
            header = os.path.join(os.path.dirname(src), name.decode())
            if os.path.exists(header):
                todo.append(header)
    return files


def _target(src: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _local_files(src):
        with open(path, "rb") as f:
            digest.update(f.read())
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


_bound: Dict[tuple, ctypes.CDLL] = {}


def bind(name: str, fn: str, argtypes) -> ctypes.CDLL:
    """The library built from ``csrc/<name>``, with its entry ``fn`` typed
    (``argtypes``, returning a CUDA error code) and its
    ``mfcd_cuda_error_string``.  After the first call a dictionary
    lookup: the wrappers call it on every launch."""
    lib = _bound.get((name, fn))
    if lib is not None:
        return lib
    lib = load(name)
    entry = getattr(lib, fn)
    if entry.argtypes is None:
        entry.argtypes = argtypes
        entry.restype = ctypes.c_int
        lib.mfcd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mfcd_cuda_error_string.restype = ctypes.c_char_p
    _bound[(name, fn)] = lib
    return lib


def stream_ptr(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (a CUDA
    device), without building a ``torch.cuda.Stream`` object."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.mfcd_cuda_error_string(err).decode())
