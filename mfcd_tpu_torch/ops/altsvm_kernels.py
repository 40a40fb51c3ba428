"""AltSVM's dual-coordinate-descent phase: a hand-written CUDA kernel (K2)
and its plain version.

The JAX package runs a phase as two ``lax.scan`` bodies under ``jax.jit``
(``mfcd_tpu/models/altsvm.py::_dcd_users``, ``::_dcd_items``); there is no
Pallas kernel.  Each coordinate step is about ten small operations, so in
plain PyTorch on the card every step costs a dozen launches: the card gets
a kernel of its own.

- :func:`dcd_phase` launches ``ops/csrc/altsvm_dcd.cu`` (one warp runs the
  phase's ``len(picks)`` dependent steps) for CUDA tensors, and runs
  :func:`dcd_phase_reference` for CPU tensors only.
- :func:`dcd_phase_reference` is the scan body as a Python loop of torch
  operations.  Its dots sum in the kernel's butterfly order
  (:func:`warp_dot`), so on the same inputs it gives the kernel's bits.

Both return new tensors and leave their inputs as they were, as the JAX
functions do.
"""

from __future__ import annotations

import ctypes

import torch

from mfcd_tpu_torch.ops import _build
from mfcd_tpu_torch.ops.kernels import _check

PHASES = ("users", "items")
# Kernel launches by dcd_phase, per phase, counted there and nowhere else.
DCD_LAUNCHES = dict.fromkeys(PHASES, 0)
LANES = 32          # the kernel's warp: lane l holds components l, l + 32, ...


def warp_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``dot(a, b)`` of two float32 vectors, summed as the kernel's warp
    sums it: each lane l adds the products of components l, l + 32, ...
    in order, starting from 0, then the lanes fold in halves (16, 8, 4, 2,
    1 apart)."""
    prod = a * b
    lanes = -(-prod.numel() // LANES) * LANES
    prod = torch.nn.functional.pad(prod, (0, lanes - prod.numel()))
    acc = torch.zeros(LANES, dtype=prod.dtype, device=prod.device)
    for part in prod.reshape(-1, LANES):
        acc = acc + part
    width = LANES
    while width > 1:
        width //= 2
        acc = acc[:width] + acc[width:]
    return acc[0]


def dcd_phase_reference(phase: str, table, fixed, dual, picks, users,
                        movie_j, movie_k, prefs, lam: float, c: float):
    """One DCD phase in plain PyTorch; returns ``(table, dual)`` updated.

    ``phase`` "users": ``table`` is U ``[n, f]`` (updated), ``fixed`` V
    ``[m, f]``, ``dual`` alpha ``[T]``; "items": ``table`` V, ``fixed`` U,
    ``dual`` beta.  ``picks`` are the comparisons to visit, in order; the
    comparisons are ``users``, ``movie_j``, ``movie_k`` (ints) and
    ``prefs`` (cast to float32).  ``lam`` and ``c`` are rounded to
    float32."""
    if phase not in PHASES:
        raise ValueError(f"dcd_phase: unknown phase {phase!r}")
    dev = table.device
    f32 = torch.float32
    table = table.to(f32).clone()
    dual = dual.to(f32).clone()
    fixed = fixed.to(f32)
    # A 0-dim tensor on the device: a Python divisor would be turned into a
    # multiplication by its reciprocal on the card.
    lam_t = torch.tensor(lam, dtype=f32, device=dev)
    c = float(torch.tensor(c, dtype=f32))
    pref_of = prefs.to(dev, f32)
    rows = list(zip(*(a.tolist() for a in (users, movie_j, movie_k))))
    for idx in picks.tolist():
        i, j, k = rows[idx]
        pref = pref_of[idx]
        old = dual[idx]
        if phase == "users":
            x = pref * (fixed[j] - fixed[k])
            q = warp_dot(x, x) / lam_t
            grad = warp_dot(table[i], x) - 1.0
        else:
            u = fixed[i]
            grad = pref * warp_dot(u, table[j] - table[k]) - 1.0
            q = (2.0 * warp_dot(u, u)) / lam_t
        fresh = torch.clamp(old - grad / torch.clamp(q, min=1e-12), 0.0, c)
        delta = fresh - old
        dual[idx] = fresh
        if phase == "users":
            table[i] = table[i] + (delta * x) / lam_t
        else:
            table[j] = table[j] + ((delta * pref) * u) / lam_t
            table[k] = table[k] + (((-delta) * pref) * u) / lam_t
    return table, dual


_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
             + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_float,
                                         ctypes.c_float, ctypes.c_void_p])


def dcd_phase(phase: str, table, fixed, dual, picks, users, movie_j,
              movie_k, prefs, lam: float, c: float):
    """One DCD phase; returns ``(table, dual)`` updated (see
    :func:`dcd_phase_reference` for the arguments).

    CPU tensors run :func:`dcd_phase_reference`.  CUDA tensors launch the
    kernel once, on copies of ``table`` and ``dual``; anything else raises,
    and so does a launch the card refuses."""
    dev = table.device
    if dev.type == "cpu":
        return dcd_phase_reference(phase, table, fixed, dual, picks, users,
                                   movie_j, movie_k, prefs, lam, c)
    if dev.type != "cuda":
        raise ValueError(f"dcd_phase: unsupported device {dev}")
    if phase not in PHASES:
        raise ValueError(f"dcd_phase: unknown phase {phase!r}")
    f32, i32 = torch.float32, torch.int32
    rows, f = table.shape
    other = fixed.shape[0]
    t = dual.shape[0]
    n, m = (rows, other) if phase == "users" else (other, rows)
    table = table.clone()
    dual = dual.clone()
    _check("table", table, f32, (rows, f), dev)
    _check("fixed", fixed, f32, (other, f), dev)
    _check("dual", dual, f32, (t,), dev)
    _check("picks", picks, i32, (picks.numel(),), dev)
    for name, a in (("users", users), ("movie_j", movie_j),
                    ("movie_k", movie_k)):
        _check(name, a, i32, (t,), dev)
    _check("prefs", prefs, f32, (t,), dev)
    # The kernel indexes without bounds checks.
    for name, a, hi in (("picks", picks, t), ("users", users, n),
                        ("movie_j", movie_j, m), ("movie_k", movie_k, m)):
        if a.numel() and (int(a.min()) < 0 or int(a.max()) >= hi):
            raise ValueError(f"dcd_phase: {name} outside [0, {hi})")
    lib = _build.bind("altsvm_dcd.cu", "mfcd_altsvm_dcd", _ARGTYPES)
    err = lib.mfcd_altsvm_dcd(
        int(phase == "users"), table.data_ptr(), fixed.data_ptr(),
        dual.data_ptr(), picks.data_ptr(), picks.numel(), users.data_ptr(),
        movie_j.data_ptr(), movie_k.data_ptr(), prefs.data_ptr(), f,
        float(lam), float(c), torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(lib, err, "altsvm dcd kernel")
    DCD_LAUNCHES[phase] += 1
    return table, dual
