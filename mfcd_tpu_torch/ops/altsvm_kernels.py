"""AltSVM's dual-coordinate-descent phase: a hand-written CUDA kernel (K2)
and its plain version.

The JAX package runs a phase as two ``lax.scan`` bodies under ``jax.jit``
(``mfcd_tpu/models/altsvm.py::_dcd_users``, ``::_dcd_items``); there is no
Pallas kernel.  Each coordinate step is about ten small operations, so in
plain PyTorch on the card every step costs a dozen launches: the card gets
a kernel of its own.

A step writes only its own rows (user phase U[i], item phase V[j] and
V[k]) and its dual, so the steps may run out of pick order as long as each
row takes its writes in pick order: the result is the sequential sweep's,
bit for bit.  The *schedule* says, for each step and each row it writes,
how many earlier steps write that row (its expected version).

- :func:`dcd_phase` launches ``ops/csrc/altsvm_dcd.cu`` for CUDA tensors:
  the schedule (:func:`dcd_schedule`), then one block of 32 warps whose
  groups of ``GROUP`` lanes run the steps, each step once its rows hold
  their expected versions.  CPU tensors run :func:`dcd_phase_reference`
  only.
- :func:`dcd_phase_reference` is the scan body as a Python loop of torch
  operations.  Its dots sum in the kernel's butterfly order over a group
  (:func:`warp_dot`), so on the same inputs it gives the kernel's bits.
- :func:`dcd_schedule_reference` and :func:`dcd_levels` (each step's depth
  in the chain of steps linked by shared rows) are plain versions for the
  tests and the card's report.

The phase functions return new tensors and leave their inputs as they
were, as the JAX functions do.
"""

from __future__ import annotations

import ctypes

import torch

from mfcd_tpu_torch.ops import _build
from mfcd_tpu_torch.ops.kernels import _check

PHASES = ("users", "items")
# Kernel launches, per phase, counted where each launches and nowhere else:
# the phase kernel by dcd_phase, the schedule's kernels by dcd_schedule.
DCD_LAUNCHES = dict.fromkeys(PHASES, 0)
SCHEDULE_LAUNCHES = dict.fromkeys(PHASES, 0)
LANES = 32          # a warp
GROUP = 4           # lanes a step: lane l holds components l, l + GROUP, ...
# Where the phase keeps its tables: both in shared memory, the written one
# only (the fixed rows from global memory), or neither.
MODES = ("both", "written", "global")
SMEM_BYTES = 232_448 - 64   # a block's shared memory, less the static part
SCHEDULE_CHUNK = 256        # slots a schedule warp takes (a multiple of 32)
SCHEDULE_CELLS = 1 << 24    # the most int32 counts the schedule allocates


def warp_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``dot(a, b)`` of float32 vectors along the last dimension, summed as
    the kernel's group of ``GROUP`` lanes sums it: each lane l adds the
    products of components l, l + GROUP, ... in order, starting from 0,
    then the lanes fold in halves (GROUP / 2, ..., 2, 1 apart)."""
    prod = a * b
    f = prod.shape[-1]
    lanes = -(-f // GROUP) * GROUP
    prod = torch.nn.functional.pad(prod, (0, lanes - f))
    prod = prod.reshape(*prod.shape[:-1], lanes // GROUP, GROUP)
    acc = torch.zeros(prod.shape[:-2] + (GROUP,), dtype=prod.dtype,
                      device=prod.device)
    for chunk in range(lanes // GROUP):
        acc = acc + prod[..., chunk, :]
    width = GROUP
    while width > 1:
        width //= 2
        acc = acc[..., :width] + acc[..., width:]
    return acc[..., 0]


def _check_phase(phase: str) -> None:
    if phase not in PHASES:
        raise ValueError(f"dcd_phase: unknown phase {phase!r}")


def _written_rows(phase: str, picks, users, movie_j, movie_k):
    """Per step, in pick order, the rows it writes: users ``(i,)``, items
    ``(j, k)``, or ``(j,)`` where k == j."""
    cols = (users,) if phase == "users" else (movie_j, movie_k)
    by_idx = list(zip(*(a.tolist() for a in cols)))
    return [tuple(dict.fromkeys(by_idx[idx])) for idx in picks.tolist()]


def dcd_schedule_reference(phase: str, picks, users, movie_j, movie_k):
    """The schedule in plain Python: int32 ``[steps, 1]`` (users: U[i]'s
    expected version) or ``[steps, 2]`` (items: V[j]'s, V[k]'s; k == j
    takes j's), a step's expected version of a row being the number of
    earlier steps that write it."""
    _check_phase(phase)
    width = 1 if phase == "users" else 2
    seen, out = {}, []
    for rows in _written_rows(phase, picks, users, movie_j, movie_k):
        vers = [seen.get(r, 0) for r in rows]
        for r in rows:
            seen[r] = seen.get(r, 0) + 1
        out.append(vers + vers[:width - len(vers)])
    return torch.tensor(out, dtype=torch.int32).reshape(-1, width)


def dcd_records_reference(phase: str, fixed, picks, users, movie_j, movie_k,
                          prefs, lam: float):
    """The schedule's records (``RECORD``) in plain PyTorch: int32
    ``[steps, RECORD]``, each step's comparison, label bits, expected
    versions (:func:`dcd_schedule_reference`; users repeat U[i]'s) and
    curvature bits, the curvature computed as
    :func:`dcd_phase_reference` computes it."""
    _check_phase(phase)
    f32 = torch.float32
    ver = dcd_schedule_reference(phase, picks, users, movie_j, movie_k)
    idx = picks.long()
    pref = prefs.to(f32)
    lam_t = torch.tensor(lam, dtype=f32)
    fixed = fixed.to(f32)
    if phase == "users":
        x = pref[:, None] * (fixed[movie_j.long()] - fixed[movie_k.long()])
        q = warp_dot(x, x) / lam_t
    else:
        u = fixed[users.long()]
        q = (2.0 * warp_dot(u, u)) / lam_t
    cols = [a.to(torch.int32)[idx] for a in (users, movie_j, movie_k)]
    cols += [picks.to(torch.int32), pref[idx].view(torch.int32), ver[:, 0],
             ver[:, -1], q[idx].view(torch.int32)]
    return torch.stack(cols, dim=1)


def dcd_levels(phase: str, picks, users, movie_j, movie_k) -> torch.Tensor:
    """Each step's depth in the chain (int64, from 1): one more than the
    deepest earlier step that writes one of its rows.  Steps of one level
    write disjoint rows; the largest level is the chain depth, the fewest
    rounds any schedule of the phase can take."""
    _check_phase(phase)
    last, out = {}, []
    for rows in _written_rows(phase, picks, users, movie_j, movie_k):
        level = 1 + max(last.get(r, 0) for r in rows)
        for r in rows:
            last[r] = level
        out.append(level)
    return torch.tensor(out, dtype=torch.int64)


def dcd_phase_reference(phase: str, table, fixed, dual, picks, users,
                        movie_j, movie_k, prefs, lam: float, c: float,
                        order=None):
    """One DCD phase in plain PyTorch; returns ``(table, dual)`` updated.

    ``phase`` "users": ``table`` is U ``[n, f]`` (updated), ``fixed`` V
    ``[m, f]``, ``dual`` alpha ``[T]``; "items": ``table`` V, ``fixed`` U,
    ``dual`` beta.  ``picks`` are the comparisons to visit, in order; the
    comparisons are ``users``, ``movie_j``, ``movie_k`` (ints) and
    ``prefs`` (cast to float32).  ``lam`` and ``c`` are rounded to
    float32.  ``order``: the positions of ``picks`` to run, in the order to
    run them (default: pick order); any order that keeps each row's writes
    in pick order gives the same bits."""
    _check_phase(phase)
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
    picked = picks.tolist()
    for s in range(len(picked)) if order is None else order:
        idx = picked[s]
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


def smem_bytes(mode: str, rows: int, other: int, f: int) -> int:
    """The phase kernel's shared memory in ``mode`` (one of ``MODES``): the
    written table (``rows`` x ``f``) and its ``rows`` int32 versions, and
    in "both" the fixed table (``other`` x ``f``)."""
    tables = {"both": rows + other, "written": rows, "global": 0}[mode]
    return 0 if mode == "global" else 4 * (tables * f + rows)


def dcd_mode(rows: int, other: int, f: int) -> str:
    """Where the phase kernel keeps its tables: the first of ``MODES``
    whose shared memory fits a block."""
    return next(mode for mode in MODES
                if smem_bytes(mode, rows, other, f) <= SMEM_BYTES)


def schedule_parts(slots: int, rows: int):
    """(parts, chunk): the schedule's warps and the slots each takes, a
    multiple of 32; ``rows`` x ``parts`` int32 counts stay within
    ``SCHEDULE_CELLS``."""
    cap = max(1, SCHEDULE_CELLS // max(rows, 1))
    parts = max(1, min(-(-slots // SCHEDULE_CHUNK), cap))
    chunk = -(-max(slots, 1) // parts)
    return parts, -(-chunk // LANES) * LANES


_SCHEDULE_ARGTYPES = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
                      + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_float]
                      + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
                      + [ctypes.c_void_p] * 3)
_DCD_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                 + [ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_int] * 3
                 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
# A step's record from the schedule, int32: i, j, k, idx, the label's bits,
# the expected versions of the rows it writes (users one, items two), and
# the bits of its curvature q (users dot(x, x) / lam, items
# (2 * dot(u, u)) / lam, summed as warp_dot sums).
RECORD = 8
VERSIONS = 5
CURVATURE = 7


def _check_comparisons(what, picks, users, movie_j, movie_k, prefs, n, m):
    """Device, type, shape and range checks of the picks and the
    comparisons over n users and m items (the kernels index without bounds
    checks); one host sync for the ranges."""
    dev = picks.device
    t = users.numel()
    _check("picks", picks, torch.int32, (picks.numel(),), dev)
    for name, a in (("users", users), ("movie_j", movie_j),
                    ("movie_k", movie_k)):
        _check(name, a, torch.int32, (t,), dev)
    _check("prefs", prefs, torch.float32, (t,), dev)
    named = [(name, a, hi) for name, a, hi in (
        ("picks", picks, t), ("users", users, n), ("movie_j", movie_j, m),
        ("movie_k", movie_k, m)) if a.numel()]
    if not named:
        return
    ends = torch.stack([torch.stack((a.min(), a.max()))
                        for _, a, _ in named]).tolist()
    for (name, _, hi), (lo_v, hi_v) in zip(named, ends):
        if lo_v < 0 or hi_v >= hi:
            raise ValueError(f"{what}: {name} outside [0, {hi})")


def _users_items(phase, rows, other):
    """(n, m): the written table's rows and the fixed one's, as users and
    items."""
    return (rows, other) if phase == "users" else (other, rows)


def dcd_schedule(phase: str, fixed, picks, users, movie_j, movie_k, prefs,
                 lam: float, rows: int):
    """The schedule's records of one phase over a written table of
    ``rows`` rows and the fixed table ``fixed`` (see ``RECORD``): int32
    ``[steps, RECORD]``.  CPU tensors run :func:`dcd_records_reference`,
    CUDA tensors the schedule's kernels (inputs checked as
    :func:`dcd_phase` checks them)."""
    _check_phase(phase)
    dev = picks.device
    if dev.type == "cpu":
        return dcd_records_reference(phase, fixed, picks, users, movie_j,
                                     movie_k, prefs, lam)
    if dev.type != "cuda":
        raise ValueError(f"dcd_schedule: unsupported device {dev}")
    if fixed.dim() != 2:
        raise ValueError("dcd_schedule: fixed must be [rows, f]")
    _check("fixed", fixed, torch.float32, tuple(fixed.shape), dev)
    _check_comparisons("dcd_schedule", picks, users, movie_j, movie_k, prefs,
                       *_users_items(phase, rows, fixed.shape[0]))
    return _schedule_records(phase, fixed, picks, users, movie_j, movie_k,
                             prefs, lam, rows)


def _schedule_records(phase, fixed, picks, users, movie_j, movie_k, prefs,
                      lam, rows):
    """The schedule's kernels on checked inputs: int32 ``[steps,
    RECORD]``."""
    dev = picks.device
    users_phase = phase == "users"
    steps = picks.numel()
    parts, chunk = schedule_parts(steps if users_phase else 2 * steps, rows)
    cnt = torch.zeros(rows * parts, dtype=torch.int32, device=dev)
    rec = torch.empty((steps, RECORD), dtype=torch.int32, device=dev)
    lib = _build.bind("altsvm_dcd.cu", "mfcd_altsvm_schedule",
                      _SCHEDULE_ARGTYPES)
    err = lib.mfcd_altsvm_schedule(
        int(users_phase), picks.data_ptr(), steps, users.data_ptr(),
        movie_j.data_ptr(), movie_k.data_ptr(), prefs.data_ptr(),
        fixed.data_ptr(), fixed.shape[1], float(lam), rows, parts, chunk,
        cnt.data_ptr(), rec.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(lib, err, "altsvm schedule kernel")
    SCHEDULE_LAUNCHES[phase] += 1
    return rec


def dcd_phase(phase: str, table, fixed, dual, picks, users, movie_j,
              movie_k, prefs, lam: float, c: float):
    """One DCD phase; returns ``(table, dual)`` updated (see
    :func:`dcd_phase_reference` for the arguments).

    CPU tensors run :func:`dcd_phase_reference`.  CUDA tensors launch the
    schedule and then the phase kernel once, on copies of ``table`` and
    ``dual``, with the tables where :func:`dcd_mode` puts them; anything
    else raises, and so does a launch the card refuses."""
    return _dcd_phase(phase, table, fixed, dual, picks, users, movie_j,
                      movie_k, prefs, lam, c)


def _dcd_phase(phase, table, fixed, dual, picks, users, movie_j, movie_k,
               prefs, lam, c, mode=None):
    """:func:`dcd_phase`, with the tables forced into ``mode`` (one of
    ``MODES``; default by size) for checks and timing.  Every placement
    gives the same bits."""
    dev = table.device
    if dev.type == "cpu":
        return dcd_phase_reference(phase, table, fixed, dual, picks, users,
                                   movie_j, movie_k, prefs, lam, c)
    if dev.type != "cuda":
        raise ValueError(f"dcd_phase: unsupported device {dev}")
    _check_phase(phase)
    rows, f = table.shape
    other = fixed.shape[0]
    _check("table", table, torch.float32, (rows, f), dev)
    _check("fixed", fixed, torch.float32, (other, f), dev)
    _check("dual", dual, torch.float32, (users.numel(),), dev)
    _check_comparisons("dcd_phase", picks, users, movie_j, movie_k, prefs,
                       *_users_items(phase, rows, other))
    mode = dcd_mode(rows, other, f) if mode is None else mode
    if mode not in MODES or smem_bytes(mode, rows, other, f) > SMEM_BYTES:
        raise ValueError(f"dcd_phase: mode {mode!r} does not fit")
    rec = _schedule_records(phase, fixed, picks, users, movie_j, movie_k,
                            prefs, lam, rows)
    table = table.clone()
    dual = dual.clone()
    gver = torch.zeros(rows if mode == "global" else 1, dtype=torch.int32,
                       device=dev)
    lib = _build.bind("altsvm_dcd.cu", "mfcd_altsvm_dcd", _DCD_ARGTYPES)
    err = lib.mfcd_altsvm_dcd(
        int(phase == "users"), MODES.index(mode), GROUP, table.data_ptr(),
        fixed.data_ptr(), dual.data_ptr(), rec.data_ptr(), picks.numel(),
        gver.data_ptr(), rows, other, f, float(lam), float(c),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(lib, err, "altsvm dcd kernel")
    DCD_LAUNCHES[phase] += 1
    return table, dual
