"""The fused epoch split by stage: two CUDA kernels and their plain versions.

Counterpart of the kernel half of ``scripts/profile_kernel_split.py``, the
JAX package's kernel-split profiler.  Both kernels train (or go through the
motions of) one epoch for each of R runs in pack mode "full", the stream
layout the canonical bucket uses.

- P1, :func:`train_epoch_variant`, is the fused epoch with stages removed
  (``_variant_kernel``).  ``VARIANTS`` names the five stage sets; each
  ablated variant keeps what is left live through a cheap term in its loss
  and leaves the state as it was.  That term weighs 1e-9 and vanishes in
  the float32 loss, so each ablated variant also returns ``alive [R]``,
  unweighted sums that depend on every stage it keeps: the check that its
  stage work was done.
- P2, :func:`train_epoch_factored`, is the fused epoch over the state in
  the ``[R, 8, d*128]`` layout of :func:`to_factored_layout`
  (``_factored_kernel``), with V's gradient summed as the i-rows' sum plus
  the j-rows' sum.

Both kernels are K1 itself: the template of ``ops/csrc/epoch_body.cuh``
that ``epoch_kernel.cu`` instantiates at the full stage set, instantiated
by ``ops/csrc/epoch_variants.cu`` at every stage set (``full`` is K1's
code, built again) and at the full one over the factored layout.  So the
split is the split of the K1 the main path runs, at K1's launch shapes:
the wrappers pick C with :func:`kernels.cluster_size`, at or above the
smallest portable C whose block fits (:func:`split_min_cluster`, K1's
gate over each kernel's own shared memory), so P1 takes every shape K1
takes (:func:`split_kernel_supported`).  P2's factored layout holds at
most ``FACTORED_ROWS`` rows a table; that limit stays.

Each wrapper runs its plain version for CPU tensors and launches its
kernel for CUDA tensors; anything else raises.  Both take pack "full" only,
as the JAX kernels do.  On the card the state is updated in place where
the kernel writes it (``full`` and P2).

The TPU profiler's other seven variants (``oh_only_bf16``,
``full_default_prec``, ``full_split3``, ``full_split3d``,
``oh_only_hoist``, ``full_split3d_hoist``, ``full_split3d_hfsel``) change
only how the TPU's matrix unit is fed; each computes its base stage set's
function, so ``oh_only`` and ``full`` stand for them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mfcd_tpu_torch.models.mf import gather_rows
from mfcd_tpu_torch.ops import _build
from mfcd_tpu_torch.ops.kernels import (CLUSTER_SIZES, PACKED,
                                        PORTABLE_CLUSTERS, SMEM_PER_BLOCK,
                                        EpochState, _adam_consts, _check,
                                        _epoch_reference, _forward,
                                        _index_add, _rows_first, _unpack,
                                        _v_grad_interleaved,
                                        check_launch_shape, cluster_size,
                                        epoch_smem_bytes)

# Stage sets, in the order each adds one stage to the one before
# (``profile_kernel_split.py:532-537``).
VARIANTS = {
    "loop_only": (),
    "oh_only": ("oh",),
    "no_scatter": ("oh", "contract"),
    "no_adam": ("oh", "contract", "scatter"),
    "full": ("oh", "contract", "scatter", "adam"),
}
# Kernel launches, counted by the wrappers where they launch and nowhere
# else: one count per P1 variant (each is its own kernel instantiation).
VARIANT_LAUNCHES = {name: 0 for name in VARIANTS}
FACTORED_LAUNCHES = 0
FACTORED = "factored"  # P2's name beside the variants' in the helpers below

FACTORED_H = 8        # sublane rows of the factored layout
FACTORED_L = 128      # lanes per row: table row = h * 128 + l
FACTORED_ROWS = FACTORED_H * FACTORED_L
ABLATION_SCALE = 1e-9  # weight of the keep-alive terms in the ablated losses
WARP_SLOTS = 16       # alive partial sums, one per warp of a 512-thread block


def _variant_name(stages) -> str:
    for name, st in VARIANTS.items():
        if tuple(stages) == st:
            return name
    raise ValueError(f"unknown stage set {tuple(stages)!r}; expected one of "
                     f"{list(VARIANTS.values())}")


def _check_pack(pack: tuple, who: str) -> None:
    if pack[0] != "full":
        raise ValueError(f"{who}: pack mode {pack[0]!r} is not supported; "
                         f"only 'full' (one packed int32 per row)")


def split_smem_bytes(n: int, m: int, d: int, batch_size: int,
                     cluster: int = 1, kernel: str = "full") -> int:
    """Shared memory of one block of P1 variant or P2 ``kernel`` at launch
    shape ``cluster`` (mirrors the .cu source): K1's
    :func:`epoch_smem_bytes`, plus, for an ablated variant, its term
    planes: a third loss term per batch row by step parity and the alive
    partial sums (at C > 1 K1's pushed buffer leaves room for them).  P2 is ``full`` over its tables' rows: call it at
    ``FACTORED_ROWS``."""
    extra = (0 if kernel in ("full", FACTORED)
             else 4 * (2 * batch_size + WARP_SLOTS))
    return epoch_smem_bytes(n, m, d, batch_size, cluster, extra) + extra


def split_min_cluster(n: int, m: int, d: int, batch_size: int,
                      kernel: str = "full") -> Optional[int]:
    """The smallest C of ``PORTABLE_CLUSTERS`` at which one block of
    ``kernel`` fits, as :func:`kernels.min_cluster` for K1; None where none
    does, and for P2 past its layout's ``FACTORED_ROWS`` rows."""
    if kernel == FACTORED and max(n, m) > FACTORED_ROWS:
        return None
    return next((c for c in PORTABLE_CLUSTERS
                 if split_smem_bytes(n, m, d, batch_size, c, kernel)
                 <= SMEM_PER_BLOCK), None)


def split_kernel_supported(n: int, m: int, d: int, batch_size: int,
                           kernel: str = "full") -> bool:
    """Does one run of ``kernel`` fit a cluster of a portable size?  K1's
    gate (:func:`kernels.epoch_kernel_supported`) over the kernel's own
    shared memory; P2 also needs n, m <= ``FACTORED_ROWS``."""
    return split_min_cluster(n, m, d, batch_size, kernel) is not None


def _check_fits(who: str, n: int, m: int, d: int, batch_size: int,
                kernel: str, cluster: Optional[int] = None) -> int:
    """Raise unless ``kernel`` fits this shape at some portable C, and a
    forced ``cluster`` at or above the smallest; returns that smallest C."""
    if kernel == FACTORED and max(n, m) > FACTORED_ROWS:
        raise ValueError(f"{who}: {max(n, m)} rows, the factored layout "
                         f"holds {FACTORED_ROWS}")
    floor = split_min_cluster(n, m, d, batch_size, kernel)
    check_launch_shape(
        f"{who}: n={n}, m={m}, d={d}, bs={batch_size}", cluster, floor,
        lambda c: split_smem_bytes(n, m, d, batch_size, c, kernel))
    return floor


def _check_cluster(who: str, cluster: Optional[int]) -> None:
    if cluster is not None and cluster not in CLUSTER_SIZES + (PACKED,):
        raise ValueError(f"{who}: cluster={cluster}, expected PACKED "
                         f"({PACKED}) or one of {CLUSTER_SIZES}")


def to_factored_layout(a: torch.Tensor) -> torch.Tensor:
    """``[R, d, n]`` -> ``[R, 8, d*128]``, rows zero-padded to 1024:
    element (row h*128 + l, component k) lands at ``[h, k*128 + l]``."""
    r, d, n = a.shape
    if n > FACTORED_ROWS:
        raise ValueError(f"to_factored_layout: {n} rows need H = "
                         f"{-(-n // FACTORED_L)}, the layout has H = "
                         f"{FACTORED_H}")
    a = torch.nn.functional.pad(a, (0, FACTORED_ROWS - n))
    return (a.reshape(r, d, FACTORED_H, FACTORED_L).permute(0, 2, 1, 3)
            .reshape(r, FACTORED_H, d * FACTORED_L).contiguous())


def from_factored_layout(a: torch.Tensor, d: int,
                         n: int = FACTORED_ROWS) -> torch.Tensor:
    """``[R, 8, d*128]`` -> ``[R, d, n]``, the first ``n`` rows."""
    r, h, dl = a.shape
    if h != FACTORED_H or dl != d * FACTORED_L:
        raise ValueError(f"from_factored_layout: shape {tuple(a.shape)} is "
                         f"not [R, {FACTORED_H}, {d}*{FACTORED_L}]")
    return (a.reshape(r, h, d, FACTORED_L).permute(0, 2, 1, 3)
            .reshape(r, d, h * FACTORED_L)[:, :, :n].contiguous())


def train_epoch_variant_reference(state: EpochState, stream, lr, wd, step0,
                                  count, pack: tuple, stages: tuple,
                                  b1: float = 0.9, b2: float = 0.999,
                                  eps: float = 1e-8):
    """P1's function in plain PyTorch; returns ``(state, loss [R],
    alive [R])``.

    ``full`` is the fused epoch (:func:`train_epoch_reference`'s function),
    with ``alive`` 0: its state is what shows its work.  An ablated variant
    runs the same executed batches and returns the state it was given.  Its
    loss and ``alive`` are means over executed batches of per-batch terms;
    the loss's are the JAX variant's (``profile_kernel_split.py:196-250``):

    - ``loop_only``: loss sum(z * mask) + 1e-9 * (sum u + sum i + sum j)
      over every lane of the raw unpacked indices, masked or not; alive
      sum u + sum i + sum j;
    - ``oh_only``: loss 1e-9 * (sum of mask * [u < n]) + 1e-9 * (sum of
      mask * ([i < m] - [j < m])), the masked row sums of the two one-hots;
      alive the sum of mask * (u [u < n] + i [i < m] + j [j < m]), the
      resolved rows (the one-hots' row sums are constant on valid rows);
    - ``no_scatter``: loss the batch's BCE loss + 1e-9 * sum(g); alive
      sum |g|;
    - ``no_adam``: loss the batch's BCE loss + 1e-9 * sum(grad U) + 1e-9 *
      sum(grad V); alive the sum of |grad U| at every u and of |grad V| at
      every i and j, the batch's rows (0 on masked lanes): the gradient
      read back where the scatter put it (sum(grad V) is 0 but for
      rounding)."""
    name = _variant_name(stages)
    _check_pack(pack, "train_epoch_variant")
    if name == "full":
        new, loss = _epoch_reference(state, stream, lr, wd, step0, count,
                                     pack, b1, b2, eps, _v_grad_interleaved)
        return new, loss, torch.zeros_like(loss)
    r, d, n = state.u_t.shape
    m = state.v_t.shape[2]
    num_batches, bs = stream[0].shape[1:]
    dev = state.u_t.device
    p_u, p_v = _rows_first(state.u_t), _rows_first(state.v_t)
    count = count.to(torch.int32)
    num_exec = (count + bs - 1) // bs
    steps = torch.clamp(num_exec, max=num_batches)
    slot_iota = torch.arange(bs, device=dev)
    scale = ABLATION_SCALE
    f32 = lambda a: a.to(torch.float32)

    loss_sum = torch.zeros(r, dtype=torch.float32, device=dev)
    alive_sum = torch.zeros_like(loss_sum)
    for t in range(int(steps.max()) if r else 0):
        active = t < steps
        u, i, j, z = _unpack(stream, t, pack)
        mask = f32((t * bs + slot_iota) < count.unsqueeze(-1))
        if name == "loop_only":
            su, si, sj = (torch.sum(f32(a), -1) for a in (u, i, j))
            terms = (torch.sum(z * mask, -1), su * scale, si * scale,
                     sj * scale)
            alive = (su, si, sj)
        elif name == "oh_only":
            oh_u = f32(u < n)
            oh_d = f32(i < m) - f32(j < m)
            terms = (torch.sum(oh_u * mask, -1) * scale,
                     torch.sum(oh_d * mask, -1) * scale)
            rows = (torch.where(u < n, u, 0) + torch.where(i < m, i, 0)
                    + torch.where(j < m, j, 0))
            alive = (torch.sum(f32(rows) * mask, -1),)
        else:
            valid = mask > 0
            u, i, j = (torch.where(valid, a, 0) for a in (u, i, j))
            eu, dv, loss, g = _forward(p_u, p_v, u, i, j, z, mask)
            if name == "no_scatter":
                terms = (loss, torch.sum(g, -1) * scale)
                alive = (torch.sum(torch.abs(g), -1),)
            else:
                grad_u = _index_add(n, u, g.unsqueeze(-1) * dv)
                grad_v = _v_grad_interleaved(m, i, j, g.unsqueeze(-1) * eu)
                terms = (loss, torch.sum(grad_u, (1, 2)) * scale,
                         torch.sum(grad_v, (1, 2)) * scale)
                back_v = torch.cat([gather_rows(grad_v, i),
                                    gather_rows(grad_v, j)], 1)
                alive = (torch.sum(torch.abs(gather_rows(grad_u, u)), (1, 2)),
                         torch.sum(torch.abs(back_v), (1, 2)))
        # Added to the running sums one by one, as the JAX variant does.
        keep = lambda term: torch.where(active, term, torch.zeros_like(term))
        for term in terms:
            loss_sum = loss_sum + keep(term)
        for term in alive:
            alive_sum = alive_sum + keep(term)
    execs = torch.clamp(f32(num_exec), min=1.0)
    return state, loss_sum / execs, alive_sum / execs


def _v_grad_split(m: int, i, j, g_v_rows):
    """V's gradient as P2 sums it: the i-entries in batch order, the
    j-entries in batch order, then the two added."""
    return _index_add(m, i, g_v_rows) + _index_add(m, j, -g_v_rows)


def train_epoch_factored_reference(state_f: EpochState, stream, lr, wd, step0,
                                   count, pack: tuple, b1: float = 0.9,
                                   b2: float = 0.999, eps: float = 1e-8):
    """P2's function in plain PyTorch; returns ``(state_f, loss [R])``.

    ``state_f`` holds the six state tensors in the ``[R, 8, d*128]``
    layout.  Converts to the ``[R, d, 1024]`` layout, runs the fused epoch
    with V's gradient summed in P2's order, and converts back."""
    _check_pack(pack, "train_epoch_factored")
    d = state_f.u_t.shape[2] // FACTORED_L
    state = EpochState(*(from_factored_layout(a, d) for a in state_f))
    new, loss = _epoch_reference(state, stream, lr, wd, step0, count, pack,
                                 b1, b2, eps, _v_grad_split)
    return EpochState(*(to_factored_layout(a) for a in new)), loss


def _check_epoch_args(state, stream, lr, wd, step0, count, state_shapes):
    """Device, dtype, shape and contiguity of a P1 / P2 call's tensors."""
    dev = state.u_t.device
    f32, i32 = torch.float32, torch.int32
    r = state.u_t.shape[0]
    for name, a, shape in zip(EpochState._fields, state, state_shapes):
        _check(name, a, f32, shape, dev)
    if len(stream) != 1:
        raise ValueError("pack 'full' takes one stream array")
    if stream[0].dim() != 3 or stream[0].shape[0] != r:
        raise ValueError(f"stream[0]: shape {tuple(stream[0].shape)}, "
                         f"expected [{r}, batches, bs]")
    _check("stream[0]", stream[0], i32, stream[0].shape, dev)
    for name, a in (("lr", lr), ("wd", wd), ("step0", step0)):
        _check(name, a, f32, (r,), dev)
    _check("count", count, i32, (r,), dev)


_COMMON_TAIL = [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_void_p]


def _library():
    name = "epoch_variants.cu"
    _build.bind(name, "mfcd_train_epoch_factored",
                [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + _COMMON_TAIL)
    return _build.bind(
        name, "mfcd_train_epoch_variant",
        [ctypes.c_int] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 10
        + _COMMON_TAIL)


def _launch_tail(pack, b1, b2, eps, cluster, dev) -> list:
    """The trailing pack, Adam, launch-shape and stream arguments of both C
    entries."""
    _, bits_n, bits_m, bits_z, denom = pack
    b1f, omb1, b2f, omb2, log_b1, log_b2 = _adam_consts(b1, b2)
    return [bits_n, bits_m, bits_z, denom, b1f, omb1, b2f, omb2, float(eps),
            log_b1, log_b2, cluster,
            torch.cuda.current_stream(dev).cuda_stream]


def train_epoch_variant(state: EpochState, stream, lr, wd, step0, count,
                        pack: tuple, stages: tuple, b1: float = 0.9,
                        b2: float = 0.999, eps: float = 1e-8):
    """P1: one epoch per run with the stages ``stages`` (a ``VARIANTS``
    value); returns ``(state, loss [R], alive [R])``, as
    :func:`train_epoch_variant_reference` defines them.

    Arguments as :func:`mfcd_tpu_torch.ops.kernels.train_epoch`, pack
    "full" only.  CPU tensors run :func:`train_epoch_variant_reference`.
    CUDA tensors launch ``epoch_variants.cu`` at K1's launch shape for
    this shape (:func:`kernels.cluster_size`); ``full`` updates the state in
    place, the ablated variants leave it as it was.  A shape whose block
    does not fit raises, and so does anything else the kernel does not
    take."""
    return _train_epoch_variant(state, stream, lr, wd, step0, count, pack,
                                stages, b1, b2, eps)


def _train_epoch_variant(state: EpochState, stream, lr, wd, step0, count,
                         pack: tuple, stages: tuple, b1: float = 0.9,
                         b2: float = 0.999, eps: float = 1e-8,
                         cluster: Optional[int] = None):
    """:func:`train_epoch_variant` at launch shape ``cluster`` (PACKED or a
    ``CLUSTER_SIZES`` entry; None: K1's, :func:`kernels.cluster_size`), for
    the checks that every launch shape gives the same bits and for timing
    the split at a forced shape."""
    name = _variant_name(stages)
    _check_pack(pack, "train_epoch_variant")
    _check_cluster("train_epoch_variant", cluster)
    dev = state.u_t.device
    if dev.type == "cpu":
        return train_epoch_variant_reference(state, stream, lr, wd, step0,
                                             count, pack, stages, b1, b2, eps)
    if dev.type != "cuda":
        raise ValueError(f"train_epoch_variant: unsupported device {dev}")
    r, d, n = state.u_t.shape
    m = state.v_t.shape[2]
    stream = tuple(stream)
    _check_epoch_args(state, stream, lr, wd, step0, count,
                      [(r, d, k) for k in (n, m, n, n, m, m)])
    num_batches, bs = stream[0].shape[1:]
    floor = _check_fits("train_epoch_variant", n, m, d, bs, name, cluster)
    if cluster is None:
        cluster = cluster_size(r, n, m, d, bs, dev, floor)
    loss = torch.empty(r, dtype=torch.float32, device=dev)
    alive = torch.zeros(r, dtype=torch.float32, device=dev)
    lib = _library()
    err = lib.mfcd_train_epoch_variant(
        list(VARIANTS).index(name), *(a.data_ptr() for a in state),
        stream[0].data_ptr(), lr.data_ptr(), wd.data_ptr(), step0.data_ptr(),
        count.data_ptr(), loss.data_ptr(), alive.data_ptr(), r, n, m, d,
        num_batches, bs, *_launch_tail(pack, b1, b2, eps, cluster, dev))
    _build.raise_on(lib, err, f"epoch variant {name!r}")
    VARIANT_LAUNCHES[name] += 1
    return state, loss, alive


def train_epoch_factored(state_f: EpochState, stream, lr, wd, step0, count,
                         pack: tuple, b1: float = 0.9, b2: float = 0.999,
                         eps: float = 1e-8):
    """P2: one fused epoch per run over the ``[R, 8, d*128]`` layout;
    returns ``(state_f, loss [R])``.

    Arguments as :func:`train_epoch_variant` without ``stages``, the six
    state tensors in the factored layout (:func:`to_factored_layout`).
    CPU tensors run :func:`train_epoch_factored_reference`; CUDA tensors
    launch ``epoch_variants.cu``'s factored instantiation at K1's launch
    shape for ``FACTORED_ROWS`` rows, which updates the state in place."""
    return _train_epoch_factored(state_f, stream, lr, wd, step0, count,
                                 pack, b1, b2, eps)


def _train_epoch_factored(state_f: EpochState, stream, lr, wd, step0, count,
                          pack: tuple, b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-8, cluster: Optional[int] = None):
    """:func:`train_epoch_factored` at launch shape ``cluster``, as
    :func:`_train_epoch_variant`."""
    global FACTORED_LAUNCHES
    _check_pack(pack, "train_epoch_factored")
    _check_cluster("train_epoch_factored", cluster)
    dev = state_f.u_t.device
    if dev.type == "cpu":
        return train_epoch_factored_reference(state_f, stream, lr, wd, step0,
                                              count, pack, b1, b2, eps)
    if dev.type != "cuda":
        raise ValueError(f"train_epoch_factored: unsupported device {dev}")
    r, h, dl = state_f.u_t.shape
    d = dl // FACTORED_L
    if h != FACTORED_H or d * FACTORED_L != dl:
        raise ValueError(f"train_epoch_factored: state shape "
                         f"{tuple(state_f.u_t.shape)} is not [R, "
                         f"{FACTORED_H}, d*{FACTORED_L}]")
    stream = tuple(stream)
    _check_epoch_args(state_f, stream, lr, wd, step0, count,
                      [(r, h, dl)] * 6)
    num_batches, bs = stream[0].shape[1:]
    if max(pack[1], pack[2]) > FACTORED_ROWS.bit_length() - 1:
        raise ValueError(f"train_epoch_factored: {pack[1]}- and {pack[2]}-bit "
                         f"indices can exceed the layout's {FACTORED_ROWS} "
                         f"rows")
    rows = FACTORED_ROWS
    floor = _check_fits("train_epoch_factored", rows, rows, d, bs, FACTORED,
                        cluster)
    if cluster is None:
        cluster = cluster_size(r, rows, rows, d, bs, dev, floor)
    loss = torch.empty(r, dtype=torch.float32, device=dev)
    lib = _library()
    err = lib.mfcd_train_epoch_factored(
        *(a.data_ptr() for a in state_f), stream[0].data_ptr(),
        lr.data_ptr(), wd.data_ptr(), step0.data_ptr(), count.data_ptr(),
        loss.data_ptr(), r, h, d, num_batches, bs,
        *_launch_tail(pack, b1, b2, eps, cluster, dev))
    _build.raise_on(lib, err, "factored epoch")
    FACTORED_LAUNCHES += 1
    return state_f, loss
