"""The fused training epoch: a hand-written CUDA kernel and its plain version.

Counterpart of ``mfcd_tpu/ops/kernels.py`` (``EpochState``,
``pallas_train_epoch``, ``pallas_epoch_supported``).  One call trains one
epoch for each of R runs: for every executed batch, forward, masked-mean
BCE, gradient scatter into U and V, and a dense coupled-weight-decay Adam
over every element, with the state carried in the ``[R, d, rows]`` layout
of the JAX package.

- :func:`train_epoch` launches ``ops/csrc/epoch_kernel.cu`` (each run on
  a cluster of C thread blocks, or packed several runs to an SM, state
  resident in shared memory) for CUDA tensors, and runs
  :func:`train_epoch_reference` for CPU tensors only.  On the card the
  state tensors are updated in place, as the TPU kernel aliases them.
- :func:`choose_cluster` picks the launch shape from R and an occupancy
  query, before the launch, among the shapes whose block fits: the
  largest C whose R clusters are all resident at once, else the packed
  kernel where the C = 1 block fits, else the C with the most resident
  runs (the rest queue behind them, in waves).
- :func:`train_epoch_reference` is the same function in plain PyTorch:
  index gathers, ``index_add_`` in batch order, the same Adam arithmetic,
  the same executed batches.
- :func:`epoch_kernel_supported` is the shape gate: at some cluster size
  C of 1, 2, 4, 8 or 16 (:func:`min_cluster`), one block's share of the
  run must fit the block's 232,448 bytes of shared memory.  Any batch
  size works: the kernel loops batch rows and gradient entries over its
  threads.

``onehot_forward_logits`` (a TPU matmul stand-in for a gather) is not
ported: ``models.mf.forward_logits`` computes the same values.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from mfcd_tpu_torch.models.mf import gather_rows
from mfcd_tpu_torch.ops import _build
from mfcd_tpu_torch.utils import observability as obs

EPOCH_LAUNCHES = 0          # kernel launches by train_epoch, nowhere else
# The open call's counter of K1 launches at C > 1, where the rows' owners
# push each step's rows into every block of the cluster.
PUSH_LAUNCHES = "k1.push_launches"
# The open call's counters of K1's executed steps (one batch of one run)
# and of its dense Adam's element updates, (n + m) d a step; the trainer
# counts them each epoch from the training rows the host holds.
RUN_STEPS = "k1.run_steps"
ADAM_ELEMENTS = "k1.adam_elements"
SMEM_PER_BLOCK = 232_448    # bytes of shared memory one Hopper block may use
# Launch shapes: C in CLUSTER_SIZES, a run on a cluster of C blocks of 512
# threads (C = 1: one block, no cluster), tried largest first; or PACKED, a
# run on one block of 256 threads, three to an SM where shared memory allows.
CLUSTER_SIZES = (16, 8, 4, 2, 1)
# The sizes every Hopper card schedules (the kernel-split kernels' gate).
# K1's gate, GATE_CLUSTERS, takes every launch size, smallest first, C = 16
# included, so that it admits every shape JAX's
# ``pallas_epoch_supported`` admits (d = 8 with bs <= 64 fits only there):
# C = 16 needs the non-portable cluster attribute, which the H100 grants;
# on a card that refuses it, a shape whose floor is 16 raises at its first
# launch (``cluster_size``), never falls back to autograd or a smaller C.
PORTABLE_CLUSTERS = (1, 2, 4, 8)
GATE_CLUSTERS = tuple(sorted(CLUSTER_SIZES))
PACKED = 0
_MODES = {"full": 0, "uij": 1, "none": 2}
_STREAM_ARRAYS = {"full": 1, "uij": 2, "none": 4}


class EpochState(NamedTuple):
    """Training state carried across epochs, JAX layout."""

    u_t: torch.Tensor   # [R, d, n]
    v_t: torch.Tensor   # [R, d, m]
    mu_u: torch.Tensor  # [R, d, n]
    nu_u: torch.Tensor  # [R, d, n]
    mu_v: torch.Tensor  # [R, d, m]
    nu_v: torch.Tensor  # [R, d, m]


def _base_smem_bytes(n: int, m: int, d: int, batch_size: int,
                     cluster: int) -> int:
    """One block's shared memory without the pushed rows' buffer (mirrors
    ``base_smem_bytes`` in the .cu source)."""
    c = max(cluster, 1)
    rows = -(-n // c) + -(-m // c)
    return 8 * rows + (8 if c > 1 else 0) + 4 * (
        3 * rows * d + batch_size * (14 + 2 * d) + 2)


def pushed_rows(n: int, m: int, d: int, batch_size: int, cluster: int,
                extra: int = 0) -> int:
    """At C > 1, the batch rows whose operand rows (3 * d floats each) one
    block's buffer holds at once: the whole batch where it fits beside the
    rest of the block and ``extra`` more bytes, else as many rows as fit
    (at least one), and a step takes its batch in rounds of that many rows;
    0 at C = 1 and PACKED (mirrors ``pushed_rows`` in the .cu source)."""
    if cluster <= 1:
        return 0
    free = SMEM_PER_BLOCK - _base_smem_bytes(n, m, d, batch_size,
                                             cluster) - extra
    return max(1, min(batch_size, free // (12 * d)))


def epoch_smem_bytes(n: int, m: int, d: int, batch_size: int,
                     cluster: int = 1, extra: int = 0) -> int:
    """Shared memory of one kernel block at launch shape ``cluster``
    (mirrors ``epoch_smem_bytes`` in the .cu source; PACKED counts as
    C = 1).  Over the block's share of rows, ceil(n / C) + ceil(m / C): a
    stamped list head (8 bytes), and the state and its two moments, d
    floats each; per batch row three list links, three entry rows, three
    touched-row slots, 2 * d contributions, two (logit, z) pairs and a
    loss sum; two touched-row counts.  When C > 1 also the buffer the
    rows' owners push each step's rows into, 3 * d floats for each of
    :func:`pushed_rows` batch rows (``extra`` as there), and its mbarrier
    (8 bytes)."""
    return (_base_smem_bytes(n, m, d, batch_size, cluster)
            + 12 * d * pushed_rows(n, m, d, batch_size, cluster, extra))


def min_cluster(n: int, m: int, d: int, batch_size: int) -> Optional[int]:
    """The smallest C of ``GATE_CLUSTERS`` (1, 2, 4, 8, 16) at which one
    block of a run (its share of the rows, and the batch's scratch) fits a
    block's shared memory; None where none does."""
    return next((c for c in GATE_CLUSTERS
                 if epoch_smem_bytes(n, m, d, batch_size, c)
                 <= SMEM_PER_BLOCK), None)


def epoch_kernel_supported(n: int, m: int, d: int, batch_size: int) -> bool:
    """Does one run's epoch fit a cluster of at most 16 blocks?  Shape-only
    (no R, no card), so the choice of trainer depends on neither."""
    return min_cluster(n, m, d, batch_size) is not None


def choose_cluster(runs: int, resident_runs: Callable[[int], int],
                   floor: int = 1, who: str = "choose_cluster") -> int:
    """The launch shape among the C of ``CLUSTER_SIZES`` at or above
    ``floor`` (the smallest C whose block fits, :func:`min_cluster`): the
    largest C for which ``resident_runs(C)`` (runs the card holds at once
    on clusters of C blocks of 512 threads) is at least ``runs``, so every
    run is resident in one wave; else, at ``floor`` 1, PACKED (more runs
    than the card holds one to an SM: several runs share each SM; its
    block is the C = 1 block); else the C with the most resident runs (the
    largest on a tie), whose clusters then run in waves.  Raises
    ``ValueError`` (its message led by ``who``) where the card holds no
    cluster of any of those sizes: at ``floor`` 16, a card that does not
    schedule the non-portable C = 16."""
    if runs < 1:
        return PACKED if floor == 1 else floor
    held = {}
    for c in CLUSTER_SIZES:
        if c < floor:
            break
        held[c] = resident_runs(c)
        if held[c] >= runs:
            return c
    if floor == 1:
        return PACKED
    best = max(held, key=lambda c: (held[c], c))
    if held[best] < 1:
        sizes = ", ".join(f"C = {c}" for c in sorted(held))
        raise ValueError(f"{who}: the card holds no cluster of any size from "
                         f"C = {floor} up ({sizes}; C = 16 needs the "
                         f"non-portable cluster attribute)")
    return best


def check_launch_shape(who: str, cluster: Optional[int],
                       floor: Optional[int], smem: Callable[[int], int]
                       ) -> None:
    """Raise ``ValueError`` unless ``floor`` (the smallest C that fits) is
    not None and a forced ``cluster`` (None: the chooser's) is PACKED or a
    ``CLUSTER_SIZES`` entry whose block fits, at or above ``floor``.
    ``smem(C)`` gives the shared memory of one block at C."""
    if floor is None:
        c = GATE_CLUSTERS[-1]
        raise ValueError(
            f"{who}: needs {smem(c)} B of shared memory in each block even "
            f"at C = {c}, the largest cluster (limit "
            f"{SMEM_PER_BLOCK}; a block holds its share of the rows' state, "
            f"moments and list heads, and the batch's scratch)")
    if cluster is None:
        return
    if cluster not in CLUSTER_SIZES + (PACKED,):
        raise ValueError(f"{who}: cluster={cluster}, expected PACKED "
                         f"({PACKED}) or one of {CLUSTER_SIZES}")
    if max(cluster, 1) < floor:
        name = "PACKED (the C = 1 block)" if cluster == PACKED \
            else f"C = {cluster}"
        raise ValueError(
            f"{who}: cluster={cluster}: {name} needs {smem(cluster)} B of "
            f"shared memory in one block (limit {SMEM_PER_BLOCK}); the "
            f"smallest C that fits this shape is {floor}")


def block_threads(cluster: int) -> int:
    """Threads per block at launch shape ``cluster``."""
    return 256 if cluster == PACKED else 512


def _adam_consts(b1: float, b2: float):
    """float32 constants shared by the kernel and the plain version."""
    f32 = lambda v: float(torch.tensor(v, dtype=torch.float32))
    log = lambda v: float(torch.log(torch.tensor(v, dtype=torch.float32)))
    return f32(b1), f32(1.0 - b1), f32(b2), f32(1.0 - b2), log(b1), log(b2)


def _unpack(stream: Sequence[torch.Tensor], t: int, pack: tuple):
    """Batch ``t`` of the stream as (u, i, j, z), each ``[R, bs]``."""
    mode, bits_n, bits_m, bits_z, denom = pack
    if mode == "none":
        return tuple(a[:, t] for a in stream)
    y = stream[0][:, t]
    u = y & ((1 << bits_n) - 1)
    i = (y >> bits_n) & ((1 << bits_m) - 1)
    j = (y >> (bits_n + bits_m)) & ((1 << bits_m) - 1)
    if mode == "full":
        k = (y >> (bits_n + 2 * bits_m)) & ((1 << bits_z) - 1)
        z = k.to(torch.float32) / float(denom)
    else:
        z = stream[1][:, t]
    return u, i, j, z


def _rows_first(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(1, 2).contiguous()


def _forward(p_u, p_v, u, i, j, z, mask):
    """One batch's forward over rows-first tables ``[R, rows, d]``:
    returns (eu, dv ``[R, bs, d]``, masked-mean BCE ``[R]``, g ``[R, bs]``)."""
    eu = gather_rows(p_u, u)
    dv = gather_rows(p_v, i) - gather_rows(p_v, j)
    logits = torch.sum(eu * dv, dim=-1)
    bce = (torch.clamp(logits, min=0.0) - logits * z
           + torch.log1p(torch.exp(-torch.abs(logits))))
    inv_cnt = 1.0 / torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    loss = torch.sum(bce * mask, dim=-1) * inv_cnt
    g = (torch.sigmoid(logits) - z) * mask * inv_cnt.unsqueeze(-1)
    return eu, dv, loss, g


def _index_add(rows: int, idx: torch.Tensor, vals: torch.Tensor):
    """Sum ``vals [R, E, d]`` into a zero ``[R, rows, d]`` at row ``idx
    [R, E]``, each row's entries in entry order (a sequential index_add_)."""
    r, _, d = vals.shape
    runs = torch.arange(r, device=vals.device).unsqueeze(-1)
    return torch.zeros(r * rows, d, device=vals.device).index_add_(
        0, (runs * rows + idx).reshape(-1).to(torch.int64),
        vals.reshape(-1, d)).reshape(r, rows, d)


def _v_grad_interleaved(m: int, i, j, g_v_rows):
    """V's gradient with entries in batch order i_0, j_0, i_1, j_1, ...
    (+g*eu, -g*eu), as the fused-epoch kernel sums them."""
    r = i.shape[0]
    return _index_add(m, torch.stack([i, j], dim=-1).reshape(r, -1),
                      torch.stack([g_v_rows, -g_v_rows], dim=-2).reshape(
                          r, -1, g_v_rows.shape[-1]))


def train_epoch_reference(state: EpochState, stream, lr, wd, step0, count,
                          pack: tuple = ("none", 0, 0, 0, 1), b1: float = 0.9,
                          b2: float = 0.999, eps: float = 1e-8):
    """One epoch per run in plain PyTorch; returns (new_state, loss [R]).

    Same arguments as :func:`train_epoch`.  Runs step together; a run past
    its own ``ceil(count / bs)`` batches keeps its state."""
    return _epoch_reference(state, stream, lr, wd, step0, count, pack, b1,
                            b2, eps, _v_grad_interleaved)


def _epoch_reference(state, stream, lr, wd, step0, count, pack, b1, b2, eps,
                     v_grad):
    """:func:`train_epoch_reference` with V's gradient summed by
    ``v_grad(m, i, j, g_v_rows)``."""
    b1f, omb1, b2f, omb2, log_b1, log_b2 = _adam_consts(b1, b2)
    r, d, n = state.u_t.shape
    m = state.v_t.shape[2]
    num_batches, bs = stream[0].shape[1:]
    dev = state.u_t.device
    p_u, mu_u, nu_u = (_rows_first(a) for a in
                       (state.u_t, state.mu_u, state.nu_u))
    p_v, mu_v, nu_v = (_rows_first(a) for a in
                       (state.v_t, state.mu_v, state.nu_v))
    count = count.to(torch.int32)
    num_exec = (count + bs - 1) // bs
    steps = torch.clamp(num_exec, max=num_batches)
    slot_iota = torch.arange(bs, device=dev)
    col = lambda v: v.reshape(r, 1, 1)

    def adam(p, mu, nu, grad, bc1, bc2, active):
        grad = grad + col(wd) * p
        mu_new = b1f * mu + omb1 * grad
        nu_new = b2f * nu + omb2 * grad * grad
        p_new = p - col(lr) * (mu_new / col(bc1)) / (
            torch.sqrt(nu_new / col(bc2)) + eps)
        keep = lambda new, old: torch.where(col(active), new, old)
        return keep(p_new, p), keep(mu_new, mu), keep(nu_new, nu)

    loss_sum = torch.zeros(r, dtype=torch.float32, device=dev)
    for t in range(int(steps.max()) if r else 0):
        active = t < steps
        u, i, j, z = _unpack(stream, t, pack)
        mask = ((t * bs + slot_iota) < count.unsqueeze(-1)).to(torch.float32)
        eu, dv, loss, g = _forward(p_u, p_v, u, i, j, z, mask)
        grad_u = _index_add(n, u, g.unsqueeze(-1) * dv)
        grad_v = v_grad(m, i, j, g.unsqueeze(-1) * eu)

        t_step = step0 + float(t + 1)
        bc1 = 1.0 - torch.exp(t_step * log_b1)
        bc2 = 1.0 - torch.exp(t_step * log_b2)
        p_u, mu_u, nu_u = adam(p_u, mu_u, nu_u, grad_u, bc1, bc2, active)
        p_v, mu_v, nu_v = adam(p_v, mu_v, nu_v, grad_v, bc1, bc2, active)
        loss_sum = loss_sum + torch.where(active, loss,
                                          torch.zeros_like(loss))

    new_state = EpochState(*(_rows_first(a) for a in
                             (p_u, p_v, mu_u, nu_u, mu_v, nu_v)))
    return new_state, loss_sum / torch.clamp(num_exec.to(torch.float32),
                                             min=1.0)


def _check(name: str, t: torch.Tensor, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 11
             + [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_void_p])


def _on(device: torch.device) -> bool:
    """True for a CUDA device, False for the CPU; raises for any other."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"train_epoch: unsupported device {device}")


def _library():
    lib = _build.bind("epoch_kernel.cu", "mfcd_train_epoch", _ARGTYPES)
    occupancy = lib.mfcd_epoch_occupancy
    if occupancy.argtypes is None:
        occupancy.argtypes = ([ctypes.c_int] * 5
                              + [ctypes.POINTER(ctypes.c_int)] * 2)
        occupancy.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def epoch_occupancy(n: int, m: int, d: int, batch_size: int, cluster: int,
                    device_index: int) -> tuple:
    """On card ``device_index``, at launch shape ``cluster``: (blocks that
    fit on one SM, runs resident on the card at once; 0 where the card does
    not schedule clusters of that size)."""
    lib = _library()
    blocks, runs = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.mfcd_epoch_occupancy(cluster, n, m, d, batch_size,
                                       ctypes.byref(blocks),
                                       ctypes.byref(runs))
    _build.raise_on(lib, err, "epoch kernel occupancy query")
    return blocks.value, runs.value


_printed_clusters: set = set()


def cluster_size(runs: int, n: int, m: int, d: int, batch_size: int,
                 device, floor: Optional[int] = None) -> int:
    """:func:`choose_cluster` for this shape on ``device``, from the card's
    occupancy query, at or above ``floor`` (None: K1's,
    :func:`min_cluster`; a shape no C up to 16 fits raises, and so does a
    floor of 16 on a card that holds no 16-block cluster, with the shape
    in the message).  Printed once per process and choice, with the
    floor."""
    if floor is None:
        floor = min_cluster(n, m, d, batch_size)
        check_launch_shape(
            "cluster_size", None, floor,
            lambda c: epoch_smem_bytes(n, m, d, batch_size, c))
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    query = lambda c: epoch_occupancy(n, m, d, batch_size, c, idx)[1]
    c = choose_cluster(runs, query, floor,
                       who=f"cluster_size: n={n}, m={m}, d={d}, "
                           f"bs={batch_size}, smallest C {floor}")
    choice = (idx, runs, n, m, d, batch_size, floor, c)
    if choice not in _printed_clusters:
        _printed_clusters.add(choice)
        blocks, held = epoch_occupancy(n, m, d, batch_size, c, idx)
        ctas = max(c, 1)
        waves = -(-runs // held) if held else 0
        print(f"mfcd_tpu_torch: epoch kernel = {runs} runs x {ctas} "
              f"block{'s' if ctas > 1 else ''} per run of "
              f"{block_threads(c)} threads (n={n}, m={m}, d={d}, "
              f"bs={batch_size}; smallest C {floor}; {blocks} blocks per SM"
              + (f"; {held} runs resident, {waves} waves" if waves > 1
                 else "") + ")", flush=True)
    return c


def train_epoch(state: EpochState, stream, lr, wd, step0, count,
                pack: tuple = ("none", 0, 0, 0, 1), b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8):
    """One training epoch per run; returns ``(state, loss [R])``.

    ``stream`` holds the shuffled batch rows as ``[R, B, bs]`` arrays in the
    layout ``pack = (mode, bits_n, bits_m, bits_z, label_denom)`` names:
    "full" one packed int32, "uij" packed int32 + float32 z, "none" int32
    u, i, j + float32 z.  ``lr``, ``wd``, ``step0`` (the Adam step count
    before this epoch) are float32 ``[R]``, ``count`` int32 ``[R]``.

    CPU tensors run :func:`train_epoch_reference`.  CUDA tensors launch the
    kernel at the launch shape :func:`cluster_size` chooses, which updates
    the state in place; anything else raises.  Every launch shape gives the
    same bits; a launch the card refuses raises."""
    return _train_epoch(state, stream, lr, wd, step0, count, pack, b1, b2,
                        eps)


def _train_epoch(state: EpochState, stream, lr, wd, step0, count,
                 pack: tuple = ("none", 0, 0, 0, 1), b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 cluster: Optional[int] = None):
    """:func:`train_epoch` at launch shape ``cluster`` (PACKED or a
    ``CLUSTER_SIZES`` entry whose block fits; None: :func:`cluster_size`
    chooses), for the checks that every launch shape gives the same bits.
    On the card a forced ``cluster`` below the smallest C that fits, PACKED
    included, raises ``ValueError`` before any launch."""
    global EPOCH_LAUNCHES
    dev = state.u_t.device
    if not _on(dev):
        return train_epoch_reference(state, stream, lr, wd, step0, count,
                                     pack, b1, b2, eps)

    mode, bits_n, bits_m, bits_z, denom = pack
    if mode not in _MODES:
        raise ValueError(f"train_epoch: unknown pack mode {mode!r}")
    r, d, n = state.u_t.shape
    m = state.v_t.shape[2]
    stream = tuple(stream)
    if len(stream) != _STREAM_ARRAYS[mode]:
        raise ValueError(f"train_epoch: pack {mode!r} takes "
                         f"{_STREAM_ARRAYS[mode]} stream arrays")
    num_batches, bs = stream[0].shape[1:]
    floor = min_cluster(n, m, d, bs)
    check_launch_shape(f"train_epoch: n={n}, m={m}, d={d}, bs={bs}", cluster,
                       floor, lambda c: epoch_smem_bytes(n, m, d, bs, c))
    f32, i32 = torch.float32, torch.int32
    for name, a, rows in zip(EpochState._fields, state, (n, m, n, n, m, m)):
        _check(name, a, f32, (r, d, rows), dev)
    sshape = (r, num_batches, bs)
    kinds = {"full": (i32,), "uij": (i32, f32),
             "none": (i32, i32, i32, f32)}[mode]
    for k, (a, dt) in enumerate(zip(stream, kinds)):
        _check(f"stream[{k}]", a, dt, sshape, dev)
    for name, a in (("lr", lr), ("wd", wd), ("step0", step0)):
        _check(name, a, f32, (r,), dev)
    _check("count", count, i32, (r,), dev)

    s_ints = ([stream[0], None, None] if mode != "none"
              else list(stream[:3]))
    s_z = None if mode == "full" else stream[-1]
    ptr = lambda a: None if a is None else a.data_ptr()
    b1f, omb1, b2f, omb2, log_b1, log_b2 = _adam_consts(b1, b2)
    loss = torch.empty(r, dtype=f32, device=dev)
    if cluster is None:
        cluster = cluster_size(r, n, m, d, bs, dev, floor)
    lib = _library()
    err = lib.mfcd_train_epoch(
        *(a.data_ptr() for a in state), *(ptr(a) for a in s_ints), ptr(s_z),
        lr.data_ptr(), wd.data_ptr(), step0.data_ptr(), count.data_ptr(),
        loss.data_ptr(), r, n, m, d, num_batches, bs, _MODES[mode], bits_n,
        bits_m, bits_z, denom, b1f, omb1, b2f, omb2, float(eps), log_b1,
        log_b2, cluster, _build.stream_ptr(dev))
    _build.raise_on(lib, err, "epoch kernel")
    EPOCH_LAUNCHES += 1
    if cluster > 1:
        obs.count(PUSH_LAUNCHES, 1)
    return state, loss
