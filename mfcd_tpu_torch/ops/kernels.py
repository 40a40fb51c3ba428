"""The fused training epoch: a hand-written CUDA kernel and its plain version.

Counterpart of ``mfcd_tpu/ops/kernels.py`` (``EpochState``,
``pallas_train_epoch``, ``pallas_epoch_supported``).  One call trains one
epoch for each of R runs: for every executed batch, forward, masked-mean
BCE, gradient scatter into U and V, and a dense coupled-weight-decay Adam
over every element, with the state carried in the ``[R, d, rows]`` layout
of the JAX package.

- :func:`train_epoch` launches ``ops/csrc/epoch_kernel.cu`` (one thread
  block per run, state resident in shared memory) for CUDA tensors, and
  runs :func:`train_epoch_reference` for CPU tensors only.  On the card the
  state tensors are updated in place, as the TPU kernel aliases them.
- :func:`train_epoch_reference` is the same function in plain PyTorch:
  index gathers, ``index_add_`` in batch order, the same Adam arithmetic,
  the same executed batches.
- :func:`epoch_kernel_supported` is the shape gate: the kernel's shared
  memory must fit one block's 232,448 bytes.

``onehot_forward_logits`` (a TPU matmul stand-in for a gather) is not
ported: ``models.mf.forward_logits`` computes the same values.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from mfcd_tpu_torch.models.mf import gather_rows

EPOCH_LAUNCHES = 0          # kernel launches by train_epoch, nowhere else
SMEM_PER_BLOCK = 232_448    # bytes of shared memory one Hopper block may use
MAX_BATCH = 512            # one batch row per thread of a 512-thread block
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


def epoch_smem_bytes(n: int, m: int, d: int, batch_size: int) -> int:
    """Shared memory of one kernel block (mirrors ``epoch_smem_bytes`` in
    the .cu source): U, V, 4 moments-and-gradient planes, per-row scratch."""
    return 4 * (4 * (n + m) * d + batch_size * (5 + 2 * d))


def epoch_kernel_supported(n: int, m: int, d: int, batch_size: int) -> bool:
    """Does one run's epoch fit a thread block?  Shape-only."""
    return (batch_size <= MAX_BATCH
            and epoch_smem_bytes(n, m, d, batch_size) <= SMEM_PER_BLOCK)


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


def train_epoch_reference(state: EpochState, stream, lr, wd, step0, count,
                          pack: tuple = ("none", 0, 0, 0, 1), b1: float = 0.9,
                          b2: float = 0.999, eps: float = 1e-8):
    """One epoch per run in plain PyTorch; returns (new_state, loss [R]).

    Same arguments as :func:`train_epoch`.  Runs step together; a run past
    its own ``ceil(count / bs)`` batches keeps its state."""
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
    runs = torch.arange(r, device=dev).unsqueeze(-1)
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
        eu = gather_rows(p_u, u)
        dv = gather_rows(p_v, i) - gather_rows(p_v, j)
        logits = torch.sum(eu * dv, dim=-1)
        bce = (torch.clamp(logits, min=0.0) - logits * z
               + torch.log1p(torch.exp(-torch.abs(logits))))
        inv_cnt = 1.0 / torch.clamp(torch.sum(mask, dim=-1), min=1.0)
        loss = torch.sum(bce * mask, dim=-1) * inv_cnt
        g = (torch.sigmoid(logits) - z) * mask * inv_cnt.unsqueeze(-1)

        g_u_rows = g.unsqueeze(-1) * dv                       # [R, bs, d]
        grad_u = torch.zeros(r * n, d, device=dev).index_add_(
            0, (runs * n + u).reshape(-1).to(torch.int64),
            g_u_rows.reshape(-1, d)).reshape(r, n, d)
        g_v_rows = g.unsqueeze(-1) * eu
        # Entries in batch order i_0, j_0, i_1, j_1, ... (+g*eu, -g*eu).
        idx_v = torch.stack([runs * m + i, runs * m + j], dim=-1)
        val_v = torch.stack([g_v_rows, -g_v_rows], dim=-2)
        grad_v = torch.zeros(r * m, d, device=dev).index_add_(
            0, idx_v.reshape(-1).to(torch.int64),
            val_v.reshape(-1, d)).reshape(r, m, d)

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
             + [ctypes.c_float] * 7 + [ctypes.c_void_p])


def _library():
    from mfcd_tpu_torch.ops import _build

    lib = _build.load("epoch_kernel.cu")
    if lib.mfcd_train_epoch.argtypes is None:
        lib.mfcd_train_epoch.argtypes = _ARGTYPES
        lib.mfcd_train_epoch.restype = ctypes.c_int
        lib.mfcd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mfcd_cuda_error_string.restype = ctypes.c_char_p
    return lib


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
    kernel, which updates the state in place; anything else raises."""
    global EPOCH_LAUNCHES
    dev = state.u_t.device
    if dev.type == "cpu":
        return train_epoch_reference(state, stream, lr, wd, step0, count,
                                     pack, b1, b2, eps)
    if dev.type != "cuda":
        raise ValueError(f"train_epoch: unsupported device {dev}")

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
    if not epoch_kernel_supported(n, m, d, bs):
        raise ValueError(
            f"train_epoch: n={n}, m={m}, d={d}, bs={bs} needs "
            f"{epoch_smem_bytes(n, m, d, bs)} B of shared memory "
            f"(limit {SMEM_PER_BLOCK}) or bs > {MAX_BATCH}")
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
    lib = _library()
    err = lib.mfcd_train_epoch(
        *(a.data_ptr() for a in state), *(ptr(a) for a in s_ints), ptr(s_z),
        lr.data_ptr(), wd.data_ptr(), step0.data_ptr(), count.data_ptr(),
        loss.data_ptr(), r, n, m, d, num_batches, bs, _MODES[mode], bits_n,
        bits_m, bits_z, denom, b1f, omb1, b2f, omb2, float(eps), log_b1,
        log_b2, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("epoch kernel launch failed: "
                           + lib.mfcd_cuda_error_string(err).decode())
    EPOCH_LAUNCHES += 1
    return state, loss
