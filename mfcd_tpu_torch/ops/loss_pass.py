"""The masked batch-mean BCE of a split: the validation pass (L1).

Counterpart of ``mfcd_tpu/train/trainer.py::batch_losses``: pad a split's
``[..., N]`` rows to whole batches, take each batch's mean BCE over its
valid rows (0 for a batch with none), then the mean of those means over
the non-empty batches.  The trainers call :func:`batch_losses` once an
epoch on the validation split; ``eval/metrics.py::evaluate_split`` calls
:func:`losses_and_hits` once on the test split, which also gives each
run's count of correct valid rows (``sigmoid(logit) > 0.5`` equal to
``z``), the test accuracy's numerator.

On CUDA tensors both launch ``ops/csrc/loss_pass.cu``: two launches a
pass (one where the split has no rows), counted by ``LOSS_LAUNCHES``,
with no host sync; U and V are read in place through their strides, so
the trainer's ``[R, d, n]`` tables pass as ``transpose(1, 2)`` views.
:func:`losses_and_hits` takes the kernel's counting variant, whose loss
is the loss-only variant's, bit for bit, and adds the rows it scored to
the open call's ``test_pass.l1_rows`` counter.  On CPU tensors they run
the plain versions, block by block; any other device raises.  The kernel
sums a batch's rows and the epoch's batch means in another order than the
plain version, so the two losses agree to float32 rounding, not bit for
bit; the counts are integers, and equal where the logits are (d = 2).
"""

from __future__ import annotations

import ctypes

import torch

from mfcd_tpu_torch.models.mf import MFParams, forward_logits
from mfcd_tpu_torch.ops import _build
from mfcd_tpu_torch.ops.losses import bce_with_logits
from mfcd_tpu_torch.utils import observability as obs

LOSS_LAUNCHES = 0   # L1 launches, counted where they are made
L1_ROWS = "test_pass.l1_rows"   # the counter of rows the counting pass scored


def _pad_last(a: torch.Tensor, pad: int, fill=0) -> torch.Tensor:
    if pad == 0:
        return a
    return torch.nn.functional.pad(a, (0, pad), value=fill)


def _pad_to_batches(split, batch_size: int):
    """Pad ``[..., rows]`` fields to whole batches; returns ``[..., B, bs]``."""
    rows = split.u.shape[-1]
    num_batches = -(-rows // batch_size)
    pad = num_batches * batch_size - rows
    shape = split.u.shape[:-1] + (num_batches, batch_size)
    return tuple(_pad_last(a, pad, False if a.dtype == torch.bool else 0)
                 .reshape(shape)
                 for a in (split.u, split.i, split.j, split.z, split.valid))


# Batches per block in the streamed loss/eval passes.
_LOSS_BLOCK_BATCHES = 64


def map_batch_blocks(block_fn, arrays, num_batches: int,
                     block: int = _LOSS_BLOCK_BATCHES):
    """Apply ``block_fn`` to ``[..., block, bs]`` slices of ``[..., B, bs]``
    arrays in turn and concatenate its per-batch ``[..., block]`` outputs."""
    if num_batches <= block:
        return block_fn(arrays)
    outs = [block_fn(tuple(a[..., s:s + block, :] for a in arrays))
            for s in range(0, num_batches, block)]
    return tuple(torch.cat(parts, dim=-1) for parts in zip(*outs))


def batch_losses_reference(params: MFParams, split, batch_size: int):
    """:func:`batch_losses` in plain PyTorch, on any device."""
    u, i, j, z, valid = _pad_to_batches(split, batch_size)

    def block_stats(args):
        bu, bi, bj, bz, bv = args
        losses = bce_with_logits(forward_logits(params, bu, bi, bj), bz)
        return (torch.sum(torch.where(bv, losses, torch.zeros_like(losses)),
                          dim=-1),
                torch.sum(bv, dim=-1))

    per_batch_sum, per_batch_cnt = map_batch_blocks(
        block_stats, (u, i, j, z, valid), u.shape[-2])
    nonempty = per_batch_cnt > 0
    per_batch_mean = torch.where(
        nonempty, per_batch_sum / torch.clamp(per_batch_cnt, min=1),
        torch.zeros_like(per_batch_sum))
    epoch_mean = (torch.sum(per_batch_mean, dim=-1)
                  / torch.clamp(torch.sum(nonempty, dim=-1), min=1))
    return per_batch_mean, epoch_mean


def losses_and_hits_reference(params: MFParams, split, batch_size: int):
    """:func:`losses_and_hits` in plain PyTorch, on any device: the loss of
    :func:`batch_losses_reference`, then each run's correct valid rows
    counted block by block."""
    per_batch_mean, epoch_mean = batch_losses_reference(params, split,
                                                        batch_size)
    u, i, j, z, valid = _pad_to_batches(split, batch_size)

    def block_hits(args):
        bu, bi, bj, bz, bv = args
        pred = (torch.sigmoid(forward_logits(params, bu, bi, bj))
                > 0.5).to(torch.float32)
        return (torch.sum(bv & (pred == bz), dim=-1),)

    (hits,) = map_batch_blocks(block_hits, (u, i, j, z, valid), u.shape[-2])
    return (per_batch_mean, epoch_mean,
            torch.sum(hits, dim=-1).to(torch.int32))


_ARGS = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3
         + [ctypes.c_void_p] + [ctypes.c_longlong] * 3
         + ([ctypes.c_void_p] + [ctypes.c_longlong] * 2) * 5
         + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
         + [ctypes.c_void_p] * 5)
_FIELDS = (("u", torch.int32), ("i", torch.int32), ("j", torch.int32),
           ("z", torch.float32), ("valid", torch.bool))


def _on(device: torch.device) -> bool:
    """True for a CUDA device, False for the CPU; raises for any other."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"batch_losses: unsupported device {device}")


def _library():
    return _build.bind("loss_pass.cu", "mfcd_loss_pass", _ARGS)


def _launch(params: MFParams, split, batch_size: int, count: bool = False):
    """L1 over ``[R, N]`` fields: (``per_batch_mean [R, B]``,
    ``epoch_mean [R]``), and with ``count`` its counting variant's
    ``correct [R]`` (int32) after them."""
    global LOSS_LAUNCHES
    U, V = params.U, params.V
    dev = U.device
    fields = [getattr(split, name) for name, _ in _FIELDS]
    for (name, dtype), t in zip(_FIELDS, fields):
        if t.dtype != dtype:
            raise ValueError(f"batch_losses: {name} is {t.dtype}, the kernel "
                             f"takes {dtype}")
    if U.dtype != torch.float32 or V.dtype != torch.float32:
        raise ValueError(f"batch_losses: U {U.dtype} and V {V.dtype}, the "
                         f"kernel takes torch.float32")
    if any(t.device != dev for t in [V] + fields):
        raise ValueError(f"batch_losses: params and split must share {dev}")
    if (U.dim() != 3 or V.dim() != 3 or fields[0].dim() != 2
            or V.shape[0] != U.shape[0] or V.shape[2] != U.shape[2]
            or fields[0].shape[0] != U.shape[0]
            or any(t.shape != fields[0].shape for t in fields)):
        raise ValueError(
            f"batch_losses: U {tuple(U.shape)}, V {tuple(V.shape)}, split "
            f"{[tuple(t.shape) for t in fields]}; the kernel takes [R, n, d], "
            f"[R, m, d] and [R, N]")
    r, rows = fields[0].shape
    d = U.shape[2]
    if batch_size < 1 or d < 1:
        raise ValueError(f"batch_losses: batch_size={batch_size}, d={d}; "
                         f"the kernel takes 1 or more")
    batches = -(-rows // batch_size)
    means = torch.empty((r, batches), dtype=torch.float32, device=dev)
    epoch = torch.empty((r,), dtype=torch.float32, device=dev)
    out = (means, epoch)
    hits_ptr = correct_ptr = None
    if count:
        hits = torch.empty((r, batches), dtype=torch.int32, device=dev)
        correct = torch.empty((r,), dtype=torch.int32, device=dev)
        out += (correct,)
        hits_ptr, correct_ptr = hits.data_ptr(), correct.data_ptr()
    if r == 0:
        return out
    strided = []
    for t in fields:
        strided += [t.data_ptr(), t.stride(0), t.stride(1)]
    lib = _library()
    err = lib.mfcd_loss_pass(U.data_ptr(), *U.stride(), V.data_ptr(),
                             *V.stride(), *strided, r, rows, batch_size, d,
                             means.data_ptr(), epoch.data_ptr(), hits_ptr,
                             correct_ptr, _build.stream_ptr(dev))
    _build.raise_on(lib, err, "batch_losses (L1)")
    LOSS_LAUNCHES += 2 if batches else 1
    return out


def batch_losses(params: MFParams, split, batch_size: int):
    """Per-batch masked mean BCE ``[..., B]`` + the epoch average over
    non-empty batches ``[...]``.

    ``params`` hold ``U [..., n, d]``, ``V [..., m, d]``; ``split`` has
    ``u``, ``i``, ``j`` (int32), ``z`` (float32) and ``valid`` (bool)
    ``[..., N]``.  On a card the leading dims are one run axis, and every
    valid row's indices must lie in the tables."""
    if _on(params.U.device):
        return _launch(params, split, batch_size)
    return batch_losses_reference(params, split, batch_size)


def losses_and_hits(params: MFParams, split, batch_size: int):
    """:func:`batch_losses` and each run's count of correct valid rows,
    ``correct [...]`` (int32): rows where ``sigmoid(logit) > 0.5`` equals
    ``z``.  On a card one pass of L1's counting variant, whose rows the
    open call's ``test_pass.l1_rows`` counter gains."""
    if _on(params.U.device):
        out = _launch(params, split, batch_size, count=True)
        obs.count(L1_ROWS, split.u.numel())
        return out
    return losses_and_hits_reference(params, split, batch_size)
