"""Eager training loop over a leading run axis.

Counterpart of ``mfcd_tpu/train/trainer.py`` (reference
``structure.py:812-878``): per epoch, advance the carried row stream by
one keyed bijection (``mix_stream``), step through the
``ceil(count / batch_size)`` batches that hold valid rows, take a masked
batch-mean BCE, and apply the dense coupled-weight-decay Adam; then a
validation pass.  Per-epoch train/val losses are means of per-batch means.

Several runs train at once (``[R, ...]`` tensors).  Where JAX ran a
``fori_loop`` per run under ``vmap``, this loops to the largest trip count
and leaves a run's state untouched past its own.  This is the CPU path
and, on the card, the path for shapes the fused-epoch kernel does not fit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mfcd_tpu_torch.data.btl import LabeledSplit
from mfcd_tpu_torch.core import prng
from mfcd_tpu_torch.models.mf import MatrixFactorization, MFParams, forward_logits
from mfcd_tpu_torch.ops.losses import bce_with_logits
from mfcd_tpu_torch.ops.optim import adam_init, adam_update
from mfcd_tpu_torch.ops.shuffle import (default_reshuffle_period, mix_stream,
                                        stream_tile_width)


def _pad_last(a: torch.Tensor, pad: int, fill=0) -> torch.Tensor:
    if pad == 0:
        return a
    return torch.nn.functional.pad(a, (0, pad), value=fill)


def _pad_to_batches(split: LabeledSplit, batch_size: int):
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


def batch_losses(params: MFParams, split: LabeledSplit, batch_size: int):
    """Per-batch masked mean BCE ``[..., B]`` + the epoch average over
    non-empty batches ``[...]``."""
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


def _where_runs(active: torch.Tensor, new: torch.Tensor,
                old: torch.Tensor) -> torch.Tensor:
    return torch.where(active.reshape(active.shape + (1,) * (new.dim() - 1)),
                       new, old)


def train_model(
    params: MFParams,
    train: LabeledSplit,
    val: LabeledSplit,
    epochs_key: torch.Tensor,
    lr,
    weight_decay,
    batch_size: int = 64,
    num_epochs: int = 30,
    reshuffle_period: int | None = None,
) -> Tuple[MFParams, torch.Tensor, torch.Tensor]:
    """Train R runs; returns ``(params, train_losses [R, E],
    val_losses [R, E])``.

    ``params`` hold ``U [R, n, d]``, ``V [R, m, d]``; split fields are
    ``[R, N]``; ``epochs_key`` is ``[R, 2]``; ``lr`` / ``weight_decay`` are
    floats or ``[R]``.  ``reshuffle_period`` defaults to
    ``MFCD_RESHUFFLE_PERIOD`` (4)."""
    period = reshuffle_period or default_reshuffle_period()
    dev = params.U.device
    r = params.U.shape[0]
    rows = train.u.shape[-1]
    k_bits = max(rows - 1, 1).bit_length()  # 2^k >= rows
    num_batches = -(-rows // batch_size)
    padded = num_batches * batch_size
    tile_w = stream_tile_width(batch_size)
    # Without a tile width the cheap mixing epochs would be rotation-only:
    # draw a fresh PRP every epoch instead.
    if tile_w is None:
        period = 1

    count = train.count.to(torch.int32)
    num_exec = torch.ceil(count.to(torch.float32) / batch_size).to(torch.int32)
    max_exec = int(num_exec.max()) if r else 0
    lr = torch.as_tensor(lr, dtype=torch.float32, device=dev).expand(r)
    wd = torch.as_tensor(weight_decay, dtype=torch.float32,
                         device=dev).expand(r)

    stream = tuple(_pad_last(a, padded - rows)
                   for a in (train.u, train.i, train.j, train.z))
    model = MatrixFactorization(params)
    opt = adam_init((model.U, model.V), runs_shape=(r,))
    slot_iota = torch.arange(batch_size, device=dev)
    train_losses, val_losses = [], []
    for epoch in range(num_epochs):
        kperm = prng.fold_in(epochs_key, epoch)
        stream = mix_stream(stream, kperm, epoch, count, k_bits,
                            period=period, tile_w=tile_w)
        su, si, sj, sz = (a.reshape(r, num_batches, batch_size)
                          for a in stream)
        loss_sum = torch.zeros(r, dtype=torch.float32, device=dev)
        for t in range(max_exec):
            active = t < num_exec
            mask = (t * batch_size + slot_iota) < count.unsqueeze(-1)
            logits = model(su[:, t], si[:, t], sj[:, t])
            losses = bce_with_logits(logits, sz[:, t])
            cnt = torch.sum(mask, dim=-1)
            loss = (torch.sum(torch.where(mask, losses,
                                          torch.zeros_like(losses)), dim=-1)
                    / torch.clamp(cnt, min=1))
            grads = torch.autograd.grad(loss.sum(), (model.U, model.V))
            with torch.no_grad():
                new_p, new_opt = adam_update(
                    (model.U, model.V), grads, opt, lr, wd)
                model.U.copy_(_where_runs(active, new_p[0], model.U))
                model.V.copy_(_where_runs(active, new_p[1], model.V))
                opt = opt._replace(
                    mu=tuple(_where_runs(active, a, b)
                             for a, b in zip(new_opt.mu, opt.mu)),
                    nu=tuple(_where_runs(active, a, b)
                             for a, b in zip(new_opt.nu, opt.nu)),
                    step=torch.where(active, new_opt.step, opt.step))
                loss_sum = loss_sum + torch.where(
                    active, loss.detach(), torch.zeros_like(loss_sum))
        with torch.no_grad():
            train_losses.append(loss_sum / torch.clamp(num_exec, min=1))
            val_losses.append(batch_losses(model.params(), val,
                                           batch_size)[1])
    final = MFParams(model.U.detach().clone(), model.V.detach().clone())
    return (final, torch.stack(train_losses, dim=-1),
            torch.stack(val_losses, dim=-1))
