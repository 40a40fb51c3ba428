"""Multi-run trainer over the fused-epoch kernel.

Counterpart of ``mfcd_tpu/train/pallas_trainer.py``: trains a stack of R
runs with one :func:`mfcd_tpu_torch.ops.kernels.train_epoch` call per epoch.
Semantics match the eager trainer (``train/trainer.py``): the same keyed
stream mixing, the same dynamic batch trip counts and batch means, the
same coupled-weight-decay Adam (bias corrections as ``exp(t * log(beta))``
here, ``beta ** t`` there).  Per epoch:

1. advance the carried packed row stream by one epoch's bijection
   (``mix_stream`` with the epoch's keys, folded for every epoch before
   the loop; on the card one launch of S2),
2. one ``train_epoch`` call trains every run's epoch (on the card: one
   kernel launch), with the Adam step count carried across epochs,
3. a masked validation pass records the per-epoch val loss (on the
   card two launches of L1, ``ops/loss_pass.py``, reading the epoch's
   tables in place).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from mfcd_tpu_torch.core import prng
from mfcd_tpu_torch.data.btl import LabeledSplit
from mfcd_tpu_torch.models.mf import MFParams
from mfcd_tpu_torch.ops.kernels import (ADAM_ELEMENTS, RUN_STEPS, EpochState,
                                        train_epoch)
from mfcd_tpu_torch.ops.loss_pass import _pad_last, batch_losses
from mfcd_tpu_torch.ops.shuffle import (default_reshuffle_period, mix_stream,
                                        stream_tile_width)
from mfcd_tpu_torch.utils import observability as obs


def _pack_spec(n: int, m: int, label_denom: int):
    """How to pack a (u, i, j, z) row into int32 words.

    Returns ("full" | "uij" | "none", bits_n, bits_m, bits_z):
      full — u, i, j and the z numerator fit in 31 bits: one int32;
      uij  — only u, i, j fit: packed int32 + float32 z;
      none — shapes too large: four plain arrays.
    """
    bits_n = max((n - 1).bit_length(), 1)
    bits_m = max((m - 1).bit_length(), 1)
    bits_z = max(int(label_denom).bit_length(), 1)
    if bits_n + 2 * bits_m + bits_z <= 31:
        return "full", bits_n, bits_m, bits_z
    if bits_n + 2 * bits_m <= 31:
        return "uij", bits_n, bits_m, 0
    return "none", 0, 0, 0


def _pack_stream(train: LabeledSplit, pack: tuple, label_denom: int,
                 pad: int) -> tuple:
    """The packed ``[R, rows + pad]`` stream arrays of a training split."""
    mode, bits_n, bits_m, _ = pack
    if mode == "none":
        arrays = (train.u, train.i, train.j, train.z)
    else:
        uij = train.u | (train.i << bits_n) | (train.j << (bits_n + bits_m))
        if mode == "full":
            z_num = torch.round(train.z * float(label_denom)).to(torch.int32)
            arrays = (uij | (z_num << (bits_n + 2 * bits_m)),)
        else:
            arrays = (uij, train.z)
    return tuple(_pad_last(a.contiguous(), pad) for a in arrays)


def train_runs_kernel(
    params: MFParams,
    train: LabeledSplit,
    val: LabeledSplit,
    epochs_keys: torch.Tensor,
    lr: torch.Tensor,
    weight_decay: torch.Tensor,
    batch_size: int = 64,
    num_epochs: int = 30,
    label_denom: int = 1,
    reshuffle_period: int | None = None,
    train_rows: Optional[Sequence[int]] = None,
) -> Tuple[MFParams, torch.Tensor, torch.Tensor]:
    """Train R runs; returns (params, train_losses [R, E], val_losses [R, E]).

    ``params`` hold ``U [R, n, d]``, ``V [R, m, d]``; split fields are
    ``[R, N]``; ``epochs_keys`` ``[R, 2]``; ``lr`` / ``weight_decay``
    ``[R]``.  ``label_denom`` is the denominator of the training labels
    (K under soft labels, else 1); ``z * label_denom`` must be integral.
    The device is the tensors' own: on CPU tensors every epoch runs the
    kernel's plain version.  ``train_rows``, each run's training rows as
    the host holds them, counts each epoch's executed steps and dense Adam
    element updates in the open call's ``k1.run_steps`` and
    ``k1.adam_elements`` (None: not counted); nothing is read back."""
    period = reshuffle_period or default_reshuffle_period()
    r, n, d = params.U.shape
    m = params.V.shape[1]
    dev = params.U.device
    rows = train.u.shape[1]
    num_batches = -(-rows // batch_size)
    padded = num_batches * batch_size
    k_bits = max(rows - 1, 1).bit_length()
    tile_w = stream_tile_width(batch_size)
    if tile_w is None:
        period = 1

    state = EpochState(
        u_t=params.U.transpose(1, 2).contiguous(),
        v_t=params.V.transpose(1, 2).contiguous(),
        mu_u=torch.zeros((r, d, n), dtype=torch.float32, device=dev),
        nu_u=torch.zeros((r, d, n), dtype=torch.float32, device=dev),
        mu_v=torch.zeros((r, d, m), dtype=torch.float32, device=dev),
        nu_v=torch.zeros((r, d, m), dtype=torch.float32, device=dev),
    )
    count = train.count.to(torch.int32).contiguous()
    nonempty_batches = torch.ceil(count.to(torch.float32) / batch_size)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=dev).contiguous()
    wd = torch.as_tensor(weight_decay, dtype=torch.float32,
                         device=dev).contiguous()

    spec = _pack_spec(n, m, label_denom)
    stream = _pack_stream(train, spec, label_denom, padded - rows)
    kernel_pack = (*spec, label_denom)
    # fold_in(epochs key, e) for every epoch in one launch: split(k, E)
    # hashes the counters (0, e), as fold_in(k, e) does.
    epoch_keys = prng.split(epochs_keys.to(torch.int64), num_epochs)
    run_steps = (None if train_rows is None else
                 sum(min(-(-int(c) // batch_size), num_batches)
                     for c in train_rows))
    train_losses, val_losses = [], []
    # Nothing in the loop reads the card back or copies a host value to it:
    # on the card an epoch is S2, K1 and the validation pass's two launches.
    with obs.stages() as stage:
        for epoch in range(num_epochs):
            stage("mfcd.train.mix")
            stream = mix_stream(stream, epoch_keys[..., epoch, :], epoch,
                                count, k_bits, period=period, tile_w=tile_w,
                                folded=True)
            stage("mfcd.train.epoch")
            step0 = float(epoch) * nonempty_batches
            state, loss = train_epoch(
                state,
                tuple(a.reshape(r, num_batches, batch_size).contiguous()
                      for a in stream),
                lr, wd, step0, count, pack=kernel_pack)
            if run_steps is not None:
                obs.count(RUN_STEPS, run_steps)
                obs.count(ADAM_ELEMENTS, run_steps * (n + m) * d)
            stage("mfcd.train.val")
            epoch_params = MFParams(U=state.u_t.transpose(1, 2),
                                    V=state.v_t.transpose(1, 2))
            train_losses.append(loss)
            val_losses.append(batch_losses(epoch_params, val, batch_size)[1])
    final = MFParams(U=state.u_t.transpose(1, 2).contiguous(),
                     V=state.v_t.transpose(1, 2).contiguous())
    return (final, torch.stack(train_losses, dim=-1),
            torch.stack(val_losses, dim=-1))
