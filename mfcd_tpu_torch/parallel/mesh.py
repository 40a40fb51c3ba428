"""Mesh parallelism over ``torch.distributed`` ranks: sweeps and the
(grid, data, tp)-sharded training step.

Counterpart of ``mfcd_tpu/parallel/mesh.py``.  The JAX package names a
mesh of devices and lets ``shard_map`` emit the collectives; the port runs
one process per device, and each rank holds a :class:`Mesh`: its place on
the named axes and one process group per axis, over the ranks that differ
from it only along that axis.  Ranks lie on the mesh in row-major order,
as JAX's ``reshape(g, dp, tp)`` lays devices out.

- **grid** (experiment DP): independent configurations, no traffic.
- **data** (batch DP): one run's minibatch split across ranks; the loss's
  sum and count, and the gradients, all-reduced over the axis.
- **tp** (feature TP): the embedding dimension d of U and V split across
  ranks; the logits' partial dots all-reduced over the axis.

The sharded step writes the model's gradient out by hand.  JAX's
differentiates through its ``psum``s, whose transposes sum the replicated
cotangents once more, so its gradients (and Adam moments) come out dp x tp
times the unsharded step's: its first Adam step cancels the factor, and
with coupled decay it then trains as if the decay were wd / (dp tp).  The
port's step equals the unsharded step, :func:`train_step`.

Global tensors are cut to a rank's block and put back together by
:func:`shard` and :func:`unshard`, after JAX's ``PartitionSpec``\\ s:
params ``PARAM_SPEC`` (grid, -, tp), the batch ``BATCH_SPEC`` (grid,
data), lr / wd / step ``GRID_SPEC`` (grid).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mfcd_tpu_torch.backend import resolve_device
from mfcd_tpu_torch.models.mf import MFParams, forward_logits, gather_rows
from mfcd_tpu_torch.ops.losses import bce_with_logits, masked_batch_mean
from mfcd_tpu_torch.ops.optim import AdamState, adam_init, adam_update

AXES = ("grid", "data", "tp")
PARAM_SPEC = ("grid", None, "tp")
BATCH_SPEC = ("grid", "data")
GRID_SPEC = ("grid",)


def factor_mesh(n_devices: int) -> Tuple[int, int, int]:
    """Factor a device count into (grid, data, tp) axis sizes.

    Greedy: give factors of 2 to grid first (the embarrassingly parallel
    axis), then data, then tp.  Non-power-of-two remainders go to grid.
    """
    g, dp, tp = 1, 1, 1
    rem = n_devices
    for target in ("grid", "data", "tp"):
        if rem % 2 == 0 and rem > 1:
            if target == "grid":
                g *= 2
            elif target == "data":
                dp *= 2
            else:
                tp *= 2
            rem //= 2
    g *= rem
    return g, dp, tp


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a mesh of every rank of the job.

    ``groups`` holds, for each axis longer than 1, the process group of
    the ranks that share this rank's place on the other axes; the whole
    mesh is the job's default group."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    device: torch.device
    groups: Dict[str, Any]

    @classmethod
    def create(cls, shape: Sequence[int], axis_names: Sequence[str],
               device=None) -> "Mesh":
        """The mesh of ``shape`` over every rank of the job, on this rank's
        ``device`` (``None``: its card).  Every rank must call it, in the
        same order as every other collective."""
        if not dist.is_initialized():
            raise RuntimeError("no process group: call "
                               "parallel.multihost.initialize (or launch) "
                               "first")
        shape = tuple(int(k) for k in shape)
        world = dist.get_world_size()
        if len(shape) != len(axis_names) or int(np.prod(shape)) != world:
            raise ValueError(f"a mesh of shape {shape} over axes "
                             f"{tuple(axis_names)} does not cover the job's "
                             f"{world} ranks")
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if dist.get_backend() == "nccl" and device.type != "cuda":
            raise ValueError("an nccl job's mesh lives on the card")
        rank = dist.get_rank()
        ranks = np.arange(world).reshape(shape)
        groups = {}
        for ax, name in enumerate(axis_names):
            if shape[ax] == 1:
                continue
            for line in np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax]):
                group = dist.new_group(line.tolist())
                if rank in line:
                    groups[name] = group
        return cls(shape, tuple(axis_names), rank, device, groups)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Each axis' index of ``rank`` (default: this rank)."""
        at = np.unravel_index(self.rank if rank is None else rank,
                              self.shape)
        return dict(zip(self.axis_names, (int(c) for c in at)))


def make_mesh(n_devices: Optional[int] = None, device=None,
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """The (grid, data, tp) mesh over the job's ranks, of ``shape`` or else
    ``factor_mesh`` of the rank count.  ``n_devices`` other than the job's
    rank count raises, as a count beyond the devices does in JAX."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"Need {n} ranks, the job has {world}; start one "
                         "rank per device (parallel.multihost.launch)")
    return Mesh.create(factor_mesh(n) if shape is None else shape, AXES,
                       device)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``'s ranks; the identity where the axis is 1 long."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def shard(mesh: Mesh, x: torch.Tensor, spec: Sequence[Optional[str]]
          ) -> torch.Tensor:
    """This rank's block of the global ``x``: dimension k split evenly over
    the axis ``spec[k]`` (``None``: whole), as a ``PartitionSpec``."""
    at = mesh.coords()
    for dim, name in enumerate(spec):
        if name is None:
            continue
        parts = mesh.axis_size(name)
        if x.shape[dim] % parts:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split over the {parts} ranks of '{name}'")
        step = x.shape[dim] // parts
        x = x.narrow(dim, at[name] * step, step)
    return x.to(mesh.device).contiguous()


def unshard(mesh: Mesh, local: torch.Tensor, spec: Sequence[Optional[str]]
            ) -> torch.Tensor:
    """The global tensor from every rank's block (``shard``'s inverse), on
    every rank."""
    local = local.contiguous()
    blocks = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(blocks, local)
    full = list(local.shape)
    for dim, name in enumerate(spec):
        if name is not None:
            full[dim] *= mesh.axis_size(name)
    out = local.new_empty(full)
    for rank, block in enumerate(blocks):
        at = mesh.coords(rank)
        index = tuple(
            slice(None) if name is None
            else slice(at[name] * local.shape[dim],
                       (at[name] + 1) * local.shape[dim])
            for dim, name in enumerate(spec))
        out[index] = block
    return out


def shard_state(mesh: Mesh, params: MFParams, opt: AdamState) -> tuple:
    """The step's params and Adam state, cut to this rank's blocks."""
    p = lambda t: shard(mesh, t, PARAM_SPEC)
    return (MFParams(p(params.U), p(params.V)),
            AdamState(tuple(map(p, opt.mu)), tuple(map(p, opt.nu)),
                      shard(mesh, opt.step, GRID_SPEC)))


def unshard_state(mesh: Mesh, params: MFParams, opt: AdamState) -> tuple:
    """``shard_state``'s inverse, on every rank."""
    p = lambda t: unshard(mesh, t, PARAM_SPEC)
    return (MFParams(p(params.U), p(params.V)),
            AdamState(tuple(map(p, opt.mu)), tuple(map(p, opt.nu)),
                      unshard(mesh, opt.step, GRID_SPEC)))


def _scatter_rows(like: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """Zeros like ``like`` ``[G, rows, d]`` with ``vals`` ``[G, B, d]``
    added at rows ``idx`` ``[G, B]``."""
    index = idx.to(torch.int64).unsqueeze(-1).expand_as(vals)
    return torch.zeros_like(like).scatter_add_(-2, index, vals)


def make_sharded_train_step(mesh: Mesh):
    """A training step sharded over (grid, data, tp).

    The step takes this rank's blocks (``shard_state``; the batch by
    ``BATCH_SPEC``, lr and wd by ``GRID_SPEC``):
      params:  MFParams with U [G/g, n, d/tp], V [G/g, m, d/tp]
      opt:     AdamState matching params, step [G/g]
      batch:   u, i, j, z, mask each [G/g, B/dp]
      lr, wd:  [G/g]
    and returns the new params, opt and per-config loss [G/g], each config
    equal to :func:`train_step` on the whole batch and d."""
    tp, data = mesh.groups.get("tp"), mesh.groups.get("data")

    def step(params: MFParams, opt: AdamState, u, i, j, z, mask, lr, wd):
        eu = gather_rows(params.U, u)
        ev = gather_rows(params.V, i) - gather_rows(params.V, j)
        logits = _all_reduce(torch.sum(eu * ev, dim=-1), tp)
        losses = bce_with_logits(logits, z)
        zero = torch.zeros_like(losses)
        sums = _all_reduce(torch.stack(
            [torch.sum(torch.where(mask, losses, zero), dim=-1),
             torch.sum(mask, dim=-1).to(losses.dtype)]), data)
        count = torch.clamp(sums[1], min=1.0)
        loss = sums[0] / count
        # d loss / d logit of each row of the global masked mean.
        dlogit = torch.where(mask, (torch.sigmoid(logits) - z)
                             / count.unsqueeze(-1), zero).unsqueeze(-1)
        g_u = _scatter_rows(params.U, u, dlogit * ev)
        g_v = _scatter_rows(params.V, torch.cat([i, j], dim=-1),
                            torch.cat([dlogit * eu, -dlogit * eu], dim=-2))
        grads = (_all_reduce(g_u, data), _all_reduce(g_v, data))
        new_p, new_opt = adam_update((params.U, params.V), grads, opt, lr,
                                     wd)
        return MFParams(*new_p), new_opt, loss

    return step


def train_step(params: MFParams, opt: AdamState, u, i, j, z, mask, lr, wd):
    """The unsharded step the sharded one must equal: autograd of the
    masked mean BCE of each config's batch, then ``adam_update``.  Takes
    and returns the global shapes of ``make_sharded_train_step``."""
    p = [t.detach().requires_grad_() for t in (params.U, params.V)]
    with torch.enable_grad():
        logits = forward_logits(MFParams(*p), u, i, j)
        loss = masked_batch_mean(bce_with_logits(logits, z), mask)
        grads = torch.autograd.grad(loss.sum(), p)
    new_p, new_opt = adam_update((params.U, params.V), grads, opt, lr, wd)
    return MFParams(*new_p), new_opt, loss.detach()


def replicate_opt_state_for_grid(params: MFParams) -> AdamState:
    """Fresh Adam state for grid-batched params (leading G axis)."""
    return adam_init((params.U, params.V), runs_shape=params.U.shape[:1])
