"""Drive the port's multi-device layer over N ranks and check it.

    python3 -m mfcd_tpu_torch.scripts.dryrun_multichip [--ranks N]
        [--device cpu|cuda] [--backend gloo|nccl] [--timeout S]

Counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``, run as N
ranks of one ``torch.distributed`` job (``parallel.multihost.launch``;
default: one rank per card, NCCL; ``--device cpu`` means gloo):

1. one step of the (grid, data, tp)-sharded training step at
   ``factor_mesh(N)`` on toy inputs: finite loss, parameters moved, and
   loss, parameters and Adam moments equal to the unsharded step
   (``mesh.train_step``) within the bounds below;
2. a bucket of N configurations (n = m = 64, 30 epochs) sharded over the
   grid mesh, bit-equal to the same bucket with ``mesh=None`` on
   ``accuracy``, ``gt_accuracy``, ``train_losses``,
   ``reconstruction_errors`` and ``pearson_corr``, and learning (accuracy
   above 0.6, within 0.2 of the ground truth's);
3. the same equality for soft labels at K = 4, the proximity PRP sampler
   and the user_similarity cascade.

On the card the metric block's keys may round by the run count of a call
(``ROUNDED_KEYS``), and are held to the bound below.

Prints rank 0's lines; exits non-zero on any failure.  The helpers
(``toy_batch``, ``sharded_steps``, ``plain_steps``, ``compare_steps``) are
what ``chip_smoke.py`` [11a] and the tests drive the sharded step with.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# Sharded against unsharded step: the sums over the tp and data shards,
# and the gradient's scatter, add in other orders.
LOSS_RTOL = 1e-5
STATE_RTOL = 1e-4
STATE_ATOL = 1e-6
BUCKET_KEYS = ("accuracy", "gt_accuracy", "train_losses",
               "reconstruction_errors", "pearson_corr")
# Sharded against unsharded sweep: on the CPU every key is bit-equal.  On
# the card the metric block's whole-matrix float reductions, batched matrix
# products and QRs (``eval/metrics.py``: the reconstruction error and the
# alignment block) pick their kernels and splits by the number of runs in
# the call, so these keys may round differently; every other key stays
# bit-equal.  Most are ratios of sums of 10^6 terms, a few ulp apart.
# svd_error_scaled is sqrt((head + tail) / |X|^2) with tail = |X|^2 - the
# top singular values' squares, a difference of two near-equal sums: its
# rounding is absolute in its square, which is compared instead.
ROUNDED_KEYS = ("reconstruction_errors", "alpha", "norm_X", "norm_ratio",
                "reconstruction_error_scaled", "pearson_corr", "pearson_std",
                "spearman_corr", "spearman_std", "svd_error_scaled",
                "slopes", "pearson_corr_matrix", "spearman_corr_matrix",
                "reconstruction_error_scaled_per_row", "alpha_per_row")
ROUNDED_SQUARED = ("svd_error_scaled",)
ROUNDED_RTOL = 1e-5
ROUNDED_ATOL = 1e-5


def toy_batch(g: int, n: int, m: int, d: int, batch: int, seed: int = 0
              ) -> Dict[str, np.ndarray]:
    """``g`` configs' N(0, 1) tables U ``[g, n, d]``, V ``[g, m, d]`` and a
    batch each (u, i, j int32 ``[g, batch]`` with j != i, z Bernoulli(0.5)
    float32, mask all true), from numpy's generator at ``seed``."""
    rs = np.random.default_rng(seed)
    state = dict(U=rs.standard_normal((g, n, d), dtype=np.float32),
                 V=rs.standard_normal((g, m, d), dtype=np.float32))
    return dict(state, **batch_of(rs, g, n, m, batch))


def batch_of(rs: np.random.Generator, g: int, n: int, m: int, batch: int
             ) -> Dict[str, np.ndarray]:
    """One random batch per config (``toy_batch``'s)."""
    u = rs.integers(0, n, (g, batch), dtype=np.int32)
    i = rs.integers(0, m, (g, batch), dtype=np.int32)
    j = rs.integers(0, m, (g, batch), dtype=np.int32)
    j = np.where(j == i, (j + 1) % m, j).astype(np.int32)
    z = (rs.random((g, batch)) < 0.5).astype(np.float32)
    return dict(u=u, i=i, j=j, z=z, mask=np.ones((g, batch), bool))


def _batch(b: Dict[str, np.ndarray], device) -> tuple:
    return tuple(torch.as_tensor(b[k], device=device)
                 for k in ("u", "i", "j", "z", "mask"))


def _start(state, opt, lr, wd, device):
    """Params, Adam state (``opt``: numpy ``mu`` and ``nu`` (U, V) pairs
    and ``step``; ``None``: fresh) and the per-config lr and wd ``[G]`` on
    ``device``."""
    from mfcd_tpu_torch.convert import adam_state_from_jax, params_from_jax
    from mfcd_tpu_torch.parallel.mesh import replicate_opt_state_for_grid

    params = params_from_jax(state["U"], state["V"], device)
    opt = (replicate_opt_state_for_grid(params) if opt is None else
           adam_state_from_jax(opt["mu"], opt["nu"], opt["step"], device))
    g = params.U.shape[0]
    per_config = lambda v: torch.as_tensor(
        np.broadcast_to(np.float32(v), (g,)).copy(), device=device)
    return params, opt, per_config(lr), per_config(wd)


def _result(params, opt, losses, wall, peak) -> Dict[str, np.ndarray]:
    out = dict(U=params.U, V=params.V, mu_U=opt.mu[0], mu_V=opt.mu[1],
               nu_U=opt.nu[0], nu_V=opt.nu[1], step=opt.step,
               loss=torch.stack(losses))
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out.update(wall=wall, peak=peak)
    return out


def _clock(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _steps(step, params, opt, batches, lr, wd, device):
    """``step`` over ``batches``, after one untimed step on the first
    (its result dropped): (params, opt, losses, wall s, peak device bytes
    above those held when the steps began)."""
    step(params, opt, *batches[0], lr, wd)
    base = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    losses = []
    t0 = _clock(device)
    for args in batches:
        params, opt, loss = step(params, opt, *args, lr, wd)
        losses.append(loss)
    wall = _clock(device) - t0
    peak = (torch.cuda.max_memory_allocated(device) - base
            if device.type == "cuda" else 0)
    return params, opt, losses, wall, peak


def sharded_steps(shape: Sequence[int], state: Dict[str, np.ndarray],
                  batches: List[Dict[str, np.ndarray]], lr, wd,
                  device=None, opt=None) -> Dict[str, np.ndarray]:
    """Run the sharded step at mesh ``shape`` over ``batches`` (global
    arrays, one dict a step) from ``state``'s U and V and ``opt``'s
    moments (``None``: fresh), with ``lr``, ``wd`` (a float or one per
    config); every rank of the job calls it.  Returns the global U, V,
    moments, step and losses ``[steps, G]`` as numpy, the wall of the
    steps and this rank's peak device bytes above those it held when the
    steps began."""
    from mfcd_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh(shape=shape, device=device)
    params, opt, lr, wd = _start(state, opt, lr, wd, mesh.device)
    params, opt = pm.shard_state(mesh, params, opt)
    lr, wd = (pm.shard(mesh, v, pm.GRID_SPEC) for v in (lr, wd))
    local = [tuple(pm.shard(mesh, t, pm.BATCH_SPEC)
                   for t in _batch(b, mesh.device)) for b in batches]
    params, opt, losses, wall, peak = _steps(
        pm.make_sharded_train_step(mesh), params, opt, local, lr, wd,
        mesh.device)
    params, opt = pm.unshard_state(mesh, params, opt)
    losses = [pm.unshard(mesh, x, pm.GRID_SPEC) for x in losses]
    return _result(params, opt, losses, wall, peak)


def plain_steps(state: Dict[str, np.ndarray],
                batches: List[Dict[str, np.ndarray]], lr, wd,
                device=None, opt=None) -> Dict[str, np.ndarray]:
    """``sharded_steps`` through the unsharded step, in one process."""
    from mfcd_tpu_torch.backend import resolve_device
    from mfcd_tpu_torch.parallel.mesh import train_step

    dev = resolve_device(device)
    params, opt, lr, wd = _start(state, opt, lr, wd, dev)
    return _result(*_steps(train_step, params, opt,
                           [_batch(b, dev) for b in batches], lr, wd, dev))


def compare_steps(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                  label: str) -> Dict[str, float]:
    """Raise unless the losses agree within ``LOSS_RTOL`` and U, V and the
    moments within ``STATE_RTOL`` / ``STATE_ATOL``; returns each key's
    largest |diff|."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL,
                               err_msg=f"{label}: loss")
    np.testing.assert_array_equal(got["step"], want["step"],
                                  err_msg=f"{label}: step")
    errs = {"loss": float(np.max(np.abs(got["loss"] - want["loss"])))}
    for k in ("U", "V", "mu_U", "mu_V", "nu_U", "nu_V"):
        np.testing.assert_allclose(got[k], want[k], rtol=STATE_RTOL,
                                   atol=STATE_ATOL, err_msg=f"{label}: {k}")
        errs[k] = float(np.max(np.abs(got[k] - want[k])))
    return errs


def _values(v) -> list:
    """A result value as arrays: a list of per-rep arrays (whose lengths
    may vary) stays a list."""
    if isinstance(v, list) and v and isinstance(v[0], (list, np.ndarray)):
        return [np.asarray(x) for x in v]
    return [np.asarray(v)]


def compare_results(got: List[dict], want: List[dict], label: str,
                    keys: Optional[Sequence[str]] = None,
                    card: bool = False) -> Dict[str, float]:
    """Raise unless ``keys`` (default: all) of every configuration's
    results are bit-equal; on the ``card``, ``ROUNDED_KEYS`` within
    ``ROUNDED_RTOL`` / ``ROUNDED_ATOL`` (``ROUNDED_SQUARED`` squared).
    Returns each rounded key's largest |diff| (0 where bit-equal)."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} results, {len(want)} "
                             "expected")
    gaps = {}
    for c, (a, b) in enumerate(zip(got, want)):
        if a.keys() != b.keys():
            raise AssertionError(f"{label}: result keys (config {c})")
        for k in (a if keys is None else keys):
            xs, ys = _values(a[k]), _values(b[k])
            if [x.shape for x in xs] != [y.shape for y in ys]:
                raise AssertionError(f"{label}: {k} shapes (config {c})")
            for x, y in zip(xs, ys):
                msg = f"{label}: sharded != unsharded for {k} (config {c})"
                if card and k in ROUNDED_KEYS:
                    x, y = x.astype(np.float64), y.astype(np.float64)
                    gap = float(np.max(np.abs(x - y), initial=0.0))
                    gaps[k] = max(gaps.get(k, 0.0), gap)
                    if k in ROUNDED_SQUARED:
                        x, y = x * x, y * y
                    np.testing.assert_allclose(x, y, rtol=ROUNDED_RTOL,
                                               atol=ROUNDED_ATOL,
                                               err_msg=msg)
                else:
                    np.testing.assert_array_equal(x, y, err_msg=msg)
    return gaps


def dryrun(device: str) -> List[str]:
    """Every rank's part of the dry run; returns the lines to print."""
    import torch.distributed as dist

    from mfcd_tpu_torch.core.config import RunConfig
    from mfcd_tpu_torch.parallel.mesh import factor_mesh
    from mfcd_tpu_torch.sampling.prp import proximity_prp_supported
    from mfcd_tpu_torch.sweep.batched import make_sweep_mesh, run_bucket

    n_ranks = dist.get_world_size()
    lead = dist.get_rank() == 0
    lines = []
    g, dp, tp = factor_mesh(n_ranks)
    lines.append(f"mesh axes: grid={g}, data={dp}, tp={tp} "
                 f"({dist.get_backend()}, {device})")

    inp = toy_batch(g, 16, 24, 2 * tp, 8 * dp, seed=0)
    got = sharded_steps((g, dp, tp), inp, [inp], 1e-2, 1e-4, device=device)
    if not np.all(np.isfinite(got["loss"])):
        raise AssertionError(f"non-finite loss {got['loss']}")
    if not np.abs(got["U"] - inp["U"]).max() > 0:
        raise AssertionError("the sharded step did not move U")
    errs = compare_steps(got, plain_steps(inp, [inp], 1e-2, 1e-4, device),
                         "sharded step")
    lines.append("sharded train step ok; per-config losses: "
                 f"{got['loss'][0].tolist()}; largest |diff| to the "
                 "unsharded step: " + ", ".join(f"{k} {v:.3g}"
                                                for k, v in errs.items()))

    sweep_mesh = make_sweep_mesh(device=device)
    cases = [
        ("random", RunConfig(n=64, m=64, d=2, p=0.8, s=5.0, num_epochs=30,
                             reps=1, batch_size=64), 2e-2),
        ("soft-label K=4",
         RunConfig(n=64, m=64, d=2, p=0.8, s=5.0, num_epochs=8, reps=2, K=4,
                   soft_label=True, batch_size=64), 1e-2),
        ("proximity PRP",
         RunConfig(n=48, m=220, d=2, p=0.3, s=5.0, num_epochs=8, reps=1,
                   strategy="proximity", batch_size=64), 1e-2),
        ("user_similarity cascade",
         RunConfig(n=48, m=64, d=2, p=0.4, s=5.0, num_epochs=6, reps=1,
                   strategy="user_similarity", batch_size=64), 1e-2),
    ]
    prox = cases[2][1]
    if not proximity_prp_supported(prox.n, prox.m, prox.num_triplets):
        raise AssertionError("the proximity case must take the PRP path")
    for name, cfg, lr in cases:
        rows = [{"s": 4.0 + 0.5 * k, "lr": lr, "weight_decay": 1e-5}
                for k in range(n_ranks)]
        outs = run_bucket(cfg, rows, list(range(n_ranks)), mesh=sweep_mesh)
        accs = [round(float(o["accuracy"][0]), 3) for o in outs]
        gaps = {}
        if lead:
            ref = run_bucket(cfg, rows, list(range(n_ranks)), device=device)
            gaps = compare_results(outs, ref, name, BUCKET_KEYS,
                                   card=device == "cuda")
        if name == "random":
            gts = np.asarray([o["gt_accuracy"][0] for o in outs])
            if not np.all(np.asarray(accs) > 0.6):
                raise AssertionError(f"the probe did not learn: {accs}")
            if not np.all(gts - np.asarray(accs) < 0.2):
                raise AssertionError(f"accuracy {accs} does not track the "
                                     f"ground truth's {gts.tolist()}")
        rounded = {k: v for k, v in gaps.items() if v}
        lines.append(f"[{name}] sharded == unsharded ("
                     + ("bit-exact" if not rounded else "bit-exact but "
                        + ", ".join(f"{k} within {v:.3g}"
                                    for k, v in rounded.items()))
                     + f") for {n_ranks} configs; accuracies: {accs}")
    return lines


def main(argv=None) -> int:
    from mfcd_tpu_torch.parallel import multihost

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks (default: the card count)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="default: nccl on the card, gloo on the CPU")
    ap.add_argument("--timeout", type=float,
                    default=multihost.JOIN_TIMEOUT_S,
                    help="seconds before the ranks are stopped")
    args = ap.parse_args(argv)
    ranks = args.ranks or (torch.cuda.device_count()
                           if args.device == "cuda" else 2)
    outs = multihost.launch(dryrun, ranks, args=(args.device,),
                            device=args.device, backend=args.backend,
                            timeout_s=args.timeout)
    for line in outs[0]:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
