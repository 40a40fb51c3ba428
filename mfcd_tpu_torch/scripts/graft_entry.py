"""The forward probe: one forward call on the flagship model's shape.

    python3 -m mfcd_tpu_torch.scripts.graft_entry [--device cuda|cpu]

Counterpart of ``__graft_entry__.py``'s ``entry()`` (that file's
``dryrun_multichip`` is ``scripts/dryrun_multichip.py``): the canonical
1000 x 1000, d = 2 matrix-factorization model and 4,096 random (u, i, j)
triplets, scored by ``models.mf.forward_prob`` (the gather, dot and
sigmoid of reference ``structure.py:787-795``).  The keys are JAX's
(``key(0)`` for the parameters, ``key(1)`` split in three for u, i, j),
drawn by the port's bit-equal threefry, so the indices are JAX's and the
parameters agree with JAX's to the port's normal sampler's rounding.

Run as a script, it prints the output's shape and mean.
"""

from __future__ import annotations

import argparse
import sys

N = M = 1000
D = 2
BATCH = 4096


def entry(device=None):
    """``(fn, (params, u, i, j))`` on ``device`` (``None``: the card):
    ``fn(params, u, i, j)`` gives the ``[BATCH]`` preference
    probabilities."""
    from mfcd_tpu_torch.backend import resolve_device
    from mfcd_tpu_torch.core import prng
    from mfcd_tpu_torch.models.mf import forward_prob, init_params

    dev = resolve_device(device)
    params = init_params(prng.key(0, device=dev), N, M, D)
    ku, ki, kj = prng.split(prng.key(1, device=dev), 3).unbind(-2)
    u = prng.randint(ku, (BATCH,), 0, N)
    i = prng.randint(ki, (BATCH,), 0, M)
    j = prng.randint(kj, (BATCH,), 0, M)

    def fn(params, u, i, j):
        return forward_prob(params, u, i, j)

    return fn, (params, u, i, j)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    fn, fn_args = entry(args.device)
    out = fn(*fn_args)
    print(f"entry forward ok: {tuple(out.shape)} {float(out.mean())}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
