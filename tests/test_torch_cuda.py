"""The fused-epoch CUDA kernel vs its plain PyTorch version, on a card.

Imports neither jax nor ``mfcd_tpu``, so it runs on a machine with the card
and without jax::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Without a card every test skips (the kernel has no CPU mode).  Bounds: the
kernel rounds every multiply and add on its own, as the plain version
does, and sums gradient rows in batch order; the plain version's
``index_add_`` on the card adds with atomics, and the loss reductions run
in another order, so state and loss agree to rtol 1e-5 / atol 1e-6.
"""

import numpy as np
import pytest
import torch

from mfcd_tpu_torch.convert import epoch_state_from_jax
from mfcd_tpu_torch.ops import kernels as K
from mfcd_tpu_torch.train import kernel_trainer as KT

N, M, D, BS, B = 20, 25, 3, 32, 4


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed, n, m, d, bs, nb, counts, lrs, mode, dev):
    g = np.random.default_rng(seed)
    r = len(counts)
    state = [g.standard_normal((r, d, n)), g.standard_normal((r, d, m))]
    state += [np.abs(g.standard_normal(s.shape)) * 1e-2
              for s in (state[0], state[0], state[1], state[1])]
    shape = (r, nb, bs)
    u = g.integers(0, n, shape).astype(np.int32)
    i = g.integers(0, m, shape).astype(np.int32)
    j = ((i + g.integers(1, m, shape)) % m).astype(np.int32)
    z = (g.random(shape) < 0.5).astype(np.float32)
    _, bn, bm, bz = KT._pack_spec(n, m, 1)
    uij = u | (i << bn) | (j << (bn + bm))
    stream, pack = {
        "full": ((uij | (z.astype(np.int32) << (bn + 2 * bm)),),
                 ("full", bn, bm, bz, 1)),
        "uij": ((uij, z), ("uij", bn, bm, 0, 1)),
        "none": ((u, i, j, z), ("none", 0, 0, 0, 1)),
    }[mode]
    t = lambda a, dt=None: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                           device=dev)
    args = (tuple(t(a) for a in stream), t(lrs, torch.float32),
            t(np.full(r, 1e-3), torch.float32),
            t(np.arange(r) * 3.0, torch.float32), t(counts, torch.int32))
    return [a.astype(np.float32) for a in state], args, pack


def _compare(state, args, pack, dev):
    want = K.train_epoch_reference(epoch_state_from_jax(*state, device=dev),
                                   *args, pack=pack)
    before = K.EPOCH_LAUNCHES
    got = K.train_epoch(epoch_state_from_jax(*state, device=dev), *args,
                        pack=pack)
    torch.cuda.synchronize()
    assert K.EPOCH_LAUNCHES == before + 1
    for x, y in zip(want[0] + (want[1],), got[0] + (got[1],)):
        torch.testing.assert_close(y, x, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["full", "uij", "none"])
def test_kernel_matches_plain_version(mode):
    dev = _card()
    state, args, pack = _inputs(3, N, M, D, BS, B, [70, 100], [1e-2, 3e-2],
                                mode, dev)
    _compare(state, args, pack, dev)


@pytest.mark.cuda
def test_kernel_matches_plain_version_canonical_shape():
    dev = _card()
    state, args, pack = _inputs(4, 1000, 1000, 2, 64, 64, [4096, 2500],
                                [1e-3, 1e-2], "full", dev)
    _compare(state, args, pack, dev)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    dev = _card()
    state, args, pack = _inputs(5, N, M, D, BS, B, [70, 100], [1e-2, 3e-2],
                                "full", dev)
    st = epoch_state_from_jax(*state, device=dev)
    with pytest.raises(TypeError):
        K.train_epoch(st, args[0], args[1].double(), *args[2:], pack=pack)
    with pytest.raises(ValueError):
        K.train_epoch(st, args[0], args[1].cpu(), *args[2:], pack=pack)
    with pytest.raises(ValueError):
        K.train_epoch(st._replace(u_t=st.u_t.transpose(1, 2).contiguous()
                                  .transpose(1, 2)), *args, pack=pack)
