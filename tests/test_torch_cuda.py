"""The CUDA kernels vs their plain PyTorch versions, on a card: the fused
epoch (K1), its five stage variants (P1) and the factored-layout epoch (P2).

Imports neither jax nor ``mfcd_tpu``, so it runs on a machine with the card
and without jax::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Without a card every test skips (the kernel has no CPU mode).  Bounds: the
kernel rounds every multiply and add on its own, as the plain version
does, and sums gradient rows in batch order; the plain version's
``index_add_`` on the card adds with atomics, and the loss reductions run
in another order, so state, loss and the P1 variants' ``alive`` sums (the
check of each kept stage's work) agree to rtol 1e-5 / atol 1e-6.
"""

import numpy as np
import pytest
import torch

from mfcd_tpu_torch.convert import epoch_state_from_jax
from mfcd_tpu_torch.ops import kernel_split as KS
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


def _compare(state, args, pack, dev, kernel=K.train_epoch,
             plain=K.train_epoch_reference, launches=lambda: K.EPOCH_LAUNCHES,
             layout=lambda a: a):
    make = lambda: K.EpochState(*(layout(a) for a in
                                  epoch_state_from_jax(*state, device=dev)))
    want = plain(make(), *args, pack=pack)
    before = launches()
    got = kernel(make(), *args, pack=pack)
    torch.cuda.synchronize()
    assert launches() == before + 1
    assert len(got) == len(want)
    for x, y in zip(want[0] + tuple(want[1:]), got[0] + tuple(got[1:])):
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


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(KS.VARIANTS))
@pytest.mark.parametrize("shape", ["small", "canonical"])
def test_variant_kernel_matches_plain_version(name, shape):
    dev = _card()
    if shape == "small":
        state, args, pack = _inputs(6, N, M, D, BS, B, [70, 100],
                                    [1e-2, 3e-2], "full", dev)
    else:
        state, args, pack = _inputs(7, 1000, 1000, 2, 64, 64, [4096, 2500],
                                    [1e-3, 1e-2], "full", dev)
    stages = KS.VARIANTS[name]
    _compare(state, args, pack, dev,
             kernel=lambda *a, **k: KS.train_epoch_variant(*a, **k,
                                                           stages=stages),
             plain=lambda *a, **k: KS.train_epoch_variant_reference(
                 *a, **k, stages=stages),
             launches=lambda: KS.VARIANT_LAUNCHES[name])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "canonical"])
def test_factored_kernel_matches_plain_version(shape):
    dev = _card()
    if shape == "small":
        state, args, pack = _inputs(8, N, M, D, BS, B, [70, 100],
                                    [1e-2, 3e-2], "full", dev)
    else:
        state, args, pack = _inputs(9, 1000, 1000, 2, 64, 64, [4096, 2500],
                                    [1e-3, 1e-2], "full", dev)
    _compare(state, args, pack, dev, kernel=KS.train_epoch_factored,
             plain=KS.train_epoch_factored_reference,
             launches=lambda: KS.FACTORED_LAUNCHES,
             layout=KS.to_factored_layout)


@pytest.mark.cuda
def test_split_kernels_reject_what_they_do_not_take():
    dev = _card()
    state, args, pack = _inputs(10, N, M, D, BS, B, [70, 100], [1e-2, 3e-2],
                                "uij", dev)
    st = epoch_state_from_jax(*state, device=dev)
    with pytest.raises(ValueError, match="only 'full'"):
        KS.train_epoch_variant(st, *args, pack=pack, stages=())
    state, args, pack = _inputs(10, N, M, D, BS, B, [70, 100], [1e-2, 3e-2],
                                "full", dev)
    st = epoch_state_from_jax(*state, device=dev)
    with pytest.raises(TypeError):
        KS.train_epoch_variant(st, args[0], args[1].double(), *args[2:],
                               pack=pack, stages=())
    with pytest.raises(ValueError, match="shape"):
        KS.train_epoch_factored(st, *args, pack=pack)
