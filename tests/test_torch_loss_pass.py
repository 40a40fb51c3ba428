"""The validation pass's masked batch-mean BCE (``ops/loss_pass.py``) and
the test pass that also counts correct rows, on the CPU and on a card.

On CPU tensors ``batch_losses`` and ``losses_and_hits`` run their plain
versions, the block loop the trainers and ``evaluate_split`` ran before
the kernel L1 existed: its values are pinned bit for bit (hex floats) on
small fixed inputs.  L1's argument packing runs through ``_FakeL1``, which
stands in for the built library: it reads every tensor through the
pointers and strides the wrapper passes, as the kernel does, computes the
pass with the plain version and writes the outputs.  The loss-only kernel
is held to the plain version on the card in ``tests/test_torch_cuda.py``;
the counting variant here, under the ``cuda`` marker (these skip without
a card, and import no jax, so ``python -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_loss_pass.py`` runs them there):
its accuracy bit-equal to the plain block path's on the card at d = 2, its
loss bit-equal to the loss-only variant's, two launches a pass.
"""

import ctypes
import hashlib

import numpy as np
import pytest
import torch
from numpy.lib.stride_tricks import as_strided

from mfcd_tpu_torch.data.btl import LabeledSplit
from mfcd_tpu_torch.eval.metrics import accuracy, evaluate_split
from mfcd_tpu_torch.models.mf import MFParams
from mfcd_tpu_torch.ops import loss_pass
from mfcd_tpu_torch.scripts.ab_test_pass import eager_accuracy
from mfcd_tpu_torch.train import trainer
from mfcd_tpu_torch.train.kernel_trainer import train_runs_kernel
from mfcd_tpu_torch.utils import observability as obs

torch.set_num_threads(1)


def _split(g, r, rows, n, m, counts, soft=None):
    u = g.integers(0, n, (r, rows)).astype(np.int32)
    i = g.integers(0, m, (r, rows)).astype(np.int32)
    j = ((i + g.integers(1, m, (r, rows))) % m).astype(np.int32)
    if soft:  # soft labels: fractions k / soft
        z = (g.integers(0, soft + 1, (r, rows)) / soft).astype(np.float32)
    else:
        z = (g.random((r, rows)) < 0.5).astype(np.float32)
    counts = np.asarray(counts)
    valid = np.arange(rows)[None, :] < counts[:, None]
    t = torch.from_numpy
    return LabeledSplit(t(u), t(i), t(j), t(z), t(valid),
                        t(counts.astype(np.int32)))


def _params(g, r, n, m, d):
    return MFParams(
        torch.from_numpy((g.standard_normal((r, n, d))
                          / np.sqrt(d)).astype(np.float32)),
        torch.from_numpy((g.standard_normal((r, m, d))
                          / np.sqrt(d)).astype(np.float32)))


def _soft_case():
    """3 runs, 50 rows in batches of 8: a full run, one whose batches past
    the second hold only padding, one with count 0; soft labels k / 10."""
    g = np.random.default_rng(19)
    return _params(g, 3, 7, 9, 2), _split(g, 3, 50, 7, 9, [50, 13, 0],
                                          soft=10)


def _train_case():
    g = np.random.default_rng(20)
    p = _params(g, 2, 6, 7, 2)
    train = _split(g, 2, 40, 6, 7, [40, 33])
    val = _split(g, 2, 30, 6, 7, [30, 21])
    keys = torch.tensor([[1, 2], [3, 4]], dtype=torch.int64)
    return p, train, val, keys, torch.tensor([1e-2, 3e-2]), torch.tensor(
        [1e-3, 5e-6])


def _blocks_case():
    """Batch size 1 over 130 rows: three of the plain version's blocks."""
    g = np.random.default_rng(21)
    return _params(g, 2, 5, 6, 3), _split(g, 2, 130, 5, 6, [130, 97])


def _hex(t):
    return [float(x).hex() for x in t.flatten()]


# The values before L1 existed (the block loop in train/trainer.py).
_SOFT_MEANS = (["0x1.65b2900000000p-1", "0x1.90683c0000000p-1",
                "0x1.b4d0560000000p-1", "0x1.6958640000000p-1",
                "0x1.78578e0000000p-1", "0x1.5a94760000000p-1",
                "0x1.673d940000000p-1", "0x1.ac18620000000p-1",
                "0x1.336d140000000p+0"] + ["0x0.0p+0"] * 12)
_SOFT_EPOCH = ["0x1.78eb040000000p-1", "0x1.04bca20000000p+0", "0x0.0p+0"]
_SOFT_ACC = ["0x1.eb851e0000000p-5", "0x1.3b13b20000000p-4", "0x0.0p+0"]
_TRAIN_VAL = ["0x1.3a7c680000000p-1", "0x1.3b6d9c0000000p-1",
              "0x1.a9d4280000000p-1", "0x1.b414b20000000p-1"]
_BLOCKS_SHA = "e66e47ab7a48c150a663f5e49188b5f1b76a18f76b3543a5dc48c7368c88991c"
_BLOCKS_EPOCH = ["0x1.86ee3e0000000p-1", "0x1.a0feb60000000p-1"]


@pytest.mark.parametrize("entry", ["batch_losses", "evaluate_split",
                                   "train_runs_kernel", "train_model",
                                   "blocks"])
def test_cpu_values_bit_identical_to_before(entry):
    before = loss_pass.LOSS_LAUNCHES
    if entry == "batch_losses":
        means, epoch = trainer.batch_losses(*_soft_case(), 8)
        assert _hex(means) == _SOFT_MEANS and _hex(epoch) == _SOFT_EPOCH
    elif entry == "evaluate_split":
        loss, acc = evaluate_split(*_soft_case(), 8)
        assert _hex(loss) == _SOFT_EPOCH and _hex(acc) == _SOFT_ACC
    elif entry == "blocks":
        means, epoch = trainer.batch_losses(*_blocks_case(), 1)
        assert tuple(means.shape) == (2, 130)
        assert hashlib.sha256(means.numpy().tobytes()).hexdigest() \
            == _BLOCKS_SHA
        assert _hex(epoch) == _BLOCKS_EPOCH
    else:
        p, train, val, keys, lr, wd = _train_case()
        fn = train_runs_kernel if entry == "train_runs_kernel" else \
            trainer.train_model
        _, _, val_losses = fn(p, train, val, keys, lr, wd, batch_size=8,
                              num_epochs=2)
        assert _hex(val_losses) == _TRAIN_VAL
    assert loss_pass.LOSS_LAUNCHES == before


def test_cpu_tensors_take_the_plain_version():
    p, sp = _soft_case()
    assert trainer.batch_losses is loss_pass.batch_losses
    before = loss_pass.LOSS_LAUNCHES
    got = loss_pass.batch_losses(p, sp, 8)
    want = loss_pass.batch_losses_reference(p, sp, 8)
    assert loss_pass.LOSS_LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _read(ptr, dtype, shape, strides):
    """The ``shape`` elements at ``ptr`` by element ``strides``, as the
    kernel reads them."""
    ctype = {np.float32: ctypes.c_float, np.int32: ctypes.c_int32,
             np.bool_: ctypes.c_bool}[dtype]
    extent = 1 + sum((n - 1) * s for n, s in zip(shape, strides) if n)
    buf = np.ctypeslib.as_array((ctype * extent).from_address(ptr))
    size = np.dtype(dtype).itemsize
    return torch.from_numpy(np.array(as_strided(
        buf, shape, [s * size for s in strides])))


class _FakeL1:
    """Stands in for the built ``loss_pass.cu`` on CPU tensors."""

    def __init__(self, monkeypatch, n, m):
        self.calls = 0
        self.n, self.m = n, m   # the tables' rows, which L1 is not told
        monkeypatch.setattr(loss_pass, "_on", lambda dev: True)
        monkeypatch.setattr(loss_pass, "_library", lambda: self)
        monkeypatch.setattr(loss_pass._build, "stream_ptr", lambda dev: 0)

    def mfcd_loss_pass(self, U, u_run, u_row, u_col, V, v_run, v_row, v_col,
                       *rest):
        self.calls += 1
        fields, rest = rest[:15], rest[15:]
        runs, rows, bs, d, means, epoch, hits, correct, stream = rest
        assert stream == 0 and bs >= 1 and d >= 1
        assert (hits is None) == (correct is None)
        params = MFParams(
            _read(U, np.float32, (runs, self.n, d), (u_run, u_row, u_col)),
            _read(V, np.float32, (runs, self.m, d), (v_run, v_row, v_col)))
        kinds = (np.int32, np.int32, np.int32, np.float32, np.bool_)
        split = LabeledSplit(*[
            _read(fields[3 * k], kinds[k], (runs, rows),
                  fields[3 * k + 1:3 * k + 3]) for k in range(5)], None)
        if correct is None:
            want = loss_pass.batch_losses_reference(params, split, bs)
            ptrs = (means, epoch)
        else:
            want = loss_pass.losses_and_hits_reference(params, split, bs)
            ptrs = (means, epoch, correct)
        for ptr, t in zip(ptrs, want):
            if t.numel():
                ctype = (ctypes.c_float if t.dtype == torch.float32
                         else ctypes.c_int32)
                dst = np.ctypeslib.as_array(
                    (ctype * t.numel()).from_address(ptr))
                dst[:] = t.reshape(-1).numpy()
        return 0


def _layout(case):
    """(params, split, batch size, tables' rows n and m) of a packing
    case, and the plain version's inputs for it."""
    p, sp = _soft_case()
    if case == "transposed tables":
        # the trainer's [R, d, n] storage, passed as [R, n, d] views
        view = MFParams(p.U.transpose(1, 2).contiguous().transpose(1, 2),
                        p.V.transpose(1, 2).contiguous().transpose(1, 2))
        assert not view.U.is_contiguous()
        return view, sp, 8, 7, 9
    if case == "strided fields":
        wide = LabeledSplit(*[torch.stack([a, a], -1).reshape(3, 100)[:, ::2]
                              for a in sp[:5]], sp.count)
        assert not wide.u.is_contiguous()
        return p, wide, 8, 7, 9
    if case == "batch size 1024":
        return p, sp, 1024, 7, 9
    if case == "no rows":
        return p, LabeledSplit(*[a[:, :0] for a in sp[:5]], sp.count), 8, 7, 9
    return p, sp, 8, 7, 9


@pytest.mark.parametrize("case", ["contiguous", "transposed tables",
                                  "strided fields", "batch size 1024",
                                  "no rows"])
def test_kernel_packing_matches_the_plain_version(case, monkeypatch):
    p, sp, bs, n, m = _layout(case)
    want = loss_pass.batch_losses_reference(p, sp, bs)
    fake = _FakeL1(monkeypatch, n, m)
    before = loss_pass.LOSS_LAUNCHES
    got = loss_pass.batch_losses(p, sp, bs)
    assert fake.calls == 1
    assert loss_pass.LOSS_LAUNCHES == before + (1 if case == "no rows" else 2)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["contiguous", "transposed tables",
                                  "strided fields", "batch size 1024",
                                  "no rows"])
def test_counting_packing_matches_the_plain_version(case, monkeypatch):
    """The test pass's three outputs through the same packing: the loss
    the loss-only pass gives, the count the plain block loop gives."""
    p, sp, bs, n, m = _layout(case)
    want = loss_pass.losses_and_hits_reference(p, sp, bs)
    # the soft case's 3 of 50 and 1 of 13 (``_SOFT_ACC``)
    assert want[2].tolist() == ([0, 0, 0] if case == "no rows" else [3, 1, 0])
    fake = _FakeL1(monkeypatch, n, m)
    before = loss_pass.LOSS_LAUNCHES
    got = loss_pass.losses_and_hits(p, sp, bs)
    assert fake.calls == 1
    assert loss_pass.LOSS_LAUNCHES == before + (1 if case == "no rows" else 2)
    assert len(got) == 3
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    for a, b in zip(got, loss_pass.batch_losses_reference(p, sp, bs)):
        assert torch.equal(a, b)


def test_trainer_val_pass_goes_through_the_kernel(monkeypatch):
    """The K1 trainer hands L1 its epoch tables as views: two launches an
    epoch, the values those of the plain version."""
    p, train, val, keys, lr, wd = _train_case()
    fake = _FakeL1(monkeypatch, 6, 7)
    before = loss_pass.LOSS_LAUNCHES
    _, _, val_losses = train_runs_kernel(p, train, val, keys, lr, wd,
                                         batch_size=8, num_epochs=2)
    assert fake.calls == 2 and loss_pass.LOSS_LAUNCHES == before + 4
    assert _hex(val_losses) == _TRAIN_VAL


def _bad(case):
    p, sp = _soft_case()
    if case == "int64 indices":
        return p, sp._replace(u=sp.u.to(torch.int64))
    if case == "float64 labels":
        return p, sp._replace(z=sp.z.to(torch.float64))
    if case == "uint8 mask":
        return p, sp._replace(valid=sp.valid.to(torch.uint8))
    if case == "float64 tables":
        return MFParams(p.U.double(), p.V), sp
    if case == "rows differ":
        return p, sp._replace(z=sp.z[:, :49])
    if case == "runs differ":
        return MFParams(p.U[:2], p.V[:2]), sp
    if case == "widths differ":
        return MFParams(p.U, torch.cat([p.V, p.V], -1)), sp
    if case == "two lead dims":
        return (MFParams(p.U[None], p.V[None]),
                LabeledSplit(*[a[None] for a in sp]))
    if case == "no run axis":
        return MFParams(p.U[0], p.V[0]), LabeledSplit(*[a[0] for a in sp])
    if case == "d = 0":
        return MFParams(p.U[..., :0], p.V[..., :0]), sp
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["int64 indices", "float64 labels",
                                  "uint8 mask", "float64 tables",
                                  "rows differ", "runs differ",
                                  "widths differ", "two lead dims",
                                  "no run axis", "d = 0", "batch size 0"])
def test_kernel_path_rejects_what_it_does_not_take(case, monkeypatch):
    fake = _FakeL1(monkeypatch, 7, 9)
    before = loss_pass.LOSS_LAUNCHES
    if case == "batch size 0":
        args = (*_soft_case(), 0)
    else:
        args = (*_bad(case), 8)
    with pytest.raises(ValueError, match="batch_losses"):
        loss_pass.batch_losses(*args)
    assert fake.calls == 0 and loss_pass.LOSS_LAUNCHES == before


def test_other_devices_raise():
    p, sp = _soft_case()
    meta = MFParams(p.U.to("meta"), p.V.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        loss_pass.batch_losses(meta, sp, 8)


@pytest.mark.parametrize("case", ["soft", "blocks"])
def test_cpu_evaluate_split_takes_the_plain_block_path(case):
    p, sp = _soft_case() if case == "soft" else _blocks_case()
    bs = 8 if case == "soft" else 1
    before = loss_pass.LOSS_LAUNCHES
    loss, acc = evaluate_split(p, sp, bs)
    assert loss_pass.LOSS_LAUNCHES == before
    assert torch.equal(loss, loss_pass.batch_losses_reference(p, sp, bs)[1])
    assert acc.dtype == torch.float32
    assert _hex(acc) == _hex(eager_accuracy(p, sp, bs))


@pytest.mark.parametrize("total", [0, 1, 7, 500_000])
def test_accuracy_is_the_plain_formula(total):
    """The count-to-accuracy arithmetic gives the bits of the plain
    formula (a float32 count over an int64 total) at every count."""
    if total < 1000:
        correct = np.arange(total + 1)
    else:
        g = np.random.default_rng(total)
        correct = np.concatenate([[0, 1, 2, 3, total // 3, total // 2,
                                   total - 1, total],
                                  g.integers(0, total + 1, 2000)])
    counts = torch.from_numpy(correct.astype(np.int32))
    totals = torch.full(counts.shape, total, dtype=torch.int64)
    got = accuracy(counts, totals)
    hits = counts.to(torch.float32)
    want = torch.where(totals > 0, hits / torch.clamp(totals, min=1),
                       torch.zeros_like(hits))
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if total:
        np.testing.assert_array_equal(
            got.numpy(), correct.astype(np.float32) / np.float32(total))
    else:
        assert _hex(got) == ["0x0.0p+0"]


@pytest.mark.parametrize("path", ["card", "cpu"])
def test_l1_rows_counted_only_on_the_card_path(path, monkeypatch):
    p, sp = _soft_case()
    if path == "card":
        fake = _FakeL1(monkeypatch, 7, 9)
    obs.reset()
    with obs.call("evaluate_split", "cpu"):
        loss, acc = evaluate_split(p, sp, 8)
        if path == "card":   # the pass that found nothing to score
            loss_pass.losses_and_hits(
                p, LabeledSplit(*[a[:, :0] for a in sp[:5]], sp.count), 8)
    counters = obs.calls()[-1]["counters"]
    if path == "card":
        assert fake.calls == 2
        assert counters == {loss_pass.L1_ROWS: 3 * 50}
    else:
        assert loss_pass.L1_ROWS not in counters
    assert _hex(loss) == _SOFT_EPOCH and _hex(acc) == _SOFT_ACC


# -- on a card ----------------------------------------------------------

def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# The test pass at the cells' test splits, R = 5, batch 64: (rows a run,
# valid counts, soft K).  "mixed" gives a run no valid row, others batches
# past their count that hold only padding; every case also empties one
# batch in the middle.  K = 10 and 50 take many of the plain version's
# blocks of 64 batches and many of L1's chunks.
CARD_CASES = {
    "k1-hard": (10_240, [10_000] * 5, None),
    "k1-mixed": (10_240, "mixed", None),
    "k10-hard": (102_400, [100_000] * 5, None),
    "k10-soft": (102_400, "mixed", 10),
    "k50-hard": (500_032, [500_000] * 5, None),
    "k50-soft": (500_032, [500_000, 499_990, 0, 123_457, 500_032], 50),
}


def _card_case(dev, rows, counts, soft, seed=43, n=1000, m=1000, d=2):
    g = np.random.default_rng(seed)
    if counts == "mixed":
        counts = [rows, 0, rows // 3, 1, rows - 7]
    sp = _split(g, 5, rows, n, m, counts, soft=soft)
    valid = sp.valid.clone()
    valid[:, 64 * 7:64 * 8] = False    # an empty batch among full ones
    sp = sp._replace(valid=valid)
    p = _params(g, 5, n, m, d)
    return (MFParams(*[t.to(dev) for t in p]),
            LabeledSplit(*[t.to(dev) for t in sp]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_card_test_pass_matches_the_plain_block_path(case):
    dev = _card()
    p, sp = _card_case(dev, *CARD_CASES[case])
    want = loss_pass.losses_and_hits_reference(p, sp, 64)
    loss_only = loss_pass.batch_losses(p, sp, 64)
    before = loss_pass.LOSS_LAUNCHES
    got = loss_pass.losses_and_hits(p, sp, 64)
    torch.cuda.synchronize()
    assert loss_pass.LOSS_LAUNCHES == before + 2
    assert got[2].dtype == torch.int32 and torch.equal(got[2], want[2])
    # the loss is the loss-only pass's, bit for bit
    for a, b in zip(got[:2], loss_only):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    loss, acc = evaluate_split(p, sp, 64)
    assert torch.equal(loss.view(torch.int32), loss_only[1].view(torch.int32))
    plain = eager_accuracy(p, sp, 64)
    assert torch.equal(acc.view(torch.int32), plain.view(torch.int32))
    again = loss_pass.losses_and_hits(p, sp, 64)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _edge_logits():
    """float32 logits at 0, a unit in the last place either side of it, and
    across the interval above 0 where the sigmoid rounds to 0.5."""
    tiny = np.float32(np.finfo(np.float32).smallest_subnormal)
    xs = [0.0, tiny, np.float32(np.finfo(np.float32).tiny), 1e-3, 1.0]
    xs += [k * 2.0 ** -28 for k in range(1, 129)]
    for e in (-25, -24, -23, -22):
        x = np.float32(2.0 ** e)
        xs += [x, np.nextafter(x, np.float32(0)), np.nextafter(x, np.float32(1))]
    xs = np.asarray(xs, np.float32)
    return np.concatenate([xs, -xs])


@pytest.mark.cuda
def test_card_test_pass_decides_as_the_plain_path_at_the_edge():
    """One row a run, logit x placed exactly (U[u] = (1, 0), V[i] = (x, 0),
    V[j] = 0), z = 1 and z = 0: each run's count is the plain decision."""
    dev = _card()
    xs = _edge_logits()
    r = 2 * len(xs)
    x = torch.from_numpy(np.concatenate([xs, xs]))
    U = torch.zeros((r, 1, 2))
    U[:, 0, 0] = 1
    V = torch.zeros((r, 2, 2))
    V[:, 0, 0] = x
    z = torch.cat([torch.ones(len(xs)), torch.zeros(len(xs))])[:, None]
    zeros = torch.zeros((r, 1), dtype=torch.int32)
    sp = LabeledSplit(zeros, zeros, zeros + 1, z,
                      torch.ones((r, 1), dtype=torch.bool),
                      torch.ones(r, dtype=torch.int32))
    p = MFParams(U.to(dev), V.to(dev))
    sp = LabeledSplit(*[t.to(dev) for t in sp])
    above = torch.sigmoid(x.to(dev)) > 0.5
    # the interval where the sigmoid rounds to 0.5 is in the data
    assert bool(((torch.sigmoid(x.to(dev)) == 0.5) & (x.to(dev) > 0)).any())
    assert bool((above & (x.to(dev) < 2.0 ** -22)).any())
    want = loss_pass.losses_and_hits_reference(p, sp, 1)[2]
    got = loss_pass.losses_and_hits(p, sp, 1)[2]
    assert torch.equal(want, (above == (z[:, 0].to(dev) == 1)).to(torch.int32))
    assert torch.equal(got, want), x[(got != want).cpu()].tolist()


@pytest.mark.cuda
def test_card_passes_launch_their_variants():
    """The test pass: two launches of the counting variant, and with the
    accuracy's arithmetic no block loop; the validation pass, the trainer's
    included: the loss-only variant."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    dev = _card()
    p, sp = _card_case(dev, *CARD_CASES["k50-hard"])
    evaluate_split(p, sp, 64)
    loss_pass.batch_losses(p, sp, 64)
    torch.cuda.synchronize()

    def kernels(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e.name for e in prof.events()
                if e.device_type == DeviceType.CUDA]

    test = kernels(lambda: loss_pass.losses_and_hits(p, sp, 64))
    assert len(test) == 2 and all("<true>" in k for k in test), test
    val = kernels(lambda: loss_pass.batch_losses(p, sp, 64))
    assert len(val) == 2 and all("<false>" in k for k in val), val
    # L1's two, then the accuracy's arithmetic: a few elementwise launches
    # over [R], where the block loop made ~37 for every 64 batches
    every = kernels(lambda: evaluate_split(p, sp, 64))
    assert [k for k in every if "loss_" in k] == test and len(every) <= 16, \
        every
    pt, train, val_split, keys, lr, wd = _train_case()
    pt = MFParams(*[t.to(dev) for t in pt])
    train, val_split = (LabeledSplit(*[t.to(dev) for t in s])
                        for s in (train, val_split))
    trained = kernels(lambda: train_runs_kernel(
        pt, train, val_split, keys.to(dev), lr.to(dev), wd.to(dev),
        batch_size=8, num_epochs=2))
    l1 = [k for k in trained if "loss_" in k]
    assert len(l1) == 4 and all("<false>" in k for k in l1), l1
