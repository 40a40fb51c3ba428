"""The validation pass's masked batch-mean BCE (``ops/loss_pass.py``) on
the CPU.

On CPU tensors ``batch_losses`` runs its plain version, the block loop the
trainers and ``evaluate_split`` ran before the kernel L1 existed: its
values are pinned bit for bit (hex floats) on small fixed inputs.  L1's
argument packing runs through ``_FakeL1``, which stands in for the built
library: it reads every tensor through the pointers and strides the
wrapper passes, as the kernel does, computes the pass with the plain
version and writes the two outputs.  The kernel itself is held to the
plain version on the card (``tests/test_torch_cuda.py``).
"""

import ctypes
import hashlib

import numpy as np
import pytest
import torch
from numpy.lib.stride_tricks import as_strided

from mfcd_tpu_torch.data.btl import LabeledSplit
from mfcd_tpu_torch.eval.metrics import evaluate_split
from mfcd_tpu_torch.models.mf import MFParams
from mfcd_tpu_torch.ops import loss_pass
from mfcd_tpu_torch.train import trainer
from mfcd_tpu_torch.train.kernel_trainer import train_runs_kernel

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
        runs, rows, bs, d, means, epoch, stream = rest
        assert stream == 0 and bs >= 1 and d >= 1
        params = MFParams(
            _read(U, np.float32, (runs, self.n, d), (u_run, u_row, u_col)),
            _read(V, np.float32, (runs, self.m, d), (v_run, v_row, v_col)))
        kinds = (np.int32, np.int32, np.int32, np.float32, np.bool_)
        split = LabeledSplit(*[
            _read(fields[3 * k], kinds[k], (runs, rows),
                  fields[3 * k + 1:3 * k + 3]) for k in range(5)], None)
        want = loss_pass.batch_losses_reference(params, split, bs)
        for ptr, t in zip((means, epoch), want):
            if t.numel():
                dst = np.ctypeslib.as_array(
                    (ctypes.c_float * t.numel()).from_address(ptr))
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
