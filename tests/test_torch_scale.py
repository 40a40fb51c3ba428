"""K1's shape envelope and the scale scripts of the port, on the CPU.

- The gate (``ops/kernels.py::min_cluster``, ``epoch_kernel_supported``)
  against the JAX package's ``pallas_epoch_supported``: pure arithmetic.
- The launch-shape chooser at a floor, on occupancy tables as a card's
  query might report them.
- ``scripts/scale_demo.py`` against the JAX package's ``run_config`` at a
  small shape (the tolerances of ``tests/test_torch_engine.py``).
- ``scripts/weak_scaling.py`` over 2 gloo ranks at a tiny bucket: results
  bit-equal to the unsharded bucket, the census constant per chunk.
- ``scripts/graft_entry.py`` against ``__graft_entry__.entry``.
"""

import json

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from mfcd_tpu.core import config as jconfig
from mfcd_tpu.core.results import RESULT_KEYS
from mfcd_tpu.ops.kernels import pallas_epoch_supported
from mfcd_tpu.sweep import engine as jengine
from mfcd_tpu_torch.convert import params_from_jax
from mfcd_tpu_torch.core import config as tconfig
from mfcd_tpu_torch.ops import kernels as K
from mfcd_tpu_torch.scripts import graft_entry, scale_demo, weak_scaling
from mfcd_tpu_torch.sweep import engine as tengine
from test_torch_kernels import _OCCUPANCY

torch.set_num_threads(1)

# The gate's grid: JAX's edge at d = 2, bs = 64 (n = m = 7,168), the port's
# old C = 1 edge (3,559), scale_demo's 10,000, and their neighbours; the
# small tables JAX admits at bs = 2,048.
GRID_ROWS = (20, 100, 300, 1000, 3559, 3560, 5000, 7168, 7169, 10_000)
GRID_D = (2, 4, 8, 16)
GRID_BS = (32, 64, 1024, 2048)


def _smem(n, m, d, bs, c):
    """One block's shared memory at cluster size c, written out: per row of
    the share a list head and 3 planes of d floats; per batch row 14 + 2d
    words; two counts.  Split, an 8-byte mbarrier and the pushed rows, 3d
    floats for each of as many batch rows as fit in the rest of the block,
    the whole batch at most and one at least."""
    rows = -(-n // c) + -(-m // c)
    rest = 8 * rows + 4 * (3 * rows * d + bs * (14 + 2 * d) + 2)
    if c == 1:
        return rest
    held = min(bs, max(1, (232_448 - rest - 8) // (12 * d)))
    return rest + 8 + 12 * d * held


def _smem_gathered(n, m, d, bs, c):
    """The same under the earlier split layout, whose batch phase gathered
    rows from their owners: the state double-buffered (4 planes split), no
    pushed rows."""
    rows = -(-n // c) + -(-m // c)
    return 8 * rows + 4 * ((4 if c > 1 else 3) * rows * d
                           + bs * (14 + 2 * d) + 2)


def _grid():
    return [(n, m, d, bs) for d in GRID_D for bs in GRID_BS
            for n in GRID_ROWS for m in GRID_ROWS]


def test_gate_admits_what_jax_admits():
    # Every shape JAX's VMEM check admits, the port admits, but where the
    # batch's scratch alone (14 + 2d words a batch row) outgrows a block,
    # which no C shrinks: d = 8 and 16 at bs = 2,048.  The d >= 8, bs <= 64
    # shapes past C = 8's reach take C = 16, where their block fits: at
    # d = 8 only n = m = 10,000 at bs = 32.  num_batches only matters to
    # JAX under MFCD_PALLAS_MAX_ROWS.
    gaps, at16 = [], []
    for n, m, d, bs in _grid():
        nb = max(1, int(0.8 * n * m * 0.02 / 2) // bs)
        if pallas_epoch_supported(n, m, d, nb, bs):
            if not K.epoch_kernel_supported(n, m, d, bs):
                gaps.append((n, m, d, bs))
                assert 4 * bs * (14 + 2 * d) > 232_448, (n, m, d, bs)
            elif K.min_cluster(n, m, d, bs) == 16:
                at16.append((n, m, d, bs))
                assert d >= 8 and bs <= 64, (n, m, d, bs)
    assert gaps == [(n, m, d, 2048) for d in (8, 16) for n in (20, 100)
                    for m in (20, 100)]
    assert [s for s in at16 if s[2] == 8] == [(10_000, 10_000, 8, 32)]
    for d in (2, 4):
        for n in (3559, 3560, 5000, 7168):
            assert pallas_epoch_supported(n, n, d, 1, 64)
            assert K.epoch_kernel_supported(n, n, d, 64)
    assert not pallas_epoch_supported(10_000, 10_000, 2, 12_500, 64)
    assert K.epoch_kernel_supported(10_000, 10_000, 2, 64)


@pytest.mark.parametrize("d", GRID_D)
@pytest.mark.parametrize("bs", GRID_BS)
def test_min_cluster_is_the_smem_arithmetic(d, bs):
    for n in GRID_ROWS + (8409, 8640, 8641, 13_216, 16_816, 17_280, 17_281,
                          22_776, 22_777, 28_472, 28_473, 30_000, 45_552,
                          45_553, 56_944, 56_945):
        for m in (20, n):
            fits = [c for c in (1, 2, 4, 8, 16)
                    if _smem(n, m, d, bs, c) <= 232_448]
            want = fits[0] if fits else None
            assert K.min_cluster(n, m, d, bs) == want
            assert K.epoch_kernel_supported(n, m, d, bs) == (want is not None)
            for c in (1, 2, 4, 8, 16):
                assert K.epoch_smem_bytes(n, m, d, bs, c) == _smem(
                    n, m, d, bs, c)


def test_min_cluster_at_d2_bs64():
    # The smallest C that fits, n = m, d = 2, bs = 64.  The split block
    # holds the state once and the pushed rows, the whole batch's up to
    # n = 7,070 at C = 2, 14,140 at C = 4 and 28,280 at C = 8, beyond that
    # fewer, in rounds: C = 2 reaches 7,118, C = 4 14,236, C = 8 28,472 and
    # C = 16 56,944.
    for n, c in ((1000, 1), (3559, 1), (3560, 2), (5000, 2), (7070, 2),
                 (7118, 2), (7119, 4), (7168, 4), (10_000, 4), (14_236, 4),
                 (14_237, 8), (22_777, 8), (28_472, 8), (28_473, 16),
                 (30_000, 16), (45_552, 16), (45_553, 16), (56_944, 16),
                 (56_945, None)):
        assert K.min_cluster(n, n, 2, 64) == c, n
    assert K.pushed_rows(7070, 7070, 2, 64, 2) == 64
    assert K.pushed_rows(7071, 7071, 2, 64, 2) == 63
    assert K.pushed_rows(7118, 7118, 2, 64, 2) == 2
    assert K.epoch_smem_bytes(10_000, 10_000, 2, 64, 2) == 324_648
    assert K.epoch_smem_bytes(10_000, 10_000, 2, 64, 4) == 166_160


@pytest.mark.parametrize("d", (1, 2, 3, 4, 7, 8, 16))
@pytest.mark.parametrize("bs", (1, 32, 64, 256, 1024, 2048))
def test_gate_admits_what_the_gathered_layout_admitted(d, bs):
    # Every shape the gathered layout's gate admitted is admitted, at the
    # same or a smaller C: where the whole batch's pushed rows do not fit
    # beside the share, the block holds as many as do and a step pushes its
    # batch in rounds.
    for n in range(1, 60_000, 173):
        for m in (20, n):
            was = [c for c in (1, 2, 4, 8, 16)
                   if _smem_gathered(n, m, d, bs, c) <= 232_448]
            now = K.min_cluster(n, m, d, bs)
            if was:
                assert now is not None and now <= was[0], (n, m)


@pytest.mark.parametrize("card", list(_OCCUPANCY))
@pytest.mark.parametrize("floor", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("runs", [1, 4, 8, 16, 17, 34, 120, 310])
def test_choose_cluster_at_a_floor(runs, floor, card):
    table = _OCCUPANCY[card]
    asked = []

    def query(c):
        asked.append(c)
        return table[c]

    sizes = [c for c in K.CLUSTER_SIZES if c >= floor]
    fits = [c for c in sizes if table[c] >= runs]
    most = max(table[c] for c in sizes)
    if not fits and floor > 1 and most == 0:
        with pytest.raises(ValueError, match="holds no cluster"):
            K.choose_cluster(runs, query, floor)
        return
    c = K.choose_cluster(runs, query, floor)
    assert c == K.PACKED or c >= floor
    assert all(k >= floor for k in asked)
    if fits:  # one wave: the largest C that holds every run
        assert c == max(fits)
    elif floor == 1:  # the C = 1 block fits: packed, three runs an SM
        assert c == K.PACKED
    else:  # waves: the C with the most resident runs, the largest on a tie
        assert table[c] == most
        assert c == max(k for k in sizes if table[k] == most)
        assert -(-runs // table[c]) > 1


def test_choose_cluster_floor_cases():
    h100, no16 = _OCCUPANCY["h100-like"], _OCCUPANCY["no-16"]
    # scale_demo's shape (floor 4) at R = 1 on an H100-like card: C = 16.
    assert K.choose_cluster(1, h100.get, 4) == 16
    # A floor of 4 on the "no-16" card: C = 8 up to its 15 runs, then 4,
    # then two waves at 4 (the most resident runs).
    assert K.choose_cluster(1, no16.get, 4) == 8
    assert K.choose_cluster(15, no16.get, 4) == 8
    assert K.choose_cluster(16, no16.get, 4) == 4
    assert K.choose_cluster(34, no16.get, 4) == 4
    # Floor 2, more runs than C = 2 holds: waves of 66, never packed.
    assert K.choose_cluster(120, h100.get, 2) == 2
    assert K.choose_cluster(0, h100.get, 4) == 4
    assert K.choose_cluster(0, h100.get, 1) == K.PACKED
    with pytest.raises(ValueError, match="holds no cluster"):
        K.choose_cluster(1, _OCCUPANCY["none"].get, 2)


def test_forced_shape_below_the_floor_raises():
    smem = lambda c: K.epoch_smem_bytes(10_000, 10_000, 2, 64, c)
    floor = K.min_cluster(10_000, 10_000, 2, 64)
    for c in (K.PACKED, 1, 2):
        with pytest.raises(ValueError, match="smallest C that fits this "
                                             "shape is 4"):
            K.check_launch_shape("t", c, floor, smem)
    with pytest.raises(ValueError, match="PACKED"):
        K.check_launch_shape("t", K.PACKED, floor, smem)
    for c in (None, 4, 8, 16):
        K.check_launch_shape("t", c, floor, smem)
    with pytest.raises(ValueError, match="cluster=3"):
        K.check_launch_shape("t", 3, floor, smem)
    with pytest.raises(ValueError, match="even at C = 16"):
        K.check_launch_shape("t", None, None, smem)


def test_cluster_size_takes_the_floor(monkeypatch, capsys):
    table = _OCCUPANCY["no-16"]
    asked = []

    def occupancy(n, m, d, bs, c, idx):
        asked.append(c)
        return 1, table.get(c, 0)

    monkeypatch.setattr(K, "epoch_occupancy", occupancy)
    monkeypatch.setattr(K, "_printed_clusters", set())
    assert K.cluster_size(1, 10_000, 10_000, 2, 64, "cuda:0") == 8
    out = capsys.readouterr().out
    assert "1 runs x 8 blocks per run" in out and "smallest C 4" in out
    assert K.cluster_size(34, 10_000, 10_000, 2, 64, "cuda:0") == 4
    assert "33 runs resident, 2 waves" in capsys.readouterr().out
    assert min(asked) >= 4
    with pytest.raises(ValueError, match="even at C = 16"):
        K.cluster_size(1, 56_945, 56_945, 2, 64, "cuda:0")
    # A floor of 16 on a card that holds no 16-block cluster raises, with
    # the shape and C = 16 in the message: no autograd, no smaller C.
    with pytest.raises(ValueError, match=r"n=30000, m=30000, d=2, bs=64, "
                       r"smallest C 16: the card holds no cluster of any "
                       r"size from C = 16 up"):
        K.cluster_size(1, 30_000, 30_000, 2, 64, "cuda:0")
    assert K.cluster_size(1, 30_000, 30_000, 2, 64, "cuda:0",
                          floor=8) == 8
    monkeypatch.setattr(K, "_printed_clusters", set())
    table = _OCCUPANCY["h100-like"]  # the occupancy stub reads it
    assert K.cluster_size(1, 10_000, 10_000, 8, 64, "cuda:0") == 16
    assert "smallest C 16" in capsys.readouterr().out


def test_engine_picks_the_kernel_from_the_shape(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tengine, "_printed_kernel_choices", set())
    for n, c in ((3560, 2), (5000, 2), (7168, 4), (10_000, 4)):
        cfg = tconfig.RunConfig(n=n, m=n, d=2)
        assert tengine.default_use_kernel(cfg, "cuda")
        assert f"kernel fits: True, smallest C {c}" in capsys.readouterr().out
        assert not tengine.default_use_kernel(cfg, "cpu")
    assert tengine.default_use_kernel(
        tconfig.RunConfig(n=30_000, m=30_000, d=2), "cuda")
    assert "kernel fits: True, smallest C 16" in capsys.readouterr().out
    assert not tengine.default_use_kernel(
        tconfig.RunConfig(n=56_945, m=56_945, d=2), "cuda")


def _flat(v):
    if isinstance(v, list) and v and isinstance(v[0], (list, np.ndarray)):
        return np.concatenate([np.ravel(np.asarray(x, np.float64))
                               for x in v])
    return np.asarray(v, np.float64)


DEMO = dict(n=48, p=0.2, epochs=2)


@pytest.fixture(scope="module")
def jax_demo():
    """The JAX script's second call at ``DEMO``."""
    cfg = jconfig.RunConfig(n=DEMO["n"], m=DEMO["n"], d=2, p=DEMO["p"],
                            s=5.0, lr=1e-3, weight_decay=1e-5,
                            num_epochs=DEMO["epochs"], reps=1)
    return jengine.run_config(cfg, seed=scale_demo.SEEDS[1])


def test_scale_demo_matches_jax(jax_demo):
    # Every result key within test_torch_engine.py's tolerances (rtol 1e-4,
    # atol 1e-5): the eager trainer the CPU takes, and the kernel trainer
    # (each epoch K1's plain version) the card takes at this shape.
    line, got = scale_demo.run(DEMO["n"], DEMO["p"], DEMO["epochs"],
                               device="cpu")
    cfg = tconfig.RunConfig(n=DEMO["n"], m=DEMO["n"], d=2, p=DEMO["p"],
                            s=5.0, lr=1e-3, weight_decay=1e-5,
                            num_epochs=DEMO["epochs"], reps=1)
    kernel = tengine.run_config(cfg, seed=scale_demo.SEEDS[1],
                                use_kernel=True, device="cpu")
    for res in (got, kernel):
        for k in RESULT_KEYS:
            np.testing.assert_allclose(_flat(res[k]), _flat(jax_demo[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    assert line["accuracy"] == got["accuracy"]
    assert line["trainer"] == "eager" and line["k1_launches"] == [0, 0]
    assert line["cluster"] is None and line["smallest_cluster"] == 1


def test_scale_demo_smoke_prints_its_line(capsys):
    assert scale_demo.main(["--smoke", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "scale_demo_full_run_seconds_128x128"
    assert set(line) == {
        "metric", "value", "unit", "first_call_s", "accuracy",
        "gt_accuracy", "reconstruction_error_scaled", "trainer", "cluster",
        "smallest_cluster", "k1_launches", "peak_bytes", "device", "card"}
    assert line["value"] > 0 and line["first_call_s"] > 0
    assert len(line["accuracy"]) == 1
    assert line["device"] == "cpu" and line["card"] is None


def test_scale_demo_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scale_demo.main(["--smoke"])


@pytest.fixture(scope="module")
def weak():
    return weak_scaling.scaling(
        [2], "cpu", bucket=weak_scaling.SMOKE_BUCKET,
        configs=weak_scaling.SMOKE_CONFIGS, timeout_s=180)


def test_weak_scaling_two_gloo_ranks(weak):
    # Sharded over 2 ranks, every key bit-equal to the unsharded bucket
    # (rank 0 compares; no key needed a bound on the CPU).
    (row,) = weak["scaling"]
    assert row["ranks"] == 2 and row["backend"] == "gloo"
    assert row["rounded_gaps"] == {}
    assert row["wall_s"] > 0 and len(row["walls_by_rank"]) == 2
    assert weak["fixed_total_work"]["total_runs"] == 4
    assert weak["device"] == "cpu" and weak["card"] is None


def test_weak_scaling_census_is_constant_per_chunk(weak):
    # Two timed chunks of 4 configurations and one of 1: each exactly the
    # failure flag's all_reduce and the results' all_gather_object; none in
    # the train stage.
    census = weak["census"]["2"]
    assert [c["configs"] for c in census["chunks"]] == [4, 4, 1]
    for c in census["chunks"]:
        assert c["collectives"] == weak_scaling.PER_CHUNK
    assert census["train_stage"] == {} and census["train_calls"] == 3
    assert census["outside_chunks"] == {}


def test_census_catches_a_collective_in_the_train_stage(monkeypatch):
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "barrier", lambda *a, **k: calls.append(1))
    monkeypatch.setattr(tengine, "train_model",
                        lambda *a, **k: dist.barrier())
    census = weak_scaling.Census()
    with census.active():
        tengine.train_model()
        dist.barrier()
    assert calls == [1, 1]
    report = census.report()
    assert report["train_stage"] == {"barrier": 1}
    assert report["outside_chunks"] == {"barrier": 1}
    with pytest.raises(AssertionError, match="train stage"):
        weak_scaling.check_census(report, "t")


def test_forward_probe_matches_jax():
    # JAX's entry() on its own params, carried over, within 1e-6; the
    # port's own draws: indices bit-equal, params within the normal
    # sampler's rounding.
    jfn, (jp, ju, ji, jj) = __graft_entry__.entry()
    want = np.asarray(jax.jit(jfn)(jp, ju, ji, jj))
    fn, (params, u, i, j) = graft_entry.entry("cpu")
    assert want.shape == (graft_entry.BATCH,)
    for a, b in ((ju, u), (ji, i), (jj, j)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    carried = params_from_jax(np.asarray(jp.U), np.asarray(jp.V))
    np.testing.assert_allclose(fn(carried, u, i, j).numpy(), want, rtol=0,
                               atol=1e-6)
    for a, b in ((jp.U, params.U), (jp.V, params.V)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(fn(params, u, i, j).numpy(), want, rtol=0,
                               atol=1e-6)
