"""The port's bring-up (``mfcd_tpu_torch/parallel/multihost.py``), its
launcher and the two scripts that run on it, in gloo jobs on the CPU.

Counterpart of ``tests/test_multihost.py``: two processes of one job each
run their strided slice of a sweep grid (``shard_param_sets`` +
``run_experiment(seed=7)``), and the merged slices equal one process's
sweep.  Every launch has a join timeout and a file-store rendezvous, and
every rank checks that it imported neither jax nor ``mfcd_tpu``.
"""

import os
import socket

import pytest
import torch
import torch.distributed as dist

import _torch_ranks
from mfcd_tpu.core.config import SweepSpec
from mfcd_tpu.parallel.multihost import shard_param_sets as jshard
from mfcd_tpu_torch.parallel import multihost
from mfcd_tpu_torch.scripts import dryrun_multichip, validate_sharded_cell
from mfcd_tpu_torch.sweep.engine import run_experiment

JOIN_S = 120
GRID = SweepSpec(params=dict(
    n=24, m=20, d=2, p=0.4, s=[2.0, 5.0, 8.0, 11.0], lr=1e-3,
    weight_decay=1e-5, num_epochs=1, reps=1, K=1)).expand()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("nproc", [1, 2, 3, 5])
def test_shard_param_sets_matches_jax(nproc):
    grid = [{"i": i} for i in range(10)]
    shards = [multihost.shard_param_sets(grid, pid, nproc)
              for pid in range(nproc)]
    assert shards == [jshard(grid, pid, nproc) for pid in range(nproc)]
    assert sorted(x["i"] for s in shards for x in s) == list(range(10))


def test_two_process_strided_sweep():
    outs = multihost.launch(_torch_ranks.run_all, 2,
                            args=([("sweep", "strided_sweep", (GRID,))],),
                            device="cpu", timeout_s=JOIN_S)
    merged = outs[0]["sweep"] + outs[1]["sweep"]
    assert [e["params"]["s"] for e in outs[0]["sweep"]] == [2.0, 8.0]
    assert sorted(e["params"]["s"] for e in merged) == [2.0, 5.0, 8.0, 11.0]
    want = [run_experiment(**e["params"], seed=7, device="cpu")
            for e in merged]
    dryrun_multichip.compare_results([e["results"] for e in merged], want,
                                     "strided sweep")


def test_a_rank_failure_fails_the_launch():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        multihost.launch(_torch_ranks.run_all, 2,
                         args=([("x", "fail_on_rank", (1,))],),
                         device="cpu", timeout_s=JOIN_S)


def test_the_join_timeout_stops_the_ranks():
    with pytest.raises(TimeoutError, match="still running"):
        multihost.launch(_torch_ranks.run_all, 2,
                         args=([("x", "sleep", (60,))],), device="cpu",
                         timeout_s=5)


def test_initialize_from_the_environment(monkeypatch):
    """``torchrun``'s variables, a world of one, on this process."""
    for k, v in (("MASTER_ADDR", "localhost"),
                 ("MASTER_PORT", str(_free_port())), ("WORLD_SIZE", "1"),
                 ("RANK", "0")):
        monkeypatch.setenv(k, v)
    device = multihost.initialize(device="cpu", timeout_s=60)
    try:
        assert device == torch.device("cpu")
        assert dist.get_backend() == "gloo"
        assert (dist.get_world_size(), dist.get_rank()) == (1, 0)
        from mfcd_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(device="cpu")
        assert (mesh.shape, mesh.groups) == ((1, 1, 1), {})
    finally:
        dist.destroy_process_group()


def test_initialize_refuses_what_cannot_run(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        multihost.initialize(device="cpu")
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize("localhost:1", device="cpu")
    with pytest.raises(ValueError, match="nccl runs on the card"):
        multihost.initialize("localhost:1", 1, 0, backend="nccl",
                             device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("localhost:1", 1, 0)
    assert not dist.is_initialized()


def test_nccl_needs_a_card_per_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one card per rank"):
        multihost.initialize("localhost:1", 2, 0, device="cuda")
    assert not dist.is_initialized()


def test_dryrun_multichip_at_four_ranks(capsys):
    assert dryrun_multichip.main(["--ranks", "4", "--device", "cpu",
                                  "--timeout", str(JOIN_S)]) == 0
    out = capsys.readouterr().out
    assert "mesh axes: grid=2, data=2, tp=1 (gloo, cpu)" in out
    assert "sharded train step ok" in out
    for case in ("random", "soft-label K=4", "proximity PRP",
                 "user_similarity cascade"):
        assert f"[{case}] sharded == unsharded (bit-exact) for 4" in out


def test_validate_sharded_cell_at_two_ranks(capsys, tmp_path):
    assert validate_sharded_cell.main(
        ["--ranks", "2", "--device", "cpu", "--scale", "0.01", "--reps", "1",
         "--strategies", "random,proximity", "--out-dir", str(tmp_path),
         "--timeout", str(JOIN_S)]) == 0
    out = capsys.readouterr().out
    assert "PASS: 40 configs x 1 reps across 2 strategies on 2 ranks" in out
    assert os.path.exists(tmp_path / "sharded_random.pkl")
