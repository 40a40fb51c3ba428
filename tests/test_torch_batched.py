"""The port's batched sweep: ``parameter_scan_fast`` vs ``mfcd_tpu``'s, vs
the port's sequential scan, chunking, persistence, resume, and the OOM
bisection.

At ``tests/test_engine.py``'s ``CFG`` shape, so the JAX side reuses the
programs that file compiles.  Against the JAX package the 23 keys agree at
``test_parameter_scan_matches_jax``'s rtol 1e-4 / atol 1e-5 (float32
rounding amplified over two epochs); within the port, batching changes no
key or stream, so fast and sequential agree to rtol 1e-6 / atol 1e-7.
"""

import pickle

import numpy as np
import pytest
import torch

from mfcd_tpu.core.results import RESULT_KEYS
from mfcd_tpu.sweep.batched import parameter_scan_fast as jax_scan_fast
import mfcd_tpu_torch
from mfcd_tpu_torch.core.config import RunConfig
from mfcd_tpu_torch.sweep import batched
from mfcd_tpu_torch.sweep.engine import compile_caps

torch.set_num_threads(1)

CFG = dict(n=24, m=28, d=2, p=0.4, s=[1.0, 4.0], lr=1e-2, weight_decay=1e-5,
           num_epochs=2, reps=2, K=1)
SMALL = dict(CFG, num_epochs=1, reps=1, s=[1.0, 4.0, 6.0])
WIDE = dict(CFG, s=[1.0, 2.0, 4.0, 6.0, 8.0])


def _flat(v):
    if isinstance(v, list) and v and isinstance(v[0], (list, np.ndarray)):
        return np.concatenate([np.ravel(np.asarray(x, np.float64))
                               for x in v])
    return np.asarray(v, np.float64)


def _assert_scans_close(want, got, rtol, atol):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a["params"] == b["params"]
        assert set(b["results"]) == set(RESULT_KEYS)
        for k in RESULT_KEYS:
            np.testing.assert_allclose(_flat(b["results"][k]),
                                       _flat(a["results"][k]), rtol=rtol,
                                       atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def fast():
    return mfcd_tpu_torch.parameter_scan_fast(device="cpu", **CFG)


def test_fast_scan_matches_jax(fast):
    _assert_scans_close(jax_scan_fast(**CFG), fast, rtol=1e-4, atol=1e-5)


def test_fast_scan_matches_sequential(fast):
    seq = mfcd_tpu_torch.parameter_scan(device="cpu", **CFG)
    _assert_scans_close(seq, fast, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def fast_wide():
    return mfcd_tpu_torch.parameter_scan_fast(device="cpu", **WIDE)


@pytest.mark.parametrize("max_bucket", [1, 2, 3, 4])
def test_chunk_of_one_matches_default(fast_wide, max_bucket):
    # Five configurations in one chunk, against chunks of 1 to 4: the
    # chunk boundaries change no stream, only the runs a call.
    chunked = mfcd_tpu_torch.parameter_scan_fast(
        device="cpu", max_bucket=max_bucket, **WIDE)
    _assert_scans_close(fast_wide, chunked, rtol=1e-6, atol=1e-7)


def test_save_path_and_resume(tmp_path):
    path = str(tmp_path / "fast.pkl")
    with open(path, "wb") as f:
        pickle.dump(["sentinel"], f)  # must be cleared at scan start
    out = mfcd_tpu_torch.parameter_scan_fast(device="cpu", save_path=path,
                                             max_bucket=2, **SMALL)
    assert out == []  # reference quirk: flushed scans return []
    full = pickle.load(open(path, "rb"))
    assert [e["params"]["s"] for e in full] == [1.0, 4.0, 6.0]

    path2 = str(tmp_path / "resume.pkl")
    mfcd_tpu_torch.parameter_scan_fast(device="cpu", save_path=path2,
                                       **dict(SMALL, s=[4.0]))
    before = pickle.load(open(path2, "rb"))
    mfcd_tpu_torch.parameter_scan_fast(device="cpu", save_path=path2,
                                       resume=True, **SMALL)
    after = pickle.load(open(path2, "rb"))
    assert [e["params"]["s"] for e in after] == [4.0, 1.0, 6.0]
    assert after[0]["results"]["accuracy"] == before[0]["results"]["accuracy"]
    by_s = {e["params"]["s"]: e["results"] for e in full}
    for e in after[1:]:  # keys fold from the grid index, as in a full scan
        assert e["results"]["accuracy"] == by_s[e["params"]["s"]]["accuracy"]


def test_oom_bisection(monkeypatch, capsys):
    want = mfcd_tpu_torch.parameter_scan_fast(device="cpu", **SMALL)
    real = batched._run_bucket_device
    sizes = []

    def flaky(cfg, cfg_keys, *args, **kwargs):
        sizes.append(cfg_keys.shape[0])
        if cfg_keys.shape[0] > 1:
            raise torch.cuda.OutOfMemoryError("out of memory (test)")
        return real(cfg, cfg_keys, *args, **kwargs)

    monkeypatch.setattr(batched, "_run_bucket_device", flaky)
    got = mfcd_tpu_torch.parameter_scan_fast(device="cpu", **SMALL)
    assert sizes == [3, 1, 2, 1, 1]
    assert capsys.readouterr().err.count("bisecting") == 2
    _assert_scans_close(want, got, rtol=0, atol=0)

    def always(cfg, cfg_keys, *args, **kwargs):
        raise torch.cuda.OutOfMemoryError("out of memory (test)")

    monkeypatch.setattr(batched, "_run_bucket_device", always)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        mfcd_tpu_torch.parameter_scan_fast(device="cpu", **SMALL)


def test_default_max_bucket(capsys):
    canon = RunConfig(n=1000, m=1000, d=2, p=0.2, reps=4)
    per_run = batched.run_bytes(canon, t_cap=131_072)
    assert per_run > 1000 * 1000 * 4
    chunk = batched.default_max_bucket(canon, t_cap=131_072, device="cpu")
    assert chunk == max(4, int(batched.CPU_BUDGET_BYTES / per_run)) // 4
    assert "configs x 4 reps per chunk" in capsys.readouterr().out
    batched.default_max_bucket(canon, t_cap=131_072, device="cpu")
    assert capsys.readouterr().out == ""  # printed once per choice
    wide = RunConfig(n=20_000, m=20_000, d=2, p=1e-4, reps=4)
    assert batched.default_max_bucket(wide, device="cpu") == 1


def test_sampler_bytes_follow_the_sampler_path():
    """The per-run estimate charges each strategy its sampler's working
    set at the canonical shape: nothing per proposal for the prefix map,
    margin's million PRP-distinct proposals, the overdraw's candidates and
    hash table, and user_similarity's blocks and 2^23-slot cascade table,
    so heavier samplers get smaller chunks."""
    mk = lambda s: RunConfig(n=1000, m=1000, d=2, p=0.2, reps=4, strategy=s)
    cap = lambda s: compile_caps(mk(s))[0]
    est = {s: batched.sampler_bytes(mk(s), cap(s))
           for s in ("random", "proximity", "top_k", "svd", "margin",
                     "variance", "popularity", "cluster", "user_similarity")}
    prefix = max(est[s] for s in ("random", "proximity", "top_k", "svd"))
    assert prefix == 131_072 * batched._SAMPLE_SLOT_BYTES
    assert est["margin"] == 1_024_288 * batched._DISTINCT_BYTES
    for s in ("variance", "popularity", "cluster"):
        assert prefix < est[s] < est["user_similarity"], s
    assert est["user_similarity"] > 3 * 4 * 2**23
    chunks = {s: batched.default_max_bucket(mk(s), t_cap=cap(s),
                                            device="cpu") for s in est}
    assert chunks["random"] > chunks["margin"] > chunks["user_similarity"]


def test_device_and_linear_checks(monkeypatch):
    with pytest.raises(ValueError, match="not synchronized"):
        mfcd_tpu_torch.parameter_scan_fast(device="cpu", s=[1.0, 2.0],
                                           lr=[1e-3, 1e-2, 1e-1],
                                           linear=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mfcd_tpu_torch.parameter_scan_fast(n=10, m=10, d=2, p=0.5,
                                           num_epochs=1)
