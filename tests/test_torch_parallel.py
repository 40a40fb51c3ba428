"""The port's mesh layer (``mfcd_tpu_torch/parallel/mesh.py``, the
``mesh=`` path of ``sweep/batched.py``) against ``mfcd_tpu.parallel`` and
the port's unsharded paths, in gloo jobs of 2, 4 and 8 ranks on the CPU.

The sharded step is held against JAX's ``make_sharded_train_step`` (on
the conftest's 8-device mesh) at ``tests/test_parallel.py``'s tolerances,
and its Adam moments against JAX's plain oracle (``value_and_grad`` +
``adam_update``) at rtol 1e-5, atol 1e-7.  JAX's own sharded step does not
meet that oracle: its gradients, and so its moments, are dp x tp times
too large (the transposes of the ``psum``s inside its differentiated loss
sum the replicated cotangents again), which its Adam's first step cancels.
``test_reference_gradient_scale`` states that factor.  Grid-sharded
buckets and scans are bit-equal to the unsharded ones.

Each world size is one launch (``_torch_ranks.run_all``), shared by the
tests through module fixtures; every rank checks that it imported neither
jax nor ``mfcd_tpu``.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

import _torch_ranks
from mfcd_tpu.core.results import RESULT_KEYS
from mfcd_tpu.models.mf import MFParams as JParams
from mfcd_tpu.models.mf import forward_logits as jforward
from mfcd_tpu.ops.losses import bce_with_logits as jbce
from mfcd_tpu.ops.optim import adam_init as jadam_init
from mfcd_tpu.ops.optim import adam_update as jadam_update
from mfcd_tpu.parallel import mesh as jmesh
from mfcd_tpu.sweep import batched as jbatched
from mfcd_tpu_torch.core.config import RunConfig
from mfcd_tpu_torch.parallel import mesh as tmesh
from mfcd_tpu_torch.parallel.multihost import launch
from mfcd_tpu_torch.scripts.dryrun_multichip import toy_batch
from mfcd_tpu_torch.sweep import batched as tbatched

JOIN_S = 120
STEP_MESHES = [(2, 2, 2), (1, 1, 2), (1, 2, 1)]
LR, WD = 1e-2, 1e-4
BUCKET = dict(n=16, m=18, d=2, p=0.4, num_epochs=1, reps=1, batch_size=16)
ROWS = [{"s": 1.0 + 0.5 * k, "lr": 1e-3, "weight_decay": 1e-5}
        for k in range(8)]
SCAN = dict(n=24, m=28, d=2, p=0.4, s=[1.0, 4.0, 6.0], lr=1e-2,
            weight_decay=1e-5, num_epochs=1, reps=1, K=1, max_bucket=2)


def _inputs(shape):
    """``tests/test_parallel.py``'s ``_toy_batch`` shapes, from numpy."""
    g, dp, tp = shape
    return toy_batch(g, 16, 24, 2 * tp, 8 * dp, seed=sum(shape))


def _jax_mesh(shape):
    devices = np.asarray(jax.devices()[:int(np.prod(shape))])
    return JaxMesh(devices.reshape(shape), ("grid", "data", "tp"))


def _jax_sharded(shape, inp, wd):
    g = shape[0]
    params = JParams(jnp.asarray(inp["U"]), jnp.asarray(inp["V"]))
    step = jmesh.make_sharded_train_step(_jax_mesh(shape))
    p, o, loss = step(params, jmesh.replicate_opt_state_for_grid(params),
                      *(jnp.asarray(inp[k]) for k in ("u", "i", "j", "z",
                                                      "mask")),
                      jnp.full((g,), LR, jnp.float32),
                      jnp.full((g,), wd, jnp.float32))
    return dict(U=p.U, V=p.V, mu_U=o.mu.U, mu_V=o.mu.V, nu_U=o.nu.U,
                nu_V=o.nu.V, loss=loss)


def _jax_plain(inp, wd, opt=None):
    """The single-device oracle of ``tests/test_parallel.py`` per config,
    from ``opt`` (JAX AdamStates per config) or fresh moments."""
    out = {k: [] for k in ("U", "V", "mu_U", "mu_V", "nu_U", "nu_V",
                           "loss", "opt")}
    for c in range(inp["U"].shape[0]):
        p0 = JParams(jnp.asarray(inp["U"][c]), jnp.asarray(inp["V"][c]))
        b = {k: jnp.asarray(inp[k][c]) for k in ("u", "i", "j", "z")}

        def loss_fn(p):
            logits = jforward(p, b["u"], b["i"], b["j"])
            return jnp.mean(jbce(logits, b["z"]))

        loss, grads = jax.value_and_grad(loss_fn)(p0)
        o0 = jadam_init(p0) if opt is None else opt[c]
        p1, o1 = jadam_update(p0, grads, o0, LR, wd)
        for k, v in (("U", p1.U), ("V", p1.V), ("mu_U", o1.mu.U),
                     ("mu_V", o1.mu.V), ("nu_U", o1.nu.U),
                     ("nu_V", o1.nu.V), ("loss", loss)):
            out[k].append(np.asarray(v))
        out["opt"].append(o1)
    return {k: (v if k == "opt" else np.stack(v)) for k, v in out.items()}


def _step_calls(shape):
    inp = _inputs(shape)
    calls = [(f"{shape} wd", "steps", (shape, inp, [inp], LR, WD)),
             (f"{shape} wd0", "steps", (shape, inp, [inp], LR, 0.0))]
    if shape == (2, 2, 2):
        # A second step from the oracle's moments after the first.
        first = _jax_plain(inp, WD)
        nxt = dict(inp, U=first["U"], V=first["V"])
        opt = dict(mu=(first["mu_U"], first["mu_V"]),
                   nu=(first["nu_U"], first["nu_V"]),
                   step=np.ones(shape[0], np.int32))
        calls.append((f"{shape} second", "steps",
                      (shape, nxt, [nxt], LR, WD, opt)))
        calls.append(("roundtrip", "roundtrip", (shape, [
            (tmesh.PARAM_SPEC, inp["U"]), (tmesh.BATCH_SPEC, inp["u"]),
            (tmesh.GRID_SPEC, np.arange(2, dtype=np.float32))])))
    return calls


def _flat(v):
    if isinstance(v, list) and v and isinstance(v[0], (list, np.ndarray)):
        return [np.asarray(x) for x in v]
    return [np.asarray(v)]


def _assert_bit_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(RESULT_KEYS) == set(b)
        for k in RESULT_KEYS:
            for x, y in zip(_flat(a[k]), _flat(b[k]), strict=True):
                np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.fixture(scope="module")
def plain():
    """The port's unsharded bucket and scan, in this process."""
    cfg = RunConfig(**BUCKET)
    return dict(
        bucket=tbatched.run_bucket(cfg, ROWS, list(range(8)), device="cpu"),
        pad3=tbatched.run_bucket(cfg, ROWS[:3], [0, 1, 2], device="cpu"),
        pad5=tbatched.run_bucket(cfg, ROWS[:5], list(range(5)),
                                 device="cpu"),
        scan=tbatched.parameter_scan_fast(device="cpu", **SCAN))


@pytest.fixture(scope="module")
def ranks8():
    return launch(_torch_ranks.run_all, 8, args=(_step_calls((2, 2, 2)),),
                  device="cpu", timeout_s=JOIN_S)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory, plain):
    tmp = tmp_path_factory.mktemp("ranks2")
    # A pickle holding the scan's first configuration, to resume from.
    with open(tmp / "resume.pkl", "wb") as f:
        pickle.dump(plain["scan"][:1], f)
    calls = _step_calls((1, 1, 2)) + _step_calls((1, 2, 1)) + [
        ("bucket", "bucket", (BUCKET, ROWS, list(range(8)))),
        ("pad3", "bucket", (BUCKET, ROWS[:3], [0, 1, 2])),
        ("scan", "scan", (SCAN,)),
        ("save", "scan", (dict(SCAN, save_path=str(tmp / "sharded.pkl")),)),
        ("resume", "scan", (dict(SCAN, save_path=str(tmp / "resume.pkl"),
                                 resume=True),)),
        ("oom", "scan_oom_on", (1, dict(SCAN, max_bucket=3))),
        ("chunks of one", "scan", (dict(SCAN, max_bucket=1),)),
    ]
    outs = launch(_torch_ranks.run_all, 2, args=(calls,), device="cpu",
                  timeout_s=JOIN_S)
    with open(tmp / "sharded.pkl", "rb") as f:
        saved = pickle.load(f)
    with open(tmp / "resume.pkl", "rb") as f:
        resumed = pickle.load(f)
    return outs, saved, resumed


@pytest.fixture(scope="module")
def ranks4():
    calls = [("bucket", "bucket", (BUCKET, ROWS, list(range(8)))),
             ("pad5", "bucket", (BUCKET, ROWS[:5], list(range(5))))]
    return launch(_torch_ranks.run_all, 4, args=(calls,), device="cpu",
                  timeout_s=JOIN_S)


def _step_out(shape, ranks8, ranks2, case):
    outs = ranks8 if shape == (2, 2, 2) else ranks2[0]
    got = [o[f"{shape} {case}"] for o in outs]
    for other in got[1:]:  # every rank holds the same global state
        for k in ("U", "V", "mu_U", "nu_V", "loss"):
            np.testing.assert_array_equal(other[k], got[0][k])
    return got[0]


def test_factor_mesh_matches_jax():
    for n in range(1, 17):
        assert tmesh.factor_mesh(n) == jmesh.factor_mesh(n), n


def _gradient(got, p0, wd):
    """The step's gradient (without decay) from its first moment."""
    return np.asarray(got, np.float64) / (1 - 0.9) - wd * p0.astype(
        np.float64)


def _adam_first_step(p0, g):
    """``adam_update``'s first step from zero moments, in float64."""
    m, v = (1 - 0.9) * g, (1 - 0.999) * g * g
    return p0 - LR * (m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.999)) + 1e-8)


@pytest.mark.parametrize("shape", STEP_MESHES)
def test_sharded_step_matches_jax_sharded_step(shape, ranks8, ranks2):
    """The loss equals JAX's sharded step's; its parameters are the
    port's first Adam step taken from dp x tp times the port's gradient
    (``test_reference_gradient_scale``), with the decay as it is."""
    g_, dp, tp = shape
    got = _step_out(shape, ranks8, ranks2, "wd")
    inp = _inputs(shape)
    want = _jax_sharded(shape, inp, WD)
    np.testing.assert_allclose(got["loss"][0], np.asarray(want["loss"]),
                               rtol=1e-5)
    for k in ("U", "V"):
        p0 = inp[k].astype(np.float64)
        scaled = dp * tp * _gradient(got[f"mu_{k}"], inp[k], WD) + WD * p0
        np.testing.assert_allclose(np.asarray(want[k]),
                                   _adam_first_step(p0, scaled), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("shape", STEP_MESHES)
def test_sharded_step_moments_match_plain_oracle(shape, ranks8, ranks2):
    got = _step_out(shape, ranks8, ranks2, "wd")
    want = _jax_plain(_inputs(shape), WD)
    np.testing.assert_allclose(got["loss"][0], want["loss"], rtol=1e-5)
    for k in ("U", "V"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for k in ("mu_U", "mu_V", "nu_U", "nu_V"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert got["step"].tolist() == [1] * shape[0]


def test_second_step_from_oracle_moments(ranks8):
    """Step 2 of (2, 2, 2) from the oracle's state after step 1: the
    moments accumulate and the bias correction reads the step."""
    shape = (2, 2, 2)
    got = _step_out(shape, ranks8, None, "second")
    inp = _inputs(shape)
    first = _jax_plain(inp, WD)
    want = _jax_plain(dict(inp, U=first["U"], V=first["V"]), WD,
                      opt=first["opt"])
    np.testing.assert_allclose(got["loss"][0], want["loss"], rtol=1e-5)
    for k in ("U", "V"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for k in ("mu_U", "mu_V", "nu_U", "nu_V"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert got["step"].tolist() == [2, 2]


@pytest.mark.parametrize("shape", STEP_MESHES)
def test_reference_gradient_scale(shape, ranks8, ranks2):
    """At wd = 0 JAX's sharded first moment is dp x tp times the port's
    (which is the oracle's), while its loss and parameters agree."""
    g, dp, tp = shape
    got = _step_out(shape, ranks8, ranks2, "wd0")
    want = _jax_sharded(shape, _inputs(shape), 0.0)
    for k in ("mu_U", "mu_V"):
        ref = np.asarray(want[k], np.float64)
        ours = dp * tp * np.asarray(got[k], np.float64)
        np.testing.assert_allclose(ref, ours, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
        ratio = np.linalg.norm(ref) / np.linalg.norm(got[k])
        assert abs(ratio / (dp * tp) - 1) < 1e-5, (k, ratio)
    np.testing.assert_allclose(got["U"], np.asarray(want["U"]), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("shape", STEP_MESHES)
def test_reference_decay_divergence(shape, ranks8, ranks2):
    """At wd > 0 JAX's sharded first moment is (1 - b1) (dp tp g + wd p)
    where the port's (the oracle's) is (1 - b1) (g + wd p).  Its first
    step moves each element by about lr against the sign of that moment,
    so where the two signs differ it moves the other way."""
    g_, dp, tp = shape
    got = _step_out(shape, ranks8, ranks2, "wd")
    inp = _inputs(shape)
    want = _jax_sharded(shape, inp, WD)
    for k in ("U", "V"):
        p0 = inp[k].astype(np.float64)
        decay = (1 - 0.9) * WD * p0
        ours = np.asarray(got[f"mu_{k}"], np.float64)
        ref = np.asarray(want[f"mu_{k}"], np.float64)
        np.testing.assert_allclose(ref, dp * tp * (ours - decay) + decay,
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        flipped = np.sign(ref) != np.sign(ours)
        moved_ref = np.sign(np.asarray(want[k]) - inp[k])
        moved_ours = np.sign(got[k] - inp[k])
        assert np.array_equal(moved_ref != moved_ours, flipped), k


def test_shard_unshard_roundtrip(ranks8):
    inp = _inputs((2, 2, 2))
    want = [inp["U"], inp["u"], np.arange(2, dtype=np.float32)]
    for out in ranks8:
        for got, ref in zip(out["roundtrip"], want, strict=True):
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ranks", [2, 4])
def test_grid_dp_bucket_bit_equal(ranks, plain, ranks2, ranks4):
    outs = ranks2[0] if ranks == 2 else ranks4
    for out in outs:  # every rank returns the whole bucket
        _assert_bit_equal(out["bucket"], plain["bucket"])


def test_grid_dp_bucket_matches_jax(plain, ranks2, ranks4):
    from mfcd_tpu.core.config import RunConfig as JConfig

    want = jbatched.run_bucket(JConfig(**BUCKET), ROWS, list(range(8)),
                               mesh=jbatched.make_sweep_mesh(8))
    for got in (ranks2[0][0]["bucket"], ranks4[0]["bucket"]):
        for a, b in zip(got, want, strict=True):
            for k in RESULT_KEYS:
                for x, y in zip(_flat(a[k]), _flat(b[k]), strict=True):
                    np.testing.assert_allclose(
                        np.asarray(x, np.float64), np.asarray(y, np.float64),
                        rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", ["pad3 over 2", "pad5 over 4"])
def test_padding_is_dropped(case, plain, ranks2, ranks4):
    name = case.split()[0]
    outs = ranks2[0] if name == "pad3" else ranks4
    for out in outs:
        _assert_bit_equal(out[name], plain[name])


@pytest.mark.parametrize("case", ["scan", "chunks of one"])
def test_scan_returns_the_whole_list_on_every_rank(case, plain, ranks2):
    """Chunks of 2 configurations, and chunks of one."""
    for out in ranks2[0]:
        assert [e["params"] for e in out[case]] == \
            [e["params"] for e in plain["scan"]]
        _assert_bit_equal([e["results"] for e in out[case]],
                          [e["results"] for e in plain["scan"]])


def test_scan_save_path_written_by_rank0_and_resume(plain, ranks2):
    outs, saved, resumed = ranks2
    assert [o["save"] for o in outs] == [[], []]
    for got in (saved, resumed):
        assert [e["params"] for e in got] == [e["params"]
                                              for e in plain["scan"]]
        _assert_bit_equal([e["results"] for e in got],
                          [e["results"] for e in plain["scan"]])


def test_mesh_size_must_be_the_world():
    with pytest.raises(RuntimeError, match="initialize"):
        tmesh.make_mesh(device="cpu")
    with pytest.raises(ValueError, match="ranks"):
        tmesh.make_mesh(n_devices=2, device="cpu")
    with pytest.raises(ValueError, match="ranks"):
        tbatched.make_sweep_mesh(n_devices=2, device="cpu")


def test_ranks_agree_on_an_oom_before_bisecting(plain, ranks2):
    """Rank 1 runs out of memory on its block of 2; both ranks bisect the
    chunk of 3 (2 a rank, padded) into blocks of 1, and the scan is the
    unsharded one."""
    for out in ranks2[0]:
        got, sizes = out["oom"]
        assert sizes == [2, 1, 1]
        _assert_bit_equal([e["results"] for e in got],
                          [e["results"] for e in plain["scan"]])
