"""The port's AltSVM (``mfcd_tpu_torch/models/altsvm.py``, its phase kernel's
plain version ``ops/altsvm_kernels.py``, ``core/prng.permutation``) against
``mfcd_tpu/models/altsvm.py`` on the CPU, at ``tests/test_legacy.py``'s
shape (12 users, 15 movies, f = 4, 600 planted comparisons).

Bounds.  Keys, permutations and visiting orders are integer paths:
bit-equal.  Normals: ``tests/test_torch_rng.py``'s 5e-7.  A phase is a
chain of 1,800 dependent coordinate steps whose two dots the port sums in
the kernel's butterfly order and XLA in its own, so one phase from the same
state agrees within 1e-5 x max|ref| + 1e-6 per tensor (measured: 3.0e-7).
Over whole epochs each phase starts from the other's output and the clip at
0 and C turns last-bit differences into different active sets: JAX itself,
given U's init one ulp up, moves by 1.1e-6 (2 epochs) and 2.6e-3 (8
epochs) of max|alpha|, and the port by 3.9e-6 and 4.0e-3.  So 2 epochs
agree within 5e-5 x max|ref| per tensor, 8 epochs within 2e-2 x max|ref|,
with the accuracy above 0.8 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfcd_tpu.models import altsvm as J
from mfcd_tpu_torch.convert import altsvm_state_from_jax, key_from_jax
from mfcd_tpu_torch.core import prng
from mfcd_tpu_torch.models import altsvm as T
from mfcd_tpu_torch.ops import altsvm_kernels as AK

torch.set_num_threads(1)

N_USERS, N_MOVIES, F, NT = 12, 15, 4, 600
LAM, C, SWEEPS = 0.1, 1.0, 3
PHASE_RTOL, PHASE_ATOL = 1e-5, 1e-6


def _planted(seed=0):
    """``tests/test_legacy.py``'s planted comparisons."""
    rng = np.random.default_rng(seed)
    u_true = rng.normal(size=(N_USERS, F))
    v_true = rng.normal(size=(N_MOVIES, F))
    users = rng.integers(0, N_USERS, NT)
    mj = rng.integers(0, N_MOVIES, NT)
    mk = (mj + 1 + rng.integers(0, N_MOVIES - 1, NT)) % N_MOVIES
    scores = np.sum(u_true[users] * (v_true[mj] - v_true[mk]), axis=1)
    return users, mj, mk, np.sign(scores).astype(np.int32)


DATA = _planted()
JDATA = tuple(jnp.asarray(a) for a in DATA)
TDATA = tuple(torch.as_tensor(a) for a in DATA)


def _jax_state():
    return J.init_altsvm(jax.random.key(0), N_USERS, N_MOVIES,
                         num_features=F, num_comparisons=NT)


def _port(state):
    return altsvm_state_from_jax(*(np.asarray(a) for a in state))


def _within(want, got, rtol, atol=0.0):
    for name, a, b in zip(J.AltSVMState._fields, want, got):
        a = np.asarray(a)
        b = b.numpy()
        assert a.shape == b.shape, name
        err = float(np.max(np.abs(a - b)))
        bound = rtol * float(np.max(np.abs(a))) + atol
        assert err <= bound, (name, err, bound)


@pytest.mark.parametrize("t", [1, 2, 1625, 1626, 5000])
def test_permutation_bit_equal(t):
    """One round up to t = 1625, two from 1626; equal 32-bit sort keys keep
    their order (stable), as in ``lax.sort_key_val``."""
    for seed in (0, 7):
        want = np.asarray(jax.random.permutation(jax.random.key(seed), t))
        got = prng.permutation(prng.key(seed), t)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    keys = jax.random.split(jax.random.key(3), 4)
    want = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, t))(keys))
    got = prng.permutation(key_from_jax(jax.random.key_data(keys)), t)
    np.testing.assert_array_equal(got.numpy(), want)


def test_picks_bit_equal():
    for seed in (1, 5):
        want = np.asarray(J._picks(jax.random.key(seed), NT, SWEEPS))
        got = T._picks(prng.key(seed), NT, SWEEPS)
        np.testing.assert_array_equal(got.numpy(), want)
        assert sorted(got[:NT].tolist()) == list(range(NT))


def test_init_allclose():
    want = _jax_state()
    got = T.init_altsvm(prng.key(0), N_USERS, N_MOVIES, num_features=F,
                        num_comparisons=NT, device="cpu")
    for name, a, b in zip(J.AltSVMState._fields, want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=5e-7, err_msg=name)
    assert got.alpha.dtype == torch.float32 and not got.alpha.any()


@pytest.mark.parametrize("phase", ["_dcd_items", "_dcd_users"])
def test_one_phase_allclose(phase):
    """One phase from one state; the port's inputs stay as they were."""
    state = _jax_state()
    want = getattr(J, phase)(state, jax.random.key(3), *JDATA, LAM, C,
                             SWEEPS)
    port = _port(state)
    before = [a.clone() for a in port]
    launches = dict(AK.DCD_LAUNCHES)
    got = getattr(T, phase)(port, prng.key(3), *TDATA, LAM, C, SWEEPS)
    assert AK.DCD_LAUNCHES == launches  # CPU tensors: the plain version
    _within(want, got, PHASE_RTOL, PHASE_ATOL)
    for a, b in zip(before, port):
        assert torch.equal(a, b)


@pytest.mark.parametrize("epochs, rtol", [(2, 5e-5), (8, 2e-2)])
def test_train_altsvm_allclose(epochs, rtol):
    state = _jax_state()
    want = J.train_altsvm(state, jax.random.key(1), *JDATA,
                          num_epochs=epochs)
    got = T.train_altsvm(_port(state), prng.key(1), *TDATA,
                         num_epochs=epochs)
    _within(want, got, rtol)
    acc_j = float(J.pairwise_accuracy(want, *JDATA))
    acc_t = float(T.pairwise_accuracy(got, *TDATA))
    assert abs(acc_j - acc_t) <= 1.0 / NT + 1e-6
    if epochs == 8:
        assert acc_t > 0.8 and acc_j > 0.8


def test_predict_and_accuracy_equal():
    state = J._dcd_items(_jax_state(), jax.random.key(4), *JDATA, LAM, C,
                         SWEEPS)
    port = _port(state)
    want = np.asarray(J.predict(state, *JDATA[:3]))
    got = T.predict(port, *TDATA[:3])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert float(T.pairwise_accuracy(port, *TDATA)) == float(
        J.pairwise_accuracy(state, *JDATA))


def test_rebuild_allclose():
    """Both rebuilds against JAX from one state; and the primal-dual
    relation: after a user (item) phase from the zero origin, rebuilding U
    (V) from the duals gives the phase's U (V) back."""
    state = _jax_state()
    state = J._dcd_items(state._replace(
        movie_features=jnp.zeros_like(state.movie_features)),
        jax.random.key(6), *JDATA, LAM, C, SWEEPS)
    state = J._dcd_users(state._replace(
        user_features=jnp.zeros_like(state.user_features)),
        jax.random.key(7), *JDATA, LAM, C, SWEEPS)
    port = _port(state)
    for fn in ("rebuild_users", "rebuild_items"):
        want = getattr(J, fn)(state, *JDATA, LAM)
        got = getattr(T, fn)(port, *TDATA, LAM)
        _within(want, got, 1e-5, 1e-6)

    port = _port(_jax_state())
    port = port._replace(user_features=torch.zeros_like(port.user_features))
    port = T._dcd_users(port, prng.key(8), *TDATA, LAM, C, SWEEPS)
    rebuilt = T.rebuild_users(port, *TDATA, LAM)
    torch.testing.assert_close(rebuilt.user_features, port.user_features,
                               rtol=1e-5, atol=1e-5)
    port = port._replace(movie_features=torch.zeros_like(
        port.movie_features))
    port = T._dcd_items(port, prng.key(9), *TDATA, LAM, C, SWEEPS)
    rebuilt = T.rebuild_items(port, *TDATA, LAM)
    torch.testing.assert_close(rebuilt.movie_features, port.movie_features,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("f", [4, 20, 33, 70])
def test_warp_dot_sums_in_the_kernels_order(f):
    """Lane l of a step's group sums components l, l + GROUP, ... from 0,
    then the GROUP lanes fold in halves: bit-equal to that order in numpy
    float32, and within float32 rounding of the float64 dot."""
    g = np.random.default_rng(f)
    a, b = (g.standard_normal(f).astype(np.float32) for _ in range(2))
    width = AK.GROUP
    lanes = np.zeros(width, np.float32)
    prod = np.zeros(-(-f // width) * width, np.float32)
    prod[:f] = a * b
    for part in prod.reshape(-1, width):
        lanes = lanes + part
    while lanes.size > 1:
        lanes = lanes[:lanes.size // 2] + lanes[lanes.size // 2:]
    got = AK.warp_dot(torch.from_numpy(a), torch.from_numpy(b))
    assert got.item() == lanes[0]
    assert abs(got.item() - float(np.dot(a.astype(np.float64), b))) <= \
        1e-6 * float(np.abs(a.astype(np.float64) * b).sum())


def test_dcd_phase_rejects():
    z = torch.zeros(3, 2)
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown phase"):
        AK.dcd_phase("both", z, z, torch.zeros(3), idx, idx, idx, idx,
                     torch.ones(3), LAM, C)
    meta = torch.zeros(3, 2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        AK.dcd_phase("users", meta, meta, torch.zeros(3, device="meta"), idx,
                     idx, idx, idx, torch.ones(3), LAM, C)


def test_init_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_altsvm(prng.key(0), 3, 4, num_features=2)
