"""AltSVM pairwise predictor: alternating SVM on comparison data.

Counterpart of ``mfcd_tpu/models/altsvm.py`` (the Draft layer's model),
with the same names and epoch structure: per epoch an item phase (V given
U) and then a user phase (U given V), each a fresh SVM solved by dual
coordinate descent from the zero primal-dual origin over ``sweeps``
keyed permutations of the comparisons, with

    u_i = (1/lambda) sum_{t: user=i} alpha_t p_t (v_{j_t} - v_{k_t}),
    alpha_t in [0, C].

A phase is one launch of the DCD kernel K2 for CUDA tensors, its plain
version for CPU tensors (``ops/altsvm_kernels.py::dcd_phase``).  The keys
are the JAX package's bit for bit (``core/prng.py``), so the visiting
order is the same on both.

Prediction: score(u, j, k) = U[u] . (V[j] - V[k]); the label is the sign.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mfcd_tpu_torch.backend import resolve_device
from mfcd_tpu_torch.core import prng
from mfcd_tpu_torch.ops.altsvm_kernels import dcd_phase


class AltSVMState(NamedTuple):
    user_features: torch.Tensor    # [n_users, f]
    movie_features: torch.Tensor   # [n_movies, f]
    alpha: torch.Tensor            # [T] duals of the user phase, in [0, C]
    beta: torch.Tensor             # [T] duals of the item phase, in [0, C]


def init_altsvm(key, n_users: int, n_movies: int, num_features: int = 20,
                num_comparisons: int = 0, device=None) -> AltSVMState:
    """Normal U and V from the two halves of ``split(key)``, zero duals, on
    ``device`` (``None``: the card)."""
    device = resolve_device(device)
    ku, kv = prng.split(key.to(device)).unbind(-2)
    zeros = torch.zeros(num_comparisons, dtype=torch.float32, device=device)
    return AltSVMState(
        user_features=prng.normal(ku, (n_users, num_features)),
        movie_features=prng.normal(kv, (n_movies, num_features)),
        alpha=zeros, beta=zeros.clone())


def predict(state: AltSVMState, users, movie_j, movie_k) -> torch.Tensor:
    u = state.user_features[users.long()]
    return torch.sum(u * (state.movie_features[movie_j.long()]
                          - state.movie_features[movie_k.long()]), dim=1)


def _picks(key, t: int, sweeps: int) -> torch.Tensor:
    """Random visiting order: ``sweeps`` whole-dataset permutations, int32,
    contiguous (at t = 1 the permutation is a broadcast view)."""
    picks = prng.permutation(prng.split(key, sweeps), t)
    return picks.reshape(-1).contiguous()


def rebuild_users(state, users, movie_j, movie_k, prefs, lam):
    """u_i = (1/lambda) sum alpha_t p_t (v_j - v_k)  (primal from duals)."""
    dv = (state.movie_features[movie_j.long()]
          - state.movie_features[movie_k.long()])
    w = (state.alpha * prefs.to(state.alpha.dtype))[:, None] * dv / lam
    return state._replace(user_features=torch.zeros_like(
        state.user_features).index_add_(0, users.long(), w))


def rebuild_items(state, users, movie_j, movie_k, prefs, lam):
    """v_j (+) / v_k (-) rebuilt from the item-phase duals."""
    w = ((state.beta * prefs.to(state.beta.dtype))[:, None]
         * state.user_features[users.long()] / lam)
    zeros = torch.zeros_like(state.movie_features)
    pos = zeros.index_add(0, movie_j.long(), w)
    neg = zeros.index_add(0, movie_k.long(), w)
    return state._replace(movie_features=pos - neg)


def _comparisons(table, users, movie_j, movie_k, prefs):
    """The comparisons on ``table``'s device: int32 indices, float32
    labels, contiguous."""
    dev = table.device
    ints = (a.to(dev, torch.int32).contiguous()
            for a in (users, movie_j, movie_k))
    return (*ints, prefs.to(dev, torch.float32).contiguous())


def _dcd_users(state, key, users, movie_j, movie_k, prefs, lam, c, sweeps):
    """Dual coordinate descent on the user phase (V fixed)."""
    comps = _comparisons(state.user_features, users, movie_j, movie_k, prefs)
    picks = _picks(key.to(state.user_features.device), prefs.shape[0],
                   sweeps)
    u, alpha = dcd_phase("users", state.user_features, state.movie_features,
                         state.alpha, picks, *comps, lam, c)
    return state._replace(user_features=u, alpha=alpha)


def _dcd_items(state, key, users, movie_j, movie_k, prefs, lam, c, sweeps):
    """Dual coordinate descent on the item phase (U fixed)."""
    comps = _comparisons(state.movie_features, users, movie_j, movie_k,
                         prefs)
    picks = _picks(key.to(state.movie_features.device), prefs.shape[0],
                   sweeps)
    v, beta = dcd_phase("items", state.movie_features, state.user_features,
                        state.beta, picks, *comps, lam, c)
    return state._replace(movie_features=v, beta=beta)


def train_altsvm(
    state: AltSVMState, key,
    users, movie_j, movie_k, prefs,
    num_epochs: int = 10, lambda_reg: float = 0.1, C: float = 1.0,
    sweeps_per_phase: int = 3,
) -> AltSVMState:
    """Alternating SVM training on the state's device.

    Per epoch: solve the item-phase SVM (V given U) by dual coordinate
    descent from the zero-dual origin, then the user-phase SVM (U given
    V).  The very first item phase uses the random U init, as the Draft
    does.  On the card each phase is one launch of K2 (2 x ``num_epochs``
    per call), with the visiting order drawn on the card."""
    dev = state.user_features.device
    comps = _comparisons(state.user_features, users, movie_j, movie_k, prefs)
    for ekey in prng.split(key.to(dev), num_epochs):
        k1, k2 = prng.split(ekey).unbind(-2)
        state = state._replace(
            beta=torch.zeros_like(state.beta),
            movie_features=torch.zeros_like(state.movie_features))
        state = _dcd_items(state, k1, *comps, lambda_reg, C,
                           sweeps_per_phase)
        state = state._replace(
            alpha=torch.zeros_like(state.alpha),
            user_features=torch.zeros_like(state.user_features))
        state = _dcd_users(state, k2, *comps, lambda_reg, C,
                           sweeps_per_phase)
    return state


def pairwise_accuracy(state: AltSVMState, users, movie_j, movie_k, prefs):
    pred = predict(state, users, movie_j, movie_k)
    prefs = prefs.to(pred.device)
    return torch.mean(((pred > 0) == (prefs > 0)).to(torch.float32))
