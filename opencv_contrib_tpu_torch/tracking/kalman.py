"""Kalman filters: the linear KF, the unscented KF (UKF) and the augmented
UKF (the port of opencv_contrib_tpu/tracking/kalman.py).

Parity: tracking's kalman_filters.hpp / unscented_kalman.cpp /
augmented_unscented_kalman.cpp: the Merwe-scaled UKF with its sigma points
propagated through `torch.func.vmap` of the caller's f and h. The
factorizations are the `_ex` forms (`cholesky_ex`, `inv_ex`), which leave
their status on the device: the checked forms read it on the host, a sync a
call on the card.

The UKF computes in float64 and returns the state's dtype: Merwe's alpha
= 1e-3 puts a weight of about -1e6 on the centre point, where float32
cancels to 0.1-0.5 of a state a step (the twin's float32 run and the
port's, CPU or card, part from a float64 run by that much, and on the card
one run missed the JAX test's 0.15 gate); its f and h are called on float64
tensors. The augmented UKF takes alpha = 1 and keeps the state's dtype.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import vmap


class KalmanState(NamedTuple):
    x: torch.Tensor  # (n,)
    P: torch.Tensor  # (n, n)


def _inv(S):
    return torch.linalg.inv_ex(S)[0]


def kf_predict(state: KalmanState, F: torch.Tensor, Q: torch.Tensor, B=None, u=None) -> KalmanState:
    x = F @ state.x
    if B is not None and u is not None:
        x = x + B @ u
    P = F @ state.P @ F.T + Q
    return KalmanState(x, P)


def kf_correct(state: KalmanState, z: torch.Tensor, Hm: torch.Tensor, R: torch.Tensor) -> KalmanState:
    S = Hm @ state.P @ Hm.T + R
    K = state.P @ Hm.T @ _inv(S)
    x = state.x + K @ (z - Hm @ state.x)
    P = (torch.eye(state.x.shape[0], dtype=state.x.dtype, device=state.x.device) - K @ Hm) @ state.P
    return KalmanState(x, P)


def _sigma_points(x, P, alpha=1e-3, beta=2.0, kappa=0.0):
    n = x.shape[0]
    lam = alpha * alpha * (n + kappa) - n
    like = dict(dtype=x.dtype, device=x.device)
    S = torch.linalg.cholesky_ex((n + lam) * (P + 1e-9 * torch.eye(n, **like)))[0]
    pts = torch.cat([x[None], x[None] + S.T, x[None] - S.T], dim=0)  # (2n+1, n)
    wm = torch.cat([torch.full((1,), lam / (n + lam), **like), torch.full((2 * n,), 1.0 / (2 * (n + lam)), **like)])
    wc = wm + torch.cat([torch.full((1,), 1.0 - alpha * alpha + beta, **like), torch.zeros(2 * n, **like)])
    return pts, wm, wc


def _f64(state: KalmanState, *more):
    return (KalmanState(state.x.to(torch.float64), state.P.to(torch.float64)),
            *(m.to(torch.float64) for m in more))


def _back(out: KalmanState, like: KalmanState) -> KalmanState:
    return KalmanState(out.x.to(like.x.dtype), out.P.to(like.P.dtype))


def ukf_predict(state: KalmanState, f: Callable, Q: torch.Tensor) -> KalmanState:
    st, Q64 = _f64(state, Q)
    pts, wm, wc = _sigma_points(st.x, st.P)
    prop = vmap(f)(pts)
    x = torch.einsum("i,ij->j", wm, prop)
    d = prop - x[None]
    P = torch.einsum("i,ij,ik->jk", wc, d, d) + Q64
    return _back(KalmanState(x, P), state)


def ukf_correct(state: KalmanState, z: torch.Tensor, h: Callable, R: torch.Tensor) -> KalmanState:
    st0 = state
    state, z, R = _f64(state, z, R)
    pts, wm, wc = _sigma_points(state.x, state.P)
    Z = vmap(h)(pts)
    z_pred = torch.einsum("i,ij->j", wm, Z)
    dz = Z - z_pred[None]
    dx = pts - state.x[None]
    S = torch.einsum("i,ij,ik->jk", wc, dz, dz) + R
    C = torch.einsum("i,ij,ik->jk", wc, dx, dz)
    K = C @ _inv(S)
    x = state.x + K @ (z - z_pred)
    P = state.P - K @ S @ K.T
    return _back(KalmanState(x, P), st0)


# --- Augmented UKF (augmented_unscented_kalman.cpp): non-additive noise ---
# The state is augmented with process/measurement noise components so sigma
# points carry noise realizations through f(x, q) / h(x, r) directly.


def aukf_predict(state: KalmanState, f: Callable, Q: torch.Tensor) -> KalmanState:
    """f(x, q) -> x'. Sigma points drawn over the (x, q) augmented state,
    with alpha = 1 (the Julier set: Merwe's 1e-3 cancels catastrophically in
    float32 on the enlarged state)."""
    n = state.x.shape[0]
    q = Q.shape[0]
    xa = torch.cat([state.x, torch.zeros(q, dtype=state.x.dtype, device=state.x.device)])
    Pa = torch.block_diag(state.P, Q)
    pts, wm, wc = _sigma_points(xa, Pa, alpha=1.0)
    prop = vmap(lambda p: f(p[:n], p[n:]))(pts)
    x = torch.einsum("i,ij->j", wm, prop)
    d = prop - x[None]
    P = torch.einsum("i,ij,ik->jk", wc, d, d)
    return KalmanState(x, P)


def aukf_correct(state: KalmanState, z: torch.Tensor, h: Callable, R: torch.Tensor) -> KalmanState:
    """h(x, r) -> z_pred. Sigma points over the (x, r) augmented state."""
    n = state.x.shape[0]
    r = R.shape[0]
    xa = torch.cat([state.x, torch.zeros(r, dtype=state.x.dtype, device=state.x.device)])
    Pa = torch.block_diag(state.P, R)
    pts, wm, wc = _sigma_points(xa, Pa, alpha=1.0)
    Z = vmap(lambda p: h(p[:n], p[n:]))(pts)
    z_pred = torch.einsum("i,ij->j", wm, Z)
    dz = Z - z_pred[None]
    dx = pts[:, :n] - state.x[None]
    S = torch.einsum("i,ij,ik->jk", wc, dz, dz)
    C = torch.einsum("i,ij,ik->jk", wc, dx, dz)
    K = C @ _inv(S)
    x = state.x + K @ (z - z_pred)
    P = state.P - K @ S @ K.T
    return KalmanState(x, P)
