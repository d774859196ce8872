"""Least-squares phase unwrapping via the DCT (Ghiglia & Romero 1994), the
port of opencv_contrib_tpu/phase_unwrapping/unwrap.py. The 2D DCT is two
dense products with orthonormal DCT-II matrices built in float64 numpy and
kept for each size and device. The wrapped differences are the twin's
float32; the transform, the Poisson division and the inverse run in
float64, and the result is rounded to float32. In float32 (the twin's
products) the low frequencies, divided by denominators down to ~2e-5 at
VGA, carry the products' rounding: the ramp 0.3 x + 0.15 y unwraps with 0.052
rad of spread at 480 x 640 against 5e-6 in float64."""

from __future__ import annotations

import math

import numpy as np
import torch

from opencv_contrib_tpu_torch.utils.device import constant

_DCT = {}  # (n, device) -> the (n, n) DCT-II matrix


def wrap(phi: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi]."""
    return torch.remainder(phi + math.pi, 2 * math.pi) - math.pi


def _dct_matrix(n: int, device) -> torch.Tensor:
    key = (n, str(torch.device(device)))
    if key not in _DCT:
        k = np.arange(n)[:, None]
        i = np.arange(n)[None, :]
        M = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * i + 1) * k / (2 * n))
        M[0] /= np.sqrt(2.0)
        _DCT[key] = constant(M, device, dtype=torch.float64)
    return _DCT[key]


def _dct2(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal 2D DCT-II as two matrix products."""
    N, M = x.shape
    return _dct_matrix(N, x.device) @ x @ _dct_matrix(M, x.device).T


def _idct2(X: torch.Tensor) -> torch.Tensor:
    N, M = X.shape
    return _dct_matrix(N, X.device).T @ X @ _dct_matrix(M, X.device)


def unwrap_phase_dct(psi: torch.Tensor) -> torch.Tensor:
    """Unwrap a wrapped phase map psi (H, W) in radians.

    Solves the discrete Poisson equation with Neumann boundary conditions:
    lap(phi) = rho, where rho is built from wrapped phase differences. The
    result has zero mean (the DC term is the gauge). float32 in and out."""
    psi = psi.to(torch.float32)
    H, W = psi.shape
    # wrapped forward differences (zero at the far boundary via append)
    dy = wrap(torch.diff(psi, dim=0, append=psi[-1:]))
    dx = wrap(torch.diff(psi, dim=1, append=psi[:, -1:]))
    # backward-difference divergence of the wrapped gradient field
    dy2 = torch.cat([dy[:1], dy[1:] - dy[:-1]], dim=0)
    dx2 = torch.cat([dx[:, :1], dx[:, 1:] - dx[:, :-1]], dim=1)
    rho = (dy2 + dx2).to(torch.float64)
    D = _dct2(rho)
    i = torch.arange(H, dtype=torch.float64, device=psi.device)[:, None]
    j = torch.arange(W, dtype=torch.float64, device=psi.device)[None, :]
    denom = 2.0 * (torch.cos(math.pi * i / H) + torch.cos(math.pi * j / W) - 2.0)
    denom = torch.where(torch.abs(denom) < 1e-9, torch.ones_like(denom), denom)
    Phi = D / denom
    Phi[0, 0].fill_(0.0)  # gauge: zero mean
    return _idct2(Phi).to(torch.float32)
