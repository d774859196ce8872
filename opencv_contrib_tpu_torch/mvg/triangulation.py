"""N-view triangulation — the port of opencv_contrib_tpu/mvg/triangulation.py.

A fixed view count with a per-view validity mask: the whole (points x views)
problem is one batched QR and one batched 4x4 SVD, and the Gauss-Newton
polish solves (N, 3, 3) systems with closed-form Jacobians.
"""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.mvg.fundamental import _smallest_singular_vector


def _safe(w: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(torch.abs(w) < eps, torch.full_like(w, eps), w)


def triangulate_dlt(pts2d: torch.Tensor, Ps: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """DLT triangulation from V views: pts2d (..., V, 2), Ps (..., V, 3, 4),
    mask (..., V) valid-view flags -> X (..., 3). Invalid views contribute
    zero rows."""
    if mask is None:
        mask = torch.ones(pts2d.shape[:-1], dtype=torch.bool, device=pts2d.device)
    u = pts2d[..., 0:1]
    v = pts2d[..., 1:2]
    rows = torch.cat([u * Ps[..., 2, :] - Ps[..., 0, :], v * Ps[..., 2, :] - Ps[..., 1, :]], dim=-2)  # (..., 2V, 4)
    m2 = torch.cat([mask, mask], dim=-1).to(rows.dtype)[..., None]
    # row normalization equilibrates the system (f32 accuracy in badly
    # scaled projective frames)
    norm = torch.linalg.norm(rows, dim=-1, keepdim=True)
    rows = rows / torch.clamp(norm, min=1e-12) * m2
    X = _smallest_singular_vector(rows)
    return X[..., :3] / _safe(X[..., 3:], 1e-12)


def _per_point(pts2d, Ps, mask):
    N, V = pts2d.shape[0], pts2d.shape[1]
    if Ps.ndim == 3:
        Ps = Ps.expand(N, V, 3, 4)
    if mask is None:
        mask = torch.ones((N, V), dtype=torch.bool, device=pts2d.device)
    return Ps, mask


def triangulate_points(pts2d: torch.Tensor, Ps: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Batched DLT: pts2d (N, V, 2), Ps (V, 3, 4) or (N, V, 3, 4), mask
    (N, V) -> X (N, 3)."""
    Ps, mask = _per_point(pts2d, Ps, mask)
    return triangulate_dlt(pts2d, Ps, mask)


def refine_points(pts2d: torch.Tensor, Ps: torch.Tensor, X0: torch.Tensor, mask: torch.Tensor | None = None,
                  iters: int = 5) -> torch.Tensor:
    """Per-point Gauss-Newton refinement of triangulated points, minimizing
    the reprojection error over all valid views (libmv EuclideanIntersect's
    per-point refine). pts2d (N, V, 2), Ps (V, 3, 4) or (N, V, 3, 4), X0
    (N, 3) -> (N, 3)."""
    Ps, mask = _per_point(pts2d, Ps, mask)
    m = mask.to(pts2d.dtype)[..., None]  # (N, V, 1)
    M, p = Ps[..., :3], Ps[..., 3]  # (N, V, 3, 3), (N, V, 3)
    eye = 1e-8 * torch.eye(3, dtype=X0.dtype, device=X0.device)
    X = X0
    for _ in range(iters):
        y = torch.einsum("nvij,nj->nvi", M, X) + p
        clamped = torch.abs(y[..., 2:]) < 1e-12
        w = torch.where(clamped, torch.full_like(y[..., 2:], 1e-12), y[..., 2:])
        r = (y[..., :2] / w - pts2d) * m  # (N, V, 2)
        # d (y[:2] / w) / dX; a clamped w is a constant
        dw = torch.where(clamped, torch.zeros_like(w), y[..., :2] / (w * w))  # (N, V, 2)
        J = (M[..., :2, :] / w[..., None] - dw[..., None] * M[..., 2:3, :]) * m[..., None]  # (N, V, 2, 3)
        H = torch.einsum("nvki,nvkj->nij", J, J) + eye
        g = torch.einsum("nvki,nvk->ni", J, r)
        X = X - torch.linalg.solve_ex(H, g)[0]
    return X


def triangulate_points_refined(pts2d, Ps, mask=None, iters: int = 5):
    """DLT + Gauss-Newton polish — the default high-accuracy entry point."""
    X0 = triangulate_points(pts2d, Ps, mask)
    return refine_points(pts2d, Ps, X0, mask, iters)


def triangulate_midpoint_two_view(x1n: torch.Tensor, x2n: torch.Tensor, R: torch.Tensor,
                                  t: torch.Tensor) -> torch.Tensor:
    """Closed-form two-view midpoint triangulation in calibrated coords:
    camera 1 at the identity, camera 2 at (R, t) world->cam; x1n / x2n (N, 2)."""
    d1 = torch.cat([x1n, torch.ones_like(x1n[..., :1])], dim=-1)
    d2 = torch.einsum("ji,nj->ni", R, torch.cat([x2n, torch.ones_like(x2n[..., :1])], dim=-1))
    o2 = -torch.einsum("ji,j->i", R, t)

    # minimize |s d1 - (o2 + u d2)|^2 over (s, u)
    a = torch.sum(d1 * d1, dim=-1)
    b = -torch.sum(d1 * d2, dim=-1)
    c = torch.sum(d2 * d2, dim=-1)
    e1 = torch.sum(d1 * o2[None], dim=-1)
    e2 = -torch.sum(d2 * o2[None], dim=-1)
    det = _safe(a * c - b * b, 1e-12)
    s = (c * e1 - b * e2) / det
    u = (a * e2 - b * e1) / det
    p1 = d1 * s[..., None]
    p2 = o2[None] + d2 * u[..., None]
    return 0.5 * (p1 + p2)
