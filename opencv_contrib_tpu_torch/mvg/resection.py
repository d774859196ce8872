"""Camera resection (PnP) in normalized coordinates — the port of
opencv_contrib_tpu/mvg/resection.py: a masked DLT solve plus a
fixed-iteration Gauss-Newton refinement on SE(3) with analytic Jacobians."""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.core import se3


def pnp_dlt(X: torch.Tensor, xn: torch.Tensor, mask: torch.Tensor | None = None):
    """DLT resection: world points X (..., N, 3), normalized image points xn
    (..., N, 2), mask (..., N). Returns world->cam (R, t). Needs N >= 6 valid
    points."""
    if mask is None:
        mask = torch.ones(X.shape[:-1], dtype=torch.bool, device=X.device)
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)  # (..., N, 4)
    zero = torch.zeros_like(Xh)
    u = xn[..., 0:1]
    v = xn[..., 1:2]
    r1 = torch.cat([Xh, zero, -u * Xh], dim=-1)  # (..., N, 12)
    r2 = torch.cat([zero, Xh, -v * Xh], dim=-1)
    m = torch.cat([mask, mask], dim=-1).to(X.dtype)
    A = torch.cat([r1, r2], dim=-2) * m[..., None]
    # the null vector is the last row of Vh; the thin SVD has it whenever A
    # has at least 12 rows
    _, _, Vh = torch.linalg.svd(A, full_matrices=A.shape[-2] < 12)
    P = Vh[..., -1, :].reshape(Vh.shape[:-2] + (3, 4))
    # sign: the majority of valid points must have positive depth
    depths = torch.einsum("...nj,...j->...n", Xh, P[..., 2, :])
    sign = torch.sign(torch.sum(torch.where(mask, torch.sign(depths), torch.zeros_like(depths)), dim=-1))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    P = P * sign[..., None, None]
    M = P[..., :3]
    S = torch.linalg.svdvals(M)
    scale = torch.mean(S, dim=-1)
    R = se3.project_to_so3(M)
    t = P[..., 3] / torch.clamp(scale, min=1e-12)[..., None]
    return R, t


def reprojection_residuals(R, t, X, xn, mask):
    Xc = se3.rotate_points(R, X) + t
    z = torch.where(torch.abs(Xc[..., 2]) < 1e-9, torch.full_like(Xc[..., 2], 1e-9), Xc[..., 2])
    pred = Xc[..., :2] / z[..., None]
    return (pred - xn) * mask[..., None]


def refine_pose(R, t, X, xn, mask=None, iters: int = 10, damping: float = 1e-6):
    """Gauss-Newton refinement of (R, t) minimizing calibrated reprojection
    error; fixed iteration count, 6x6 normal equations from analytic
    Jacobians of a left-multiplied increment. Returns (R, t, last cost)."""
    if mask is None:
        mask = torch.ones(X.shape[0], dtype=torch.bool, device=X.device)
    mf = mask.to(X.dtype)
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    cost = None
    for _ in range(iters):
        Xc = se3.rotate_points(R, X) + t
        z = torch.where(torch.abs(Xc[..., 2]) < 1e-9, torch.full_like(Xc[..., 2], 1e-9), Xc[..., 2])
        pred = Xc[..., :2] / z[..., None]
        r = (pred - xn) * mf[..., None]  # (N, 2)

        x, y = Xc[..., 0], Xc[..., 1]
        invz = 1.0 / z
        zeros = torch.zeros_like(z)
        J_proj = torch.stack(
            [
                torch.stack([invz, zeros, -x * invz * invz], dim=-1),
                torch.stack([zeros, invz, -y * invz * invz], dim=-1),
            ],
            dim=-2,
        )  # (N, 2, 3)
        # dXc = -[Xc]_x dw + dv
        J_point = torch.cat([-se3.hat(Xc), eye3.expand(Xc.shape[:-1] + (3, 3))], dim=-1)
        J = torch.einsum("nij,njk->nik", J_proj, J_point) * mf[..., None, None]
        JtJ = torch.einsum("nik,nil->kl", J, J)
        Jtr = torch.einsum("nik,ni->k", J, r)
        dx = -torch.linalg.solve_ex(JtJ + damping * eye6, Jtr)[0]
        dR = se3.exp_so3(dx[:3])
        R, t = dR @ R, dR @ t + dx[3:]
        cost = torch.sum(r * r)
    return R, t, cost


def resect(X, xn, mask=None, refine_iters: int = 10):
    """DLT init + Gauss-Newton refine."""
    R0, t0 = pnp_dlt(X, xn, mask)
    return refine_pose(R0, t0, X, xn, mask, iters=refine_iters)
