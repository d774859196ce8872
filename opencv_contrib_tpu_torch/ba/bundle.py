"""Schur-complement Levenberg-Marquardt bundle adjustment — the port of
opencv_contrib_tpu/ba/bundle.py.

Layout: cameras (C, 6) [angle-axis | t], points (P, 3), shared intrinsics
(9,), a dense observation grid (C, P, 2) with a mask (C, P). Each step
eliminates the points (S = U - W V^-1 W^T), solves the reduced camera system
(optionally with the shared-intrinsics block) densely or by Schur-Jacobi
preconditioned CG, back-substitutes the points, and accepts or rejects the
step on the device (no host round trip per iteration).

The per-observation Jacobians are analytic: the derivative of the Rodrigues
map is taken through the same Taylor / closed-form branches as `exp_so3`,
which is what `jax.jacfwd` of the JAX version differentiates.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_contrib_tpu_torch.core import camera as cam
from opencv_contrib_tpu_torch.core import se3
from opencv_contrib_tpu_torch.utils.precision import f32_matmuls


class BAProblem(NamedTuple):
    cameras: torch.Tensor  # (C, 6) [rvec | tvec]
    points: torch.Tensor  # (P, 3)
    intr: torch.Tensor  # (9,)
    obs: torch.Tensor  # (C, P, 2) pixel observations
    mask: torch.Tensor  # (C, P) bool


class BAResult(NamedTuple):
    cameras: torch.Tensor
    points: torch.Tensor
    intr: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    lam_history: torch.Tensor


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def _small_mm(a, b):
    """a (..., m, k) @ b (..., k, n) for small m, k, n, as broadcast products
    and a sum: over a batch of millions of 2x3 factors a batched GEMM spends
    a tile on each (4.3 ms against 0.24 at 2.2 M on an H100)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def _project(pose, X, intr, jacobians: bool = False, intr_jac: bool = False):
    """Project points X (..., 3) by cameras `pose` (..., 6) [angle-axis | t],
    the two broadcast against each other: pred (..., 2). With `jacobians`,
    also d pred / d camera (..., 2, 6) and d pred / d point (..., 2, 3); with
    `intr_jac`, d pred / d intr (..., 2, 9). The dense grid passes
    cameras[:, None] against points[None]; the sparse solver (ba/sparse.py)
    its cameras against the points of their observations. A depth under
    1e-9 is clamped to 1e-9 and is then a constant."""
    w, tv = pose[..., :3], pose[..., 3:]
    A, B, dA, dB = se3.so3_coeffs(torch.sum(w * w, dim=-1))
    Wm = se3.hat(w)
    I3 = torch.eye(3, dtype=w.dtype, device=w.device)
    R = I3 + A[..., None, None] * Wm + B[..., None, None] * _small_mm(Wm, Wm)  # (..., 3, 3) at the cameras' shape
    Xc = torch.einsum("...ij,...j->...i", R, X) + tv
    z = Xc[..., 2]
    small = torch.abs(z) < 1e-9
    zs = torch.where(small, torch.full_like(z, 1e-9), z)
    xn = Xc[..., :2] / zs[..., None]
    pred = cam.denormalize_points(intr, xn)
    if not jacobians:
        return pred, None, None, None

    x, y = xn[..., 0], xn[..., 1]
    fx, fy = intr[cam.FX], intr[cam.FY]
    k1, k2, k3, p1, p2 = intr[cam.K1], intr[cam.K2], intr[cam.K3], intr[cam.P1], intr[cam.P2]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    drad = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)  # d radial / d r2
    # d distorted / d normalized (..., 2, 2)
    dxx = radial + 2.0 * x * x * drad + 2.0 * p1 * y + 6.0 * p2 * x
    dxy = 2.0 * x * y * drad + 2.0 * p1 * x + 2.0 * p2 * y
    dyx = 2.0 * x * y * drad + 2.0 * p1 * x + 2.0 * p2 * y
    dyy = radial + 2.0 * y * y * drad + 6.0 * p1 * y + 2.0 * p2 * x
    # d normalized / d Xc (the clamped depth is a constant)
    invz = 1.0 / zs
    dz = torch.where(small, torch.zeros_like(z), torch.ones_like(z))
    nx = -x * invz * dz
    ny = -y * invz * dz
    zero = torch.zeros_like(z)
    Jn = torch.stack([torch.stack([invz, zero, nx], -1), torch.stack([zero, invz, ny], -1)], -2)
    Jd = torch.stack([torch.stack([fx * dxx, fx * dxy], -1), torch.stack([fy * dyx, fy * dyy], -1)], -2)
    J_X = _small_mm(Jd, Jn)  # d pred / d Xc (..., 2, 3)

    # d (R(w) X) / d w for R = I + A [w]x + B [w]x^2
    wxX = _cross(w, X)
    wwX = _cross(w, wxX)
    wX = torch.sum(w * X, dim=-1)
    M = (wX[..., None, None] * I3 + w[..., :, None] * X[..., None, :]
         - 2.0 * X[..., :, None] * w[..., None, :])
    dAw = (2.0 * dA)[..., None] * w
    dBw = (2.0 * dB)[..., None] * w
    J_w = (wxX[..., :, None] * dAw[..., None, :]
           - A[..., None, None] * se3.hat(X).expand(wxX.shape + (3,))
           + wwX[..., :, None] * dBw[..., None, :]
           + B[..., None, None] * M)  # (..., 3, 3)
    Jc = torch.cat([_small_mm(J_X, J_w), J_X], dim=-1)  # (..., 2, 6)
    Jp = _small_mm(J_X, R)  # (..., 2, 3)

    Ji = None
    if intr_jac:
        xd = torch.stack([x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x),
                          y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y], -1)
        one = torch.ones_like(x)
        rx = [zero, zero, zero, zero, x * r2, x * r2 * r2, x * r2 * r2 * r2, 2.0 * x * y, r2 + 2.0 * x * x]
        ry = [zero, zero, zero, zero, y * r2, y * r2 * r2, y * r2 * r2 * r2, r2 + 2.0 * y * y, 2.0 * x * y]
        row_x = [xd[..., 0], zero, one, zero] + [fx * v for v in rx[4:]]
        row_y = [zero, xd[..., 1], zero, one] + [fy * v for v in ry[4:]]
        Ji = torch.stack([torch.stack(row_x, -1), torch.stack(row_y, -1)], -2)  # (..., 2, 9)
    return pred, Jc, Jp, Ji


def residuals(cameras, points, intr, obs, mask):
    """Masked residual grid (C, P, 2)."""
    pred = _project(cameras[:, None], points[None], intr)[0]
    return (pred - obs) * mask[..., None]


def cost(cameras, points, intr, obs, mask):
    r = residuals(cameras, points, intr, obs, mask)
    return 0.5 * torch.sum(r * r)


def rms_reprojection_error(cameras, points, intr, obs, mask):
    """RMS pixel reprojection error over valid observations."""
    r = residuals(cameras, points, intr, obs, mask)
    n = torch.clamp(torch.sum(mask), min=1)
    return torch.sqrt(torch.sum(r * r) / n)


class Sums:
    """The reductions of a solve that holds the whole observation grid:
    every sum is complete and every block whole, so each is the identity.
    parallel/dist_ba.py passes the solver its mesh's version, which sums
    the partials of a rank's (cameras, points) block over the point shards
    ("sp"), the camera shards ("dp") or both, and gathers shards, where
    GSPMD places the collectives of the JAX package's sharded solve."""

    cams = pts = slice(None)  # this rank's block of the (C, P) grid

    def over_points(self, x):  # per-camera sums: add the point shards' partials
        return x

    def over_cams(self, x):  # per-point sums: add the camera shards' partials
        return x

    def total(self, x):  # sums over the whole grid
        return x

    def all_cams(self, x):  # camera-sharded dim 0 -> every camera
        return x

    def all_points(self, x):  # point-sharded dim 0 -> every point
        return x


LOCAL = Sums()


def _per_obs_jacobians(cameras, points, intr, obs, mask, optimize_intr: bool):
    """r (C,P,2), Jc (C,P,2,6), Jp (C,P,2,3), Ji (C,P,2,9) or None; masked."""
    pred, Jc, Jp, Ji = _project(cameras[:, None], points[None], intr, jacobians=True, intr_jac=optimize_intr)
    m3 = mask[..., None].to(pred.dtype)
    m4 = m3[..., None]
    r = (pred - obs) * m3
    return r, Jc * m4, Jp * m4, (Ji * m4 if Ji is not None else None)


def _normal_blocks(r, Jc, Jp, lam, pt_free, sums: Sums = LOCAL):
    """Damped U (C,6,6), V^-1 (P,3,3), W (C,P,6,3), Y = W V^-1, bc, bp of
    the block's cameras and points (`sums` completes U, V, bc and bp)."""
    U = sums.over_points(torch.einsum("cpki,cpkj->cij", Jc, Jc))
    V = sums.over_cams(torch.einsum("cpki,cpkj->pij", Jp, Jp))
    W = torch.einsum("cpki,cpkj->cpij", Jc, Jp)
    bc = sums.over_points(-torch.einsum("cpki,cpk->ci", Jc, r))
    bp = sums.over_cams(-torch.einsum("cpki,cpk->pi", Jp, r))
    # LM damping, multiplicative on the diagonal
    dU = torch.clamp(torch.diagonal(U, dim1=1, dim2=2), min=1e-6)
    dV = torch.clamp(torch.diagonal(V, dim1=1, dim2=2), min=1e-6)
    U = U + torch.diag_embed(lam * dU)
    V = V + torch.diag_embed(lam * dV)
    # frozen points get a huge V, so no update leaks into them
    eye3 = torch.eye(3, dtype=r.dtype, device=r.device)
    Vinv = torch.linalg.inv(V + (~pt_free).to(r.dtype)[:, None, None] * eye3 * 1e12)
    Y = torch.einsum("cpij,pjk->cpik", W, Vinv)
    return U, Vinv, W, Y, bc, bp


def _solve_schur(r, Jc, Jp, lam, cam_free, pt_free, Ji=None, intr_sel=None, intr_tie=None, sums: Sums = LOCAL):
    """One damped explicit-Schur step; with Ji the shared intrinsics enter
    the reduced system as one extra block (intr_sel selects free
    components, intr_tie maps the reduced parameters to the full 9).
    r, Jc, Jp (and Ji) hold the block's observations, cam_free every
    camera, pt_free the block's points. Returns (dcam (C,6) for every
    camera, dpt (P,3) for the block's points, dintr (9,))."""
    dt, dev = r.dtype, r.device
    U, Vinv, W, Y, bc, bp = _normal_blocks(r, Jc, Jp, lam, pt_free, sums)
    U, W, Y, bc = (sums.all_cams(x) for x in (U, W, Y, bc))  # every camera against the block's points
    C = U.shape[0]

    S = -sums.over_points(torch.einsum("apik,bpjk->aibj", Y, W))  # (C, 6, C, 6)
    idx = torch.arange(C, device=dev)
    S[idx, :, idx, :] += U
    rhs = bc - sums.over_points(torch.einsum("cpik,pk->ci", Y, bp))

    # frozen cameras: identity rows/cols, zero rhs
    free = cam_free.to(dt)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    Sm = S * free[:, None, None, None] * free[None, None, :, None]
    Sm[idx, :, idx, :] += (1.0 - free)[:, None, None] * eye6
    rhs = rhs * free[:, None]

    n = C * 6
    if Ji is not None:
        sel = intr_sel.to(dt) if intr_sel is not None else torch.ones(9, dtype=dt, device=dev)
        if intr_tie is not None:
            Ji = torch.einsum("cpka,ab->cpkb", Ji, intr_tie)
        Ji = Ji * sel
        A_ii = sums.total(torch.einsum("cpki,cpkj->ij", Ji, Ji))
        A_ci = sums.all_cams(sums.over_points(torch.einsum("cpki,cpkj->cij", Jc, Ji)))
        Bi = sums.over_cams(torch.einsum("cpki,cpkj->pij", Ji, Jp))
        b_i = sums.total(-torch.einsum("cpki,cpk->i", Ji, r))
        A_ii = A_ii + torch.diag(lam * torch.clamp(torch.diag(A_ii), min=1e-6))
        S_ci = (A_ci - sums.over_points(torch.einsum("apik,pjk->aij", Y, Bi))) * free[:, None, None]
        BiV = torch.einsum("pij,pjk->pik", Bi, Vinv)
        S_ii = A_ii - sums.over_points(torch.einsum("pik,pjk->ij", BiV, Bi))
        rhs_i = b_i - sums.over_points(torch.einsum("pik,pk->i", BiV, bp))
        S_ii = S_ii + torch.diag(1.0 - sel)  # pin frozen intrinsic components
        rhs_i = rhs_i * sel

        full = torch.zeros((n + 9, n + 9), dtype=dt, device=dev)
        full[:n, :n] = Sm.reshape(n, n)
        full[:n, n:] = S_ci.reshape(n, 9)
        full[n:, :n] = S_ci.reshape(n, 9).T
        full[n:, n:] = S_ii
        frhs = torch.cat([rhs.reshape(-1), rhs_i])
        sol = torch.linalg.solve(full + 1e-9 * torch.eye(n + 9, dtype=dt, device=dev), frhs)
        dcam = sol[:n].reshape(C, 6)
        dq = sol[n:] * sel
        dpt = torch.einsum("pij,pj->pi", Vinv,
                           bp - torch.einsum("cpij,ci->pj", W, dcam) - torch.einsum("pij,i->pj", Bi, dq))
        dintr = dq if intr_tie is None else intr_tie @ dq
    else:
        Sd = Sm.reshape(n, n)
        dcam = torch.linalg.solve(Sd + 1e-9 * torch.eye(n, dtype=dt, device=dev), rhs.reshape(-1)).reshape(C, 6)
        dintr = torch.zeros(9, dtype=dt, device=dev)
        dpt = torch.einsum("pij,pj->pi", Vinv, bp - torch.einsum("cpij,ci->pj", W, dcam))
    return dcam * cam_free[:, None], dpt * pt_free[:, None], dintr


def _solve_schur_pcg(r, Jc, Jp, lam, cam_free, pt_free, n_cg: int = 30, sums: Sums = LOCAL):
    """Implicit-Schur camera solve by CG with the block diagonal of S as
    preconditioner (S x = U x - Y (W^T x) without forming S). Arguments
    and returns as `_solve_schur`'s."""
    dt, dev = r.dtype, r.device
    U, Vinv, W, Y, bc, bp = _normal_blocks(r, Jc, Jp, lam, pt_free, sums)
    U, W, Y, bc = (sums.all_cams(x) for x in (U, W, Y, bc))
    free = cam_free.to(dt)[:, None]

    def matvec(x):
        x = x * free
        wx = torch.einsum("cpij,ci->pj", W, x)
        sx = torch.einsum("cij,cj->ci", U, x) - sums.over_points(torch.einsum("cpik,pk->ci", Y, wx))
        return sx * free + x * (1.0 - free)

    rhs = (bc - sums.over_points(torch.einsum("cpik,pk->ci", Y, bp))) * free
    S_diag = U - sums.over_points(torch.einsum("cpik,cpjk->cij", Y, W))
    Minv = torch.linalg.inv(S_diag + 1e-9 * torch.eye(6, dtype=dt, device=dev))

    def prec(x):
        return torch.einsum("cij,cj->ci", Minv, x) * free + x * (1.0 - free)

    x = torch.zeros_like(rhs)
    res = rhs - matvec(x)
    z = prec(res)
    p = z
    rz = torch.sum(res * z)
    for _ in range(n_cg):
        Ap = matvec(p)
        denom = torch.sum(p * Ap)
        alpha = torch.where(torch.abs(denom) > 1e-20, rz / denom, torch.zeros_like(denom))
        x = x + alpha * p
        res = res - alpha * Ap
        z = prec(res)
        rz_new = torch.sum(res * z)
        beta = torch.where(torch.abs(rz) > 1e-20, rz_new / rz, torch.zeros_like(rz))
        p = z + beta * p
        rz = rz_new
    dcam = x * free
    dpt = torch.einsum("pij,pj->pi", Vinv, bp - torch.einsum("cpij,ci->pj", W, dcam))
    return dcam, dpt * pt_free[:, None], torch.zeros(9, dtype=dt, device=dev)


@f32_matmuls
def bundle_adjust(
    problem: BAProblem,
    n_iters: int = 20,
    optimize_intr: bool = False,
    fix_first_cam: bool = True,
    cam_free: torch.Tensor | None = None,
    pt_free: torch.Tensor | None = None,
    lam0: float = 1e-4,
    solver: str = "auto",
    n_cg: int = 30,
) -> BAResult:
    """Levenberg-Marquardt BA with on-device accept/reject and a fixed
    iteration count. The first camera is held fixed by default (gauge)."""
    return _bundle_adjust(problem, n_iters, optimize_intr, fix_first_cam, cam_free, pt_free, lam0, solver, n_cg)


def _bundle_adjust(problem: BAProblem, n_iters, optimize_intr, fix_first_cam, cam_free, pt_free, lam0, solver, n_cg,
                   sums: Sums = LOCAL) -> BAResult:
    """The LM loop of `bundle_adjust`. Cameras, points and intrinsics stay
    whole on every caller; each iteration linearises the (sums.cams,
    sums.pts) block of the observation grid, and `sums` completes the sums
    and gathers the steps (parallel/dist_ba.py)."""
    obs, mask, intr0 = problem.obs[sums.cams, sums.pts], problem.mask[sums.cams, sums.pts], problem.intr
    C, P = problem.cameras.shape[0], problem.points.shape[0]
    dt, dev = obs.dtype, obs.device
    cam_free = (torch.ones(C, dtype=torch.bool, device=dev) if cam_free is None
                else cam_free.to(torch.bool).clone())
    if fix_first_cam:
        cam_free[0] = False
    if pt_free is None:
        pt_free = torch.ones(P, dtype=torch.bool, device=dev)
    # points with no valid observation must not move
    pt_free = pt_free & (sums.all_points(sums.over_cams(torch.sum(mask, dim=0))) > 0)
    pt_free_b = pt_free[sums.pts]

    # intrinsic components BA may move (f, c, k1, k2); fx/fy tied to one focal
    intr_sel = torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0], dtype=dt, device=dev)
    intr_tie = torch.eye(9, dtype=dt, device=dev)
    intr_tie[1, 0], intr_tie[1, 1] = 1.0, 0.0

    if solver == "pcg" and optimize_intr:
        raise ValueError("solver='pcg' does not support optimize_intr=True; "
                         "use solver='schur' (or 'auto')")
    use_pcg = (solver == "pcg") or (solver == "auto" and C > 1024 and not optimize_intr)

    def block_cost(cams, pts, it):
        return sums.total(cost(cams[sums.cams], pts[sums.pts], it, obs, mask))

    cams, pts, it = problem.cameras, problem.points, intr0
    lam = torch.tensor(lam0, dtype=dt, device=dev)
    c0 = block_cost(cams, pts, it)
    lam_hist = []
    for _ in range(n_iters):
        r, Jc, Jp, Ji = _per_obs_jacobians(cams[sums.cams], pts[sums.pts], it, obs, mask, optimize_intr)
        if use_pcg:
            dcam, dpt, di = _solve_schur_pcg(r, Jc, Jp, lam, cam_free, pt_free_b, n_cg=n_cg, sums=sums)
        else:
            dcam, dpt, di = _solve_schur(
                r, Jc, Jp, lam, cam_free, pt_free_b, Ji=Ji,
                intr_sel=intr_sel if optimize_intr else None,
                intr_tie=intr_tie if optimize_intr else None, sums=sums)
        new_cams, new_pts, new_it = cams + dcam, pts + sums.all_points(dpt), it + di
        c_old = block_cost(cams, pts, it)
        c_new = block_cost(new_cams, new_pts, new_it)
        accept = c_new < c_old
        cams = torch.where(accept, new_cams, cams)
        pts = torch.where(accept, new_pts, pts)
        it = torch.where(accept, new_it, it)
        lam = torch.where(accept, torch.clamp(lam * 0.33, min=1e-9), torch.clamp(lam * 4.0, max=1e6))
        lam_hist.append(lam)
    c1 = block_cost(cams, pts, it)
    lam_history = torch.stack(lam_hist) if lam_hist else torch.zeros(0, dtype=dt, device=dev)
    return BAResult(cams, pts, it, c0, c1, lam_history)


def points_only_adjust(problem: BAProblem, n_iters: int = 5) -> torch.Tensor:
    """Refine only the 3D points with every camera fixed."""
    res = bundle_adjust(problem, n_iters=n_iters, fix_first_cam=False,
                        cam_free=torch.zeros(problem.cameras.shape[0], dtype=torch.bool,
                                             device=problem.cameras.device))
    return res.points


def make_problem_from_scene(Rs, ts, points3d, intr, obs, mask, device="cpu") -> BAProblem:
    """Pack (R, t) pose arrays into the angle-axis problem layout."""
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    rvecs = se3.log_so3(f(Rs))
    cams = torch.cat([rvecs, f(ts)], dim=-1)
    return BAProblem(cams, f(points3d), f(intr), f(obs), torch.as_tensor(mask, dtype=torch.bool, device=device))
