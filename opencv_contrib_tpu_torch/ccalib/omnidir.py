"""Mei unified-sphere omnidirectional camera model (the port of
opencv_contrib_tpu/ccalib/omnidir.py).

Projection (omnidir::projectPoints semantics): world point -> unit sphere ->
perspective from a center shifted by xi along z -> radial-tangential
distortion -> pixels.

The loops (the undistortion's fixed-point iterations, calibrate_xi's
Newton steps, calibrate_omni's Levenberg-Marquardt) step in Python and
select with `torch.where`: no host read inside them. Derivatives are
`torch.func`'s (grad of grad for calibrate_xi, jacfwd for the LM) where the
twin takes jax's; the LM's damped system is solved by
`torch.linalg.solve_ex`. calibrate_omni reads the device once for each
focal candidate's cost (the twin's host choice), once for its result and
once to see whether the boards are planar: a planar board's views start
from the board homography, not from the twin's DLT resection
(`_init_pose`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, jacfwd

from opencv_contrib_tpu_torch.core import se3
from opencv_contrib_tpu_torch.mvg import homography, resection
from opencv_contrib_tpu_torch.ops.image import grid_coords, sample_bilinear
from opencv_contrib_tpu_torch.utils.device import as_float, constant, to_device
from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision


def project_points_omni(X, R, t, K, xi, dist=None):
    """X (..., 3) world -> pixels (..., 2). K (3,3); dist = (k1, k2, p1, p2)."""
    Xc = se3.rotate_points(R, X) + t
    s = Xc / torch.clamp(torch.linalg.norm(Xc, dim=-1, keepdim=True), min=1e-9)
    denom = s[..., 2] + xi
    denom = torch.where(torch.abs(denom) < 1e-9, torch.full_like(denom, 1e-9), denom)
    xu = s[..., 0] / denom
    yu = s[..., 1] / denom
    if dist is not None:
        k1, k2, p1, p2 = dist
        r2 = xu * xu + yu * yu
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = xu * radial + 2 * p1 * xu * yu + p2 * (r2 + 2 * xu * xu)
        yd = yu * radial + p1 * (r2 + 2 * yu * yu) + 2 * p2 * xu * yu
        xu, yu = xd, yd
    u = K[0, 0] * xu + K[0, 2]
    v = K[1, 1] * yu + K[1, 2]
    return torch.stack([u, v], dim=-1)


def undistort_points_omni(px, K, xi, dist=None, iters: int = 20):
    """Pixels -> unit-sphere ray directions (..., 3) (cam frame)."""
    xd = (px[..., 0] - K[0, 2]) / K[0, 0]
    yd = (px[..., 1] - K[1, 2]) / K[1, 1]
    xu, yu = xd, yd
    if dist is not None:
        k1, k2, p1, p2 = dist
        for _ in range(iters):
            r2 = xu * xu + yu * yu
            radial = 1.0 + k1 * r2 + k2 * r2 * r2
            dx = 2 * p1 * xu * yu + p2 * (r2 + 2 * xu * xu)
            dy = p1 * (r2 + 2 * yu * yu) + 2 * p2 * xu * yu
            xu, yu = (xd - dx) / radial, (yd - dy) / radial
    # invert the sphere projection: find unit s with s_xy/(s_z + xi) = (xu, yu)
    r2 = xu * xu + yu * yu
    disc = torch.sqrt(torch.clamp(1.0 + (1.0 - xi * xi) * r2, min=0.0))
    factor = (xi + disc) / (1.0 + r2)
    sz = factor - xi
    s = torch.stack([factor * xu, factor * yu, sz], dim=-1)
    return s / torch.clamp(torch.linalg.norm(s, dim=-1, keepdim=True), min=1e-9)


def undistort_image_omni(img, K, xi, K_new=None, dist=None, out_shape=None):
    """Render a perspective view from an omni image
    (omnidir::undistortImage RECTIFY_PERSPECTIVE)."""
    img = as_float(img)
    dev = img.device
    K = to_device(K, dev)
    H, W = img.shape[:2] if out_shape is None else out_shape
    K_new = K if K_new is None else to_device(K_new, dev)
    y, x = grid_coords(H, W, device=dev)
    # perspective ray for each output pixel
    xr = (x - K_new[0, 2]) / K_new[0, 0]
    yr = (y - K_new[1, 2]) / K_new[1, 1]
    rays = torch.stack([xr, yr, torch.ones_like(xr)], dim=-1)
    px = project_points_omni(rays, torch.eye(3, device=dev), torch.zeros(3, device=dev), K, xi, dist)
    return sample_bilinear(img, px[..., 1], px[..., 0])


def calibrate_xi(obj_pts, img_pts, K, R, t, xi0: float = 0.8, iters: int = 30):
    """Refine the mirror parameter xi given known pose/intrinsics
    (the inner loop of omnidir::calibrate; full joint calibration composes
    this with mvg.resection/ba). Returns xi as a 0-dim tensor."""
    obj_pts = as_float(obj_pts)
    dev = obj_pts.device
    img_pts, K, R, t = (to_device(a, dev) for a in (img_pts, K, R, t))

    def residual(xi):
        pred = project_points_omni(obj_pts, R, t, K, xi)
        return torch.sum((pred - img_pts) ** 2)

    g = grad(residual)
    h = grad(g)
    xi = torch.full((), float(xi0), device=dev)
    with f32_matmul_precision():
        for _ in range(iters):
            gg = g(xi)
            hh = h(xi)
            step = gg / torch.where(torch.abs(hh) > 1e-9, hh, torch.full_like(hh, 1e-9))
            xi = xi - torch.clamp(step, -0.2, 0.2)
    return xi


def _polar_rotation(M: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """The rotation factor of the polar decomposition of a 3x3 M with
    det M > 0 (U V^T of its SVD) by Newton's iteration X <- (X + X^-T) / 2,
    with no SVD: the card's SVD and det check their status on the host."""
    X = M
    for _ in range(iters):
        X = 0.5 * (X + torch.linalg.inv_ex(X)[0].T)
    return X


def _init_pose(obj: torch.Tensor, xn: torch.Tensor, planar: bool):
    """A board view's starting pose from its normalized image points. On a
    planar board (z = 0, as calibration boards are) the resection's DLT
    has three zero columns, so its null space has four dimensions and the
    pose it returns depends on the SVD routine: the card's gave depths of 0
    and a NaN calibration. So a planar board starts, as
    aruco.charuco.estimate_pose_single_markers does, from the board
    homography's decomposition (its rotation by `_polar_rotation`), refined
    by resection.refine_pose; any other from mvg.resection.resect."""
    if not planar:
        R0, t0, _ = resection.resect(obj, xn)
        return R0, t0
    Hm = homography.dlt(obj[:, :2], xn)
    h1, h2, h3 = Hm[:, 0], Hm[:, 1], Hm[:, 2]
    lam = 2.0 / torch.clamp(torch.linalg.norm(h1) + torch.linalg.norm(h2), min=1e-9)
    lam = torch.where(h3[2] * lam < 0, -lam, lam)  # the board in front of the camera
    r1, r2 = h1 * lam, h2 * lam
    R0 = _polar_rotation(torch.stack([r1, r2, torch.linalg.cross(r1, r2)], dim=1))
    R0, t0, _ = resection.refine_pose(R0, h3 * lam, obj, xn)
    return R0, t0


def _stack_views(arrays: list, dev):
    """The views' arrays as one (V, N, C) tensor when every view has the
    same N (the residual is then one batched computation), else a list."""
    ts = [to_device(a, dev) for a in arrays]
    if all(a.shape == ts[0].shape for a in ts):
        return torch.stack(ts)
    return ts


def calibrate_omni(obj_pts_list, img_pts_list, image_size, K0=None, xi0: float = 0.8,
                   outer_iters: int = 30, pose_iters: int = 8, fix_xi: bool = False):
    """Full joint omnidirectional calibration (omnidir::calibrate,
    ccalib/include/opencv2/ccalib/omnidir.hpp:176): one joint
    Levenberg-Marquardt over all per-view poses plus (fx, fy, cx, cy, xi)
    (at ~6V+5 parameters the full dense system is tiny, so the reference's
    alternating schedule is unnecessary).

    obj_pts_list: list of (N_v, 3) board points; img_pts_list: matching
    (N_v, 2) pixels. Runs on the first board's device (the CPU for host
    arrays). Returns (K, xi, Rs, ts, rms_px), numpy and floats.

    Identifiability note (shared with the reference): with planar boards of
    moderate FOV, (f, xi) trade off to noise level: the fit is excellent
    but the split is weakly determined. Pass fix_xi=True when the mirror
    parameter is known (then K is well determined).
    """
    H, W = image_size
    V = len(obj_pts_list)
    first = obj_pts_list[0]
    dev = first.device if isinstance(first, torch.Tensor) else torch.device("cpu")
    objs = [to_device(o, dev) for o in obj_pts_list]
    imgs = [to_device(i, dev) for i in img_pts_list]
    obj_b, img_b = _stack_views(obj_pts_list, dev), _stack_views(img_pts_list, dev)
    # one host read: is every board planar (z = 0)?
    planar = bool(torch.stack([torch.all(torch.abs(o[:, 2]) < 1e-9) for o in objs]).all())
    n_pose = 6 * V
    xi0 = float(np.float32(xi0))  # the twin's xi0 is a float32 array

    def init_theta(K):
        # init poses: undistort pixels with (K, xi0) to pinhole normalized
        # coords, then a pose per view (`_init_pose`)
        poses = []
        for o, ip in zip(objs, imgs):
            ray = undistort_points_omni(ip, K, float(xi0))
            xn = ray[:, :2] / torch.clamp(ray[:, 2:3], min=1e-6)
            R0, t0 = _init_pose(o, xn, planar)
            poses.append(torch.cat([se3.log_so3(R0), t0]))
        intr = torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2], torch.full((), float(xi0), device=dev)])
        return torch.cat([torch.cat(poses), intr])

    def residual(theta):
        zero, one = torch.zeros_like(theta[0]), torch.ones_like(theta[0])
        Kt = torch.stack([torch.stack([theta[n_pose], zero, theta[n_pose + 2]]),
                          torch.stack([zero, theta[n_pose + 1], theta[n_pose + 3]]),
                          torch.stack([zero, zero, one])])
        xit = theta[n_pose + 4]
        pv = theta[:n_pose].reshape(V, 6)
        R = se3.exp_so3(pv[:, :3])
        if isinstance(obj_b, torch.Tensor):  # every view at once: (V, N, 2)
            return (project_points_omni(obj_b, R, pv[:, None, 3:], Kt, xit) - img_b).reshape(-1)
        return torch.cat([(project_points_omni(o, R[v], pv[v, 3:], Kt, xit) - ip).reshape(-1)
                          for v, (o, ip) in enumerate(zip(obj_b, img_b))])

    fmax = 4.0 * max(H, W)
    inf = float("inf")
    lo = constant([-inf] * n_pose + [0.1 * max(H, W), 0.1 * max(H, W), 0.0, 0.0, 0.0], dev)
    hi = constant([inf] * n_pose + [fmax, fmax, float(W), float(H), 1.2], dev)
    free = constant([1.0] * (n_pose + 4) + [0.0 if fix_xi else 1.0], dev)

    def lm(theta0):
        theta, lam = theta0, torch.full((), 1e-3, device=dev)
        for _ in range(outer_iters):
            r = residual(theta)
            J = jacfwd(residual)(theta) * free
            JtJ = J.T @ J
            D = torch.diag(torch.clamp(torch.diag(JtJ), min=1e-6))
            dd = torch.linalg.solve_ex(JtJ + lam * D, J.T @ r)[0]
            # box constraints: xi in [0, 1.2] (unified sphere range), focal
            # and principal point within sane image-scaled bounds: keeps
            # LM off the degenerate large-xi branch of the ambiguity family
            cand = torch.clamp(theta - dd, min=lo, max=hi)
            c_old = torch.sum(r * r)
            c_new = torch.sum(residual(cand) ** 2)
            ok = c_new < c_old
            theta = torch.where(ok, cand, theta)
            lam = torch.where(ok, torch.clamp(lam * 0.3, min=1e-8), torch.clamp(lam * 4.0, max=1e6))
        return theta

    with f32_matmul_precision():
        if K0 is not None:
            theta0s = [init_theta(to_device(K0, dev))]
        else:
            # focal-candidate search (the reference initializes f from board
            # geometry; a small grid is robust across FOVs)
            theta0s = []
            for fs in (0.5, 0.8, 1.2, 1.8):
                f0 = fs * max(H, W)
                theta0s.append(init_theta(constant([[f0, 0, W / 2], [0, f0, H / 2], [0, 0, 1]], dev)))
        best = None
        for th0 in theta0s:
            th = lm(th0)
            c = float(torch.sum(residual(th) ** 2))  # the twin's host choice
            if best is None or c < best[0]:
                best = (c, th)
        theta = best[1]
        r = residual(theta)
        Rs = se3.exp_so3(theta[:n_pose].reshape(V, 6)[:, :3])
        host = torch.cat([theta, Rs.reshape(-1), torch.sqrt(torch.mean(r * r))[None]]).cpu().numpy()
    th = host[:n_pose + 5]
    Kf = np.array([[th[n_pose], 0, th[n_pose + 2]], [0, th[n_pose + 1], th[n_pose + 3]], [0, 0, 1.0]], np.float32)
    Rs_np = host[n_pose + 5:n_pose + 5 + 9 * V].reshape(V, 3, 3)
    return (Kf, float(th[n_pose + 4]), [Rs_np[v].copy() for v in range(V)],
            [th[6 * v + 3:6 * v + 6].copy() for v in range(V)], float(host[-1]))
