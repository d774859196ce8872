"""Frame-to-frame RGB-D odometry: photometric (rgbd), geometric (icp) and
joint (merged) Gauss-Newton (the port of opencv_contrib_tpu/rgbd/odometry.py;
odometry.cpp RGBDICPOdometryImpl :790, level loop :851-901,
calcRgbdLsmMatrices :618, calcICPLsmMatrices :691, solveSystem :764).

Each iteration of a level warps every source pixel into the target,
builds the 6x6 normal system and solves it on the device: the photometric
system is a masked einsum, the ICP system is the getAb kernel on the card
(`icp.build_system`), and the det gate and the solve are selects on
`torch.linalg.det` / `solve_ex`, so a level reads nothing back to the
host. The gray pyramids go through `core.pyramid.build_pyramid` (the
pyrdown kernel on the card). `compute` reads the sanity gate back once,
as the reference returns a bool.
"""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.core import pyramid, se3
from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.image import sample_bilinear
from opencv_contrib_tpu_torch.rgbd import frame as frame_mod
from opencv_contrib_tpu_torch.rgbd.frame import DepthFrame
from opencv_contrib_tpu_torch.rgbd.icp import build_system
from opencv_contrib_tpu_torch.utils.device import resolve, to_device
from opencv_contrib_tpu_torch.utils.precision import f32_matmuls

METHODS = ("rgbd", "icp", "merged")


def _photometric_system(T, gray_src, src: DepthFrame, gray_dst, gdx, gdy, dst: DepthFrame, intr, depth_gate=0.07):
    """Photometric GN system: warp the source points into the target,
    compare intensities, Jacobian through the image gradients
    (calcRgbdLsmMatrices). Returns (A (6, 6), b (6,), count, sum of r^2)."""
    R, t = se3.mat_to_rt(T)
    p = torch.einsum("ij,hwj->hwi", R, src.points) + t
    z = torch.clamp(p[..., 2], min=1e-9)
    u = torch.addcmul(intr[2], p[..., 0] / z, intr[0])
    v = torch.addcmul(intr[3], p[..., 1] / z, intr[1])
    H, W = gray_dst.shape
    inb = (u >= 1) & (u < W - 2) & (v >= 1) & (v < H - 2) & (p[..., 2] > 0) & src.valid

    i_dst = sample_bilinear(gray_dst, v, u)
    gx = sample_bilinear(gdx, v, u)
    gy = sample_bilinear(gdy, v, u)
    d_dst = sample_bilinear(dst.depth, v, u)
    depth_ok = torch.abs(d_dst - p[..., 2]) < depth_gate
    w = (inb & depth_ok & (d_dst > 0)).to(torch.float32)

    r = i_dst - gray_src
    fx, fy = intr[0], intr[1]
    invz = 1.0 / z
    x, y = p[..., 0], p[..., 1]
    # dI/dxi = [gx gy] * dproj/dp * dp/dxi
    Jx = gx * fx * invz
    Jy = gy * fy * invz
    Jz = -(gx * fx * x + gy * fy * y) * invz * invz
    Jp = torch.stack([Jx, Jy, Jz], dim=-1)  # dI/dp (H, W, 3)
    Jw = torch.linalg.cross(p, Jp, dim=-1)  # through dp/domega = -[p]x: J_omega = p x Jp
    J = torch.cat([Jw, Jp], dim=-1)
    Jm = J * w[..., None]
    A = torch.einsum("hwi,hwj->ij", Jm, J)
    b = -torch.einsum("hwi,hw->i", Jm, r * w)
    return A, b, torch.sum(w), torch.sum(w * r * r)


def _icp_system(T, src: DepthFrame, dst: DepthFrame, intr, dist_gate=0.1):
    return build_system(T, src, dst, intr, dist_thresh=dist_gate)


def _solve_level(T0, gray_src, src, gray_dst, dst, intr, iters: int, method: str, w_rgbd: float = 0.1):
    """`iters` Gauss-Newton steps on one pyramid level, T on the device."""
    gdy, gdx = filters.gradients(gray_dst)
    eye = torch.eye(6, device=T0.device)
    T = T0
    for _ in range(iters):
        A = torch.zeros((6, 6), device=T0.device)
        b = torch.zeros(6, device=T0.device)
        if method in ("rgbd", "merged"):
            Ai, bi, _, _ = _photometric_system(T, gray_src, src, gray_dst, gdx, gdy, dst, intr)
            scale = w_rgbd if method == "merged" else 1.0
            A = A + scale * Ai
            b = b + scale * bi
        if method in ("icp", "merged"):
            Ai, bi, _, _ = _icp_system(T, src, dst, intr)
            A = A + Ai
            b = b + bi
        ok = torch.linalg.det(A) > 1e-12  # the det gate (solveSystem, odometry.cpp:764)
        dx = torch.where(ok, torch.linalg.solve_ex(A + 1e-9 * eye, b)[0], 0.0)
        dx = torch.where(torch.all(torch.isfinite(dx)), dx, 0.0)
        T = se3.exp_se3(dx) @ T
    return T


@f32_matmuls
def compute(gray_src, depth_src, gray_dst, depth_dst, intr, method: str = "merged", levels: int = 3,
            iterations: tuple = (7, 7, 10), max_rotation: float = 0.5, max_translation: float = 0.5,
            device="cuda"):
    """Estimate T: src camera -> dst camera (the Odometry::compute contract,
    odometry.cpp:1042) from gray images and depth maps (host arrays or
    tensors), on `device`. method in {'rgbd', 'icp', 'merged'}. Returns
    (T (4, 4) on the device, success as a bool)."""
    if method not in METHODS:
        raise ValueError(f"odometry: method must be one of {METHODS}, got {method!r}")
    dev = resolve(device)
    intr = to_device(intr, dev)
    src_pyr = frame_mod.make_frame(to_device(depth_src, dev), intr, levels=levels, use_bilateral=False)
    dst_pyr = frame_mod.make_frame(to_device(depth_dst, dev), intr, levels=levels, use_bilateral=False)
    gs = pyramid.build_pyramid(to_device(gray_src, dev), levels)
    gd = pyramid.build_pyramid(to_device(gray_dst, dev), levels)

    T = torch.eye(4, device=dev)
    for l in reversed(range(levels)):
        T = _solve_level(T, gs[l], src_pyr[l], gd[l], dst_pyr[l], frame_mod.level_intrinsics(intr, l),
                         iters=iterations[min(l, len(iterations) - 1)], method=method)
    # sanity gates (testDeltaTransformation)
    xi = se3.log_se3(T)
    ok = (torch.linalg.norm(xi[:3]) < max_rotation) & (torch.linalg.norm(xi[3:]) < max_translation)
    return T, bool(ok)
