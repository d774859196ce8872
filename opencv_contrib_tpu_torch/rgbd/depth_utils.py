"""Depth utilities: registration to another camera, plane extraction, depth
cleaning (the port of opencv_contrib_tpu/rgbd/depth_utils.py;
depth_registration.cpp registerDepth, plane.cpp RgbdPlane, depth_cleaner.cpp
DepthCleaner).

Registration resolves many depth pixels landing on one RGB pixel with a
min-scatter z-buffer (`scatter_reduce_(..., "amin")` into a buffer with
one dump slot for the pixels that land nowhere). Plane extraction is
RANSAC over point + normal hypotheses, all scored at once, then a masked
least-squares refinement; its draws come from a `torch.Generator` in
`_sample_hypotheses`. The cleaner's box sums are differences of the
summed-area table of `ops.integral.integral` (the integral kernel on the
card). The functions run where their tensors are.
"""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.core import se3
from opencv_contrib_tpu_torch.ops.integral import integral
from opencv_contrib_tpu_torch.rgbd.frame import compute_normals, depth_to_points, pixel_grid


def register_depth(depth: torch.Tensor, intr_d: torch.Tensor, intr_rgb: torch.Tensor, T_rgb_from_d: torch.Tensor,
                   out_hw=None) -> torch.Tensor:
    """Reproject a depth map into the RGB camera's frame with a z-buffer
    (registerDepth). Returns the registered depth (oh, ow), 0 where empty."""
    H, W = depth.shape
    oh, ow = (H, W) if out_hw is None else out_hw
    pts = depth_to_points(depth, intr_d)
    R, t = se3.mat_to_rt(T_rgb_from_d)
    pc = torch.einsum("ij,hwj->hwi", R, pts) + t
    z = pc[..., 2]
    zs = torch.clamp(z, min=1e-9)
    ui = torch.round(torch.addcmul(intr_rgb[2], pc[..., 0] / zs, intr_rgb[0])).long()
    vi = torch.round(torch.addcmul(intr_rgb[3], pc[..., 1] / zs, intr_rgb[1])).long()
    valid = (depth > 0) & (z > 0) & (ui >= 0) & (ui < ow) & (vi >= 0) & (vi < oh)
    flat = torch.where(valid, vi * ow + ui, oh * ow).reshape(-1)
    zbuf = torch.full((oh * ow + 1,), torch.inf, dtype=torch.float32, device=depth.device)
    zbuf.scatter_reduce_(0, flat, torch.where(valid, z, torch.inf).reshape(-1), reduce="amin", include_self=True)
    out = zbuf[: oh * ow].reshape(oh, ow)
    return torch.where(torch.isfinite(out), out, 0.0)


def _sample_hypotheses(generator: torch.Generator | None, n: int, n_pixels: int, device) -> torch.Tensor:
    """The RANSAC draws: n pixel indices uniform in [0, n_pixels), from
    `generator` (on its own device), moved to `device`."""
    gen_dev = generator.device if generator is not None else "cpu"
    return torch.randint(0, n_pixels, (n,), generator=generator, device=gen_dev).to(device)


def extract_planes(depth: torch.Tensor, intr: torch.Tensor, generator: torch.Generator | None = None,
                   n_hypotheses: int = 64, dist_thresh: float = 0.02, normal_thresh: float = 0.9,
                   refine_iters: int = 2):
    """Dominant-plane extraction (RgbdPlane semantics, RANSAC form): sample
    point + normal hypotheses, vote inliers by point-plane distance and
    normal agreement, refine the best plane by masked least squares.
    Returns (plane (4,) [n | d] with n.p + d = 0, inlier mask (H, W)).
    `generator` (a torch.Generator, or None for the default one) takes the
    place of the JAX version's PRNG key. `torch.linalg.eigh` reads its
    status back once per refinement."""
    H, W = depth.shape
    pts = depth_to_points(depth, intr)
    valid = depth > 0
    normals, _ = compute_normals(pts, valid)
    flat_pts = pts.reshape(-1, 3)
    flat_n = normals.reshape(-1, 3)
    flat_v = valid.reshape(-1)

    idx = _sample_hypotheses(generator, n_hypotheses, H * W, depth.device)
    p0, n0 = flat_pts[idx], flat_n[idx]  # (K, 3)
    d = -torch.sum(n0 * p0, dim=-1)
    dist = torch.abs(flat_pts @ n0.T + d)  # (HW, K)
    agree = flat_n @ n0.T
    counts = (flat_v[:, None] & (dist < dist_thresh) & (agree > normal_thresh)).sum(dim=0)
    best = torch.argmax(counts)
    plane = torch.cat([n0[best], d[best, None]])

    for _ in range(refine_iters):
        n0, d = plane[:3], plane[3]
        dist = torch.abs(flat_pts @ n0 + d)
        agree = flat_n @ n0
        m = (flat_v & (dist < dist_thresh) & (agree > normal_thresh)).to(torch.float32)
        # least-squares plane through the inliers: centroid + smallest eigenvector
        wsum = torch.clamp(m.sum(), min=1.0)
        c = (flat_pts * m[:, None]).sum(dim=0) / wsum
        X = (flat_pts - c) * m[:, None]
        _, V = torch.linalg.eigh(X.T @ X / wsum)
        n_new = V[:, 0]
        n_new = torch.where(torch.dot(n_new, n0) < 0, -n_new, n_new)
        plane = torch.cat([n_new, -torch.dot(n_new, c)[None]])
    dist = torch.abs(flat_pts @ plane[:3] + plane[3])
    return plane, (flat_v & (dist < dist_thresh)).reshape(H, W)


def clean_depth(depth: torch.Tensor, intr: torch.Tensor, window: int = 1) -> torch.Tensor:
    """DepthCleaner (NIL method): re-estimate each depth sample from the
    mean of its (2 window + 1)^2 neighbourhood's points, projected onto the
    pixel's ray, suppressing quantisation staircase noise."""
    H, W = depth.shape
    pts = depth_to_points(depth, intr)
    valid = (depth > 0).to(torch.float32)
    k = 2 * window + 1

    def boxsum(x):
        c = integral(torch.nn.functional.pad(x, (window, window, window, window)))
        return c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]

    n = boxsum(valid)
    mean = torch.stack([boxsum(pts[..., i] * valid) for i in range(3)], dim=-1) / torch.clamp(n, min=1)[..., None]
    v, u = pixel_grid(H, W, depth.device)
    ray = torch.stack([(u - intr[2]) / intr[0], (v - intr[3]) / intr[1], torch.ones_like(u)], dim=-1)
    d_clean = (mean * ray).sum(dim=-1) / (ray * ray).sum(dim=-1)
    return torch.where(depth > 0, d_clean, 0.0)
