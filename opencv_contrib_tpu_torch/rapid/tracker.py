"""RAPID tracker core (rapid/src/rapid.cpp semantics, batched), the port of
opencv_contrib_tpu/rapid/tracker.py. The search line's offsets are
`jnp.linspace`'s formula (`ximgproc.edges._linspace`); the edge along each
line is the first maximum of the tapered response, as XLA's argmax takes
it. A track makes no host read."""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.mvg import resection
from opencv_contrib_tpu_torch.ops.image import sample_bilinear
from opencv_contrib_tpu_torch.utils.device import as_float, constant, to_device
from opencv_contrib_tpu_torch.ximgproc.edges import _linspace


def extract_control_points(vertices, edges, n_per_edge: int = 8):
    """Sample 3D control points uniformly along model wireframe edges
    (extractControlPoints, rapid.cpp). vertices (V, 3), edges (E, 2) int.
    Returns (pts (E * n_per_edge, 3), dirs (E * n_per_edge, 3)): each
    point carries its own edge's 3D direction so image tangents never mix
    across edges."""
    t = (torch.arange(n_per_edge, dtype=torch.float32, device=vertices.device) + 0.5) / n_per_edge  # (n,)
    edges = (edges.to(vertices.device, torch.int64) if isinstance(edges, torch.Tensor)
             else constant(edges, vertices.device, torch.int64))
    a = vertices[edges[:, 0]]  # (E, 3)
    b = vertices[edges[:, 1]]
    pts = a[:, None, :] + t[None, :, None] * (b - a)[:, None, :]
    d = b - a
    d = d / (torch.linalg.norm(d, dim=1, keepdim=True) + 1e-9)
    dirs = d[:, None, :].expand(pts.shape)
    return pts.reshape(-1, 3), dirs.reshape(-1, 3)


def _project(K, R, t, X):
    Xc = X @ R.T + t[None]
    uv = Xc[:, :2] / torch.clamp(Xc[:, 2:3], min=1e-6)
    return uv @ K[:2, :2].T + K[:2, 2][None], Xc[:, 2]


def extract_line_bundle(img, pts2d, normals, search_len: float = 8.0, n_samples: int = 17):
    """Sample intensities along lines normal to the contour at each point
    (extractLineBundle). Returns (N, n_samples) plus the sample positions."""
    s = _linspace(-search_len, search_len, n_samples, device=pts2d.device)
    pos = pts2d[:, None, :] + s[None, :, None] * normals[:, None, :]  # (N, S, 2)
    vals = sample_bilinear(img, pos[..., 1], pos[..., 0])  # (y, x) order
    return vals, pos


def _along(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[n, idx[n]] for (N, S) a, or a[n, idx[n], :] for (N, S, C) a."""
    if a.ndim == 2:
        return torch.gather(a, 1, idx[:, None])[:, 0]
    return torch.gather(a, 1, idx[:, None, None].expand(-1, 1, a.shape[2]))[:, 0]


def find_correspondencies(bundle, pos):
    """Strongest intensity step along each search line -> target 2D point
    (findCorrespondencies uses the max filtered response; here the absolute
    central difference with parabolic subpixel refinement of the peak)."""
    grad = torch.abs(bundle[:, 2:] - bundle[:, :-2])  # (N, S-2)
    # prefer the edge nearest the prediction: a mild taper with distance
    # from the line center breaks plateau ties inward (the reference's
    # search also scores proximity)
    S2 = grad.shape[1]
    center = (S2 - 1) / 2.0
    taper = 1.0 - 0.02 * torch.abs(torch.arange(S2, dtype=torch.float32, device=grad.device) - center)
    idx = torch.argmax(grad * taper[None], dim=1)
    strength = _along(grad, idx)
    g0 = _along(grad, torch.clamp(idx - 1, 0, S2 - 1))
    g1 = strength
    g2 = _along(grad, torch.clamp(idx + 1, 0, S2 - 1))
    denom = g0 - 2 * g1 + g2
    delta = torch.where(torch.abs(denom) > 1e-9, 0.5 * (g0 - g2) / denom, torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    # positions along the line: idx in grad space -> idx+1 in bundle space
    p_lo = _along(pos, idx)
    p_c = _along(pos, idx + 1)
    step = p_c - p_lo
    tgt = p_c + delta[:, None] * step
    return tgt, strength


def _image_normals(K, R, t, pts3d, dirs3d, eps: float = 1e-3):
    """2D contour normals: perpendicular to the projected 3D edge tangent
    at each control point."""
    uv, _ = _project(K, R, t, pts3d)
    uv2, _ = _project(K, R, t, pts3d + 1e-2 * dirs3d)
    d = uv2 - uv
    n = torch.stack([-d[:, 1], d[:, 0]], dim=1)
    return n / (torch.linalg.norm(n, dim=1, keepdim=True) + eps), uv


def rapid_step(img, K, R, t, pts3d, dirs3d, search_len: float = 8.0, min_strength: float = 0.05):
    """One RAPID iteration (rapid(), rapid.cpp): project control points,
    search normals for edges, Gauss-Newton pose refinement on the found
    2D-3D correspondences. Returns (R, t, ratio_of_used_points)."""
    normals, uv = _image_normals(K, R, t, pts3d, dirs3d)
    bundle, pos = extract_line_bundle(img, uv, normals, search_len)
    tgt, strength = find_correspondencies(bundle, pos)
    mask = strength > min_strength
    # normalized camera coords for refine_pose
    Kinv = torch.linalg.inv_ex(K)[0]
    xn = (torch.cat([tgt, torch.ones_like(tgt[:, :1])], dim=1) @ Kinv.T)[:, :2]
    R2, t2, _ = resection.refine_pose(R, t, pts3d, xn, mask=mask, iters=5)
    return R2, t2, mask.to(torch.float32).mean()


def track(img, K, R, t, vertices, edges, n_iters: int = 4, n_per_edge: int = 8,
          search_len: float = 8.0):
    """Full RAPID track call (Tracker::compute): iterate rapid_step with a
    shrinking search range. Returns (R, t, used_ratio) on the image's
    device."""
    img = as_float(img)
    dev = img.device
    K, R, t = (to_device(a, dev) for a in (K, R, t))
    pts3d, dirs3d = extract_control_points(to_device(vertices, dev), edges, n_per_edge)
    used = 0.0
    for i in range(n_iters):
        sl = search_len * (0.6 ** i)
        R, t, used = rapid_step(img, K, R, t, pts3d, dirs3d, search_len=sl)
    return R, t, used
