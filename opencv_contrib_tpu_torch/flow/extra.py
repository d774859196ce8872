"""The remaining contrib optflow algorithms — the port of
opencv_contrib_tpu/flow/extra.py: DeepFlow, SimpleFlow, SparseToDense and
RLOF-class robust local flow with an illumination model.

- DeepFlow (optflow/src/deepflow.cpp:50-159): coarse to fine, each level
  solved by the variational engine alone (`dis.variational_refine`, whose
  warp is the remap kernel on the card).
- SimpleFlow (optflow/src/simpleflow.cpp): a (2r+1)^2 displacement cost
  volume of windowed colour distances over static shifts of the warped
  target, a soft sub-pixel pick around the winner, a guided-filter cleanup.
- SparseToDense (optflow/src/sparsetodenseflow.cpp): grid LK matches,
  forward-backward pruned, densified by `ximgproc.interp`.
- RLOF (optflow/src/rlofflow.cpp:73,320, rlof/rlof_invoker.hpp): a local
  window Gauss-Newton over (dy, dx, gain, bias) with Huber weights; the
  dense variant seeds a grid, densifies, then refines variationally.

Every pyramid is built by `core.pyramid.build_pyramid` (the pyrdown kernel
on the card). The RLOF 4x4 systems are solved by `torch.linalg.solve_ex`,
which leaves their info on the device (no host check), as the JAX solve
does not check either.
"""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.core import pyramid
from opencv_contrib_tpu_torch.flow import dis, lk
from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.image import resize, sample_bilinear
from opencv_contrib_tpu_torch.ximgproc.interp import edge_aware_interpolate


def _pyramids(I0, I1, levels: int):
    I0, I1 = I0.to(torch.float32), I1.to(torch.float32)
    return pyramid.build_pyramid(I0, levels), pyramid.build_pyramid(I1, levels)


def _grid(H: int, W: int, step: int, device) -> torch.Tensor:
    """Seed points (y, x) every `step` pixels from step // 2, row-major."""
    ys = torch.arange(step // 2, H, step, dtype=torch.float32, device=device)
    xs = torch.arange(step // 2, W, step, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gy.reshape(-1), gx.reshape(-1)], dim=1)


# ---------------------------------------------------------------------------
# DeepFlow


def deepflow(I0, I1, levels: int = 5, alpha: float = 8.0, fixed_point_iters: int = 5, sor_iters: int = 25):
    """DeepFlow contract (deepflow.cpp:83 defaults, :155-159 delegation):
    coarse to fine, each level solved by the variational engine alone."""
    p0, p1 = _pyramids(I0, I1, levels)
    flow = torch.zeros(p0[-1].shape + (2,), dtype=torch.float32, device=p0[0].device)
    for lvl in reversed(range(levels)):
        if flow.shape[:2] != p0[lvl].shape:
            flow = resize(flow, p0[lvl].shape) * 2.0
        flow = dis.variational_refine(p0[lvl], p1[lvl], flow, alpha=alpha, outer=fixed_point_iters, iters=sor_iters)
    return flow


# ---------------------------------------------------------------------------
# SimpleFlow


def _shift(img, dy: int, dx: int):
    return torch.roll(img, (dy, dx), dims=(0, 1))


def _parab(line, i):
    """Sub-pixel offset of the parabola through line[i - 1], line[i],
    line[i + 1] along the last axis, clipped to +-0.5."""
    cm = torch.gather(line, -1, (i - 1)[..., None])[..., 0]
    c0 = torch.gather(line, -1, i[..., None])[..., 0]
    cp = torch.gather(line, -1, (i + 1)[..., None])[..., 0]
    den = cm - 2 * c0 + cp
    return torch.where(torch.abs(den) > 1e-9, torch.clamp(0.5 * (cm - cp) / torch.clamp(den, min=1e-9), -0.5, 0.5),
                       0.0)


def _simpleflow_level(I0, I1, flow_init, search_radius: int, window_radius: int, sigma_color: float):
    """One SimpleFlow level: cost volume over static shifts of the warped
    target, windowed (box) colour distance, winner with a parabolic
    sub-pixel step; also the confidence 1 - sum(softmin^2)."""
    H, W = I0.shape
    dev = I0.device
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    # warp I1 by the upscaled coarse flow so that the residual search is centred
    Iw = sample_bilinear(I1, yy + flow_init[..., 0], xx + flow_init[..., 1])
    costs = []
    for dy in range(-search_radius, search_radius + 1):
        for dx in range(-search_radius, search_radius + 1):
            d = (Iw if (dy == 0 and dx == 0) else _shift(Iw, -dy, -dx)) - I0
            costs.append(filters.box_filter(d * d, window_radius))
    S = 2 * search_radius + 1
    Cf = torch.stack(costs, dim=-1)  # (H, W, S * S)
    C = Cf.reshape(H, W, S, S)  # (H, W, Sy, Sx)
    # probabilistic (softmin) weights: simpleflow.cpp weighs shifts by
    # exp(-cost / (2 sigma^2)); at image contrast that is near-hard argmin
    wgt = torch.softmax(-Cf / (2 * sigma_color * sigma_color), dim=-1)
    k = torch.argmin(Cf, dim=-1)
    iy, ix = torch.div(k, S, rounding_mode="floor"), k % S
    iy_c = torch.clamp(iy, 1, S - 2)
    ix_c = torch.clamp(ix, 1, S - 2)
    row = torch.gather(C, 2, iy_c[..., None, None].expand(H, W, 1, S))[:, :, 0, :]  # (H, W, Sx)
    col = torch.gather(C, 3, ix_c[..., None, None].expand(H, W, S, 1))[:, :, :, 0]  # (H, W, Sy)
    sub_y = torch.where(iy == iy_c, _parab(col, iy_c), 0.0)
    sub_x = torch.where(ix == ix_c, _parab(row, ix_c), 0.0)
    dflow = torch.stack([iy.to(torch.float32) - search_radius + sub_y,
                         ix.to(torch.float32) - search_radius + sub_x], dim=-1)
    conf = 1.0 - torch.sum(wgt * wgt, dim=-1)  # occlusion-style confidence: the distribution's sharpness
    return flow_init + dflow, conf


def simpleflow(I0, I1, levels: int = 3, search_radius: int = 4, window_radius: int = 2,
               sigma_color: float = 25.0 / 255.0):
    """SimpleFlow dense field. Inputs (H, W) grayscale in [0, 1]."""
    p0, p1 = _pyramids(I0, I1, levels)
    flow = torch.zeros(p0[-1].shape + (2,), dtype=torch.float32, device=p0[0].device)
    for lvl in reversed(range(levels)):
        if flow.shape[:2] != p0[lvl].shape:
            flow = resize(flow, p0[lvl].shape) * 2.0
        flow, _ = _simpleflow_level(p0[lvl], p1[lvl], flow, search_radius=search_radius,
                                    window_radius=window_radius, sigma_color=sigma_color)
        # edge-preserving cleanup of the level's field
        flow = torch.stack([filters.guided_filter(p0[lvl], flow[..., 0], 4, 1e-3),
                            filters.guided_filter(p0[lvl], flow[..., 1], 4, 1e-3)], dim=-1)
    return flow


# ---------------------------------------------------------------------------
# SparseToDense


def sparse_to_dense(I0, I1, grid_step: int = 8, levels: int = 3, radius: int = 7, iters: int = 10,
                    fb_threshold: float = 1.5):
    """calcOpticalFlowSparseToDense contract (sparsetodenseflow.cpp): grid
    LK matches, forward-backward pruned, densified edge-aware."""
    I0, I1 = I0.to(torch.float32), I1.to(torch.float32)
    H, W = I0.shape
    pts = _grid(H, W, grid_step, I0.device)
    fwd_pts, fwd, v_f = lk.track(I0, I1, pts, levels=levels, radius=radius, iters=iters)
    bwd_pts, _, v_b = lk.track(I1, I0, fwd_pts, levels=levels, radius=radius, iters=iters)
    fb = torch.linalg.norm(bwd_pts - pts, dim=1)
    valid = v_f & v_b & (fb < fb_threshold)
    return edge_aware_interpolate(I0, pts, fwd, seed_valid=valid)


# ---------------------------------------------------------------------------
# RLOF


def rlof_level(I0, I1, pts_yx, flow0, radius: int = 7, iters: int = 12, huber: float = 0.04):
    """One-level RLOF: per-window Gauss-Newton over (dy, dx, gain, bias) with
    Huber IRLS weights, the illumination-augmented system of
    rlof/rlof_invoker.hpp (model I1(x + d) ~= (1 + g) I0(x) + b). Returns
    (flow (N, 2), valid (N,))."""
    gy, gx = filters.gradients(I0)
    dy, dx = lk._window_offsets(radius, device=I0.device)
    wy = pts_yx[:, 0][:, None] + dy[None]
    wx = pts_yx[:, 1][:, None] + dx[None]
    T = sample_bilinear(I0, wy, wx)  # (N, M)
    Gy = sample_bilinear(gy, wy, wx)
    Gx = sample_bilinear(gx, wy, wx)
    # Jacobian columns [Gy, Gx, -T, -1] for the parameters (dy, dx, gain, bias)
    J = torch.stack([Gy, Gx, -T, -torch.ones_like(T)], dim=-1)  # (N, M, 4)
    eye = 1e-6 * torch.eye(4, device=I0.device)
    params = torch.cat([flow0, torch.zeros((flow0.shape[0], 2), device=flow0.device)], dim=1)

    def residual(p):
        Iw = sample_bilinear(I1, wy + p[:, 0][:, None], wx + p[:, 1][:, None])
        return Iw - (1.0 + p[:, 2][:, None]) * T - p[:, 3][:, None]

    for _ in range(iters):
        r = residual(params)
        w = torch.clamp(huber / (torch.abs(r) + 1e-9), max=1.0)  # Huber IRLS weight
        Jw = J * w[..., None]
        A = torch.einsum("nmi,nmj->nij", Jw, J) + eye
        b = torch.einsum("nmi,nm->ni", Jw, r)
        params = params - torch.linalg.solve_ex(A, b[..., None])[0][..., 0]
    flow = params[:, :2]
    H, W = I0.shape
    ty = pts_yx[:, 0] + flow[:, 0]
    tx = pts_yx[:, 1] + flow[:, 1]
    valid = (ty >= 0) & (ty <= H - 1) & (tx >= 0) & (tx <= W - 1)
    # quality gate: the residual after the illumination correction must be
    # small against the window's contrast (textureless / diverged windows fail)
    r = residual(params)
    contrast = torch.std(T, dim=1, correction=0) + 1e-6
    valid = valid & (torch.sqrt(torch.mean(r * r, dim=1)) < 0.5 * contrast)
    return flow, valid


def rlof_track(I0, I1, pts_yx, levels: int = 3, radius: int = 7, iters: int = 12):
    """Pyramidal sparse RLOF (SparseRLOFOpticalFlow contract): (new_pts,
    flow, valid)."""
    p0, p1 = _pyramids(I0, I1, levels)
    N = pts_yx.shape[0]
    flow = torch.zeros((N, 2), dtype=torch.float32, device=pts_yx.device)
    valid = torch.ones(N, dtype=torch.bool, device=pts_yx.device)
    for lvl in reversed(range(levels)):
        flow, v = rlof_level(p0[lvl], p1[lvl], pts_yx * 0.5 ** lvl, flow, radius=radius, iters=iters)
        valid = valid & v
        if lvl > 0:
            flow = flow * 2.0
    return pts_yx + flow, flow, valid


def rlof_dense(I0, I1, grid_step: int = 6, levels: int = 3, radius: int = 7, iters: int = 12,
               use_variational: bool = True):
    """DenseRLOFOpticalFlow contract (rlofflow.cpp:320): grid-seeded sparse
    RLOF + edge-aware densification + variational post-pass (:258)."""
    I0, I1 = I0.to(torch.float32), I1.to(torch.float32)
    H, W = I0.shape
    pts = _grid(H, W, grid_step, I0.device)
    _, flow_s, valid = rlof_track(I0, I1, pts, levels=levels, radius=radius, iters=iters)
    dense = edge_aware_interpolate(I0, pts, flow_s, seed_valid=valid)
    if use_variational:
        dense = dis.variational_refine(I0, I1, dense)
    return dense
