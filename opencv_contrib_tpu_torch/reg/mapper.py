"""Gauss-Newton parametric registration (the port of
opencv_contrib_tpu/reg/mapper.py).

Models (parameter vectors p):
- "shift":      p = (dy, dx)
- "euclidean":  p = (angle, dy, dx)
- "similarity": p = (log_scale, angle, dy, dx)
- "affine":     p = 6 (row-major 2x3 delta from identity)
- "projective": p = 8 (3x3 with h22 = 1)

register(img_ref, img_mov) finds p so that mov warped by p matches ref
(same contract as Mapper::calculate returning a Map that warps img2 into
img1's frame). The Jacobian of the residual is `torch.func.jacfwd`'s, as
the twin's is `jax.jacfwd`'s (the floor of the bilinear sample contributes
no derivative in either); the normal equations are solved by
`torch.linalg.solve_ex`, which makes the host wait for nothing.
"""

from __future__ import annotations

import math

import torch
from torch.func import jacfwd

from opencv_contrib_tpu_torch.core import pyramid
from opencv_contrib_tpu_torch.ops.image import grid_coords, sample_bilinear
from opencv_contrib_tpu_torch.utils.device import as_float, constant
from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision

MODELS = ("shift", "euclidean", "similarity", "affine", "projective")

# each model's factor on its parameters from one pyramid level to the next
# finer one: translations double, the projective row halves
_LEVEL_SCALE = {"shift": [2.0, 2.0], "euclidean": [1.0, 2.0, 2.0], "similarity": [1.0, 1.0, 2.0, 2.0],
                "affine": [1.0, 1.0, 2.0, 1.0, 1.0, 2.0],
                "projective": [1.0, 1.0, 2.0, 1.0, 1.0, 2.0, 0.5, 0.5]}


def _n_params(model: str) -> int:
    return {"shift": 2, "euclidean": 3, "similarity": 4, "affine": 6, "projective": 8}[model]


def _warp_coords(model: str, p: torch.Tensor, y: torch.Tensor, x: torch.Tensor, cy: float, cx: float):
    """Map output coords -> source coords under parameters p."""
    yc = y - cy
    xc = x - cx
    if model == "shift":
        return y + p[0], x + p[1]
    if model == "euclidean":
        c, s = torch.cos(p[0]), torch.sin(p[0])
        ys = s * xc + c * yc + cy + p[1]
        xs = c * xc - s * yc + cx + p[2]
        return ys, xs
    if model == "similarity":
        sc = torch.exp(p[0])
        c, s = sc * torch.cos(p[1]), sc * torch.sin(p[1])
        ys = s * xc + c * yc + cy + p[2]
        xs = c * xc - s * yc + cx + p[3]
        return ys, xs
    if model == "affine":
        xs = (1.0 + p[0]) * xc + p[1] * yc + cx + p[2]
        ys = p[3] * xc + (1.0 + p[4]) * yc + cy + p[5]
        return ys, xs
    if model == "projective":
        d = p[6] * xc + p[7] * yc + 1.0
        d = torch.where(torch.abs(d) < 1e-9, torch.full_like(d, 1e-9), d)
        xs = ((1.0 + p[0]) * xc + p[1] * yc + p[2]) / d + cx
        ys = (p[3] * xc + (1.0 + p[4]) * yc + p[5]) / d + cy
        return ys, xs
    raise ValueError(model)


def warp_with_params(model: str, p: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Warp img by parameters p (output(y,x) = img(warp(y,x)))."""
    img = as_float(img)
    H, W = img.shape
    y, x = grid_coords(H, W, device=img.device)
    ys, xs = _warp_coords(model, p.to(img.device), y, x, H / 2.0, W / 2.0)
    return sample_bilinear(img, ys, xs)


def _register_level(model: str, p0, ref, mov, iters: int = 20, huber_delta: float = 0.1):
    H, W = ref.shape
    y, x = grid_coords(H, W, device=ref.device)
    cy, cx = H / 2.0, W / 2.0
    # ignore borders where warps read out of bounds
    border = max(2, int(0.08 * min(H, W)))
    mask = torch.zeros((H, W), device=ref.device)
    mask[border:-border, border:-border].fill_(1.0)
    eye = torch.eye(p0.shape[0], device=ref.device)

    def residual(p):
        ys, xs = _warp_coords(model, p, y, x, cy, cx)
        warped = sample_bilinear(mov, ys, xs)
        return ((warped - ref) * mask).reshape(-1)

    p, cost = p0, None
    with f32_matmul_precision():
        for _ in range(iters):
            r = residual(p)
            # IRLS Huber weights: occlusions/outliers get |r|^-1 influence
            # (the robust-loss item of the reference's Mapper gradient methods)
            w = torch.clamp(huber_delta / torch.clamp(torch.abs(r), min=1e-9), max=1.0)
            J = jacfwd(residual)(p)  # (HW, P)
            Jw = J * w[:, None]
            Hm = Jw.T @ J + 1e-6 * eye
            dp = torch.linalg.solve_ex(Hm, Jw.T @ r)[0]
            p, cost = p - dp, torch.sum(w * r * r)
    return p, cost


def register_pyramid(ref, mov, model: str = "affine", levels: int | None = 3,
                     iters: int = 20, expected_motion_px: float | None = None):
    """Coarse-to-fine registration (MapperPyramid contract). Returns params p
    (a tensor on the images' device) such that warp_with_params(model, p,
    mov) ~= ref.

    levels=None picks the depth automatically: deep enough that the
    expected motion shrinks below ~2 px at the coarsest level (the
    "scale pyramid depth with expected motion" rule), bounded by image
    size."""
    ref = as_float(ref)
    mov = as_float(mov).to(ref.device)
    if levels is None:
        motion = expected_motion_px if expected_motion_px is not None else 0.05 * min(ref.shape)
        need = max(1, int(math.ceil(math.log2(max(motion, 1.0) / 2.0))) + 1)
        cap = max(1, int(math.log2(min(ref.shape) / 16)))
        levels = int(min(max(need, 2), cap))
    pr = pyramid.build_pyramid(ref, levels)
    pm = pyramid.build_pyramid(mov, levels)
    p = torch.zeros(_n_params(model), dtype=torch.float32, device=ref.device)
    scale = constant(_LEVEL_SCALE[model], ref.device) if levels > 1 else None
    for lv in reversed(range(levels)):
        p, _ = _register_level(model, p, pr[lv], pm[lv], iters=iters)
        if lv > 0:  # upscale translation-like params
            p = p * scale
    return p
