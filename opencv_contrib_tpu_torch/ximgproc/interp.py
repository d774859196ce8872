"""Edge-aware sparse match interpolation — the port of
opencv_contrib_tpu/ximgproc/interp.py (EdgeAwareInterpolator /
RICInterpolator, sparse_match_interpolator.hpp:77,146: the densifier of
RLOF and SparseToDense flow).

Instead of the reference's geodesic nearest-neighbour graph, a fixed number
of edge-weighted diffusion sweeps of the sparse values: seeds pinned,
neighbour weights from the guide image's differences, coarse to fine."""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.ops.image import resize


def _diffuse_level(guide, seeded, dense, init, sigma_edge, n_iters):
    """n_iters Jacobi sweeps of the 4-neighbour edge-weighted mean (wrapping
    at the borders, as the JAX version's roll); seeded pixels keep their
    seed values."""
    def conduct(shift):
        g2 = (torch.roll(guide, shift, (0, 1)) - guide) ** 2
        return torch.exp(-g2 / (2 * sigma_edge * sigma_edge))

    c_n = conduct((1, 0))
    c_s = conduct((-1, 0))
    c_e = conduct((0, -1))
    c_w = conduct((0, 1))
    den = torch.clamp((c_n + c_s + c_e + c_w)[..., None], min=1e-9)
    c_n, c_s, c_e, c_w = c_n[..., None], c_s[..., None], c_e[..., None], c_w[..., None]
    x = init
    for _ in range(n_iters):
        num = (c_n * torch.roll(x, 1, 0) + c_s * torch.roll(x, -1, 0)
               + c_e * torch.roll(x, -1, 1) + c_w * torch.roll(x, 1, 1))
        x = torch.where(seeded[..., None], dense, num / den)
    return x


def edge_aware_interpolate(guide: torch.Tensor, seed_yx: torch.Tensor, seed_values: torch.Tensor,
                           seed_valid: torch.Tensor | None = None, sigma_edge: float = 0.1, n_iters: int = 100,
                           levels: int = 3) -> torch.Tensor:
    """guide (H, W); seeds (N, 2) (y, x) coords with values (N, D) -> dense
    (H, W, D). Coarse to fine: Jacobi sweeps converge in O(n^2) of the
    domain size, so each finer level resolves only residual detail."""
    H, W = guide.shape
    D = seed_values.shape[-1]
    dev = guide.device
    if seed_valid is None:
        seed_valid = torch.ones(seed_yx.shape[0], dtype=torch.bool, device=dev)
    v = seed_valid.to(torch.float32)
    seed_mean = torch.sum(seed_values * v[:, None], dim=0) / torch.clamp(torch.sum(v), min=1.0)
    # the seed's cell at each level: divided by a device tensor, so the card
    # takes the quotient as the CPU does (its division by a Python number
    # multiplies by the reciprocal, which can move a seed to the next cell)
    Ht, Wt = (torch.full((), n, dtype=torch.float32, device=dev) for n in (H, W))
    init = None
    for lvl in reversed(range(levels)):
        s = 2 ** lvl
        Hl, Wl = max(H // s, 2), max(W // s, 2)
        guide_l = resize(guide, (Hl, Wl))
        yi = torch.clamp((seed_yx[:, 0] / Ht * Hl).to(torch.int32), 0, Hl - 1).long()
        xi = torch.clamp((seed_yx[:, 1] / Wt * Wl).to(torch.int32), 0, Wl - 1).long()
        dense = torch.zeros((Hl, Wl, D), device=dev).index_put_((yi, xi), seed_values * v[:, None], accumulate=True)
        weight = torch.zeros((Hl, Wl), device=dev).index_put_((yi, xi), v, accumulate=True)
        seeded = weight > 0
        dense = dense / torch.clamp(weight, min=1.0)[..., None]
        if init is None:
            init = seed_mean[None, None, :].expand(Hl, Wl, D)
        else:
            init = resize(init, (Hl, Wl))
        init = torch.where(seeded[..., None], dense, init)
        init = _diffuse_level(guide_l, seeded, dense, init, sigma_edge, n_iters)
    return init
