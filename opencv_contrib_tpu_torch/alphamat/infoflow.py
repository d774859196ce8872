"""Information-flow-class alpha matting via an affinity-Laplacian CG solve
(the port of opencv_contrib_tpu/alphamat/infoflow.py).

alpha minimizes  sum_edges w_ij (a_i - a_j)^2 + lam * |a - trimap|^2 on
known pixels, with color-based edge affinities — the graph structure of the
reference's info-flow formulation on the 8-neighborhood. The n_iters CG
steps run where the image lies with no read of the device (the step
sizes stay 0-dim tensors). `jnp.roll` is `torch.roll`, the twin's stable
`argsort` a stable sort, and `lax.top_k`'s ties go to the lower index
through a stable descending sort.
"""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.utils.device import as_float
from opencv_contrib_tpu_torch.utils.precision import f32_matmuls

_SHIFTS = [(-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1)]


def _affinities(feat: torch.Tensor, sigma_color: float):
    """The 8-neighbour colour affinities exp(-|f(shifted) - f|^2 / 2 s^2)."""
    den = torch.full((), 2 * sigma_color * sigma_color, device=feat.device)
    return [torch.exp(-torch.sum((torch.roll(feat, (dy, dx), (0, 1)) - feat) ** 2, dim=-1) / den)
            for dy, dx in _SHIFTS]


def _cg(diag: torch.Tensor, ws, b: torch.Tensor, a0: torch.Tensor, n_iters: int) -> torch.Tensor:
    """n_iters conjugate-gradient steps on (diag + L_w) a = b from a0."""
    def A(a):
        out = diag * a
        for (dy, dx), w in zip(_SHIFTS, ws):
            out = out + w * (a - torch.roll(a, (dy, dx), (0, 1)))
        return out

    a = a0
    r = b - A(a0)
    p = r
    rs = torch.sum(r * r)
    for _ in range(n_iters):
        Ap = A(p)
        step = rs / torch.clamp(torch.sum(p * Ap), min=1e-12)
        a = a + step * p
        r = r - step * Ap
        rs_new = torch.sum(r * r)
        p = r + (rs_new / torch.clamp(rs, min=1e-12)) * p
        rs = rs_new
    return torch.clamp(a, 0.0, 1.0)


def _trimap(img, trimap):
    img = as_float(img)
    trimap = as_float(trimap).to(img.device)
    feat = img[..., None] if img.ndim == 2 else img
    known_fg = trimap > 0.99
    known = known_fg | (trimap < 0.01)
    return feat, known, known_fg.to(torch.float32)


def info_flow(img, trimap, sigma_color: float = 0.1, lam: float = 100.0, n_iters: int = 150) -> torch.Tensor:
    """img (H, W[, 3]) in [0,1]; trimap (H, W): 1 = foreground, 0 =
    background, 0.5 (or anything else) = unknown. Returns alpha (H, W)."""
    feat, known, target = _trimap(img, trimap)
    ws = _affinities(feat, sigma_color)
    lam_map = lam * known.to(torch.float32)
    a0 = torch.where(known, target, torch.full_like(target, 0.5))
    return _cg(lam_map, ws, lam_map * target, a0, n_iters)


@f32_matmuls
def info_flow_nonlocal(img, trimap, sigma_color: float = 0.1, lam: float = 100.0, k: int = 5, n_samples: int = 2048,
                       w_nonlocal: float = 1.0, n_iters: int = 150) -> torch.Tensor:
    """Info-flow matting with the reference's NON-LOCAL K-to-U flow
    (alphamat/src/trimming.cpp + KToU term): every unknown pixel is softly
    tied to its k nearest KNOWN (fg/bg) samples in color space — long-range
    alpha propagation across disconnected regions of similar color, which
    the 8-neighborhood Laplacian alone cannot provide.

    The unknown->known kNN is one (HW, S) distance product + top-k over a
    static sample of known pixels (the first S in pixel order); the flow
    enters the CG system as a diagonal + rhs term. The (HW, S) float32
    distances are the peak: 2.5 GB at VGA with S = 2,048."""
    feat, known, target = _trimap(img, trimap)
    H, W = known.shape
    ws = _affinities(feat, sigma_color)

    # static sample of KNOWN pixels: sort so known come first, take S
    F = feat.reshape(H * W, -1)
    kflat = known.reshape(-1)
    order = torch.sort((~kflat).to(torch.uint8), stable=True).indices
    samp_idx = order[:n_samples]
    samp_ok = kflat[samp_idx]
    Fs = F[samp_idx]
    ts = target.reshape(-1)[samp_idx]

    d2 = (F * F).sum(-1)[:, None] + (Fs * Fs).sum(-1)[None] - 2.0 * F @ Fs.T
    d2 = torch.where(samp_ok[None], d2, torch.full((), float("inf"), device=d2.device))
    neg, nn = torch.sort(-d2, dim=1, descending=True, stable=True)  # (HW, k) nearest KNOWN samples
    del d2
    neg, nn = neg[:, :k], nn[:, :k]
    den = torch.full((), 2 * sigma_color * sigma_color, device=neg.device)
    wd = torch.exp(torch.clamp(neg, -50.0, 0.0) / den)
    wd = wd * torch.isfinite(neg)
    # only unknown pixels receive the flow
    wd = wd * (~kflat)[:, None]
    ku_diag = (w_nonlocal * wd.sum(-1)).reshape(H, W)
    ku_rhs = (w_nonlocal * (wd * ts[nn]).sum(-1)).reshape(H, W)

    lam_map = lam * known.to(torch.float32)
    a0 = torch.where(known, target, torch.full_like(target, 0.5))
    return _cg(lam_map + ku_diag, ws, lam_map * target + ku_rhs, a0, n_iters)
