"""Template matching in the six TM_* modes and minMaxLoc (the port of
opencv_contrib_tpu/ops/template_match.py).

The cross-correlation is one `F.conv2d` (VALID) in full float32 (TF32 off,
`utils.precision`); the sums and sums of squares of the image under each
window are box sums of `ops.integral.integral` of the image and of its
square, so on a CUDA tensor they are two launches of the integral kernel.

TM_SQDIFF is s2 - 2 ccorr + sum(t^2), as in the JAX version. At VGA the
table of img^2 reaches about 2e10 on 0..255 frames, where a float32 ulp is
about 2e3, so that difference cancels: two summation orders (the kernel's
and the plain scan's, or the CPU's) agree on where the extrema are, not on
the surface's low bits.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from opencv_contrib_tpu_torch.ops import integral as integ
from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision

METHODS = ("ccorr", "ccorr_normed", "sqdiff", "sqdiff_normed", "ccoeff", "ccoeff_normed")


def _window_sums(img: torch.Tensor, th: int, tw: int):
    """Sums and sums of squares of every (th, tw) window, (H-th+1, W-tw+1)."""
    def box(i):
        return i[th:, tw:] - i[:-th, tw:] - i[th:, :-tw] + i[:-th, :-tw]

    return box(integ.integral(img)), box(integ.integral(img * img))


def match_template(img, tmpl, method: str = "ccoeff_normed") -> torch.Tensor:
    """The (H-th+1, W-tw+1) response of tmpl over img: "ccorr", "sqdiff",
    "ccoeff", each also "_normed". The best match is the maximum for
    ccorr / ccoeff and the minimum for sqdiff."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method}")
    img = torch.as_tensor(img, dtype=torch.float32)
    tmpl = torch.as_tensor(tmpl, dtype=torch.float32, device=img.device)
    th, tw = tmpl.shape
    n = th * tw
    with f32_matmul_precision():
        ccorr = F.conv2d(img[None, None], tmpl[None, None])[0, 0]
    s1, s2 = _window_sums(img, th, tw)
    t_sum = tmpl.sum()
    t_sq = (tmpl * tmpl).sum()

    base = method.replace("_normed", "")
    normed = method.endswith("_normed")
    if base == "ccorr":
        r = ccorr
        if normed:
            r = r / torch.sqrt(torch.clamp(s2 * t_sq, min=1e-12))
    elif base == "sqdiff":
        r = s2 - 2.0 * ccorr + t_sq
        if normed:
            r = r / torch.sqrt(torch.clamp(s2 * t_sq, min=1e-12))
    else:
        r = ccorr - s1 * (t_sum / n)
        if normed:
            var_i = torch.clamp(s2 - s1 * s1 / n, min=1e-12)
            var_t = torch.clamp(t_sq - t_sum * t_sum / n, min=1e-12)
            r = r / torch.sqrt(var_i * var_t)
    return r


def min_max_loc(resp: torch.Tensor):
    """(min_val, max_val, min_loc (y, x), max_loc (y, x)) as cv::minMaxLoc
    gives them; the first extremum in raster order wins a tie."""
    flat = resp.reshape(-1)
    idx = torch.stack([torch.argmin(flat), torch.argmax(flat)])
    # one copy to the host: float64 holds the float32 values and the indices exactly
    vmin, vmax, imin, imax = torch.cat([flat.index_select(0, idx).to(torch.float64), idx.to(torch.float64)]).tolist()
    H, W = resp.shape
    mn = tuple(int(v) for v in np.unravel_index(int(imin), (H, W)))
    mx = tuple(int(v) for v in np.unravel_index(int(imax), (H, W)))
    return vmin, vmax, mn, mx
