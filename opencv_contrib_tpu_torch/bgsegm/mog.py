"""MOG background subtraction: per-pixel Gaussian mixtures (the port of
opencv_contrib_tpu/bgsegm/mog.py).

Parity: BackgroundSubtractorMOG (bgsegm.hpp:62; Stauffer-Grimson) — K
gaussians per pixel with weight/mean/variance, matched-component update,
weakest-component replacement, foreground = no match among high-weight
components.

The components are ranked by a stable sort (ties of -w/sqrt(var) are common
on the first frames, and `jnp.argsort` keeps their order), and the sorted
background flags go back to their components by one scatter along the
component axis. The sums over the K components add them in order, as the
twin's reductions do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class MogState(NamedTuple):
    weight: torch.Tensor  # (H, W, K)
    mean: torch.Tensor  # (H, W, K)
    var: torch.Tensor  # (H, W, K)


def mog_create(shape, n_mixtures: int = 5, init_var: float = 0.01, device="cpu") -> MogState:
    H, W = shape
    K = n_mixtures
    weight = torch.zeros((H, W, K), device=device)
    weight[..., 0].fill_(1.0)
    return MogState(weight=weight, mean=torch.zeros((H, W, K), device=device),
                    var=torch.full((H, W, K), init_var, device=device))


def _running_sums(x: torch.Tensor) -> torch.Tensor:
    """Inclusive sums along the last (component) axis, added in order."""
    out = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., k])
    return torch.stack(out, dim=-1)


def mog_apply(state: MogState, frame: torch.Tensor, lr: float = 0.05, var_thresh: float = 6.25, bg_ratio: float = 0.7):
    """One frame -> (new_state, fg_mask (H, W) bool)."""
    K = state.weight.shape[-1]
    x = frame[..., None]
    d2 = (x - state.mean) ** 2 / torch.clamp(state.var, min=1e-6)
    match = d2 < var_thresh  # (H, W, K)
    # only the best-matching component updates
    best = torch.argmin(torch.where(match, d2, torch.inf), dim=-1)
    onehot = F.one_hot(best, K).to(frame.dtype)
    any_match = match.any(dim=-1)
    upd = onehot * any_match[..., None]

    w = (1 - lr) * state.weight + lr * upd
    rho = lr
    mean = torch.where(upd > 0, (1 - rho) * state.mean + rho * x, state.mean)
    var = torch.where(upd > 0, torch.clamp((1 - rho) * state.var + rho * (x - mean) ** 2, min=1e-4), state.var)

    # no match: replace weakest component
    weakest = torch.argmin(w, dim=-1)
    wh = F.one_hot(weakest, K).to(frame.dtype) * (~any_match)[..., None]
    mean = torch.where(wh > 0, x, mean)
    var = torch.where(wh > 0, 0.04, var)
    w = torch.where(wh > 0, 0.05, w)
    w = w / torch.clamp(_running_sums(w)[..., -1:], min=1e-9)

    # foreground: pixel not matching any "background" component. Components
    # sorted by weight/sqrt(var); top ones summing to bg_ratio are background.
    rank_key = -w / torch.sqrt(var)
    order = torch.argsort(rank_key, dim=-1, stable=True)
    w_sorted = torch.gather(w, -1, order)
    csum = _running_sums(w_sorted)
    is_bg_sorted = (csum - w_sorted) < bg_ratio
    # scatter back component-is-background flags
    is_bg = torch.zeros_like(match).scatter(-1, order, is_bg_sorted)
    fg = ~torch.any(match & is_bg, dim=-1)
    return MogState(w, mean, var), fg
