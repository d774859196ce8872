"""Two-pass stabilization: estimate inter-frame motions, smooth the
accumulated trajectory, re-warp the frames (TwoPassStabilizer semantics);
the port of opencv_contrib_tpu/videostab/stabilizer.py.

The motions stay on the device: each pair's `reg.register_pyramid` (at
levels 3, 4 pyrdown launches a call) adds its parameters to a stacked
tensor, where the twin read each to the host. The trajectory is smoothed
in float64 (its running sum in the motions' dtype), as the twin's numpy
does, on the motions' device, and the
compensation rounds to float32 where the twin's `jnp.asarray(-p, float32)`
does.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch import reg
from opencv_contrib_tpu_torch.utils.device import as_float


def estimate_motions(frames, model: str = "similarity"):
    """Per-pair motion parameters p_i mapping frame i -> frame i+1 frame
    coordinates (the MotionEstimator role): (N-1, P), on the frames'
    device."""
    ps = [reg.register_pyramid(as_float(a), as_float(b), model=model, levels=3, iters=12)
          for a, b in zip(frames[:-1], frames[1:])]
    return torch.stack(ps)


def smooth_trajectory(motions, sigma: float = 2.0) -> torch.Tensor:
    """Gaussian-smooth the cumulative trajectory (edge-replicated); returns
    the per-frame compensation parameters (N, P) in float64 (the
    GaussianMotionFilter role)."""
    m = motions if isinstance(motions, torch.Tensor) else torch.as_tensor(np.asarray(motions))
    # the running sum in the motions' own dtype, one row after another (the twin's
    # np.cumsum; torch's CPU cumsum accumulates float32 in float64), the rest in float64
    rows = [m[0]]
    for k in range(1, m.shape[0]):
        rows.append(rows[-1] + m[k])
    traj = torch.cat([torch.zeros((1, m.shape[1]), dtype=torch.float64, device=m.device),
                      torch.stack(rows).to(torch.float64)])
    radius = max(1, int(3 * sigma))
    k = np.exp(-0.5 * (np.arange(-radius, radius + 1) / sigma) ** 2)
    k /= k.sum()
    padded = torch.cat([traj[:1].expand(radius, -1), traj, traj[-1:].expand(radius, -1)])
    # np.convolve's "valid" window, tap by tap (the kernel is symmetric)
    n = traj.shape[0]
    smoothed = sum(float(k[j]) * padded[j:j + n] for j in range(2 * radius + 1))
    return smoothed - traj  # compensation per frame


def stabilize(frames, model: str = "similarity", sigma: float = 2.0):
    """Full pipeline -> (stabilized frames, motions, compensations)."""
    motions = estimate_motions(frames, model)
    comp = smooth_trajectory(motions, sigma)
    out = [reg.warp_with_params(model, (-p).to(torch.float32), as_float(f)) for f, p in zip(frames, comp)]
    return out, motions, comp
