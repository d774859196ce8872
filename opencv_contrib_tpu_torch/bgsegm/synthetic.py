"""Synthetic moving-object sequence generator (the port of
opencv_contrib_tpu/bgsegm/synthetic.py, plain numpy as there).

Parity: bgsegm's SyntheticSequenceGenerator (bgsegm.hpp) — a background
image with a moving foreground patch + noise, used to test the subtractors.
"""

from __future__ import annotations

import numpy as np


def synthetic_sequence(n_frames: int = 30, shape=(64, 64), obj_size: int = 10, noise: float = 0.01, seed: int = 0):
    """Yields (frame (H, W) float32, gt_mask (H, W) bool)."""
    rng = np.random.default_rng(seed)
    H, W = shape
    bg = rng.uniform(0.2, 0.8, size=shape).astype(np.float32)
    for i in range(n_frames):
        frame = bg + rng.normal(scale=noise, size=shape).astype(np.float32)
        mask = np.zeros(shape, bool)
        cy = H // 2
        cx = int((i / max(n_frames - 1, 1)) * (W - obj_size))
        frame[cy : cy + obj_size, cx : cx + obj_size] = 0.95
        mask[cy : cy + obj_size, cx : cx + obj_size] = True
        yield frame, mask
