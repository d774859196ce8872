"""Random-pattern calibration: corner finder via feature matching (the port
of opencv_contrib_tpu/ccalib/random_pattern.py).

Reference anchor: ccalib/src/randpattern.cpp (RandomPatternCornerFinder:
SIFT-match the captured image against the known random pattern, RANSAC a
homography, keep inliers as 2D-3D correspondences; RandomPatternGenerator
renders the pattern). multicalib.cpp consumes these per-camera
correspondences.

The feature front-end is the port's Harris + SURF + cross-checked ratio
test (knn2 on the card); the homography RANSAC draws its hypotheses from an
explicit `torch.Generator` (the twin's JAX PRNG key). The result is read
to the host once.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.features import describe, detect, match
from opencv_contrib_tpu_torch.mvg.robust import homography_robust
from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.utils.device import as_float, to_device


def generate_pattern(shape=(160, 200), seed: int = 7, sigma: float = 1.2):
    """RandomPatternGenerator: smoothed binary noise pattern (numpy)."""
    rng = np.random.default_rng(seed)
    img = (rng.uniform(0, 1, shape) > 0.5).astype(np.float32)
    return filters.gaussian_blur(torch.from_numpy(img), sigma).numpy()


def find_correspondences(pattern, img, pattern_size_m=(0.16, 0.20),
                         max_keypoints: int = 512, ratio: float = 0.85,
                         inlier_px: float = 3.0, key=None):
    """Match image -> pattern and return (obj_pts (N, 3) meters on z=0,
    img_pts (N, 2) pixels, n_inliers): the
    CornerFinder::computeObjectImagePointsForSingle contract. Runs on img's
    device (the CPU for host arrays); `key` is the RANSAC's
    torch.Generator on that device (default: seeded with 0)."""
    im = as_float(img)
    dev = im.device
    pat = to_device(pattern, dev)
    if key is None:
        key = torch.Generator(device=dev).manual_seed(0)
    k1 = detect.harris(pat, max_keypoints=max_keypoints)
    k2 = detect.harris(im, max_keypoints=max_keypoints)
    d1 = describe.surf_describe(pat, k1)
    d2 = describe.surf_describe(im, k2)
    m = match.ratio_test_match(d2, d1, k2.valid, k1.valid, ratio=ratio)
    xy_img = torch.stack([k2.x, k2.y], 1)
    xy_pat = torch.stack([k1.x, k1.y], 1)[m.train_idx.to(torch.int64)]

    res = homography_robust(key, xy_img, xy_pat, threshold_px=inlier_px, mask=m.valid, n_hypotheses=128)
    inl = res.inliers & m.valid
    host = torch.cat([xy_img, xy_pat, inl[:, None].to(torch.float32)], 1).cpu().numpy()  # one read
    inl = host[:, 4] > 0.5
    H_pat, W_pat = np.shape(pattern)[:2]
    sy = pattern_size_m[0] / H_pat
    sx = pattern_size_m[1] / W_pat
    pat_xy = host[inl, 2:4]
    obj = np.stack([pat_xy[:, 0] * sx, pat_xy[:, 1] * sy, np.zeros(inl.sum())], 1)
    img_pts = host[inl, 0:2]
    return obj.astype(np.float32), img_pts.astype(np.float32), int(inl.sum())
