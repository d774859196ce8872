"""Point-pair-feature detection (Drost et al., the reference's
PPF3DDetector), the port of opencv_contrib_tpu/surface_matching/ppf.py.

PPF(p1, p2) = (|d|, angle(n1, d), angle(n2, d), angle(n1, n2)), quantized.
Training hashes model pair features; matching votes over (model reference
point, rotation angle) for scene pairs with matching features.

The model's keys are sorted stably (`torch.argsort(stable=True)`, as
`jnp.argsort` sorts), so equal keys keep their pair order and the linear
probe after `searchsorted` sees the twin's entries. The best vote is the
first maximum, as XLA's argmax takes it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from opencv_contrib_tpu_torch.utils.device import as_float, constant, to_device

_NO_KEY = 2 ** 31 - 1  # the key of a point paired with itself: sorts last, matches nothing


def compute_ppf_features(p1, n1, p2, n2):
    """Batched PPF: p*, n* (..., 3) -> (..., 4)."""
    d = p2 - p1
    dn = torch.linalg.norm(d, dim=-1)
    dhat = d / torch.clamp(dn[..., None], min=1e-9)

    def ang(a, b):
        return torch.arccos(torch.clamp(torch.sum(a * b, dim=-1), -1.0, 1.0))

    return torch.stack([dn, ang(n1, dhat), ang(n2, dhat), ang(n1, n2)], dim=-1)


def _quantize(f, dist_step, angle_step):
    """Each feature over its step, truncated to int32 (0-dim float32 tensor
    steps: a true float32 quotient on every device), 7 bits each."""
    q0 = (f[..., 0] / dist_step).to(torch.int32)
    q1 = (f[..., 1] / angle_step).to(torch.int32)
    q2 = (f[..., 2] / angle_step).to(torch.int32)
    q3 = (f[..., 3] / angle_step).to(torch.int32)
    return ((torch.clamp(q0, 0, 127) << 21) | (torch.clamp(q1, 0, 127) << 14) | (torch.clamp(q2, 0, 127) << 7)
            | torch.clamp(q3, 0, 127))


def _helper_axis(z):
    """[1, 0, 0] where |z_x| < 0.9, else [0, 1, 0]: the axis a frame about
    z is crossed from."""
    small = torch.abs(z[..., 0:1]) < 0.9
    one, zero = torch.ones_like(z[..., :1]), torch.zeros_like(z[..., :1])
    return torch.where(small, torch.cat([one, zero, zero], -1), torch.cat([zero, one, zero], -1))


def _pair_alpha(p1, n1, p2):
    """In-plane rotation angle of the pair about the reference normal
    (the alpha_m of the Drost voting scheme)."""
    z = n1
    x = torch.linalg.cross(_helper_axis(z), z)
    x = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-9)
    y = torch.linalg.cross(z, x)
    d = p2 - p1
    return torch.atan2(torch.sum(d * y, dim=-1), torch.sum(d * x, dim=-1))


class PPFModel(NamedTuple):
    points: torch.Tensor  # (M, 3) sampled model points
    normals: torch.Tensor  # (M, 3)
    keys: torch.Tensor  # (P,) sorted quantized features of model pairs, int32
    ref_idx: torch.Tensor  # (P,) reference (first) point index per pair, int32
    alpha: torch.Tensor  # (P,) model in-plane angle per pair
    dist_step: torch.Tensor  # 0-dim float32
    angle_step: torch.Tensor  # 0-dim float32
    diameter: torch.Tensor  # 0-dim float32


def _pairs(M: int, device):
    i = torch.arange(M, device=device).repeat_interleave(M)
    j = torch.arange(M, device=device).repeat(M)
    return i, j


def train_model(points, normals, sampling_step: int = 2, dist_quant: float = 0.05, angle_bins: int = 30) -> PPFModel:
    """PPF3DDetector::trainModel: subsample, compute all pair features,
    sort by quantized key."""
    pts = as_float(points)[::sampling_step]
    nrm = to_device(normals, pts.device)[::sampling_step]
    M = pts.shape[0]
    diameter = torch.amax(torch.linalg.norm(pts[:, None] - pts[None], dim=-1))
    dist_step = dist_quant * diameter
    angle_step = constant(math.pi / angle_bins, pts.device)

    i, j = _pairs(M, pts.device)
    keep = i != j
    f = compute_ppf_features(pts[i], nrm[i], pts[j], nrm[j])
    keys = torch.where(keep, _quantize(f, dist_step, angle_step), torch.full_like(i, _NO_KEY, dtype=torch.int32))
    alpha = _pair_alpha(pts[i], nrm[i], pts[j])
    order = torch.argsort(keys, stable=True)
    return PPFModel(points=pts, normals=nrm, keys=keys[order], ref_idx=i[order].to(torch.int32),
                    alpha=alpha[order], dist_step=dist_step, angle_step=angle_step, diameter=diameter)


def match(model: PPFModel, scene_points, scene_normals, scene_step: int = 4, n_angle_bins: int = 30,
          max_matches_per_key: int = 8):
    """PPF3DDetector::match: for each scene reference point, vote over
    (model ref point, alpha difference) using pairs with matching features;
    return the best (R, t) hypothesis by vote count.

    Returns (T (4, 4) model->scene, votes), tensors on the model's device."""
    dev = model.points.device
    spts = to_device(scene_points, dev)[::scene_step]
    snrm = to_device(scene_normals, dev)[::scene_step]
    S = spts.shape[0]
    M = model.points.shape[0]
    A = n_angle_bins

    i, j = _pairs(S, dev)
    keep = i != j
    f = compute_ppf_features(spts[i], snrm[i], spts[j], snrm[j])
    keys = _quantize(f, model.dist_step, model.angle_step)
    alpha_s = _pair_alpha(spts[i], snrm[i], spts[j])

    # join scene pairs to model pairs via searchsorted + linear probe of
    # up to max_matches_per_key entries with the same key
    start = torch.searchsorted(model.keys, keys)
    P = model.keys.shape[0]
    acc = torch.zeros(S * M * A, device=dev)
    two_pi = 2 * math.pi
    for k in range(max_matches_per_key):
        idx = torch.clamp(start + k, 0, P - 1)
        ok = keep & (model.keys[idx] == keys)
        m_ref = model.ref_idx[idx].to(torch.int64)
        dalpha = model.alpha[idx] - alpha_s
        abin = (torch.remainder(dalpha + math.pi, two_pi) / two_pi * A).to(torch.int32)
        abin = torch.clamp(abin, 0, A - 1).to(torch.int64)
        # votes are 0 / 1 counts, integer-valued floats below 2^24: their
        # sums are exact in any order, so the accumulating scatter gives
        # the same bits on every run and device
        acc.index_put_(((i * M + m_ref) * A + abin,), ok.to(torch.float32), accumulate=True)

    best = torch.argmax(acc, dim=0, keepdim=True)  # (1,): indexing by it stays on the device
    votes = acc[best][0]
    s_ref = best // (M * A)
    m_ref = (best // A) % M
    abin = best % A
    alpha = (abin.to(torch.float32) + 0.5) / A * 2 * math.pi - math.pi

    # recover pose: align model ref point/normal to scene ref point/normal,
    # then rotate by alpha about the normal
    T = _pose_from_correspondence(model.points[m_ref][0], model.normals[m_ref][0], spts[s_ref][0],
                                  snrm[s_ref][0], alpha[0])
    return T, votes


def _axis_frame(n):
    z = n
    x = torch.linalg.cross(_helper_axis(z), z)
    x = x / torch.clamp(torch.linalg.norm(x), min=1e-9)
    y = torch.linalg.cross(z, x)
    return torch.stack([x, y, z], dim=0)  # rows


def _pose_from_correspondence(pm, nm, ps, ns, alpha):
    """T such that pm -> ps, nm -> ns, with in-plane rotation alpha."""
    Fm = _axis_frame(nm)  # model frame -> canonical
    Fs = _axis_frame(ns)
    c, s = torch.cos(alpha), torch.sin(alpha)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    Rz = torch.stack([torch.stack([c, -s, zero]), torch.stack([s, c, zero]), torch.stack([zero, zero, one])])
    R = Fs.T @ Rz @ Fm
    t = ps - R @ pm
    bottom = torch.stack([zero, zero, zero, one])[None]
    return torch.cat([torch.cat([R, t[:, None]], dim=1), bottom], dim=0)
