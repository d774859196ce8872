"""Learned structured edge detector, trained in-repo (the port of
opencv_contrib_tpu/ximgproc/edge_forest.py).

Reference anchor: ximgproc/src/structured_edge_detection.cpp:359-366
(StructuredEdgeDetection::detectEdges), which evaluates a shipped
random-forest model over 13-channel patch features. Here, as in the JAX
version: the same channel-feature family (multi-scale gradient magnitude,
soft orientation channels, intensity) with 3x3 spatial context by shifted
channel stacking, scored by a small MLP and trained on synthetic boundary
supervision.

`train` draws its initial weights from a `torch.Generator` seeded by
`seed` unless it is given them (`interop.edge_forest_params` carries the
JAX package's draws across); its Adam is written out as the JAX version's,
with the same moments and bias correction, not `torch.optim.Adam`. The
features do not depend on the weights, so they are built once for the
training set. `structured_edges` trains the default model on first use, on
the device of the image it is given, and keeps it per device."""

from __future__ import annotations

import math

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision

N_ORIENT = 4


def _channels(img: torch.Tensor) -> torch.Tensor:
    """(C, H, W) per-pixel channels: intensity, 2-scale gradient magnitude,
    4 soft orientation channels (the reference's gradient channel family)."""
    chans = [img]
    for s in (1.0, 2.0):
        g = filters.gaussian_blur(img, s)
        gy, gx = filters.gradients(g)
        mag = torch.sqrt(gy * gy + gx * gx)
        chans.append(mag)
        if s == 1.0:
            ang = torch.atan2(gy, gx)
            for k in range(N_ORIENT):
                a0 = -math.pi + (2 * math.pi) * k / N_ORIENT
                chans.append(mag * torch.cos(ang - a0) ** 2)
    return torch.stack(chans)  # (7, H, W)


_OFFSETS = [(dy, dx) for dy in (-2, 0, 2) for dx in (-2, 0, 2)]


def _features(img: torch.Tensor) -> torch.Tensor:
    """(H, W, D) feature rows: channels at 9 shifted context positions."""
    ch = _channels(img)  # (C, H, W)
    F = torch.cat([torch.roll(ch, (dy, dx), dims=(1, 2)) for dy, dx in _OFFSETS], dim=0)  # (9C, H, W)
    return torch.movedim(F, 0, -1)


def _predict(params: dict, f: torch.Tensor) -> torch.Tensor:
    h = torch.relu(f @ params["W1"] + params["b1"])
    return torch.sigmoid(h @ params["W2"] + params["b2"])[..., 0]


def _predict_map(params: dict, img: torch.Tensor) -> torch.Tensor:
    with f32_matmul_precision():
        return _predict(params, _features(img))


def _synthetic_scene(rng, H=96, W=96):
    """Random ellipse regions with distinct intensities AND intra-region
    texture (stripes/noise); ground truth = region boundaries only. The
    texture is the point: plain gradient detectors fire on it, the learned
    model must suppress it. numpy, as the JAX version's."""
    lab = np.zeros((H, W), np.int32)
    img = np.full((H, W), rng.uniform(0.2, 0.5), np.float32)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    for i in range(1, rng.integers(3, 6)):
        cy, cx = rng.uniform(10, H - 10), rng.uniform(10, W - 10)
        a, b = rng.uniform(8, 28, 2)
        th = rng.uniform(0, np.pi)
        ry = (yy - cy) * np.cos(th) + (xx - cx) * np.sin(th)
        rx = -(yy - cy) * np.sin(th) + (xx - cx) * np.cos(th)
        m = (ry / a) ** 2 + (rx / b) ** 2 < 1
        lab[m] = i
        img[m] = rng.uniform(0.1, 0.9)
    # per-region texture: oriented stripes at random frequency/phase
    for i in range(int(lab.max()) + 1):
        m = lab == i
        if not m.any() or rng.random() < 0.3:
            continue
        fth = rng.uniform(0, np.pi)
        freq = rng.uniform(0.4, 1.2)
        phase = rng.uniform(0, 2 * np.pi)
        stripes = 0.08 * np.sin(freq * (yy * np.cos(fth) + xx * np.sin(fth)) + phase)
        img = np.where(m, img + stripes, img)
    edge = np.zeros((H, W), bool)
    edge[:-1] |= lab[:-1] != lab[1:]
    edge[:, :-1] |= lab[:, :-1] != lab[:, 1:]
    # photometric nuisance
    img = img + rng.normal(0, 0.02, img.shape)
    from scipy.ndimage import gaussian_filter
    img = gaussian_filter(img, rng.uniform(0.5, 1.2))
    return img.astype(np.float32), edge


def init_params(D: int, hidden: int, seed: int = 0, device="cpu") -> dict:
    """He-normal initial weights from a CPU `torch.Generator` seeded by
    seed (the same draws on every device), zero biases."""
    gen = torch.Generator().manual_seed(seed)
    W1 = torch.randn((D, hidden), generator=gen) * np.float32(np.sqrt(2.0 / D))
    W2 = torch.randn((hidden, 1), generator=gen) * np.float32(np.sqrt(2.0 / hidden))
    return {"W1": W1.to(device), "b1": torch.zeros(hidden, device=device), "W2": W2.to(device),
            "b2": torch.zeros(1, device=device)}


def train(n_images: int = 40, steps: int = 400, lr: float = 3e-3, hidden: int = 32, seed: int = 0,
          init: dict | None = None, device="cpu") -> dict:
    """Train the edge MLP on synthetic boundary supervision (the scenes from
    numpy's default_rng(seed), as the JAX version's) on `device`. init: the
    initial parameters (e.g. `interop.edge_forest_params` of the JAX
    package's draws); by default `init_params(D, hidden, seed)`. Returns the
    parameter dict for structured_edges."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    imgs, gts = [], []
    for _ in range(n_images):
        im, ed = _synthetic_scene(rng)
        imgs.append(im)
        gts.append(ed)
    # soft targets: the 1px halo around the boundary is ignored
    gt = np.stack(gts)
    near = gt.copy()
    for dy, dx in ((0, 1), (1, 0), (0, -1), (-1, 0)):
        near |= np.roll(gt, (dy, dx), (1, 2))
    target = torch.from_numpy(gt.astype(np.float32)).to(dev)
    weight = torch.from_numpy(np.where(gt, 6.0, np.where(near, 0.0, 1.0)).astype(np.float32)).to(dev)
    feats = torch.stack([_features(torch.from_numpy(im).to(dev)) for im in imgs])  # (B, H, W, D)

    D = 7 * len(_OFFSETS)
    params = init if init is not None else init_params(D, hidden, seed, dev)
    params = {k: v.detach().to(dev, torch.float32).clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    f32 = np.float32
    with f32_matmul_precision():
        for t in range(1, steps + 1):
            p = {k: x.requires_grad_(True) for k, x in params.items()}
            pred = _predict(p, feats)
            bce = -(target * torch.log(pred + 1e-7) + (1 - target) * torch.log(1 - pred + 1e-7))
            loss = (bce * weight).mean()
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            # the bias corrections in float32, as the JAX version's traced step count
            c1 = float(f32(1) - f32(0.9) ** f32(t))
            c2 = float(f32(1) - f32(0.999) ** f32(t))
            with torch.no_grad():
                for k in params:
                    g = grads[k]
                    m[k] = 0.9 * m[k] + 0.1 * g
                    v[k] = 0.999 * v[k] + 0.001 * g * g
                    mh = m[k] / c1
                    vh = v[k] / c2
                    params[k] = params[k].detach() - lr * mh / (torch.sqrt(vh) + 1e-8)
    return {k: x.detach() for k, x in params.items()}


_DEFAULT_PARAMS: dict = {}


def structured_edges(img: torch.Tensor, params: dict | None = None) -> torch.Tensor:
    """Learned edge probability map in [0, 1]
    (StructuredEdgeDetection::detectEdges contract,
    structured_edge_detection.hpp:97). Trains the default model on first
    use on img's device (kept per device in the process; pass params to
    reuse across processes)."""
    img = img.to(torch.float32)
    if params is None:
        key = str(img.device)
        if key not in _DEFAULT_PARAMS:
            _DEFAULT_PARAMS[key] = train(device=img.device)
        params = _DEFAULT_PARAMS[key]
    return _predict_map(params, img)


def edges_nms(e: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Orientation-selective thinning of an edge map (edgesNms role)."""
    from opencv_contrib_tpu_torch.ximgproc.edges import _nms4

    return _nms4(e, img.to(torch.float32), 1.0)
