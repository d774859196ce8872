"""Learned descriptors: VGG-class float and BoostDesc-class binary (the port
of opencv_contrib_tpu/features/learned.py).

The raw feature is a rotated gradient grid soft-assigned to 8 orientations
and pooled into 4x4 cells (128-d). The projection W is trained here on
synthetic patches and their warped copies: the generalised eigenvectors of
(S_w + eps I)^-1 S_t, directions that vary across patches but not under the
warp. `eigh` leaves each eigenvector's sign free, so two solvers may give W
with some columns negated; VGG descriptors then differ by those signs and
match the same.

The random draws go through `_normal` and `_uniform` on a `torch.Generator`
made on the CPU, so a card and the CPU draw the same numbers. `load_projection`
reads the npz that either package's `save_projection` writes: it carries a W
trained by the JAX package into the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from opencv_contrib_tpu_torch.features import keypoints as kp_mod
from opencv_contrib_tpu_torch.features.describe import _signs, pack_bits
from opencv_contrib_tpu_torch.features.keypoints import Keypoints
from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.image import sample_bilinear_multi
from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision

RAW_DIM = 4 * 4 * 8  # spatial 4x4 cells x 8 orientation bins


def pooled_gradient_raw(img: torch.Tensor, kps: Keypoints, n_samples: int = 20) -> torch.Tensor:
    """Raw patch feature (K, 128): a rotated n x n gradient grid soft-assigned
    to 8 orientation bins and pooled into 4x4 cells, L2-normalised."""
    gy, gx = filters.gradients(filters.gaussian_blur(img, 1.0))
    n = n_samples
    u = (torch.arange(n, dtype=torch.float32, device=img.device) - n / 2 + 0.5) * (20.0 / n)
    gyy, gxx = torch.meshgrid(u, u, indexing="ij")
    w = torch.exp(-(gxx ** 2 + gyy ** 2) / (2 * 6.6 ** 2))
    c = torch.cos(kps.angle)[:, None, None]
    s = torch.sin(kps.angle)[:, None, None]
    sc = kps.scale[:, None, None]
    px = kps.x[:, None, None] + sc * (c * gxx[None] - s * gyy[None])
    py = kps.y[:, None, None] + sc * (s * gxx[None] + c * gyy[None])
    sgx, sgy = sample_bilinear_multi(torch.stack([gx, gy]), py, px)
    rx = c * sgx + s * sgy
    ry = -s * sgx + c * sgy
    mag = torch.sqrt(rx * rx + ry * ry) * w[None]
    ang = torch.atan2(ry, rx)
    kbin = torch.arange(8, dtype=torch.float32, device=img.device) * (2 * math.pi / 8) - math.pi
    resp = torch.clamp(torch.cos(ang[..., None] - kbin), min=0.0) ** 3 * mag[..., None]
    K = kps.capacity
    cell = n // 4
    raw = resp.reshape(K, 4, cell, 4, cell, 8).sum(dim=(2, 4)).reshape(K, RAW_DIM)
    raw = raw / (torch.linalg.norm(raw, dim=-1, keepdim=True) + 1e-12)
    return raw * kps.valid[:, None]


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard normal draws (float32, CPU) from gen."""
    return torch.randn(shape, generator=gen)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    """Uniform draws on [lo, hi) (float32, CPU) from gen."""
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


def _synthetic_patches(gen: torch.Generator, n: int, size: int = 64, device="cpu") -> torch.Tensor:
    """n textured patches (n, size, size): smoothed noise plus a random
    oriented step edge through the centre, each normalised to zero mean and
    unit deviation."""
    noise = _normal(gen, (n, size, size)).to(device)
    smooth = filters.fast_gaussian_blur(noise, 2.0)
    th = _uniform(gen, (n,), 0.0, math.pi).to(device)
    amp = _uniform(gen, (n, 1, 1), 0.0, 1.5).to(device)
    r = torch.arange(size, dtype=torch.float32, device=device) - size / 2
    yy, xx = torch.meshgrid(r, r, indexing="ij")
    d = torch.cos(th)[:, None, None] * xx[None] + torch.sin(th)[:, None, None] * yy[None]
    p = smooth + torch.tanh(d / 2.0) * amp
    return (p - p.mean(dim=(1, 2), keepdim=True)) / (p.std(dim=(1, 2), keepdim=True, correction=0) + 1e-6)


def _center_kp(size: int, angle, scale, device="cpu") -> Keypoints:
    return kp_mod.from_arrays(y=[size / 2.0], x=[size / 2.0], scale=[float(scale)], angle=[float(angle)],
                              device=device)


def train_projection(seed: int = 0, n_patches: int = 512, out_dim: int = 120, eps: float = 1e-3,
                     device="cpu") -> torch.Tensor:
    """Learn W (RAW_DIM, out_dim): the top out_dim generalised eigenvectors
    of (S_w + eps I)^-1 S_t, each column of unit norm. The draws come from
    a CPU generator seeded with `seed`; the work runs on `device`."""
    gen = torch.Generator().manual_seed(seed)
    patches = _synthetic_patches(gen, n_patches, device=device)
    size = patches.shape[1]
    d_ang = _uniform(gen, (n_patches,), -0.35, 0.35)
    d_sc = torch.exp(_uniform(gen, (n_patches,), -0.2, 0.2))
    noise = 0.05 * _normal(gen, tuple(patches.shape)).to(device)

    def feats(p, ang, sc):
        return pooled_gradient_raw(p, _center_kp(size, ang, 2.0 * sc, device))[0]

    fa = torch.stack([feats(p, 0.0, 1.0) for p in patches])
    fb = torch.stack([feats(p, a, s) for p, a, s in zip(patches + noise, d_ang.tolist(), d_sc.tolist())])
    eye = torch.eye(RAW_DIM, device=device)
    with f32_matmul_precision():
        diff = fa - fb
        S_w = diff.T @ diff / n_patches + eps * eye
        allf = torch.cat([fa, fb])
        allf = allf - allf.mean(0)
        S_t = allf.T @ allf / allf.shape[0]
        L = torch.linalg.cholesky(S_w)
        Li = torch.linalg.solve_triangular(L, eye, upper=False)
        _, evecs = torch.linalg.eigh(Li @ S_t @ Li.T)
        W = Li.T @ torch.flip(evecs, [1])[:, :out_dim]
    return W / (torch.linalg.norm(W, dim=0, keepdim=True) + 1e-12)


_CACHED_W: dict = {}


def default_projection(out_dim: int = 120, device="cpu") -> torch.Tensor:
    """train_projection(out_dim=out_dim), trained once a process on the CPU
    and kept, with its copy on each device asked for."""
    device = torch.device(device)
    if (out_dim, device) not in _CACHED_W:
        W = _CACHED_W.get((out_dim, torch.device("cpu")))
        if W is None:
            W = _CACHED_W[(out_dim, torch.device("cpu"))] = train_projection(out_dim=out_dim)
        _CACHED_W[(out_dim, device)] = W.to(device)
    return _CACHED_W[(out_dim, device)]


def save_projection(path: str, W) -> None:
    np.savez(path, W=np.asarray(W.detach().cpu() if isinstance(W, torch.Tensor) else W))


def load_projection(path: str, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.asarray(np.load(path)["W"], np.float32)).to(device)


def vgg_describe(img: torch.Tensor, kps: Keypoints, W=None) -> torch.Tensor:
    """VGG-class float descriptor (K, out_dim): the learned projection of the
    pooled gradients, L2-normalised."""
    if W is None:
        W = default_projection(device=img.device)
    with f32_matmul_precision():
        d = pooled_gradient_raw(img, kps) @ W
    d = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-12)
    return d * kps.valid[:, None]


def boostdesc_describe(img: torch.Tensor, kps: Keypoints, W=None, n_bits: int = 128):
    """BoostDesc-class binary descriptor: the signs of the learned
    projections of the centred raw feature. Returns (packed, signs)."""
    if W is None:
        W = default_projection(out_dim=n_bits, device=img.device)
    raw = pooled_gradient_raw(img, kps)
    with f32_matmul_precision():
        proj = (raw - raw.mean(-1, keepdim=True)) @ W[:, :n_bits]
    bits = proj > 0
    return pack_bits(bits), _signs(bits, kps.valid)
