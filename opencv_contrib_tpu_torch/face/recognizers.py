"""Face recognizers: PCA (eigenfaces), LDA (fisherfaces), LBP histograms (the
port of opencv_contrib_tpu/face/recognizers.py).

Each follows the reference's train/predict/save/load contract; the linear
algebra runs on the images' device in full f32 products. Distances: L2 in
subspace (eigen/fisher), chi-square (LBPH). `predict` returns host numbers,
as the twin's does.

`jnp.linalg.eigh` symmetrizes its input ((A + A^T) / 2) and FisherFaces
hands it solve(Sw, Sb), which is not symmetric; `torch.linalg.eigh` reads
one triangle only, so the port symmetrizes first. SVD and eigh bases are
free up to each column's sign: labels, distances and the subspace's
projector are what match the twin.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opencv_contrib_tpu_torch.utils.device import as_float, constant
from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision


class SubspaceModel(NamedTuple):
    mean: torch.Tensor  # (D,)
    basis: torch.Tensor  # (D, K)
    projections: torch.Tensor  # (N, K)
    labels: torch.Tensor  # (N,)


def _stack(images) -> torch.Tensor:
    """Images (a list of (H, W) arrays or tensors, or an (N, H, W) tensor) as
    (N, H, W) float32 on their device (the CPU for host data)."""
    if isinstance(images, torch.Tensor):
        return images.to(torch.float32)
    return torch.stack([as_float(im) for im in images])


def _labels(labels, device) -> torch.Tensor:
    if isinstance(labels, torch.Tensor):
        return labels.to(device=device, dtype=torch.int32)
    return constant(np.asarray(labels), device, torch.int32)


def _nearest(m: SubspaceModel, image):
    x = as_float(image).to(m.mean.device).reshape(-1) - m.mean
    with f32_matmul_precision():
        p = x @ m.basis
    d = torch.sum((m.projections - p[None]) ** 2, dim=1)
    return _read_best(m.labels, torch.sqrt(d), torch.argmin(d))


def _read_best(labels, dist, i):
    """(label, distance) at index i (a 0-dim device tensor) as host numbers,
    in one read (float64 holds either exactly); a 1-element index, since
    indexing by a 0-dim tensor reads it on the host."""
    i = i.reshape(1)
    label, d = torch.cat([labels.index_select(0, i).to(torch.float64), dist.index_select(0, i).to(torch.float64)]).tolist()
    return int(label), d


class EigenFaces:
    """PCA subspace recognizer (EigenFaces parity)."""

    def __init__(self, n_components: int = 16):
        self.n_components = n_components
        self.model: SubspaceModel | None = None

    def train(self, images, labels):
        X = _stack(images)
        X = X.reshape(X.shape[0], -1)
        labels = _labels(labels, X.device)
        mean = X.mean(dim=0)
        Xc = X - mean
        # eigen via SVD of the centered data
        with f32_matmul_precision():
            _, _, Vt = torch.linalg.svd(Xc, full_matrices=False)
            K = min(self.n_components, Vt.shape[0])
            basis = Vt[:K].T  # (D, K)
            proj = Xc @ basis
        self.model = SubspaceModel(mean, basis, proj, labels)
        return self

    def predict(self, image):
        return _nearest(self.model, image)

    def save(self, path):
        np.savez(path, **{k: v.detach().cpu().numpy() for k, v in self.model._asdict().items()})

    def load(self, path, device="cpu"):
        d = np.load(path)
        self.model = SubspaceModel(*(torch.from_numpy(d[k]).to(device) for k in SubspaceModel._fields))
        return self


class FisherFaces:
    """PCA -> LDA recognizer (FisherFaces parity)."""

    def __init__(self, n_components: int | None = None):
        self.n_components = n_components
        self.model: SubspaceModel | None = None

    def train(self, images, labels):
        X = _stack(images)
        X = X.reshape(X.shape[0], -1)
        dev = X.device
        y = labels.detach().cpu().numpy() if isinstance(labels, torch.Tensor) else np.asarray(labels)
        classes = np.unique(y)
        C = len(classes)
        N = X.shape[0]
        mean = X.mean(dim=0)
        Xc = X - mean
        with f32_matmul_precision():
            # PCA to N - C dims first (standard fisherfaces recipe)
            _, _, Vt = torch.linalg.svd(Xc, full_matrices=False)
            Kp = max(min(N - C, Vt.shape[0]), 1)
            W_pca = Vt[:Kp].T
            Z = Xc @ W_pca  # (N, Kp)

            # LDA in PCA space
            Sw = torch.zeros((Kp, Kp), device=dev)
            Sb = torch.zeros((Kp, Kp), device=dev)
            zmean = Z.mean(dim=0)
            for c in classes:
                Zc = Z.index_select(0, constant(np.flatnonzero(y == c), dev, torch.int64))
                mu = Zc.mean(dim=0)
                d = Zc - mu
                Sw = Sw + d.T @ d
                mb = (mu - zmean)[:, None]
                Sb = Sb + Zc.shape[0] * (mb @ mb.T)
            A = torch.linalg.solve_ex(Sw + 1e-6 * torch.eye(Kp, device=dev), Sb)[0]
            _, evecs = torch.linalg.eigh((A + A.T) / 2)  # jnp.linalg.eigh's symmetrize_input
            K = self.n_components or (C - 1)
            W_lda = evecs.flip(1)[:, :K]
            basis = W_pca @ W_lda  # (D, K)
            proj = Xc @ basis
        self.model = SubspaceModel(mean, basis, proj, _labels(y, dev))
        return self

    def predict(self, image):
        return _nearest(self.model, image)


def lbp_image(img: torch.Tensor) -> torch.Tensor:
    """8-neighbor local binary pattern codes (0..255) per pixel of (..., H,
    W) (the shifts wrap, as the twin's rolls)."""
    shifts = [(-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1)]
    code = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    for i, (dy, dx) in enumerate(shifts):
        code = code | ((torch.roll(img, (dy, dx), (-2, -1)) >= img).to(torch.int32) << i)
    return code


def _lbph_features(img: torch.Tensor, grid: int = 8) -> torch.Tensor:
    """Spatial grid of LBP histograms -> (grid*grid*256,) L1-normalized; a
    stack (N, H, W) gives (N, grid*grid*256)."""
    code = lbp_image(as_float(img))
    H, W = code.shape[-2:]
    th, tw = H // grid, W // grid
    code = code[..., : th * grid, : tw * grid]
    lead = code.shape[:-2]
    cells = code.reshape(*lead, grid, th, grid, tw).transpose(-3, -2).reshape(*lead, grid * grid, -1)
    counts = torch.ones(cells.shape, device=cells.device)  # integer counts: exact in any order of adds
    hists = torch.zeros(cells.shape[:-1] + (256,), device=cells.device).scatter_add_(-1, cells.long(), counts)
    hists = hists / torch.clamp(hists.sum(dim=-1, keepdim=True), min=1.0)
    return hists.reshape(*lead, -1)


class LBPH:
    """Local-binary-pattern histogram recognizer (LBPH parity); chi-square
    nearest neighbor over grid histograms. A training set's histograms are
    one batched call."""

    def __init__(self, grid: int = 8):
        self.grid = grid
        self.features = None
        self.labels = None

    def train(self, images, labels):
        self.features = _lbph_features(_stack(images), self.grid)
        self.labels = _labels(labels, self.features.device)
        return self

    def update(self, images, labels):
        """Incremental training (LBPH supports update() in the reference)."""
        f = _lbph_features(_stack(images).to(self.features.device), self.grid)
        self.features = torch.cat([self.features, f])
        self.labels = torch.cat([self.labels, _labels(labels, self.features.device)])
        return self

    def predict(self, image):
        f = _lbph_features(as_float(image).to(self.features.device), self.grid)
        chi2 = torch.sum((self.features - f[None]) ** 2 / torch.clamp(self.features + f[None], min=1e-9), dim=1)
        return _read_best(self.labels, chi2, torch.argmin(chi2))
