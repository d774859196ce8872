"""HFS segmentation stages (the port of opencv_contrib_tpu/hfs/segment.py;
hfs/src/hfs_core.cpp semantics).

The region sums are `ops.segment` sums, the same bits on a rerun on the
card. `region_adjacency` scatters only the boundary pairs (a != b): the JAX
version also sends every equal-label pair, which adds exactly 0 to the
diagonal; here those pairs go to ccl.DUMP_SLOTS spare slots past the R x R
table, so no slot collects most of the image (the card's ordered
accumulation walks a slot's run serially). The host stages (`_merge`, the
stage-2 graph) are the JAX version's numpy, on one read of the device
results."""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.ccl import DUMP_SLOTS
from opencv_contrib_tpu_torch.ops.segment import segment_count, segment_sum
from opencv_contrib_tpu_torch.ximgproc.slic import slic
from opencv_contrib_tpu_torch.utils.device import as_float


def region_features(img: torch.Tensor, labels: torch.Tensor, n_regions: int):
    """Per-superpixel mean color and size via segment sums (the device half
    of the reference's feature extraction). Returns (mean (R, C), cnt (R,))."""
    img = img.to(torch.float32)
    if img.ndim == 2:
        img = img[..., None]
    C = img.shape[-1]
    flat = labels.reshape(-1)
    cnt = segment_count(flat, n_regions)
    mean = segment_sum(flat, img.reshape(-1, C), n_regions) / torch.clamp(cnt, min=1)[:, None]
    return mean, cnt


def region_adjacency(img: torch.Tensor, labels: torch.Tensor, n_regions: int):
    """Boundary-weighted adjacency: for each horizontally/vertically
    adjacent label pair, the boundary length and the summed gradient
    magnitude along the shared boundary. Returns dense (R, R) matrices
    (len, grad_sum)."""
    img = img.to(torch.float32)
    g = img if img.ndim == 2 else img.mean(-1)
    gy, gx = filters.gradients(g)
    mag = torch.sqrt(gy * gy + gx * gx)
    RR = n_regions * n_regions
    labels = labels.to(torch.int64)

    def acc(a, b, m):
        a, b, m = a.reshape(-1), b.reshape(-1), m.reshape(-1)
        boundary = a != b
        spare = RR + torch.remainder(torch.arange(a.shape[0], device=a.device), DUMP_SLOTS)
        slot = torch.where(boundary, a * n_regions + b, spare)
        vals = torch.stack([boundary.to(torch.float32), torch.where(boundary, m, 0.0)], 1)
        out = segment_sum(slot, vals, RR + DUMP_SLOTS)[:RR]
        return out[:, 0], out[:, 1]

    l1, g1 = acc(labels[:, :-1], labels[:, 1:], 0.5 * (mag[:, :-1] + mag[:, 1:]))
    l2, g2 = acc(labels[:-1, :], labels[1:, :], 0.5 * (mag[:-1, :] + mag[1:, :]))
    L = (l1 + l2).reshape(n_regions, n_regions)
    G = (g1 + g2).reshape(n_regions, n_regions)
    return L + L.T, G + G.T


def _merge(edges, weights, sizes, n, threshold: float):
    """Felzenszwalb merge on the region graph: join components when the
    edge weight is below min(internal + k/size) of both sides (host
    union-find, as in the reference's CPU merge stage)."""
    parent = np.arange(n)
    internal = np.zeros(n)
    size = sizes.copy()

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    order = np.argsort(weights)
    for ei in order:
        a, b = edges[ei]
        w = weights[ei]
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        ta = internal[ra] + threshold / max(size[ra], 1)
        tb = internal[rb] + threshold / max(size[rb], 1)
        if w <= min(ta, tb):
            parent[rb] = ra
            size[ra] += size[rb]
            internal[ra] = max(internal[ra], internal[rb], w)
    roots = np.array([find(i) for i in range(n)])
    _, remap = np.unique(roots, return_inverse=True)
    return remap


def hfs_segment(img, grid: int = 12, seg_thresh1: float = 0.1, seg_thresh2: float = 0.3, w_color: float = 1.0,
                w_grad: float = 0.5, slic_iters: int = 6):
    """Two-stage HFS segmentation (HfsSegment::performSegment*): stage 1
    merges superpixels by color + boundary-gradient affinity; stage 2
    re-merges the stage-1 regions with a looser threshold. img a tensor (on
    the device it runs on) or host data (the CPU). Returns an (H, W) int
    numpy segment map; the host reads the device results once."""
    img = as_float(img)
    labels, _ = slic(img, grid=grid, n_iters=slic_iters)
    n = grid * grid
    mean, _ = region_features(img, labels, n)
    L, G = region_adjacency(img, labels, n)
    C = mean.shape[1]
    # one copy to the host: the adjacency, the means and the labels (exact in float32)
    host = torch.cat([L.reshape(-1), G.reshape(-1), mean.reshape(-1), labels.reshape(-1).to(torch.float32)]).cpu()
    Lnp, Gnp, meann, lab = np.split(host.numpy(), [n * n, 2 * n * n, 2 * n * n + n * C])
    Lnp, Gnp, meann = Lnp.reshape(n, n), Gnp.reshape(n, n), meann.reshape(n, C)
    lab = lab.astype(np.int32).reshape(labels.shape)
    ii, jj = np.nonzero(np.triu(Lnp, 1))
    if ii.size == 0:
        return lab
    color_d = np.linalg.norm(meann[ii] - meann[jj], axis=1)
    grad_d = Gnp[ii, jj] / np.maximum(Lnp[ii, jj], 1)
    w = w_color * color_d + w_grad * grad_d

    edges = np.stack([ii, jj], axis=1)
    # Felzenszwalb's tau = k/|C| uses REGION counts here (superpixels are
    # the graph nodes), not pixel counts
    remap1 = _merge(edges, w, np.ones(n), n, seg_thresh1)
    # stage 2 on the coarsened graph
    n2 = remap1.max() + 1
    s2 = np.zeros(n2)
    for r in range(n):
        s2[remap1[r]] += 1.0
    e2w = {}
    for (a, b), ww in zip(edges, w):
        ra, rb = remap1[a], remap1[b]
        if ra == rb:
            continue
        k = (min(ra, rb), max(ra, rb))
        e2w[k] = min(e2w.get(k, np.inf), ww)
    if e2w:
        e2 = np.array(list(e2w.keys()))
        w2 = np.array(list(e2w.values()))
        remap2 = _merge(e2, w2, s2, n2, seg_thresh2)
    else:
        remap2 = np.arange(n2)
    final = remap2[remap1]
    return final[lab]
