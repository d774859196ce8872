"""Graph segmentation + selective search proposals + EdgeBoxes (the port of
opencv_contrib_tpu/ximgproc/segmentation.py).

Reference anchors:
- GraphSegmentation (Felzenszwalb-Huttenlocher): ximgproc/src/
  graphsegmentation.cpp, header segmentation.hpp:46
- SelectiveSearchSegmentation: ximgproc/src/selectivesearchsegmentation.cpp
  (hierarchical region merging under color/texture/size/fill similarities,
  box proposals from the merge tree), header segmentation.hpp:109
- EdgeBoxes: ximgproc/src/edgeboxes.cpp (box objectness from edge groups
  wholly enclosed by the box)

The smoothing, the region features (color and texture histograms, sizes,
boxes) and the edge magnitude are device work, read by the host once a
call; the merge loops are the JAX version's host code (union-find over the
pixel graph, the greedy merge with its adjacency built in the same order,
so that `max` keeps the same pair at a tie; EdgeBoxes' float64 integral).
The region sums are `ops.segment` sums and the boxes scatter minima and
maxima, the same bits on a rerun on the card."""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.segment import segment_count, segment_sum
from opencv_contrib_tpu_torch.utils.device import as_float

N_TEX = 8


def graph_segment(img, k: float = 0.3, min_size: int = 20, sigma: float = 0.8):
    """Felzenszwalb pixel-graph segmentation (GraphSegmentation::process).
    Returns (H, W) int numpy labels. The smoothing on the device; the edge
    weights and the merge on the host."""
    from opencv_contrib_tpu_torch.hfs.segment import _merge  # here: hfs imports this package's slic

    img = as_float(img)
    s = filters.gaussian_blur(img, sigma).cpu().numpy()
    if s.ndim == 2:
        s = s[..., None]
    H, W, _ = s.shape
    idx = np.arange(H * W).reshape(H, W)

    def edge_set(a, b):
        w = np.linalg.norm(s.reshape(H, W, -1)[tuple(a)] - s.reshape(H, W, -1)[tuple(b)], axis=-1)
        return np.stack([idx[tuple(a)].reshape(-1), idx[tuple(b)].reshape(-1)], 1), w.reshape(-1)

    e1, w1 = edge_set((slice(None), slice(0, W - 1)), (slice(None), slice(1, W)))
    e2, w2 = edge_set((slice(0, H - 1), slice(None)), (slice(1, H), slice(None)))
    edges = np.concatenate([e1, e2])
    weights = np.concatenate([w1, w2])
    remap = _merge(edges, weights, np.ones(H * W), H * W, k)
    labels = remap.reshape(H, W)
    # absorb tiny segments into their lowest-weight neighbor (min_size pass)
    sizes = np.bincount(labels.reshape(-1))
    small = set(np.where(sizes < min_size)[0].tolist())
    if small:
        parent = np.arange(sizes.size)
        for (a, b), w in sorted(zip(edges.tolist(), weights.tolist()), key=lambda t: t[1]):
            ra, rb = labels.reshape(-1)[a], labels.reshape(-1)[b]
            ra, rb = parent[ra], parent[rb]
            if ra != rb and (sizes[ra] < min_size or sizes[rb] < min_size):
                parent[parent == rb] = ra
                sizes[ra] += sizes[rb]
        labels = parent[labels]
    _, labels = np.unique(labels, return_inverse=True)
    return labels.reshape(H, W)


def _region_descriptors(img, labels, n_regions):
    """Color histogram (8 bins), texture histogram (8 orientations), size,
    bbox per region: selective search's similarity features, read to the
    host in one copy."""
    imgt = as_float(img)
    dev = imgt.device
    g = imgt if imgt.ndim == 2 else imgt.mean(-1)
    gy, gx = filters.gradients(g)
    mag = torch.sqrt(gy * gy + gx * gx)
    ori = torch.clamp(((torch.atan2(gy, gx) + torch.pi) / (2 * torch.pi) * N_TEX).to(torch.int64), 0, N_TEX - 1)
    q = torch.clamp((g * 8).to(torch.int64), 0, 7)
    lab = torch.as_tensor(np.asarray(labels)).to(dev)
    flat = lab.reshape(-1).to(torch.int64)

    col = segment_count(flat * 8 + q.reshape(-1), n_regions * 8).reshape(n_regions, 8)
    tex = segment_sum(flat * N_TEX + ori.reshape(-1), mag.reshape(-1), n_regions * N_TEX).reshape(n_regions, N_TEX)
    size = segment_count(flat, n_regions)
    H, W = lab.shape
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W).reshape(-1)
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W).reshape(-1)

    def reduce(v, fill, how):
        return torch.full((n_regions,), fill, device=dev).scatter_reduce_(0, flat, v, how)

    y0, x0 = reduce(yy, float("inf"), "amin"), reduce(xx, float("inf"), "amin")
    y1, x1 = reduce(yy, -float("inf"), "amax"), reduce(xx, -float("inf"), "amax")
    col = col / torch.clamp(col.sum(1, keepdim=True), min=1)
    tex = tex / torch.clamp(tex.sum(1, keepdim=True), min=1)
    host = torch.cat([col, tex, torch.stack([size, y0, x0, y1, x1], 1)], 1).cpu().numpy()
    out = dict(col=host[:, :8], tex=host[:, 8:8 + N_TEX])
    for i, k in enumerate(("size", "y0", "x0", "y1", "x1")):
        out[k] = host[:, 8 + N_TEX + i].copy()
    return out


def selective_search(img, base_k: float = 0.3, max_proposals: int = 64):
    """Selective search box proposals (SelectiveSearchSegmentation::process):
    start from graph segmentation, greedily merge the most similar region
    pair (color + texture + size + fill), record every merged region's box.
    Returns (N, 4) numpy [y0, x0, y1, x1]."""
    labels = graph_segment(img, k=base_k)
    n = int(labels.max()) + 1
    d = _region_descriptors(img, labels, n)
    img_area = labels.size

    # adjacency from the label map, in the JAX version's order
    adj = set()
    ln = np.asarray(labels)
    for a, b in zip(ln[:, :-1].reshape(-1), ln[:, 1:].reshape(-1)):
        if a != b:
            adj.add((min(a, b), max(a, b)))
    for a, b in zip(ln[:-1].reshape(-1), ln[1:].reshape(-1)):
        if a != b:
            adj.add((min(a, b), max(a, b)))

    col, tex = d["col"].copy(), d["tex"].copy()
    size = d["size"].copy()
    boxes = np.stack([d["y0"], d["x0"], d["y1"], d["x1"]], 1)

    def sim(a, b):
        s_col = np.minimum(col[a], col[b]).sum()
        s_tex = np.minimum(tex[a], tex[b]).sum()
        s_size = 1.0 - (size[a] + size[b]) / img_area
        bb_y0, bb_x0 = min(boxes[a][0], boxes[b][0]), min(boxes[a][1], boxes[b][1])
        bb_y1, bb_x1 = max(boxes[a][2], boxes[b][2]), max(boxes[a][3], boxes[b][3])
        bb = (bb_y1 - bb_y0 + 1) * (bb_x1 - bb_x0 + 1)
        s_fill = 1.0 - (bb - size[a] - size[b]) / img_area
        return s_col + s_tex + s_size + s_fill

    proposals = [tuple(boxes[i]) for i in range(n)]
    adj = {(a, b): sim(a, b) for a, b in adj}
    alive = set(range(n))
    next_id = n
    # grow arrays as regions merge
    col = np.vstack([col, np.zeros((n, 8))])
    tex = np.vstack([tex, np.zeros((n, N_TEX))])
    size = np.concatenate([size, np.zeros(n)])
    boxes = np.vstack([boxes, np.zeros((n, 4))])
    while adj and next_id < 2 * n:
        (a, b), _ = max(adj.items(), key=lambda kv: kv[1])
        c = next_id
        next_id += 1
        w = size[a] + size[b]
        col[c] = (col[a] * size[a] + col[b] * size[b]) / w
        tex[c] = (tex[a] * size[a] + tex[b] * size[b]) / w
        size[c] = w
        boxes[c] = [min(boxes[a][0], boxes[b][0]), min(boxes[a][1], boxes[b][1]),
                    max(boxes[a][2], boxes[b][2]), max(boxes[a][3], boxes[b][3])]
        proposals.append(tuple(boxes[c]))
        alive.discard(a)
        alive.discard(b)
        alive.add(c)
        new_adj = {}
        for (i, j), s in adj.items():
            if a in (i, j) or b in (i, j):
                other = j if i in (a, b) else i
                if other in alive and other != c:
                    new_adj[(min(other, c), max(other, c))] = None
            else:
                new_adj[(i, j)] = s
        for k2 in [k2 for k2, v in new_adj.items() if v is None]:
            new_adj[k2] = sim(*k2)
        adj = new_adj
    # dedupe, largest-first
    uniq = list(dict.fromkeys(proposals))
    return np.asarray(uniq[:max_proposals])


def edge_boxes(img, boxes, beta: float = 0.75, edge_map=None):
    """EdgeBoxes-style objectness for candidate boxes
    (EdgeBoxes::getBoundingBoxes scoring): interior edge mass minus edges
    crossing the box boundary, normalized by perimeter^beta, all boxes
    scored from one float64 integral image on the host.

    edge_map: optional precomputed edge probability map (e.g. the learned
    ximgproc.edge_forest.structured_edges, the reference's intended input);
    defaults to gradient magnitude (on img's device)."""
    if edge_map is not None:
        mag = (edge_map.detach().cpu().numpy() if isinstance(edge_map, torch.Tensor)
               else np.asarray(edge_map)).astype(np.float32)
    else:
        imgt = as_float(img)
        gy, gx = filters.gradients(imgt if imgt.ndim == 2 else imgt.mean(-1))
        mag = torch.sqrt(gy * gy + gx * gx).cpu().numpy()
    H, W = mag.shape
    ii = np.zeros((H + 1, W + 1))
    ii[1:, 1:] = mag.cumsum(0).cumsum(1)

    def boxsum(y0, x0, y1, x1):
        return ii[y1 + 1, x1 + 1] - ii[y0, x1 + 1] - ii[y1 + 1, x0] + ii[y0, x0]

    scores = []
    for y0, x0, y1, x1 in np.asarray(boxes, int):
        y0c, x0c = max(y0, 1), max(x0, 1)
        y1c, x1c = min(y1, H - 2), min(x1, W - 2)
        if y1c <= y0c or x1c <= x0c:
            scores.append(0.0)
            continue
        interior = boxsum(y0c + 2, x0c + 2, y1c - 2, x1c - 2) if (y1c - y0c > 4 and x1c - x0c > 4) else 0.0
        full = boxsum(y0c, x0c, y1c, x1c)
        ring = full - interior  # edges on/near the boundary = likely crossing
        per = 2 * (y1c - y0c + x1c - x0c)
        scores.append(float((interior - 0.5 * ring) / max(per**beta, 1.0)))
    return np.asarray(scores)
