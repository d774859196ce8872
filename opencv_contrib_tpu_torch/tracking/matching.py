"""Tracking-by-matching: multi-target track management with optimal
detection-to-track assignment (the port of
opencv_contrib_tpu/tracking/matching.py).

Reference anchors: tracking/src/tracking_by_matching.cpp (TrackerByMatching:
affinity = appearance distance x shape x motion gates) and
tracking/src/kuhn_munkres.cpp (KuhnMunkres::Solve, the Hungarian algorithm
on a dense cost matrix).

The affinity matrix (IoU, appearance cosine distances) is batched torch on
the tracker's device; the Hungarian solve is sequential, branchy
augmentation, a host algorithm by nature (the reference runs it on one core
too): the port keeps its own numpy copy of the twin's O(n^3)
potential-based shortest-augmenting-path solver, and reads the cost matrix
to the host once a frame.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from opencv_contrib_tpu_torch.utils.device import constant


def kuhn_munkres(cost: np.ndarray) -> np.ndarray:
    """Hungarian algorithm (Jonker-Volgenant style shortest augmenting path
    with dual potentials). cost (n, m). Returns col4row (n,), the assigned
    column per row (-1 where none), minimizing the total cost;
    kuhn_munkres.cpp:Solve semantics."""
    cost = np.asarray(cost, np.float64)
    n_orig, m_orig = cost.shape
    transposed = n_orig > m_orig
    if transposed:
        cost = cost.T
    n, m = cost.shape
    u = np.zeros(n)
    v = np.zeros(m + 1)  # slot m is the virtual start column
    p = np.full(m + 1, -1, dtype=np.int64)  # p[j] = row matched to column j
    way = np.zeros(m + 1, dtype=np.int64)
    cols = np.arange(m)
    for i in range(n):
        p[m] = i
        j0 = m
        minv = np.full(m, np.inf)
        used = np.zeros(m + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            cur = cost[i0] - u[i0] - v[:m]
            better = (~used[:m]) & (cur < minv)
            minv[better] = cur[better]
            way[cols[better]] = j0
            free = ~used[:m]
            j1 = int(cols[free][np.argmin(minv[free])])
            delta = minv[j1]
            u[p[used]] += delta
            v[used] -= delta
            minv[free] -= delta
            j0 = j1
            if p[j0] == -1:
                break
        while j0 != m:  # augment along the alternating path
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    col4row = np.full(n, -1, dtype=np.int64)
    for j in range(m):
        if p[j] >= 0:
            col4row[p[j]] = j
    if transposed:
        out = np.full(n_orig, -1, dtype=np.int64)
        for r, c in enumerate(col4row):
            if c >= 0:
                out[c] = r
        return out
    return col4row


def _f32(x, device=None) -> torch.Tensor:
    """x as float32 on `device` (a tensor stays where it is when None); host
    data crosses through pinned memory."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device, dtype=torch.float32)
    return constant(np.asarray(x, np.float32), device if device is not None else "cpu")


def iou_matrix(boxes_a, boxes_b):
    """IoU between (N, 4) and (M, 4) boxes in (y0, x0, y1, x1)."""
    a = _f32(boxes_a)[:, None]
    b = _f32(boxes_b, a.device)[None]
    y0 = torch.maximum(a[..., 0], b[..., 0])
    x0 = torch.maximum(a[..., 1], b[..., 1])
    y1 = torch.minimum(a[..., 2], b[..., 2])
    x1 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(y1 - y0, min=0) * torch.clamp(x1 - x0, min=0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / torch.clamp(area_a + area_b - inter, min=1e-9)


def affinity_matrix(track_boxes, det_boxes, track_feats=None, det_feats=None, w_shape: float = 0.5,
                    w_app: float = 0.5):
    """Combined assignment cost (tracking_by_matching.cpp affinity):
    1 - IoU blended with the appearance cosine distance."""
    cost = 1.0 - iou_matrix(track_boxes, det_boxes)
    if track_feats is not None and det_feats is not None:
        tf = _f32(track_feats, cost.device)
        df = _f32(det_feats, cost.device)
        tf = tf / (torch.linalg.norm(tf, dim=1, keepdim=True) + 1e-9)
        df = df / (torch.linalg.norm(df, dim=1, keepdim=True) + 1e-9)
        app = 1.0 - tf @ df.T
        cost = w_shape * cost + w_app * app
    return cost


@dataclass
class Track:
    track_id: int
    box: np.ndarray  # (4,)
    feat: np.ndarray | None = None
    age: int = 0
    misses: int = 0
    hits: int = 1


@dataclass
class TrackerByMatching:
    """Multi-target tracker: detections assigned to tracks each frame by the
    Hungarian solve on the affinity matrix; tracks spawned and killed by
    hit / miss counts (TrackerByMatching::Process semantics). The affinity
    is computed on `device`; the track table is host state."""

    max_cost: float = 0.7
    max_misses: int = 5
    tracks: list = field(default_factory=list)
    _next_id: int = 0
    device: str = "cpu"

    def process(self, det_boxes, det_feats=None):
        if isinstance(det_boxes, torch.Tensor):
            det_boxes = det_boxes.detach().cpu().numpy()
        if isinstance(det_feats, torch.Tensor):
            det_feats = det_feats.detach().cpu().numpy()
        det_boxes = np.asarray(det_boxes, np.float32).reshape(-1, 4)
        n_det = det_boxes.shape[0]
        assigned_det = np.zeros(n_det, bool)
        if self.tracks and n_det:
            t_boxes = np.stack([t.box for t in self.tracks])
            t_feats = None
            if det_feats is not None and all(t.feat is not None for t in self.tracks):
                t_feats = np.stack([t.feat for t in self.tracks])
            cost = affinity_matrix(_f32(t_boxes, self.device), det_boxes, t_feats, det_feats)
            cost = cost.cpu().numpy()  # the Hungarian solve is a host algorithm: one read a frame
            col = kuhn_munkres(cost)
            for ti, di in enumerate(col):
                if di >= 0 and cost[ti, di] <= self.max_cost:
                    t = self.tracks[ti]
                    t.box = det_boxes[di]
                    if det_feats is not None:
                        t.feat = np.asarray(det_feats[di])
                    t.hits += 1
                    t.misses = 0
                    assigned_det[di] = True
                else:
                    self.tracks[ti].misses += 1
        else:
            for t in self.tracks:
                t.misses += 1
        for t in self.tracks:
            t.age += 1
        self.tracks = [t for t in self.tracks if t.misses <= self.max_misses]
        for di in range(n_det):
            if not assigned_det[di]:
                feat = None if det_feats is None else np.asarray(det_feats[di])
                self.tracks.append(Track(self._next_id, det_boxes[di], feat))
                self._next_id += 1
        return [(t.track_id, t.box.copy()) for t in self.tracks]
