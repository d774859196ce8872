"""Tracks: correspondence chains across images as a dense tensor — the port
of opencv_contrib_tpu/sfm/tracks.py (host numpy in both packages; this is
the port's own copy).

Replaces libmv::Tracks' (image, track, x, y) marker multimap with a
[n_images, n_tracks] observation array and validity mask: every Tracks
query (MarkersForTracksInBothImages etc.) becomes a mask expression, and BA
consumes the array directly. Track building from pairwise matches is a
host-side union-find (sequential by nature, tiny cost).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class TracksTensor(NamedTuple):
    obs: np.ndarray  # (V, T, 2) float32 pixel observations
    mask: np.ndarray  # (V, T) bool

    @property
    def n_views(self) -> int:
        return self.obs.shape[0]

    @property
    def n_tracks(self) -> int:
        return self.obs.shape[1]

    def common_tracks(self, i: int, j: int) -> np.ndarray:
        """Track ids visible in both views (MarkersForTracksInBothImages)."""
        return np.flatnonzero(self.mask[i] & self.mask[j])


class _UnionFind:
    def __init__(self, n):
        self.parent = np.arange(n)

    def find(self, a):
        root = a
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[a] != root:
            self.parent[a], a = root, self.parent[a]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def build_tracks(
    n_views: int,
    keypoints_xy: list[np.ndarray],
    matches: list[tuple[int, int, np.ndarray, np.ndarray]],
    min_length: int = 2,
    max_tracks: int | None = None,
) -> TracksTensor:
    """Union-find track linking.

    keypoints_xy: per view, (K_v, 2) arrays of pixel coords.
    matches: list of (view_i, view_j, idx_i (M,), idx_j (M,)) match sets.
    Features matched across views merge into one track; tracks that collide
    (two features of the same view in one track) are dropped, like libmv's
    consistency filtering. Tracks shorter than min_length are dropped.
    """
    counts = [kp.shape[0] for kp in keypoints_xy]
    offsets = np.concatenate([[0], np.cumsum(counts)])
    total = offsets[-1]
    uf = _UnionFind(total)
    for vi, vj, ii, jj in matches:
        for a, b in zip(ii, jj):
            uf.union(offsets[vi] + int(a), offsets[vj] + int(b))

    roots = np.array([uf.find(k) for k in range(total)])
    # group features by root
    uniq, inv = np.unique(roots, return_inverse=True)
    n_groups = len(uniq)

    view_of = np.concatenate([np.full(c, v) for v, c in enumerate(counts)])
    feat_of = np.concatenate([np.arange(c) for c in counts])

    # detect collisions: a group containing two features from the same view
    key = inv * n_views + view_of
    _, first_idx, key_counts = np.unique(key, return_index=True, return_counts=True)
    collided_groups = np.unique(inv[first_idx[key_counts > 1]])
    group_len = np.bincount(inv, minlength=n_groups)
    good = np.ones(n_groups, bool)
    good[collided_groups] = False
    good &= group_len >= min_length

    good_ids = np.flatnonzero(good)
    if max_tracks is not None and len(good_ids) > max_tracks:
        # keep longest tracks
        order = np.argsort(-group_len[good_ids], kind="stable")
        good_ids = good_ids[order[:max_tracks]]
    remap = -np.ones(n_groups, np.int64)
    remap[good_ids] = np.arange(len(good_ids))

    T = len(good_ids)
    obs = np.zeros((n_views, T, 2), np.float32)
    mask = np.zeros((n_views, T), bool)
    tids = remap[inv]
    sel = tids >= 0
    v = view_of[sel]
    t = tids[sel]
    f = feat_of[sel]
    xy = np.concatenate(keypoints_xy, axis=0)[sel]
    obs[v, t] = xy
    mask[v, t] = True
    return TracksTensor(obs=obs, mask=mask)


def load_blender_tracks(path: str) -> TracksTensor:
    """Load a Blender-exported track file (the reference's sample data
    format: desktop_tracks.txt / backyard_tracks.txt).

    One line per track; each line is "x0 y0 x1 y1 ..." pairs, one pair per
    frame; (-1, -1) marks the track invisible in that frame. Parity with
    parser_2D_tracks (sfm/test/test_common.cpp:79 — markers kept only when
    x > 0 && y > 0)."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            vals = np.asarray(parts, dtype=np.float64) if parts else np.empty(0)
            if vals.size:
                rows.append(vals.reshape(-1, 2))
    n_frames = max(r.shape[0] for r in rows)
    T = len(rows)
    obs = np.zeros((n_frames, T, 2), np.float32)
    mask = np.zeros((n_frames, T), bool)
    for t, r in enumerate(rows):
        valid = (r[:, 0] > 0) & (r[:, 1] > 0)
        obs[: r.shape[0], t] = r.astype(np.float32)
        mask[: r.shape[0], t] = valid
    obs[~mask] = 0.0
    return TracksTensor(obs=obs, mask=mask)


def from_observation_list(n_views: int, markers: np.ndarray) -> TracksTensor:
    """Build from (image, track, x, y) marker rows — the parser for the
    reference's Blender-style track files (parser_2D_tracks,
    sfm/src/simple_pipeline.cpp:59)."""
    img = markers[:, 0].astype(int)
    trk = markers[:, 1].astype(int)
    T = trk.max() + 1
    obs = np.zeros((n_views, T, 2), np.float32)
    mask = np.zeros((n_views, T), bool)
    obs[img, trk] = markers[:, 2:4]
    mask[img, trk] = True
    return TracksTensor(obs=obs, mask=mask)
