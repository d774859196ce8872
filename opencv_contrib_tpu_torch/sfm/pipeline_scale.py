"""Incremental SfM at the 5k-view scale (sparse tracks, windowed BA) — the
port of opencv_contrib_tpu/sfm/pipeline_scale.py.

The dense-grid driver (sfm/pipeline.py) mirrors libmv's fixpoint loop
(pipeline.cc:138-264) on a (V, T) observation grid, which does not fit past
a few hundred views. This module is its scalable twin for sequential
captures: the BASELINE "distributed SfM, 5k images" configuration.

Reference parity:
- incremental resect -> intersect -> bundle structure:
  sfm/src/libmv/simple_pipeline/pipeline.cc:138-264
- two-frame init: initialize_reconstruction.cc:53-94
- bundle: bundle.cc:450 (here ba.sparse, the ITERATIVE_SCHUR analog)

Design, as in the JAX package:
- SparseTracks holds observations in (V, K) slot form: K observation slots
  a view, which is at once the frontend's top-K output, the flat
  observation list of ba.sparse after one reshape, and camera-bucketed.
- The whole map state (poses, points, first-sighting table) lives on the
  device (`MapState`). Views are registered in chunks of `ba_every`: the
  host reads one (n_steps, 4) flags array a chunk, so its round trips are
  O(V / ba_every), not O(V). A chunk is a loop in Python over its steps
  (the JAX package's `lax.scan`); every step runs the same branchless work
  and selects with `torch.where`, so nothing inside a chunk waits for the
  device, and a step past the last view or on a registered view still draws
  its RANSAC samples, as the JAX package's does.
- Per view: masked robust PnP plus a motion-model fallback, closed-form
  pairwise midpoint triangulation, first-sighting bookkeeping. The JAX
  package's `mode="drop"` scatters write into buffers with one dump row
  that is sliced off, so an index of T (or V) writes nothing.
- BA schedule: windowed local BA (device-side, the full (T,) point axis,
  slot-trivial buckets) after every chunk, plus global sparse BA when the
  map has grown by `global_growth`, and at the end.
- Tracking loss starts a NEW SEGMENT with a fresh scale gauge; views and
  points of different segments never share a BA problem.

The public functions run on the card unless the caller passes
`device="cpu"`; with no card they raise. They run under
`torch.inference_mode`, which spares each of the ~4,500 launches a view its
autograd bookkeeping on the host. RANSAC draws come from
`torch.Generator`s seeded from `seed` and the view (the init pair from the
pair), the roles of the JAX package's `fold_in(key, v)` and
`fold_in(key, i * V + j)`.

With a `mesh` (parallel/mesh.py) every rank runs the host loop with the same
seeds, and the global bundles (growth-triggered and final) shard over the
mesh through parallel.dist_ba; the windowed bundles stay whole on each rank.
The final sequence is the single-device route's, re-triangulation and
pruning included (the JAX package's mesh route skips them,
pipeline_scale.py:851-869), so a mesh changes the result only by rounding.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from opencv_contrib_tpu_torch.ba import sparse as sba
from opencv_contrib_tpu_torch.ba.bundle import _small_mm
from opencv_contrib_tpu_torch.core import camera as cam
from opencv_contrib_tpu_torch.core import se3
from opencv_contrib_tpu_torch.mvg import fundamental, resection, robust, triangulation
from opencv_contrib_tpu_torch.parallel import dist_ba
from opencv_contrib_tpu_torch.parallel.mesh import check_replicated
from opencv_contrib_tpu_torch.utils.device import resolve
from opencv_contrib_tpu_torch.utils.precision import f32_matmuls
from opencv_contrib_tpu_torch.utils.tracing import trace_span


class SparseTracks(NamedTuple):
    """Per-view observation slots (see module docstring); host numpy."""

    tid: np.ndarray  # (V, K) int32
    uv: np.ndarray  # (V, K, 2) float32 pixels
    ok: np.ndarray  # (V, K) bool
    n_tracks: int

    @property
    def n_views(self) -> int:
        return self.tid.shape[0]

    @property
    def slots(self) -> int:
        return self.tid.shape[1]


def from_sequence_scene(scene) -> SparseTracks:
    return SparseTracks(tid=scene.tid, uv=scene.uv, ok=scene.ok, n_tracks=scene.n_tracks)


class MapState(NamedTuple):
    """Device-resident reconstruction state."""

    Rs: torch.Tensor  # (V, 3, 3)
    ts: torch.Tensor  # (V, 3)
    registered: torch.Tensor  # (V,) bool
    seg_of_view: torch.Tensor  # (V,) int32, -1 = unregistered
    points: torch.Tensor  # (T, 3)
    has_point: torch.Tensor  # (T,) bool
    seg_of_point: torch.Tensor  # (T,) int32
    first_view: torch.Tensor  # (T,) int32, -1 = unseen
    first_uv: torch.Tensor  # (T, 2)


def _upload(a, dev: torch.device) -> torch.Tensor:
    """Host array -> tensor on `dev`; to the card through pinned memory, so
    the copy does not wait for the stream."""
    t = torch.from_numpy(np.array(a))
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


def _generator(dev: torch.device, seed: int, data: int) -> torch.Generator:
    """A generator for the draws of one view (or init pair), seeded from
    (seed, data): the role of the JAX package's `fold_in(key, data)`."""
    s = int(np.random.SeedSequence([seed, data]).generate_state(1, np.uint64)[0])
    return torch.Generator(dev).manual_seed(s)


def _f32(x) -> float:
    """A float rounded to float32: a threshold compared as the JAX package's
    f32 scalars compare."""
    return float(np.float32(x))


@dataclass
class SequentialReconstruction:
    """Host-side result of the scalable driver (EuclideanReconstruction
    store role, reconstruction.h:39-100); the JAX package's fields, all host
    numpy."""

    Rs: np.ndarray  # (V, 3, 3)
    ts: np.ndarray  # (V, 3)
    registered: np.ndarray  # (V,) bool
    points: np.ndarray  # (T, 3)
    has_point: np.ndarray  # (T,) bool
    intr: np.ndarray  # (9,)
    seg_of_view: np.ndarray = None  # (V,) int32
    seg_of_point: np.ndarray = None  # (T,) int32
    n_segments: int = 0
    reg_order: list = field(default_factory=list)
    log: list = field(default_factory=list)

    def reprojection_mean_px(self, tracks: SparseTracks, device="cuda") -> float:
        """Mean per-marker reprojection error over registered views and
        same-segment reconstructed points (the libmv error metric,
        pipeline.cc:266-318). One batched device call and one read."""
        dev = resolve(device)
        s, n = _reproj_sums_jit(*(_upload(a, dev) for a in (
            self.Rs, self.ts, self.registered, self.seg_of_view, self.points, self.has_point, self.seg_of_point,
            tracks.tid, tracks.uv, tracks.ok, self.intr)))
        out = torch.stack([s, n.to(s.dtype)]).cpu()
        return float(out[0]) / max(float(out[1]), 1.0)


def _slot_px(Rs, ts, registered, seg_of_view, points, has_point, seg_of_point, tid, ok, intr):
    """Per-slot predicted pixels (V, K, 2) and the mask of valid
    same-segment reconstructed observations in front of the camera."""
    tid = tid.long()
    Xc = torch.einsum("vij,vkj->vki", Rs, points[tid]) + ts[:, None, :]
    z = torch.where(torch.abs(Xc[..., 2]) < 1e-9, 1e-9, Xc[..., 2])
    px = cam.denormalize_points(intr, cam.distort(intr, Xc[..., :2] / z[..., None]))
    m = (ok & registered[:, None] & has_point[tid] & (seg_of_point[tid] == seg_of_view[:, None]) & (z > 1e-3))
    return px, m


@f32_matmuls
def _slot_err_jit(st: MapState, tid, uv, ok, intr):
    """Per-slot reprojection error in px ((V, K); +inf where not a valid
    same-segment reconstructed observation). Feeds outlier pruning before
    the final bundle (the reference drops such markers through its
    intersect gates, intersect.cc:131-149)."""
    px, m = _slot_px(st.Rs, st.ts, st.registered, st.seg_of_view, st.points, st.has_point, st.seg_of_point, tid,
                     ok, intr)
    return torch.where(m, torch.linalg.norm(px - uv, dim=-1), torch.inf)


@f32_matmuls
def _reproj_sums_jit(Rs, ts, registered, seg_of_view, points, has_point, seg_of_point, tid, uv, ok, intr):
    px, m = _slot_px(Rs, ts, registered, seg_of_view, points, has_point, seg_of_point, tid, ok, intr)
    return torch.sum(torch.where(m, torch.linalg.norm(px - uv, dim=-1), 0.0)), torch.sum(m)


# ---------------------------------------------------------------------------
# per-view cores (the steps of a chunk)

_PRIOR_GATES = tuple(_f32(g) for g in (0.05, 0.02, 0.01))


def _register_core(generator, X, uvv, have, intr, R_prior, t_prior):
    """Robust PnP + GN refine with a motion-model fallback (EuclideanResect
    role, resect.cc:94-157; the prior path is the frame-to-frame odometry
    analog for smooth sequences). Both branches are computed and the one
    with more inliers selected on the device. Returns (R, t, n_inliers)."""
    xn = cam.undistort(intr, cam.normalize_points(intr, uvv))
    res = robust.pnp_robust(generator, X, xn, threshold=0.01, mask=have)
    R1, t1, _ = resection.refine_pose(res.model[:, :3], res.model[:, 3], X, xn, res.inliers & have, iters=8)

    def inl(R, t, thr):
        r = resection.reprojection_residuals(R, t, X, xn, have)
        return have & (torch.sum(r * r, dim=-1) < thr * thr)

    # the fallback: refine from the prior pose with widening-then-tightening
    # inlier gates
    R2, t2 = R_prior, t_prior
    for thr in _PRIOR_GATES:
        R2, t2, _ = resection.refine_pose(R2, t2, X, xn, inl(R2, t2, thr), iters=4)
    n1, n2 = torch.sum(inl(R1, t1, 0.01)), torch.sum(inl(R2, t2, 0.01))
    better2 = n2 > n1
    return torch.where(better2, R2, R1), torch.where(better2, t2, t1), torch.maximum(n1, n2)


def _midpoint(da, oa, db, ob):
    """Midpoint of the closest approach of rays oa + s da and ob + u db."""
    a = torch.sum(da * da, dim=-1)
    b = -torch.sum(da * db, dim=-1)
    c = torch.sum(db * db, dim=-1)
    d = ob - oa
    e1 = torch.sum(da * d, dim=-1)
    e2 = -torch.sum(db * d, dim=-1)
    det = a * c - b * b
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    s = (c * e1 - b * e2) / det
    u = (a * e2 - b * e1) / det
    return 0.5 * (oa + da * s[:, None] + ob + db * u[:, None])


def _unit(d):
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)


def _homog(x):
    return torch.cat([x, torch.ones_like(x[:, :1])], dim=-1)


def _triangulate_core(uva, uvb, Ra, ta, Rb, tb, cand, intr, max_err_n, min_par_cos):
    """Midpoint triangulation of K tracks from per-slot first-view poses
    (Ra, ta) and the current view (Rb, tb) — the batched EuclideanIntersect
    (intersect.cc:69-149) in closed form."""
    xa = cam.undistort(intr, cam.normalize_points(intr, uva))
    xb = cam.undistort(intr, cam.normalize_points(intr, uvb))
    da = torch.einsum("kji,kj->ki", Ra, _homog(xa))  # world rays
    oa = -torch.einsum("kji,kj->ki", Ra, ta)
    db = _homog(xb) @ Rb
    ob = (-(Rb.T @ tb)).expand(da.shape)
    X = _midpoint(da, oa, db, ob)

    Xa = torch.einsum("kij,kj->ki", Ra, X) + ta
    Xb = X @ Rb.T + tb
    za, zb = Xa[:, 2], Xb[:, 2]
    ea = torch.sum((Xa[:, :2] / torch.where(torch.abs(za) < 1e-9, 1e-9, za)[:, None] - xa) ** 2, dim=-1)
    eb = torch.sum((Xb[:, :2] / torch.where(torch.abs(zb) < 1e-9, 1e-9, zb)[:, None] - xb) ** 2, dim=-1)
    cosang = torch.sum(_unit(da) * _unit(db), dim=-1)
    max_err2 = max_err_n * max_err_n
    accept = (cand & (za > 1e-3) & (zb > 1e-3) & (ea < max_err2) & (eb < max_err2) & (cosang < min_par_cos))
    return X, accept


# ---------------------------------------------------------------------------
# the chunked registration: n_steps views between two reads of the flags


def _dump_row(x: torch.Tensor, fill) -> torch.Tensor:
    """x with one more row along dim 0: the target of dropped writes."""
    return torch.cat([x, torch.full((1,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)])


@f32_matmuls
def _chunk_register_jit(st: MapState, tid, uv, ok, v0: int, seg: int, prev, key: int, intr, max_err_n: float,
                        min_par_cos: float, n_steps: int, min_inliers: int, min_gap: int):
    """Register views v0..v0+n_steps-1 into the device-resident map.

    Per view: robust PnP (+ prior fallback) -> pose update -> first-sighting
    bookkeeping -> pairwise midpoint triangulation. Branchless: failed views
    leave the state untouched. `prev` is the last registered view as a (1,)
    device tensor, `key` the seed of the views' generators, `max_err_n` and
    `min_par_cos` float32 values. Returns (state, prev, flags): per step
    (newly_registered, n_inliers, n_have, already) on the device (n_steps,
    4) int32; the argument's state is not changed."""
    V, K = tid.shape
    T = st.points.shape[0]
    dev = st.points.device
    min_have = max(min_inliers, 6)
    seg = int(seg)
    prev = torch.as_tensor(prev, device=dev).reshape(1).long()
    Rs, ts = st.Rs.clone(), st.ts.clone()
    registered, seg_of_view = st.registered.clone(), st.seg_of_view.clone()
    points, has_point, seg_of_point = _dump_row(st.points, 0.0), _dump_row(st.has_point, False), \
        _dump_row(st.seg_of_point, -1)
    first_view, first_uv = _dump_row(st.first_view, -1), _dump_row(st.first_uv, 0.0)
    drop = torch.full((K,), T, dtype=torch.long, device=dev)

    flags = []
    for i in range(n_steps):
        v = v0 + i
        valid = v < V
        vc = min(v, V - 1)
        tidv = tid[vc].long()
        okv = ok[vc] if valid else torch.zeros_like(ok[vc])
        uvv = uv[vc]
        have = okv & has_point[tidv] & (seg_of_point[tidv] == seg)
        n_have = torch.sum(have)
        R, t, n_inl = _register_core(_generator(dev, key, v), points[tidv], uvv, have, intr,
                                     Rs.index_select(0, prev)[0], ts.index_select(0, prev)[0])
        already = registered[vc].clone()
        ok_reg = (~already) & (n_have >= min_have) & (n_inl >= min_inliers) & valid

        Rv = torch.where(ok_reg, R, Rs[vc])
        tv = torch.where(ok_reg, t, ts[vc])
        Rs[vc] = Rv
        ts[vc] = tv
        registered[vc] = ok_reg | already
        seg_of_view[vc] = torch.where(ok_reg, seg, seg_of_view[vc])
        prev = torch.where(ok_reg, vc, prev)

        # first-sighting bookkeeping: claim when unseen, when the anchor is
        # from another segment, or when THIS view is earlier than the
        # recorded sighting (the init pair's later view pre-claims tracks
        # the views between the pair see first — earliest wins)
        fv_t = first_view[tidv]
        fv_safe = torch.clamp(fv_t, min=0).long()
        stale = (fv_t < 0) | (seg_of_view[fv_safe] != seg) | (v < fv_t)
        upd_idx = torch.where(okv & ok_reg & stale, tidv, drop)
        first_view.index_fill_(0, upd_idx, v)
        first_uv.index_copy_(0, upd_idx, uvv)

        # triangulate tracks first seen >= min_gap views ago in-segment
        fv_t = first_view[tidv]
        fv_safe = torch.clamp(fv_t, min=0).long()
        cand = (okv & ok_reg & ~(has_point[tidv] & (seg_of_point[tidv] == seg)) & (fv_t >= 0)
                & (fv_t <= v - min_gap) & (seg_of_view[fv_safe] == seg) & registered[fv_safe])
        Xn, acc = _triangulate_core(first_uv[tidv], uvv, Rs[fv_safe], ts[fv_safe], Rv, tv, cand, intr, max_err_n,
                                    min_par_cos)
        acc_idx = torch.where(acc, tidv, drop)
        points.index_copy_(0, acc_idx, Xn)
        has_point.index_fill_(0, acc_idx, True)
        seg_of_point.index_fill_(0, acc_idx, seg)
        flags.append(torch.stack([ok_reg.int(), n_inl.int(), n_have.int(), already.int()]))

    st = MapState(Rs, ts, registered, seg_of_view, points[:T], has_point[:T], seg_of_point[:T], first_view[:T],
                  first_uv[:T])
    return st, prev, torch.stack(flags)


# ---------------------------------------------------------------------------
# device-side BA wrappers (uncompacted (T,) point axis; slot buckets)


def _set_rows(x: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """x with x[idx] = rows, where an index of len(x) writes nothing."""
    return _dump_row(x, 0).index_copy_(0, idx, rows)[:x.shape[0]]


def _solve_slots(st: MapState, vids, tid_w, uv_w, ok_w, cam_free, pt_free, intr, n_iters, n_cg, mesh=None):
    """Sparse BA over the (C, K) slots of the views `vids` against all T
    points (slot-trivial buckets), its cameras written back where
    `cam_free`; sharded over `mesh` when one is given."""
    C, K = tid_w.shape
    V = st.Rs.shape[0]
    dev = st.points.device
    prob = sba.SparseBAProblem(
        cameras=torch.cat([se3.log_so3(st.Rs[vids]), st.ts[vids]], dim=-1), points=st.points, intr=intr,
        obs_cam=torch.arange(C * K, dtype=torch.int32, device=dev) // K,
        obs_pt=tid_w.reshape(-1).int(), obs_uv=uv_w.reshape(-1, 2).T, obs_ok=ok_w.reshape(-1))
    buckets = sba.ObsBuckets(torch.arange(C * K, dtype=torch.int32, device=dev).reshape(C, K).T, ok_w.T)
    if mesh is None:
        res = sba._bundle_adjust_sparse_jit(prob, buckets, n_iters, False, cam_free, pt_free, 1e-4, n_cg)
    else:
        res = dist_ba.bundle_adjust_sparse(prob, mesh, buckets=buckets, n_iters=n_iters, fix_first_cam=False,
                                           cam_free=cam_free, pt_free=pt_free, n_cg=n_cg)
    widx = torch.where(cam_free, vids, V)
    return st._replace(Rs=_set_rows(st.Rs, widx, se3.exp_so3(res.cameras[:, :3])),
                       ts=_set_rows(st.ts, widx, res.cameras[:, 3:]), points=res.points)


@f32_matmuls
def _windowed_ba_jit(st: MapState, tid, uv, ok, vids, cam_free, live, seg: int, intr, W: int, n_iters: int,
                     n_cg: int):
    """Local BA over the window views `vids` (W,) — device-side assembly,
    full (T,) point axis (the solver freezes unobserved points itself),
    slot-trivial buckets. Gauge: cam_free already anchors two views; `live`
    masks padding rows (short windows repeat the last vid)."""
    vids = vids.long()
    tidw = tid[vids].long()
    okw = ok[vids] & cam_free_obs_mask(st, tidw, seg) & st.registered[vids][:, None] & live[:, None]
    return _solve_slots(st, vids, tidw, uv[vids], okw, cam_free, st.has_point & (st.seg_of_point == seg), intr,
                        n_iters, n_cg)


def cam_free_obs_mask(st: MapState, tidw, seg):
    return st.has_point[tidw] & (st.seg_of_point[tidw] == seg)


def build_track_major(tracks: SparseTracks):
    """Host-side transpose of the (V, K) slot table into track-major form:
    per track, the views observing it and the pixel there. Built once;
    feeds the global re-intersection pass."""
    V, K = tracks.tid.shape
    T = tracks.n_tracks
    vv, kk = np.nonzero(tracks.ok)
    tt = tracks.tid[vv, kk]
    order = np.argsort(tt, kind="stable")
    tt_s, vv_s, kk_s = tt[order], vv[order], kk[order]
    counts = np.bincount(tt_s, minlength=T)
    S = max(int(counts.max()), 2)
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    pos = np.arange(len(tt_s)) - starts[tt_s]
    tm_view = np.zeros((T, S), np.int32)
    tm_uv = np.zeros((T, S, 2), np.float32)
    tm_ok = np.zeros((T, S), bool)
    tm_view[tt_s, pos] = vv_s
    tm_uv[tt_s, pos] = tracks.uv[vv_s, kk_s]
    tm_ok[tt_s, pos] = True
    return tm_view, tm_uv, tm_ok


@f32_matmuls
def _retriangulate_slice_jit(st: MapState, tm_view, tm_uv, tm_ok, t0: int, intr, iters: int = 6):
    """Global re-intersection (the libmv fixpoint's intersect step,
    pipeline.cc:151-181) over the track slice [t0, t0+Tc): re-initialize
    every reconstructed point by closed-form midpoint triangulation from its
    WIDEST-baseline pair of same-segment registered observations under the
    CURRENT poses, then Gauss-Newton refine against all of them. (A pure GN
    refine cannot recover points that ran away through a near-parallel
    triangulation earlier in the sequence.) The 3x3 solves keep their info
    on the device."""
    Tc, S = tm_view.shape
    tm_view = tm_view.long()
    seg_pt = st.seg_of_point[t0:t0 + Tc]
    has_pt = st.has_point[t0:t0 + Tc]
    pts0 = st.points[t0:t0 + Tc]
    m = tm_ok & st.registered[tm_view] & (st.seg_of_view[tm_view] == seg_pt[:, None]) & has_pt[:, None]
    xn = cam.undistort(intr, cam.normalize_points(intr, tm_uv))  # (Tc, S, 2)
    Rv = st.Rs[tm_view]  # (Tc, S, 3, 3)
    tv = st.ts[tm_view]  # (Tc, S, 3)

    # widest observation pair per track (first / last valid slot; slots are
    # in view order from the host-side build); argmax takes the first maximum
    mi = m.to(torch.int8)
    first = torch.argmax(mi, dim=1)
    last = S - 1 - torch.argmax(mi.flip(1), dim=1)
    rows = torch.arange(Tc, device=m.device)
    Ra, ta, Rb, tb = Rv[rows, first], tv[rows, first], Rv[rows, last], tv[rows, last]
    da = torch.einsum("kji,kj->ki", Ra, _homog(xn[rows, first]))
    oa = -torch.einsum("kji,kj->ki", Ra, ta)
    db = torch.einsum("kji,kj->ki", Rb, _homog(xn[rows, last]))
    ob = -torch.einsum("kji,kj->ki", Rb, tb)
    Xinit = _midpoint(da, oa, db, ob)
    # only adopt the re-init when the pair has usable parallax
    par_ok = torch.sum(_unit(da) * _unit(db), dim=-1) < _f32(np.cos(np.radians(1.0)))
    X = torch.where((par_ok & (last > first))[:, None], Xinit, pts0)

    mf = m.to(X.dtype)
    eye = 1e-8 * torch.eye(3, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        # residuals + 3x3 normal equations, fully batched
        Xc = torch.sum(Rv * X[:, None, None, :], dim=-1) + tv  # (Tc, S, 3)
        z = torch.where(torch.abs(Xc[..., 2]) < 1e-9, 1e-9, Xc[..., 2])
        r = (Xc[..., :2] / z[..., None] - xn) * mf[..., None]  # (Tc, S, 2)
        invz = 1.0 / z
        zero = torch.zeros_like(z)
        Jp = torch.stack([torch.stack([invz, zero, -Xc[..., 0] * invz * invz], dim=-1),
                          torch.stack([zero, invz, -Xc[..., 1] * invz * invz], dim=-1)], dim=-2)  # (Tc, S, 2, 3)
        J = _small_mm(Jp, Rv) * mf[..., None, None]
        H = torch.sum(J[..., :, None] * J[..., None, :], dim=(1, 2)) + eye
        g = torch.sum(J * r[..., None], dim=(1, 2))
        X = X - torch.linalg.solve_ex(H, g)[0]
    keep = (torch.sum(m, dim=1) >= 2) & has_pt & torch.all(torch.isfinite(X), dim=-1)
    points = st.points.clone()
    points[t0:t0 + Tc] = torch.where(keep[:, None], X, pts0)
    return st._replace(points=points)


def _retriangulate(st: MapState, tmv, tmu, tmo, intr, chunk: int = 32768) -> MapState:
    """Host loop over track slices (the final slice overlaps the previous
    one rather than clamping: its tracks are refined again from the updated
    points)."""
    T = tmv.shape[0]
    Tc = min(chunk, T)
    t0s = list(range(0, T - Tc + 1, Tc))
    if not t0s or t0s[-1] + Tc < T:
        t0s.append(T - Tc)
    for t0 in t0s:
        st = _retriangulate_slice_jit(st, tmv[t0:t0 + Tc], tmu[t0:t0 + Tc], tmo[t0:t0 + Tc], t0, intr)
    return st


@f32_matmuls
def _global_ba_jit(st: MapState, tid, uv, ok, cam_free, intr, n_iters: int, n_cg: int, mesh=None):
    """Global sparse BA over all registered views (EuclideanBundle role,
    bundle.cc:450) — segment-consistent observations only; sharded over
    `mesh` when one is given."""
    tid = tid.long()
    okg = ok & st.registered[:, None] & st.has_point[tid] & (st.seg_of_point[tid] == st.seg_of_view[:, None])
    vids = torch.arange(tid.shape[0], device=tid.device)
    return _solve_slots(st, vids, tid, uv, okg, cam_free, st.has_point, intr, n_iters, n_cg, mesh)


# ---------------------------------------------------------------------------
# host-side init + state shuttling (rare paths)


def _host(x: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of a CPU tensor's memory)."""
    return x.cpu().numpy().copy()


@f32_matmuls
def _init_two_view(tracks: SparseTracks, rec: SequentialReconstruction, first_view, first_uv, i: int, j: int,
                   key: torch.Generator, base_R=None, base_t=None, seg: int = 0) -> int:
    """Two-frame init (initialize_reconstruction.cc:53-94) on the shared
    tracks of slot-views i and j, on the device of the generator `key`;
    returns #triangulated points.

    base_R/base_t place view i (segment re-initialization keeps the new
    segment near the old trajectory; scale is a fresh gauge)."""
    K = tracks.slots
    ti, tj = tracks.tid[i], tracks.tid[j]
    oki, okj = tracks.ok[i], tracks.ok[j]
    common, ia, ja = np.intersect1d(np.where(oki, ti, -1), np.where(okj, tj, -2), return_indices=True)
    sel = common >= 0
    ia, ja = ia[sel], ja[sel]
    n = ia.size
    if n < 12:
        return 0
    x1 = np.zeros((K, 2), np.float32)
    x2 = np.zeros((K, 2), np.float32)
    m = np.zeros(K, bool)
    x1[:n] = tracks.uv[i, ia]
    x2[:n] = tracks.uv[j, ja]
    m[:n] = True

    dev = key.device
    intr_d, x1_d, x2_d, m_d = (_upload(a, dev) for a in (rec.intr, x1, x2, m))
    res = robust.fundamental_8pt_robust(key, x1_d, x2_d, threshold_px=1.5, mask=m_d)
    Kmat = cam.intrinsics_to_K(intr_d)
    E = fundamental.project_to_essential(fundamental.essential_from_fundamental(res.model, Kmat, Kmat))
    Rs4, ts4 = fundamental.motions_from_essential(E)
    x1n = cam.undistort(intr_d, cam.normalize_points(intr_d, x1_d))
    x2n = cam.undistort(intr_d, cam.normalize_points(intr_d, x2_d))
    inl = res.inliers & m_d
    R, t, _ = fundamental.choose_motion_cheirality(Rs4, ts4, x1n, x2n, inl)
    X = triangulation.triangulate_midpoint_two_view(x1n, x2n, R, t)
    good = _host(inl & (X[:, 2] > 1e-3) & ((se3.rotate_points(R, X) + t)[:, 2] > 1e-3))
    if int(good.sum()) < 12:
        return int(good.sum())  # commit nothing on a failed attempt

    if base_R is None:
        base_R = np.eye(3, dtype=np.float32)
        base_t = np.zeros(3, np.float32)
    R, t = _host(R), _host(t)
    X_world = (_host(X) - base_t) @ base_R  # base_R^T (X - base_t) rowwise
    rec.Rs[i] = base_R
    rec.ts[i] = base_t
    rec.Rs[j] = R @ base_R
    rec.ts[j] = R @ base_t + t
    rec.registered[i] = rec.registered[j] = True
    rec.seg_of_view[i] = rec.seg_of_view[j] = seg
    rec.reg_order += [i, j]
    tids = tracks.tid[i, ia[good[:n]]]
    rec.points[tids] = X_world[:n][good[:n]]
    rec.has_point[tids] = True
    rec.seg_of_point[tids] = seg
    for v in (i, j):
        mm = tracks.ok[v]
        t_ids = tracks.tid[v][mm]
        fv = first_view[t_ids]
        fv_safe = np.maximum(fv, 0)
        fresh = (fv < 0) | (rec.seg_of_view[fv_safe] != seg) | (v < fv)
        first_view[t_ids[fresh]] = v
        first_uv[t_ids[fresh]] = tracks.uv[v][mm][fresh]
    rec.log.append(("init", i, j, int(good.sum())))
    return int(good.sum())


def _pull_state(st: MapState, rec: SequentialReconstruction):
    """Device -> host (rare: re-init, final)."""
    rec.Rs, rec.ts, rec.registered, rec.seg_of_view = (_host(x) for x in st[:4])
    rec.points, rec.has_point, rec.seg_of_point = (_host(x) for x in st[4:7])
    return _host(st.first_view), _host(st.first_uv)


def _push_state(rec: SequentialReconstruction, first_view, first_uv, device="cuda") -> MapState:
    dev = resolve(device)
    return MapState(*(_upload(a, dev) for a in (rec.Rs, rec.ts, rec.registered, rec.seg_of_view, rec.points,
                                                 rec.has_point, rec.seg_of_point, first_view, first_uv)))


@torch.inference_mode()
@f32_matmuls
def global_ba(rec: SequentialReconstruction, tracks: SparseTracks, n_iters: int = 15, n_cg: int = 15, mesh=None,
              device="cuda") -> None:
    """Host-facing global sparse BA over ALL registered views, on `device`;
    sharded over `mesh` through parallel.dist_ba when one is given (every
    rank of it calls this with the same reconstruction)."""
    _check_mesh(mesh)
    dev = resolve(device)
    V, K = tracks.tid.shape
    ok = (tracks.ok & rec.registered[:, None] & rec.has_point[tracks.tid]
          & (rec.seg_of_point[tracks.tid] == rec.seg_of_view[:, None]))
    cam_free = _upload(_global_cam_free(rec), dev)
    ok_d = _upload(ok, dev)
    prob = sba.SparseBAProblem(
        cameras=torch.cat([se3.log_so3(_upload(rec.Rs, dev)), _upload(rec.ts, dev)], dim=1),
        points=_upload(rec.points, dev), intr=_upload(rec.intr, dev),
        obs_cam=torch.arange(V * K, dtype=torch.int32, device=dev) // K,
        obs_pt=_upload(tracks.tid.reshape(-1), dev), obs_uv=_upload(tracks.uv.reshape(-1, 2).T, dev),
        obs_ok=ok_d.reshape(-1))
    buckets = sba.ObsBuckets(torch.arange(V * K, dtype=torch.int32, device=dev).reshape(V, K).T, ok_d.T)
    kwargs = dict(n_iters=n_iters, fix_first_cam=False, cam_free=cam_free, pt_free=_upload(rec.has_point, dev),
                  n_cg=n_cg, buckets=buckets)
    if mesh is None:
        res = sba.bundle_adjust_sparse(prob, **kwargs)
    else:
        res = dist_ba.bundle_adjust_sparse(prob, mesh, **kwargs)
    upd = np.flatnonzero(_global_cam_free(rec))
    out_c = res.cameras[_upload(upd, dev)]
    rec.Rs[upd] = _host(se3.exp_so3(out_c[:, :3]))
    rec.ts[upd] = _host(out_c[:, 3:])
    rec.points[rec.has_point] = _host(res.points)[rec.has_point]


def _check_mesh(mesh) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh (parallel.mesh.make_mesh), not {type(mesh).__name__}")


def _global_cam_free(rec: SequentialReconstruction) -> np.ndarray:
    cam_free = rec.registered.copy()
    for s in range(rec.n_segments):
        sviews = [v for v in rec.reg_order if rec.seg_of_view[v] == s]
        for v in sviews[:2]:  # per-segment gauge anchor
            cam_free[v] = False
    return cam_free


# ---------------------------------------------------------------------------
# driver


@torch.inference_mode()
@f32_matmuls
def reconstruct_sequential(
    tracks: SparseTracks,
    intr: np.ndarray,
    window: int = 16,
    ba_every: int = 3,
    global_every: int = 0,
    min_gap: int = 3,
    min_inliers: int = 8,
    max_err_px: float = 4.0,
    min_parallax_deg: float = 1.0,
    prune_px: float = 20.0,
    window_iters: int = 6,
    window_cg: int = 8,
    global_growth: float = 1.4,
    final_global_iters: int = 15,
    mesh=None,
    seed: int = 0,
    progress_every: int = 0,
    device="cuda",
) -> SequentialReconstruction:
    """Sequential incremental reconstruction over sparse tracks, on `device`.

    The cv::sfm::reconstruct contract (reconstruct.cpp:236) restructured for
    sequential captures at scale: chunked device-side registration
    (`ba_every` views between two reads of the flags), windowed BA after
    every chunk, global sparse BA at the end (plus every `global_every`
    registrations if nonzero, and whenever the map has grown by
    `global_growth`). See the module docstring for the round-trip arithmetic.

    With a `mesh` (a DeviceMesh on `device`'s type), every rank of it calls
    this with the same arguments and runs the host loop; the global bundles
    shard over the mesh (module docstring), and the ranks' `reg_order` are
    checked to agree at the end.
    """
    _check_mesh(mesh)
    dev = resolve(device)
    V, K = tracks.tid.shape
    T = tracks.n_tracks
    intr = np.asarray(intr, np.float32)
    rec = SequentialReconstruction(
        Rs=np.tile(np.eye(3, dtype=np.float32), (V, 1, 1)),
        ts=np.zeros((V, 3), np.float32),
        registered=np.zeros(V, bool),
        points=np.zeros((T, 3), np.float32),
        has_point=np.zeros(T, bool),
        intr=intr,
        seg_of_view=np.full(V, -1, np.int32),
        seg_of_point=np.full(T, -1, np.int32),
    )
    first_view = np.full(T, -1, np.int32)
    first_uv = np.zeros((T, 2), np.float32)

    def try_init(i, base_R=None, base_t=None):
        """Two-view init at view i: widest-baseline overlapping later view
        first (the GRIC pair-selection intent, keyframe_selection.cc:133 —
        adjacent pairs triangulate degenerately)."""
        js = list(range(min(i + 2 * min_gap, V - 1), i + min_gap - 1, -1))
        js += list(range(i + min_gap - 1, i, -1))  # desperate fallback
        for j in js:
            if j <= i:
                continue
            npts = _init_two_view(tracks, rec, first_view, first_uv, i, j, _generator(dev, seed, i * V + j),
                                  base_R=base_R, base_t=base_t, seg=rec.n_segments)
            if npts >= 12:
                rec.n_segments += 1
                return True
        return False

    if not try_init(0):
        raise ValueError("two-view initialization failed")

    # device-resident state + tracks
    st = _push_state(rec, first_view, first_uv, dev)
    tid_d, uv_d, ok_d, intr_d = (_upload(a, dev) for a in (tracks.tid.astype(np.int64), tracks.uv, tracks.ok, intr))
    max_err_n = _f32(max_err_px / float(intr[0]))
    min_par_cos = _f32(np.cos(np.radians(min_parallax_deg)))

    fail_streak = 0
    reinit_after = 4
    regs_since_global = 0
    next_global_mark = max(16, 4 * ba_every)
    tmv, tmu, tmo = (_upload(a, dev) for a in build_track_major(tracks))
    prev = torch.full((1,), rec.reg_order[-1], dtype=torch.long, device=dev)

    def window_vids():
        seg = rec.n_segments - 1
        seg_views = [v for v in rec.reg_order if rec.seg_of_view[v] == seg]
        W_live = min(window, len(seg_views))
        if W_live < 3:
            return None, None, None
        vids = np.asarray(seg_views[-W_live:] + [seg_views[-1]] * (window - W_live), np.int64)
        live = np.arange(window) < W_live
        cam_free = (np.arange(window) >= 2) & live  # two oldest = gauge
        return _upload(vids, dev), _upload(cam_free, dev), _upload(live, dev)

    def bundle_all(n_iters):
        """Re-intersect, prune observations over prune_px, bundle all
        registered views."""
        nonlocal st
        cam_free = _upload(_global_cam_free(rec), dev)
        st = _retriangulate(st, tmv, tmu, tmo, intr_d)
        err = _slot_err_jit(st, tid_d, uv_d, ok_d, intr_d)
        st = _global_ba_jit(st, tid_d, uv_d, ok_d & (err < prune_px), cam_free, intr_d, n_iters=n_iters, n_cg=15,
                            mesh=mesh)

    with trace_span("sfm_scale.sequential"):
        v0 = 1
        while v0 < V:
            st, prev, flags = _chunk_register_jit(
                st, tid_d, uv_d, ok_d, v0, rec.n_segments - 1, prev, seed, intr_d, max_err_n, min_par_cos,
                n_steps=ba_every, min_inliers=min_inliers, min_gap=min_gap)
            flags = _host(flags)  # (n_steps, 4): the chunk's one read
            new_regs = 0
            reinit_at = -1
            for i in range(flags.shape[0]):
                v = v0 + i
                if v >= V:
                    break
                newly, n_inl, n_have, already = flags[i]
                if already:
                    continue
                if newly:
                    rec.reg_order.append(v)
                    rec.seg_of_view[v] = rec.n_segments - 1
                    rec.registered[v] = True
                    new_regs += 1
                    fail_streak = 0
                else:
                    rec.log.append(("fail", v, int(n_inl), int(n_have)))
                    fail_streak += 1
                    if fail_streak >= reinit_after and reinit_at < 0:
                        reinit_at = v
            if new_regs:
                vids, cfree, live = window_vids()
                if vids is not None:
                    st = _windowed_ba_jit(st, tid_d, uv_d, ok_d, vids, cfree, live, rec.n_segments - 1, intr_d,
                                          W=window, n_iters=window_iters, n_cg=window_cg)
                regs_since_global += new_regs
            if reinit_at >= 0 and reinit_at + min_gap < V:
                # tracking lost: pull state, re-init a fresh segment anchored
                # near the last registered pose, push back
                first_view, first_uv = _pull_state(st, rec)
                pv = rec.reg_order[-1]
                if try_init(reinit_at, base_R=rec.Rs[pv].copy(), base_t=rec.ts[pv].copy()):
                    rec.log.append(("reinit", reinit_at, rec.n_segments - 1))
                    fail_streak = 0
                    prev = torch.full((1,), rec.reg_order[-1], dtype=torch.long, device=dev)
                    st = _push_state(rec, first_view, first_uv, dev)
                    v0 = reinit_at + 1
                    continue
                # failed re-init: back off before trying again
                fail_streak = 0
                st = _push_state(rec, first_view, first_uv, dev)
            trigger = global_every and regs_since_global >= global_every
            if global_growth and len(rec.reg_order) >= next_global_mark:
                trigger = True
                next_global_mark = int(max(next_global_mark * global_growth, next_global_mark + 2 * ba_every))
            if trigger:
                # COLMAP-style growth-triggered global refinement: the model
                # is re-bundled every ~global_growth x growth, so drift never
                # accumulates past what LM can pull back
                bundle_all(10)
                regs_since_global = 0
            if progress_every and len(rec.reg_order) % progress_every < ba_every:
                print(f"[sfm_scale] v0={v0} registered {len(rec.reg_order)}/{V}", flush=True)
            v0 += ba_every

    with trace_span("sfm_scale.global_ba"):
        if final_global_iters:
            # the libmv fixpoint at global scale: re-intersect <-> bundle
            # (pipeline.cc:138-264's alternation, batched over everything),
            # with outlier observations pruned before each bundle
            for _ in range(3):
                bundle_all(final_global_iters)
        _pull_state(st, rec)
    if mesh is not None:
        check_replicated(mesh, zlib.crc32(np.asarray(rec.reg_order, np.int64).tobytes()), "reg_order")
    return rec
