"""Incremental Euclidean reconstruction driver — the port of
opencv_contrib_tpu/sfm/pipeline.py (libmv's simple pipeline):

- init-pair selection by GRIC(H) against GRIC(F) (`gric_scores`,
  `select_init_pair`);
- two-frame init: 8-point F -> E -> cheirality-chosen (R, t)
  (`initialize_two_view`);
- the fixpoint loop: intersect every unreconstructed track seen by >= 2
  registered views -> bundle -> resect every unregistered view with >= 6
  known points -> bundle, until nothing changes (`reconstruct_incremental`);
- the reference's reprojection metrics (`Reconstruction`).

The state is host numpy (`Reconstruction`, `TracksTensor`); each stage is
batched tensor work on the device over the full (views, tracks) grid with
masks, and only the control flow runs on the host. The public functions run
on the card unless the caller passes `device="cpu"`, and their matrix
products run in full f32.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from opencv_contrib_tpu_torch.ba import bundle, sparse
from opencv_contrib_tpu_torch.core import camera as cam
from opencv_contrib_tpu_torch.core import se3
from opencv_contrib_tpu_torch.mvg import fundamental, homography, resection, robust, triangulation
from opencv_contrib_tpu_torch.sfm.tracks import TracksTensor
from opencv_contrib_tpu_torch.utils.device import resolve
from opencv_contrib_tpu_torch.utils.precision import f32_matmuls
from opencv_contrib_tpu_torch.utils.tracing import trace_span


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def _on(device, a, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


@dataclass
class Reconstruction:
    """Cameras (world->cam) and points of the registered views and
    reconstructed tracks — libmv's EuclideanReconstruction store. The same
    fields as the JAX package's, all host numpy."""

    Rs: np.ndarray  # (V, 3, 3)
    ts: np.ndarray  # (V, 3)
    points: np.ndarray  # (T, 3)
    registered: np.ndarray  # (V,) bool
    has_point: np.ndarray  # (T,) bool
    intr: np.ndarray  # (9,)
    log: list = field(default_factory=list)

    def _problem(self, tracks: TracksTensor, device):
        mask = tracks.mask & self.registered[:, None] & self.has_point[None, :]
        if not mask.any():
            return None
        return bundle.make_problem_from_scene(self.Rs, self.ts, self.points, self.intr, tracks.obs, mask,
                                              device=resolve(device))

    @f32_matmuls
    def reprojection_rms(self, tracks: TracksTensor, device="cuda") -> float:
        """RMS pixel reprojection error over the markers of registered views
        and reconstructed tracks."""
        prob = self._problem(tracks, device)
        if prob is None:
            return float("inf")
        return float(bundle.rms_reprojection_error(prob.cameras, prob.points, prob.intr, prob.obs, prob.mask))

    @f32_matmuls
    def reprojection_mean(self, tracks: TracksTensor, device="cuda") -> float:
        """MEAN of per-marker Euclidean reprojection errors over those markers
        — the reference's error metric (pipeline.cc:266-318), which its
        1.4 px pipeline gate is stated in."""
        prob = self._problem(tracks, device)
        if prob is None:
            return float("inf")
        r = bundle.residuals(prob.cameras, prob.points, prob.intr, prob.obs, prob.mask)
        return float(torch.sum(torch.linalg.norm(r, dim=-1)) / torch.sum(prob.mask))


@f32_matmuls
def gric_scores(x1: np.ndarray, x2: np.ndarray, img_shape=(480, 640), device="cuda") -> tuple[float, float]:
    """GRIC(H) and GRIC(F) of an image pair's correspondences (N, 2); lower
    is better. A good init pair has GRIC(F) < GRIC(H): parallax that a
    homography cannot explain."""
    n = x1.shape[0]
    if n < 8:
        return 0.0, float("inf")
    dev = resolve(device)
    a, b = _on(dev, x1), _on(dev, x2)
    eH = _host(homography.transfer_error(homography.dlt(a, b), a, b))
    eF = _host(fundamental.sampson_distance(fundamental.eight_point(a, b), a, b))
    r = 4.0  # data dimension
    sigma2 = 1.0  # px^2 noise scale
    lam3 = 2.0

    def gric(e, d, k):
        rho = np.minimum(e / sigma2, lam3 * (r - d))
        return rho.sum() + n * d * np.log(r) + k * np.log(r * n)

    return gric(eH, 2.0, 8), gric(eF, 3.0, 7)


def select_init_pair(tracks: TracksTensor, min_common: int = 16, max_candidates: int = 16,
                     device="cuda") -> tuple[int, int]:
    """Best two-frame init pair: enough common tracks and GRIC(F) << GRIC(H).
    The candidates are the `max_candidates` pairs with the most common tracks
    (one boolean product on the host); GRIC runs on those alone."""
    V = tracks.n_views
    m = tracks.mask.astype(np.float32)
    counts = m @ m.T  # (V, V) common-track counts
    iu = np.triu_indices(V, k=1)
    cand = np.stack([iu[0], iu[1], counts[iu]], axis=1)
    cand = cand[cand[:, 2] >= min_common]
    if len(cand) == 0:
        return (0, min(1, V - 1))
    cand = cand[np.argsort(-cand[:, 2])][:max_candidates]
    best, best_score = (int(cand[0, 0]), int(cand[0, 1])), -np.inf
    for i, j, _ in cand:
        i, j = int(i), int(j)
        common = tracks.common_tracks(i, j)
        gH, gF = gric_scores(tracks.obs[i, common], tracks.obs[j, common], device=device)
        score = (gH - gF) / max(len(common), 1) + 0.01 * len(common)
        if score > best_score:
            best_score, best = score, (i, j)
    return best


def _undistort_normalize(intr, px):
    """Pixels -> undistorted normalized camera coords."""
    return cam.undistort(intr, cam.normalize_points(intr, px))


@f32_matmuls
def initialize_two_view(tracks: TracksTensor, intr: np.ndarray, i: int, j: int,
                        generator: torch.Generator | None = None, device="cuda") -> Reconstruction:
    """Two-frame Euclidean init: robust F -> E -> cheirality-chosen (R, t),
    camera i at the identity. The device work runs over the full track axis
    with the common-visibility mask. `generator` (on `device`) draws the
    RANSAC samples; by default one seeded with 0."""
    dev = resolve(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    m = _on(dev, tracks.mask[i] & tracks.mask[j], torch.bool)
    x1, x2 = _on(dev, tracks.obs[i]), _on(dev, tracks.obs[j])
    res = robust.fundamental_8pt_robust(generator, x1, x2, threshold_px=1.5, mask=m)
    intr_d = _on(dev, intr)
    K = cam.intrinsics_to_K(intr_d)
    E = fundamental.project_to_essential(fundamental.essential_from_fundamental(res.model, K, K))
    Rs4, ts4 = fundamental.motions_from_essential(E)
    x1n = _undistort_normalize(intr_d, x1)
    x2n = _undistort_normalize(intr_d, x2)
    inl = res.inliers & m
    R, t, _ = fundamental.choose_motion_cheirality(Rs4, ts4, x1n, x2n, inl)

    V, T = tracks.n_views, tracks.n_tracks
    rec = Reconstruction(
        Rs=np.tile(np.eye(3, dtype=np.float32), (V, 1, 1)),
        ts=np.zeros((V, 3), np.float32),
        points=np.zeros((T, 3), np.float32),
        registered=np.zeros(V, bool),
        has_point=np.zeros(T, bool),
        intr=np.asarray(intr, np.float32),
    )
    rec.Rs[j] = _host(R)
    rec.ts[j] = _host(t)
    rec.registered[i] = rec.registered[j] = True

    # triangulate the inlier tracks; keep points in front of both cameras
    X = triangulation.triangulate_midpoint_two_view(x1n, x2n, R, t)
    z2 = (se3.rotate_points(R, X) + t)[:, 2]
    ok = _host(inl & (X[:, 2] > 1e-3) & (z2 > 1e-3))
    rec.points[ok] = _host(X)[ok]
    rec.has_point[ok] = True
    rec.log.append(("init", i, j, int(ok.sum())))
    return rec


# above this many observations the bundle without intrinsics runs on the
# bucketed sparse solver (ba/sparse.py): the dense (C, P) grid's Jacobian
# buffers are O(C * P) whatever the fill
SPARSE_BA_OBS_THRESHOLD = 100_000


def _run_bundle_sparse(rec: Reconstruction, tracks: TracksTensor, mask: np.ndarray, n_iters: int, device="cuda"):
    """Run the fixpoint's bundle on ba/sparse.py: the flat observation list
    (capacity rounded up to 4096) and its camera buckets. The buckets are
    cached on the reconstruction and reused while the sparsity pattern is
    unchanged, so the fixpoint's repeated solves skip the host argsort."""
    c_idx, p_idx = np.nonzero(mask)
    n = len(c_idx)
    cap = max(4096, int(np.ceil(n / 4096)) * 4096)
    obs_cam = np.zeros(cap, np.int32)
    obs_pt = np.zeros(cap, np.int32)
    obs_uv = np.zeros((2, cap), np.float32)
    obs_ok = np.zeros(cap, bool)
    obs_cam[:n] = c_idx
    obs_pt[:n] = p_idx
    obs_uv[:, :n] = tracks.obs[c_idx, p_idx].T
    obs_ok[:n] = True

    dev = resolve(device)
    fingerprint = (str(dev), cap, n, int(c_idx[0]) if n else 0, int(p_idx[-1]) if n else 0,
                   hash(c_idx.tobytes()) ^ hash(p_idx.tobytes()))
    cache = getattr(rec, "_sparse_ba_cache", None)
    if cache is not None and cache[0] == fingerprint:
        buckets = cache[1]
    else:
        buckets = sparse.build_buckets(obs_cam, obs_pt, obs_ok, mask.shape[0], mask.shape[1], device=dev)
        rec._sparse_ba_cache = (fingerprint, buckets)

    prob = sparse.make_sparse_problem(rec.Rs, rec.ts, rec.points, rec.intr, obs_cam, obs_pt, obs_uv, obs_ok,
                                      device=dev)
    out = sparse.bundle_adjust_sparse(
        prob, n_iters=n_iters, fix_first_cam=True,
        cam_free=_on(dev, rec.registered, torch.bool), pt_free=_on(dev, rec.has_point, torch.bool),
        n_cg=15, buckets=buckets)
    _store(rec, out)


def _store(rec: Reconstruction, out):
    """Write a bundle's cameras and points back for the registered views and
    reconstructed tracks."""
    Rm = _host(se3.exp_so3(out.cameras[:, :3]))
    rec.Rs = np.where(rec.registered[:, None, None], Rm, rec.Rs).astype(np.float32)
    rec.ts = np.where(rec.registered[:, None], _host(out.cameras[:, 3:]), rec.ts).astype(np.float32)
    rec.points = np.where(rec.has_point[:, None], _host(out.points), rec.points).astype(np.float32)


def _run_bundle(rec: Reconstruction, tracks: TracksTensor, n_iters: int = 12, optimize_intr=False, device="cuda"):
    mask = tracks.mask & rec.registered[:, None] & rec.has_point[None, :]
    if not optimize_intr and int(mask.sum()) > SPARSE_BA_OBS_THRESHOLD:
        _run_bundle_sparse(rec, tracks, mask, n_iters, device=device)
        return
    dev = resolve(device)
    prob = bundle.make_problem_from_scene(rec.Rs, rec.ts, rec.points, rec.intr, tracks.obs, mask, device=dev)
    out = bundle.bundle_adjust(
        prob, n_iters=n_iters, optimize_intr=optimize_intr,
        cam_free=_on(dev, rec.registered, torch.bool), pt_free=_on(dev, rec.has_point, torch.bool),
    )
    _store(rec, out)
    if optimize_intr:
        rec.intr = _host(out.intr)


@f32_matmuls
def _intersect_batch(obs, cand_mask, Rs, ts, intr, max_err_px, iters=5):
    """Triangulate ALL tracks over the full (V, T) grid and report per-track
    acceptance: obs (V, T, 2), cand_mask (V, T), Rs (V, 3, 3), ts (V, 3),
    intr (9,) -> X (T, 3), ok (T,).

    Triangulation runs on undistorted normalized coords with P = [R|t];
    acceptance reprojects through the full distortion model: positive depth
    in every observing view and a MEDIAN reprojection error under
    `max_err_px` (a per-view veto would deadlock on one weak tail pose)."""
    xn = _undistort_normalize(intr, obs)  # (V, T, 2)
    Ps = torch.cat([Rs, ts[:, :, None]], dim=2)  # (V, 3, 4)
    X = triangulation.triangulate_points_refined(xn.transpose(0, 1), Ps, cand_mask.T, iters=iters)
    px, z = cam.project(intr, Rs[:, None], ts[:, None], X[None])  # (V, T, 2), (V, T)
    err = torch.linalg.norm(px - obs, dim=-1)  # (V, T)
    cheir_ok = torch.all((~cand_mask) | (z > 1e-3), dim=0)
    n_obs = torch.clamp(torch.sum(cand_mask, dim=0), min=1)  # (T,)
    err_sorted = torch.sort(torch.where(cand_mask, err, torch.full_like(err, torch.inf)), dim=0).values
    med = torch.gather(err_sorted, 0, ((n_obs - 1) // 2)[None, :])[0]
    return X, cheir_ok & (med < max_err_px)


def _intersect_new_tracks(rec: Reconstruction, tracks: TracksTensor, min_views: int = 2, max_err_px: float = 16.0,
                          device="cuda") -> int:
    """Triangulate all unreconstructed tracks with >= min_views registered
    observations (EuclideanIntersect over the batch)."""
    cand_mask = tracks.mask & rec.registered[:, None]
    todo = (~rec.has_point) & (cand_mask.sum(axis=0) >= min_views)
    if not todo.any():
        return 0
    dev = resolve(device)
    X, ok = _intersect_batch(_on(dev, tracks.obs), _on(dev, cand_mask, torch.bool), _on(dev, rec.Rs),
                             _on(dev, rec.ts), _on(dev, rec.intr), max_err_px)
    accept = _host(ok) & todo
    rec.points[accept] = _host(X)[accept]
    rec.has_point[accept] = True
    return int(accept.sum())


def _resect_new_views(rec: Reconstruction, tracks: TracksTensor, min_points: int = 5,
                      generator: torch.Generator | None = None, device="cuda") -> int:
    """Register every unregistered view with >= max(min_points, 6) known 3D
    tracks (EuclideanResect over the candidates), in view order. Each view
    reads its inlier count back to the host to decide."""
    dev = resolve(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(1)
    need = max(min_points, 6)
    n_new = 0
    X_all = _on(dev, rec.points)
    # every view's markers, normalized in one batch; masks on the device
    xn_all = _undistort_normalize(_on(dev, rec.intr), _on(dev, tracks.obs))
    corr_all = _on(dev, tracks.mask, torch.bool) & _on(dev, rec.has_point, torch.bool)
    for v in range(tracks.n_views):
        if rec.registered[v]:
            continue
        if (tracks.mask[v] & rec.has_point).sum() < need:
            continue
        # full-(T,) masked resection: one program shape for every view
        m, xn = corr_all[v], xn_all[v]
        rres = robust.pnp_robust(generator, X_all, xn, threshold=0.01, mask=m)
        n_inl = int(rres.n_inliers)
        if n_inl < need:
            continue
        R, t, _ = resection.refine_pose(rres.model[:, :3], rres.model[:, 3], X_all, xn, rres.inliers & m, iters=10)
        Rt = _host(torch.cat([R, t[:, None]], dim=1))
        rec.Rs[v], rec.ts[v] = Rt[:, :3], Rt[:, 3]
        rec.registered[v] = True
        rec.log.append(("resect", v, n_inl))
        n_new += 1
    return n_new


@f32_matmuls
def reconstruct_incremental(
    tracks: TracksTensor,
    intr: np.ndarray,
    init_pair: tuple[int, int] | None = None,
    max_rounds: int = 20,
    refine_intrinsics: bool = False,
    seed: int = 0,
    device="cuda",
) -> Reconstruction:
    """Full incremental SfM — the cv::sfm::reconstruct contract: init pair ->
    alternate intersect / resect with bundling until a fixpoint, then an
    optional intrinsics refinement. `seed` seeds the RANSAC draws (a
    `torch.Generator` on `device`). Above SPARSE_BA_OBS_THRESHOLD
    observations a bundle without intrinsics runs on the sparse solver."""
    dev = resolve(device)
    generator = torch.Generator(dev).manual_seed(seed)
    if init_pair is None:
        init_pair = select_init_pair(tracks, device=dev)
    i, j = init_pair
    with trace_span("sfm.init_two_view"):
        rec = initialize_two_view(tracks, intr, i, j, generator, device=dev)
        _run_bundle(rec, tracks, device=dev)

    for round_idx in range(max_rounds):
        with trace_span("sfm.intersect"):
            n_pts = _intersect_new_tracks(rec, tracks, device=dev)
        if n_pts:
            with trace_span("sfm.bundle"):
                _run_bundle(rec, tracks, device=dev)
        with trace_span("sfm.resect"):
            n_views = _resect_new_views(rec, tracks, generator=generator, device=dev)
        if n_views:
            with trace_span("sfm.bundle"):
                _run_bundle(rec, tracks, device=dev)
        rec.log.append(("round", round_idx, n_pts, n_views))
        if n_pts == 0 and n_views == 0:
            break

    with trace_span("sfm.final_bundle"):
        if refine_intrinsics:
            # alternate intrinsics refinement with re-intersection: tracks
            # rejected under the first distortion estimate may triangulate
            # once the intrinsics settle
            for _ in range(2):
                _run_bundle(rec, tracks, n_iters=15, optimize_intr=True, device=dev)
                if _intersect_new_tracks(rec, tracks, device=dev) == 0:
                    break
        _run_bundle(rec, tracks, n_iters=15, device=dev)
    return rec
