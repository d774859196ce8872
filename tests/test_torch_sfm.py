"""Parity of the port's incremental SfM driver (opencv_contrib_tpu_torch.sfm and
.mvg) with the JAX package on the CPU.

Inputs are made with numpy from a seed. The RANSAC draws of the two packages
come from different generators, so the parity tests record the JAX package's
draws in call order (a spy on opencv_contrib_tpu.mvg.robust.sample_indices)
and replay them into the port (which looks `robust.sample_indices` up at each
call). Each test states its tolerance."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu.core import camera as jcam
from opencv_contrib_tpu.mvg import conditioning as jcond
from opencv_contrib_tpu.mvg import fundamental as jfund
from opencv_contrib_tpu.mvg import homography as jhom
from opencv_contrib_tpu.mvg import robust as jrob
from opencv_contrib_tpu.mvg import triangulation as jtri
from opencv_contrib_tpu.sfm import pairing as jpair
from opencv_contrib_tpu.sfm import pipeline as jpipe
from opencv_contrib_tpu.sfm import tracks as jtrk
from opencv_contrib_tpu.utils.synthetic import generate_scene as jscene
from opencv_contrib_tpu_torch import entry, interop
from opencv_contrib_tpu_torch.core import camera as tcam
from opencv_contrib_tpu_torch.mvg import conditioning as tcond
from opencv_contrib_tpu_torch.mvg import fundamental as tfund
from opencv_contrib_tpu_torch.mvg import homography as thom
from opencv_contrib_tpu_torch.mvg import robust as trob
from opencv_contrib_tpu_torch.mvg import triangulation as ttri
from opencv_contrib_tpu_torch.sfm import pairing as tpair
from opencv_contrib_tpu_torch.sfm import pipeline as tpipe
from opencv_contrib_tpu_torch.sfm import tracks as ttrk
from opencv_contrib_tpu_torch.utils import tracing
from opencv_contrib_tpu_torch.utils.synthetic import generate_scene as tscene

# The suite runs several worker processes beside XLA's thread pools; at
# these sizes torch's own per-process OpenMP pool only oversubscribes the CPU.
torch.set_num_threads(1)
CPU = "cpu"


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def J(a):
    return jnp.asarray(np.asarray(a))


@pytest.fixture(scope="module")
def scene():
    return jscene(n_views=4, n_points=120, seed=3)


def _pair(scene, i=0, j=1):
    idx = np.flatnonzero(scene.visible[i] & scene.visible[j])
    return scene.points2d[i][idx], scene.points2d[j][idx], idx


# --- replayed RANSAC draws -----------------------------------------------------


class Draws:
    """The JAX package's `sample_indices` results in call order, each with the
    mask it drew under; `replay` feeds them to the port in the same order."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def record(self):
        orig = jrob.sample_indices

        def spy(key, n_points, mask, n_hypotheses, sample_size):
            idx = orig(key, n_points, mask, n_hypotheses, sample_size)
            self.calls.append((np.asarray(mask), np.asarray(idx)))
            return idx

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jrob, "sample_indices", spy)
            yield self

    @contextlib.contextmanager
    def replay(self):
        calls = iter(self.calls)

        def replayed(generator, n_points, mask, n_hypotheses, sample_size):
            jmask, idx = next(calls)
            assert idx.shape == (n_hypotheses, sample_size)
            np.testing.assert_array_equal(N(mask), jmask)  # the same state draws the same samples
            return torch.from_numpy(idx.astype(np.int64)).to(mask.device)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(trob, "sample_indices", replayed)
            yield
        assert next(calls, None) is None, "the port drew fewer times than the JAX package"


# --- camera, conditioning ------------------------------------------------------


def test_intrinsics_to_K_and_back(rng):
    intr = rng.uniform(1, 600, size=(3, 9)).astype(np.float32)
    K_t = tcam.intrinsics_to_K(T(intr))
    np.testing.assert_array_equal(N(K_t), np.asarray(jcam.intrinsics_to_K(J(intr))))
    np.testing.assert_array_equal(N(tcam.K_to_intrinsics(K_t)), np.asarray(jcam.K_to_intrinsics(J(N(K_t)))))


@pytest.mark.parametrize("masked", [False, True])
def test_conditioning(rng, masked):
    """rtol 1e-6 (a mean and a mean distance in f32)."""
    pts = rng.uniform(0, 640, size=(40, 2)).astype(np.float32)
    mask = rng.uniform(size=40) > 0.3 if masked else None
    Tj = jcond.preconditioner_from_points(J(pts), None if mask is None else J(mask))
    Tt = tcond.preconditioner_from_points(T(pts), None if mask is None else T(mask))
    np.testing.assert_allclose(N(Tt), np.asarray(Tj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(N(tcond.apply_transform(Tt, T(pts))), np.asarray(jcond.apply_transform(Tj, J(pts))),
                               rtol=1e-5, atol=1e-6)
    batch = np.stack([pts, pts[::-1] * 0.5])
    Tb = tcond.preconditioner_from_points(T(batch))
    np.testing.assert_allclose(N(Tb[1]), np.asarray(jcond.preconditioner_from_points(J(batch[1]))), rtol=1e-6,
                               atol=1e-6)


# --- two-view geometry -----------------------------------------------------------


def test_eight_point_masked_and_padded(scene, rng):
    """F normalised by F[2, 2] within atol 1e-5 of the JAX package; 20 padded
    garbage rows under a False mask change nothing beyond it."""
    x1, x2, _ = _pair(scene)
    Fj = np.asarray(jfund.eight_point(J(x1), J(x2)))
    Ft = N(tfund.eight_point(T(x1), T(x2)))
    np.testing.assert_allclose(Ft, Fj, atol=1e-5)
    pad = rng.uniform(0, 640, size=(20, 2)).astype(np.float32)
    p1, p2 = np.concatenate([x1, pad]), np.concatenate([x2, pad[::-1]])
    m = np.concatenate([np.ones(len(x1), bool), np.zeros(20, bool)])
    Fjm = np.asarray(jfund.eight_point(J(p1), J(p2), J(m)))
    Ftm = N(tfund.eight_point(T(p1), T(p2), T(m)))
    np.testing.assert_allclose(Ftm, Fjm, atol=1e-5)
    np.testing.assert_allclose(Ftm, Ft, atol=1e-5)
    # the batched solver: each sample as the single call
    Fb = N(tfund.eight_point(T(np.stack([x1[:8], x1[8:16]])), T(np.stack([x2[:8], x2[8:16]]))))
    np.testing.assert_allclose(Fb[1], N(tfund.eight_point(T(x1[8:16]), T(x2[8:16]))), atol=1e-6)
    np.testing.assert_allclose(Fb[1], np.asarray(jfund.eight_point(J(x1[8:16]), J(x2[8:16]))), rtol=1e-3, atol=1e-5)


CUBICS = [(1.0, -6.0, 11.0, -6.0),  # three real roots 1, 2, 3
          (2.0, 0.0, 3.0, 4.0),  # one real root
          (0.5, -1.5, 0.0, 0.2),
          (0.0, 1.0, -3.0, 2.0),  # quadratic: 1, 2
          (0.0, 1.0, 0.0, 1.0),  # quadratic without real roots
          (0.0, 0.0, 2.0, -4.0),  # linear: 2
          (0.0, 0.0, 0.0, 1.0)]  # no root


def test_cubic_roots():
    """Roots within 1e-5 (|root| + 1) of the JAX package; the same validity."""
    a, b, c, d = (np.array(v, np.float32) for v in zip(*CUBICS))
    rj, vj = jax.vmap(jfund._cubic_roots)(J(a), J(b), J(c), J(d))
    rt, vt = tfund._cubic_roots(T(a), T(b), T(c), T(d))
    np.testing.assert_array_equal(N(vt), np.asarray(vj))
    rj = np.asarray(rj)
    np.testing.assert_allclose(np.where(N(vt), N(rt), 0), np.where(N(vt), rj, 0), rtol=1e-5, atol=1e-5)


def test_seven_point(scene):
    """The same roots and validity on 7 exact correspondences (the null
    basis of the 7 x 9 system is the same LAPACK SVD's); F within atol 1e-4
    after normalisation by F[2, 2]."""
    x1, x2, _ = _pair(scene)
    for s in (slice(0, 7), slice(20, 27), slice(40, 47)):
        Fj, vj = jfund.seven_point(J(x1[s]), J(x2[s]))
        Ft, vt = tfund.seven_point(T(x1[s]), T(x2[s]))
        np.testing.assert_array_equal(N(vt), np.asarray(vj))
        v = N(vt)
        np.testing.assert_allclose(N(Ft)[v], np.asarray(Fj)[v], atol=1e-4)
        # one of the valid roots is the true F: epipolar residual ~0
        d = N(tfund.epipolar_distance(Ft, T(x1), T(x2)))
        assert min(d[k].max() for k in np.flatnonzero(v)) < 1e-3


def test_homography(rng):
    """H within rtol 1e-4 of the JAX package; transfer errors within 1e-4 px^2."""
    H = np.array([[1.0, 0.1, 5.0], [0.02, 1.1, -3.0], [1e-4, -2e-4, 1.0]], np.float32)
    x1 = rng.uniform(0, 100, size=(30, 2)).astype(np.float32)
    y = np.concatenate([x1, np.ones((30, 1), np.float32)], 1) @ H.T
    x2 = (y[:, :2] / y[:, 2:] + rng.normal(scale=0.3, size=(30, 2))).astype(np.float32)
    mask = rng.uniform(size=30) > 0.2
    for m in (None, mask):
        Hj = np.asarray(jhom.dlt(J(x1), J(x2), None if m is None else J(m)))
        Ht = N(thom.dlt(T(x1), T(x2), None if m is None else T(m)))
        np.testing.assert_allclose(Ht, Hj, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(N(thom.transfer_error(T(Ht), T(x1), T(x2))),
                                   np.asarray(jhom.transfer_error(J(Ht), J(x1), J(x2))), rtol=1e-5, atol=1e-4)


def test_distances_essential_and_motion(scene, rng):
    """Sampson and epipolar distances rtol 1e-5; E from F and its projection
    rtol 1e-5 (scale-free: both normalised); the four motions as a set, and
    the chosen (R, t) within 1e-5 on a pair where one candidate has the most
    points in front (no tie at the top). The candidates' order follows the
    SVD's signs, so best_index may differ."""
    x1, x2, _ = _pair(scene)
    x1n = x1 + rng.normal(scale=0.5, size=x1.shape).astype(np.float32)
    F = np.asarray(jfund.eight_point(J(x1n), J(x2)))
    for jf, tf in ((jfund.sampson_distance, tfund.sampson_distance),
                   (jfund.epipolar_distance, tfund.epipolar_distance)):
        np.testing.assert_allclose(N(tf(T(F), T(x1n), T(x2))), np.asarray(jf(J(F), J(x1n), J(x2))), rtol=1e-5,
                                   atol=1e-9)
    K = scene.K
    Ej = jfund.essential_from_fundamental(J(F), J(K), J(K))
    Et = tfund.essential_from_fundamental(T(F), T(K), T(K))
    np.testing.assert_allclose(N(Et), np.asarray(Ej), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(N(tfund.fundamental_from_essential(Et, T(K), T(K))),
                               np.asarray(jfund.fundamental_from_essential(Ej, J(K), J(K))), rtol=1e-4, atol=1e-9)
    Pj, Pt = jfund.project_to_essential(Ej), tfund.project_to_essential(Et)
    np.testing.assert_allclose(N(Pt), np.asarray(Pj), rtol=1e-4, atol=1e-5)

    Rsj, tsj = jfund.motions_from_essential(Pj)
    Rst, tst = tfund.motions_from_essential(Pt)
    Rsj, tsj, Rst, tst = map(np.asarray, (Rsj, tsj, N(Rst), N(tst)))
    for k in range(4):  # every port candidate is one of the JAX package's
        d = [np.abs(Rst[k] - Rsj[m]).max() + np.abs(tst[k] - tsj[m]).max() for m in range(4)]
        assert min(d) < 1e-4, d

    intr = J(scene.intr)
    a, b = jcam.normalize_points(intr, J(x1)), jcam.normalize_points(intr, J(x2))
    Rj, tj, _ = jfund.choose_motion_cheirality(J(Rsj), J(tsj), a, b)
    Rt, tt, _ = tfund.choose_motion_cheirality(T(Rst), T(tst), T(np.asarray(a)), T(np.asarray(b)))
    z1, z2 = jax.vmap(lambda R, t: jfund._two_view_depths(R, t, a, b))(J(Rsj), J(tsj))
    counts = np.sum((np.asarray(z1) > 0) & (np.asarray(z2) > 0), axis=1)
    assert np.sort(counts)[-1] > np.sort(counts)[-2], counts  # no tie at the top
    np.testing.assert_allclose(N(Rt), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(N(tt), np.asarray(tj), atol=1e-5)
    # cheirality by the true relative motion
    Rrel, trel = jfund.relative_camera_motion(J(scene.Rs[0]), J(scene.ts[0]), J(scene.Rs[1]), J(scene.ts[1]))
    Rrt, trt = tfund.relative_camera_motion(T(scene.Rs[0]), T(scene.ts[0]), T(scene.Rs[1]), T(scene.ts[1]))
    np.testing.assert_allclose(N(Rrt), np.asarray(Rrel), atol=1e-6)
    np.testing.assert_allclose(N(trt), np.asarray(trel), atol=1e-5)
    np.testing.assert_allclose(N(Rt), np.asarray(Rrel), atol=1e-2)
    Ej2 = jfund.essential_from_Rt(J(scene.Rs[0]), J(scene.ts[0]), J(scene.Rs[1]), J(scene.ts[1]))
    Et2 = tfund.essential_from_Rt(T(scene.Rs[0]), T(scene.ts[0]), T(scene.Rs[1]), T(scene.ts[1]))
    np.testing.assert_allclose(N(Et2), np.asarray(Ej2), atol=1e-5)


def test_projections_from_fundamental(scene):
    """P1 equal; P2 within 5e-5 (entries up to 1) up to the sign of the SVD's
    epipole, the left null vector of a rank-2 F."""
    x1, x2, _ = _pair(scene)
    F = np.asarray(jfund.eight_point(J(x1), J(x2)))
    P1j, P2j = jfund.projections_from_fundamental(J(F))
    P1t, P2t = tfund.projections_from_fundamental(T(F))
    np.testing.assert_array_equal(N(P1t), np.asarray(P1j))
    P2j, P2t = np.asarray(P2j), N(P2t)
    s = np.sign(np.sum(P2j * P2t))
    np.testing.assert_allclose(s * P2t, P2j, atol=5e-5)


# --- triangulation -----------------------------------------------------------


@pytest.fixture(scope="module")
def tri_case(scene):
    """Noisy pixels of 4 views, each track missing from some views."""
    rng = np.random.default_rng(5)
    K = scene.K
    Ps = np.stack([K @ np.concatenate([R, t[:, None]], 1) for R, t in zip(scene.Rs, scene.ts)]).astype(np.float32)
    pts = np.transpose(scene.points2d, (1, 0, 2)) + rng.normal(scale=0.5, size=(120, 4, 2)).astype(np.float32)
    mask = np.transpose(scene.visible) & (rng.uniform(size=(120, 4)) > 0.15)
    mask[:, :2] = True  # at least two views each
    return pts.astype(np.float32), Ps, mask


def test_triangulation(tri_case, scene):
    """DLT within 2e-4 of the JAX package on the scene (about 2 units across),
    one track and the batch; the Gauss-Newton polish (closed-form Jacobians
    against jax.jacfwd) within 1e-4; the midpoint within 1e-5."""
    pts, Ps, mask = tri_case
    Xj = np.asarray(jtri.triangulate_points(J(pts), J(Ps), J(mask)))
    Xt = N(ttri.triangulate_points(T(pts), T(Ps), T(mask)))
    np.testing.assert_allclose(Xt, Xj, atol=2e-4)
    np.testing.assert_allclose(N(ttri.triangulate_dlt(T(pts[3]), T(Ps), T(mask[3]))),
                               np.asarray(jtri.triangulate_dlt(J(pts[3]), J(Ps), J(mask[3]))), atol=2e-4)
    Rj = np.asarray(jtri.refine_points(J(pts), J(Ps), J(Xj), J(mask), iters=3))
    Rt = N(ttri.refine_points(T(pts), T(Ps), T(Xj), T(mask), iters=3))
    np.testing.assert_allclose(Rt, Rj, atol=1e-4)
    np.testing.assert_allclose(N(ttri.triangulate_points_refined(T(pts), T(Ps), T(mask))),
                               np.asarray(jtri.triangulate_points_refined(J(pts), J(Ps), J(mask))), atol=1e-4)
    assert np.abs(Rt - scene.points3d).max() < 0.05
    # per-track projection matrices, as _intersect_batch passes them
    Pn = np.broadcast_to(Ps, (120,) + Ps.shape).copy()
    np.testing.assert_allclose(N(ttri.triangulate_points(T(pts), T(Pn), T(mask))), Xt, atol=1e-6)

    intr = J(scene.intr)
    x1n = np.asarray(jcam.normalize_points(intr, J(scene.points2d[0])))
    x2n = np.asarray(jcam.normalize_points(intr, J(scene.points2d[1])))
    Rr, tr = jfund.relative_camera_motion(J(scene.Rs[0]), J(scene.ts[0]), J(scene.Rs[1]), J(scene.ts[1]))
    Mj = np.asarray(jtri.triangulate_midpoint_two_view(J(x1n), J(x2n), Rr, tr))
    Mt = N(ttri.triangulate_midpoint_two_view(T(x1n), T(x2n), T(np.asarray(Rr)), T(np.asarray(tr))))
    np.testing.assert_allclose(Mt, Mj, rtol=1e-5, atol=1e-5)


# --- robust estimators with replayed draws ---------------------------------------


def _robust_cases(scene):
    rng = np.random.default_rng(11)
    x1, x2, idx = _pair(scene)
    n_out = 30
    f1 = np.concatenate([x1, rng.uniform(0, 640, (n_out, 2))]).astype(np.float32)
    f2 = np.concatenate([x2, rng.uniform(0, 480, (n_out, 2))]).astype(np.float32)
    fmask = rng.uniform(size=len(f1)) > 0.1
    Hgt = np.array([[1.0, 0.1, 5.0], [0.0, 1.1, -3.0], [0.0, 0.0, 1.0]], np.float32)
    h1 = rng.uniform(0, 100, size=(80, 2)).astype(np.float32)
    y = np.concatenate([h1, np.ones((80, 1), np.float32)], 1) @ Hgt.T
    h2 = (y[:, :2] / y[:, 2:]).astype(np.float32)
    h2[:15] += rng.uniform(10, 40, (15, 2)).astype(np.float32)
    v = 3
    pidx = np.flatnonzero(scene.visible[v])[:60]
    X = scene.points3d[pidx]
    xn = np.asarray(jcam.normalize_points(J(scene.intr), J(scene.points2d[v][pidx])))
    xn = xn + rng.normal(scale=1e-3, size=xn.shape).astype(np.float32)
    xn[:12] = rng.uniform(-0.5, 0.5, (12, 2))
    return {
        "8pt": (jrob.fundamental_8pt_robust, trob.fundamental_8pt_robust, (f1, f2), dict(threshold_px=1.0)),
        "8pt_masked": (jrob.fundamental_8pt_robust, trob.fundamental_8pt_robust, (f1, f2),
                       dict(threshold_px=1.5, mask=fmask)),
        "7pt": (jrob.fundamental_7pt_robust, trob.fundamental_7pt_robust, (f1, f2), dict(threshold_px=1.0)),
        "homography": (jrob.homography_robust, trob.homography_robust, (h1, h2), dict(threshold_px=1.0)),
        "pnp": (jrob.pnp_robust, trob.pnp_robust, (X.astype(np.float32), xn.astype(np.float32)),
                dict(threshold=0.005)),
    }


@pytest.mark.parametrize("name", ["8pt", "8pt_masked", "7pt", "homography", "pnp"])
def test_robust_estimators_replayed(scene, name):
    """With the JAX package's draws: the same best_index and inliers, the
    model within 1e-3 (F, H: normalised by [2, 2]; [R | t]), the score
    within rtol 1e-3."""
    jfn, tfn, data, kw = _robust_cases(scene)[name]
    draws = Draws()
    with draws.record():
        rj = jfn(jax.random.PRNGKey(7), *map(J, data), **{k: J(v) if k == "mask" else v for k, v in kw.items()})
    with draws.replay():
        rt = tfn(torch.Generator().manual_seed(7), *map(T, data), **{k: T(v) if k == "mask" else v
                                                                     for k, v in kw.items()})
    assert int(rt.best_index) == int(rj.best_index)
    np.testing.assert_array_equal(N(rt.inliers), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    np.testing.assert_allclose(N(rt.model), np.asarray(rj.model), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(float(rt.score), float(rj.score), rtol=1e-3)
    # and it crosses between the packages
    back = interop.from_numpy(jax.tree.map(np.asarray, rj))
    assert type(back) is trob.RansacResult
    np.testing.assert_array_equal(N(back.inliers), np.asarray(rj.inliers))


def test_ransac_takes_the_first_of_tied_scores():
    """Every hypothesis scores the same (a constant point set): both
    packages' generic `ransac` return hypothesis 0."""
    x = np.full((20, 1), 3.0, np.float32)
    rj = jrob.ransac(jax.random.PRNGKey(0), lambda s: (s.mean(0)[None], jnp.ones((1,), bool)),
                     lambda m, a: jnp.abs(a[:, 0] - m[0]), (J(x),), 20, 3, n_hypotheses=16, threshold=1.0)
    rt = trob.ransac(torch.Generator().manual_seed(0),
                     lambda s: (s.mean(1)[:, None], torch.ones(s.shape[0], 1, dtype=torch.bool)),
                     lambda m, a: torch.abs(a[None, :, 0] - m[:, None, 0]), (T(x),), 20, 3, n_hypotheses=16,
                     threshold=1.0)
    assert int(rj.best_index) == int(rt.best_index) == 0
    assert int(rj.n_inliers) == int(rt.n_inliers) == 20


def test_sample_indices_draws_distinct_valid_points():
    mask = torch.zeros(50, dtype=torch.bool)
    mask[::3] = True
    idx = trob.sample_indices(torch.Generator().manual_seed(0), 50, mask, 64, 8)
    assert idx.shape == (64, 8)
    assert bool(mask[idx].all())
    assert all(len(set(r.tolist())) == 8 for r in idx)
    again = trob.sample_indices(torch.Generator().manual_seed(0), 50, mask, 64, 8)
    assert torch.equal(idx, again)


# --- tracks and pairing --------------------------------------------------------


def _tracks_equal(a, b):
    np.testing.assert_array_equal(a.obs, b.obs)
    np.testing.assert_array_equal(a.mask, b.mask)
    assert a.obs.dtype == b.obs.dtype and a.mask.dtype == b.mask.dtype


def test_build_tracks():
    """tests/test_sfm.py::TestTracks's cases, and a random match graph: exact."""
    kps = [np.array([[10.0 * k, 5.0 * v + k] for k in range(4)], np.float32) for v in range(3)]
    matches = [(0, 1, np.arange(4), np.arange(4)), (1, 2, np.arange(4), np.arange(4))]
    _tracks_equal(ttrk.build_tracks(3, kps, matches), jtrk.build_tracks(3, kps, matches))
    kz = [np.zeros((2, 2), np.float32), np.zeros((2, 2), np.float32)]
    coll = [(0, 1, np.array([0, 1]), np.array([0, 0]))]
    assert ttrk.build_tracks(2, kz, coll).n_tracks == jtrk.build_tracks(2, kz, coll).n_tracks == 0
    k3 = [np.zeros((3, 2), np.float32) for _ in range(2)]
    one = [(0, 1, np.array([0]), np.array([0]))]
    _tracks_equal(ttrk.build_tracks(2, k3, one, min_length=2), jtrk.build_tracks(2, k3, one, min_length=2))
    rng = np.random.default_rng(2)
    kr = [rng.uniform(0, 640, size=(30, 2)).astype(np.float32) for _ in range(5)]
    mr = [(i, j, rng.choice(30, 12, replace=False), rng.choice(30, 12, replace=False))
          for i in range(5) for j in range(i + 1, 5)]
    for max_tracks in (None, 7):
        _tracks_equal(ttrk.build_tracks(5, kr, mr, max_tracks=max_tracks),
                      jtrk.build_tracks(5, kr, mr, max_tracks=max_tracks))
    t = ttrk.build_tracks(5, kr, mr)
    i, j = 1, 3
    np.testing.assert_array_equal(t.common_tracks(i, j), jtrk.build_tracks(5, kr, mr).common_tracks(i, j))


def test_load_blender_tracks_and_observation_list(tmp_path):
    """exact, on a Blender-style file with invisible (-1, -1) markers and
    short lines, and on tests/test_sfm.py's marker rows."""
    path = tmp_path / "tracks.txt"
    path.write_text("10 20 -1 -1 30.5 40\n\n1 2 3 4\n-1 -1 5 6 7 8 9 10\n")
    _tracks_equal(ttrk.load_blender_tracks(str(path)), jtrk.load_blender_tracks(str(path)))
    markers = np.array([[0, 0, 1.0, 2.0], [1, 0, 3.0, 4.0], [1, 1, 5.0, 6.0]])
    _tracks_equal(ttrk.from_observation_list(2, markers), jtrk.from_observation_list(2, markers))


def _pairing_cases():
    rng = np.random.default_rng(0)
    D, K = 32, 64
    base_a = rng.normal(size=(1, 1, D))
    grouped = np.concatenate([base_a + 0.1 * rng.normal(size=(4, K, D)),
                              -base_a + 0.1 * rng.normal(size=(4, K, D))]).astype(np.float32)
    rng = np.random.default_rng(0)
    spread = rng.normal(size=(12, 32, 16)).astype(np.float32)
    return [(grouped, np.ones((8, K), bool), 2), (spread, np.ones((12, 32), bool), 3)]


@pytest.mark.parametrize("case", [0, 1], ids=["selects_similar", "prunes_quadratic"])
def test_pairing(case):
    """tests/test_breadth8.py::TestPairing's cases: the same codebook, the bag
    of words within 1e-6, the same pairs."""
    descs, valids, k = _pairing_cases()[case]
    cj, ct = jpair.make_codebook(descs.shape[-1]), tpair.make_codebook(descs.shape[-1])
    np.testing.assert_array_equal(N(ct), np.asarray(cj))
    bj = np.asarray(jax.vmap(lambda d, v: jpair.bow_descriptor(d, v, cj))(J(descs), J(valids)))
    bt = N(tpair.bow_descriptor(T(descs), T(valids), ct))
    np.testing.assert_allclose(bt, bj, atol=1e-6)
    np.testing.assert_allclose(N(tpair.pair_similarity(T(bt))), np.asarray(jpair.pair_similarity(J(bt))), atol=1e-6)
    assert tpair.select_pairs(descs, valids, k=k) == jpair.select_pairs(descs, valids, k=k)


# --- the pipeline's stages --------------------------------------------------------


def _tracks_from_scene(scene, noise=0.0, seed=0, drop=0.0):
    """tests/test_sfm.py's helper."""
    obs = scene.points2d.copy()
    mask = scene.visible.copy()
    if noise > 0:
        rng = np.random.default_rng(seed)
        obs += rng.normal(scale=noise, size=obs.shape).astype(np.float32)
    if drop > 0:
        rng = np.random.default_rng(seed + 1)
        mask &= rng.uniform(size=mask.shape) > drop
    return jtrk.TracksTensor(obs=obs, mask=mask)


def _pair_score(tracks, i, j):
    common = tracks.common_tracks(i, j)
    gH, gF = jpipe.gric_scores(tracks.obs[i, common], tracks.obs[j, common])
    return (gH - gF) / max(len(common), 1) + 0.01 * len(common)


def test_gric_and_init_pair():
    """GRIC scores within rtol 1e-6 (host float64 sums of f32 errors); the
    same init pair on a noisy scene. On exact data every pair's score ties to
    1e-8 (GRIC(H) saturates, GRIC(F) is rounding), so there the port's pair
    scores within 1e-6 of the JAX package's."""
    scene = jscene(n_views=6, n_points=150, seed=4)
    for noise in (0.5, 0.0):
        t = _tracks_from_scene(scene, noise=noise)
        for i, j in ((0, 1), (1, 3), (2, 5)):
            c = t.common_tracks(i, j)
            np.testing.assert_allclose(tpipe.gric_scores(t.obs[i, c], t.obs[j, c], device=CPU),
                                       jpipe.gric_scores(t.obs[i, c], t.obs[j, c]), rtol=1e-6)
        pj, pt = jpipe.select_init_pair(t), tpipe.select_init_pair(t, device=CPU)
        if noise > 0:
            assert pt == pj
        else:
            assert abs(_pair_score(t, *pt) - _pair_score(t, *pj)) < 1e-6
    # a pure rotation prefers the homography (tests/test_sfm.py::TestGric)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (80, 3)).astype(np.float32) + np.array([0, 0, 4], np.float32)
    intr = tcam.make_intrinsics(500.0, 500.0, 320.0, 240.0)
    from opencv_contrib_tpu_torch.core import se3
    x1, _ = tcam.project(intr, torch.eye(3), torch.zeros(3), T(pts))
    x2, _ = tcam.project(intr, se3.exp_so3(torch.tensor([0.0, 0.15, 0.0])), torch.zeros(3), T(pts))
    gH, gF = tpipe.gric_scores(N(x1), N(x2), device=CPU)
    assert gH < gF


def test_intersect_batch_same_state():
    """Given identical state (true poses of 6 of 8 views, distorted noisy
    pixels, dropped markers): the same `ok`, X within 2e-4."""
    scene = jscene(n_views=8, n_points=200, seed=9, distortion=True)
    t = _tracks_from_scene(scene, noise=0.5, drop=0.2)
    reg = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
    cand = t.mask & reg[:, None]
    args = (t.obs, cand, scene.Rs, scene.ts, scene.intr)
    Xj, okj = jpipe._intersect_batch(*map(J, args), jnp.float32(1.0))
    Xt, okt = tpipe._intersect_batch(*(T(a) for a in args), 1.0)
    okj = np.asarray(okj)
    np.testing.assert_array_equal(N(okt), okj)
    assert 0 < okj.sum() < okj.size  # the gate both accepts and rejects
    np.testing.assert_allclose(N(Xt)[okj], np.asarray(Xj)[okj], atol=2e-4)


def _similarity_rms(A, B):
    """Residual RMS of the best similarity A -> B (Umeyama;
    tests/test_sfm.py's _similarity_align)."""
    muA, muB = A.mean(0), B.mean(0)
    Ac, Bc = A - muA, B - muB
    U, S, Vt = np.linalg.svd(Ac.T @ Bc / len(A))
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / ((Ac ** 2).sum() / len(A))
    return np.sqrt(((s * A @ R + muB - s * muA @ R - B) ** 2).sum(axis=1).mean())


# the scenes of tests/test_sfm.py, and one with distortion and intrinsics
# refinement: (views, points, scene seed, noise, drop, distortion)
SCENES = {"6x150_exact": (6, 150, 4, 0.0, 0.0, False), "6x150_noise": (6, 150, 4, 0.5, 0.0, False),
          "8x200_drop": (8, 200, 9, 0.3, 0.2, False), "8x200_distortion": (8, 200, 9, 0.5, 0.0, True)}
_JAX_RUNS = {}


def _jax_run(name):
    """The JAX package's reconstruction of a scene and its draws, once per
    module."""
    if name not in _JAX_RUNS:
        nv, npt, seed, noise, drop, dist = SCENES[name]
        scene = jscene(n_views=nv, n_points=npt, seed=seed, distortion=dist)
        t = _tracks_from_scene(scene, noise=noise, drop=drop)
        # exact data ties every pair's init score (test_gric_and_init_pair),
        # so that scene takes the JAX package's pair in both runs
        init = jpipe.select_init_pair(t) if noise == 0 else None
        draws = Draws()
        with draws.record():
            rec = jpipe.reconstruct_incremental(t, scene.intr, init_pair=init, refine_intrinsics=dist, seed=0)
        _JAX_RUNS[name] = (scene, t, init, draws, rec)
    return _JAX_RUNS[name]


@pytest.mark.parametrize("name", list(SCENES))
def test_reconstruct_incremental_replayed(name):
    """With the JAX package's draws: the same log (init pair, resection order
    and inlier counts, points per round), the same registered views and
    reconstructed tracks; rms and mean px within 1e-4 px; points within 1e-3
    of the JAX package's after a similarity alignment, on a scene about 2
    units across. With intrinsics refinement: the focal length within rtol
    1e-4, k1 and k2 within 2e-3, the principal point within 1 px. The last
    lies in a valley of the cost that this scene (8 cameras on a half ring at
    one height) leaves flat: the two packages' cy differ by up to 0.7 px here
    while their rms px agree within 1e-4."""
    scene, t, init, draws, rj = _jax_run(name)
    with draws.replay():
        rt = tpipe.reconstruct_incremental(t, scene.intr, init_pair=init, refine_intrinsics=SCENES[name][5], seed=0,
                                           device=CPU)
    assert rt.log == rj.log
    np.testing.assert_array_equal(rt.registered, rj.registered)
    np.testing.assert_array_equal(rt.has_point, rj.has_point)
    assert abs(rt.reprojection_rms(t, device=CPU) - rj.reprojection_rms(t)) < 1e-4
    assert abs(rt.reprojection_mean(t, device=CPU) - rj.reprojection_mean(t)) < 1e-4
    np.testing.assert_allclose(rt.intr[:2], rj.intr[:2], rtol=1e-4)
    np.testing.assert_allclose(rt.intr[2:4], rj.intr[2:4], atol=1.0)
    np.testing.assert_allclose(rt.intr[4:], rj.intr[4:], atol=2e-3)
    sel = rt.has_point
    assert _similarity_rms(rt.points[sel], rj.points[sel]) < 1e-3


@pytest.mark.parametrize("noise,gate", [(0.0, 0.05), (0.5, 1.4)])
def test_port_meets_test_sfm_gates(noise, gate):
    """tests/test_sfm.py's gates, met with the port's own generator and draws."""
    scene = tscene(n_views=6, n_points=150, seed=4)
    t = _tracks_from_scene(scene, noise=noise)
    rec = tpipe.reconstruct_incremental(t, scene.intr, seed=0, device=CPU)
    assert rec.registered.all(), rec.log
    assert rec.has_point.sum() > 0.8 * t.n_tracks
    assert rec.reprojection_rms(t, device=CPU) < gate
    if noise == 0:
        sel = rec.has_point
        assert _similarity_rms(rec.points[sel], scene.points3d[sel]) < 0.01


def test_port_meets_dropped_observation_gate():
    scene = tscene(n_views=8, n_points=200, seed=9)
    t = _tracks_from_scene(scene, noise=0.3, drop=0.2)
    rec = tpipe.reconstruct_incremental(t, scene.intr, seed=0, device=CPU)
    assert rec.registered.sum() >= 7
    assert rec.reprojection_rms(t, device=CPU) < 1.4


def test_sparse_threshold_raises(monkeypatch):
    """Above SPARSE_BA_OBS_THRESHOLD the port raises instead of running
    another solver; with intrinsics refinement the JAX package keeps the
    dense solver too."""
    scene = tscene(n_views=6, n_points=150, seed=4)
    t = _tracks_from_scene(scene, noise=0.5)
    monkeypatch.setattr(tpipe, "SPARSE_BA_OBS_THRESHOLD", 100)
    with pytest.raises(NotImplementedError, match="ba/sparse.py"):
        tpipe.reconstruct_incremental(t, scene.intr, seed=0, device=CPU)


def test_sfm_scene_and_tracing(tmp_path):
    """entry.sfm_scene: the JAX generator's scene (pixels within 1e-3, the
    same markers), and the default under the sparse threshold; the spans of
    a run are recorded on the host and in a profiler trace."""
    t, intr = entry.sfm_scene(16, 256)
    ref = jscene(n_views=16, n_points=256, seed=4, noise_px=0.5, distortion=True)
    np.testing.assert_array_equal(t.mask, ref.visible)
    np.testing.assert_allclose(t.obs, ref.points2d, atol=1e-3)
    np.testing.assert_array_equal(intr, ref.intr)
    assert isinstance(t, ttrk.TracksTensor)

    scene = tscene(n_views=6, n_points=150, seed=4)
    t6 = _tracks_from_scene(scene, noise=0.5)
    tracing.reset_spans()
    with tracing.profile_to(str(tmp_path)) as prof:
        tpipe.reconstruct_incremental(t6, scene.intr, seed=0, device=CPU)
    stats = tracing.span_stats()
    assert {"sfm.init_two_view", "sfm.intersect", "sfm.resect", "sfm.bundle", "sfm.final_bundle"} <= set(stats)
    assert stats["sfm.intersect"]["count"] >= 2 and stats["sfm.init_two_view"]["total_s"] > 0
    keys = {e.key for e in prof.key_averages()}
    assert {"sfm.init_two_view", "sfm.resect", "sfm.final_bundle"} <= keys
    assert (tmp_path / "trace.json").stat().st_size > 0
