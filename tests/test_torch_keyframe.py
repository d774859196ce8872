"""Parity of the PyTorch port's keyframe tick (opencv_contrib_tpu_torch) with
the JAX package on the CPU: SO(3) and camera helpers, PnP resection, bundle
adjustment, the synthetic scene, the interop carry, and a small keyframe
tick written as bench.py's `bench_keyframes` writes it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu.ba import bundle as jba
from opencv_contrib_tpu.core import camera as jcam
from opencv_contrib_tpu.core import se3 as jse3
from opencv_contrib_tpu.features import describe as jdesc
from opencv_contrib_tpu.features import detect as jdet
from opencv_contrib_tpu.features import match as jmatch
from opencv_contrib_tpu.mvg import resection as jres
from opencv_contrib_tpu.utils import synthetic as jsyn
from opencv_contrib_tpu_torch import entry, interop
from opencv_contrib_tpu_torch.ba import bundle as tba
from opencv_contrib_tpu_torch.core import camera as tcam
from opencv_contrib_tpu_torch.core import se3 as tse3
from opencv_contrib_tpu_torch.mvg import resection as tres
from opencv_contrib_tpu_torch.utils import synthetic as tsyn


# The suite runs several worker processes beside XLA's thread pools; at
# these sizes torch's own per-process OpenMP pool only oversubscribes the CPU.
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _rotations(rng, n):
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w[0] = 0.0
    w[1] = [1e-5, -2e-5, 0.5e-5]  # Taylor branch
    w[2] = [0.0, 0.0, 3.1]  # near pi
    return w


# --- SO(3) and the camera ----------------------------------------------------


def test_hat_vee(rng):
    w = rng.normal(size=(6, 3)).astype(np.float32)
    np.testing.assert_array_equal(N(tse3.hat(T(w))), np.asarray(jse3.hat(jnp.asarray(w))))
    np.testing.assert_array_equal(N(tse3.vee(tse3.hat(T(w)))), w)


def test_exp_log_so3(rng):
    w = _rotations(rng, 16)
    R_j = jax.jit(jse3.exp_so3)(jnp.asarray(w))
    R_t = tse3.exp_so3(T(w))
    np.testing.assert_allclose(N(R_t), np.asarray(R_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(N(tse3.mat_to_quat(R_t)), np.asarray(jax.jit(jse3.mat_to_quat)(R_j)), atol=1e-6)
    np.testing.assert_allclose(N(tse3.log_so3(R_t)), np.asarray(jax.jit(jse3.log_so3)(R_j)), atol=1e-5)
    q = rng.normal(size=(5, 4)).astype(np.float32)
    np.testing.assert_allclose(N(tse3.quat_to_axis_angle(T(q))),
                               np.asarray(jax.jit(jse3.quat_to_axis_angle)(jnp.asarray(q))), atol=1e-6)


def test_rotate_and_project_to_so3(rng):
    R = tse3.exp_so3(T(_rotations(rng, 4)))
    pts = rng.normal(size=(4, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(N(tse3.rotate_points(R, T(pts))),
                               np.asarray(jse3.rotate_points(jnp.asarray(N(R)), jnp.asarray(pts))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(N(tse3.rotate_points(R[0], T(pts[0, 0]))),
                               np.asarray(jse3.rotate_points(jnp.asarray(N(R[0])), jnp.asarray(pts[0, 0]))),
                               rtol=1e-6, atol=1e-6)
    M = rng.normal(size=(5, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(N(tse3.project_to_so3(T(M))),
                               np.asarray(jse3.project_to_so3(jnp.asarray(M))), atol=1e-5)


def test_camera_model(rng):
    intr_j = jcam.make_intrinsics(500.0, 480.0, 320.0, 240.0, -0.1, 0.02, 0.001, 1e-3, -5e-4)
    intr_t = tcam.make_intrinsics(500.0, 480.0, 320.0, 240.0, -0.1, 0.02, 0.001, 1e-3, -5e-4)
    np.testing.assert_array_equal(N(intr_t), np.asarray(intr_j))
    xn = rng.uniform(-0.5, 0.5, size=(30, 2)).astype(np.float32)
    np.testing.assert_allclose(N(tcam.distort(intr_t, T(xn))), np.asarray(jcam.distort(intr_j, jnp.asarray(xn))),
                               rtol=1e-6, atol=1e-6)
    px = N(tcam.denormalize_points(intr_t, T(xn)))
    np.testing.assert_allclose(px, np.asarray(jcam.denormalize_points(intr_j, jnp.asarray(xn))), rtol=1e-6)
    back = N(tcam.normalize_points(intr_t, T(px)))
    np.testing.assert_allclose(back, np.asarray(jcam.normalize_points(intr_j, jnp.asarray(px))), atol=1e-6)
    np.testing.assert_allclose(N(tcam.undistort(intr_t, T(xn), iters=3)),
                               np.asarray(jcam.undistort(intr_j, jnp.asarray(xn), iters=3)), atol=1e-6)
    eye = np.array([1.0, 0.3, -4.0], np.float32)
    tgt = np.array([0.1, -0.1, 0.2], np.float32)
    Rt, tt = tcam.look_at(T(eye), T(tgt))
    Rj, tj = jcam.look_at(jnp.asarray(eye), jnp.asarray(tgt))
    np.testing.assert_allclose(N(Rt), np.asarray(Rj), atol=1e-6)
    np.testing.assert_allclose(N(tt), np.asarray(tj), atol=1e-5)
    X = rng.uniform(-1, 1, size=(20, 3)).astype(np.float32)
    pt, zt = tcam.project(intr_t, Rt, tt, T(X))
    pj, zj = jcam.project(intr_j, Rj, tj, jnp.asarray(X))
    np.testing.assert_allclose(N(pt), np.asarray(pj), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(N(zt), np.asarray(zj), rtol=1e-6, atol=1e-6)


# --- resection ---------------------------------------------------------------


@pytest.fixture(scope="module")
def pnp_case():
    rng = np.random.default_rng(3)
    X = rng.uniform(-1, 1, size=(60, 3)).astype(np.float32) + np.array([0, 0, 5], np.float32)
    w = np.array([0.1, -0.2, 0.05], np.float32)
    R = np.asarray(jse3.exp_so3(jnp.asarray(w)))
    t = np.array([0.2, -0.1, 0.3], np.float32)
    Xc = X @ R.T + t
    xn = (Xc[:, :2] / Xc[:, 2:]).astype(np.float32)
    xn_noisy = xn + rng.normal(scale=2e-3, size=xn.shape).astype(np.float32)
    mask = rng.uniform(size=60) > 0.2
    return X, xn_noisy, mask, R, t


def test_pnp_dlt(pnp_case):
    X, xn, mask, R_true, _ = pnp_case
    Rj, tj = jres.pnp_dlt(jnp.asarray(X), jnp.asarray(xn), jnp.asarray(mask))
    Rt, tt = tres.pnp_dlt(T(X), T(xn), T(mask))
    np.testing.assert_allclose(N(Rt), np.asarray(Rj), atol=2e-3)
    np.testing.assert_allclose(N(tt), np.asarray(tj), atol=2e-2)
    assert np.abs(N(Rt) - R_true).max() < 5e-2


def test_refine_pose_and_residuals(pnp_case):
    X, xn, mask, R_true, t_true = pnp_case
    R0, t0 = jres.pnp_dlt(jnp.asarray(X), jnp.asarray(xn), jnp.asarray(mask))
    Rj, tj, cj = jres.refine_pose(R0, t0, jnp.asarray(X), jnp.asarray(xn), jnp.asarray(mask), iters=5)
    Rt, tt, ct = tres.refine_pose(T(R0), T(t0), T(X), T(xn), T(mask), iters=5)
    np.testing.assert_allclose(N(Rt), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(N(tt), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-3)
    r_j = jres.reprojection_residuals(Rj, tj, jnp.asarray(X), jnp.asarray(xn), jnp.asarray(mask))
    r_t = tres.reprojection_residuals(Rt, tt, T(X), T(xn), T(mask))
    np.testing.assert_allclose(N(r_t), np.asarray(r_j), atol=1e-5)
    assert np.abs(N(Rt) - R_true).max() < 5e-3 and np.abs(N(tt) - t_true).max() < 5e-2
    Rr, tr, cr = tres.resect(T(X), T(xn), T(mask), refine_iters=5)
    np.testing.assert_allclose(N(Rr), N(Rt), atol=1e-6)


# --- bundle adjustment -------------------------------------------------------


def _problem(n_views, n_points, noise=0.02, distortion=False, seed=0, noise_px=0.0):
    scene = jsyn.generate_scene(n_views=n_views, n_points=n_points, seed=seed, distortion=distortion,
                                noise_px=noise_px)
    rng = np.random.default_rng(seed)
    noisy = scene.points3d + rng.normal(scale=noise, size=scene.points3d.shape).astype(np.float32)
    jp = jba.make_problem_from_scene(scene.Rs, scene.ts, noisy, scene.intr, scene.points2d, scene.visible)
    tp = tba.make_problem_from_scene(scene.Rs, scene.ts, noisy, scene.intr, scene.points2d, scene.visible)
    return jp, tp


def test_generate_scene_matches_jax():
    for kw in ({}, {"distortion": True, "noise_px": 0.5, "n_views": 5, "n_points": 40}):
        js = jsyn.generate_scene(**kw)
        ts = tsyn.generate_scene(**kw)
        assert tsyn.SyntheticScene._fields == jsyn.SyntheticScene._fields
        for f in js._fields:
            np.testing.assert_allclose(getattr(ts, f), getattr(js, f), rtol=1e-5, atol=1e-3, err_msg=f)


def test_make_problem_and_cost():
    jp, tp = _problem(4, 64)
    assert tba.BAProblem._fields == jba.BAProblem._fields
    for f in jp._fields:
        np.testing.assert_allclose(N(getattr(tp, f)), np.asarray(getattr(jp, f)), atol=1e-5, err_msg=f)
    args_j = tuple(jp)
    args_t = tuple(tp)
    np.testing.assert_allclose(float(tba.cost(*args_t)), float(jax.jit(jba.cost)(*args_j)), rtol=1e-4)
    np.testing.assert_allclose(float(tba.rms_reprojection_error(*args_t)),
                               float(jax.jit(jba.rms_reprojection_error)(*args_j)), rtol=1e-4)


@pytest.mark.parametrize("distortion", [False, True])
def test_per_observation_jacobians(distortion):
    """The port's analytic Jacobians against jax.jacfwd of the JAX model."""
    jp, tp = _problem(3, 24, distortion=distortion)
    cams = jp.cameras.at[0, :3].set(jnp.array([1e-5, 0.0, 0.0]))  # Taylor branch
    jac = jax.jit(jba._per_obs_jacobians, static_argnums=5)
    rj, Jcj, Jpj, Jij = jac(cams, jp.points, jp.intr, jp.obs, jp.mask, True)
    rt, Jct, Jpt, Jit = tba._per_obs_jacobians(T(cams), tp.points, tp.intr, tp.obs, tp.mask, True)
    for a, b, name in ((rt, rj, "r"), (Jct, Jcj, "Jc"), (Jpt, Jpj, "Jp"), (Jit, Jij, "Ji")):
        b = np.asarray(b)
        np.testing.assert_allclose(N(a), b, rtol=1e-4, atol=1e-4 * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("kw", [{}, {"optimize_intr": True}, {"solver": "pcg", "n_cg": 12}])
def test_bundle_adjust_matches_jax(kw):
    """generate_scene(4, 64) with 0.5 px observation noise, so that the
    optimum's cost is well above float32 rounding (noise-free, 3 iterations
    reach ~5e-8, where a relative comparison means nothing)."""
    jp, tp = _problem(4, 64, noise_px=0.5)
    jr = jba.bundle_adjust(jp, n_iters=3, **kw)
    tr = tba.bundle_adjust(tp, n_iters=3, **kw)
    assert float(tr.final_cost) < float(tr.initial_cost)
    np.testing.assert_allclose(float(tr.initial_cost), float(jr.initial_cost), rtol=1e-4)
    np.testing.assert_allclose(float(tr.final_cost), float(jr.final_cost), rtol=1e-3)
    np.testing.assert_allclose(N(tr.lam_history), np.asarray(jr.lam_history), rtol=1e-5)
    np.testing.assert_allclose(N(tr.points), np.asarray(jr.points), atol=1e-3)


def test_points_only_adjust():
    jp, tp = _problem(4, 64)
    np.testing.assert_allclose(N(tba.points_only_adjust(tp, n_iters=2)),
                               np.asarray(jba.points_only_adjust(jp, n_iters=2)), atol=1e-4)


def test_pcg_rejects_intrinsics():
    _, tp = _problem(3, 16)
    with pytest.raises(ValueError, match="pcg"):
        tba.bundle_adjust(tp, n_iters=1, solver="pcg", optimize_intr=True)


def test_interop_round_trip():
    jp, _ = _problem(3, 16)
    tp = interop.from_numpy(jp)
    assert type(tp) is tba.BAProblem
    back = interop.to_numpy(tp)
    for a, b in zip(back, jp):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(TypeError):
        interop.from_numpy(jsyn.SequenceScene(*([np.zeros(1)] * 7), n_tracks=1))


# --- the keyframe tick -------------------------------------------------------


def _jax_tick(imgs, intr, K, n_ba, ba_views, ba_points):
    """bench.py's bench_keyframes pipeline at a small size, with the BA
    problem drawn as entry.ba_problem draws it."""

    @jax.jit
    def pipeline(imgs):
        def frontend(img):
            k = jdet.fast_hessian(img, max_keypoints=K, threshold=20.0)
            d = jdesc.surf_describe(img, k)
            return d, k.valid, jnp.stack([k.x, k.y], axis=1)

        def lift(xy):
            xn = jcam.normalize_points(intr, xy)
            return jnp.concatenate([xn, jnp.ones((K, 1))], axis=1)

        d0, v0, xy0 = frontend(imgs[0])

        def step(carry, img):
            prev_d, prev_v, prev_xyz = carry
            d, v, xy = frontend(img)
            m = jmatch.ratio_test_match(prev_d, d, prev_v, v, ratio=0.85)
            xn = jcam.normalize_points(intr, xy[m.train_idx])
            ok = m.valid & prev_v
            R0, t0 = jres.pnp_dlt(prev_xyz, xn, mask=ok)
            R, t, _ = jres.refine_pose(R0, t0, prev_xyz, xn, ok, iters=5)
            return (d, v, lift(xy)), (t, jnp.sum(ok))

        _, (ts, n_ok) = jax.lax.scan(step, (d0, v0, lift(xy0)), imgs[1:])
        return ts, n_ok

    ts, n_ok = pipeline(jnp.asarray(imgs))
    jp, _ = _problem(ba_views, ba_points)
    return ts, n_ok, jba.bundle_adjust(jp, n_iters=n_ba)


def test_keyframe_tick_matches_jax():
    """The same matches (`n_ok`) per frame and the same BA costs. The
    resected translations are compared for shape and finiteness only: the
    tick lifts the previous keyframe's points to the plane z = 1, where the
    DLT's z and homogeneous columns coincide, so its null space has more
    than one dimension and the pose it picks depends on the SVD routine (in
    JAX as in the port). BA runs one iteration: the tick's problem has
    exact observations, and a second iteration already reaches float32
    rounding."""
    imgs = entry.make_frames(n_frames=3, H=128, W=160, seed=0)
    intr = np.asarray(jcam.make_intrinsics(500.0, 500.0, 80.0, 64.0))
    ts_j, nok_j, ba_j = _jax_tick(imgs, jnp.asarray(intr), K=64, n_ba=1, ba_views=4, ba_points=64)
    tick = entry.keyframe_tick(imgs, intr, K=64, n_ba=1, ba_views=4, ba_points=64, device="cpu")
    np.testing.assert_array_equal(N(tick.n_ok), np.asarray(nok_j))
    assert (N(tick.n_ok) >= 12).all()
    assert tick.ts.shape == ts_j.shape and torch.isfinite(tick.ts).all()
    np.testing.assert_allclose(float(tick.ba.initial_cost), float(ba_j.initial_cost), rtol=1e-4)
    np.testing.assert_allclose(float(tick.ba.final_cost), float(ba_j.final_cost), rtol=1e-3)
    assert float(tick.ba.final_cost) < 1e-3 * float(tick.ba.initial_cost)


def test_make_frames_is_bench_sequence():
    """The bench.py:76-84 construction: smooth texture, 3 px shift per frame."""
    f = entry.make_frames(n_frames=2, H=24, W=32, seed=0)
    assert f.shape == (3, 24, 32) and f.dtype == np.float32
    assert f.min() == 0.0 and abs(f.max() - 255.0) < 1e-3
    np.testing.assert_array_equal(f[2], np.roll(f[0], 6, axis=1))


def test_keyframe_tick_needs_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.keyframe_tick(np.zeros((2, 32, 32), np.float32), np.ones(9, np.float32))
