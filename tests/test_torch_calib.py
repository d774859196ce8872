"""Parity of the port's calibration and registration modules
(opencv_contrib_tpu_torch.reg, .rapid, .aruco, .ccalib, and core.se3's
axis_angle_to_quat / rotation_angle / rotation_distance / log_se3) with the JAX
package on the CPU. The inputs are the JAX tests' fixtures
(tests/test_imgproc_modules.py, test_breadth3.py, test_breadth6.py,
test_breadth8.py, test_detect_breadth.py, test_aruco.py) and second seeded
inputs, the same numpy arrays through both packages.

Tolerances:
- se3: 1e-6; log_se3 1e-5 of the twin outside the small-angle band, and
  within it (1e-4 to 1e-3 rad, where the twin is NaN or inexact) 1e-5
  relative of a float64 log_se3; reg's warps 1e-5 and its parameters within 1e-4 (each
  level's 20 Gauss-Newton steps through jacfwd of the bilinear warp, the
  two packages' sums rounding apart); RAPID's control points, line bundles
  and correspondences 1e-5, its tracked pose 1e-4;
- ArUco: dictionaries, markers, boards, detected ids and corners equal;
  ChArUco corners within 1e-3 px (a host DLT on CPU tensors against the
  twin's); marker poses within 1e-4;
- omnidir: projections 1e-3 px and rays 1e-6; the undistorted image 1e-5;
  calibrate_xi 1e-5; calibrate_omni compared by its reprojected pixels
  (0.01 px) and rms (1e-4 relative), not by f and xi apart: with xi free
  their split is weakly determined (omnidir.py:112-115); with fix_xi K
  within 1e-3 relative too;
- the random pattern on the JAX package's RANSAC draws, recorded by a spy
  on its `sample_indices` and replayed into the port (as
  tests/test_torch_sfm.py's Draws): inlier count, object and image points
  equal."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu import aruco as jar
from opencv_contrib_tpu import ccalib as jcc
from opencv_contrib_tpu import rapid as jrap
from opencv_contrib_tpu import reg as jreg
from opencv_contrib_tpu.aruco import charuco as jch
from opencv_contrib_tpu.ccalib import omnidir as jom
from opencv_contrib_tpu.ccalib import random_pattern as jrp
from opencv_contrib_tpu.core import se3 as jse3
from opencv_contrib_tpu.mvg import robust as jrob
from opencv_contrib_tpu.ops import filters as jf
from opencv_contrib_tpu.ops.image import warp_affine as jwarp
from opencv_contrib_tpu.rapid import tracker as jtr
from opencv_contrib_tpu_torch import aruco as tar
from opencv_contrib_tpu_torch import ccalib as tcc
from opencv_contrib_tpu_torch import rapid as trap
from opencv_contrib_tpu_torch import reg as treg
from opencv_contrib_tpu_torch.aruco import charuco as tch
from opencv_contrib_tpu_torch.ccalib import omnidir as tom
from opencv_contrib_tpu_torch.ccalib import random_pattern as trp
from opencv_contrib_tpu_torch.core import se3 as tse3
from opencv_contrib_tpu_torch.mvg import robust as trob
from opencv_contrib_tpu_torch.rapid import tracker as ttr

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --- se3 --------------------------------------------------------------------------


def test_se3_rotation_helpers(rng):
    w = rng.normal(0, 1.0, (40, 3)).astype(np.float32)
    w[:3] = [[0, 0, 0], [1e-9, 0, 0], [np.pi, 0, 0]]
    np.testing.assert_allclose(N(tse3.axis_angle_to_quat(T(w))), np.asarray(jse3.axis_angle_to_quat(jnp.asarray(w))),
                               atol=1e-6)
    R1 = np.asarray(jse3.exp_so3(jnp.asarray(w)))
    R2 = np.asarray(jse3.exp_so3(jnp.asarray(rng.normal(0, 1.0, (40, 3)).astype(np.float32))))
    np.testing.assert_allclose(N(tse3.rotation_angle(T(R1))), np.asarray(jse3.rotation_angle(jnp.asarray(R1))),
                               atol=1e-6)
    np.testing.assert_allclose(N(tse3.rotation_distance(T(R1), T(R2))),
                               np.asarray(jse3.rotation_distance(jnp.asarray(R1), jnp.asarray(R2))), atol=1e-6)



def _twists(theta):
    """Twists of rotation angle theta (about a fixed axis) and a 0.37 m
    translation, float32."""
    axis = np.array([0.6, -0.8, 0.0])
    return np.concatenate([theta * axis, [0.1, -0.2, 0.3]])[None].astype(np.float32)


@pytest.mark.parametrize("theta", [1e-4, 1.5e-4, 2e-4, 2.4e-4, 5e-4, 9e-4])
def test_log_se3_small_angles_against_float64(theta):
    """Below theta^2 = 1e-6 log_se3 takes the Taylor branch of its V^-1
    coefficient: finite and within 1e-5 of a float64 log_se3 of the same
    transform (from 1e-4 to ~2.4e-4 rad the closed form divides by a B that
    float32 rounds to 0, and the twin returns NaN there)."""
    Tm = tse3.exp_se3(T(_twists(theta)))
    got, ref = N(tse3.log_se3(Tm)), N(tse3.log_se3(Tm.double()))
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("theta", [0.0, 1e-5, 9e-5, 1e-3, 1e-2, 0.5, 2.0])
def test_log_se3_outside_the_band_is_the_twins(theta):
    Tm = np.asarray(jse3.exp_se3(jnp.asarray(_twists(theta))))
    np.testing.assert_allclose(N(tse3.log_se3(T(Tm))), np.asarray(jse3.log_se3(jnp.asarray(Tm))), atol=1e-5)

# --- reg --------------------------------------------------------------------------


def _textured(rng, shape=(96, 96), sigma=2.0):
    """tests/test_imgproc_modules.py::TestReg._textured."""
    return np.asarray(jf.gaussian_blur(jnp.asarray(rng.uniform(size=shape).astype(np.float32)), sigma)) * 3


PARAMS = {"shift": [-1.5, 2.25], "euclidean": [0.04, 1.0, -2.0], "similarity": [0.02, -0.03, 0.5, 1.5],
          "affine": [0.01, -0.02, 1.0, 0.015, -0.01, -0.5],
          "projective": [0.01, -0.02, 1.0, 0.015, -0.01, -0.5, 2e-4, -1e-4]}


@pytest.mark.parametrize("model", list(PARAMS))
def test_warp_with_params(model, rng):
    img = _textured(rng)
    p = np.float32(PARAMS[model])
    np.testing.assert_allclose(N(treg.warp_with_params(model, T(p), T(img))),
                               np.asarray(jreg.warp_with_params(model, jnp.asarray(p), jnp.asarray(img))), atol=1e-5)


def _reg_fixture(model, rng):
    """The JAX tests' motions (shift, rotation about the 96 x 96 texture's
    centre, affine), a similarity about the centre and a second affine
    motion for the projective model, all of the same size."""
    ref = _textured(rng)
    c = 48.0
    if model == "shift":
        M = [[1.0, 0.0, 2.0], [0.0, 1.0, 3.0]]
    elif model in ("euclidean", "similarity"):
        a, s, (tx, ty) = (0.05, 1.0, (1.0, -1.5)) if model == "euclidean" else (0.03, 1.02, (1.5, -1.0))
        ca, sa = s * np.cos(a), s * np.sin(a)
        M = [[ca, -sa, c - ca * c + sa * c + tx], [sa, ca, c - sa * c - ca * c + ty]]
    else:
        M = [[1.03, 0.02, -2.0], [-0.01, 0.97, 1.0]]
    mov = np.asarray(jwarp(jnp.asarray(ref), jnp.array(M, jnp.float32)))
    if model == "projective":  # another affine motion of the same size: the projective model fits it
        mov = np.asarray(jwarp(jnp.asarray(ref), jnp.array([[1.02, 0.01, -1.0], [-0.01, 0.98, 0.5]], jnp.float32)))
    return ref, mov


@pytest.mark.parametrize("model,levels", [("shift", 2), ("euclidean", 3), ("similarity", 2), ("affine", 3),
                                          ("projective", 2)])
def test_register_pyramid(model, levels, rng):
    """The JAX tests' levels (shift 2, euclidean and affine 3); 2 for the
    others (each level is a compile of the JAX package's level)."""
    ref, mov = _reg_fixture(model, rng)
    pj = np.asarray(jreg.register_pyramid(ref, mov, model=model, levels=levels))
    pt = treg.register_pyramid(ref, mov, model=model, levels=levels)
    np.testing.assert_allclose(N(pt), pj, atol=1e-4)
    out = N(treg.warp_with_params(model, pt, T(mov)))
    assert np.abs(out[10:-10, 10:-10] - ref[10:-10, 10:-10]).mean() < 0.03


def test_register_pyramid_robust_auto_levels(rng):
    """tests/test_breadth8.py::TestRegRobust: the occluder and levels=None."""
    base = np.asarray(jf.gaussian_blur(jnp.asarray(rng.uniform(0, 1, (64, 64)).astype(np.float32)), 1.5))
    mov = np.roll(base, (3, -2), (0, 1))
    ref = base.copy()
    ref[40:56, 40:56] = 1.0
    pj = np.asarray(jreg.register_pyramid(jnp.asarray(ref), jnp.asarray(mov), model="shift", levels=None))
    pt = N(treg.register_pyramid(T(ref), T(mov), model="shift", levels=None))
    np.testing.assert_allclose(pt, pj, atol=1e-4)
    assert abs(pt[0] - 3) < 0.5 and abs(pt[1] + 2) < 0.5


# --- RAPID ------------------------------------------------------------------------


def _rapid_fixture():
    """tests/test_detect_breadth.py::TestRapid."""
    from tests.test_detect_breadth import _render_wire_cube, cube_vertices

    K = np.array([[120.0, 0, 80], [0, 120.0, 60], [0, 0, 1]], np.float32)
    img = _render_wire_cube(K, np.eye(3, dtype=np.float32), np.array([0.0, 0.0, 3.0], np.float32))
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 0]])
    t0 = np.array([0.05, -0.04, 3.1], np.float32)
    return img, K, t0, cube_vertices(), edges


def test_rapid_stages():
    img, K, t0, verts, edges = _rapid_fixture()
    pj, dj = jtr.extract_control_points(jnp.asarray(verts), jnp.asarray(edges), 8)
    pt, dt = ttr.extract_control_points(T(verts), edges, 8)
    np.testing.assert_allclose(N(pt), np.asarray(pj), atol=1e-6)
    np.testing.assert_allclose(N(dt), np.asarray(dj), atol=1e-6)
    nj, uvj = jtr._image_normals(jnp.asarray(K), jnp.eye(3), jnp.asarray(t0), pj, dj)
    nt, uvt = ttr._image_normals(T(K), torch.eye(3), T(t0), pt, dt)
    np.testing.assert_allclose(N(nt), np.asarray(nj), atol=1e-5)
    np.testing.assert_allclose(N(uvt), np.asarray(uvj), atol=1e-4)
    bj, posj = jtr.extract_line_bundle(jnp.asarray(img), uvj, nj, 10.0)
    bt, post = ttr.extract_line_bundle(T(img), T(np.asarray(uvj)), T(np.asarray(nj)), 10.0)
    np.testing.assert_allclose(N(post), np.asarray(posj), atol=1e-4)
    np.testing.assert_allclose(N(bt), np.asarray(bj), atol=1e-5)
    tj, sj = jtr.find_correspondencies(bj, posj)
    tt, st = ttr.find_correspondencies(T(np.asarray(bj)), T(np.asarray(posj)))
    np.testing.assert_allclose(N(tt), np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(N(st), np.asarray(sj), atol=1e-6)
    Rj, tj2, uj = jtr.rapid_step(jnp.asarray(img), jnp.asarray(K), jnp.eye(3), jnp.asarray(t0), pj, dj, 10.0)
    Rt, tt2, ut = ttr.rapid_step(T(img), T(K), torch.eye(3), T(t0), pt, dt, 10.0)
    np.testing.assert_allclose(N(tt2), np.asarray(tj2), atol=1e-4)
    np.testing.assert_allclose(N(Rt), np.asarray(Rj), atol=1e-4)
    assert float(ut) == float(uj)


def test_rapid_track():
    img, K, t0, verts, edges = _rapid_fixture()
    Rj, tj, uj = jrap.track(jnp.asarray(img), jnp.asarray(K), jnp.eye(3), jnp.asarray(t0), verts, edges,
                            n_iters=5, search_len=10.0)
    Rt, tt, ut = trap.track(T(img), T(K), torch.eye(3), T(t0), verts, edges, n_iters=5, search_len=10.0)
    np.testing.assert_allclose(N(tt), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(N(Rt), np.asarray(Rj), atol=1e-4)
    assert float(ut) == float(uj) > 0.5
    t_true = np.array([0.0, 0.0, 3.0], np.float32)
    assert np.linalg.norm(N(tt) - t_true) < 0.6 * np.linalg.norm(t0 - t_true)


# --- ArUco / ChArUco --------------------------------------------------------------


@pytest.fixture(scope="module")
def dico():
    return jar.generate_dictionary(n_markers=8, bits=4, min_dist=4)


def test_dictionary_and_marker(dico):
    np.testing.assert_array_equal(tar.generate_dictionary(n_markers=8, bits=4, min_dist=4), dico)
    np.testing.assert_array_equal(tar.generate_dictionary(n_markers=4, bits=4, seed=3),
                                  jar.generate_dictionary(n_markers=4, bits=4, seed=3))
    for mid, size in ((3, 64), (5, 60), (0, 50)):
        np.testing.assert_array_equal(tar.draw_marker(dico, mid, size), jar.draw_marker(dico, mid, size))


def _marker_scenes(dico, rng):
    """tests/test_aruco.py's scenes: axis-aligned, two markers, rotated,
    noise (at 120 x 160: the host labelling of its many components takes
    seconds at 240 x 320); and a blurred, rotated marker."""
    def scene(mid, y0, x0, size=64, bg=0.8):
        img = np.full((240, 320), bg, np.float32)
        m = jar.draw_marker(dico, mid, size)
        img[y0:y0 + m.shape[0], x0:x0 + m.shape[1]] = m
        return img

    two = scene(1, 30, 40)
    two[140:200, 200:260] = jar.draw_marker(dico, 5, 60)
    tilted = np.asarray(jwarp(jnp.asarray(scene(6, 80, 120, 72)),
                              jnp.array([[0.97, -0.2, 30.0], [0.2, 0.97, -20.0]], jnp.float32)))
    return [scene(3, 50, 80), two, np.rot90(scene(2, 60, 100)).copy(),
            rng.uniform(0.3, 0.9, size=(120, 160)).astype(np.float32),
            np.asarray(jf.gaussian_blur(jnp.asarray(tilted), 0.8))]


def test_detect_markers(dico, rng):
    for img in _marker_scenes(dico, rng):
        ij, cj = jar.detect_markers(img, dico)
        it, ct = tar.detect_markers(T(img), dico)
        assert it == ij
        for a, b in zip(cj, ct):
            np.testing.assert_array_equal(b, a)


def test_charuco_board_corners_and_poses():
    d = jar.generate_dictionary(n_markers=12, bits=4)
    board, ids, centers = jch.draw_charuco_board(d, squares=(5, 5), square_px=40)
    tb, tids, tcent = tch.draw_charuco_board(d, squares=(5, 5), square_px=40)
    np.testing.assert_array_equal(tb, board)
    assert tids == ids
    np.testing.assert_array_equal(tcent, centers)
    ij, cj = jar.detect_markers(board, d)
    it, ct = tar.detect_markers(T(board), d)
    assert it == ij and len(it) >= 6
    idj, kj = jch.interpolate_charuco_corners(ij, cj, ids, centers, squares=(5, 5), square_px=40)
    idt, kt = tch.interpolate_charuco_corners(it, ct, ids, centers, squares=(5, 5), square_px=40)
    assert idt == idj and len(idt) == 16
    np.testing.assert_allclose(kt, kj, atol=1e-3)
    assert np.abs(kt - np.round(kt / 40) * 40).max() < 3.0
    K = np.array([[200.0, 0, 100], [0, 200.0, 100], [0, 0, 1]], np.float32)
    for a, b in zip(jch.estimate_pose_single_markers(cj, 0.05, K), tch.estimate_pose_single_markers(ct, 0.05, K)):
        np.testing.assert_allclose(b[0], a[0], atol=1e-4)
        np.testing.assert_allclose(b[1], a[1], atol=1e-4)


def test_estimate_pose_single_markers():
    """tests/test_breadth6.py::TestCharuco::test_pose_estimation, K as
    numpy and as a tensor."""
    K = np.array([[200.0, 0, 64], [0, 200.0, 64], [0, 0, 1]], np.float32)
    R_true = np.asarray(jse3.exp_so3(jnp.asarray([0.1, -0.2, 0.05])))
    t_true = np.array([0.05, -0.02, 1.5], np.float32)
    half = 0.1
    obj = np.array([[-half, -half, 0], [half, -half, 0], [half, half, 0], [-half, half, 0]], np.float32)
    pc = obj @ R_true.T + t_true
    quad = (pc[:, :2] / pc[:, 2:] * 200.0 + 64.0)[:, ::-1]
    (Rj, tj), = jch.estimate_pose_single_markers([quad], 2 * half, K)
    for Kx in (K, T(K)):
        (Rt, tt), = tch.estimate_pose_single_markers([quad], 2 * half, Kx)
        np.testing.assert_allclose(Rt, Rj, atol=1e-4)
        np.testing.assert_allclose(tt, tj, atol=1e-4)
    assert float(tse3.rotation_distance(T(Rt), T(R_true))) < 0.05 and np.linalg.norm(tt - t_true) < 0.02


# --- omnidir ----------------------------------------------------------------------

K_OMNI = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("dist", [None, (0.05, -0.01, 1e-3, -1e-3)])
def test_project_and_undistort_points(dist, rng):
    X = rng.uniform(-1, 1, (50, 3)).astype(np.float32) + np.array([0, 0, 3], np.float32)
    R = np.asarray(jse3.exp_so3(jnp.asarray([0.1, -0.05, 0.2])))
    t = np.float32([0.1, -0.2, 0.3])
    pj = np.asarray(jcc.project_points_omni(jnp.asarray(X), jnp.asarray(R), jnp.asarray(t), jnp.asarray(K_OMNI),
                                            0.8, dist))
    pt = N(tcc.project_points_omni(T(X), T(R), T(t), T(K_OMNI), 0.8, dist))
    np.testing.assert_allclose(pt, pj, atol=1e-3)
    rj = np.asarray(jcc.undistort_points_omni(jnp.asarray(pj), jnp.asarray(K_OMNI), 0.8, dist))
    rt = N(tcc.undistort_points_omni(T(pj), T(K_OMNI), 0.8, dist))
    np.testing.assert_allclose(rt, rj, atol=1e-6)


def test_init_pose_of_a_planar_board(rng):
    """omnidir._init_pose: the true pose of a planar board from its
    noise-free normalized points (the homography's start), and of a
    non-planar cloud (the resection's); the polar rotation against the
    SVD's."""
    objs, _, poses = _omni_views(rng)
    cloud = objs[0] + np.stack([np.zeros(48), np.zeros(48), rng.uniform(-0.1, 0.1, 48)], 1).astype(np.float32)
    for obj, planar in ((objs[0], True), (cloud, False)):
        for R, t in poses[:3]:
            Xc = obj @ R.T + t
            R0, t0 = tom._init_pose(T(obj), T(Xc[:, :2] / Xc[:, 2:]), planar)
            np.testing.assert_allclose(N(R0), R, atol=1e-4)
            np.testing.assert_allclose(N(t0), t, atol=1e-4)
    M = rng.normal(size=(3, 3)).astype(np.float32) * 0.1 + np.eye(3, dtype=np.float32)
    U, _, Vt = np.linalg.svd(M.astype(np.float64))
    np.testing.assert_allclose(N(tom._polar_rotation(T(M))), U @ Vt, atol=1e-5)


def test_undistort_image_and_calibrate_xi(rng):
    img = rng.uniform(size=(240, 320)).astype(np.float32)
    np.testing.assert_allclose(N(tcc.undistort_image_omni(T(img), T(K_OMNI), xi=0.7)),
                               np.asarray(jcc.undistort_image_omni(jnp.asarray(img), jnp.asarray(K_OMNI), xi=0.7)),
                               atol=1e-5)
    X = rng.uniform(-1, 1, (80, 3)).astype(np.float32) + np.array([0, 0, 4], np.float32)
    px = np.asarray(jcc.project_points_omni(jnp.asarray(X), jnp.eye(3), jnp.zeros(3), jnp.asarray(K_OMNI), 0.75))
    for xi0 in (0.5, 1.0):
        xj = float(jcc.calibrate_xi(X, px, jnp.asarray(K_OMNI), jnp.eye(3), jnp.zeros(3), xi0=xi0))
        xt = float(tcc.calibrate_xi(T(X), T(px), T(K_OMNI), torch.eye(3), torch.zeros(3), xi0=xi0))
        assert abs(xt - xj) <= 1e-5 and abs(xt - 0.75) < 0.01


def _omni_views(rng):
    """tests/test_breadth8.py::TestOmniCalibrate's six board views."""
    gy, gx = np.meshgrid(np.arange(6), np.arange(8), indexing="ij")
    board = np.stack([gx.ravel() * 0.08, gy.ravel() * 0.08, np.zeros(48)], 1).astype(np.float32)
    board -= board.mean(0)
    objs, imgs, poses = [], [], []
    for _ in range(6):
        w = 0.3 * rng.standard_normal(3).astype(np.float32)
        R = np.asarray(jse3.exp_so3(jnp.asarray(w)))
        t = np.array([0.02, -0.01, 0.0], np.float32) + 0.08 * rng.standard_normal(3).astype(np.float32)
        t[2] = abs(t[2]) + 0.3
        px = np.asarray(jom.project_points_omni(jnp.asarray(board), jnp.asarray(R), jnp.asarray(t),
                                                jnp.asarray(K_OMNI), 0.9))
        objs.append(board)
        imgs.append(px + 0.1 * rng.standard_normal(px.shape).astype(np.float32))
        poses.append((R, t))
    return objs, imgs, poses


def _reprojected(res, objs):
    K, xi, Rs, ts, _ = res
    return np.stack([np.asarray(jom.project_points_omni(jnp.asarray(o), jnp.asarray(R), jnp.asarray(t),
                                                        jnp.asarray(K), xi)) for o, R, t in zip(objs, Rs, ts)])


@contextlib.contextmanager
def _true_starts(poses):
    """calibrate_omni's per-view starting poses replaced by the true poses
    in both packages (the twin's `mvg.resection.resect`, the port's
    `omnidir._init_pose`): on a planar board the twin's DLT null space has
    four dimensions, so its start depends on the SVD routine (ROADMAP Queue
    3), and the port starts from the board homography instead. This holds
    the LM itself to the twin's."""
    from opencv_contrib_tpu.mvg import resection as jres

    left = {"jax": list(poses), "torch": list(poses)}

    def jax_start(X, xn, mask=None, refine_iters=10):
        R, t = left["jax"].pop(0)
        return jnp.asarray(R), jnp.asarray(t), None

    def torch_start(obj, xn, planar):
        R, t = left["torch"].pop(0)
        return T(R).to(obj.device), T(t).to(obj.device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jres, "resect", jax_start)
        mp.setattr(tom, "_init_pose", torch_start)
        yield
    assert not left["jax"] and not left["torch"]


@pytest.mark.parametrize("fix_xi", [False, True])
def test_calibrate_omni(fix_xi, rng):
    """From K0 = the true K (one focal candidate) and the true poses for 20
    LM steps: the JAX package's jitted LM takes ~40 s on the CPU over the 4
    candidates at 60 steps (entry.geometry_x runs those on the card)."""
    objs, imgs, poses = _omni_views(rng)
    kw = dict(K0=K_OMNI, outer_iters=20, xi0=0.9 if fix_xi else 0.8, fix_xi=fix_xi)
    with _true_starts(poses):
        rj = jom.calibrate_omni(objs, imgs, (240, 320), **kw)
        rt = tom.calibrate_omni(objs, imgs, (240, 320), **kw)
    assert isinstance(rt[0], np.ndarray) and rt[0].dtype == np.float32 and isinstance(rt[1], float)
    assert len(rt[2]) == len(rt[3]) == 6 and isinstance(rt[4], float)
    assert np.abs(_reprojected(rt, objs) - _reprojected(rj, objs)).max() <= 0.01
    assert abs(rt[4] - rj[4]) <= 1e-4 * rj[4] and rt[4] < 0.3
    if fix_xi:
        np.testing.assert_allclose(rt[0], rj[0], rtol=1e-3)
        assert rt[1] == rj[1]


# --- random pattern ---------------------------------------------------------------


class Draws:
    """The JAX package's RANSAC draws in call order, each with the mask it
    drew under, replayed into the port in the same order."""

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
            np.testing.assert_array_equal(N(mask), jmask)
            return torch.from_numpy(idx.astype(np.int64)).to(mask.device)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(trob, "sample_indices", replayed)
            yield
        assert next(calls, None) is None, "the port drew fewer times than the JAX package"


def test_generate_pattern():
    for shape, seed in (((96, 128), 7), ((40, 50), 3)):
        np.testing.assert_allclose(trp.generate_pattern(shape, seed), np.asarray(jrp.generate_pattern(shape, seed)),
                                   atol=1e-6)


def test_find_correspondences_on_replayed_draws():
    """tests/test_breadth8.py::TestRandomPattern::test_shifted_view."""
    pat = np.asarray(jrp.generate_pattern((96, 128)))
    img = np.roll(pat, (4, 7), (0, 1))
    draws = Draws()
    with draws.record():
        oj, ij, nj = jrp.find_correspondences(pat, img)
    with draws.replay():
        ot, it, nt = trp.find_correspondences(pat, T(img))
    assert nt == nj >= 15
    np.testing.assert_array_equal(ot, oj)
    np.testing.assert_array_equal(it, ij)
    dx = it[:, 0] - ot[:, 0] / (0.20 / 128)
    dy = it[:, 1] - ot[:, 1] / (0.16 / 96)
    assert abs(np.median(dx) - 7) < 1.0 and abs(np.median(dy) - 4) < 1.0
