"""Parity of the port's RGB-D modules (opencv_contrib_tpu_torch.rgbd: odometry,
colored_tsdf, depth_utils, normals) with the JAX package on the CPU, at
tests/test_rgbd.py's size: 120x160 depth frames of the synthetic orbit
rendered by the JAX `sdf_scene` and fed to both packages, 64^3 volumes;
colors and textures come from numpy seeds.

Tolerances:
- odometry: `_photometric_system` and `_icp_system` from one pose: A and b
  within 1e-4 of their largest entry; `compute` ("rgbd", "icp", "merged")
  on tests/test_rgbd.py:184-210's two inputs: T within 1e-4, the same ok.
- colored_tsdf: integrate (two frames) and raycast_colored: colors within
  1e-5, TSDF within 1e-5, the same weights and valid pixels.
- depth_utils: register_depth equal except max(2, 1e-4) of the pixels;
  extract_planes on the JAX package's draws (replayed into the port's
  `_sample_hypotheses`): the plane within 1e-4, the masks equal except
  max(2, 1e-4) of the pixels; clean_depth within 1e-5 (its box sums take
  the plain summed-area table, XLA's cumsum order, on the CPU).
- normals: LINEMOD and SRI within 1e-4 on the valid pixels. FALS solves a
  3x3 system a pixel whose condition number kappa is 3e3 to 3e4 at every
  pixel here, so no pixel is conditioned well enough for two float32 LU
  routines to agree to 1e-4 (they part by about eps * kappa, eps = 2^-24):
  within 1e-4 + 2 eps kappa of the JAX package's, and within
  1e-4 + eps kappa of the float64 solution of the same system, on every
  valid pixel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu.core import se3 as jse3
from opencv_contrib_tpu.ops import filters as jfilters
from opencv_contrib_tpu.rgbd import colored_tsdf as jct
from opencv_contrib_tpu.rgbd import depth_utils as jdu
from opencv_contrib_tpu.rgbd import frame as jframe
from opencv_contrib_tpu.rgbd import normals as jnormals
from opencv_contrib_tpu.rgbd import odometry as jodo
from opencv_contrib_tpu.utils import sdf_scene as jscene
from opencv_contrib_tpu_torch import entry, interop
from opencv_contrib_tpu_torch.ops import filters as tfilters
from opencv_contrib_tpu_torch.rgbd import colored_tsdf as tct
from opencv_contrib_tpu_torch.rgbd import depth_utils as tdu
from opencv_contrib_tpu_torch.rgbd import frame as tframe
from opencv_contrib_tpu_torch.rgbd import normals as tnormals
from opencv_contrib_tpu_torch.rgbd import odometry as todo

torch.set_num_threads(1)

INTR = np.array([120.0, 120.0, 80.0, 60.0, 0, 0, 0, 0, 0], np.float32)  # tests/test_rgbd.py:15
SHAPE = (120, 160)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def J(a):
    return jnp.asarray(np.asarray(a))


@pytest.fixture(scope="module")
def orbit():
    poses = jscene.orbit_poses(8, sweep=0.5)
    return poses, [np.asarray(jscene.render_depth(J(p), J(INTR), shape=SHAPE)) for p in poses[:2]]


def _gray_of(d, T_wc):
    """tests/test_rgbd.py:199-203's texture through the depth points."""
    pts = jframe.depth_to_points(J(d), J(INTR))
    R, t = jse3.mat_to_rt(J(T_wc))
    pw = jnp.einsum("ij,hwj->hwi", R, pts) + t
    return np.asarray(jnp.sin(4.0 * pw[..., 0]) * jnp.cos(4.0 * pw[..., 1]) * (J(d) > 0))


@pytest.fixture(scope="module")
def odo_inputs(orbit):
    """tests/test_rgbd.py's two inputs, (gray_src, depth_src, gray_dst,
    depth_dst): src = frame 1, dst = frame 0."""
    poses, (d0, d1) = orbit
    return {"depth_gray": (d1 * 50.0 * 0, d1, d0 * 50.0 * 0, d0),
            "textured": (_gray_of(d1, poses[1]), d1, _gray_of(d0, poses[0]), d0)}


def _close_to_max(xt, xj, rel=1e-4):
    np.testing.assert_allclose(N(xt), np.asarray(xj), atol=rel * float(np.abs(np.asarray(xj)).max()))


# --- odometry -----------------------------------------------------------------


@pytest.mark.parametrize("level", [0, 1])
def test_linear_systems_match_jax(odo_inputs, level):
    gs, ds, gd, dd = odo_inputs["textured"]
    from opencv_contrib_tpu.core import pyramid as jpyr
    from opencv_contrib_tpu_torch.core import pyramid as tpyr

    it = np.asarray(INTR) * np.array([0.5 ** level] * 4 + [1] * 5, np.float32)
    Tm = np.asarray(jse3.exp_se3(J(np.array([0.01, -0.005, 0.0, 0.01, 0.0, -0.005], np.float32))))
    jsrc = jframe.make_frame(J(ds), J(INTR), use_bilateral=False)[level]
    jdst = jframe.make_frame(J(dd), J(INTR), use_bilateral=False)[level]
    tsrc = tframe.make_frame(T(ds), T(INTR), use_bilateral=False)[level]
    tdst = tframe.make_frame(T(dd), T(INTR), use_bilateral=False)[level]
    jgs, jgd = jpyr.build_pyramid(J(gs), 3)[level], jpyr.build_pyramid(J(gd), 3)[level]
    tgs, tgd = tpyr.build_pyramid(T(gs), 3)[level], tpyr.build_pyramid(T(gd), 3)[level]
    jgy, jgx = jfilters.gradients(jgd)
    tgy, tgx = tfilters.gradients(tgd)
    Aj, bj, nj, ej = jodo._photometric_system(J(Tm), jgs, jsrc, jgd, jgx, jgy, jdst, J(it))
    At, bt, nt, et = todo._photometric_system(T(Tm), tgs, tsrc, tgd, tgx, tgy, tdst, T(it))
    assert float(nt) == float(nj) > 500
    _close_to_max(At, Aj)
    _close_to_max(bt, bj)
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-4)
    Aj, bj, nj, _ = jodo._icp_system(J(Tm), jsrc, jdst, J(it))
    At, bt, nt, _ = todo._icp_system(T(Tm), tsrc, tdst, T(it))
    assert float(nt) == float(nj) > 500
    _close_to_max(At, Aj)
    _close_to_max(bt, bj)


@pytest.mark.parametrize("method", ["rgbd", "icp", "merged"])
@pytest.mark.parametrize("inputs", ["depth_gray", "textured"])
def test_compute_matches_jax(odo_inputs, orbit, inputs, method):
    args = odo_inputs[inputs]
    Tj, okj = jodo.compute(*args, INTR, method=method)
    Tt, okt = todo.compute(*args, INTR, method=method, device="cpu")
    assert okt == okj
    np.testing.assert_allclose(N(Tt), np.asarray(Tj), atol=1e-4)
    if method != "rgbd":  # tests/test_rgbd.py's gate (the depth-gray input gives rgbd no texture)
        poses = orbit[0]
        T_gt = np.asarray(jse3.inverse(J(poses[0])) @ J(poses[1]))
        d = np.asarray(jse3.log_se3(J(T_gt) @ jse3.inverse(J(N(Tt)))))
        assert np.linalg.norm(d[:3]) < 0.015 and np.linalg.norm(d[3:]) < 0.03, d


def test_rgbd_odometry_entry(odo_inputs):
    args = odo_inputs["textured"]
    Te, oke = entry.rgbd_odometry(*args, INTR, method="merged", device="cpu")
    Tt, okt = todo.compute(*args, INTR, method="merged", device="cpu")
    assert oke is okt is True
    np.testing.assert_array_equal(N(Te), N(Tt))
    with pytest.raises(ValueError, match="method"):
        todo.compute(*args, INTR, method="dense", device="cpu")


# --- colored TSDF ---------------------------------------------------------------


def test_colored_tsdf_matches_jax(orbit):
    poses, depths = orbit
    rng = np.random.default_rng(5)
    rgbs = [rng.uniform(0, 1, SHAPE + (3,)).astype(np.float32) for _ in depths]
    Tcw = [np.asarray(jse3.inverse(J(p))) for p in poses[:2]]
    vj = jct.create((64, 64, 64), size=3.2)
    vt = tct.create((64, 64, 64), size=3.2)
    for d, c, Tk in zip(depths, rgbs, Tcw):  # the second frame fuses into weighted voxels
        vj = jct.integrate(vj, J(d), J(c), J(INTR), J(Tk))
        vt = tct.integrate(vt, T(d), T(c), T(INTR), T(Tk))
        np.testing.assert_array_equal(N(vt.base.weight), np.asarray(vj.base.weight))
        np.testing.assert_allclose(N(vt.base.tsdf), np.asarray(vj.base.tsdf), atol=1e-5)
        np.testing.assert_allclose(N(vt.color), np.asarray(vj.color), atol=1e-5)
    assert float(vt.base.weight.max()) == 2.0 and float(vt.color.max()) > 0.5
    back = interop.from_numpy(jax.tree_util.tree_map(np.asarray, vj))  # the nested TSDFVolume crosses too
    assert type(back) is tct.ColoredTSDFVolume and type(back.base) is type(vt.base)
    pj, nj, cj, okj = (np.asarray(a) for a in jct.raycast_colored(vj, J(INTR), J(Tcw[1]), shape=SHAPE))
    pt, nt, ct, okt = (N(a) for a in tct.raycast_colored(back, T(INTR), T(Tcw[1]), shape=SHAPE))
    assert okj.mean() > 0.3
    np.testing.assert_array_equal(okt, okj)
    np.testing.assert_allclose(pt, pj, atol=1e-4)
    np.testing.assert_allclose(ct, cj, atol=1e-5)


# --- depth utilities ----------------------------------------------------------


def test_register_depth_matches_jax(orbit):
    d = orbit[1][0]
    intr_rgb = np.array([130.0, 128.0, 78.0, 62.0, 0, 0, 0, 0, 0], np.float32)
    Tm = np.asarray(jse3.exp_se3(J(np.array([0.01, 0.02, -0.01, 0.05, -0.01, 0.02], np.float32))))
    oj = np.asarray(jdu.register_depth(J(d), J(INTR), J(intr_rgb), J(Tm)))
    ot = N(tdu.register_depth(T(d), T(INTR), T(intr_rgb), T(Tm)))
    assert (oj > 0).mean() > 0.3
    assert (ot != oj).sum() <= max(2, 1e-4 * oj.size), (ot != oj).sum()
    big = N(tdu.register_depth(T(d), T(INTR), T(intr_rgb), T(Tm), out_hw=(130, 170)))
    assert big.shape == (130, 170) and (big > 0).sum() >= (ot > 0).sum()


def test_extract_planes_matches_jax(orbit):
    d = orbit[1][0]
    key = jax.random.PRNGKey(3)
    idx = np.asarray(jax.random.randint(key, (64,), 0, d.size))  # the JAX package's draws
    pj, mj = (np.asarray(a) for a in jdu.extract_planes(J(d), J(INTR), key))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdu, "_sample_hypotheses", lambda gen, n, n_pixels, device: torch.from_numpy(idx).long())
        pt, mt = (N(a) for a in tdu.extract_planes(T(d), T(INTR), torch.Generator().manual_seed(3)))
    assert mj.mean() > 0.05
    np.testing.assert_allclose(pt, pj, atol=1e-4)
    assert (mt != mj).sum() <= max(2, 1e-4 * mj.size), (mt != mj).sum()
    # its own draws: a plane of unit normal through the same floor
    po, mo = (N(a) for a in tdu.extract_planes(T(d), T(INTR), torch.Generator().manual_seed(0)))
    assert abs(np.linalg.norm(po[:3]) - 1.0) < 1e-5 and mo.sum() > 0


def test_clean_depth_matches_jax(orbit):
    d = orbit[1][0]
    noisy = np.where(d > 0, np.round(d / 0.01) * 0.01, 0).astype(np.float32)  # a quantisation staircase
    oj = np.asarray(jdu.clean_depth(J(noisy), J(INTR)))  # the JAX version traces `window`: only its default runs
    ot = N(tdu.clean_depth(T(noisy), T(INTR)))
    np.testing.assert_allclose(ot, oj, atol=1e-5)
    out = N(tdu.clean_depth(T(noisy), T(INTR), window=2))
    assert np.isfinite(out).all() and (out[noisy == 0] == 0).all() and (out[noisy > 0] > 0).mean() > 0.99


# --- normals --------------------------------------------------------------------


EPS32 = 2.0 ** -24  # float32 unit roundoff


def _fals_reference(d, valid):
    """Each valid pixel's FALS system solved in float64: (oriented normals,
    2-norm condition numbers)."""
    A, b, pts, _ = (N(a).astype(np.float64) for a in tnormals._fals_system(T(d), T(INTR)))
    A = np.where(valid[..., None, None], A, np.eye(3))
    n = np.linalg.solve(A, b[..., None])[..., 0]
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where((n * pts).sum(-1, keepdims=True) > 0, -n, n)
    return n, np.linalg.cond(A)


@pytest.mark.parametrize("method", ["fals", "linemod", "sri"])
def test_normals_match_jax(orbit, method):
    """FALS: every pixel's 3x3 system (sum p p^T) n = sum p has a condition
    number kappa of 3e3 to 3e4 here, so a float32 LU solve carries about
    eps * kappa (2e-4 to 2e-3): the port's normals are held within
    1e-4 + 2 eps kappa of the JAX package's, and within 1e-4 + eps kappa
    of the float64 solution of the same system, on every valid pixel."""
    d = orbit[1][1]
    nj = np.asarray(jnormals.rgbd_normals(J(d), J(INTR), method=method))
    nt = N(tnormals.rgbd_normals(T(d), T(INTR), method=method))
    vj, vt = np.abs(nj).sum(-1) > 0, np.abs(nt).sum(-1) > 0
    np.testing.assert_array_equal(vt, vj)
    keep = vj & (d > 0)
    assert keep.mean() > 0.3
    if method != "fals":
        np.testing.assert_allclose(nt[keep], nj[keep], atol=1e-4)
        return
    n64, kappa = _fals_reference(d, keep)
    err_j = np.abs(nt - nj).max(-1)[keep]
    err_64 = np.abs(nt - n64).max(-1)[keep]
    k = kappa[keep]
    assert (err_j <= 1e-4 + 2 * EPS32 * k).all(), np.max((err_j - 1e-4) / (EPS32 * k))
    assert (err_64 <= 1e-4 + EPS32 * k).all(), np.max((err_64 - 1e-4) / (EPS32 * k))
