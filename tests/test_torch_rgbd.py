"""Parity of the PyTorch port's KinectFusion slice (opencv_contrib_tpu_torch.rgbd)
with the JAX package on the CPU, at tests/test_rgbd.py's size: 120x160 depth
frames of the synthetic orbit, rendered by the JAX `sdf_scene` and fed to
both packages, and 64^3-96^3 volumes. The JAX side runs through its own
functions, which call no Pallas kernel.

Two differences are inherent, and the tolerances below say where they apply:
XLA's CPU `exp` differs from a correctly rounded one in the last bit on about
a tenth of its inputs, so the bilateral filter's output differs by a few ulp
(<= 1.5e-6 m at 2-3 m depth), which the normal map amplifies at grazing
pixels; and a pose that differs by ~1e-7 moves a voxel's projection across a
pixel's rounding boundary now and then, which changes that voxel's depth
sample.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu.core import se3 as jse3
from opencv_contrib_tpu.ops import filters as jfilters
from opencv_contrib_tpu.rgbd import frame as jframe
from opencv_contrib_tpu.rgbd import icp as jicp
from opencv_contrib_tpu.rgbd import kinfu as jkinfu
from opencv_contrib_tpu.rgbd import tsdf as jtsdf
from opencv_contrib_tpu.utils import sdf_scene as jscene
from opencv_contrib_tpu_torch import entry, interop
from opencv_contrib_tpu_torch.core import pyramid as tpyramid
from opencv_contrib_tpu_torch.core import se3 as tse3
from opencv_contrib_tpu_torch.ops import filters as tfilters
from opencv_contrib_tpu_torch.rgbd import frame as tframe
from opencv_contrib_tpu_torch.rgbd import icp as ticp
from opencv_contrib_tpu_torch.rgbd import kinfu as tkinfu
from opencv_contrib_tpu_torch.rgbd import tsdf as ttsdf
from opencv_contrib_tpu_torch.utils import sdf_scene as tscene

# The suite runs several worker processes beside XLA's thread pools; at
# these sizes torch's own per-process OpenMP pool only oversubscribes the CPU.
torch.set_num_threads(1)

INTR = np.array([120.0, 120.0, 80.0, 60.0, 0, 0, 0, 0, 0], np.float32)  # tests/test_rgbd.py:15
SHAPE = (120, 160)
OFFSET = np.array([0.01, -0.005, 0.0, 0.01, 0.0, -0.005], np.float32)  # rad | m


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def poses():
    return jscene.orbit_poses(8, sweep=0.5)


@pytest.fixture(scope="module")
def depths(poses):
    return [np.array(jscene.render_depth(jnp.asarray(p), jnp.asarray(INTR), shape=SHAPE)) for p in poses[:6]]


@pytest.fixture(scope="module")
def frames(depths):
    """(JAX, port) frame pyramids of depth frames 0 and 1."""
    out = []
    for d in depths[:2]:
        jf = jframe.make_frame(jnp.asarray(d), jnp.asarray(INTR))
        out.append((jf, tframe.make_frame(T(d), T(INTR))))
    return out


def _cw(pose):
    return np.asarray(jse3.inverse(jnp.asarray(pose)))


def _pose_diff(Ta, Tb) -> float:
    return float(np.linalg.norm(np.asarray(jse3.log_se3(jse3.inverse(jnp.asarray(Ta)) @ jnp.asarray(Tb)))))


# --- scene, se3, filters, pyramid, frames ------------------------------------


def test_sdf_scene_matches_jax(poses, depths):
    np.testing.assert_allclose(tscene.orbit_poses(8, sweep=0.5), poses, atol=1e-6)
    d = N(tscene.render_depth(T(poses[0]), T(INTR), shape=SHAPE))
    ref = depths[0]
    assert ((d > 0) == (ref > 0)).mean() >= 0.999
    both = (d > 0) & (ref > 0)
    # sphere tracing stops within 1e-3 of the surface; the two step
    # sequences round differently
    np.testing.assert_allclose(d[both], ref[both], atol=2e-3)


def test_se3_matches_jax(rng):
    xi = rng.normal(scale=0.5, size=(7, 6)).astype(np.float32)
    xi[0] = 0.0
    xi[1, :3] = [1e-5, 0.0, -2e-5]  # Taylor branch
    Tj = np.asarray(jse3.exp_se3(jnp.asarray(xi)))
    Tt = tse3.exp_se3(T(xi))
    np.testing.assert_allclose(N(Tt), Tj, atol=1e-6)
    np.testing.assert_allclose(N(tse3.log_se3(T(Tj))), np.asarray(jse3.log_se3(jnp.asarray(Tj))), atol=1e-5)
    np.testing.assert_allclose(N(tse3.inverse(T(Tj))), np.asarray(jse3.inverse(jnp.asarray(Tj))), atol=1e-6)
    pts = rng.normal(size=(7, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(N(tse3.transform_points(T(Tj), T(pts))),
                               np.asarray(jse3.transform_points(jnp.asarray(Tj), jnp.asarray(pts))), atol=1e-5)
    np.testing.assert_allclose(N(tse3.compose(T(Tj[0]), T(Tj[1]))), Tj[0] @ Tj[1], atol=1e-6)


def test_bilateral_and_box_filters_match_jax(depths, rng):
    d = depths[0]
    out = N(tfilters.bilateral_filter(T(d), 4.5, 0.04, radius=3))
    ref = np.asarray(jfilters.bilateral_filter(jnp.asarray(d), 4.5, 0.04, radius=3))
    assert ((out > 0) == (ref > 0)).all()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)  # XLA's exp: a few ulp
    img = rng.uniform(0, 1, (23, 31)).astype(np.float32)
    np.testing.assert_allclose(N(tfilters.box_filter(T(img), 2)),
                               np.asarray(jfilters.box_filter(jnp.asarray(img), 2)), atol=1e-6)


def test_depth_pyramid_matches_jax(depths):
    from opencv_contrib_tpu.core import pyramid as jpyramid

    for lt, lj in zip(tpyramid.build_depth_pyramid(T(depths[1]), 3, 0.04),
                      jpyramid.build_depth_pyramid(jnp.asarray(depths[1]), 3, 0.04)):
        np.testing.assert_array_equal(N(lt), np.asarray(lj))


@pytest.mark.parametrize("use_bilateral", [False, True])
def test_make_frame_matches_jax(depths, use_bilateral):
    jf = jframe.make_frame(jnp.asarray(depths[0]), jnp.asarray(INTR), use_bilateral=use_bilateral)
    tf = tframe.make_frame(T(depths[0]), T(INTR), use_bilateral=use_bilateral)
    assert len(tf) == 3
    for a, b in zip(jf, tf):
        assert a.depth.shape == tuple(b.depth.shape)
        np.testing.assert_array_equal(N(b.valid), np.asarray(a.valid))
        np.testing.assert_allclose(N(b.points), np.asarray(a.points), atol=1e-5)
        # with the bilateral filter, its output's ulp differences, amplified
        # at grazing pixels (observed: up to 2.4e-5 on 2% of the pixels)
        np.testing.assert_allclose(N(b.normals), np.asarray(a.normals), atol=1e-4 if use_bilateral else 1e-5)


# --- ICP ----------------------------------------------------------------------


@pytest.mark.parametrize("offset", [False, True], ids=["identity", "offset"])
def test_build_system_matches_jax(frames, offset):
    (j0, t0), (j1, t1) = frames
    Tm = np.asarray(jse3.exp_se3(jnp.asarray(OFFSET))) if offset else np.eye(4, dtype=np.float32)
    for lvl in range(3):
        it = np.asarray(jframe.level_intrinsics(jnp.asarray(INTR), lvl))
        Aj, bj, nj, ej = jicp.build_system(jnp.asarray(Tm), j1[lvl], j0[lvl], jnp.asarray(it), 0.1 * (1 << lvl))
        At, bt, nt, et = ticp.build_system(T(Tm), t1[lvl], t0[lvl], T(it), 0.1 * (1 << lvl))
        assert abs(float(nt) - float(nj)) <= max(3.0, 2e-3 * float(nj))
        Aj, bj = np.asarray(Aj), np.asarray(bj)
        np.testing.assert_allclose(N(At), Aj, rtol=0, atol=1e-3 * np.abs(Aj).max())
        np.testing.assert_allclose(N(bt), bj, rtol=0, atol=1e-3 * np.abs(bj).max())
        np.testing.assert_allclose(float(et), float(ej), rtol=1e-3)


def test_estimate_transform_matches_jax(frames):
    (j0, t0), (j1, t1) = frames
    Tj, okj, _ = jicp.estimate_transform(j1, j0, jnp.asarray(INTR))
    Tt, okt, _ = ticp.estimate_transform(t1, t0, T(INTR))
    assert bool(okt) == bool(okj) is True
    assert _pose_diff(np.asarray(Tj), N(Tt)) < 1e-4


# --- TSDF ---------------------------------------------------------------------


def _assert_volumes_equal(vt, vj):
    np.testing.assert_array_equal(N(vt.weight), np.asarray(vj.weight))
    np.testing.assert_allclose(N(vt.tsdf), np.asarray(vj.tsdf), atol=1e-5)


def test_integrate_matches_jax(poses, depths):
    vj = jtsdf.create((64, 64, 64), size=3.2)
    vt = ttsdf.create((64, 64, 64), size=3.2)
    for k in (0, 1):  # a second frame fuses into weighted voxels
        vj = jtsdf.integrate(vj, jnp.asarray(depths[k]), jnp.asarray(INTR), jnp.asarray(_cw(poses[k])))
        vt = ttsdf.integrate(vt, T(depths[k]), T(INTR), T(_cw(poses[k])))
        _assert_volumes_equal(vt, vj)
    assert float(vt.weight.max()) == 2.0


def test_integrate_sparse_matches_jax(depths):
    vj = jtsdf.create((64, 64, 64), size=3.2, center=(0, 0, 2.2))
    vt = ttsdf.create((64, 64, 64), size=3.2, center=(0, 0, 2.2))
    vj = jtsdf.integrate_sparse(vj, jnp.asarray(depths[0]), jnp.asarray(INTR), jnp.eye(4), max_blocks=512)
    vt = ttsdf.integrate_sparse(vt, T(depths[0]), T(INTR), torch.eye(4), max_blocks=512)
    assert int((vt.weight > 0).sum()) > 10000
    _assert_volumes_equal(vt, vj)


def test_integrate_sparse_gate_and_inplace(depths):
    """A False gate leaves the volume as it was (the KinFu tick's masked
    update); a True gate updates it as no gate does, in the given tensors."""
    def fresh():
        return ttsdf.create((64, 64, 64), size=3.2, center=(0, 0, 2.2))

    vol = fresh()
    args = (T(depths[0]), T(INTR), torch.eye(4))
    gated = ttsdf.integrate_sparse(vol, *args, max_blocks=512, gate=torch.tensor(False))
    assert gated.tsdf is vol.tsdf and gated.weight is vol.weight
    assert float(vol.weight.abs().sum()) == 0.0 and float(vol.tsdf.abs().sum()) == 0.0
    ungated = ttsdf.integrate_sparse(fresh(), *args, max_blocks=512)
    same = ttsdf.integrate_sparse(vol, *args, max_blocks=512, gate=torch.tensor(True))
    assert same.tsdf is vol.tsdf and same.weight is vol.weight and float(vol.weight.sum()) > 0
    np.testing.assert_array_equal(N(vol.weight), N(ungated.weight))
    np.testing.assert_array_equal(N(vol.tsdf), N(ungated.tsdf))


@pytest.fixture(scope="module")
def volumes96(poses, depths):
    vj = jtsdf.integrate(jtsdf.create((96, 96, 96), size=3.2), jnp.asarray(depths[0]), jnp.asarray(INTR),
                         jnp.asarray(_cw(poses[0])))
    vt = ttsdf.integrate(ttsdf.create((96, 96, 96), size=3.2), T(depths[0]), T(INTR), T(_cw(poses[0])))
    return vj, vt


def _assert_raycasts_agree(out_t, out_j):
    pt, nt, vt = (N(x) for x in out_t)
    pj, nj, vj = (np.asarray(x) for x in out_j)
    assert (vt == vj).mean() >= 0.999 and vj.mean() > 0.3
    both = vt & vj
    np.testing.assert_allclose(pt[..., 2][both], pj[..., 2][both], atol=1e-4)
    np.testing.assert_allclose(nt[both], nj[both], atol=1e-4)


@pytest.mark.parametrize("frame_idx", [0, 1])
def test_raycast_matches_jax(poses, volumes96, frame_idx):
    """Gradient normals (the default at 96^3), at the integrated pose and at
    the next orbit pose."""
    vj, vt = volumes96
    Tcw = _cw(poses[frame_idx])
    out_j = jtsdf.raycast(vj, jnp.asarray(INTR), jnp.asarray(Tcw), shape=SHAPE)
    out_t = ttsdf.raycast(vt, T(INTR), T(Tcw), shape=SHAPE)
    _assert_raycasts_agree(out_t, out_j)


@pytest.fixture(scope="module")
def volumes64(depths):
    """Sparse-integrated 64^3 volumes, as tests/test_raycast_splat.py builds them."""
    vj = jtsdf.integrate_sparse(jtsdf.create((64, 64, 64), size=3.2, center=(0, 0, 2.2)), jnp.asarray(depths[0]),
                                jnp.asarray(INTR), jnp.eye(4), max_blocks=512)
    vt = ttsdf.integrate_sparse(ttsdf.create((64, 64, 64), size=3.2, center=(0, 0, 2.2)), T(depths[0]), T(INTR),
                                torch.eye(4), max_blocks=512)
    return vj, vt


@pytest.mark.parametrize("offset", [False, True], ids=["identity", "offset"])
def test_raycast_splat_matches_jax(volumes64, offset):
    vj, vt = volumes64
    Tm = np.asarray(jse3.exp_se3(jnp.asarray(OFFSET))) if offset else np.eye(4, dtype=np.float32)
    out_j = jtsdf.raycast_splat(vj, jnp.asarray(INTR), jnp.asarray(Tm), shape=SHAPE, paint_sub=2, stamp=24)
    out_t = ttsdf.raycast_splat(vt, T(INTR), T(Tm), shape=SHAPE, paint_sub=2, stamp=24)
    _assert_raycasts_agree(out_t, out_j)


@pytest.mark.parametrize("normals", ["screen", "gradient"])
@pytest.mark.parametrize("offset", [False, True], ids=["identity", "offset"])
def test_raycast_splat_main_path_settings_match_jax(volumes64, normals, offset):
    """The settings of KinFu's model raycast above 256^3 (`_raycast_pyramid`:
    n_fine=10, stamp=8, the default paint_sub=4), with the JAX package's
    screen-space normals and with the TSDF gradient the port takes there."""
    vj, vt = volumes64
    Tm = np.asarray(jse3.exp_se3(jnp.asarray(OFFSET))) if offset else np.eye(4, dtype=np.float32)
    kw = dict(shape=SHAPE, n_fine=10, stamp=8, normals=normals)
    out_j = jtsdf.raycast_splat(vj, jnp.asarray(INTR), jnp.asarray(Tm), **kw)
    out_t = ttsdf.raycast_splat(vt, T(INTR), T(Tm), **kw)
    _assert_raycasts_agree(out_t, out_j)


def test_extract_points_matches_jax(volumes64):
    vj, vt = volumes64
    pj, nj, okj = jtsdf.extract_points(vj, max_points=8192)
    pt, nt, okt = ttsdf.extract_points(vt, max_points=8192)
    assert int(okt.sum()) == int(okj.sum()) > 1000
    np.testing.assert_array_equal(N(okt), np.asarray(okj))
    np.testing.assert_allclose(N(pt), np.asarray(pj), atol=1e-5)
    np.testing.assert_allclose(N(nt), np.asarray(nj), atol=1e-4)


# --- KinFu --------------------------------------------------------------------


def _params(module, res=96):
    p = module.KinFuParams.default(INTR, SHAPE)
    p.volume_resolution = (res, res, res)
    p.volume_size = 3.2
    p.volume_center = (0.0, 0.0, 2.2)
    return p


def _drift(poses, T_est):
    """The reference gate's pose difference (tests/test_rgbd.py:178-182)."""
    T_gt = jse3.inverse(jnp.asarray(poses[0])) @ jnp.asarray(poses[len(poses) - 1])
    return np.asarray(jse3.log_se3(jse3.inverse(T_gt) @ jnp.asarray(T_est)))


def test_kinfu_tick_from_jax_state(depths):
    """Carry a JAX KinFu's state after frame 3 into the port, tick both on
    frame 4: the same pose, flag and volume."""
    kj = jkinfu.KinFu(_params(jkinfu))
    for d in depths[:4]:
        assert kj.update(d)
    kt = tkinfu.KinFu(_params(tkinfu), device="cpu")
    kt.volume = interop.from_numpy(kj.volume)
    kt.model_pyr = interop.from_numpy(kj.model_pyr)
    kt.T_cw = interop.from_numpy(kj.T_cw)
    kt.frame_count = kj.frame_count
    assert type(kt.volume) is ttsdf.TSDFVolume and type(kt.model_pyr[0]) is tframe.DepthFrame
    assert kt.update(depths[4]) == kj.update(depths[4]) is True
    np.testing.assert_allclose(N(kt.T_cw), np.asarray(kj.T_cw), atol=1e-4)
    np.testing.assert_array_equal(N(kt.volume.weight), np.asarray(kj.volume.weight))
    err = np.abs(N(kt.volume.tsdf) - np.asarray(kj.volume.tsdf))
    # a ~1e-7 pose difference re-rounds a voxel's pixel now and then
    assert (err > 1e-5).sum() <= max(2, 1e-4 * int((N(kt.volume.weight) > 0).sum())), (err > 1e-5).sum()


def test_kinfu_orbit_meets_reference_gates(poses, depths):
    """The reference's drift gate (test_kinfu.cpp:326-330) on a 6-frame
    orbit at 96^3, in both packages."""
    orbit = poses[:6]
    kj = jkinfu.KinFu(_params(jkinfu))
    kt = tkinfu.KinFu(_params(tkinfu), device="cpu")
    for d in depths:
        assert kj.update(d) and kt.update(d)
    for d in (_drift(orbit, kj.pose), _drift(orbit, kt.pose)):
        assert np.linalg.norm(d[:3]) < 0.02 and np.linalg.norm(d[3:]) < 0.1, d
    assert _pose_diff(kj.pose, kt.pose) < 2e-3


def test_kinfu_track_entry(depths):
    """entry.kinfu_track runs the same ticks as KinFu.update, and keeps
    the tracking flags on the device until read."""
    kw = dict(frame_shape=SHAPE, volume_resolution=(64, 64, 64), volume_size=3.2, volume_center=(0.0, 0.0, 2.2),
              sparse_blocks=512, device="cpu")
    out = entry.kinfu_track(np.stack(depths[:3]), INTR, **kw)
    assert tuple(out.T_cw.shape) == (3, 4, 4) and out.ok.dtype == torch.bool and bool(out.ok.all())
    p = _params(tkinfu, 64)
    p.sparse_blocks = 512
    kf = tkinfu.KinFu(p, device="cpu")
    for d in depths[:3]:
        kf.update(d)
    np.testing.assert_array_equal(N(out.T_cw[-1]), N(kf.T_cw))
    np.testing.assert_array_equal(N(out.volume.tsdf), N(kf.volume.tsdf))


def test_kinfu_bench_frames():
    """bench.py::bench_kinfu_vga512's ramp: base + 0.002 * i, about 2 m."""
    f = entry.kinfu_bench_frames(3, 48, 64)
    assert f.shape == (3, 48, 64) and f.dtype == np.float32
    np.testing.assert_allclose(f[2] - f[0], 0.004, atol=1e-6)
    assert 1.4 < f.min() and f.max() < 2.6
