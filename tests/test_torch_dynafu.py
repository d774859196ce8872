"""Parity of the port's DynaFu slice (opencv_contrib_tpu_torch: core/se3.py's
quaternions, rgbd/warpfield.py, rgbd/dynafu.py, entry.dynafu_track) with
the JAX package, on the CPU. Inputs are made with numpy from seeds;
tests/test_rgbd_extras.py:154-185's growing bump (60x80, 5 frames, 64^3,
32 nodes) drives DynaFu.

Tolerances (measured values in brackets, on the CPU):
- quat_mul, quat_conj, quat_to_mat within 1e-6 (below 2.4e-7).
- warp_points within 1e-5 (1.2e-7); node_neighbors equal.
- _energy within rtol 1e-5 (equal) and its gradient (torch.autograd)
  within rtol 1e-4 of jax.grad's largest entry, at a random twist (4.5e-7)
  and at rest (7.1e-8).
- fit from one state (30 steps): xi within 1e-4 (7.5e-9).
- DynaFu over the 5 frames, each package on its own state: the same ok
  flags, xi within 1e-4 after every frame (7.0e-8: the 40 gradient steps a
  frame drift far below 1e-4), the TSDF within
  1e-5 (8.3e-7), render_live within 1e-5 on the same valid pixels
  (3.6e-7), and the bump gate (centre pulled toward the camera by more
  than 0.05 against the rim).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu.core import se3 as jse3
from opencv_contrib_tpu.rgbd import dynafu as jdyn
from opencv_contrib_tpu.rgbd import warpfield as jwf
from opencv_contrib_tpu_torch import entry, interop
from opencv_contrib_tpu_torch.core import se3 as tse3
from opencv_contrib_tpu_torch.rgbd import dynafu as tdyn
from opencv_contrib_tpu_torch.rgbd import warpfield as twf

torch.set_num_threads(1)

BUMP_SHAPE = (60, 80)
BUMP_INTR = np.array([70.0, 70.0, 40.0, 30.0], np.float32)  # tests/test_rgbd_extras.py:161
BUMP_PARAMS = dict(frame_shape=BUMP_SHAPE, n_nodes=32, node_sigma=0.3, volume_resolution=(64, 64, 64),
                   volume_size=2.0, volume_center=(0.0, 0.0, 1.2))


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def N(t):
    return t.detach().cpu().numpy()


def J(a):
    return jnp.asarray(np.asarray(a, dtype=np.float32))


def bump_frame(t: float) -> np.ndarray:
    """tests/test_rgbd_extras.py:163-166: a plane at z = 1.5 with a bump of
    height 0.2 t."""
    yy, xx = np.meshgrid(np.arange(BUMP_SHAPE[0]), np.arange(BUMP_SHAPE[1]), indexing="ij")
    bump = 0.2 * t * np.exp(-((yy - 30) ** 2 + (xx - 40) ** 2) / (2 * 8.0 ** 2))
    return (1.5 - bump).astype(np.float32)


def bump_gate(warped, valid) -> float:
    """Rim depth minus centre depth of the live render (tests/test_rgbd_extras.py:180-185)."""
    center = warped[26:34, 36:44, 2][valid[26:34, 36:44]]
    rim = warped[5:15, 5:15, 2][valid[5:15, 5:15]]
    assert center.size and rim.size
    return float(rim.mean() - center.mean())


def test_quaternions_match_jax():
    rng = np.random.default_rng(0)
    q1, q2 = rng.normal(size=(2, 50, 4)).astype(np.float32)
    np.testing.assert_allclose(N(tse3.quat_mul(T(q1), T(q2))), np.asarray(jse3.quat_mul(J(q1), J(q2))), atol=1e-6)
    np.testing.assert_array_equal(N(tse3.quat_conj(T(q1))), np.asarray(jse3.quat_conj(J(q1))))
    np.testing.assert_allclose(N(tse3.quat_to_mat(T(q1))), np.asarray(jse3.quat_to_mat(J(q1))), atol=1e-6)
    # the round trip through the port's mat_to_quat
    R = N(tse3.quat_to_mat(T(q1)))
    np.testing.assert_allclose(N(tse3.quat_to_mat(tse3.mat_to_quat(T(R)))), R, atol=1e-6)


@pytest.fixture(scope="module")
def field():
    """20 nodes in [-1, 1]^3 with small random twists, 300 points."""
    rng = np.random.default_rng(0)
    nodes = rng.uniform(-1, 1, (20, 3)).astype(np.float32)
    xi = (rng.normal(size=(20, 6)) * 0.05).astype(np.float32)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    jw = jwf.make_warpfield(nodes, sigma=0.6)._replace(xi=J(xi))
    tw = interop.from_numpy(jw)
    assert isinstance(tw, twf.WarpField)
    return jw, tw, pts


def test_warp_points_and_neighbors_match_jax(field):
    jw, tw, pts = field
    for k in (1, 4):
        np.testing.assert_allclose(N(twf.warp_points(tw, T(pts), k=k)), np.asarray(jwf.warp_points(jw, J(pts), k=k)),
                                   atol=1e-5)
    np.testing.assert_array_equal(N(twf.node_neighbors(tw.nodes)), np.asarray(jwf.node_neighbors(jw.nodes)))
    rest = twf.make_warpfield(tw.nodes, sigma=0.6)
    np.testing.assert_allclose(N(twf.warp_points(rest, T(pts))), pts, atol=1e-6)


@pytest.mark.parametrize("at", ["random", "rest"])
def test_energy_and_gradient_match_jax(field, at):
    """_energy and torch.autograd's gradient against jax.grad, at the
    field's twists and at rest (xi = 0, where exp_se3 takes its small-angle
    branch)."""
    jw, tw, pts = field
    xi = np.asarray(jw.xi) if at == "random" else np.zeros((20, 6), np.float32)
    tgt = pts + np.float32(0.05)
    nrm = np.tile(np.eye(3, dtype=np.float32), (100, 1))
    nbrs = np.array(jwf.node_neighbors(jw.nodes))
    args_j = (jw, J(pts), J(tgt), J(nrm), jnp.asarray(nbrs), 4, 0.5)
    ej, gj = jwf._energy(J(xi), *args_j), jax.grad(jwf._energy)(J(xi), *args_j)
    x = T(xi).requires_grad_(True)
    et = twf._energy(x, tw, T(pts), T(tgt), T(nrm), torch.from_numpy(nbrs).long(), 4, 0.5)
    (gt,) = torch.autograd.grad(et, x)
    np.testing.assert_allclose(float(et.detach()), float(ej), rtol=1e-5)
    assert np.isfinite(N(gt)).all()
    np.testing.assert_allclose(N(gt), np.asarray(gj), atol=1e-4 * np.abs(np.asarray(gj)).max())


def test_fit_matches_jax(field):
    """30 steps of tests/test_rgbd_extras.py:140-152's fit (a shifted copy,
    axis normals) from the field's state."""
    jw, tw, pts = field
    tgt = pts + np.array([0.05, -0.03, 0.08], np.float32)
    nrm = np.tile(np.eye(3, dtype=np.float32), (100, 1))
    nbrs = np.array(jwf.node_neighbors(jw.nodes))
    fj = jwf.fit(jw, J(pts), J(tgt), J(nrm), jnp.asarray(nbrs), iters=30, lr=0.2, lam=0.1)
    ft = twf.fit(tw, T(pts), T(tgt), T(nrm), torch.from_numpy(nbrs).long(), iters=30, lr=0.2, lam=0.1)
    np.testing.assert_allclose(N(ft.xi), np.asarray(fj.xi), atol=1e-4)
    assert not ft.xi.requires_grad
    err0 = np.linalg.norm(pts - tgt, axis=1).mean()
    err1 = np.linalg.norm(N(twf.warp_points(ft, T(pts))) - tgt, axis=1).mean()
    assert err1 < err0


def test_dynafu_matches_jax():
    """The growing bump through both packages, each on its own state."""
    jd = jdyn.DynaFu(BUMP_INTR, **BUMP_PARAMS)
    td = tdyn.DynaFu(BUMP_INTR, device="cpu", **BUMP_PARAMS)
    for t in np.linspace(0.0, 1.0, 5):
        d = bump_frame(t)
        ok_j, ok_t = jd.update(J(d)), td.update(d)
        assert ok_t == ok_j
        np.testing.assert_allclose(N(td.warp.xi), np.asarray(jd.warp.xi), atol=1e-4)
        np.testing.assert_allclose(N(td.volume.tsdf), np.asarray(jd.volume.tsdf), atol=1e-5)
        np.testing.assert_array_equal(N(td.volume.weight), np.asarray(jd.volume.weight))
    wj, vj = jd.render_live()
    wt, vt = td.render_live()
    np.testing.assert_array_equal(N(vt), np.asarray(vj))
    np.testing.assert_allclose(N(wt)[N(vt)], np.asarray(wj)[np.asarray(vj)], atol=1e-5)
    assert bump_gate(N(wt), N(vt)) > 0.05
    pc, _, pv = td.get_cloud(4096)
    pj, _, pvj = jd.get_cloud(4096)
    assert int(pv.sum()) == int(np.asarray(pvj).sum()) > 0


def test_dynafu_track_runs_the_frames():
    track = entry.dynafu_track(np.stack([bump_frame(t) for t in (0.0, 0.5)]), BUMP_INTR, device="cpu",
                               **{k: v for k, v in BUMP_PARAMS.items() if k != "frame_shape"})
    assert track.ok == [True, True]
    assert track.tracker.frame_shape == BUMP_SHAPE and track.tracker.frame_count == 2
