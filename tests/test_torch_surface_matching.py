"""Parity of the port's surface matching (opencv_contrib_tpu_torch
.surface_matching: point-pair features and cloud ICP), of
`interop.ppf_model`, and of `entry.geometry_x` on a small
`entry.geometry_scene` with the JAX package on the CPU. The inputs are the
JAX tests' fixtures (tests/test_surface_matching.py) and a seeded generic
cloud, the same numpy arrays through both packages.

Tolerances:
- features within 1e-6 (arccos rounds apart by an ulp: XLA's acos is its
  own approximation); keys of a generic cloud equal on >= 99.9% of the
  pairs and every differing pair within 1e-5 of a bin edge in a float64
  recompute written here; on the box cloud of the JAX tests every angle
  between two faces' normals is pi / 2 or pi, a bin edge (pi / 2 is 15
  bins of pi / 30 exactly), so the ulp decides the bin there: every
  differing key is such a pair (about 4% of the box's pairs);
- a trained model of the generic cloud: keys, reference indices equal,
  alpha within 1e-5, steps and diameter within 1e-6; the box's model's
  steps and diameter within 1e-6;
- ppf_match on the JAX package's model (carried by interop.ppf_model):
  votes equal and the pose within 1e-5 on the generic cloud, where every
  key agrees; on the box the pose refined by register_model_to_scene
  within 1e-4 of the JAX package's, and the JAX test's gates;
- register_model_to_scene: poses within 1e-4 and residuals within 1e-6;
- a rerun of ppf_match gives the same bits (votes are integer-valued
  counts, so the accumulating scatter's sums are exact in any order);
- entry.geometry_x at 240 x 320: the methods the JAX functions can run
  at this size in a few seconds held to them (disparities as in
  tests/test_torch_stereo.py, reg parameters within 1e-4, markers and
  corners as in tests/test_torch_calib.py, poses within 1e-4); FAPS and the
  DCT unwrap held to float64 recomputes written here (the port within 1e-4
  rad and 1e-4 of the range; the twin within 3e-4 rad and 1e-3 of the
  range: at this size its float32 unwrap moves the phase steps by up to
  ~1e-4 rad), and every method to the JAX tests' gates, as chip_smoke's
  phase v applies them at 480 x 640 (`chip_smoke.geometry_gates`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_stereo import _unwrap64
from opencv_contrib_tpu import aruco as jar
from opencv_contrib_tpu import phase_unwrapping as jpu
from opencv_contrib_tpu import rapid as jrap
from opencv_contrib_tpu import reg as jreg
from opencv_contrib_tpu import stereo as jst
from opencv_contrib_tpu import structured_light as jsl
from opencv_contrib_tpu import surface_matching as jsm
from opencv_contrib_tpu.aruco import charuco as jch
from opencv_contrib_tpu.core import se3 as jse3
from opencv_contrib_tpu.structured_light import sinusoidal as jsin
from opencv_contrib_tpu.surface_matching import ppf as jppf
from opencv_contrib_tpu_torch import entry, interop
from opencv_contrib_tpu_torch import surface_matching as tsm
from opencv_contrib_tpu_torch.surface_matching import ppf as tppf

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _box_cloud(n_per_face=36):
    from tests.test_surface_matching import _box_cloud as box

    return box(n_per_face)


def _generic_cloud(n=150, seed=5):
    """Points on a bumpy ellipsoid with their (unit) normals: no two normals
    at a quantization edge but by chance."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = 1.0 + 0.15 * np.sin(3 * d[:, 0]) * np.cos(2 * d[:, 1])
    pts = d * r[:, None] * np.array([0.6, 0.4, 0.3])
    nrm = d / np.array([0.6, 0.4, 0.3]) + 0.1 * rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts.astype(np.float32), nrm.astype(np.float32)


def _pairs(pts, nrm):
    M = len(pts)
    i, j = np.repeat(np.arange(M), M), np.tile(np.arange(M), M)
    return pts[i], nrm[i], pts[j], nrm[j], i != j


def _features64(p1, n1, p2, n2):
    d = (p2 - p1).astype(np.float64)
    dn = np.linalg.norm(d, axis=-1)
    dh = d / np.maximum(dn[:, None], 1e-9)

    def ang(a, b):
        return np.arccos(np.clip(np.sum(a.astype(np.float64) * b, -1), -1, 1))

    return np.stack([dn, ang(n1, dh), ang(n2, dh), ang(n1, n2)], -1)


def _near_edge(f64, dist_step, angle_step, tol=1e-5):
    """Pairs with a feature within tol of a quantization edge."""
    steps = np.array([dist_step, angle_step, angle_step, angle_step], np.float64)
    q = f64 / steps
    return (np.abs(q - np.round(q)) * steps <= tol).any(-1)


def test_features(rng):
    p1, p2 = rng.normal(size=(2, 200, 3)).astype(np.float32)
    n1, n2 = rng.normal(size=(2, 200, 3)).astype(np.float32)
    n1 /= np.linalg.norm(n1, axis=1, keepdims=True)
    n2 /= np.linalg.norm(n2, axis=1, keepdims=True)
    np.testing.assert_allclose(N(tppf.compute_ppf_features(T(p1), T(n1), T(p2), T(n2))),
                               np.asarray(jppf.compute_ppf_features(*map(jnp.asarray, (p1, n1, p2, n2)))), atol=1e-6)
    np.testing.assert_allclose(N(tppf._pair_alpha(T(p1), T(n1), T(p2))),
                               np.asarray(jppf._pair_alpha(*map(jnp.asarray, (p1, n1, p2)))), atol=1e-6)


@pytest.mark.parametrize("cloud", ["generic", "box"])
def test_keys(cloud):
    pts, nrm = _generic_cloud() if cloud == "generic" else _box_cloud()
    pts, nrm = pts[::2], nrm[::2]
    p1, n1, p2, n2, keep = _pairs(pts, nrm)
    step_d = np.float32(0.05 * 1.2)
    fj = jppf.compute_ppf_features(*map(jnp.asarray, (p1, n1, p2, n2)))
    kj = np.asarray(jppf._quantize(fj, jnp.float32(step_d), np.pi / 30))
    ft = tppf.compute_ppf_features(*map(T, (p1, n1, p2, n2)))
    kt = N(tppf._quantize(ft, T(step_d), T(np.float32(np.pi / 30))))
    differ = (kj != kt) & keep
    edge = _near_edge(_features64(p1, n1, p2, n2), float(step_d), float(np.float32(np.pi / 30)))
    assert not (differ & ~edge).any()
    if cloud == "generic":
        assert 1 - differ[keep].mean() >= 0.999


@pytest.fixture(scope="module")
def generic_models():
    pts, nrm = _generic_cloud()
    return pts, nrm, jsm.train_model(pts, nrm, sampling_step=1), tsm.train_model(T(pts), T(nrm), sampling_step=1)


def test_train_model(generic_models):
    _, _, mj, mt = generic_models
    for k in ("points", "normals"):
        np.testing.assert_array_equal(N(getattr(mt, k)), np.asarray(getattr(mj, k)))
    np.testing.assert_array_equal(N(mt.keys), np.asarray(mj.keys))
    np.testing.assert_array_equal(N(mt.ref_idx), np.asarray(mj.ref_idx))
    assert N(mt.keys).dtype == np.int32 and N(mt.ref_idx).dtype == np.int32
    np.testing.assert_allclose(N(mt.alpha), np.asarray(mj.alpha), atol=1e-5)
    for k in ("dist_step", "angle_step", "diameter"):
        np.testing.assert_allclose(float(getattr(mt, k)), float(getattr(mj, k)), rtol=1e-6)
    pts, nrm = _box_cloud()
    bj, bt = jsm.train_model(pts, nrm, sampling_step=3), tsm.train_model(T(pts), T(nrm), sampling_step=3)
    for k in ("dist_step", "angle_step", "diameter"):
        np.testing.assert_allclose(float(getattr(bt, k)), float(getattr(bj, k)), rtol=1e-6)
    assert (np.diff(N(bt.keys)) >= 0).all()


def test_interop_ppf_model(generic_models):
    _, _, mj, _ = generic_models
    m = interop.ppf_model(mj)
    assert type(m) is tppf.PPFModel
    for k in mj._fields:
        np.testing.assert_array_equal(N(getattr(m, k)), np.asarray(getattr(mj, k), N(getattr(m, k)).dtype))
    assert N(m.keys).dtype == np.int32 and N(m.angle_step).dtype == np.float32
    assert float(m.angle_step) == float(np.float32(np.pi / 30))
    with pytest.raises(TypeError):
        interop.ppf_model(jse3)


def _moved(pts, nrm, xi):
    Tg = np.asarray(jse3.exp_se3(jnp.asarray(xi, jnp.float32)))
    return Tg, pts @ Tg[:3, :3].T + Tg[:3, 3], nrm @ Tg[:3, :3].T


def test_match_on_the_jax_model(generic_models):
    pts, nrm, mj, _ = generic_models
    _, sc, sn = _moved(pts, nrm, [0.2, 0.4, -0.1, 0.3, -0.2, 0.5])
    Tj, vj = jsm.ppf_match(mj, sc, sn, scene_step=1)
    model = interop.ppf_model(mj)
    Tt, vt = tsm.ppf_match(model, T(sc), T(sn), scene_step=1)
    assert float(vt) == float(vj)
    np.testing.assert_allclose(N(Tt), np.asarray(Tj), atol=1e-5)
    Tt2, vt2 = tsm.ppf_match(model, T(sc), T(sn), scene_step=1)  # a rerun: the same bits
    assert torch.equal(Tt, Tt2) and torch.equal(vt, vt2)


def test_ppf_on_the_box_then_icp():
    """tests/test_surface_matching.py::TestPPF::test_detects_pose_of_model_in_scene."""
    pts, nrm = _box_cloud()
    Tg, sc, sn = _moved(pts, nrm, [0.2, 0.4, -0.1, 0.3, -0.2, 0.5])
    mj = jsm.train_model(pts, nrm, sampling_step=3)
    Tj, vj = jsm.ppf_match(mj, sc, sn, scene_step=3)
    Rj, _ = jsm.register_model_to_scene(pts, sc, sn, T_init=np.asarray(Tj))
    for model in (interop.ppf_model(mj), tsm.train_model(T(pts), T(nrm), sampling_step=3)):
        Tt, vt = tsm.ppf_match(model, T(sc), T(sn), scene_step=3)
        assert float(vt) > 10
        Rt, _ = tsm.register_model_to_scene(T(pts), T(sc), T(sn), T_init=Tt)
        np.testing.assert_allclose(N(Rt), np.asarray(Rj), atol=1e-4)
        d = np.asarray(jse3.log_se3(jse3.inverse(jnp.asarray(Tg)) @ jnp.asarray(N(Rt))))
        assert np.linalg.norm(d[:3]) < 0.05 and np.linalg.norm(d[3:]) < 0.05


@pytest.mark.parametrize("case", ["misaligned", "identity"])
def test_register_model_to_scene(case):
    """tests/test_surface_matching.py::TestCloudICP."""
    pts, nrm = _box_cloud(n_per_face=40 if case == "misaligned" else 36)
    if case == "misaligned":
        _, sc, sn = _moved(pts, nrm, [0.05, -0.04, 0.06, 0.05, 0.03, -0.04])
    else:
        sc, sn = pts, nrm
    Tj, ej = jsm.register_model_to_scene(pts, sc, sn)
    Tt, et = tsm.register_model_to_scene(T(pts), T(sc), T(sn))
    assert isinstance(et, float)
    np.testing.assert_allclose(N(Tt), np.asarray(Tj), atol=1e-4)
    assert abs(et - ej) <= 1e-6


# --- entry.geometry_x ------------------------------------------------------------

SMALL = (240, 320)


@pytest.fixture(scope="module")
def small():
    return entry.geometry_scene(*SMALL)


@pytest.fixture(scope="module")
def port(small):
    """geometry_x's result of each method on the small scene, made on
    first use and kept for the module."""
    done = {}

    def result(method):
        if method not in done:
            done[method] = entry.geometry_x(small, method, device="cpu")
        return done[method]

    return result


def test_geometry_scene(small):
    again = entry.geometry_scene(*SMALL)
    for k in entry.GeometryScene._fields:
        np.testing.assert_array_equal(np.asarray(getattr(again, k)), np.asarray(getattr(small, k)))
    H, W = SMALL
    assert small.left.shape == (H, W) and small.graycode.shape == (2 * (9 + 8) + 2, H, W)
    assert small.reg_mov.shape == (5, H, W) and small.omni_img.shape == (6, 48, 2)


def test_geometry_x_refuses(small, monkeypatch):
    with pytest.raises(ValueError):
        entry.geometry_x(small, "no_such_method", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        entry.geometry_x(small, "psp")  # the default device is the card, and there is none


def _faps64(cap: np.ndarray) -> np.ndarray:
    """structured_light.sinusoidal.compute_faps_phase in float64 numpy
    (its shadow mask, the sideband band-pass by np.fft, the anchored
    unwrap by `_unwrap64`)."""
    cap = cap.astype(np.float64)
    H, W = cap.shape[1:]
    yy, xx = np.arange(H)[:, None], np.arange(W)[None, :]
    cy, cx = H // 2, W // 2

    def analytic(img):
        F = np.fft.fftshift(np.fft.fft2(img))
        F = np.where((np.abs(yy - cy) <= 5) & (np.abs(xx - cx) <= 5), 0, F)
        my, mx = divmod(int(np.argmax(np.abs(F) * (xx > cx))), W)
        return np.fft.ifft2(np.fft.ifftshift(np.where((np.abs(yy - my) <= 21) & (np.abs(xx - mx) <= 21), F, 0)))

    hi = cap.max(0)
    mask = (hi > 0.1) & (hi - cap.min(0) > 0.02)
    z = [analytic(c) for c in cap]
    f = [2 * zi.real for zi in z]
    u = []
    for zi in z:
        psi = np.arctan2(zi.real, zi.imag)
        un = _unwrap64(psi)
        u.append(un + np.angle(np.mean(np.exp(1j * (psi - un)))))
    a, b, t1, t2 = f[0] - f[1], f[1] - f[2], u[1] - u[0], u[2] - u[1]
    return np.arctan2((1 - np.cos(t2)) * a + (1 - np.cos(t1)) * b, np.sin(t1) * b - np.sin(t2) * a) * mask


def _jax_chain(method, s, faps=None):
    """The JAX package's functions with GEOMETRY's settings on the scene
    (for the unwrap, its float64 recompute on the port's FAPS phase)."""
    J = jnp.asarray
    if method == "block_match":
        return jst.block_match(J(s.left), J(s.right), max_disp=64)
    if method == "graycode":
        return jsl.decode_graycode(J(s.graycode), 9, 8)
    if method == "faps":
        return jsin.compute_faps_phase(J(s.fringe)), _faps64(s.fringe)
    if method == "unwrap_phase_dct":
        return jpu.unwrap_phase_dct(jsin.compute_faps_phase(J(s.fringe))), _unwrap64(N(faps))
    if method == "reg_affine":
        return jreg.register_pyramid(s.reg_ref, s.reg_mov[3], model="affine", levels=3, iters=20)
    if method == "interpolate_charuco_corners":
        ids, corners = jar.detect_markers(s.charuco, s.dictionary)
        return jch.interpolate_charuco_corners(ids, corners, s.board_ids, s.board_centers, squares=(5, 5),
                                               square_px=s.square_px)
    if method == "rapid_track":
        return jrap.track(J(s.rapid_img), J(s.rapid_K), jnp.eye(3), J(s.rapid_t0), s.rapid_vertices, s.rapid_edges,
                          n_iters=5, search_len=10.0 * SMALL[1] / 160)
    if method == "cloud_icp":
        Tg = s.cloud_T_icp
        return jsm.register_model_to_scene(s.cloud, s.cloud @ Tg[:3, :3].T + Tg[:3, 3], s.cloud_normals @ Tg[:3, :3].T)
    raise KeyError(method)


JAX_HELD = ("block_match", "graycode", "faps", "unwrap_phase_dct", "reg_affine", "interpolate_charuco_corners",
            "rapid_track", "cloud_icp")


@pytest.mark.parametrize("method", JAX_HELD)
def test_geometry_x_against_jax(method, small, port):
    out = port(method)
    ref = _jax_chain(method, small, port("faps") if method == "unwrap_phase_dct" else None)
    if method == "block_match":
        d_j, d_t = np.rint(np.asarray(ref[0])), np.rint(N(out[0]))
        assert (d_j == d_t)[8:-8, 80:-16].mean() >= 0.995
    elif method == "graycode":
        for a, b in zip(ref, out):
            np.testing.assert_array_equal(N(b), np.asarray(a))
    elif method == "faps":  # each package against float64
        jx, f64 = np.asarray(ref[0]), ref[1]
        assert np.abs(np.angle(np.exp(1j * (N(out) - f64)))).max() <= 1e-4
        assert np.abs(np.angle(np.exp(1j * (jx - f64)))).max() <= 3e-4
    elif method == "unwrap_phase_dct":  # the port against float64 on its FAPS phase; the twin's float32 farther
        u, r = N(out), ref[1]
        assert np.abs((u - u.mean()) - (r - r.mean())).max() <= 1e-4 * np.ptp(r)
        jx = np.asarray(ref[0])
        assert np.abs((jx - jx.mean()) - (r - r.mean())).max() <= 1e-3 * np.ptp(r)
    elif method == "reg_affine":
        np.testing.assert_allclose(N(out), np.asarray(ref), atol=1e-4)
    elif method == "interpolate_charuco_corners":
        assert out[0] == ref[0]
        np.testing.assert_allclose(out[1], ref[1], atol=1e-3)
    elif method == "rapid_track":
        np.testing.assert_allclose(N(out[1]), np.asarray(ref[1]), atol=1e-4)
        np.testing.assert_allclose(N(out[0]), np.asarray(ref[0]), atol=1e-4)
    else:
        np.testing.assert_allclose(N(out[0]), np.asarray(ref[0]), atol=1e-4)


@pytest.mark.parametrize("method", sorted(entry.GEOMETRY))
def test_geometry_x_gates(method, small, port):
    """Every method at 240 x 320 on the CPU meets the JAX tests' gate that
    phase v applies at 480 x 640."""
    chip_smoke.geometry_gates(small, {method: port(method)})
