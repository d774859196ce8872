"""Parity of the port's video stabilization and super-resolution
(opencv_contrib_tpu_torch.videostab, .superres, and the planned segment
sum of ops/segment.py) with the JAX package on the CPU, on the JAX tests'
fixtures (tests/test_breadth2.py::TestVideostab / TestSuperres,
test_videostab2.py), the same numpy arrays through both packages, and
`entry.stabilize_clip` / `entry.superres_clip` against chip_smoke's phase-w
gates at a small size.

Tolerances:
- the stabilizer: motions 1e-5 (each pair's 12 Gauss-Newton steps a level
  through jacfwd of the warp, summed in another order), the float64
  compensation 1e-5, the frames 1e-5;
- RANSAC on the twin's hypotheses (recomputed from its key outside jit):
  the motion 1e-4 and the inliers equal (the refit is "gels" QR least
  squares against the twin's SVD solve, equal at rank 3);
- the L1 path 1e-4 (150 ADMM x 25 CG steps in float32, the sums in
  another order); blurriness 1e-6 relative; deblur, inpainting and wobble
  1e-5;
- BTV 1e-4 with known flows and 5e-4 with DIS's (the twin's adjoint is a
  `jax.linear_transpose` scatter in XLA's order, the port's sums each
  pixel's contributions in index order); the adjoint to 1e-12 relative in
  float64 (the dot-product test); the planned segment sum bit-equal to
  `index_add_`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from opencv_contrib_tpu import superres as jsr
from opencv_contrib_tpu import videostab as jvs
from opencv_contrib_tpu.ops import filters as jf
from opencv_contrib_tpu.ops.image import resize as jresize
from opencv_contrib_tpu.ops.image import warp_affine as jwarp
from opencv_contrib_tpu_torch import entry
from opencv_contrib_tpu_torch import superres as tsr
from opencv_contrib_tpu_torch import videostab as tvs
from opencv_contrib_tpu_torch.ops import segment
from opencv_contrib_tpu_torch.ops.image import sample_bilinear
from opencv_contrib_tpu_torch.superres import btv as tbtv
from opencv_contrib_tpu_torch.videostab import extra as textra

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --- the stabilizer -------------------------------------------------------------------------


def test_stabilize_shift_jitter(rng):
    """TestVideostab::test_stabilizes_jitter."""
    base = np.asarray(jf.gaussian_blur(jnp.asarray(rng.uniform(size=(64, 64)).astype(np.float32)), 2.0)) * 3
    jit = [(0.0, 0.0), (2.0, -1.0), (-1.5, 2.0), (1.0, 1.0), (-2.0, -2.0), (0.5, -0.5)]
    frames = [np.asarray(jwarp(jnp.asarray(base), jnp.array([[1.0, 0.0, dx], [0.0, 1.0, dy]]))) for dy, dx in jit]
    sj, mj, cj = jvs.stabilize(frames, model="shift", sigma=1.5)
    st, mt, ct = tvs.stabilize([T(f) for f in frames], model="shift", sigma=1.5)
    np.testing.assert_allclose(N(mt), np.asarray(mj), atol=1e-5)
    assert ct.dtype == torch.float64
    np.testing.assert_allclose(N(ct), cj, atol=1e-5)
    for a, b in zip(st, sj):
        np.testing.assert_allclose(N(a), b, atol=1e-5)

    def tvar(fs):
        return np.stack([np.asarray(f)[8:-8, 8:-8] for f in fs]).var(axis=0).mean()

    assert tvar([N(f) for f in st]) < tvar(frames) * 0.6


def test_smooth_trajectory_in_float64(rng):
    m = rng.normal(0, 1.0, (9, 4))
    np.testing.assert_allclose(N(tvs.smooth_trajectory(T(m), 2.0)), jvs.smooth_trajectory(m, 2.0), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(N(tvs.smooth_trajectory(m.astype(np.float32), 0.5)),
                               jvs.smooth_trajectory(m.astype(np.float32), 0.5), atol=1e-12)


def test_estimate_motions_similarity(rng):
    base = np.asarray(jf.gaussian_blur(jnp.asarray(rng.uniform(size=(64, 80)).astype(np.float32)), 2.0)) * 3
    frames = [base, np.asarray(jwarp(jnp.asarray(base), jnp.array([[1.0, -0.02, 1.5], [0.02, 1.0, -1.0]])))]
    mj = jvs.estimate_motions(frames, "similarity")
    mt = tvs.estimate_motions([T(f) for f in frames], "similarity")
    np.testing.assert_allclose(N(mt), mj, atol=1e-5)


# --- RANSAC, the L1 path --------------------------------------------------------------------


@pytest.mark.parametrize("model,seed", [("similarity", 0), ("translation", 1), ("affine", 2)])
def test_ransac_motion_on_the_twin_hypotheses(model, seed, monkeypatch):
    """tests/test_videostab2.py::TestRansacMotion's fixtures."""
    rng = np.random.default_rng(seed)
    if model == "similarity":
        pts0 = rng.uniform(0, 100, (60, 2)).astype(np.float32)
        th, s = 0.2, 1.1
        A = np.concatenate([s * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]),
                            [[3.0], [-2.0]]], 1).astype(np.float32)
    elif model == "translation":
        pts0 = rng.uniform(0, 50, (30, 2)).astype(np.float32)
        A = np.array([[1.0, 0.0, 5.0], [0.0, 1.0, -3.0]], np.float32)
    else:
        pts0 = rng.uniform(0, 50, (40, 2)).astype(np.float32)
        A = np.array([[1.1, 0.2, 4.0], [-0.1, 0.95, 1.0]], np.float32)
    pts1 = pts0 @ A[:, :2].T + A[:, 2]
    if model == "similarity":
        pts1[:12] += rng.uniform(20, 40, (12, 2))  # 20% outliers
    key = jax.random.PRNGKey(seed)
    msize = {"translation": 1, "similarity": 2, "affine": 3}[model]
    idx = np.asarray(jax.random.randint(key, (256, msize), 0, pts0.shape[0]))
    monkeypatch.setattr(textra, "_hypotheses", lambda gen, n, m, n_pts, device: T(idx))
    Mj, inl_j = jvs.ransac_motion(jnp.asarray(pts0), jnp.asarray(pts1), key, model=model)
    Mt, inl_t = tvs.ransac_motion(T(pts0), T(pts1), None, model=model)
    np.testing.assert_allclose(N(Mt), np.asarray(Mj), atol=1e-4)
    np.testing.assert_array_equal(N(inl_t), np.asarray(inl_j))
    np.testing.assert_allclose(N(Mt)[:2], A, atol=0.02 if model != "translation" else 1e-3)


def test_lp_trajectory():
    """TestLpTrajectory::test_smoother_and_bounded, and the adjoints of the
    difference operators."""
    rng = np.random.default_rng(3)
    n = 60
    jitter = rng.normal(0, 0.03, (n, 2)).astype(np.float32)
    C = np.stack([np.linspace(0, 1, n), np.zeros(n)], 1).astype(np.float32) + jitter
    Sj = np.asarray(jvs.lp_stabilize_trajectory(jnp.array(C), bound=0.08))
    St = N(tvs.lp_stabilize_trajectory(T(C), bound=0.08))
    np.testing.assert_allclose(St, Sj, atol=1e-4)
    assert np.abs(np.diff(St, axis=0)).sum() < np.abs(np.diff(C, axis=0)).sum() * 0.6
    assert np.abs(St - C).max() < 0.15
    x = torch.from_numpy(rng.normal(size=(20, 3)))
    for D, Dt, k in ((textra._d1, textra._d1t, 1), (textra._d2, textra._d2t, 2), (textra._d3, textra._d3t, 3)):
        y = torch.from_numpy(rng.normal(size=(20 - k, 3)))
        assert abs(float((D(x) * y).sum() - (x * Dt(y)).sum())) < 1e-12


# --- deblur, inpainting, wobble ---------------------------------------------------------------


def test_deblur(rng):
    sharp = rng.uniform(size=(32, 32)).astype(np.float32)
    blurred = np.asarray(jf.gaussian_blur(jnp.array(sharp), 2.0))
    np.testing.assert_allclose(float(tvs.calc_blurriness(T(blurred))), float(jvs.calc_blurriness(jnp.array(blurred))),
                               rtol=1e-6)
    M = np.array([[1.0, 0.0, 0.5], [0.0, 1.0, -0.3], [0.0, 0.0, 1.0]], np.float32)
    frames, motions = [sharp, blurred, sharp, sharp], [M, np.eye(3, dtype=np.float32), M]
    for idx in (1, 2):
        out_j = np.asarray(jvs.weighting_deblur(frames, motions, idx=idx))
        out_t = N(tvs.weighting_deblur([T(f) for f in frames], [T(m) for m in motions], idx=idx))
        np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    assert np.abs(out_t - sharp).mean() < np.abs(blurred - sharp).mean() or idx != 1


@pytest.mark.parametrize("idx", [1, 2])
def test_inpainters(idx, rng):
    """ColorAverageInpainter and ConsistentMosaicInpainter; idx 1 stacks 4
    frames (an even median: the mean of the two middles), idx 2 five."""
    f = np.full((24, 24), 0.7, np.float32)
    mask = np.zeros((24, 24), bool)
    mask[8:14, 9:15] = True
    np.testing.assert_allclose(N(tvs.color_average_inpaint(T(f), T(mask), n_iters=100)), 0.7, atol=1e-3)
    tex = rng.uniform(size=(24, 24)).astype(np.float32)
    np.testing.assert_allclose(N(tvs.color_average_inpaint(T(tex), T(mask), n_iters=30)),
                               np.asarray(jvs.color_average_inpaint(tex, mask, n_iters=30)), atol=1e-5)
    scene = rng.uniform(size=(32, 32)).astype(np.float32)
    mask = np.zeros((32, 32), bool)
    mask[10:16, 10:16] = True
    frames = [scene * s for s in (1.0, 1.1, 0.9, 1.05, 0.95)]
    frames[idx] = np.where(mask, 0.0, frames[idx]).astype(np.float32)
    M = np.array([[1.0, 0.0, 0.25], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    motions = [M] * 4
    out_j = np.asarray(jvs.consistent_mosaic_inpaint(frames, motions, idx, mask, radius=2))
    out_t = N(tvs.consistent_mosaic_inpaint([T(x) for x in frames], [T(m) for m in motions], idx, T(mask), radius=2))
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)


def test_median_of_an_even_count():
    S = torch.tensor([[1.0, 5.0], [4.0, 2.0], [3.0, 8.0], [2.0, 1.0]])
    np.testing.assert_array_equal(N(textra._median0(S)), np.asarray(jnp.median(jnp.asarray(N(S)), axis=0)))
    assert N(textra._median0(S)).tolist() == [2.5, 3.5]  # torch.median would give the lower, [2, 2]
    np.testing.assert_array_equal(N(textra._median0(S[:3])), [3.0, 5.0])


def test_wobble(rng):
    f = rng.uniform(size=(24, 24)).astype(np.float32)
    eye = np.eye(3, dtype=np.float32)
    A = np.array([[1.0, 0.01, 0.3], [-0.01, 1.0, -0.2], [0, 0, 1]], np.float32)
    B = np.array([[1.0, 0.0, 0.1], [0.0, 1.0, 0.25], [0, 0, 1]], np.float32)
    motions, motions2 = [A, B] * 4 + [A], [B, A] * 4 + [B]
    for idx in (0, 3, 7):
        out_j = np.asarray(jvs.wobble_suppress(f, idx, 5, motions, motions2, eye))
        out_t = N(tvs.wobble_suppress(T(f), idx, 5, [T(m) for m in motions], [T(m) for m in motions2], T(eye)))
        np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    same = N(tvs.wobble_suppress(T(f), 3, 5, [T(eye)] * 9, [T(eye)] * 9, T(eye)))
    np.testing.assert_allclose(same, f, atol=1e-4)


# --- super-resolution ---------------------------------------------------------------------


SHIFTS = [(0, 0), (1.0, 0), (0, 1.0), (1.0, 1.0)]


@pytest.fixture(scope="module")
def sr_fixture():
    """TestSuperres._fixture."""
    rng = np.random.default_rng(0)
    hr_gt = np.asarray(jf.gaussian_blur(jnp.asarray(rng.uniform(size=(64, 64)).astype(np.float32)), 1.0))
    frames = [np.asarray(jresize(jwarp(jnp.asarray(hr_gt), jnp.array([[1.0, 0.0, dx], [0.0, 1.0, dy]])), (32, 32),
                                 method="area")) for dy, dx in SHIFTS]
    return hr_gt, frames


def _ratio(out, hr_gt, frames):
    bicubic = np.asarray(jresize(jnp.asarray(frames[0]), (64, 64)))
    return np.abs(out[4:-4, 4:-4] - hr_gt[4:-4, 4:-4]).mean() / np.abs(bicubic[4:-4, 4:-4] - hr_gt[4:-4, 4:-4]).mean()


def test_btv_with_known_flows(sr_fixture):
    hr_gt, frames = sr_fixture
    flows = [np.full((32, 32, 2), [dy / 2, dx / 2], np.float32) for dy, dx in SHIFTS]
    oj = np.asarray(jsr.btv_l1(frames, scale=2, n_iters=25, lam=5e-3, ref_index=0, flows=flows))
    ot = N(tsr.btv_l1([T(f) for f in frames], scale=2, n_iters=25, lam=5e-3, ref_index=0,
                      flows=[T(f) for f in flows]))
    np.testing.assert_allclose(ot, oj, atol=1e-4)
    assert _ratio(ot, hr_gt, frames) < 0.35


def test_btv_with_dis_flows(sr_fixture):
    hr_gt, frames = sr_fixture
    oj = np.asarray(jsr.btv_l1(frames, scale=2, n_iters=25, lam=2e-2))
    ot = N(tsr.btv_l1([T(f) for f in frames], scale=2, n_iters=25, lam=2e-2))
    np.testing.assert_allclose(ot, oj, atol=5e-4)
    assert _ratio(ot, hr_gt, frames) < 2.5


def test_btv_adjoint_dot_product(rng):
    """<A x, y> = <x, A^T y> for the warp's written-out adjoint, in
    float64, at coordinates that leave the image (the clipped corners)."""
    sy = T(rng.uniform(-3, 50, (48, 40)))
    sx = T(rng.uniform(-3, 43, (48, 40)))
    w = tbtv._warp(sy, sx, 48, 40)
    x, y = T(rng.normal(size=(48, 40))), T(rng.normal(size=(48, 40)))
    lhs = float((sample_bilinear(x, w.sy, w.sx) * y).sum())
    rhs = float((x * tbtv._warp_t(w, y)).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    again = tbtv._warp_t(w, y)
    assert torch.equal(again, tbtv._warp_t(w, y))


def test_planned_segment_sum_is_index_add(rng):
    ids = T(rng.integers(0, 50, 400))
    vals = T(rng.normal(size=400).astype(np.float32))
    plan = segment.segment_plan(ids, 60)
    want = torch.zeros(60).index_add_(0, ids, vals)
    assert torch.equal(segment.segment_sum_planned(plan, vals), want)
    assert torch.equal(segment.segment_sum(ids, vals, 60), want)


# --- the entry points ----------------------------------------------------------------------


def test_stabilize_and_superres_clips_meet_the_gates():
    clip = entry.shaky_clip(96, 128, 8)
    res = entry.stabilize_clip(clip, device="cpu")
    g = chip_smoke.stab_gates(clip, res)
    assert g["ransac_inliers"] >= 45 and len(res.frames) == 8
    sr = entry.superres_clip(device="cpu", H=48, W=64)
    g = chip_smoke.superres_gates(sr)
    assert g["known_ratio"] < 0.35 and sr.known.shape == (96, 128)
