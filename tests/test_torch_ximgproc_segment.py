"""Parity of the port's ximgproc transforms, superpixels and segmentations
(opencv_contrib_tpu_torch.ximgproc: transforms_x, slic, superpixels_x,
segmentation; opencv_contrib_tpu_torch.hfs) with the JAX package on the
CPU. The inputs are the JAX tests' fixtures (tests/test_ximgproc*.py,
tests/test_detect_breadth.py::TestHfs) and a second seeded random image,
the same numpy arrays through both packages.

Tolerances:
- label maps (slic, SEEDS, LSC, ScanSegment, HFS, graph segmentation):
  equal. The region sums are `ops.segment` sums, which on the CPU add in
  the JAX version's index order (bits equal), and the host merges are the
  same numpy on the same weights;
- the region features, the adjacency's boundary lengths: equal; its
  gradient sums, selective search's texture histograms and EdgeBoxes'
  scores: 1e-6 relative (the gradient magnitude parts by an ulp here and
  there: XLA fuses the squares' sum); `_merge` on the same graph and the
  selective search proposals: equal;
- erode / dilate: equal; covariance: 1e-6; colour match: 1e-6 of the
  response's largest value; Radon: 1e-5 of the largest projection (the
  bilinear weights of a sample round apart now and then); Pei-Lin: held to
  a float64 recompute (`_peilin_f64`), each within 1e-2 of it and the two
  within twice the larger distance (the third moments cancel, so the
  residual rotation follows the summation order); SLIC / LSC centres:
  1e-4 px and 1e-4;
- find_ellipses: the same components scored, centres and axes within
  1e-3 px, scores within 1e-5, angles within 1e-4 rad up to pi (an
  eigenvector's sign is free in both versions)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu import ximgproc as jx
from opencv_contrib_tpu.hfs import segment as jhfs
from opencv_contrib_tpu.ximgproc import segmentation as jseg
from opencv_contrib_tpu.ximgproc import superpixels_x as jsp
from opencv_contrib_tpu_torch import ximgproc as tx
from opencv_contrib_tpu_torch.hfs import segment as thfs
from opencv_contrib_tpu_torch.ximgproc import segmentation as tseg
from opencv_contrib_tpu_torch.ximgproc import superpixels_x as tsp

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _two_tone(H=64, W=64, noise=0.01, seed=0):
    rng = np.random.default_rng(seed)
    img = np.zeros((H, W), np.float32)
    img[:, W // 2:] = 1.0
    return img + rng.normal(0, noise, (H, W)).astype(np.float32)


def _random(H=64, W=64, seed=7):
    return np.random.default_rng(seed).uniform(size=(H, W)).astype(np.float32)


def _object(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 0.05, (64, 64)).astype(np.float32)
    img[20:44, 12:36] += 0.9  # bright square object
    return img


IMAGES = {"two_tone": _two_tone(), "random": _random()}
# jitted once: the JAX version's eager vmap of the fit takes ~11 s to trace, the jit ~3 s to compile
J_ELLIPSES = jax.jit(functools.partial(jx.find_ellipses, max_ellipses=4, min_pts=20))


# --- transforms_x -----------------------------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["disc", "random"])
def test_radon_transform(case):
    ys, xs = np.mgrid[0:48, 0:48]
    img = (((ys - 23.5) ** 2 + (xs - 23.5) ** 2 < 15 ** 2).astype(np.float32) if case == "disc"
           else _random(32, 40, 3))
    ref = np.asarray(jx.radon_transform(jnp.asarray(img), n_angles=24))
    got = N(tx.radon_transform(T(img), n_angles=24))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    if case == "disc":  # tests/test_ximgproc3.py::test_radon_disc_invariance
        totals = got.sum(axis=1)
        assert totals.std() / totals.mean() < 0.02


@pytest.mark.parametrize("case", ["blob", "random"])
def test_peilin_normalization(case):
    ys, xs = np.mgrid[0:40, 0:40]
    img = (np.exp(-(((ys - 18) / 4.0) ** 2 + ((xs - 22) / 9.0) ** 2)).astype(np.float32) if case == "blob"
           else _random(40, 40, 4))
    ref = np.asarray(jx.peilin_normalization(jnp.asarray(img)))
    got = N(tx.peilin_normalization(T(img)))
    assert got.shape == (2, 3) and np.isfinite(got).all()
    f64 = _peilin_f64(img)
    d_port, d_ref = np.abs(got - f64).max(), np.abs(ref - f64).max()
    assert max(d_port, d_ref) < 1e-2, (d_port, d_ref)
    assert np.abs(got - ref).max() <= 2 * max(d_port, d_ref), (np.abs(got - ref).max(), d_port, d_ref)


def _peilin_f64(img):
    """Pei-Lin in float64, the same steps: the third moments cancel (a
    symmetric blob's are ~0), so the residual rotation follows the
    summation order in float32."""
    f = img.astype(np.float64)
    H, W = f.shape
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    m00 = f.sum() + 1e-9
    xc, yc = (f * xs).sum() / m00, (f * ys).sum() / m00
    dx, dy = xs - xc, ys - yc
    cov = np.array([[(f * dx * dx).sum(), (f * dx * dy).sum()], [(f * dx * dy).sum(), (f * dy * dy).sum()]]) / m00
    evals, evecs = np.linalg.eigh(cov)
    evals = np.maximum(evals, 1e-9)
    Wm = evecs @ np.diag(np.sqrt(np.sqrt(evals[0] * evals[1])) / np.sqrt(evals)) @ evecs.T
    wdx, wdy = Wm[0, 0] * dx + Wm[0, 1] * dy, Wm[1, 0] * dx + Wm[1, 1] * dy
    theta = np.arctan2((f * wdy ** 3).sum() + (f * wdx ** 2 * wdy).sum(),
                       (f * wdx ** 3).sum() + (f * wdx * wdy ** 2).sum())
    R = np.array([[np.cos(theta), np.sin(theta)], [-np.sin(theta), np.cos(theta)]])
    Minv = np.linalg.inv(R @ Wm)
    t = np.array([xc, yc]) - Minv @ np.array([(W - 1) / 2.0, (H - 1) / 2.0])
    return np.concatenate([Minv, t[:, None]], axis=1)


@pytest.mark.parametrize("seed", [4, 9])
def test_color_match_template(seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(40, 40, 3)).astype(np.float32)
    tpl = img[12:20, 18:26].copy()
    ref = np.asarray(jx.color_match_template(jnp.asarray(img), jnp.asarray(tpl)))
    got = N(tx.color_match_template(T(img), T(tpl)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * ref.max())
    assert np.unravel_index(got.argmax(), got.shape) == (12, 18)


@pytest.mark.parametrize("case", sorted(IMAGES))
def test_covariance_and_fast_morphology(case):
    img = IMAGES[case][:24, :28]
    np.testing.assert_allclose(N(tx.covariance_estimation(T(img), window=5)),
                               np.asarray(jx.covariance_estimation(jnp.asarray(img), window=5)), rtol=0, atol=1e-6)
    for name in ("erode_fast", "dilate_fast"):
        np.testing.assert_array_equal(N(getattr(tx, name)(T(img), 3, 4)),
                                      np.asarray(getattr(jx, name)(jnp.asarray(img), 3, 4)))


@pytest.mark.parametrize("case", sorted(IMAGES))
def test_scan_segment(case):
    img = IMAGES[case][:48]
    for n_sp, n_it in ((48, 3), (32, 4)):
        ref = np.asarray(jx.scan_segment(jnp.asarray(img), n_superpixels=n_sp, n_iters=n_it))
        got = N(tx.scan_segment(T(img), n_superpixels=n_sp, n_iters=n_it))
        np.testing.assert_array_equal(got, ref)


def _ring(cx=48.0, cy=44.0, a=30.0, b=18.0, H=96, W=96):
    ys, xs = np.mgrid[0:H, 0:W]
    r = ((xs - cx) / a) ** 2 + ((ys - cy) / b) ** 2
    return np.clip(1.0 - np.abs(r - 1.0) * 4.0, 0, 1).astype(np.float32)


def _rotated_ring():
    ys, xs = np.mgrid[0:96, 0:96]
    c, s = np.cos(0.5), np.sin(0.5)
    u, v = (xs - 50) * c + (ys - 46) * s, -(xs - 50) * s + (ys - 46) * c
    img = np.clip(1.0 - np.abs((u / 28.0) ** 2 + (v / 16.0) ** 2 - 1.0) * 4.0, 0, 1).astype(np.float32)
    return img + np.random.default_rng(5).normal(0, 0.02, img.shape).astype(np.float32)


@pytest.mark.parametrize("case", ["ring", "rotated_noisy"])
def test_find_ellipses(case):
    img = _ring() if case == "ring" else _rotated_ring()
    ej, sj = (np.asarray(v) for v in J_ELLIPSES(jnp.asarray(img)))
    ep, sp = (N(v) for v in tx.find_ellipses(T(img), max_ellipses=4, min_pts=20))
    np.testing.assert_allclose(sp, sj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ep[:, :4], ej[:, :4], rtol=0, atol=1e-3)
    d = np.remainder(ep[:, 4] - ej[:, 4] + np.pi / 2, np.pi) - np.pi / 2
    assert np.abs(d).max() < 1e-4, d
    best = ep[sp.argmax()]
    assert sp.max() > 0.5
    if case == "ring":  # tests/test_ximgproc3.py::TestFindEllipses
        assert abs(best[0] - 48) < 3 and abs(best[1] - 44) < 3
        assert abs(max(best[2], best[3]) - 30) < 4 and abs(min(best[2], best[3]) - 18) < 4


def test_conic_to_ellipse():
    # (x - 5)^2 / 16 + (y + 2)^2 / 4 = 1, and a rotated one
    coefs = [np.array([1 / 16, 0.0, 1 / 4, -10 / 16, 4 / 4, 25 / 16 + 4 / 4 - 1], np.float32),
             np.array([0.3, 0.2, 0.5, -0.4, 0.1, -2.0], np.float32)]
    for c in coefs:
        ref = np.asarray(jx.conic_to_ellipse(jnp.asarray(c)))
        got = N(tx.conic_to_ellipse(T(c)))
        np.testing.assert_allclose(got[:4], ref[:4], rtol=1e-5, atol=1e-5)
        assert abs(np.remainder(got[4] - ref[4] + np.pi / 2, np.pi) - np.pi / 2) < 1e-5


# --- slic, SEEDS, LSC -------------------------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(IMAGES))
def test_slic(case):
    img = IMAGES[case]
    for grid, comp in ((4, 0.5), (4, 100.0), (6, 10.0)):
        (lj, cj), (lp, cp) = jx.slic(jnp.asarray(img), grid=grid, compactness=comp), tx.slic(T(img), grid=grid,
                                                                                              compactness=comp)
        np.testing.assert_array_equal(N(lp), np.asarray(lj))
        np.testing.assert_allclose(N(cp), np.asarray(cj), rtol=0, atol=1e-4)
    if case == "two_tone":  # tests/test_ximgproc.py::TestSlic
        lab = N(tx.slic(T(img), grid=4, compactness=0.5)[0])
        assert not set(np.unique(lab[:, :30])) & set(np.unique(lab[:, 34:]))


@pytest.mark.parametrize("case", sorted(IMAGES))
def test_seeds_and_lsc(case):
    img = IMAGES[case]
    np.testing.assert_array_equal(N(tsp.seeds(T(img), grid=8, n_iters=12)),
                                  np.asarray(jsp.seeds(jnp.asarray(img), grid=8, n_iters=12)))
    (lj, cj), (lp, cp) = jsp.lsc(jnp.asarray(img), grid=8), tsp.lsc(T(img), grid=8)
    np.testing.assert_array_equal(N(lp), np.asarray(lj))
    np.testing.assert_allclose(N(cp), np.asarray(cj), rtol=0, atol=1e-4)


# --- HFS --------------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(IMAGES))
def test_hfs_stages(case):
    img = IMAGES[case]
    labels = np.asarray(jx.slic(jnp.asarray(img), grid=8, n_iters=6)[0])
    mj, cj = jhfs.region_features(jnp.asarray(img), jnp.asarray(labels), 64)
    mp, cp = thfs.region_features(T(img), T(labels), 64)
    np.testing.assert_array_equal(N(mp), np.asarray(mj))
    np.testing.assert_array_equal(N(cp), np.asarray(cj))
    (Lj, Gj), (Lp, Gp) = jhfs.region_adjacency(jnp.asarray(img), jnp.asarray(labels), 64), thfs.region_adjacency(
        T(img), T(labels), 64)
    np.testing.assert_array_equal(N(Lp), np.asarray(Lj))
    np.testing.assert_allclose(N(Gp), np.asarray(Gj), rtol=1e-6, atol=0)
    rng = np.random.default_rng(2)
    edges = np.stack(np.triu_indices(20, 1), 1)[rng.permutation(190)[:60]]
    w = rng.uniform(0, 1, 60).round(2)  # ties among the weights
    np.testing.assert_array_equal(thfs._merge(edges, w, np.ones(20), 20, 0.4),
                                  jhfs._merge(edges, w, np.ones(20), 20, 0.4))


@pytest.mark.parametrize("case", ["fixture", "random"])
def test_hfs_segment(case):
    rng = np.random.default_rng(0)
    if case == "fixture":  # tests/test_detect_breadth.py::TestHfs
        img = np.zeros((96, 96), np.float32)
        img[:, 48:] = 1.0
        img += rng.normal(0, 0.01, img.shape).astype(np.float32)
    else:
        img = np.kron(rng.uniform(size=(6, 6)), np.ones((16, 16))).astype(np.float32)
    ref = jhfs.hfs_segment(img, grid=8, seg_thresh1=0.3, seg_thresh2=0.6)
    got = thfs.hfs_segment(T(img), grid=8, seg_thresh1=0.3, seg_thresh2=0.6)
    np.testing.assert_array_equal(got, ref)
    if case == "fixture":
        assert len(np.unique(got)) <= 4
        left, right = np.bincount(got[:, :40].reshape(-1)).argmax(), np.bincount(got[:, 56:].reshape(-1)).argmax()
        assert left != right and (got[:, :40] == left).mean() > 0.9 and (got[:, 56:] == right).mean() > 0.9


# --- graph segmentation, selective search, EdgeBoxes ------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(IMAGES))
def test_graph_segment(case):
    img = IMAGES[case][:40, :48]
    for k in (0.5, 0.3):
        np.testing.assert_array_equal(tseg.graph_segment(T(img), k=k), jseg.graph_segment(img, k=k))
    if case == "two_tone":  # tests/test_ximgproc2.py::test_graph_segment_two_regions
        seg = tseg.graph_segment(T(_two_tone()), k=0.5)
        assert len(np.unique(seg)) <= 6
        assert np.bincount(seg[:, :24].reshape(-1)).argmax() != np.bincount(seg[:, 40:].reshape(-1)).argmax()


@pytest.mark.parametrize("seed", [0, 3])
def test_selective_search(seed):
    img = _object(seed)
    ref = jseg.selective_search(img, base_k=0.5, max_proposals=48)
    got = tseg.selective_search(T(img), base_k=0.5, max_proposals=48)
    np.testing.assert_array_equal(got, ref)
    labels = jseg.graph_segment(img, k=0.5)
    n = int(labels.max()) + 1
    dj, dp = jseg._region_descriptors(img, labels, n), tseg._region_descriptors(T(img), labels, n)
    for k in dj:
        np.testing.assert_allclose(dp[k], dj[k], rtol=1e-6, atol=0, err_msg=k)
    gt = np.array([20, 12, 43, 35])  # tests/test_ximgproc2.py::test_selective_search_covers_object

    def iou(p):
        y0, x0, y1, x1 = max(p[0], gt[0]), max(p[1], gt[1]), min(p[2], gt[2]), min(p[3], gt[3])
        inter = max(y1 - y0 + 1, 0) * max(x1 - x0 + 1, 0)
        a1, a2 = (p[2] - p[0] + 1) * (p[3] - p[1] + 1), (gt[2] - gt[0] + 1) * (gt[3] - gt[1] + 1)
        return inter / (a1 + a2 - inter)

    assert max(iou(p) for p in got) > 0.5


@pytest.mark.parametrize("seed", [1, 6])
def test_edge_boxes(seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 0.02, (64, 64)).astype(np.float32)
    img[20:44, 12:36] += 0.9
    boxes = np.array([[18, 10, 45, 37], [5, 40, 30, 60], [28, 20, 36, 28], [0, 0, 63, 63], [2, 2, 8, 8]])
    ref = jseg.edge_boxes(img, boxes)
    got = tseg.edge_boxes(T(img), boxes)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-9)
    assert got[0] > got[1] and got[0] > got[2]  # tests/test_ximgproc2.py::test_edge_boxes_prefers_tight_box
    emap = np.abs(np.gradient(img)[0]).astype(np.float32)
    np.testing.assert_array_equal(tseg.edge_boxes(T(img), boxes, edge_map=T(emap)),
                                  jseg.edge_boxes(img, boxes, edge_map=emap))
