"""Parity of the port's edge, line and shape detectors (opencv_contrib_tpu_torch
.ximgproc: edges, edge_forest, edline, hough_mser; opencv_contrib_tpu_torch
.text.swt) and of `entry.ximgproc_frame` with the JAX package on the CPU.
The inputs are the JAX tests' fixtures (tests/test_ximgproc*.py,
tests/test_text.py) and second seeded inputs, the same numpy arrays through
both packages.

Tolerances:
- edge and label masks, stroke widths, text boxes, thinning, Canny, MSER,
  the ED lines and circles on noisy inputs, the Hough circles found: equal
  (circle radii within 1e-5: the radii are a linspace, rounded apart); the
  ED moments: the port's are float64 sums rounded to float32, equal to the
  JAX version's float32 sums at these sizes (integers below 2^24) and to a
  float64 numpy sum at 240 x 320, where float32 sums are not exact;
- on noise-free steps the NMS compares two equal magnitudes (the rows on
  either side of the step): the JAX version's jit fuses the blur's
  multiply-adds and breaks the tie by an ulp, the port keeps both rows. The
  edge masks may differ only where a float64 recompute of the magnitudes
  (`_edges_f64`) finds such a tie (1e-6 relative), and the port's ED lines
  pass the JAX test's gates;
- the Hough line accumulator: each angle's votes equal in total and at
  least 98% of the votes in the same (angle, rho) cell (the angles are a
  linspace that XLA rounds apart by an ulp, which moves a vote lying on a
  rho bin's edge to the next bin), the peak cell equal;
- the Hough circle accumulator: at least 99% of the votes in the same cell;
- structured_edges_lite: 1e-6;
- the learned edge map: `train` from the JAX package's initial draws
  (computed here with jax.random, carried by interop.edge_forest_params)
  for 20 Adam steps on 4 images: every parameter within 1e-6; the maps of
  the JAX-trained parameters within 1e-6, edges_nms equal;
- entry.ximgproc_frame: each method equal to its function called with the
  METHODS settings, and FGS, SLIC, Canny, HFS and SWT at 120 x 160 against
  the JAX functions on the same gray frame: FGS within 1e-5 of its range;
  HFS's segment maps agreeing on >= 99.9% of the pixels, every pixel that
  differs on a segment boundary of both (its SLIC labels, 6 iterations at
  grid 8, flip at near-ties of two neighbouring centres, which the JAX
  version's one-hot dot and the port's ordered sums round apart); the rest
  equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import correlate1d

from opencv_contrib_tpu import ximgproc as jx
from opencv_contrib_tpu.text import swt as jswt
from opencv_contrib_tpu.ximgproc import edge_forest as jef
from opencv_contrib_tpu.ximgproc import edline as jed
from opencv_contrib_tpu.ximgproc import hough_mser as jhm
from opencv_contrib_tpu_torch import entry, interop
from opencv_contrib_tpu_torch import ximgproc as tx
from opencv_contrib_tpu_torch.core.color import rgb_to_gray
from opencv_contrib_tpu_torch.ops.ccl import connected_components
from opencv_contrib_tpu_torch.text import swt as tswt
from opencv_contrib_tpu_torch.ximgproc import edge_forest as tef
from opencv_contrib_tpu_torch.ximgproc import edline as ted
from opencv_contrib_tpu_torch.ximgproc import hough_mser as thm

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _glyph_image(shape=(96, 160), stroke=3):
    img = np.ones(shape, np.float32)
    for x in (30, 50, 70, 90):
        img[30:66, x:x + stroke] = 0.0
    return img


def _smooth_random(H=64, W=64, seed=3):
    rng = np.random.default_rng(seed)
    img = np.kron(rng.uniform(size=(H // 8, W // 8)), np.ones((8, 8))).astype(np.float32)
    return img + rng.normal(0, 0.02, (H, W)).astype(np.float32)


def _step(horizontal: bool, noise: float = 0.0):
    img = np.zeros((64, 64), np.float32)
    if horizontal:
        img[:20, :] = 1.0
    else:
        img[:, 40:] = 1.0
    return img + np.random.default_rng(8).normal(0, noise, img.shape).astype(np.float32)


def _circle_and_line(noise: float = 0.0):
    yy, xx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    img = ((yy - 32) ** 2 + (xx - 32) ** 2 <= 15 ** 2).astype(np.float32)
    img[2:4, 4:60] = 1.0
    return img + np.random.default_rng(9).normal(0, noise, img.shape).astype(np.float32)


def _edges_f64(img, low=0.08, high=0.2):
    """text.swt._edges' NMS in float64 (the blur's reflect border is scipy's
    'mirror'); returns the NMS margins min(mag - n0, mag - n1)
    over the magnitude, whose ~0 marks a tie, and the magnitude."""
    x = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-x * x / 2.0)
    k /= k.sum()
    g = correlate1d(correlate1d(img.astype(np.float64), k, 0, mode="mirror"), k, 1, mode="mirror")
    gy = (np.roll(g, -1, 0) - np.roll(g, 1, 0)) * 0.5
    gx = (np.roll(g, -1, 1) - np.roll(g, 1, 1)) * 0.5
    gy[0], gy[-1] = g[1] - g[0], g[-1] - g[-2]
    gx[:, 0], gx[:, -1] = g[:, 1] - g[:, 0], g[:, -1] - g[:, -2]
    mag = np.sqrt(gx * gx + gy * gy)
    d = np.round(np.arctan2(gy, gx) / (np.pi / 4)).astype(int) % 4
    H, W = img.shape
    p = np.pad(mag, 1)

    def nb(dy, dx):
        return p[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    n0 = np.select([d == 0, d == 1, d == 2, d == 3], [nb(0, 1), nb(1, 1), nb(1, 0), nb(1, -1)])
    n1 = np.select([d == 0, d == 1, d == 2, d == 3], [nb(0, -1), nb(-1, -1), nb(-1, 0), nb(-1, 1)])
    margin = np.minimum(mag - n0, mag - n1) / np.maximum(mag, 1e-12)
    return margin, mag


# the JAX functions that the JAX package calls eagerly, jitted once (a compile a shape, not an op-by-op trace)
J_SEL = jax.jit(jx.structured_edges_lite)
J_EDGES = jax.jit(jef.structured_edges)
J_NMS = jax.jit(jef.edges_nms)


# --- edges ------------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["step", "random"])
def test_structured_edges_lite_and_thinning(case):
    img = _step(False, 0.02) if case == "step" else _smooth_random()
    np.testing.assert_allclose(N(tx.structured_edges_lite(T(img))), np.asarray(J_SEL(jnp.asarray(img))), rtol=0,
                               atol=1e-6)
    mask = np.zeros((32, 32), bool)
    mask[10:16, 4:28] = True
    for m in (mask, _smooth_random(32, 32) > 0.5):
        np.testing.assert_array_equal(N(tx.thinning(T(m), n_iters=10)), np.asarray(jx.thinning(jnp.asarray(m),
                                                                                               n_iters=10)))
    out = N(tx.thinning(T(mask), n_iters=10))  # tests/test_ximgproc.py::test_thinning_reduces_width
    assert out[:, 10:22].sum(axis=0).max() <= 2 and out.sum() > 5


@pytest.mark.parametrize("case", ["vertical_line", "random"])
def test_fast_hough_lines(case):
    if case == "vertical_line":
        mask = np.zeros((64, 64), bool)
        mask[:, 20] = True
    else:
        mask = np.random.default_rng(4).uniform(size=(48, 64)) > 0.97
    aj, thj, rhj = (np.asarray(v) for v in jx.fast_hough_lines(jnp.asarray(mask)))
    ap, thp, rhp = (N(v) for v in tx.fast_hough_lines(T(mask)))
    np.testing.assert_allclose(thp, thj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(rhp, rhj, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ap.sum(1), aj.sum(1))
    assert np.minimum(ap, aj).sum() >= 0.98 * aj.sum()
    if case == "vertical_line":  # tests/test_ximgproc.py::test_hough_finds_line
        assert np.unravel_index(ap.argmax(), ap.shape) == np.unravel_index(aj.argmax(), aj.shape)
        ai, ri = np.unravel_index(ap.argmax(), ap.shape)
        assert abs(float(thp[ai])) < 0.1 or abs(float(thp[ai]) - np.pi) < 0.1
        assert abs(abs(float(rhp[ri])) - 20) < 3


# --- the learned edge map ---------------------------------------------------------------------------------------


def _jax_initial_params(seed=0, hidden=32):
    """The JAX version's initial draws (edge_forest.train:122-128)."""
    D = 7 * len(jef._OFFSETS)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return {"W1": np.asarray(jax.random.normal(k1, (D, hidden)) * np.sqrt(2.0 / D)),
            "b1": np.zeros(hidden, np.float32),
            "W2": np.asarray(jax.random.normal(k2, (hidden, 1)) * np.sqrt(2.0 / hidden)),
            "b2": np.zeros(1, np.float32)}


@pytest.fixture(scope="module")
def trained():
    return jef.train(n_images=4, steps=20)


def test_edge_forest_train_from_the_jax_draws(trained):
    init = _jax_initial_params()
    got = tef.train(n_images=4, steps=20, init=interop.edge_forest_params(init))
    for k in ("W1", "b1", "W2", "b2"):
        moved = np.abs(np.asarray(trained[k]) - init[k]).max()
        assert moved > 1e-2, (k, moved)  # 20 steps of lr 3e-3 move every parameter
        np.testing.assert_allclose(N(got[k]), np.asarray(trained[k]), rtol=0, atol=1e-6, err_msg=k)
    # the default draws: a seeded generator, the same on a rerun
    a, b = tef.init_params(63, 32, seed=1), tef.init_params(63, 32, seed=1)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("seed", [99, 5])
def test_edge_forest_maps_with_the_jax_parameters(trained, seed):
    rng = np.random.default_rng(seed)
    im, gt = jef._synthetic_scene(rng)
    im2, gt2 = tef._synthetic_scene(np.random.default_rng(seed))
    np.testing.assert_array_equal(im2, im)
    np.testing.assert_array_equal(gt2, gt)
    params = interop.edge_forest_params(trained)
    ej = np.asarray(J_EDGES(jnp.asarray(im), trained))
    ep = N(tef.structured_edges(T(im), params))
    np.testing.assert_allclose(ep, ej, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(N(tef.edges_nms(T(ej), T(im))), np.asarray(J_NMS(jnp.asarray(ej), jnp.asarray(im))))
    with pytest.raises(ValueError):
        interop.edge_forest_params({"W1": trained["W1"]})


# --- SWT --------------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["glyphs", "random"])
def test_swt(case):
    img = _glyph_image(stroke=4) if case == "glyphs" else np.clip(_smooth_random(96, 160), 0, 1)
    ej = [np.asarray(v) for v in jax.jit(jswt._edges)(jnp.asarray(img))]
    ep = [N(v) for v in tswt._edges(T(img))]
    np.testing.assert_array_equal(ep[0], ej[0])
    m = N(tswt.stroke_width_map(T(img), max_width=16))
    np.testing.assert_array_equal(m, np.asarray(jswt.stroke_width_map(jnp.asarray(img), max_width=16)))
    bj, lj = jswt.detect_text(img, max_width=16)
    bp, lp = tswt.detect_text(T(img), max_width=16)
    np.testing.assert_array_equal(bp, bj)
    np.testing.assert_array_equal(lp, lj)
    if case == "glyphs":  # tests/test_text.py::TestSwt
        vals = m[40:60, 50:54][m[40:60, 50:54] > 0]
        assert vals.size > 10 and 2.0 <= np.median(vals) <= 6.0
        bp, lp = tswt.detect_text(T(_glyph_image()), max_width=16)
        b = bp[np.argmax(bp[:, 3] - bp[:, 1])]
        assert lp.shape[0] >= 3 and b[0] <= 32 and b[2] >= 62 and b[1] <= 33 and b[3] >= 88
        assert tswt.detect_text(T(np.ones((64, 64), np.float32)))[0].shape[0] == 0


# --- ED lines and circles ---------------------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["noisy_steps", "random"])
def test_ed_lines_and_circles(case):
    imgs = ([_step(True, 0.01), _step(False, 0.01), _circle_and_line(0.01)] if case == "noisy_steps"
            else [_smooth_random(), _smooth_random(seed=12)])
    for img in imgs:
        mj = jed._component_moments(jnp.asarray(img))
        mp = ted._component_moments(T(img))
        for k in mj:
            np.testing.assert_array_equal(N(mp[k]), np.asarray(mj[k]), err_msg=k)
        np.testing.assert_array_equal(ted.ed_lines(T(img), min_length=20), jed.ed_lines(img, min_length=20))
        np.testing.assert_array_equal(ted.ed_circles(T(img), min_points=16), jed.ed_circles(img, min_points=16))


def test_ed_moments_are_rounded_float64_sums():
    """The port sums its moments in float64 and rounds them to float32 (the
    JAX version sums in float32, which at 240 x 320 already loses the low
    bits of y^3 sums): each moment is the float64 sum over the port's own
    components, rounded."""
    f = entry.structure_frame(240, 320)
    img = rgb_to_gray(T(f.rgb))
    m = ted._component_moments(img)
    labels, _ = connected_components(tswt._edges(img)[0], connectivity=8)
    lab = N(labels).reshape(-1)
    roots = np.flatnonzero(lab == np.arange(lab.size))  # raster order: component k is the k-th root
    cid = np.searchsorted(roots, lab[lab >= 0])
    H, W = img.shape
    y, x = (v.reshape(-1)[lab >= 0].astype(np.float64) for v in np.mgrid[0:H, 0:W])
    r2 = y * y + x * x
    vals = {"n": np.ones_like(y), "sy": y, "sx": x, "syy": y * y, "sxx": x * x, "sxy": x * y, "syr": y * r2,
            "sxr": x * r2, "srr": r2}
    n = min(len(roots), 256)
    for k, v in vals.items():  # integer moments: float64 sums are exact in any order
        ref = np.bincount(cid, weights=v, minlength=n)[:n].astype(np.float32)
        np.testing.assert_array_equal(N(m[k])[:n], ref, err_msg=k)


def test_ed_lines_noise_free_ties():
    """tests/test_ximgproc2.py::TestEdPrimitives on its noise-free fixtures:
    the port passes the gates, and its edge mask parts from the JAX one only
    at float64 ties of the NMS."""
    for horizontal in (True, False):
        img = _step(horizontal)
        ej = np.asarray(jax.jit(jswt._edges)(jnp.asarray(img))[0])
        ep = N(tswt._edges(T(img))[0])
        margin, mag = _edges_f64(img)
        differ = ej != ep
        assert (np.abs(margin[differ]) < 1e-6).all() and (mag[differ] > 0.08).all()
        lines = ted.ed_lines(T(img), min_length=20)
        dy, dx = np.abs(lines[:, 2] - lines[:, 0]), np.abs(lines[:, 3] - lines[:, 1])
        if horizontal:
            assert (dx > 5 * dy).any() and (np.abs((lines[:, 0] + lines[:, 2]) / 2 - 19.5) < 2.0).any()
        else:
            assert (dy > 5 * dx).any() and (lines[:, 4] < 1.0).all()
    circles = ted.ed_circles(T(_circle_and_line()), min_points=16)
    np.testing.assert_array_equal(circles, jed.ed_circles(_circle_and_line(), min_points=16))
    c = circles[np.argmin(np.abs(circles[:, 2] - 15.0))]
    assert abs(c[0] - 32) < 2 and abs(c[1] - 32) < 2 and abs(c[2] - 15.0) < 2.0
    assert not ((np.abs(circles[:, 0] - 3) < 3) & (circles[:, 2] > 20)).any()


# --- Canny, Hough circles, MSER ---------------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["circle", "random"])
def test_canny_hough_circles_mser(case):
    img = _circle_and_line(0.01) if case == "circle" else _smooth_random()
    np.testing.assert_array_equal(N(thm.canny(T(img))), np.asarray(jhm.canny(jnp.asarray(img))))
    np.testing.assert_array_equal(N(thm.canny(T(img), 0.04, 0.12)), np.asarray(jhm.canny(jnp.asarray(img), 0.04,
                                                                                        0.12)))
    aj, rj = (np.asarray(v) for v in jhm.hough_circles_accumulator(jnp.asarray(img)))
    ap, rp = (N(v) for v in thm.hough_circles_accumulator(T(img)))
    np.testing.assert_allclose(rp, rj, rtol=0, atol=1e-5)
    assert ap.sum() == aj.sum() and np.minimum(ap, aj).sum() >= 0.99 * aj.sum()
    cj, cp = jhm.hough_circles(img), thm.hough_circles(T(img))
    assert cp.shape == cj.shape
    np.testing.assert_array_equal(cp[:, :2], cj[:, :2])
    np.testing.assert_allclose(cp[:, 2], cj[:, 2], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(thm.mser(T(img)), jhm.mser(img))
    glyphs = _glyph_image(stroke=4)
    np.testing.assert_array_equal(thm.mser(T(glyphs), n_levels=8), jhm.mser(glyphs, n_levels=8))


# --- entry.ximgproc_frame ---------------------------------------------------------------------------------------


SMALL = (120, 160)


@pytest.fixture(scope="module")
def small_frame():
    return entry.structure_frame(*SMALL)


def test_structure_frame_layout():
    f = entry.structure_frame()
    L = f.layout
    assert f.rgb.shape == (480, 640, 3) and f.rgb.dtype == np.float32 and 0 <= f.rgb.min() and f.rgb.max() <= 1
    g = N(rgb_to_gray(T(f.rgb)))
    y0, x0, y1, x1 = L["box"]
    assert g[y0:y1 + 1, x0:x1 + 1].mean() > 0.9 and g[y0 - 3, x0:x1].mean() < 0.15
    assert g[L["band"] - 3].mean() < 0.15 and g[L["band"] + 3, :300].mean() > 0.7
    cy, cx, r = L["circle"]
    assert g[int(cy), int(cx)] > 0.85 and g[int(cy), int(cx + r + 3)] < 0.15
    gy0, gy1, gxs, stroke = L["glyphs"]
    assert all(g[(gy0 + gy1) // 2, gx:gx + stroke].max() < 0.05 for gx in gxs)
    dl, dr = f.disparity
    assert (dl == 0).sum() > 0 and dl[L["band"] - 5, 600] == 8.0 and dr.max() > 20
    np.testing.assert_array_equal(entry.structure_frame().rgb, f.rgb)  # seeded


def test_ximgproc_frame_dispatch(small_frame):
    """Every method runs on the small frame and equals its function called
    with the METHODS settings; the host-answer methods answer numpy."""
    f = small_frame
    gray = rgb_to_gray(T(f.rgb))
    frame = entry._XFrame(gray, T(f.rgb), T(f.disparity), f.layout)
    tef._DEFAULT_PARAMS["cpu"] = tef.train(n_images=2, steps=3)  # keep the CPU test short
    try:
        for name, (fn, settings) in entry.METHODS.items():
            got = entry.ximgproc_frame(f.rgb, name, device="cpu", disparity=f.disparity)
            ref = fn(frame, **dict(settings))
            for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, ref))):
                a, b = (N(v) if isinstance(v, torch.Tensor) else np.asarray(v) for v in (a, b))
                np.testing.assert_array_equal(a, b, err_msg=name)
            if name in ("graph_segment", "selective_search", "detect_text", "ed_lines", "ed_circles", "mser",
                        "hough_circles", "hfs_segment", "edge_boxes"):
                assert all(isinstance(v, np.ndarray) for v in (got if isinstance(got, tuple) else (got,))), name
    finally:
        tef._DEFAULT_PARAMS.pop("cpu", None)
    with pytest.raises(ValueError, match="method must be one of"):
        entry.ximgproc_frame(f.rgb, "no_such", device="cpu")
    with pytest.raises(ValueError, match="disparity"):
        entry.ximgproc_frame(f.rgb, "disparity_wls_filter", device="cpu")


def test_ximgproc_frame_needs_a_card_for_cuda(monkeypatch, small_frame):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.ximgproc_frame(small_frame.rgb, "canny")


def _on_boundary(lab):
    b = np.zeros(lab.shape, bool)
    b[:, 1:] |= lab[:, 1:] != lab[:, :-1]
    b[:, :-1] |= lab[:, 1:] != lab[:, :-1]
    b[1:] |= lab[1:] != lab[:-1]
    b[:-1] |= lab[1:] != lab[:-1]
    return b


def _partitions_agree(a, b, share=0.999):
    """Two segment maps agree on >= share of the pixels, and every pixel
    that differs lies on a segment boundary of both maps."""
    differ = a != b
    assert differ.mean() <= 1 - share, differ.mean()
    assert (_on_boundary(a)[differ] & _on_boundary(b)[differ]).all()


def test_ximgproc_frame_against_jax(small_frame):
    f = small_frame
    gray = N(rgb_to_gray(T(f.rgb)))
    jg = jnp.asarray(gray)
    got = N(entry.ximgproc_frame(f.rgb, "fast_global_smoother", device="cpu"))
    ref = np.asarray(jx.fast_global_smoother(jg, jg, lam=64.0, sigma_color=0.1))
    assert np.abs(got - ref).max() <= 1e-5 * np.ptp(ref)
    labels, _ = entry.ximgproc_frame(f.rgb, "slic", device="cpu")
    np.testing.assert_array_equal(N(labels), np.asarray(jx.slic(jg, grid=4, compactness=0.5)[0]))
    np.testing.assert_array_equal(N(entry.ximgproc_frame(f.rgb, "canny", device="cpu")),
                                  np.asarray(jax.jit(functools.partial(jhm.canny))(jg)))
    from opencv_contrib_tpu.hfs import segment as jhfs

    _partitions_agree(entry.ximgproc_frame(f.rgb, "hfs_segment", device="cpu"),
                      jhfs.hfs_segment(gray, grid=8, seg_thresh1=0.3, seg_thresh2=0.6))
    bp, lp = entry.ximgproc_frame(f.rgb, "detect_text", device="cpu")
    bj, lj = jswt.detect_text(gray, max_width=16)
    np.testing.assert_array_equal(bp, bj)
    np.testing.assert_array_equal(lp, lj)
