"""Parity of the port's xfeatures2d breadth (opencv_contrib_tpu_torch.features:
the rest of describe / detect / match, detect_x, describe_x, pct, learned,
and entry.features_x) with the JAX package on the CPU. The inputs are the
same numpy arrays from a seed; frames that reach a summed-area table are
integers (ROADMAP rule 2).

Tolerances:
- bits equal: pack_bits in its uint32 view, unpack_to_signs, the box-pair
  and BRIEF patterns, the GMS and LOGOS keep-masks, match_pairs_batched,
  FAST, keypoint positions and scales of Harris, Star, MSD and
  Harris-Laplace, TBMR's level slots; Fast-Hessian's subpixel positions
  within 1e-4 px and its interpolated scales within 1e-5 relative;
- binary descriptors (boxes, BRIEF, FREAK, LATCH, BoostDesc): bit agreement
  >= 0.999;
- DAISY, VGG, the pooled raw feature: rtol 1e-4 (atol 1e-6);
- LUCID: ranks equal, but for the order of values within 1e-6 (relative) of
  each other: the JAX version's jit fuses the box blur into multiply-adds,
  whose last bit can part or join near ties (1.2e-7 apart at most here);
- detector responses: rtol 1e-4; Harris-Laplace's Haar orientation within
  0.02 rad (the orientation histogram's parabolic peak moves with the
  responses' low bits);
- affine_adapt: rtol 1e-4;
- TBMR: the region count equal, centres within 1e-2 px, axes within 2%;
- _component_moments: against a float64 numpy recompute of the same moments,
  area and centres within 1e-4 px, central second moments within 1e-4 of
  their scale (the raw second moments reach ~1e4 here, ~7e10 at VGA, and
  cancel);
- PCT: centroids, weights and SQFD within 1e-4;
- train_projection on the JAX package's draws (replayed through a spy): W
  within 1e-3 column by column up to sign (eigh leaves each sign free).
The JAX tests' own gates (tests/test_features.py, tests/test_features_x.py,
tests/test_breadth7.py, tests/test_breadth8.py) run through the port too."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu.features import describe as jdesc
from opencv_contrib_tpu.features import describe_x as jdx
from opencv_contrib_tpu.features import detect as jdet
from opencv_contrib_tpu.features import detect_x as jdetx
from opencv_contrib_tpu.features import keypoints as jkp
from opencv_contrib_tpu.features import learned as jlearn
from opencv_contrib_tpu.features import match as jmatch
from opencv_contrib_tpu.features import pct as jpct
from opencv_contrib_tpu.ops import filters as jfilt
from opencv_contrib_tpu.ops import integral as jinteg
from opencv_contrib_tpu_torch import entry, features, interop
from opencv_contrib_tpu_torch.features import describe as tdesc
from opencv_contrib_tpu_torch.features import describe_x as tdx
from opencv_contrib_tpu_torch.features import detect as tdet
from opencv_contrib_tpu_torch.features import detect_x as tdetx
from opencv_contrib_tpu_torch.features import keypoints as tkp
from opencv_contrib_tpu_torch.features import learned as tlearn
from opencv_contrib_tpu_torch.features import match as tmatch
from opencv_contrib_tpu_torch.features import pct as tpct

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _blob_image(centers, sigmas, shape=(128, 128)):
    H, W = shape
    y, x = np.mgrid[0:H, 0:W]
    img = np.zeros(shape, np.float32)
    for (cy, cx), s in zip(centers, sigmas):
        img += 200.0 * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * s * s))
    return img


@pytest.fixture(scope="module")
def textured():
    """An integer frame of blurred noise and Fast-Hessian keypoints on it,
    from the JAX package (the port gets them through interop)."""
    rng = np.random.default_rng(0)
    img = np.round(rng.uniform(0, 255, (96, 128))).astype(np.float32)
    img = np.round(np.asarray(jfilt.gaussian_blur(jnp.asarray(img), 2.0))).astype(np.float32)
    kj = jdet.fast_hessian(jnp.asarray(img), max_keypoints=48, threshold=5.0)
    return img, kj, interop.from_numpy(kj)


@pytest.fixture(scope="module")
def pair():
    """entry.feature_pair at tests/test_features_x.py::texture_pair's size,
    with Fast-Hessian keypoints from the port."""
    img1, img2, fwd = entry.feature_pair(240, 320)
    k1 = tdet.fast_hessian(T(img1), max_keypoints=128, threshold=20.0)
    k2 = tdet.fast_hessian(T(img2), max_keypoints=128, threshold=20.0)
    return T(img1), T(img2), k1, k2, fwd


def _inlier_rate(k1, k2, m, fwd, tol=3.0):
    v = N(m.valid)
    if v.sum() == 0:
        return 0.0, 0
    p1 = np.stack([N(k1.x), N(k1.y)], 1)
    mapped = p1 @ fwd[:, :2].T + fwd[:, 2]
    t = N(m.train_idx).astype(np.int64)
    err = np.hypot(mapped[:, 0] - N(k2.x)[t], mapped[:, 1] - N(k2.y)[t])
    return float((err[v] < tol).mean()), int(v.sum())


def _bit_agreement(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


# --- describe ---------------------------------------------------------------------------


def test_pack_bits_uint32_view(rng):
    bits = rng.uniform(size=(5, 3, 96)) > 0.5
    bits[0, 0, 31] = bits[0, 0, 63] = True  # the sign bit of a word
    ref = np.asarray(jdesc.pack_bits(jnp.asarray(bits)))
    out = N(tdesc.pack_bits(T(bits)))
    assert out.dtype == np.int32 and ref.dtype == np.uint32
    np.testing.assert_array_equal(out.view(np.uint32), ref)
    np.testing.assert_array_equal(N(tdesc.unpack_to_signs(T(out), 96)),
                                  np.asarray(jdesc.unpack_to_signs(jnp.asarray(ref), 96)))
    with pytest.raises(ValueError):
        tdesc.pack_bits(T(bits[..., :40]))


def test_sample_patterns_equal():
    for a, b in zip(jdesc.make_box_pairs(256), tdesc.make_box_pairs(256)):
        np.testing.assert_array_equal(N(b), np.asarray(a))
    np.testing.assert_array_equal(tdx._latch_triplets(64, 12.0), jdx._latch_triplets(64, 12.0))
    np.testing.assert_array_equal(tdx._freak_pairs(*tdx._freak_pattern()[:1], 512),
                                  jdx._freak_pairs(*jdx._freak_pattern()[:1], 512))


@pytest.mark.parametrize("name", ["boxes", "brief", "freak", "latch"])
def test_binary_descriptors(textured, name):
    img, kj, kt = textured
    fj, ft = {"boxes": (jdesc.binary_boxes_describe, tdesc.binary_boxes_describe),
              "brief": (jdesc.brief_describe, tdesc.brief_describe),
              "freak": (jdx.freak_describe, tdx.freak_describe),
              "latch": (jdx.latch_describe, tdx.latch_describe)}[name]
    rj, rt = fj(jnp.asarray(img), kj), ft(T(img), kt)
    assert _bit_agreement(N(rt[0]).view(np.uint32), rj[0]) >= 0.999
    assert _bit_agreement(N(rt[1]), rj[1]) >= 0.999
    # the packed words and the signs carry the same bits
    v = N(kt.valid)[:, None]
    np.testing.assert_array_equal(N(tdesc.unpack_to_signs(rt[0], rt[1].shape[1])) * v, N(rt[1]))
    if name == "freak":
        np.testing.assert_allclose(N(rt[2]), np.asarray(rj[2]), atol=1e-3)


def test_daisy_and_orientation_maps(textured):
    img, kj, kt = textured
    np.testing.assert_allclose(N(tdesc._orientation_maps(T(img), 8)),
                               np.asarray(jdesc._orientation_maps(jnp.asarray(img), 8)), rtol=1e-4, atol=1e-4)
    ref = np.asarray(jdesc.daisy_describe(jnp.asarray(img), kj))
    out = N(tdesc.daisy_describe(T(img), kt))
    assert out.shape == ref.shape == (48, 200)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-6)


def _lucid_values(img, kps, patch=7):
    """The port's blurred patch values that LUCID ranks."""
    off = torch.arange(-(patch // 2), patch // 2 + 1, dtype=torch.float32)
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    g = tdet.filters.box_filter(T(img), 2)
    return N(tdx.sample_bilinear(g, kps.y[:, None] + oy.reshape(-1)[None], kps.x[:, None] + ox.reshape(-1)[None]))


def _assert_ranks_agree(out, ref, vals, rel=1e-6):
    """Ranks equal, but for pairs of values within rel of each other."""
    P = out.shape[1]
    ro, rr = np.round(out * (P - 1)), np.round(ref * (P - 1))
    for i in range(out.shape[0]):
        flipped = np.sign(ro[i][:, None] - ro[i][None]) != np.sign(rr[i][:, None] - rr[i][None])
        if flipped.any():
            gap = np.abs(vals[i][:, None] - vals[i][None])[flipped].max()
            assert gap <= rel * np.abs(vals[i]).max(), (i, gap)


def test_lucid_ranks_equal(textured):
    img, kj, kt = textured
    ref = np.asarray(jdx.lucid_describe(jnp.asarray(img), kj))
    out = N(tdx.lucid_describe(T(img), kt))
    np.testing.assert_array_equal(np.round(out * 48), np.round(ref * 48))
    _assert_ranks_agree(out, ref, _lucid_values(img, kt))


def test_describe_gates_of_the_jax_tests(rng):
    """tests/test_features.py::TestDescribe's DAISY and binary cases, and
    tests/test_features_x.py::test_lucid_shapes, through the port."""
    img = T(rng.uniform(0, 1, size=(128, 128)).astype(np.float32))
    ys, xs = np.meshgrid(np.linspace(30, 100, 3), np.linspace(30, 100, 3))
    kps = tkp.from_arrays(ys.ravel()[:8], xs.ravel()[:8], scale=np.full(8, 2.0))
    h = N(tdesc.daisy_describe(img, kps)).reshape(8, 25, 8)
    assert np.linalg.norm(h, axis=2).max() < 1.0 + 1e-4
    img = rng.uniform(0, 255, size=(128, 128)).astype(np.float32)
    packed, signs = tdesc.binary_boxes_describe(T(img), kps)
    assert packed.shape == (8, 8) and packed.dtype == torch.int32 and signs.shape == (8, 256)
    np.testing.assert_array_equal(N(tdesc.unpack_to_signs(packed, 256)), N(signs))
    img = N(tdet.filters.gaussian_blur(T(img), 2.0))
    _, s1 = tdesc.binary_boxes_describe(T(img), kps)
    _, s2 = tdesc.binary_boxes_describe(T(img + rng.normal(scale=2.0, size=img.shape).astype(np.float32)), kps)
    assert (0.5 * (256 - np.sum(N(s1) * N(s2), axis=1))).mean() < 40
    img = T(rng.uniform(0, 255, (64, 64)).astype(np.float32))
    r = tdx.lucid_describe(img, tkp.from_arrays(y=rng.uniform(10, 50, 8), x=rng.uniform(10, 50, 8)))
    assert r.shape == (8, 49)
    np.testing.assert_allclose(np.sort(N(r[0])), np.arange(49) / 48.0, atol=1e-6)


# --- detect -----------------------------------------------------------------------------


def _same_keypoints(a, b, rtol=1e-4, angle_atol=None):
    for f in ("y", "x", "scale", "valid"):
        np.testing.assert_array_equal(N(getattr(b, f)), np.asarray(getattr(a, f)), err_msg=f)
    np.testing.assert_allclose(N(b.response), np.asarray(a.response), rtol=rtol, atol=1e-6)
    if angle_atol is None:
        np.testing.assert_array_equal(N(b.angle), np.asarray(a.angle))
    else:
        d = np.abs((N(b.angle) - np.asarray(a.angle) + np.pi) % (2 * np.pi) - np.pi)
        assert d.max() <= angle_atol


@pytest.mark.parametrize("name", ["harris", "fast", "star", "msd", "harris_laplace"])
def test_detectors(textured, name):
    img = textured[0]
    fj, ft, kw = {"harris": (jdet.harris, tdet.harris, {}),
                  "fast": (jdet.fast_corners, tdet.fast_corners, dict(threshold=8.0)),
                  "star": (jdetx.star_detector, tdetx.star_detector, dict(response_threshold=5.0)),
                  "msd": (jdetx.msd_detector, tdetx.msd_detector, {}),
                  "harris_laplace": (jdetx.harris_laplace, tdetx.harris_laplace, {})}[name]
    a = fj(jnp.asarray(img), max_keypoints=64, **kw)
    b = ft(T(img), max_keypoints=64, **kw)
    assert int(b.count()) == int(a.count()) > 0
    _same_keypoints(a, b, angle_atol=0.02 if name == "harris_laplace" else None)


def test_detect_gates_of_the_jax_tests():
    """tests/test_features.py's Harris and FAST cases and
    tests/test_features_x.py::TestDetectX through the port."""
    rng = np.random.default_rng(0)
    checker = rng.uniform(0, 50, size=(160, 160)).astype(np.float32)
    for i in range(4):
        for j in range(4):
            if (i + j) % 2 == 0:
                checker[20 + i * 30:50 + i * 30, 20 + j * 30:50 + j * 30] += 150.0
    kps = tdet.harris(T(checker), max_keypoints=64)
    assert int(kps.count()) >= 9
    assert (np.diff(N(kps.response)[N(kps.valid)]) <= 1e-5).all()
    assert int(tdet.fast_corners(T(checker / 255.0), max_keypoints=64, threshold=0.1).count()) >= 4

    centers = [(40, 40), (40, 90), (90, 40), (90, 90)]
    k = tdetx.star_detector(T(_blob_image(centers, [5] * 4)), max_keypoints=16)
    got = np.stack([N(k.y), N(k.x)], 1)[N(k.valid)]
    for cy, cx in centers:
        assert np.hypot(got[:, 0] - cy, got[:, 1] - cx).min() < 3.0
    img = np.zeros((96, 96), np.float32)
    img[40:56, 40:56] = 200.0
    k = tdetx.msd_detector(T(img), max_keypoints=16)
    got = np.stack([N(k.y), N(k.x)], 1)[N(k.valid)]
    assert len(got) >= 4 and (np.minimum(np.abs(got - 40), np.abs(got - 55)).min(1) < 8).all()
    noise = np.random.default_rng(0).uniform(0, 2, (128, 128)).astype(np.float32)
    s1 = float(tdetx.harris_laplace(T(_blob_image([(64, 64)], [3.0]) + noise), max_keypoints=8).scale[0])
    s2 = float(tdetx.harris_laplace(T(_blob_image([(64, 64)], [6.0]) + noise), max_keypoints=8).scale[0])
    assert s2 > s1
    ek = tdetx.tbmr(T(_blob_image([(40, 40), (80, 80)], [6, 6])), max_regions=16)
    v = N(ek.valid)
    c = np.stack([N(ek.y)[v], N(ek.x)[v]], 1)
    assert v.sum() >= 2 and all(np.hypot(c[:, 0] - cy, c[:, 1] - cx).min() < 4.0 for cy, cx in [(40, 40), (80, 80)])
    y, x = np.mgrid[0:96, 0:96]
    ridge = (200.0 * np.exp(-(((y - 48) / 4.0) ** 2 + ((x - 48) / 12.0) ** 2) / 2)).astype(np.float32)
    ek = tdetx.affine_adapt(T(ridge), tkp.from_arrays(y=[48.0], x=[48.0], scale=[6.0]))
    assert float(ek.a[0]) / float(ek.b[0]) > 1.5


def test_affine_adapt(textured):
    img, kj, kt = textured
    a = jdetx.affine_adapt(jnp.asarray(img), kj)
    b = tdetx.affine_adapt(T(img), kt)
    for f, x, y in zip(a._fields, a, b):
        np.testing.assert_allclose(N(y), np.asarray(x), rtol=1e-4, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("case", ["blobs", "noise"])
def test_tbmr(rng, case):
    """TBMR on integer frames: the region count equal, centres within 1e-2
    px, axes within 2%."""
    if case == "blobs":
        img = np.round(_blob_image([(40, 40), (70, 90), (20, 100)], [6, 5, 3], (96, 128)))
    else:
        img = np.round(np.asarray(jfilt.gaussian_blur(jnp.asarray(rng.uniform(0, 255, (64, 80)).astype(np.float32)),
                                                      3.0)))
    a = jdetx.tbmr(jnp.asarray(img), max_regions=16)
    b = tdetx.tbmr(T(img), max_regions=16)
    v = np.asarray(a.valid)
    assert int(N(b.valid).sum()) == int(v.sum()) > 0
    np.testing.assert_allclose(N(b.y)[v], np.asarray(a.y)[v], atol=1e-2)
    np.testing.assert_allclose(N(b.x)[v], np.asarray(a.x)[v], atol=1e-2)
    np.testing.assert_allclose(N(b.a)[v], np.asarray(a.a)[v], rtol=0.02)
    np.testing.assert_allclose(N(b.b)[v], np.asarray(a.b)[v], rtol=0.02)
    np.testing.assert_array_equal(N(b.response)[v], np.asarray(a.response)[v])


def _jax_level_slots(labels, maxc):
    """The JAX version's slot rule (tbmr's `level`), on its own arrays."""
    u = jnp.unique(labels, size=maxc, fill_value=-1)
    comp = (labels[None] == u[:, None, None]).argmax(0)
    return jnp.where(labels < 0, maxc - 1, comp), u >= 0


@pytest.mark.parametrize("case", ["few", "truncated", "all_foreground", "no_foreground"])
def test_level_slots(rng, case):
    mask = {"few": rng.uniform(size=(30, 40)) > 0.8, "truncated": rng.uniform(size=(30, 40)) > 0.6,
            "all_foreground": np.ones((12, 15), bool), "no_foreground": np.zeros((12, 15), bool)}[case]
    labels, _ = jax.jit(lambda m: __import__("opencv_contrib_tpu.ops.ccl", fromlist=["c"]).connected_components(m))(
        jnp.asarray(mask))
    maxc = 16
    rs, ru = _jax_level_slots(labels, maxc)
    s, u = tdetx._level_slots(T(np.asarray(labels)), maxc)
    np.testing.assert_array_equal(N(s), np.asarray(rs))
    np.testing.assert_array_equal(N(u), np.asarray(ru))


def test_component_moments_against_float64(rng):
    H, W, C = 120, 160, 24
    labels = rng.integers(0, C, (H, W)).astype(np.int64)
    labels[30:90, 40:150] = 5  # one large component: its second moments cancel most
    out = [N(t).astype(np.float64) for t in tdetx._component_moments(T(labels), C)]
    ref = [np.asarray(t, np.float64) for t in jdetx._component_moments(jnp.asarray(labels.astype(np.int32)), C)]
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    exact = []
    for c in range(C):
        m = labels == c
        a = m.sum()
        cy, cx = y[m].mean(), x[m].mean()
        exact.append((a, cy, cx, (y[m] ** 2).mean() - cy * cy, (x[m] ** 2).mean() - cx * cx,
                      (y[m] * x[m]).mean() - cy * cx))
    exact = np.asarray(exact).T
    for got in (out, ref):  # both packages to the same tolerance
        np.testing.assert_array_equal(got[0], exact[0])
        np.testing.assert_allclose(got[1], exact[1], atol=1e-4)
        np.testing.assert_allclose(got[2], exact[2], atol=1e-4)
        for k in (3, 4, 5):
            assert np.abs(got[k] - exact[k]).max() <= 1e-4 * np.abs(exact[3:5]).max()


# --- match ------------------------------------------------------------------------------


def _all_valid(n):
    return (jmatch.Matches(jnp.arange(n, dtype=jnp.int32), jnp.arange(n, dtype=jnp.int32), jnp.zeros(n),
                           jnp.ones(n, bool)),
            tmatch.Matches(torch.arange(n, dtype=torch.int32), torch.arange(n, dtype=torch.int32), torch.zeros(n),
                           torch.ones(n, dtype=torch.bool)))


def test_gms_filter(rng):
    """tests/test_features.py::test_gms_keeps_coherent_matches's data: the
    keep-mask equal, and its gate through the port."""
    n = 200
    xy1 = rng.uniform(50, 590, size=(n, 2)).astype(np.float32)
    xy2 = xy1 + np.array([20.0, 10.0], np.float32)
    xy2[:40] = rng.uniform(0, 640, size=(40, 2)).astype(np.float32)
    mj, mt = _all_valid(n)
    mt = mt._replace(valid=T(np.arange(n) % 17 != 3))  # some invalid slots
    mj = mj._replace(valid=jnp.asarray(N(mt.valid)))
    kw = dict(shape1=(640, 640), shape2=(640, 640), grid=10, tau_factor=3.0)
    ref = np.asarray(jmatch.gms_filter(mj, jnp.asarray(xy1), jnp.asarray(xy2), **kw).valid)
    out = N(tmatch.gms_filter(mt, T(xy1), T(xy2), **kw).valid)
    np.testing.assert_array_equal(out, ref)
    assert out[40:].mean() > 0.5 and out[:40].mean() < 0.25


def test_gms_filter_auto(rng):
    """tests/test_breadth8.py::TestGmsAuto's data: the keep-mask equal."""
    N_ = 200
    xy1 = rng.uniform(0, 400, (N_, 2)).astype(np.float32)
    xy2 = xy1 + np.array([6.0, 4.0], np.float32)
    bad = rng.choice(N_, 40, replace=False)
    xy2[bad] = rng.uniform(0, 400, (40, 2))
    mj, mt = _all_valid(N_)
    kw = dict(shape1=(400, 400), shape2=(400, 400))
    ref = np.asarray(jmatch.gms_filter_auto(mj, jnp.asarray(xy1), jnp.asarray(xy2), **kw).valid)
    out = N(tmatch.gms_filter_auto(mt, T(xy1), T(xy2), **kw).valid)
    np.testing.assert_array_equal(out, ref)
    good = ~np.isin(np.arange(N_), bad)
    assert out[good].mean() > 0.6 and out[bad].mean() < 0.3


def _logos_cases():
    rng = np.random.default_rng(0)
    xy1 = rng.uniform(10, 90, (40, 2)).astype(np.float32)
    xy2 = xy1 + np.array([5.0, -3.0], np.float32)
    bad = rng.choice(40, 5, replace=False)
    xy2[bad] = rng.uniform(10, 90, (5, 2))
    rng = np.random.default_rng(1)
    r1 = rng.uniform(10, 90, (60, 2)).astype(np.float32)
    th = np.deg2rad(30.0)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 30, (20, 2)).astype(np.float32)
    b = rng.uniform(200, 230, (20, 2)).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(6.0), np.arange(6.0)), -1).reshape(-1, 2).astype(np.float32) * 4.0
    return {"outliers": (xy1, xy2, bad), "rotation": (r1, (r1 - 50.0) @ R.T * 1.2 + 55.0, None),
            "two_clusters": (np.concatenate([a, b]),
                             np.concatenate([a + np.array([7.0, 2.0]), b + np.array([-4.0, 9.0])]).astype(np.float32),
                             None),
            "grid_ties": (grid, grid + np.float32(1.5), None)}


@pytest.mark.parametrize("case", ["outliers", "rotation", "two_clusters", "grid_ties"])
@pytest.mark.parametrize("k", [4, 5])
def test_logos_filter(case, k):
    """tests/test_breadth7.py::TestLogos's three scenes and a grid, whose
    equal neighbour distances test the tie order; k = 4 takes the even
    median."""
    xy1, xy2, bad = _logos_cases()[case]
    mj, mt = _all_valid(xy1.shape[0])
    ref = np.asarray(jmatch.logos_filter(mj, jnp.asarray(xy1), jnp.asarray(xy2), k=k, min_support=2).valid)
    out = N(tmatch.logos_filter(mt, T(xy1), T(xy2), k=k, min_support=2).valid)
    np.testing.assert_array_equal(out, ref)
    if k == 5 and bad is not None:
        assert out[~np.isin(np.arange(len(out)), bad)].mean() > 0.9 and out[bad].sum() == 0
    elif k == 5 and case != "grid_ties":
        assert out.all()


def test_median_even_and_odd(rng):
    for k in (4, 5, 6):
        x = rng.normal(size=(9, k)).astype(np.float32)
        np.testing.assert_array_equal(N(tmatch._median(T(x))), np.asarray(jnp.median(jnp.asarray(x), axis=1)))


def test_match_pairs_batched(rng):
    descs = rng.normal(size=(4, 24, 16)).astype(np.float32)
    descs[1] = descs[0] + rng.normal(scale=0.05, size=(24, 16)).astype(np.float32)
    valids = rng.uniform(size=(4, 24)) > 0.1
    pairs = np.array([[0, 1], [1, 2], [3, 0]], np.int32)
    ref = jmatch.match_pairs_batched(jnp.asarray(descs), jnp.asarray(valids), jnp.asarray(pairs), ratio=0.8)
    out = tmatch.match_pairs_batched(T(descs), T(valids), T(pairs), ratio=0.8)
    for f, a, b in zip(ref._fields, ref, out):
        assert tuple(b.shape) == a.shape, f
        if f == "distance":
            np.testing.assert_allclose(N(b), np.asarray(a), rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(N(b), np.asarray(a), err_msg=f)
    assert N(out.valid)[0].sum() > 15


# --- PCT --------------------------------------------------------------------------------


def test_pct(textured, rng):
    img = textured[0]
    other = np.round(rng.uniform(0, 255, (96, 128))).astype(np.float32)
    sj, sj2 = jpct.compute_signature(jnp.asarray(img)), jpct.compute_signature(jnp.asarray(other), k=6, seed=3)
    st, st2 = tpct.compute_signature(T(img)), tpct.compute_signature(T(other), k=6, seed=3)
    for a, b in ((sj, st), (sj2, st2)):
        np.testing.assert_allclose(N(b.centroids), np.asarray(a.centroids), atol=1e-4)
        np.testing.assert_allclose(N(b.weights), np.asarray(a.weights), atol=1e-4)
        np.testing.assert_array_equal(N(b.valid), np.asarray(a.valid))
    assert abs(float(tpct.sqfd(st, st2)) - float(jpct.sqfd(sj, sj2))) <= 1e-4
    f = np.asarray(jpct._sample_features(jnp.asarray(img), 64, 5))
    np.testing.assert_allclose(N(tpct._sample_features(T(img), 64, 5)), f, atol=1e-5)


def test_pct_gates_of_the_jax_tests():
    """tests/test_features_x.py::TestPCT through the port."""
    rng = np.random.default_rng(0)
    a = tdet.filters.fast_gaussian_blur(T(rng.uniform(0, 1, (96, 96)).astype(np.float32)), 2.0)
    b = T(_blob_image([(30, 30)], [8], (96, 96)) / 200.0)
    sa, sb = tpct.compute_signature(a), tpct.compute_signature(b)
    assert float(tpct.sqfd(sa, sa)) < 1e-5 and float(tpct.sqfd(sa, sb)) > 0.01
    s = tpct.compute_signature(T(np.random.default_rng(1).uniform(0, 1, (64, 64)).astype(np.float32)), k=8)
    assert abs(float(s.weights.sum()) - 1.0) < 1e-5


# --- learned ----------------------------------------------------------------------------


class Draws:
    """The JAX package's jax.random.normal / uniform results in call order
    (train_projection draws outside any jit); `replay` feeds them to the
    port's `_normal` / `_uniform` in the same order."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def record(self):
        normal, uniform = jax.random.normal, jax.random.uniform

        def spy_normal(key, shape, *a, **kw):
            out = normal(key, shape, *a, **kw)
            self.calls.append(("normal", np.asarray(out)))
            return out

        def spy_uniform(key, shape, *a, **kw):
            out = uniform(key, shape, *a, **kw)
            self.calls.append(("uniform", np.asarray(out)))
            return out

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "normal", spy_normal)
            mp.setattr(jax.random, "uniform", spy_uniform)
            yield self

    @contextlib.contextmanager
    def replay(self):
        calls = iter(self.calls)

        def take(kind, shape):
            k, arr = next(calls)
            assert k == kind and arr.shape == tuple(shape), (k, kind, arr.shape, shape)
            return torch.from_numpy(arr.astype(np.float32))

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tlearn, "_normal", lambda gen, shape: take("normal", shape))
            mp.setattr(tlearn, "_uniform", lambda gen, shape, lo, hi: take("uniform", shape))
            yield
        assert next(calls, None) is None, "the port drew fewer times than the JAX package"


@pytest.fixture(scope="module")
def projections():
    """train_projection(n_patches=192, out_dim=64), tests/test_features_x.py's
    W: the JAX package's, and the port's on the JAX package's draws."""
    draws = Draws()
    with draws.record():
        Wj = np.asarray(jlearn.train_projection(n_patches=192, out_dim=64))
    assert [k for k, _ in draws.calls] == ["normal", "uniform", "uniform", "uniform", "uniform", "normal"]
    with draws.replay():
        Wt = tlearn.train_projection(n_patches=192, out_dim=64)
    return Wj, Wt


def test_train_projection_on_replayed_draws(projections):
    Wj, Wt = projections
    Wt = N(Wt)
    assert Wt.shape == Wj.shape == (128, 64)
    sign = np.sign((Wt * Wj).sum(0))
    assert (sign != 0).all()
    np.testing.assert_allclose(Wt * sign, Wj, atol=1e-3)


def test_pooled_raw_and_learned_descriptors(textured, projections):
    img, kj, kt = textured
    Wj = projections[0]
    np.testing.assert_allclose(N(tlearn.pooled_gradient_raw(T(img), kt)),
                               np.asarray(jlearn.pooled_gradient_raw(jnp.asarray(img), kj)), rtol=1e-4, atol=1e-6)
    ref = np.asarray(jlearn.vgg_describe(jnp.asarray(img), kj, jnp.asarray(Wj)))
    np.testing.assert_allclose(N(tlearn.vgg_describe(T(img), kt, T(Wj))), ref, rtol=1e-4, atol=1e-6)
    rj = jlearn.boostdesc_describe(jnp.asarray(img), kj, jnp.asarray(Wj), n_bits=64)
    rt = tlearn.boostdesc_describe(T(img), kt, T(Wj), n_bits=64)
    assert _bit_agreement(N(rt[0]).view(np.uint32), rj[0]) >= 0.999
    assert _bit_agreement(N(rt[1]), rj[1]) >= 0.999


def test_synthetic_patches_on_replayed_draws():
    draws = Draws()
    with draws.record():
        ref = np.asarray(jlearn._synthetic_patches(jax.random.PRNGKey(5), 6))
    with draws.replay():
        out = N(tlearn._synthetic_patches(torch.Generator().manual_seed(5), 6))
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_load_projection_reads_the_jax_file(tmp_path, projections):
    Wj = projections[0]
    path = str(tmp_path / "w.npz")
    jlearn.save_projection(path, jnp.asarray(Wj))
    W = tlearn.load_projection(path)
    assert W.dtype == torch.float32
    np.testing.assert_array_equal(N(W), Wj)
    tlearn.save_projection(str(tmp_path / "t.npz"), W)
    np.testing.assert_array_equal(np.asarray(jlearn.load_projection(str(tmp_path / "t.npz"))), Wj)


def test_default_projection_trains_once(monkeypatch):
    calls = []
    monkeypatch.setattr(tlearn, "_CACHED_W", {})
    monkeypatch.setattr(tlearn, "train_projection", lambda out_dim: calls.append(out_dim) or torch.ones(128, out_dim))
    a = tlearn.default_projection(16)
    b = tlearn.default_projection(16)
    assert calls == [16] and a.shape == (128, 16) and torch.equal(a, b)


def test_projection_beats_raw(projections):
    """tests/test_features_x.py::test_projection_beats_raw through the port."""
    W = projections[1]
    ps = tlearn._synthetic_patches(torch.Generator().manual_seed(5), 24)
    size = ps.shape[1]

    def raw(p, ang, sc):
        return N(tlearn.pooled_gradient_raw(p, tlearn._center_kp(size, ang, 2.0 * sc))[0])

    ra = np.stack([raw(p, 0.0, 1.0) for p in ps])
    rb = np.stack([raw(p, 0.25, 1.1) for p in ps])

    def acc(a, b):
        return (((a[:, None] - b[None]) ** 2).sum(-1).argmin(1) == np.arange(len(a))).mean()

    Wn = N(W)
    pa, pb = ra @ Wn, rb @ Wn
    pa /= np.linalg.norm(pa, axis=1, keepdims=True) + 1e-12
    pb /= np.linalg.norm(pb, axis=1, keepdims=True) + 1e-12
    assert acc(pa, pb) >= acc(ra, rb)


# --- the rotation gates of tests/test_features_x.py, and entry.features_x ---------------------


@pytest.mark.parametrize("descriptor,gate", [("freak", (20, 0.6)), ("latch", (20, 0.8)), ("vgg", (20, 0.8)),
                                             ("boostdesc", (15, 0.7))])
def test_rotation_gates(pair, projections, descriptor, gate):
    """tests/test_features_x.py's rotation-invariance gates through the port,
    on entry.feature_pair at the test's 240x320 and 15 degrees."""
    img1, img2, k1, k2, fwd = pair
    W = projections[1]
    if descriptor == "vgg":
        d1, d2 = tlearn.vgg_describe(img1, k1, W), tlearn.vgg_describe(img2, k2, W)
        metric = "l2"
    else:
        fn = {"freak": lambda i, k: tdx.freak_describe(i, k)[1], "latch": lambda i, k: tdx.latch_describe(i, k)[1],
              "boostdesc": lambda i, k: tlearn.boostdesc_describe(i, k, W, n_bits=64)[1]}[descriptor]
        d1, d2 = fn(img1, k1), fn(img2, k2)
        metric = "hamming"
    m = tmatch.ratio_test_match(d1, d2, k1.valid, k2.valid, ratio=0.95, metric=metric)
    rate, n = _inlier_rate(k1, k2, m, fwd)
    assert n > gate[0] and rate > gate[1], (n, rate)


def test_feature_pair_is_the_texture_pair():
    """entry.feature_pair against tests/test_features_x.py::texture_pair's
    construction in the JAX package: the frames and the forward map."""
    from opencv_contrib_tpu.ops.image import warp_affine

    rng = np.random.default_rng(2)
    img = jfilt.fast_gaussian_blur(jnp.asarray(rng.uniform(0, 255, (240, 320)).astype(np.float32)), 1.5)
    th = np.deg2rad(15.0)
    c, s = np.cos(th), np.sin(th)
    M = jnp.asarray([[c, -s, 160.0 - c * 160.0 + s * 120.0], [s, c, 120.0 - s * 160.0 - c * 120.0]], jnp.float32)
    img2 = np.asarray(warp_affine(img, M))
    a, b, fwd = entry.feature_pair(240, 320)
    np.testing.assert_allclose(a, np.asarray(img), atol=1e-3)
    np.testing.assert_allclose(b, img2, atol=1e-3)
    Rm = np.array([[c, -s], [s, c]], np.float32)
    pts = np.random.default_rng(0).uniform(0, 300, (5, 2)).astype(np.float32)
    np.testing.assert_allclose(pts @ fwd[:, :2].T + fwd[:, 2], (pts - np.asarray(M)[:, 2]) @ Rm, atol=1e-3)


@pytest.mark.parametrize("detector,descriptor", [("fast_hessian", "daisy"), ("harris", "brief"),
                                                 ("star", "boxes"), ("msd", "lucid")])
def test_features_x_against_the_jax_chain(detector, descriptor):
    """entry.features_x on the CPU against the same chain of JAX calls, at
    96x128 on integer frames: keypoints, descriptors and matches."""
    img1, img2, _ = entry.feature_pair(96, 128)
    img1, img2 = np.round(img1), np.round(img2)
    K = 48
    det = {"fast_hessian": lambda i: jdet.fast_hessian(i, max_keypoints=K, threshold=20.0),
           "harris": lambda i: jdet.harris(i, max_keypoints=K),
           "star": lambda i: jdetx.star_detector(i, max_keypoints=K, response_threshold=5.0),
           "msd": lambda i: jdetx.msd_detector(i, max_keypoints=K)}[detector]
    desc = {"daisy": jdesc.daisy_describe, "brief": lambda i, k: jdesc.brief_describe(i, k)[1],
            "boxes": lambda i, k: jdesc.binary_boxes_describe(i, k)[1], "lucid": jdx.lucid_describe}[descriptor]
    binary = descriptor in ("brief", "boxes")
    ks = [det(jnp.asarray(i)) for i in (img1, img2)]
    ds = [desc(jnp.asarray(i), k) for i, k in zip((img1, img2), ks)]
    mj = jmatch.ratio_test_match(ds[0], ds[1], ks[0].valid, ks[1].valid, ratio=0.95,
                                 metric="hamming" if binary else "l2")
    params = {"response_threshold": 5.0} if detector == "star" else None  # the default finds none at this size
    out = entry.features_x(img1, img2, detector, descriptor, K=K, detector_params=params, device="cpu")
    for kj, kt in zip(ks, (out.k1, out.k2)):
        assert int(kt.count()) > 0
        np.testing.assert_array_equal(N(kt.valid), np.asarray(kj.valid))
        np.testing.assert_allclose(N(kt.scale), np.asarray(kj.scale), rtol=1e-5)
        for f in ("y", "x"):
            np.testing.assert_allclose(N(getattr(kt, f)), np.asarray(getattr(kj, f)), rtol=0, atol=1e-4, err_msg=f)
    for img, kt, dj, dt in zip((img1, img2), (out.k1, out.k2), ds, (out.d1, out.d2)):
        if binary:
            assert _bit_agreement(N(dt), dj) >= 0.999
        elif descriptor == "lucid":
            _assert_ranks_agree(N(dt), np.asarray(dj), _lucid_values(img, kt))
        else:
            np.testing.assert_allclose(N(dt), np.asarray(dj), rtol=1e-4, atol=1e-6)
    v = np.asarray(mj.valid)
    assert v.sum() > 0 and (N(out.matches.valid) == v).mean() >= 0.95
    both = v & N(out.matches.valid)
    assert (N(out.matches.train_idx)[both] == np.asarray(mj.train_idx)[both]).all()


def test_features_x_names():
    img = np.zeros((32, 48), np.float32)
    with pytest.raises(ValueError, match="detector"):
        entry.features_x(img, img, "sift", "surf", device="cpu")
    with pytest.raises(ValueError, match="descriptor"):
        entry.features_x(img, img, "harris", "orb", device="cpu")
    assert features.__all__ == ["Keypoints", "detect", "detect_x", "describe", "describe_x", "learned", "match",
                                "pct"]


def test_interop_tuples(textured):
    """Signature and EllipticKeypoints cross between the packages."""
    img, kj, _ = textured
    sj = jpct.compute_signature(jnp.asarray(img))
    st = interop.from_numpy(sj)
    assert type(st) is tpct.Signature
    np.testing.assert_array_equal(interop.to_numpy(st).centroids, np.asarray(sj.centroids))
    ej = jdetx.affine_adapt(jnp.asarray(img), kj)
    et = interop.from_numpy(ej)
    assert type(et) is tdetx.EllipticKeypoints and et.valid.dtype == torch.bool
