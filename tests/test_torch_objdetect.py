"""Parity of the port's detectors (opencv_contrib_tpu_torch.xobjdetect: HOG
and WaldBoost; .dpm) with the JAX package on the CPU, on the JAX tests' own
fixtures, and `entry.detect_x` for them against the JAX tests' gates as
chip_smoke's phase x applies them at 480 x 640
(`chip_smoke.detection_gates`), here at 160 x 240.

WaldBoost's pool is the JAX package's draw from PRNGKey(0), carried across
as data (the port draws its own from a torch.Generator), and its model
crosses by `interop.from_numpy`.

Tolerances: HOG cells, blocks, window descriptors and SVM scores rtol 1e-5
/ atol 1e-6 (the twins sum the one-hot bins in their own order); boxes
equal. WaldBoost's summed-area tables and box features bit for bit on
integer channels whose tables stay below 2**24, rtol 1e-5 / atol 1e-5 on
float frames (a box mean differences table entries near the table's scale);
each stump's decision equal wherever |x - thresh| is above 1e-5 of the
feature's scale; the scores 1e-5. DPM's feature maps and filter responses
1e-5, the distance transform exact on the test's grid, the detections
equal in place and 1e-5 in score."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from opencv_contrib_tpu import dpm as jdpm
from opencv_contrib_tpu.dpm import detector as jdet
from opencv_contrib_tpu.ops.integral import integral as jintegral
from opencv_contrib_tpu.xobjdetect import hog as jhog
from opencv_contrib_tpu.xobjdetect import waldboost as jwb
from opencv_contrib_tpu_torch import dpm as tdpm
from opencv_contrib_tpu_torch import entry, interop
from opencv_contrib_tpu_torch.dpm import detector as tdet
from opencv_contrib_tpu_torch.ops.integral import integral as tintegral
from opencv_contrib_tpu_torch.xobjdetect import hog as thog
from opencv_contrib_tpu_torch.xobjdetect import waldboost as twb

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(N(a), np.asarray(b), rtol=rtol, atol=atol)


def _cross_patch(win=24, rng=None):
    """tests/test_xobjdetect.py::_cross_patch."""
    return entry._cross_patch(win, rng)


# ---- HOG -------------------------------------------------------------------------------------------------------------


def test_hog_cells_blocks_and_descriptor(rng):
    img = rng.uniform(0, 1, (128, 64)).astype(np.float32)
    cells = thog.cell_histograms(T(img))
    close(cells, jhog.cell_histograms(jnp.asarray(img)))
    close(thog.block_descriptors(cells), jhog.block_descriptors(jnp.asarray(N(cells))))
    d = N(thog.hog_descriptor(img))
    close(d, jhog.hog_descriptor(img))
    assert d.shape == (15 * 7 * 36,) and d.max() <= 0.5 and d.min() >= 0.0  # TestHog's gate


def test_hog_angles_fold_like_jnp_remainder():
    """(atan2 + pi) % pi with Python's sign rule: gradients along every
    direction, the bins and their weights as the twin's."""
    ys, xs = np.mgrid[0:32, 0:32].astype(np.float32)
    img = np.sin(0.3 * xs + 0.2 * ys) + np.cos(0.25 * xs - 0.4 * ys) * (xs > 15)
    close(thog.cell_histograms(T(img.astype(np.float32))), jhog.cell_histograms(jnp.asarray(img, jnp.float32)))


@pytest.mark.parametrize("win_cells,stride", [((16, 8), 1), ((8, 8), 1), ((4, 3), 2)])
def test_window_descriptors_one_view(rng, win_cells, stride):
    """The strided view lists the windows and their blocks in the twin's
    order (its Python double loop of slices)."""
    blocks = rng.uniform(0, 1, (21, 13, 36)).astype(np.float32)
    got, grid = thog.window_descriptors(T(blocks), win_cells, stride)
    want, grid_j = jhog.window_descriptors(jnp.asarray(blocks), win_cells, stride)
    assert grid == grid_j
    np.testing.assert_array_equal(N(got), np.asarray(want))


def test_hog_multiscale_detection(rng):
    """TestHog::test_svm_detection's scene at its scale and at the three
    default scales: boxes equal, scores 1e-5; the test's gate."""
    target = np.zeros((64, 64), np.float32)
    target[16:48, 28:36] = 1.0
    wvec = N(thog.hog_descriptor(target, (8, 8)))
    close(wvec, jhog.hog_descriptor(target, (8, 8)))
    wvec = wvec - wvec.mean()
    scene = rng.uniform(0, 0.05, (128, 128)).astype(np.float32)
    scene[32:96, 48:112] = np.maximum(scene[32:96, 48:112], target)
    for scales in ((1.0,), (1.0, 0.84, 0.7)):
        bt, st = thog.detect_multiscale(scene, wvec, win_cells=(8, 8), scales=scales, score_thresh=0.0)
        bj, sj = jhog.detect_multiscale(scene, wvec, win_cells=(8, 8), scales=scales, score_thresh=0.0)
        np.testing.assert_allclose(N(bt), bj, rtol=1e-12)
        close(st, sj, atol=1e-5)
    b = N(bt)[np.argmax(N(st))]
    assert abs(b[0] - 32) <= 8 and abs(b[1] - 48) <= 8


# ---- WaldBoost -------------------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_pool():
    return np.asarray(jwb.make_feature_pool(jax.random.PRNGKey(0), win=24, n_features=256))


def test_icf_channels_and_the_batched_tables(rng):
    """The 8 channels as the twin's; their tables one batched `integral`
    call, each bit-equal to the twin's on an integer image."""
    img = rng.uniform(0, 1, (40, 56)).astype(np.float32)
    close(twb.icf_channels(T(img)), jwb.icf_channels(jnp.asarray(img)))
    ints = rng.integers(0, 50, (8, 40, 56)).astype(np.float32)
    tables = N(tintegral(T(ints)))
    assert tables.shape == (8, 41, 57)
    np.testing.assert_array_equal(tables, np.asarray(jax.vmap(jintegral)(jnp.asarray(ints))))


def test_window_features_on_integer_channels(rng, jax_pool):
    """Every box of every window (clipped at the borders) read from the
    batched tables of integer channels (tables below 2**24): bit for bit.
    The channels are given to both twins: on integer images the gradient
    angles sit on the orientation bins' edges (axis-aligned gradients at
    exactly pi / 2), where an ulp of `atan2` moves a pixel's bin."""
    chans = rng.integers(0, 50, (8, 61, 73)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(0, 61, 5), np.arange(0, 73, 7), indexing="ij")
    centers = np.stack([ys, xs], -1).reshape(-1, 2).astype(np.int32)
    with mock.patch.object(twb, "icf_channels", lambda img: T(chans)), \
            mock.patch.object(jwb, "icf_channels", lambda img: jnp.asarray(chans)):
        got = N(twb.window_features(torch.zeros(61, 73), T(centers), T(jax_pool), win=24))
        want = np.asarray(jwb.window_features(jnp.zeros((61, 73)), jnp.asarray(centers), jnp.asarray(jax_pool), win=24))
    np.testing.assert_array_equal(got, want)


def test_window_features_on_a_float_image(rng, jax_pool):
    """A box mean is a difference of four table entries near the table's
    scale (~500 here), so an ulp of the channels moves it by ~1e-5: atol
    1e-5."""
    img = rng.uniform(0, 1, (60, 72)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(0, 60, 5), np.arange(0, 72, 7), indexing="ij")
    centers = np.stack([ys, xs], -1).reshape(-1, 2).astype(np.int32)
    got = twb.window_features(T(img), T(centers), T(jax_pool), win=24)
    close(got, jwb.window_features(jnp.asarray(img), jnp.asarray(centers), jnp.asarray(jax_pool), win=24), atol=1e-5)


def test_feature_pool_draws_in_range():
    pool = N(twb.make_feature_pool(torch.Generator().manual_seed(0), win=24, n_features=512))
    ch, y0, x0, y1, x1 = pool.T
    assert pool.shape == (512, 5) and ch.min() >= 0 and ch.max() < twb.N_CH
    assert (y1 > y0).all() and (x1 > x0).all() and y1.max() <= 23 and x1.max() <= 23


def _train_features(rng, pool, feats):
    win = 24
    pos = np.stack([_cross_patch(win, rng) for _ in range(40)])
    neg = rng.uniform(0, 1, (40, win, win)).astype(np.float32)
    c = np.array([[win // 2, win // 2]])
    return (np.concatenate([np.asarray(feats(p, c, pool)) for p in pos]),
            np.concatenate([np.asarray(feats(n, c, pool)) for n in neg]))


def test_waldboost_train_score_and_detect(rng, jax_pool):
    """TestWaldBoost on the JAX pool: the port's features of the training
    patches, its host training (the twin's numpy) on the twin's features
    equal to the twin's model; the twin's model carried across scores and
    detects as the twin does; the test's gate."""
    fp, fn = _train_features(rng, jax_pool, lambda p, c, pool: twb.window_features(T(p), T(c), T(pool)))
    rng2 = np.random.default_rng(0)
    fpj, fnj = _train_features(rng2, jax_pool, lambda p, c, pool: jwb.window_features(jnp.asarray(p), jnp.asarray(c),
                                                                                       jnp.asarray(pool)))
    close(fp, fpj)
    close(fn, fnj)
    mj = jwb.train(fpj, fnj, jnp.asarray(jax_pool), n_rounds=16, win=24)
    mt = twb.train(fpj, fnj, T(jax_pool), n_rounds=16, win=24)
    for a, b in zip(mt[:-1], mj[:-1]):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    assert mt.win == mj.win == 24
    mx = interop.from_numpy(mj)
    assert isinstance(mx, twb.WaldBoostModel) and type(mx.win) is int
    scene = rng.uniform(0, 0.3, (96, 96)).astype(np.float32)
    scene[40:64, 30:54] = _cross_patch(24, rng)
    ys, xs = np.meshgrid(np.arange(12, 84, 2), np.arange(12, 84, 2), indexing="ij")
    centers = np.stack([ys, xs], -1).reshape(-1, 2)
    ft = twb.window_features(T(scene), T(centers), mx.pool)
    fj = jwb.window_features(jnp.asarray(scene), jnp.asarray(centers), mj.pool)
    x, xj = N(ft)[:, N(mx.feat_idx)], np.asarray(fj)[:, np.asarray(mj.feat_idx)]
    th = np.asarray(mj.thresh)[None]
    near = np.abs(xj - th) <= 1e-5 * max(float(np.abs(xj).max()), 1.0)
    np.testing.assert_array_equal((x > th)[~near], (xj > th)[~near])
    assert near.mean() < 1e-3
    close(twb._score_windows(ft, mx), jwb._score_windows(fj, mj))
    ct, st = twb.detect(scene, mx, stride=2)
    cj, sj = jwb.detect(scene, mj, stride=2)
    np.testing.assert_array_equal(N(ct), cj)
    close(st, sj)
    top = N(ct)[N(st) >= N(st).max() - 1e-3]
    cy, cx = top.mean(0)
    assert abs(cy - 52) <= 4 and abs(cx - 42) <= 4  # the JAX test's gate


# ---- DPM -------------------------------------------------------------------------------------------------------------


def test_gdt2d_quadratic():
    """TestDpm::test_gdt_quadratic, through both."""
    s = np.full((9, 9), -10.0, np.float32)
    s[2, 6] = 5.0
    d = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    out = N(tdpm.gdt2d(T(s), T(d), 4, 4))
    np.testing.assert_array_equal(out, np.asarray(jdpm.gdt2d(jnp.asarray(s), jnp.asarray(d), 4, 4)))
    assert out[2, 6] == 5.0 and out[3, 6] == 4.0 and out[2, 5] == 4.0 and out[3, 5] == 3.0
    rng = np.random.default_rng(3)
    s2, d2 = rng.normal(size=(13, 17)).astype(np.float32), np.array([0.3, 0.1, 0.2, 0.05], np.float32)
    np.testing.assert_array_equal(N(tdpm.gdt2d(T(s2), T(d2), 3, 2)),
                                  np.asarray(jdpm.gdt2d(jnp.asarray(s2), jnp.asarray(d2), 3, 2)))


def test_dpm_detect_on_the_jax_model(rng):
    """TestDpm's fixture: the JAX model built from the training pattern's
    features, carried across; features, correlations, score maps and the
    three detections (pattern, deformed, noise) as the twin's; the gates."""
    train = entry._dpm_pattern(rng)
    featj = jdet._features(jnp.asarray(train))
    close(tdet._features(T(train)), featj)
    root, p1, p2 = featj[4:9, 3:8], featj[5:7, 4:6], featj[7:9, 6:8]
    nrm = lambda a: a / (jnp.linalg.norm(a) + 1e-6)  # noqa: E731
    mj = jdpm.DPMModel(root=nrm(root), parts=jnp.stack([nrm(p1), nrm(p2)]),
                       anchors=jnp.asarray([[1, 1], [3, 3]], jnp.int32), deform=jnp.full((2, 4), 0.05), bias=0.0)
    mt = interop.from_numpy(mj)
    assert isinstance(mt, tdpm.DPMModel) and type(mt.bias) is float
    close(tdet._correlate(T(np.asarray(featj)), mt.root), jdet._correlate(featj, mj.root), atol=1e-5)
    close(tdpm.score_scale(T(np.asarray(featj)), mt), jdpm.score_scale(featj, mj), atol=1e-5)
    deformed = entry._dpm_pattern(rng, deform=6)
    noise = rng.uniform(0, 1, (96, 96)).astype(np.float32)
    out = {}
    for name, img in (("train", train), ("deformed", deformed), ("noise", noise)):
        dt = tdpm.detect(img, mt, scales=(1.0,), score_thresh=2.0)
        dj = jdpm.detect(img, mj, scales=(1.0,), score_thresh=2.0)
        assert [d[:3] for d in dt] == [d[:3] for d in dj]
        np.testing.assert_allclose([d[3] for d in dt], [d[3] for d in dj], rtol=1e-5)
        out[name] = dt
    y, x, _, _ = out["train"][0]
    assert abs(y - 32) <= 16 and abs(x - 24) <= 16  # the JAX test's gates
    assert out["deformed"] and out["deformed"][0][3] > max((d[3] for d in out["noise"]), default=-np.inf)


def test_dpm_anchor_placement_clamps_like_dynamic_slice(rng):
    """An anchor past the padded map's edge: the start clamped as
    `dynamic_slice` clamps it."""
    feat = rng.uniform(0, 1, (12, 14, 36)).astype(np.float32)
    parts = rng.uniform(0, 1, (2, 2, 2, 36)).astype(np.float32)
    mj = jdpm.DPMModel(root=jnp.asarray(feat[:4, :5]), parts=jnp.asarray(parts),
                       anchors=jnp.asarray([[20, 1], [2, 30]], jnp.int32), deform=jnp.full((2, 4), 0.1), bias=0.5)
    close(tdpm.score_scale(T(feat), interop.from_numpy(mj)), jdpm.score_scale(jnp.asarray(feat), mj), atol=1e-5)


def test_detect_x_detectors_and_gates():
    """`entry.detect_x` for HOG, WaldBoost and DPM at 160 x 240 on the CPU:
    against the same calls of the JAX package on the scene (WaldBoost and
    DPM on the scene's models, carried across), and the JAX tests' gates
    (`chip_smoke.detection_gates`)."""
    scene = entry.detection_scene(160, 240)
    outs = {m: entry.detect_x(scene, m, device="cpu") for m in ("hog", "waldboost", "dpm")}
    chip_smoke.detection_gates(scene, outs)
    bj, sj = jhog.detect_multiscale(scene.hog_frame, scene.hog_w, win_cells=entry.HOG_WIN_CELLS,
                                    scales=entry.HOG_SCALES)
    np.testing.assert_allclose(N(outs["hog"]["boxes"]), bj, rtol=1e-12)
    close(outs["hog"]["scores"], sj, atol=1e-5)
    mj = jwb.WaldBoostModel(*(jnp.asarray(N(v)) for v in scene.wb_model[:-1]), scene.wb_model.win)
    cj, sj = jwb.detect(scene.wb_frame, mj, stride=entry.WB_STRIDE)
    np.testing.assert_array_equal(N(outs["waldboost"]["centers"]), cj)
    close(outs["waldboost"]["scores"], sj)
    dm = scene.dpm_model
    dj = jdpm.detect(scene.dpm_frame, jdpm.DPMModel(*(jnp.asarray(v) for v in dm[:-1]), dm.bias), scales=(1.0,),
                     score_thresh=2.0)
    assert [d[:3] for d in outs["dpm"]["dets"]] == [d[:3] for d in dj]
    with pytest.raises(ValueError):
        entry.detect_x(scene, "viola_jones", device="cpu")
