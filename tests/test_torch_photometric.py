"""Parity of the PyTorch port's photometric / image-quality slice
(opencv_contrib_tpu_torch: core/color.py, ops/histogram.py, ops/filters.py's
conv2d and guided filter, intensity_transform/, xphoto/, utils/metrics.py,
quality/, entry.photometric) with the JAX package, on the CPU.

Inputs are made with numpy from a seed (`entry.photo_clip` at 2 x 100 x 130,
a size whose CLAHE tiles crop the frame) and fed to both packages. Single
maps agree to an ulp or two of their values (XLA's CPU compiler contracts
`a * b + c` into FMAs; its `pow`, `log1p` and `exp` round otherwise than
PyTorch's), hence atol 1e-6 on values in [0, 1]; means and sums are taken
in other orders (rtol 1e-5); counts are exact. BRISQUE's shape parameters
are points of a 0.01 grid chosen by an argmin, so an ulp may move one by a
step: those entries are held to one step, the rest to rtol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu import intensity_transform as jit
from opencv_contrib_tpu import quality as jq
from opencv_contrib_tpu import xphoto as jxp
from opencv_contrib_tpu.core import color as jcolor
from opencv_contrib_tpu.ops import filters as jfilt
from opencv_contrib_tpu.ops import histogram as jhist
from opencv_contrib_tpu.quality import brisque as jbr
from opencv_contrib_tpu_torch import entry
from opencv_contrib_tpu_torch import intensity_transform as tit
from opencv_contrib_tpu_torch import quality as tq
from opencv_contrib_tpu_torch import xphoto as txp
from opencv_contrib_tpu_torch.core import color as tcolor
from opencv_contrib_tpu_torch.ops import filters as tfilt
from opencv_contrib_tpu_torch.ops import histogram as thist
from opencv_contrib_tpu_torch.quality import brisque as tbr

torch.set_num_threads(1)

ALPHA = [0, 2, 6, 10, 14, 18, 20, 24, 28, 32]  # the shape parameters among the 36 BRISQUE features
STEP = 0.01 + 1e-6  # one step of the alpha grid, and its float32 rounding


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def J(a):
    return jnp.asarray(np.asarray(a, dtype=np.float32))


@pytest.fixture(scope="module")
def clip():
    clean, degraded = entry.photo_clip(2, 100, 130, seed=1)
    return clean, degraded


@pytest.fixture(scope="module")
def grays(clip):
    """The first frame of each clip as gray, made by the JAX package."""
    clean, degraded = clip
    return np.asarray(jcolor.rgb_to_gray(J(degraded[0]))), np.asarray(jcolor.rgb_to_gray(J(clean[0])))


def test_photo_clip_is_seeded_and_in_range():
    c1, d1 = entry.photo_clip(2, 40, 56, seed=5)
    c2, d2 = entry.photo_clip(2, 40, 56, seed=5)
    assert c1.shape == d1.shape == (2, 40, 56, 3) and c1.dtype == d1.dtype == np.float32
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(d1, d2)
    assert c1.min() == 0.0 and c1.max() == 1.0 and 0.0 <= d1.min() and d1.max() <= 1.0
    np.testing.assert_array_equal(c1[1], np.roll(c1[0], 4, axis=1))
    # darkened and cast: the red channel's mean above the blue one's
    assert d1.mean() < c1.mean() and d1[..., 0].mean() > d1[..., 2].mean()


@pytest.mark.parametrize("layout", ["clip", "rgb", "gray"])
def test_gamma_correction(clip, layout):
    x = {"clip": clip[1], "rgb": clip[1][0], "gray": clip[1][0, ..., 1]}[layout]
    x = x * 1.2 - 0.1  # values outside [0, 1] are clipped first
    out = N(tit.gamma_correction(T(x), 1 / 2.2))
    assert out.shape == x.shape
    np.testing.assert_allclose(out, np.asarray(jit.gamma_correction(J(x), 1 / 2.2)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("lead", [(), (2,)])
def test_rgb_to_gray(clip, lead):
    x = clip[1] if lead else clip[1][0]
    out = N(tcolor.rgb_to_gray(T(x)))
    assert out.shape == x.shape[:-1]
    np.testing.assert_allclose(out, np.asarray(jcolor.rgb_to_gray(J(x))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("sat", [0.98, 0.5])
def test_grayworld_wb(clip, sat):
    x = clip[1][0]
    np.testing.assert_allclose(N(txp.grayworld_wb(T(x), sat)), np.asarray(jxp.grayworld_wb(J(x), sat)),
                               rtol=0, atol=1e-6)


def test_simple_wb(clip):
    x = clip[1][1]
    np.testing.assert_allclose(N(txp.simple_wb(T(x), 0.02)), np.asarray(jxp.simple_wb(J(x), 0.02)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("q", [0.0, 0.005, 0.1, 0.25, 0.5, 0.51, 0.73, 0.995, 1.0])
def test_quantile_linear_matches_numpy_on_ties(rng, q):
    """Columns of repeated values (sorted, shuffled, constant, with a NaN):
    equal to np.quantile's linear rule, NaN where the column holds one."""
    col = np.repeat(np.arange(7, dtype=np.float32), [1, 3, 2, 5, 1, 4, 2])[:, None]
    x = np.concatenate([col, rng.permutation(col), np.full_like(col, 2.5), col], axis=1)
    x[3, 3] = np.nan
    (out,) = txp.white_balance._quantile_linear(T(x), (q,))
    np.testing.assert_array_equal(N(out), np.quantile(x, q, axis=0, method="linear"))


def test_simple_wb_past_2_24_values_a_channel(rng):
    """A (2**24 + 3)-row column, past torch.quantile's limit: the quantiles
    and the stretch equal np.quantile's linear rule."""
    x = rng.standard_normal((2 ** 24 + 3, 1)).astype(np.float32)
    lo, hi = txp.white_balance._quantile_linear(T(x), (0.005, 0.995))
    qlo, qhi = np.quantile(x, 0.005, axis=0), np.quantile(x, 0.995, axis=0)
    np.testing.assert_array_equal(N(lo), qlo)
    np.testing.assert_array_equal(N(hi), qhi)
    out = N(txp.simple_wb(torch.from_numpy(x)))
    np.testing.assert_array_equal(out, np.clip((x - qlo) / np.maximum(qhi - qlo, np.float32(1e-6)), 0.0, 1.0))


def test_histogram_clamp_rule_keeps_the_jax_contract():
    """Out-of-range values count in the end bins and NaN in bin 0, exactly."""
    x = np.array([[0.0, 0.5, 1.0, 1.5, -0.2, np.nan, 0.999999, 0.99999994]], np.float32)
    out = N(thist.histogram(T(x), bins=4))
    np.testing.assert_array_equal(out, np.asarray(jhist.histogram(J(x), 4)))
    np.testing.assert_array_equal(out, [3, 0, 1, 4])


@pytest.mark.parametrize("bins,vmin,vmax", [(256, 0.0, 1.0), (37, -0.25, 1.3)])
def test_histogram_and_equalize(grays, rng, bins, vmin, vmax):
    g = grays[0].copy()
    g[rng.uniform(size=g.shape) < 0.02] = np.nan
    g[:3] = rng.uniform(-1, 2, size=(3, g.shape[1]))
    np.testing.assert_array_equal(N(thist.histogram(T(g), bins, vmin, vmax)),
                                  np.asarray(jhist.histogram(J(g), bins, vmin, vmax)))
    if (vmin, vmax) == (0.0, 1.0):
        np.testing.assert_allclose(N(thist.equalize_hist(T(g), bins)), np.asarray(jhist.equalize_hist(J(g), bins)),
                                   rtol=0, atol=1e-6)


def test_lut_lookup(rng):
    lut = rng.uniform(size=256).astype(np.float32)
    idx = rng.integers(0, 256, size=(17, 23)).astype(np.int32)
    np.testing.assert_array_equal(N(thist.lut_lookup(torch.from_numpy(idx), T(lut))),
                                  np.asarray(jhist.lut_lookup(jnp.asarray(idx), J(lut))))


@pytest.mark.parametrize("shape,clip_limit,grid", [((100, 130), 4.0, 8), ((96, 128), 2.0, 4), ((64, 80), 40.0, 8)])
def test_clahe(grays, shape, clip_limit, grid):
    """A cropping size (100 x 130: tiles of 12 x 16 cover 96 x 128), an
    exact one, and a limit that clips nothing. The JAX blend is a one-hot
    product and a weighted sum over all tiles, the port's a gather of four
    corners: atol 1e-6."""
    g = grays[0][:shape[0], :shape[1]]
    out = N(thist.clahe(T(g), clip_limit, grid))
    np.testing.assert_allclose(out, np.asarray(jhist.clahe(J(g), clip_limit, grid)), rtol=0, atol=1e-6)


def test_clahe_nan_and_out_of_range_pixels(grays, rng):
    g = grays[0].copy() * 1.4 - 0.2
    g[rng.uniform(size=g.shape) < 0.01] = np.nan
    np.testing.assert_allclose(N(thist.clahe(T(g))), np.asarray(jhist.clahe(J(g))), rtol=0, atol=1e-6)


def test_mse_and_psnr(grays):
    a, b = grays
    m = tq.mse(T(a), T(b))
    assert isinstance(m, float) and isinstance(tq.psnr(T(a), T(b)), float)
    np.testing.assert_allclose(m, jq.mse(J(a), J(b)), rtol=1e-5)
    np.testing.assert_allclose(tq.psnr(T(a), T(b)), jq.psnr(J(a), J(b)), rtol=1e-5)
    assert tq.psnr(T(a), T(a)) == float("inf")


@pytest.mark.parametrize("shape", [(100, 130), (99, 129), (100, 129)], ids=["even", "odd", "odd_width"])
def test_ssim_and_gmsd(grays, shape):
    """GMSD takes the 2x2 mean only when both sides are even."""
    a, b = (g[:shape[0], :shape[1]] for g in grays)
    np.testing.assert_allclose(N(tq.ssim(T(a), T(b))), np.asarray(jq.ssim(J(a), J(b))), rtol=1e-5)
    np.testing.assert_allclose(N(tq.gmsd(T(a), T(b))), np.asarray(jq.gmsd(J(a), J(b))), rtol=1e-5)
    np.testing.assert_allclose(N(tq.ssim(T(a), T(a))), 1.0, rtol=1e-6)


def test_mscn(grays):
    g = grays[0]
    np.testing.assert_allclose(N(tbr.mscn_coefficients(T(g))), np.asarray(jbr.mscn_coefficients(J(g))),
                               rtol=0, atol=1e-6)


def _hold_features(out, ref):
    assert out.shape == ref.shape == (36,)
    np.testing.assert_allclose(out[ALPHA], ref[ALPHA], rtol=0, atol=STEP)
    rest = np.setdiff1d(np.arange(36), ALPHA)
    np.testing.assert_allclose(out[rest], ref[rest], rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("which", [0, 1], ids=["degraded", "clean"])
def test_brisque_features_and_score(grays, which):
    g = grays[which]
    _hold_features(N(tbr.brisque_features(T(g))), np.asarray(jbr.brisque_features(J(g))))
    np.testing.assert_allclose(N(tbr.no_reference_score(T(g))), np.asarray(jbr.no_reference_score(J(g))), rtol=1e-5)


def test_ggd_and_aggd_params(rng):
    """The fits on a Laplacian sample and an asymmetric product."""
    x = rng.laplace(size=(60, 70)).astype(np.float32)
    y = (x * np.where(x > 0, 2.0, 0.5)).astype(np.float32)
    a, s = (N(v) for v in tbr._ggd_params(T(x)))
    ja, js = (np.asarray(v) for v in jbr._ggd_params(J(x)))
    assert abs(a - ja) <= STEP and abs(a - 1.0) < 0.2
    np.testing.assert_allclose(s, js, rtol=1e-5)
    out = [N(v) for v in tbr._aggd_params(T(y))]
    ref = [np.asarray(v) for v in jbr._aggd_params(J(y))]
    assert abs(out[0] - ref[0]) <= STEP
    np.testing.assert_allclose(out[1:], ref[1:], rtol=1e-4)


@pytest.mark.parametrize("fn", ["log_transform", "autoscaling", "contrast", "bimef_rgb", "bimef_gray"])
def test_intensity_transforms(clip, grays, fn):
    rgb, g = clip[1][0], grays[0]
    call = {"log_transform": lambda m, x: m.log_transform(x(g)),
            "autoscaling": lambda m, x: m.autoscaling(x(g * 0.6 + 0.1)),
            "contrast": lambda m, x: m.contrast_stretching(x(g), 0.3, 0.1, 0.7, 0.9),
            "bimef_rgb": lambda m, x: m.bimef(x(rgb)),
            "bimef_gray": lambda m, x: m.bimef(x(g), mu=0.3)}[fn]
    np.testing.assert_allclose(N(call(tit, T)), np.asarray(call(jit, J)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("border", ["reflect", "edge", "zero"])
def test_conv2d(clip, grays, rng, border):
    """F.conv2d sums the taps in its own order: atol 2e-6 on values up to
    about 3."""
    k = rng.normal(size=(3, 5)).astype(np.float32)
    for x in (clip[1][0], grays[0]):
        np.testing.assert_allclose(N(tfilt.conv2d(T(x), T(k), border)), np.asarray(jfilt.conv2d(J(x), J(k), border)),
                                   rtol=0, atol=2e-6)


def test_conv2d_rejects_unknown_border():
    with pytest.raises(ValueError, match="border"):
        tfilt.conv2d(torch.zeros(8, 8), torch.ones(3, 3), border="wrap")


def test_guided_filter(grays):
    a, b = grays
    np.testing.assert_allclose(N(tfilt.guided_filter(T(a), T(b), 4, 1e-2)),
                               np.asarray(jfilt.guided_filter(J(a), J(b), 4, 1e-2)), rtol=0, atol=1e-6)


def test_photometric_matches_the_jax_sequence(clip):
    """entry.photometric on the CPU against the same sequence of JAX calls
    on a 2 x 100 x 130 clip."""
    clean, degraded = clip
    res = entry.photometric(degraded, clean, device="cpu")
    lin = jit.gamma_correction(J(degraded), 1 / 2.2)
    for t in range(2):
        wb = jxp.grayworld_wb(lin[t])
        out = jhist.clahe(jcolor.rgb_to_gray(wb), clip_limit=4.0, grid=8)
        ref = jcolor.rgb_to_gray(J(clean[t]))
        np.testing.assert_allclose(N(res.balanced[t]), np.asarray(wb), rtol=0, atol=1e-6)
        np.testing.assert_allclose(N(res.equalized[t]), np.asarray(out), rtol=0, atol=1e-6)
        np.testing.assert_allclose(res.psnr[t], jq.psnr(out, ref), rtol=1e-5)
        np.testing.assert_allclose(N(res.ssim[t]), np.asarray(jq.ssim(out, ref)), rtol=1e-5)
        np.testing.assert_allclose(N(res.gmsd[t]), np.asarray(jq.gmsd(out, ref)), rtol=1e-5)
        np.testing.assert_allclose(N(res.nr_score[t]), np.asarray(jbr.no_reference_score(out)), rtol=1e-5)
        _hold_features(N(res.features[t]), np.asarray(jbr.brisque_features(out)))
    assert res.balanced.shape == (2, 100, 130, 3) and res.features.shape == (2, 36)
