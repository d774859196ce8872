"""Parity of the port's perceptual hashes (opencv_contrib_tpu_torch.img_hash)
and saliency maps (.saliency), with the colour conversions they take
(core.color.rgb_to_hsv / rgb_to_ycrcb), against the JAX package on the CPU,
on the JAX tests' fixtures (tests/test_imgproc_modules.py, the BING test of
tests/test_breadth7.py) and at their sizes.

Tolerances: the binary hashes bit for bit; the colour conversions rtol 1e-6
/ atol 1e-6 (the hue's `torch.remainder` and `jnp.mod` wrap alike); the
colour moments rtol 1e-5 / atol 1e-6 (sign(x) |x|^(1/3) for `jnp.cbrt`,
an ulp or two); the radial variances 1e-5; the spectral residual atol 2e-5
of its [0, 1] map (the two FFTs round differently); fine-grained saliency
1e-6, and bit for bit on an integer image; BING's maps rtol 1e-5 / atol
1e-6 and its boxes equal; the motion masks equal, the model 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu import img_hash as jhash
from opencv_contrib_tpu import saliency as jsal
from opencv_contrib_tpu.core import color as jcolor
from opencv_contrib_tpu.ops import filters as jfilters
from opencv_contrib_tpu.saliency import bing as jbing
from opencv_contrib_tpu_torch import img_hash as thash
from opencv_contrib_tpu_torch import interop
from opencv_contrib_tpu_torch import saliency as tsal
from opencv_contrib_tpu_torch.core import color as tcolor
from opencv_contrib_tpu_torch.img_hash import hashes as thashes
from opencv_contrib_tpu_torch.saliency import bing as tbing

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def close(a, b, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(N(a), np.asarray(b), rtol=rtol, atol=atol)


def _img(rng):
    """TestImgHash._img."""
    x = rng.uniform(size=(64, 80, 3)).astype(np.float32)
    return np.asarray(jfilters.gaussian_blur(jnp.asarray(x), 2.0))


# ---- colour and the median -------------------------------------------------------------------------------------------


def test_rgb_to_hsv_and_ycrcb(rng):
    img = rng.uniform(0, 1, (40, 50, 3)).astype(np.float32)
    img[0, :5] = [[0.3, 0.3, 0.3], [0, 0, 0], [1, 0, 0], [0.2, 0.1, 0.6], [0.5, 0.5, 0.1]]  # gray, black, ties
    img[1, :3] = [[0.9, 0.1, 0.5], [0.6, 0.2, 0.6], [0.4, 0.4, 0.9]]  # the hue's negative branch wraps
    hsv = N(tcolor.rgb_to_hsv(T(img)))
    close(hsv, jcolor.rgb_to_hsv(jnp.asarray(img)), atol=2e-5)
    assert hsv[..., 0].min() >= 0 and hsv[..., 0].max() < 360
    close(tcolor.rgb_to_ycrcb(T(img)), jcolor.rgb_to_ycrcb(jnp.asarray(img)))


@pytest.mark.parametrize("n", [256, 63, 2])
def test_median_is_jnp_median(rng, n):
    """An even count averages the two middle values (torch.median would take the lower)."""
    x = rng.normal(size=n).astype(np.float32)
    assert float(thashes._median(T(x))) == float(jnp.median(jnp.asarray(x)))


def test_cbrt_of_signed_moments(rng):
    x = np.concatenate([rng.normal(size=64) * 10.0 ** rng.integers(-6, 3, 64), [0.0, -0.0, 8.0, -27.0]])
    close(thashes._cbrt(T(x.astype(np.float32))), jnp.cbrt(jnp.asarray(x, jnp.float32)), rtol=2e-7, atol=0)


# ---- hashes ----------------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["average_hash", "block_mean_hash", "phash", "marr_hildreth_hash"])
def test_binary_hashes_equal(rng, name):
    """TestImgHash's fixture: the frame, its noisy copy and another frame; every bit equal, and the test's gate."""
    a = _img(rng)[..., 0]
    noisy = a + rng.normal(scale=0.01, size=a.shape).astype(np.float32)
    other = _img(rng)[..., 0]
    tf, jf = getattr(thash, name), getattr(jhash, name)
    hs = []
    for x in (a, noisy, other):
        h = N(tf(T(x)))
        np.testing.assert_array_equal(h, np.asarray(jf(jnp.asarray(x))))
        hs.append(h)
    d_noise, d_other = int((hs[0] != hs[1]).sum()), int((hs[0] != hs[2]).sum())
    assert d_noise < d_other and d_noise <= 0.15 * hs[0].size
    assert int(thash.hamming_compare(T(hs[0]), T(hs[2]))) == d_other


def test_average_hash_of_an_odd_frame(rng):
    """The linear resize branch (a height not a multiple of 8) and a colour frame through rgb_to_gray."""
    x = rng.uniform(size=(50, 70, 3)).astype(np.float32)
    np.testing.assert_array_equal(N(thash.average_hash(T(x))), np.asarray(jhash.average_hash(jnp.asarray(x))))


def test_color_moment_hash(rng):
    a = _img(rng)
    for x in (a, a * 0.98):
        close(thash.color_moment_hash(T(x)), jhash.color_moment_hash(jnp.asarray(x)), rtol=1e-5)


def test_radial_variance_hash(rng):
    a = _img(rng)[..., 0]
    for x in (a, np.rot90(a, 2).copy()):
        close(thash.radial_variance_hash(T(x)), jhash.radial_variance_hash(jnp.asarray(x)), rtol=1e-5, atol=1e-5)


# ---- saliency --------------------------------------------------------------------------------------------------------


def test_spectral_residual(rng):
    img = np.full((96, 96), 0.5, np.float32)
    img += rng.normal(scale=0.01, size=img.shape).astype(np.float32)
    img[40:56, 40:56] = 1.0
    close(tsal.spectral_residual(T(img)), jsal.spectral_residual(jnp.asarray(img)), rtol=0, atol=2e-5)


def test_fine_grained(rng):
    img = rng.uniform(size=(64, 64)).astype(np.float32)
    close(tsal.fine_grained(T(img)), jsal.fine_grained(jnp.asarray(img)), atol=1e-6)
    ints = np.round(rng.uniform(0, 50, (64, 64))).astype(np.float32)
    np.testing.assert_array_equal(N(tsal.fine_grained(T(ints))), np.asarray(jsal.fine_grained(jnp.asarray(ints))))


def test_bing_maps_and_boxes(rng):
    img = rng.uniform(0, 0.03, (96, 96)).astype(np.float32)
    img[30:62, 40:72] += 0.8
    tm = tbing.score_windows(T(img), tbing.default_template())
    jm = jbing.score_windows(jnp.asarray(img), jbing.default_template())
    assert sorted(tm) == sorted(jm)
    for size in jm:
        close(tm[size], jm[size], rtol=1e-5)
    for kw in ({"sizes": (32,), "stride": 4, "top_k": 8}, {}):
        tb, ts = tsal.objectness_boxes(T(img), **kw)
        jb, js = jsal.objectness_boxes(img, **kw)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)


def test_bing_trained_template(rng):
    pos = rng.uniform(size=(12, 8, 8)).astype(np.float32)
    neg = rng.uniform(size=(20, 8, 8)).astype(np.float32)
    close(tbing.train_template(pos, neg), jbing.train_template(pos, neg))


def test_motion_saliency_over_11_frames(rng):
    """test_motion_saliency's sequence: the masks equal at every frame, the model within 1e-6; the JAX state
    carried across by interop.motion_saliency_from_jax matches the port's own after the run."""
    base = rng.uniform(size=(32, 32)).astype(np.float32)
    frames = [base + rng.normal(scale=0.003, size=base.shape).astype(np.float32) for _ in range(10)]
    moved = base.copy()
    moved[10:20, 10:20] += 0.5
    frames.append(moved)
    js, ts = jsal.motion_create((32, 32)), tsal.motion_create((32, 32))
    for f in frames:
        js, jm = jsal.motion_apply(js, jnp.asarray(f))
        ts, tm = tsal.motion_apply(ts, T(f))
        np.testing.assert_array_equal(N(tm), np.asarray(jm))
    close(ts.mean, js.mean)
    close(ts.var, js.var)
    assert float(ts.frames) == float(js.frames) == 11.0
    carried = interop.motion_saliency_from_jax(js)
    assert isinstance(carried, tsal.MotionSaliency) and carried.frames.ndim == 0
    close(carried.mean, N(ts.mean))
    tm = N(tm)
    assert tm[10:20, 10:20].mean() > 0.8 and tm[25:, 25:].mean() < 0.1
