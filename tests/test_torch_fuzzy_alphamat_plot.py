"""Parity of the port's `fuzzy`, `alphamat` and `plot` with the JAX package on
the CPU, and `entry.learned_x`'s numeric methods against the JAX functions
and chip_smoke's gates (`numeric_gates` at 120 x 160, `fixture_gates` on
the tests' own fixtures) as phase z applies them at VGA on the card.

Tolerances: fuzzy rtol 1e-5 (of the largest value); alphamat atol 1e-4
after the 150 CG steps; plot2d exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from opencv_contrib_tpu import alphamat as jam
from opencv_contrib_tpu import plot as jplot
from opencv_contrib_tpu import signal as jsig
from opencv_contrib_tpu.fuzzy import ftransform as jft
from opencv_contrib_tpu_torch import alphamat as tam
from opencv_contrib_tpu_torch import entry
from opencv_contrib_tpu_torch import plot as tplot
from opencv_contrib_tpu_torch.fuzzy import ftransform as tft

torch.set_num_threads(1)


def N(t):
    return t.detach().cpu().numpy()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("radius", [4, 8, 10])
@pytest.mark.parametrize("shape", [(50, 70), (64, 64)])
def test_fuzzy_matches_jax(radius, shape):
    rng = np.random.default_rng(radius)
    img = rng.uniform(size=shape).astype(np.float32)
    mask = np.zeros(shape, bool)
    mask[10:20, 15:30] = True
    pairs = [(tft.f0_filter(img, radius), jft.f0_filter(jnp.asarray(img), radius)),
             (tft.f1_filter(img, radius), jft.f1_filter(jnp.asarray(img), radius)),
             (tft.f0_inpaint(img, mask, radius), jft.f0_inpaint(jnp.asarray(img), jnp.asarray(mask), radius))]
    (c, d), (cj, dj) = tft.f0_components(img, radius, mask=~mask), jft.f0_components(jnp.asarray(img), radius,
                                                                                     mask=jnp.asarray(~mask))
    pairs += [(c, cj), (d, dj), (tft.f0_inverse(c, shape, radius), jft.f0_inverse(cj, shape, radius))]
    comps, compsj = tft.f1_components(img, radius), jft.f1_components(jnp.asarray(img), radius)
    pairs += list(zip(comps, compsj))
    pairs += [(tft.f1_inverse(*comps, shape, radius), jft.f1_inverse(*compsj, shape, radius))]
    for got, want in pairs:
        assert _rel(N(got), np.asarray(want)) <= 1e-5


def _two_regions():
    img = np.zeros((48, 48), np.float32)
    img[16:32, 4:16] = 1.0
    img[16:32, 32:44] = 1.0
    img = img + np.random.default_rng(3).uniform(0, 0.05, img.shape).astype(np.float32)
    tri = np.full((48, 48), 0.5, np.float32)
    tri[20:28, 6:10] = 1.0
    tri[:8] = 0.0
    tri[-8:] = 0.0
    return img, tri


def test_info_flow_matches_jax():
    img, tri = _two_regions()
    want = np.asarray(jam.info_flow(jnp.asarray(img), jnp.asarray(tri)))
    np.testing.assert_allclose(N(tam.info_flow(img, tri)), want, atol=1e-4)
    # a colour image: two ramps, a wave and a red block (on U(0, 1) colours the affinities at sigma 0.1 are ~e^-17
    # and the system so ill-conditioned that the two float32 solves part by 1e-3 after 150 steps)
    yy, xx = np.mgrid[0:40, 0:44].astype(np.float32)
    rgb = np.stack([xx / 44, yy / 40, 0.5 + 0.3 * np.sin(xx / 6)], -1).astype(np.float32)
    rgb[10:30, 12:30] = [0.9, 0.2, 0.1]
    tri3 = np.full((40, 44), 0.5, np.float32)
    tri3[:5], tri3[-5:], tri3[15:25, 18:24] = 0.0, 1.0, 1.0
    for n_iters in (60, 150):
        np.testing.assert_allclose(N(tam.info_flow(rgb, tri3, n_iters=n_iters)),
                                   np.asarray(jam.info_flow(jnp.asarray(rgb), jnp.asarray(tri3), n_iters=n_iters)),
                                   atol=1e-4)


@pytest.mark.parametrize("gray", [True, False])
def test_info_flow_nonlocal_matches_jax(gray):
    if gray:
        img, tri = _two_regions()
        kw = dict(n_samples=512, k=4)
    else:
        img = np.random.default_rng(5).uniform(size=(40, 44, 3)).astype(np.float32)
        tri = np.full((40, 44), 0.5, np.float32)
        tri[:6], tri[-6:] = 0.0, 1.0
        kw = dict(n_samples=256)
    want = np.asarray(jam.info_flow_nonlocal(jnp.asarray(img), jnp.asarray(tri), **kw))
    np.testing.assert_allclose(N(tam.info_flow_nonlocal(img, tri, **kw)), want, atol=1e-4)


def test_nonlocal_top_k_ties_take_the_lower_index():
    """Known samples of one colour tie in distance: lax.top_k keeps the
    lower indices, as the port's stable descending sort does; samples of
    other targets at the same distance would part the two otherwise."""
    img = np.full((12, 12), 0.5, np.float32)
    tri = np.full((12, 12), 0.5, np.float32)
    tri[0, :6], tri[0, 6:] = 1.0, 0.0  # twelve known samples of one colour, half fg, half bg
    want = np.asarray(jam.info_flow_nonlocal(jnp.asarray(img), jnp.asarray(tri), n_samples=12, k=3))
    np.testing.assert_allclose(N(tam.info_flow_nonlocal(img, tri, n_samples=12, k=3)), want, atol=1e-5)


@pytest.mark.parametrize("shape,n", [((120, 160), 100), ((240, 320), 37), ((50, 60), 500)])
def test_plot2d_matches_jax_exactly(shape, n):
    rng = np.random.default_rng(n)
    x = np.sort(rng.uniform(-3, 5, n))
    y = np.cumsum(rng.normal(size=n))
    np.testing.assert_array_equal(N(tplot.plot2d(x, y, shape=shape)), np.asarray(jplot.plot2d(x, y, shape=shape)))


def test_learned_x_numeric_methods_and_gates():
    """entry.learned_x's numeric methods at 120 x 160 against the JAX
    functions on the same fixtures, then chip_smoke's gates on them."""
    scene = entry.learned_scene(120, 160)
    outs = {m: entry.learned_x(m, {}, scene, device="cpu")
            for m in ("f0_filter", "f1_filter", "f0_inpaint", "plot2d", "resample_signal", "info_flow")}
    j = jnp.asarray
    assert _rel(N(outs["f0_filter"]["noise8"]), jft.f0_filter(j(scene.fuzzy_noise), 8)) <= 1e-5
    assert _rel(N(outs["f1_filter"]["ramp8"]), jft.f1_filter(j(scene.fuzzy_ramp), 8)) <= 1e-5
    assert _rel(N(outs["f0_inpaint"]["out"]), jft.f0_inpaint(j(scene.fuzzy_corrupted), j(scene.fuzzy_mask), 10)) <= 1e-5
    np.testing.assert_array_equal(N(outs["plot2d"]["img"]), np.asarray(jplot.plot2d(scene.plot_x, scene.plot_y,
                                                                                    shape=(120, 160))))
    np.testing.assert_allclose(N(outs["resample_signal"]["up"]),
                               np.asarray(jsig.resample_signal(j(scene.signal), 2 * entry.SIGNAL_LEN)), atol=1e-6)
    np.testing.assert_allclose(N(outs["info_flow"]["alpha"]),
                               np.asarray(jam.info_flow(j(scene.matte_img), j(scene.matte_trimap))), atol=1e-4)
    g = chip_smoke.numeric_gates(scene, outs)
    assert g["f1_reconstructs_ramp"]["err"] < 1e-3
    g = chip_smoke.fixture_gates("cpu")
    assert g["nonlocal"]["right_nonlocal"] > 0.5
