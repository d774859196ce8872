"""Parity of the port's ximgproc filters (opencv_contrib_tpu_torch.ximgproc:
filters_x, filters_x2, fourier) with the JAX package on the CPU. The inputs
are the JAX tests' fixtures (tests/test_ximgproc.py, tests/test_ximgproc3.py)
and a second seeded random image, the same numpy arrays through both
packages; the JAX functions run jitted, as the JAX package calls them.

Tolerances (max abs difference, on images in [0, 1] unless stated):
- niblack_threshold, edge_preserving_filter: equal; weighted_median_filter:
  the median bins equal, the values within 1e-6 (the bin's value is
  lo + bin / (n - 1) * span, rounded apart by XLA's fusion);
  joint_bilateral_filter: 1e-6 (jitted, XLA fuses the window's
  multiply-adds: an ulp here and there);
- the other whole-image filters (anisotropic diffusion, rolling guidance,
  ridge, L0, bilateral texture, adaptive manifold, the bilateral solver):
  1e-5, a few float32 roundings of values of order 1 (XLA fuses multiply-adds
  that PyTorch rounds apart; the solver's CG sums in another order);
- the scanline recursions (dt_filter, the fast global smoother and the WLS
  filter, the Deriche / Paillou IIR gradients): held to a float64 recompute
  of the same recurrence (`_dt_f64`, `_fgs_f64`, `_iir_f64` below): each
  package within 1e-5 of it (relative to the output's range), and the two
  within twice the larger of their distances to it;
- fourier_descriptors: 1e-6 of the largest magnitude (1 when normalized):
  the FFTs' rounding.
The JAX tests' own gates run through the port too."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu import ximgproc as jx
from opencv_contrib_tpu_torch import ximgproc as tx

torch.set_num_threads(1)

H, W = 32, 48


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _step_image(h=48, w=64, noise=0.05, seed=0):
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    img[:, w // 2:] = 1.0
    return img, img + rng.normal(0, noise, (h, w)).astype(np.float32)


def _inputs():
    """The step fixture (clean guide, noisy image) and a smooth random pair."""
    clean, noisy = _step_image(H, W)
    rng = np.random.default_rng(11)
    rnd = rng.uniform(size=(H, W)).astype(np.float32)
    rnd = (0.5 * rnd + 0.5 * np.roll(rnd, 1, 0)).astype(np.float32)
    return {"step": (clean, noisy), "random": (rnd, np.clip(rnd + rng.normal(0, 0.05, (H, W)), 0, 1)
                                               .astype(np.float32))}


INPUTS = _inputs()


def jit(fn, **static):
    return jax.jit(functools.partial(fn, **static))


# jitted once a module, so that both inputs (one shape) share a compile
J_ROLLING = jit(jx.rolling_guidance_filter, sigma_s=2.0, sigma_r=0.2, n_iters=2)  # 2 of 4: half the compile
J_DT = jit(jx.dt_filter, sigma_s=10.0, sigma_r=0.15)
J_NIBLACK = jit(jx.niblack_threshold, block_radius=5)
J_RIDGE = jit(jx.ridge_filter, sigma=1.5)
J_JBF = jit(jx.joint_bilateral_filter, sigma_s=2.0, sigma_r=0.2, radius=3)
J_AMF = jit(jx.adaptive_manifold_filter, sigma_s=8.0, sigma_r=0.3)


# --- float64 recomputes of the scanline recursions ------------------------------------------------------------------


def _gradients_f64(img):
    gy = (np.roll(img, -1, 0) - np.roll(img, 1, 0)) * 0.5
    gx = (np.roll(img, -1, 1) - np.roll(img, 1, 1)) * 0.5
    gy[0], gy[-1] = img[1] - img[0], img[-1] - img[-2]
    gx[:, 0], gx[:, -1] = img[:, 1] - img[:, 0], img[:, -1] - img[:, -2]
    return gy, gx


def _rf_rows_f64(x, w):
    y = x.copy()
    for i in range(1, x.shape[1]):
        y[:, i] = x[:, i] + w[:, i] * (y[:, i - 1] - x[:, i])
    for i in range(x.shape[1] - 2, -1, -1):
        y[:, i] = y[:, i] + w[:, i] * (y[:, i + 1] - y[:, i])
    return y


def _dt_f64(guide, src, sigma_s, sigma_r, n_iters):
    gy, gx = _gradients_f64(guide.astype(np.float64))
    out = src.astype(np.float64)
    for i in range(n_iters):
        sigma_h = sigma_s * np.sqrt(3.0) * 2.0 ** (n_iters - i - 1) / np.sqrt(4.0 ** n_iters - 1.0)
        a = np.exp(-np.sqrt(2.0) / sigma_h)
        out = _rf_rows_f64(out, a ** (1.0 + sigma_s / sigma_r * np.abs(gx)))
        out = _rf_rows_f64(out.T, a ** (1.0 + sigma_s / sigma_r * np.abs(gy.T))).T
    return out


def _thomas_f64(b, a, c, d):
    n, L = b.shape
    cp, dp = np.zeros((n, L)), np.zeros((n, L))
    cprev, dprev = np.zeros(n), np.zeros(n)
    for i in range(L):
        den = b[:, i] - a[:, i] * cprev
        cp[:, i] = c[:, i] / den
        dp[:, i] = (d[:, i] - a[:, i] * dprev) / den
        cprev, dprev = cp[:, i], dp[:, i]
    x = np.zeros((n, L))
    nxt = np.zeros(n)
    for i in range(L - 1, -1, -1):
        x[:, i] = dp[:, i] - cp[:, i] * nxt
        nxt = x[:, i]
    return x


def _fgs_f64(guide, src, lam, sigma_color, n_iters=3):
    def pass_(s, g, lam_t):
        w = np.exp(-np.abs(g[:, 1:] - g[:, :-1]) / sigma_color)
        z = np.zeros((w.shape[0], 1))
        wl, wr = np.concatenate([z, w], 1), np.concatenate([w, z], 1)
        return _thomas_f64(1.0 + lam_t * (wl + wr), -lam_t * wl, -lam_t * wr, s)

    out, g = src.astype(np.float64), guide.astype(np.float64)
    for t in range(1, n_iters + 1):
        lam_t = 1.5 * lam * 4.0 ** (n_iters - t) / (4.0 ** n_iters - 1.0)
        out = pass_(pass_(out, g, lam_t).T, g.T, lam_t).T
    return out


def _iir_f64(x, a1, a2, a3, a4, b1, b2):
    Hh, L = x.shape
    yp, ym = np.zeros((Hh, L)), np.zeros((Hh, L))
    y1 = y2 = x1 = np.zeros(Hh)
    for i in range(L):
        y = a1 * x[:, i] + a2 * x1 + b1 * y1 + b2 * y2
        yp[:, i], y1, y2, x1 = y, y, y1, x[:, i]
    y1 = y2 = x1 = x2 = np.zeros(Hh)
    for i in range(L - 1, -1, -1):
        y = a3 * x1 + a4 * x2 + b1 * y1 + b2 * y2
        ym[:, i], y1, y2, x1, x2 = y, y, y1, x[:, i], x1
    return yp + ym


def _deriche_x_f64(img, alpha, smooth_alpha=None):
    sa = alpha if smooth_alpha is None else smooth_alpha
    ea, e2a = np.exp(-sa), np.exp(-2.0 * sa)
    k = (1 - ea) ** 2 / (1 + 2 * sa * ea - e2a)
    s = _iir_f64(img.astype(np.float64).T, k, k * ea * (sa - 1.0), k * ea * (sa + 1.0), -k * e2a, 2 * ea, -e2a).T
    ea, e2a = np.exp(-alpha), np.exp(-2.0 * alpha)
    a = -((1 - ea) ** 3) / (2.0 * (1 + ea))
    return _iir_f64(s, 0, a, 0, 0, 2 * ea, -e2a) + _iir_f64(s, 0, 0, -a, 0, 2 * ea, -e2a)


def _held_to_f64(port, ref, f64, what, bound=1e-5):
    """Each float32 result within bound (relative to the output's range) of
    the float64 recompute, and the two within twice the larger distance."""
    scale = max(float(np.ptp(f64)), 1e-6)
    d_port, d_ref = np.abs(port - f64).max(), np.abs(ref - f64).max()
    assert d_port <= bound * scale and d_ref <= bound * scale, (what, d_port, d_ref, scale)
    assert np.abs(port - ref).max() <= 2 * max(d_port, d_ref) + 1e-12, (what, np.abs(port - ref).max())


# --- filters_x --------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(INPUTS))
def test_anisotropic_diffusion(case):
    _, img = INPUTS[case]
    ref = np.asarray(jx.anisotropic_diffusion(jnp.asarray(img), n_iters=30))
    got = N(tx.anisotropic_diffusion(T(img), n_iters=30))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", sorted(INPUTS))
def test_rolling_guidance_filter(case):
    _, img = INPUTS[case]
    ref = np.asarray(J_ROLLING(jnp.asarray(img)))
    got = N(tx.rolling_guidance_filter(T(img), sigma_s=2.0, sigma_r=0.2, n_iters=2))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", sorted(INPUTS))
def test_dt_filter_against_float64(case):
    _, img = INPUTS[case]
    ref = np.asarray(J_DT(jnp.asarray(img), jnp.asarray(img)))
    got = N(tx.dt_filter(T(img), T(img), sigma_s=10.0, sigma_r=0.15))
    _held_to_f64(got, ref, _dt_f64(img, img, 10.0, 0.15, 3), "dt_filter")


@pytest.mark.parametrize("case", sorted(INPUTS))
def test_niblack_and_ridge(case):
    _, img = INPUTS[case]
    np.testing.assert_array_equal(N(tx.niblack_threshold(T(img), block_radius=5)),
                                  np.asarray(J_NIBLACK(jnp.asarray(img))))
    np.testing.assert_allclose(N(tx.ridge_filter(T(img), sigma=1.5)),
                               np.asarray(J_RIDGE(jnp.asarray(img))), rtol=0, atol=1e-5)


def test_filters_x_gates():
    """tests/test_ximgproc.py::TestFilters through the port."""
    rng = np.random.default_rng(0)
    edge = np.full((64, 64), 0.3, np.float32)
    edge[:, 32:] = 0.8
    edge = edge + rng.normal(scale=0.02, size=edge.shape).astype(np.float32)
    out = N(tx.anisotropic_diffusion(T(edge), n_iters=30))
    assert out[10:20, 5:25].std() < edge[10:20, 5:25].std() * 0.5
    assert (out[:, 36:].mean() - out[:, :28].mean()) > 0.4
    out = N(tx.dt_filter(T(edge), T(edge), sigma_s=10.0, sigma_r=0.15))
    assert out[10:20, 5:25].std() < edge[10:20, 5:25].std()
    assert (out[:, 40:].mean() - out[:, :24].mean()) > 0.4
    base = np.full((48, 48), 0.5, np.float32)
    base[:, 24:] = 0.9
    textured = base + 0.1 * np.sin(np.arange(48) * 2.0)[None, :].astype(np.float32)
    out = N(tx.rolling_guidance_filter(T(textured), sigma_s=2.0, sigma_r=0.2))
    assert out[:, 4:20].std() < 0.03 and (out[:, 36:].mean() - out[:, :12].mean()) > 0.3
    img = rng.uniform(size=(32, 32)).astype(np.float32)
    img[10:20, 10:20] += 2.0
    assert bool(tx.niblack_threshold(T(img), block_radius=5)[14, 14])
    ridge = np.zeros((48, 48), np.float32)
    ridge[24] = 1.0
    out = N(tx.ridge_filter(T(ridge), sigma=1.5))
    assert np.abs(out[24, 10:-10]).mean() > np.abs(out[10, 10:-10]).mean() * 3


# --- filters_x2 -------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(INPUTS))
def test_fast_global_smoother_against_float64(case):
    guide, img = INPUTS[case]
    ref = np.asarray(jx.fast_global_smoother(jnp.asarray(guide), jnp.asarray(img), lam=64.0, sigma_color=0.1))
    got = N(tx.fast_global_smoother(T(guide), T(img), lam=64.0, sigma_color=0.1))
    _held_to_f64(got, ref, _fgs_f64(guide, img, 64.0, 0.1), "fast_global_smoother")


def test_disparity_wls_filter_against_float64():
    rng = np.random.default_rng(5)
    dL = np.full((H, W), 8.0, np.float32)
    dL[:, W // 2:] = 12.0
    dL[5:9, 5:9] = 0.0  # a hole: the left-right check fails there
    dR = np.full((H, W), 8.0, np.float32)
    dR[:, W // 2 - 12:] = 12.0
    guide = (dL / 12.0 + rng.normal(0, 0.01, (H, W))).astype(np.float32)
    (rf, rc), (gf, gc) = (jx.disparity_wls_filter(jnp.asarray(dL), jnp.asarray(dR), jnp.asarray(guide)),
                          tx.disparity_wls_filter(T(dL), T(dR), T(guide)))
    np.testing.assert_allclose(N(gc), np.asarray(rc), rtol=0, atol=1e-6)
    conf = N(gc).astype(np.float64)
    num = _fgs_f64(guide, conf * dL, 8000.0, 1.0 / 255.0)
    den = _fgs_f64(guide, conf, 8000.0, 1.0 / 255.0)
    _held_to_f64(N(gf), np.asarray(rf), num / np.maximum(den, 1e-6), "disparity_wls_filter", bound=1e-4)


@pytest.mark.parametrize("case", sorted(INPUTS))
def test_l0_and_texture_filters(case):
    guide, img = INPUTS[case]
    np.testing.assert_allclose(N(tx.l0_smooth(T(img), lam=0.02)),
                               np.asarray(jx.l0_smooth(jnp.asarray(img), lam=0.02)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(N(tx.bilateral_texture_filter(T(img), fr=2)),
                               np.asarray(jx.bilateral_texture_filter(jnp.asarray(img), fr=2)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        N(tx.joint_bilateral_filter(T(guide), T(img), sigma_s=2.0, sigma_r=0.2, radius=3)),
        np.asarray(J_JBF(jnp.asarray(guide), jnp.asarray(img))),
        rtol=0, atol=1e-6)
    got = N(tx.weighted_median_filter(T(guide), T(img), radius=3, n_bins=8))
    ref = np.asarray(jx.weighted_median_filter(jnp.asarray(guide), jnp.asarray(img), radius=3, n_bins=8))
    lo, span = img.min(), img.max() - img.min()
    np.testing.assert_array_equal(np.round((got - lo) / span * 7), np.round((ref - lo) / span * 7))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(N(tx.edge_preserving_filter(T(img), radius=3, threshold=0.3)),
                                  np.asarray(jx.edge_preserving_filter(jnp.asarray(img), radius=3, threshold=0.3)))


@pytest.mark.parametrize("case", sorted(INPUTS))
def test_iir_gradients_against_float64(case):
    _, img = INPUTS[case]
    for alpha in (1.0, 1.5):
        _held_to_f64(N(tx.deriche_gradient_x(T(img), alpha=alpha)),
                     np.asarray(jx.deriche_gradient_x(jnp.asarray(img), alpha=alpha)), _deriche_x_f64(img, alpha),
                     "deriche_gradient_x")
        _held_to_f64(N(tx.deriche_gradient_y(T(img), alpha=alpha)),
                     np.asarray(jx.deriche_gradient_y(jnp.asarray(img), alpha=alpha)),
                     _deriche_x_f64(img.T, alpha).T, "deriche_gradient_y")
    eff = np.sqrt(1.0 + 0.2 ** 2)
    _held_to_f64(N(tx.paillou_gradient_x(T(img), alpha=1.0, omega=0.2)),
                 np.asarray(jx.paillou_gradient_x(jnp.asarray(img), alpha=1.0, omega=0.2)),
                 _deriche_x_f64(img, 1.0, eff), "paillou_gradient_x")
    _held_to_f64(N(tx.paillou_gradient_y(T(img), alpha=1.0, omega=0.2)),
                 np.asarray(jx.paillou_gradient_y(jnp.asarray(img), alpha=1.0, omega=0.2)),
                 _deriche_x_f64(img.T, 1.0, eff).T, "paillou_gradient_y")


@pytest.mark.parametrize("case", sorted(INPUTS))
def test_adaptive_manifold_and_bilateral_solver(case):
    guide, img = INPUTS[case]
    ref = np.asarray(J_AMF(jnp.asarray(guide), jnp.asarray(img)))
    np.testing.assert_allclose(N(tx.adaptive_manifold_filter(T(guide), T(img), sigma_s=8.0, sigma_r=0.3)), ref,
                               rtol=0, atol=1e-5)
    conf = np.ones_like(guide)
    ref = np.asarray(jx.fast_bilateral_solver(jnp.asarray(guide), jnp.asarray(img), jnp.asarray(conf), lam=4.0,
                                              radius=2))
    np.testing.assert_allclose(N(tx.fast_bilateral_solver(T(guide), T(img), T(conf), lam=4.0, radius=2)), ref,
                               rtol=0, atol=1e-5)


def test_filters_x2_gates():
    """tests/test_ximgproc3.py's filter gates through the port."""
    clean, noisy = _step_image()
    out = N(tx.fast_global_smoother(T(clean), T(noisy), lam=64.0, sigma_color=0.1))
    assert out[:, :20].std() < noisy[:, :20].std() * 0.5 and abs(out[:, 40:].mean() - out[:, :20].mean()) > 0.8
    g = torch.ones((16, 16))
    np.testing.assert_allclose(N(tx.fast_global_smoother(g, g * 3.0, lam=32.0)), 3.0, atol=1e-4)
    d = torch.full((32, 48), 8.0)
    filt, conf = tx.disparity_wls_filter(d, d, torch.zeros((32, 48)))
    assert float(conf.mean()) > 0.9
    np.testing.assert_allclose(N(filt), 8.0, atol=0.2)
    _, noisy8 = _step_image(noise=0.08)
    out = N(tx.l0_smooth(T(noisy8), lam=0.02))
    assert out[:, :20].std() < 0.02 and abs(out[:, 44:].mean() - out[:, :20].mean()) > 0.8
    rng = np.random.default_rng(1)
    tex = (0.5 + 0.3 * np.sign(rng.normal(size=(40, 40)))).astype(np.float32)
    assert N(tx.bilateral_texture_filter(T(tex), fr=2)).std() < tex.std() * 0.8
    assert N(tx.joint_bilateral_filter(T(clean), T(noisy), 2.0, 0.2, 3))[:, :20].std() < noisy[:, :20].std()
    sp = clean.copy()
    sp[10, 10] = 5.0
    assert abs(N(tx.weighted_median_filter(T(clean), T(sp), radius=3, n_bins=8))[10, 10]) < 0.5
    out = N(tx.edge_preserving_filter(T(noisy), radius=3, threshold=0.3))
    assert out[:, :20].std() < noisy[:, :20].std() and abs(out[:, 44:].mean() - out[:, :20].mean()) > 0.8
    assert N(tx.adaptive_manifold_filter(T(clean), T(noisy), 8.0, 0.3))[:, :20].std() < noisy[:, :20].std()
    out = N(tx.fast_bilateral_solver(T(clean), T(noisy), torch.ones((48, 64)), lam=4.0, radius=2))
    assert out[:, :20].std() < noisy[:, :20].std() * 0.7 and abs(out[:, 44:].mean() - out[:, :20].mean()) > 0.8
    ramp = np.tile(np.arange(64, dtype=np.float32), (32, 1))
    np.testing.assert_allclose(N(tx.deriche_gradient_x(T(ramp), alpha=1.5))[10:-10, 20:-20], 1.0, atol=0.05)
    r2 = np.random.default_rng(2).normal(size=(32, 48)).astype(np.float32)
    np.testing.assert_allclose(N(tx.deriche_gradient_y(T(r2))), N(tx.deriche_gradient_x(T(r2.T))).T, atol=1e-4)
    gx = N(tx.paillou_gradient_x(T(clean), alpha=1.0, omega=0.2))
    assert np.abs(gx).argmax(axis=1).mean() == pytest.approx(32, abs=1.5)


# --- fourier ----------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("normalize", [True, False])
def test_fourier_descriptors(normalize):
    t = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    ellipse = np.stack([20 * np.sin(t), 40 * np.cos(t)], axis=1).astype(np.float32)
    rnd = np.random.default_rng(3).normal(size=(40, 2)).astype(np.float32) * 10
    for c in (ellipse, rnd):
        ref = np.asarray(jx.fourier_descriptors(jnp.asarray(c), normalize=normalize))
        got = N(tx.fourier_descriptors(T(c), normalize=normalize))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * max(1.0, float(np.abs(ref).max())))
    if normalize:  # tests/test_ximgproc.py::TestFourier's invariance gate
        c, s = np.cos(0.7), np.sin(0.7)
        e2 = 2.5 * ellipse @ np.array([[c, -s], [s, c]], np.float32).T + np.array([100, -50], np.float32)
        np.testing.assert_allclose(N(tx.fourier_descriptors(T(ellipse))),
                                   N(tx.fourier_descriptors(T(e2.astype(np.float32)))), atol=1e-2)
