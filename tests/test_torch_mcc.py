"""Parity of the port's colour chart (opencv_contrib_tpu_torch.mcc: the
CCM fit and its application, the chart cells, the chart detector) with the
JAX package on the CPU, on tests/test_mcc_perspective.py's and
tests/test_breadth7.py::TestMccDetector's fixtures.

Tolerances: the CCM rtol 1e-4 / atol 2e-5 (lstsq by different LAPACK
routines on a well-posed 24 x 3 system); its application 1e-5; the cell
centres and boxes equal; the detected colours equal (sampled on the host
from the same homography, the lattice RANSAC on the same seeded draws)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu.mcc import ccm as jccm
from opencv_contrib_tpu.mcc import detector as jdet
from opencv_contrib_tpu_torch.mcc import ccm as tccm
from opencv_contrib_tpu_torch.mcc import detector as tdet

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _chart_image(cell: int = 22, gutter: int = 5):
    """test_mcc_perspective.py::_chart_image."""
    ref = np.asarray(jccm.MACBETH_SRGB, np.float32).reshape(4, 6, 3)
    img = np.zeros((4 * cell + 5 * gutter, 6 * cell + 7 * gutter, 3), np.float32)
    for r in range(4):
        for c in range(6):
            y0, x0 = gutter + r * (cell + gutter), gutter + c * (cell + gutter)
            img[y0:y0 + cell, x0:x0 + cell] = ref[r, c]
    return img, ref


def _warp(img, H, out_shape):
    """test_mcc_perspective.py::_warp."""
    Ho, Wo = out_shape
    src = np.linalg.inv(H) @ np.stack([*np.mgrid[0:Ho, 0:Wo][::-1].reshape(2, -1), np.ones(Ho * Wo)])
    xi, yi = np.round(src[0] / src[2]).astype(int), np.round(src[1] / src[2]).astype(int)
    ok = (xi >= 0) & (xi < img.shape[1]) & (yi >= 0) & (yi < img.shape[0])
    out = np.zeros((Ho * Wo, 3), np.float32)
    out[ok] = img[yi[ok], xi[ok]]
    return out.reshape(Ho, Wo, 3)


def _rotation_h(deg, center, offset):
    th = np.radians(deg)
    c, s = np.cos(th), np.sin(th)
    T1 = np.array([[1, 0, -center[0]], [0, 1, -center[1]], [0, 0, 1.0]])
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    T2 = np.array([[1, 0, offset[0]], [0, 1, offset[1]], [0, 0, 1.0]])
    return T2 @ R @ T1


def _fixture(name):
    img, _ = _chart_image()
    if name == "axis":
        return img
    if name == "rotated30":
        return _warp(img, _rotation_h(30.0, (img.shape[1] / 2, img.shape[0] / 2), (130, 120)), (260, 260))
    if name == "perspective":
        h, w = img.shape[:2]
        src = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
        dst = np.array([[20, 28], [205, 12], [225, 135], [12, 165]], np.float64)
        return _warp(img, jdet._fit_homography_np(src, dst), (190, 250))
    if name == "occluded":
        img[5 + 1 * 27:5 + 1 * 27 + 22, 5 + 2 * 27:5 + 2 * 27 + 22] = 0.0
        img[5 + 2 * 27:5 + 2 * 27 + 22, 5 + 4 * 27:5 + 4 * 27 + 22] = 0.0
        return _warp(img, _rotation_h(15.0, (img.shape[1] / 2, img.shape[0] / 2), (120, 110)), (240, 240))
    if name == "ccm20":
        return _warp(img, _rotation_h(20.0, (img.shape[1] / 2, img.shape[0] / 2), (120, 115)), (240, 240))
    if name == "breadth7":  # TestMccDetector._chart
        ref = np.asarray(jccm.MACBETH_SRGB, np.float32).reshape(4, 6, 3)
        out = np.zeros((4 * 20 + 10, 6 * 20 + 10, 3), np.float32)
        for r in range(4):
            for c in range(6):
                out[5 + r * 20 + 2:5 + r * 20 + 18, 5 + c * 20 + 2:5 + c * 20 + 18] = ref[r, c]
        return out
    raise KeyError(name)


@pytest.mark.parametrize("ccm_3x4", [False, True])
def test_fit_and_apply_ccm(rng, ccm_3x4):
    ref = np.asarray(jccm.MACBETH_SRGB, np.float32)
    measured = np.clip(ref @ np.array([[0.9, 0.05, 0.0], [0.1, 0.8, 0.1], [0.0, 0.1, 1.1]], np.float32).T + 0.02
                       + rng.normal(0, 0.01, ref.shape).astype(np.float32), 0, 1)
    tM = tccm.fit_ccm(measured, ref, ccm_3x4=ccm_3x4)
    jM = jccm.fit_ccm(jnp.asarray(measured), jnp.asarray(ref), ccm_3x4=ccm_3x4)
    np.testing.assert_allclose(N(tM), np.asarray(jM), rtol=1e-4, atol=2e-5)
    img = rng.uniform(size=(16, 20, 3)).astype(np.float32)
    np.testing.assert_allclose(N(tccm.apply_ccm(T(img), T(np.asarray(jM)))), np.asarray(jccm.apply_ccm(jnp.asarray(img), jM)),
                               rtol=1e-5, atol=1e-5)
    if not ccm_3x4:
        tM2, fn = tccm.color_correction_model(measured)
        np.testing.assert_allclose(N(fn(T(img))), N(tccm.apply_ccm(T(img), tM2)))


@pytest.mark.parametrize("name", ["axis", "rotated30", "perspective", "occluded"])
def test_find_chart_cells(name):
    img = _fixture(name)
    tc, tb = tdet.find_chart_cells(T(img.mean(-1)))
    jc, jb = jdet.find_chart_cells(img.mean(-1))
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize("name", ["axis", "rotated30", "perspective", "occluded", "breadth7"])
def test_detect_chart(name):
    img = _fixture(name)
    tcol, tcen = tdet.detect_chart(T(img))
    jcol, jcen = jdet.detect_chart(img)
    np.testing.assert_array_equal(tcen, jcen)
    assert (tcol is None) == (jcol is None) and tcol is not None
    np.testing.assert_array_equal(tcol, jcol)


@pytest.mark.parametrize("name", ["ccm20", "breadth7"])
def test_detect_and_fit_ccm(name):
    img = _fixture(name)
    tM, tmeas = tdet.detect_and_fit_ccm(T(img))
    jM, jmeas = jdet.detect_and_fit_ccm(img)
    np.testing.assert_array_equal(tmeas, jmeas)
    np.testing.assert_allclose(N(tM), np.asarray(jM), rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(N(tM), np.eye(3), atol=0.1)
