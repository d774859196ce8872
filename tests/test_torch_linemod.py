"""Parity of the port's LINEMOD (opencv_contrib_tpu_torch.rgbd.linemod) with
the JAX package on the CPU: the colour-gradient and surface-normal
quantisation, spreading, response maps, template extraction, template
scores and detection. The inputs are the same numpy arrays from a seed.

Tolerances:
- quantisation (both modalities): at most 1e-4 of the bins apart (an atan2
  at a bin edge may flip a pixel's bin); the gradient magnitude within 1e-5;
- spreading, response maps: bits equal on the same quantised input;
- extract_template: equal offsets, orientations and size on the same input
  (both pick with numpy's argsort on the host);
- template scores: within 1e-6 (a mean of F responses summed in another
  order); detect's boxes equal and scores within 1e-6.
The JAX test's own gate (tests/test_rgbd_extras.py::TestLinemod: the
template found at 0.9 and a rotated object scoring lower) runs through the
port too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu.rgbd import linemod as jlm
from opencv_contrib_tpu_torch import interop, rgbd
from opencv_contrib_tpu_torch.rgbd import linemod as tlm

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _scene(rng, transpose=False):
    """tests/test_rgbd_extras.py::TestLinemod's scene: an L of bright strokes
    at (50, 30) on faint noise."""
    scene = rng.uniform(0, 0.05, (96, 96)).astype(np.float32)
    obj = np.zeros((24, 24), np.float32)
    obj[4:20, 4:8] = 1.0
    obj[16:20, 4:20] = 1.0
    scene[50:74, 30:54] += obj.T[::-1] if transpose else obj
    return scene


def _depth(rng, H=60, W=80):
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    d = 1.5 + 0.3 * np.sin(x / 9.0) * np.cos(y / 7.0) + 0.002 * x
    d += 0.4 * np.exp(-((y - 30) ** 2 + (x - 45) ** 2) / 60.0)
    d[rng.uniform(size=d.shape) < 0.03] = 0.0  # holes
    return d.astype(np.float32)


INTR = np.array([70.0, 70.0, 40.0, 30.0], np.float32)


@pytest.mark.parametrize("thresh", [0.05, 0.3])
def test_quantize_gradients(rng, thresh):
    img = rng.uniform(0, 1, (48, 64)).astype(np.float32)
    img[10:30, 20:40] += 1.0
    rq, rm = jlm.quantize_gradients(jnp.asarray(img), thresh)
    q, m = tlm.quantize_gradients(T(img), thresh)
    assert q.shape == (48, 64, 8) and q.dtype == torch.float32
    assert (N(q) != np.asarray(rq)).any(-1).mean() <= 1e-4
    np.testing.assert_allclose(N(m), np.asarray(rm), atol=1e-5)


def test_quantize_normals(rng):
    d = _depth(rng)
    ref = np.asarray(jlm.quantize_normals(jnp.asarray(d), jnp.asarray(INTR)))
    out = N(tlm.quantize_normals(T(d), INTR))
    assert out.shape == ref.shape == (60, 80, 8)
    assert (out != ref).any(-1).mean() <= 1e-4
    assert out.sum() > 0.3 * d.size  # the modality is not empty


@pytest.mark.parametrize("T_", [2, 4, 5])
def test_spread_and_response_maps(rng, T_):
    q = (rng.uniform(size=(30, 41, 8)) > 0.93).astype(np.float32)
    rs = np.asarray(jlm.spread(jnp.asarray(q), T_))
    s = N(tlm.spread(T(q), T_))
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(N(tlm.response_maps(T(s))), np.asarray(jlm.response_maps(jnp.asarray(rs))))


@pytest.mark.parametrize("n_features", [8, 24, 40])
def test_extract_and_match_template(rng, n_features):
    scene = _scene(rng)
    q, mag = jlm.quantize_gradients(jnp.asarray(scene))
    rt = jlm.extract_template(q, mag, (50, 30), (24, 24), n_features=n_features)
    t = tlm.extract_template(T(np.asarray(q)), T(np.asarray(mag)), (50, 30), (24, 24), n_features=n_features)
    np.testing.assert_array_equal(N(t.offsets), np.asarray(rt.offsets))
    np.testing.assert_array_equal(N(t.orientations), np.asarray(rt.orientations))
    assert t.size == rt.size == (24, 24) and type(t.size[0]) is int
    resp = np.asarray(jlm.response_maps(jlm.spread(q, 4)))
    for stride in (1, 2, 3):
        ref = np.asarray(jlm.match_template(jnp.asarray(resp), rt, stride))
        out = N(tlm.match_template(T(resp), t, stride))
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_detect(rng):
    scene = _scene(rng)
    q, mag = jlm.quantize_gradients(jnp.asarray(scene))
    rt = jlm.extract_template(q, mag, (50, 30), (24, 24), n_features=24)
    t = interop.from_numpy(rt)
    assert type(t) is tlm.Template and t.size == (24, 24)
    for thresh in (0.5, 0.9):
        rb, rsc = jlm.detect(scene, rt, thresh=thresh)
        b, sc = tlm.detect(scene, t, thresh=thresh)
        np.testing.assert_array_equal(b, rb)
        np.testing.assert_allclose(sc, rsc, atol=1e-6)


def test_linemod_gate_of_the_jax_test(rng):
    """tests/test_rgbd_extras.py::TestLinemod::test_detects_template through
    the port."""
    scene = _scene(rng)
    q, mag = tlm.quantize_gradients(T(scene))
    tmpl = tlm.extract_template(q, mag, (50, 30), (24, 24), n_features=24)
    boxes, scores = tlm.detect(scene, tmpl, thresh=0.9)
    assert len(scores) > 0
    best = boxes[np.argmax(scores)]
    assert abs(best[0] - 50) <= 4 and abs(best[1] - 30) <= 4
    _, s2 = tlm.detect(_scene(rng, transpose=True), tmpl, thresh=0.0)
    assert s2.max() < scores.max()
    assert "linemod" in rgbd.__all__
