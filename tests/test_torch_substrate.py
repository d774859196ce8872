"""Parity of the port's image substrate (opencv_contrib_tpu_torch.ops) with
the JAX package on the CPU: the fast Gaussian blur and its box passes, Scharr
and Laplacian, the squared integral, the samplers and warps of ops.image,
morphology, connected components and template matching. The inputs are
the same numpy arrays from a seed; frames that reach a summed-area table
are integers, so both tables are exact (ROADMAP rule 2).

Tolerances:
- bits equal: the box passes and the fast Gaussian blur at sigma >= 3 (both
  tables come from the same summation order on the CPU), its batched form,
  Scharr, the squared integral, morphology, CCL labels and pass count,
  component_stats, nearest sampling;
- the separable Gaussian below sigma 3: atol 1e-4 on 0..255 (the JAX
  version's convolution sums its taps in another order);
- bilinear samplers and warps: atol 1e-4;
- Laplacian: atol 1e-4;
- template matching: the locations of min_max_loc equal; the surfaces within
  1e-5 of their range (the correlation is a convolution on both sides, in
  different orders).
The JAX tests' own gates run through the port too (tests/test_text.py's CCL
cases, tests/test_core.py's nms2d, tests/test_breadth8.py's template
modes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu.ops import ccl as jccl
from opencv_contrib_tpu.ops import filters as jfilt
from opencv_contrib_tpu.ops import image as jimage
from opencv_contrib_tpu.ops import integral as jinteg
from opencv_contrib_tpu.ops import morphology as jmorph
from opencv_contrib_tpu.ops import template_match as jtm
from opencv_contrib_tpu_torch import ops
from opencv_contrib_tpu_torch.ops import ccl as tccl
from opencv_contrib_tpu_torch.ops import filters as tfilt
from opencv_contrib_tpu_torch.ops import image as timage
from opencv_contrib_tpu_torch.ops import integral as tinteg
from opencv_contrib_tpu_torch.ops import morphology as tmorph
from opencv_contrib_tpu_torch.ops import template_match as ttm

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _frame(rng, shape=(37, 53), hi=255):
    return np.round(rng.uniform(0, hi, shape)).astype(np.float32)


# --- filters ------------------------------------------------------------------


@pytest.mark.parametrize("radius", [1, 2, 3, 5])
def test_box_blur_cumsum_bits(rng, radius):
    img = _frame(rng)
    ref = np.asarray(jfilt._box_blur_cumsum(jnp.asarray(img), radius))
    np.testing.assert_array_equal(N(tfilt._box_blur_cumsum(T(img), radius)), ref)


@pytest.mark.parametrize("sigma", [1.5, 2.5, 3.0, 4.2, 7.6])
def test_fast_gaussian_blur(rng, sigma):
    img = _frame(rng)
    ref = np.asarray(jfilt.fast_gaussian_blur(jnp.asarray(img), sigma))
    out = N(tfilt.fast_gaussian_blur(T(img), sigma))
    if sigma >= 3.0:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("sigma", [2.0, 4.2])
def test_fast_gaussian_blur_batched(rng, sigma):
    """Leading dimensions are maps blurred alike: the JAX version's vmap."""
    cube = _frame(rng, (2, 3, 30, 41))
    ref = np.asarray(jax.vmap(jax.vmap(lambda m: jfilt.fast_gaussian_blur(m, sigma)))(jnp.asarray(cube)))
    out = N(tfilt.fast_gaussian_blur(T(cube), sigma))
    assert out.shape == cube.shape
    if sigma >= 3.0:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
        # the batched separable pass gives each map the bits of the 2D one
        np.testing.assert_array_equal(out[1, 2], N(tfilt.fast_gaussian_blur(T(cube[1, 2]), sigma)))


def test_fast_gaussian_blur_reads_the_integral_module(rng, monkeypatch):
    """The box passes call ops.integral.integral through the module, so
    swapping integral_padded there (as chip_smoke's plain_path does) reaches
    them."""
    calls = []
    orig = tinteg.integral_padded

    def spy(x):
        calls.append(tuple(x.shape))
        return orig(x)

    monkeypatch.setattr(tinteg, "integral_padded", spy)
    tfilt.fast_gaussian_blur(T(_frame(rng, (20, 30))), 4.2)
    assert len(calls) == 3 and all(c[0] > 20 and c[1] > 30 for c in calls)


@pytest.mark.parametrize("dxdy", [(1, 0), (0, 1), (1, 1)])
def test_scharr(rng, dxdy):
    img = _frame(rng)
    ref = np.asarray(jfilt.scharr(jnp.asarray(img), *dxdy))
    np.testing.assert_array_equal(N(tfilt.scharr(T(img), *dxdy)), ref)


def test_laplacian(rng):
    img = _frame(rng)
    ref = np.asarray(jfilt.laplacian(jnp.asarray(img)))
    np.testing.assert_allclose(N(tfilt.laplacian(T(img))), ref, atol=1e-4, rtol=0)


def test_integral_sq(rng):
    img = _frame(rng, (31, 45), hi=40)
    ref = [np.asarray(a) for a in jinteg.integral_sq(jnp.asarray(img))]
    out = [N(a) for a in tinteg.integral_sq(T(img))]
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


# --- image ----------------------------------------------------------------------


def test_sample_nearest(rng):
    img = rng.normal(size=(12, 17)).astype(np.float32)
    y = np.concatenate([rng.uniform(-3, 15, 40), [2.5, 3.5, -0.5]]).astype(np.float32)
    x = np.concatenate([rng.uniform(-3, 20, 40), [4.5, 5.5, 16.5]]).astype(np.float32)
    ref = np.asarray(jimage.sample_nearest(jnp.asarray(img), jnp.asarray(y), jnp.asarray(x)))
    np.testing.assert_array_equal(N(timage.sample_nearest(T(img), T(y), T(x))), ref)


def test_sample_bilinear_valid(rng):
    img = rng.normal(size=(12, 17, 2)).astype(np.float32)
    y = rng.uniform(-2, 14, (5, 6)).astype(np.float32)
    x = rng.uniform(-2, 19, (5, 6)).astype(np.float32)
    rv, rm = jimage.sample_bilinear_valid(jnp.asarray(img), jnp.asarray(y), jnp.asarray(x))
    v, m = timage.sample_bilinear_valid(T(img), T(y), T(x))
    np.testing.assert_allclose(N(v), np.asarray(rv), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(N(m), np.asarray(rm))


def test_warp_perspective_and_remap(rng):
    img = rng.uniform(0, 1, (24, 31)).astype(np.float32)
    Hm = np.array([[1.02, 0.03, 1.5], [-0.02, 0.98, -2.0], [1e-4, -2e-4, 1.0]], np.float32)
    ref = np.asarray(jimage.warp_perspective(jnp.asarray(img), jnp.asarray(Hm), out_hw=(20, 28)))
    np.testing.assert_allclose(N(timage.warp_perspective(T(img), T(Hm), out_hw=(20, 28))), ref, atol=1e-4, rtol=0)
    my = rng.uniform(-2, 26, (20, 28)).astype(np.float32)
    mx = rng.uniform(-2, 33, (20, 28)).astype(np.float32)
    ref = np.asarray(jimage.remap(jnp.asarray(img), jnp.asarray(my), jnp.asarray(mx)))
    np.testing.assert_allclose(N(timage.remap(T(img), T(my), T(mx))), ref, atol=1e-4, rtol=0)
    # tests/test_core.py's translation gate
    Ht = np.array([[1.0, 0.0, 3.0], [0.0, 1.0, 2.0], [0.0, 0.0, 1.0]], np.float32)
    out = N(timage.warp_perspective(T(img), T(Ht)))
    np.testing.assert_allclose(out[:-2, :-3], img[2:, 3:], atol=1e-5)


@pytest.mark.parametrize("size", [5, 8])
def test_extract_patches(rng, size):
    img = rng.uniform(0, 255, (40, 50)).astype(np.float32)
    c = rng.uniform(-3, 45, (7, 2)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, 7).astype(np.float32)
    sc = rng.uniform(0.5, 2.0, 7).astype(np.float32)
    ref = np.asarray(jimage.extract_patches(jnp.asarray(img), jnp.asarray(c), size))
    np.testing.assert_allclose(N(timage.extract_patches(T(img), T(c), size)), ref, atol=1e-4, rtol=0)
    ref = np.asarray(jimage.extract_rotated_patches(jnp.asarray(img), jnp.asarray(c), jnp.asarray(ang),
                                                    jnp.asarray(sc), size))
    out = N(timage.extract_rotated_patches(T(img), T(c), T(ang), T(sc), size))
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


# --- morphology -------------------------------------------------------------------


@pytest.mark.parametrize("size", [2, 3, 4, 5])
@pytest.mark.parametrize("fn", ["dilate", "erode", "opening", "closing", "nms2d"])
def test_morphology_bits(rng, fn, size):
    """Even windows too: reduce_window's "SAME" pads them asymmetrically."""
    img = rng.normal(size=(19, 26)).astype(np.float32)
    img[3:6, 4:8] = 1.5  # plateaus: ties in nms2d
    ref = np.asarray(getattr(jmorph, fn)(jnp.asarray(img), size))
    np.testing.assert_array_equal(N(getattr(tmorph, fn)(T(img), size)), ref)


def test_morphology_iterations(rng):
    img = rng.normal(size=(19, 26)).astype(np.float32)
    for fn in ("dilate", "erode"):
        ref = np.asarray(getattr(jmorph, fn)(jnp.asarray(img), 3, iterations=3))
        np.testing.assert_array_equal(N(getattr(tmorph, fn)(T(img), 3, iterations=3)), ref)


@pytest.mark.parametrize("stride", [2, 3, 4])
def test_maxpool_valid(rng, stride):
    img = rng.normal(size=(19, 26)).astype(np.float32)
    ref = np.asarray(jmorph.maxpool(jnp.asarray(img), stride))
    out = N(tmorph.maxpool(T(img), stride))
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_nms2d_gate():
    """tests/test_core.py::test_nms2d through the port."""
    r = torch.zeros(9, 9)
    r[4, 4], r[2, 2] = 5.0, 3.0
    m = tmorph.nms2d(r)
    assert bool(m[4, 4]) and not bool(m[4, 5])


# --- connected components -----------------------------------------------------------


def _snake(n=20):
    m = np.zeros((n, n), bool)
    for r in range(0, n, 2):
        m[r, :] = True
        m[min(r + 1, n - 1), -1 if (r // 2) % 2 == 0 else 0] = True
    return m


def _masks(rng):
    return {"random_45": rng.uniform(size=(40, 57)) > 0.55, "random_30": rng.uniform(size=(33, 48)) > 0.7,
            "snake": _snake(), "snake_40": _snake(40), "empty": np.zeros((9, 11), bool),
            "full": np.ones((9, 11), bool)}


@pytest.mark.parametrize("name", ["random_45", "random_30", "snake", "snake_40", "empty", "full"])
@pytest.mark.parametrize("connectivity", [4, 8])
def test_ccl_labels_and_passes(rng, name, connectivity):
    """The labels and the pass count equal, whatever the group of passes a
    read: the snakes take passes past one group."""
    m = _masks(rng)[name]
    rl, rn = jccl.connected_components(jnp.asarray(m), connectivity=connectivity)
    labels, n = tccl.connected_components(T(m), connectivity=connectivity)
    np.testing.assert_array_equal(N(labels), np.asarray(rl))
    assert labels.dtype == torch.int32 and int(n) == int(rn)


@pytest.mark.parametrize("max_iters", [1, 3, 8, 9, 13])
def test_ccl_max_iters(max_iters):
    """The pass cap cuts the flood where the JAX loop cuts it, inside a group
    of passes, at its end and past it."""
    m = _snake(40)
    rl, rn = jccl.connected_components(jnp.asarray(m), max_iters=max_iters)
    labels, n = tccl.connected_components(T(m), max_iters=max_iters)
    np.testing.assert_array_equal(N(labels), np.asarray(rl))
    assert int(n) == int(rn) == max_iters


def test_ccl_reads_the_flag_once_a_group(monkeypatch):
    """One host read of the stop flag a group of passes, not one a pass."""
    reads = []
    orig = torch.Tensor.__bool__

    def spy(self):
        reads.append(1)
        return orig(self)

    m = _snake(40)
    _, rn = jccl.connected_components(jnp.asarray(m))
    monkeypatch.setattr(torch.Tensor, "__bool__", spy)
    _, n = tccl.connected_components(T(m))
    monkeypatch.undo()
    assert int(n) == int(rn) > tccl.PASSES_A_READ
    assert len(reads) == -(-int(n) // tccl.PASSES_A_READ)


@pytest.mark.parametrize("max_components", [4, 64])
def test_component_stats_bits(rng, max_components):
    """max_components 4 puts most components in the dropped overflow slot."""
    m = rng.uniform(size=(40, 57)) > 0.55
    vals = rng.normal(size=m.shape).astype(np.float32)
    rl, _ = jccl.connected_components(jnp.asarray(m), connectivity=8)
    ref = jccl.component_stats(rl, jnp.asarray(vals), max_components=max_components)
    out = tccl.component_stats(T(np.asarray(rl)), T(vals), max_components=max_components)
    assert list(out) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(N(out[k]), np.asarray(ref[k]), err_msg=k)
        assert N(out[k]).dtype == np.asarray(ref[k]).dtype, k


def test_ccl_gates_of_the_jax_tests():
    """tests/test_text.py::TestCcl through the port."""
    m = np.zeros((16, 16), bool)
    m[2:5, 2:5] = True
    m[10:14, 9:15] = True
    lab = N(tccl.connected_components(T(m))[0])
    assert len(np.unique(lab[lab >= 0])) == 2 and lab[0, 0] == -1
    assert (lab[2:5, 2:5] == lab[2, 2]).all() and (lab[10:14, 9:15] == lab[10, 9]).all()
    m = np.zeros((16, 16), bool)
    m[2:5, 2:6] = True
    labels, _ = tccl.connected_components(T(m))
    st = tccl.component_stats(labels, values=torch.ones(16, 16), max_components=8)
    assert N(st["area"])[N(st["valid"])].tolist() == [12.0]
    i = int(torch.argmax(st["area"]))
    assert (float(st["y0"][i]), float(st["x0"][i]), float(st["y1"][i]), float(st["x1"][i])) == (2, 2, 4, 5)
    lab = N(tccl.connected_components(T(_snake()), connectivity=4)[0])
    assert len(np.unique(lab[lab >= 0])) == 1


# --- template matching ------------------------------------------------------------------


@pytest.mark.parametrize("method", ttm.METHODS)
def test_match_template(rng, method):
    img = _frame(rng, (64, 80))
    tm = img[20:36, 30:50].copy()
    ref = np.asarray(jtm.match_template(jnp.asarray(img), jnp.asarray(tm), method))
    out = N(ttm.match_template(T(img), T(tm), method))
    assert out.shape == ref.shape == (49, 61)
    assert np.abs(out - ref).max() <= 1e-5 * (ref.max() - ref.min())
    rv = jtm.min_max_loc(jnp.asarray(ref))
    ov = ttm.min_max_loc(T(out))
    assert ov[2:] == tuple(tuple(int(v) for v in loc) for loc in rv[2:])
    assert abs(ov[0] - rv[0]) <= 1e-5 * (ref.max() - ref.min()) and abs(ov[1] - rv[1]) <= 1e-5 * (ref.max() - ref.min())


def test_min_max_loc_ties_and_values(rng):
    r = rng.normal(size=(7, 9)).astype(np.float32)
    r[1, 2] = r[5, 6] = r.max() + 1  # a tied maximum: the first in raster order
    r[0, 8] = r[6, 0] = r.min() - 1
    ref = jtm.min_max_loc(jnp.asarray(r))
    out = ttm.min_max_loc(T(r))
    assert out[0] == ref[0] and out[1] == ref[1]
    assert out[2] == (0, 8) == tuple(int(v) for v in ref[2]) and out[3] == (1, 2) == tuple(int(v) for v in ref[3])


def test_template_modes_localize(rng):
    """tests/test_breadth8.py::TestTemplateMatch through the port."""
    img = rng.uniform(0, 1, (64, 80)).astype(np.float32)
    tm = img[20:36, 30:50].copy()
    for method, use_max in [("ccorr_normed", True), ("sqdiff", False), ("ccoeff_normed", True),
                            ("sqdiff_normed", False)]:
        _, _, mn, mx = ttm.min_max_loc(ttm.match_template(T(img), T(tm), method))
        assert (mx if use_max else mn) == (20, 30), method
    assert abs(float(ttm.match_template(T(img), T(tm), "ccoeff_normed").max()) - 1.0) < 1e-3
    with pytest.raises(ValueError):
        ttm.match_template(T(img), T(tm), "ccorr_norm")


def test_ops_exports():
    assert ops.__all__ == ["ccl", "filters", "histogram", "image", "integral", "morphology", "template_match"]
