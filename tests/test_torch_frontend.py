"""Parity of the PyTorch port's feature frontend (opencv_contrib_tpu_torch)
with the JAX package on the CPU: sampling and filters, the Fast-Hessian
detector, the SURF descriptor, the matcher, and the two-frame frontend of
`__graft_entry__.entry` on its own inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu.features import describe as jdesc
from opencv_contrib_tpu.features import detect as jdet
from opencv_contrib_tpu.features import keypoints as jkp
from opencv_contrib_tpu.features import match as jmatch
from opencv_contrib_tpu.ops import filters as jfilt
from opencv_contrib_tpu.ops import image as jimage
from opencv_contrib_tpu.ops import integral as jinteg
from opencv_contrib_tpu.ops.pallas import matching as pmatch
from opencv_contrib_tpu_torch import entry, interop
from opencv_contrib_tpu_torch.features import describe as tdesc
from opencv_contrib_tpu_torch.features import detect as tdet
from opencv_contrib_tpu_torch.features import keypoints as tkp
from opencv_contrib_tpu_torch.features import match as tmatch
from opencv_contrib_tpu_torch.ops import filters as tfilt
from opencv_contrib_tpu_torch.ops import image as timage
from opencv_contrib_tpu_torch.ops import integral as tinteg
from opencv_contrib_tpu_torch.ops.cuda import matching as fused


# The suite runs several worker processes beside XLA's thread pools; at
# these sizes torch's own per-process OpenMP pool only oversubscribes the CPU.
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _angle_diff(a, b):
    return np.abs((a - b + np.pi) % (2 * np.pi) - np.pi)


@pytest.fixture(scope="module")
def graft_inputs():
    """The exact inputs of __graft_entry__.entry (:47-49)."""
    rng = np.random.default_rng(0)
    img1 = rng.uniform(0, 255, (128, 128)).astype(np.float32)
    img2 = np.roll(img1, 5, axis=1)
    return img1, img2


@pytest.fixture(scope="module")
def jax_frontend(graft_inputs):
    """The JAX frontend of __graft_entry__.entry, stage by stage."""
    img1, img2 = (jnp.asarray(a) for a in graft_inputs)
    k1 = jdet.fast_hessian(img1, max_keypoints=128, threshold=40.0)
    k2 = jdet.fast_hessian(img2, max_keypoints=128, threshold=40.0)
    d1 = jdesc.surf_describe(img1, k1)
    d2 = jdesc.surf_describe(img2, k2)
    m = jmatch.ratio_test_match(d1, d2, k1.valid, k2.valid, ratio=0.9)
    return k1, k2, d1, d2, m


# --- substrate -------------------------------------------------------------


def test_gather2d_clips(rng):
    img = rng.normal(size=(9, 11, 3)).astype(np.float32)
    yi = rng.integers(-4, 14, size=(5, 6))
    xi = rng.integers(-4, 16, size=(5, 6))
    ref = np.asarray(jimage._gather2d(jnp.asarray(img), jnp.asarray(yi), jnp.asarray(xi)))
    np.testing.assert_array_equal(N(timage._gather2d(T(img), T(yi), T(xi))), ref)


@pytest.mark.parametrize("channels", [0, 2])
def test_sample_bilinear(rng, channels):
    shape = (20, 24) + ((channels,) if channels else ())
    img = rng.normal(size=shape).astype(np.float32)
    y = rng.uniform(-2, 22, size=(7, 9)).astype(np.float32)
    x = rng.uniform(-2, 26, size=(7, 9)).astype(np.float32)
    ref = np.asarray(jimage.sample_bilinear(jnp.asarray(img), jnp.asarray(y), jnp.asarray(x)))
    np.testing.assert_allclose(N(timage.sample_bilinear(T(img), T(y), T(x))), ref, rtol=1e-6, atol=1e-6)


def test_sample_bilinear_multi_clamp_and_wrap(rng):
    """The H-1.001 / W-1.001 clamp and the roll-wrapped corner stack."""
    maps = rng.normal(size=(3, 16, 21)).astype(np.float32)
    y = rng.uniform(-3, 19, size=(40,)).astype(np.float32)
    x = rng.uniform(-3, 24, size=(40,)).astype(np.float32)
    y[:3] = [15.0, 15.9995, 0.0]
    x[:3] = [20.0, 20.9995, 0.0]
    ref = np.asarray(jimage.sample_bilinear_multi(jnp.asarray(maps), jnp.asarray(y), jnp.asarray(x)))
    out = N(timage.sample_bilinear_multi(T(maps), T(y), T(x)))
    assert out.shape == (3, 40)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sigma,radius", [(1.0, None), (2.5, 4)])
def test_gaussian_blur_reflect_border(rng, sigma, radius):
    img = rng.uniform(0, 255, (23, 31)).astype(np.float32)
    np.testing.assert_allclose(N(tfilt.gaussian_kernel1d(sigma, radius)),
                               np.asarray(jfilt.gaussian_kernel1d(sigma, radius)), rtol=1e-6)
    ref = np.asarray(jfilt.gaussian_blur(jnp.asarray(img), sigma, radius))
    np.testing.assert_allclose(N(tfilt.gaussian_blur(T(img), sigma, radius)), ref, rtol=1e-5, atol=1e-4)


def test_sep_filter2d_asymmetric_kernels(rng):
    img = rng.normal(size=(12, 17, 2)).astype(np.float32)
    kr = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    kc = np.array([0.25], np.float32)
    ref = np.asarray(jfilt.sep_filter2d(jnp.asarray(img), jnp.asarray(kr), jnp.asarray(kc)))
    np.testing.assert_allclose(N(tfilt.sep_filter2d(T(img), T(kr), T(kc))), ref, rtol=1e-6, atol=1e-5)


def test_gradients_replicate_edges(rng):
    img = rng.uniform(0, 255, (14, 19)).astype(np.float32)
    jgy, jgx = jfilt.gradients(jnp.asarray(img))
    tgy, tgx = tfilt.gradients(T(img))
    np.testing.assert_array_equal(N(tgy), np.asarray(jgy))
    np.testing.assert_array_equal(N(tgx), np.asarray(jgx))


def test_keypoints_containers():
    y, x = [1.0, 2.0, 3.0], [4.0, 5.0, 6.0]
    jk = jkp.from_arrays(y, x, valid=[True, False, True])
    tk = tkp.from_arrays(y, x, valid=[True, False, True])
    assert tkp.Keypoints._fields == jkp.Keypoints._fields
    for a, b in zip(tk, jk):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    assert tk.capacity == jk.capacity == 3
    assert int(tk.count()) == int(jk.count()) == 2
    np.testing.assert_array_equal(N(tk.yx()), np.asarray(jk.yx()))
    np.testing.assert_array_equal(N(tk.xy()), np.asarray(jk.xy()))
    for a, b in zip(tkp.empty(4), jkp.empty(4)):
        np.testing.assert_array_equal(N(a), np.asarray(b))


# --- detector ---------------------------------------------------------------


def test_surf_filter_sizes():
    for args in [(), (4, 5), (1, 3)]:
        assert tdet.surf_filter_sizes(*args) == jdet.surf_filter_sizes(*args)


def test_topk_2stage_ties_and_chunks(rng):
    """At most 2 winners per chunk of 4096 rows; ties to the lower index."""
    flat = np.round(rng.normal(size=(50_000,)), 1).astype(np.float32)
    flat[rng.uniform(size=flat.shape) < 0.5] = -np.inf
    jv, ji = jdet._topk_2stage(jnp.asarray(flat), 300)
    tv, ti = tdet._topk_2stage(T(flat), 300)
    np.testing.assert_array_equal(N(tv), np.asarray(jv))
    np.testing.assert_array_equal(N(ti), np.asarray(ji))


@pytest.mark.parametrize("size", [9, 27, 51])
def test_hessian_response(graft_inputs, size):
    img = graft_inputs[0]
    H, W = img.shape
    P_j = jdet._padded_integral(jnp.asarray(img))
    P_t = tdet._padded_integral(tinteg.integral(T(img)))
    np.testing.assert_array_equal(N(P_t), np.asarray(P_j))
    ref = np.asarray(jdet._hessian_response(P_j, H, W, size))
    out = N(tdet._hessian_response(P_t, H, W, size))
    np.testing.assert_array_equal(np.isfinite(out), np.isfinite(ref))
    f = np.isfinite(ref)
    np.testing.assert_allclose(out[f], ref[f], rtol=1e-5, atol=1e-3)


def test_fast_hessian_matches_jax(graft_inputs, jax_frontend):
    k1 = jax_frontend[0]
    p1 = tdet.fast_hessian(T(graft_inputs[0]), max_keypoints=128, threshold=40.0)
    np.testing.assert_array_equal(N(p1.valid), np.asarray(k1.valid))
    v = np.asarray(k1.valid)
    assert v.sum() > 50
    for f in ("y", "x", "scale", "response"):
        np.testing.assert_allclose(N(getattr(p1, f)), np.asarray(getattr(k1, f)), rtol=1e-4, atol=1e-3,
                                   err_msg=f)
    assert _angle_diff(N(p1.angle), np.asarray(k1.angle)).max() < 1e-3


def test_orientation_from_same_keypoints(graft_inputs, jax_frontend):
    img = graft_inputs[1]
    k2 = jax_frontend[1]
    kz = k2._replace(angle=jnp.zeros_like(k2.angle))
    ii = jinteg.integral(jnp.asarray(img))
    ref = np.asarray(jax.jit(jdet.assign_orientation)(ii, kz).angle)
    out = N(tdet.assign_orientation(tinteg.integral(T(img)), interop.from_numpy(kz)).angle)
    assert _angle_diff(out, ref).max() < 1e-3
    np.testing.assert_allclose(N(tdet._haar_maps(tinteg.integral(T(img)))),
                               np.asarray(jax.jit(jdet._haar_maps)(ii)), rtol=1e-6, atol=1e-2)


# --- descriptor and matcher --------------------------------------------------


def test_surf_describe_same_keypoints(graft_inputs, jax_frontend):
    for img, kps, ref in ((graft_inputs[0], jax_frontend[0], jax_frontend[2]),
                          (graft_inputs[1], jax_frontend[1], jax_frontend[3])):
        out = tdesc.surf_describe(T(img), interop.from_numpy(kps))
        assert out.shape == (128, 64)
        np.testing.assert_allclose(N(out), np.asarray(ref), rtol=0, atol=1e-5)


def test_ratio_test_match_same_descriptors(jax_frontend):
    k1, k2, d1, d2, m = jax_frontend
    tm = tmatch.ratio_test_match(T(d1), T(d2), T(k1.valid), T(k2.valid), ratio=0.9)
    np.testing.assert_array_equal(N(tm.valid), np.asarray(m.valid))
    v = np.asarray(k1.valid)
    np.testing.assert_array_equal(N(tm.train_idx)[v], np.asarray(m.train_idx)[v])
    np.testing.assert_allclose(N(tm.distance), np.asarray(m.distance), rtol=1e-5, atol=1e-5)
    assert tm.train_idx.dtype == torch.int32


@pytest.mark.parametrize("cross_check", [True, False])
def test_ratio_test_match_random(rng, cross_check):
    t = rng.normal(size=(90, 32)).astype(np.float32)
    q = t[rng.permutation(90)[:70]] + rng.normal(scale=0.3, size=(70, 32)).astype(np.float32)
    qv, tv = rng.uniform(size=70) > 0.1, rng.uniform(size=90) > 0.1
    m = jmatch.ratio_test_match(jnp.asarray(q), jnp.asarray(t), jnp.asarray(qv), jnp.asarray(tv),
                                ratio=0.8, cross_check=cross_check)
    tm = tmatch.ratio_test_match(T(q), T(t), T(qv), T(tv), ratio=0.8, cross_check=cross_check)
    np.testing.assert_array_equal(N(tm.valid), np.asarray(m.valid))
    np.testing.assert_array_equal(N(tm.train_idx), np.asarray(m.train_idx))
    jd, ji = jmatch.knn2(jnp.asarray(q), jnp.asarray(t), jnp.asarray(qv), jnp.asarray(tv))
    td, ti = tmatch.knn2(T(q), T(t), T(qv), T(tv))
    np.testing.assert_allclose(N(td), np.asarray(jd), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(N(ti), np.asarray(ji))


def test_ratio_test_match_rejects_other_metrics():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="not ported"):
        tmatch.ratio_test_match(x, x, metric="hamming")


def test_fused_match_on_frontend_descriptors(jax_frontend):
    k1, k2, d1, d2, _ = jax_frontend
    ref = pmatch.ratio_test_match_fused(d1, d2, k1.valid, k2.valid, ratio=0.9,
                                        tile_q=128, tile_t=128, interpret=True)
    out = fused.ratio_test_match_fused(T(d1), T(d2), T(k1.valid), T(k2.valid), ratio=0.9)
    np.testing.assert_array_equal(N(out.valid), np.asarray(ref.valid))
    v = N(out.valid)
    np.testing.assert_array_equal(N(out.train_idx)[v], np.asarray(ref.train_idx)[v])


# --- the two-frame frontend --------------------------------------------------


def test_frontend_matches_graft_entry(graft_inputs, jax_frontend):
    """__graft_entry__.entry's frontend and its twin on the same inputs: the
    same match count (89 with these inputs), valid mask and train_idx."""
    m = jax_frontend[4]
    n, train_idx, distance = entry.frontend(*graft_inputs, device="cpu")
    assert int(n) == int(np.asarray(m.valid).sum())
    valid = np.asarray(m.valid)
    np.testing.assert_array_equal(N(train_idx)[valid], np.asarray(m.train_idx)[valid])
    np.testing.assert_allclose(N(distance)[valid], np.asarray(m.distance)[valid], rtol=1e-4, atol=1e-5)


def test_frontend_needs_a_gpu_by_default(graft_inputs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.frontend(*graft_inputs)
