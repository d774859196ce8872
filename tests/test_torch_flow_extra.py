"""Parity of the port's dense-flow remainder (opencv_contrib_tpu_torch:
ops/filters.sobel, flow/motempl.py, flow/gpc.py, flow/pcaflow.py,
ximgproc/interp.py, flow/extra.py, lk._window_offsets and the new methods
of entry.dense_flow) with the JAX package, on the CPU, at 64x96: a seeded
texture (tests/test_flow_extra.py's, made by the JAX package) and its
warp by a shift of (1.5, -1) px.

Tolerances (measured values in brackets, on the CPU):
- sobel within 1e-5 (0); motempl's history equal, the orientation within
  rtol 1e-6 (7.6e-6 deg at 342 deg: the two atan2s part by an ulp), the
  validity mask equal, the global orientation within rtol 1e-6 (0).
- GPC with the JAX forest carried across as numpy: descriptors within 1e-5
  (0), the trained biases (jnp.median's middle value or midpoint) within
  1e-5 (0), the leaf codes equal, the int32 wrap at 4 trees x depth 8 and
  at 5 x 8 included, except on the few pixels where a split's response
  lies within 1e-5 of its bias (XLA's jitted hash fuses the descriptor
  filter into FMAs, so rounding decides those bits: 1 to 5 of 6,144), and
  the same correspondences.
- PCAFlow's basis and its fit to the same sparse matches within 1e-5 of
  the largest value; `compute` within 1e-3 px (2.4e-4 on a field up to
  61 px: the ridge system is ill-conditioned at k=4).
- edge_aware_interpolate within 1e-4 (8.3e-7).
- deepflow, simpleflow, sparse_to_dense, rlof (dense) and pcaflow through
  `entry.dense_flow(method, device="cpu")`, and rlof_track, within 1e-3 px
  (below 5e-6 px, except pcaflow's 2.4e-4), with the same validity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu.flow import extra as jextra
from opencv_contrib_tpu.flow import gpc as jgpc
from opencv_contrib_tpu.flow import lk as jlk
from opencv_contrib_tpu.flow import motempl as jmot
from opencv_contrib_tpu.flow import pcaflow as jpca
from opencv_contrib_tpu.ops import filters as jfilt
from opencv_contrib_tpu.ops import image as jimg
from opencv_contrib_tpu.ximgproc import interp as jinterp
from opencv_contrib_tpu_torch import entry
from opencv_contrib_tpu_torch.flow import extra as textra
from opencv_contrib_tpu_torch.flow import gpc as tgpc
from opencv_contrib_tpu_torch.flow import lk as tlk
from opencv_contrib_tpu_torch.flow import motempl as tmot
from opencv_contrib_tpu_torch.flow import pcaflow as tpca
from opencv_contrib_tpu_torch.ops import filters as tfilt
from opencv_contrib_tpu_torch.ximgproc import interp as tinterp

torch.set_num_threads(1)

SHAPE = (64, 96)
FLOW_TOL = 1e-3  # px


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def N(t):
    return t.detach().cpu().numpy()


def J(a):
    return jnp.asarray(np.asarray(a, dtype=np.float32))


@pytest.fixture(scope="module")
def pair():
    """tests/test_flow_extra.py's texture at 64x96 and its shift by
    (dy, dx) = (1.5, -1) px, both made by the JAX package."""
    rng = np.random.default_rng(7)
    img = np.asarray(jfilt.gaussian_blur(J(rng.uniform(0, 1, size=SHAPE)), 1.5)) * 4.0
    M = jnp.array([[1.0, 0.0, -1.0], [0.0, 1.0, 1.5]])  # output -> input
    return img, np.asarray(jimg.warp_affine(J(img), M))


@pytest.mark.parametrize("dx,dy", [(1, 0), (0, 1)])
def test_sobel_matches_jax(pair, dx, dy):
    np.testing.assert_allclose(N(tfilt.sobel(T(pair[0]), dx=dx, dy=dy)),
                               np.asarray(jfilt.sobel(J(pair[0]), dx=dx, dy=dy)), atol=1e-5)


@pytest.mark.parametrize("aperture", [3, 4])
def test_motempl_matches_jax(aperture):
    """A moving bar and a flickering band over 5 timestamps (duration 3, so
    the oldest entries decay), then the gradient and the global orientation."""
    jm, tm = jnp.zeros((16, 16)), torch.zeros(16, 16)
    for t in range(1, 6):
        sil = np.zeros((16, 16), np.float32)
        sil[:, 2 * t:2 * t + 2] = 1.0
        sil[3:5, :] = t % 2
        jm = jmot.update_motion_history(jm, J(sil), float(t), 3.0)
        tm = tmot.update_motion_history(tm, T(sil), float(t), 3.0)
    np.testing.assert_array_equal(N(tm), np.asarray(jm))
    oj, vj = jmot.calc_motion_gradient(jm, 0.5, 10.0, aperture=aperture)
    ot, vt = tmot.calc_motion_gradient(tm, 0.5, 10.0, aperture=aperture)
    np.testing.assert_allclose(N(ot), np.asarray(oj), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(N(vt), np.asarray(vj))
    assert N(vt).any() and not N(vt).all()
    gj = jmot.calc_global_orientation(oj, vj, jm, 5.0, 10.0)
    gt = tmot.calc_global_orientation(ot, vt, tm, 5.0, 10.0)
    np.testing.assert_allclose(float(gt), float(gj), rtol=1e-6)


FORESTS = [(4, 8, 512), (3, 10, 512), (5, 8, 512), (4, 8, 511)]  # trees, depth, training descriptors


@pytest.fixture(scope="module")
def forests(pair):
    """The JAX package's forests: random draws, trained on seeded
    descriptors of I0. With an even count the median is the midpoint of the
    middle two responses; with an odd count it is one pixel's response."""
    out = {}
    d0 = np.asarray(jgpc.patch_descriptors(J(pair[0]))).reshape(-1, jgpc.DESC_DIM)
    for n_trees, depth, n_train in FORESTS:
        f = jgpc.make_forest(jax.random.PRNGKey(n_trees), n_trees=n_trees, depth=depth)
        sel = d0[np.random.default_rng(n_train).choice(d0.shape[0], n_train, replace=False)]
        out[(n_trees, depth, n_train)] = (np.asarray(f), sel, np.asarray(jgpc.train_forest(f, J(sel))))
    return out


def test_gpc_descriptors_and_training_match_jax(pair, forests):
    np.testing.assert_allclose(N(tgpc.patch_descriptors(T(pair[0]))), np.asarray(jgpc.patch_descriptors(J(pair[0]))),
                               atol=1e-5)
    for raw, sel, trained in forests.values():
        np.testing.assert_allclose(N(tgpc.train_forest(T(raw), T(sel))), trained, atol=1e-5)


TIE = 1e-5  # |response - bias| below which a split's bit is decided by rounding


def _ties(img, trained):
    """Pixels with a split whose response lies within TIE of its bias, by
    the JAX package's eager arithmetic."""
    d = jgpc.patch_descriptors(J(img))
    resp = np.asarray(jnp.einsum("hwk,tdk->hwtd", d, J(trained[..., :jgpc.DESC_DIM]))) - trained[..., jgpc.DESC_DIM]
    return (np.abs(resp) <= TIE).any(axis=(-2, -1))


@pytest.mark.parametrize("key", FORESTS, ids=lambda k: "x".join(map(str, k)))
def test_gpc_leaf_codes_wrap_like_int32(pair, forests, key):
    """The same int32 codes, including the wrap at 2^32: 4 trees x depth 8
    fill all 32 bits (negative codes), and at 5 x 8 the fifth tree's factor
    256^4 is 0 in int32. Inside its jitted `leaf_codes` XLA fuses the
    descriptor filter into FMAs, so its descriptors part from the eager ones
    (and the port's, which equal the eager ones) by ulps, and a split whose
    response lies that close to its bias is decided by rounding: trained on
    an odd count, a bias IS a training pixel's response. The codes are held
    equal on every pixel without a split within TIE of its bias, and such
    pixels are at most 1% (measured: up to 43 of 6,144 pixels tie at
    4 x 8 x 511, a training pixel per split; the codes differ on 1 pixel of
    3 of the 8 images and on 5 at 4 x 8 x 511)."""
    trained = forests[key][2]
    for img in pair:
        cj = np.asarray(jgpc.leaf_codes(J(img), J(trained)))
        ct = N(tgpc.leaf_codes(T(img), T(trained)))
        assert ct.dtype == np.int32
        tie = _ties(img, trained)
        assert tie.mean() <= 0.01, tie.sum()
        np.testing.assert_array_equal(ct[~tie], cj[~tie])
        if key[0] * key[1] >= 32:
            assert (ct < 0).any()


def test_gpc_correspondences_match_jax(pair, forests):
    trained = forests[(4, 8, 512)][2]
    pj = jgpc.find_correspondences(pair[0], pair[1], J(trained))
    pt = tgpc.find_correspondences(pair[0], pair[1], T(trained))
    assert pj[0].shape[0] > 30
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a, b)


def test_gpc_make_forest_from_a_generator():
    f = tgpc.make_forest(torch.Generator().manual_seed(0), n_trees=4, depth=8)
    assert f.shape == (4, 8, tgpc.DESC_DIM + 1)
    np.testing.assert_allclose(N(torch.linalg.norm(f[..., :tgpc.DESC_DIM], dim=-1)), 1.0, atol=1e-6)
    assert not N(f[..., -1]).any()
    assert torch.equal(f, tgpc.make_forest(torch.Generator().manual_seed(0), n_trees=4, depth=8))


def test_pcaflow_basis_and_fit_match_jax(pair):
    H, W = SHAPE
    for k in (4, 6):
        np.testing.assert_allclose(N(tpca.dct_basis(H, W, k)), np.asarray(jpca.dct_basis(H, W, k)), atol=1e-5)
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, [H - 1, W - 1], (60, 2)).astype(np.float32)
    flows = rng.normal(size=(60, 2)).astype(np.float32)
    valid = rng.uniform(size=60) > 0.2
    fj = np.asarray(jpca.fit_flow(J(pts), J(flows), jnp.asarray(valid), H, W, k=4))
    ft = N(tpca.fit_flow(T(pts), T(flows), torch.from_numpy(valid), H, W, k=4))
    np.testing.assert_allclose(ft, fj, atol=1e-5 * np.abs(fj).max())


def test_edge_aware_interpolate_matches_jax(pair):
    rng = np.random.default_rng(4)
    seeds = rng.uniform(0, 63, (40, 2)).astype(np.float32)
    vals = rng.normal(size=(40, 2)).astype(np.float32)
    valid = rng.uniform(size=40) > 0.2
    dj = jinterp.edge_aware_interpolate(J(pair[0]), J(seeds), J(vals), jnp.asarray(valid))
    dt = tinterp.edge_aware_interpolate(T(pair[0]), T(seeds), T(vals), torch.from_numpy(valid))
    np.testing.assert_allclose(N(dt), np.asarray(dj), atol=1e-4)


def test_window_offsets_match_jax():
    for a, b in zip(tlk._window_offsets(3), jlk._window_offsets(3)):
        np.testing.assert_array_equal(N(a), np.asarray(b))


def test_rlof_track_matches_jax(pair):
    """tests/test_flow_extra.py's sparse RLOF under a gain and bias change."""
    I1 = pair[1] * 1.3 + 0.15
    pts = np.array([[40.0, 48.0], [30, 60], [50, 30], [44, 70], [20, 20]], np.float32)
    pj, fj, vj = jextra.rlof_track(J(pair[0]), J(I1), J(pts))
    pt, ft, vt = textra.rlof_track(T(pair[0]), T(I1), T(pts))
    np.testing.assert_allclose(N(ft), np.asarray(fj), atol=FLOW_TOL)
    np.testing.assert_allclose(N(pt), np.asarray(pj), atol=FLOW_TOL)
    np.testing.assert_array_equal(N(vt), np.asarray(vj))
    assert N(vt).sum() >= 3


JAX_METHODS = {"deepflow": lambda a, b: jextra.deepflow(a, b, levels=3),
               "simpleflow": lambda a, b: jextra.simpleflow(a, b, levels=3, search_radius=3),
               "sparse_to_dense": jextra.sparse_to_dense,
               "rlof": jextra.rlof_dense,
               "pcaflow": lambda a, b: jpca.compute(a, b, grid_stride=8, k=4)}
PORT_PARAMS = {"deepflow": dict(levels=3), "simpleflow": dict(levels=3, search_radius=3), "sparse_to_dense": {},
               "rlof": {}, "pcaflow": dict(grid_stride=8, k=4)}


@pytest.mark.parametrize("method", sorted(JAX_METHODS))
def test_dense_flow_methods_match_jax(pair, method):
    fj = np.asarray(JAX_METHODS[method](*pair))
    ft = N(entry.dense_flow(*pair, method=method, device="cpu", **PORT_PARAMS[method]))
    assert ft.shape == SHAPE + (2,) and np.isfinite(ft).all()
    np.testing.assert_allclose(ft, fj, atol=FLOW_TOL)
