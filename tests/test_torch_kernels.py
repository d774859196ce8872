"""Parity of the PyTorch port's kernel modules (opencv_contrib_tpu_torch.ops.cuda)
with the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the Pallas kernels
run in interpret mode, as tests/test_pallas*.py run them. The CUDA kernels
themselves are held against the plain versions on the card by
`chip_smoke.py`.
"""

import ctypes
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu.features import match as xmatch
from opencv_contrib_tpu.ops import image as jimage
from opencv_contrib_tpu.ops import integral as jinteg
from opencv_contrib_tpu.ops.pallas import grid as pgrid
from opencv_contrib_tpu.ops.pallas import matching as pmatch
from opencv_contrib_tpu.ops.pallas import pipeline as ppipe
from opencv_contrib_tpu.ops.pallas import remap as premap
from opencv_contrib_tpu_torch.features import match as fmatch
from opencv_contrib_tpu_torch.ops import image as timage
from opencv_contrib_tpu_torch.ops.histogram import clahe
from opencv_contrib_tpu_torch.ops import integral as tinteg
from opencv_contrib_tpu_torch.ops import cuda as tcuda
from opencv_contrib_tpu_torch.ops.cuda import _build, pyramid, reduce, scan
from opencv_contrib_tpu_torch.ops.cuda import histogram as thist
from opencv_contrib_tpu_torch.ops.cuda import transform as ttf
from opencv_contrib_tpu_torch.ops.cuda import matching as tmatch
from opencv_contrib_tpu_torch.ops.cuda import remap as tremap


# The suite runs several worker processes beside XLA's thread pools; at
# these sizes torch's own per-process OpenMP pool only oversubscribes the CPU.
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


class TestFusedKnn:
    """Twins of tests/test_pallas.py::TestFusedKnn, same tolerances."""

    def test_matches_xla_reference(self, rng):
        q = rng.normal(size=(512, 128)).astype(np.float32)
        t = rng.normal(size=(1024, 128)).astype(np.float32)
        dist, idx = tmatch.knn2(T(q), T(t), tile_q=256, tile_t=512)
        jd, ji = pmatch.knn2(jnp.asarray(q), jnp.asarray(t), tile_q=256, tile_t=512, interpret=True)
        neg, idx_ref = jax.lax.top_k(-xmatch.l2_distance_matrix(jnp.asarray(q), jnp.asarray(t)), 2)
        for ref in (np.asarray(jd), -np.asarray(neg)):
            np.testing.assert_allclose(N(dist[:, 0]), ref[:, 0], rtol=1e-4, atol=1e-3)
            np.testing.assert_allclose(N(dist[:, 1]), ref[:, 1], rtol=1e-4, atol=1e-3)
        assert (N(idx) == np.asarray(ji)).mean() > 0.999
        assert (N(idx) == np.asarray(idx_ref[:, 0])).mean() > 0.999

    def test_second_best_crosses_tiles(self, rng):
        q = rng.normal(size=(256, 32)).astype(np.float32)
        t = np.concatenate([q + 0.01, q + 0.02, rng.normal(size=(512, 32)).astype(np.float32)])
        dist, idx = tmatch.knn2(T(q), T(t), tile_q=256, tile_t=256)
        jd, ji = pmatch.knn2(jnp.asarray(q), jnp.asarray(t), tile_q=256, tile_t=256, interpret=True)
        np.testing.assert_array_equal(N(idx), np.arange(256))
        np.testing.assert_array_equal(N(idx), np.asarray(ji))
        assert float(torch.max(torch.abs(dist[:, 1] - dist[:, 0]))) < 0.1
        np.testing.assert_allclose(N(dist), np.asarray(jd), rtol=1e-4, atol=1e-3)

    def test_fused_ratio_match(self, rng):
        d = rng.normal(size=(256, 64)).astype(np.float32)
        qq = d + rng.normal(scale=0.01, size=d.shape).astype(np.float32)
        m = tmatch.ratio_test_match_fused(T(qq), T(d))
        jm = pmatch.ratio_test_match_fused(jnp.asarray(qq), jnp.asarray(d), interpret=True)
        v = N(m.valid)
        assert v.mean() > 0.9
        assert (N(m.train_idx)[v] == np.arange(256)[v]).all()
        np.testing.assert_array_equal(v, np.asarray(jm.valid))
        np.testing.assert_array_equal(N(m.train_idx), np.asarray(jm.train_idx))


def test_fused_ratio_match_masks_invalid_rows(rng):
    """The invalid-row push to 1e6 of the Pallas twin: masked train rows are
    never matched, masked query rows never valid."""
    d = rng.normal(size=(128, 64)).astype(np.float32)
    q = d + rng.normal(scale=0.01, size=d.shape).astype(np.float32)
    qv = rng.uniform(size=128) > 0.2
    tv = rng.uniform(size=128) > 0.2
    m = tmatch.ratio_test_match_fused(T(q), T(d), T(qv), T(tv), ratio=0.8)
    jm = pmatch.ratio_test_match_fused(jnp.asarray(q), jnp.asarray(d), jnp.asarray(qv),
                                       jnp.asarray(tv), ratio=0.8, interpret=True)
    np.testing.assert_array_equal(N(m.valid), np.asarray(jm.valid))
    np.testing.assert_array_equal(N(m.train_idx)[N(m.valid)], np.asarray(jm.train_idx)[N(m.valid)])
    assert tv[N(m.train_idx)[N(m.valid)]].all()
    assert not N(m.valid)[~qv].any()


@pytest.mark.parametrize("shape", [(120, 300), (37, 5)])
def test_integral_image_matches_cumsum(rng, shape):
    """Twin of tests/test_pallas_grid.py::test_integral_image_matches_cumsum."""
    a = rng.normal(size=shape).astype(np.float32)
    out = N(scan.integral_image(T(a)))
    ref = np.asarray(jnp.cumsum(jnp.cumsum(jnp.asarray(a), axis=1), axis=0))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-3)
    pal = np.asarray(pgrid.integral_image(jnp.asarray(a), tile=(64, 128), interpret=True))
    np.testing.assert_allclose(out, pal, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("shape,rtol,atol", [((64, 1000), 1e-4, 1e-3), ((16, 128), 1e-5, 1e-4)])
def test_grid_scan_matches_cumsum(rng, shape, rtol, atol):
    """Twins of tests/test_pallas_pipeline.py's grid_scan cases."""
    x = rng.normal(size=shape).astype(np.float32)
    out = N(scan.grid_scan(T(x)))
    np.testing.assert_allclose(out, np.asarray(jnp.cumsum(jnp.asarray(x), axis=1)), rtol=rtol, atol=atol)
    pal = np.asarray(ppipe.grid_scan(jnp.asarray(x), tile=256, interpret=True))
    np.testing.assert_allclose(out, pal, rtol=rtol, atol=atol)


def test_grid_scan_keeps_dtype(rng):
    x = rng.integers(0, 9, size=(5, 40)).astype(np.int32)
    out = scan.grid_scan(T(x))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(N(out), np.cumsum(x, axis=1))


@pytest.mark.parametrize("shape", [(128, 128), (480, 640), (33, 47)])
def test_integral_matches_jax(rng, shape):
    """The zero-padded summed-area table against the JAX package's. Two
    float32 summation orders may differ by a few ulp of the table's largest
    entry, hence atol = 2e-6 * max|ii|; the plain version sums in the JAX
    package's own order, so on the CPU the two agree exactly."""
    img = rng.uniform(0, 255, shape).astype(np.float32)
    ji = np.asarray(jinteg.integral(jnp.asarray(img)))
    ti = N(tinteg.integral(T(img)))
    assert ti.shape == (shape[0] + 1, shape[1] + 1)
    np.testing.assert_allclose(ti, ji, rtol=0, atol=2e-6 * np.abs(ji).max())
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("fn", ["box_sum", "box_mean", "haar_x", "haar_y"])
def test_box_and_haar_match_jax(rng, fn):
    img = rng.uniform(0, 255, (40, 56)).astype(np.float32)
    ii_j = jinteg.integral(jnp.asarray(img))
    ii_t = tinteg.integral(T(img))
    y = rng.integers(-3, 44, size=(7, 5)).astype(np.int32)
    x = rng.integers(-3, 60, size=(7, 5)).astype(np.int32)
    if fn.startswith("box"):
        args = (6, 9)
    else:
        args = (8,)
    ref = np.asarray(getattr(jinteg, fn)(ii_j, jnp.asarray(y), jnp.asarray(x), *args))
    out = N(getattr(tinteg, fn)(ii_t, T(y).long(), T(x).long(), *args))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-3)


def _getab_frames(rng, H=24, W=32):
    """A source and a target point / normal map of a tilted plane with a
    bump, made from a seed, as (H, W, 3) float32 plus a valid mask."""
    v, u = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    intr = np.array([30.0, 30.0, W / 2, H / 2, 0, 0, 0, 0, 0], np.float32)
    out = []
    for k in range(2):
        z = 2.0 + 0.01 * u + 0.2 * np.exp(-((u - W / 2) ** 2 + (v - H / 2) ** 2) / 40.0) + 0.01 * k
        z = (z + rng.normal(scale=1e-3, size=z.shape)).astype(np.float32)
        pts = np.stack([(u - intr[2]) / intr[0] * z, (v - intr[3]) / intr[1] * z, z], -1).astype(np.float32)
        n = np.cross(np.gradient(pts, axis=0), np.gradient(pts, axis=1))
        n = -(n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
        valid = rng.uniform(size=(H, W)) > 0.1
        out += [pts, n, valid]
    return out, intr


@pytest.mark.parametrize("offset", [False, True], ids=["identity", "offset"])
def test_icp_getab_plain_matches_jax(rng, offset):
    """icp_getab_plain against the JAX build_system's einsum form."""
    from opencv_contrib_tpu.core import se3 as jse3
    from opencv_contrib_tpu.rgbd import icp as jicp
    from opencv_contrib_tpu.rgbd.frame import DepthFrame

    (sp, sn, sv, dp, dn, dv), intr = _getab_frames(rng)
    xi = np.array([0.005, -0.01, 0.0, 0.01, 0.0, 0.005] if offset else [0.0] * 6, np.float32)
    Tm = np.asarray(jse3.exp_se3(jnp.asarray(xi)))
    src = DepthFrame(jnp.asarray(sp[..., 2]), jnp.asarray(sp), jnp.asarray(sn), jnp.asarray(sv))
    dst = DepthFrame(jnp.asarray(dp[..., 2]), jnp.asarray(dp), jnp.asarray(dn), jnp.asarray(dv))
    Aj, bj, nj, ej = (np.asarray(x) for x in jicp.build_system(jnp.asarray(Tm), src, dst, jnp.asarray(intr)))
    At, bt, nt, et = (N(x) for x in reduce.icp_getab(T(Tm), T(sp), T(sn), T(sv), T(dp), T(dn), T(dv), T(intr)))
    assert float(nj) > 200 and abs(float(nt) - float(nj)) <= max(3.0, 2e-3 * float(nj))
    np.testing.assert_allclose(At, Aj, rtol=0, atol=1e-3 * np.abs(Aj).max())
    np.testing.assert_allclose(bt, bj, rtol=0, atol=1e-3 * np.abs(bj).max())
    np.testing.assert_allclose(et, ej, rtol=1e-3)


def _mapper_products(x, y, valid):
    x = torch.where(valid, x, 0.0)
    y = torch.where(valid, y, 0.0)
    return torch.stack([torch.sum(x * y), torch.sum(x), torch.sum(y * y)])


def _mapper_gauss(x, valid):
    v = torch.where(valid, torch.exp(-x * x), 0.0)
    return torch.stack([torch.sum(v), torch.sum(torch.where(valid, 1.0, 0.0))])


@pytest.mark.parametrize("n_in", [2, 1], ids=["products", "nonlinear"])
def test_grid_reduce_vec_plain_matches_pallas(rng, n_in):
    """Twins of tests/test_pallas_grid.py's grid_reduce_vec cases: the same
    mappers, 100x257 in (64, 128) tiles; the padded cells' validity tile
    gates them out (the second mapper is nonzero at the pad's 0)."""
    a = rng.normal(size=(100, 257)).astype(np.float32)
    b = rng.normal(size=(100, 257)).astype(np.float32)

    def jax_products(x, y, valid):
        x, y = jnp.where(valid, x, 0.0), jnp.where(valid, y, 0.0)
        return jnp.stack([jnp.sum(x * y), jnp.sum(x), jnp.sum(y * y)])

    def jax_gauss(x, valid):
        v = jnp.where(valid, jnp.exp(-x * x), 0.0)
        return jnp.stack([jnp.sum(v), jnp.sum(jnp.where(valid, 1.0, 0.0))])

    arrays = (a, b)[:n_in]
    tmap, jmap, dim = (_mapper_products, jax_products, 3) if n_in == 2 else (_mapper_gauss, jax_gauss, 2)
    out = N(reduce.grid_reduce_vec_plain(tmap, *(T(x) for x in arrays), out_dim=dim, tile=(64, 128)))
    pal = np.asarray(pgrid.grid_reduce_vec(jmap, *(jnp.asarray(x) for x in arrays), out_dim=dim, tile=(64, 128),
                                           interpret=True))
    np.testing.assert_allclose(out, pal, rtol=2e-5, atol=1e-4)
    if n_in == 1:
        assert int(out[1]) == 100 * 257


def _pyrdown_reference(x, mode):
    """tests/test_pallas_pipeline.py's numpy reference (float64), for either
    border and any size: the padded separable binomial blur, decimated."""
    k = np.array([1, 4, 6, 4, 1], np.float64) / 16.0
    H, W = x.shape
    pad = np.pad(x.astype(np.float64), ((2, 2), (0, 0)), mode=mode)
    tmp = sum(k[i] * pad[i:i + H] for i in range(5))
    pad = np.pad(tmp, ((0, 0), (2, 2)), mode=mode)
    return sum(k[i] * pad[:, i:i + W] for i in range(5))[::2, ::2]


def test_grid_pyrdown_plain_matches_pallas(rng):
    """Twin of tests/test_pallas_pipeline.py::test_grid_pyrdown_matches_reference
    (64x96, replicate border), held to its numpy reference and to the Pallas
    kernel in interpret mode, same tolerance (rtol, atol 1e-4)."""
    x = rng.normal(size=(64, 96)).astype(np.float32)
    out = N(pyramid.pyrdown(T(x), border="replicate"))
    assert out.shape == (32, 48)
    np.testing.assert_allclose(out, _pyrdown_reference(x, "edge"), rtol=1e-4, atol=1e-4)
    pal = np.asarray(ppipe.grid_pyrdown(jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(out, pal, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(out, N(pyramid.grid_pyrdown_plain(T(x))))


@pytest.mark.parametrize("shape", [(109, 256), (55, 128), (64, 96)])
def test_pyrdown_borders_on_odd_levels(rng, shape):
    """Both borders at any size, the flow pyramid's odd 109x256 -> 55x128
    level included: each against the float64 reference (atol 2e-6 on values
    in [0, 4)); only the first and last output row and column read past the
    edge, so the two borders agree everywhere else."""
    x = rng.uniform(0, 4, shape).astype(np.float32)
    refl = N(pyramid.pyrdown(T(x)))
    repl = N(pyramid.pyrdown(T(x), border="replicate"))
    assert refl.shape == repl.shape == ((shape[0] + 1) // 2, (shape[1] + 1) // 2)
    np.testing.assert_allclose(refl, _pyrdown_reference(x, "reflect"), rtol=0, atol=2e-6)
    np.testing.assert_allclose(repl, _pyrdown_reference(x, "edge"), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(N(pyramid.pyr_down_plain(T(x))), refl)
    np.testing.assert_array_equal(refl[1:-1, 1:-1], repl[1:-1, 1:-1])
    assert np.abs(refl[0] - repl[0]).max() > 0 and np.abs(refl[-1] - repl[-1]).max() > 0


def test_pyrdown_rejects_unknown_border():
    with pytest.raises(ValueError, match="border"):
        pyramid.pyrdown(torch.zeros(8, 8), border="wrap")


def _field(hw, amp, seed):
    """tests/test_pallas_remap.py's smooth random displacement field."""
    rng = np.random.default_rng(seed)
    H, W = hw
    g = rng.standard_normal((max(H // 16, 1), max(W // 16, 1))).astype(np.float32)
    f = np.asarray(jax.image.resize(jnp.asarray(g), (H, W), "bilinear"))
    return (amp * f / max(np.abs(f).max(), 1e-6)).astype(np.float32)


REMAP_CASES = {
    # tests/test_pallas_remap.py's five cases: (shape, seed of img, dy, dx, max_disp, tile_h);
    # a field is ("field", amplitude, seed), a constant ("const", value)
    "interior": ((96, 128), 0, ("field", 3.0, 1), ("field", 3.0, 2), 4, 64),
    "identity": ((64, 128), 1, ("const", 0.0), ("const", 0.0), 2, 64),
    "integer_shift": ((64, 128), 2, ("const", 2.0), ("const", -1.0), 3, 64),
    "clamps_oversized": ((64, 128), 3, ("const", 10.0), ("const", 0.0), 2, 64),
    "non_tile_aligned": ((50, 128), 4, ("field", 1.5, 5), ("field", 1.5, 6), 2, 16),
}


@pytest.mark.parametrize("case", sorted(REMAP_CASES))
def test_remap_bounded_plain_matches_pallas(case):
    """remap_bounded_plain (and the wrapper on the CPU) against the Pallas
    `remap_bounded` in interpret mode and its XLA sampler baseline, in every
    case of tests/test_pallas_remap.py, over the whole image (the Pallas
    test compares with the XLA sampler inside a border only): atol 2e-5,
    the Pallas test's tolerance."""
    shape, seed, sy, sx, R, tile_h = REMAP_CASES[case]
    img = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)

    def make(spec):
        return _field(shape, spec[1], spec[2]) if spec[0] == "field" else np.full(shape, spec[1], np.float32)

    dy, dx = make(sy), make(sx)
    pal = np.asarray(premap.remap_bounded(jnp.asarray(img), jnp.asarray(dy), jnp.asarray(dx), max_disp=R,
                                          tile_h=tile_h, interpret=True))
    out = N(tremap.remap(T(img), T(dy), T(dx), max_disp=R))
    np.testing.assert_allclose(out, pal, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(out, N(tremap.remap_bounded_plain(T(img), T(dy), T(dx), R)))
    xla = np.asarray(premap.remap_bounded_xla(jnp.asarray(img), jnp.asarray(dy), jnp.asarray(dx), max_disp=R))
    np.testing.assert_allclose(out, xla, rtol=0, atol=2e-5)


def test_remap_flow_warp_matches_sample_bilinear_multi(rng):
    """The flow warp (max_disp=None) of C = 3 maps by smooth fields up to
    +-12 px, which leave the image at every border: against the JAX
    sample_bilinear_multi at the grid plus the displacement, across the
    coordinate clamp to [0, H - 1.001] (atol 1e-5 on values in [0, 4))."""
    H, W = 55, 128
    maps = rng.uniform(0, 4, (3, H, W)).astype(np.float32)
    dy, dx = _field((H, W), 12.0, 8), _field((H, W), 12.0, 9)
    out = N(tremap.remap(T(maps), T(dy), T(dx)))
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    ref = np.asarray(jimage.sample_bilinear_multi(jnp.asarray(maps), jnp.asarray(y + dy), jnp.asarray(x + dx)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    # the port's sampler sums the corners by a reduction: an ulp apart
    tref = N(timage.sample_bilinear_multi(T(maps), T(y) + T(dy), T(x) + T(dx)))
    np.testing.assert_allclose(out, tref, rtol=0, atol=2e-6)
    assert (y + dy < 0).any() and (y + dy > H - 1).any() and (x + dx < 0).any() and (x + dx > W - 1).any()
    one = N(tremap.remap(T(maps[1]), T(dy), T(dx)))  # (H, W) maps: one channel
    np.testing.assert_array_equal(one, out[1])


def test_remap_flow_clamp_bound_rounds_once():
    """The coordinate clamp's bound is H - 1.001 rounded once to float32,
    the bound torch.clamp and jnp.clip take from a Python float; the
    wrapper hands the kernel that value."""
    for n in (55, 436, 1024):
        lim = tremap._clamp_limit(n)
        assert lim == float(np.float32(n - 1.001))
        c = float(torch.clamp(torch.tensor([1e6]), 0.0, n - 1.001)[0])
        assert c == lim
        assert float(jnp.clip(jnp.float32(1e6), 0.0, n - 1.001)) == lim


def test_cpu_calls_leave_launch_counters_at_zero(rng):
    tcuda.reset_launches()
    q = T(rng.normal(size=(64, 16)).astype(np.float32))
    tmatch.knn2(q, q)
    tmatch.ratio_test_match_fused(q, q)
    fmatch.ratio_test_match(q, q)
    scan.grid_scan(q)
    scan.integral_image(q)
    tinteg.integral(q)
    scan.integral_padded(q)
    clahe(T(rng.uniform(size=(32, 48)).astype(np.float32)))
    (sp, sn, sv, dp, dn, dv), intr = _getab_frames(rng)
    reduce.icp_getab(torch.eye(4), T(sp), T(sn), T(sv), T(dp), T(dn), T(dv), T(intr))
    pyramid.pyrdown(q)
    pyramid.pyrdown(q, border="replicate")
    tremap.remap(torch.stack([q, q]), q, q)
    tremap.remap(q, q, q, max_disp=2)
    ttf.grid_transform(ttf.mul(), q, q)
    ttf.streamed_transform(ttf.gamma(0.5), q)
    reduce.grid_reduce(ttf.sq(), q)
    reduce.grid_reduce_sums(ttf.aggd_moments(), q)
    thist.grid_histogram(q, 16, -1.0, 1.0, tiles=(2, 2))
    assert tcuda.launches() == {"knn2": 0, "integral_image": 0, "grid_scan": 0, "grid_reduce_vec": 0,
                                "pyrdown": 0, "remap": 0, "grid_transform": 0, "streamed_transform": 0,
                                "grid_reduce": 0, "grid_histogram": 0}


@pytest.mark.parametrize("Q,Tn", [(512, 512), (1000, 3000), (8192, 8192), (70, 130), (2048, 2048), (1, 100000)])
def test_knn2_plan_covers_the_train_set_and_fills_the_card(Q, Tn):
    """The wrapper's split: the span is a multiple of the kernel's train
    tile, the spans cover every train row and no span is empty, and at the
    shapes of the path the blocks are at least about one an SM of an H100
    (132 SMs)."""
    large, span, n_split = tmatch.plan(Q, Tn, 132)
    tq, tt = tmatch._LARGE if large else tmatch._SMALL
    assert span % tt == 0 and (n_split - 1) * span < Tn <= n_split * span
    blocks = -(-Q // tq) * n_split
    if (Q, Tn) in ((512, 512), (1000, 3000), (8192, 8192), (2048, 2048)):
        assert blocks >= 0.95 * 132, (large, span, n_split)
    assert large == ((Q, Tn) == (8192, 8192))


def test_knn2_plan_honours_an_explicit_tile_t():
    """tile_t sets the span, rounded up to the train tile, whatever the SM
    count; the tile shape depends on (Q, T) alone."""
    assert tmatch.plan(512, 512, 132, 128) == (False, 128, 4)
    assert tmatch.plan(512, 512, 8, 128) == (False, 128, 4)
    assert tmatch.plan(512, 512, 132, 100) == (False, 128, 4)
    assert tmatch.plan(1000, 3000, 132, 3000) == (False, 3008, 1)
    assert tmatch.plan(8192, 8192, 132, 256) == (True, 256, 32)
    assert tmatch.plan(512, 512, 132)[0] == tmatch.plan(512, 512, 132, 2048)[0]


def test_knn2_tiles_match_the_source():
    """The tile shapes in the wrapper mirror csrc/knn2.cu's Large and Small
    tiles."""
    text = (_build.CSRC / "knn2.cu").read_text()
    tiles = dict((n, tuple(int(v) for v in a)) for n, *a in
                 re.findall(r"using (Large|Small) = Tile<(\d+), (\d+),", text))
    assert tiles == {"Large": tmatch._LARGE, "Small": tmatch._SMALL}


@pytest.mark.parametrize("H,W", [(480, 640), (2048, 2048), (481, 643), (1, 7), (37, 5), (40, 8000), (3001, 16),
                                 (4000, 8000), (1000, 3001), (8, 12000), (20000, 20000), (100000, 4)])
def test_integral_bands_fit_the_shared_memory(H, W):
    """Slabs of R rows by Cw columns at any width: the slab's rows, E, 4
    rows of group sums and the row carries within the kernel's shared
    memory (csrc/scan.cu MAX_SMEM, GROUPS, MAX_COLS); the slabs cover the
    table and none is empty; about 48 bands of at least 8 rows up to
    18,000 rows, so no slab reads the totals of more than about 48."""
    R, Cw = scan.slabs(H, W)
    nb, nc = -(-H // R), -(-W // Cw)
    assert R >= 1 and Cw % 4 == 0 and 4 <= Cw <= scan._COLS
    assert ((R + 1 + scan._GROUPS) * Cw + R) * 4 <= scan._SMEM_MAX
    assert (nb - 1) * R < H <= nb * R and (nc - 1) * Cw < W <= nc * Cw
    assert R >= min(H, scan._MIN_ROWS) and (nb <= scan._BANDS or H > 18000)
    text = (_build.CSRC / "scan.cu").read_text()
    assert f"constexpr int MAX_SMEM = {scan._SMEM_MAX // 1024} * 1024;" in text
    assert f"constexpr int GROUPS = {scan._GROUPS};" in text
    assert f"constexpr int MAX_COLS = {scan._COLS};" in text


@pytest.mark.parametrize("shape", [(128, 128), (480, 640), (33, 47), (1, 5)])
def test_integral_padded_is_the_plain_table_padded(rng, shape):
    """`integral` and `scan.integral_padded` on the CPU: the plain 2D scan
    padded with a zero row and column, bit for bit, and so the JAX
    package's `ops.integral.integral`."""
    img = rng.uniform(0, 255, shape).astype(np.float32)
    ref = torch.nn.functional.pad(scan.integral_image_plain(T(img)), (1, 0, 1, 0))
    for out in (tinteg.integral(T(img)), scan.integral_padded(T(img)), scan.integral_padded_plain(T(img))):
        assert out.shape == (shape[0] + 1, shape[1] + 1) and out.dtype == torch.float32
        assert torch.equal(out, ref)
    np.testing.assert_array_equal(N(ref), np.asarray(jinteg.integral(jnp.asarray(img))))


def test_clahe_cdfs_go_through_grid_scan(rng, monkeypatch):
    """CLAHE's 64 tile CDFs are one grid_scan call of (64, 256)."""
    calls = []
    real = scan.grid_scan

    def spy(x):
        calls.append(tuple(x.shape))
        return real(x)

    monkeypatch.setattr(scan, "grid_scan", spy)
    clahe(T(rng.uniform(size=(40, 56)).astype(np.float32)))
    assert calls == [(64, 256)]


def test_other_devices_raise():
    x = torch.zeros(4, 4, device="meta")
    pts = torch.zeros(4, 4, 3, device="meta")
    ok = torch.zeros(4, 4, dtype=torch.bool, device="meta")
    for fn in (scan.grid_scan, scan.integral_image, scan.integral_padded, lambda a: tmatch.knn2(a, a),
               lambda a: reduce.icp_getab(a, pts, pts, ok, pts, pts, ok, a[0]),
               pyramid.pyrdown, lambda a: tremap.remap(a, a, a), lambda a: ttf.grid_transform(ttf.mul(), a, a),
               lambda a: ttf.streamed_transform(ttf.gamma(0.5), a), lambda a: reduce.grid_reduce(ttf.sq(), a),
               lambda a: reduce.grid_reduce_sums(ttf.ggd_moments(), a), lambda a: thist.grid_histogram(a, 8, 0.0, 1.0)):
        with pytest.raises(ValueError, match="no kernel or plain version"):
            fn(x)


def test_dispatch_follows_the_tensor_device():
    """The device of the tensor alone decides: CUDA takes the kernel, the
    CPU the plain version (a stand-in object: this image has no card)."""
    assert tcuda.use_kernel(SimpleNamespace(device=torch.device("cuda", 0)))
    assert not tcuda.use_kernel(torch.zeros(1))


def test_build_needs_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_build_flags_and_signatures():
    """sm_90a target; every C entry point of csrc/ is declared with pointer
    (c_void_p) argtypes for every pointer and the stream, c_float for every
    float, and c_int for the rest."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags and "-fPIC" in flags
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = src.read_text()
        entries = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text))
        assert set(entries) == set(_build.SIGNATURES[src.stem]), src.name
        for name, params in entries.items():
            kinds = [ctypes.c_void_p if ("*" in p or "cudaStream_t" in p)
                     else ctypes.c_float if p.split()[0] == "float" else ctypes.c_int
                     for p in params.split(",")]
            assert _build.SIGNATURES[src.stem][name] == kinds, name
            assert "return (int)cudaGetLastError();" in text


# ---- grid_transform, streamed_transform, grid_reduce, grid_histogram --------

def test_grid_transform_plain_matches_pallas(rng):
    """Twin of tests/test_pallas_grid.py::test_grid_transform_elementwise:
    300x515 in (128, 256) tiles, atol 1e-6."""
    a = rng.normal(size=(300, 515)).astype(np.float32)
    b = rng.normal(size=(300, 515)).astype(np.float32)
    out = N(ttf.grid_transform_plain(lambda x, y: torch.tanh(x) * y + 0.5, T(a), T(b), tile=(128, 256)))
    pal = np.asarray(pgrid.grid_transform(lambda x, y: jnp.tanh(x) * y + 0.5, jnp.asarray(a), jnp.asarray(b),
                                          tile=(128, 256), interpret=True))
    np.testing.assert_allclose(out, pal, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out, np.tanh(a) * b + 0.5, rtol=0, atol=1e-6)


def _jax_twins(m):
    """The jnp expression of each map of ops/cuda/transform.py."""
    hp = m.hparams
    gate = lambda r, g, b: (jnp.maximum(jnp.maximum(r, g), b) < hp[0]).astype(jnp.float32)  # noqa: E731
    return {
        "gamma": lambda x: jnp.clip(x, 0.0, 1.0) ** hp[0],
        "gray": lambda r, g, b: r * 0.299 + g * 0.587 + b * 0.114,
        "gain": lambda x: jnp.clip(x * float(m.dparams[int(hp[0])]), 0.0, 1.0),
        "ssim": lambda ma, mb, saa, sbb, sab: ((2 * ma * mb + hp[0]) * (2 * (sab - ma * mb) + hp[1]))
        / ((ma * ma + mb * mb + hp[0]) * ((saa - ma * ma) + (sbb - mb * mb) + hp[1])),
        "gms": lambda a, b, c, d: (2 * jnp.sqrt(a * a + b * b) * jnp.sqrt(c * c + d * d) + hp[0])
        / (a * a + b * b + c * c + d * d + hp[0]),
        "mscn": lambda x, mu, s2: (x - mu) / (jnp.sqrt(jnp.maximum(s2 - mu * mu, 0.0)) + 1.0),
        "mul": lambda a, b: a * b,
        "ident": lambda x: x,
        "sqdiff": lambda a, b: (a - b) ** 2,
        "sq": lambda x: x * x,
        "abs": jnp.abs,
        "neg_sq": lambda x: (x * (x < 0)) ** 2,
        "pos_sq": lambda x: (x * (x > 0)) ** 2,
        "neg": lambda x: (x < 0).astype(jnp.float32),
        "pos": lambda x: (x > 0).astype(jnp.float32),
        "gated": lambda r, g, b: (r, g, b)[int(hp[1])] * gate(r, g, b),
        "gated_count": gate,
        "sqdev": lambda x: (x - float(m.dparams[0])) ** 2,
    }[m.name]


TRANSFORM_CASES = {"gamma": lambda: ttf.gamma(1 / 2.2), "gray": ttf.gray,
                   "gain": lambda: ttf.gain(torch.tensor([1.25, 1.0, 0.8]), 2),
                   "ssim": lambda: ttf.ssim(1e-4, 9e-4), "gms": lambda: ttf.gms(0.0026), "mscn": ttf.mscn,
                   "mul": ttf.mul}


def _inputs(rng, name, n, shape):
    """Inputs in each map's domain: values about [0, 1] for the gamma and
    the gain; for SSIM and MSCN, means in [0, 1] and second moments whose
    variance is either negative (clamped by MSCN) or at least 0.01, so that
    XLA's fused `s2 - mu * mu` (an FMA) moves the square root by less than
    the tolerance."""
    if name in ("gamma", "gain"):
        return [rng.uniform(-0.2, 1.2, size=shape).astype(np.float32) for _ in range(n)]
    if name in ("ssim", "mscn"):
        mu = [rng.uniform(0, 1, size=shape).astype(np.float32) for _ in range(2)]
        var = rng.uniform(0.01, 0.05, size=shape).astype(np.float32)
        var[rng.uniform(size=shape) < 0.1] = -0.01
        second = [m * m + var for m in mu]
        return [mu[0], mu[1], second[0], second[1], mu[0] * mu[1] + var / 2] if name == "ssim" else \
            [rng.uniform(0, 1, size=shape).astype(np.float32), mu[0], second[0]]
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


# atol against the Pallas twin. XLA's CPU compiler contracts the SSIM map's
# `saa - mu_a * mu_a` into an FMA, so its variances differ by an ulp of mu^2
# (6e-8) from the port's two roundings, which the quotient carries to 3.1e-6
# at variances of 0.01 (ROADMAP Queue 3); the port's kernel and plain
# version round alike.
MAP_ATOL = {"ssim": 5e-6}


@pytest.mark.parametrize("name", sorted(TRANSFORM_CASES))
def test_transform_maps_match_pallas(rng, name):
    """Each map of the path through grid_transform on the CPU against its
    jnp expression through the Pallas grid_transform in interpret mode, at
    a ragged 70x300 in (32, 128) tiles: atol 1e-6 (rtol 1e-6 beside it for
    the quotients), SSIM's MAP_ATOL; and equal to the plain version's bits
    in any tiling."""
    m = TRANSFORM_CASES[name]()
    xs = _inputs(rng, name, m.n_in, (70, 300))
    out = N(ttf.grid_transform(m, *(T(x) for x in xs)))
    pal = np.asarray(pgrid.grid_transform(_jax_twins(m), *(jnp.asarray(x) for x in xs), tile=(32, 128),
                                          interpret=True))
    np.testing.assert_allclose(out, pal, rtol=1e-6, atol=MAP_ATOL.get(name, 1e-6))
    np.testing.assert_array_equal(out, N(ttf.grid_transform_plain(m.fn, *(T(x) for x in xs), tile=(32, 128))))


def test_grid_transform_reads_and_writes_strided_views(rng):
    """Channel views of an interleaved (H, W, 3) frame, in and out."""
    img = T(rng.uniform(size=(20, 33, 3)).astype(np.float32))
    out = torch.zeros(20, 33, 3)
    gains = torch.tensor([0.5, 2.0, 1.5])
    for c in range(3):
        ttf.grid_transform(ttf.gain(gains, c), img[..., c], out=out[..., c])
    np.testing.assert_array_equal(N(out), N(torch.clamp(img * gains, 0.0, 1.0)))


def test_transform_wrappers_check_their_maps():
    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="takes 2 arrays"):
        ttf.grid_transform(ttf.mul(), x)
    with pytest.raises(ValueError, match="reduce map"):
        ttf.grid_transform(ttf.sq(), x)
    with pytest.raises(ValueError, match="transform map"):
        reduce.grid_reduce(ttf.mul(), x, x)
    with pytest.raises(ValueError, match="kind"):
        reduce.grid_reduce(ttf.sq(), x, kind="mean")
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        ttf.streamed_transform(ttf.gamma(0.5), torch.zeros(2, 3, 4))


@pytest.mark.parametrize("shape,block", [((500, 256), 128), ((37, 300), 16)])
def test_streamed_transform_plain_matches_pallas(rng, shape, block):
    """Twin of tests/test_pallas_pipeline.py::test_streamed_transform_elementwise
    (rtol, atol 1e-5), and the gamma map over a ragged last block."""
    x = rng.normal(size=shape).astype(np.float32)
    out = N(ttf.streamed_transform_plain(lambda a: torch.tanh(a) * 2.0 + 0.25, T(x), block=block))
    pal = np.asarray(ppipe.streamed_transform(lambda a: jnp.tanh(a) * 2.0 + 0.25, jnp.asarray(x), block=block,
                                              interpret=True))
    np.testing.assert_allclose(out, pal, rtol=1e-5, atol=1e-5)
    m = ttf.gamma(1 / 2.2)
    g = N(ttf.streamed_transform(m, T(x)))
    pal = np.asarray(ppipe.streamed_transform(_jax_twins(m), jnp.asarray(x), block=block, interpret=True))
    np.testing.assert_allclose(g, pal, rtol=1e-5, atol=1e-5)


def test_grid_reduce_plain_matches_pallas(rng):
    """Twins of tests/test_pallas_grid.py's grid_reduce cases: sums rtol
    1e-5, min and max exact, and maps that are not neutral at the pad."""
    a = rng.normal(size=(200, 330)).astype(np.float32)
    ja = jnp.asarray(a)
    for tmap, jmap, kind, tile in ((lambda x: x * x, lambda x: x * x, "sum", (128, 128)),
                                   (lambda x: torch.exp(-x * x), lambda x: jnp.exp(-x * x), "sum", (128, 128)),
                                   (lambda x: x, lambda x: x, "min", (64, 128)),
                                   (lambda x: x, lambda x: x, "max", (64, 128)),
                                   (lambda x: x + 10.0, lambda x: x + 10.0, "min", (64, 128))):
        out = float(reduce.grid_reduce_plain(tmap, T(a), kind=kind, tile=tile))
        pal = float(pgrid.grid_reduce(jmap, ja, kind=kind, tile=tile, interpret=True))
        if kind == "sum":
            np.testing.assert_allclose(out, pal, rtol=1e-5)
        else:
            assert out == pal


REDUCE_CASES = {"ident": ttf.ident, "sqdiff": ttf.sqdiff, "sq": ttf.sq, "abs": ttf.abs_, "neg_sq": ttf.neg_sq,
                "pos_sq": ttf.pos_sq, "neg": ttf.neg, "pos": ttf.pos, "gated": lambda: ttf.gated(0.9, 1),
                "gated_count": lambda: ttf.gated_count(0.9), "sqdev": lambda: ttf.sqdev(torch.tensor(0.25))}


@pytest.mark.parametrize("name", sorted(REDUCE_CASES))
def test_reduce_maps_match_pallas(rng, name):
    """Each reduce map of the path through grid_reduce on the CPU against
    its jnp expression through the Pallas grid_reduce in interpret mode,
    70x300 in (32, 128) tiles: sums rtol 1e-5, counts exact, min and max of
    the identity exact."""
    m = REDUCE_CASES[name]()
    xs = [rng.uniform(-0.5, 1.0, size=(70, 300)).astype(np.float32) for _ in range(m.n_in)]
    out = float(reduce.grid_reduce(m, *(T(x) for x in xs)))
    pal = float(pgrid.grid_reduce(_jax_twins(m), *(jnp.asarray(x) for x in xs), tile=(32, 128), interpret=True))
    np.testing.assert_allclose(out, pal, rtol=1e-5)
    if name in ("neg", "pos", "gated_count"):
        assert out == pal == int(out) > 0
    if name == "ident":
        for kind in ("min", "max"):
            assert float(reduce.grid_reduce(m, T(xs[0]), kind=kind)) == float(
                pgrid.grid_reduce(lambda x: x, jnp.asarray(xs[0]), kind=kind, tile=(32, 128), interpret=True))
    mean = float(reduce.grid_reduce(m, *(T(x) for x in xs), div=float(xs[0].size)))
    np.testing.assert_allclose(mean, out / xs[0].size, rtol=1e-6)


def test_grid_reduce_min_max_propagate_nan(rng):
    x = rng.normal(size=(9, 40)).astype(np.float32)
    x[4, 7] = np.nan
    for kind in ("min", "max"):
        assert np.isnan(float(reduce.grid_reduce(ttf.ident(), T(x), kind=kind)))


GROUP_CASES = {"ggd": ttf.ggd_moments, "aggd": ttf.aggd_moments, "grayworld": lambda: ttf.grayworld_sums(0.9)}


@pytest.mark.parametrize("shape", [(70, 300), (37, 301)], ids=["70x300", "ragged_37x301"])
@pytest.mark.parametrize("group", sorted(GROUP_CASES))
def test_grid_reduce_sums_match_single_maps_and_pallas(rng, group, shape):
    """Each group of grid_reduce_sums (the kernel's multi-output sums) on the
    CPU: equal to per-map grid_reduce_plain bit for bit, divided as
    grid_reduce divides, and each sum against its jnp map through the Pallas
    grid_reduce in interpret mode in (32, 128) tiles at rtol 1e-5, counts
    exact."""
    grp = GROUP_CASES[group]()
    assert grp.name == group
    maps = grp.maps
    xs = [rng.uniform(-0.5, 1.0, size=shape).astype(np.float32) for _ in range(maps[0].n_in)]
    out = N(reduce.grid_reduce_sums_plain(grp, *(T(x) for x in xs)))
    single = np.array([float(reduce.grid_reduce_plain(m.fn, *(T(x) for x in xs))) for m in maps], np.float32)
    np.testing.assert_array_equal(out, single)
    np.testing.assert_array_equal(N(reduce.grid_reduce_sums(grp, *(T(x) for x in xs))), out)
    divs = [float(k + 2) for k in range(len(maps))]
    np.testing.assert_array_equal(N(reduce.grid_reduce_sums(grp, *(T(x) for x in xs), div=divs)),
                                  [float(reduce.grid_reduce(m, *(T(x) for x in xs), div=d)) for m, d in zip(maps, divs)])
    for m, v in zip(maps, out):
        pal = float(pgrid.grid_reduce(_jax_twins(m), *(jnp.asarray(x) for x in xs), tile=(32, 128), interpret=True))
        np.testing.assert_allclose(v, pal, rtol=1e-5)
        if m.name in ("neg", "pos", "gated_count"):
            assert v == pal == int(v) > 0


def test_grid_reduce_sums_refuses_what_the_kernel_does_not_take():
    """On the CPU as on the card: min / max, and every Group that is not one
    its constructor builds (mixed arity, a transform map, more than 8 maps,
    none, maps out of order, a grayworld group with mixed gates, a bare
    tuple of maps); a div per map of the wrong length. The constructors'
    groups pass."""
    x = torch.zeros(4, 4)
    for kind in ("min", "max"):
        with pytest.raises(ValueError, match="sums only"):
            reduce.grid_reduce_sums(ttf.ggd_moments(), x, kind=kind)
    gw = ttf.grayworld_sums(0.9)
    for bad in (ttf.Group("ggd", (ttf.sq(), ttf.gated_count(0.9))), ttf.Group("ggd", (ttf.sq(), ttf.gamma(0.5))),
                ttf.Group("aggd", (ttf.sq(),) * 9), ttf.Group("ggd", ()), ttf.Group("ggd", (ttf.abs_(), ttf.sq())),
                ttf.Group("grayworld", gw.maps[:2] + (ttf.gated(0.8, 2),) + gw.maps[3:], gw.hparams),
                ttf.Group("grayworld", gw.maps, (0.8,)), ttf.Group("ggd", ttf.ggd_moments().maps, (1.0,)),
                ttf.Group("median", (ttf.sq(),)), (ttf.sq(), ttf.abs_())):
        with pytest.raises(ValueError, match="not one of the kernel's groups"):
            reduce.grid_reduce_sums(bad, *([x] * 3))
    with pytest.raises(ValueError, match="one per map"):
        reduce.grid_reduce_sums(ttf.ggd_moments(), x, div=(1.0, 2.0, 3.0))
    with pytest.raises(ValueError, match="takes 1 arrays"):
        reduce.grid_reduce_sums(ttf.ggd_moments(), x, x)
    assert reduce.grid_reduce_sums(ttf.grayworld_sums(0.5), x, x, x).shape == (4,)
    assert reduce.grid_reduce_sums(ttf.aggd_moments(), x).shape == (6,)


def test_the_row_walk_paths():
    """vec4_path: the float4 path for views with stride 1, a row pitch that
    is a multiple of 4 (or one row) and a 16-byte aligned pointer; the
    strided path for the rest; and no row may span 2**31 elements."""
    a = torch.zeros(33, 1004)
    assert ttf.vec4_path([a]) and ttf.vec4_path([a[:, :1001], a[2:, :8]]) and ttf.vec4_path([torch.zeros(1, 7)])
    assert not ttf.vec4_path([a[:, 1:]]) and not ttf.vec4_path([torch.zeros(5, 7)])
    rgb = torch.zeros(4, 8, 3)
    assert not ttf.vec4_path([rgb[..., 0]]) and not ttf.vec4_path([a, a.t()[:33, :33]])
    wide = torch.empty_strided((1, 2), (1, 2 ** 31), device="meta")
    with pytest.raises(ValueError, match="spans 2"):
        ttf.check_views([wide], "t", wide.device)


def test_grid_histogram_drop_rule_matches_pallas(rng):
    """Twin of tests/test_pallas_grid.py::test_grid_histogram (150x210, 16
    bins, exact counts), with NaN and out-of-range values the rule drops."""
    a = rng.random((150, 210)).astype(np.float32)
    out = N(thist.grid_histogram(T(a), 16, 0.0, 1.0))
    np.testing.assert_array_equal(out, np.histogram(a, bins=16, range=(0.0, 1.0))[0])
    a[rng.uniform(size=a.shape) < 0.05] = np.nan
    a[:4] = rng.uniform(-1, 2, size=(4, 210))
    for bins, vmin, vmax in ((16, 0.0, 1.0), (10, -0.3, 0.7)):
        out = N(thist.grid_histogram(T(a), bins, vmin, vmax))
        pal = np.asarray(pgrid.grid_histogram(jnp.asarray(a), bins=bins, vmin=vmin, vmax=vmax, tile=(64, 128),
                                              interpret=True))
        np.testing.assert_array_equal(out, pal)


def test_the_two_histogram_rules():
    """4 bins over [0, 1] of [0, .5, 1, 1.5, -.2, NaN, .999999]: the Pallas
    rule drops NaN and what lies outside [0, 1); ops.histogram's clamps."""
    x = np.array([[0.0, 0.5, 1.0, 1.5, -0.2, np.nan, 0.999999]], np.float32)
    drop = N(thist.grid_histogram(T(x), 4, 0.0, 1.0, rule="drop"))
    clamp = N(thist.grid_histogram(T(x), 4, 0.0, 1.0, rule="clamp"))
    np.testing.assert_array_equal(drop, [1, 0, 1, 1])
    np.testing.assert_array_equal(clamp, [3, 0, 1, 3])
    np.testing.assert_array_equal(drop, np.asarray(pgrid.grid_histogram(jnp.asarray(x), 4, 0.0, 1.0, interpret=True)))


def test_grid_histogram_tiles_match_the_onehot_counts(rng):
    """CLAHE's batched tile histograms (a 100x130 frame cropped to 8 x 8
    tiles of 12 x 16) against the JAX one-hot counts of the same crop."""
    from opencv_contrib_tpu.ops import histogram as jhist

    x = rng.uniform(-0.1, 1.1, size=(100, 130)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.02] = np.nan
    out = N(thist.grid_histogram(T(x), 256, 0.0, 1.0, rule="clamp", tiles=(8, 8)))
    crop = jnp.asarray(x[:96, :128]).reshape(8, 12, 8, 16).transpose(0, 2, 1, 3).reshape(64, -1)
    idx = jnp.clip((crop * 256).astype(jnp.int32), 0, 255)
    np.testing.assert_array_equal(out, np.asarray(jhist._onehot_counts(idx, 256)))
    assert out.shape == (64, 256) and out.sum() == 96 * 128


def test_map_codes_match_the_header():
    """MAP_CODES mirrors csrc/maps.cuh's MAP_* numbers, and every number
    has its one functor case in the dispatch of its kind."""
    text = (_build.CSRC / "maps.cuh").read_text()
    codes = {k.lower(): int(v) for k, v in re.findall(r"constexpr int MAP_(\w+) = (\d+);", text)}
    assert codes == ttf.MAP_CODES
    cases = re.findall(r"case MAP_(\w+):", text)
    assert sorted(c.lower() for c in cases) == sorted(ttf.MAP_CODES)
    transform_part = text[text.index("dispatch_transform"):text.index("dispatch_reduce")]
    assert sorted(c.lower() for c in re.findall(r"case MAP_(\w+):", transform_part)) == sorted(ttf.TRANSFORM_MAPS)


def test_group_codes_match_the_header():
    """GROUP_CODES and the constructors of transform.GROUPS mirror
    csrc/maps.cuh's GROUP_* numbers and the maps each lists in output order;
    each group has its dispatch case, and its functor calls those maps'
    functors in that order."""
    text = (_build.CSRC / "maps.cuh").read_text()
    found = re.findall(r"constexpr int GROUP_(\w+) = (\d+);  // (.*)", text)
    assert {k.lower(): int(v) for k, v, _ in found} == ttf.GROUP_CODES
    assert sorted(ttf.GROUPS) == sorted(GROUP_CASES) == sorted(ttf.GROUP_CODES)
    names = {g: tuple(m.name for m in GROUP_CASES[g]().maps) for g in GROUP_CASES}
    assert {k.lower(): tuple(m.strip() for m in maps.split(",")) for k, _, maps in found} == names
    assert sorted(c.lower() for c in re.findall(r"case GROUP_(\w+):", text)) == sorted(ttf.GROUP_CODES)
    functor = {"sq": "Sq{}", "abs": "Abs{}", "neg": "SideCount<true>{}", "pos": "SideCount<false>{}",
               "neg_sq": "SideSq<true>{}", "pos_sq": "SideSq<false>{}"}
    for struct, group in (("GgdMoments", "ggd"), ("AggdMoments", "aggd")):
        body = text[text.index(f"struct {struct}"):]
        body = body[:body.index("};")]
        calls = re.findall(r"o\[(\d)\] = (\w+(?:<\w+>)?\{\})\(v\);", body)
        assert [int(k) for k, _ in calls] == list(range(len(names[group])))
        assert [f for _, f in calls] == [functor[m] for m in names[group]]


# ---- the launch plans of the getAb and grid_histogram kernels ----------------

@pytest.mark.parametrize("H,W", [(480, 640), (240, 320), (120, 160), (1080, 1920), (481, 643), (37, 5), (1, 7),
                                 (1, 100000)])
def test_getab_plan_fits_the_scratch_and_the_card(H, W):
    """The getAb grid: sqrt(H W) / 2 blocks rounded up, at most two an SM of
    an H100 (csrc/reduce_vec.cu MAX_BLOCKS), no block without a pixel, and
    their partials fit the scratch grid_reduce caches; it depends on (H, W)
    alone."""
    blocks = reduce.getab_plan(H, W)
    assert 1 <= blocks <= reduce._GETAB_MAX_BLOCKS
    assert blocks == min(reduce._GETAB_MAX_BLOCKS, max(1, int(np.ceil(np.floor(np.sqrt(H * W)) / 2))),
                         -(-(H * W) // reduce._GETAB_THREADS))
    assert (blocks - 1) * reduce._GETAB_THREADS < H * W
    assert 4 + blocks * reduce._OUT <= 4 + reduce._GETAB_MAX_BLOCKS * reduce._OUT <= reduce._SCRATCH_FLOATS
    assert blocks == reduce.getab_plan(H, W)
    text = (_build.CSRC / "reduce_vec.cu").read_text()
    assert f"constexpr int MAX_BLOCKS = {reduce._GETAB_MAX_BLOCKS // 132} * 132;" in text
    assert f"constexpr int THREADS = {reduce._GETAB_THREADS};" in text
    assert "static constexpr int OUT = 29;" in text and reduce._OUT == 29


def test_getab_plan_at_the_icp_levels():
    assert [reduce.getab_plan(480 >> lvl, 640 >> lvl) for lvl in range(3)] == [264, 139, 69]


# (H, W, tiles, the float4 walk): CLAHE's tiles of a 1080p frame, the frame,
# `ops.histogram.histogram`'s one row of it, ragged shapes (tiles of 257 or
# 515 columns, a row of 7), CLAHE's crop of 8x16 tiles in a pitch of 130
# (scalar) and of 128, tiles of several blocks, one-row images
HIST_PLANS = [(1080, 1920, (8, 8), True), (1080, 1920, None, True), (1, 1080 * 1920, None, True),
              (101, 257, None, False), (101, 257, (2, 1), False), (5, 3, None, False), (1, 7, None, False),
              (100, 130, (8, 8), False), (100, 128, (8, 8), True), (130, 1030, (2, 2), False),
              (257, 1024, (2, 4), True), (1, 100000, None, True), (1, 100003, None, False),
              (1, 1000003, None, False)]


@pytest.mark.parametrize("H,W,tiles,vec4", HIST_PLANS)
def test_grid_histogram_plan_covers_each_tile(H, W, tiles, vec4):
    """Which tiles take the float4 walk (a 16-byte aligned image, tiles a
    multiple of 4 wide, a pitch that is a multiple of 4 or one row), and the
    blocks a tile: no block empty, every unit of a tile counted, at least
    _ITEMS values a thread before a tile takes another block, and at most
    _MAX_BLOCKS blocks over all tiles unless each tile has one; at most 32
    blocks add into one copy of a tile's counts, up to 16 copies, all within
    the cached scratch."""
    ty, tx = tiles or (1, 1)
    rows, cols = H // ty, W // tx
    x = torch.zeros(H, W)
    assert thist.vec4_walk(x, rows, cols, ty) == vec4
    per_tile, chunk, spread = thist.plan(rows, cols, ty * tx, vec4)
    units = rows * (cols // 4 if vec4 else cols)
    assert (per_tile - 1) * chunk < units <= per_tile * chunk
    assert per_tile == 1 or rows * cols > (per_tile - 1) * thist._THREADS * thist._ITEMS
    assert per_tile * ty * tx <= max(thist._MAX_BLOCKS, ty * tx)
    assert 1 <= spread <= thist._MAX_SPREAD and (per_tile <= 32 * spread or spread == thist._MAX_SPREAD)
    assert spread == 1 or per_tile > 32 * (spread - 1)
    text = (_build.CSRC / "histogram.cu").read_text()
    assert f"constexpr int MAX_SPREAD = {thist._MAX_SPREAD};" in text


def test_grid_histogram_plan_at_the_path_shapes():
    """CLAHE's 64 tiles of 135 x 240 take 8 blocks a tile, 512 in all, each
    tile's counts in one copy; the 1080p frame 507 blocks over 16 copies; a
    view that starts 4 bytes in takes the scalar walk."""
    assert thist.plan(135, 240, 64, True) == (8, 1013, 1)
    assert thist.plan(1080, 1920, 1, True) == (507, 1023, 16)
    x = torch.zeros(1080, 1924)
    assert thist.vec4_walk(x[:, :1920], 1080, 1920, 1) and not thist.vec4_walk(x[:, 1:1921], 1080, 1920, 1)


def test_grid_histogram_shared_bins_fit_up_to_the_bin_limit():
    """csrc/histogram.cu keeps one copy of the bins, a block's shared memory
    of bins int32, within 48 KB, so the wrapper's limit of 12,288 bins fits,
    and one bin more would not."""
    text = (_build.CSRC / "histogram.cu").read_text()
    assert "const size_t smem = (size_t)r.bins * sizeof(int);" in text
    assert "(size_t)bins * sizeof(int) > SMEM" in text
    assert f"constexpr int SMEM = {thist._SMEM // 1024} * 1024;" in text
    assert f"constexpr int THREADS = {thist._THREADS};" in text
    assert thist._MAX_BINS == 12288 and thist._MAX_BINS * 4 <= thist._SMEM < (thist._MAX_BINS + 1) * 4


def test_grid_histogram_scratch_grows_and_keeps_what_it_has(monkeypatch):
    """The tickets and counts cached per device and stream hold the largest
    call so far: CLAHE's 64 x 256 from the start, 12,288 bins of one tile
    after such a call."""
    monkeypatch.setattr(thist, "_scratch", {})
    dev = torch.device("cpu")
    tickets, counts = thist._scratch_for(dev, 0, 64, 256)
    assert tickets.numel() >= 64 and counts.numel() >= 64 * 256 and not counts.any() and not tickets.any()
    assert thist._scratch_for(dev, 0, 1, 256)[1] is counts
    _, big = thist._scratch_for(dev, 0, 1, 12288)
    assert big.numel() >= 64 * 256 and big.numel() >= 12288
    assert thist._scratch_for(dev, 0, 64, 256)[1] is big
    assert thist._scratch_for(dev, 1, 64, 256)[1] is not big


def test_grid_histogram_quotient_by_a_power_of_two_is_a_product():
    """_inverse gives the clamp rule's exact reciprocal where q is a power
    of two (the kernel multiplies there; the quotient has the same bits),
    and 0 elsewhere and for the drop rule."""
    assert [thist._inverse("clamp", q) for q in (1.0, 2.0, 0.25, 1.5, 3.0)] == [1.0, 0.5, 4.0, 0.0, 0.0]
    assert thist._inverse("drop", 1.0) == 0.0
    d = np.random.default_rng(0).uniform(-4, 4, 10000).astype(np.float32)
    for q in (np.float32(1.0), np.float32(0.25), np.float32(2.0 ** -20)):
        inv = np.float32(thist._inverse("clamp", float(q)))
        np.testing.assert_array_equal((d / q).view(np.int32), (d * inv).view(np.int32))


@pytest.mark.parametrize("bins,vmin,vmax", [(256, -0.25, 1.25), (1000, -0.3, 0.7), (37, 0.1, 1.3)])
def test_histogram_clamp_rule_matches_jax_at_any_range(rng, bins, vmin, vmax):
    """`ops.histogram.histogram` (the clamp rule) against the JAX twin at
    ranges whose quotient is not a product, NaN included; the plain version
    divides by a tensor on the input's device, so it keeps the quotient on
    the card too."""
    from opencv_contrib_tpu.ops import histogram as jhist
    from opencv_contrib_tpu_torch.ops import histogram as thistogram

    x = rng.uniform(-0.5, 1.5, (150, 210)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.03] = np.nan
    out = N(thistogram.histogram(T(x), bins, vmin, vmax))
    np.testing.assert_array_equal(out, np.asarray(jhist.histogram(jnp.asarray(x), bins, vmin, vmax)))


def _no_launch(*args, **kwargs):
    raise AssertionError("the wrapper reached the kernel")


def test_grid_histogram_refuses_what_the_kernel_does_not_take(monkeypatch):
    """The wrapper's checks on the CUDA path (use_kernel forced to True, the
    library never reached): float32 (H, W) with unit column stride, at most
    12,288 bins, at least one tile, fewer than 2**31 elements spanned, at
    most 65,535 tiles."""
    monkeypatch.setattr(thist, "use_kernel", lambda x: True)
    monkeypatch.setattr(_build, "lib", _no_launch)
    x = torch.zeros(8, 12)
    for bad, match in ((x.double(), "float32"), (x[None], "float32"), (x.t(), "unit column stride")):
        with pytest.raises(ValueError, match=match):
            thist.grid_histogram(bad, 16, 0.0, 1.0)
    with pytest.raises(ValueError, match="at most 12288 bins"):
        thist.grid_histogram(x, 12289, 0.0, 1.0)
    with pytest.raises(ValueError, match="has no 9x1 tiles"):
        thist.grid_histogram(x, 16, 0.0, 1.0, tiles=(9, 1))
    with pytest.raises(ValueError, match="at most 65535 tiles"):
        thist.grid_histogram(torch.zeros(256, 512), 16, 0.0, 1.0, tiles=(256, 256))
    wide = torch.empty_strided((2, 4), (2 ** 31, 1), device="meta")
    with pytest.raises(ValueError, match="spans 2"):
        thist.grid_histogram(wide, 16, 0.0, 1.0)


def test_icp_getab_refuses_what_the_kernel_does_not_take(monkeypatch, rng):
    """The wrapper's checks on the CUDA path (use_kernel forced to True, the
    library never reached): each array's shape and dtype, then its device."""
    monkeypatch.setattr(reduce, "use_kernel", lambda x: True)
    monkeypatch.setattr(_build, "lib", _no_launch)
    (sp, sn, sv, dp, dn, dv), intr = _getab_frames(rng)
    args = [torch.eye(4), T(sp), T(sn), T(sv), T(dp), T(dn), T(dv), T(intr)]
    for k, bad in ((0, torch.eye(4)[:3]), (1, T(sp)[..., :2]), (3, T(sv).float()), (5, T(dn).double())):
        with pytest.raises(ValueError, match="expected"):
            reduce.icp_getab(*args[:k], bad, *args[k + 1:])
    with pytest.raises(ValueError, match="the kernel takes CUDA tensors"):
        reduce.icp_getab(*args)
