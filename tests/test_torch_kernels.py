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
from opencv_contrib_tpu_torch.ops import integral as tinteg
from opencv_contrib_tpu_torch.ops import cuda as tcuda
from opencv_contrib_tpu_torch.ops.cuda import _build, pyramid, reduce, scan
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
    (sp, sn, sv, dp, dn, dv), intr = _getab_frames(rng)
    reduce.icp_getab(torch.eye(4), T(sp), T(sn), T(sv), T(dp), T(dn), T(dv), T(intr))
    pyramid.pyrdown(q)
    pyramid.pyrdown(q, border="replicate")
    tremap.remap(torch.stack([q, q]), q, q)
    tremap.remap(q, q, q, max_disp=2)
    assert tcuda.launches() == {"knn2": 0, "integral_image": 0, "grid_scan": 0, "grid_reduce_vec": 0,
                                "pyrdown": 0, "remap": 0}


def test_other_devices_raise():
    x = torch.zeros(4, 4, device="meta")
    pts = torch.zeros(4, 4, 3, device="meta")
    ok = torch.zeros(4, 4, dtype=torch.bool, device="meta")
    for fn in (scan.grid_scan, scan.integral_image, lambda a: tmatch.knn2(a, a),
               lambda a: reduce.icp_getab(a, pts, pts, ok, pts, pts, ok, a[0]),
               pyramid.pyrdown, lambda a: tremap.remap(a, a, a)):
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
