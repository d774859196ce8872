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
from opencv_contrib_tpu.ops import integral as jinteg
from opencv_contrib_tpu.ops.pallas import grid as pgrid
from opencv_contrib_tpu.ops.pallas import matching as pmatch
from opencv_contrib_tpu.ops.pallas import pipeline as ppipe
from opencv_contrib_tpu_torch.features import match as fmatch
from opencv_contrib_tpu_torch.ops import integral as tinteg
from opencv_contrib_tpu_torch.ops import cuda as tcuda
from opencv_contrib_tpu_torch.ops.cuda import _build, scan
from opencv_contrib_tpu_torch.ops.cuda import matching as tmatch


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


def test_cpu_calls_leave_launch_counters_at_zero(rng):
    tcuda.reset_launches()
    q = T(rng.normal(size=(64, 16)).astype(np.float32))
    tmatch.knn2(q, q)
    tmatch.ratio_test_match_fused(q, q)
    fmatch.ratio_test_match(q, q)
    scan.grid_scan(q)
    scan.integral_image(q)
    tinteg.integral(q)
    assert tcuda.launches() == {"knn2": 0, "integral_image": 0, "grid_scan": 0}


def test_other_devices_raise():
    x = torch.zeros(4, 4, device="meta")
    for fn in (scan.grid_scan, scan.integral_image, lambda a: tmatch.knn2(a, a)):
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
    (c_void_p) argtypes for every pointer and the stream, and nothing else is."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags and "-fPIC" in flags
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = src.read_text()
        entries = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text))
        assert set(entries) == set(_build.SIGNATURES[src.stem]), src.name
        for name, params in entries.items():
            kinds = [ctypes.c_void_p if ("*" in p or "cudaStream_t" in p) else ctypes.c_int
                     for p in params.split(",")]
            assert _build.SIGNATURES[src.stem][name] == kinds, name
            assert "return (int)cudaGetLastError();" in text
