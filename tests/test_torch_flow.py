"""Parity of the PyTorch port's dense-flow slice (opencv_contrib_tpu_torch:
core/pyramid.py, ops/image.py's windows and resize, ops/filters.py's median,
flow/lk.py, flow/dis.py, flow/tvl1.py, entry.dense_flow) with the JAX
package, on the CPU, at tests/test_flow.py's 96x128 fixture with 3 levels.

Inputs are made with numpy from a seed and fed to both packages. XLA's CPU
compiler contracts `a * b + c` into FMAs and sums in its own order, so
single-pass results agree to a few float32 ulp (atol 1e-5 on values up to
about 4); the iterative solvers carry those ulps through tens of sweeps,
and their tolerances say how far."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu.core import pyramid as jpyr
from opencv_contrib_tpu.flow import dis as jdis
from opencv_contrib_tpu.flow import lk as jlk
from opencv_contrib_tpu.flow import tvl1 as jtvl1
from opencv_contrib_tpu.ops import filters as jfilt
from opencv_contrib_tpu.ops import image as jimg
from opencv_contrib_tpu_torch import entry
from opencv_contrib_tpu_torch.core import pyramid as tpyr
from opencv_contrib_tpu_torch.flow import dis as tdis
from opencv_contrib_tpu_torch.flow import lk as tlk
from opencv_contrib_tpu_torch.flow import tvl1 as ttvl1
from opencv_contrib_tpu_torch.ops import filters as tfilt
from opencv_contrib_tpu_torch.ops import image as timg

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def N(t):
    return t.detach().cpu().numpy()


def J(a):
    return jnp.asarray(np.asarray(a, dtype=np.float32))


def interior_epe(flow, gt, border: int = 8) -> float:
    e = np.linalg.norm(np.asarray(flow)[border:-border, border:-border] - gt[border:-border, border:-border], axis=-1)
    return float(e.mean())


@pytest.fixture(scope="module")
def textured():
    """tests/test_flow.py's texture, made by the JAX package."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, size=(96, 128)).astype(np.float32)
    return np.asarray(jfilt.gaussian_blur(jnp.asarray(img), 1.5)) * 4.0


def _shifted(img, dy, dx):
    M = jnp.array([[1.0, 0.0, dx], [0.0, 1.0, dy]])  # output->input map
    return np.asarray(jimg.warp_affine(jnp.asarray(img), M))


def _rotated(img, a=0.03):
    """tests/test_flow.py::TestDIS::test_rotation_field's pair and truth."""
    c, s = np.cos(a), np.sin(a)
    H, W = img.shape
    cy, cx = H / 2, W / 2
    M = jnp.array([[c, -s, cx - c * cx + s * cy], [s, c, cy - s * cx - c * cy]])
    I1 = np.asarray(jimg.warp_affine(jnp.asarray(img), M))
    Mh = np.eye(3, dtype=np.float32)
    Mh[:2] = np.asarray(M)
    Minv = np.linalg.inv(Mh)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    gx = Minv[0, 0] * x + Minv[0, 1] * y + Minv[0, 2] - x
    gy = Minv[1, 0] * x + Minv[1, 1] * y + Minv[1, 2] - y
    return I1, np.stack([gy, gx], axis=-1)


@pytest.fixture(scope="module")
def pairs(textured):
    return {"dis": _shifted(textured, 2.0, 1.0), "tvl1": _shifted(textured, 1.0, 2.0)}


@pytest.fixture(scope="module")
def jax_flows(textured, pairs):
    """The JAX package's flows, shared by the tests below."""
    return {"dis": np.asarray(jdis.compute(textured, pairs["dis"], levels=3)),
            "tvl1": np.asarray(jtvl1.compute(textured, pairs["tvl1"], levels=3))}


@pytest.fixture(scope="module")
def port_flows(textured, pairs):
    return {"dis": N(entry.dense_flow(textured, pairs["dis"], "dis", device="cpu", levels=3)),
            "tvl1": N(entry.dense_flow(textured, pairs["tvl1"], "tvl1", device="cpu", levels=3))}


# ---- pyramid --------------------------------------------------------------

# sides of 1 to 4: the 5-tap blur reaches past a side of 1 or 2, where the
# reflect border folds again (`jnp.pad(mode="reflect")`)
SMALL_SIDES = [(1, 6), (2, 6), (3, 4), (4, 4), (1, 1), (2, 1)]


@pytest.mark.parametrize("shape", [(96, 128), (109, 256), (37, 21), *SMALL_SIDES])
def test_pyr_down_matches_jax(rng, shape):
    """Reflect-101 5-tap blur + decimation, odd sizes and sides of 1 to 4
    included: one pass, atol 1e-6 on values in [0, 4)."""
    x = rng.uniform(0, 4, shape).astype(np.float32)
    out = N(tpyr.pyr_down(T(x)))
    ref = np.asarray(jpyr.pyr_down(J(x)))
    assert out.shape == ref.shape == ((shape[0] + 1) // 2, (shape[1] + 1) // 2)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shapes", [[(109, 256), (55, 128), (28, 64)], [(13, 6), (7, 3), (4, 2), (2, 1), (1, 1)]],
                         ids=["sintel", "to_1x1"])
def test_build_pyramid_matches_jax(rng, shapes):
    """An odd pyramid, 109x256 -> 55x128 -> 28x64 (Sintel's levels 2-4, and
    one more), and one down to a 1x1 level through levels of 1 and 2 rows
    or columns."""
    x = rng.uniform(0, 4, shapes[0]).astype(np.float32)
    out = tpyr.build_pyramid(T(x), len(shapes))
    ref = jpyr.build_pyramid(J(x), len(shapes))
    assert [tuple(o.shape) for o in out] == [r.shape for r in ref] == shapes
    for o, r in zip(out, ref):
        np.testing.assert_allclose(N(o), np.asarray(r), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_reflect_index_folds_as_jnp_pad(n):
    """The port's reflect-101 index at pads up to three times the side, as
    `jnp.pad(mode="reflect")` pads: [1, 2] by 2 is [1, 2, 1, 2, 1, 2], [1]
    repeats."""
    a = np.arange(1, n + 1, dtype=np.float32)
    for pad in sorted({0, n - 1, n, 2 * n + 1, 3 * n}):
        idx = N(tfilt.reflect_index(n, pad, pad + 1))
        np.testing.assert_array_equal(a[idx], np.asarray(jnp.pad(J(a), (pad, pad + 1), mode="reflect")))
    assert N(tfilt.reflect_pad(T([[1.0, 2.0]]), 0, 0, 2, 2)).tolist() == [[1, 2, 1, 2, 1, 2]]
    assert N(tfilt.reflect_pad(T([[1.0]]), 2, 2, 0, 0)).ravel().tolist() == [1] * 5


@pytest.mark.parametrize("shape", SMALL_SIDES)
def test_sep_filter2d_and_conv2d_reflect_at_any_side(rng, shape):
    """A 7-tap separable blur and a 5x3 depthwise correlation in the reflect
    border on sides of 1 to 4, where the pad reaches past the side: the
    JAX package's values, atol 1e-6 on values in [0, 4) (blur kernels with
    positive taps summing to 1, so the outputs stay in [0, 4); F.conv2d sums
    its taps in its own order)."""
    x = rng.uniform(0, 4, shape).astype(np.float32)
    kr, kc = (k / k.sum() for k in rng.uniform(0.1, 1, (2, 7)).astype(np.float32))
    out = N(tfilt.sep_filter2d(T(x), T(kr), T(kc)))
    ref = np.asarray(jfilt.sep_filter2d(J(x), J(kr), J(kc)))
    assert out.shape == ref.shape == shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    k2 = rng.uniform(0.1, 1, (5, 3)).astype(np.float32)
    k2 /= k2.sum()
    out = N(tfilt.conv2d(T(x), T(k2), border="reflect"))
    ref = np.asarray(jfilt.conv2d(J(x), J(k2), border="reflect"))
    assert out.shape == ref.shape == shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_sintel_pyramid_shapes():
    out = tpyr.build_pyramid(torch.zeros(436, 1024), 4)
    assert [tuple(o.shape) for o in out] == [(436, 1024), (218, 512), (109, 256), (55, 128)]


def test_pyr_up_matches_jax(rng):
    x = rng.uniform(0, 4, (24, 37)).astype(np.float32)
    out = N(tpyr.pyr_up(T(x)))
    ref = np.asarray(jpyr.pyr_up(J(x)))
    assert out.shape == ref.shape == (48, 74)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


# ---- image ----------------------------------------------------------------

WINDOW_CASES = {
    # (points (y, x), flow or None, radius): interior; every edge and corner,
    # with window rows at y0 + o = -1 and beyond; a flow that pushes windows out
    "interior": ([[40.3, 50.7], [30.0, 80.0], [60.5, 40.25]], None, 7),
    "borders": ([[0.25, 0.6], [0.0, 64.0], [95.3, 127.8], [47.5, 0.1], [47.5, 126.9], [95.99, 0.5],
                 [-0.5, 10.2], [96.4, 20.0]], None, 3),
    "flow": ([[10.0, 10.0], [85.2, 117.3], [48.0, 64.0]], [[-12.6, 3.3], [11.4, 9.9], [0.2, -0.7]], 8),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_sample_windows_matches_jax(textured, case):
    """The port gathers the corners directly; JAX selects columns with a
    one-hot dot. Same border rule: atol 1e-5."""
    pts, flow, radius = WINDOW_CASES[case]
    jargs = (J(pts), radius) + ((J(flow),) if flow is not None else ())
    ref = np.asarray(jimg.sample_windows(J(textured), *jargs))
    out = N(timg.sample_windows(T(textured), T(pts), radius, None if flow is None else T(flow)))
    assert out.shape == ref.shape == (len(pts), (2 * radius + 1) ** 2)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_sample_windows_border_rule():
    """A window row at y0 + o = -1 is clipped to row 0 and blends it with
    row 1 (`sample_bilinear` would blend row 0 with itself); likewise at
    the right edge the clipped column W-1 blends with itself."""
    img = np.arange(5 * 6, dtype=np.float32).reshape(5, 6) ** 1.5
    out = N(timg.sample_windows(T(img), T([[0.25, 4.5]]), 1)).reshape(3, 3)
    fy, fx = 0.25, 0.5
    rows = {-1: (0, 1), 0: (0, 1), 1: (1, 2)}
    cols = {-1: (3, 4), 0: (4, 5), 1: (5, 5)}
    for i, o in enumerate((-1, 0, 1)):
        r0, r1 = rows[o]
        for j, q in enumerate((-1, 0, 1)):
            c0, c1 = cols[q]
            top = img[r0, c0] * (1 - fx) + img[r0, c1] * fx
            bot = img[r1, c0] * (1 - fx) + img[r1, c1] * fx
            np.testing.assert_allclose(out[i, j], top * (1 - fy) + bot * fy, rtol=1e-6)
    ref = np.asarray(jimg.sample_windows(J(img), J([[0.25, 4.5]]), 1)).reshape(3, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    sb = float(timg.sample_bilinear(T(img), T([-0.75]), T([4.5]))[0])
    assert abs(sb - out[0, 1]) > 0.1  # the two samplers differ on that row


@pytest.mark.parametrize("case", ["linear_2d", "linear_flow_odd", "nearest", "area"])
def test_resize_matches_jax(rng, case):
    """Separable interpolation matrices; linear_flow_odd is the flow path's
    (H, W, 2) upsample 55x128 -> 109x256. atol 1e-5."""
    src, dst, method = {"linear_2d": ((30, 41), (64, 50), "linear"),
                        "linear_flow_odd": ((55, 128, 2), (109, 256), "linear"),
                        "nearest": ((30, 41), (17, 90), "nearest"),
                        "area": ((32, 48), (8, 12), "area")}[case]
    x = rng.uniform(-3, 3, src).astype(np.float32)
    out = N(timg.resize(T(x), dst, method))
    ref = np.asarray(jimg.resize(J(x), dst, method))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_warp_affine_matches_jax(textured):
    M = np.array([[0.999, -0.03, 2.4], [0.03, 0.999, -3.7]], np.float32)
    out = N(timg.warp_affine(T(textured), T(M)))
    ref = np.asarray(jimg.warp_affine(J(textured), J(M)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_median_filter3_matches_jax(rng):
    """The median picks one of the 9 inputs, so the two agree exactly; the
    shifts wrap at the borders in both."""
    x = rng.normal(size=(21, 34)).astype(np.float32)
    np.testing.assert_array_equal(N(tfilt.median_filter3(T(x))), np.asarray(jfilt.median_filter3(J(x))))


# ---- Lucas-Kanade ---------------------------------------------------------

def test_lk_level_matches_jax(textured):
    """One level, 10 Gauss-Newton steps from zero at 12 points, a few
    degenerate (flat) ones included: flows within 1e-4 px, equal masks."""
    I1 = _shifted(textured, 1.3, -0.8)
    rng = np.random.default_rng(5)
    pts = np.concatenate([rng.uniform(8, 88, (10, 1)), rng.uniform(8, 120, (10, 1))], 1).astype(np.float32)
    pts = np.concatenate([pts, [[0.0, 0.0], [95.0, 127.0]]]).astype(np.float32)
    flow0 = np.zeros_like(pts)
    jf, jv = jlk.lk_level(J(textured), J(I1), J(pts), J(flow0), radius=7, iters=10)
    tf, tv = tlk.lk_level(T(textured), T(I1), T(pts), T(flow0), radius=7, iters=10)
    np.testing.assert_array_equal(N(tv), np.asarray(jv))
    np.testing.assert_allclose(N(tf), np.asarray(jf), rtol=0, atol=1e-4)


def test_lk_track_matches_jax(textured):
    """tests/test_flow.py::TestLK::test_sparse_track_translation on the
    port (flow within 0.1 px of the truth), and the JAX flow within 1e-3."""
    I1 = _shifted(textured, 3.0, -2.0)  # flow I0 -> I1 = (-3, +2)
    pts = np.array([[40.0, 50.0], [30, 80], [60, 40], [50, 100]], np.float32)
    new_pts, flow, valid = tlk.track(T(textured), T(I1), T(pts))
    _, jflow, jvalid = jlk.track(J(textured), J(I1), J(pts))
    assert bool(valid.all()) and bool(np.asarray(jvalid).all())
    np.testing.assert_allclose(N(flow), np.tile([-3.0, 2.0], (4, 1)), atol=0.1)
    np.testing.assert_allclose(N(flow), np.asarray(jflow), rtol=0, atol=1e-3)
    np.testing.assert_allclose(N(new_pts), pts + N(flow), rtol=0, atol=1e-5)


def test_lk_invalid_outside(textured):
    """tests/test_flow.py::TestLK::test_invalid_outside on the port."""
    I1 = _shifted(textured, 0.0, 40.0)
    _, _, valid = tlk.track(T(textured), T(I1), T([[48.0, 5.0]]))
    assert not bool(valid[0])


# ---- DIS and TV-L1 stages, with the JAX inputs carried in -----------------

@pytest.fixture(scope="module")
def level_inputs(textured, pairs):
    """JAX pyramids of the DIS pair and a smooth flow at level 1 (48x64)."""
    p0 = jpyr.build_pyramid(J(textured), 3)
    p1 = jpyr.build_pyramid(J(pairs["dis"]), 3)
    rng = np.random.default_rng(7)
    coarse = rng.uniform(-1.5, 1.5, (6, 8, 2)).astype(np.float32)
    flow1 = np.asarray(jimg.resize(J(coarse), (48, 64)))
    return [np.asarray(a) for a in p0], [np.asarray(a) for a in p1], flow1


def test_level_patch_flow_matches_jax(level_inputs):
    """Patch search + densification at level 1, stride 8, radius 8, 12 LK
    iterations, from the same flow: within 1e-4 px."""
    p0, p1, flow1 = level_inputs
    ref = np.asarray(jdis._level_patch_flow(J(p0[1]), J(p1[1]), J(flow1), stride=8, radius=8, iters=12))
    out = N(tdis._level_patch_flow(T(p0[1]), T(p1[1]), T(flow1), stride=8, radius=8, iters=12))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_variational_refine_matches_jax(level_inputs):
    """3 warps x 30 Jacobi sweeps at level 0 from the same flow: the sweeps
    are a contraction, so the ulps stay small: within 1e-4 px."""
    p0, p1, flow1 = level_inputs
    flow0 = np.asarray(jimg.resize(J(flow1), (96, 128))) * 2.0
    ref = np.asarray(jdis.variational_refine(J(p0[0]), J(p1[0]), J(flow0)))
    out = N(tdis.variational_refine(T(p0[0]), T(p1[0]), T(flow0)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_tvl1_level_matches_jax(level_inputs):
    """5 warps x 30 primal-dual iterations + medians at level 1 from the
    same flow: within 1e-3 px (the thresholding switches branch where the
    residual crosses +-lam*theta*|grad|^2, which an ulp can move)."""
    p0, p1, flow1 = level_inputs
    ref = np.asarray(jtvl1._tvl1_level(J(p0[1]), J(p1[1]), J(flow1)))
    out = N(ttvl1._tvl1_level(T(p0[1]), T(p1[1]), T(flow1)))
    err = np.abs(out - ref)
    assert err.max() <= 1e-3, err.max()


# ---- end to end -----------------------------------------------------------

@pytest.mark.parametrize("method", ["dis", "tvl1"])
def test_compute_matches_jax(jax_flows, port_flows, method):
    """dis.compute and tvl1.compute, 3 levels, through entry.dense_flow on
    the CPU: within 1e-3 px everywhere (mean within 1e-5)."""
    err = np.abs(port_flows[method] - jax_flows[method])
    assert port_flows[method].shape == (96, 128, 2)
    assert err.max() <= 1e-3 and err.mean() <= 1e-5, (err.max(), err.mean())


def test_dis_translation_epe(port_flows):
    """tests/test_flow.py:48 on the port."""
    gt = np.tile(np.array([-2.0, -1.0], np.float32), (96, 128, 1))
    assert interior_epe(port_flows["dis"], gt) < 0.25


def test_tvl1_translation_epe(port_flows):
    """tests/test_flow.py:83 on the port."""
    gt = np.tile(np.array([-1.0, -2.0], np.float32), (96, 128, 1))
    assert interior_epe(port_flows["tvl1"], gt) < 0.35


def test_dis_rotation_field(textured):
    """tests/test_flow.py:69 on the port, and its field within 1e-3 px of
    the JAX package's."""
    I1, gt = _rotated(textured)
    flow = N(tdis.compute(T(textured), T(I1), levels=3))
    assert interior_epe(flow, gt) < 0.3
    ref = np.asarray(jdis.compute(textured, I1, levels=3))
    assert np.abs(flow - ref).max() <= 1e-3


def test_epe_metric():
    f, g = torch.zeros(4, 4, 2), torch.ones(4, 4, 2)
    assert abs(float(tdis.epe(f, g)) - np.sqrt(2)) < 1e-6
    mask = torch.zeros(4, 4)
    mask[1, 1] = 1.0
    assert abs(float(tdis.epe(f, g, mask)) - np.sqrt(2)) < 1e-6


def test_flow_pair_is_the_recipe():
    """entry.flow_pair builds tests/test_flow.py's texture and a rotation +
    shift warp: the JAX package's blur and warp on the same noise agree."""
    I0, I1, gt = entry.flow_pair(96, 128, seed=3, angle=0.01, shift_xy=(3.0, -5.0))
    rng = np.random.default_rng(3)
    ref0 = np.asarray(jfilt.gaussian_blur(jnp.asarray(rng.uniform(0, 1, size=(96, 128)).astype(np.float32)),
                                          1.5)) * 4.0
    np.testing.assert_allclose(I0, ref0, rtol=0, atol=1e-5)
    c, s = np.cos(0.01), np.sin(0.01)
    M = np.array([[c, -s, 64 - c * 64 + s * 48 + 3.0], [s, c, 48 - s * 64 - c * 48 - 5.0]], np.float32)
    np.testing.assert_allclose(I1, np.asarray(jimg.warp_affine(J(I0), J(M))), rtol=0, atol=1e-4)
    assert gt.shape == (96, 128, 2) and 3.0 < np.abs(gt).max() < 6.5
    # the truth is M^-1 p - p: M maps p + flow(p) back onto p
    y, x = np.mgrid[0:96, 0:128].astype(np.float64)
    qy, qx = y + gt[..., 0], x + gt[..., 1]
    np.testing.assert_allclose(M[0, 0] * qx + M[0, 1] * qy + M[0, 2], x, rtol=0, atol=1e-4)
    np.testing.assert_allclose(M[1, 0] * qx + M[1, 1] * qy + M[1, 2], y, rtol=0, atol=1e-4)


@pytest.mark.parametrize("method,gate", [("dis", 0.3), ("tvl1", 0.3)])
def test_flow_pair_epe_matches_jax(method, gate):
    """The chip's frames (rotation 0.01 rad + shift (3, -5)) at 96x128,
    3 levels: the port's interior EPE passes the gate and stays within 5%
    (or 0.002 px) of the JAX package's on the same frames."""
    I0, I1, gt = entry.flow_pair(96, 128)
    out = N(entry.dense_flow(I0, I1, method, device="cpu", levels=3))
    ref = np.asarray({"dis": jdis, "tvl1": jtvl1}[method].compute(I0, I1, levels=3))
    e_port, e_jax = interior_epe(out, gt), interior_epe(ref, gt)
    assert e_port < gate
    assert abs(e_port - e_jax) <= max(0.05 * e_jax, 2e-3), (e_port, e_jax)


def test_dense_flow_rejects_an_unknown_method(textured):
    with pytest.raises(ValueError, match="method"):
        entry.dense_flow(textured, textured, "farneback", device="cpu")
