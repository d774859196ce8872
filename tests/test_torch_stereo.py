"""Parity of the port's stereo, structured-light and phase-unwrapping
modules (opencv_contrib_tpu_torch.stereo, .structured_light,
.phase_unwrapping) with the JAX package on the CPU. The inputs are the JAX
tests' fixtures (tests/test_bgsegm_stereo.py, test_breadth2.py,
test_breadth5.py, test_imgproc_modules.py) and second seeded inputs, the
same numpy arrays through both packages.

Tolerances:
- census codes, Gray-code patterns and their decoded col / row, shadow
  masks, the left-right check: equal;
- cost volumes within 1e-5 (relative to the largest cost); SGM's
  aggregation of one volume within 1e-6 relative;
- disparity maps (block matching, SGM, quasi-dense) equal on at least
  99.5% of the interior pixels, and every pixel that differs a near-tie of
  its two best costs in a float64 recompute of the volume written here
  (1e-5 relative): the box filters of the two packages round apart by an
  ulp (XLA fuses multiply-adds);
- wrapped phases (PSP, FTP, FAPS) compared through angle(exp(i (a - b))),
  within 1e-4 rad; PSP amplitudes within 1e-5;
- the DCT unwrap: each package within 1e-4 of the phase's range of a
  float64 recompute written here (the port transforms in float64 and
  rounds the result to float32; the twin's float32 products carry more
  rounding, 0.052 rad of spread at 480 x 640), and the two within 2e-4 of
  the range; the ZNCC volume within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu import phase_unwrapping as jpu
from opencv_contrib_tpu import stereo as jst
from opencv_contrib_tpu import structured_light as jsl
from opencv_contrib_tpu.ops import filters as jf
from opencv_contrib_tpu.stereo import quasi_dense as jqd
from opencv_contrib_tpu.structured_light import sinusoidal as jsin
from opencv_contrib_tpu_torch import phase_unwrapping as tpu
from opencv_contrib_tpu_torch import stereo as tst
from opencv_contrib_tpu_torch import structured_light as tsl
from opencv_contrib_tpu_torch.stereo import quasi_dense as tqd
from opencv_contrib_tpu_torch.structured_light import sinusoidal as tsin

torch.set_num_threads(1)

# the JAX functions that run eagerly, jitted once for the module (an eager
# loop of rolls and box filters traces op by op)
J_CENSUS = jax.jit(jst.census_transform, static_argnums=1)
J_SAD = jax.jit(jst.cost_volume_sad, static_argnums=2)
J_CENSUS_VOL = jax.jit(jst.cost_volume_census, static_argnums=2)
J_DECODE = jax.jit(jsl.decode_graycode, static_argnums=(1, 2))
J_FTP = jax.jit(jsin.compute_ftp_phase)
J_FAPS = jax.jit(jsin.compute_faps_phase)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def wrapped_diff(a, b) -> float:
    return float(np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64) - np.asarray(b, np.float64))))).max())


# --- float64 recomputes ---------------------------------------------------------


def _box64(x: np.ndarray, r: int) -> np.ndarray:
    """The (D, H, W) maps' box means over (2r+1)^2 windows with the
    BORDER_REFLECT_101 pad, in float64."""
    p = np.pad(x.astype(np.float64), ((0, 0), (r, r), (r, r)), mode="reflect")
    n = 2 * r + 1
    H, W = x.shape[1:]
    rows = sum(p[:, i:i + H, :] for i in range(n)) / n
    return sum(rows[:, :, j:j + W] for j in range(n)) / n


def _sad64(left, right, D, r=3):
    return _box64(np.stack([np.abs(left - np.roll(right, d, 1)) for d in range(D)]), r)


def _census64(left, right, D, radius=2, agg=2):
    def census(img):
        bits = [(np.roll(img, (dy, dx), (0, 1)) < img) for dy in range(-radius, radius + 1)
                for dx in range(-radius, radius + 1) if dy or dx]
        return sum(b.astype(np.int64) << i for i, b in enumerate(bits))

    cl, cr = census(left), census(right)
    h = np.stack([np.vectorize(lambda v: bin(v).count("1"))(cl ^ np.roll(cr, d, 1)) for d in range(D)])
    return _box64(h, agg)


def _sgm64(vol, P1=1.0, P2=8.0):
    def scan(v):  # v (S, D, L)
        out = [v[0]]
        for s in range(1, len(v)):
            Lp = out[-1]
            m = Lp.min(0)
            up = np.concatenate([Lp[1:], np.full((1, Lp.shape[1]), np.inf)])
            dn = np.concatenate([np.full((1, Lp.shape[1]), np.inf), Lp[:-1]])
            out.append(v[s] + np.minimum(np.minimum(Lp, np.minimum(up, dn) + P1), m + P2) - m)
        return np.stack(out)

    h = np.moveaxis(vol, 2, 0)  # (W, D, H)
    w = np.moveaxis(vol, 1, 0)  # (H, D, W)
    return (np.moveaxis(scan(h), 0, 2) + np.moveaxis(scan(h[::-1])[::-1], 0, 2)
            + np.moveaxis(scan(w), 0, 1) + np.moveaxis(scan(w[::-1])[::-1], 0, 1))


def _assert_disparities(dj, dt, vol64, interior, share=0.995, rel=1e-5):
    """Equal on >= share of the interior; each differing pixel a near-tie
    of its two best costs in the float64 volume."""
    dj, dt = np.rint(np.asarray(dj)).astype(int), np.rint(np.asarray(dt)).astype(int)
    same = (dj == dt)[interior]
    assert same.mean() >= share, same.mean()
    ys, xs = np.nonzero(interior & (dj != dt))
    for y, x in zip(ys, xs):
        c = vol64[:, y, x]
        a, b = c[dj[y, x]], c[dt[y, x]]
        assert abs(a - b) <= rel * max(abs(c.min()), 1.0), (y, x, a, b)


def _stereo_pair(rng, disp_gt: int = 6, shape=(64, 96)):
    """tests/test_bgsegm_stereo.py::_stereo_pair."""
    tex = rng.uniform(0, 1, size=shape).astype(np.float32)
    left = np.asarray(jf.gaussian_blur(jnp.asarray(tex), 1.0))
    return left, np.roll(left, -disp_gt, axis=1)


def _interior(shape, m_y=8, m_x=16):
    a = np.zeros(shape, bool)
    a[m_y:-m_y, m_x:-m_x] = True
    return a


# --- phase unwrapping ------------------------------------------------------------


def _unwrap64(psi: np.ndarray) -> np.ndarray:
    psi = psi.astype(np.float64)
    H, W = psi.shape

    def wrap(p):
        return np.mod(p + np.pi, 2 * np.pi) - np.pi

    dy = wrap(np.diff(psi, axis=0, append=psi[-1:]))
    dx = wrap(np.diff(psi, axis=1, append=psi[:, -1:]))
    rho = np.concatenate([dy[:1], dy[1:] - dy[:-1]], 0) + np.concatenate([dx[:, :1], dx[:, 1:] - dx[:, :-1]], 1)

    def M(n):
        k, i = np.arange(n)[:, None], np.arange(n)[None, :]
        m = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * i + 1) * k / (2 * n))
        m[0] /= np.sqrt(2.0)
        return m

    D = M(H) @ rho @ M(W).T
    den = 2 * (np.cos(np.pi * np.arange(H)[:, None] / H) + np.cos(np.pi * np.arange(W)[None, :] / W) - 2)
    P = D / np.where(np.abs(den) < 1e-9, 1.0, den)
    P[0, 0] = 0.0
    return M(H).T @ P @ M(W)


def _ramp(H=64, W=64):
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    return 0.3 * x + 0.15 * y


def test_wrap_equal():
    phi = np.concatenate([_ramp().ravel(), np.float32([0.5, -1.2, 3.0, np.pi, -np.pi, 7 * np.pi])])
    np.testing.assert_array_equal(N(tpu.wrap(T(phi))), np.asarray(jpu.wrap(jnp.asarray(phi))))


@pytest.mark.parametrize("case", ["ramp", "smooth"])
def test_unwrap_phase_dct_against_float64(case, rng):
    if case == "ramp":
        phi = _ramp()
    else:  # a smooth random surface over 96 x 128
        coarse = rng.normal(0, 6.0, (6, 8))
        phi = np.kron(coarse, np.ones((16, 16))).astype(np.float32)
        phi = np.asarray(jf.gaussian_blur(jnp.asarray(phi), 6.0))
    wrapped = np.asarray(jpu.wrap(jnp.asarray(phi)))
    ref = _unwrap64(wrapped)
    rng_ = np.ptp(ref)
    uj = np.asarray(jpu.unwrap_phase_dct(jnp.asarray(wrapped)))
    ut = N(tpu.unwrap_phase_dct(T(wrapped)))
    assert ut.dtype == np.float32
    for u in (uj, ut):
        assert np.abs(u - ref).max() <= 1e-4 * rng_, np.abs(u - ref).max() / rng_
    assert np.abs(uj - ut).max() <= 2e-4 * rng_
    # and the gate of tests/test_imgproc_modules.py::TestPhaseUnwrapping
    if case == "ramp":
        assert (ut - phi).std() < 0.05


# --- Gray code -------------------------------------------------------------------


@pytest.mark.parametrize("W,H", [(64, 32), (32, 16), (100, 37)])
def test_graycode_patterns(W, H):
    pj, cj, rj = jsl.generate_graycode_patterns(W, H)
    pt, ct, rt = tsl.generate_graycode_patterns(W, H)
    assert (ct, rt) == (cj, rj)
    np.testing.assert_array_equal(N(pt), np.asarray(pj))


@pytest.mark.parametrize("fixture", ["direct", "gain_offset", "noisy"])
def test_decode_graycode(fixture, rng):
    W, H = (64, 32) if fixture == "direct" else (32, 16) if fixture == "gain_offset" else (80, 48)
    pats, ncb, nrb = jsl.generate_graycode_patterns(W, H)
    cap = np.asarray(pats)
    if fixture != "direct":
        gain = rng.uniform(0.4, 0.8, size=(H, W)).astype(np.float32)
        offs = rng.uniform(0.0, 0.2, size=(H, W)).astype(np.float32)
        cap = cap * gain[None] + offs[None]
    if fixture == "noisy":  # bits that flip and pixels that fail the white - black gate
        cap = (cap + rng.normal(0, 0.25, cap.shape)).astype(np.float32)
    outj = J_DECODE(jnp.asarray(cap), ncb, nrb)
    outt = tsl.decode_graycode(T(cap), ncb, nrb)
    for a, b in zip(outj, outt):
        np.testing.assert_array_equal(N(b), np.asarray(a))
    assert N(outt[0]).dtype == np.int32 and N(outt[1]).dtype == np.int32
    if fixture != "noisy":
        np.testing.assert_array_equal(N(outt[0]), np.broadcast_to(np.arange(W)[None], (H, W)))


# --- sinusoidal patterns ---------------------------------------------------------


def test_psp():
    pj = jsl.generate_psp_patterns(64, 8, n_periods=4, n_shifts=4)
    pt = tsl.generate_psp_patterns(64, 8, n_periods=4, n_shifts=4)
    np.testing.assert_allclose(N(pt), np.asarray(pj), atol=1e-6)
    (phj, aj), (pht, at) = jsl.compute_psp_phase(pj), tsl.compute_psp_phase(T(np.asarray(pj)))
    assert wrapped_diff(N(pht), phj) <= 1e-4
    np.testing.assert_allclose(N(at), np.asarray(aj), atol=1e-5)


def _fringe_scene():
    """tests/test_breadth2.py::TestSinusoidalFtpFaps._scene."""
    H, W = 128, 160
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    obj = 1.2 * np.exp(-(((yy - 64) / 30.0) ** 2 + ((xx - 80) / 40.0) ** 2))
    true = 2 * np.pi * 12 * xx / W + obj
    return np.stack([0.5 + 0.45 * np.cos(true + 2 * np.pi * k / 3) for k in range(3)]).astype(np.float32), true


def test_shadow_mask_ftp_faps():
    cap, true = _fringe_scene()
    dark = cap.copy()
    dark[:, :20] = 0.0
    for c in (cap, dark):
        np.testing.assert_array_equal(N(tsin.compute_shadow_mask(T(c))), np.asarray(jsin.compute_shadow_mask(c)))
    mj, mt = jsin.compute_shadow_mask(jnp.asarray(cap)), tsin.compute_shadow_mask(T(cap))
    assert wrapped_diff(N(tsin.compute_ftp_phase(T(cap[0]), mt)), J_FTP(jnp.asarray(cap[0]), mj)) <= 1e-4
    assert wrapped_diff(N(tsin.compute_ftp_phase(T(cap[1]))), J_FTP(jnp.asarray(cap[1]))) <= 1e-4
    fj = np.asarray(J_FAPS(jnp.asarray(cap)))
    ft = N(tsin.compute_faps_phase(T(cap)))
    assert wrapped_diff(ft, fj) <= 1e-4
    # the JAX test's gate
    d = np.angle(np.exp(1j * (ft + true)))[12:-12, 12:-12]
    assert np.abs(np.angle(np.exp(1j * (d - np.median(d))))).mean() < 0.05


# --- stereo ----------------------------------------------------------------------


def test_census_transform(rng):
    for img in (rng.uniform(size=(32, 32)).astype(np.float32), _stereo_pair(rng)[0]):
        for radius in (1, 2):
            np.testing.assert_array_equal(N(tst.census_transform(T(img), radius)),
                                          np.asarray(J_CENSUS(jnp.asarray(img), radius)))


def test_cost_volumes(rng):
    left, right = _stereo_pair(rng)
    for fj, ft in ((J_SAD, tst.cost_volume_sad), (J_CENSUS_VOL, tst.cost_volume_census)):
        vj = np.asarray(fj(jnp.asarray(left), jnp.asarray(right), 16))
        vt = N(ft(T(left), T(right), 16))
        assert vt.shape == vj.shape == (16,) + left.shape
        np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-5 * np.abs(vj).max())


@pytest.mark.parametrize("fixture", ["constant", "textureless_band"])
def test_block_match(fixture, rng):
    left, right = _stereo_pair(rng, disp_gt=6 if fixture == "constant" else 5)
    if fixture == "textureless_band":
        left = left.copy()
        left[20:28] = 0.5
        right = np.roll(left, -5, axis=1)
    dj, vj = jst.block_match(jnp.asarray(left), jnp.asarray(right), max_disp=16)
    dt, vt = tst.block_match(T(left), T(right), max_disp=16)
    inner = _interior(left.shape)
    _assert_disparities(np.floor(np.asarray(dj) + 0.5), np.floor(N(dt) + 0.5), _sad64(left, right, 16), inner)
    same = np.asarray(vj) == N(vt)
    assert same[inner].mean() >= 0.995
    both = inner & (np.rint(np.asarray(dj)) == np.rint(N(dt)))
    np.testing.assert_allclose(N(dt)[both], np.asarray(dj)[both], atol=1e-4)


@pytest.mark.parametrize("fixture", ["constant", "textureless_band"])
def test_sgm_match(fixture, rng):
    if fixture == "constant":
        left, right = _stereo_pair(rng, disp_gt=4)
        D = 12
    else:
        left, _ = _stereo_pair(rng, disp_gt=5)
        left = left.copy()
        left[20:28] = 0.5
        right, D = np.roll(left, -5, axis=1), 16
    dj, vj = jst.sgm_match(jnp.asarray(left), jnp.asarray(right), max_disp=D)
    dt, vt = tst.sgm_match(T(left), T(right), max_disp=D)
    agg64 = _sgm64(_census64(left, right, D))
    _assert_disparities(dj, dt, agg64, _interior(left.shape))
    assert (np.asarray(vj) == N(vt))[_interior(left.shape)].mean() >= 0.995


def test_sgm_aggregate_of_one_volume(rng):
    left, right = _stereo_pair(rng, disp_gt=4)
    vol = np.asarray(J_CENSUS_VOL(jnp.asarray(left), jnp.asarray(right), 12))
    np.testing.assert_allclose(N(tst.sgm_aggregate(T(vol))), np.asarray(jst.sgm_aggregate(jnp.asarray(vol))),
                               rtol=1e-6, atol=1e-6)


def test_lr_consistency(rng):
    left, right = _stereo_pair(rng, disp_gt=5)
    dl, _ = tst.block_match(T(left), T(right), max_disp=16)
    dr, _ = tst.block_match(torch.flip(T(right), (1,)), torch.flip(T(left), (1,)), max_disp=16)
    dr = torch.flip(dr, (1,))
    for a, b in ((dl, dl), (dl, dr), (dr, dl)):
        np.testing.assert_array_equal(N(tst.lr_consistency(a, b)),
                                      np.asarray(jst.lr_consistency(jnp.asarray(N(a)), jnp.asarray(N(b)))))
    assert bool(N(tst.lr_consistency(dl, dl)).all())


def _qds_pair(rng):
    """tests/test_breadth5.py::TestQuasiDense's pair."""
    H, W, d = 48, 96, 6
    tex = rng.uniform(0, 1, (H, W + d)).astype(np.float32)
    return tex[:, :W], tex[:, d:]


def test_zncc_volume_and_grow(rng):
    left, right = _qds_pair(rng)
    zj = np.asarray(jqd.zncc_volume(jnp.asarray(left), jnp.asarray(right), 16))
    zt = N(tqd.zncc_volume(T(left), T(right), 16))
    np.testing.assert_allclose(zt, zj, atol=1e-5)
    # growth from the same seeds over the same volume: equal
    seeds = np.zeros(left.shape, bool)
    seeds[::8, ::8] = True
    sd = np.where(seeds, 6, 0).astype(np.int32)
    gj = jqd.grow(jnp.asarray(zj), jnp.asarray(sd), jnp.asarray(seeds), n_sweeps=12)
    gt = tqd.grow(T(zj), T(sd), T(seeds), n_sweeps=12)
    for a, b in zip(gj, gt):
        np.testing.assert_array_equal(N(b), np.asarray(a))


def test_quasi_dense_stereo(rng):
    left, right = _qds_pair(rng)
    dj, vj = jqd.quasi_dense_stereo(left, right, max_disp=16, seed_stride=8, n_sweeps=32)
    dt, vt = tqd.quasi_dense_stereo(left, right, max_disp=16, seed_stride=8, n_sweeps=32)
    assert N(dt).dtype == np.int32
    inner = np.zeros(left.shape, bool)
    inner[4:-4, 12:-4] = True
    assert (np.asarray(vj) == N(vt))[inner].mean() >= 0.995
    assert (np.asarray(dj) == N(dt))[inner].mean() >= 0.995
    # the JAX test's gates
    v, d = N(vt), N(dt)
    assert (v & inner).sum() / inner.sum() > 0.8
    assert (np.abs(d[v & inner] - 6) <= 1.0).mean() > 0.9
