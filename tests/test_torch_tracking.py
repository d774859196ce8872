"""Parity of the port's trackers and filters (opencv_contrib_tpu_torch.
tracking: correlation, csrt, dsst, kalman, medianflow, tld, twist,
matching) with the JAX package on the CPU, on the JAX tests' fixtures
(tests/test_tracking.py, test_tracking_extra.py; the first 8 of a target
sequence's 12 frames, for time), the same numpy arrays through both
packages; each tracker also to its JAX test's gate.

Tolerances:
- MOSSE / KCF: the centres equal frame by frame (the peaks are argmaxes
  of float32 FFT responses that agree to ~1e-6 relative); PSR and peaks
  1e-4 relative; the filters 1e-4 of their largest entry.
- CSRT: centres 1e-2 px (its parabolic sub-pixel step divides by the
  response's curvature, which carries the FFTs' ~1e-6 relative
  differences to ~4e-3 px over 11 frames), peaks 1e-4 relative.
- DSST: the scale each frame equal, the boxes 1e-4 px; the scaled CSRT's
  centres 5e-2 px (CSRT's sub-pixel step over 19 frames of zoom).
- Kalman: KF 1e-5, the AUKF against the KF 1e-2 (the JAX test's); the UKF
  held to its gate and to the twin within 0.1 (see its test: the twin's
  float32 cancels at the Merwe weights, the port computes in float64), its
  sigma points 1e-6 relative.
- MedianFlow: centres and sizes 2e-2 px over the 11 steps (LK's windows
  sum in another order and XLA fuses multiply-adds: ~1e-3 px; the scale is
  the median of 4,950 distance ratios, where a near-tie of two ratios
  moves it by ~4e-4, 8e-3 px on a 20 px box); ok equal.
- TLD: centres 1e-3 px, confidences 1e-4; the fern counts part at a few
  entries where a pixel pair's comparison is a near-tie under XLA's fused
  bilinear samples (at most 4 entries, each by at most 2 counts).
- twist 1e-5; matching: assignments and track tables equal, IoU /
  affinity 1e-6."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu.ops import filters as jf
from opencv_contrib_tpu.tracking import correlation as jc
from opencv_contrib_tpu.tracking import csrt as jcs
from opencv_contrib_tpu.tracking import dsst as jd
from opencv_contrib_tpu.tracking import kalman as jk
from opencv_contrib_tpu.tracking import matching as jmt
from opencv_contrib_tpu.tracking import medianflow as jm
from opencv_contrib_tpu.tracking import tld as jt
from opencv_contrib_tpu.tracking import twist as jtw
from opencv_contrib_tpu_torch.tracking import correlation as tc
from opencv_contrib_tpu_torch.tracking import csrt as tcs
from opencv_contrib_tpu_torch.tracking import dsst as td
from opencv_contrib_tpu_torch.tracking import kalman as tk
from opencv_contrib_tpu_torch.tracking import matching as tmt
from opencv_contrib_tpu_torch.tracking import medianflow as tm
from opencv_contrib_tpu_torch.tracking import tld as tt
from opencv_contrib_tpu_torch.tracking import twist as ttw

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _target_sequence(n=12, shape=(128, 128), start=(40.0, 40.0), vel=(2.0, 3.0), seed=0):
    """tests/test_tracking.py::_target_sequence."""
    rng = np.random.default_rng(seed)
    bg = np.asarray(jf.gaussian_blur(jnp.asarray(rng.uniform(0, 0.3, shape).astype(np.float32)), 2.0))
    tex = np.asarray(jf.gaussian_blur(jnp.asarray(rng.uniform(0.5, 1.0, (21, 21)).astype(np.float32)), 1.0))
    frames, centers = [], []
    for i in range(n):
        cy, cx = start[0] + vel[0] * i, start[1] + vel[1] * i
        f = bg.copy()
        iy, ix = int(round(cy)) - 10, int(round(cx)) - 10
        f[iy:iy + 21, ix:ix + 21] = tex
        frames.append(f)
        centers.append((cy, cx))
    return frames, centers


def _jit_init(fn):
    """A twin's init under jit: eager, its op-by-op dispatch takes seconds."""
    return jax.jit(fn, static_argnames=("target_hw", "size"))


def _close(a, b, rel):
    a, b = N(a), np.asarray(b)
    assert np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1e-30), (np.abs(a - b).max(), np.abs(b).max())


# --- correlation -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mosse", "kcf"])
def test_correlation_trackers(kind):
    frames, centers = _target_sequence(n=8) if kind == "mosse" else _target_sequence(
        n=8, vel=(1.5, -2.0), start=(70.0, 80.0), seed=5)
    ji, ju = (jc.mosse_init, jc.mosse_update) if kind == "mosse" else (jc.kcf_init, jc.kcf_update)
    ti, tu = (tc.mosse_init, tc.mosse_update) if kind == "mosse" else (tc.kcf_init, tc.kcf_update)
    sj = jax.jit(ji, static_argnames="size")(jnp.asarray(frames[0]), jnp.asarray(centers[0]), size=(64, 64))
    st = ti(T(frames[0]), centers[0], size=(64, 64))
    for i in range(1, len(frames)):
        sj, vj = ju(sj, jnp.asarray(frames[i]))
        st, vt = tu(st, T(frames[i]))
        np.testing.assert_array_equal(N(st.center), np.asarray(sj.center))
        _close(vt, vj, 1e-4)
        assert np.linalg.norm(N(st.center) - centers[i]) < 2.5  # the JAX test's gate
    _close(st[1], sj[1], 1e-4)  # A (MOSSE) or alpha_f (KCF)
    _close(st[2], sj[2], 1e-4)
    if kind == "mosse":  # PSR drops on a blank frame
        _, bad_j = jc.mosse_update(sj, jnp.zeros_like(jnp.asarray(frames[0])))
        _, bad_t = tc.mosse_update(st, torch.zeros(frames[0].shape))
        _close(bad_t, bad_j, 1e-4)
        assert float(bad_t) < float(vt) and float(vt) > 5.0


def test_gaussian_response_and_window():
    for shape in ((64, 64), (48, 40)):
        _close(tc._gaussian_response(shape), jc._gaussian_response(shape), 1e-6)
        _close(tc._gaussian_response(shape, 1 / 16), jc._gaussian_response(shape, 1 / 16), 1e-6)
        _close(tc._window(shape), jc._window(shape), 1e-6)


# --- CSRT, DSST ----------------------------------------------------------------------


def test_csrt_features_mask_and_track():
    frames, centers = _target_sequence(n=8, vel=(2.0, 2.5), seed=3)
    patch = np.asarray(frames[0])[8:72, 8:72]
    _close(tcs._features(T(patch)), jcs._features(jnp.asarray(patch)), 1e-5)
    m = tcs._spatial_reliability(T(patch), (21, 21), (64, 64))
    _close(m, jcs._spatial_reliability(jnp.asarray(patch), (21, 21), (64, 64)), 1e-5)
    assert float(m[0, 0]) == 0.0 and float(m[-1, -1]) == 0.0
    sj = _jit_init(jcs.csrt_init)(jnp.asarray(frames[0]), jnp.asarray(centers[0]), target_hw=(21, 21))
    st = tcs.csrt_init(T(frames[0]), centers[0], target_hw=(21, 21))
    _close(st.h_f, sj.h_f, 1e-4)
    for i in range(1, len(frames)):
        sj, pj = jcs.csrt_update(sj, jnp.asarray(frames[i]))
        st, pt = tcs.csrt_update(st, T(frames[i]))
        np.testing.assert_allclose(N(st.center), np.asarray(sj.center), atol=1e-2)
        _close(pt, pj, 1e-4)
        assert np.linalg.norm(N(st.center) - centers[i]) < 3.0
    _close(st.chan_w, sj.chan_w, 1e-4)


def _zoom_frames(rng, n=20, lo=24, hi=48, H=160, W=160):
    """TestDsstScale._zoom_frames with a linear resize on both sides (the
    same frames through both packages)."""
    from opencv_contrib_tpu_torch import entry

    return entry._zoom_frames(rng, H, W, lo, hi, n)


@pytest.mark.parametrize("kind", ["csrt", "kcf"])
def test_scale_adaptive_trackers(kind, rng):
    frames, sizes = _zoom_frames(rng, lo=24 if kind == "csrt" else 28)
    ji, ju = (jd.csrt_scale_init, jd.csrt_scale_update) if kind == "csrt" else (jd.kcf_scale_init, jd.kcf_scale_update)
    ti, tu = (td.csrt_scale_init, td.csrt_scale_update) if kind == "csrt" else (td.kcf_scale_init, td.kcf_scale_update)
    hw = (int(sizes[0]), int(sizes[0]))
    sj = _jit_init(ji)(jnp.asarray(frames[0]), jnp.array([80.0, 80.0]), target_hw=hw)
    st = ti(T(frames[0]), (80.0, 80.0), target_hw=hw)
    for f in frames[1:]:
        sj, (cj, bj), _ = ju(sj, jnp.asarray(f))
        st, (ct, bt), _ = tu(st, T(f))
        assert float(st.dsst.scale) == float(sj.dsst.scale)
        np.testing.assert_allclose(N(bt), np.asarray(bj), atol=1e-4)
        np.testing.assert_allclose(N(ct), np.asarray(cj), atol=5e-2)
    est, true = float(bt[0]), float(sizes[-1])
    inter = min(est, true) ** 2
    assert inter / (est * est + true * true - inter) > (0.7 if kind == "csrt" else 0.6)


def test_dsst_alone_on_a_constant_size(rng):
    frames, _ = _zoom_frames(rng, lo=32, hi=32, n=12)
    sj = jax.jit(jd.dsst_init)(jnp.asarray(frames[0]), jnp.array([80.0, 80.0]), jnp.array([32.0, 32.0]))
    st = td.dsst_init(T(frames[0]), (80.0, 80.0), (32, 32))
    _close(st.B, sj.B, 1e-4)
    for f in frames[1:]:
        sj, scale_j = jd.dsst_update(sj, jnp.asarray(f), (80.0, 80.0), (32, 32))
        st, scale_t = td.dsst_update(st, T(f), (80.0, 80.0), (32, 32))
        assert float(scale_t) == float(scale_j)
    assert 0.85 < float(scale_t) < 1.18


# --- Kalman -------------------------------------------------------------------------------


def test_kalman_filters(rng):
    F = np.array([[1, 0, 1, 0], [0, 1, 0, 1], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    Hm = np.array([[1, 0, 0, 0], [0, 1, 0, 0]], np.float32)
    Q, R = 1e-4 * np.eye(4, dtype=np.float32), 0.04 * np.eye(2, dtype=np.float32)
    sj, st = jk.KalmanState(jnp.zeros(4), jnp.eye(4)), tk.KalmanState(torch.zeros(4), torch.eye(4))
    sa = tk.KalmanState(torch.zeros(4), torch.eye(4))
    x_true = np.array([0.0, 0.0, 1.0, 0.5])
    for _ in range(30):
        x_true = F @ x_true
        z = (x_true[:2] + rng.normal(scale=0.2, size=2)).astype(np.float32)
        sj = jk.kf_correct(jk.kf_predict(sj, jnp.asarray(F), jnp.asarray(Q)), jnp.asarray(z), jnp.asarray(Hm),
                           jnp.asarray(R))
        st = tk.kf_correct(tk.kf_predict(st, T(F), T(Q)), T(z), T(Hm), T(R))
        sa = tk.aukf_correct(tk.aukf_predict(sa, lambda x, q: T(F) @ x + q, T(Q)), T(z), lambda x, r: T(Hm) @ x + r,
                             T(R))
        np.testing.assert_allclose(N(st.x), np.asarray(sj.x), atol=1e-5)
        np.testing.assert_allclose(N(st.P), np.asarray(sj.P), atol=1e-5)
    np.testing.assert_allclose(N(st.x[2:]), [1.0, 0.5], atol=0.1)
    # the AUKF with linear f, h and additive noise is the KF (test_matches_kf_on_linear_additive)
    np.testing.assert_allclose(N(sa.x), N(st.x), atol=1e-2)
    np.testing.assert_allclose(N(sa.P), N(st.P), atol=1e-2)


def test_unscented_filters(rng):
    """The Merwe sigma points (alpha 1e-3) weigh the centre by about -1e6:
    float32 cancels there to ~0.1-0.5 of a state a step (the twin's run
    against a float64 one); the port's UKF computes in float64. The 60-step
    runs are held to the JAX test's gate (0.15 to the truth) and to each
    other within 0.1, the port's to a float64 run of its own within 1e-5;
    the sigma points and weights within 1e-6 relative."""
    x0, P0 = np.array([1.5, 1.5, 0.1, -0.2], np.float32), (0.5 * np.eye(4) + 0.01).astype(np.float32)
    for alpha in (1e-3, 1.0):
        pj, wmj, wcj = jk._sigma_points(jnp.asarray(x0), jnp.asarray(P0), alpha=alpha)
        pt, wmt, wct = tk._sigma_points(T(x0), T(P0), alpha=alpha)
        _close(pt, pj, 1e-6)
        _close(wmt, wmj, 1e-6)
        _close(wct, wcj, 1e-6)
    dt = 0.1
    Q, R = 1e-5 * np.eye(4, dtype=np.float32), np.diag([0.01, 1e-4]).astype(np.float32)
    sj = jk.KalmanState(jnp.array([1.5, 1.5, 0.0, 0.0]), 0.5 * jnp.eye(4))
    st = tk.KalmanState(torch.tensor([1.5, 1.5, 0.0, 0.0]), 0.5 * torch.eye(4))
    s64 = tk.KalmanState(st.x.double(), st.P.double())
    x_true = np.array([2.0, 1.0, 0.5, -0.2])

    def f64(x):
        return torch.stack([x[0] + dt * x[2], x[1] + dt * x[3], x[2], x[3]])

    def h64(x):
        return torch.stack([torch.sqrt(x[0] ** 2 + x[1] ** 2), torch.atan2(x[1], x[0])])

    def step_j(st, z):  # eager, as the JAX test runs it (under jit XLA's fusions lead this run to NaN)
        st = jk.ukf_predict(st, lambda x: jnp.array([x[0] + dt * x[2], x[1] + dt * x[3], x[2], x[3]]), jnp.asarray(Q))
        return jk.ukf_correct(st, z, lambda x: jnp.array([jnp.sqrt(x[0] ** 2 + x[1] ** 2), jnp.arctan2(x[1], x[0])]),
                              jnp.asarray(R))

    for _ in range(60):
        x_true = np.array([x_true[0] + dt * x_true[2], x_true[1] + dt * x_true[3], x_true[2], x_true[3]])
        z = np.array([np.hypot(x_true[0], x_true[1]) + rng.normal(scale=0.05),
                      np.arctan2(x_true[1], x_true[0]) + rng.normal(scale=0.005)], np.float32)
        sj = step_j(sj, jnp.asarray(z))
        st = tk.ukf_correct(tk.ukf_predict(st, lambda x: torch.stack([x[0] + dt * x[2], x[1] + dt * x[3], x[2], x[3]]),
                                           T(Q)), T(z),
                            lambda x: torch.stack([torch.sqrt(x[0] ** 2 + x[1] ** 2), torch.atan2(x[1], x[0])]), T(R))
        s64 = tk.ukf_correct(tk.ukf_predict(s64, f64, T(Q).double()), T(z).double(), h64, T(R).double())
        np.testing.assert_allclose(N(st.x), N(s64.x), atol=1e-5)
    np.testing.assert_allclose(N(st.x[:2]), x_true[:2], atol=0.15)
    np.testing.assert_allclose(np.asarray(sj.x[:2]), x_true[:2], atol=0.15)
    np.testing.assert_allclose(N(st.x[:2]), np.asarray(sj.x[:2]), atol=0.1)
    assert st.x.dtype == torch.float32 and s64.x.dtype == torch.float64
    # the augmented UKF's multiplicative process noise (test_nonadditive_noise_propagates)
    a_j = jk.aukf_predict(jk.KalmanState(jnp.array([2.0]), jnp.array([[1e-6]])), lambda x, q: x * (1.0 + q[0]),
                          jnp.array([[0.04]]))
    a_t = tk.aukf_predict(tk.KalmanState(torch.tensor([2.0]), torch.tensor([[1e-6]])), lambda x, q: x * (1.0 + q[0]),
                          torch.tensor([[0.04]]))
    np.testing.assert_allclose(N(a_t.P), np.asarray(a_j.P), atol=1e-6)
    assert abs(float(a_t.P[0, 0]) - 0.16) < 0.02


# --- MedianFlow, TLD -----------------------------------------------------------------------


@pytest.mark.parametrize("x,mask,want", [
    ([5.0, 1.0, 9.0, 3.0], [True, True, False, True], 3.0),  # the JAX test's odd count
    ([5.0, 1.0, 9.0, 3.0], [True, True, True, True], 4.0),  # an even count: the two middles' mean
    ([2.0, 8.0], [True, True], 5.0),  # torch.median would give the lower, 2.0
    ([5.0, 1.0], [False, False], 0.0)])
def test_masked_median_averages_the_middles(x, mask, want):
    got = tm._masked_median(torch.tensor(x), torch.tensor(mask))
    assert float(got) == want == float(jm._masked_median(jnp.asarray(x), jnp.asarray(mask)))


def test_medianflow():
    frames, centers = _target_sequence(n=8, vel=(2.0, 3.0), seed=7)
    bj = jm.Box(jnp.asarray(centers[0], jnp.float32), jnp.asarray([20.0, 20.0]))
    bt = tm.Box(torch.tensor(centers[0], dtype=torch.float32), torch.tensor([20.0, 20.0]))
    for i in range(1, len(frames)):
        bj, oj = jm.medianflow_update(bj, jnp.asarray(frames[i - 1]), jnp.asarray(frames[i]))
        bt, ot = tm.medianflow_update(bt, T(frames[i - 1]), T(frames[i]))
        assert bool(ot) == bool(oj) is True
        np.testing.assert_allclose(N(bt.center), np.asarray(bj.center), atol=2e-2)
        np.testing.assert_allclose(N(bt.size), np.asarray(bj.size), atol=2e-2)
        assert np.linalg.norm(N(bt.center) - centers[i]) < 2.5


def test_tld_on_the_jax_fern_bank():
    frames, centers = _target_sequence(n=8, vel=(2.0, 2.0), seed=13)
    key = jax.random.PRNGKey(1)
    bank = jt.fern_bank(key)
    sj = jt.tld_init(jnp.asarray(frames[0]), centers[0], (21.0, 21.0), key)
    st = tt.tld_init(T(frames[0]), centers[0], (21.0, 21.0), bank=T(bank))
    np.testing.assert_array_equal(N(st.counts), np.asarray(sj.counts))
    _close(st.pos_ex, sj.pos_ex, 1e-5)
    for i in range(1, len(frames)):
        sj, cj = jt.tld_update(sj, jnp.asarray(frames[i - 1]), jnp.asarray(frames[i]), bank)
        st, ct = tt.tld_update(st, T(frames[i - 1]), T(frames[i]), T(bank))
        np.testing.assert_allclose(N(st.box.center), np.asarray(sj.box.center), atol=1e-3)
        np.testing.assert_allclose(float(ct), float(cj), atol=1e-4)
        assert int(st.n_pos) == int(sj.n_pos) and int(st.n_neg) == int(sj.n_neg) and bool(st.tracking)
        d = np.abs(N(st.counts) - np.asarray(sj.counts))
        assert (d > 0).sum() <= 4 and d.max() <= 2, np.argwhere(d > 0)
        assert np.linalg.norm(N(st.box.center) - centers[i]) < 4.0
    assert float(ct) > 0.5


def test_tld_helpers_against_jax(rng):
    img = rng.uniform(size=(64, 80)).astype(np.float32)
    c = rng.uniform(10, 50, (7, 2)).astype(np.float32)
    hw = rng.uniform(8, 20, (7, 2)).astype(np.float32)
    _close(tt._extract_norm(T(img), T(c), T(hw)), jt._extract_norm(jnp.asarray(img), jnp.asarray(c), jnp.asarray(hw)),
           1e-5)
    box_j = jm.Box(jnp.array([30.0, 40.0]), jnp.array([21.0, 17.0]))
    cj, sj = jt._scan_grid(box_j, 64, 80)
    ct, st = tt._scan_grid(tm.Box(torch.tensor([30.0, 40.0]), torch.tensor([21.0, 17.0])), 64, 80)
    np.testing.assert_array_equal(N(ct), np.asarray(cj))  # jnp.linspace's formula (tracking.correlation._linspace)
    np.testing.assert_array_equal(N(st), np.asarray(sj))


def test_population_variance_and_std():
    """ddof 0 where the twin's jnp.var / jnp.std take it (torch's default
    is the unbiased estimate): TLD's variance filter, the correlation
    filters' normalization, MIL's and Boosting's class Gaussians."""
    x = np.array([[1.0, 2.0, 4.0, 7.0], [0.5, 0.5, 3.0, -1.0]], np.float32)
    jv = np.asarray(jnp.asarray(x).var(axis=1))
    np.testing.assert_allclose(N(T(x).var(dim=1, correction=0)), jv, rtol=1e-6)
    assert not np.allclose(N(T(x).var(dim=1)), jv)
    from opencv_contrib_tpu_torch.tracking import mil as tmil

    f = np.random.default_rng(1).normal(size=(16, 5)).astype(np.float32)
    mu, sig = tmil._update_gaussians(torch.zeros(5), torch.ones(5), T(f), 0.15)
    m, s = f.mean(0), f.std(0) + 1e-3  # numpy: ddof 0
    np.testing.assert_allclose(N(sig), np.sqrt(0.85 + 0.15 * s ** 2) + 1e-4, rtol=1e-6)
    np.testing.assert_allclose(N(mu), 0.15 * m, rtol=1e-5, atol=1e-7)
    p = np.random.default_rng(2).uniform(size=(20, 24)).astype(np.float32)
    _close(tc._preprocess(T(p)), jc._preprocess(jnp.asarray(p)), 1e-5)


# --- twist, matching ---------------------------------------------------------------------------


def test_twist():
    rng = np.random.default_rng(1)
    K = np.array([[400.0, 0, 100], [0, 400.0, 80], [0, 0, 1]], np.float32)
    uv = rng.uniform(20, 150, size=(20, 2)).astype(np.float32)
    Z = rng.uniform(1, 5, size=20).astype(np.float32)
    xi_true = np.array([0.1, -0.05, 0.2, 0.02, -0.03, 0.05], np.float32)
    Lj = jtw.interaction_matrix(jnp.asarray(uv), jnp.asarray(Z), jnp.asarray(K))
    Lt = ttw.interaction_matrix(T(uv), T(Z), T(K))
    _close(Lt, Lj, 1e-6)
    duv = (np.asarray(Lj) @ xi_true).reshape(-1, 2) * np.array([K[0, 0], K[1, 1]], np.float32)
    xj = jtw.compute_twist(jnp.asarray(uv), jnp.asarray(duv), jnp.asarray(Z), jnp.asarray(K))
    xt = ttw.compute_twist(T(uv), T(duv), T(Z), T(K))
    np.testing.assert_allclose(N(xt), np.asarray(xj), atol=1e-5)
    np.testing.assert_allclose(N(xt), xi_true, atol=1e-5)


def test_kuhn_munkres_and_affinity(rng):
    for shape in [(3, 3), (3, 5), (5, 3), (6, 6)]:
        cost = rng.uniform(0, 10, shape)
        col = tmt.kuhn_munkres(cost)
        np.testing.assert_array_equal(col, jmt.kuhn_munkres(cost))
        n, m = shape
        k = min(n, m)
        total = sum(cost[i, c] for i, c in enumerate(col) if c >= 0)
        if n <= m:
            best = min(sum(cost[i, p[i]] for i in range(n)) for p in itertools.permutations(range(m), n))
        else:
            best = min(sum(cost[p[j], j] for j in range(m)) for p in itertools.permutations(range(n), m))
        assert abs(total - best) < 1e-9 and (col >= 0).sum() == k
    a = rng.uniform(0, 50, (5, 2)).astype(np.float32)
    A = np.concatenate([a, a + rng.uniform(5, 20, (5, 2))], 1).astype(np.float32)
    B = (A[:4] + rng.normal(0, 2, (4, 4))).astype(np.float32)
    fa, fb = rng.normal(size=(5, 8)).astype(np.float32), rng.normal(size=(4, 8)).astype(np.float32)
    np.testing.assert_allclose(N(tmt.iou_matrix(A, B)), np.asarray(jmt.iou_matrix(A, B)), atol=1e-6)
    np.testing.assert_allclose(N(tmt.affinity_matrix(A, B, fa, fb)), np.asarray(jmt.affinity_matrix(A, B, fa, fb)),
                               atol=1e-6)


def test_tracker_by_matching_tables():
    """tests/test_tracking.py::TestTrackerByMatching's sequences, the two
    packages' track tables equal frame by frame."""
    seqs = [np.array([[10, 10, 30, 30], [50, 50, 70, 70]], np.float32)]
    seqs.append(seqs[0] + 2.0)
    seqs.append(np.vstack([seqs[1] + 2.0, [[100, 100, 120, 120]]]).astype(np.float32))
    seqs += [np.zeros((0, 4), np.float32)] * 7
    tj, tt_ = jmt.TrackerByMatching(max_cost=0.8, max_misses=2), tmt.TrackerByMatching(max_cost=0.8, max_misses=2)
    for b in seqs:
        oj, ot = tj.process(b), tt_.process(b)
        assert [i for i, _ in ot] == [i for i, _ in oj]
        for (_, x), (_, y) in zip(ot, oj):
            np.testing.assert_array_equal(x, y)
    assert ot == []
