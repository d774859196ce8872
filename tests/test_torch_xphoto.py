"""The port's xphoto/, the trained BRISQUE head (quality/brisque_svr.py) and
`entry.video_photometric` against the JAX package, on the CPU.

Tolerances, each stated where it is used:
- dct_denoise, bm3d_denoise, bm3d_denoise_step2 and bm3d: atol 1e-5 on
  values in [0, 1] (matrix products in other orders; a group or a kept
  coefficient decided by a distance or a coefficient within an ulp of its
  rival would show as more, and does not here);
- inpaint_diffusion: equal (the same sums in the same order);
- oil_painting: atol 1e-6 where the JAX package's two fullest bins differ
  by more than 1e-5; at a tie the two packages' box filters (XLA fuses the
  taps into FMAs) may pick different bins, and the port's value is then one
  of the tied bins' means;
- wb_features atol 1e-6, learning_wb atol 1e-5, fit_wb_model rtol 1e-3 of
  the matrix's scale (a 12 x 8 least-squares solve);
- BRISQUE: features as tests/test_torch_photometric.py holds them (the
  alpha grid one step apart at most, the rest rtol 1e-4), plus 5e-3 of a
  feature's span over the training set: the heavily blurred and quantised
  training images have MSCN variances near 1e-6, whose cancellation moves
  their sigmas by up to 9% (2.5e-7 absolute, 0.16% of a span); scores of
  one model in both packages within 0.5 on a 0-100 scale;
- the video path: the chain of JAX calls on the JAX reader's frames, at
  the photometric test's tolerances (balanced 1e-5, the equalized frames'
  mean abs 1e-4; CLAHE is a step function of its input)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu import intensity_transform as jit
from opencv_contrib_tpu import quality as jq
from opencv_contrib_tpu import xphoto as jxp
from opencv_contrib_tpu.core import color as jcolor
from opencv_contrib_tpu.ops import filters as jfilt
from opencv_contrib_tpu.ops import histogram as jhist
from opencv_contrib_tpu.quality import brisque as jbr
from opencv_contrib_tpu.quality import brisque_svr as jsvr
from opencv_contrib_tpu.utils import video as jvideo
from opencv_contrib_tpu_torch import entry, interop
from opencv_contrib_tpu_torch import xphoto as txp
from opencv_contrib_tpu_torch.core import color as tcolor
from opencv_contrib_tpu_torch.quality import brisque_svr as tsvr

torch.set_num_threads(1)

ALPHA = [0, 2, 6, 10, 14, 18, 20, 24, 28, 32]  # the shape parameters among the 36 BRISQUE features
STEP = 0.01 + 1e-6


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def J(a):
    return jnp.asarray(np.asarray(a, dtype=np.float32))


def _blocks(shape, seed, noise):
    """Piecewise-constant blocks (self-similar, as BM3D wants) and a noisy copy."""
    rng = np.random.default_rng(seed)
    H, W = shape
    clean = np.kron(rng.random((H // 6 + 1, W // 6 + 1)), np.ones((6, 6)))[:H, :W].astype(np.float32)
    noisy = np.clip(clean + rng.normal(0, noise, clean.shape), 0, 1).astype(np.float32)
    return clean, noisy


def _psnr(a, b):
    return 10 * np.log10(1.0 / np.mean((np.asarray(a, np.float64) - b) ** 2))


@pytest.mark.parametrize("shape", [(68, 100), (64, 64), (33, 49)])
@pytest.mark.parametrize("sigma", [0.05, 0.1])
def test_dct_denoise(shape, sigma):
    clean, noisy = _blocks(shape, 1, sigma)
    out = N(txp.dct_denoise(T(noisy), sigma))
    np.testing.assert_allclose(out, np.asarray(jxp.dct_denoise(J(noisy), sigma)), rtol=0, atol=1e-5)


def test_dct_denoise_where_the_twin_raises():
    """At H % 16 >= 8 (1080 % 16 = 8) the JAX function's shifted pass is
    longer than its first pass's output and it raises; the port averages the
    shifted pass into the whole image, and the tiles the JAX function would
    average agree with it on a cut it can take."""
    clean, noisy = _blocks((40, 56), 2, 0.05)
    with pytest.raises(TypeError):
        jxp.dct_denoise(J(noisy), 0.05)
    out = N(txp.dct_denoise(T(noisy), 0.05))
    assert out.shape == noisy.shape and np.isfinite(out).all()
    assert _psnr(out, clean) > _psnr(noisy, clean)
    cut = N(txp.dct_denoise(T(noisy[:36, :52]), 0.05))  # 36 % 16 = 4: the twin runs
    np.testing.assert_allclose(cut, np.asarray(jxp.dct_denoise(J(noisy[:36, :52]), 0.05)), rtol=0, atol=1e-5)


def test_dct_denoise_reduces_noise(rng):
    """tests/test_imgproc_modules.py::test_dct_denoise_reduces_noise."""
    clean = np.asarray(jfilt.gaussian_blur(J(rng.uniform(size=(64, 64))), 3.0))
    noisy = clean + rng.normal(scale=0.05, size=clean.shape).astype(np.float32)
    out = N(txp.dct_denoise(T(noisy), sigma=0.05))
    assert np.abs(out - clean).mean() < np.abs(noisy - clean).mean()


@pytest.mark.parametrize("channels", [1, 3])
def test_inpaint_diffusion(channels):
    rng = np.random.default_rng(3)
    img = rng.random((30, 41, channels) if channels > 1 else (30, 41)).astype(np.float32)
    mask = rng.random((30, 41)) < 0.25
    mask[10:18, 12:20] = True
    out = N(txp.inpaint_diffusion(T(img), torch.from_numpy(mask), iters=200))
    np.testing.assert_array_equal(out, np.asarray(jxp.inpaint_diffusion(J(img), jnp.asarray(mask), iters=200)))
    flat = np.full((32, 32), 0.7, np.float32)  # tests/test_imgproc_modules.py::test_inpaint_fills_hole
    hole = np.zeros((32, 32), bool)
    hole[12:20, 12:20] = True
    filled = N(txp.inpaint_diffusion(T(np.where(hole, 0.0, flat)), torch.from_numpy(hole)))
    assert np.abs(filled[hole] - 0.7).max() < 0.05


@pytest.mark.parametrize("radius,bins", [(3, 16), (2, 8)])
def test_oil_painting(radius, bins):
    rng = np.random.default_rng(4)
    img = np.clip(np.kron(rng.random((9, 12)), np.ones((5, 5))) + rng.normal(0, 0.05, (45, 60)), 0, 1)
    img = img.astype(np.float32)
    out = N(txp.oil_painting(T(img), radius, bins))
    ref = np.asarray(jxp.oil_painting(J(img), radius, bins))
    q = np.clip((img * bins).astype(np.int32), 0, bins - 1)
    votes = np.stack([np.asarray(jfilt.box_filter(J(q == b), radius)) for b in range(bins)], -1)
    top2 = np.sort(votes, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-5
    np.testing.assert_allclose(out[clear], ref[clear], rtol=0, atol=1e-6)
    sums = np.stack([np.asarray(jfilt.box_filter(J(np.where(q == b, img, 0.0)), radius)) for b in range(bins)], -1)
    means = sums / np.maximum(votes, 1e-9)
    tied = ~clear
    cand = np.abs(votes - top2[..., 1:]) <= 1e-5  # every bin within the tie
    ok = (np.abs(means - out[..., None]) <= 1e-5) & cand
    assert ok.any(-1)[tied].all()
    assert clear.mean() > 0.9


def _wb_set(rng, n):
    base = rng.uniform(0.1, 0.9, (n, 24, 24, 3)).astype(np.float32)
    ills = rng.uniform(0.7, 1.3, (n, 3)).astype(np.float32)
    return [np.clip(base[i] * ills[i] / ills[i].max(), 0, 1) for i in range(n)], ills


def test_learning_wb_both_packages():
    """fit_wb_model in both packages; each package's model in the other's
    learning_wb through interop.wb_model; tests/test_breadth5.py's gate."""
    rng = np.random.default_rng(0)
    imgs, ills = _wb_set(rng, 12)
    for im in imgs[:3]:
        np.testing.assert_allclose(N(txp.wb_features(T(im))), np.asarray(jxp.wb_features(im)), rtol=0, atol=1e-6)
    Wt, Wj = txp.fit_wb_model(imgs, ills), jxp.fit_wb_model(imgs, ills)
    assert Wt.shape == (8, 2) and Wt.dtype == torch.float32
    np.testing.assert_allclose(N(Wt), np.asarray(Wj), rtol=0, atol=1e-3 * np.abs(np.asarray(Wj)).max())
    test_ill = np.array([1.4, 1.0, 0.7], np.float32)
    casted = np.clip(rng.uniform(0.1, 0.9, (32, 32, 3)).astype(np.float32) * test_ill / test_ill.max(), 0, 1)
    cj, ej = jxp.learning_wb(J(casted), Wj)
    ct, et = txp.learning_wb(T(casted), interop.wb_model(Wj))
    np.testing.assert_allclose(N(ct), np.asarray(cj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(N(et), np.asarray(ej), rtol=0, atol=1e-5)
    cj2, _ = jxp.learning_wb(J(casted), jnp.asarray(N(Wt)))
    ct2, et2 = txp.learning_wb(T(casted), Wt)
    np.testing.assert_allclose(N(ct2), np.asarray(cj2), rtol=0, atol=1e-5)
    assert np.abs(N(et2)[:2] - test_ill[:2] / test_ill.sum()).max() < 0.08
    assert np.ptp(N(ct2).mean((0, 1))) < np.ptp(casted.mean((0, 1)))
    with pytest.raises(ValueError, match="F, 2"):
        interop.wb_model(np.zeros((8, 3)))


@pytest.mark.parametrize("shape,sigma", [((68, 100), 0.08), ((40, 52), 0.05)])
def test_bm3d(shape, sigma):
    clean, noisy = _blocks(shape, 5, sigma)
    basic_t = txp.bm3d_denoise(T(noisy), sigma)
    basic_j = jxp.bm3d_denoise(J(noisy), sigma)
    np.testing.assert_allclose(N(basic_t), np.asarray(basic_j), rtol=0, atol=1e-5)
    step2 = txp.bm3d_denoise_step2(T(noisy), T(np.asarray(basic_j)), sigma)
    np.testing.assert_allclose(N(step2), np.asarray(jxp.bm3d_denoise_step2(J(noisy), basic_j, sigma)), rtol=0,
                               atol=1e-5)
    full = N(txp.bm3d(T(noisy), sigma))
    np.testing.assert_allclose(full, np.asarray(jxp.bm3d(J(noisy), sigma)), rtol=0, atol=1e-5)
    assert _psnr(full, clean) > _psnr(noisy, clean) + 1.0


def test_bm3d_gates(rng):
    """tests/test_breadth5.py::TestBm3d's two gates."""
    clean = np.zeros((64, 64), np.float32)
    clean[16:48, :] = 0.6
    clean[:, 32:] += 0.3
    noisy = clean + rng.normal(0, 0.08, clean.shape).astype(np.float32)
    out = N(txp.bm3d_denoise(T(noisy), sigma=0.08))
    assert np.abs(out - clean).mean() < 0.5 * np.abs(noisy - clean).mean()
    edge = np.zeros((64, 64), np.float32)
    edge[:, 32:] = 1.0
    out = N(txp.bm3d_denoise(T(edge + rng.normal(0, 0.05, edge.shape).astype(np.float32)), sigma=0.05))
    assert out[:, 34].mean() - out[:, 29].mean() > 0.8


def test_bm3d_aggregation_is_a_fixed_order_sum():
    """The gather-based aggregation equals a float64 scatter-add to float32
    rounding, and a rerun gives the same bits."""
    rng = np.random.default_rng(6)
    Ry, Rx, G, P, stride = 5, 7, 4, 8, 4
    iy = torch.from_numpy(rng.integers(0, Ry, (Ry, Rx, G)))
    ix = torch.from_numpy(rng.integers(0, Rx, (Ry, Rx, G)))
    spat = T(rng.normal(size=(Ry, Rx, G, P, P)))
    wgt = T(rng.uniform(0.1, 1.0, (Ry, Rx)))
    shape = ((Ry - 1) * stride + P, (Rx - 1) * stride + P)
    tb = importlib.import_module("opencv_contrib_tpu_torch.xphoto.bm3d")  # the package exports a function bm3d
    num, den = tb._aggregate(spat, wgt, iy, ix, shape, P, stride)
    num2, den2 = tb._aggregate(spat, wgt, iy, ix, shape, P, stride)
    assert torch.equal(num, num2) and torch.equal(den, den2)
    ref_n, ref_d = np.zeros(shape), np.zeros(shape)
    s, w, y0, x0 = N(spat).astype(np.float64), N(wgt).astype(np.float64), N(iy) * stride, N(ix) * stride
    for r in np.ndindex(Ry, Rx):
        for g in range(G):
            ref_n[y0[r][g]:y0[r][g] + P, x0[r][g]:x0[r][g] + P] += s[r][g] * w[r]
            ref_d[y0[r][g]:y0[r][g] + P, x0[r][g]:x0[r][g] + P] += w[r]
    np.testing.assert_allclose(N(num), ref_n, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(N(den), ref_d, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def models():
    """The head trained by each package on the same synthetic images (3
    textures x 3 distortions x 5 severities)."""
    return tsvr.train_brisque_model(n_images=3, seed=0, device="cpu"), jsvr.train_brisque_model(n_images=3, seed=0)


def _assert_features_agree(ft, fj, model, alpha_tol=STEP):
    """BRISQUE features (..., 36) of the port and of the JAX package at the
    tolerances above: the alphas within alpha_tol, the rest within rtol 1e-4
    plus 5e-3 of the feature's span over `model`'s training set."""
    ft, fj = np.atleast_2d(ft), np.atleast_2d(fj)
    assert np.abs(ft[:, ALPHA] - fj[:, ALPHA]).max() <= alpha_tol
    # an AGGD mean (the entry after its alpha) scales with Gamma ratios of the alpha: held where the alphas agree
    same = np.ones_like(ft, bool)
    for a in ALPHA[1:5] + ALPHA[6:]:
        same[:, a + 1] = ft[:, a] == fj[:, a]
    rest = np.setdiff1d(np.arange(36), ALPHA)
    span = (model.feat_hi - model.feat_lo)[rest]
    d, ref = np.abs(ft - fj)[:, rest], np.abs(fj)[:, rest]
    assert (d <= 1e-4 * ref + 5e-3 * span)[same[:, rest]].all(), (d, ref)


def test_brisque_fixtures_are_the_twins():
    """The host generators draw and compute as the JAX package's do."""
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    ta, tb = tsvr.natural_texture(a), jsvr.natural_texture(b)
    np.testing.assert_array_equal(ta, tb)
    for kind in ("blur", "noise", "jpeg"):
        for sev in range(5):
            np.testing.assert_array_equal(tsvr.distort(ta, kind, sev, a), jsvr.distort(tb, kind, sev, b))


def test_brisque_models_agree(models, tmp_path):
    """The two heads: features per training image within the tolerances
    above, the same bandwidth to 1e-4; each package scores held-out images
    with the other's model (through the npz) as with its own."""
    mt, mj = models
    Xt = (mt.X + 1) / 2 * (mt.feat_hi - mt.feat_lo) + mt.feat_lo  # back to raw features
    Xj = (mj.X + 1) / 2 * (mj.feat_hi - mj.feat_lo) + mj.feat_lo
    _assert_features_agree(Xt, Xj, mj, alpha_tol=STEP + 1e-5)
    np.testing.assert_allclose(mt.gamma, mj.gamma, rtol=1e-4)
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jsvr.save_model(mj, pj)
    tsvr.save_model(mt, pt)
    mj_in_t, mt_in_j = tsvr.load_model(pj), jsvr.load_model(pt)
    rng = np.random.default_rng(11)
    for _ in range(3):
        img = tsvr.distort(tsvr.natural_texture(rng), "noise", 2, rng)
        s_t = tsvr.brisque_score(mj_in_t, img, device="cpu")
        s_j = jsvr.brisque_score(mj, img)
        assert abs(s_t - s_j) < 0.5, (s_t, s_j)
        assert abs(jsvr.brisque_score(mt_in_j, img) - tsvr.brisque_score(mt, img, device="cpu")) < 0.5
        assert abs(tsvr.brisque_score(mt, T(img)) - tsvr.brisque_score(mt, img, device="cpu")) == 0.0


@pytest.fixture(scope="module")
def model10():
    return tsvr.train_brisque_model(n_images=10, seed=0, device="cpu")


@pytest.mark.parametrize("kind", ["blur", "noise", "jpeg"])
def test_brisque_monotone_in_severity_held_out(model10, kind):
    """tests/test_brisque_svr.py's gate, on the port's head."""
    rng = np.random.default_rng(123)
    scores = np.mean([[tsvr.brisque_score(model10, tsvr.distort(base, kind, s, rng), device="cpu")
                       for s in range(5)] for base in [tsvr.natural_texture(rng) for _ in range(4)]], axis=0)
    assert np.all(np.diff(scores) > 0), (kind, scores)


def test_brisque_pristine_low_and_round_trip(model10, tmp_path):
    rng = np.random.default_rng(99)
    pristine = [tsvr.brisque_score(model10, tsvr.natural_texture(rng), device="cpu") for _ in range(3)]
    worst = [tsvr.brisque_score(model10, tsvr.distort(tsvr.natural_texture(rng), "blur", 4, rng), device="cpu")
             for _ in range(3)]
    assert np.mean(pristine) < 30 and np.mean(worst) > 60
    p = str(tmp_path / "b.npz")
    tsvr.save_model(model10, p)
    img = tsvr.distort(tsvr.natural_texture(rng), "noise", 2, rng)
    assert tsvr.brisque_score(tsvr.load_model(p), img, device="cpu") == tsvr.brisque_score(model10, img,
                                                                                            device="cpu")
    e_hi = np.abs(tsvr.jpeg_blockiness(img, 90) - img).mean()
    e_lo = np.abs(tsvr.jpeg_blockiness(img, 5) - img).mean()
    assert e_lo > 3 * e_hi > 0


@pytest.mark.parametrize("codec", ["y4m", "MJPG"])
def test_video_photometric_matches_the_jax_chain(tmp_path, models, codec):
    """entry.video_photometric on the CPU against the same chain of JAX calls
    on the JAX reader's frames of the same file (3 x 64 x 96), scored by the
    JAX package's head in both."""
    path, clean = entry.video_clip(str(tmp_path), codec, T=3, H=64, W=96, seed=1)
    mj = models[1]
    res = entry.video_photometric(path, clean, model=tsvr.load_model(_saved(mj, tmp_path)), device="cpu")
    assert res.balanced.shape == (3, 64, 96, 3) and res.features.shape == (3, 36) and len(res.brisque) == 3
    assert res.decode_ms > 0
    frames = np.concatenate([np.asarray(b) for b in jvideo.VideoReader(path, batch=8, to_device=False)], 0)
    lin = jit.gamma_correction(J(frames), 1 / 2.2)
    for t in range(3):
        wb = jxp.grayworld_wb(lin[t])
        g = jxp.dct_denoise(jcolor.rgb_to_gray(wb), sigma=entry.VIDEO_DENOISE_SIGMA)
        out = jhist.clahe(g, clip_limit=4.0, grid=8)
        ref = jcolor.rgb_to_gray(J(clean[t]))
        np.testing.assert_allclose(N(res.balanced[t]), np.asarray(wb), rtol=0, atol=1e-5)
        d = np.abs(N(res.equalized[t]) - np.asarray(out))
        assert d.mean() <= 1e-4 and d.max() <= 0.05, (d.mean(), d.max())
        np.testing.assert_allclose(res.psnr[t], jq.psnr(out, ref), rtol=1e-4)
        np.testing.assert_allclose(N(res.ssim[t]), np.asarray(jq.ssim(out, ref)), rtol=1e-4)
        np.testing.assert_allclose(N(res.gmsd[t]), np.asarray(jq.gmsd(out, ref)), rtol=1e-4)
        _assert_features_agree(N(res.features[t]), np.asarray(jbr.brisque_features(out)), mj)
        assert abs(res.brisque[t] - jsvr.brisque_score(mj, np.asarray(g))) < 0.5


def test_video_photometric_score_moves(tmp_path, models):
    """The path's trained score is that of the denoised frame, which lies in
    the head's training range: a degraded frame scores worse than its clean
    twin (at 540 x 960, where the clip's texture is many 96 x 96 training
    images wide)."""
    mt = models[0]
    path, clean = entry.video_clip(str(tmp_path), "y4m", T=1, H=540, W=960, seed=0)
    res = entry.video_photometric(path, clean, model=mt, device="cpu")
    clean_score = tsvr.brisque_score(mt, tcolor.rgb_to_gray(T(clean[0])))
    assert res.brisque[0] > clean_score + 1.0, (res.brisque, clean_score)


def _saved(model, tmp_path):
    p = str(tmp_path / "head.npz")
    jsvr.save_model(model, p)
    return p
