"""Parity of the port's learned QR stages (`wechat_qrcode.learned`) with the
JAX package on the CPU, each network from the twin's flax parameters
carried across by `interop` (`qr_detector_params`, `superres_params`).

Tolerances: the detector's maps 1e-5 of the twin's largest; its box
exactly (the corners truncate toward zero as the twin's int()) and its
score atol 1e-5; the training scenes, targets and the tests' tiny codes as
the twin draws them (the resize within 1e-6); five training steps of each
stage from the twin's init: the parameters within atol 1e-4; the composed
pipeline's decoded texts exactly. The gates are held on the card
(chip_smoke's phase z)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu.models import dnn_superres as jsr
from opencv_contrib_tpu.wechat_qrcode import learned as jl
from opencv_contrib_tpu.wechat_qrcode import qr as jqr
from opencv_contrib_tpu_torch import entry, interop
from opencv_contrib_tpu_torch.wechat_qrcode import learned as tl

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def qr_pair():
    params = jl.QrDetectorNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 1)))
    net = tl.QrDetectorNet()
    net.load_state_dict(interop.qr_detector_params(params))
    return params, net


def test_qr_detector_forward_and_detect(qr_pair):
    params, net = qr_pair
    rng = np.random.default_rng(6)
    x = rng.uniform(size=(2, 128, 128, 1)).astype(np.float32)
    with torch.no_grad():
        for g, w in zip(net(T(x)), jl.QrDetectorNet().apply(params, x)):
            assert _rel(N(g), np.asarray(w)) <= 1e-5
    for shape in ((150, 170), (192, 192), (96, 301)):
        img = rng.uniform(size=shape).astype(np.float32)
        (bj, sj), (bt, st) = jl.QrDetector(params).detect(img), tl.QrDetector(net).detect(img)
        assert bt == bj and abs(float(st) - float(sj)) <= 1e-5


def test_training_scenes_are_the_twins():
    for seed in (0, 5):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(3):
            (ij, tj), (it, tt) = jl.make_training_scene(a), tl.make_training_scene(b)
            assert tt == tj and np.abs(it - ij).max() <= 1e-6
        np.testing.assert_allclose(tl._background(a, 192), jl._background(b, 192), atol=1e-6)
    img = np.random.default_rng(1).uniform(size=(30, 40)).astype(np.float32)
    np.testing.assert_array_equal(tl._blur(img, 0.9), jl._blur(img, 0.9))


def test_qr_detector_five_training_steps(qr_pair):
    params, _ = qr_pair
    pj = jl.train_detector(n_steps=5, batch=4, seed=0).params
    det = tl.train_detector(n_steps=5, batch=4, seed=0, params=interop.qr_detector_params(params), device="cpu")
    want = interop.qr_detector_params(pj)
    for k, v in det.params.state_dict().items():
        np.testing.assert_allclose(N(v), N(want[k]), atol=1e-4)


def test_qr_sr_five_training_steps_and_pipeline(qr_pair):
    params, net = qr_pair
    init = jsr.DnnSuperRes("espcn", 2, seed=0).params
    srj = jl.train_qr_sr(n_steps=5, batch=4, seed=0)
    srt = tl.train_qr_sr(n_steps=5, batch=4, seed=0, params=interop.superres_params(init, "espcn"), device="cpu")
    want = interop.superres_params(srj.params, "espcn")
    for k, v in srt.net.state_dict().items():
        np.testing.assert_allclose(N(v), N(want[k]), atol=1e-4)
    # the composed pipeline on the twin's scene fixture and the clean fallback code, both packages on one pair of
    # models (the twin's, carried across)
    sr_t = tl.train_qr_sr(n_steps=0, seed=0, params=interop.superres_params(srj.params, "espcn"), device="cpu")
    scene = entry.learned_scene(120, 160)
    det_j, det_t = jl.QrDetector(params), tl.QrDetector(net)
    assert tl.detect_and_decode_learned(scene.qr_scenes[0], det_t, sr_t) == \
        jl.detect_and_decode_learned(scene.qr_scenes[0], det_j, srj)
    assert tl.detect_and_decode_learned(scene.qr_clean, det_t, sr_t) == "FALLBACK1" == \
        jl.detect_and_decode_learned(scene.qr_clean, det_j, srj)


def test_tiny_code_is_the_tests():
    """entry.tiny_code against tests/test_qr_learned.py::_tiny_code's
    recipe run with the twin's resize."""
    a, b = np.random.default_rng(1), np.random.default_rng(1)
    got = entry.tiny_code("T00001", 1.5, 0.7, 0.03, a)
    mod = jqr.encode("T00001")
    hr = jqr.render(mod, scale=4, border=2).astype(np.float32)
    tgt = int((mod.shape[0] + 4) * 1.5)
    small = np.asarray(jax.image.resize(jnp.asarray(hr), (tgt, tgt), "bilinear"))
    want = np.clip(jl._blur(small, 0.7) + b.standard_normal(small.shape) * 0.03, 0, 1).astype(np.float32)
    np.testing.assert_allclose(got, want, atol=1e-6)
