"""Parity of the port's QR pipeline (opencv_contrib_tpu_torch.wechat_qrcode:
its own copies of the GF(256) codec and the symbol tables, the encoder, the
detector and the decoder) with the JAX package on the CPU, on
tests/test_wechat_qrcode.py's fixtures; and `entry.recognize_x` against
`chip_smoke.recognition_gates` at 240 x 320.

Tolerances: codewords, tables, matrices, decoded texts and finder corners
equal (the module grid is one bilinear gather in both packages, compared
after its 0.5 threshold)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from opencv_contrib_tpu.ops.image import sample_bilinear as jsample
from opencv_contrib_tpu.wechat_qrcode import gf256 as jgf
from opencv_contrib_tpu.wechat_qrcode import qr as jqr
from opencv_contrib_tpu.wechat_qrcode import spec as jspec
from opencv_contrib_tpu_torch import entry
from opencv_contrib_tpu_torch.wechat_qrcode import gf256 as tgf
from opencv_contrib_tpu_torch.wechat_qrcode import qr as tqr
from opencv_contrib_tpu_torch.wechat_qrcode import spec as tspec

torch.set_num_threads(1)


def test_rs_encode_and_decode(rng):
    np.testing.assert_array_equal(tgf.EXP, jgf.EXP)
    np.testing.assert_array_equal(tgf.LOG, jgf.LOG)
    for n_data, n_ec, n_err in ((19, 7, 3), (19, 7, 6), (80, 20, 10), (16, 28, 14), (9, 17, 0)):
        data = [int(v) for v in rng.integers(0, 256, n_data)]
        cw = tgf.rs_encode(data, n_ec)
        assert [int(v) for v in cw] == [int(v) for v in jgf.rs_encode(data, n_ec)]
        bad = list(cw)
        for i in rng.choice(len(bad), n_err, replace=False):
            bad[i] ^= int(rng.integers(1, 256))
        t, j = tgf.rs_decode(bad, n_ec), jgf.rs_decode(bad, n_ec)
        assert t[1] == j[1] and [int(v) for v in t[0]] == [int(v) for v in j[0]]


def test_spec_tables():
    assert tspec.VERSION_TABLE == jspec.VERSION_TABLE
    assert tspec.FORMAT_CODES == jspec.FORMAT_CODES and tspec.VERSION_CODES == jspec.VERSION_CODES
    for v in (1, 2, 7, 21, 40):
        np.testing.assert_array_equal(tspec.function_mask(v), jspec.function_mask(v))
        np.testing.assert_array_equal(tspec.place_function_patterns(v), jspec.place_function_patterns(v))
        assert tspec.data_coords(v) == jspec.data_coords(v)
        for lvl in "LMQH":
            assert tspec.total_data_codewords(v, lvl) == jspec.total_data_codewords(v, lvl)


@pytest.mark.parametrize("mask", range(8))
def test_encode_every_mask(mask):
    for text, kw in (("HELLO TPU", {}), ("0123456789" * 3, {"level": "M"}), ("café ☃", {"level": "H"}),
                     ("点茗", {}), ("x" * 60, {"version": 7, "level": "Q"})):
        mod = tqr.encode(text, mask_id=mask, **kw)
        np.testing.assert_array_equal(mod, jqr.encode(text, mask_id=mask, **kw))
        assert tqr.decode_matrix(mod) == jqr.decode_matrix(mod) == text


def _perspective_fixture():
    """test_rendered_decode_perspective's image."""
    text = "PERSPECTIVE AT VERSION FOUR 0123456789"
    img = jqr.render(jqr.encode(text, mask_id=5, level="M"), scale=8, border=6)
    H0, W0 = img.shape
    src = np.array([[0, 0], [0, W0 - 1], [H0 - 1, 0], [H0 - 1, W0 - 1]], float)
    dst = src + np.array([[6, 9], [3, -7], [-5, 6], [8, -4]], float)
    Hm = jqr._perspective_from_4([(r, c) for r, c in dst], [(r, c) for r, c in src])
    yy, xx = np.meshgrid(np.arange(H0), np.arange(W0), indexing="ij")
    p = np.stack([xx, yy, np.ones_like(xx)], -1) @ Hm.T
    return np.asarray(jsample(jnp.asarray(img), jnp.asarray(p[..., 1] / p[..., 2]), jnp.asarray(p[..., 0] / p[..., 2])))


@pytest.mark.parametrize("name", ["clean", "noisy", "midsize", "perspective", "none"])
def test_detect_and_decode(rng, name):
    if name == "clean":
        img = jqr.render(jqr.encode("IMG TEST"), scale=4)
    elif name == "noisy":
        img = jqr.render(jqr.encode("NOISY!"), scale=5, border=6)
        img = np.clip(img + rng.normal(0, 0.05, img.shape).astype(np.float32), 0, 1)
    elif name == "midsize":
        img = jqr.render(jqr.encode("https://example.com/path?q=tpu-qr", mask_id=2, level="M"), scale=6, border=4)
    elif name == "perspective":
        img = _perspective_fixture()
    else:
        img = rng.uniform(0, 1, (80, 80)).astype(np.float32)
    tt, tc = tqr.detect_and_decode(torch.from_numpy(np.array(img)))
    jt, jc = jqr.detect_and_decode(img)
    assert tt == jt and (tt is None) == (name == "none")
    if jc is None:
        assert tc is None
    else:
        np.testing.assert_array_equal(tc, jc)


def test_sample_grid_on_a_tensor():
    img = _perspective_fixture()
    H = jqr._perspective_from_4([(3.5, 3.5), (3.5, 29.5), (29.5, 3.5), (29.5, 29.5)],
                                [(50, 50), (60, 300), (300, 45), (310, 305)])
    np.testing.assert_array_equal(tqr._sample_grid(torch.from_numpy(np.array(img)), H, 33), jqr._sample_grid(img, H, 33))


def test_recognize_x_meets_the_gates():
    """Every recognize_x method at 360 x 480 on the CPU, held to chip_smoke's phase-y gates (the JAX tests'
    gates, scaled), and the hashes' card-vs-CPU rule on a run against itself."""
    scene = entry.recognition_scene(360, 480)  # the perspective QR code needs a module of 5 px or more
    outs = {m: entry.recognize_x(scene, m, device="cpu") for m in entry.RECOGNITION}
    gates = chip_smoke.recognition_gates(scene, outs)
    assert gates["mih"]["found"] == entry.MIH_QUERIES and gates["ocr_viterbi"] == gates["ocr_beam"]
    host = {m: chip_smoke._geo_host(o) for m, o in outs.items()}
    for m in entry.RECOGNITION:
        assert chip_smoke.y_diff(host[m], host[m], m)["ok"], m
    with pytest.raises(ValueError, match="method must be one of"):
        entry.recognize_x(scene, "sift", device="cpu")
