"""Parity of the port's ER filter (opencv_contrib_tpu_torch.text.er) and OCR
heads (.text.ocr) with the JAX package on the CPU, on tests/test_text.py's
and tests/test_text_ocr.py's fixtures.

Tolerances: the ER level features equal (areas, boxes, perimeters, Euler
numbers and crossings are integers or halves, summed exactly in any order);
the ER boxes equal and their probabilities 1e-6; the glyph log-posteriors
rtol 1e-5 / atol 2e-5; the segmented patches 1e-6; decoded states and
strings equal (Viterbi's argmax takes the first of equal maxima and the
beam a stable sort, both as the twin)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu.ops import ccl as jccl
from opencv_contrib_tpu.text import er as jer
from opencv_contrib_tpu.text import ocr as jocr
from opencv_contrib_tpu_torch.ops import ccl as tccl
from opencv_contrib_tpu_torch.text import er as ter
from opencv_contrib_tpu_torch.text import ocr as tocr

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _glyph_image(shape=(96, 160), stroke=3):
    """tests/test_text.py::_glyph_image."""
    img = np.ones(shape, np.float32)
    for x in [30, 50, 70, 90]:
        img[30:66, x:x + stroke] = 0.0
    return img


def _fixtures():
    noise = np.random.default_rng(0).uniform(0.4, 0.6, (64, 64)).astype(np.float32)
    rings = np.ones((48, 64), np.float32)  # holes and crossings: an O, a ring with a bar, an 8
    rings[8:40, 6:26] = 0.0
    rings[14:34, 12:20] = 1.0
    rings[8:40, 34:58] = 0.2
    rings[12:20, 38:54] = 1.0
    rings[28:36, 38:54] = 1.0
    return {"glyphs": _glyph_image(stroke=4), "noise": noise, "rings": rings}


@pytest.mark.parametrize("name", ["glyphs", "noise", "rings"])
@pytest.mark.parametrize("dark_on_light", [True, False])
def test_er_level_features(name, dark_on_light):
    img = _fixtures()[name]
    kw = dict(n_levels=8, max_components=64, dark_on_light=dark_on_light)
    t = ter.er_level_features(T(img), **kw)
    j = jer.er_level_features(jnp.asarray(img), **kw)
    assert sorted(t) == sorted(j)
    for k in j:
        np.testing.assert_array_equal(N(t[k]), np.asarray(j[k]), err_msg=k)


def test_levels_label_as_connected_components(rng):
    """connected_components of a stack of masks (ER's levels) gives each mask its own labels and pass count, masks
    that stop at different passes and one that hits max_iters included."""
    masks = rng.uniform(size=(5, 40, 50)) < np.array([0.3, 0.5, 0.6, 0.7, 0.9])[:, None, None]
    masks[0] = False
    spiral = np.zeros((40, 50), bool)
    spiral[::4, 1:-1] = True
    spiral[np.arange(1, 40, 4), np.where(np.arange(10) % 2, 1, 48)] = True
    masks[4] = spiral
    for max_iters in (64, 3):
        got, passes = tccl.connected_components(T(masks), 4, max_iters)
        assert passes.shape == (5,)
        for i in range(5):
            one, n = tccl.connected_components(T(masks[i]), 4, max_iters)
            jl, jn = jccl.connected_components(jnp.asarray(masks[i]), 4, max_iters)
            np.testing.assert_array_equal(N(got[i]), N(one))
            np.testing.assert_array_equal(N(got[i]), np.asarray(jl))
            assert int(passes[i]) == int(n) == int(jn)


@pytest.mark.parametrize("name,min_area", [("glyphs", 12), ("glyphs", 20), ("noise", 20), ("rings", 12)])
def test_er_detect(name, min_area):
    img = _fixtures()[name]
    tb, tp = ter.er_detect(img, n_levels=8, max_components=64, min_area=min_area)
    jb, jp = jer.er_detect(img, n_levels=8, max_components=64, min_area=min_area)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_allclose(tp, jp, rtol=1e-6)
    if name == "glyphs" and min_area == 12:
        assert tb.shape[0] >= 2 and any(b[0] <= 35 and b[2] >= 60 and b[1] <= 52 and b[3] >= 50 for b in tb)


def test_classify_glyphs(rng):
    bank = tocr.glyph_bank()
    np.testing.assert_array_equal(bank, jocr.glyph_bank())
    assert tocr.VOCAB == jocr.VOCAB
    patches = np.concatenate([bank, bank + rng.normal(0, 0.3, bank.shape).astype(np.float32)])
    t = tocr.classify_glyphs(T(patches), T(bank))
    j = jocr.classify_glyphs(jnp.asarray(patches), jnp.asarray(bank))
    np.testing.assert_allclose(N(t), np.asarray(j), rtol=1e-5, atol=2e-5)
    assert (N(t)[:len(bank)].argmax(1) == np.arange(len(bank))).all()


@pytest.mark.parametrize("text,noise,seed", [("HELLO", 0.0, 0), ("KINFU42", 0.0, 0), ("TRACK", 0.25, 0),
                                             ("BEAM", 0.1, 1), ("WMW11", 0.0, 0)])
def test_segment_characters(text, noise, seed):
    img = jocr.render_text(text, scale=2, noise=noise, rng=np.random.default_rng(seed))
    np.testing.assert_array_equal(img, tocr.render_text(text, scale=2, noise=noise, rng=np.random.default_rng(seed)))
    t, j = tocr.segment_characters(img), jocr.segment_characters(img)
    assert t.shape == j.shape
    np.testing.assert_allclose(N(t), j, rtol=1e-6, atol=1e-6)


def test_viterbi_and_beam(rng):
    C = len(jocr.VOCAB)
    cases = [rng.normal(size=(6, C)).astype(np.float32), np.zeros((4, C), np.float32),  # all tied
             np.round(rng.normal(size=(7, C)) * 2).astype(np.float32)]  # integer ties
    em = np.full((2, C), -10.0, np.float32)  # test_viterbi_prefers_lexicon_transitions
    em[0, jocr.VOCAB.index("T")] = 0.0
    em[1, jocr.VOCAB.index("O")] = em[1, jocr.VOCAB.index("Q")] = -1.0
    cases.append(em)
    trans = [np.zeros((C, C), np.float32), np.asarray(jocr.transitions_from_lexicon(["TOP", "TON", "TOT"])),
             np.asarray(jocr.transitions_from_lexicon(["TRACK", "STACK", "TRUCK", "TRICK"]))]
    np.testing.assert_array_equal(N(tocr.transitions_from_lexicon(["TOP", "TON", "TOT"])), trans[1])
    for e in cases:
        for tr in trans:
            np.testing.assert_array_equal(N(tocr.viterbi_decode(T(e), T(tr))),
                                          np.asarray(jocr.viterbi_decode(jnp.asarray(e), jnp.asarray(tr))))
            for beam in (1, 4, 8):
                tp, ts = tocr.beam_search_decode(T(e), T(tr), beam=beam)
                jp, js = jocr.beam_search_decode(jnp.asarray(e), jnp.asarray(tr), beam=beam)
                np.testing.assert_array_equal(N(tp), np.asarray(jp))
                np.testing.assert_allclose(float(ts), float(js), rtol=1e-6, atol=1e-6)
    assert jocr.VOCAB[int(tocr.viterbi_decode(T(em), T(trans[1]))[1])] == "O"


@pytest.mark.parametrize("text,noise,seed,lexicon", [("KINFU42", 0.0, 0, None), ("TRACK", 0.25, 0,
                                                     ["TRACK", "STACK", "TRUCK", "TRICK"]), ("BEAM", 0.1, 1, None)])
@pytest.mark.parametrize("use_beam", [False, True])
def test_ocr_hmm(text, noise, seed, lexicon, use_beam):
    img = jocr.render_text(text, scale=2, noise=noise, rng=np.random.default_rng(seed))
    out = tocr.ocr_hmm(img, lexicon=lexicon, use_beam=use_beam)
    assert out == jocr.ocr_hmm(img, lexicon=lexicon, use_beam=use_beam) == text
