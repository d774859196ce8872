"""Parity of the port's line descriptors (opencv_contrib_tpu_torch.
line_descriptor: Hough segments, LBD, binarization, multi-index hashing)
with the JAX package on the CPU, on tests/test_breadth10.py::TestMIH's
fixtures and sizes.

Tolerances: segment validity equal; segments atol 1e-3 px (the twins'
`linspace` and trigonometry round an ulp apart); LBD rtol 1e-5 / atol 1e-6;
the packed codes, the bucket tables and the matches equal (the codes
compared as uint32: the port keeps int32 words of the same bits)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu import line_descriptor as jld
from opencv_contrib_tpu.line_descriptor import lines as jlines
from opencv_contrib_tpu.line_descriptor import mih as jmih
from opencv_contrib_tpu_torch import interop
from opencv_contrib_tpu_torch import line_descriptor as tld
from opencv_contrib_tpu_torch.line_descriptor import lines as tlines
from opencv_contrib_tpu_torch.line_descriptor import mih as tmih

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def u32(t):
    return N(t).astype(np.int32).view(np.uint32)


def _codes(n, words, rng):
    """TestMIH._codes."""
    return rng.integers(0, 2 ** 32, (n, words), dtype=np.uint64).astype(np.uint32)


def _bar_image(seed=5, shape=(64, 96)):
    """test_end_to_end_with_lbd's image."""
    img = np.random.default_rng(seed).uniform(size=shape).astype(np.float32)
    img[20:24, :] = 1.5
    return img


def _segments_equal(t, j):
    (ts, tv), (js, jv) = t, j
    np.testing.assert_array_equal(N(tv), np.asarray(jv))
    np.testing.assert_allclose(N(ts), np.asarray(js), atol=1e-3, rtol=0)


def test_segments_on_the_bar():
    img = _bar_image()
    _segments_equal(tld.detect_line_segments(T(img), max_lines=8), jld.detect_line_segments(jnp.array(img), max_lines=8))


def test_segments_with_tied_peaks():
    """Three equal bars: their six edge lines tie in the Hough votes, and the four kept are picked by the lower
    index (the stable sort, as `lax.top_k`). The bars lie along the rows: at 45 degrees the twins' votes part
    where x cos + y sin falls on a rho bin's edge (the cosines an ulp apart), which no row line's peak meets."""
    img = np.zeros((64, 64), np.float32)
    for r in (12, 28, 44):
        img[r:r + 2, 8:56] = 1.0
    acc = None
    for max_lines in (4, 6):
        peaks_t = tld.detect_line_segments(T(img), max_lines=max_lines, min_support=10)
        peaks_j = jld.detect_line_segments(jnp.array(img), max_lines=max_lines, min_support=10)
        _segments_equal(peaks_t, peaks_j)
        assert N(peaks_t[1]).all()
        ys = np.sort(N(peaks_t[0])[:, 0].round())
        acc = ys if acc is None else acc
    assert len(set(acc)) == 4 and set(acc) < set(ys)  # four of the six tied lines, then all six
    x = T(np.array([3.0, 7.0, 7.0, -np.inf, 7.0, 1.0], np.float32))
    np.testing.assert_array_equal(N(tlines._stable_top(x, 4)), [1, 2, 4, 0])


def test_lbd_and_binarize_as_uint32():
    img = _bar_image()
    segs, valid = jld.detect_line_segments(jnp.array(img), max_lines=8)
    jd = jld.lbd_describe(jnp.array(img), segs, valid)
    td = tld.lbd_describe(T(img), T(segs), T(valid))
    np.testing.assert_allclose(N(td), np.asarray(jd), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(u32(tld.lbd_binarize(T(jd))), np.asarray(jld.lbd_binarize(jd)))


@pytest.mark.parametrize("D", [12, 36, 9])
def test_binarize_keeps_bit_31(rng, D):
    """Words whose bit 31 is set keep the twin's bits (the int64 sum wraps to int32)."""
    d = rng.normal(size=(40, D)).astype(np.float32)
    d[:, -1] = -10.0  # every pair (i, D-1) is set: with D = 36 a word's last bit is such a pair
    t, j = tld.lbd_binarize(T(d)), np.asarray(jld.lbd_binarize(jnp.asarray(d)))
    assert t.dtype == torch.int32 and t.shape == j.shape
    np.testing.assert_array_equal(u32(t), j)
    assert (j >> 31).any() or D == 9


def test_substrings_of_negative_words(rng):
    codes = _codes(50, 3, rng)
    codes[0] = [0xFFFFFFFF, 0x80000001, 0x7FFFFFFF]
    np.testing.assert_array_equal(N(tmih._substrings(T(codes.view(np.int32)), 8)),
                                  np.asarray(jmih._substrings(jnp.asarray(codes), 8)))


@pytest.mark.parametrize("n,words,cap", [(64, 8, 16), (128, 8, 16), (200, 2, 4)])
def test_bucket_tables(rng, n, words, cap):
    """(200, 2, 4): 200 codes over 256 buckets with cap 4 overflow buckets; the twin's last -1 on slot cap - 1 is
    kept."""
    codes = _codes(n, words, rng)
    if cap == 4:
        codes[:40, 0] = (codes[:40, 0] & 0xFFFFFF00) | 0x5A  # 40 codes share table 0's key
    jb = np.asarray(jmih._mih_build(jnp.asarray(codes), 8, cap))
    tb = N(tmih._mih_build(T(codes.view(np.int32)), 8, cap))
    np.testing.assert_array_equal(tb, jb)
    if cap == 4:
        assert (jb[0, 0x5A] == [0, 1, 2, -1]).all()


@pytest.mark.parametrize("n,words,cap,k", [(64, 8, 16, 1), (128, 8, 16, 2), (300, 2, 4, 3), (256, 4, 8, 5)])
def test_knn_and_radius_match(rng, n, words, cap, k):
    """Matches against the JAX index carried across (interop.mih_index_from_jax) and the port's own: queries are
    database codes with 0-3 bits flipped, so distances tie often; (300, 2, 4) overflows buckets past the cap."""
    codes = _codes(n, words, rng)
    if cap == 4:
        codes[:60, 1] = (codes[:60, 1] & 0xFF00FFFF) | 0x00330000
    src = rng.choice(n, 40, replace=False)
    q = codes[src].copy()
    for i in range(40):
        for b in rng.choice(words * 32, i % 4, replace=False):
            q[i, b // 32] ^= np.uint32(1 << (b % 32))
    jidx = jld.mih_build(jnp.asarray(codes), b=8, cap=cap)
    carried = interop.mih_index_from_jax(jidx)
    own = tld.mih_build(T(codes.view(np.int32)), b=8, cap=cap)
    np.testing.assert_array_equal(N(own.buckets), N(carried.buckets))
    np.testing.assert_array_equal(u32(carried.codes), codes)
    ji, jd = jld.mih_knn_match(jidx, jnp.asarray(q), k=k)
    for index in (carried, own):
        ti, td = tld.mih_knn_match(index, T(q.view(np.int32)), k=k)
        np.testing.assert_array_equal(N(ti), np.asarray(ji))
        np.testing.assert_array_equal(N(td), np.asarray(jd))
    for radius in (0, 2):
        ri, rd = jld.mih_radius_match(jidx, jnp.asarray(q), radius=radius)
        ti, td = tld.mih_radius_match(own, T(q.view(np.int32)), radius=radius)
        np.testing.assert_array_equal(N(ti), np.asarray(ri))
        np.testing.assert_array_equal(N(td), np.asarray(rd))


def test_end_to_end_with_lbd():
    """TestMIH::test_end_to_end_with_lbd through the port, against the chain of JAX calls."""
    img = _bar_image()
    segs, valid = tld.detect_line_segments(T(img), max_lines=8)
    codes = tld.lbd_binarize(tld.lbd_describe(T(img), segs, valid))
    idx, dist = tld.mih_knn_match(tld.mih_build(codes, b=8, cap=8), codes, k=1)
    js, jv = jld.detect_line_segments(jnp.array(img), max_lines=8)
    jc = jld.lbd_binarize(jld.lbd_describe(jnp.array(img), js, jv))
    ji, jdist = jld.mih_knn_match(jld.mih_build(jc, b=8, cap=8), jc, k=1)
    np.testing.assert_array_equal(u32(codes), np.asarray(jc))
    np.testing.assert_array_equal(N(idx), np.asarray(ji))
    v = N(valid)
    assert (N(idx)[v, 0] == np.arange(len(v))[v]).all()
