"""Parity of the port's background subtraction and retina
(opencv_contrib_tpu_torch.bgsegm, .bioinspired) with the JAX package on the
CPU, on the JAX tests' own fixtures, and `entry.background_x` against the
JAX tests' gates as chip_smoke's phase x applies them at 480 x 640
(`chip_smoke.background_gates`), here at 160 x 240.

GSOC and LSBP draw each frame's replacement mask from a split key inside a
jitted step; the tests recompute those draws outside jit from the same
keys (`jax.random` gives the same bits) and hand them to the port through a
spy on `gsoc._uniform`.

Tolerances: masks, integer states and codes equal; float states rtol 1e-5 /
atol 1e-6 (the twins add the K components and the blur taps in their own
order); the transient segmentation, which reads summed-area tables, on
integer magno frames whose tables stay below 2**24 (its first box pass bit
for bit, the states to 1e-5, the mask equal) and on the float fixture (the
states to 1e-5, the mask equal)."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from opencv_contrib_tpu import bgsegm as jbg
from opencv_contrib_tpu import bioinspired as jbio
from opencv_contrib_tpu.bgsegm import gsoc as jgsoc
from opencv_contrib_tpu.ops import filters as jfilters
from opencv_contrib_tpu_torch import bgsegm as tbg
from opencv_contrib_tpu_torch import bioinspired as tbio
from opencv_contrib_tpu_torch import entry, interop
from opencv_contrib_tpu_torch.bgsegm import gsoc as tgsoc
from opencv_contrib_tpu_torch.ops import filters as tfilters

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(N(a), np.asarray(b), rtol=rtol, atol=atol)


def same_state(st, sj):
    for a, b in zip(st, sj):
        b = np.asarray(b)
        if b.dtype.kind == "f":
            close(a, b)
        else:
            np.testing.assert_array_equal(N(a), b)


def test_synthetic_sequence_is_the_twins():
    for kw in ({}, {"n_frames": 7, "shape": (20, 30), "obj_size": 4, "seed": 3}):
        for (f, m), (fj, mj) in zip(tbg.synthetic_sequence(**kw), jbg.synthetic_sequence(**kw)):
            np.testing.assert_array_equal(f, fj)
            np.testing.assert_array_equal(m, mj)


def test_mog_every_frame():
    """TestMog's sequence: state and mask each frame; the test's gate."""
    frames = list(jbg.synthetic_sequence(n_frames=25, seed=1))
    sj, st = jbg.mog_create((64, 64)), tbg.mog_create((64, 64))
    hits, fps = [], []
    for i, (f, gt) in enumerate(frames):
        if 10 <= i < 15:  # the test skips these
            continue
        sj, fj = jbg.mog_apply(sj, jnp.asarray(f))
        st, ft = tbg.mog_apply(st, T(f))
        np.testing.assert_array_equal(N(ft), np.asarray(fj))
        same_state(st, sj)
        if i >= 15:
            hits.append(N(ft)[gt].mean())
            fps.append(N(ft)[~gt].mean())
    assert np.mean(hits) > 0.7 and np.mean(fps) < 0.1


def test_mog_ranks_ties_stably():
    """Equal -w/sqrt(var) keys keep their component order (`jnp.argsort` is
    stable): the background flags follow the twin's on tied mixtures."""
    K = 5
    w = np.full((4, 4, K), 0.2, np.float32)
    w[0, 0] = [0.1, 0.3, 0.3, 0.2, 0.1]
    var = np.full((4, 4, K), 0.01, np.float32)
    mean = np.tile(np.linspace(0.1, 0.9, K, dtype=np.float32), (4, 4, 1))
    frame = np.full((4, 4), 0.5, np.float32)
    sj, fj = jbg.mog_apply(jbg.MogState(*map(jnp.asarray, (w, mean, var))), jnp.asarray(frame))
    st, ft = tbg.mog_apply(tbg.MogState(*map(T, (w, mean, var))), T(frame))
    np.testing.assert_array_equal(N(ft), np.asarray(fj))
    same_state(st, sj)


def test_mog_static_scene(rng):
    img = rng.uniform(size=(32, 32)).astype(np.float32)
    sj, st = jbg.mog_create(img.shape), tbg.mog_create(img.shape)
    for _ in range(10):
        frame = img + rng.normal(scale=0.005, size=img.shape).astype(np.float32)
        sj, fj = jbg.mog_apply(sj, jnp.asarray(frame))
        st, ft = tbg.mog_apply(st, T(frame))
    np.testing.assert_array_equal(N(ft), np.asarray(fj))
    assert N(ft).mean() < 0.05


def test_cnt_every_frame():
    frames = list(jbg.synthetic_sequence(n_frames=30, seed=2))
    sj, st = jbg.cnt_create((64, 64)), tbg.cnt_create((64, 64))
    for f, _ in frames[:20] + [frames[25]]:
        sj, fj = jbg.cnt_apply(sj, jnp.asarray(f))
        st, ft = tbg.cnt_apply(st, T(f))
        np.testing.assert_array_equal(N(ft), np.asarray(fj))
        same_state(st, sj)
    gt = frames[25][1]
    assert N(ft)[gt].mean() > 0.6 and N(ft)[~gt].mean() < 0.15


def test_gmg_init_window_on_the_device():
    """TestGmg's fixture: the count a device tensor, the init window a
    `torch.where`; state and mask each frame, and the test's gate."""
    rng = np.random.default_rng(1)
    bg = np.full((48, 48), 0.5)
    sj, st = jbg.gmg_create((48, 48)), tbg.gmg_create((48, 48))
    assert st.frame_count.ndim == 0 and st.frame_count.dtype == torch.int32
    frames = [(bg + rng.normal(0, 0.01, bg.shape)).astype(np.float32) for _ in range(22)]
    obj = bg.copy()
    obj[10:20, 10:20] = 0.95
    for f in frames + [obj.astype(np.float32)]:
        sj, fj = jbg.gmg_apply(sj, jnp.asarray(f))
        st, ft = tbg.gmg_apply(st, T(f))
        np.testing.assert_array_equal(N(ft), np.asarray(fj))
        same_state(st, sj)
    fg = N(ft)
    assert fg[12:18, 12:18].mean() > 0.9 and fg[30:, 30:].mean() < 0.05


class Draws:
    """The twin's replacement draws of each step, recomputed from its split
    keys, handed to the port in its order."""

    def __init__(self, key, shape, n):
        self.q = []
        for _ in range(n):
            key, k1 = jax.random.split(key)
            self.q.append(np.asarray(jax.random.uniform(k1, shape)))

    def __call__(self, gen, shape, device):
        a = self.q.pop(0)
        assert a.shape == tuple(shape)
        return T(a).to(device)


def test_gsoc_on_replayed_draws():
    frames = list(jbg.synthetic_sequence(n_frames=24, shape=(48, 48)))
    sj = jbg.gsoc_create((48, 48))
    st = tbg.gsoc_create((48, 48))
    draws = Draws(sj.key, (48, 48), len(frames))
    with mock.patch.object(tgsoc, "_uniform", draws):
        for f, _ in frames:
            sj, fj = jbg.gsoc_apply(sj, jnp.asarray(f))
            st, ft = tbg.gsoc_apply(st, T(f))
            np.testing.assert_array_equal(N(ft), np.asarray(fj))
            close(st.samples, sj.samples)
            close(st.hits, sj.hits)
    assert not draws.q
    gt = frames[-1][1]
    fg = N(ft)
    assert (fg & gt).sum() / gt.sum() > 0.6 and (fg & ~gt).sum() / (~gt).sum() < 0.15


def test_lsbp_on_replayed_draws():
    frames = list(jbg.synthetic_sequence(n_frames=24, shape=(48, 48), seed=3))
    sj = jbg.lsbp_create((48, 48))
    st = tbg.lsbp_create((48, 48))
    draws = Draws(sj.gsoc.key, (48, 48), len(frames))
    with mock.patch.object(tgsoc, "_uniform", draws):
        for f, _ in frames:
            np.testing.assert_array_equal(N(tbg.lsbp_descriptor(T(f))), np.asarray(jbg.lsbp_descriptor(jnp.asarray(f))))
            sj, fj = jbg.lsbp_apply(sj, jnp.asarray(f))
            st, ft = tbg.lsbp_apply(st, T(f))
            np.testing.assert_array_equal(N(ft), np.asarray(fj))
            np.testing.assert_array_equal(N(st.desc), np.asarray(sj.desc))
            close(st.gsoc.samples, sj.gsoc.samples)
            close(st.gsoc.hits, sj.gsoc.hits)
    gt = frames[-1][1]
    assert (N(ft) & gt).sum() / gt.sum() > 0.5
    assert int(N(tbg.lsbp_descriptor(torch.zeros(16, 16))).max()) == 0


def test_popcount8_every_code():
    x = np.arange(256, dtype=np.int32)
    got = N(tgsoc._popcount8(T(x)))
    np.testing.assert_array_equal(got, [bin(v).count("1") for v in x])
    np.testing.assert_array_equal(got, np.asarray(jgsoc._popcount8(jnp.asarray(x))))


def test_states_cross_by_interop():
    """The JAX states cross by `interop.from_numpy`; GSOC's key becomes the
    generator passed in."""
    frames = list(jbg.synthetic_sequence(n_frames=6, shape=(24, 24)))
    sj = jbg.mog_create((24, 24))
    for f, _ in frames:
        sj, _ = jbg.mog_apply(sj, jnp.asarray(f))
    st = interop.from_numpy(sj)
    assert isinstance(st, tbg.MogState)
    same_state(tbg.mog_apply(st, T(frames[0][0]))[0], jbg.mog_apply(sj, jnp.asarray(frames[0][0]))[0])
    gen = torch.Generator().manual_seed(5)
    lj = jbg.lsbp_create((8, 8))
    lt = interop.from_numpy(lj, key=gen)
    assert isinstance(lt, tbg.LsbpState) and lt.gsoc.key is gen and lt.desc.dtype == torch.int32
    with pytest.raises(TypeError):
        interop.from_numpy(jbg.gsoc_create((8, 8)))
    gj = interop.to_numpy(tbg.gmg_create((8, 8)))
    assert gj.frame_count.shape == () and gj.hist.shape == (16, 8, 8)


def _retina_pair(shape):
    return jbio.Retina(shape), tbio.Retina(shape)


def test_retina_parvo_and_magno(rng):
    """TestRetina's fixtures: every run's parvo and magno, and both gates."""
    base = rng.uniform(size=(64, 64)).astype(np.float32) * 0.1
    img = base.copy()
    img[:, 32:] += 0.8
    rj, rt = _retina_pair((64, 64))
    for _ in range(10):
        pj, mj = rj.run(img)
        pt, mt = rt.run(img)
        close(pt, pj)
        close(mt, mj)
    for a, b in zip(rt.state, rj.state):
        close(a, b)
    p = N(pt)
    assert 0.2 < p[8:-8, 4:28].std() / p[8:-8, 36:-4].std() < 5.0
    img1 = rng.uniform(size=(64, 64)).astype(np.float32)
    rj, rt = _retina_pair((64, 64))
    for _ in range(12):
        _, ms = rt.run(img1)
        _, msj = rj.run(img1)
    _, mm = rt.run(np.roll(img1, 5, axis=1))
    _, mmj = rj.run(np.roll(img1, 5, axis=1))
    close(ms, msj)
    close(mm, mmj)
    assert float(mm.mean()) > 2.0 * float(ms.mean())
    rt.reset()
    assert all(float(a.abs().max()) == 0 for a in rt.state)


def _transient_run(magnos):
    sj, st = jbio.transient_create(magnos[0].shape), tbio.transient_create(magnos[0].shape)
    for m in magnos:
        sj, gj = jbio.transient_run(sj, jnp.asarray(m))
        st, gt = tbio.transient_run(st, T(m))
    return sj, gj, st, gt


def test_transient_on_integer_magno():
    """Integer magno frames (tables below 2**24): the sigma-6 blur's first
    summed-area box pass gives the twin's bits; the later passes read
    tables of box means, so the states are held to 1e-5 and the mask
    equal."""
    rng = np.random.default_rng(7)
    magnos = [rng.integers(0, 50, (64, 64)).astype(np.float32) for _ in range(4)]
    for r in (5, 6):  # the passes' radii at sigma 6
        np.testing.assert_array_equal(N(tfilters._box_blur_cumsum(T(magnos[0]), r)),
                                      np.asarray(jfilters._box_blur_cumsum(jnp.asarray(magnos[0]), r)))
    sj, gj, st, gt = _transient_run(magnos)
    for a, b in zip(st, sj):
        close(a, b)
    np.testing.assert_array_equal(N(gt), np.asarray(gj))


def test_transient_segments_moving_region(rng):
    """TestTransient's fixture: states to 1e-5, the mask equal, the gate."""
    magnos = []
    for _ in range(10):
        m = 0.01 * rng.standard_normal((64, 64)).astype(np.float32)
        m[20:40, 24:44] += 0.5
        magnos.append(m)
    sj, gj, st, gt = _transient_run(magnos)
    for a, b in zip(st, sj):
        close(a, b)
    np.testing.assert_array_equal(N(gt), np.asarray(gj))
    seg = N(gt)
    assert seg[24:36, 28:40].mean() > 0.7 and seg[:10, :10].mean() < 0.1


def test_color_multiplexing_and_tone_mapping():
    """tests/test_breadth9.py::TestRetinaColor's fixtures through both."""
    np.testing.assert_array_equal(N(tbio.bayer_masks((7, 9))), np.asarray(jbio.bayer_masks((7, 9))))
    H, W = 32, 48
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    rgb = np.stack([0.3 + 0.3 * np.sin(xs / 15), 0.5 + 0.2 * np.cos(ys / 12),
                    0.4 + 0.1 * np.sin((xs + ys) / 20)], -1).astype(np.float32)
    mosaic = tbio.color_multiplex(T(rgb))
    np.testing.assert_array_equal(N(mosaic), np.asarray(jbio.color_multiplex(jnp.asarray(rgb))))
    rec = tbio.color_demultiplex(mosaic)
    close(rec, jbio.color_demultiplex(jnp.asarray(N(mosaic))))
    assert np.abs(N(rec) - rgb).mean() < 0.03
    hdr = np.exp(np.random.default_rng(0).normal(0, 2.0, (32, 32))).astype(np.float32)
    close(tbio.fast_tone_mapping(T(hdr)), jbio.fast_tone_mapping(jnp.asarray(hdr)), rtol=1e-5, atol=1e-5)
    img = np.random.default_rng(1).uniform(0.1, 1.0, (16, 16, 3)).astype(np.float32)
    close(tbio.fast_tone_mapping(T(img)), jbio.fast_tone_mapping(jnp.asarray(img)), rtol=1e-5, atol=1e-5)
    rgb2 = np.random.default_rng(2).uniform(size=(24, 24, 3)).astype(np.float32)
    pj, mj = jbio.retina_run_color(jbio.Retina((24, 24)), rgb2)
    pt, mt = tbio.retina_run_color(tbio.Retina((24, 24)), rgb2)
    close(pt, pj)
    close(mt, mj)


def test_background_x_against_the_twins_and_gates():
    """Every `entry.background_x` method at 160 x 240 on the CPU: MOG, CNT,
    GMG and the retina paths against the same calls of the JAX package on
    the clip, and every method against `chip_smoke.background_gates`."""
    clip = entry.background_clip(160, 240)
    outs = {m: entry.background_x(clip, m, device="cpu") for m in entry.BACKGROUND}
    chip_smoke.background_gates(clip, outs)
    sj = jbg.cnt_create((160, 240))
    for f in list(clip.cnt[:20]) + [clip.cnt[25]]:
        sj, fj = jbg.cnt_apply(sj, jnp.asarray(f))
    np.testing.assert_array_equal(N(outs["cnt"]["fg"]), np.asarray(fj))
    sj = jbg.mog_create((160, 240))
    for f in list(clip.mog[:10]) + list(clip.mog[15:]):
        sj, fj = jbg.mog_apply(sj, jnp.asarray(f))
    np.testing.assert_array_equal(N(outs["mog"]["fg"][-1]), np.asarray(fj))
    same_state(outs["mog"]["state"], sj)
    sj = jbg.gmg_create((160, 240))
    for f in clip.gmg:
        sj, fj = jbg.gmg_apply(sj, jnp.asarray(f))
    np.testing.assert_array_equal(N(outs["gmg"]["fg"]), np.asarray(fj))
    sj = jbio.transient_create((160, 240))
    for m in clip.magno:
        sj, gj = jbio.transient_run(sj, jnp.asarray(m))
    np.testing.assert_array_equal(N(outs["retina_transient"]["seg"]), np.asarray(gj))
    close(outs["retina_color"]["demux"], jbio.color_demultiplex(jbio.color_multiplex(jnp.asarray(clip.smooth))))
    with pytest.raises(ValueError):
        entry.background_x(clip, "vibe", device="cpu")
