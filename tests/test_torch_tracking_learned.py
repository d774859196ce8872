"""Parity of the port's learned and multi-target trackers
(opencv_contrib_tpu_torch.tracking: mil, boosting, multitracker, siam) with
the JAX package on the CPU, and `entry.track_x` against the JAX tests'
gates as chip_smoke's phase w applies them at 480 x 640
(`chip_smoke.tracking_gates`), here on a 240 x 320 scene.

The twins draw inside jitted functions; the tests give the port the same
draws: the Haar banks cross as arrays, and each step's ring offsets are
recomputed outside jit from the same split keys (`jax.random` gives the
same bits) and handed to the port through a spy on
`mil._sample_offsets`.

Tolerances:
- MIL: centres equal every frame, the class Gaussians 1e-5 relative, the
  best scores 1e-5 relative.
- Boosting: centres within 1 px of the twin's every frame, and the twin's
  gate (<= 2 px); the selector chain equal at init up to the first
  near-tie of two pool members' float32 error sums (the port sums the
  importances in float64, where equal sums tie exactly; the twin's order
  decides such a tie): the first 35 selectors.
- the batched integral of MIL's patches: each table bit-equal to the plain
  2-D table and to the twin's vmapped `integral`; the Haar responses 1e-6
  relative.
- MultiTracker: centres equal (MOSSE, KCF), 2e-2 px (MedianFlow).
- Siam: the embeddings 1e-5 of their range and one `_track_step` equal on
  the twin's init parameters (`interop.siam_params`); after 5 training
  steps the parameters within 1e-4 and the embeddings within 1e-4 of
  their range, except conv3's bias: its gradient is 0 (the embedding
  subtracts its mean), so Adam scales each package's rounding noise to a
  step of lr, and it leaves the embedding unchanged."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from opencv_contrib_tpu.ops import filters as jf
from opencv_contrib_tpu.ops.integral import integral as jintegral
from opencv_contrib_tpu.tracking import boosting as jb
from opencv_contrib_tpu.tracking import mil as jmil
from opencv_contrib_tpu.tracking import multitracker as jmt
from opencv_contrib_tpu.tracking import siam as js
from opencv_contrib_tpu_torch import entry, interop
from opencv_contrib_tpu_torch.ops.cuda import scan
from opencv_contrib_tpu_torch.tracking import boosting as tb
from opencv_contrib_tpu_torch.tracking import mil as tmil
from opencv_contrib_tpu_torch.tracking import multitracker as tmt
from opencv_contrib_tpu_torch.tracking import siam as ts

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


def _blob_scene(center, H=120, W=160):
    """tests/test_tracking_extra.py::_scene."""
    rng = np.random.default_rng(5)
    bg = rng.uniform(0, 0.2, size=(H, W)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    blob = np.exp(-(((yy - center[0]) / 6) ** 2 + ((xx - center[1]) / 6) ** 2))
    return np.asarray(jf.gaussian_blur(jnp.asarray(bg + blob), 1.0))


class Replay:
    """The twin's ring offsets of each step, recomputed from its split keys,
    handed to the port in its order of draws."""

    def __init__(self):
        self.q = []

    def add(self, kp, kn):
        self.q.append(np.asarray(jmil._sample_offsets(kp, 16, 3.0)))
        self.q.append(np.asarray(jmil._sample_offsets(kn, 32, 40.0, min_radius=12.0)))

    def __call__(self, gen, n, radius, min_radius=0.0):
        a = self.q.pop(0)
        assert a.shape == (n, 2)
        return T(a)


def _rel(a, b):
    a, b = N(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_batched_integral_of_the_patches(rng):
    """One `integral` call on (N, P, P) patches: each table bit-equal to the
    plain 2-D table of its patch and to the twin's vmapped integral."""
    patches = rng.uniform(0, 1, (13, 32, 32)).astype(np.float32)
    batch = N(scan.integral_padded(T(patches)))
    assert batch.shape == (13, 33, 33)
    for i in range(13):
        np.testing.assert_array_equal(batch[i], N(scan.integral_padded(T(patches[i]))))
    np.testing.assert_array_equal(batch, np.asarray(jax.vmap(jintegral)(jnp.asarray(patches))))
    with pytest.raises(ValueError):
        scan._check(T(patches[None]), "integral_padded", batch=True)


def test_haar_responses(rng):
    bank = jmil.make_feature_bank(jax.random.PRNGKey(4), patch=32, n_features=60)
    patches = rng.uniform(0, 1, (9, 32, 32)).astype(np.float32)
    got = tmil._haar_responses(T(patches), {k: T(v) for k, v in bank.items()})
    assert _rel(got, jmil._haar_responses(jnp.asarray(patches), bank)) <= 1e-6


def test_stable_top_k_keeps_the_lower_index_at_ties():
    x = np.array([0.5, 0.9, 0.5, 0.9, 0.1, 0.5, 0.9], np.float32)
    for k in (1, 2, 3, 5):
        want = np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1])
        np.testing.assert_array_equal(N(tmil._stable_top_k(T(x), k)), want)


def test_mil_on_replayed_draws():
    frames, centers = _target_sequence(vel=(2.0, 2.0), seed=11)
    key = jax.random.PRNGKey(0)
    bank = jmil.make_feature_bank(key, patch=32, n_features=120)
    rep = Replay()
    with mock.patch.object(tmil, "_sample_offsets", rep):
        rep.add(*jax.random.split(key))
        sj = jmil.mil_init(jnp.asarray(frames[0]), centers[0], key, bank)
        st = tmil.mil_init(T(frames[0]), centers[0], None, {k: T(v) for k, v in bank.items()})
        for i in range(1, len(frames)):
            key, k = jax.random.split(key)
            rep.add(*jax.random.split(k, 3)[1:])
            sj, scj = jmil.mil_update(sj, jnp.asarray(frames[i]), k, bank)
            st, sct = tmil.mil_update(st, T(frames[i]), None, {k_: T(v) for k_, v in bank.items()})
            np.testing.assert_array_equal(N(st.center), np.asarray(sj.center))
            assert _rel(sct, scj) <= 1e-5
        for a, b in zip(st[1:], sj[1:]):
            assert _rel(a, b) <= 1e-5
    assert not rep.q
    assert np.linalg.norm(N(st.center) - centers[-1]) < 6.0  # the JAX test's gate


def test_boosting_on_replayed_draws():
    key = jax.random.PRNGKey(0)
    bank = jb.make_feature_bank(key, n_features=120)
    tbank = {k: T(v) for k, v in bank.items()}
    c = np.array([60.0, 70.0])
    rep = Replay()
    with mock.patch.object(tmil, "_sample_offsets", rep):
        rep.add(*jax.random.split(key))
        sj = jb.boosting_init(jnp.asarray(_blob_scene(c)), c, key, bank)
        st = tb.boosting_init(T(_blob_scene(c)), c, None, tbank)
        np.testing.assert_array_equal(N(st.chosen)[:35], np.asarray(sj.chosen)[:35])
        np.testing.assert_allclose(N(st.alpha)[:35], np.asarray(sj.alpha)[:35], rtol=1e-5)
        for _ in range(5):
            c = c + np.array([2.0, 3.0])
            key, k = jax.random.split(key)
            rep.add(*jax.random.split(k))
            sj, _ = jb.boosting_update(sj, jnp.asarray(_blob_scene(c)), k, bank)
            st, _ = tb.boosting_update(st, T(_blob_scene(c)), None, tbank)
            assert np.abs(N(st.center) - np.asarray(sj.center)).max() <= 1.0
    assert np.abs(N(st.center) - c).max() <= 2.0  # the JAX test's gate


def test_multitracker_mixed_kinds():
    mj, mt = jmt.MultiTracker(seed=1), tmt.MultiTracker(seed=1)
    c = np.array([60.0, 70.0])
    img0 = _blob_scene(c)
    for m, im in ((mj, img0), (mt, T(img0))):
        m.add("mosse", im, c)
        m.add("kcf", im, c)
        m.add("medianflow", im, (c, (24.0, 24.0)))
    prev = img0
    for _ in range(4):
        c = c + np.array([1.0, 2.0])
        img = _blob_scene(c)
        oj, ot = mj.update(img, prev_img=prev), mt.update(T(img), prev_img=T(prev))
        prev = img
        for i, (a, b) in enumerate(zip(ot, oj)):
            np.testing.assert_allclose(N(a), np.asarray(b), atol=0.0 if i < 2 else 2e-2)
    for pos in ot:
        assert np.abs(N(pos) - c).max() < 3.0


def test_same_padding_at_stride_two():
    """flax's "SAME" at stride 2 pads a 3x3 of an even side by (0, 1), not
    torch's (1, 1): the backbone's outputs on the twin's parameters."""
    import flax.linen as fnn

    x = np.random.default_rng(0).normal(size=(1, 8, 8, 1)).astype(np.float32)
    conv = fnn.Conv(2, (3, 3), strides=(2, 2))
    p = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(conv.apply({"params": p}, jnp.asarray(x)))  # (1, 4, 4, 2)
    w = T(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    got = torch.nn.functional.conv2d(ts._same_pad(T(x.transpose(0, 3, 1, 2)), 3, 2), w, T(p["bias"]), stride=2)
    np.testing.assert_allclose(N(got).transpose(0, 2, 3, 1), want, atol=1e-6)
    sym = torch.nn.functional.conv2d(T(x.transpose(0, 3, 1, 2)), w, T(p["bias"]), stride=2, padding=1)
    assert np.abs(N(sym).transpose(0, 2, 3, 1) - want).max() > 1e-3  # torch's symmetric pad differs
    assert ts._same_pad(torch.zeros(1, 1, 64, 64), 3, 2).shape[-2:] == (65, 65)
    assert ts._same_pad(torch.zeros(1, 1, 16, 16), 3, 1).shape[-2:] == (18, 18)


@pytest.fixture(scope="module")
def siam_init():
    model = js.SiamBackbone()
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, js.SEARCH, js.SEARCH, 1)))["params"]
    tm = ts.SiamBackbone()
    tm.load_state_dict(interop.siam_params(params))
    return model, params, tm


def test_siam_embeddings_and_track_step(siam_init):
    model, params, tm = siam_init
    rng = np.random.default_rng(10)
    t, s, _ = js._synth_pair(rng)
    for patch in (t, s):
        fj = np.asarray(js._embed(params, model.apply, jnp.asarray(patch)))
        ft = N(ts._embed(tm, T(patch)))
        assert ft.shape == fj.shape and np.abs(ft - fj).max() <= 1e-5 * np.ptp(fj)
    tf_j = js._embed(params, model.apply, jnp.asarray(t))
    img = rng.uniform(0, 0.3, (96, 96)).astype(np.float32)
    img[34:46, 38:50] = t[10:22, 10:22]
    cj, sj = js._track_step(params, model.apply, tf_j, jnp.array([40.0, 40.0]), jnp.array([12.0, 12.0]),
                            jnp.asarray(img))
    ct, st = ts._track_step(tm, T(tf_j), torch.tensor([40.0, 40.0]), torch.tensor([12.0, 12.0]), T(img))
    np.testing.assert_array_equal(N(ct), np.asarray(cj))
    assert _rel(st, sj) <= 1e-5
    state = ts.siam_init(tm, T(img), (34, 38, 12, 12))
    _, bbox, score = ts.siam_update(tm, state, T(img))
    assert len(bbox) == 4 and isinstance(score, float)
    assert interop.siam_params(params).keys() == tm.state_dict().keys()


def test_siam_five_training_steps(siam_init):
    model, params, tm = siam_init
    rng = np.random.default_rng(0)
    tx = optax.adam(3e-3)
    opt, p = tx.init(params), params
    grad_fn = jax.jit(jax.value_and_grad(js._loss), static_argnames=("apply_fn",))
    for _ in range(5):
        trip = [js._synth_pair(rng) for _ in range(16)]
        _, g = grad_fn(p, model.apply, *(jnp.asarray(np.stack([x[i] for x in trip])) for i in range(3)))
        u, opt = tx.update(g, opt)
        p = optax.apply_updates(p, u)
    m5 = ts.train_siam(n_steps=5, batch=16, seed=0, params=interop.siam_params(params))
    got, want = m5.state_dict(), interop.siam_params(p)
    for k in got:
        if k != "conv3.bias":
            np.testing.assert_allclose(N(got[k]), N(want[k]), atol=1e-4)
    t, s, _ = js._synth_pair(np.random.default_rng(10))
    fj = np.asarray(js._embed(p, model.apply, jnp.asarray(s)))
    assert np.abs(N(ts._embed(m5, T(s))) - fj).max() <= 1e-4 * np.ptp(fj)


def test_siam_fresh_init_is_lecun_normal():
    m = ts.SiamBackbone().reset_parameters(torch.Generator().manual_seed(0))
    w = N(m.conv2.weight)
    assert np.abs(w).max() <= 2 * np.sqrt(1.0 / (16 * 9)) / ts.LECUN_TRUNC + 1e-6
    assert abs(w.std() - np.sqrt(1.0 / (16 * 9))) < 0.15 * np.sqrt(1.0 / (16 * 9))
    assert float(m.conv1.bias.detach().abs().max()) == 0.0


SMALL = (240, 320, 12)  # rows, columns, frames: A's fixture fits, MOSSE's 11 updates run


@pytest.fixture(scope="module")
def small_scene():
    return entry.tracking_scene(*SMALL)


def test_track_x_meets_the_gates(small_scene):
    """Every track_x method on the CPU, held to chip_smoke.tracking_gates."""
    outs = {m: entry.track_x(small_scene, m, device="cpu") for m in chip_smoke.TRACK_METHODS}
    assert tuple(entry.TRACKING) == chip_smoke.TRACK_METHODS
    g = chip_smoke.tracking_gates(small_scene, outs)
    assert g["mosse"]["err_px"] < 2.5 and g["by_matching"]["ids_as_expected"]
    again = entry.track_x(small_scene, "mil", device="cpu")
    assert chip_smoke._geo_equal(again, outs["mil"])


def test_track_x_refuses(small_scene, monkeypatch):
    with pytest.raises(ValueError):
        entry.track_x(small_scene, "no_such_method", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        entry.track_x(small_scene, "kcf")  # the default device is the card, and there is none
