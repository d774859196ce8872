"""Parity of the port's `models.dnn_objdetect` (SqueezeDet-class detection)
and its shared optax-order Adam (`utils.optim.Adam`) with the JAX package on
the CPU, the network from the twin's flax parameters carried across by
`interop.squeezedet_params`.

Tolerances: the head 1e-5 of the twin's largest; `decode`'s boxes atol
1e-4, its confidences and class probabilities 1e-6; `nms` indices and
validity equal, ties to the first; `detect`'s boxes 1e-4 and classes
equal; five training steps from the twin's init: the losses within 1e-5
relative, the parameters within atol 1e-4; Adam within 1e-7 of optax."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from opencv_contrib_tpu.models import dnn_objdetect as jod
from opencv_contrib_tpu_torch import interop
from opencv_contrib_tpu_torch.models import dnn_objdetect as tod
from opencv_contrib_tpu_torch.utils.optim import Adam

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_adam_is_optax():
    rng = np.random.default_rng(6)
    p0 = rng.normal(size=(3, 4)).astype(np.float32)
    tx = optax.adam(3e-3)
    pj, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    pt = torch.nn.Parameter(T(p0))
    opt = Adam([pt], 3e-3)
    for _ in range(7):
        g = rng.normal(size=(3, 4)).astype(np.float32)
        u, st = tx.update(jnp.asarray(g), st)
        pj = optax.apply_updates(pj, u)
        pt.grad = T(g)
        opt.step()
    np.testing.assert_allclose(N(pt), np.asarray(pj), atol=1e-7)


@pytest.fixture(scope="module")
def squeezedet():
    m = jod.SqueezeDetLite()
    p, _ = jod.init(jax.random.PRNGKey(0), m, img_hw=(48, 64))
    tm, _ = tod.init(0, tod.SqueezeDetLite(), device="cpu", params=interop.squeezedet_params(p))
    return m, p, tm


def test_squeezedet_forward_decode_nms_detect(squeezedet):
    m, p, tm = squeezedet
    rng = np.random.default_rng(7)
    x = rng.uniform(size=(2, 48, 64, 1)).astype(np.float32)
    hj = np.asarray(m.apply(p, x))
    with torch.no_grad():
        ht = N(tm(T(x)))
    assert ht.shape == hj.shape == (2, 6, 8, 3, 8) and _rel(ht, hj) <= 1e-5
    bj, cj, clj = jod.decode(jnp.asarray(hj[0]), jod.make_anchors())
    bt, ct, clt = tod.decode(T(hj[0]), tod.make_anchors())
    np.testing.assert_allclose(N(bt), np.asarray(bj), atol=1e-4)
    np.testing.assert_allclose(N(ct), np.asarray(cj), atol=1e-6)
    np.testing.assert_allclose(N(clt), np.asarray(clj), atol=1e-6)
    scores = rng.uniform(size=(bj.shape[0],)).astype(np.float32)
    scores[::5] = -np.inf
    ij, vj = jod.nms(bj, jnp.asarray(scores), top_k=40)
    it, vt = tod.nms(bt, T(scores), top_k=40)
    np.testing.assert_array_equal(N(it), np.asarray(ij))
    np.testing.assert_array_equal(N(vt), np.asarray(vj))
    img = rng.uniform(size=(48, 64)).astype(np.float32)
    for thr in (0.1, 0.2):
        dj, dt = jod.detect(p, m, img, jod.make_anchors(), conf_thresh=thr), \
            tod.detect(tm, tm, img, tod.make_anchors(), conf_thresh=thr)
        np.testing.assert_allclose(dt[0], dj[0], atol=1e-4)
        np.testing.assert_allclose(dt[1], dj[1], atol=1e-6)
        np.testing.assert_array_equal(dt[2], dj[2])


def test_nms_ties_take_the_first():
    boxes = T([[0, 0, 10, 10], [20, 20, 30, 30], [1, 1, 11, 11], [40, 40, 50, 50]]).float()
    s = np.array([0.5, 0.9, 0.9, 0.5], np.float32)
    ij, vj = jod.nms(jnp.asarray(N(boxes)), jnp.asarray(s), top_k=4)
    it, vt = tod.nms(boxes, T(s), top_k=4)
    np.testing.assert_array_equal(N(it), np.asarray(ij))
    np.testing.assert_array_equal(N(vt), np.asarray(vj))


def test_squeezedet_five_training_steps():
    rng = np.random.default_rng(0)
    m = jod.SqueezeDetLite(n_classes=2, n_anchors=1)
    p, oj = jod.init(jax.random.PRNGKey(0), m, img_hw=(48, 48))
    tm, ot = tod.init(0, tod.SqueezeDetLite(2, 1), device="cpu", params=interop.squeezedet_params(p, 2, 1))
    imgs = rng.uniform(0, 1, (2, 48, 48, 1)).astype(np.float32)
    tc = np.zeros((2, 6, 6, 1), np.float32)
    tc[:, 2, 2, 0] = 1.0
    tb = (rng.normal(size=(2, 6, 6, 1, 4)) * 0.1).astype(np.float32)
    tcl = rng.integers(0, 2, (2, 6, 6, 1)).astype(np.int32)
    aj, at = jod.make_anchors((16.0,)), tod.make_anchors((16.0,))
    for _ in range(5):
        p, oj, lj = jod.train_step(p, oj, m, jnp.asarray(imgs), jnp.asarray(tc), jnp.asarray(tb), jnp.asarray(tcl), aj)
        tm, ot, lt = tod.train_step(tm, ot, tm, T(imgs), T(tc), T(tb), T(tcl), at)
        assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    want = interop.squeezedet_params(p, 2, 1)
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(N(v), N(want[k]), atol=1e-4)


def test_detection_loss_terms():
    """optax's sigmoid BCE and integer-label softmax CE, term by term."""
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(3, 5)).astype(np.float32) * 3
    labels = (rng.uniform(size=(3, 5)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(N(tod._sigmoid_bce(T(logits), T(labels))),
                               np.asarray(optax.sigmoid_binary_cross_entropy(logits, labels)), rtol=1e-6)
    ints = rng.integers(0, 5, (3,)).astype(np.int32)
    np.testing.assert_allclose(N(tod._softmax_ce_int(T(logits), T(ints))),
                               np.asarray(optax.softmax_cross_entropy_with_integer_labels(logits, ints)), rtol=1e-6)
