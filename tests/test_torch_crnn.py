"""Parity of the port's CRNN (`text.crnn`) with the JAX package on the CPU,
from the twin's flax parameters carried across by `interop.crnn_params`
(`test_torch_qr_learned.py` holds the learned QR stages).

Tolerances: forward outputs 1e-5 of the twin's largest; the CTC loss rtol
1e-5 and its gradient 1e-5 of its largest against a float64 recompute of
the recursion (the twin's float32 gradient parts from that by 3.6e-5);
five training steps
from the twin's init: the parameters within atol 1e-4; the strings
exactly. The gates are held on the card (chip_smoke's phase z)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from opencv_contrib_tpu.text import crnn as jc
from opencv_contrib_tpu_torch import interop
from opencv_contrib_tpu_torch.models import layers
from opencv_contrib_tpu_torch.text import crnn as tc

torch.set_num_threads(1)
WORDS = ["AB", "CD", "EF", "GH"]


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def crnn_pair():
    imgs, labels, lpad = jc.make_batch(WORDS, 20, 40, 4, np.random.default_rng(3))
    model = jc.CRNN()
    params = model.init(jax.random.PRNGKey(0), imgs)["params"]
    tm = tc.CRNN()
    tm.load_state_dict(interop.crnn_params(params))
    return model, params, tm, (imgs, labels, lpad)


def test_make_batch_and_labels(crnn_pair):
    imgs, labels, lpad = crnn_pair[3]
    ti, tlab, tp = tc.make_batch(WORDS, 20, 40, 4, np.random.default_rng(3))
    np.testing.assert_array_equal(N(ti), np.asarray(imgs))
    np.testing.assert_array_equal(N(tlab), np.asarray(labels))
    np.testing.assert_array_equal(N(tp), np.asarray(lpad))
    for s in ("HELLO", "a1-b", ""):
        for a, b in zip(tc.encode_label(s, 6), jc.encode_label(s, 6)):
            np.testing.assert_array_equal(a, b)


def test_crnn_forward_and_recognize(crnn_pair):
    model, params, tm, (imgs, _, _) = crnn_pair
    want = np.asarray(model.apply({"params": params}, imgs))
    with torch.no_grad():
        got = N(tm(T(imgs)))
    assert got.shape == want.shape == (4, 20, tc.N_CLASSES) and _rel(got, want) <= 1e-5
    assert tc.recognize(tm, None, T(imgs)) == jc.recognize(model, params, imgs)
    assert tc.recognize(tm, dict(tm.named_parameters()), T(imgs)) == jc.recognize(model, params, imgs)


def test_reverse_gru_keeps_flax_order():
    """flax's nn.RNN(reverse=True) (keep_order False) returns at step t the
    state after reading steps T-1 .. T-1-t: the port's forward run over the
    flipped input, not flipped back."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 7, 5)).astype(np.float32)
    cell = fnn.GRUCell(6)
    rnn = fnn.RNN(cell, reverse=True)
    p = rnn.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(rnn.apply(p, jnp.asarray(x)))
    g = layers.GRUCell(5, 6)
    g.load_state_dict(layers.flax_to_state_dict(p["params"]["cell"]))
    with torch.no_grad():
        got = N(g.run(torch.flip(T(x), (1,))))
        kept = N(torch.flip(g.run(torch.flip(T(x), (1,))), (1,)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.abs(kept - want).max() > 1e-2  # flipping back (keep_order=True) would be another result
    fwd = fnn.RNN(fnn.GRUCell(6))
    pf = fwd.init(jax.random.PRNGKey(2), jnp.asarray(x))
    g.load_state_dict(layers.flax_to_state_dict(pf["params"]["cell"]))
    with torch.no_grad():
        np.testing.assert_allclose(N(g.run(T(x))), np.asarray(fwd.apply(pf, jnp.asarray(x))), atol=1e-6)


def test_ctc_loss_and_gradient():
    rng = np.random.default_rng(5)
    B, Tn, K, L = 4, 48, 37, 6
    logits = rng.normal(size=(B, Tn, K)).astype(np.float32) * 2
    labels = rng.integers(1, K, (B, L)).astype(np.int32)
    labels[1, 2] = labels[1, 1]  # a repeat
    lpad = np.zeros((B, L), np.float32)
    lpad[0, 3:] = 1.0
    lpad[2, 5:] = 1.0
    labels[lpad > 0] = 0
    pads = np.zeros((B, Tn), np.float32)
    pads[3, 40:] = 1.0  # a padded tail
    want = np.asarray(optax.ctc_loss(jnp.asarray(logits), jnp.asarray(pads), jnp.asarray(labels), jnp.asarray(lpad)))
    gj = np.asarray(jax.grad(lambda z: optax.ctc_loss(z, jnp.asarray(pads), jnp.asarray(labels),
                                                      jnp.asarray(lpad)).mean())(jnp.asarray(logits)))
    lg = T(logits).requires_grad_()
    got = tc.ctc_loss(lg, T(pads), T(labels), T(lpad))
    got.mean().backward()
    np.testing.assert_allclose(N(got), want, rtol=1e-5)
    # the gradient against a float64 recompute of the same recursion (rtol 1e-5 of the largest); the twin's own
    # float32 gradient parts from it by 3.6e-5 of the largest here, the port's by 6.7e-6
    l64 = T(logits.astype(np.float64)).requires_grad_()
    tc.ctc_loss(l64, T(pads).double(), T(labels), T(lpad).double()).mean().backward()
    g64, top = N(l64.grad), np.abs(N(l64.grad)).max()
    assert np.abs(N(lg.grad) - g64).max() <= 1e-5 * top
    assert np.abs(gj - g64).max() <= 5e-5 * top  # the twin on the same float64 yardstick


def test_ctc_greedy_decode():
    a, b = tc.VOCAB.index("A") + 1, tc.VOCAB.index("B") + 1
    logits = np.full((1, 6, tc.N_CLASSES), -5.0, np.float32)
    for t, s in enumerate([a, a, 0, a, b, 0]):
        logits[0, t, s] = 5.0
    assert tc.ctc_greedy_decode(T(logits)) == jc.ctc_greedy_decode(jnp.asarray(logits)) == ["AAB"]


def test_crnn_five_training_steps(crnn_pair):
    _, params, _, _ = crnn_pair
    model, pj = jc.train_crnn(WORDS, n_steps=5, W=40, max_len=4, seed=0, lr=5e-3)
    init = model.init(jax.random.PRNGKey(0), jc.make_batch(WORDS, 20, 40, 4, np.random.default_rng(0))[0])["params"]
    tm, pt = tc.train_crnn(WORDS, n_steps=5, W=40, max_len=4, seed=0, lr=5e-3, params=interop.crnn_params(init),
                           device="cpu")
    want = interop.crnn_params(pj)
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(N(v), N(want[k]), atol=1e-4)
    imgs = jc.make_batch(WORDS, 20, 40, 4, np.random.default_rng(2), noise=0.0)[0]
    assert tc.recognize(tm, pt, T(imgs)) == jc.recognize(model, pj, imgs)
