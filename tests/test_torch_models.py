"""Parity of the port's `jax.image.resize` twin, `signal` and
`models.dnn_superres` with the JAX package on the CPU
(`test_torch_dnn_objdetect.py` holds `models.dnn_objdetect` and the Adam).

Each network starts from the twin's flax parameters carried across by
`interop` (`superres_params`). Tolerances:
- `ops.image.image_resize` against `jax.image.resize`: atol 1e-6, bilinear
  and cubic, up and down, whole and non-integral ratios;
- forward outputs of every net: rtol / atol 1e-5 of the twin's largest;
- five training steps of each trainer from the twin's init: the
  parameters within atol 1e-4 (the losses within 1e-5 relative);
- the npz written by either package read by the other: the upsampled
  image within 1e-6.
The gates themselves are held on the card (chip_smoke's phase z); nothing
here trains to a gate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu import signal as jsig
from opencv_contrib_tpu.models import dnn_superres as jsr
from opencv_contrib_tpu_torch import interop
from opencv_contrib_tpu_torch import signal as tsig
from opencv_contrib_tpu_torch.models import dnn_superres as tsr
from opencv_contrib_tpu_torch.models import layers
from opencv_contrib_tpu_torch.ops.image import image_resize

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("method", ["bilinear", "cubic"])
@pytest.mark.parametrize("n_in,n_out", [(192, 128), (96, 48), (24, 48), (37, 128), (128, 192), (5, 3)])
def test_image_resize_matches_jax(method, n_in, n_out):
    x = np.random.default_rng(n_in).uniform(size=(2, n_in, n_in + 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, n_out, n_out + 5), method))
    got = N(image_resize(T(x), (2, n_out, n_out + 5), method))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_image_resize_long_signal_needs_no_matrix():
    """48,000 samples up to 96,000 (a dense weight matrix would be 18 GB):
    the taps agree with the twin's dense weights on a shorter signal, and
    the long one is finite and of its length."""
    x = np.sin(np.linspace(0, 60, 900)).astype(np.float32)
    np.testing.assert_allclose(N(image_resize(T(x), (1711,), "cubic")),
                               np.asarray(jax.image.resize(jnp.asarray(x), (1711,), "cubic")), atol=1e-6)
    y = image_resize(torch.zeros(48000), (96000,), "cubic")
    assert y.shape == (96000,) and bool(torch.isfinite(y).all())


@pytest.mark.parametrize("n", [400, 50, 777])
def test_resample_signal(n):
    x = np.random.default_rng(1).normal(size=(300,)).astype(np.float32)
    np.testing.assert_allclose(N(tsig.resample_signal(x, n)), np.asarray(jsig.resample_signal(jnp.asarray(x), n)),
                               atol=1e-6)


@pytest.fixture(scope="module", params=[("espcn", 2), ("fsrcnn", 2), ("edsr", 2), ("lapsrn", 2), ("lapsrn", 4)],
                ids=lambda p: f"{p[0]}x{p[1]}")
def sr_pair(request):
    algo, scale = request.param
    j = jsr.DnnSuperRes(algo, scale, seed=1)
    t = tsr.DnnSuperRes(algo, scale, device="cpu", params=interop.superres_params(j.params, algo, scale))
    return algo, scale, j, t


def test_superres_forward_and_upsample(sr_pair):
    algo, scale, j, t = sr_pair
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(2, 12, 14, 1)).astype(np.float32)
    want = np.asarray(j.net.apply(j.params, x))
    with torch.no_grad():
        got = N(t.net(T(x).permute(0, 3, 1, 2))).transpose(0, 2, 3, 1)
    assert got.shape == want.shape and _rel(got, want) <= 1e-5
    img = rng.uniform(size=(20, 24)).astype(np.float32)
    np.testing.assert_allclose(N(t.upsample(img)), np.asarray(j.upsample(img)), atol=1e-5)


def test_superres_state_keys_are_the_flax_paths(sr_pair):
    algo, scale, j, t = sr_pair
    flat = {"/".join(str(k) for k in kp) for kp, _ in jax.tree_util.tree_flatten_with_path(j.params)[0]}
    ours = {tsr._flax_key(p) for p, _ in tsr._flat(layers.state_dict_to_flax(t.net.state_dict()))}
    assert ours == flat


def test_superres_bicubic_and_evaluate():
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(17, 23)).astype(np.float32)
    np.testing.assert_allclose(N(tsr.DnnSuperRes.upsample_bicubic(img, 3)),
                               np.asarray(jsr.DnnSuperRes.upsample_bicubic(img, 3)), atol=1e-5)
    hr = [np.clip(rng.uniform(size=(32, 40)), 0, 1).astype(np.float32) for _ in range(2)]
    j = jsr.DnnSuperRes("espcn", 2, seed=0)
    t = tsr.DnnSuperRes("espcn", 2, device="cpu", params=interop.superres_params(j.params, "espcn"))
    for got, want in ((tsr.evaluate_psnr_ssim(t, hr), jsr.evaluate_psnr_ssim(j, hr)),
                      (tsr.evaluate_bicubic(hr, 2, device="cpu"), jsr.evaluate_bicubic(hr, 2))):
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("algo", ["espcn", "fsrcnn", "lapsrn"])
def test_superres_five_training_steps(algo):
    rng = np.random.default_rng(4)
    j = jsr.DnnSuperRes(algo, 2, seed=0)
    t = tsr.DnnSuperRes(algo, 2, device="cpu", params=interop.superres_params(j.params, algo))
    j.init_training(lr=2e-3)
    t.init_training(lr=2e-3)
    for _ in range(5):
        hr = rng.uniform(size=(4, 16, 16, 1)).astype(np.float32)
        lr = hr[:, ::2, ::2]
        lj = j.train_step(jnp.asarray(lr), jnp.asarray(hr))
        lt = t.train_step(lr, hr)
        assert abs(lt - lj) <= 1e-5 * abs(lj)
    want = interop.superres_params(j.params, algo)
    for k, v in t.net.state_dict().items():
        np.testing.assert_allclose(N(v), N(want[k]), atol=1e-4)


def test_npz_crosses_both_ways(tmp_path):
    rng = np.random.default_rng(5)
    img = rng.uniform(size=(16, 16)).astype(np.float32)
    j = jsr.DnnSuperRes("fsrcnn", 2, seed=3)
    j.save_model(str(tmp_path / "jax.npz"))
    t = tsr.DnnSuperRes("fsrcnn", 2, seed=99, device="cpu").read_model(str(tmp_path / "jax.npz"))
    np.testing.assert_allclose(N(t.upsample(img)), np.asarray(j.upsample(img)), atol=1e-6)
    t2 = tsr.DnnSuperRes("lapsrn", 2, seed=7, device="cpu")
    t2.save_model(str(tmp_path / "port.npz"))
    j2 = jsr.DnnSuperRes("lapsrn", 2, seed=99).read_model(str(tmp_path / "port.npz"))
    np.testing.assert_allclose(np.asarray(j2.upsample(img)), N(t2.upsample(img)), atol=1e-6)
    data = np.load(str(tmp_path / "port.npz"))
    assert str(data["__algo__"]) == "lapsrn" and int(data["__scale__"]) == 2


def test_prelu_starts_at_flax_slope():
    """flax's PReLU is one scalar that starts at 0.01 (torch's nn.PReLU:
    0.25); the port's fresh FSRCNN and the twin's agree."""
    j = jsr.DnnSuperRes("fsrcnn", 2, seed=0)
    assert float(j.params["params"]["PReLU_0"]["negative_slope"]) == pytest.approx(0.01)
    t = tsr.DnnSuperRes("fsrcnn", 2, seed=0, device="cpu")
    slopes = [v for k, v in t.net.state_dict().items() if k.endswith("negative_slope")]
    assert len(slopes) == 5 and all(s.shape == () and float(s) == pytest.approx(0.01) for s in slopes)
    x = torch.tensor([-2.0, 0.0, 3.0])
    np.testing.assert_allclose(N(layers.PReLU()(x)), [-0.02, 0.0, 3.0], rtol=1e-6)


def test_fresh_init_is_flax_like():
    """Truncated lecun-normal kernels (std 1 / sqrt(fan_in), within 2 std
    of the untruncated), zero biases, from a generator of the seed."""
    a = tsr.DnnSuperRes("edsr", 2, seed=0, device="cpu").net
    b = tsr.DnnSuperRes("edsr", 2, seed=0, device="cpu").net
    w = N(a.Conv_1.weight)
    std = np.sqrt(1.0 / (32 * 9))
    assert np.abs(w).max() <= 2 * std / layers.LECUN_TRUNC + 1e-6 and abs(w.std() - std) < 0.1 * std
    assert float(a.Conv_1.bias.detach().abs().max()) == 0.0
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
