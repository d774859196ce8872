"""Parity of the port's shape and face modules (opencv_contrib_tpu_torch.shape:
distances, tps, extra; .face: recognizers, bif, aam, facemark) with the JAX
package on the CPU, on the JAX tests' own fixtures, and `entry.detect_x`
for them against the JAX tests' gates as chip_smoke's phase x applies them
at 480 x 640 (`chip_smoke.detection_gates`), here at 160 x 240.

Tolerances: distances, costs, warps and fits rtol 1e-5 (atol 1e-5 where a
value sits near 0: the TPS and affine residuals, the Sinkhorn costs);
labels equal; the recognizers' distances rtol 1e-4 and their subspaces by
the projector B B^T, since SVD and eigh bases are free up to each column's
sign; FisherFaces' eigenproblem symmetrized as `jnp.linalg.eigh` does; BIF
rtol 1e-4 (a 37 x 37 correlation summed in each library's order) with the
population standard deviation (ddof 0); the AAM's and Facemark's models
and fits to 1e-4 of their scale (float32 texture samples through a TPS
solve, then ridge solves); the AAM's shape modes are not compared: on the
test's faces they fit float32 rounding in both packages (see the test)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from opencv_contrib_tpu import face as jface
from opencv_contrib_tpu import shape as jshape
from opencv_contrib_tpu.face import aam as jaam
from opencv_contrib_tpu.face import facemark as jfm
from opencv_contrib_tpu_torch import entry, interop
from opencv_contrib_tpu_torch import face as tface
from opencv_contrib_tpu_torch import shape as tshape
from opencv_contrib_tpu_torch.face import aam as taam
from opencv_contrib_tpu_torch.face import facemark as tfm
from opencv_contrib_tpu_torch.face import recognizers as trec

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(N(a), np.asarray(b), rtol=rtol, atol=atol)


# ---- shape -----------------------------------------------------------------------------------------------------------


def test_distances(rng):
    pts = rng.normal(size=(30, 2)).astype(np.float32)
    other = rng.normal(size=(25, 2)).astype(np.float32)
    for rank in (1.0, 0.9):
        close(tshape.hausdorff_distance(T(pts), T(other), rank), jshape.hausdorff_distance(pts, other, rank))
    assert float(tshape.hausdorff_distance(T(pts), T(pts))) < 1e-6  # TestShape's gates
    assert 0.3 < float(tshape.hausdorff_distance(T(pts), T(pts + 0.5))) < 0.9
    h1, h2 = rng.uniform(size=(4, 12)).astype(np.float32), rng.uniform(size=(4, 12)).astype(np.float32)
    close(tshape.chi2_cost(T(h1), T(h2)), jshape.chi2_cost(h1, h2))


def test_shape_context(rng):
    """The log-polar descriptor (its radial edges as `jnp.logspace`'s) and
    the distance; TestShape's invariance gate."""
    t = np.linspace(0, 2 * np.pi, 40, endpoint=False)
    circle = np.stack([np.cos(t), np.sin(t)], axis=1).astype(np.float32)
    square = np.stack([np.cos(t) * (1 + 0.3 * np.sign(np.cos(3 * t))), np.sin(t)], axis=1).astype(np.float32)
    np.testing.assert_allclose(N(tshape.distances._log_edges(5, "cpu")),  # an ulp: XLA's pow and log10
                               np.asarray(jnp.logspace(jnp.log10(0.125), jnp.log10(2.0), 6)), rtol=2e-7)
    for pts in (circle, square, rng.normal(size=(33, 2)).astype(np.float32)):
        close(tshape.shape_context_descriptor(T(pts)), jshape.shape_context_descriptor(jnp.asarray(pts)))
    d_same = tshape.shape_context_distance(T(circle), T(circle * 2.0 + 5.0))
    d_diff = tshape.shape_context_distance(T(circle), T(square))
    close(d_same, jshape.shape_context_distance(jnp.asarray(circle), jnp.asarray(circle * 2.0 + 5.0)), atol=1e-6)
    close(d_diff, jshape.shape_context_distance(jnp.asarray(circle), jnp.asarray(square)))
    assert float(d_same) < float(d_diff)


def test_tps(rng):
    src = rng.uniform(0, 10, size=(12, 2)).astype(np.float32)
    dst = src + rng.normal(scale=0.5, size=(12, 2)).astype(np.float32)
    pt, pj = tshape.tps_fit(T(src), T(dst)), jshape.tps_fit(jnp.asarray(src), jnp.asarray(dst))
    for a, b in zip(pt, pj):
        close(a, b, rtol=1e-4, atol=1e-5)
    q = rng.uniform(-2, 12, size=(20, 2)).astype(np.float32)
    close(tshape.tps_apply(pt, T(src), T(q)), jshape.tps_apply(pj, jnp.asarray(src), jnp.asarray(q)), atol=1e-4)
    np.testing.assert_allclose(N(tshape.tps_apply(pt, T(src), T(src))), dst, atol=1e-2)  # TestShape's gates
    sq = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float32)
    params = tshape.tps_fit(T(sq), T(sq + np.float32([2.0, -1.0])))
    qq = np.array([[0.5, 0.5], [3.0, 2.0]], np.float32)
    np.testing.assert_allclose(N(tshape.tps_apply(params, T(sq), T(qq))), qq + np.float32([2.0, -1.0]), atol=1e-3)


def test_emd():
    h1 = np.zeros(10, np.float32)
    h1[2] = 1
    h2 = np.zeros(10, np.float32)
    h2[5] = 1
    close(tshape.emd_1d(T(h1), T(h2)), jshape.emd_1d(jnp.asarray(h1), jnp.asarray(h2)))
    assert float(tshape.emd_1d(T(h1), T(h2))) == pytest.approx(3.0, abs=1e-5)
    g1 = np.zeros((4, 6), np.float32)
    g1[1, 2] = 1
    g2 = np.zeros((4, 6), np.float32)
    g2[3, 4] = 1
    d = tshape.emd_l1_grid(T(g1), T(g2))
    close(d, jshape.emd_l1_grid(jnp.asarray(g1), jnp.asarray(g2)), atol=1e-5)
    assert float(d) == pytest.approx(4.0, rel=0.05)
    x1, x2, w = np.array([[0.0, 0.0]], np.float32), np.array([[2.0, 0.0]], np.float32), np.ones(1, np.float32)
    d = tshape.emd_sinkhorn(T(w), T(x1), T(w), T(x2), reg=0.01)
    close(d, jshape.emd_sinkhorn(w, x1, w, x2, reg=0.01))
    assert float(d) == pytest.approx(2.0, rel=0.05)
    rng = np.random.default_rng(9)
    pa, pb = rng.uniform(size=(7, 2)).astype(np.float32), rng.uniform(size=(5, 2)).astype(np.float32)
    wa, wb = rng.uniform(size=7).astype(np.float32), rng.uniform(size=5).astype(np.float32)
    close(tshape.emd_sinkhorn(T(wa), T(pa), T(wb), T(pb)), jshape.emd_sinkhorn(wa, pa, wb, pb), atol=1e-5)


def test_emd_cost_matrices():
    """Every pair at once against the twin's nested vmaps; TestEMD's
    shapes and signs."""
    rng = np.random.default_rng(6)
    a = rng.uniform(size=(5, 12)).astype(np.float32)
    b = rng.uniform(size=(7, 12)).astype(np.float32)
    C = tshape.emd_histogram_cost(T(a), T(b))
    close(C, jshape.emd_histogram_cost(jnp.asarray(a), jnp.asarray(b)))
    Cg = tshape.emd_histogram_cost(T(a), T(b), grid_shape=(3, 4))
    close(Cg, jshape.emd_histogram_cost(jnp.asarray(a), jnp.asarray(b), grid_shape=(3, 4)), rtol=1e-4, atol=1e-5)
    assert C.shape == (5, 7) and Cg.shape == (5, 7) and float(Cg.min()) >= -1e-6


def test_affine_transformer():
    rng = np.random.default_rng(7)
    src = rng.normal(size=(20, 2)).astype(np.float32)
    M_true = np.array([[1.2, 0.3, 2.0], [-0.2, 0.9, -1.0]], np.float32)
    dst = src @ M_true[:, :2].T + M_true[:, 2]
    M = tshape.affine_fit(T(src), T(dst), True)
    close(M, jshape.affine_fit(jnp.asarray(src), jnp.asarray(dst), True), atol=1e-5)
    np.testing.assert_allclose(N(M), M_true, atol=1e-4)
    close(tshape.affine_apply(M, T(src)), jshape.affine_apply(jnp.asarray(N(M)), jnp.asarray(src)))
    rng = np.random.default_rng(8)
    src = rng.normal(size=(15, 2)).astype(np.float32)
    th, s = 0.4, 1.3
    R = s * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    dst = src @ R.T + np.array([1.0, -2.0], np.float32)
    Ms = tshape.affine_fit(T(src), T(dst), False)
    close(Ms, jshape.affine_fit(jnp.asarray(src), jnp.asarray(dst), False), atol=1e-5)
    np.testing.assert_allclose(N(Ms)[:, :2], R, atol=1e-4)
    th = 0.7
    Rr = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    M = np.concatenate([Rr, np.zeros((2, 1), np.float32)], 1)
    M2 = M.copy()
    M2[0, 0] *= 2.5
    for m in (M, M2, M_true):
        close(tshape.affine_transform_cost(T(m)), jshape.affine_transform_cost(jnp.asarray(m)), atol=1e-5)
    assert abs(float(tshape.affine_transform_cost(T(M)))) < 1e-5 and float(tshape.affine_transform_cost(T(M2))) > 0.1


# ---- face ------------------------------------------------------------------------------------------------------------


@pytest.fixture
def dataset(rng):
    return entry._identity_images(rng)


def _projector(basis):
    B = np.asarray(basis, np.float64)
    return B @ B.T


def _same_predictions(pt, pj, rtol=1e-4):
    assert [p for p, _ in pt] == [p for p, _ in pj]
    np.testing.assert_allclose([d for _, d in pt], [d for _, d in pj], rtol=rtol)


def test_eigenfaces(dataset, rng, tmp_path):
    imgs, labels, bases = dataset
    mt = tface.EigenFaces(n_components=8).train(imgs, labels)
    mj = jface.EigenFaces(n_components=8).train(imgs, labels)
    close(mt.model.mean, mj.model.mean)
    np.testing.assert_allclose(_projector(N(mt.model.basis)), _projector(mj.model.basis), atol=1e-4)
    np.testing.assert_allclose(np.abs(N(mt.model.projections)), np.abs(np.asarray(mj.model.projections)), atol=1e-3)
    probes = [np.clip(1.1 * b + rng.normal(scale=0.05, size=b.shape), 0, 1.5).astype(np.float32) for b in bases]
    pt = [mt.predict(p) for p in probes]
    _same_predictions(pt, [mj.predict(p) for p in probes])
    assert [p for p, _ in pt] == list(range(len(bases)))  # TestEigenFaces's gate
    path = str(tmp_path / "eigen.npz")
    mt.save(path)
    m2 = tface.EigenFaces(8).load(path)
    assert m2.predict(bases[2])[0] == mt.predict(bases[2])[0] == 2
    mj2 = jface.EigenFaces(8).load(path)  # the twin reads the port's file
    assert mj2.predict(bases[2])[0] == 2


def test_fisherfaces_symmetrizes_like_jnp_eigh(dataset, rng):
    """`jnp.linalg.eigh` symmetrizes its input; solve(Sw, Sb) is not
    symmetric, and `torch.linalg.eigh` reads one triangle only, so the port
    symmetrizes: its eigenvalues are the twin's, the lower triangle's are
    not."""
    A = np.random.default_rng(1).normal(size=(5, 5)).astype(np.float32)
    wj = np.asarray(jnp.linalg.eigh(jnp.asarray(A))[0])
    np.testing.assert_allclose(N(torch.linalg.eigh((T(A) + T(A).T) / 2)[0]), wj, rtol=1e-5, atol=1e-5)
    assert np.abs(N(torch.linalg.eigh(T(A))[0]) - wj).max() > 1e-3
    imgs, labels, bases = dataset
    mt = tface.FisherFaces().train(imgs, labels)
    mj = jface.FisherFaces().train(imgs, labels)
    np.testing.assert_allclose(_projector(N(mt.model.basis)), _projector(mj.model.basis), rtol=1e-3, atol=1e-5)
    probes = [np.clip(0.9 * b + rng.normal(scale=0.05, size=b.shape), 0, 1.5).astype(np.float32) for b in bases]
    pt = [mt.predict(p) for p in probes]
    _same_predictions(pt, [mj.predict(p) for p in probes], rtol=1e-3)
    assert sum(p == i for i, (p, _) in enumerate(pt)) >= len(bases) - 1  # TestFisherFaces's gate


def test_lbph(dataset, rng):
    imgs, labels, bases = dataset
    img = rng.uniform(size=(16, 16)).astype(np.float32)
    codes = N(tface.lbp_image(T(img)))
    np.testing.assert_array_equal(codes, np.asarray(jface.lbp_image(jnp.asarray(img))))
    assert codes.min() >= 0 and codes.max() <= 255
    mt, mj = tface.LBPH(grid=4).train(imgs, labels), jface.LBPH(grid=4).train(imgs, labels)
    np.testing.assert_array_equal(N(mt.features), np.asarray(mj.features))
    _same_predictions([mt.predict(bases[1]), mt.predict((2.0 * bases[3]).astype(np.float32))],
                      [mj.predict(bases[1]), mj.predict((2.0 * bases[3]).astype(np.float32))], rtol=1e-6)
    assert mt.predict(bases[1])[0] == 1 and mt.predict((2.0 * bases[3]).astype(np.float32))[0] == 3
    new_base = rng.uniform(0, 1, (32, 32)).astype(np.float32)
    new = [np.clip(new_base + rng.normal(scale=0.05, size=(32, 32)), 0, 1.5).astype(np.float32) for _ in range(3)]
    mt.update(new, [9] * 3)
    mj.update(new, [9] * 3)
    np.testing.assert_array_equal(N(mt.labels), np.asarray(mj.labels))
    assert mt.predict(new_base)[0] == mj.predict(new_base)[0] == 9
    stack = N(trec._lbph_features(T(np.stack(imgs[:3])), 4))
    for i in range(3):
        np.testing.assert_array_equal(stack[i], np.asarray(jface.recognizers._lbph_features(imgs[i], 4)))


@pytest.mark.parametrize("bands,rots,size", [(4, 6, (64, 64)), (2, 4, (48, 40)), (8, 12, (56, 46))])
def test_bif(bands, rots, size):
    img = np.random.default_rng(3).uniform(size=size).astype(np.float32)
    ft = tface.bif_features(T(img), bands, rots)
    close(ft, jface.bif_features(jnp.asarray(img), num_bands=bands, num_rotations=rots), rtol=1e-4, atol=1e-5)
    assert ft.shape == (bands * rots * 4,)


def test_bif_std_is_the_population_one():
    """`jnp.std` is ddof 0: an image whose two halves differ only in
    spread, where the unbiased form would read 1 + 1/(n - 1) larger."""
    img = np.zeros((32, 32), np.float32)
    img[:, ::2] = 1.0
    f = tface.bif_features(T(img), 2, 4)
    close(f, jface.bif_features(jnp.asarray(img), num_bands=2, num_rotations=4), rtol=1e-4, atol=1e-5)
    x = T(np.arange(6, dtype=np.float32))
    assert float(x.std(correction=0)) == pytest.approx(float(np.std(np.arange(6))))


def _aam_data(rng, n=12, jitter=6):
    imgs, shapes = [], []
    for _ in range(n):
        img, lm = entry._make_face(44 + rng.uniform(-jitter, jitter), 46 + rng.uniform(-jitter, jitter),
                                   22 + rng.uniform(-4, 5))
        imgs.append(img + rng.normal(0, 0.01, img.shape).astype(np.float32))
        shapes.append(lm)
    return imgs, shapes


AAM_PARITY_PERTURB = 6  # the twin's eager training at its 24 perturbations an image takes ~20 s here


def test_aam_train_and_fit(rng):
    """TestFacemarkAAM's data: the port's model against the twin's (the
    mean shape, grid, texture mean and texture modes up to sign; the twin
    trained on AAM_PARITY_PERTURB perturbations an image); the twin's model
    carried across fits as the twin fits; the port's own model, at the
    test's settings, meets the test's gate."""
    imgs, shapes = _aam_data(rng)
    mt = taam.train(imgs, shapes, n_shape_modes=4, n_tex_modes=4)
    mj = jaam.train(imgs, shapes, n_shape_modes=4, n_tex_modes=4, n_perturb=AAM_PARITY_PERTURB)
    mp = taam.train(imgs, shapes, n_shape_modes=4, n_tex_modes=4, n_perturb=AAM_PARITY_PERTURB)
    close(mp.tex_mean, mt.tex_mean, rtol=0, atol=0)  # the texture model does not depend on the perturbations
    close(mt.mean_shape, mj.mean_shape, atol=1e-6)
    close(mt.grid_mean, mj.grid_mean, atol=1e-6)
    close(mt.tex_mean, mj.tex_mean, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_projector(N(mt.tex_basis).T), _projector(np.asarray(mj.tex_basis).T), atol=1e-4)
    # the test's landmarks are similarity transforms of one template: after Procrustes the shape residuals are
    # float32 rounding (singular values ~1e-7), so both packages' shape modes (and the regressors trained on them)
    # are rounding noise, not the twin's; the fits below are what agree
    aligned = np.stack([N(taam._procrustes_one(T(s), mt.mean_shape)) for s in shapes])
    assert np.linalg.svd((aligned - N(mt.mean_shape)).reshape(len(shapes), -1), compute_uv=False).max() < 1e-5
    assert mt.R.shape == mj.R.shape == (4, 8, taam.GRID ** 2)
    img_t, lm_t = entry._make_face(49, 43, 25)
    box = entry._box_of(lm_t)
    mx = interop.from_numpy(mj)
    assert isinstance(mx, taam.AAMModel)
    q0 = taam.init_params(mx, box)
    close(q0, jaam.init_params(mj, box))
    st, qt = taam.fit(mx, T(img_t), q0)
    sj, qj = jaam.fit(mj, jnp.asarray(img_t), jnp.asarray(N(q0)))
    close(st, sj, rtol=1e-4, atol=1e-3)
    close(qt, qj, rtol=1e-4, atol=1e-4)
    q0 = taam.init_params(mt, box)
    shape0 = N(taam._shape_from_params(mt, q0))
    fit, _ = taam.fit(mt, T(img_t), q0)
    e0 = np.linalg.norm(shape0 - lm_t, axis=1).mean()
    e1 = np.linalg.norm(N(fit) - lm_t, axis=1).mean()
    assert e1 < 1.5 and e1 < 0.5 * e0  # the JAX test's gates


def _facemark_data(rng):
    base = np.array([[30, 30], [30, 60], [55, 45], [70, 35], [70, 55]], np.float32)
    images, shapes, boxes = [], [], []
    for _ in range(24):
        lm = base + rng.normal(0, 2.0, base.shape).astype(np.float32) + rng.uniform(-6, 6, 2).astype(np.float32)
        images.append(entry._face_like(lm))
        shapes.append(lm)
        boxes.append([lm[:, 0].min() - 10, lm[:, 1].min() - 10, 60.0])
    return base, images, np.stack(shapes), np.stack(boxes)


def test_facemark_train_and_fit(rng):
    """TestFacemark's data: the cascade's draws (numpy) equal, its
    regressors to 1e-4 of their scale; the twin's model carried across fits
    as the twin fits; the port's own model meets the test's gate."""
    base, images, shapes, boxes = _facemark_data(rng)
    mt = tfm.train(images, shapes, boxes, n_stages=3)
    mj = jfm.train(images, shapes, boxes, n_stages=3)
    np.testing.assert_array_equal(N(mt.offsets), np.asarray(mj.offsets))
    np.testing.assert_array_equal(N(mt.pairs), np.asarray(mj.pairs))
    close(mt.mean_shape, mj.mean_shape)
    for a, b in ((mt.W, mj.W), (mt.b, mj.b)):
        b = np.asarray(b)
        np.testing.assert_allclose(N(a), b, atol=1e-4 * np.abs(b).max())
    lm = base + rng.normal(0, 2.0, base.shape).astype(np.float32)
    img = entry._face_like(lm)
    box = np.array([lm[:, 0].min() - 10, lm[:, 1].min() - 10, 60.0], np.float32)
    mx = interop.from_numpy(mj)
    close(tfm.fit(mx, T(img), T(box)), jfm.fit(mj, jnp.asarray(img), jnp.asarray(box)), rtol=1e-4, atol=1e-3)
    out = N(tfm.fit(mt, T(img), T(box)))
    err = np.linalg.norm(out - lm, axis=1).mean()
    err0 = np.linalg.norm(N(mt.mean_shape) * 60.0 + box[:2] - lm, axis=1).mean()
    assert err < err0 and err < 4.0  # the JAX test's gates


def test_detect_x_face_and_shape_and_gates():
    """`entry.detect_x` for the recognizers, BIF, AAM, Facemark and the shape
    methods at 160 x 240 on the CPU: against the same calls of the JAX
    package on the scene (the AAM and Facemark on the scene's models,
    carried across; FisherFaces by its gate here, its parity above), and
    the JAX tests' gates (`chip_smoke.detection_gates`)."""
    scene = entry.detection_scene(160, 240)
    methods = ("eigenfaces", "fisherfaces", "lbph", "bif", "aam", "facemark", "shape_context", "tps", "emd", "affine")
    outs = {m: entry.detect_x(scene, m, device="cpu") for m in methods}
    chip_smoke.detection_gates(scene, outs)
    faces, labels = list(scene.faces), list(scene.face_labels)
    mj = jface.EigenFaces(n_components=entry.EIGEN_COMPONENTS).train(faces, labels)
    _same_predictions(outs["eigenfaces"]["predictions"], [mj.predict(p) for p in scene.eigen_probes])
    close(outs["bif"]["a"], jface.bif_features(jnp.asarray(scene.bif_a), 4, 6), rtol=1e-4, atol=1e-5)
    am = jaam.AAMModel(*(jnp.asarray(N(v)) for v in scene.aam_model))
    sj, _ = jaam.fit(am, jnp.asarray(scene.aam_frame), jaam.init_params(am, scene.aam_box))
    close(outs["aam"]["shape"], sj, rtol=1e-4, atol=1e-3)
    fm = jfm.FacemarkModel(*(jnp.asarray(N(v)) for v in scene.fm_model))
    close(outs["facemark"]["shape"], jfm.fit(fm, jnp.asarray(scene.fm_frame), jnp.asarray(scene.fm_box)),
          rtol=1e-4, atol=1e-3)
    close(outs["shape_context"]["diff"], jshape.shape_context_distance(jnp.asarray(scene.circle),
                                                                       jnp.asarray(scene.wavy)))
    close(outs["affine"]["M"], jshape.affine_fit(jnp.asarray(scene.circle * 3.0 + scene.wavy),
                                                 jnp.asarray(N(outs["affine"]["dst"])), True), atol=1e-5)
