"""Parity of the port's sparse bundle adjustment (opencv_contrib_tpu_torch.ba.sparse)
with the JAX package's ba/sparse.py on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The sizes
are those of tests/test_ba_sparse.py. Each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu.ba import bundle as jba
from opencv_contrib_tpu.ba import sparse as jsp
from opencv_contrib_tpu.core import se3 as jse3
from opencv_contrib_tpu.utils.synthetic import generate_scene
from opencv_contrib_tpu_torch import interop
from opencv_contrib_tpu_torch.ba import bundle as tba
from opencv_contrib_tpu_torch.ba import sparse as tsp

# The suite runs several worker processes beside XLA's thread pools; at
# these sizes torch's own per-process OpenMP pool only oversubscribes the CPU.
torch.set_num_threads(1)
CPU = "cpu"


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _noisy_scene(noise_px=0.0):
    """tests/test_ba_sparse.py's noisy_problem: generate_scene(8, 256) with
    points and translations perturbed; optionally noisy pixels."""
    scene = generate_scene(n_views=8, n_points=256, seed=3, noise_px=noise_px)
    rng = np.random.default_rng(0)
    noisy_pts = scene.points3d + rng.normal(scale=0.02, size=(256, 3)).astype(np.float32)
    noisy_ts = np.asarray(scene.ts) + rng.normal(scale=0.01, size=(8, 3)).astype(np.float32)
    return scene, noisy_ts, noisy_pts


@pytest.fixture(scope="module")
def problems():
    """The noisy problem in both packages' flat layout; the port's converted
    from the JAX package's arrays, so both start from the same bits."""
    scene, noisy_ts, noisy_pts = _noisy_scene()
    jdense = jba.make_problem_from_scene(scene.Rs, noisy_ts, noisy_pts, scene.intr, scene.points2d, scene.visible)
    return jsp.from_dense(jdense), tsp.from_dense(interop.from_numpy(jdense)), jdense


def _pad(prob, pad, cat):
    """`prob` with `pad` padding rows (obs_ok False, pixels 123) appended."""
    return type(prob)(prob.cameras, prob.points, prob.intr, cat(prob.obs_cam, np.zeros(pad, np.int32)),
                      cat(prob.obs_pt, np.zeros(pad, np.int32)),
                      cat(prob.obs_uv, np.full((2, pad), 123.0, np.float32), 1),
                      cat(prob.obs_ok, np.zeros(pad, bool)))


def _tcat(a, b, dim=0):
    return torch.cat([a, T(b)], dim=dim)


# --- layout --------------------------------------------------------------------


def test_build_buckets_equal_arrays(rng):
    """A random observation list with padding rows scattered through it: the
    same idx_a / ok_a arrays, each camera's valid slots first, then its
    padding; build_buckets reads tensors as well as numpy."""
    C, P, N_ = 12, 50, 300
    obs_cam = rng.integers(0, C, N_).astype(np.int32)
    obs_pt = rng.integers(0, P, N_).astype(np.int32)
    obs_ok = rng.uniform(size=N_) > 0.2
    jb = jsp.build_buckets(obs_cam, obs_pt, obs_ok, C, P)
    tb = tsp.build_buckets(obs_cam, obs_pt, obs_ok, C, P, device=CPU)
    np.testing.assert_array_equal(N(tb.idx_a), np.asarray(jb.idx_a))
    np.testing.assert_array_equal(N(tb.ok_a), np.asarray(jb.ok_a))
    assert tb.idx_a.dtype == torch.int32 and tb.ok_a.dtype == torch.bool
    ok = N(tb.ok_a)
    assert (np.diff(ok.astype(int), axis=0) <= 0).all()  # per camera: valid slots, then padding
    assert ok.sum() == obs_ok.sum()
    tb2 = tsp.build_buckets(T(obs_cam), T(obs_pt), T(obs_ok), C, P, device=CPU)
    np.testing.assert_array_equal(N(tb2.idx_a), N(tb.idx_a))


def test_from_dense_equal_arrays(problems):
    """from_dense of the same dense problem: every field equal, capacity a
    multiple of 1024 with the padding rows last."""
    jp, tp, _ = problems
    assert tsp.SparseBAProblem._fields == jsp.SparseBAProblem._fields
    for f in jp._fields:
        np.testing.assert_array_equal(N(getattr(tp, f)), np.asarray(getattr(jp, f)), err_msg=f)
    ok = N(tp.obs_ok)
    n = ok.sum()
    assert len(ok) % 1024 == 0 and ok[:n].all() and not ok[n:].any()


@pytest.mark.parametrize("uv_rows", [True, False], ids=["uv_N2", "uv_2N"])
def test_make_sparse_problem(rng, uv_rows):
    """make_sparse_problem of the same poses and observations: cameras within
    1e-6 (log_so3 of the same rotations), the rest equal; uv taken as (N, 2)
    or (2, N) and stored (2, N)."""
    scene = generate_scene(n_views=5, n_points=40, seed=1)
    N_ = 64
    obs_cam = rng.integers(0, 5, N_).astype(np.int32)
    obs_pt = rng.integers(0, 40, N_).astype(np.int32)
    uv = rng.uniform(0, 640, (N_, 2)).astype(np.float32)
    obs_ok = rng.uniform(size=N_) > 0.3
    args = (scene.Rs, scene.ts, scene.points3d, scene.intr, obs_cam, obs_pt, uv if uv_rows else uv.T, obs_ok)
    jp = jsp.make_sparse_problem(*args)
    tp = tsp.make_sparse_problem(*args, device=CPU)
    np.testing.assert_allclose(N(tp.cameras), np.asarray(jp.cameras), atol=1e-6)
    for f in jp._fields[1:]:
        np.testing.assert_array_equal(N(getattr(tp, f)), np.asarray(getattr(jp, f)), err_msg=f)
    assert tp.obs_uv.shape == (2, N_)


def test_constructors_default_to_the_card():
    """Without `device`, make_sparse_problem and build_buckets ask for the
    card, and raise on a machine without one instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    z = np.zeros(4, np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsp.build_buckets(z, z, z > 0, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsp.make_sparse_problem(np.eye(3)[None], np.zeros((1, 3)), np.zeros((2, 3)), np.zeros(9), z, z,
                                np.zeros((4, 2)), z > 0)


def test_interop_carries_problem_buckets_and_result(problems):
    """from_numpy / to_numpy carry SparseBAProblem, ObsBuckets and
    SparseBAResult between the packages with their classes and bits."""
    jp, _, _ = problems
    jb = jsp.build_buckets(jp.obs_cam, jp.obs_pt, jp.obs_ok, 8, 256)
    jr = jsp.SparseBAResult(jp.cameras, jp.points, jnp.float32(2.0), jnp.float32(1.0))
    for j, cls in ((jp, tsp.SparseBAProblem), (jb, tsp.ObsBuckets), (jr, tsp.SparseBAResult)):
        t = interop.from_numpy(j)
        assert type(t) is cls
        back = interop.to_numpy(t)
        for f in j._fields:
            np.testing.assert_array_equal(getattr(back, f), np.asarray(getattr(j, f)), err_msg=f)


# --- forward model and Jacobians -------------------------------------------------


def _columns(rng, n=300, distortion=True):
    """Cameras and points as columns: small rotations, some rows under the
    small-angle branch (theta^2 < 1e-8) and rows with depth exactly 0 (the
    clamp at |z| < 1e-9)."""
    w = rng.normal(scale=0.2, size=(n, 3))
    w[:40] *= 1e-5  # theta^2 ~ 1e-10
    w[40:45] = 0.0
    t = rng.normal(scale=0.3, size=(n, 3)) + np.array([0.0, 0.0, 4.0])
    t[40:45] = 0.0
    X = rng.uniform(-1, 1, (n, 3))
    X[40:45, 2] = 0.0  # with w = 0, t = 0: Xc = X, depth 0
    intr = np.array([600, 610, 320, 240, -0.1, 0.02, 0.001, 0.001, -0.002] if distortion
                    else [600, 600, 320, 240, 0, 0, 0, 0, 0], np.float32)
    cam6 = np.concatenate([w, t], axis=1).astype(np.float32)
    return cam6, X.astype(np.float32), intr


def test_project_cf(rng):
    """_project_cf within 1e-4 px of the JAX package's; on the rows whose
    depth is clamped (pixels ~1e11) within rtol 1e-5."""
    cam6, X, intr = _columns(rng)
    pj = np.asarray(jsp._project_cf(J(cam6.T), J(X.T), J(intr)))
    pt = N(tsp._project_cf(T(cam6.T), T(X.T), T(intr)))
    assert pt.shape == (2, len(X))
    clamp = np.zeros(len(X), bool)
    clamp[40:45] = True
    np.testing.assert_allclose(pt[:, ~clamp], pj[:, ~clamp], rtol=0, atol=1e-4)
    np.testing.assert_allclose(pt[:, clamp], pj[:, clamp], rtol=1e-5)
    assert np.abs(pj[:, clamp]).max() > 1e9


def J(a):
    return jnp.asarray(np.asarray(a))


@pytest.mark.parametrize("distortion", [False, True])
def test_obs_residual_jac(rng, distortion):
    """r, Jc and Jp of a flat list (small-angle rows and 40 padding rows
    included) within rtol 1e-4, atol 1e-4 of each array's largest entry, of
    the JAX package's (jvp against the port's closed form); padding rows
    zero in both."""
    cam6, X, intr = _columns(rng, distortion=distortion)
    keep = np.ones(len(X), bool)
    keep[40:45] = False  # the clamped rows' Jacobians are ~1e20: held by the clamp test above
    cam6, X = cam6[keep], X[keep]
    C, n = 24, 360
    cams = cam6[:C]
    obs_cam = rng.integers(0, C, n).astype(np.int32)
    obs_pt = rng.integers(0, len(X), n).astype(np.int32)
    uv = rng.uniform(0, 640, (2, n)).astype(np.float32)
    obs_ok = np.ones(n, bool)
    obs_ok[-40:] = False
    rj, Jcj, Jpj = jsp._obs_residual_jac_cf(J(cams), J(X), J(intr), J(obs_cam), J(obs_pt), J(uv), J(obs_ok))
    rt, Jct, Jpt = tsp._obs_residual_jac(T(cams)[obs_cam], T(X)[obs_pt], T(uv.T), T(obs_ok), T(intr))
    for a, b, name in ((N(rt).T, rj, "r"), (N(Jct).transpose(1, 2, 0), Jcj, "Jc"),
                       (N(Jpt).transpose(1, 2, 0), Jpj, "Jp")):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max(), err_msg=name)
        assert not a[..., -40:].any() and not b[..., -40:].any()


def test_costs(problems):
    """sparse_cost and rms_reprojection_error within rtol 1e-5 of the JAX
    package's and of the port's dense cost on the same problem."""
    jp, tp, jdense = problems
    cj = float(jsp.sparse_cost(*jp))
    ct = float(tsp.sparse_cost(*tp))
    np.testing.assert_allclose(ct, cj, rtol=1e-5)
    np.testing.assert_allclose(ct, float(tba.cost(*interop.from_numpy(jdense))), rtol=1e-5)
    np.testing.assert_allclose(float(tsp.rms_reprojection_error(tp)), float(jsp.rms_reprojection_error(jp)),
                               rtol=1e-5)


def test_inv3x3(rng):
    """The adjugate inverse within rtol 1e-5 of the JAX package's, on
    symmetric positive blocks and on a zero block (determinant below the
    1e-30 guard: zero in both)."""
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    V = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    V[5] = 0.0
    vj = np.asarray(jsp._inv3x3_cf(J(V.transpose(1, 2, 0))))
    vt = N(tsp._inv3x3(T(V)))
    np.testing.assert_allclose(vt, vj.transpose(2, 0, 1), rtol=1e-5, atol=1e-6)
    assert not vt[5].any()
    np.testing.assert_allclose(vt[:5] @ V[:5], np.broadcast_to(np.eye(3), (5, 3, 3)), atol=1e-4)


def test_point_sums(rng):
    """Per-point sums over the buckets equal a float64 sum within 1e-6; a
    point with no observation sums to 0; padding slots are dropped."""
    P, M = 30, 400
    seg = rng.integers(0, P + 1, M)  # P: padding
    seg[seg == 7] = 8  # point 7 has no observation
    vals = rng.normal(size=(M, 4)).astype(np.float32)
    order = tsp._point_order(T(seg), P)
    got = N(tsp._point_sums(T(vals), order))
    ref = np.zeros((P + 1, 4))
    np.add.at(ref, seg, vals.astype(np.float64))
    np.testing.assert_allclose(got, ref[:P], atol=1e-6)
    assert not got[7].any()
    np.testing.assert_array_equal(N(order.offsets[1:P + 1] - order.offsets[:P]), np.bincount(seg, minlength=P + 1)[:P])


# --- the solver --------------------------------------------------------------------


def test_solve_sparse_pcg_step(problems):
    """One damped PCG step (lam 1e-3, 30 CG iterations, first camera and
    points 0-9 frozen) at the noisy problem: dcam and dpt within 1e-3 of the
    JAX package's step relative to its norm; the frozen parts zero."""
    jp, tp, _ = problems
    C, P = 8, 256
    lam = 1e-3
    cam_free = np.ones(C, bool)
    cam_free[0] = False
    pt_free = np.ones(P, bool)
    pt_free[:10] = False
    rj, Jcj, Jpj = jsp._obs_residual_jac_cf(*jp)
    jb = jsp.build_buckets(jp.obs_cam, jp.obs_pt, jp.obs_ok, C, P)
    dcj, dpj = jsp._solve_sparse_pcg(rj, Jcj, Jpj, jp.obs_cam, jp.obs_pt, jb, jnp.float32(lam), J(cam_free),
                                     J(pt_free), C, P, 30)
    tb = interop.from_numpy(jb)
    sl = tsp._bucket_slots(tp, tb)
    r, Jc, Jp = tsp._obs_residual_jac(tp.cameras[:, None], tp.points[sl.pt], sl.uv, sl.ok, tp.intr)
    dct, dpt, solved = tsp._solve_sparse_pcg(r, Jc, Jp, sl.pt, sl.order, torch.tensor(lam), T(cam_free), T(pt_free),
                                             30)
    assert bool(solved)
    for a, b in ((N(dct), np.asarray(dcj)), (N(dpt), np.asarray(dpj))):
        assert np.linalg.norm(a - b) <= 1e-3 * np.linalg.norm(b)
    assert not N(dct)[0].any() and not N(dpt)[:10].any()


def test_bundle_adjust_sparse_matches_jax(problems):
    """15 LM iterations on the noisy problem. The first iteration's cost
    (~0.5, far above float32 rounding) within rtol 1e-3 of the JAX package's;
    after 15 both at the rounding floor (below 1e-5, from ~2.4e4); cameras
    and points within 1e-4 of the JAX package's; the port's bits the same on
    a rerun."""
    jp, tp, _ = problems
    for k in (1, 15):
        jr = jsp.bundle_adjust_sparse(jp, n_iters=k)
        tr = tsp.bundle_adjust_sparse(tp, n_iters=k)
        np.testing.assert_allclose(float(tr.initial_cost), float(jr.initial_cost), rtol=1e-5)
        if k == 1:
            np.testing.assert_allclose(float(tr.final_cost), float(jr.final_cost), rtol=1e-3)
        else:
            assert float(tr.final_cost) < 1e-5 and float(jr.final_cost) < 1e-5
        np.testing.assert_allclose(N(tr.cameras), np.asarray(jr.cameras), atol=1e-4)
        np.testing.assert_allclose(N(tr.points), np.asarray(jr.points), atol=1e-4)
    again = tsp.bundle_adjust_sparse(tp, n_iters=15)
    assert torch.equal(again.cameras, tr.cameras) and torch.equal(again.points, tr.points)


def test_bundle_adjust_sparse_noisy_pixels():
    """The noisy problem with 0.5 px pixel noise, so the optimum's cost (about
    0.25 px^2 an observation) is well above float32 rounding: the final cost
    after 10 iterations within rtol 1e-3 of the JAX package's, and within 10%
    of the port's dense bundle_adjust (the same basin)."""
    scene, noisy_ts, noisy_pts = _noisy_scene(noise_px=0.5)
    args = (scene.Rs, noisy_ts, noisy_pts, scene.intr, scene.points2d, scene.visible)
    jr = jsp.bundle_adjust_sparse(jsp.from_dense(jba.make_problem_from_scene(*args)), n_iters=10)
    tdense = tba.make_problem_from_scene(*args)
    tr = tsp.bundle_adjust_sparse(tsp.from_dense(tdense), n_iters=10)
    np.testing.assert_allclose(float(tr.final_cost), float(jr.final_cost), rtol=1e-3)
    dense = tba.bundle_adjust(tdense, n_iters=10)
    assert abs(float(tr.final_cost) - float(dense.final_cost)) <= 0.1 * float(dense.final_cost)


def test_sparse_matches_dense(problems):
    """tests/test_ba_sparse.py::test_sparse_matches_dense on the port: both
    layouts reach the same basin (within 10%)."""
    _, tp, jdense = problems
    dense = tba.bundle_adjust(interop.from_numpy(jdense), n_iters=15)
    res = tsp.bundle_adjust_sparse(tp, n_iters=15)
    assert float(res.final_cost) < float(res.initial_cost) * 1e-2
    assert float(res.final_cost) <= float(dense.final_cost) * 1.1 + 1e-3


def test_sparse_fixed_first_camera(problems):
    _, tp, _ = problems
    res = tsp.bundle_adjust_sparse(tp, n_iters=5)
    np.testing.assert_allclose(N(res.cameras[0]), N(tp.cameras[0]), atol=1e-7)


def test_sparse_padding_rows_inert(problems):
    """512 padding rows (obs_ok False, pixels 123) change the cameras by at
    most 1e-5 and the final cost by rtol 1e-5, as in the JAX package."""
    _, tp, _ = problems
    tp2 = _pad(tp, 512, _tcat)
    r1 = tsp.bundle_adjust_sparse(tp, n_iters=5)
    r2 = tsp.bundle_adjust_sparse(tp2, n_iters=5)
    np.testing.assert_allclose(N(r1.cameras), N(r2.cameras), atol=1e-5)
    np.testing.assert_allclose(float(r1.final_cost), float(r2.final_cost), rtol=1e-5)


def test_points_without_observations_stay(problems):
    """cam_free / pt_free are honoured, and a point with no valid observation
    does not move: the same rule as the JAX package's."""
    _, tp, _ = problems
    ok = tp.obs_ok.clone()
    ok[tp.obs_pt == 3] = False  # point 3 loses every observation
    tp3 = tp._replace(obs_ok=ok)
    cam_free = torch.ones(8, dtype=torch.bool)
    cam_free[5] = False
    pt_free = torch.ones(256, dtype=torch.bool)
    pt_free[9] = False
    res = tsp.bundle_adjust_sparse(tp3, n_iters=3, cam_free=cam_free, pt_free=pt_free)
    assert torch.equal(res.points[[3, 9]], tp.points[[3, 9]])
    assert torch.equal(res.cameras[[0, 5]], tp.cameras[[0, 5]])
    assert float(res.final_cost) < 1e-2 * float(res.initial_cost)


def test_sparse_moderate_scale_cpu():
    """tests/test_ba_sparse.py::test_sparse_moderate_scale_cpu on the port:
    64 cameras x 4096 points x 8 observations a point (32,768 rows), pixels
    from the port's forward model, points with N(0, 0.01) noise; 8 LM
    iterations of 20 CG iterations take the cost below 1e-2 of its start."""
    rng = np.random.default_rng(1)
    C, P, k = 64, 4096, 8
    scene = generate_scene(n_views=C, n_points=64, seed=2)  # poses only
    pts = rng.uniform(-1, 1, (P, 3)).astype(np.float32)
    obs_cam = np.stack([rng.choice(C, k, replace=False) for _ in range(P)]).reshape(-1).astype(np.int32)
    obs_pt = np.repeat(np.arange(P, dtype=np.int32), k)
    cams6 = np.concatenate([np.asarray(jse3.log_so3(J(scene.Rs))), scene.ts], axis=1).astype(np.float32)
    uv = tsp._project_cf(T(cams6)[obs_cam].T, T(pts)[obs_pt].T, T(scene.intr))
    noisy = pts + rng.normal(scale=0.01, size=pts.shape).astype(np.float32)
    prob = tsp.SparseBAProblem(T(cams6), T(noisy), T(scene.intr), T(obs_cam), T(obs_pt), uv,
                               torch.ones(len(obs_cam), dtype=torch.bool))
    res = tsp.bundle_adjust_sparse(prob, n_iters=8, n_cg=20)
    assert float(res.final_cost) < float(res.initial_cost) * 1e-2
