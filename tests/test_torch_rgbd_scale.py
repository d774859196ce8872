"""Parity of the port's KinFu-at-scale modules (opencv_contrib_tpu_torch.rgbd:
hash_tsdf, kinfu.HashKinFu, posegraph, submap.LargeKinFu) with the JAX
package on the CPU, at tests/test_rgbd_scale.py's and tests/test_rgbd.py's
sizes: 120x160 depth frames rendered by the JAX `sdf_scene` and fed to both
packages, hash pools of up to 8,192 blocks, 96^3 submaps. JAX state crosses
into the port through `interop.from_numpy`; each comparison starts from one
state.

Tolerances:
- hash_tsdf.allocate: the key sets are equal except at most max(2, 0.1%) of
  the blocks (a point on a block boundary may floor into the neighbour when
  the two einsums round differently); integrate: TSDF and weights within
  1e-5 on the keys both hold; sample: equal; raycast: the valid masks agree
  except max(2, 1e-3) of the pixels, points within 1e-4 m and normals within
  1e-3 where both are valid; a pool too small for the frame keeps the same
  keys (the merge keeps the smallest keys, as the JAX package does).
- HashKinFu, 4 ticks: poses within 1e-4 on every frame (matrix entries),
  and the block counts within max(2, 0.1%).
- posegraph: Jacobians within 1e-4 of `jax.jacfwd` wherever the JAX ones are
  finite (random edges and identity edges), and finite there;
  optimize: poses within 1e-4 and costs within rtol 1e-4, on
  tests/test_rgbd.py's three ring graphs and on one with a node of four edges.
- LargeKinFu: from the JAX state before each frame, the same tracking flag,
  the same submap created at the same frame, and the pose within 1e-4; run
  on its own, the same submap count and creation frames, and the pose
  within 2e-3 of the JAX run's (the bilateral filter's ulp differences,
  tests/test_torch_rgbd.py, grow over ICP's iterations); optimize_pose_graph
  from one state: costs within rtol 1e-4 (atol 1e-10 where a consistent
  graph's cost is 0 up to float32 rounding; the final cost of the perturbed
  loop within rtol 1e-3, see the test) and submap poses within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu.core import se3 as jse3
from opencv_contrib_tpu.rgbd import hash_tsdf as jht
from opencv_contrib_tpu.rgbd import kinfu as jkinfu
from opencv_contrib_tpu.rgbd import posegraph as jpg
from opencv_contrib_tpu.rgbd import submap as jsub
from opencv_contrib_tpu.utils import sdf_scene as jscene
from opencv_contrib_tpu_torch import entry, interop
from opencv_contrib_tpu_torch.rgbd import hash_tsdf as tht
from opencv_contrib_tpu_torch.rgbd import kinfu as tkinfu
from opencv_contrib_tpu_torch.rgbd import posegraph as tpg
from opencv_contrib_tpu_torch.rgbd import submap as tsub

torch.set_num_threads(1)

INTR = np.array([120.0, 120.0, 80.0, 60.0, 0, 0, 0, 0, 0], np.float32)  # tests/test_rgbd_scale.py:12
SHAPE = (120, 160)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def J(a):
    return jnp.asarray(np.asarray(a))


def _render(poses):
    return [np.asarray(jscene.render_depth(J(p), J(INTR), shape=SHAPE)) for p in poses]


def _cw(pose):
    return np.asarray(jse3.inverse(J(pose)))


def _to_port(x):
    return interop.from_numpy(jax.tree_util.tree_map(np.asarray, x))


# --- hash_tsdf ---------------------------------------------------------------


@pytest.fixture(scope="module")
def frames01():
    """Frames 0 and 1 of tests/test_rgbd_scale.py's orbit and their poses."""
    poses = jscene.orbit_poses(2, sweep=0.3)
    return [_cw(p) for p in poses], _render(poses)


@pytest.fixture(scope="module")
def pools(frames01):
    """JAX pools at 3 cm voxels: frame 0 allocated, then integrated."""
    (T0, _), (d0, _) = frames01
    vol = jht.allocate(jht.create(capacity=8192, voxel_size=0.03), J(d0), J(INTR), J(T0))
    return vol, jht.integrate(vol, J(d0), J(INTR), J(T0))


def _assert_keys_agree(kt, kj, n):
    kt, kj = set(kt.tolist()), set(kj.tolist())
    assert len(kt ^ kj) <= max(2, 1e-3 * n), len(kt ^ kj)


@pytest.mark.parametrize("start", ["empty", "after_frame0"])
def test_allocate_matches_jax(frames01, pools, start):
    """From an empty pool (frame 0) and from the integrated frame-0 pool
    (frame 1, merging into held blocks)."""
    (T0, T1), (d0, d1) = frames01
    if start == "empty":
        vj, Tcw, d = jht.create(capacity=8192, voxel_size=0.03), T0, d0
    else:
        vj, Tcw, d = pools[1], T1, d1
    oj = jht.allocate(vj, J(d), J(INTR), J(Tcw))
    ot = tht.allocate(_to_port(vj), T(d), T(INTR), T(Tcw))
    n = int(oj.active.sum())
    assert n > 200
    aj, at = np.asarray(oj.active), N(ot.active)
    kj, kt = np.asarray(oj.keys)[aj], N(ot.keys)[at]
    _assert_keys_agree(kt, kj, n)
    assert (np.diff(N(ot.keys).astype(np.int64)) >= 0).all()
    # a shared block has the same coordinates, and carries its data to its new slot
    held = {k: (c, w) for k, c, w in zip(kj.tolist(), np.asarray(oj.coords)[aj], np.asarray(oj.weight)[aj])}
    for k, c, w in zip(kt.tolist(), N(ot.coords)[at], N(ot.weight)[at]):
        if k in held:
            np.testing.assert_array_equal(c, held[k][0])
            np.testing.assert_array_equal(w, held[k][1])


def test_integrate_matches_jax(frames01, pools):
    (_, T1), (_, d1) = frames01
    vj = jht.allocate(pools[1], J(d1), J(INTR), J(T1))  # frame 1 fuses into weighted blocks and new ones
    oj = jht.integrate(vj, J(d1), J(INTR), J(T1))
    ot = tht.integrate(_to_port(vj), T(d1), T(INTR), T(T1))
    assert type(ot) is tht.HashTSDF and float(ot.weight.max()) == 2.0
    np.testing.assert_allclose(N(ot.weight), np.asarray(oj.weight), atol=1e-5)
    np.testing.assert_allclose(N(ot.tsdf), np.asarray(oj.tsdf), atol=1e-5)


def test_sample_matches_jax(pools, rng):
    vj = pools[1]
    active = np.asarray(vj.coords)[np.asarray(vj.active)]
    lo, hi = active.min(0) * tht.B * 0.03, (active.max(0) + 1) * tht.B * 0.03
    pts = rng.uniform(lo - 0.1, hi + 0.1, size=(4000, 3)).astype(np.float32)
    fj, okj = jht.sample(vj, J(pts))
    ft, okt = tht.sample(_to_port(vj), T(pts))
    assert 100 < int(okj.sum()) < 4000
    np.testing.assert_array_equal(N(okt), np.asarray(okj))
    np.testing.assert_array_equal(N(ft), np.asarray(fj))
    assert not bool(tht.sample(tht.create(64), T([[0.5, 0.5, 0.5]]))[1][0])  # a miss is invalid


@pytest.mark.parametrize("pose", ["frame0", "frame1"])
def test_raycast_matches_jax(frames01, pools, pose):
    Tcw = frames01[0][0 if pose == "frame0" else 1]
    pj, nj, vj = (np.asarray(a) for a in jht.raycast(pools[1], J(INTR), J(Tcw), shape=SHAPE))
    pt, nt, vt = (N(a) for a in tht.raycast(_to_port(pools[1]), T(INTR), T(Tcw), shape=SHAPE))
    assert vj.mean() > 0.2
    assert (vt != vj).sum() <= max(2, 1e-3 * vj.size), (vt != vj).sum()
    both = vt & vj
    np.testing.assert_allclose(pt[both], pj[both], atol=1e-4)
    np.testing.assert_allclose(nt[both], nj[both], atol=1e-3)


def test_capacity_overflow_keeps_the_same_keys(frames01):
    """tests/test_rgbd_scale.py:57-64: a 128-block pool is too small for
    the frame; the merge keeps the smallest keys in both packages."""
    (T0, T1), (d0, d1) = frames01
    vj = jht.allocate(jht.create(capacity=128, voxel_size=0.04), J(d0), J(INTR), J(T0))
    vt = tht.allocate(tht.create(128, 0.04), T(d0), T(INTR), T(T0))
    assert int(vt.active.sum()) == int(vj.active.sum()) == 128
    np.testing.assert_array_equal(N(vt.keys), np.asarray(vj.keys))
    vj = jht.integrate(vj, J(d0), J(INTR), J(T0))
    vt = tht.integrate(vt, T(d0), T(INTR), T(T0))
    # a second frame into the full pool evicts held blocks with large keys
    oj = jht.allocate(vj, J(d1), J(INTR), J(T1))
    ot = tht.allocate(vt, T(d1), T(INTR), T(T1))
    np.testing.assert_array_equal(N(ot.keys), np.asarray(oj.keys))
    np.testing.assert_array_equal(N(ot.weight), np.asarray(oj.weight))
    assert np.isfinite(N(tht.integrate(ot, T(d1), T(INTR), T(T1)).tsdf)).all()


# --- HashKinFu ---------------------------------------------------------------


def _hash_params(module):
    p = module.KinFuParams.default(INTR, SHAPE)  # tests/test_rgbd_scale.py:122-124
    p.volume_resolution = (96, 96, 96)
    p.volume_size = 3.2
    return p


@pytest.fixture(scope="module")
def orbit_depths():
    poses = jscene.orbit_poses(8, sweep=0.5)
    return poses, _render(poses[:6])


def test_hash_kinfu_matches_jax(orbit_depths):
    _, depths = orbit_depths
    kj = jkinfu.HashKinFu(_hash_params(jkinfu), capacity=4096)
    kt = tkinfu.HashKinFu(_hash_params(tkinfu), capacity=4096, device="cpu")
    for d in depths[:5]:  # the first frame and 4 ticks
        assert kj.update(d) and kt.update(d)
        np.testing.assert_allclose(N(kt.T_cw), np.asarray(kj.T_cw), atol=1e-4)
        nj, nt = kj.n_active_blocks(), kt.n_active_blocks()
        assert abs(nt - nj) <= max(2, 1e-3 * nj) and 0 < nt < 4096, (nt, nj)
    # and the state crosses: one more tick from the JAX state
    kt.volume, kt.model_pyr, kt.T_cw = _to_port(kj.volume), _to_port(kj.model_pyr), _to_port(kj.T_cw)
    assert type(kt.volume) is tht.HashTSDF
    assert kj.update(depths[5]) and kt.update(depths[5])
    np.testing.assert_allclose(N(kt.T_cw), np.asarray(kj.T_cw), atol=1e-4)
    assert kt.n_active_blocks() == kj.n_active_blocks()


def test_hash_kinfu_track_entry(orbit_depths):
    """entry.hash_kinfu_track runs the same ticks as HashKinFu.update and
    keeps the flags and block counts on the device until read."""
    _, depths = orbit_depths
    out = entry.hash_kinfu_track(np.stack(depths[:3]), INTR, frame_shape=SHAPE, voxel_size=3.2 / 96,
                                 capacity=4096, device="cpu")
    assert tuple(out.T_cw.shape) == (3, 4, 4) and out.ok.dtype == torch.bool and bool(out.ok.all())
    kf = tkinfu.HashKinFu(_hash_params(tkinfu), capacity=4096, device="cpu")
    for d in depths[:3]:
        kf.update(d)
    np.testing.assert_array_equal(N(out.T_cw[-1]), N(kf.T_cw))
    assert N(out.n_active).tolist()[-1] == kf.n_active_blocks() and (np.diff(N(out.n_active)) >= 0).all()


# --- posegraph ---------------------------------------------------------------


def _ring_graph(n=12, noise=0.05, seed=0):
    """tests/test_rgbd.py::TestPoseGraph._ring_graph: a ring of poses with
    noisy odometry edges and an exact loop closure."""
    rng = np.random.default_rng(seed)
    gt = np.stack([np.asarray(jse3.exp_se3(jnp.asarray([0, a, 0, np.cos(a), 0, np.sin(a)], dtype=np.float32)))
                   for a in 2 * np.pi * np.arange(n) / n])
    edges_ij, edges_T = [], []
    for k in range(n):
        j = (k + 1) % n
        T_rel = np.asarray(jse3.inverse(J(gt[k])) @ J(gt[j]))
        if j != 0:
            T_rel = np.asarray(jse3.exp_se3(J(rng.normal(scale=noise, size=6).astype(np.float32)))) @ T_rel
        edges_ij.append([k, j])
        edges_T.append(T_rel)
    init = [gt[0]]
    for k in range(n - 1):
        init.append(init[-1] @ edges_T[k])
    return gt, np.stack(init), np.array(edges_ij), np.stack(edges_T)


def _jax_jacobians(Ti, Tj, Tm):
    """The JAX package's optimize: jax.jacfwd of the edge residual at 0."""
    def one(Ti_, Tj_, Tm_):
        def res(xi_i, xi_j):
            return jpg.edge_residual(jse3.exp_se3(xi_i) @ Ti_, jse3.exp_se3(xi_j) @ Tj_, Tm_)

        z = jnp.zeros(6)
        return (res(z, z),) + jax.jacfwd(res, argnums=(0, 1))(z, z)

    return [np.asarray(a) for a in jax.vmap(one)(J(Ti), J(Tj), J(Tm))]


def test_posegraph_jacobians_match_jax(rng):
    E = 6
    Ts = [np.array(jse3.exp_se3(J(rng.normal(scale=0.5, size=(E, 6)).astype(np.float32)))) for _ in range(3)]
    Ti, Tj, Tm = Ts
    Ti[0] = Tj[0] = Tm[0] = np.eye(4, dtype=np.float32)  # an identity edge
    Tm[1] = np.asarray(jse3.inverse(J(Ti[1])) @ J(Tj[1]))  # a consistent edge: residual 0 up to rounding
    rj, Jij, Jjj = _jax_jacobians(Ti, Tj, Tm)
    g = tpg.make_graph(np.concatenate([Ti, Tj]), np.stack([np.arange(E), np.arange(E) + E], 1), Tm, device="cpu")
    rt, Jit, Jjt = (N(a) for a in tpg._residuals_and_jac(g, g.poses))
    np.testing.assert_allclose(rt, rj, atol=1e-5)
    for jt, jj in ((Jit, Jij), (Jjt, Jjj)):
        fin = np.isfinite(jj)
        assert fin[:2].all() and np.isfinite(jt[fin]).all()
        np.testing.assert_allclose(jt[fin], jj[fin], atol=1e-4)


def _graphs():
    gt, init, eij, eT = _ring_graph()
    valid = np.concatenate([np.ones(len(eij), bool), [False]])
    rng = np.random.default_rng(3)
    extra = np.array([[3, 7], [3, 9], [3, 0]])  # node 3: four edges
    extra_T = np.stack([np.asarray(jse3.exp_se3(J(rng.normal(scale=0.02, size=6).astype(np.float32))))
                        @ np.asarray(jse3.inverse(J(gt[a])) @ J(gt[b])) for a, b in extra])
    return {"loop_closure": ((init, eij, eT), {}, 30),
            "fixed_node": ((init, eij, eT), {}, 10),
            "invalid_edge": ((init, np.concatenate([eij, [[0, 5]]]),
                              np.concatenate([eT, [np.eye(4, dtype=np.float32)]])), {"edges_valid": valid}, 15),
            "shared_node": ((init, np.concatenate([eij, extra]), np.concatenate([eT, extra_T])), {}, 30)}


@pytest.mark.parametrize("name", ["loop_closure", "fixed_node", "invalid_edge", "shared_node"])
def test_posegraph_optimize_matches_jax(name):
    args, kw, iters = _graphs()[name]
    gj, cj = jpg.optimize(jpg.make_graph(*args, **kw), n_iters=iters)
    gt_ = tpg.make_graph(*args, device="cpu", **kw)
    assert type(_to_port(jpg.make_graph(*args, **kw))) is tpg.PoseGraph
    g2, ct = tpg.optimize(gt_, n_iters=iters)
    np.testing.assert_allclose(N(ct), np.asarray(cj), rtol=1e-4)
    np.testing.assert_allclose(N(g2.poses), np.asarray(gj.poses), atol=1e-4)
    np.testing.assert_array_equal(N(g2.poses[0]), args[0][0])  # the gauge-fixed node stays
    assert float(ct[1]) < float(ct[0]) * (0.1 if name != "fixed_node" else 1.0)


# --- LargeKinFu ---------------------------------------------------------------


def _carry(lj, lt):
    """The JAX LargeKinFu's state, carried into the port's (Submap and the
    constraints hold host numpy and cross as they are)."""
    lt.submaps = [tsub.Submap(index=s.index, T_ws=np.array(s.T_ws), volume=_to_port(s.volume), n_frames=s.n_frames,
                              constraints={k: (np.array(v[0]), v[1]) for k, v in s.constraints.items()})
                  for s in lj.submaps]
    lt.active = lt.submaps[lj.active.index]
    lt.T_cw = _to_port(lj.T_cw)
    lt.model_pyr = _to_port(lj.model_pyr) if lj.model_pyr is not None else None
    lt.frame_count = lj.frame_count


ORBITS = {  # tests/test_rgbd_scale.py:67-104, cut to 6 frames with the gate lowered so that submaps still form
    "wide": dict(n=10, sweep=1.2, frames=6, max_dist_from_center=0.2, min_frames_per_submap=5),
    "loop": dict(n=8, sweep=1.0, frames=8, max_dist_from_center=0.3, min_frames_per_submap=2),
}


def _large(module, orbit, **kw):
    o = ORBITS[orbit]
    p = module.LargeKinFuParams(intr=INTR, frame_shape=SHAPE)
    p.max_dist_from_center = o["max_dist_from_center"]
    p.min_frames_per_submap = o["min_frames_per_submap"]
    return module.LargeKinFu(p, **kw)


@pytest.fixture(scope="module")
def large_runs():
    """Per orbit: the depths, the JAX tracker after every frame (with the
    port's tick from its state before each frame), and the submap counts."""
    out = {}
    for name, o in ORBITS.items():
        depths = _render(jscene.orbit_poses(o["n"], sweep=o["sweep"])[:o["frames"]])
        lj, lt = _large(jsub, name), _large(tsub, name, device="cpu")
        steps = []
        for d in depths:
            _carry(lj, lt)
            okt = lt.update(d)
            okj = lj.update(d)
            steps.append((okj, okt, len(lj.submaps), len(lt.submaps), np.asarray(lj.pose), lt.pose))
        out[name] = (depths, lj, steps)
    return out


@pytest.mark.parametrize("orbit", ["wide", "loop"])
def test_large_kinfu_tick_from_jax_state(large_runs, orbit):
    _, lj, steps = large_runs[orbit]
    for i, (okj, okt, nj, nt, Pj, Pt) in enumerate(steps):
        assert okj is okt is True, i
        assert nj == nt, (i, nj, nt)
        np.testing.assert_allclose(Pt, Pj, atol=1e-4, err_msg=f"frame {i}")
    assert len(lj.submaps) >= 2


@pytest.mark.parametrize("orbit", ["wide", "loop"])
def test_large_kinfu_orbit_matches_jax(large_runs, orbit):
    """The port on its own over the orbit, through entry.large_kinfu_track."""
    depths, lj, steps = large_runs[orbit]
    o = ORBITS[orbit]
    out = entry.large_kinfu_track(np.stack(depths), INTR, frame_shape=SHAPE, device="cpu",
                                  max_dist_from_center=o["max_dist_from_center"],
                                  min_frames_per_submap=o["min_frames_per_submap"])
    assert all(out.ok)
    assert out.n_submaps == [s[2] for s in steps]  # the same submaps, created at the same frames
    np.testing.assert_allclose(out.tracker.pose, np.asarray(lj.pose), atol=2e-3)
    np.testing.assert_allclose(N(out.T_cw[-1]), N(out.tracker.T_cw))


@pytest.mark.parametrize("loop", ["consistent", "perturbed"])
def test_optimize_pose_graph_matches_jax(large_runs, loop):
    """tests/test_rgbd_scale.py:96-101's loop constraint (first -> last
    submap from the current estimates), and the same perturbed by 0.02 rad /
    3 cm so that the costs are not 0; both packages from the JAX state."""
    _, lj, _ = large_runs["loop"]
    lj = _copy_large(lj)
    lt = _large(tsub, "loop", device="cpu")
    _carry(lj, lt)
    i, j = 0, len(lj.submaps) - 1
    T_rel = np.asarray(jse3.inverse(J(lj.submaps[i].T_ws)) @ J(lj.submaps[j].T_ws))
    if loop == "perturbed":
        T_rel = np.asarray(jse3.exp_se3(J(np.array([0.02, -0.01, 0.01, 0.03, 0.0, -0.02], np.float32)))) @ T_rel
    lj.add_loop_constraint(i, j, T_rel, weight=2.0)
    lt.add_loop_constraint(i, j, T_rel, weight=2.0)
    cj = lj.optimize_pose_graph(n_iters=15)
    ct = lt.optimize_pose_graph(n_iters=15)
    np.testing.assert_allclose(ct[0], cj[0], rtol=1e-4, atol=1e-10)
    # perturbed: the first LM step takes the cost from 1.8e-3 to 3.8e-4; the
    # later steps change it by 1e-4 of itself or less, and f32 rounding in H
    # decides their accept / reject in either package
    np.testing.assert_allclose(ct[1], cj[1], rtol=1e-4 if loop == "consistent" else 1e-3, atol=1e-10)
    assert ct[1] <= ct[0] + 1e-6 and (loop == "consistent" or ct[0] > 1e-4)
    for sj, st in zip(lj.submaps, lt.submaps):
        np.testing.assert_allclose(st.T_ws, sj.T_ws, atol=1e-4)


def _copy_large(lj):
    """A JAX LargeKinFu whose submaps are copies (the optimisation rewrites
    their poses)."""
    import copy

    out = copy.copy(lj)
    out.submaps = [copy.copy(s) for s in lj.submaps]
    for s in out.submaps:
        s.constraints = dict(s.constraints)
    out.active = out.submaps[lj.active.index]
    return out
