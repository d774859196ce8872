"""Parity of the port's 5k-view sequential SfM driver
(opencv_contrib_tpu_torch.sfm.pipeline_scale, with
utils.synthetic.generate_sequence_scene and utils.metrics' trajectory
metrics) with the JAX package on the CPU.

Inputs are made with numpy from a seed; a JAX MapState crosses into the port
through `interop.from_numpy`. The RANSAC draws of the two packages come from
different generators, so the parity tests record the JAX package's draws in
execution order and replay them into the port. The JAX package draws inside
its jitted chunk programs (a `lax.scan`), where the spy meets tracers, so the
spy records through an ordered `jax.debug.callback`, once per executed step.

Tolerances:
- generate_sequence_scene: every array equal bit for bit; ate_rmse,
  umeyama_align and rpe within 1e-6; build_track_major equal.
- one call of each device function from the same MapState: poses and points
  within 1e-4, reprojection errors and costs within rtol 1e-3 (1e-4 px
  absolute), masks, counts and flags equal.
- _init_two_view with replayed draws: the same return value, the same masks,
  first-sighting table and log, poses and points within 1e-4.
- reconstruct_sequential replayed on the noise-free 64 x 48 scene and on a
  copy with 14 views blanked (re-initialisation): the same log, reg_order,
  registered and n_segments, mean reprojection within 1e-3 px, points within
  1e-3 RMS after a similarity alignment. On the 96 x 48 scene with 0.3 px
  noise the replay parts where the ring closes (views 88-95 triangulate
  tracks first seen at view 0 under drifted poses; f32 rounding amplified by
  near-parallel triangulation decides 3 of them near the 4 px gate): the
  same reg_order, registered, n_segments and log events (kind and view),
  fail counts within 3, points within 1% of the tracks, mean reprojection
  within 5e-3 px, points within 0.05 RMS after a similarity alignment, both
  ATEs under tests/test_sfm_scale.py's 0.3 (ROADMAP Queue 3).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu.mvg import robust as jrob
from opencv_contrib_tpu.sfm import pipeline_scale as jps
from opencv_contrib_tpu.utils import metrics as jmet
from opencv_contrib_tpu.utils.synthetic import generate_sequence_scene as jgen
from opencv_contrib_tpu_torch import entry, interop
from opencv_contrib_tpu_torch.mvg import robust as trob
from opencv_contrib_tpu_torch.sfm import pipeline_scale as tps
from opencv_contrib_tpu_torch.utils import metrics as tmet
from opencv_contrib_tpu_torch.utils.synthetic import generate_sequence_scene as tgen

# The suite runs several worker processes beside XLA's thread pools; at
# these sizes torch's own per-process OpenMP pool only oversubscribes the CPU.
torch.set_num_threads(1)
CPU = "cpu"
SCENE = dict(n_views=64, slots_per_view=48, track_span=10, seed=1, noise_px=0.0)  # test_sfm_scale's noise-free
RUN = dict(window=12, ba_every=3, min_gap=2)  # tests/test_sfm_scale.py's driver settings
POINTS_ATOL = 1e-3  # a point's depth along near-parallel rays amplifies rounding: 1e-4 of the scene's 10 units


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def J(a):
    return jnp.asarray(np.asarray(a))


def _centers(Rs, ts):
    return np.einsum("vij,vi->vj", Rs, -ts)


def _aligned_rms(A, B):
    """RMS of A - B after the similarity alignment of A onto B."""
    s, R, t = tmet.umeyama_align(A.astype(np.float64), B.astype(np.float64))
    return float(np.sqrt((((s * (R @ A.T)).T + t - B) ** 2).sum(axis=1).mean()))


# --- replayed RANSAC draws -----------------------------------------------------


class Draws:
    """The JAX package's `sample_indices` results in execution order, each
    with the mask it drew under; `replay` feeds them to the port in the same
    order."""

    def __init__(self):
        self.calls = []

    def spy(self, orig):
        def spy(key, n_points, mask, n_hypotheses, sample_size):
            idx = orig(key, n_points, mask, n_hypotheses, sample_size)
            jax.debug.callback(self._append, mask, idx, ordered=True)
            return idx

        return spy

    def _append(self, mask, idx):
        self.calls.append((np.array(mask), np.array(idx)))

    @contextlib.contextmanager
    def record(self):
        self.calls = []
        yield self
        jax.effects_barrier()

    @contextlib.contextmanager
    def replay(self, strict: bool = True):
        """With `strict`, each draw's mask must equal the JAX package's (the
        same state draws the same samples); otherwise the draws whose masks
        differ are counted in the yielded list."""
        calls = iter(self.calls)
        parted = []

        def replayed(generator, n_points, mask, n_hypotheses, sample_size):
            jmask, idx = next(calls)
            assert idx.shape == (n_hypotheses, sample_size)
            if strict:
                np.testing.assert_array_equal(N(mask), jmask)
            elif not np.array_equal(N(mask), jmask):
                parted.append(len(parted))
            return torch.from_numpy(idx.astype(np.int64)).to(mask.device)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(trob, "sample_indices", replayed)
            yield parted
        assert next(calls, None) is None, "the port drew fewer times than the JAX package"


@pytest.fixture(scope="module")
def draws():
    """The spy stays installed for the module. The compiled programs are
    dropped before and after it, so every program that draws here is traced
    with the spy, and none traced with it outlives the module."""
    d = Draws()
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrob, "sample_indices", d.spy(jrob.sample_indices))
        yield d
    jax.clear_caches()


# --- scene generator, metrics, track-major table -----------------------------------


SEQ_CASES = {"shapes_96x48": dict(n_views=96, slots_per_view=48, track_span=10, seed=3),
             "exact_32x32": dict(n_views=32, slots_per_view=32, track_span=8, seed=0, noise_px=0.0),
             "wrap_24x40": dict(n_views=24, slots_per_view=40, track_span=12, seed=7, noise_px=0.5)}


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_generate_sequence_scene_bit_equal(case):
    """tests/test_sfm_scale.py's two scenes and a short noisy ring whose
    tracks wrap past 2 pi: every array equal bit for bit, the same dtypes."""
    js, ts = jgen(**SEQ_CASES[case]), tgen(**SEQ_CASES[case])
    assert type(ts).__name__ == type(js).__name__ and ts._fields == js._fields
    for f in js._fields:
        a, b = getattr(js, f), getattr(ts, f)
        if f == "n_tracks":
            assert a == b
        else:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)
    if case.startswith("wrap"):
        first, last = set(ts.tid[0][ts.ok[0]]), set(ts.tid[-1][ts.ok[-1]])
        assert first & last, "no track spans the ring's seam"


def test_track_ids_unique_within_a_view():
    """The driver's scatters rely on it: a view's valid slots hold distinct
    tracks, so their write order does not matter."""
    for kw in (SCENE, SEQ_CASES["wrap_24x40"], dict(n_views=96, slots_per_view=48, track_span=10, seed=0,
                                                    noise_px=0.3)):
        sc = tgen(**kw)
        for v in range(sc.tid.shape[0]):
            t = sc.tid[v][sc.ok[v]]
            assert len(np.unique(t)) == len(t)


def test_trajectory_metrics(rng):
    """umeyama_align, ate_rmse (centers and 4x4 poses, aligned or not) and
    rpe within 1e-6 of the JAX package's."""
    A = rng.normal(size=(40, 3))
    ang = 0.3
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    B = 1.7 * A @ R.T + np.array([0.5, -1.0, 2.0]) + rng.normal(scale=0.01, size=A.shape)
    for ws in (True, False):
        for a, b in zip(tmet.umeyama_align(A, B, with_scale=ws), jmet.umeyama_align(A, B, with_scale=ws)):
            np.testing.assert_allclose(a, b, atol=1e-6)
    poses = np.tile(np.eye(4), (40, 1, 1))
    poses[:, :3, 3] = A
    gt = poses.copy()
    gt[:, :3, 3] = B
    gt[:, :3, :3] = R
    for align in (True, False):
        np.testing.assert_allclose(tmet.ate_rmse(A, B, align), jmet.ate_rmse(A, B, align), atol=1e-6)
        np.testing.assert_allclose(tmet.ate_rmse(poses, gt, align), jmet.ate_rmse(poses, gt, align), atol=1e-6)
    for delta in (1, 3):
        np.testing.assert_allclose(tmet.rpe(poses, gt, delta), jmet.rpe(poses, gt, delta), atol=1e-6)


def test_build_track_major_equal():
    sc = tgen(**SEQ_CASES["wrap_24x40"])
    tr = tps.from_sequence_scene(sc)
    for a, b in zip(tps.build_track_major(tr), jps.build_track_major(jps.from_sequence_scene(sc))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# --- one call of each device function from the same MapState -----------------------


@pytest.fixture(scope="module")
def state():
    """A MapState of the noise-free 64 x 48 scene with views 0-19 registered
    (true poses plus N(0, 0.01) translation noise) and the tracks they see
    twice reconstructed (true points plus N(0, 0.02)), its first-sighting
    table filled from those views; in both packages."""
    sc = tgen(**SCENE)
    rng = np.random.default_rng(11)
    V, K = sc.tid.shape
    Tn, n_reg = sc.n_tracks, 20
    reg = np.arange(V) < n_reg
    Rs = np.where(reg[:, None, None], sc.Rs, np.eye(3, dtype=np.float32)).astype(np.float32)
    ts = np.where(reg[:, None], sc.ts + rng.normal(scale=0.01, size=sc.ts.shape), 0).astype(np.float32)
    seen = np.zeros(Tn, np.int64)
    first_view = np.full(Tn, -1, np.int32)
    first_uv = np.zeros((Tn, 2), np.float32)
    for v in range(n_reg - 1, -1, -1):
        t = sc.tid[v][sc.ok[v]]
        seen[t] += 1
        first_view[t] = v
        first_uv[t] = sc.uv[v][sc.ok[v]]
    has_point = seen >= 2
    points = np.where(has_point[:, None], sc.points3d + rng.normal(scale=0.02, size=sc.points3d.shape), 0)
    jst = jps.MapState(Rs=J(Rs), ts=J(ts), registered=J(reg), seg_of_view=J(np.where(reg, 0, -1).astype(np.int32)),
                       points=J(points.astype(np.float32)), has_point=J(has_point),
                       seg_of_point=J(np.where(has_point, 0, -1).astype(np.int32)), first_view=J(first_view),
                       first_uv=J(first_uv))
    tst = interop.from_numpy(jst)
    assert isinstance(tst, tps.MapState)
    assert [x.dtype for x in tst] == [torch.float32, torch.float32, torch.bool, torch.int32, torch.float32,
                                      torch.bool, torch.int32, torch.int32, torch.float32]
    return sc, n_reg, jst, tst


def _assert_states(tst, jst):
    for f in jst._fields:
        a, b = N(getattr(tst, f)), np.asarray(getattr(jst, f))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=POINTS_ATOL if f == "points" else 1e-4, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_register_core_replayed(state, draws):
    """The next view from the map's points, the last registered pose as the
    prior: R, t within 1e-4, the inlier count equal."""
    sc, v, jst, tst = state
    tid = sc.tid[v]
    have = sc.ok[v] & np.asarray(jst.has_point)[tid]
    X = np.asarray(jst.points)[tid]
    args = (X, sc.uv[v], have, sc.intr, np.asarray(jst.Rs)[v - 1], np.asarray(jst.ts)[v - 1])
    with draws.record():
        Rj, tj, nj = jps._register_core(jax.random.PRNGKey(3), *map(J, args))
    assert len(draws.calls) == 1
    with draws.replay():
        Rt, tt, nt = tps._register_core(None, *map(T, args))
    np.testing.assert_allclose(N(Rt), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(N(tt), np.asarray(tj), atol=1e-4)
    assert int(nt) == int(nj) >= 20


def test_triangulate_core(state):
    """Tracks of view 20 seen first at least 2 views before it, against its
    true pose: the points accepted by the same rule, within 1e-4."""
    sc, v, jst, tst = state
    tid = sc.tid[v]
    fv = np.asarray(jst.first_view)[tid]
    cand = sc.ok[v] & (fv >= 0) & (fv <= v - 2)
    fs = np.maximum(fv, 0)
    args = (np.asarray(jst.first_uv)[tid], sc.uv[v], np.asarray(jst.Rs)[fs], np.asarray(jst.ts)[fs], sc.Rs[v],
            sc.ts[v], cand, sc.intr)
    max_err_n, min_par_cos = np.float32(4.0 / sc.intr[0]), np.float32(np.cos(np.radians(1.0)))
    Xj, aj = jps._triangulate_core(*map(J, args), J(max_err_n), J(min_par_cos))
    Xt, at = tps._triangulate_core(*map(T, args), float(max_err_n), float(min_par_cos))
    np.testing.assert_array_equal(N(at), np.asarray(aj))
    assert N(at).sum() >= 5
    np.testing.assert_allclose(N(Xt)[N(at)], np.asarray(Xj)[np.asarray(aj)], atol=1e-4)


def test_slot_errors_and_sums(state):
    """_slot_err_jit: the same +inf pattern, finite errors within rtol 1e-3
    (1e-4 px); _reproj_sums_jit: the sum within rtol 1e-3, the count equal."""
    sc, _, jst, tst = state
    ej = np.asarray(jps._slot_err_jit(jst, J(sc.tid), J(sc.uv), J(sc.ok), J(sc.intr)))
    et = N(tps._slot_err_jit(tst, T(sc.tid), T(sc.uv), T(sc.ok), T(sc.intr)))
    np.testing.assert_array_equal(np.isfinite(et), np.isfinite(ej))
    fin = np.isfinite(ej)
    assert fin.sum() > 500
    np.testing.assert_allclose(et[fin], ej[fin], rtol=1e-3, atol=1e-4)
    args = (*jst[:7], sc.tid, sc.uv, sc.ok, sc.intr)
    sj, nj = jps._reproj_sums_jit(*map(J, args))
    st_, nt = tps._reproj_sums_jit(*map(T, args))
    assert int(nt) == int(nj) == fin.sum()
    np.testing.assert_allclose(float(st_), float(sj), rtol=1e-3)


def test_retriangulate_overlapping_slice(state):
    """Slices of 128 tracks over 342: starts 0, 128 and 214, the last
    overlapping the one before it; points within 1e-4."""
    sc, _, jst, tst = state
    tm = jps.build_track_major(jps.from_sequence_scene(sc))
    assert tm[0].shape[0] == 342
    out_j = jps._retriangulate(jst, *map(J, tm), J(sc.intr), chunk=128)
    out_t = tps._retriangulate(tst, *map(T, tm), T(sc.intr), chunk=128)
    _assert_states(out_t, out_j)
    moved = np.linalg.norm(np.asarray(out_j.points) - np.asarray(jst.points), axis=1)
    assert (moved > 1e-3).sum() > 100


def test_windowed_ba(state):
    """The driver's windowed BA (6 LM x 8 CG) over the last 12 registered
    views, the two oldest as gauge: poses and points within 1e-4."""
    sc, n_reg, jst, tst = state
    W = 12
    vids = np.arange(n_reg - W, n_reg, dtype=np.int32)
    live = np.ones(W, bool)
    cam_free = np.arange(W) >= 2
    out_j = jps._windowed_ba_jit(jst, J(sc.tid), J(sc.uv), J(sc.ok), J(vids), J(cam_free), J(live), jnp.int32(0),
                                 J(sc.intr), W=W, n_iters=6, n_cg=8)
    out_t = tps._windowed_ba_jit(tst, T(sc.tid), T(sc.uv), T(sc.ok), T(vids), T(cam_free), T(live), 0, T(sc.intr),
                                 W=W, n_iters=6, n_cg=8)
    _assert_states(out_t, out_j)
    assert np.abs(np.asarray(out_j.ts) - np.asarray(jst.ts)).max() > 1e-3  # the window moved


def test_global_ba(state):
    """The global BA (4 LM x 15 CG) over the registered views, views 0 and 1
    fixed, pixels pruned at 20 px: poses and points within 1e-4."""
    sc, n_reg, jst, tst = state
    cam_free = (np.arange(sc.tid.shape[0]) >= 2) & (np.arange(sc.tid.shape[0]) < n_reg)
    ok = sc.ok & (np.asarray(jps._slot_err_jit(jst, J(sc.tid), J(sc.uv), J(sc.ok), J(sc.intr))) < 20.0)
    out_j = jps._global_ba_jit(jst, J(sc.tid), J(sc.uv), J(ok), J(cam_free), J(sc.intr), n_iters=4, n_cg=15)
    out_t = tps._global_ba_jit(tst, T(sc.tid), T(sc.uv), T(ok), T(cam_free), T(sc.intr), n_iters=4, n_cg=15)
    _assert_states(out_t, out_j)


def test_chunk_register_replayed(state, draws):
    """One chunk of 3 steps from view 20: the same flags and prev, the state
    within 1e-4 (masks and tables equal)."""
    sc, v0, jst, tst = state
    max_err_n, min_par_cos = np.float32(4.0 / sc.intr[0]), np.float32(np.cos(np.radians(1.0)))
    with draws.record():
        out_j, prev_j, fl_j = jps._chunk_register_jit(
            jst, J(sc.tid), J(sc.uv), J(sc.ok), jnp.int32(v0), jnp.int32(0), jnp.int32(v0 - 1), jax.random.PRNGKey(0),
            J(sc.intr), jnp.float32(max_err_n), jnp.float32(min_par_cos), n_steps=3, min_inliers=8, min_gap=2)
    assert len(draws.calls) == 3
    with draws.replay():
        out_t, prev_t, fl_t = tps._chunk_register_jit(
            tst, T(sc.tid), T(sc.uv), T(sc.ok), v0, 0, v0 - 1, 0, T(sc.intr), float(max_err_n), float(min_par_cos),
            n_steps=3, min_inliers=8, min_gap=2)
    np.testing.assert_array_equal(N(fl_t), np.asarray(fl_j))
    assert N(fl_t)[:, 0].all()
    assert int(prev_t[0]) == int(prev_j) == v0 + 2
    _assert_states(out_t, out_j)


@pytest.mark.parametrize("base", [False, True], ids=["first", "reinit"])
def test_init_two_view_replayed(draws, base):
    """The two-view init of views 0 and 4 (and of 30 and 34 placed at a base
    pose, as a re-initialisation places its pair): the same return value,
    masks, first-sighting table and log; poses and points within 1e-4."""
    sc = tgen(**SCENE)
    tr = tps.from_sequence_scene(sc)
    V, Tn = sc.tid.shape[0], sc.n_tracks
    i, j = (30, 34) if base else (0, 4)
    kw = dict(base_R=sc.Rs[20], base_t=sc.ts[20], seg=1) if base else {}
    recs, tables = [], []
    for mod in (jps, tps):
        recs.append(mod.SequentialReconstruction(
            Rs=np.tile(np.eye(3, dtype=np.float32), (V, 1, 1)), ts=np.zeros((V, 3), np.float32),
            registered=np.zeros(V, bool), points=np.zeros((Tn, 3), np.float32), has_point=np.zeros(Tn, bool),
            intr=sc.intr, seg_of_view=np.full(V, -1, np.int32), seg_of_point=np.full(Tn, -1, np.int32)))
        tables.append((np.full(Tn, -1, np.int32), np.zeros((Tn, 2), np.float32)))
    with draws.record():
        nj = jps._init_two_view(tr, recs[0], *tables[0], i, j, jax.random.PRNGKey(5), **kw)
    with draws.replay():
        nt = tps._init_two_view(tr, recs[1], *tables[1], i, j, torch.Generator().manual_seed(5), **kw)
    assert nt == nj >= 12
    rj, rt = recs
    assert rt.log == rj.log and rt.reg_order == rj.reg_order
    for f in ("registered", "has_point", "seg_of_view", "seg_of_point"):
        np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f), err_msg=f)
    for f in ("Rs", "ts", "points"):
        np.testing.assert_allclose(getattr(rt, f), getattr(rj, f), atol=POINTS_ATOL if f == "points" else 1e-4,
                                   err_msg=f)
    for a, b in zip(tables[1], tables[0]):
        np.testing.assert_array_equal(a, b)


# --- the driver, replayed ---------------------------------------------------------


def _scene(name):
    if name == "noisy_96x48":
        return tgen(n_views=96, slots_per_view=48, track_span=10, seed=0, noise_px=0.3)
    return tgen(**SCENE)


def _tracks(name, sc):
    ok = sc.ok.copy()
    if name == "blanked_64x48":
        ok[24:38] = False  # longer than a track's span: nothing links the two sides
    return tps.SparseTracks(sc.tid, sc.uv, ok, sc.n_tracks)


@pytest.mark.parametrize("name", ["exact_64x48", "blanked_64x48", "noisy_96x48"])
def test_reconstruct_sequential_replayed(draws, name):
    """tests/test_sfm_scale.py's two scenes, and the noise-free one with 14
    views blanked, so tracking is lost and a second segment starts: both
    packages on the JAX package's draws, by the rules in the module
    docstring."""
    sc = _scene(name)
    tr = _tracks(name, sc)
    with draws.record():
        rj = jps.reconstruct_sequential(tr, sc.intr, **RUN)
    strict = name != "noisy_96x48"
    with draws.replay(strict=strict) as parted:
        rt = tps.reconstruct_sequential(tr, sc.intr, device=CPU, **RUN)
    assert rt.reg_order == rj.reg_order and rt.n_segments == rj.n_segments
    np.testing.assert_array_equal(rt.registered, rj.registered)
    px_j, px_t = rj.reprojection_mean_px(tr), rt.reprojection_mean_px(tr, device=CPU)
    both = rj.has_point & rt.has_point
    aligned = _aligned_rms(rt.points[both], rj.points[both])
    if strict:
        assert rt.log == rj.log
        np.testing.assert_array_equal(rt.has_point, rj.has_point)
        assert abs(px_t - px_j) <= 1e-3
        assert aligned <= 1e-3
    else:
        assert [e[:2] for e in rt.log] == [e[:2] for e in rj.log]
        for a, b in zip(rt.log, rj.log):
            assert a[0] != "fail" or max(abs(a[2] - b[2]), abs(a[3] - b[3])) <= 3
        assert abs(int(rt.has_point.sum()) - int(rj.has_point.sum())) <= 0.01 * sc.n_tracks
        assert abs(px_t - px_j) <= 5e-3 and px_t < 1.4
        assert aligned <= 0.05
        reg = rt.registered & (rt.seg_of_view == rt.seg_of_view[0])
        for r in (rj, rt):
            assert tmet.ate_rmse(_centers(r.Rs, r.ts)[reg], _centers(sc.Rs, sc.ts)[reg]) < 0.3
        assert len(parted) <= 12
    if name == "blanked_64x48":
        assert rt.n_segments == 2 and any(e[0] == "reinit" for e in rt.log)


# --- the port alone ------------------------------------------------------------------


def test_entry_scene_rule():
    """entry.sfm_sequence_scene: scripts/sfm_scale_run.py's track span
    max(24, V // 125), the generator's arrays."""
    tr, intr, sc = entry.sfm_sequence_scene(n_views=40, slots=24, seed=3)
    ref = tgen(n_views=40, slots_per_view=24, track_span=24, seed=3, noise_px=0.3)
    np.testing.assert_array_equal(tr.tid, ref.tid)
    np.testing.assert_array_equal(tr.uv, ref.uv)
    np.testing.assert_array_equal(intr, ref.intr)
    assert tr.n_tracks == sc.n_tracks == ref.n_tracks
    assert isinstance(tr, tps.SparseTracks)


def test_mesh_raises_and_short_window_runs(monkeypatch):
    """A mesh that is not a DeviceMesh raises (the mesh route itself is held
    by tests/test_torch_parallel_sfm.py). A window under 3 views runs no
    windowed BA (the JAX package's `window_vids` returns two values there,
    and its caller unpacks three) and the run completes; a window of 3 runs
    it."""
    sc = tgen(n_views=24, slots_per_view=32, track_span=8, seed=0, noise_px=0.0)
    tr = tps.from_sequence_scene(sc)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tps.reconstruct_sequential(tr, sc.intr, mesh=object(), device=CPU)
    calls = []
    orig = tps._windowed_ba_jit
    monkeypatch.setattr(tps, "_windowed_ba_jit", lambda *a, **k: calls.append(k["W"]) or orig(*a, **k))
    for window in (2, 3):
        rec = tps.reconstruct_sequential(tr, sc.intr, window=window, ba_every=3, min_gap=2, final_global_iters=2,
                                         device=CPU)
        assert rec.registered.sum() >= 4
    assert calls and set(calls) == {3}
    with pytest.raises(TypeError, match="DeviceMesh"):
        tps.global_ba(rec, tr, mesh=object(), device=CPU)


def test_global_ba_host_facing(state):
    """global_ba (3 LM x 15 CG) on the MapState fixture as a host
    reconstruction: poses within 1e-4, points within 1e-3."""
    sc, n_reg, jst, _ = state
    tr = tps.from_sequence_scene(sc)
    host = {f: np.array(getattr(jst, f)) for f in jps.MapState._fields[:7]}
    recs = [mod.SequentialReconstruction(intr=sc.intr, n_segments=1, reg_order=list(range(n_reg)),
                                         **{f: v.copy() for f, v in host.items()}) for mod in (jps, tps)]
    jps.global_ba(recs[0], tr, n_iters=3)
    tps.global_ba(recs[1], tr, n_iters=3, device=CPU)
    rj, rt = recs
    assert np.abs(rj.ts - host["ts"]).max() > 1e-3  # the bundle moved the poses
    for f in ("Rs", "ts", "points"):
        np.testing.assert_allclose(getattr(rt, f), getattr(rj, f), atol=POINTS_ATOL if f == "points" else 1e-4,
                                   err_msg=f)
