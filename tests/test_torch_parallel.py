"""Parity of the port's distributed layer (opencv_contrib_tpu_torch/parallel/)
with the JAX package's on the CPU.

One gloo group of 4 processes (tests/torch_ranks.py: spawned, a FileStore
under tmp_path, one torch thread a rank, a hard limit of 120 s) runs every
scenario once for the module, on meshes 2 x 2 and 1 x 4 over ("dp", "sp")
and 4 over ("pp",). The JAX package runs in this process on a mesh of the
same shape taken from conftest's 8 virtual devices. Inputs are made with
numpy from seeds; the BA problems are built by the JAX package and cross as
arrays, so both start from the same bits. Every rank must return the same
global outputs.

Tolerances (the JAX tests' own sharded-against-single bounds, since the
order of sums under all_reduce differs from one rank's):
- dense dist_ba: final cost rtol 1e-3 / atol 1e-3, cameras atol 5e-4
  (tests/test_parallel.py:45-55); sparse dist_ba: final cost rtol 1e-3,
  cameras and points 1e-4 (tests/test_torch_ba_sparse.py's bounds);
- the ring: `ok` equal, `idx` equal where ok, distances rtol 1e-4 / atol
  1e-4, and idx[i, i] == arange at ratio 1.1;
- submap_shard: one step within 1e-5 of JAX's; after 25 steps
  err1 < 0.3 err0;
- the stage pipeline: the toy chain within rtol 1e-4 / atol 1e-5 of JAX; on
  integer frames the frontend chain's matches equal to JAX's; the sharded
  feed equal to the replicated feed and to the sequential chain at atol 0;
- the dist_sfm step: the same valid keypoints as JAX's batched frontend,
  ok[0, 1].sum() > 10, the sharded BA lowers the cost;
- checkpoints crossing packages bit for bit, on a nested dict whose
  insertion order is not sorted;
- world-size-1 runs of every function equal to the single-device port bit
  for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_ranks
from opencv_contrib_tpu.ba import bundle as jba
from opencv_contrib_tpu.ba import sparse as jsp
from opencv_contrib_tpu.core import se3 as jse3
from opencv_contrib_tpu.features import describe as jdesc
from opencv_contrib_tpu.features import detect as jdet
from opencv_contrib_tpu.ops import filters as jfilters
from opencv_contrib_tpu.parallel import checkpoint as jck
from opencv_contrib_tpu.parallel import dist_ba as jdist_ba
from opencv_contrib_tpu.parallel import dist_sfm as jdist_sfm
from opencv_contrib_tpu.parallel import mesh as jmesh
from opencv_contrib_tpu.parallel import ring_match as jring
from opencv_contrib_tpu.parallel import stage_pipeline as jsp_pipe
from opencv_contrib_tpu.parallel import submap_shard as jsub
from opencv_contrib_tpu.utils.synthetic import generate_scene
from opencv_contrib_tpu_torch.ba import bundle as tba
from opencv_contrib_tpu_torch.ba import sparse as tsp
from opencv_contrib_tpu_torch.parallel import checkpoint as tck
from opencv_contrib_tpu_torch.parallel import dist_ba as tdist_ba
from opencv_contrib_tpu_torch.parallel import dist_sfm as tdist_sfm
from opencv_contrib_tpu_torch.parallel import mesh as tmesh
from opencv_contrib_tpu_torch.parallel import ring_match as tring
from opencv_contrib_tpu_torch.parallel import stage_pipeline as tpipe
from opencv_contrib_tpu_torch.parallel import submap_shard as tsub

torch.set_num_threads(1)
WORLD = 4


def _arrays(nt) -> dict:
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _dense(noise: float):
    """tests/test_parallel.py's _problem."""
    scene = generate_scene(n_views=4, n_points=128, seed=2)
    rng = np.random.default_rng(0)
    pts = scene.points3d + rng.normal(scale=noise, size=scene.points3d.shape).astype(np.float32)
    return jba.make_problem_from_scene(scene.Rs, scene.ts, pts, scene.intr, scene.points2d, scene.visible)


def _sparse():
    """tests/test_ba_sparse.py's noisy problem with 0.5 px pixel noise (the
    cost stays off the float32 floor), in the flat layout."""
    scene = generate_scene(n_views=8, n_points=256, seed=3, noise_px=0.5)
    rng = np.random.default_rng(0)
    pts = scene.points3d + rng.normal(scale=0.02, size=(256, 3)).astype(np.float32)
    ts = np.asarray(scene.ts) + rng.normal(scale=0.01, size=(8, 3)).astype(np.float32)
    return jsp.from_dense(jba.make_problem_from_scene(scene.Rs, ts, pts, scene.intr, scene.points2d, scene.visible))


def _submaps():
    """tests/test_parallel.py's ring of 8 submaps, 32 boundary points each."""
    rng = np.random.default_rng(0)
    S, M = 8, 32
    T_true = [np.eye(4, dtype=np.float32)]
    for _ in range(1, S):
        T_true.append(np.asarray(jse3.exp_se3(jnp.asarray(0.2 * rng.standard_normal(6).astype(np.float32)))))
    T_true = np.stack(T_true)
    pts = rng.uniform(-1, 1, (S, M, 3)).astype(np.float32)
    nbr = np.asarray([(s - 1) % S for s in range(S)], np.int32)
    tgt = np.zeros_like(pts)
    for s in range(S):
        pw = pts[s] @ T_true[s, :3, :3].T + T_true[s, :3, 3]
        Tn = np.linalg.inv(T_true[nbr[s]])
        tgt[s] = pw @ Tn[:3, :3].T + Tn[:3, 3]
    w = np.ones((S, M), np.float32)
    T0 = T_true.copy()
    for s in range(1, S):
        T0[s] = np.asarray(jse3.exp_se3(jnp.asarray(0.05 * rng.standard_normal(6).astype(np.float32)))) @ T0[s]
    return T_true, (T0, pts, tgt, nbr, w)


def _frames(n, hw=(64, 64), seed=0):
    """tests/test_stage_pipeline_real.py's blob frames, on 0..255 and
    rounded to integers (summed-area tables below 2**24 make the detector
    independent of summation order)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, hw).astype(np.float32)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    for _ in range(12):
        cy, cx = rng.uniform(8, hw[0] - 8), rng.uniform(8, hw[1] - 8)
        base += 0.8 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0)
    base = np.round(base / base.max() * 255.0).astype(np.float32)
    return [np.roll(base, (0, k), axis=(0, 1)) for k in range(n)]


def _sfm_images():
    """tests/test_parallel.py::test_end_to_end_distributed_step's frames."""
    rng = np.random.default_rng(0)
    base = np.asarray(jfilters.gaussian_blur(jnp.asarray(rng.uniform(0, 255, (96, 128)).astype(np.float32)), 2.0)) * 3
    return np.stack([np.roll(base, 3 * i, axis=1) for i in range(4)]).astype(np.float32)


def _tree():
    """A nested checkpoint tree whose insertion order is not sorted."""
    rng = np.random.default_rng(5)
    return {"z_last": rng.normal(size=(3, 4)).astype(np.float32),
            "a_first": {"y": np.arange(6, dtype=np.int32).reshape(2, 3), "b": rng.uniform(size=5) > 0.5},
            "m": [rng.normal(size=2).astype(np.float32), (np.eye(4, dtype=np.float32), None)]}


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    ring = (rng.normal(size=(8, 32, 16)).astype(np.float32), rng.uniform(size=(8, 32)) > 0.2)
    ring_self = np.random.default_rng(2).normal(size=(8, 16, 8)).astype(np.float32)
    _, submap = _submaps()
    return {"dense": {"noise02": {**_arrays(_dense(0.02)), "n_iters": 8},
                      "noise05": {**_arrays(_dense(0.05)), "n_iters": 15}},
            "sparse": _arrays(_sparse()), "ring": ring, "ring_self": ring_self, "submap": submap,
            "pipe_toy": np.random.default_rng(0).normal(size=(6, 32, 32)).astype(np.float32),
            "ref": _frames(1, seed=3)[0], "frames": np.stack(_frames(6)), "imgs": _sfm_images(), "tree": _tree()}


@pytest.fixture(scope="module")
def group(inputs, tmp_path_factory):
    """The 4-rank group's results (rank order), and its directory: the JAX
    package writes its checkpoint there first, the ranks read it."""
    d = tmp_path_factory.mktemp("ranks")
    jck.save_pytree(str(d / "jax_ck"), inputs["tree"], use_orbax=False)
    inp = dict(inputs, jax_file=str(d / "jax_ck.npz"))
    return torch_ranks.run_group(torch_ranks.parallel_scenarios, WORLD, d, inp, d), d


@pytest.fixture(scope="module")
def jmeshes():
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must provide 8 CPU devices"
    return {"22": jmesh.make_mesh(2, 2, devices=devs[:4]), "14": jmesh.make_mesh(1, 4, devices=devs[:4]),
            "pp": Mesh(np.array(devs[:4]), ("pp",))}


def _same_on_every_rank(res, key):
    a = jax.tree_util.tree_leaves(res[0][key])
    for r in res[1:]:
        for x, y in zip(a, jax.tree_util.tree_leaves(r[key])):
            np.testing.assert_array_equal(x, y, err_msg=key)
    return res[0][key]


# --- mesh ----------------------------------------------------------------------------


def test_mesh_layout(group, inputs):
    """make_mesh(2, 2): ("dp", "sp"), rank r at (r // 2, r % 2); the JAX
    defaults (1 x n under 4 ranks, else 2 x n/2); shard() places P("sp",
    None) as Shard(0) over sp, replicated over dp; shard_problem and
    shard_sparse_problem lay out the JAX package's specs."""
    res, _ = group
    for r, out in enumerate(res):
        assert out["shape"] == (2, 2) and out["names"] == ("dp", "sp")
        assert list(out["coordinate"]) == [r // 2, r % 2]
        assert out["default_shape"] == (2, 2)
        assert out["shard"] == ((4, 16), [("Replicate", None), ("Shard", 0)])
        # dist_ba's layouts: the grid's blocks (4 cameras over dp, 128 points over sp); the flat list's
        # rows over all four ranks, cameras, points and intrinsics whole
        assert out["shard_problem"] == [(2, 6), (64, 3), (9,), (2, 64, 2), (2, 64)]
        n = len(inputs["sparse"]["obs_cam"]) // 4
        assert out["shard_sparse_problem"] == [(8, 6), (256, 3), (9,), (n,), (n,), (2, n), (n,)]


# --- dist_ba ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["noise02", "noise05"])
def test_dist_ba_dense(group, inputs, jmeshes, name):
    """The grid over 2 x 2 against the JAX package's sharded solve on a 2 x 2
    mesh (8 and 15 LM iterations); at 0.05 noise the cost falls below 1e-2
    of the initial (tests/test_parallel.py::test_sharded_converges)."""
    res, _ = group
    cams, pts, c0, c1 = _same_on_every_rank(res, f"dense_{name}")
    a = inputs["dense"][name]
    jr = jdist_ba.bundle_adjust(_dense(0.02 if name == "noise02" else 0.05), jmeshes["22"], n_iters=a["n_iters"])
    np.testing.assert_allclose(float(c1), float(jr.final_cost), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(cams, np.asarray(jr.cameras), atol=5e-4)
    np.testing.assert_allclose(float(c0), float(jr.initial_cost), rtol=1e-5)
    if name == "noise05":
        assert float(c1) < float(c0) * 1e-2


def test_dist_ba_sparse(group, jmeshes):
    """The camera buckets over the 4 ranks against the JAX package's flat
    list over a 2 x 2 mesh: 2 LM x 10 CG."""
    res, _ = group
    cams, pts, c0, c1 = _same_on_every_rank(res, "sparse")
    jr = jdist_ba.bundle_adjust_sparse(_sparse(), jmeshes["22"], n_iters=2, n_cg=10)
    assert float(c1) < 0.5 * float(c0)
    np.testing.assert_allclose(float(c1), float(jr.final_cost), rtol=1e-3)
    np.testing.assert_allclose(cams, np.asarray(jr.cameras), atol=1e-4)
    np.testing.assert_allclose(pts, np.asarray(jr.points), atol=1e-4)


# --- ring_match -------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["22", "14"])
def test_ring_equals_reference(group, inputs, jmeshes, mesh):
    """8 images over sp = 2 and sp = 4 against the JAX ring on the same mesh
    and its single-device reference."""
    res, _ = group
    idx, dist, ok = _same_on_every_rank(res, f"ring_{mesh}")
    descs, valids = inputs["ring"]
    for j_idx, j_dist, j_ok in (jring.ring_all_pairs_match(jnp.asarray(descs), jnp.asarray(valids), jmeshes[mesh]),
                                jring.all_pairs_match_reference(jnp.asarray(descs), jnp.asarray(valids))):
        m = np.asarray(j_ok)
        np.testing.assert_array_equal(ok, m)
        np.testing.assert_array_equal(idx[m], np.asarray(j_idx)[m])
        np.testing.assert_allclose(dist[m], np.asarray(j_dist)[m], rtol=1e-4, atol=1e-4)
    assert idx.shape == (8, 8, 32) and idx.dtype == np.int32


@pytest.mark.parametrize("mesh", ["22", "14"])
def test_self_matches_are_identity(group, mesh):
    res, _ = group
    idx = _same_on_every_rank(res, f"ring_self_{mesh}")
    for i in range(8):
        np.testing.assert_array_equal(idx[i, i], np.arange(16))


# --- submap_shard ---------------------------------------------------------------------------


def test_submap_step_and_convergence(group, jmeshes):
    """8 submaps over sp = 4: one step within 1e-5 of the JAX package's on a
    1 x 4 mesh; 25 steps bring the poses within 0.3 of their start error."""
    res, _ = group
    step = _same_on_every_rank(res, "submap_step")
    T_true, (T0, pts, tgt, nbr, w) = _submaps()
    j_step = jsub.sharded_constraint_step(jmeshes["14"])(*(jnp.asarray(a) for a in (T0, pts, tgt, nbr, w)))
    np.testing.assert_allclose(step, np.asarray(j_step), atol=1e-5)
    out = _same_on_every_rank(res, "submap_25")
    err0 = np.mean([np.linalg.norm(T0[s] - T_true[s]) for s in range(1, 8)])
    err1 = np.mean([np.linalg.norm(out[s] - T_true[s]) for s in range(1, 8)])
    assert err1 < 0.3 * err0, (err0, err1)
    owner, per = res[0]["assign"]
    j_owner, j_per = jsub.assign_submaps(10, jmeshes["14"])
    np.testing.assert_array_equal(owner, j_owner)
    assert per == j_per


# --- stage_pipeline ---------------------------------------------------------------------------


def test_toy_chain_matches_jax(group, inputs, jmeshes):
    """tests/test_parallel.py's blur -> grad -> norm -> soft over 4 stage
    ranks, 6 items."""
    res, _ = group
    out = _same_on_every_rank(res, "pipe_toy")
    k = jnp.ones((3, 3)) / 9.0

    def blur(x):
        return jax.scipy.signal.convolve2d(x, k, mode="same")

    def grad(x):
        gy = jnp.diff(x, axis=0, append=x[-1:])
        gx = jnp.diff(x, axis=1, append=x[:, -1:])
        return jnp.sqrt(gy * gy + gx * gx)

    def norm(x):
        return (x - x.mean()) / (x.std() + 1e-6)

    def soft(x):
        return jax.nn.sigmoid(4.0 * x)

    j_out = jsp_pipe.pipeline_map([blur, grad, norm, soft], jnp.asarray(inputs["pipe_toy"]), jmeshes["pp"])
    np.testing.assert_allclose(out, np.asarray(j_out), rtol=1e-4, atol=1e-5)


def test_frontend_chain(group, inputs, jmeshes):
    """The real chain (detect -> describe -> match against a reference, +
    identity) with the feed sharded over 4 stage ranks: equal to the
    replicated feed and to the sequential chain at atol 0, and its matches
    equal to the JAX package's sharded pipeline on integer frames."""
    res, _ = group
    sharded = _same_on_every_rank(res, "chain_sharded")
    np.testing.assert_array_equal(sharded, res[0]["chain_replicated"])
    np.testing.assert_array_equal(sharded, res[0]["chain_sequential"])
    ref = jnp.asarray(inputs["ref"])
    kp = jdet.fast_hessian(ref, max_keypoints=16, threshold=1e-4)
    stages, pack, unpack, C = jsp_pipe.frontend_stages(jdesc.surf_describe(ref, kp), kp.valid, img_hw=(64, 64),
                                                       n_kp=16)
    items = jnp.stack([pack(f) for f in inputs["frames"]])
    j_out = np.asarray(jsp_pipe.pipeline_map_sharded(stages + [jsp_pipe.identity_stage], items, jmeshes["pp"]))
    assert sharded.shape == j_out.shape == (6, C)
    for t in range(6):
        (ti, td), (ji, jd) = [(np.asarray(a) for a in unpack(jnp.asarray(o[t]))) for o in (sharded, j_out)]
        matched = jd > -0.5
        assert matched.sum() >= 4
        np.testing.assert_array_equal(td > -0.5, matched)
        np.testing.assert_array_equal(ti[matched], ji[matched])
        np.testing.assert_allclose(td[matched], jd[matched], rtol=1e-4, atol=1e-3)


# --- dist_sfm ----------------------------------------------------------------------------------


def test_distributed_step(group, inputs, jmeshes):
    """batched_frontend over dp -> ring matching over sp -> sharded BA on
    2 x 2: the same valid keypoints as the JAX package's batched frontend,
    neighbouring shifted frames match (ok[0, 1].sum() > 10), the cost falls;
    scaling_report's keys."""
    res, _ = group
    descs, xy, valid = _same_on_every_rank(res, "frontend")
    idx, dist, ok = _same_on_every_rank(res, "matching")
    assert descs.shape == (4, 64, 64) and xy.shape == (4, 64, 2) and valid.sum() > 0
    j_descs, j_xy, j_valid = jdist_sfm.batched_frontend(jnp.asarray(inputs["imgs"]), jmeshes["22"], max_keypoints=64,
                                                        threshold=1.0)
    np.testing.assert_array_equal(valid, np.asarray(j_valid))
    np.testing.assert_allclose(xy[valid], np.asarray(j_xy)[valid], atol=1e-3)
    assert int(ok[0, 1].sum()) > 10
    c0, c1 = _same_on_every_rank(res, "bundle_cost")
    assert float(c1) < float(c0)
    keys, n_dev = res[0]["report"]
    assert keys == sorted(["t_single_s", "t_sharded_s", "n_devices", "speedup", "efficiency"]) and n_dev == WORLD


# --- checkpoint ---------------------------------------------------------------------------------


def test_checkpoint_crosses_packages(group, inputs):
    """The port's file (rank 0 wrote it, the ranks met at a barrier)
    restores in the JAX package bit for bit with the JAX package's treedef
    text, and the JAX package's file restores in the port on every rank;
    use_orbax=True raises in the port."""
    res, d = group
    tree = inputs["tree"]
    assert {r["saved"] for r in res} == {str(d / "port_ck.npz")}
    like = jax.tree_util.tree_map(jnp.zeros_like, tree)
    back = jck.restore_pytree(res[0]["saved"], like, use_orbax=False)
    for a, b in zip(_leaves(back), _leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
        assert np.asarray(a).dtype == b.dtype
    with np.load(res[0]["saved"]) as f, np.load(str(d / "jax_ck.npz")) as g:
        assert bytes(f["treedef"]) == bytes(g["treedef"])
        assert sorted(f.files) == sorted(g.files)
    for r in res:
        for a, b in zip(_leaves(r["restored"]), _leaves(tree)):
            np.testing.assert_array_equal(a, b)
        assert r["orbax"] == "raised"


# --- world size 1 ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh1():
    """A 1 x 1 mesh on a world-size-1 gloo group that make_mesh starts in
    this process; the group is destroyed after the module."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    m = tmesh.make_mesh(device="cpu")
    yield m
    dist.destroy_process_group()


def _t(a):
    return torch.from_numpy(np.array(a))


def test_world_size_one_equals_single_device(mesh1, inputs, tmp_path):
    """Every function of the layer at world size 1, bit for bit against the
    single-device port (gloo's all_reduce of one rank is the identity)."""
    assert tuple(mesh1.shape) == (1, 1)
    p = torch_ranks.dense_problem(inputs["dense"]["noise02"])
    for kw in (dict(n_iters=4), dict(n_iters=3, optimize_intr=True), dict(n_iters=3, solver="pcg")):
        a, b = tba.bundle_adjust(p, **kw), tdist_ba.bundle_adjust(p, mesh1, **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y), kw
    sp_ = torch_ranks.sparse_problem(inputs["sparse"])
    for x, y in zip(tsp.bundle_adjust_sparse(sp_, n_iters=2, n_cg=10),
                    tdist_ba.bundle_adjust_sparse(sp_, mesh1, n_iters=2, n_cg=10)):
        assert torch.equal(x, y)
    descs, valids = (_t(a) for a in inputs["ring"])
    for x, y in zip(tring.ring_all_pairs_match(descs, valids, mesh1), tring.all_pairs_match_reference(descs, valids)):
        assert torch.equal(x, y)
    sub = [_t(a) for a in inputs["submap"]]
    step = tsub.sharded_constraint_step(mesh1)
    one = step(*sub)
    assert torch.equal(tsub.optimize_submaps(*sub, mesh1, n_iters=1), one)
    from torch.distributed.device_mesh import DeviceMesh

    pp = DeviceMesh("cpu", [0], mesh_dim_names=("pp",))
    blur_only = torch_ranks.toy_stages()[:1]
    items = _t(inputs["pipe_toy"])
    ref = torch.stack([blur_only[0](x) for x in items])
    assert torch.equal(tpipe.pipeline_map(blur_only, items, pp), ref)
    assert torch.equal(tpipe.pipeline_map_sharded(blur_only, items, pp), ref)
    f_d, f_xy, f_v = tdist_sfm.batched_frontend(inputs["imgs"][:2], mesh1, max_keypoints=32, threshold=1.0)
    from opencv_contrib_tpu_torch.features import describe, detect

    for i in range(2):
        img = _t(inputs["imgs"][i])
        k = detect.fast_hessian(img, max_keypoints=32, threshold=1.0, n_octaves=2)
        assert torch.equal(f_d[i], describe.surf_describe(img, k)) and torch.equal(f_v[i], k.valid)
    tree = torch_ranks.to_torch(inputs["tree"])
    back = tck.restore_pytree(tck.save_slam_state(str(tmp_path / "s"), extra=tree), {k: tree[k] for k in tree})
    for a, b in zip(_leaves(torch_ranks._np(back)), _leaves(inputs["tree"])):
        np.testing.assert_array_equal(a, b)


def test_sizes_that_do_not_divide_raise(mesh1, group):
    """Where a JAX NamedSharding refuses a shape, the port raises instead of
    padding (on the 4-rank group: 3 cameras over dp = 2, 6 cameras' buckets
    over 4 ranks, 7 images over sp = 2); a mesh asking for more ranks than
    the group has, and a stage count other than the axis extent, raise."""
    res, _ = group
    for r in res:
        assert r["refused"] == ["dense", "sparse", "ring"]
    with pytest.raises(ValueError, match="needs 4 ranks"):
        tmesh.make_mesh(2, 2, device="cpu")
    assert tmesh.initialize_multihost("localhost:1", num_processes=1, process_id=0, device="cpu") is False
    from torch.distributed.device_mesh import DeviceMesh

    pp = DeviceMesh("cpu", [0], mesh_dim_names=("pp",))
    with pytest.raises(ValueError, match="stages"):
        tpipe.pipeline_map([tpipe.identity_stage] * 2, torch.zeros(3, 2), pp)
