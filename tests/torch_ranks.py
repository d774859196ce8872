"""Rank groups for the CPU tests of the port's distributed layer
(opencv_contrib_tpu_torch/parallel/), and the work each rank does.

`run_group(fn, world, store_dir, *args)` starts `world` processes by the
`spawn` method; each joins a gloo process group through a FileStore under
`store_dir` (no TCP port is chosen, so test workers do not collide), sets
torch to one thread, calls fn(rank, *args) and sends back what it returns.
The group has a hard limit: when it passes, or when a rank fails, every
process of the group is killed and the caller gets an error. Nothing waits
without a limit.

This module imports no JAX: the rank processes import it, and only it, from
the tests directory. The JAX side of each comparison runs in the test
process.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import time
import traceback

import numpy as np

LIMIT_S = 120.0


def _rank_main(fn, rank: int, world: int, store: str, args, results) -> None:
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which kills the group
        results.put((rank, False, traceback.format_exc()))


def run_group(fn, world: int, store_dir, *args, limit: float = LIMIT_S) -> list:
    """fn(rank, *args) on `world` ranks of a gloo group; returns the ranks'
    results in rank order. Raises (after killing the group) when a rank
    fails, dies or the group outlives `limit` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = str(store_dir / "filestore")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, store, args, results), daemon=True)
             for r in range(world)]
    deadline = time.monotonic() + limit
    got = {}
    try:
        for p in procs:
            p.start()
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"the rank group passed its {limit:.0f} s limit; ranks done: {sorted(got)}")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks {dead} died without a result (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            if p.pid is not None:
                p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [got[r] for r in range(world)]


# --- what the ranks of tests/test_torch_parallel.py do ----------------------------------


def _np(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    return x


def to_torch(tree):
    """A tree of dicts, lists and tuples with numpy leaves, its leaves as
    tensors (other leaves kept)."""
    import torch

    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree


def dense_problem(a: dict):
    """A port BAProblem from the arrays of a JAX one (the same bits)."""
    import torch

    from opencv_contrib_tpu_torch.ba import bundle

    return bundle.BAProblem(*(torch.from_numpy(np.array(a[k])) for k in bundle.BAProblem._fields))


def sparse_problem(a: dict):
    import torch

    from opencv_contrib_tpu_torch.ba import sparse

    return sparse.SparseBAProblem(*(torch.from_numpy(np.array(a[k])) for k in sparse.SparseBAProblem._fields))


def toy_stages():
    """tests/test_parallel.py's toy chain in torch: a 3x3 box blur with zero
    padding (`convolve2d(mode="same")`), the gradient magnitude of forward
    differences, standardisation (population std) and a sigmoid."""
    import torch
    import torch.nn.functional as F

    def blur(x):
        return F.conv2d(x[None, None], torch.full((1, 1, 3, 3), 1.0 / 9.0), padding=1)[0, 0]

    def grad(x):
        gy = torch.diff(x, dim=0, append=x[-1:])
        gx = torch.diff(x, dim=1, append=x[:, -1:])
        return torch.sqrt(gy * gy + gx * gx)

    def norm(x):
        return (x - x.mean()) / (x.std(unbiased=False) + 1e-6)

    def soft(x):
        return torch.sigmoid(4.0 * x)

    return [blur, grad, norm, soft]


def frontend_chain(ref: np.ndarray, n_kp: int = 16):
    """tests/test_stage_pipeline_real.py's chain, its reference frame
    described by the port."""
    import torch

    from opencv_contrib_tpu_torch.features import describe, detect
    from opencv_contrib_tpu_torch.parallel import stage_pipeline as sp

    img = torch.from_numpy(ref)
    kp = detect.fast_hessian(img, max_keypoints=n_kp, threshold=1e-4)
    return sp.frontend_stages(describe.surf_describe(img, kp), kp.valid, img_hw=ref.shape, n_kp=n_kp)


def parallel_scenarios(rank: int, inp: dict, out_dir) -> dict:
    """Every scenario of tests/test_torch_parallel.py on a 4-rank group:
    meshes 2 x 2 and 1 x 4 over ("dp", "sp"), and 4 over ("pp",)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from opencv_contrib_tpu_torch.parallel import checkpoint, dist_ba, dist_sfm, ring_match, submap_shard
    from opencv_contrib_tpu_torch.parallel import mesh as pm
    from opencv_contrib_tpu_torch.parallel import stage_pipeline as sp

    m22 = pm.make_mesh(2, 2, device="cpu")
    m14 = pm.make_mesh(1, 4, device="cpu")
    mpp = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("pp",))
    out = {"coordinate": m22.get_coordinate(), "shape": tuple(m22.shape), "names": m22.mesh_dim_names,
           "default_shape": tuple(pm.make_mesh(device="cpu").shape)}
    xs = pm.shard(m22, torch.zeros(8, 16), ("sp", None))
    out["shard"] = (tuple(xs.to_local().shape), [(type(p).__name__, getattr(p, "dim", None)) for p in xs.placements])
    dense = dense_problem(inp["dense"]["noise02"])
    out["shard_problem"] = [tuple(x.to_local().shape) for x in dist_ba.shard_problem(dense, m22)]
    out["shard_sparse_problem"] = [tuple(x.to_local().shape)
                                   for x in dist_ba.shard_sparse_problem(sparse_problem(inp["sparse"]), m22)]

    for name, a in inp["dense"].items():
        r = dist_ba.bundle_adjust(dense_problem(a), m22, n_iters=a["n_iters"])
        out[f"dense_{name}"] = _np((r.cameras, r.points, r.initial_cost, r.final_cost))
    r = dist_ba.bundle_adjust_sparse(sparse_problem(inp["sparse"]), m22, n_iters=2, n_cg=10)
    out["sparse"] = _np((r.cameras, r.points, r.initial_cost, r.final_cost))

    for mname, m in (("22", m22), ("14", m14)):
        out[f"ring_{mname}"] = _np(ring_match.ring_all_pairs_match(
            torch.from_numpy(inp["ring"][0]), torch.from_numpy(inp["ring"][1]), m))
        out[f"ring_self_{mname}"] = _np(ring_match.ring_all_pairs_match(
            torch.from_numpy(inp["ring_self"]), torch.ones(inp["ring_self"].shape[:2], dtype=torch.bool), m,
            ratio=1.1))[0]

    T0, pts, tgt, nbr, w = (torch.from_numpy(x) for x in inp["submap"])
    step = submap_shard.sharded_constraint_step(m14)
    out["submap_step"] = _np(step(T0, pts, tgt, nbr, w))
    out["submap_25"] = _np(submap_shard.optimize_submaps(T0, pts, tgt, nbr, w, m14, n_iters=25))
    out["assign"] = submap_shard.assign_submaps(10, m14)

    out["pipe_toy"] = _np(sp.pipeline_map(toy_stages(), torch.from_numpy(inp["pipe_toy"]), mpp))
    stages, pack, unpack, _ = frontend_chain(inp["ref"])
    stages = stages + [sp.identity_stage]
    items = torch.stack([pack(torch.from_numpy(f)) for f in inp["frames"]])
    out["chain_sharded"] = _np(sp.pipeline_map_sharded(stages, items, mpp))
    out["chain_replicated"] = _np(sp.pipeline_map(stages, items, mpp))
    seq = items
    for s in stages:
        seq = torch.stack([s(x) for x in seq])
    out["chain_sequential"] = _np(seq)

    descs, xy, valid = dist_sfm.batched_frontend(inp["imgs"], m22, max_keypoints=64, threshold=1.0)
    out["frontend"] = _np((descs, xy, valid))
    out["matching"] = _np(dist_sfm.distributed_matching(descs, valid, m22))
    r = dist_sfm.distributed_bundle(dense_problem(inp["dense"]["noise02"]), m22, n_iters=8)
    out["bundle_cost"] = _np((r.initial_cost, r.final_cost))
    rep = dist_sfm.scaling_report(dense_problem(inp["dense"]["noise02"]), m22, n_iters=3, repeats=1)
    out["report"] = (sorted(rep), rep["n_devices"])

    refused = []
    dense = dense_problem(inp["dense"]["noise02"])
    sparse_ = sparse_problem(inp["sparse"])
    for name, call in (("dense", lambda: dist_ba.bundle_adjust(dense._replace(
                            cameras=dense.cameras[:3], obs=dense.obs[:3], mask=dense.mask[:3]), m22, n_iters=1)),
                       ("sparse", lambda: dist_ba.bundle_adjust_sparse(sparse_._replace(
                            cameras=sparse_.cameras[:6]), m22, n_iters=1)),
                       ("ring", lambda: ring_match.ring_all_pairs_match(
                            torch.zeros(7, 4, 2), torch.ones(7, 4, dtype=torch.bool), m22))):
        try:
            call()
        except ValueError as e:
            if "must divide" in str(e):
                refused.append(name)
    out["refused"] = refused

    tree = to_torch(inp["tree"])
    out["saved"] = checkpoint.save_pytree(str(out_dir / "port_ck"), tree)
    out["restored"] = _np(checkpoint.restore_pytree(inp["jax_file"], to_torch(inp["tree"])))
    try:
        checkpoint.save_pytree(str(out_dir / "orbax_ck"), tree, use_orbax=True)
        out["orbax"] = "saved"
    except NotImplementedError:
        out["orbax"] = "raised"
    return out


# --- what the ranks of tests/test_torch_parallel_sfm.py do ------------------------------


def sfm_scenarios(rank: int, jobs: list) -> list:
    """For each job (calls, scene_kw, ok, run_kw, host): reconstruct_sequential
    on a 2 x 2 mesh with the JAX package's RANSAC draws `calls` replayed in
    order (the masks they were drawn under are compared and the partings
    counted), then global_ba on the mesh from the host reconstruction
    `host`."""
    import torch

    from opencv_contrib_tpu_torch.mvg import robust
    from opencv_contrib_tpu_torch.parallel import mesh as pm
    from opencv_contrib_tpu_torch.sfm import pipeline_scale as tps
    from opencv_contrib_tpu_torch.utils.synthetic import generate_sequence_scene

    m22 = pm.make_mesh(2, 2, device="cpu")
    outs = []
    for calls, scene_kw, ok, run_kw, host in jobs:
        draws = iter(calls)
        parted = []

        def replayed(generator, n_points, mask, n_hypotheses, sample_size, draws=draws, parted=parted):
            jmask, idx = next(draws)
            if not np.array_equal(mask.cpu().numpy(), jmask):
                parted.append(len(parted))
            return torch.from_numpy(idx.astype(np.int64)).to(mask.device)

        robust.sample_indices = replayed
        sc = generate_sequence_scene(**scene_kw)
        tr = tps.SparseTracks(sc.tid, sc.uv, ok, sc.n_tracks)
        rec = tps.reconstruct_sequential(tr, sc.intr, mesh=m22, device="cpu", **run_kw)
        out = {"reg_order": rec.reg_order, "log": rec.log, "n_segments": rec.n_segments,
               "drew_all": next(draws, None) is None, "parted": len(parted),
               **{f: getattr(rec, f) for f in ("registered", "has_point", "points", "Rs", "ts")},
               "mean_px": rec.reprojection_mean_px(tr, device="cpu")}
        g = tps.SequentialReconstruction(**{k: (v.copy() if isinstance(v, np.ndarray) else v)
                                            for k, v in host.items()})
        tps.global_ba(g, tr, n_iters=3, mesh=m22, device="cpu")
        out["global_ba"] = {f: getattr(g, f) for f in ("Rs", "ts", "points")}
        out["global_ba_px"] = g.reprojection_mean_px(tr, device="cpu")
        outs.append(out)
    return outs
