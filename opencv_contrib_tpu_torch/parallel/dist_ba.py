"""Distributed Schur bundle adjustment over a mesh — the port of
opencv_contrib_tpu/parallel/dist_ba.py.

The JAX package annotates shardings and lets GSPMD insert the collectives
(SURVEY §5.8 / §7). The port runs the single-device solvers of ba/bundle.py
and ba/sparse.py on each rank's block and hands them a `Sums` that calls the
collectives where GSPMD places them; every rank returns the whole result.

Dense layout, the observation grid over (dp, sp): rank (d, s) holds the
observations of camera block d and point block s, cameras P("dp"), points
P("sp"), intrinsics replicated. Point blocks (V, bp) sum over dp and camera
blocks (U, bc) over sp; the reduced camera system is a sum over the point
shards of local products, with W and Y gathered over dp inside each sp
group; the small camera solve is replicated, and the point steps are
gathered over sp. Cameras must divide by dp and points by sp.

Sparse layout: every observation lives in the bucket of its camera, and the
flat list is sharded over every mesh axis by camera: rank k (row-major in
the mesh) holds the buckets of cameras [k C / n, (k + 1) C / n). Point
blocks and the scalar products of the PCG are sums of the ranks' partials
(each matvec's point sums one `all_reduce`), the camera steps are gathered.
Cameras must divide by the mesh size. (The JAX package shards the list's
rows; the port's solver works on camera buckets, and a camera's bucket on
one rank keeps its camera blocks local.)
"""

from __future__ import annotations

import inspect

from torch.distributed.device_mesh import DeviceMesh

from opencv_contrib_tpu_torch.ba import bundle, sparse
from opencv_contrib_tpu_torch.parallel.mesh import (AXES, all_gather, axis_index, axis_size, check_divisible, psum,
                                                    replicate, shard)
from opencv_contrib_tpu_torch.utils.precision import f32_matmuls


def _same_device(problem, mesh: DeviceMesh) -> None:
    if problem.cameras.device.type != mesh.device_type:
        raise ValueError(f"the problem is on {problem.cameras.device}, the mesh on {mesh.device_type}")


class _GridSums(bundle.Sums):
    """The dense solve's sums on rank (d, s) of the grid."""

    def __init__(self, mesh: DeviceMesh, C: int, P: int):
        cb = check_divisible(C, mesh, "dp", "cameras")
        pb = check_divisible(P, mesh, "sp", "points")
        d, s = axis_index(mesh, "dp"), axis_index(mesh, "sp")
        self.mesh, self.cams, self.pts = mesh, slice(d * cb, (d + 1) * cb), slice(s * pb, (s + 1) * pb)

    def over_points(self, x):
        return psum(x, self.mesh, "sp")

    def over_cams(self, x):
        return psum(x, self.mesh, "dp")

    def total(self, x):
        return psum(x, self.mesh, AXES)

    def all_cams(self, x):
        return all_gather(x, self.mesh, "dp")

    def all_points(self, x):
        return all_gather(x, self.mesh, "sp")


class _BucketSums(sparse.Sums):
    """The sparse solve's sums on the rank that holds one block of cameras'
    buckets."""

    def __init__(self, mesh: DeviceMesh, C: int):
        cb = check_divisible(C, mesh, AXES, "cameras")
        k = axis_index(mesh, "dp") * axis_size(mesh, "sp") + axis_index(mesh, "sp")
        self.mesh, self.cams = mesh, slice(k * cb, (k + 1) * cb)

    def points(self, x):
        return psum(x, self.mesh, AXES)

    def total(self, x):
        return psum(x, self.mesh, AXES)

    def all_cams(self, x):
        return all_gather(all_gather(x, self.mesh, "sp"), self.mesh, "dp")


def shard_problem(problem: bundle.BAProblem, mesh: DeviceMesh) -> bundle.BAProblem:
    """The problem as DTensors in the dense layout: cameras P("dp"), points
    P("sp"), intrinsics replicated, observations and mask P("dp", "sp")."""
    return bundle.BAProblem(
        cameras=shard(mesh, problem.cameras, ("dp", None)),
        points=shard(mesh, problem.points, ("sp", None)),
        intr=replicate(mesh, problem.intr),
        obs=shard(mesh, problem.obs, ("dp", "sp", None)),
        mask=shard(mesh, problem.mask, ("dp", "sp")),
    )


@f32_matmuls
def bundle_adjust(problem: bundle.BAProblem, mesh: DeviceMesh, **kwargs) -> bundle.BAResult:
    """Sharded BA: the contract of ba.bundle.bundle_adjust (every keyword of
    it), executed with the observation grid partitioned over (dp, sp).
    Every rank of the mesh calls it with the same problem and gets the
    whole result."""
    _same_device(problem, mesh)
    args = inspect.signature(bundle.bundle_adjust).bind(problem, **kwargs)
    args.apply_defaults()
    sums = _GridSums(mesh, problem.cameras.shape[0], problem.points.shape[0])
    return bundle._bundle_adjust(**args.arguments, sums=sums)


# ---------------------------------------------------------------------------
# the sparse-observation layout (ba.sparse) over the mesh: the 5k-image path


def shard_sparse_problem(problem: sparse.SparseBAProblem, mesh: DeviceMesh) -> sparse.SparseBAProblem:
    """The problem as DTensors in the JAX package's sparse layout: the flat
    observation list sharded over every mesh axis, cameras, points and
    intrinsics replicated (`bundle_adjust_sparse` shards by camera bucket)."""
    obs = (AXES,)
    return sparse.SparseBAProblem(
        cameras=replicate(mesh, problem.cameras), points=replicate(mesh, problem.points),
        intr=replicate(mesh, problem.intr),
        obs_cam=shard(mesh, problem.obs_cam, obs), obs_pt=shard(mesh, problem.obs_pt, obs),
        obs_uv=shard(mesh, problem.obs_uv, (None, AXES)), obs_ok=shard(mesh, problem.obs_ok, obs))


def bundle_adjust_sparse(problem: sparse.SparseBAProblem, mesh: DeviceMesh, buckets=None, **kwargs):
    """Sharded sparse-observation BA: the contract of
    ba.sparse.bundle_adjust_sparse (every keyword of it). Buckets are built
    on the host once a sparsity pattern when not given; each rank solves on
    its cameras' columns of them."""
    _same_device(problem, mesh)
    if buckets is None:
        buckets = sparse.build_buckets(problem.obs_cam, problem.obs_pt, problem.obs_ok, problem.cameras.shape[0],
                                       problem.points.shape[0], device=problem.cameras.device)
    sums = _BucketSums(mesh, problem.cameras.shape[0])
    mine = sparse.ObsBuckets(buckets.idx_a[:, sums.cams], buckets.ok_a[:, sums.cams])
    args = inspect.signature(sparse.bundle_adjust_sparse).bind(problem, buckets=mine, **kwargs)
    args.apply_defaults()
    return sparse._bundle_adjust_sparse_jit(**args.arguments, sums=sums)
