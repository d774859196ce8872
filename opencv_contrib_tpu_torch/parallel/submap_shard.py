"""Submap sharding: map blocks distributed over ranks, boundary constraints
exchanged by collectives — the port of
opencv_contrib_tpu/parallel/submap_shard.py.

The reference's LargeKinFu keeps all submaps in one process (submap.hpp,
SURVEY §5.7c names it the precedent for map-block partitioning). Here the
submap POSE GRAPH is the shared small state and the expensive per-submap
work (constraint residuals over shared-frame point sets) is sharded over a
mesh axis: each rank owns n_submaps / n_ranks submaps' boundary point sets,
and the 6x6-block normal equations are summed over the axis — the same
structure as dist_ba's reduced camera system; the link carries 6 x 7 floats
a submap, not the point sets.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from opencv_contrib_tpu_torch.core import se3
from opencv_contrib_tpu_torch.parallel.mesh import axis_index, axis_size, check_divisible, mesh_device, psum
from opencv_contrib_tpu_torch.utils.precision import f32_matmuls


def assign_submaps(n_submaps: int, mesh: DeviceMesh, axis: str = "sp"):
    """Round-robin submap -> shard assignment (padded to a multiple of the
    axis size). Returns (owner (N,), n_per_shard)."""
    n = axis_size(mesh, axis)
    per = -(-n_submaps // n)
    owner = np.arange(per * n) // per
    return owner[:n_submaps], per


def sharded_constraint_step(mesh: DeviceMesh, axis: str = "sp"):
    """A one-step Gauss-Newton update of the submap poses from sharded
    boundary observations.

    Inputs (per call), the same on every rank:
      poses (S, 4, 4)      — current submap poses (world <- submap)
      pts   (S, M, 3)      — boundary points, in OWNER submap coords
      tgt   (S, M, 3)      — the same physical points in NEIGHBOR submap coords
      nbr   (S,)           — neighbor submap index per owner
      w     (S, M)         — point weights (0 pads)
    S must divide by the axis extent. Each rank builds the (H, g) blocks of
    its S / n submaps, scatters them into the global (S, 6, 6) / (S, 6)
    system and sums it over the axis; every rank then takes the damped 6x6
    block-Jacobi steps (submap 0 fixed) and returns the new poses.
    """

    @f32_matmuls
    def step(poses, pts, tgt, nbr, w):
        dev = mesh_device(mesh)
        poses, pts, tgt, w = (torch.as_tensor(a).to(dev, torch.float32) for a in (poses, pts, tgt, w))
        nbr = torch.as_tensor(nbr).to(dev, torch.long)
        S = poses.shape[0]
        S_local = check_divisible(S, mesh, axis, "submaps")
        ids = axis_index(mesh, axis) * S_local + torch.arange(S_local, device=dev)
        p, q, wi = pts[ids], tgt[ids], w[ids]
        T_i, T_j = poses[ids], poses[nbr[ids]]
        pw = torch.einsum("smk,sjk->smj", p, T_i[:, :3, :3]) + T_i[:, None, :3, 3]
        qw = torch.einsum("smk,sjk->smj", q, T_j[:, :3, :3]) + T_j[:, None, :3, 3]
        r = (pw - qw) * wi[..., None]  # (S_local, M, 3)
        Jw = -se3.hat(pw)  # (S_local, M, 3, 3)
        Jv = torch.eye(3, device=dev).expand_as(Jw)
        J = torch.cat([Jw, Jv], dim=-1) * wi[..., None, None]  # (S_local, M, 3, 6)
        H_all = torch.zeros((S, 6, 6), device=dev).index_copy_(0, ids, torch.einsum("smik,smil->skl", J, J))
        g_all = torch.zeros((S, 6), device=dev).index_copy_(0, ids, torch.einsum("smik,smi->sk", J, r))
        H_all, g_all = psum(H_all, mesh, axis), psum(g_all, mesh, axis)
        eye = torch.eye(6, device=dev)
        dx = -torch.linalg.solve(H_all + 1e-6 * eye + 1e-9 * eye, g_all[..., None])[..., 0]  # (S, 6)
        dx = torch.where(torch.arange(S, device=dev)[:, None] > 0, dx, torch.zeros_like(dx))  # submap 0 fixed
        return se3.exp_se3(dx) @ poses

    return step


def optimize_submaps(poses, pts, tgt, nbr, w, mesh: DeviceMesh, n_iters: int = 10, axis: str = "sp"):
    """Run n_iters sharded GN steps. Arguments as in sharded_constraint_step,
    already padded so S is divisible by the axis size."""
    step = sharded_constraint_step(mesh, axis)
    poses = torch.as_tensor(poses).to(mesh_device(mesh), torch.float32)
    for _ in range(n_iters):
        poses = step(poses, pts, tgt, nbr, w)
    return poses
