"""Pose graph optimisation: SE(3) nodes, relative-pose edges, LM (the port
of opencv_contrib_tpu/rgbd/posegraph.py; pose_graph.cpp PoseGraphImpl
:108-201, optimize :576).

Edges live in padded tensors (E, ...) with a validity mask. The Jacobians
of each edge's residual with respect to left-multiplied increments of its
two poses come from one forward-mode pass (`torch.autograd.forward_ad`)
through the same se3 maps as the residual: the 12 tangent directions ride
as a batch dimension, so the pass is as wide as 12 residual evaluations.
The Hessian is dense (6N x 6N; pose graphs here have tens of nodes) and is
assembled by `index_put_(accumulate=True)`, which adds every edge of a node
shared by several edges. The LM loop runs on the device: accept / reject
and the damping are selects, and the solve is `solve_ex`, so no step reads
a value back to the host. The first node is gauge-fixed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from opencv_contrib_tpu_torch.core import se3
from opencv_contrib_tpu_torch.utils.device import resolve


class PoseGraph(NamedTuple):
    poses: torch.Tensor  # (N, 4, 4) node poses (world <- node)
    edges_ij: torch.Tensor  # (E, 2) int node indices
    edges_T: torch.Tensor  # (E, 4, 4) measured relative pose: node_j in node_i
    edges_info: torch.Tensor  # (E, 6, 6) information matrices
    edges_valid: torch.Tensor  # (E,) bool
    fixed: torch.Tensor  # (N,) bool: gauge-fixed nodes


def _tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def make_graph(poses, edges_ij, edges_T, edges_info=None, edges_valid=None, fixed=None,
               device="cuda") -> PoseGraph:
    """A PoseGraph on `device` from host arrays (or tensors). By default
    every edge has identity information and is valid, and node 0 is fixed."""
    dev = resolve(device)
    poses = _tensor(poses, torch.float32, dev)
    edges_ij = _tensor(edges_ij, torch.int64, dev)
    E, N = edges_ij.shape[0], poses.shape[0]
    if edges_info is None:
        edges_info = torch.eye(6, device=dev).expand(E, 6, 6)
    if edges_valid is None:
        edges_valid = torch.ones(E, dtype=torch.bool, device=dev)
    if fixed is None:
        fixed = torch.arange(N, device=dev) == 0
    return PoseGraph(poses, edges_ij, _tensor(edges_T, torch.float32, dev),
                     _tensor(edges_info, torch.float32, dev).contiguous(), _tensor(edges_valid, torch.bool, dev),
                     _tensor(fixed, torch.bool, dev))


def edge_residual(Ti: torch.Tensor, Tj: torch.Tensor, Tij_meas: torch.Tensor) -> torch.Tensor:
    """r = log(Tij_meas^-1 (Ti^-1 Tj)) in se(3), batched over leading
    dimensions: the between-factor residual (pose_graph.cpp poseError)."""
    return se3.log_se3(se3.inverse(Tij_meas) @ (se3.inverse(Ti) @ Tj))


def total_cost(g: PoseGraph, poses=None) -> torch.Tensor:
    if poses is None:
        poses = g.poses
    ij = g.edges_ij.long()
    r = edge_residual(poses[ij[:, 0]], poses[ij[:, 1]], g.edges_T)
    w = g.edges_valid.to(torch.float32)
    return 0.5 * torch.sum(w[:, None] * r * torch.einsum("eij,ej->ei", g.edges_info, r))


def _residuals_and_jac(g: PoseGraph, poses: torch.Tensor):
    """Residuals (E, 6) and their Jacobians (E, 6, 6) with respect to the
    increments xi_i, xi_j of Pi = exp(xi_i) Ti, Pj = exp(xi_j) Tj at 0."""
    ij = g.edges_ij.long()
    Ti, Tj = poses[ij[:, 0]], poses[ij[:, 1]]
    E = Ti.shape[0]
    eye = torch.eye(6, dtype=poses.dtype, device=poses.device)
    zero = torch.zeros_like(eye)
    ti = torch.cat([eye, zero])[:, None, :].expand(12, E, 6).contiguous()  # tangent k < 6 moves xi_i
    tj = torch.cat([zero, eye])[:, None, :].expand(12, E, 6).contiguous()  # tangent k >= 6 moves xi_j
    z = torch.zeros((12, E, 6), dtype=poses.dtype, device=poses.device)
    with fwAD.dual_level():
        xi, xj = fwAD.make_dual(z, ti), fwAD.make_dual(z, tj)
        r, dr = fwAD.unpack_dual(edge_residual(se3.exp_se3(xi) @ Ti, se3.exp_se3(xj) @ Tj, g.edges_T))
    J = dr.permute(1, 2, 0)  # (E, 6 residuals, 12 directions)
    return r[0], J[..., :6], J[..., 6:]


def _block_index(a: torch.Tensor, b: torch.Tensor):
    """Row and column indices into the (6N, 6N) matrix of the 6x6 blocks
    (a[e], b[e]), each (E, 6, 6)."""
    k = torch.arange(6, device=a.device)
    rows = (6 * a)[:, None, None] + k[None, :, None]
    cols = (6 * b)[:, None, None] + k[None, None, :]
    return torch.broadcast_tensors(rows, cols)


def optimize(g: PoseGraph, n_iters: int = 30, lam0: float = 1e-4) -> tuple[PoseGraph, torch.Tensor]:
    """LM over all node poses: left-multiplied se(3) increments, the dense
    block Hessian assembled by scatter-add, gauge-fixed nodes pinned.
    Returns (optimized graph, (initial_cost, final_cost))."""
    N = g.poses.shape[0]
    dev = g.poses.device
    ij = g.edges_ij.long()
    i_idx, j_idx = ij[:, 0], ij[:, 1]
    w = g.edges_valid.to(torch.float32)
    Info = g.edges_info * w[:, None, None]
    # the four blocks each edge adds to, and its two rows of b
    bi_r, bi_c = _block_index(i_idx, i_idx)
    bj_r, bj_c = _block_index(j_idx, j_idx)
    bij_r, bij_c = _block_index(i_idx, j_idx)
    rows = torch.cat([bi_r.reshape(-1), bj_r.reshape(-1), bij_r.reshape(-1), bij_c.reshape(-1)])
    cols = torch.cat([bi_c.reshape(-1), bj_c.reshape(-1), bij_c.reshape(-1), bij_r.reshape(-1)])
    k6 = torch.arange(6, device=dev)
    b_rows = torch.cat([(6 * i_idx[:, None] + k6).reshape(-1), (6 * j_idx[:, None] + k6).reshape(-1)])
    free = (~g.fixed).to(torch.float32)
    free6 = free.repeat_interleave(6)
    eye = torch.eye(6 * N, device=dev)

    poses = g.poses
    lam = torch.full((), lam0, dtype=torch.float32, device=dev)
    c0 = total_cost(g)
    for _ in range(n_iters):
        r, Ji, Jj = _residuals_and_jac(g, poses)
        JiI = torch.einsum("eki,ekl->eil", Ji, Info)  # Ji^T Info
        JjI = torch.einsum("eki,ekl->eil", Jj, Info)
        Hii = torch.einsum("eil,elj->eij", JiI, Ji)
        Hjj = torch.einsum("eil,elj->eij", JjI, Jj)
        Hij = torch.einsum("eil,elj->eij", JiI, Jj)
        bi = -torch.einsum("eil,el->ei", JiI, r)
        bj = -torch.einsum("eil,el->ei", JjI, r)
        H = torch.zeros(6 * N, 6 * N, device=dev).index_put_(
            (rows, cols), torch.cat([Hii.reshape(-1), Hjj.reshape(-1), Hij.reshape(-1), Hij.reshape(-1)]),
            accumulate=True)
        b = torch.zeros(6 * N, device=dev).index_put_((b_rows,), torch.cat([bi.reshape(-1), bj.reshape(-1)]),
                                                      accumulate=True)

        # gauge fixing + damping
        Hf = H * free6[:, None] * free6[None, :]
        diag = torch.clamp(torch.abs(torch.diagonal(H)), min=1e-6)
        Hf = Hf + torch.diag_embed(lam * diag * free6 + (1.0 - free6))
        dx = torch.linalg.solve_ex(Hf + 1e-9 * eye, b * free6)[0].reshape(N, 6) * free[:, None]
        new_poses = se3.exp_se3(dx) @ poses
        accept = total_cost(g, new_poses) < total_cost(g, poses)
        poses = torch.where(accept, new_poses, poses)
        lam = torch.where(accept, torch.clamp(lam * 0.33, min=1e-9), torch.clamp(lam * 4.0, max=1e8))
    return g._replace(poses=poses), torch.stack([c0, total_cost(g, poses)])
