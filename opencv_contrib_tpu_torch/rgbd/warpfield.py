"""DynaFu warp field — the port of opencv_contrib_tpu/rgbd/warpfield.py:
dual-quaternion blended deformation nodes and their non-rigid fit
(rgbd/src/warpfield.cpp, dqb.cpp, nonrigid_icp.cpp).

Node k-NN is a dense distance table and a top-k (node counts are in the
hundreds); the blend is closed-form quaternion arithmetic over all points
at once. `fit` runs plain gradient descent on the blended point-to-plane +
ARAP energy, its gradient by `torch.autograd` (where the JAX package takes
`jax.grad` inside a `lax.scan`): a Python loop of `iters` steps that stays
on the device and reads nothing back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_contrib_tpu_torch.core import se3


class WarpField(NamedTuple):
    nodes: torch.Tensor  # (N, 3) node positions (canonical frame)
    xi: torch.Tensor  # (N, 6) per-node se3 (w, v)
    sigma: torch.Tensor  # () influence radius


def make_warpfield(nodes, sigma: float = 0.1) -> WarpField:
    """Nodes at rest (xi = 0); nodes a tensor (kept on its device) or an array."""
    nodes = torch.as_tensor(nodes, dtype=torch.float32)
    return WarpField(nodes, torch.zeros((nodes.shape[0], 6), device=nodes.device),
                     torch.full((), sigma, dtype=torch.float32, device=nodes.device))


def _xi_to_dq(xi):
    """se3 (..., 6) -> unit dual quaternion (q_r, q_d) (dqb.cpp's
    UnitDualQuaternion)."""
    R, t = se3.mat_to_rt(se3.exp_se3(xi))
    qr = se3.mat_to_quat(R)  # (w, x, y, z)
    tq = torch.cat([torch.zeros_like(t[..., :1]), t], dim=-1)
    qd = 0.5 * se3.quat_mul(tq, qr)
    return qr, qd


def _dq_apply(qr, qd, p):
    """Apply blended (non-unit) dual quaternions (..., 4) to points (..., 3)."""
    n = torch.linalg.norm(qr, dim=-1, keepdim=True) + 1e-9
    qr = qr / n
    qd = qd / n
    R = se3.quat_to_mat(qr)
    # translation = 2 * qd * conj(qr), vector part
    t = (2.0 * se3.quat_mul(qd, se3.quat_conj(qr)))[..., 1:]
    return torch.einsum("...j,...ij->...i", p, R) + t


def warp_points(wf: WarpField, pts, k: int = 4):
    """DQB-blend the k nearest nodes of each point and apply them
    (warpfield.cpp applyWarp). pts (P, 3) -> (P, 3). Tied distances may pick
    other nodes than lax.top_k's order; the blend does not depend on it."""
    qr, qd = _xi_to_dq(wf.xi)  # (N, 4), (N, 4)
    d2 = ((pts[:, None] - wf.nodes[None]) ** 2).sum(-1)  # (P, N)
    negd, idx = torch.topk(-d2, k, dim=-1)  # (P, k)
    w = torch.exp(negd / (2 * wf.sigma ** 2))
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    # sign-align the k rotation quats to the nearest node's before blending
    qr_k = qr[idx]  # (P, k, 4)
    qd_k = qd[idx]
    sign = torch.sign(torch.sum(qr_k * qr_k[:, :1], dim=-1, keepdim=True) + 1e-12)
    qr_b = (qr_k * sign * w[..., None]).sum(1)
    qd_b = (qd_k * sign * w[..., None]).sum(1)
    return _dq_apply(qr_b, qd_b, pts)


def _energy(xi, wf: WarpField, src, tgt, tgt_normals, node_nbrs, k: int, lam: float):
    """The blended point-to-plane data term plus lam times the ARAP-lite
    regulariser: neighbouring nodes should move each other's positions alike
    (nonrigid_icp.cpp's regularisation)."""
    warped = warp_points(wf._replace(xi=xi), src, k=k)
    r = ((warped - tgt) * tgt_normals).sum(-1)
    data = torch.mean(r * r)
    Ti = se3.exp_se3(xi)  # (N, 4, 4)
    pj = wf.nodes[node_nbrs]  # (N, M, 3)
    Tj = Ti[node_nbrs]  # (N, M, 4, 4)
    via_i = torch.einsum("nmj,nij->nmi", pj, Ti[:, :3, :3]) + Ti[:, None, :3, 3]
    via_j = torch.einsum("nmj,nmij->nmi", pj, Tj[..., :3, :3]) + Tj[..., :3, 3]
    reg = torch.mean(((via_i - via_j) ** 2).sum(-1))
    return data + lam * reg


def node_neighbors(nodes, m: int = 4):
    """(N, m) nearest-node graph (excluding self), int64."""
    d2 = ((nodes[:, None] - nodes[None]) ** 2).sum(-1)
    d2 = d2 + torch.eye(nodes.shape[0], device=nodes.device) * 1e9
    _, idx = torch.topk(-d2, m, dim=-1)
    return idx


def fit(wf: WarpField, src, tgt, tgt_normals, node_nbrs, k: int = 4, iters: int = 30, lr: float = 0.05,
        lam: float = 1.0) -> WarpField:
    """Non-rigid fit: `iters` steps of gradient descent on `_energy`
    (nonrigid_icp.cpp estimateWarpNodes' role). src/tgt (P, 3)
    correspondences, tgt_normals (P, 3)."""
    xi = wf.xi.detach()
    with torch.enable_grad():
        for _ in range(iters):
            x = xi.requires_grad_(True)
            (g,) = torch.autograd.grad(_energy(x, wf, src, tgt, tgt_normals, node_nbrs, k, lam), x)
            xi = (x - lr * g).detach()
    return wf._replace(xi=xi)
