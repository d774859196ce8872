"""Sparse-observation bundle adjustment — the port of
opencv_contrib_tpu/ba/sparse.py.

The dense (C, P) observation grid of ba/bundle.py holds O(C P) Jacobians
whatever the fill. This solver works off a FLAT observation list of fixed
capacity:

  obs_cam (N,) int32   camera of each observation
  obs_pt  (N,) int32   point of each observation
  obs_uv  (2, N) f32   pixel measurement, channels first
  obs_ok  (N,) bool    validity (padding rows are False)

and its camera buckets, ObsBuckets.idx_a / ok_a (Kc, C): the observation row
of each slot of each camera's bucket, argsorted by camera on the host
(`build_buckets`), padding slots last. These stored arrays keep the JAX
package's layouts, so `interop` carries a problem and its buckets between
the two packages as they are.

Layout inside the solver. The JAX package keeps its per-observation tensors
channels first with the owner axis last, for XLA's (8, 128) tiling of the
two minor dimensions of a TPU buffer. CUDA tiles nothing, so the port puts
the owner first and the components last: per-slot values are (C, Kc, ...)
records, each camera's blocks are one batched product over its bucket, and
the closed-form Jacobians of ba/bundle.py::_project broadcast each camera
over its bucket with no gather.

Point sums are reproducible on the card. The bucket slots are sorted by
point once a solve (a stable sort on the device), and each point's slots are
reduced by `torch.segment_reduce` in an order fixed by the shapes, never by
a scatter-add, whose float atomics change the bits from run to run.

The camera system S = U - W V^-1 W^T is never formed: PCG with the
SCHUR_JACOBI block-diagonal preconditioner (Ceres' ITERATIVE_SCHUR), each
matvec one sweep from the cameras down to the points and one back. The LM
and CG loops keep lam, accept, alpha and beta on the device: given its
buckets, a solve makes no host sync before it returns.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opencv_contrib_tpu_torch.ba.bundle import _project, _small_mm
from opencv_contrib_tpu_torch.core import se3
from opencv_contrib_tpu_torch.utils.device import resolve
from opencv_contrib_tpu_torch.utils.precision import f32_matmuls


class SparseBAProblem(NamedTuple):
    cameras: torch.Tensor  # (C, 6) [rvec | tvec]
    points: torch.Tensor  # (P, 3)
    intr: torch.Tensor  # (9,)
    obs_cam: torch.Tensor  # (N,) int32
    obs_pt: torch.Tensor  # (N,) int32
    obs_uv: torch.Tensor  # (2, N) channels-first pixels
    obs_ok: torch.Tensor  # (N,) bool


class SparseBAResult(NamedTuple):
    cameras: torch.Tensor
    points: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor


class ObsBuckets(NamedTuple):
    """Camera-bucketed view of the flat observation list: bucket-slot axis
    first, camera axis last (the JAX package's arrays)."""

    idx_a: torch.Tensor  # (Kc, C) int32 observation row of each camera-bucket slot
    ok_a: torch.Tensor  # (Kc, C) bool


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def build_buckets(obs_cam, obs_pt, obs_ok, C: int, P: int, pad_to: int = 8, device="cuda") -> ObsBuckets:
    """Bucket construction on the host (a stable argsort by camera id, in
    numpy as in the JAX package); the buckets go to `device`."""
    obs_cam = _host(obs_cam)
    obs_ok = _host(obs_ok)

    owner = np.where(obs_ok, obs_cam, C)  # padding rows last
    order = np.argsort(owner, kind="stable")
    owner_s = owner[order]
    counts = np.bincount(owner_s, minlength=C + 1)[:C]
    K = max(pad_to, int(-(-max(1, counts.max()) // pad_to) * pad_to))
    idx = np.zeros((C, K), np.int32)
    ok = np.zeros((C, K), bool)
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(len(order))
    valid = owner_s < C
    slot = pos - starts[np.clip(owner_s, 0, C - 1)]
    idx[owner_s[valid], slot[valid]] = order[valid]
    ok[owner_s[valid], slot[valid]] = True
    dev = resolve(device)
    return ObsBuckets(torch.from_numpy(idx.T.copy()).to(dev), torch.from_numpy(ok.T.copy()).to(dev))


def from_dense(problem) -> SparseBAProblem:
    """A dense-grid BAProblem (ba/bundle.py) in the flat layout, on the
    problem's device. Host-side (the size depends on the mask): capacity =
    the valid entries rounded up to a multiple of 1024, so calls reuse
    shapes."""
    mask = _host(problem.mask)
    c_idx, p_idx = np.nonzero(mask)
    n = len(c_idx)
    cap = max(1024, int(np.ceil(n / 1024)) * 1024)
    obs_cam = np.zeros(cap, np.int32)
    obs_pt = np.zeros(cap, np.int32)
    obs_uv = np.zeros((2, cap), np.float32)
    obs_ok = np.zeros(cap, bool)
    obs_cam[:n] = c_idx
    obs_pt[:n] = p_idx
    obs_uv[:, :n] = _host(problem.obs)[c_idx, p_idx].T
    obs_ok[:n] = True
    dev = problem.cameras.device
    return SparseBAProblem(problem.cameras, problem.points, problem.intr,
                           *(torch.from_numpy(a).to(dev) for a in (obs_cam, obs_pt, obs_uv, obs_ok)))


# ---------------------------------------------------------------------------
# forward model and Jacobians


def _project_cf(cam_cf: torch.Tensor, X_cf: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Projection over columns, the JAX package's channels-first signature:
    cam_cf (6, N), X_cf (3, N) -> pixels (2, N). The model of
    ba/bundle.py::_project (OpenCVReprojectionError): Rodrigues rotation with
    its small-angle branch at theta^2 < 1e-8, translate, normalise with the
    depth clamped at |z| < 1e-9, distort, to pixels."""
    return _project(cam_cf.T, X_cf.T, intr)[0].T


def _obs_residual_jac(pose, X, uv, ok, intr):
    """Residuals and Jacobians of observations, components last: cameras
    `pose` (..., 6) against points X (..., 3) (broadcast), pixels uv (..., 2)
    and validity ok (...) -> r (..., 2), Jc (..., 2, 6), Jp (..., 2, 3), zero
    on invalid rows. The port of `_obs_residual_jac_cf`: closed-form
    Jacobians, where the JAX package takes 9 forward-mode jvps."""
    pred, Jc, Jp, _ = _project(pose, X, intr, jacobians=True)
    w = ok.to(pred.dtype)[..., None]
    return (pred - uv) * w, Jc * w[..., None], Jp * w[..., None]


def sparse_cost(cameras, points, intr, obs_cam, obs_pt, obs_uv, obs_ok):
    pred = _project(cameras[obs_cam], points[obs_pt], intr)[0]
    r = (pred - obs_uv.T) * obs_ok.to(pred.dtype)[:, None]
    return 0.5 * torch.sum(r * r)


def rms_reprojection_error(problem: SparseBAProblem) -> torch.Tensor:
    c = sparse_cost(*problem)
    n = torch.clamp(torch.sum(problem.obs_ok), min=1)
    return torch.sqrt(2.0 * c / n)


# ---------------------------------------------------------------------------
# 3x3 point blocks and the point-side sums


def _inv3x3(V: torch.Tensor) -> torch.Tensor:
    """Batched inverse of (..., 3, 3) by the adjugate, the determinant kept
    away from 0 by 1e-30 (the port of `_inv3x3_cf`, components last)."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 0], V[..., 1, 1], V[..., 1, 2]
    g, h, i = V[..., 2, 0], V[..., 2, 1], V[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    Cc = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    adj = torch.stack([torch.stack([A, B, Cc], -1), torch.stack([D, E, F], -1), torch.stack([G, H, I], -1)], -2)
    return adj / det[..., None, None]


class PointOrder(NamedTuple):
    """The camera-bucket slots (flattened camera-major) sorted by point."""

    perm: torch.Tensor  # (M,) slots in point order, stable: each point's in bucket order
    offsets: torch.Tensor  # (P + 2,) each point's first sorted slot, then the padding's, then M


def _point_order(seg: torch.Tensor, P: int) -> PointOrder:
    """seg (M,): each slot's point, P on padding slots. A stable device sort
    and a search: no host sync."""
    seg_sorted, perm = torch.sort(seg, stable=True)
    bounds = torch.arange(P + 1, dtype=seg_sorted.dtype, device=seg.device)
    end = torch.full((1,), seg.numel(), dtype=seg_sorted.dtype, device=seg.device)
    return PointOrder(perm, torch.cat([torch.searchsorted(seg_sorted, bounds), end]))


class BucketSlots(NamedTuple):
    """The observations of each camera-bucket slot, camera-major."""

    pt: torch.Tensor  # (C, Kc) int64 point (that of row 0 on padding slots)
    uv: torch.Tensor  # (C, Kc, 2) pixels
    ok: torch.Tensor  # (C, Kc) bool
    order: PointOrder


def _bucket_slots(problem: SparseBAProblem, buckets: ObsBuckets) -> BucketSlots:
    ia = buckets.idx_a.T.long()
    ok = buckets.ok_a.T
    pt = problem.obs_pt.long()[ia]
    order = _point_order(torch.where(ok, pt, problem.points.shape[0]).reshape(-1), problem.points.shape[0])
    return BucketSlots(pt, problem.obs_uv.T[ia], ok, order)


def _point_sums(vals: torch.Tensor, order: PointOrder) -> torch.Tensor:
    """Per-point sums of per-slot values (M, D) -> (P, D), each point's slots
    reduced in `order` by a segmented reduction of fixed shape, so the bits
    do not depend on scheduling. One 1-D reduction a component: on the card
    those run one block a segment, where the 2-D form runs one thread a
    segment and took 13.4 against 0.75 ms for three components at 2.2 M
    slots on an H100."""
    v = vals.T[:, order.perm]  # (D, M), components first
    return torch.stack([torch.segment_reduce(row, "sum", offsets=order.offsets, unsafe=True)[:-1] for row in v],
                       dim=1)  # the last segment holds the padding slots


# ---------------------------------------------------------------------------
# implicit-Schur PCG over buckets


class Sums:
    """The reductions of a solve that holds every camera's bucket: each is
    the identity. parallel/dist_ba.py passes the solver its mesh's version:
    there a rank holds the buckets of the cameras `cams`, and the point
    sums, the scalar products and the camera steps are completed across
    ranks (the JAX package's per-shard partials + psum under GSPMD)."""

    cams = slice(None)  # the cameras whose buckets this solve holds

    def points(self, x):  # (P, D) per-point sums: add the other ranks' partials
        return x

    def total(self, x):  # scalar sums
        return x

    def all_cams(self, x):  # (C_held, ...) -> every camera's
        return x


LOCAL = Sums()

_V_ENTRIES = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))  # V's distinct entries
_V_FULL = [0, 1, 2, 1, 3, 4, 2, 4, 5]  # V (3, 3), row-major, from them


def _solve_sparse_pcg(r, Jc, Jp, ptA, order: PointOrder, lam, cam_free, pt_free, n_cg: int, sums: Sums = LOCAL):
    """One damped implicit-Schur step by PCG over the camera buckets.

    r (C, Kc, 2), Jc (C, Kc, 2, 6), Jp (C, Kc, 2, 3): each bucket slot's
    residual and Jacobians, zero on padding slots; ptA (C, Kc) each slot's
    point (any valid index on padding slots); `order` the slots sorted by
    point; cam_free (C,) of the same cameras, pt_free (P,) of every point.
    Returns dcam (C, 6), dpt (P, 3) and `solved`, a device bool that is
    false when the LU of a preconditioner block met a zero pivot (the JAX
    package's inverse then gives a non-finite step, which LM rejects).
    Under a mesh's `sums` the C cameras are this rank's: the CG vectors stay
    sharded by camera, and each matvec completes its point sums with one
    reduction."""
    C, Kc = ptA.shape
    P = pt_free.shape[0]
    dt, dev = r.dtype, r.device
    Jc2 = Jc.reshape(C, Kc * 2, 6)

    def point_sums(v):  # (C, Kc, D) -> (P, D)
        return sums.points(_point_sums(v.reshape(C * Kc, -1), order))

    # camera blocks: one batched product over each camera's bucket
    U = Jc2.transpose(1, 2) @ Jc2  # (C, 6, 6)
    bc = -torch.einsum("ckri,ckr->ci", Jc, r)  # (C, 6)

    # point blocks: V's 6 distinct entries and bp in one sum over each point's slots
    Vu = torch.stack([torch.sum(Jp[..., j] * Jp[..., l], dim=-1) for j, l in _V_ENTRIES], dim=-1)
    bpo = -torch.sum(Jp * r[..., None], dim=-2)  # (C, Kc, 3)
    vb = point_sums(torch.cat([Vu, bpo], dim=-1))  # (P, 9)
    V = torch.stack([vb[:, k] for k in _V_FULL], dim=-1).reshape(P, 3, 3)  # no index tensor: no copy to the card
    bp = vb[:, 6:]

    # LM damping (multiplicative) and the freeze of fixed points
    U = U + torch.diag_embed(lam * torch.clamp(torch.diagonal(U, dim1=1, dim2=2), min=1e-6))
    dV = torch.clamp(torch.diagonal(V, dim1=1, dim2=2), min=1e-6)
    V = V + torch.diag_embed(lam * dV + (~pt_free).to(dt)[:, None] * 1e12)
    Vinv = _inv3x3(V)  # (P, 3, 3)
    free = cam_free.to(dt)[:, None]

    def vinv_mul(v):  # (P, 3) -> V^-1 v, elementwise: a batched GEMV spends a tile on each 3x3
        return torch.sum(Vinv * v[:, None, :], dim=-1)

    def halfdown(x):
        """x (C, 6) -> (P, 3): the sum over a point's observations of Jp^T Jc x."""
        a = torch.einsum("ckri,ci->ckr", Jc, x)
        return point_sums(torch.sum(Jp * a[..., None], dim=-2))

    def halfup(vz):
        """vz (P, 3) -> (C, 6): the sum over a camera's observations of
        Jc^T Jp vz[point]."""
        t = torch.sum(Jp * vz[ptA][..., None, :], dim=-1)  # (C, Kc, 2)
        return torch.einsum("ckri,ckr->ci", Jc, t)

    def matvec(x):
        x = x * free
        vz = vinv_mul(halfdown(x))
        sx = torch.einsum("cij,cj->ci", U, x) - halfup(vz)
        return sx * free + x * (1.0 - free)

    # rhs = bc - W V^-1 bp
    rhs = (bc - halfup(vinv_mul(bp))) * free

    # SCHUR_JACOBI preconditioner: the diagonal blocks U - sum Jc^T Jp V^-1 Jp^T Jc of S
    G = _small_mm(Jp, Vinv[ptA])  # (C, Kc, 2, 3)
    H = _small_mm(G, Jp.transpose(-1, -2))  # (C, Kc, 2, 2)
    T = _small_mm(H.transpose(-1, -2), Jc).reshape(C, Kc * 2, 6)
    WVW = T.transpose(1, 2) @ Jc2  # (C, 6, 6)
    Minv, info = torch.linalg.inv_ex(U - WVW + 1e-9 * torch.eye(6, dtype=dt, device=dev))

    def prec(x):
        return torch.einsum("cij,cj->ci", Minv, x) * free + x * (1.0 - free)

    # from x = 0, where res = rhs - matvec(0) = rhs
    x = torch.zeros_like(rhs)
    res = rhs
    z = prec(res)
    p = z
    rz = sums.total(torch.sum(res * z))
    zero = torch.zeros((), dtype=dt, device=dev)
    for _ in range(n_cg):
        Ap = matvec(p)
        denom = sums.total(torch.sum(p * Ap))
        alpha = torch.where(torch.abs(denom) > 1e-20, rz / denom, zero)
        x = x + alpha * p
        res = res - alpha * Ap
        z = prec(res)
        rz_new = sums.total(torch.sum(res * z))
        beta = torch.where(torch.abs(rz) > 1e-20, rz_new / rz, zero)
        p = z + beta * p
        rz = rz_new
    dcam = x * free
    # back-substitute the points: dp = V^-1 (bp - W^T dcam)
    dpt = vinv_mul(bp - halfdown(dcam)) * pt_free.to(dt)[:, None]
    return dcam, dpt, sums.total(torch.sum(info != 0)) == 0


def bundle_adjust_sparse(
    problem: SparseBAProblem,
    n_iters: int = 20,
    fix_first_cam: bool = True,
    cam_free: torch.Tensor | None = None,
    pt_free: torch.Tensor | None = None,
    lam0: float = 1e-4,
    n_cg: int = 30,
    buckets: ObsBuckets | None = None,
) -> SparseBAResult:
    """LM over the flat observation list, on the problem's device; matches
    ba/bundle.py::bundle_adjust on equivalent problems. Without `buckets`
    they are built on the host first (the observation list is read back);
    pass them when solving the same sparsity pattern again."""
    if buckets is None:
        buckets = build_buckets(problem.obs_cam, problem.obs_pt, problem.obs_ok, problem.cameras.shape[0],
                                problem.points.shape[0], device=problem.cameras.device)
    return _bundle_adjust_sparse_jit(problem, buckets, n_iters, fix_first_cam, cam_free, pt_free, lam0, n_cg)


@f32_matmuls
def _bundle_adjust_sparse_jit(
    problem: SparseBAProblem,
    buckets: ObsBuckets,
    n_iters: int = 20,
    fix_first_cam: bool = True,
    cam_free: torch.Tensor | None = None,
    pt_free: torch.Tensor | None = None,
    lam0: float = 1e-4,
    n_cg: int = 30,
    sums: Sums = LOCAL,
) -> SparseBAResult:
    """The LM loop on given buckets, with the JAX package's signature (its
    jitted body): a fixed number of iterations with the accept / reject on
    the device, no host sync. Points with no valid observation do not move.
    Under a mesh's `sums` (parallel/dist_ba.py) `buckets` hold the columns
    of the cameras `sums.cams`; cameras and points stay whole."""
    cams, pts, intr = problem.cameras, problem.points, problem.intr
    C, P = cams.shape[0], pts.shape[0]
    dt, dev = cams.dtype, cams.device
    cam_free = torch.ones(C, dtype=torch.bool, device=dev) if cam_free is None else cam_free.to(torch.bool)
    if fix_first_cam:  # a mask, not an item assignment, which would copy the value to the card
        cam_free = cam_free & (torch.arange(C, device=dev) > 0)
    cam_free = cam_free[sums.cams]
    if pt_free is None:
        pt_free = torch.ones(P, dtype=torch.bool, device=dev)

    sl = _bucket_slots(problem, buckets)
    pt_free = pt_free.to(torch.bool) & (sums.points(sl.order.offsets[1:P + 1] - sl.order.offsets[:P]) > 0)

    def total_cost(c, p):  # sparse_cost over the bucket slots: one rotation a camera
        r = (_project(c[sums.cams][:, None], p[sl.pt], intr)[0] - sl.uv) * sl.ok.to(dt)[..., None]
        return sums.total(0.5 * torch.sum(r * r))

    lam = torch.full((), lam0, dtype=dt, device=dev)
    c0 = cost = total_cost(cams, pts)
    for _ in range(n_iters):
        r, Jc, Jp = _obs_residual_jac(cams[sums.cams][:, None], pts[sl.pt], sl.uv, sl.ok, intr)
        dcam, dpt, solved = _solve_sparse_pcg(r, Jc, Jp, sl.pt, sl.order, lam, cam_free, pt_free, n_cg, sums)
        new_cams, new_pts = cams + sums.all_cams(dcam), pts + dpt
        c_new = total_cost(new_cams, new_pts)
        accept = (c_new < cost) & solved
        cams = torch.where(accept, new_cams, cams)
        pts = torch.where(accept, new_pts, pts)
        cost = torch.where(accept, c_new, cost)  # the cost of (cams, pts), as a recomputation gives it
        lam = torch.where(accept, torch.clamp(lam * 0.33, min=1e-9), torch.clamp(lam * 4.0, max=1e6))
    return SparseBAResult(cams, pts, c0, cost)


def make_sparse_problem(Rs, ts, points3d, intr, obs_cam, obs_pt, obs_uv, obs_ok, device="cuda") -> SparseBAProblem:
    """Pack (R, t) pose arrays into the angle-axis flat-observation layout on
    `device`. obs_uv is taken as (N, 2) or (2, N) and stored channels first."""
    dev = resolve(device)

    def f(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    cams = torch.cat([se3.log_so3(f(Rs)), f(ts)], dim=-1)
    uv = f(obs_uv)
    if uv.ndim == 2 and uv.shape[0] != 2:
        uv = uv.T.contiguous()
    return SparseBAProblem(cams, f(points3d), f(intr), f(obs_cam, torch.int32), f(obs_pt, torch.int32), uv,
                           f(obs_ok, torch.bool))
