"""Two-view geometry: fundamental / essential matrices and motion recovery —
the port of opencv_contrib_tpu/mvg/fundamental.py.

Every solver takes leading batch dimensions, so RANSAC solves all of its
minimal samples in one batched call. Null vectors come from an SVD of a
square system: a tall system is first reduced to its QR factor R (the same
singular values and right vectors), a wide one gets the full right basis.
On the card a batch of small squares is one cuSOLVER call, where tall
systems would take one call each. Singular vectors carry an arbitrary sign:
F and H are normalised by their [2, 2] entry, points by their homogeneous
coordinate, and `motions_from_essential` returns the four candidates in an
order that depends on the signs, so a caller picks by cheirality, never by
index.
"""

from __future__ import annotations

import math

import torch

from opencv_contrib_tpu_torch.core import se3
from opencv_contrib_tpu_torch.mvg import conditioning


def _epipolar_constraint_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Rows of the linear system x2' F x1 = 0. x1, x2 (..., N, 2) -> A (..., N, 9)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = torch.ones_like(u1)
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], dim=-1)


def _right_singular_vectors(A: torch.Tensor) -> torch.Tensor:
    """Vh (..., n, n) of A (..., m, n): the right singular vectors as rows,
    that of the smallest singular value last (the null space of a wide A
    included). A direct SVD, not eigh of A^T A, which would square the
    condition number."""
    if A.shape[-2] > A.shape[-1]:
        A = torch.linalg.qr(A, mode="r")[1]
    return torch.linalg.svd(A, full_matrices=True)[2]


def _smallest_singular_vector(A: torch.Tensor) -> torch.Tensor:
    """Null-space direction of A (..., N, D): its smallest right singular vector."""
    return _right_singular_vectors(A)[..., -1, :]


def _normalize_by_22(F: torch.Tensor) -> torch.Tensor:
    f22 = F[..., 2:3, 2:3]
    return F / torch.where(torch.abs(f22) < 1e-12, torch.ones_like(f22), f22)


def eight_point(x1: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Normalized 8-point fundamental solver on (..., N, 2) correspondences,
    with a validity mask (..., N) for padded inputs. Returns F (..., 3, 3)."""
    if mask is None:
        mask = torch.ones(x1.shape[:-1], dtype=torch.bool, device=x1.device)
    T1 = conditioning.preconditioner_from_points(x1, mask)
    T2 = conditioning.preconditioner_from_points(x2, mask)
    x1n = conditioning.apply_transform(T1, x1)
    x2n = conditioning.apply_transform(T2, x2)
    A = _epipolar_constraint_rows(x1n, x2n) * mask[..., None].to(x1.dtype)
    F = _smallest_singular_vector(A).reshape(A.shape[:-2] + (3, 3))
    # enforce rank 2
    U, S, Vh = torch.linalg.svd(F)
    keep = torch.ones_like(S)
    keep[..., 2] = 0.0
    F = (U * (S * keep)[..., None, :]) @ Vh
    return _normalize_by_22(T2.mT @ F @ T1)


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactors."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def seven_point(x1: torch.Tensor, x2: torch.Tensor):
    """7-point solver on (..., 7, 2) correspondences: up to 3 fundamental
    candidates (..., 3, 3, 3) and a validity flag per root (...,  3)."""
    T1 = conditioning.preconditioner_from_points(x1)
    T2 = conditioning.preconditioner_from_points(x2)
    x1n = conditioning.apply_transform(T1, x1)
    x2n = conditioning.apply_transform(T2, x2)
    Vh = _right_singular_vectors(_epipolar_constraint_rows(x1n, x2n))  # (..., 9, 9)
    F1 = Vh[..., -1, :].reshape(Vh.shape[:-2] + (3, 3))
    F2 = Vh[..., -2, :].reshape(Vh.shape[:-2] + (3, 3))

    # det(a F1 + (1 - a) F2) = 0 is a cubic in a; its coefficients from its
    # values at 4 points
    def d(a):
        return _det3(a * F1 + (1 - a) * F2)

    d0, d1, dm1, d2 = d(0.0), d(1.0), d(-1.0), d(2.0)
    c0 = d0
    c2 = (d1 + dm1) / 2.0 - c0
    c3 = (d2 - 2.0 * d1 + d0 - 2.0 * c2) / 6.0
    c1 = d1 - c0 - c2 - c3
    roots, valid = _cubic_roots(c3, c2, c1, c0)
    a = roots[..., :, None, None]
    Fs = a * F1[..., None, :, :] + (1 - a) * F2[..., None, :, :]
    Fs = T2.mT[..., None, :, :] @ Fs @ T1[..., None, :, :]
    return _normalize_by_22(Fs), valid


def _cubic_roots(a, b, c, d):
    """Real roots of a x^3 + b x^2 + c x + d, elementwise over (...): roots
    (..., 3) and valid (..., 3). Falls back to the quadratic and linear cases
    when the leading coefficients vanish; branch-free, every case computed
    and one selected."""
    eps = 1e-12
    is_cubic = torch.abs(a) > eps
    one = torch.ones_like(a)

    # cubic, trigonometric method: three real roots when disc <= 0
    an = torch.where(is_cubic, a, one)
    p = (3.0 * an * c - b * b) / (3.0 * an * an)
    q = (2.0 * b ** 3 - 9.0 * an * b * c + 27.0 * an * an * d) / (27.0 * an ** 3)
    shift = -b / (3.0 * an)
    disc = (q * q) / 4.0 + (p ** 3) / 27.0
    safe_p = torch.clamp(p, max=-eps)
    m = 2.0 * torch.sqrt(-safe_p / 3.0)
    acos_arg = torch.clamp(3.0 * q / (safe_p * m), -1.0, 1.0)
    theta = torch.arccos(acos_arg) / 3.0
    k = torch.arange(3, dtype=a.dtype, device=a.device)
    roots3 = m[..., None] * torch.cos(theta[..., None] - 2.0 * math.pi * k / 3.0) + shift[..., None]
    # one real root when disc > 0 (Cardano)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))

    def cbrt(x):
        return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)

    root1 = cbrt(-q / 2.0 + sq) + cbrt(-q / 2.0 - sq) + shift
    first = k == 0
    three_real = (disc <= 0)[..., None]
    cubic_roots = torch.where(three_real, roots3, root1[..., None].expand(roots3.shape))
    cubic_valid = three_real | first

    # quadratic fallback
    is_quad = (~is_cubic) & (torch.abs(b) > eps)
    bq = torch.where(torch.abs(b) > eps, b, one)
    qdisc = c * c - 4.0 * bq * d
    sqq = torch.sqrt(torch.clamp(qdisc, min=0.0))
    quad_roots = torch.stack([(-c + sqq) / (2.0 * bq), (-c - sqq) / (2.0 * bq), torch.zeros_like(c)], dim=-1)
    quad_valid = (k < 2) & (qdisc >= 0)[..., None]

    # linear fallback
    lin_root = -d / torch.where(torch.abs(c) > eps, c, one)
    lin_roots = torch.stack([lin_root, torch.zeros_like(lin_root), torch.zeros_like(lin_root)], dim=-1)
    lin_valid = first & (torch.abs(c) > eps)[..., None]

    cub, quad = is_cubic[..., None], is_quad[..., None]
    roots = torch.where(cub, cubic_roots, torch.where(quad, quad_roots, lin_roots))
    valid = torch.where(cub, cubic_valid, torch.where(quad, quad_valid, lin_valid))
    return roots, valid


def _homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _epipolar_lines(F, x1, x2):
    """F x1 (..., N, 3), F' x2 and x2' F x1 (..., N) for F (..., 3, 3)."""
    x1h, x2h = _homogeneous(x1), _homogeneous(x2)
    Fx1 = torch.einsum("...ij,...nj->...ni", F, x1h)
    Ftx2 = torch.einsum("...ji,...nj->...ni", F, x2h)
    return Fx1, Ftx2, torch.sum(x2h * Fx1, dim=-1)


def sampson_distance(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) distance of correspondences (..., N, 2)
    to F (..., 3, 3): (..., N)."""
    Fx1, Ftx2, s = _epipolar_lines(F, x1, x2)
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return s ** 2 / torch.clamp(den, min=1e-12)


def epipolar_distance(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Symmetric point-to-epipolar-line distance (squared px): (..., N)."""
    Fx1, Ftx2, s = _epipolar_lines(F, x1, x2)
    s = s ** 2
    d1 = s / torch.clamp(Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2, min=1e-12)
    d2 = s / torch.clamp(Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2, min=1e-12)
    return 0.5 * (d1 + d2)


def essential_from_fundamental(F: torch.Tensor, K1: torch.Tensor, K2: torch.Tensor) -> torch.Tensor:
    """E = K2' F K1."""
    return K2.mT @ F @ K1


def fundamental_from_essential(E: torch.Tensor, K1: torch.Tensor, K2: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv_ex(K2)[0].mT @ E @ torch.linalg.inv_ex(K1)[0]


def essential_from_Rt(R1, t1, R2, t2) -> torch.Tensor:
    """E from two absolute poses."""
    R, t = relative_camera_motion(R1, t1, R2, t2)
    return se3.hat(t) @ R


def relative_camera_motion(R1, t1, R2, t2):
    """(R, t) of camera 2 relative to camera 1."""
    R = R2 @ R1.mT
    t = t2 - torch.einsum("...ij,...j->...i", R, t1)
    return R, t


def project_to_essential(E: torch.Tensor) -> torch.Tensor:
    """Nearest valid essential matrix: singular values (s, s, 0)."""
    U, S, Vh = torch.linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) * 0.5
    keep = torch.ones_like(S)
    keep[..., 2] = 0.0
    return (U * keep[..., None, :] * s[..., None, None]) @ Vh


def motions_from_essential(E: torch.Tensor):
    """All four (R, t) decompositions of E (3, 3): Rs (4, 3, 3), ts (4, 3),
    as [Ra, Ra, Rb, Rb] with [t, -t, t, -t]."""
    U, _, Vh = torch.linalg.svd(E)
    # force proper rotations
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vh = Vh * torch.sign(torch.linalg.det(Vh))[..., None, None]
    W = torch.zeros_like(E)
    W[..., 0, 1], W[..., 1, 0], W[..., 2, 2] = -1.0, 1.0, 1.0
    Ra = U @ W @ Vh
    Rb = U @ W.mT @ Vh
    t = U[..., :, 2]
    return torch.stack([Ra, Ra, Rb, Rb], dim=-3), torch.stack([t, -t, t, -t], dim=-2)


def choose_motion_cheirality(Rs, ts, x1n, x2n, mask=None):
    """The (R, t) of the 4 candidates with the most points in front of both
    cameras, on normalized (calibrated) points x1n / x2n (N, 2), with a
    validity mask (N,). Returns (R, t, best_index); ties go to the first."""
    if mask is None:
        mask = torch.ones(x1n.shape[:-1], dtype=torch.bool, device=x1n.device)
    z1, z2 = _two_view_depths(Rs, ts, x1n, x2n)  # (4, N)
    counts = torch.sum((z1 > 0) & (z2 > 0) & mask, dim=-1)
    best = torch.argmax(counts, dim=0, keepdim=True)  # (1,): gathers without a host read
    return Rs[best][0], ts[best][0], best[0]


def _two_view_depths(R, t, x1n, x2n):
    """Depths in both views of the DLT-triangulated points: camera 1 at the
    identity, camera 2 at each (R (C, 3, 3), t (C, 3)). Returns (C, N) twice."""
    P2 = torch.cat([R, t[..., None]], dim=-1)  # (C, 3, 4)
    P1 = torch.zeros_like(P2[0])
    P1[0, 0], P1[1, 1], P1[2, 2] = 1.0, 1.0, 1.0
    a, b = x1n[..., None], x2n[..., None]  # (N, 1)
    rows1 = torch.stack([a[:, 0] * P1[2] - P1[0], a[:, 1] * P1[2] - P1[1]], dim=-2)  # (N, 2, 4)
    rows2 = torch.stack([b[None, :, 0] * P2[:, None, 2] - P2[:, None, 0],
                         b[None, :, 1] * P2[:, None, 2] - P2[:, None, 1]], dim=-2)  # (C, N, 2, 4)
    A = torch.cat([rows1.expand(rows2.shape), rows2], dim=-2)  # (C, N, 4, 4)
    X = _smallest_singular_vector(A)
    w = X[..., 3:]
    X = X[..., :3] / torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    z1 = X[..., 2]
    z2 = (torch.einsum("cij,cnj->cni", R, X) + t[:, None, :])[..., 2]
    return z1, z2


def projections_from_fundamental(F: torch.Tensor):
    """Canonical projective cameras (P1, P2) from F (3, 3). The epipole's
    sign is the SVD's, so P2 is defined up to sign, as a camera is."""
    P1 = torch.zeros(3, 4, dtype=F.dtype, device=F.device)
    P1[0, 0], P1[1, 1], P1[2, 2] = 1.0, 1.0, 1.0
    # epipole e2: left null vector of F (smallest left singular vector)
    U, _, _ = torch.linalg.svd(F)
    e2 = U[:, 2]
    P2 = torch.cat([se3.hat(e2) @ F, e2[:, None]], dim=1)
    return P1, P2
