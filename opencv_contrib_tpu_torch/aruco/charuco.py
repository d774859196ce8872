"""ChArUco boards + marker pose estimation (the port of
opencv_contrib_tpu/aruco/charuco.py).

Reference anchors: aruco/src/charuco.cpp (CharucoBoard::draw /
interpolateCornersCharuco: chessboard corners interpolated from detected
marker homographies) and aruco/src/aruco_calib.cpp + objdetect's
estimatePoseSingleMarkers (per-marker PnP from the 4 corners).

The board drawing, the corner interpolation's DLT and the planar pose
initialisation (DLT, SVD) are host stages, as in the twin: the DLT runs on
CPU tensors. The Gauss-Newton pose refinement runs on K's device (a
tensor K on the card refines there), every marker's pose read back once.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.aruco.markers import draw_marker
from opencv_contrib_tpu_torch.mvg import homography as hmod
from opencv_contrib_tpu_torch.mvg import resection
from opencv_contrib_tpu_torch.utils.device import constant


def _host_dlt(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The DLT homography dst ~ H src on the host (CPU tensors)."""
    return hmod.dlt(torch.from_numpy(np.asarray(src, np.float32)),
                    torch.from_numpy(np.asarray(dst, np.float32))).numpy()


def draw_charuco_board(dictionary, squares=(5, 5), square_px: int = 32,
                       marker_frac: float = 0.75):
    """Render a ChArUco board (CharucoBoard::draw): chessboard with markers
    in the white squares. Returns (img, marker_ids, marker_centers_sq)."""
    sy, sx = squares
    img = np.ones((sy * square_px, sx * square_px), np.float32)
    mpx = int(square_px * marker_frac)
    pad = (square_px - mpx) // 2
    mid = 0
    ids, centers = [], []
    for r in range(sy):
        for c in range(sx):
            y0, x0 = r * square_px, c * square_px
            if (r + c) % 2 == 0:
                img[y0:y0 + square_px, x0:x0 + square_px] = 0.0
            else:
                if mid < dictionary.shape[0]:
                    m = draw_marker(dictionary, mid, mpx)
                    img[y0 + pad:y0 + pad + mpx, x0 + pad:x0 + pad + mpx] = m
                    ids.append(mid)
                    centers.append((r + 0.5, c + 0.5))
                    mid += 1
    return img, ids, np.asarray(centers, np.float32)


def interpolate_charuco_corners(marker_ids, marker_corners, board_ids, board_centers_sq,
                                squares=(5, 5), square_px: int = 32):
    """Interior chessboard corners from detected markers
    (interpolateCornersCharuco): fit one homography board->image over all
    detected marker corners, then map every interior corner through it.
    Returns (corner_ids, corners_yx (K, 2))."""
    sy, sx = squares
    src, dst = [], []
    pad_frac = (1 - 0.75) / 2
    for mid, quad in zip(marker_ids, marker_corners):
        if mid not in board_ids:
            continue
        r, c = board_centers_sq[board_ids.index(mid)]
        # marker corner positions on the board (in pixels), TL TR BR BL to
        # match _find_quads' corner ordering (y, x)
        y0 = (r - 0.5 + pad_frac) * square_px
        y1 = (r + 0.5 - pad_frac) * square_px
        x0 = (c - 0.5 + pad_frac) * square_px
        x1 = (c + 0.5 - pad_frac) * square_px
        src.extend([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
        # quad is (4, 2) (y, x); order: sorted by angle (TL, TR, BR, BL)
        dst.extend(np.asarray(quad)[:, ::-1].tolist())
    if len(src) < 8:
        return [], np.zeros((0, 2), np.float32)
    Hm = _host_dlt(np.asarray(src, np.float32), np.asarray(dst, np.float32))
    ids, out = [], []
    k = 0
    for r in range(1, sy):
        for c in range(1, sx):
            p = Hm @ np.array([c * square_px, r * square_px, 1.0])
            out.append([p[1] / p[2], p[0] / p[2]])  # (y, x)
            ids.append(k)
            k += 1
    return ids, np.asarray(out, np.float32)


def estimate_pose_single_markers(corners_list, marker_length: float, K, dist_iters: int = 8):
    """Per-marker pose from its 4 corners (estimatePoseSingleMarkers):
    planar PnP via homography decomposition + GN refinement. corners are
    (4, 2) (y, x); K (3, 3) numpy or a tensor (the refinement then runs on
    its device). Returns a list of (R, t) numpy arrays."""
    dev = K.device if isinstance(K, torch.Tensor) else torch.device("cpu")
    K_np = K.detach().cpu().numpy() if isinstance(K, torch.Tensor) else np.asarray(K)
    half = marker_length / 2.0
    # object corners (x, y, 0) matching the quad order TL, TR, BR, BL
    # (x right, y down when the marker faces the camera)
    obj_xy = np.array([[-half, -half], [half, -half], [half, half], [-half, half]], np.float32)
    obj3d = constant(np.concatenate([obj_xy, np.zeros((4, 1), np.float32)], 1), dev)
    Kinv = np.linalg.inv(K_np)
    refined = []
    for quad in corners_list:
        xy = np.asarray(quad, np.float32)[:, ::-1]  # (x, y)
        xn = (np.concatenate([xy, np.ones((4, 1), np.float32)], 1) @ Kinv.T)[:, :2]
        # planar homography obj (x, y) -> normalized image; H ~ [r1 r2 t]
        Hm = _host_dlt(obj_xy, xn)
        h1, h2, h3 = Hm[:, 0], Hm[:, 1], Hm[:, 2]
        lam = 2.0 / max(np.linalg.norm(h1) + np.linalg.norm(h2), 1e-9)
        if h3[2] * lam < 0:  # marker in front of the camera: t_z > 0
            lam = -lam
        r1, r2 = h1 * lam, h2 * lam
        R0 = np.stack([r1, r2, np.cross(r1, r2)], axis=1)
        U, _, Vt = np.linalg.svd(R0)
        R0 = U @ Vt
        if np.linalg.det(R0) < 0:
            R0 = U @ np.diag([1.0, 1.0, -1.0]) @ Vt
        t0 = h3 * lam
        Rj, tj, _ = resection.refine_pose(constant(R0.astype(np.float32), dev), constant(t0.astype(np.float32), dev),
                                          obj3d, constant(xn.astype(np.float32), dev), iters=dist_iters)
        refined.append(torch.cat([Rj.reshape(-1), tj]))
    if not refined:
        return []
    host = torch.stack(refined).cpu().numpy()  # one read for every marker
    return [(row[:9].reshape(3, 3).copy(), row[9:].copy()) for row in host]
