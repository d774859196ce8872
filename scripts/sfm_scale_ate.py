"""Trajectory accuracy of the sequential SfM driver (sfm/pipeline_scale.py) at a view count, in either package.

    python scripts/sfm_scale_ate.py --backend jax --views 2500     # the JAX package (JAX_PLATFORMS=cpu: the CPU)
    python scripts/sfm_scale_ate.py --backend torch --views 2500   # the PyTorch port, on the card
    python scripts/sfm_scale_ate.py --backend torch --views 256 --device cpu

The scene is scripts/sfm_scale_run.py's at that view count: 1,024 slots a view, tracks living max(24, V // 125)
views, 0.3 px pixel noise, seed 0; the driver takes that script's settings (window 24, ba_every 4, min_gap
max(3, span // 3), min_parallax_deg 0.4, 15 final LM iterations). Prints one JSON line: registered views,
segments and their sizes, points, the mean reprojection, wall s, the ATE of the dominant segment (its camera
centres after a similarity alignment; the camera ring's radius is 4), the ATE of each eighth of it, and the
largest ATE over its 96-view windows (tests/test_sfm_scale.py's gate, 0.3, is set on a 96-view sequence).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def window_ates(ate_rmse, c_est, c_gt, idx, n_windows: int) -> list:
    """ATE of each of `n_windows` consecutive runs of the views `idx`."""
    return [ate_rmse(c_est[w], c_gt[w]) for w in np.array_split(idx, max(1, n_windows))]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=("jax", "torch"), required=True)
    ap.add_argument("--views", type=int, default=5000)
    ap.add_argument("--slots", type=int, default=1024)
    ap.add_argument("--device", default="cuda", help="the port's device (torch backend)")
    args = ap.parse_args()

    V = args.views
    span = max(24, V // 125)
    settings = dict(window=24, ba_every=4, min_gap=max(3, span // 3), min_parallax_deg=0.4, final_global_iters=15)
    if args.backend == "jax":
        from opencv_contrib_tpu.sfm import pipeline_scale as ps
        from opencv_contrib_tpu.utils.metrics import ate_rmse
        from opencv_contrib_tpu.utils.synthetic import generate_sequence_scene

        sc = generate_sequence_scene(n_views=V, slots_per_view=args.slots, track_span=span, seed=0, noise_px=0.3)
        tracks = ps.from_sequence_scene(sc)
        kw, px_kw, device = {}, {}, "jax"
    else:
        import torch

        from opencv_contrib_tpu_torch import entry
        from opencv_contrib_tpu_torch.sfm import pipeline_scale as ps
        from opencv_contrib_tpu_torch.utils.metrics import ate_rmse

        tracks, _, sc = entry.sfm_sequence_scene(V, args.slots)
        kw = px_kw = {"device": args.device}
        device = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"

    t0 = time.perf_counter()
    rec = ps.reconstruct_sequential(tracks, sc.intr, **settings, **kw)
    wall = time.perf_counter() - t0
    c_est = np.einsum("vij,vi->vj", rec.Rs, -rec.ts)
    c_gt = np.einsum("vij,vi->vj", sc.Rs, -sc.ts)
    segs, counts = np.unique(rec.seg_of_view[rec.registered], return_counts=True)
    idx = np.flatnonzero(rec.registered & (rec.seg_of_view == segs[np.argmax(counts)]))
    print(json.dumps({
        "backend": args.backend, "device": device, "views": V, "slots": args.slots, "track_span": span,
        "settings": settings, "registered": int(rec.registered.sum()), "segments": counts.tolist(),
        "points": int(rec.has_point.sum()), "tracks": int(tracks.n_tracks),
        "reprojection_mean_px": rec.reprojection_mean_px(tracks, **px_kw), "wall_s": wall,
        "ate_dominant_segment": ate_rmse(c_est[idx], c_gt[idx]),
        "ate_eighths": window_ates(ate_rmse, c_est, c_gt, idx, 8),
        "ate_96_view_windows_max": max(window_ates(ate_rmse, c_est, c_gt, idx, len(idx) // 96))}), flush=True)


if __name__ == "__main__":
    main()
