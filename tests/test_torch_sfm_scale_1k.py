"""The port's 5k-view sequential SfM driver (opencv_contrib_tpu_torch.sfm.
pipeline_scale) alone on the CPU at tests/test_sfm_scale.py's 1,024 views,
with its own RANSAC draws, under that test's gates: at least 0.9 of the
views registered, a mean reprojection under 1.4 px, points on at least 0.6
of the tracks. A file of its own: the run takes about 100 s on one CPU
thread, and the parity tests of tests/test_torch_sfm_scale.py about as long."""

import numpy as np
import torch

from opencv_contrib_tpu_torch.sfm import pipeline_scale as tps
from opencv_contrib_tpu_torch.utils.synthetic import generate_sequence_scene

torch.set_num_threads(1)


def test_thousand_view_reconstruction_port():
    sc = generate_sequence_scene(n_views=1024, slots_per_view=48, track_span=16, seed=2, noise_px=0.3)
    tr = tps.from_sequence_scene(sc)
    rec = tps.reconstruct_sequential(tr, sc.intr, window=12, ba_every=4, min_gap=2, final_global_iters=8,
                                     device="cpu")
    assert rec.registered.sum() >= 0.9 * 1024
    assert rec.reprojection_mean_px(tr, device="cpu") < 1.4
    assert rec.has_point.sum() >= 0.6 * sc.n_tracks
    assert np.isfinite(rec.points[rec.has_point]).all()
