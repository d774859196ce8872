"""Dataset readers, part 2 — multiview-stereo and generic layouts (the
port's copy of opencv_contrib_tpu/utils/datasets2.py).

Reference anchors (datasets module):
- src/msm_epfl.cpp — MSM_epfl::load: per-image camera files
  `<name>.png.camera` (K 3x3, distortion 3, R 3x3, t 3, image size)
- src/msm_middlebury.cpp — MSM_middlebury::load: `<name>_par.txt` with
  per-image "name k11..k33 r11..r33 t1 t2 t3" lines
- src/or_imagenet.cpp / tr_icdar.cpp / etc. — directory+annotation scanners
- src/slam_kitti.cpp, slam_tumindoor.cpp — in utils.datasets
- src/dataset.cpp — the Dataset::load/getTrain/getTest facade

These are pure host-side parsers (like the reference's); arrays come out as
numpy, and image paths are returned for `utils.io.imread` to read lazily.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class MSMView:
    name: str
    K: np.ndarray          # (3, 3)
    R: np.ndarray          # (3, 3)
    t: np.ndarray          # (3,)
    distortion: np.ndarray | None = None
    image_size: tuple | None = None

    @property
    def P(self) -> np.ndarray:
        """3x4 projection K [R | t]."""
        return self.K @ np.concatenate([self.R, self.t[:, None]], 1)


def load_msm_epfl(root: str):
    """EPFL multiview stereo camera files (parity: MSM_epfl::load,
    msm_epfl.cpp). Scans `<root>` for `*.camera` files; each holds K rows,
    distortion, R rows, t, and image size (per the EPFL bundler-style
    format). Returns list[MSMView] sorted by name."""
    views = []
    for fn in sorted(os.listdir(root)):
        if not fn.endswith(".camera"):
            continue
        nums = []
        with open(os.path.join(root, fn)) as f:
            for line in f:
                nums.extend(float(x) for x in line.split())
        vals = np.array(nums, np.float64)
        K = vals[0:9].reshape(3, 3)
        dist = vals[9:12]
        R = vals[12:21].reshape(3, 3)
        t = vals[21:24]
        size = tuple(int(v) for v in vals[24:26]) if len(vals) >= 26 else None
        views.append(MSMView(name=fn[:-len(".camera")], K=K, R=R, t=t,
                             distortion=dist, image_size=size))
    return views


def load_msm_middlebury(par_file: str):
    """Middlebury MSM `*_par.txt` (parity: MSM_middlebury::load,
    msm_middlebury.cpp): first line = count, then per line
    `name k(9) r(9) t(3)`. Returns list[MSMView]."""
    views = []
    with open(par_file) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    try:
        n = int(lines[0])
        body = lines[1:1 + n]
    except ValueError:
        body = lines
    for ln in body:
        parts = ln.split()
        name = parts[0]
        vals = np.array([float(x) for x in parts[1:]], np.float64)
        views.append(MSMView(name=name, K=vals[0:9].reshape(3, 3),
                             R=vals[9:18].reshape(3, 3), t=vals[18:21]))
    return views


@dataclass
class LabeledImageSet:
    """Generic (path, label) dataset with train/val/test splits — the role
    of the OR_* / TR_* readers (or_imagenet.cpp and friends)."""

    train: list = field(default_factory=list)  # (path, label)
    val: list = field(default_factory=list)
    test: list = field(default_factory=list)
    labels: list = field(default_factory=list)


def load_labeled_dirs(root: str, splits=("train", "val", "test"),
                      exts=(".png", ".jpg", ".jpeg", ".pgm", ".ppm")):
    """Scan `<root>/<split>/<class>/*.<ext>` into a LabeledImageSet
    (the classic ImageNet-style layout OR_imagenet::load walks; splits
    missing on disk are left empty; with no split dirs, everything goes to
    train)."""
    ds = LabeledImageSet()
    classes = set()

    def scan(d):
        out = []
        for cls in sorted(os.listdir(d)):
            cdir = os.path.join(d, cls)
            if not os.path.isdir(cdir):
                continue
            classes.add(cls)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(exts):
                    out.append((os.path.join(cdir, fn), cls))
        return out

    any_split = False
    for split in splits:
        d = os.path.join(root, split)
        if os.path.isdir(d):
            any_split = True
            setattr(ds, split, scan(d))
    if not any_split and os.path.isdir(root):
        ds.train = scan(root)
    ds.labels = sorted(classes)
    return ds


def load_image_sequence(root: str, exts=(".png", ".jpg", ".jpeg", ".pgm")):
    """Sorted frame paths of a directory — the minimal FrameSource the
    tracking/videostab datasets (vot.cpp, track_*.cpp) reduce to."""
    return [os.path.join(root, f) for f in sorted(os.listdir(root))
            if f.lower().endswith(exts)]


def write_msm_middlebury(par_file: str, views):
    """Inverse of load_msm_middlebury (round-trip support for tests and
    checkpointing reconstructions in a standard format)."""
    with open(par_file, "w") as f:
        f.write(f"{len(views)}\n")
        for v in views:
            nums = np.concatenate([v.K.reshape(-1), v.R.reshape(-1), v.t])
            f.write(v.name + " " + " ".join(f"{x:.10g}" for x in nums) + "\n")
