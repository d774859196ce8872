"""More dataset reader families (datasets module breadth; the port's copy of
opencv_contrib_tpu/utils/datasets3.py).

Parity targets (reference datasets/src/*.cpp):
- or_pascal.cpp      -> load_or_pascal (VOC XML object annotations)
- tr_icdar.cpp       -> load_tr_icdar (8-coord word ground truth files)
- or_mnist.cpp       -> load_or_mnist (idx-ubyte images + labels)
- track_vot.cpp      -> load_track_vot (list.txt + per-sequence
                        groundtruth.txt polygon/rect rows)
- fr_lfw.cpp         -> load_fr_lfw_pairs (pairs.txt match/mismatch folds)
- ir_affine.cpp      -> load_ir_affine (Oxford img1..6 + H1to{n}p)
- sr_div2k/general100/bsds.cpp -> load_sr_dataset (split image lists)
- pd_inria.cpp       -> load_pd_inria (pos/neg lists + bounding boxes)
- ar_hmdb.cpp        -> load_ar_hmdb_splits (action 7030 split files)

Each loader returns plain numpy/python structures (images load lazily via
the port's utils.io.imread where applicable) — the Dataset::load contract
(datasets/include/opencv2/datasets/dataset.hpp) without the class
scaffolding.
"""

from __future__ import annotations

import os
import struct
from typing import NamedTuple

import numpy as np


# ---------------------------------------------------------------------------
# OR_pascal (or_pascal.cpp: VOC XML annotation parsing)

class PascalObject(NamedTuple):
    name: str
    xmin: int
    ymin: int
    xmax: int
    ymax: int
    difficult: bool
    truncated: bool
    occluded: bool


class PascalSample(NamedTuple):
    filename: str
    width: int
    height: int
    objects: list


def load_or_pascal(ann_dir: str):
    """Parse every VOC XML annotation in a directory
    (or_pascal.cpp parseAnnotation)."""
    import xml.etree.ElementTree as ET

    out = []
    for fn in sorted(os.listdir(ann_dir)):
        if not fn.endswith(".xml"):
            continue
        root = ET.parse(os.path.join(ann_dir, fn)).getroot()
        size = root.find("size")
        objs = []
        for o in root.findall("object"):
            bb = o.find("bndbox")
            objs.append(PascalObject(
                name=o.findtext("name", ""),
                xmin=int(float(bb.findtext("xmin"))),
                ymin=int(float(bb.findtext("ymin"))),
                xmax=int(float(bb.findtext("xmax"))),
                ymax=int(float(bb.findtext("ymax"))),
                difficult=o.findtext("difficult", "0").strip() == "1",
                truncated=o.findtext("truncated", "0").strip() == "1",
                occluded=o.findtext("occluded", "0").strip() == "1",
            ))
        out.append(PascalSample(
            filename=root.findtext("filename", fn[:-4]),
            width=int(size.findtext("width")) if size is not None else 0,
            height=int(size.findtext("height")) if size is not None else 0,
            objects=objs,
        ))
    return out


# ---------------------------------------------------------------------------
# TR_icdar (tr_icdar.cpp: gt_*.txt with 8 corner coords + word)

class IcdarWord(NamedTuple):
    x: int
    y: int
    width: int
    height: int
    value: str


def load_tr_icdar(gt_dir: str):
    """Parse ICDAR ground-truth files: per image, rows of
    'x1,y1,x2,y2,x3,y3,x4,y4,word' (tr_icdar.cpp:84-100 keeps the
    axis-aligned box from corners 0 and 3)."""
    out = {}
    for fn in sorted(os.listdir(gt_dir)):
        if not fn.endswith(".txt"):
            continue
        words = []
        with open(os.path.join(gt_dir, fn), encoding="utf-8-sig") as f:
            for line in f:
                parts = line.strip().split(",")
                if len(parts) < 9:
                    continue
                try:
                    c = [int(float(p)) for p in parts[:8]]
                except ValueError:
                    continue
                value = ",".join(parts[8:]).strip().strip('"')
                words.append(IcdarWord(
                    x=c[0], y=c[1], width=c[4] - c[0], height=c[7] - c[1],
                    value=value))
        out[fn] = words
    return out


# ---------------------------------------------------------------------------
# OR_mnist (or_mnist.cpp: idx-ubyte binary images + labels)

def load_or_mnist(images_path: str, labels_path: str):
    """Read idx3-ubyte images + idx1-ubyte labels (or_mnist.cpp loadDataset).
    Returns (images (N, H, W) uint8, labels (N,) uint8)."""
    with open(images_path, "rb") as f:
        magic, n, h, w = struct.unpack(">IIII", f.read(16))
        assert magic == 0x00000803, "not an idx3-ubyte image file"
        imgs = np.frombuffer(f.read(n * h * w), np.uint8).reshape(n, h, w)
    with open(labels_path, "rb") as f:
        magic, n2 = struct.unpack(">II", f.read(8))
        assert magic == 0x00000801, "not an idx1-ubyte label file"
        labels = np.frombuffer(f.read(n2), np.uint8)
    assert n == n2
    return imgs, labels


# ---------------------------------------------------------------------------
# TRACK_vot (track_vot.cpp: list.txt + per-seq groundtruth.txt)

class VotSequence(NamedTuple):
    name: str
    frames: list  # image paths
    gt: np.ndarray  # (T, 4) axis-aligned (x, y, w, h) from the polygons


def load_track_vot(root: str):
    """VOT layout: root/list.txt names sequences; each sequence dir has
    groundtruth.txt (rows of 8 polygon coords or 4 rect coords) and
    images (track_vot.cpp:122-160)."""
    out = []
    with open(os.path.join(root, "list.txt")) as f:
        names = [ln.strip() for ln in f if ln.strip()]
    for name in names:
        d = os.path.join(root, name)
        rows = []
        with open(os.path.join(d, "groundtruth.txt")) as f:
            for line in f:
                vals = [float(v) for v in line.replace(";", ",").split(",") if v.strip()]
                if len(vals) == 8:
                    xs, ys = vals[0::2], vals[1::2]
                    rows.append([min(xs), min(ys),
                                 max(xs) - min(xs), max(ys) - min(ys)])
                elif len(vals) == 4:
                    rows.append(vals)
        frames = sorted(
            os.path.join(d, fn) for fn in os.listdir(d)
            if fn.lower().endswith((".jpg", ".png")))
        out.append(VotSequence(name=name, frames=frames,
                               gt=np.asarray(rows, np.float32)))
    return out


# ---------------------------------------------------------------------------
# FR_lfw (fr_lfw.cpp: pairs.txt folds of match/mismatch pairs)

class LfwPair(NamedTuple):
    image1: str
    image2: str
    same: bool


def load_fr_lfw_pairs(path: str):
    """Parse pairs.txt (fr_lfw.cpp:106-148): header 'folds n', then per
    fold n matched rows 'name i j' and n mismatched rows 'name1 i name2 j'.
    Returns list of folds, each a list of LfwPair."""
    def img(name, idx):
        return f"{name}/{name}_{int(idx):04d}.jpg"

    with open(path) as f:
        header = f.readline().split()
        n_folds, n_pairs = (int(header[0]), int(header[1])) if len(header) >= 2 \
            else (1, int(header[0]))
        folds = []
        for _ in range(n_folds):
            fold = []
            for _ in range(n_pairs):
                p = f.readline().split()
                fold.append(LfwPair(img(p[0], p[1]), img(p[0], p[2]), True))
            for _ in range(n_pairs):
                p = f.readline().split()
                fold.append(LfwPair(img(p[0], p[1]), img(p[2], p[3]), False))
            folds.append(fold)
    return folds


# ---------------------------------------------------------------------------
# IR_affine (ir_affine.cpp: Oxford affine-covariant benchmark — img1..6 +
# H1to{n}p 3x3 homographies)

class AffineSequence(NamedTuple):
    images: list  # 6 image paths (img1 = reference)
    H: np.ndarray  # (6, 3, 3); H[0] = identity, H[i] maps img1 -> img{i+1}


def load_ir_affine(seq_dir: str, ext: str | None = None):
    """Load one Oxford affine sequence directory (graf/wall/boat/...)."""
    exts = [ext] if ext else [".ppm", ".pgm", ".png", ".jpg"]
    imgs = []
    for i in range(1, 7):
        for e in exts:
            p = os.path.join(seq_dir, f"img{i}{e}")
            if os.path.exists(p):
                imgs.append(p)
                break
    Hs = [np.eye(3, dtype=np.float64)]
    for i in range(2, 7):
        p = os.path.join(seq_dir, f"H1to{i}p")
        Hs.append(np.loadtxt(p).reshape(3, 3) if os.path.exists(p)
                  else np.full((3, 3), np.nan))
    return AffineSequence(images=imgs, H=np.stack(Hs))


# ---------------------------------------------------------------------------
# SR_* (sr_div2k.cpp / sr_general100.cpp / sr_bsds.cpp: image-name lists)

def load_sr_dataset(root: str, train_dir: str = "DIV2K_train_HR",
                    valid_dir: str = "DIV2K_valid_HR"):
    """Super-resolution dataset splits as sorted image-path lists
    (sr_div2k.cpp loadDatasetPart semantics — the datasets are just image
    directories)."""
    def scan(d):
        full = os.path.join(root, d)
        if not os.path.isdir(full):
            return []
        return sorted(os.path.join(full, f) for f in os.listdir(full)
                      if f.lower().endswith((".png", ".jpg", ".bmp")))

    return {"train": scan(train_dir), "valid": scan(valid_dir)}


# ---------------------------------------------------------------------------
# PD_inria (pd_inria.cpp: pos.lst / neg.lst image lists + annotations)

class InriaSample(NamedTuple):
    filename: str
    bndboxes: np.ndarray  # (M, 4) (xmin, ymin, xmax, ymax); empty for neg


def load_pd_inria(root: str, image_set: str = "Train"):
    """INRIA person layout: <set>/pos.lst, <set>/neg.lst, annotations/*.txt
    with 'Bounding box ... (xmin, ymin) - (xmax, ymax)' rows
    (pd_inria.cpp:94-170)."""
    import re

    out = []
    pos = os.path.join(root, image_set, "pos.lst")
    neg = os.path.join(root, image_set, "neg.lst")
    if os.path.exists(pos):
        for line in open(pos):
            rel = line.strip()
            if not rel:
                continue
            ann = os.path.join(root, image_set, "annotations",
                               os.path.splitext(os.path.basename(rel))[0] + ".txt")
            boxes = []
            if os.path.exists(ann):
                for al in open(ann, errors="ignore"):
                    m = re.search(r"\((\d+),\s*(\d+)\)\s*-\s*\((\d+),\s*(\d+)\)", al)
                    if m and "Bounding box" in al:
                        boxes.append([int(m.group(i)) for i in (1, 2, 3, 4)])
            out.append(InriaSample(rel, np.asarray(boxes, np.int32).reshape(-1, 4)))
    if os.path.exists(neg):
        for line in open(neg):
            rel = line.strip()
            if rel:
                out.append(InriaSample(rel, np.zeros((0, 4), np.int32)))
    return out


# ---------------------------------------------------------------------------
# AR_hmdb (ar_hmdb.cpp: testTrainMulti_7030_splits action split files)

def load_ar_hmdb_splits(split_dir: str, split_id: int = 1):
    """HMDB action splits: per action a '<action>_test_split<k>.txt' with
    'video.avi <tag>' rows; tag 1 = train, 2 = test (ar_hmdb.cpp:122-141).
    Returns {action: {"train": [...], "test": [...]}}."""
    out = {}
    suffix = f"_test_split{split_id}.txt"
    for fn in sorted(os.listdir(split_dir)):
        if not fn.endswith(suffix):
            continue
        action = fn[: -len(suffix)]
        tr, te = [], []
        for line in open(os.path.join(split_dir, fn)):
            parts = line.split()
            if len(parts) < 2:
                continue
            if parts[1] == "1":
                tr.append(parts[0])
            elif parts[1] == "2":
                te.append(parts[0])
        out[action] = {"train": tr, "test": te}
    return out


# ---------------------------------------------------------------------------
# IS_bsds (is_bsds.cpp: train/test id lists; images + GT live beside them)

def load_is_bsds(root: str):
    """BSDS segmentation splits: iids_train.txt / iids_test.txt of image
    ids (is_bsds.cpp:84)."""
    out = {}
    for split, fn in (("train", "iids_train.txt"), ("test", "iids_test.txt")):
        p = os.path.join(root, fn)
        out[split] = ([ln.strip() for ln in open(p) if ln.strip()]
                      if os.path.exists(p) else [])
    return out


# ---------------------------------------------------------------------------
# TRACK_alov (track_alov.cpp: ann/<category>/<video>.ann rows
# "frame ax ay bx by cx cy dx dy")

class AlovAnnotation(NamedTuple):
    frame: int
    box: np.ndarray  # (4,) axis-aligned (x, y, w, h) from the 4 corners


def load_track_alov(ann_dir: str):
    """ALOV300++ annotations: {category/video: [AlovAnnotation, ...]}."""
    out = {}
    for cat in sorted(os.listdir(ann_dir)):
        cdir = os.path.join(ann_dir, cat)
        if not os.path.isdir(cdir):
            continue
        for fn in sorted(os.listdir(cdir)):
            if not fn.endswith(".ann"):
                continue
            anns = []
            for line in open(os.path.join(cdir, fn)):
                vals = [float(v) for v in line.split()]
                if len(vals) < 9:
                    continue
                xs, ys = vals[1::2], vals[2::2]
                anns.append(AlovAnnotation(
                    frame=int(vals[0]),
                    box=np.asarray([min(xs), min(ys), max(xs) - min(xs),
                                    max(ys) - min(ys)], np.float32)))
            out[f"{cat}/{fn[:-4]}"] = anns
    return out


# ---------------------------------------------------------------------------
# GR_skig (gr_skig.cpp: attributes parsed from the video filenames)

class SkigSample(NamedTuple):
    path: str
    person: int
    background: int
    illumination: int
    pose: int
    action: int


def load_gr_skig(root: str):
    """SKIG gesture videos: attributes encoded in names like
    'person_1_backgroud_1_illumination_1_pose_1_actionType_1.avi'
    (gr_skig.cpp:102-130; note the dataset's own 'backgroud' spelling)."""
    import re

    pat = re.compile(
        r"person_(\d+)_backgrou?n?d_(\d+)_illumination_(\d+)_pose_(\d+)_actionType_(\d+)")
    out = []
    for dirpath, _, files in os.walk(root):
        for fn in sorted(files):
            m = pat.search(fn)
            if m:
                out.append(SkigSample(
                    os.path.join(dirpath, fn),
                    *[int(m.group(i)) for i in range(1, 6)]))
    return out
