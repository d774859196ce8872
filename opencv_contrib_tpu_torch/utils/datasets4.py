"""Final dataset reader families — completes the datasets module (31/31;
the port's copy of opencv_contrib_tpu/utils/datasets4.py).

Parity targets (reference datasets/src/*.cpp):
- ar_sports.cpp      -> load_ar_sports (train/test partition txt:
                        "videoUrl label1,label2,...")
- fr_adience.cpp     -> load_fr_adience (fold_N_data.txt CSVs + faces/
                        dir name resolution)
- gr_chalearn.cpp    -> load_gr_chalearn (per-sample dirs with
                        _data.csv/_labels.csv/_skeleton.csv)
- hpe_humaneva.cpp   -> load_hpe_humaneva (S{i}/Image_Data video names
                        "Action_Type1_(C2).ext" + Sync_Data .ofs)
- hpe_parse.cpp      -> load_hpe_parse (first 100 jpgs train, rest test)
- ir_robot.cpp       -> load_ir_robot (scene dirs of "imgNNN_PP.png"
                        grouped into camera positions by NNN)
- is_weizmann.cpp    -> load_is_weizmann (per-image dirs with
                        src_bw/src_color/human_seg)
- or_imagenet.cpp    -> load_or_imagenet (labels.txt synset ids,
                        train/<synset>/ dirs, val/test ground truth)
- or_sun.cpp         -> load_or_sun (Partitions/Training_NN.txt /
                        Testing_NN.txt; label = path prefix registry)
- pd_caltech.cpp     -> load_pd_caltech (.seq video container header +
                        frame index walk)
- slam_tumindoor.cpp -> load_slam_tumindoor (info/*.csv ';' rows:
                        name;4x4 transform; type from name prefix)
- tr_chars.cpp       -> load_tr_chars (list_English_Img.m MATLAB lists:
                        ALLlabels/ALLnames/TRNind/TSTind/VALind columns)
- tr_svt.cpp         -> load_tr_svt (tagset XML: image/lex/
                        taggedRectangles)

Each loader returns plain numpy/python structures (images load lazily via
the port's utils.io.imread where applicable) — the Dataset::load
contract (datasets/include/opencv2/datasets/dataset.hpp) without the
class scaffolding. Formats re-derived from the reference parsers'
behavior; no code is shared.
"""

from __future__ import annotations

import os
import re
import struct
from typing import NamedTuple

import numpy as np


# ---------------------------------------------------------------------------
# AR_sports (ar_sports.cpp: "url label1,label2" rows per partition file)

class SportsSample(NamedTuple):
    video_url: str
    labels: list


def load_ar_sports(root: str):
    """Sports-1M partitions: original/{train,test}_partition.txt rows of
    'videoUrl labelsCSV' (ar_sports.cpp loadDatasetPart)."""

    def part(path):
        out = []
        if not os.path.exists(path):
            return out
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) != 2:
                    continue
                out.append(SportsSample(
                    video_url=parts[0],
                    labels=[int(x) for x in parts[1].split(",") if x]))
        return out

    return {
        "train": part(os.path.join(root, "original", "train_partition.txt")),
        "test": part(os.path.join(root, "original", "test_partition.txt")),
    }


# ---------------------------------------------------------------------------
# FR_adience (fr_adience.cpp: fold CSVs + faces/<user>/ real-name lookup)

class AdienceSample(NamedTuple):
    user_id: str
    original_image: str
    face_id: int
    age: str
    gender: str  # 'm' / 'f' / ''
    x: int
    y: int
    dx: int
    dy: int
    tilt_ang: int
    fiducial_yaw_angle: int
    fiducial_score: int


def load_fr_adience(root: str, frontal: bool = False):
    """Adience folds: fold_{N}_data.txt (or fold_frontal_{N}_data.txt),
    tab/CSV columns user_id..fiducial_score; original_image resolved
    against faces/<user_id>/ listings by suffix match, unresolvable rows
    recorded under 'missing' (fr_adience.cpp loadFile). Returns
    {'folds': [list of AdienceSample x5], 'missing': [...]}.
    """
    faces_dir = os.path.join(root, "faces")
    real = {}
    if os.path.isdir(faces_dir):
        for user in sorted(os.listdir(faces_dir)):
            udir = os.path.join(faces_dir, user)
            if os.path.isdir(udir):
                real[user] = sorted(os.listdir(udir))

    missing = []
    folds = []
    prefix = "fold_frontal_" if frontal else "fold_"
    for n in range(5):
        fold = []
        path = os.path.join(root, f"{prefix}{n}_data.txt")
        if not os.path.exists(path):
            folds.append(fold)
            continue
        with open(path) as f:
            next(f, None)  # header
            for line in f:
                line = line.rstrip("\n")
                # real fold files are tab-separated; ages like "(25, 32)"
                # contain commas, so only fall back to commas without tabs
                elems = line.split("\t") if "\t" in line else line.split(",")
                if len(elems) < 12:
                    continue
                user_id, orig = elems[0], elems[1]
                resolved = None
                for name in real.get(user_id, ()):
                    if len(name) > len(orig) and name.endswith(orig):
                        resolved = name
                        break
                if resolved is None:
                    missing.append(f"{user_id}/{orig}")
                    continue
                g = elems[4] if elems[4] in ("m", "f") else ""
                fold.append(AdienceSample(
                    user_id, resolved, int(elems[2]), elems[3], g,
                    int(elems[5]), int(elems[6]), int(elems[7]),
                    int(elems[8]), int(elems[9]), int(elems[10]),
                    int(elems[11])))
        folds.append(fold)
    return {"folds": folds, "missing": missing}


# ---------------------------------------------------------------------------
# GR_chalearn (gr_chalearn.cpp: per-sample dir with csv triplet)

class ChalearnGesture(NamedTuple):
    gesture_id: int
    initial_frame: int
    last_frame: int


class ChalearnSample(NamedTuple):
    name: str
    name_color: str
    name_depth: str
    name_user: str
    num_frames: int
    fps: int
    depth: int
    gestures: list
    skeletons: np.ndarray  # (F, 20, 9) Wx Wy Wz Rx Ry Rz Rw Px Py


def load_gr_chalearn(root: str, with_labels: bool = True):
    """ChaLearn gesture samples: <name>/<name>_data.csv (numFrames,fps,
    depth), _labels.csv (gestureID,first,last), _skeleton.csv (20 joints x
    9 floats per frame) — gr_chalearn.cpp loadDatasetPart."""
    out = []
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        if not os.path.isdir(d):
            continue
        data_csv = os.path.join(d, f"{name}_data.csv")
        if not os.path.exists(data_csv):
            continue
        with open(data_csv) as f:
            elems = f.readline().split(",")
        gestures = []
        lab = os.path.join(d, f"{name}_labels.csv")
        if with_labels and os.path.exists(lab):
            with open(lab) as f:
                for line in f:
                    e = line.split(",")
                    if len(e) >= 3:
                        gestures.append(ChalearnGesture(
                            int(e[0]), int(e[1]), int(e[2])))
        skel_rows = []
        skel = os.path.join(d, f"{name}_skeleton.csv")
        if os.path.exists(skel):
            with open(skel) as f:
                for line in f:
                    vals = [float(x) for x in line.split(",") if x.strip()]
                    joints = np.zeros((20, 9), np.float32)
                    for i in range(0, min(len(vals), 180), 9):
                        joints[i // 9] = vals[i:i + 9]
                    skel_rows.append(joints)
        out.append(ChalearnSample(
            name=name,
            name_color=f"{name}/{name}_color.mp4",
            name_depth=f"{name}/{name}_depth.mp4",
            name_user=f"{name}/{name}_user.mp4",
            num_frames=int(elems[0]), fps=int(elems[1]),
            depth=int(elems[2]),
            gestures=gestures,
            skeletons=(np.stack(skel_rows) if skel_rows
                       else np.zeros((0, 20, 9), np.float32))))
    return out


# ---------------------------------------------------------------------------
# HPE_humaneva (hpe_humaneva.cpp: S{i}/Image_Data + Sync_Data ofs)

class HumanEvaSample(NamedTuple):
    person: int
    action: str
    type1: int
    type2: str
    file_name: str
    ofs: np.ndarray


def load_hpe_humaneva(root: str):
    """HumanEva-I layout: S{1..4}/Image_Data/<Action>_<type1>_(<C*>).avi
    plus Sync_Data/<same>.ofs offset files (hpe_humaneva.cpp)."""
    out = []
    for i in range(1, 5):
        img_dir = os.path.join(root, f"S{i}", "Image_Data")
        sync_dir = os.path.join(root, f"S{i}", "Sync_Data")
        if not os.path.isdir(img_dir):
            continue
        for fn in sorted(os.listdir(img_dir)):
            stem = os.path.splitext(fn)[0]
            elems = stem.split("_")
            if len(elems) != 3:
                continue
            m = re.match(r"\((.+)\)", elems[2])
            type2 = m.group(1) if m else elems[2]
            ofs_path = os.path.join(sync_dir, stem + ".ofs")
            ofs = []
            if os.path.exists(ofs_path):
                with open(ofs_path) as f:
                    ofs = [float(line.strip() or 0) for line in f]
            out.append(HumanEvaSample(
                person=i, action=elems[0], type1=int(elems[1]),
                type2=type2, file_name=os.path.join(img_dir, fn),
                ofs=np.asarray(ofs, np.float32)))
    return out


# ---------------------------------------------------------------------------
# HPE_parse (hpe_parse.cpp: first 100 jpg -> train, rest -> test)

def load_hpe_parse(root: str):
    """PARSE image split: jpgs in directory order, first 100 train, rest
    test (hpe_parse.cpp loadDataset)."""
    names = [f for f in sorted(os.listdir(root)) if f.endswith(".jpg")]
    return {"train": names[:100], "test": names[100:]}


# ---------------------------------------------------------------------------
# IR_robot (ir_robot.cpp: scenes of imgNNN_PP.png grouped by NNN)

def load_ir_robot(root: str):
    """Robot data set: <scene>/img{NNN}_{PP}.png files grouped into camera
    positions by image number NNN (ir_robot.cpp loadDataset). Returns
    {scene: [ [files of pos 1], [files of pos 2], ... ]}."""
    out = {}
    for scene in sorted(os.listdir(root)):
        sdir = os.path.join(root, scene)
        if not os.path.isdir(sdir):
            continue
        positions = []
        curr_num = None
        for fn in sorted(os.listdir(sdir)):
            m = re.match(r"img(\d{3})_(\d{2})", fn)
            if not m:
                continue
            num = int(m.group(1))
            if num != curr_num:
                positions.append([])
                curr_num = num
            positions[-1].append(fn)
        out[scene] = positions
    return out


# ---------------------------------------------------------------------------
# IS_weizmann (is_weizmann.cpp: per-image dirs with fixed sub-layout)

class WeizmannSample(NamedTuple):
    image_name: str
    src_bw: str
    src_color: str
    human_seg: str


def load_is_weizmann(root: str):
    """Weizmann segmentation DB: one dir per image with src_bw/ src_color/
    human_seg/ children (is_weizmann.cpp loadDataset; non-dir entries like
    the .mat files are skipped)."""
    out = []
    for name in sorted(os.listdir(root)):
        if "." in name or not os.path.isdir(os.path.join(root, name)):
            continue
        out.append(WeizmannSample(
            image_name=name,
            src_bw=f"{name}/src_bw/{name}.png",
            src_color=f"{name}/src_color/{name}.png",
            human_seg=f"{name}human_seg/"))
    return out


# ---------------------------------------------------------------------------
# OR_imagenet (or_imagenet.cpp: labels.txt + train synset dirs + val/test)

class ImagenetSample(NamedTuple):
    image: str
    id: int


def load_or_imagenet(root: str):
    """ILSVRC2010 layout: labels.txt 'synset,id' rows; train/<synset>/*
    images labeled through the synset map; validation/test ids from
    ILSVRC2010_{validation,test}_ground_truth.txt with generated
    zero-padded file names (or_imagenet.cpp loadDataset)."""
    labels = {}
    lab_path = os.path.join(root, "labels.txt")
    if os.path.exists(lab_path):
        with open(lab_path) as f:
            for line in f:
                e = line.strip().split(",")
                if len(e) >= 2:
                    labels[e[0]] = int(e[1])

    train = []
    train_dir = os.path.join(root, "train")
    if os.path.isdir(train_dir):
        for syn in sorted(os.listdir(train_dir)):
            sdir = os.path.join(train_dir, syn)
            if not os.path.isdir(sdir):
                continue
            for fn in sorted(os.listdir(sdir)):
                train.append(ImagenetSample(f"train/{syn}/{fn}",
                                            labels.get(syn, -1)))

    def gt_split(fname, pattern):
        out = []
        p = os.path.join(root, fname)
        if os.path.exists(p):
            with open(p) as f:
                for k, line in enumerate(f):
                    if line.strip():
                        out.append(ImagenetSample(
                            pattern % (k + 1), int(line)))
        return out

    val = gt_split("ILSVRC2010_validation_ground_truth.txt",
                   "val/ILSVRC2010_val_%08d.JPEG")
    test = gt_split("ILSVRC2010_test_ground_truth.txt",
                    "test/ILSVRC2010_test_%08d.JPEG")
    return {"train": train, "validation": val, "test": test}


# ---------------------------------------------------------------------------
# OR_sun (or_sun.cpp: partition lists, labels from path prefixes)

class SunSample(NamedTuple):
    name: str
    label: int


def load_or_sun(root: str, n_partitions: int = 10):
    """SUN397 partitions: Partitions/{Training,Testing}_NN.txt with
    '/c/class/img.jpg' rows; the class label registry grows in encounter
    order of the path prefix (or_sun.cpp loadDatasetPart). Returns
    {'train': [...x10], 'test': [...x10], 'paths': [class prefixes]}."""
    path_label = {}
    paths = []

    def part(p):
        out = []
        if not os.path.exists(p):
            return out
        with open(p) as f:
            for line in f:
                name = line.strip()
                if not name:
                    continue
                pos = name.rfind("/")
                label = 397
                if pos != -1:
                    prefix = name[:pos + 1]
                    if prefix in path_label:
                        label = path_label[prefix]
                    else:
                        label = len(path_label)
                        path_label[prefix] = label
                        paths.append(prefix)
                    name = name[pos + 1:]
                out.append(SunSample(name, label))
        return out

    train, test = [], []
    for i in range(1, n_partitions + 1):
        train.append(part(os.path.join(root, "Partitions",
                                       f"Training_{i:02d}.txt")))
        test.append(part(os.path.join(root, "Partitions",
                                      f"Testing_{i:02d}.txt")))
    return {"train": train, "test": test, "paths": paths}


# ---------------------------------------------------------------------------
# PD_caltech (pd_caltech.cpp: .seq container header + frame walk)

class SeqInfo(NamedTuple):
    width: int
    height: int
    image_bit_depth: int
    image_format: int
    num_frames: int
    fps: float
    ext: str
    frame_names: list
    frame_offsets: list  # (offset, size) per frame payload


_SEQ_EXT = {100: "raw", 200: "raw", 101: "brgb8", 102: "jpg", 201: "jpg",
            103: "jbrgb", 1: "png", 2: "png"}


def read_seq_header(path: str) -> SeqInfo:
    """Parse a Caltech Pedestrian .seq container: 548-byte preamble, 9
    uint32 header words (numFrames at word 6), fps double, 432-byte pad,
    then per frame [uint32 size][payload][12-byte trailer]
    (pd_caltech.cpp loadDataset)."""
    with open(path, "rb") as f:
        f.seek(28 + 8 + 512)
        header = struct.unpack("<9I", f.read(36))
        fps = struct.unpack("<d", f.read(8))[0]
        f.seek(432, 1)
        num_frames = header[6]
        ext = _SEQ_EXT.get(header[5], "bin")
        names, offsets = [], []
        for i in range(num_frames):
            raw = f.read(4)
            if len(raw) < 4:
                break
            size = struct.unpack("<I", raw)[0]
            names.append(f"/{i}.{ext}")
            offsets.append((f.tell(), size))
            f.seek(size + 12, 1)
    return SeqInfo(header[0], header[1], header[2], header[5],
                   num_frames, fps, ext, names, offsets)


def load_pd_caltech(root: str):
    """Caltech Pedestrian: <set>/<seq>.seq containers; returns
    {set_name: {seq_name: SeqInfo}} (pd_caltech.cpp loadDataset without
    the frame-unpack side effects)."""
    out = {}
    for set_name in sorted(os.listdir(root)):
        sdir = os.path.join(root, set_name)
        if not os.path.isdir(sdir):
            continue
        seqs = {}
        for fn in sorted(os.listdir(sdir)):
            if fn.endswith(".seq"):
                seqs[fn] = read_seq_header(os.path.join(sdir, fn))
        out[set_name] = seqs
    return out


def read_seq_frame(path: str, info: SeqInfo, index: int) -> bytes:
    """Extract one frame payload (the commented-out unpack block in
    pd_caltech.cpp made a file per frame; here the bytes are returned)."""
    off, size = info.frame_offsets[index]
    with open(path, "rb") as f:
        f.seek(off)
        return f.read(size)


# ---------------------------------------------------------------------------
# SLAM_tumindoor (slam_tumindoor.cpp: info/*.csv ';' rows name + 4x4)

class TumIndoorSample(NamedTuple):
    name: str
    type: str  # 'left' | 'right' | 'ladybug'
    transform: np.ndarray  # (4, 4)


def load_slam_tumindoor(root: str):
    """TUMindoor: the single info/*.csv with ';'-separated rows of image
    name + row-major 4x4 pose; camera type from the name prefix
    (slam_tumindoor.cpp loadDataset)."""
    info_dir = os.path.join(root, "info")
    csvs = [f for f in os.listdir(info_dir) if f.endswith(".csv")]
    if len(csvs) != 1:
        raise ValueError(f"expected exactly one info/*.csv, found {csvs}")
    out = []
    with open(os.path.join(info_dir, csvs[0])) as f:
        for line in f:
            e = line.strip().split(";")
            if len(e) < 17:
                continue
            name = e[0]
            if name.startswith("dslr_left"):
                typ = "left"
            elif name.startswith("dslr_right"):
                typ = "right"
            else:
                typ = "ladybug"
            mat = np.asarray([float(x) for x in e[1:17]],
                             np.float64).reshape(4, 4)
            out.append(TumIndoorSample(name, typ, mat))
    return out


# ---------------------------------------------------------------------------
# TR_chars (tr_chars.cpp: list_English_Img.m MATLAB-list sections)

class CharsSample(NamedTuple):
    img_name: str
    label: int


def load_tr_chars(root: str, split: int = 0):
    """Chars74k: parse list_English_Img.m sections ALLlabels/ALLnames and
    the TRNind/TSTind/VALind index columns for the given split; indices
    are 1-based, 0 means absent (tr_chars.cpp loadDatasetSplit)."""
    labels, names = [], []
    trn, tst, val = [], [], []
    state = None
    with open(os.path.join(root, "list_English_Img.m")) as f:
        for line in f:
            if "];" in line:
                state = None
            for pat, st in (("list.ALLlabels = [", "labels"),
                            ("list.ALLnames = [", "names"),
                            ("list.TRNind = [", "trn"),
                            ("list.TSTind = [", "tst"),
                            ("list.VALind = [", "val")):
                pos = line.find(pat)
                if pos != -1:
                    state = st
                    line = line[pos + len(pat):]
                    break
            if state is None:
                continue
            body = line.strip()
            if not body or body == "];":
                continue
            if state == "labels":
                try:
                    labels.append(int(float(body)))
                except ValueError:
                    pass
            elif state == "names":
                names.append(body.strip().strip("'"))
            else:
                cols = body.split()
                if split < len(cols):
                    try:
                        ind = int(float(cols[split]))
                    except ValueError:
                        continue
                    if ind > 0:
                        {"trn": trn, "tst": tst, "val": val}[state].append(
                            ind - 1)

    def conv(idx):
        return [CharsSample(names[i], labels[i]) for i in idx
                if i < len(names) and i < len(labels)]

    return {"train": conv(trn), "test": conv(tst), "validation": conv(val)}


# ---------------------------------------------------------------------------
# TR_svt (tr_svt.cpp: tagset XML with lex + taggedRectangles)

class SvtTag(NamedTuple):
    value: str
    x: int
    y: int
    width: int
    height: int


class SvtSample(NamedTuple):
    file_name: str
    lex: list
    tags: list


def load_tr_svt(xml_path: str):
    """Street View Text: <tagset><image> entries with imageName, comma
    lexicon, and taggedRectangles (tr_svt.cpp parseDataset)."""
    import xml.etree.ElementTree as ET

    root = ET.parse(xml_path).getroot()
    if root.tag != "tagset":
        return []
    out = []
    for image in root.findall("image"):
        tags = []
        tr = image.find("taggedRectangles")
        if tr is not None:
            for t in tr.findall("taggedRectangle"):
                tags.append(SvtTag(
                    value=t.findtext("tag", ""),
                    x=int(t.get("x")), y=int(t.get("y")),
                    width=int(t.get("width")),
                    height=int(t.get("height"))))
        out.append(SvtSample(
            file_name=image.findtext("imageName", ""),
            lex=[w for w in image.findtext("lex", "").split(",") if w],
            tags=tags))
    return out
