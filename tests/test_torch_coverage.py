"""The port carries the public names of the JAX package's files it ports.

For every file of opencv_contrib_tpu/ that has a twin at the same path in
opencv_contrib_tpu_torch/, each top-level public function and class of the
JAX file (a name without a leading underscore) must be defined at the top
level of the twin, unless it is on ALLOWED, the names ROADMAP.md still
queues. Both sides are read with `ast` only: nothing is imported."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "opencv_contrib_tpu"
PORT = ROOT / "opencv_contrib_tpu_torch"

# the names ROADMAP.md's Queue 1 lists as still missing from files the port has
ALLOWED = {
    "core/color.py": {"bgr_to_gray", "ycrcb_to_rgb", "rgb_to_lab"},
    "core/camera.py": {"project_P", "projection_from_KRt", "KRt_from_projection"},
    "utils/sdf_scene.py": {"sdf_rounded_room"},
    "utils/native.py": {"load_library"},
}

TWINS = sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py")
               if p.name != "__init__.py" and (PORT / p.relative_to(JAX)).exists())


def public_names(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not n.name.startswith("_")}


@pytest.mark.parametrize("rel", TWINS)
def test_twin_has_the_public_names(rel):
    missing = public_names(JAX / rel) - public_names(PORT / rel) - ALLOWED.get(rel, set())
    assert not missing, f"{rel}: the port lacks {sorted(missing)}"


@pytest.mark.parametrize("rel", sorted(ALLOWED))
def test_allowed_names_are_still_missing(rel):
    """An allowed name exists in the JAX file and not yet in the twin: a
    ported name leaves the list."""
    names = ALLOWED[rel]
    assert names <= public_names(JAX / rel), sorted(names - public_names(JAX / rel))
    assert not names & public_names(PORT / rel), sorted(names & public_names(PORT / rel))


def test_slice_files_are_twins():
    for rel in ("ops/ccl.py", "ops/morphology.py", "ops/template_match.py", "features/detect_x.py",
                "features/describe_x.py", "features/pct.py", "features/learned.py", "rgbd/linemod.py",
                "features/describe.py", "features/detect.py", "features/match.py", "ops/filters.py",
                "ops/image.py", "ops/integral.py", "utils/cache.py", "utils/video.py", "utils/datasets2.py",
                "utils/datasets3.py", "utils/datasets4.py", "quality/brisque_svr.py", "xphoto/artistic.py",
                "xphoto/bm3d.py", "xphoto/denoise.py", "xphoto/inpaint.py", "xphoto/learning_wb.py",
                "ximgproc/filters_x.py", "ximgproc/filters_x2.py", "ximgproc/transforms_x.py", "ximgproc/fourier.py",
                "ximgproc/slic.py", "hfs/segment.py", "ximgproc/superpixels_x.py", "ximgproc/segmentation.py",
                "ximgproc/edges.py", "ximgproc/edge_forest.py", "text/swt.py", "ximgproc/edline.py",
                "ximgproc/hough_mser.py", "phase_unwrapping/unwrap.py", "structured_light/graycode.py",
                "structured_light/sinusoidal.py", "stereo/matching.py", "stereo/quasi_dense.py", "reg/mapper.py",
                "surface_matching/icp3d.py", "surface_matching/ppf.py", "rapid/tracker.py", "aruco/markers.py",
                "aruco/charuco.py", "ccalib/omnidir.py", "ccalib/random_pattern.py", "core/se3.py",
                "tracking/boosting.py", "tracking/correlation.py", "tracking/csrt.py", "tracking/dsst.py",
                "tracking/kalman.py", "tracking/matching.py", "tracking/medianflow.py", "tracking/mil.py",
                "tracking/multitracker.py", "tracking/siam.py", "tracking/tld.py", "tracking/twist.py",
                "videostab/stabilizer.py", "videostab/extra.py", "superres/btv.py", "bgsegm/synthetic.py",
                "bgsegm/mog.py", "bgsegm/cnt.py", "bgsegm/gmg.py", "bgsegm/gsoc.py", "bioinspired/retina.py",
                "bioinspired/transient.py", "bioinspired/color.py", "xobjdetect/hog.py", "xobjdetect/waldboost.py",
                "dpm/detector.py", "shape/distances.py", "shape/tps.py", "shape/extra.py", "face/recognizers.py",
                "face/bif.py", "face/aam.py", "face/facemark.py", "img_hash/hashes.py", "saliency/static.py",
                "saliency/motion.py", "saliency/bing.py", "line_descriptor/lines.py", "line_descriptor/mih.py",
                "mcc/ccm.py", "mcc/detector.py", "text/er.py", "text/ocr.py", "wechat_qrcode/gf256.py",
                "wechat_qrcode/spec.py", "wechat_qrcode/qr.py"):
        assert rel in TWINS, rel
        assert rel not in ALLOWED, rel


def exported(path: Path) -> list:
    """A package __init__'s __all__, read with `ast`."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for n in tree.body:
        if isinstance(n, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in n.targets):
            return [ast.literal_eval(e) for e in n.value.elts]
    return []


# packages ported whole, whose __init__ keeps its twin's exports (earlier slices' packages that are ported in part,
# such as text/, export what they hold)
WHOLE_PACKAGES = ("phase_unwrapping", "structured_light", "stereo", "reg", "surface_matching", "rapid", "aruco",
                  "ccalib", "tracking", "videostab", "superres", "bgsegm", "bioinspired", "xobjdetect", "dpm", "shape",
                  "face", "img_hash", "saliency", "line_descriptor", "mcc", "wechat_qrcode")


@pytest.mark.parametrize("pkg", WHOLE_PACKAGES)
def test_package_exports_the_twins_names(pkg):
    """The package's __init__ exports at least its twin's __all__."""
    missing = set(exported(JAX / pkg / "__init__.py")) - set(exported(PORT / pkg / "__init__.py"))
    assert not missing, f"{pkg}: the port's __all__ lacks {sorted(missing)}"


def test_the_walk_reads_defs_and_classes(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("def a():\n    def inner():\n        pass\n\nclass B:\n    def m(self):\n        pass\n\n"
                   "async def c():\n    pass\n\ndef _d():\n    pass\n\nE = 1\n")
    assert public_names(src) == {"a", "B", "c"}
