"""The PyTorch port stands alone: no file of opencv_contrib_tpu_torch/, and
not chip_smoke.py, imports JAX or the JAX package, nor PIL (the port reads
and writes PNG and JPEG with its own codecs, utils/png.py and utils/jpeg.py,
and MJPG video through the latter).

This walks the source with `ast` rather than checking `sys.modules`: the
test process imports JAX anyway (the parity tests need it, and some Python
environments pre-import it)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "opencv_contrib_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "opencv_contrib_tpu", "PIL")


def _forbidden(module: str | None) -> bool:
    return bool(module) and module.split(".")[0] in FORBIDDEN


def _imports(tree: ast.AST):
    """Every module a file imports: import statements, and string arguments
    of importlib.import_module / __import__."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
            if name in ("import_module", "__import__") and isinstance(node.args[0].value, str):
                yield node.lineno, node.args[0].value


def test_port_has_its_files():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for need in ("entry.py", "interop.py", "ops/cuda/_build.py", "ops/cuda/scan.py", "ba/sparse.py",
                 "ops/cuda/matching.py", "features/detect.py", "ba/bundle.py", "rgbd/frame.py", "rgbd/icp.py",
                 "rgbd/tsdf.py", "rgbd/kinfu.py", "core/pyramid.py", "ops/cuda/reduce.py", "utils/sdf_scene.py",
                 "flow/dis.py", "flow/tvl1.py", "flow/lk.py", "ops/cuda/pyramid.py", "ops/cuda/remap.py",
                 "ops/cuda/transform.py", "ops/cuda/histogram.py", "ops/histogram.py", "ops/filters.py",
                 "core/color.py", "intensity_transform/transforms.py", "xphoto/white_balance.py",
                 "utils/metrics.py", "quality/__init__.py", "quality/brisque.py", "utils/tracing.py",
                 "mvg/conditioning.py", "mvg/fundamental.py", "mvg/homography.py", "mvg/triangulation.py",
                 "mvg/robust.py", "mvg/resection.py", "sfm/__init__.py", "sfm/tracks.py", "sfm/pairing.py",
                 "sfm/pipeline.py", "sfm/pipeline_scale.py", "rgbd/hash_tsdf.py", "rgbd/posegraph.py",
                 "rgbd/submap.py", "rgbd/odometry.py", "rgbd/colored_tsdf.py", "rgbd/depth_utils.py",
                 "rgbd/normals.py", "utils/png.py", "utils/io.py", "utils/datasets.py", "utils/tum_export.py",
                 "utils/native.py", "rgbd/warpfield.py", "rgbd/dynafu.py", "flow/motempl.py", "flow/pcaflow.py",
                 "flow/gpc.py", "flow/extra.py", "ximgproc/__init__.py", "ximgproc/interp.py",
                 "parallel/__init__.py", "parallel/mesh.py", "parallel/dist_ba.py", "parallel/ring_match.py",
                 "parallel/submap_shard.py", "parallel/stage_pipeline.py", "parallel/dist_sfm.py",
                 "parallel/checkpoint.py", "ops/ccl.py", "ops/morphology.py", "ops/template_match.py",
                 "features/detect_x.py", "features/describe_x.py", "features/pct.py", "features/learned.py",
                 "rgbd/linemod.py", "utils/jpeg.py", "utils/video.py", "utils/cache.py", "utils/datasets2.py",
                 "utils/datasets3.py", "utils/datasets4.py", "quality/brisque_svr.py", "xphoto/artistic.py",
                 "xphoto/bm3d.py", "xphoto/denoise.py", "xphoto/inpaint.py", "xphoto/learning_wb.py",
                 "img_hash/hashes.py", "saliency/bing.py", "line_descriptor/mih.py", "mcc/detector.py", "text/er.py",
                 "text/ocr.py", "wechat_qrcode/qr.py"):
        assert need in names
    for src in ("unfilter.cpp", "jpeg.cpp"):
        assert (PORT / "utils/csrc" / src).exists()
    for cu in ("reduce_vec.cu", "pyrdown.cu", "remap.cu", "transform.cu", "reduce.cu", "histogram.cu", "maps.cuh"):
        assert (PORT / "ops/cuda/csrc" / cu).exists()
    assert (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("name", ["frontend", "keyframe_tick", "dense_flow", "photometric", "sfm", "sfm_scale",
                                  "HashKinFu", "LargeKinFu", "odometry.compute", "hash_kinfu_track",
                                  "large_kinfu_track", "rgbd_odometry", "tum_kinfu", "dynafu_track", "DynaFu",
                                  "dense_flow_deepflow", "dense_flow_simpleflow", "dense_flow_sparse_to_dense",
                                  "dense_flow_rlof", "dense_flow_pcaflow", "dryrun_multichip", "make_mesh",
                                  "features_x", "video_photometric", "VideoReader", "train_brisque_model",
                                  "recognize_x"])
def test_entry_points_need_a_card_for_cuda(monkeypatch, tmp_path, name):
    """Asked for "cuda" (their default) on a machine without a card, the
    frontend, keyframe, dense-flow, photometric and both SfM drivers' entry
    points, the hashed-block and large-scale KinFu, the RGB-D odometry, the
    TUM disk path, DynaFu, every dense-flow method, the multichip dryrun, a
    mesh on "cuda", the xfeatures2d pair path, the video photometric path,
    a VideoReader onto the card, the BRISQUE head's training and the
    recognition methods (`entry.recognize_x`) raise
    instead of running on the CPU (a mesh drops neither to gloo nor to the
    CPU). (The TUM loader decodes on the host and has no device path.)"""
    import numpy as np
    import torch

    from opencv_contrib_tpu_torch import entry
    from opencv_contrib_tpu_torch.rgbd import dynafu, kinfu, odometry, submap
    from opencv_contrib_tpu_torch.parallel import mesh
    from opencv_contrib_tpu_torch.quality import brisque_svr
    from opencv_contrib_tpu_torch.sfm import pipeline, pipeline_scale
    from opencv_contrib_tpu_torch.utils import video
    from opencv_contrib_tpu_torch.utils.tum_export import write_tum_sequence

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if name == "tum_kinfu":
        root = tmp_path / "tum"
        write_tum_sequence(str(root), np.ones((2, 32, 48), np.float32), [np.eye(4)] * 2)
    if name in ("video_photometric", "VideoReader"):
        w = video.Y4MWriter(str(tmp_path / "v.y4m"), (48, 32))
        w.write(np.zeros((32, 48, 3), np.float32))
        w.release()
    img = np.zeros((32, 48), np.float32)
    intr = np.array([50.0, 50.0, 24.0, 16.0, 0, 0, 0, 0, 0], np.float32)
    call = {"frontend": lambda: entry.frontend(img, img, K=8),
            "keyframe_tick": lambda: entry.keyframe_tick(np.stack([img, img]), intr, K=8, n_ba=1, ba_views=2,
                                                         ba_points=8),
            "dense_flow": lambda: entry.dense_flow(img, img, "tvl1", levels=2),
            "photometric": lambda: entry.photometric(np.zeros((1, 32, 48, 3), np.float32),
                                                     np.zeros((1, 32, 48, 3), np.float32)),
            "sfm": lambda: pipeline.reconstruct_incremental(*entry.sfm_scene(6, 150)),
            "sfm_scale": lambda: pipeline_scale.reconstruct_sequential(*entry.sfm_sequence_scene(24, 32)[:2]),
            "HashKinFu": lambda: kinfu.HashKinFu(kinfu.KinFuParams.default(intr, (32, 48)), capacity=64),
            "LargeKinFu": lambda: submap.LargeKinFu(submap.LargeKinFuParams(intr=intr, frame_shape=(32, 48))),
            "odometry.compute": lambda: odometry.compute(img, img + 1, img, img + 1, intr, method="icp"),
            "hash_kinfu_track": lambda: entry.hash_kinfu_track(np.ones((1, 32, 48), np.float32), intr,
                                                               frame_shape=(32, 48), capacity=64),
            "large_kinfu_track": lambda: entry.large_kinfu_track(np.ones((1, 32, 48), np.float32), intr,
                                                                 frame_shape=(32, 48)),
            "rgbd_odometry": lambda: entry.rgbd_odometry(img, img + 1, img, img + 1, intr),
            "tum_kinfu": lambda: entry.tum_kinfu(str(tmp_path / "tum"), intr=intr, volume_resolution=(32, 32, 32)),
            "dynafu_track": lambda: entry.dynafu_track(np.ones((1, 32, 48), np.float32), intr),
            "DynaFu": lambda: dynafu.DynaFu(intr, frame_shape=(32, 48)),
            **{f"dense_flow_{m}": (lambda m=m: entry.dense_flow(img, img, m, levels=2))
               for m in ("deepflow", "simpleflow", "sparse_to_dense", "rlof")},
            "dense_flow_pcaflow": lambda: entry.dense_flow(img, img, "pcaflow", k=3),
            "dryrun_multichip": lambda: entry.dryrun_multichip(1),
            "make_mesh": lambda: mesh.make_mesh(device="cuda"),
            "features_x": lambda: entry.features_x(img, img, "harris", "brief", K=8),
            "video_photometric": lambda: entry.video_photometric(str(tmp_path / "v.y4m"),
                                                                 np.zeros((1, 32, 48, 3), np.float32)),
            "VideoReader": lambda: video.VideoReader(str(tmp_path / "v.y4m")),
            "train_brisque_model": lambda: brisque_svr.train_brisque_model(n_images=1),
            "recognize_x": lambda: entry.recognize_x(entry.recognition_scene(120, 160), "phash")}[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_kinfu_entry_points_need_a_card_for_cuda(monkeypatch):
    """Asked for "cuda" (their default) on a machine without a card, the
    KinFu entry points raise instead of running on the CPU."""
    import numpy as np
    import torch

    from opencv_contrib_tpu_torch import entry
    from opencv_contrib_tpu_torch.rgbd import kinfu

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    intr = np.array([120.0, 120.0, 80.0, 60.0, 0, 0, 0, 0, 0], np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kinfu.KinFu(kinfu.KinFuParams.default(intr))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.kinfu_track(np.ones((1, 120, 160), np.float32), intr, frame_shape=(120, 160),
                          volume_resolution=(64, 64, 64))


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [f"{path.name}:{line} imports {mod}" for line, mod in _imports(tree) if _forbidden(mod)]
    assert not bad, bad


def test_the_walk_catches_each_form():
    src = ("import jax\nfrom jax import numpy\nimport opencv_contrib_tpu.ops as o\n"
           "from opencv_contrib_tpu.features import match\n"
           "import importlib\nimportlib.import_module('jax.numpy')\n__import__('jaxlib')\n"
           "import opencv_contrib_tpu_torch\nfrom . import x\nimport PIL\nfrom PIL import Image\n"
           "importlib.import_module('PIL.Image')\nimport PILLOW_LIKE\n")
    mods = sorted(m for _, m in _imports(ast.parse(src)) if _forbidden(m))
    assert mods == ["PIL", "PIL", "PIL.Image", "jax", "jax", "jax.numpy", "jaxlib", "opencv_contrib_tpu.features",
                    "opencv_contrib_tpu.ops"]
