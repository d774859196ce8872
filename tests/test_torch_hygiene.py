"""The PyTorch port stands alone: no file of opencv_contrib_tpu_torch/, and
not chip_smoke.py, imports JAX or the JAX package.

This walks the source with `ast` rather than checking `sys.modules`: the
test process imports JAX anyway (the parity tests need it, and some Python
environments pre-import it)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "opencv_contrib_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "opencv_contrib_tpu")


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
    for need in ("entry.py", "interop.py", "ops/cuda/_build.py", "ops/cuda/scan.py",
                 "ops/cuda/matching.py", "features/detect.py", "ba/bundle.py", "rgbd/frame.py", "rgbd/icp.py",
                 "rgbd/tsdf.py", "rgbd/kinfu.py", "core/pyramid.py", "ops/cuda/reduce.py", "utils/sdf_scene.py",
                 "flow/dis.py", "flow/tvl1.py", "flow/lk.py", "ops/cuda/pyramid.py", "ops/cuda/remap.py"):
        assert need in names
    for cu in ("reduce_vec.cu", "pyrdown.cu", "remap.cu"):
        assert (PORT / "ops/cuda/csrc" / cu).exists()
    assert (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("name", ["frontend", "keyframe_tick", "dense_flow"])
def test_entry_points_need_a_card_for_cuda(monkeypatch, name):
    """Asked for "cuda" (their default) on a machine without a card, the
    frontend, keyframe and dense-flow entry points raise instead of running
    on the CPU."""
    import numpy as np
    import torch

    from opencv_contrib_tpu_torch import entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((32, 48), np.float32)
    intr = np.array([50.0, 50.0, 24.0, 16.0, 0, 0, 0, 0, 0], np.float32)
    call = {"frontend": lambda: entry.frontend(img, img, K=8),
            "keyframe_tick": lambda: entry.keyframe_tick(np.stack([img, img]), intr, K=8, n_ba=1, ba_views=2,
                                                         ba_points=8),
            "dense_flow": lambda: entry.dense_flow(img, img, "tvl1", levels=2)}[name]
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
           "import opencv_contrib_tpu_torch\nfrom . import x\n")
    mods = sorted(m for _, m in _imports(ast.parse(src)) if _forbidden(m))
    assert mods == ["jax", "jax", "jax.numpy", "jaxlib", "opencv_contrib_tpu.features",
                    "opencv_contrib_tpu.ops"]
