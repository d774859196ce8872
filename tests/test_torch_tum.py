"""The port's TUM disk path (opencv_contrib_tpu_torch: utils/png.py,
utils/io.py, utils/datasets.py, utils/tum_export.py, utils/native.py and
entry.tum_kinfu) against PIL and the JAX package, on the CPU.

Tolerances (measured values in brackets, on the CPU):
- the codec: samples equal to PIL's, bit for bit, on files PIL writes (its
  adaptive filters) and on files the port writes with each filter 0-4
  forced; decode_png equal to the JAX package's native decode (libpng);
  the C++ unfilter's bytes equal to the numpy version's.
- io, datasets and the writer: equal arrays, equal text; groundtruth.txt
  numbers within 2e-6 (one digit in the sixth decimal: the two mat_to_quat
  round apart by an ulp), tum_gt_pose_at within 1e-6.
- the loader: every frame, in order, equal to a direct decode, for 1-4
  threads by prefetch 1-8, with decodes that sleep at random; a consumer
  thread joined with a timeout, so a stall fails the test.
- the mini TUM path (tests/test_tum_e2e.py's 6 frames at 120x160, 96^3):
  the JAX package reads through its Python reader (`load_tum` +
  `imread_depth_tum`), never its native loader; the port through its
  loader. Depths equal. The camera -> world poses (max abs entry of the
  4x4 difference): the port's tick from the JAX state before each frame
  within 1e-4 (2.4e-7), that trajectory's ATE within 1e-4 of the JAX
  package's; run alone from frame 0, within 2e-3 (1.8e-3, the bound of
  tests/test_torch_rgbd.py's independent orbits), both ATEs < 0.05 m and
  within 1e-3 m of each other (2.1e-4).
"""

import io as pyio
import os
import struct
import threading
import time
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from opencv_contrib_tpu.rgbd import kinfu as jkinfu
from opencv_contrib_tpu.utils import datasets as jds
from opencv_contrib_tpu.utils import io as jio
from opencv_contrib_tpu.utils import metrics as jmetrics
from opencv_contrib_tpu.utils import native as jnative
from opencv_contrib_tpu.utils import sdf_scene as jscene
from opencv_contrib_tpu.utils.tum_export import write_tum_sequence as jwrite_tum
from opencv_contrib_tpu_torch import entry
from opencv_contrib_tpu_torch.utils import datasets as tds
from opencv_contrib_tpu_torch.utils import io as tio
from opencv_contrib_tpu_torch.utils import native as tnative
from opencv_contrib_tpu_torch.utils import png
from opencv_contrib_tpu_torch.utils.tum_export import write_tum_sequence as twrite_tum

torch.set_num_threads(1)

INTR = np.array([120.0, 120.0, 80.0, 60.0, 0, 0, 0, 0, 0], np.float32)  # tests/test_tum_e2e.py:23
SHAPE = (120, 160)


def _image(kind: str, rng) -> np.ndarray:
    """A seeded image with smooth runs (so every filter type wins somewhere
    under PIL's adaptive choice) and noise."""
    shape, dtype = {"rgb8": ((23, 37, 3), np.uint8), "rgba8": ((23, 37, 4), np.uint8), "ga8": ((23, 37, 2), np.uint8),
                    "gray8": ((23, 37), np.uint8), "gray16": ((23, 37), np.uint16),
                    "rgb16": ((23, 37, 3), np.uint16), "rgba16": ((23, 37, 4), np.uint16)}[kind]
    hi = np.iinfo(dtype).max
    ramp = np.linspace(0, hi, shape[1])[None, :] * np.linspace(0.2, 1.0, shape[0])[:, None]
    img = np.broadcast_to(ramp.reshape(shape[:2] + (1,) * (len(shape) - 2)), shape).astype(np.float64)
    noise = rng.integers(0, hi + 1, shape)
    img = np.where(np.arange(shape[1]).reshape((1, -1) + (1,) * (len(shape) - 2)) % 11 < 5, img, noise)
    return img.astype(dtype)


def _pil_bytes(img: np.ndarray) -> bytes:
    b = pyio.BytesIO()
    Image.fromarray(img).save(b, format="PNG")
    return b.getvalue()


@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "ga8", "gray8", "gray16"])
def test_codec_reads_pil_files_bit_for_bit(kind):
    img = _image(kind, np.random.default_rng(0))
    data = _pil_bytes(img)
    got = png.decode(data)
    ref = np.asarray(Image.open(pyio.BytesIO(data)))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "ga8", "gray8", "gray16"])
@pytest.mark.parametrize("ftype", range(5))
def test_codec_writes_every_filter_pil_reads(kind, ftype):
    img = _image(kind, np.random.default_rng(1))
    data = png.encode(img, filter=ftype)
    raw = zlib.decompress(b"".join(body for t, body in png._chunks(data) if t == b"IDAT"))
    assert raw[0] == ftype
    np.testing.assert_array_equal(np.asarray(Image.open(pyio.BytesIO(data))), img)
    np.testing.assert_array_equal(png.decode(data), img)


@pytest.mark.parametrize("kind", ["rgb16", "rgba16"])
def test_sixteen_bit_colour_reads_as_pil_opens_it(tmp_path, kind):
    """PIL opens 16-bit colour as 8-bit (the high bytes); `io.imread` does
    the same, while the codec and decode_png keep all 16 bits."""
    img = _image(kind, np.random.default_rng(2))
    path = str(tmp_path / "c16.png")
    png.write(path, img, filter=4)
    np.testing.assert_array_equal(png.read(path), img)
    np.testing.assert_array_equal(tio.imread(path), jio.imread(path))
    np.testing.assert_array_equal(tio.imread(path, gray=True), jio.imread(path, gray=True))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_cpp_unfilter_equals_numpy(bpp):
    """Rows of every filter type, mixed within one image, through the host
    C++ routine and the numpy version."""
    rng = np.random.default_rng(bpp)
    H, rowbytes = 17, 5 * bpp
    raw = rng.integers(0, 256, (H, rowbytes)).astype(np.uint8)
    # row y filtered with type y % 5, each against the raw row above: unfiltering restores raw
    rows = np.stack([png.filter_rows(raw, bpp, f) for f in range(5)])[np.arange(H) % 5, np.arange(H)]
    buf = rows.tobytes()
    got = png.unfilter(buf, H, rowbytes, bpp)
    np.testing.assert_array_equal(got, png.unfilter_numpy(buf, H, rowbytes, bpp))
    np.testing.assert_array_equal(got, raw)


def test_cpp_unfilter_rejects_an_unknown_filter():
    buf = bytes([0, 1, 2, 7, 3, 4])
    with pytest.raises(ValueError, match="filter type 7"):
        png.unfilter(buf, 2, 2, 1)


def _patch_ihdr(data: bytes, offset: int, value: int) -> bytes:
    """Set one IHDR byte (offset into its payload) and fix the CRC."""
    body = bytearray(data[16:29])
    body[offset] = value
    return data[:16] + bytes(body) + struct.pack(">I", zlib.crc32(b"IHDR" + bytes(body))) + data[33:]


def test_unsupported_and_corrupt_files_raise(tmp_path):
    img = _image("rgb8", np.random.default_rng(3))
    pal = pyio.BytesIO()
    Image.fromarray(img).convert("P").save(pal, format="PNG")
    with pytest.raises(NotImplementedError, match="palette"):
        png.decode(pal.getvalue())
    one_bit = pyio.BytesIO()
    Image.fromarray(img).convert("1").save(one_bit, format="PNG")
    with pytest.raises(NotImplementedError, match="bit depth 1"):
        png.decode(one_bit.getvalue())
    with pytest.raises(NotImplementedError, match="interlac"):
        png.decode(_patch_ihdr(png.encode(img), 12, 1))
    trns = pyio.BytesIO()
    Image.fromarray(img).save(trns, format="PNG", transparency=(1, 2, 3))
    with pytest.raises(NotImplementedError, match="tRNS"):
        png.decode(trns.getvalue())
    data = bytearray(png.encode(img))
    data[45] ^= 0xFF  # a byte of the IDAT payload
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(data))
    good = png.encode(img)
    n = struct.unpack(">I", good[33:37])[0]  # the IDAT chunk after the 33-byte signature + IHDR
    cut = good[41:41 + n // 2]  # its zlib stream cut in half, the CRC made right
    short = good[:33] + struct.pack(">I", len(cut)) + b"IDAT" + cut + struct.pack(">I", zlib.crc32(b"IDAT" + cut))
    with pytest.raises(ValueError, match="bad image data"):
        png.decode(short + good[41 + n + 4:])
    path = str(tmp_path / "bad.png")
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(IOError):
        tnative.decode_png(path)
    with pytest.raises(IOError):
        tnative.decode_png(str(tmp_path / "missing.png"))
    with pytest.raises(NotImplementedError, match="JPEG"):
        tnative.decode_image(str(tmp_path / "photo.jpg"))
    with pytest.raises(NotImplementedError, match="PNG"):
        tio.imread(str(tmp_path / "photo.jpg"))


@pytest.mark.skipif(not jnative.available(), reason="the JAX package's native library is not built")
@pytest.mark.parametrize("kind,scale", [("rgb8", -1.0), ("rgba8", -1.0), ("gray8", -1.0), ("gray16", 5000.0),
                                        ("gray16", -1.0), ("rgb16", -1.0)])
def test_decode_png_equals_native(tmp_path, kind, scale):
    """Single files through the JAX package's native decode (libpng), which
    uses no queue: the same float32 values, bit for bit."""
    path = str(tmp_path / f"{kind}.png")
    png.write(path, _image(kind, np.random.default_rng(4)), filter=3)
    ref = jnative.decode_png(path, depth_scale=scale)
    got = tnative.decode_png(path, depth_scale=scale)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_io_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    for kind in ("rgb8", "rgba8", "ga8", "gray8", "gray16"):
        path = str(tmp_path / f"{kind}.png")
        with open(path, "wb") as f:
            f.write(_pil_bytes(_image(kind, rng)))
        for gray in (False, True):
            np.testing.assert_array_equal(tio.imread(path, gray=gray), jio.imread(path, gray=gray))
        np.testing.assert_array_equal(tio.imread_depth_tum(path), jio.imread_depth_tum(path))
    for name, img in (("f.png", rng.uniform(-0.2, 1.2, (9, 11, 3)).astype(np.float32)),
                      ("u.png", rng.integers(0, 256, (9, 11)).astype(np.uint8)),
                      ("t.png", torch.from_numpy(rng.uniform(0, 1, (9, 11, 4)).astype(np.float32)))):
        tio.imwrite(str(tmp_path / ("t" + name)), img)
        jio.imwrite(str(tmp_path / ("j" + name)), np.asarray(img))
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / ("t" + name))),
                                      np.asarray(Image.open(tmp_path / ("j" + name))))
    arrays = {"a": rng.normal(size=(3, 4)).astype(np.float32), "b": torch.arange(5)}
    tio.save_checkpoint(str(tmp_path / "ck.npz"), arrays, attrs={"step": 7})
    got, attrs = jio.load_checkpoint(str(tmp_path / "ck.npz"))
    np.testing.assert_array_equal(got["a"], arrays["a"])
    np.testing.assert_array_equal(got["b"], np.arange(5))
    assert int(attrs["step"]) == 7
    Rs = rng.normal(size=(3, 3, 3)).astype(np.float32)
    ts = rng.normal(size=(3, 3)).astype(np.float32)
    pts = rng.normal(size=(6, 3)).astype(np.float32)
    intr = np.array([500.0, 500, 320, 240, 0.01, -0.02, 0, 0, 0], np.float32)
    reg, has = np.array([True, False, True]), np.arange(6) % 2 == 0
    tio.export_reconstruction(str(tmp_path / "t.out"), torch.from_numpy(Rs), ts, pts, intr, reg, has)
    jio.export_reconstruction(str(tmp_path / "j.out"), Rs, ts, pts, intr, reg, has)
    assert (tmp_path / "t.out").read_text() == (tmp_path / "j.out").read_text()
    for a, b in zip(tio.import_reconstruction(str(tmp_path / "t.out")),
                    jio.import_reconstruction(str(tmp_path / "j.out"))):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def mini_tum(tmp_path_factory):
    """tests/test_tum_e2e.py's mini sequence (6 frames, 120x160, rendered by
    the JAX sdf_scene), written once by each package's writer."""
    poses = jscene.orbit_poses(6, sweep=0.4)
    depths = [np.asarray(jscene.render_depth(jnp.asarray(p), jnp.asarray(INTR), shape=SHAPE)) for p in poses]
    roots = {k: tmp_path_factory.mktemp(f"tum_{k}") for k in ("jax", "port")}
    jwrite_tum(str(roots["jax"]), depths, [np.asarray(p) for p in poses])
    twrite_tum(str(roots["port"]), [torch.from_numpy(d.copy()) for d in depths], [np.asarray(p) for p in poses])
    return poses, depths, roots


def test_writer_matches_jax(mini_tum):
    """The same files: equal PNG samples (each package's reader on each
    package's files), equal indices, ground truth within 2e-6."""
    _, depths, roots = mini_tum
    for name in ("rgb.txt", "depth.txt"):
        assert (roots["port"] / name).read_text() == (roots["jax"] / name).read_text()
    gt_t = np.loadtxt(roots["port"] / "groundtruth.txt")
    gt_j = np.loadtxt(roots["jax"] / "groundtruth.txt")
    np.testing.assert_allclose(gt_t, gt_j, atol=2e-6, rtol=0)
    for pair in jds.load_tum(str(roots["jax"])).pairs:
        for rel in (pair[1], pair[3]):
            a, b = str(roots["port"] / rel), str(roots["jax"] / rel)
            np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
            np.testing.assert_array_equal(png.read(b), np.asarray(Image.open(b)))
        np.testing.assert_array_equal(jio.imread_depth_tum(str(roots["port"] / pair[3])),
                                      tio.imread_depth_tum(str(roots["jax"] / pair[3])))


def test_datasets_match_jax(mini_tum, tmp_path):
    _, _, roots = mini_tum
    st, sj = tds.load_tum(str(roots["port"])), jds.load_tum(str(roots["jax"]))
    assert st.rgb == sj.rgb and st.depth == sj.depth and st.pairs == sj.pairs
    np.testing.assert_allclose(st.gt, sj.gt, atol=2e-6, rtol=0)
    for t in (0.0, 0.05, 0.1, 0.17):
        np.testing.assert_allclose(tds.tum_gt_pose_at(sj.gt, t), jds.tum_gt_pose_at(sj.gt, t), atol=1e-6)
    np.testing.assert_array_equal(tds.TUM_FR1_INTR, jds.TUM_FR1_INTR)
    np.testing.assert_array_equal(tds.TUM_DEFAULT_INTR, jds.TUM_DEFAULT_INTR)
    # association of jittered, unequal-rate streams (greedy, first come)
    rng = np.random.default_rng(6)
    a = [(float(t), f"a{i}") for i, t in enumerate(np.sort(rng.uniform(0, 2, 40)))]
    b = [(float(t), f"b{i}") for i, t in enumerate(np.sort(rng.uniform(0, 2, 55)))]
    for dt in (0.005, 0.02, 0.1):
        assert tds.associate(a, b, dt) == jds.associate(a, b, dt)
    # KITTI odometry layout
    seq = tmp_path / "kitti" / "00"
    (seq / "image_0").mkdir(parents=True)
    for i in (2, 0, 1):
        (seq / "image_0" / f"{i:06d}.png").write_bytes(png.encode(np.zeros((4, 5), np.uint8)))
    P = rng.normal(size=(2, 12))
    (seq / "calib.txt").write_text("".join(f"P{i}: " + " ".join(map(repr, p.tolist())) + "\n" for i, p in enumerate(P)))
    np.savetxt(tmp_path / "poses.txt", rng.normal(size=(3, 12)))
    kt = tds.load_kitti_odometry(str(seq), str(tmp_path / "poses.txt"))
    kj = jds.load_kitti_odometry(str(seq), str(tmp_path / "poses.txt"))
    assert kt.image_paths == kj.image_paths and list(kt.calib) == list(kj.calib)
    for k in kt.calib:
        np.testing.assert_array_equal(kt.calib[k], kj.calib[k])
    np.testing.assert_array_equal(kt.poses, kj.poses)
    # Sintel .flo
    flow = rng.normal(size=(7, 9, 2)).astype(np.float32)
    tds.write_flo(str(tmp_path / "t.flo"), flow)
    jds.write_flo(str(tmp_path / "j.flo"), flow)
    assert (tmp_path / "t.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    np.testing.assert_array_equal(tds.read_flo(str(tmp_path / "j.flo")), jds.read_flo(str(tmp_path / "t.flo")))
    np.testing.assert_array_equal(tds.flow_yx_to_xy(flow), jds.flow_yx_to_xy(flow))


@pytest.fixture(scope="module")
def loader_seq(tmp_path_factory):
    """A 12-frame sequence of seeded 8x12 frames, written by the port."""
    root = tmp_path_factory.mktemp("loader")
    rng = np.random.default_rng(8)
    depths = [rng.uniform(0.5, 3.0, (8, 12)).astype(np.float32) for _ in range(12)]
    rgbs = [rng.uniform(0, 1, (8, 12, 3)).astype(np.float32) for _ in range(12)]
    twrite_tum(str(root), depths, [np.eye(4)] * 12, rgbs=rgbs)
    seq = tds.load_tum(str(root))
    ref = [(p[0], tnative.decode_png(os.path.join(str(root), p[1])), p[2],
            tio.imread_depth_tum(os.path.join(str(root), p[3]))) for p in seq.pairs]
    return str(root), ref


def _consume(loader, timeout: float = 30.0):
    """Iterate the loader in a thread joined with a timeout: a stall fails
    here instead of hanging the suite."""
    out, err = [], []

    def run():
        try:
            out.extend(loader)
        except BaseException as e:  # noqa: BLE001 - handed to the test thread
            err.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"loader stalled ({loader.n_threads} threads, prefetch {loader.prefetch})"
    return out, err


@pytest.mark.parametrize("n_threads", [1, 2, 3, 4])
def test_loader_order_and_liveness(monkeypatch, loader_seq, n_threads):
    """Decodes that sleep 0-4 ms at random finish out of order; every
    prefetch 1-8 (below, equal to and above the thread count) still gives
    every frame, in order, equal to a direct decode."""
    root, ref = loader_seq
    rng = np.random.default_rng(n_threads)
    lock = threading.Lock()
    decode = tnative.decode_png

    def slow_decode(path, depth_scale=-1.0):
        with lock:
            pause = float(rng.uniform(0, 0.004))
        time.sleep(pause)
        return decode(path, depth_scale)

    monkeypatch.setattr(tnative, "decode_png", slow_decode)
    for prefetch in range(1, 9):
        loader = tnative.TumLoader(root, n_threads=n_threads, prefetch=prefetch)
        assert len(loader) == len(ref) and (loader.height, loader.width) == (8, 12)
        frames, err = _consume(loader)
        assert not err, err
        assert [f[0] for f in frames] == [r[0] for r in ref]
        for (t_rgb, rgb, t_depth, depth), r in zip(frames, ref):
            assert t_depth == r[2] and rgb.dtype == depth.dtype == np.float32
            np.testing.assert_array_equal(rgb, r[1])
            np.testing.assert_array_equal(depth, r[3])


def test_loader_raises_at_the_bad_frame_and_closes(loader_seq, tmp_path):
    """A corrupt depth PNG raises IOError to the consumer at its frame, after
    the frames before it; close() ends a loader left half read."""
    import shutil

    root, ref = loader_seq
    bad = tmp_path / "seq"
    shutil.copytree(root, bad)
    path = bad / tds.load_tum(str(bad)).pairs[5][3]
    data = bytearray(path.read_bytes())
    data[40] ^= 0xFF
    path.write_bytes(bytes(data))
    frames, err = _consume(tnative.TumLoader(str(bad), n_threads=3, prefetch=4))
    assert len(frames) == 5 and len(err) == 1 and isinstance(err[0], IOError)
    loader = tnative.TumLoader(root, n_threads=2, prefetch=8)
    it = iter(loader)
    next(it)
    loader.close()
    it.close()
    with loader:
        assert len(list(loader)) == len(ref)
    assert tnative.available()


def _jax_mini_path(root):
    """The JAX package on its own files: the Python reader, KinFu with
    tests/test_tum_e2e.py:58-63's settings, ATE against groundtruth.txt.
    Also the port's tick on each frame from the JAX state before it."""
    from opencv_contrib_tpu_torch import interop
    from opencv_contrib_tpu_torch.rgbd import kinfu as tkinfu

    seq = jds.load_tum(str(root))
    p = jkinfu.KinFuParams.default(INTR, SHAPE)
    p.volume_resolution, p.volume_size, p.volume_center, p.sparse_blocks = MINI_KINFU.values()
    kf = jkinfu.KinFu(p)
    kt = tkinfu.KinFu(tkinfu.KinFuParams(intr=INTR, frame_shape=SHAPE, **MINI_KINFU), device="cpu")
    depths, poses, carried = [], [], []
    for pair in seq.pairs:
        depths.append(jio.imread_depth_tum(os.path.join(str(root), pair[3])))
        if kf.frame_count:
            kt.volume, kt.model_pyr, kt.T_cw = (interop.from_numpy(x) for x in (kf.volume, kf.model_pyr, kf.T_cw))
            kt.frame_count = kf.frame_count
            assert kt.update(depths[-1])
        assert kf.update(jnp.asarray(depths[-1]))
        poses.append(np.asarray(kf.pose))
        carried.append(kt.pose if kt.frame_count > 1 else poses[-1])
    ate = [jmetrics.ate_rmse(np.asarray(x)[:, :3, 3], seq.gt[:, 1:4]) for x in (poses, carried)]
    return depths, np.asarray(poses), np.asarray(carried), ate


MINI_KINFU = dict(volume_resolution=(96, 96, 96), volume_size=3.2, volume_center=(0.0, 0.0, 2.2), sparse_blocks=512)


def test_mini_tum_path_matches_jax(mini_tum):
    """tests/test_tum_e2e.py's path in both packages, each from its own
    files. Depths equal. From the JAX state before each frame, the port's
    tick gives the JAX pose within 1e-4 (measured 2.4e-7) and that
    trajectory's ATE within 1e-4 of the JAX package's. Run alone from frame
    0, the bilateral filter's ulps (XLA's exp) move the first ICP by 2.6e-4
    and grow over the 6 ticks, so there the poses are held within 2e-3,
    tests/test_torch_rgbd.py's bound for independent orbits (measured
    1.8e-3), and the ATEs below 0.05 m and within 1e-3 m of each other
    (measured 3.73e-3 against 3.52e-3)."""
    _, _, roots = mini_tum
    depths_j, poses_j, carried, (ate_j, ate_carried) = _jax_mini_path(roots["jax"])
    frames = list(tnative.TumLoader(str(roots["port"]), n_threads=2, prefetch=4))
    for (_, _, _, d), dj in zip(frames, depths_j):
        np.testing.assert_array_equal(d, dj)
    assert np.abs(carried - poses_j).max() < 1e-4, np.abs(carried - poses_j).max(axis=(1, 2))
    assert abs(ate_carried - ate_j) < 1e-4, (ate_carried, ate_j)
    res = entry.tum_kinfu(str(roots["port"]), intr=INTR, device="cpu", n_threads=2, prefetch=4, **MINI_KINFU)
    assert res.frames == 6 and res.lost == []
    assert np.abs(res.poses - poses_j).max() < 2e-3, np.abs(res.poses - poses_j).max(axis=(1, 2))
    assert ate_j < 0.05 and res.ate < 0.05
    assert abs(res.ate - ate_j) < 1e-3, (res.ate, ate_j)
