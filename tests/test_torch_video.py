"""The port's video layer (utils/video.py) against the JAX package's.

The twins of tests/test_io_modules.py:155-208 (Y4M, DIB and MJPG AVI round
trips, the colour matrices), files written by each package read by the
other, the colour conversions against the JAX functions, and the reader's
liveness: a frame that fails to decode raises in the consumer, and close()
ends a reader whose pump waits on a full queue, both under a hard limit.

Tolerances: yuv420_to_rgb within 1e-6 (XLA fuses the products and sums of
the matrix; PyTorch rounds each); rgb_to_yuv420's planes equal but for
values an ulp from a rounding edge, at most 1 apart on at most 1% of the
samples."""

import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_contrib_tpu.utils import video as jvideo
from opencv_contrib_tpu_torch.utils import video as tvideo


def _frames(n, h=32, w=48):
    """tests/test_io_modules.py's frames."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        r = 0.5 + 0.5 * np.sin(xx / 7.0 + i)
        g = 0.5 + 0.5 * np.cos(yy / 5.0 - i / 2.0)
        b = 0.5 + 0.5 * np.sin((xx + yy) / 9.0 + i / 3.0)
        out.append(np.clip(np.stack([r, g, b], -1), 0, 1).astype(np.float32))
    return out


def _read_all(rdr):
    return np.concatenate([b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b) for b in rdr], 0)


def test_y4m_roundtrip(tmp_path):
    p = str(tmp_path / "v.y4m")
    frames = _frames(5)
    wtr = tvideo.create_video_writer(p, (48, 32), fps=25.0, codec="y4m")
    for f in frames:
        wtr.write(f)
    wtr.release()
    rdr = tvideo.VideoReader(p, batch=2, device="cpu")
    assert (rdr.width, rdr.height) == (48, 32)
    assert abs(rdr.fps - 25.0) < 1e-6
    got = _read_all(rdr)
    assert got.shape == (5, 32, 48, 3) and got.dtype == np.float32
    assert np.abs(got - np.stack(frames)).mean() < 0.03
    assert rdr.next_batch() is None and rdr.next_batch() is None  # the end, again
    assert rdr.frames_decoded == 5


def test_avi_dib_roundtrip(tmp_path):
    p = str(tmp_path / "v.avi")
    frames = _frames(4, 24, 32)
    wtr = tvideo.create_video_writer(p, (32, 24), fps=30.0)
    for f in frames:
        wtr.write(f)
    wtr.release()
    rdr = tvideo.AVIReader(p)
    assert len(rdr) == 4 and (rdr.w, rdr.h) == (32, 24) and abs(rdr.fps - 30.0) < 1e-3
    for i, f in enumerate(frames):
        assert np.abs(rdr.read(i).astype(np.float32) / 255.0 - f).max() < 1.0 / 255.0 + 1e-6


def test_avi_mjpg_roundtrip(tmp_path):
    p = str(tmp_path / "m.avi")
    frames = _frames(3, 24, 32)
    wtr = tvideo.create_video_writer(p, (32, 24), fps=15.0, codec="MJPG")
    for f in frames:
        wtr.write(f)
    wtr.release()
    got = _read_all(tvideo.VideoReader(p, batch=2, to_device=False))
    assert got.shape == (3, 24, 32, 3)
    assert np.abs(got - np.stack(frames)).mean() < 0.08


def test_yuv_color_matrix_identity():
    rgb = torch.from_numpy(_frames(1, 16, 16)[0])[None]
    y, u, v = tvideo.rgb_to_yuv420(rgb)
    back = tvideo.yuv420_to_rgb(y, u, v)[0]
    assert np.abs(back.numpy() - rgb[0].numpy()).mean() < 0.03


@pytest.mark.parametrize("lead", [(), (3,)], ids=["frame", "batch"])
def test_color_conversions_match_jax(lead):
    rng = np.random.default_rng(0)
    rgb = rng.random(lead + (20, 28, 3), dtype=np.float32)
    ours = [p.numpy() for p in tvideo.rgb_to_yuv420(torch.from_numpy(rgb))]
    theirs = [np.asarray(p) for p in jvideo.rgb_to_yuv420(jnp.asarray(rgb))]
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 0.01
    y, u, v = (rng.integers(0, 256, lead + s).astype(np.uint8) for s in ((20, 28), (10, 14), (10, 14)))
    a = tvideo.yuv420_to_rgb(*(torch.from_numpy(p) for p in (y, u, v))).numpy()
    b = np.asarray(jvideo.yuv420_to_rgb(*(jnp.asarray(p) for p in (y, u, v))))
    assert a.shape == b.shape and a.dtype == np.float32
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("codec", ["y4m", "DIB ", "MJPG"])
def test_each_package_reads_the_others_files(tmp_path, codec):
    """The same frames written by both packages; each package's reader on
    each file. AVI files are byte-equal (DIB: the same truncation; MJPG:
    the port's encoder writes PIL's bytes); Y4M frames read the same but
    for the planes' rounding edges."""
    ext = ".y4m" if codec == "y4m" else ".avi"
    frames = _frames(3, 24, 32)
    paths = {}
    for name, mod in (("jax", jvideo), ("torch", tvideo)):
        paths[name] = str(tmp_path / f"{name}{ext}")
        wtr = mod.create_video_writer(paths[name], (32, 24), fps=29.97, codec=codec)
        for f in frames:
            wtr.write(f)
        wtr.release()
    if codec != "y4m":
        with open(paths["jax"], "rb") as f1, open(paths["torch"], "rb") as f2:
            assert f1.read() == f2.read()
    for p in paths.values():
        ours = _read_all(tvideo.VideoReader(p, batch=2, to_device=False))
        theirs = np.concatenate([np.asarray(b) for b in jvideo.VideoReader(p, batch=2, to_device=False)], 0)
        assert ours.shape == theirs.shape == (3, 24, 32, 3)
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)
        if codec != "y4m":
            rdr, jrdr = tvideo.AVIReader(p), jvideo.AVIReader(p)
            assert abs(rdr.fps - jrdr.fps) < 1e-9 and rdr.fourcc == jrdr.fourcc
            for i in range(3):
                np.testing.assert_array_equal(rdr.read(i), jrdr.read(i))
    a = _read_all(tvideo.VideoReader(paths["jax"], batch=3, to_device=False))
    b = _read_all(tvideo.VideoReader(paths["torch"], batch=3, to_device=False))
    assert np.abs(a - b).max() <= 1.5 / 255.0


def _in_thread(fn, timeout: float = 20.0):
    """Run fn in a thread joined with a timeout: a hang fails here instead of
    hanging the suite. Returns (result, exception)."""
    out, err = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:  # noqa: BLE001 - handed to the test thread
            err.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), "the video reader hung"
    return (out[0] if out else None), (err[0] if err else None)


def _mjpg(tmp_path, n, corrupt=None):
    p = str(tmp_path / "c.avi")
    wtr = tvideo.AVIWriter(p, (32, 24), fourcc="MJPG")
    for f in _frames(n, 24, 32):
        wtr.write(f)
    if corrupt is not None:
        wtr._frames[corrupt] = wtr._frames[corrupt][:40]  # a JPEG cut inside its headers
    wtr.release()
    return p


def test_a_corrupt_frame_raises_in_the_consumer(tmp_path):
    """Frame 5 of 8 is cut short: the batches before it arrive, then
    next_batch raises the decode error, then the stream has ended."""
    rdr = tvideo.VideoReader(_mjpg(tmp_path, 8, corrupt=5), batch=2, prefetch=1, to_device=False)
    got, err = _in_thread(lambda: [rdr.next_batch() for _ in range(2)])
    assert err is None and [b.shape[0] for b in got] == [2, 2]
    _, err = _in_thread(rdr.next_batch)
    assert isinstance(err, ValueError) and "JPEG" in str(err)
    assert _in_thread(rdr.next_batch) == (None, None)
    rdr.close()


def test_close_stops_a_pump_on_a_full_queue(tmp_path, monkeypatch):
    """40 frames in batches of 1 through a queue of 1: the pump blocks on the
    full queue; close() ends it and later calls raise at once. With decodes
    slowed to 0.2 s, a consumer waiting in another thread when close() is
    called raises too."""
    rdr = tvideo.VideoReader(_mjpg(tmp_path, 40), batch=1, prefetch=1, to_device=False)
    first, err = _in_thread(rdr.next_batch)
    assert err is None and first.shape == (1, 24, 32, 3)
    deadline = time.time() + 10
    while rdr._q.qsize() < 1 and time.time() < deadline:
        time.sleep(0.01)
    assert rdr._thread.is_alive()  # blocked on the full queue
    rdr.close()
    assert not rdr._thread.is_alive()
    _, err = _in_thread(rdr.next_batch)
    assert isinstance(err, RuntimeError) and "closed" in str(err)

    decode = tvideo.jpeg.decode

    def slow(data):
        time.sleep(0.2)
        return decode(data)

    monkeypatch.setattr(tvideo.jpeg, "decode", slow)
    rdr = tvideo.VideoReader(_mjpg(tmp_path, 40), batch=1, prefetch=1, to_device=False)
    box = {}

    def consume():
        try:
            while rdr.next_batch() is not None:
                pass
        except RuntimeError as e:
            box["err"] = e

    waiting = threading.Thread(target=consume, daemon=True)
    waiting.start()
    time.sleep(0.5)
    rdr.close()
    waiting.join(10)
    assert not waiting.is_alive() and "closed" in str(box.get("err"))
    assert not rdr._thread.is_alive()


@pytest.mark.parametrize("n_threads", [1, 2, 4])
def test_parallel_decode_keeps_the_order(tmp_path, monkeypatch, n_threads):
    """MJPG decodes that sleep 0-5 ms at random finish out of order; with 1,
    2 or 4 workers the batches still hold every frame in order, equal to a
    direct read."""
    monkeypatch.setattr(tvideo, "DECODE_THREADS", n_threads)
    path = _mjpg(tmp_path, 11)
    ref = np.stack([tvideo.AVIReader(path).read(i) for i in range(11)]).astype(np.float32) / np.float32(255.0)
    rng = np.random.default_rng(n_threads)
    lock = threading.Lock()
    decode = tvideo.jpeg.decode

    def jittery(data):
        with lock:
            pause = float(rng.uniform(0, 0.005))
        time.sleep(pause)
        return decode(data)

    monkeypatch.setattr(tvideo.jpeg, "decode", jittery)
    rdr = tvideo.VideoReader(path, batch=3, prefetch=1, to_device=False)
    got, err = _in_thread(lambda: [b for b in rdr])
    assert err is None and [b.shape[0] for b in got] == [3, 3, 3, 2]
    np.testing.assert_array_equal(np.concatenate(got), ref)
    assert rdr.frames_decoded == 11 and rdr.decode_s > 0


def test_readers_and_writers_reject_bad_input(tmp_path):
    with pytest.raises(ValueError, match="container"):
        tvideo.VideoReader(str(tmp_path / "v.mp4"), device="cpu")
    bad = tmp_path / "bad.y4m"
    bad.write_bytes(b"NOTY4M\n")
    with pytest.raises(ValueError, match="y4m"):
        tvideo.Y4MReader(str(bad))
    bad = tmp_path / "bad.avi"
    bad.write_bytes(b"RIFX....AVI ")
    with pytest.raises(ValueError, match="AVI"):
        tvideo.AVIReader(str(bad))
    assert os.path.exists(str(tmp_path))
