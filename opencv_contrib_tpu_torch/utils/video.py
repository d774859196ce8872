"""Video IO, the cudacodec role (the port of opencv_contrib_tpu/utils/video.py;
reference: modules/cudacodec `cv::cudacodec::VideoReader/VideoWriter`).

Containers and bitstreams are handled on the host: Y4M and AVI demux are
byte slicing, and an MJPG frame is a baseline JPEG read and written by the
port's own codec (`utils/jpeg.py`, host C++, at the quality the JAX package
gives PIL). A background thread keeps frames flowing (the role of
cudacodec's videoSource thread); the pixel work, YUV 4:2:0 -> RGB and the
scaling to [0, 1], runs batched on the reader's device.

Formats, byte for byte those of the JAX package, so each package reads the
other's files:
- Y4M (YUV4MPEG2), I420 planes ("C420jpeg"), read and written;
- AVI with 'DIB ' (uncompressed BGR24, bottom-up, rows without padding)
  or 'MJPG' frames in '00dc' chunks, read and written. `AVIWriter.write`
  scales a float frame by 255 and truncates, as the JAX writer does.

`VideoReader.next_batch` returns a (B, H, W, 3) float32 tensor on the
reader's device ("cuda" by default), or numpy with `to_device=False`, and
None at the end of the stream (again on every later call). An MJPG file's
frames are decoded by DECODE_THREADS workers (the codec releases the GIL),
at most two batches ahead, and handed on in order. Unlike the JAX
reader, whose pump thread dies on an exception while `next_batch` waits on
its queue forever, the pump hands an exception (a corrupt MJPG frame, a
truncated file) to the consumer, which raises it; `close()` (or dropping the
reader) stops a pump blocked on a full queue, and a `next_batch` waiting in
another thread then raises instead of waiting.
"""

from __future__ import annotations

import os
import queue
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np
import torch

from opencv_contrib_tpu_torch.utils import jpeg, native
from opencv_contrib_tpu_torch.utils.device import resolve

_POLL_S = 0.05  # how often a blocked pump or consumer looks at the stop flag
DECODE_THREADS = 4  # an MJPG file's decode workers


# ---------------------------------------------------------------------------
# device colour conversion (BT.601 full range, the Y4M default)

def yuv420_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """I420 planes ([B,]H,W), ([B,]H/2,W/2) x2 in [0,255] -> RGB float32
    [0,1] on their device. Chroma is upsampled by nearest."""
    up = u.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    vp = v.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    yf = y.to(torch.float32)
    uf = up.to(torch.float32) - 128.0
    vf = vp.to(torch.float32) - 128.0
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    # a tensor divisor: the card divides a tensor by a Python scalar as a product by its reciprocal
    scale = torch.full((), 255.0, dtype=torch.float32, device=yf.device)
    return torch.clamp(torch.stack([r, g, b], dim=-1) / scale, 0.0, 1.0)


def rgb_to_yuv420(rgb: torch.Tensor):
    """RGB float [0,1] ([B,]H,W,3) -> (y, u, v) uint8 I420 planes on its
    device; chroma by 2x2 averages, every plane rounded half to even."""
    rgb = rgb.to(torch.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 0.5
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 0.5
    H, W = y.shape[-2], y.shape[-1]

    def sub(c):
        return c.reshape(c.shape[:-2] + (H // 2, 2, W // 2, 2)).mean(dim=(-3, -1))

    def to8(a):
        return torch.clamp(torch.round(a * 255.0), 0, 255).to(torch.uint8)

    return to8(y), to8(sub(u)), to8(sub(v))


# ---------------------------------------------------------------------------
# Y4M

def _fps_to_ratio(fps: float):
    if abs(fps - round(fps)) < 1e-9:
        return int(round(fps)), 1
    return int(round(fps * 1001)), 1001


class Y4MWriter:
    def __init__(self, path: str, size: Tuple[int, int], fps: float = 30.0):
        self.w, self.h = size
        num, den = _fps_to_ratio(fps)
        self._f = open(path, "wb")
        self._f.write(f"YUV4MPEG2 W{self.w} H{self.h} F{num}:{den} Ip A1:1 C420jpeg\n".encode())

    def write(self, frame):
        """frame: RGB float [0,1] (H,W,3) array or tensor (converted on its
        device), or a tuple of I420 planes."""
        if isinstance(frame, tuple):
            planes = [p.detach().cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p) for p in frame]
        else:
            t = frame if isinstance(frame, torch.Tensor) else torch.as_tensor(np.asarray(frame))
            planes = [p.cpu().numpy() for p in rgb_to_yuv420(t)]
        self._f.write(b"FRAME\n")
        for p in planes:
            self._f.write(np.ascontiguousarray(p, np.uint8).tobytes())

    def release(self):
        self._f.close()


class Y4MReader:
    def __init__(self, path: str):
        self._f = open(path, "rb")
        header = self._f.readline().decode("latin-1")
        if not header.startswith("YUV4MPEG2"):
            self._f.close()
            raise ValueError(f"{path}: not a y4m file")
        self.w = self.h = 0
        self.fps = 30.0
        for tok in header.split()[1:]:
            if tok[0] == "W":
                self.w = int(tok[1:])
            elif tok[0] == "H":
                self.h = int(tok[1:])
            elif tok[0] == "F":
                n, d = tok[1:].split(":")
                self.fps = float(n) / float(d)

    def read_planes(self):
        line = self._f.readline()
        if not line or not line.startswith(b"FRAME"):
            return None
        ysz = self.w * self.h
        csz = ysz // 4
        buf = self._f.read(ysz + 2 * csz)
        if len(buf) < ysz + 2 * csz:
            return None
        y = np.frombuffer(buf, np.uint8, ysz).reshape(self.h, self.w)
        u = np.frombuffer(buf, np.uint8, csz, ysz).reshape(self.h // 2, self.w // 2)
        v = np.frombuffer(buf, np.uint8, csz, ysz + csz).reshape(self.h // 2, self.w // 2)
        return y, u, v

    def __iter__(self) -> Iterator[tuple]:
        while True:
            p = self.read_planes()
            if p is None:
                return
            yield p

    def release(self):
        self._f.close()


# ---------------------------------------------------------------------------
# AVI (RIFF): uncompressed DIB and MJPEG

def _chunk(tag: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return tag + struct.pack("<I", len(payload)) + payload + pad


def _list(tag: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", tag + payload)


class AVIWriter:
    """Minimal AVI writer: 'DIB ' (uncompressed BGR24 bottom-up) or 'MJPG'."""

    def __init__(self, path: str, size: Tuple[int, int], fps: float = 30.0, fourcc: str = "DIB ",
                 quality: int = 90):
        self.path = path
        self.w, self.h = size
        self.fps = fps
        self.fourcc = fourcc
        self.quality = quality
        self._frames = []

    def write(self, frame):
        arr = frame.detach().cpu().numpy() if isinstance(frame, torch.Tensor) else np.asarray(frame)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        if self.fourcc == "MJPG":
            self._frames.append(jpeg.encode(arr, quality=self.quality))
        else:
            self._frames.append(arr[::-1, :, ::-1].tobytes())  # bottom-up BGR

    def release(self):
        n = len(self._frames)
        us_per_frame = int(1e6 / self.fps)
        fcc = self.fourcc.encode()
        avih = struct.pack("<14I", us_per_frame, 0, 0, 0x10, n, 0, 1, 0, self.w, self.h, 0, 0, 0, 0)
        # rate / scale as an exact ratio (29.97 -> 30000/1001): readers honour strh over avih
        fnum, fden = _fps_to_ratio(self.fps)
        strh = struct.pack("<4s4sIHHIIIIIIII4H", b"vids", fcc, 0, 0, 0, 0, fden, fnum, 0, n, 0, 0xFFFFFFFF, 0,
                           0, 0, self.w, self.h)
        bi_comp = 0 if self.fourcc == "DIB " else struct.unpack("<I", b"MJPG")[0]
        strf = struct.pack("<IiiHHIIiiII", 40, self.w, self.h, 1, 24, bi_comp, self.w * self.h * 3, 0, 0, 0, 0)
        strl = _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf))
        hdrl = _list(b"hdrl", _chunk(b"avih", avih) + strl)
        parts, offs, at = [b"movi"], [], 4
        for fr in self._frames:
            offs.append(at)
            c = _chunk(b"00dc", fr)
            parts.append(c)
            at += len(c)
        movi = _chunk(b"LIST", b"".join(parts))
        idx = b"".join(struct.pack("<4sIII", b"00dc", 0x10, off, len(fr)) for off, fr in zip(offs, self._frames))
        riff_payload = b"AVI " + hdrl + movi + _chunk(b"idx1", idx)
        with open(self.path, "wb") as f:
            f.write(_chunk(b"RIFF", riff_payload))


class AVIReader:
    """Minimal AVI demuxer for the writer's output (DIB / MJPG '00dc' chunks)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
            raise ValueError(f"{path}: not an AVI file")
        self.w = self.h = 0
        self.fps = 30.0
        self.fourcc = "DIB "
        self._frames = []
        self._parse(data[12: 8 + struct.unpack("<I", data[4:8])[0]])

    def _parse(self, buf: bytes):
        pos = 0
        while pos + 8 <= len(buf):
            tag = buf[pos:pos + 4]
            size = struct.unpack("<I", buf[pos + 4:pos + 8])[0]
            body = buf[pos + 8:pos + 8 + size]
            if tag == b"LIST":
                self._parse(body[4:])
            elif tag == b"strh":
                self.fourcc = body[4:8].decode("latin1")
                scale, rate = struct.unpack("<II", body[20:28])
                if scale:
                    self.fps = rate / scale
            elif tag == b"strf":
                self.w, self.h = struct.unpack("<ii", body[4:12])
                self.h = abs(self.h)
            elif tag[2:] == b"dc":
                self._frames.append(body)
            pos += 8 + size + (size % 2)

    def __len__(self):
        return len(self._frames)

    def read(self, i: int) -> np.ndarray:
        """Frame i as (H, W, 3) uint8 RGB (a gray MJPG frame repeated
        thrice, as PIL's convert("RGB") gives it)."""
        raw = self._frames[i]
        if self.fourcc.strip() in ("MJPG", "mjpg"):
            img = jpeg.decode(raw)
            return np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img
        bgr = np.frombuffer(raw, np.uint8).reshape(self.h, self.w, 3)
        return bgr[::-1, :, ::-1].copy()

    def __iter__(self):
        for i in range(len(self._frames)):
            yield self.read(i)


# ---------------------------------------------------------------------------
# VideoReader: a background demux / decode thread and batched device conversion
# (cudacodec.hpp VideoReader::nextFrame semantics)

_END = object()


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


class VideoReader:
    def __init__(self, path: str, batch: int = 8, prefetch: int = 2, to_device: bool = True, device="cuda"):
        ext = os.path.splitext(path)[1].lower()
        if ext == ".y4m":
            self._src: object = Y4MReader(path)
            self._mode = "y4m"
        elif ext == ".avi":
            self._src = AVIReader(path)
            self._mode = "avi"
        else:
            raise ValueError(f"unsupported container: {ext}")
        if batch < 1 or prefetch < 1:
            raise ValueError(f"VideoReader: batch and prefetch must be >= 1, got {batch}, {prefetch}")
        self.width, self.height, self.fps = self._src.w, self._src.h, self._src.fps
        self.batch = batch
        self.to_device = to_device
        self.device = resolve(device) if to_device else torch.device("cpu")
        self.frames_decoded = 0  # frames read and decoded so far
        self.decode_s = 0.0  # host seconds spent on them, summed over the workers
        self._lock = threading.Lock()
        self._done = False
        self._stop = threading.Event()
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread = threading.Thread(target=self._pump, daemon=True, name="video-reader")
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue item, waiting for room while the reader is open."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _decode(self, i: int):
        t0 = time.perf_counter()
        fr = self._src.read(i)
        with self._lock:
            self.decode_s += time.perf_counter() - t0
        return fr

    def _frames(self):
        """The source's frames in order: a Y4M file's read in turn, an AVI's
        decoded by the pool, at most two batches ahead."""
        if self._mode == "y4m":
            it = iter(self._src)
            while True:
                t0 = time.perf_counter()
                fr = next(it, None)
                self.decode_s += time.perf_counter() - t0
                if fr is None:
                    return
                yield fr
        pool = ThreadPoolExecutor(DECODE_THREADS, thread_name_prefix="video-decode")
        yield from native.ordered_prefetch(pool, self._decode, len(self._src), 2 * self.batch)

    def _pump(self):
        try:
            buf = []
            frames = self._frames()
            for fr in frames:
                if self._stop.is_set():
                    frames.close()
                    return
                self.frames_decoded += 1
                buf.append(fr)
                if len(buf) == self.batch:
                    if not self._put(buf):
                        frames.close()
                        return
                    buf = []
            if self._stop.is_set() or (buf and not self._put(buf)):
                return
            self._put(_END)
        except BaseException as e:  # handed to the consumer, which raises it
            self._put(_Failure(e))

    def _get(self):
        while True:
            if self._stop.is_set():
                raise RuntimeError("VideoReader: the reader was closed")
            try:
                return self._q.get(timeout=_POLL_S)
            except queue.Empty:
                continue

    def next_batch(self):
        """-> RGB float32 (B,H,W,3) on the reader's device (numpy with
        to_device=False), or None at the end of the stream. A frame that
        failed to decode raises here, in the consumer."""
        if self._done:
            return None
        item = self._get()
        if item is _END:
            self._done = True
            return None
        if isinstance(item, _Failure):
            self._done = True
            raise item.exc
        dev = self.device
        if self._mode == "y4m":
            planes = [torch.from_numpy(np.stack([f[i] for f in item])) for i in range(3)]
            if dev.type == "cuda":
                planes = [p.pin_memory().to(dev, non_blocking=True) for p in planes]
            rgb = yuv420_to_rgb(*planes)
        else:
            u8 = torch.from_numpy(np.stack(item))
            if dev.type == "cuda":
                u8 = u8.pin_memory().to(dev, non_blocking=True)
            # the quotient by a tensor: numpy's float32 `/ 255.0`, correctly rounded, on either device
            rgb = u8.to(torch.float32) / torch.full((), 255.0, dtype=torch.float32, device=dev)
        return rgb if self.to_device else rgb.numpy()

    def __iter__(self):
        while True:
            b = self.next_batch()
            if b is None:
                return
            yield b

    def close(self):
        """Stop the pump (also one blocked on a full queue) and release the
        source; a `next_batch` waiting in another thread raises."""
        self._stop.set()
        thread = getattr(self, "_thread", None)
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5.0)
        if isinstance(getattr(self, "_src", None), Y4MReader) and not (thread and thread.is_alive()):
            self._src.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def create_video_reader(path: str, **kw) -> VideoReader:
    """cudacodec::createVideoReader twin (cudacodec.hpp:322)."""
    return VideoReader(path, **kw)


def create_video_writer(path: str, size, fps: float = 30.0, codec: str = "auto"):
    """cudacodec::createVideoWriter twin. codec: 'y4m' | 'DIB ' | 'MJPG'."""
    ext = os.path.splitext(path)[1].lower()
    if codec == "auto":
        codec = "y4m" if ext == ".y4m" else "DIB "
    if codec == "y4m":
        return Y4MWriter(path, size, fps)
    return AVIWriter(path, size, fps, fourcc=codec)
