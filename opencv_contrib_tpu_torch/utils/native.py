"""Image decode and the TUM RGB-D sequence loader — the port's counterpart of
opencv_contrib_tpu/utils/native.py, which binds the C++ runtime of
native/dataset_loader.cpp (libpng, libjpeg and a threaded prefetch queue).
The port does not bind that library: it decodes with its own codecs
(`utils/png.py`, whose unfilter is host C++, and the host C++ baseline
JPEG codec of `utils/jpeg.py`) and prefetches with a thread pool.

`decode_png` gives the values the native decode gives: the samples as
libpng expands them there (a palette to RGB, 1-, 2- and 4-bit gray to 8
bits, tRNS to an alpha channel: `png.expand`), 8-bit samples times 1/255,
16-bit samples times 1/depth_scale (TUM depth in meters) or 1/65535, each
factor rounded to float32 first, as the C++ computes it. `decode_image`
takes `.jpg` / `.jpeg` through the JPEG codec, whose samples equal
libjpeg's, times 1/255.

`TumLoader` yields `(t_rgb, rgb (H, W, 3), t_depth, depth (H, W))`, float32,
in the order of the associated pairs; its depth is the quotient of the
16-bit samples by depth_scale (`io.imread_depth_tum`, the JAX package's
Python reader), which the native loader's product by the rounded
reciprocal misses by an ulp now and then. Its design is an ordered window of
futures: a `ThreadPoolExecutor(n_threads)` decodes frames (zlib and the
ctypes unfilter release the GIL); the consumer submits frame i + prefetch
when it takes frame i, so at most `prefetch` frames are in flight, and it
waits only on the future of the frame it needs. A worker never waits for
anything: it decodes the frame it was given and returns. The native queue's
stall (a worker holding a decoded frame waits for a free slot while the
consumer waits for an earlier frame that no slot is left for,
native/dataset_loader.cpp:231, :238-253) has no counterpart here: the frame
the consumer waits for was submitted before every frame still pending, and
the pool's workers take submissions in order. A decode error is raised to
the consumer at its frame, never skipped; `close()` (or leaving the `with`
block, or dropping the iterator) cancels the work still pending.
"""

from __future__ import annotations

import collections
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from opencv_contrib_tpu_torch.utils import datasets, jpeg, png
from opencv_contrib_tpu_torch.utils.io import imread_depth_tum


def ordered_prefetch(pool: ThreadPoolExecutor, fn, n: int, ahead: int):
    """Yield fn(0), ..., fn(n - 1) in order, with up to `ahead` calls
    submitted to `pool` ahead of the consumer. A call's exception is raised
    at its item. When the generator ends or is closed, the calls not yet
    started are cancelled and the pool is shut down without waiting."""
    window, nxt = collections.deque(), 0
    try:
        while nxt < n and len(window) < ahead:
            window.append(pool.submit(fn, nxt))
            nxt += 1
        while window:
            item = window.popleft().result()
            if nxt < n:
                window.append(pool.submit(fn, nxt))
                nxt += 1
            yield item
    finally:
        for f in window:
            f.cancel()
        pool.shutdown(wait=False, cancel_futures=True)


def available() -> bool:
    """True when the decoders can run here: their host routines build (or
    are built) with the host compiler."""
    try:
        png.unfilter_lib()
        jpeg.codec_lib()
    except RuntimeError:
        return False
    return True


def decode_png(path: str, depth_scale: float = -1.0) -> np.ndarray:
    """Decode a PNG with the port's codec. depth_scale > 0: 16-bit values
    divided by it (TUM depth); otherwise 8-bit -> [0, 1], 16-bit -> [0, 1].
    Returns (H, W) or (H, W, C) float32. A missing or corrupt file raises
    IOError (OSError). A `.jpg` / `.jpeg` path is decoded as JPEG
    (`decode_jpeg`), as the native runtime dispatches by extension."""
    if os.path.splitext(path)[1].lower() in (".jpg", ".jpeg"):
        return decode_jpeg(path)
    try:
        samples = png.read(path)
    except ValueError as e:
        raise IOError(f"PNG decode failed: {path}: {e}") from e
    if samples.dtype == np.uint16:
        s = np.float32(1.0) / np.float32(depth_scale if depth_scale > 0 else 65535.0)
    else:
        s = np.float32(1.0) / np.float32(255.0)
    return samples.astype(np.float32) * s


def decode_jpeg(path: str) -> np.ndarray:
    """Decode a baseline JPEG with the port's codec: (H, W) or (H, W, 3)
    float32, the 8-bit samples times 1/255. A missing or corrupt file
    raises IOError (OSError); a mode the codec lacks (progressive,
    arithmetic, lossless, 12-bit, 4 components), NotImplementedError."""
    try:
        samples = jpeg.read(path)
    except ValueError as e:
        raise IOError(f"JPEG decode failed: {path}: {e}") from e
    return samples.astype(np.float32) * (np.float32(1.0) / np.float32(255.0))


def decode_image(path: str, depth_scale: float = -1.0) -> np.ndarray:
    """Decode by extension: JPEG (`.jpg`, `.jpeg`: the SfM photo feeds of
    the native runtime) or PNG (anything else, as the native runtime
    dispatches)."""
    return decode_png(path, depth_scale)


class TumLoader:
    """Threaded prefetching TUM RGB-D sequence iterator: rgb.txt and
    depth.txt associated within max_dt (`datasets.associate`), frames
    decoded by `n_threads` workers at most `prefetch` frames ahead."""

    def __init__(self, root: str, depth_scale: float = 5000.0, max_dt: float = 0.02, n_threads: int = 4,
                 prefetch: int = 8):
        if n_threads < 1 or prefetch < 1:
            raise ValueError(f"TumLoader: n_threads and prefetch must be >= 1, got {n_threads}, {prefetch}")
        self.root, self.depth_scale = str(root), float(depth_scale)
        self.n_threads, self.prefetch = int(n_threads), int(prefetch)
        try:
            rgb = datasets._read_tum_list(os.path.join(self.root, "rgb.txt"))
            depth = datasets._read_tum_list(os.path.join(self.root, "depth.txt"))
        except OSError as e:
            raise IOError(f"failed to open TUM sequence at {root}: {e}") from e
        self.pairs = datasets.associate(rgb, depth, max_dt)
        if not self.pairs:
            raise IOError(f"failed to open TUM sequence at {root}: no associated frames")
        self.size = len(self.pairs)
        first = decode_png(os.path.join(self.root, self.pairs[0][1]))
        self.height, self.width = first.shape[:2]
        self._pool = None

    def __len__(self):
        return self.size

    def _frame(self, i: int):
        t_rgb, rgb_path, t_depth, depth_path = self.pairs[i][:4]
        rgb = decode_png(os.path.join(self.root, rgb_path))
        if rgb.ndim == 2:
            rgb = np.stack([rgb] * 3, axis=-1)
        try:
            depth = imread_depth_tum(os.path.join(self.root, depth_path), self.depth_scale)
        except ValueError as e:
            raise IOError(f"PNG decode failed: {depth_path}: {e}") from e
        return t_rgb, rgb[..., :3], t_depth, depth

    def __iter__(self):
        self.close()
        self._pool = ThreadPoolExecutor(self.n_threads, thread_name_prefix="tum-loader")
        yield from ordered_prefetch(self._pool, self._frame, self.size, self.prefetch)

    def close(self):
        """Cancel the decodes not yet started; those running finish on their
        own and their frames are dropped."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
