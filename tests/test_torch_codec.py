"""The port's image codecs against PIL and the JAX package's native decode.

PNG: every colour type and bit depth the specification allows, with and
without a tRNS chunk, plain and Adam7-interlaced, written from raw chunks
by `png.encode_raw` (PIL writes no interlaced PNG and no 2- or 4-bit gray),
plus the palette, 1-bit and transparent files PIL writes itself. Each file
is read by both routes and held bit for bit to its twin: `utils.io.imread`
(and its samples) to PIL, as the JAX `utils/io.py` reads them, and
`utils.native.decode_png` to the native decode (libpng), which expands a
palette, low-bit gray and tRNS.

JPEG: the port's decode bit for bit against PIL (libjpeg-turbo) and the
native decode on files PIL writes at qualities 10-95, 4:4:4, 4:2:2 and
4:2:0, gray, odd sizes and restart intervals; its encoder byte for byte
against PIL's for the same frame and quality; and the modes it lacks
raising NotImplementedError."""

import io as pyio
import os
import warnings

import numpy as np
import pytest
from PIL import Image

from opencv_contrib_tpu.utils import io as jio
from opencv_contrib_tpu.utils import native as jnative
from opencv_contrib_tpu_torch.utils import io as tio
from opencv_contrib_tpu_torch.utils import jpeg, png
from opencv_contrib_tpu_torch.utils import native as tnative

NATIVE = pytest.mark.skipif(not jnative.available(), reason="the JAX package's native library is not built")
SUBSAMPLING = {0: "4:4:4", 1: "4:2:2", 2: "4:2:0"}  # PIL's subsampling codes


def _pil(path, gray=False):
    with warnings.catch_warnings():  # PIL warns on a palette with tRNS bytes
        warnings.simplefilter("ignore")
        im = Image.open(path)
        return np.asarray(im.convert("L") if gray else im)


def _jax_imread(path, gray=False):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jio.imread(path, gray=gray)


def _png_cases():
    rng = np.random.default_rng(0)
    H, W = 13, 21  # odd: partial bytes at low depths, Adam7 passes of every size
    cases = []
    for depth in (1, 2, 4, 8, 16):
        s = rng.integers(0, 2 ** depth, (H, W))
        cases += [(f"gray{depth}", s, depth, 0, None, None), (f"gray{depth}_trns", s, depth, 0, None, [int(s[0, 0])])]
    for depth in (1, 2, 4, 8):
        n = min(2 ** depth, 200)
        pal = rng.integers(0, 256, (n, 3))
        s = rng.integers(0, n, (H, W))
        cases += [(f"palette{depth}", s, depth, 3, pal, None),
                  (f"palette{depth}_trns", s, depth, 3, pal, rng.integers(0, 256, n // 2 + 1))]
    for depth in (8, 16):
        s = rng.integers(0, 2 ** depth, (H, W, 3))
        s[1, :5] = s[0, 0]  # six pixels of the transparent colour
        cases += [(f"rgb{depth}", s, depth, 2, None, None), (f"rgb{depth}_trns", s, depth, 2, None, s[0, 0]),
                  (f"gray_alpha{depth}", rng.integers(0, 2 ** depth, (H, W, 2)), depth, 4, None, None),
                  (f"rgba{depth}", rng.integers(0, 2 ** depth, (H, W, 4)), depth, 6, None, None)]
    return cases


PNG_CASES = _png_cases()


@pytest.fixture(scope="module")
def png_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("png")
    out = {}
    for name, s, depth, ctype, pal, trns in PNG_CASES:
        for interlace in (False, True):
            path = str(root / f"{name}_{'adam7' if interlace else 'plain'}.png")
            with open(path, "wb") as f:
                f.write(png.encode_raw(s, depth, ctype, palette=pal, trns=trns, interlace=interlace))
            out[(name, interlace)] = path
    return out


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("name", [c[0] for c in PNG_CASES])
def test_png_pil_route(png_files, name, interlace):
    """imread's samples, imread and imread(gray=True) equal PIL's and the
    JAX imread's bit for bit: palette indices, 1-bit gray as bool, 2- and
    4-bit gray scaled to 0-255, tRNS ignored."""
    path = png_files[(name, interlace)]
    ref = _pil(path)
    got = tio._pil_samples(path)[0]
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    for gray in (False, True):
        a, b = tio.imread(path, gray=gray), _jax_imread(path, gray=gray)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@NATIVE
@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("name", [c[0] for c in PNG_CASES])
def test_png_native_route(png_files, name, interlace):
    """decode_png equals the native decode (libpng: palette to RGB, low-bit
    gray to 8 bits, tRNS to alpha, de-interlaced) bit for bit, at both
    scales."""
    path = png_files[(name, interlace)]
    for scale in (-1.0, 5000.0):
        a, b = tnative.decode_png(path, scale), jnative.decode_png(path, scale)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_png_expansions_by_hand():
    """The expansions themselves: a 2-bit palette with tRNS to RGBA, 4-bit
    gray scaled by 17 with its transparent value, an Adam7 file equal to
    the plain one."""
    pal = np.array([[10, 20, 30], [40, 50, 60], [70, 80, 90]], np.uint8)
    idx = np.array([[0, 1, 2, 1], [2, 2, 0, 3]])
    raw = png.decode_raw(png.encode_raw(idx, 2, 3, palette=pal, trns=[0, 128]))
    np.testing.assert_array_equal(raw.samples, idx)
    rgba = png.expand(raw)
    assert rgba.shape == (2, 4, 4)
    np.testing.assert_array_equal(rgba[0, 1], [40, 50, 60, 128])
    np.testing.assert_array_equal(rgba[1, 3], [0, 0, 0, 255])  # past PLTE: libpng's zeroed entries, opaque
    g = np.array([[0, 5, 15], [5, 5, 1]])
    ga = png.decode(png.encode_raw(g, 4, 0, trns=[5]))
    np.testing.assert_array_equal(ga[..., 0], g * 17)
    np.testing.assert_array_equal(ga[..., 1], np.where(g == 5, 0, 255))
    x = np.random.default_rng(1).integers(0, 65536, (9, 11, 3))
    np.testing.assert_array_equal(png.decode(png.encode_raw(x, 16, 2, interlace=True)), x)


@pytest.mark.parametrize("kind", ["P", "P4", "P1", "1", "L_trns", "RGB_trns", "P_trns"])
def test_png_files_pil_writes(tmp_path, kind):
    """Files PIL itself writes: both routes against their twins."""
    rgb = (np.random.default_rng(2).random((17, 23, 3)) * 255).astype(np.uint8)
    im = Image.fromarray(rgb)
    path = str(tmp_path / f"{kind}.png")
    if kind.startswith("P"):
        bits = {"P": 8, "P4": 4, "P1": 1, "P_trns": 8}[kind]
        pim = im.quantize(colors=2 ** bits if bits < 8 else 200)
        kw = {"bits": bits} if bits < 8 else {}
        if kind == "P_trns":
            kw["transparency"] = bytes([0, 64, 255, 7])
        pim.save(path, **kw)
    elif kind == "1":
        im.convert("1").save(path)
    elif kind == "L_trns":
        im.convert("L").save(path, transparency=int(np.asarray(im.convert("L"))[0, 0]))
    else:
        im.save(path, transparency=tuple(int(v) for v in rgb[0, 0]))
    np.testing.assert_array_equal(tio._pil_samples(path)[0], _pil(path))
    for gray in (False, True):
        np.testing.assert_array_equal(tio.imread(path, gray=gray), _jax_imread(path, gray=gray))
    if jnative.available():
        np.testing.assert_array_equal(tnative.decode_png(path), jnative.decode_png(path))


def _texture(H, W, C, seed):
    """Blocky noise with fine grain: every coefficient band carries energy."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.random((H // 4 + 2, W // 4 + 2, C)), np.ones((4, 4, 1)))[:H, :W]
    x = (0.7 * base + 0.3 * rng.random((H, W, C))) * 255
    a = x.astype(np.uint8)
    return a if C == 3 else a[..., 0]


def _pil_jpeg(a, **kw) -> bytes:
    buf = pyio.BytesIO()
    Image.fromarray(a).save(buf, "JPEG", **kw)
    return buf.getvalue()


JPEG_CASES = ([(37, 53, 3, q, sub) for q in (10, 35, 75, 95) for sub in (0, 1, 2)]
              + [(37, 53, 1, q, 0) for q in (10, 50, 90)]
              + [(H, W, 3, 75, 2) for H, W in ((1, 1), (2, 3), (8, 8), (16, 16), (17, 23), (9, 31), (120, 160))]
              + [(H, W, 3, 80, 1) for H, W in ((1, 1), (3, 5), (15, 17))]
              + [(H, W, 1, 75, 0) for H, W in ((1, 1), (7, 9), (120, 160))])


@pytest.mark.parametrize("H,W,C,q,sub", JPEG_CASES)
def test_jpeg_decode_and_encode_match_pil(tmp_path, H, W, C, q, sub):
    """decode of PIL's file equals PIL's samples, and the native decode's
    values, bit for bit; encode of the same frame gives PIL's bytes."""
    a = _texture(H, W, C, seed=H * 1000 + W + q)
    data = _pil_jpeg(a, quality=q, subsampling=sub)
    ref = np.asarray(Image.open(pyio.BytesIO(data)))
    got = jpeg.decode(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert jpeg.encode(a, quality=q, subsampling=SUBSAMPLING[sub]) == data
    path = str(tmp_path / "f.jpg")
    with open(path, "wb") as f:
        f.write(data)
    if jnative.available():
        np.testing.assert_array_equal(tnative.decode_image(path), jnative.decode_image(path))


@pytest.mark.parametrize("kw", [{"restart_marker_blocks": 1}, {"restart_marker_blocks": 3},
                                {"restart_marker_rows": 1}], ids=["every_mcu", "every_3", "every_row"])
def test_jpeg_restart_intervals(tmp_path, kw):
    a = _texture(64, 80, 3, seed=5)
    data = _pil_jpeg(a, quality=80, **kw)
    assert b"\xff\xdd" in data
    np.testing.assert_array_equal(jpeg.decode(data), np.asarray(Image.open(pyio.BytesIO(data))))
    path = str(tmp_path / "r.jpeg")
    with open(path, "wb") as f:
        f.write(data)
    if jnative.available():
        np.testing.assert_array_equal(tnative.decode_image(path), jnative.decode_image(path))


@pytest.mark.parametrize("shape", [(41, 50), (7, 3), (16, 24)])
def test_jpeg_4_4_0_pil_cannot_write(shape):
    """4:4:0 (luma 1 x 2: the h1v2 fancy upsampler) from the port's encoder:
    PIL decodes it to the port's samples."""
    a = _texture(*shape, 3, seed=9)
    data = jpeg.encode(a, quality=85, subsampling="4:4:0")
    np.testing.assert_array_equal(jpeg.decode(data), np.asarray(Image.open(pyio.BytesIO(data))))


def _with_sof(data: bytes, marker: int) -> bytes:
    i = data.index(b"\xff\xc0")
    return data[:i + 1] + bytes([marker]) + data[i + 2:]


def test_jpeg_unsupported_modes_raise():
    a = _texture(24, 32, 3, seed=3)
    base = _pil_jpeg(a, quality=75)
    with pytest.raises(NotImplementedError, match="progressive"):
        jpeg.decode(_pil_jpeg(a, quality=75, progressive=True))
    for marker, what in ((0xC9, "arithmetic"), (0xC3, "lossless"), (0xC5, "hierarchical"), (0xCA, "progressive")):
        with pytest.raises(NotImplementedError, match=what):
            jpeg.decode(_with_sof(base, marker))
    i = base.index(b"\xff\xc0")
    twelve = base[:i + 4] + bytes([12]) + base[i + 5:]  # the SOF's sample precision
    with pytest.raises(NotImplementedError, match="12-bit"):
        jpeg.decode(twelve)
    cmyk = pyio.BytesIO()
    Image.new("CMYK", (16, 16), (10, 20, 30, 40)).save(cmyk, "JPEG")
    with pytest.raises(NotImplementedError, match="4-component|CMYK"):
        jpeg.decode(cmyk.getvalue())


def test_jpeg_corrupt_files_raise(tmp_path):
    data = _pil_jpeg(_texture(32, 40, 3, seed=4), quality=75)
    with pytest.raises(ValueError, match="SOI"):
        jpeg.decode(b"\x00" + data)
    with pytest.raises(ValueError):
        jpeg.decode(data[:len(data) // 2])
    path = str(tmp_path / "cut.jpg")
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])
    with pytest.raises(IOError):
        tnative.decode_image(path)
    with pytest.raises(IOError):
        tnative.decode_image(str(tmp_path / "missing.jpg"))


def test_io_reads_and_writes_jpeg_like_pil(tmp_path):
    """imwrite to .jpg writes PIL's bytes (quality 75, 4:2:0); imread of it,
    color and gray, equals the JAX imread."""
    a = _texture(30, 44, 3, seed=6)
    ours, theirs = str(tmp_path / "ours.jpg"), str(tmp_path / "theirs.jpg")
    tio.imwrite(ours, a.astype(np.float32) / 255.0)
    jio.imwrite(theirs, a.astype(np.float32) / 255.0)
    with open(ours, "rb") as f1, open(theirs, "rb") as f2:
        assert f1.read() == f2.read()
    for gray in (False, True):
        np.testing.assert_array_equal(tio.imread(ours, gray=gray), jio.imread(ours, gray=gray))
    with pytest.raises(NotImplementedError, match="PNG and JPEG"):
        tio.imread(str(tmp_path / "photo.bmp"))


def test_codecs_link_no_image_library():
    """The host sources include only the C++ standard library."""
    csrc = os.path.join(os.path.dirname(png.__file__), "csrc")
    for name in ("jpeg.cpp", "unfilter.cpp"):
        with open(os.path.join(csrc, name)) as f:
            includes = [ln for ln in f if ln.startswith("#include")]
        assert all(inc.split()[1] in ("<cstdint>", "<cstdlib>", "<cstring>", "<vector>") for inc in includes), includes


def test_enable_compile_cache_sets_the_build_root(monkeypatch, tmp_path):
    """utils.cache: the argument, else OCV_TPU_CACHE, else build/kernels; with
    OCV_TPU_NO_CACHE a directory of the process's own under it."""
    from opencv_contrib_tpu_torch.ops.cuda import _build
    from opencv_contrib_tpu_torch.utils import cache

    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
    monkeypatch.delenv("OCV_TPU_CACHE", raising=False)
    monkeypatch.delenv("OCV_TPU_NO_CACHE", raising=False)
    assert cache.enable_compile_cache() == _build.BUILD_ROOT == _build.DEFAULT_ROOT
    assert _build.DEFAULT_ROOT.parts[-2:] == ("build", "kernels")
    monkeypatch.setenv("OCV_TPU_CACHE", str(tmp_path / "env"))
    assert cache.enable_compile_cache() == tmp_path / "env" == _build.BUILD_ROOT
    assert cache.enable_compile_cache(str(tmp_path / "arg")) == tmp_path / "arg"
    monkeypatch.setenv("OCV_TPU_NO_CACHE", "1")
    assert cache.enable_compile_cache() == tmp_path / "env" / f"proc-{os.getpid()}" == _build.BUILD_ROOT


def test_mutated_jpegs_raise_or_decode():
    """600 random mutations (bytes changed, cut out, inserted) of baseline
    files PIL writes with restarts at three samplings: each decodes to an
    image or raises ValueError / NotImplementedError; none crashes the
    process."""
    rng = np.random.default_rng(0)
    a = _texture(40, 56, 3, seed=8)
    bases = [_pil_jpeg(a, quality=80, subsampling=sub, restart_marker_blocks=2) for sub in (2, 0, 1)]
    for it in range(600):
        d = bytearray(bases[it % 3])
        for _ in range(int(rng.integers(1, 6))):
            i, kind = int(rng.integers(0, len(d))), int(rng.integers(0, 3))
            if kind == 0:
                d[i] = int(rng.integers(0, 256))
            elif kind == 1:
                del d[i:i + int(rng.integers(1, 50))]
            else:
                d[i:i] = rng.integers(0, 256, int(rng.integers(1, 20))).astype(np.uint8).tobytes()
        try:
            out = jpeg.decode(bytes(d))
        except (ValueError, NotImplementedError):
            continue
        assert out.dtype == np.uint8 and out.ndim in (2, 3)
