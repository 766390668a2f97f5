"""The image-slider reader: decode a file and resize it to (res, res, 3)
float32 in [-1, 1] (port of sliders_tpu/data/native_loader.py and of the
decode and resize of sliders_tpu/data/native/imgloader.cpp).

    load_batch(paths, resolution) -> (N, res, res, 3) float32 in [-1, 1]

PNG is decoded here with zlib and numpy: every chunk's CRC is checked, the
five row filters are undone (a wavefront over the anti-diagonals, since
Average and Paeth depend on the left and upper bytes), Adam7 interlacing is
undone, and the result is 8-bit RGB as the JAX loader's libpng transforms
leave it (`imgloader.cpp:96-104`): 16-bit samples keep their high byte,
palette indices become RGB, grey below 8 bits is scaled to 8, grey becomes
RGB, alpha (tRNS too) is dropped.

JPEG is decoded by the port's copy of the loader's libjpeg decoder
(`native/imgloader.cpp`), built with g++ into `sliders_tpu_torch/_build/`
at the first JPEG. Where it cannot be built (no g++, no `jpeglib.h` or
libjpeg), a JPEG raises `JpegUnavailable`, a RuntimeError naming what is
missing, which the paired-folder reader does not take for a bad file.

The resize is PIL's bicubic (a = -0.5, support scaled by the downscale
ratio) with the C++ loader's arithmetic: coefficients in f64, normalised,
stored as f32; a horizontal then a vertical pass of f32 products and sums
in tap order; clamp to [0, 255], / 255, then x * 2 - 1.

`resize_bilinear_pil` is PIL's 8-bit bilinear resize bit for bit (the
LPIPS loader's, `evals/lpips.load_image_64`).

A missing file raises FileNotFoundError; a file that does not decode
raises ValueError naming it.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

from sliders_tpu_torch.ops._build import BUILD_DIR

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8\xff"
JPEG_SOURCE = Path(__file__).resolve().parent / "native" / "imgloader.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

# IHDR colour type -> (channels, allowed bit depths)
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7: (x0, y0, dx, dy) of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


class JpegUnavailable(RuntimeError):
    """The JPEG decoder cannot be built or loaded here (no g++, or no libjpeg)."""


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _chunks(data: bytes):
    """(type, payload) of every chunk up to IEND, each CRC-checked."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError("truncated PNG: no IEND chunk")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length + 4
        if end > len(data):
            raise ValueError(f"truncated PNG chunk {ctype!r}")
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(ctype + payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {ctype!r} fails its CRC")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos = end


def _unfilter(raw: np.ndarray, rows: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of `rows` scanlines of `rowbytes` bytes
    (each led by its filter byte) -> (rows, rowbytes) uint8. Byte (y, x)
    depends on (y, x - bpp), (y - 1, x) and (y - 1, x - bpp), so the bytes
    of one anti-diagonal of the (rows, rowbytes / bpp) pixel grid are
    independent: the grid is skewed so that each anti-diagonal is a column,
    and the columns are reconstructed in order."""
    lines = raw[:rows * (rowbytes + 1)].reshape(rows, rowbytes + 1)
    ftype = lines[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    filt = lines[:, 1:]
    if not ftype.any():
        return filt.copy()
    cols = rowbytes // bpp
    ys, xs = np.divmod(np.arange(rows * cols), cols)
    # pixel (y, x) sits at skewed[y + 1, y + x + 2]; row 0 and columns 0-1
    # stay zero: the prior row of the first line and the left of x = 0
    skewed_in = np.zeros((rows, rows + cols + 2, bpp), np.uint8)
    skewed_in[ys, ys + xs + 2] = filt.reshape(rows * cols, bpp)
    out = np.zeros((rows + 1, rows + cols + 2, bpp), np.uint8)
    ft_col = ftype.astype(np.int16)[:, None]
    for c in range(2, rows + cols + 1):
        y0, y1 = max(0, c - 1 - cols), min(rows - 1, c - 2)
        a = out[1 + y0:2 + y1, c - 1].astype(np.int16)  # left
        b = out[y0:y1 + 1, c - 1].astype(np.int16)  # up
        d = out[y0:y1 + 1, c - 2].astype(np.int16)  # upper left
        pa, pb, pc = np.abs(b - d), np.abs(a - d), np.abs(a + b - 2 * d)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, d))
        ft = ft_col[y0:y1 + 1]
        pred = np.where(ft == 1, a, np.where(ft == 2, b, np.where(
            ft == 3, (a + b) >> 1, np.where(ft == 4, paeth, 0))))
        out[1 + y0:2 + y1, c] = (skewed_in[y0:y1 + 1, c] + pred) & 0xFF
    return out[ys + 1, ys + xs + 2].reshape(rows, rowbytes)


def _to_rgb(lines: np.ndarray, width: int, depth: int, ctype: int,
            palette: np.ndarray) -> np.ndarray:
    """Unfiltered scanlines (rows, rowbytes) -> (rows, width, 3) uint8."""
    channels = _COLOR_TYPES[ctype][0]
    n = width * channels
    if depth == 16:
        samples = lines[:, 0:2 * n:2]  # png_set_strip_16: the high byte
    elif depth == 8:
        samples = lines[:, :n]
    else:
        bits = np.unpackbits(lines, axis=1)[:, :n * depth].reshape(len(lines), n, depth)
        samples = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(
            axis=2, dtype=np.uint8)
        if ctype == 0:  # png_set_expand_gray_1_2_4_to_8
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
    px = samples.reshape(len(lines), width, channels)
    if ctype == 3:
        return palette[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8, as the JAX loader's libpng transforms
    decode it. Raises ValueError on a malformed file."""
    header, palette, idat = None, None, []
    for ctype, payload in _chunks(data):
        if header is None and ctype != b"IHDR":
            raise ValueError("PNG does not start with IHDR")
        if ctype == b"IHDR":
            if len(payload) != 13:
                raise ValueError("bad IHDR length")
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            if len(payload) % 3 or not 0 < len(payload) <= 768:
                raise ValueError("bad PLTE length")
            palette = np.zeros((256, 3), np.uint8)  # entries past the palette read black
            palette[:len(payload) // 3] = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(payload)
    width, height, depth, ctype, compression, filter_method, interlace = header
    if ctype not in _COLOR_TYPES or depth not in _COLOR_TYPES[ctype][1]:
        raise ValueError(f"bad PNG colour type {ctype} at bit depth {depth}")
    if compression or filter_method or interlace > 1 or not width or not height:
        raise ValueError("bad PNG header")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    if not idat:
        raise ValueError("PNG without IDAT")
    try:
        raw = np.frombuffer(zlib.decompressobj().decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"bad PNG image data: {e}") from None
    bits_pp = _COLOR_TYPES[ctype][0] * depth
    bpp = max(1, bits_pp // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    image = np.empty((height, width, 3), np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        rowbytes = -(-(pw * bits_pp) // 8)
        size = ph * (rowbytes + 1)
        if pos + size > len(raw):
            raise ValueError("truncated PNG image data")
        lines = _unfilter(raw[pos:pos + size], ph, rowbytes, bpp)
        image[y0::dy, x0::dx] = _to_rgb(lines, pw, depth, ctype, palette)
        pos += size
    return image


# ---------------------------------------------------------------------------
# JPEG, through the C++ decoder
# ---------------------------------------------------------------------------

_jpeg_lock = threading.Lock()
_jpeg_lib = None


def jpeg_library_path() -> Path:
    """The build of `native/imgloader.cpp`, keyed by its source and flags."""
    digest = hashlib.sha1(JPEG_SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libimgloader_{digest.hexdigest()[:12]}.so"


def _jpeg_library():
    global _jpeg_lib
    with _jpeg_lock:
        if _jpeg_lib is not None:
            return _jpeg_lib
        path = jpeg_library_path()
        if not path.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                raise JpegUnavailable("reading a JPEG needs g++ to build the JPEG decoder "
                                      f"({JPEG_SOURCE.name}), and g++ is not on PATH")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            proc = subprocess.run([gxx, *GXX_FLAGS, str(JPEG_SOURCE), "-o", str(tmp), "-ljpeg"],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise JpegUnavailable(
                    "reading a JPEG needs libjpeg (jpeglib.h and libjpeg.so), and the JPEG "
                    f"decoder did not build against it:\n{proc.stderr.strip()[-2000:]}")
            os.replace(tmp, path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:  # built, but libjpeg.so (or the build itself) will not load
            raise JpegUnavailable(
                f"reading a JPEG needs libjpeg, and the JPEG decoder {path.name} does not "
                f"load: {e}") from e
        lib.jpeg_size.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int)]
        lib.jpeg_decode_rgb.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int]
        lib.jpeg_size.restype = lib.jpeg_decode_rgb.restype = ctypes.c_int
        _jpeg_lib = lib
        return lib


def decode_jpeg(path: str) -> np.ndarray:
    """A JPEG file -> (H, W, 3) uint8 through libjpeg (RGB output, as the
    JAX loader asks for). Raises ValueError if libjpeg refuses the file."""
    lib = _jpeg_library()
    name = os.fsencode(path)
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    if lib.jpeg_size(name, ctypes.byref(w), ctypes.byref(h)) != 0 or w.value <= 0 or h.value <= 0:
        raise ValueError("libjpeg cannot read the JPEG header")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.jpeg_decode_rgb(name, out.ctypes.data, w.value, h.value) != 0:
        raise ValueError("libjpeg cannot decode the JPEG")
    return out


# ---------------------------------------------------------------------------
# PIL-style bicubic resize (imgloader.cpp:146-230)
# ---------------------------------------------------------------------------


def _cubic(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic kernel, a = -0.5, in f64."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, out_size: int):
    """(first input index (out,), f32 weights (out, taps)): PIL's
    ImagingPrecomputeCoeffs, the filter's support scaled by the downscale
    ratio, each output's weights normalised by their sum in tap order;
    weights beyond an output's taps are 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)  # C++ int()
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = _cubic(((taps[None] + xmin[:, None]) - center[:, None] + 0.5) / filterscale)
    w = np.where(taps[None] < xmax[:, None], w, 0.0)
    ww = np.cumsum(w, axis=1)[:, -1:]  # summed in tap order; the zeros past xmax add nothing
    k = np.divide(w, ww, out=np.zeros_like(w), where=ww != 0.0)
    return xmin, k.astype(np.float32)


def _resample_rows(x: np.ndarray, out_size: int) -> np.ndarray:
    """One separable pass along axis 0 of an (n, m, 3) f32 array: f32
    products and sums in tap order -> (out_size, m, 3)."""
    in_size = x.shape[0]
    bounds, k = _coeffs(in_size, out_size)
    acc = np.zeros((out_size,) + x.shape[1:], np.float32)
    for t in range(k.shape[1]):
        idx = np.minimum(bounds + t, in_size - 1)  # past the taps the weight is 0
        acc += k[:, t, None, None] * x[idx]
    return acc


def resize_bicubic(img: np.ndarray, resolution: int) -> np.ndarray:
    """(h, w, 3) uint8 -> (res, res, 3) float32 in [-1, 1]: the horizontal
    pass, then the vertical, each gathering whole rows of a transposed
    copy."""
    wide = _resample_rows(img.transpose(1, 0, 2).astype(np.float32), resolution)  # (res, h, 3)
    out = _resample_rows(np.ascontiguousarray(wide.transpose(1, 0, 2)), resolution)
    out = np.clip(out, np.float32(0.0), np.float32(255.0)) / np.float32(255.0)
    return out * np.float32(2.0) - np.float32(1.0)


# ---------------------------------------------------------------------------
# PIL's 8-bit bilinear resize (Pillow's Resample.c): the LPIPS loader's
# ---------------------------------------------------------------------------

_PRECISION_BITS = 22  # 32 - 8 - 2


def _bilinear_coeffs_8bpc(in_size: int, out_size: int):
    """(first input index (out,), int64 fixed-point weights (out, taps)):
    Pillow's precompute_coeffs for the triangle filter (support 1 scaled by
    the reduction ratio, each output's f64 weights normalised by their sum
    in tap order), then normalize_coeffs_8bpc (x 2^22, rounded half away
    from zero); weights beyond an output's taps are 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)  # C int()
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    x = np.abs(((taps[None] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where((x < 1.0) & (taps[None] < xmax[:, None]), 1.0 - x, 0.0)
    ww = np.cumsum(w, axis=1)[:, -1:]
    k = np.divide(w, ww, out=np.zeros_like(w), where=ww != 0.0)
    k = k * (1 << _PRECISION_BITS)
    return xmin, np.trunc(np.where(k < 0, k - 0.5, k + 0.5)).astype(np.int64)


def _resample_rows_8bpc(x: np.ndarray, out_size: int) -> np.ndarray:
    """One 8-bit pass along axis 0 of an (n, m, 3) uint8 array: int64 sums
    from 2^21, shifted right by 22 and clipped to uint8."""
    in_size = x.shape[0]
    bounds, k = _bilinear_coeffs_8bpc(in_size, out_size)
    acc = np.full((out_size,) + x.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for t in range(k.shape[1]):
        idx = np.minimum(bounds + t, in_size - 1)  # past the taps the weight is 0
        acc += k[:, t, None, None] * x[idx].astype(np.int64)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear_pil(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(h, w, 3) uint8 -> (height, width, 3) uint8, bit for bit what
    `Image.resize((width, height), Image.BILINEAR)` gives an RGB image: the
    horizontal pass first, then the vertical."""
    wide = _resample_rows_8bpc(np.ascontiguousarray(img.transpose(1, 0, 2)), width)
    return _resample_rows_8bpc(np.ascontiguousarray(wide.transpose(1, 0, 2)), height)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def decode_file(path: str) -> np.ndarray:
    """A PNG or JPEG file -> (H, W, 3) uint8, told apart by their magic
    bytes as the JAX loader does."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data.startswith(JPEG_MAGIC):
            return decode_jpeg(path)
        if data.startswith(PNG_SIGNATURE):
            return decode_png(data)
        raise ValueError("neither a PNG nor a JPEG file")
    except ValueError as e:
        raise ValueError(f"cannot decode image: {path}: {e}") from None


def load_batch(paths: list, resolution: int) -> np.ndarray:
    """Decode + PIL-style bicubic resize + [-1, 1] normalise each path ->
    (N, res, res, 3) float32. Raises FileNotFoundError / ValueError on bad
    inputs, JpegUnavailable where a JPEG cannot be decoded here."""
    out = np.empty((len(paths), resolution, resolution, 3), np.float32)
    for i, p in enumerate(paths):
        out[i] = resize_bicubic(decode_file(p), resolution)
    return out
