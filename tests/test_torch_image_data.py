"""The port's image-slider reader (`data/native_loader.py`) and paired
folders (`data/paired_images.py`) against the JAX package's on the CPU.

PNGs are written two ways: by PIL (every mode it writes, with and without
its adaptive filters), and by `png_bytes` below, which covers what PIL does
not write: every colour type at every bit depth (16-bit too), each of the
five row filters in turn, Adam7 interlacing, palette + tRNS, and image data
split over two IDAT chunks. The port's decode must give exactly the pixels
encoded (8-bit RGB as the JAX loader's libpng transforms make them), and its
load_batch must agree with the JAX native library (libpng, libjpeg and the
same resize arithmetic, up to the order of f32 sums) within 1e-5, and with
the JAX package's PIL path within 2/255 (PIL's fixed-point coefficients).
"""

import logging
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from sliders_tpu.data import native_loader as jnl
from sliders_tpu.data import paired_images as jpi
from sliders_tpu_torch.data import native_loader as nl
from sliders_tpu_torch.data import paired_images as tpi

NATIVE_TOL = 1e-5
PIL_TOL = 2.0 / 255.0
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX native library must build here (g++, libpng, libjpeg): it is
    the reference these tests hold the port to."""
    assert jnl.available()


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _pack_row(row, depth: int) -> bytes:
    if depth == 16:
        return b"".join(struct.pack(">H", int(v)) for v in row)
    if depth == 8:
        return bytes(int(v) for v in row)
    bits = "".join(format(int(v), f"0{depth}b") for v in row)
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_rows(rows: list, bpp: int, first_filter: int) -> bytes:
    """Row i takes filter (first_filter + i) % 5, so every filter appears."""
    out, prior = [], bytes(len(rows[0]))
    for i, row in enumerate(rows):
        f = (first_filter + i) % 5
        enc = bytearray([f])
        for x, v in enumerate(row):
            a = row[x - bpp] if x >= bpp else 0
            b = prior[x]
            c = prior[x - bpp] if x >= bpp else 0
            enc.append((v - (0, a, b, (a + b) // 2, _paeth(a, b, c))[f]) % 256)
        out.append(bytes(enc))
        prior = row
    return b"".join(out)


def png_bytes(samples: np.ndarray, ctype: int, depth: int, palette=None, trns=None,
              interlace=False, first_filter=0) -> bytes:
    """(H, W, channels) integer samples -> PNG bytes (stdlib only)."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    raw = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter_rows([_pack_row(r.reshape(-1), depth) for r in sub], bpp,
                                first_filter)
    comp = zlib.compress(raw, 9)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                            0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    half = len(comp) // 2
    return out + _chunk(b"IDAT", comp[:half]) + _chunk(b"IDAT", comp[half:]) + _chunk(b"IEND", b"")


def expected_rgb(samples: np.ndarray, ctype: int, depth: int, palette=None) -> np.ndarray:
    """What libpng's transforms of the JAX loader make of the samples."""
    s = samples.astype(np.int64)
    if depth == 16:
        s = s >> 8
    elif depth < 8 and ctype == 0:
        s = s * (255 // ((1 << depth) - 1))
    if ctype == 3:
        return np.asarray(palette, np.uint8)[s[..., 0]]
    if ctype in (0, 4):
        return np.repeat(s[..., :1], 3, axis=2).astype(np.uint8)
    return s[..., :3].astype(np.uint8)


CASES = [(c, d, i) for c, ds in DEPTHS.items() for d in ds for i in (False, True)]


@pytest.mark.parametrize("ctype,depth,interlace", CASES)
def test_png_every_type_depth_filter_and_interlace(tmp_path, ctype, depth, interlace):
    """Decode exactly; resized to 9 px (down) and 24 px (up) within 1e-5 of
    the JAX native library."""
    rng = np.random.default_rng(ctype * 100 + depth)
    top = min((1 << depth) - 1, 5) if ctype == 3 else (1 << depth) - 1
    samples = rng.integers(0, top + 1, (13, 11, CHANNELS[ctype]))
    palette = rng.integers(0, 256, (6, 3)) if ctype == 3 else None
    trns = {0: b"\x00\x01", 2: b"\x00\x01\x00\x02\x00\x03", 3: b"\x00\x80"}.get(ctype)
    data = png_bytes(samples, ctype, depth, palette, trns, interlace, first_filter=depth % 5)
    np.testing.assert_array_equal(nl.decode_png(data), expected_rgb(samples, ctype, depth, palette))
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(data)
    for res in (9, 24):
        out = nl.load_batch([path], res)
        assert out.shape == (1, res, res, 3) and out.dtype == np.float32
        np.testing.assert_allclose(out, jnl.load_batch([path], res), rtol=0, atol=NATIVE_TOL)


@pytest.mark.parametrize("dx,dy", [(1, -2), (-2, 1)])
@pytest.mark.parametrize("interlace", [False, True])
def test_png_paeth_ties(tmp_path, dx, dy, interlace):
    """Ramps on which Paeth's estimates tie past the first row and column:
    with left a, up b, upper left c, (dx, dy) = (1, -2) makes |b - c| ==
    |a + b - 2c| < |a - c| (the tie goes to a), (-2, 1) makes |a - c| ==
    |a + b - 2c| < |b - c| (the tie goes to b), as libpng breaks them."""
    yy, xx = np.mgrid[0:13, 0:11]
    samples = np.repeat((128 + dx * xx + dy * yy)[..., None], 3, axis=2)
    data = png_bytes(samples, 2, 8, interlace=interlace, first_filter=4)
    np.testing.assert_array_equal(nl.decode_png(data), samples.astype(np.uint8))
    path = str(tmp_path / "ramp.png")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_allclose(nl.load_batch([path], 7), jnl.load_batch([path], 7), rtol=0,
                               atol=NATIVE_TOL)


def _pil_images(rng):
    """Smooth gradients with a little noise, in every mode PIL writes."""
    yy, xx = np.mgrid[0:37, 0:53]
    smooth = np.stack([xx * 4, 20 + yy * 5, (xx + yy) * 2], -1)
    noisy = (smooth + rng.integers(0, 9, smooth.shape)).clip(0, 255).astype(np.uint8)
    pal = Image.fromarray(noisy).convert("P", palette=Image.ADAPTIVE, colors=7)
    pal_t = pal.copy()
    pal_t.info["transparency"] = 2
    return {"RGB": Image.fromarray(noisy), "L": Image.fromarray(noisy[..., 0]),
            "LA": Image.fromarray(noisy[..., :2].copy()).convert("LA"),
            "RGBA": Image.fromarray(np.concatenate([noisy, noisy[..., :1]], -1)),
            "P": pal, "P_tRNS": pal_t, "1": Image.fromarray(noisy[..., 0]).convert("1")}


@pytest.mark.parametrize("optimize", [False, True])
def test_pil_written_pngs(tmp_path, optimize):
    """PNGs PIL writes (with its adaptive filters under optimize): decoded as
    PIL's convert('RGB') decodes them, loaded within 1e-5 of the JAX native
    library and within 2/255 of the JAX package's PIL path. PIL rounds and
    clips to 8 bits between its two passes, so the last check holds where no
    edge overshoots [0, 255] between them: not for the bilevel mode '1'."""
    for name, img in _pil_images(np.random.default_rng(0)).items():
        path = str(tmp_path / f"{name}.png")
        img.save(path, optimize=optimize)
        with Image.open(path) as back:
            np.testing.assert_array_equal(nl.decode_file(path), np.asarray(back.convert("RGB")),
                                          err_msg=name)
            pil = jpi.preprocess_image(back, 32)
        out = nl.load_batch([path], 32)[0]
        np.testing.assert_allclose(out, jnl.load_batch([path], 32)[0], rtol=0, atol=NATIVE_TOL,
                                   err_msg=name)
        if name != "1":
            np.testing.assert_allclose(out, pil, rtol=0, atol=PIL_TOL, err_msg=name)


def test_sixteen_bit_gray_written_by_pil(tmp_path):
    """PIL's I;16 PNG: the high byte of each sample, as libpng's strip_16."""
    v = np.random.default_rng(1).integers(0, 65536, (10, 14), dtype=np.uint16)
    path = str(tmp_path / "g16.png")
    Image.fromarray(v).save(path)
    np.testing.assert_array_equal(nl.decode_file(path), np.repeat((v >> 8)[..., None], 3, 2))
    np.testing.assert_allclose(nl.load_batch([path], 8), jnl.load_batch([path], 8), rtol=0,
                               atol=NATIVE_TOL)


def _good_png() -> bytes:
    return png_bytes(np.random.default_rng(2).integers(0, 256, (6, 5, 3)), 2, 8)


def _bad_files(tmp_path):
    good = _good_png()
    ihdr_end = 8 + 8 + 13 + 4
    idat = good.index(b"IDAT")
    crc = bytearray(good)
    crc[idat + 6] ^= 0x55  # a byte of the first IDAT's payload: its CRC fails
    bad_filter = png_bytes(np.zeros((2, 2, 3), np.int64), 2, 8)
    raw = zlib.decompress(b"".join(payload for tag, payload in nl._chunks(bad_filter)
                                   if tag == b"IDAT"))
    bad_filter = (bad_filter[:ihdr_end] + _chunk(b"IDAT", zlib.compress(b"\x07" + raw[1:]))
                  + _chunk(b"IEND", b""))
    files = {"truncated_header.png": good[:20], "truncated_data.png": good[:idat + 12],
             "no_iend.png": good[:-12], "bad_crc.png": bytes(crc),
             "bad_filter.png": bad_filter, "not_an_image.png": b"hello, world",
             "empty.png": b""}
    for name, data in files.items():
        with open(tmp_path / name, "wb") as f:
            f.write(data)
    return sorted(files)


def test_bad_files_raise(tmp_path):
    """A truncated PNG, a CRC mismatch, an unknown filter, a non-image and
    an empty file raise ValueError naming the file; so does the JAX native
    library on each. A missing file raises FileNotFoundError in both."""
    for name in _bad_files(tmp_path):
        path = str(tmp_path / name)
        with pytest.raises(ValueError, match=name):
            nl.load_batch([path], 8)
        with pytest.raises(ValueError):
            jnl.load_batch([path], 8)
    missing = str(tmp_path / "missing.png")
    with pytest.raises(FileNotFoundError):
        nl.load_batch([missing], 8)
    with pytest.raises(FileNotFoundError):
        jnl.load_batch([missing], 8)


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_jpeg_matches_jax_native(tmp_path, mode):
    """A JPEG PIL writes, through the port's copy of the C++ decoder (built
    with g++ into sliders_tpu_torch/_build/): within 1e-5 of the JAX native
    library, at a downscale and an upscale. Skips, with the builder's
    message, only where the decoder cannot be built (no g++ or no
    libjpeg)."""
    try:
        nl._jpeg_library()
    except nl.JpegUnavailable as e:
        pytest.skip(str(e))
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (45, 61, 3), dtype=np.uint8)
    path = str(tmp_path / "x.jpg")
    Image.fromarray(img).convert(mode).save(path, quality=90)
    assert nl.jpeg_library_path().parent == nl.BUILD_DIR
    with Image.open(path) as back:
        np.testing.assert_array_equal(nl.decode_file(path), np.asarray(back.convert("RGB")))
    for res in (16, 64):
        np.testing.assert_allclose(nl.load_batch([path], res), jnl.load_batch([path], res),
                                   rtol=0, atol=NATIVE_TOL)


def _jpeg_folders(tmp_path):
    for folder in ("low", "high"):
        os.makedirs(tmp_path / folder)
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / folder / "a.jpg")
    return tpi.PairedImageFolders(str(tmp_path), ["low", "high"], [-1.0, 1.0])


def test_jpeg_without_gxx_stops_the_run(tmp_path, monkeypatch):
    """With no g++, a JPEG raises JpegUnavailable naming g++, and the paired
    folders pass it on: a missing toolchain is not a folder of bad files."""
    monkeypatch.setattr(nl, "_jpeg_lib", None)
    monkeypatch.setattr(nl, "jpeg_library_path", lambda: tmp_path / "none" / "lib.so")
    monkeypatch.setattr(nl.shutil, "which", lambda name: None)
    ds = _jpeg_folders(tmp_path)
    with pytest.raises(nl.JpegUnavailable, match="g\\+\\+"):
        ds.sample_pair(np.random.default_rng(0), 8)
    assert not ds._bad_files


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_jpeg_without_libjpeg_names_it(tmp_path, monkeypatch):
    """Where the decoder does not build against libjpeg (here: a source
    whose jpeglib.h is missing), a JPEG raises JpegUnavailable naming
    libjpeg, with the compiler's message."""
    src = tmp_path / "imgloader.cpp"
    src.write_text(nl.JPEG_SOURCE.read_text().replace("<jpeglib.h>", "<no_such_jpeglib.h>"))
    monkeypatch.setattr(nl, "_jpeg_lib", None)
    monkeypatch.setattr(nl, "JPEG_SOURCE", src)
    monkeypatch.setattr(nl, "BUILD_DIR", tmp_path / "build")
    ds = _jpeg_folders(tmp_path)
    with pytest.raises(nl.JpegUnavailable, match="libjpeg") as info:
        ds.sample_pair(np.random.default_rng(0), 8)
    assert "no_such_jpeglib.h" in str(info.value)


def test_jpeg_library_that_does_not_load_names_libjpeg(tmp_path, monkeypatch):
    """A built decoder that cannot be loaded (here: a cached file that is no
    shared library, as one whose libjpeg.so is gone fails) raises
    JpegUnavailable naming libjpeg, and the paired folders pass it on
    instead of skipping every JPEG as a bad file."""
    broken = tmp_path / "build" / "libimgloader_broken.so"
    broken.parent.mkdir()
    broken.write_bytes(b"not a shared library")
    monkeypatch.setattr(nl, "_jpeg_lib", None)
    monkeypatch.setattr(nl, "jpeg_library_path", lambda: broken)
    ds = _jpeg_folders(tmp_path)
    with pytest.raises(nl.JpegUnavailable, match="libjpeg") as info:
        ds.sample_pair(np.random.default_rng(0), 8)
    assert broken.name in str(info.value)
    assert not ds._bad_files


def _write_pairs(root, bad=()):
    """Scales +-1 and +-2, three files each, every file a distinct flat
    grey; names in `bad` are truncated in the +s folders."""
    value = 10
    for folder in ("vlow", "low", "high", "vhigh"):
        os.makedirs(root / folder)
        for name in ("a.png", "b.png", "c.png", *bad):
            img = Image.fromarray(np.full((12, 10, 3), value, np.uint8))
            img.save(root / folder / name)
            value += 7
            if name in bad and folder in ("high", "vhigh"):
                data = (root / folder / name).read_bytes()
                (root / folder / name).write_bytes(data[:len(data) // 2])
        (root / folder / "notes.txt").write_text("not an image")
    return ["vlow", "low", "high", "vhigh"], [-2.0, -1.0, 1.0, 2.0]


def _draws(ds, n, seed=0):
    """n draws of sample_pair, each as (scale, filename, low, high)."""
    names = []
    inner = ds._load_pair

    def record(s, name, res):
        names.append(name)
        return inner(s, name, res)

    ds._load_pair = record
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s, lo, hi = ds.sample_pair(rng, 8)
        out.append((s, names[-1], lo, hi))
    return out


@pytest.mark.parametrize("bad", [(), ("d.png",)])
def test_paired_folders_draw_like_jax(tmp_path, bad, caplog):
    """One seed draws the same (scale, filename) sequence as the JAX class,
    with the same images (within 1e-5), also when a truncated file must be
    skipped: the skip warns, excludes the file for the run, and draws again
    from the same generator."""
    folders, scales = _write_pairs(tmp_path, bad)
    assert tpi.parse_folder_args("vlow, low, high, vhigh", "-2, -1, 1, 2") == (folders, scales)
    ours = tpi.PairedImageFolders(str(tmp_path), folders, scales)
    ref = jpi.PairedImageFolders(str(tmp_path), folders, scales)
    assert ours.scales_unique == ref.scales_unique == [1.0, 2.0]
    assert ours.filenames(-1.0) == ref.filenames(-1.0) == sorted(["a.png", "b.png", "c.png", *bad])
    with caplog.at_level(logging.WARNING):
        got, want = _draws(ours, 24), _draws(ref, 24)
    assert [(s, n) for s, n, _, _ in got] == [(s, n) for s, n, _, _ in want]
    assert {s for s, _, _, _ in got} == {1.0, 2.0}
    for (_, _, lo, hi), (_, _, jlo, jhi) in zip(got, want):
        np.testing.assert_allclose(lo, jlo, rtol=0, atol=NATIVE_TOL)
        np.testing.assert_allclose(hi, jhi, rtol=0, atol=NATIVE_TOL)
    assert ours._bad_files == ref._bad_files == {(s, n) for n in bad for s in (1.0, 2.0)}
    if bad:
        warnings = [r.getMessage() for r in caplog.records
                    if r.name == "sliders_tpu_torch.data.paired_images"]
        assert warnings and all("d.png" in w for w in warnings)


def test_paired_folders_refuse(tmp_path):
    """A scale with only bad files raises RuntimeError; misaligned folders
    and scales, or a scale without its negative, raise ValueError."""
    for folder in ("low", "high"):
        os.makedirs(tmp_path / folder)
        (tmp_path / folder / "x.png").write_bytes(b"\x89PNG\r\n\x1a\n garbage")
    ds = tpi.PairedImageFolders(str(tmp_path), ["low", "high"], [-1.0, 1.0])
    with pytest.raises(RuntimeError, match="no decodable image pairs"):
        ds.sample_pair(np.random.default_rng(0), 8)
    with pytest.raises(ValueError):
        tpi.PairedImageFolders(str(tmp_path), ["low"], [1.0])
    with pytest.raises(ValueError):
        tpi.PairedImageFolders(str(tmp_path), ["low", "high"], [1.0])
    with pytest.raises(ValueError):
        tpi.parse_folder_args("a,b", "1")
