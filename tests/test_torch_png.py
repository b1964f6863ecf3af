"""The port's PNG reader (utils/images.py::read_png) against
cv2.imread(path, cv2.IMREAD_UNCHANGED): files cv2 writes at 8 and 16 bits
in greyscale, BGR and BGRA, on smooth and on noisy images (libpng picks
each row's filter from the data); files built here with each of the five
row filters on every row and with the filters mixed row by row (with and
without Average and Paeth, which the reader undoes by different paths);
and the port's own 16-bit files (utils/images.py::write_png16, Sub on
every row, and encode_png16 with each filter in turn) read back by cv2.
Every case must be equal bit for bit, dtype and shape included. Palette,
interlaced, grey-with-alpha and other-depth files raise naming the
feature."""

import struct
import zlib

import numpy as np
import pytest
import torch

import cv2

from multimodalstudio_tpu_torch.utils.images import (
    PNG_SIGNATURE,
    _chunk,
    decode_png,
    encode_png16,
    read_png,
    write_png16,
)

torch.set_num_threads(1)


def image(kind, dtype, channels, h=29, w=41, seed=0):
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max
    if kind == "noise":
        img = rng.integers(0, top + 1, size=(h, w, channels))
    else:
        y, x = np.mgrid[0:h, 0:w]
        img = np.stack([(0.5 + 0.5 * np.sin(x / (5 + c) + y / 7.0)) * top
                        for c in range(channels)], -1)
    img = img.astype(dtype)
    return img[..., 0] if channels == 1 else img


@pytest.mark.parametrize("kind", ["smooth", "noise"])
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_reads_what_cv2_writes_bit_for_bit(tmp_path, kind, channels, dtype):
    path = str(tmp_path / "f.png")
    assert cv2.imwrite(path, image(kind, dtype, channels))
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    got = read_png(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)


def _filter_row(kind, raw, prev, bpp):
    """PNG's filter `kind` of one row of raw bytes (PNG spec 9.2), int arithmetic."""
    raw, prev = raw.astype(np.int32), prev.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), raw[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(raw)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prev
    elif kind == 3:
        pred = (left + prev) // 2
    else:
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
    return ((raw - pred) % 256).astype(np.uint8)


def encode_with_filters(img, depth, color, filters):
    """PNG bytes of img (RGB(A) channel order) with row i filtered by filters[i]."""
    h, w = img.shape[:2]
    samples = img.astype(">u2") if depth == 16 else img
    rows = np.ascontiguousarray(samples).reshape(h, -1).view(np.uint8)
    bpp = rows.shape[1] // w
    out, prev = [], np.zeros(rows.shape[1], np.uint8)
    for i in range(h):
        out.append(bytes([filters[i]]) + _filter_row(filters[i], rows[i], prev, bpp).tobytes())
        prev = rows[i]
    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(b"".join(out))) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", ["0", "1", "2", "3", "4", "mixed", "mixed 0-2"])
@pytest.mark.parametrize("depth,channels", [(8, 1), (16, 3), (8, 4), (16, 4)])
def test_every_row_filter_against_cv2(tmp_path, filters, depth, channels):
    dtype = np.uint16 if depth == 16 else np.uint8
    img = image("noise", dtype, channels, h=23, w=19, seed=depth + channels)
    h = img.shape[0]
    if filters.startswith("mixed"):
        top = 3 if filters == "mixed 0-2" else 5  # without Average and Paeth: the row path
        rows = np.random.default_rng(1).integers(0, top, size=h).tolist()
    else:
        rows = [int(filters)] * h
    color = {1: 0, 3: 2, 4: 6}[channels]
    blob = encode_with_filters(img, depth, color, rows)
    path = tmp_path / "f.png"
    path.write_bytes(blob)
    ref = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    got = decode_png(blob)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)
    # the file holds RGB(A); both return cv2's BGR(A)
    want = img if channels == 1 else img[..., [2, 1, 0, 3][:channels]]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("row_filters", ["sub", "each"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_port_written_png16_read_back_by_cv2(tmp_path, channels, row_filters):
    """The writer's default (Sub on every row) and each filter in turn."""
    img = image("smooth", np.uint16, channels, seed=channels)
    path = str(tmp_path / "p.png")
    if row_filters == "sub":
        write_png16(path, img)
    else:
        (tmp_path / "p.png").write_bytes(encode_png16(img, np.arange(img.shape[0]) % 5))
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    # write_png16 takes RGB(A), cv2 returns BGR(A)
    want = img if channels == 1 else img[..., [2, 1, 0, 3][:channels]]
    assert ref.dtype == np.uint16 and np.array_equal(ref, want)
    assert np.array_equal(read_png(path), ref)


def test_unsupported_files_raise_naming_the_feature(tmp_path):
    grey = image("noise", np.uint8, 1, h=6, w=5)
    pal = tmp_path / "pal.png"
    header = struct.pack(">IIBBBBB", 5, 6, 8, 3, 0, 0, 0)
    raw = b"".join(b"\x00" + bytes(row) for row in grey % 4)
    pal.write_bytes(PNG_SIGNATURE + _chunk(b"IHDR", header)
                    + _chunk(b"PLTE", bytes(range(12))) + _chunk(b"IDAT", zlib.compress(raw))
                    + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="palette"):
        read_png(str(pal))
    inter = tmp_path / "adam7.png"
    assert cv2.imwrite(str(tmp_path / "plain.png"), grey)
    blob = (tmp_path / "plain.png").read_bytes()
    ihdr = blob[8:8 + 25]
    fields = list(struct.unpack(">IIBBBBB", ihdr[8:21]))
    fields[-1] = 1
    body = struct.pack(">IIBBBBB", *fields)
    inter.write_bytes(PNG_SIGNATURE + _chunk(b"IHDR", body) + blob[8 + 25:])
    with pytest.raises(ValueError, match="interlaced"):
        read_png(str(inter))
    for depth, color, word in ((4, 0, "bit depth 4"), (8, 4, "grey with alpha")):
        header = struct.pack(">IIBBBBB", 5, 6, depth, color, 0, 0, 0)
        with pytest.raises(ValueError, match=word):
            decode_png(PNG_SIGNATURE + _chunk(b"IHDR", header)
                       + _chunk(b"IDAT", zlib.compress(b"\x00" * 60)) + _chunk(b"IEND", b""))
