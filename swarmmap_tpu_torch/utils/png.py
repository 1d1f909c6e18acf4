"""PNG reading and writing on zlib, for the dataset loaders.

The JAX package reads every dataset image with `cv2.imread`; the port reads
them here, with no cv2, and gives the same arrays:

- `imread_gray(path)` is `cv2.imread(path, cv2.IMREAD_GRAYSCALE)` for 8-bit
  gray (EuRoC cam0, KITTI image_0/1), 8-bit RGB and 8-bit RGBA (TUM rgb/).
  Colour goes to gray as cv2's libpng build does it
  (`png_set_rgb_to_gray(png, 1, 0.299, 0.587)`): the coefficients truncated
  to 15 bits, 9797 R + 19234 G + 3737 B, and the sum shifted right by 15;
  alpha is dropped, not composited.
- `imread_unchanged(path)` is `cv2.imread(path, cv2.IMREAD_UNCHANGED)` for
  8-bit and 16-bit gray (TUM depth/, big-endian on disk).
- `imwrite(path, image)` writes 8-bit or 16-bit gray.

Non-interlaced images only, with any of the five scanline filters and any
number of IDAT chunks.  Another layout (interlaced, palette, gray with
alpha, bit depths below 8, 16-bit colour) raises ValueError naming the
file.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel
_GRAY_COEFFS = (9797, 19234, 3737)  # R, G, B in 1/32768


def _read(path) -> tuple[np.ndarray, int, int]:
    """Decode to the unfiltered samples [H, W, C] (uint8, or uint16 for
    16-bit), with the colour type and the bit depth."""
    path = str(path)
    try:
        data = Path(path).read_bytes()
    except FileNotFoundError:
        raise FileNotFoundError(path) from None
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(_SIGNATURE), None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n] or b"\0\0\0\0")
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: truncated or corrupt {kind!r} chunk")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, ctype, _, _, interlace = header
    if interlace or ctype not in _CHANNELS or depth not in (8, 16) or depth == 16 and ctype:
        raise ValueError(f"{path}: unsupported PNG layout (colour type {ctype}, "
                         f"bit depth {depth}, interlace {interlace})")
    bpp = _CHANNELS[ctype] * depth // 8  # bytes per pixel
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: image data has {raw.size} bytes, expected {h * (1 + w * bpp)}")
    raw = raw.reshape(h, 1 + w * bpp)
    filters = raw[:, 0]
    if filters.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown scanline filter {int(filters.max())}")
    px = _unfilter(raw[:, 1:].reshape(h, w, bpp), filters)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    return px.reshape(h, w, _CHANNELS[ctype]), ctype, depth


def _unfilter(x: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Undo the scanline filters of [H, W, bpp] bytes (PNG spec 9.2).
    Rows filtered by None, Sub or Up go row by row; Average and Paeth,
    which read the pixel to the left as it is decoded, go over the image's
    anti-diagonals, each of which depends only on the two before it."""
    h, w, bpp = x.shape
    if filters.max(initial=0) <= 2:
        out = np.empty_like(x)
        prev = np.zeros((w, bpp), np.uint8)
        for r in range(h):
            row, f = x[r], filters[r]
            if f == 1:
                row = (np.cumsum(row, axis=0, dtype=np.uint64) & 0xFF).astype(np.uint8)
            elif f == 2:
                row = row + prev
            out[r] = prev = row
        return out
    # out is padded by a zero row above and a zero column to the left
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    x = x.astype(np.int32)
    f = filters.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        c = d - r
        a, b, cc = out[r + 1, c], out[r, c + 1], out[r, c]
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        fr = f[r][:, None]
        pred = np.where(fr == 1, a, np.where(fr == 2, b, np.where(
            fr == 3, (a + b) >> 1, np.where(fr == 4, paeth, 0))))
        out[r + 1, c + 1] = (x[r, c] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def imread_gray(path) -> np.ndarray:
    """[H, W] uint8, as cv2.imread(path, cv2.IMREAD_GRAYSCALE) gives it."""
    px, ctype, depth = _read(path)
    if depth != 8:
        raise ValueError(f"{path}: a {depth}-bit image is not read as 8-bit gray")
    if ctype == 0:
        return px[..., 0]
    rgb = px[..., :3].astype(np.uint32)
    r, g, b = _GRAY_COEFFS
    return ((r * rgb[..., 0] + g * rgb[..., 1] + b * rgb[..., 2]) >> 15).astype(np.uint8)


def imread_unchanged(path) -> np.ndarray:
    """[H, W] uint8 or uint16 of a gray image, as
    cv2.imread(path, cv2.IMREAD_UNCHANGED) gives it."""
    px, ctype, _ = _read(path)
    if ctype != 0:
        raise ValueError(f"{path}: only gray images are read unchanged")
    return px[..., 0]


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def imwrite(path, image: np.ndarray) -> None:
    """Write a [H, W] uint8 or uint16 gray image (each row Up-filtered)."""
    img = np.asarray(image)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"{path}: only [H, W] uint8 or uint16 images are written, "
                         f"got {img.dtype} {img.shape}")
    h, w = img.shape
    rows = img.astype(">u2").view(np.uint8).reshape(h, -1) if img.dtype == np.uint16 else img
    up = rows.copy()
    up[1:] -= rows[:-1]  # uint8 arithmetic wraps, as the filter does
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    header = struct.pack(">IIBBBBB", w, h, img.itemsize * 8, 0, 0, 0, 0)
    Path(path).write_bytes(_SIGNATURE + _chunk(b"IHDR", header)
                           + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                           + _chunk(b"IEND", b""))
