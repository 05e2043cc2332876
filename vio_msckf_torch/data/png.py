"""A small PNG codec for 8-bit grayscale images, in numpy and zlib.

The host-side decoder the EuRoC reader falls back to where the native
loader (runtime/euroc_loader.cc, libpng) cannot be built, and the encoder
the synthetic EuRoC writer uses. It reads 8-bit grayscale, non-interlaced
PNGs (what EuRoC ships) with any of the five row filters of the PNG
specification, and raises on anything else. It writes filter None, Sub
or Up per row, whichever leaves the smallest residual.

An image whose rows use only None, Sub and Up (what the encoder here
writes) is unfiltered in a few whole-image numpy operations: Sub is a
running sum along each row, Up a running sum down each column from the
last row that is not Up, all modulo 256. Average and Paeth depend on the
pixel just decoded, so an image with such rows (what libpng's adaptive
filter mostly writes) is undone row by row, those rows pixel by pixel in
Python: about 0.2 s for a 752x480 frame, holding the interpreter lock.
"""

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunks(data):
    """(type, payload) of every chunk up to IEND, CRCs checked."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before IEND")


def _unfilter_none_sub_up(kinds, x):
    """Undo filters None (0), Sub (1) and Up (2) on the whole image at once.

    A None or Sub row decodes on its own; an Up row adds the decoded row
    above. So with d = the decoded None/Sub rows and the raw Up rows, row
    r is the sum of d over its segment (from the last non-Up row down to
    r): a running sum down the columns, minus its value just above the
    segment, all in uint8 arithmetic (modulo 256)."""
    d = x.copy()
    sub = kinds == 1
    d[sub] = np.cumsum(x[sub], axis=1, dtype=np.uint8)
    c = np.cumsum(d, axis=0, dtype=np.uint8)
    r = np.arange(len(kinds))
    start = np.maximum.accumulate(np.where(kinds != 2, r, 0))    # segment's first row
    above = np.where(start[:, None] > 0, c[np.maximum(start - 1, 0)], 0).astype(np.uint8)
    return c - above


def _unfilter_average(x, up):
    out, a = [], 0
    for xi, b in zip(x, up):
        a = (xi + ((a + b) >> 1)) & 255
        out.append(a)
    return out


def _unfilter_paeth(x, up):
    out, a, c = [], 0, 0
    for xi, b in zip(x, up):
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        a = (xi + pred) & 255
        c = b
        out.append(a)
    return out


def decode_png_gray(data):
    """PNG bytes (or a path) -> (H, W) uint8."""
    if isinstance(data, (str, os.PathLike)):
        with open(data, "rb") as f:
            data = f.read()
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG file has no IHDR")
    W, H, depth, color, _, _, interlace = header
    if depth != 8 or color != 0 or interlace != 0:
        raise ValueError(f"only 8-bit grayscale non-interlaced PNGs are read here "
                         f"(bit depth {depth}, color type {color}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (W + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected {H * (W + 1)}")
    rows = raw.reshape(H, W + 1)
    kinds, x = rows[:, 0], rows[:, 1:]
    if kinds.max(initial=0) <= 2:
        return _unfilter_none_sub_up(kinds, x)
    out = np.empty((H, W), np.uint8)
    up = np.zeros(W, np.uint8)
    for r in range(H):
        kind = kinds[r]
        if kind == 0:
            out[r] = x[r]
        elif kind == 1:
            out[r] = np.cumsum(x[r], dtype=np.uint8)
        elif kind == 2:
            out[r] = x[r] + up
        elif kind == 3:
            out[r] = _unfilter_average(x[r].tolist(), up.tolist())
        elif kind == 4:
            out[r] = _unfilter_paeth(x[r].tolist(), up.tolist())
        else:
            raise ValueError(f"PNG row {r}: unknown filter type {kind}")
        up = out[r]
    return out


def _chunk(kind, payload):
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png_gray(img, level=6):
    """(H, W) uint8 -> PNG bytes. Each row takes the filter (None, Sub or
    Up) whose residual has the smallest sum of magnitudes."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"expected an (H, W) uint8 image, got {img.dtype} {img.shape}")
    H, W = img.shape
    none = img
    sub = np.diff(img, axis=1, prepend=np.zeros((H, 1), np.uint8))
    up = np.diff(img, axis=0, prepend=np.zeros((1, W), np.uint8))
    cands = np.stack([none, sub, up])                       # uint8, wrapped
    cost = np.minimum(cands, 256 - cands.astype(np.int32)).sum(axis=2)
    kinds = np.argmin(cost, axis=0).astype(np.uint8)        # (H,) 0 / 1 / 2
    rows = np.concatenate([kinds[:, None], cands[kinds, np.arange(H)]], axis=1)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png_gray(path, img):
    with open(path, "wb") as f:
        f.write(encode_png_gray(img))
