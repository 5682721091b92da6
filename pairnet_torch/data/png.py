"""PNG read and write with zlib and numpy, without PIL.

Reads 8-bit gray, gray + alpha, RGB and RGBA images, non-interlaced, with
any of the five row filters (None, Sub, Up, Average, Paeth), as encoders
such as PIL's adaptive filtering write them. Writes 8-bit gray, RGB or RGBA
with the None filter on every row. Anything else (palettes, 16-bit
samples, interlacing) raises.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_TYPE_OF = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode(img: np.ndarray, level: int = 1) -> bytes:
    """uint8 (H, W) gray or (H, W, C) with C in 1, 2, 3, 4 -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"png.encode: dtype {img.dtype} is not uint8")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in _TYPE_OF:
        raise ValueError(f"png.encode: shape {img.shape} is not (H, W[, 1-4])")
    h, w, c = img.shape
    rows = np.zeros((h, w * c + 1), np.uint8)  # filter byte 0 (None) on every row
    rows[:, 1:] = img.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _TYPE_OF[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def write(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(img))


def _unfilter_avg_paeth(ftype: int, line: bytearray, prev: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4) run left to right: each byte depends on the
    decoded byte ``bpp`` to its left, so they decode byte by byte."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        if ftype == 3:
            line[i] = (line[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError(f"png: {data.size} bytes of image data, expected {h * (stride + 1)}")
    rows = data.reshape(h, stride + 1)
    out = rows[:, 1:].copy()
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        ftype = int(rows[r, 0])
        if ftype == 1:  # Sub: a running sum along the row, mod 256
            out[r] = np.cumsum(out[r].reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            out[r] += prev
        elif ftype in (3, 4):
            line = bytearray(out[r].tobytes())
            _unfilter_avg_paeth(ftype, line, prev.tobytes(), bpp)
            out[r] = np.frombuffer(bytes(line), np.uint8)
        elif ftype != 0:
            raise ValueError(f"png: unknown row filter {ftype}")
        prev = out[r]
    return out


def decode(buf: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W) for gray, (H, W, C) otherwise."""
    if buf[:8] != SIGNATURE:
        raise ValueError("png: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos : pos + 4])
        kind = buf[pos + 4 : pos + 8]
        data = buf[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("png: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in CHANNELS or interlace:
        raise ValueError(f"png: unsupported bit depth {depth}, colour type {ctype} or "
                         f"interlace {interlace} (8-bit gray, gray+alpha, RGB, RGBA only)")
    c = CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, c)
    return px.reshape(h, w) if c == 1 else px.reshape(h, w, c)


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def read_rgb(path: str) -> np.ndarray:
    """uint8 (H, W, 3), as PIL's ``convert("RGB")``: gray replicated, alpha
    dropped."""
    img = read(path)
    if img.ndim == 2:
        return np.repeat(img[:, :, None], 3, axis=2)
    if img.shape[2] == 2:
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])
