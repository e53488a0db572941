"""PNG with the standard library and numpy (no imaging package).

``encode_rgb8`` writes 8-bit RGB with filter type 0 (what the renderer
saves); ``decode`` reads non-interlaced 8-bit PNGs of every colour type
(grey, RGB, palette, grey + alpha, RGBA) and undoes all five row filters
(None, Sub, Up, Average, Paeth; PNG specification §9). Other PNGs
(16-bit, sub-byte depths, Adam7 interlacing) raise :class:`PngError`.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: Samples per pixel of each 8-bit colour type.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class PngError(ValueError):
    """A PNG this decoder does not read, or a malformed one."""


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_rgb8(img: np.ndarray) -> bytes:
    """PNG bytes of an (H, W, 3) uint8 image: filter type 0 on every row."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise PngError("truncated PNG chunk")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise PngError("PNG without IEND")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, kinds: np.ndarray) -> np.ndarray:
    """Undo the row filters. raw: (H, W, C) filtered bytes; kinds: (H,).

    A pixel depends on its left, upper and upper-left neighbours, so the
    pixels of one anti-diagonal (y + x = s) are independent: one vectorised
    step per anti-diagonal, every filter's prediction computed and the
    row's own selected."""
    if kinds.size and int(kinds.max()) > 4:
        raise PngError(f"unknown PNG filter type {int(kinds.max())}")
    h, w, c = raw.shape
    out = np.zeros((h + 1, w + 1, c), np.int32)  # row -1 and column -1: 0
    raw = raw.astype(np.int32)
    for s in range(h + w - 1):
        ys = np.arange(max(0, s - w + 1), min(h, s + 1))
        xs = s - ys
        a = out[ys + 1, xs]
        b = out[ys, xs + 1]
        cc = out[ys, xs]
        k = kinds[ys][:, None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, cc)], 0)
        out[ys + 1, xs + 1] = (raw[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """(H, W, C) uint8 pixels of a PNG: C = 1 grey, 2 grey + alpha, 3 RGB
    (palette images are expanded), 4 RGBA."""
    if not data.startswith(SIGNATURE):
        raise PngError("not a PNG")
    header = None
    palette = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PngError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise PngError(f"PNG with bit depth {depth}, colour type {ctype}, "
                       f"interlace {interlace}: only non-interlaced 8-bit "
                       "PNGs are decoded")
    c = _CHANNELS[ctype]
    flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if flat.size != h * (1 + w * c):
        raise PngError("PNG image data has the wrong size")
    rows = flat.reshape(h, 1 + w * c)
    pixels = _unfilter(rows[:, 1:].reshape(h, w, c), rows[:, 0])
    if ctype == 3:
        if palette is None:
            raise PngError("palette PNG without PLTE")
        pixels = palette[pixels[..., 0]]
    return pixels
