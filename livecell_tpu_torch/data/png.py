"""PNG encoder for grayscale tiles and RGB panels and a PNG decoder
(counterpart of livecell_tpu/data/png.py, which has the grey encoder
only).

The encoder writes filter-type-0 scanlines compressed with zlib at a
caller-chosen level: an 8-bit grayscale PNG, byte for byte the JAX
package's, or an 8-bit RGB one. The decoder reads the tiles back
without PIL (the data path runs where PIL is not installed): 8-bit
grey, RGB, palette, grey+alpha and RGBA images, non-interlaced, with
every scanline filter (0-4), into uint8 [H, W, 3] as PIL's
`Image.open(p).convert("RGB")` gives them: grey is widened to three
equal channels, a palette is looked up, alpha is dropped. Interlaced
files, bit depths other than 8 and unknown colour types raise
UnsupportedImage; a file that does not decode raises ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
# Samples per pixel of each 8-bit colour type.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class UnsupportedImage(ValueError):
    """A well-formed image file in a form the port's readers do not read
    (data/png.py, data/tiff.py): unlike a corrupt file, it is not skipped
    by the tiler."""


def _chunk(typ: bytes, data: bytes) -> bytes:
    c = typ + data
    return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))


def _encode(arr: np.ndarray, color_type: int, compress_level: int) -> bytes:
    h, w = arr.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    rows = np.zeros((h, arr[0].size + 1), np.uint8)   # leading 0 = None
    rows[:, 1:] = arr.reshape(h, -1)
    idat = zlib.compress(rows.tobytes(), compress_level)
    return (_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat)
            + _chunk(b"IEND", b""))


def encode_gray_png(arr: np.ndarray, compress_level: int = 1) -> bytes:
    """Encode a [H, W] uint8 array as an 8-bit grayscale PNG."""
    if arr.ndim != 2 or arr.dtype != np.uint8:
        raise ValueError(f"need [H, W] uint8, got {arr.shape} {arr.dtype}")
    return _encode(arr, 0, compress_level)


def encode_rgb_png(arr: np.ndarray, compress_level: int = 1) -> bytes:
    """Encode a [H, W, 3] uint8 array as an 8-bit RGB PNG."""
    if arr.ndim != 3 or arr.shape[2] != 3 or arr.dtype != np.uint8:
        raise ValueError(f"need [H, W, 3] uint8, got {arr.shape} "
                         f"{arr.dtype}")
    return _encode(arr, 2, compress_level)


def write_gray_png(path, arr: np.ndarray, compress_level: int = 1) -> None:
    with open(path, "wb") as f:
        f.write(encode_gray_png(arr, compress_level))


def write_rgb_png(path, arr: np.ndarray, compress_level: int = 1) -> None:
    with open(path, "wb") as f:
        f.write(encode_rgb_png(arr, compress_level))


def _chunks(data: bytes):
    pos = len(_SIG)
    while pos + 8 <= len(data):
        n, typ = struct.unpack(">I4s", data[pos:pos + 8])
        yield typ, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if typ == b"IEND":
            return
    raise ValueError("PNG ends before its IEND chunk")


def _unfilter_row(ftype: int, cur: bytearray, prev: bytes, bpp: int
                  ) -> None:
    """Undo one scanline's filter in place (PNG spec, section 9)."""
    n = len(cur)
    if ftype == 0:
        return
    if ftype == 1:                                       # Sub
        for i in range(bpp, n):
            cur[i] = (cur[i] + cur[i - bpp]) & 0xFF
    elif ftype == 2:                                     # Up
        for i in range(n):
            cur[i] = (cur[i] + prev[i]) & 0xFF
    elif ftype == 3:                                     # Average
        for i in range(n):
            left = cur[i - bpp] if i >= bpp else 0
            cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
    elif ftype == 4:                                     # Paeth
        for i in range(n):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            cur[i] = (cur[i] + pred) & 0xFF
    else:
        raise ValueError(f"PNG scanline filter type {ftype} is not 0-4")


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3] (see the module docstring)."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    ihdr, palette, idat = None, None, []
    for typ, body in _chunks(data):
        if typ == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif typ == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif typ == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise UnsupportedImage("interlaced PNG is not supported")
    if depth != 8:
        raise UnsupportedImage(f"PNG bit depth {depth} is not supported "
                               "(8 only)")
    if ctype not in _CHANNELS:
        raise UnsupportedImage(f"PNG colour type {ctype} is not "
                               "supported")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1)).reshape(
        h, stride + 1)
    filters = rows[:, 0]
    if not filters.any():
        pix = rows[:, 1:]
    else:
        out = bytearray(h * stride)
        prev = bytes(stride)
        for y in range(h):
            cur = bytearray(rows[y, 1:].tobytes())
            _unfilter_row(int(filters[y]), cur, prev, bpp)
            out[y * stride:(y + 1) * stride] = cur
            prev = bytes(cur)
        pix = np.frombuffer(bytes(out), np.uint8).reshape(h, stride)
    pix = pix.reshape(h, w, bpp)
    if ctype == 3:
        return palette[pix[..., 0]]
    if ctype in (0, 4):
        return np.repeat(pix[..., :1], 3, axis=2)
    return np.ascontiguousarray(pix[..., :3])


def read_png(path) -> np.ndarray:
    """The PNG file at `path` as uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        return decode_png(f.read())
