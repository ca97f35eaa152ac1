"""Baseline TIFF reader for LIVECell's source frames, without PIL (the
data path runs where PIL is not installed; data/png.py does the same
for the tiles).

`decode_tiff(data)` and `read_tiff(path)` return uint8 [H, W, 3] as
PIL's `Image.open(p).convert("RGB")` gives them. The first image
directory of a file in either byte order (II or MM) is read, stored in
strips (StripOffsets, StripByteCounts and RowsPerStrip, which may be
missing: one strip), with 8 bits a sample and

  * one sample: PhotometricInterpretation 1 (black is zero), or 0
    (white is zero), inverted as PIL inverts it; widened to three equal
    channels;
  * three chunky RGB samples (PhotometricInterpretation 2,
    PlanarConfiguration 1);

compressed with Compression 1 (none), 5 (LZW), 8 or 32946 (Deflate,
through zlib) or 32773 (PackBits), with Predictor 1 (none) or 2
(horizontal differencing). Anything else raises UnsupportedImage (a
ValueError) naming the tag and its value: tiles, other sample sizes,
JPEG, a palette. A file that does not decode (truncated, not a TIFF)
raises ValueError.

The LZW loop runs in the port's C++ library (native/rasterize.cc) where
it builds; `lzw_decode_plain` is its Python version, which serves
without a compiler.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional

import numpy as np

from livecell_tpu_torch import native
from livecell_tpu_torch.data.png import UnsupportedImage

# Tags read (TIFF 6.0, section 8).
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
STRIP_OFFSETS, SAMPLES, ROWS_PER_STRIP, STRIP_BYTES = 273, 277, 278, 279
PLANAR, PREDICTOR, TILE_WIDTH = 284, 317, 322
NONE, LZW, DEFLATE, OLD_DEFLATE, PACKBITS = 1, 5, 8, 32946, 32773
# Byte size of each integer field type: BYTE, SHORT, LONG.
_INT_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4)}
_ALL_ROWS = 2 ** 32 - 1
_CLEAR, _EOI = 256, 257


def _read_ifd(data: bytes) -> Dict[int, List[int]]:
    """{tag: integer values} of the first image directory; fields of
    other types are kept as None (none of them is read)."""
    order = data[:4]
    if order == b"II*\x00":
        bo = "<"
    elif order == b"MM\x00*":
        bo = ">"
    else:
        raise ValueError("not a baseline TIFF file (byte order mark "
                         f"{order!r})")
    (at,) = struct.unpack(bo + "I", data[4:8])
    if at + 2 > len(data):
        raise ValueError("TIFF image directory lies past the end of the "
                         "file")
    (n,) = struct.unpack(bo + "H", data[at:at + 2])
    if at + 2 + 12 * n > len(data):
        raise ValueError("TIFF image directory is truncated")
    tags = {}
    for i in range(n):
        e = at + 2 + 12 * i
        tag, typ, count = struct.unpack(bo + "HHI", data[e:e + 8])
        if typ not in _INT_TYPES:
            tags[tag] = None
            continue
        fmt, size = _INT_TYPES[typ]
        if count * size <= 4:
            raw = data[e + 8:e + 8 + count * size]
        else:
            (off,) = struct.unpack(bo + "I", data[e + 8:e + 12])
            raw = data[off:off + count * size]
            if len(raw) < count * size:
                raise ValueError(f"TIFF tag {tag}'s values lie past the "
                                 "end of the file")
        tags[tag] = list(struct.unpack(f"{bo}{count}{fmt}", raw))
    return tags


def _one(tags: Dict, tag: int, default: Optional[int] = None) -> int:
    v = tags.get(tag)
    if v is None:
        if tag in tags or default is None:
            raise ValueError(f"TIFF tag {tag} is missing or not an integer")
        return default
    return v[0]


def lzw_decode_plain(data: bytes, size: int) -> bytes:
    """TIFF LZW (MSB-first codes of 9-12 bits, the width growing one code
    early) -> at most `size` bytes. Stops at the end-of-information code,
    at the end of the data or at `size` bytes; a code that is not yet
    in the table raises."""
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out = bytearray()
    width, buf, nbits, pos, prev = 9, 0, 0, 0, None
    while len(out) < size:
        while nbits < width:
            if pos >= len(data):
                return bytes(out[:size])
            buf = (buf << 8) | data[pos]
            pos += 1
            nbits += 8
        nbits -= width
        code = buf >> nbits
        buf &= (1 << nbits) - 1
        if code == _EOI:
            break
        if code == _CLEAR:
            del table[258:]
            width, prev = 9, None
            continue
        if prev is None:
            if code > 255:
                raise ValueError(f"TIFF LZW code {code} after a clear code")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
            elif code == len(table):
                entry = prev + prev[:1]
            else:
                raise ValueError(f"TIFF LZW code {code} is not in its table "
                                 f"of {len(table)}")
            if len(table) < 4096:
                table.append(prev + entry[:1])
            n = len(table)
            if n in (511, 1023, 2047):
                width += 1
        out += entry
        prev = entry
    return bytes(out[:size])


def lzw_decode(data: bytes, size: int) -> bytes:
    """lzw_decode_plain's bytes, by the C++ routine where it builds."""
    if native.library() is None:
        return lzw_decode_plain(data, size)
    return native.lzw_decode(data, size)


def packbits_decode(data: bytes, size: int) -> bytes:
    """PackBits runs -> at most `size` bytes (TIFF 6.0, section 9)."""
    out = bytearray()
    pos, n = 0, len(data)
    while pos < n and len(out) < size:
        h = data[pos]
        pos += 1
        if h < 128:
            out += data[pos:pos + h + 1]
            pos += h + 1
        elif h > 128:
            if pos >= n:
                break
            out += data[pos:pos + 1] * (257 - h)
            pos += 1
    return bytes(out[:size])


def _inflate(data: bytes, size: int) -> bytes:
    try:
        return zlib.decompressobj().decompress(data, size)
    except zlib.error as e:
        raise ValueError(f"TIFF Deflate strip does not decode: {e}") from e


# The codecs Predictor applies to, as in libtiff: with no compression
# or PackBits, it is ignored.
_PREDICTED = (LZW, DEFLATE, OLD_DEFLATE)
_DECODERS = {LZW: lzw_decode, DEFLATE: _inflate, OLD_DEFLATE: _inflate,
             PACKBITS: packbits_decode, NONE: lambda d, size: d[:size]}


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes -> uint8 [H, W, 3] (see the module docstring)."""
    tags = _read_ifd(data)
    if TILE_WIDTH in tags:
        raise UnsupportedImage(f"TIFF tag {TILE_WIDTH} (TileWidth) is set: "
                               "tiled images are not supported")
    w, h = _one(tags, WIDTH), _one(tags, LENGTH)
    spp = _one(tags, SAMPLES, 1)
    bits = tags.get(BITS) or [1]
    if any(b != 8 for b in bits):
        raise UnsupportedImage(f"TIFF tag {BITS} (BitsPerSample) is {bits}: "
                               "8 only")
    comp = _one(tags, COMPRESSION, NONE)
    if comp not in _DECODERS:
        raise UnsupportedImage(f"TIFF tag {COMPRESSION} (Compression) is "
                               f"{comp}: 1, 5, 8, 32946 and 32773 only")
    photo = _one(tags, PHOTOMETRIC)
    if (spp, photo) not in ((1, 0), (1, 1), (3, 2)):
        raise UnsupportedImage(
            f"TIFF tag {PHOTOMETRIC} (PhotometricInterpretation) is {photo} "
            f"with {spp} samples a pixel: grey (0, 1) or RGB (2) only")
    planar = _one(tags, PLANAR, 1)
    if spp > 1 and planar != 1:
        raise UnsupportedImage(f"TIFF tag {PLANAR} (PlanarConfiguration) is "
                               f"{planar}: chunky (1) only")
    predictor = _one(tags, PREDICTOR, 1)
    if predictor not in (1, 2):
        raise UnsupportedImage(f"TIFF tag {PREDICTOR} (Predictor) is "
                               f"{predictor}: 1 or 2 only")
    rps = min(_one(tags, ROWS_PER_STRIP, _ALL_ROWS), h)
    offsets = tags.get(STRIP_OFFSETS)
    counts = tags.get(STRIP_BYTES)
    n_strips = -(-h // rps)
    if not offsets or not counts or min(len(offsets), len(counts)) < \
            n_strips:
        raise ValueError(f"TIFF tags {STRIP_OFFSETS} and {STRIP_BYTES} "
                         f"(StripOffsets, StripByteCounts) give "
                         f"{len(offsets or [])} and {len(counts or [])} "
                         f"strips, {n_strips} needed")

    row = w * spp
    decode = _DECODERS[comp]
    strips = []
    for i in range(n_strips):
        want = min(rps, h - i * rps) * row
        raw = data[offsets[i]:offsets[i] + counts[i]]
        strip = decode(raw, want)
        if len(strip) < want:
            raise ValueError(f"TIFF strip {i} holds {len(strip)} of its "
                             f"{want} bytes: the file is truncated")
        strips.append(strip)
    pix = np.frombuffer(b"".join(strips), np.uint8).reshape(h, w, spp)
    if predictor == 2 and comp in _PREDICTED:
        pix = np.cumsum(pix, axis=1, dtype=np.uint8)
    if photo == 0:
        pix = 255 - pix
    if spp == 1:
        return np.repeat(pix, 3, axis=2)
    return np.ascontiguousarray(pix)


def read_tiff(path) -> np.ndarray:
    """The TIFF file at `path` as uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        return decode_tiff(f.read())
