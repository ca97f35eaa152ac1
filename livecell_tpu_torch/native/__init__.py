"""Host-side routines in C++ (ctypes bindings): the polygon rasterizer,
the COCO RLE codec and the TIFF LZW decoder of `rasterize.cc`, and the
zstd decoder and CRC-32C of `zstd.cc` (the checkpoint reader's).

The library is built from both sources with g++ at first use, not when
this module is imported, into
`livecell_tpu_torch/build/librasterize-<hash>.so` (the hash covers every
source and the flags). It is compiled to a temporary
name and renamed into place, so processes that build at once never load
a half-written file. Without a compiler, or if the build fails,
`library()` is None and data/coco.py, data/tiff.py and utils/zstd.py
take their numpy and Python routines instead; `backend()` says which
path serves.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCES = [HERE / "rasterize.cc", HERE / "zstd.cc"]
BUILD = HERE.parent / "build"
FLAGS = ["-O3", "-shared", "-fPIC"]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"librasterize-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, *map(str, SOURCES), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, path)
    return True


@functools.lru_cache(maxsize=None)
def library() -> Optional[ctypes.CDLL]:
    """The built library, or None where it cannot be built."""
    path = library_path()
    if not path.exists() and not _build(path):
        return None
    lib = ctypes.CDLL(str(path))
    lib.rasterize_polygon.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    lib.rasterize_polygon.restype = None
    lib.rle_decode.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    lib.rle_decode.restype = None
    lib.rle_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64)]
    lib.rle_encode.restype = ctypes.c_int
    lib.lzw_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.lzw_decode.restype = ctypes.c_int64
    lib.zstd_decompress.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int64]
    lib.zstd_decompress.restype = ctypes.c_int64
    lib.zstd_content_size.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                      ctypes.c_int64]
    lib.zstd_content_size.restype = ctypes.c_int64
    lib.crc32c.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.crc32c.restype = ctypes.c_uint32
    return lib


def backend() -> str:
    """"cpp" when the C++ routines serve, "numpy" when they cannot."""
    return "cpp" if library() is not None else "numpy"


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def rasterize_polygon(poly: np.ndarray, h: int, w: int) -> np.ndarray:
    """Even-odd scanline fill of one flat-coordinate polygon -> uint8
    [h, w]."""
    poly = np.ascontiguousarray(poly, np.float64)
    out = np.zeros((h, w), np.uint8)
    library().rasterize_polygon(_ptr(poly, ctypes.c_double), len(poly) // 2,
                                h, w, _ptr(out, ctypes.c_uint8))
    return out


def rle_decode(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    """Column-major COCO RLE counts -> uint8 [h, w]."""
    counts = np.ascontiguousarray(counts, np.int64)
    out = np.zeros((h, w), np.uint8)
    library().rle_decode(_ptr(counts, ctypes.c_int64), len(counts), h, w,
                         _ptr(out, ctypes.c_uint8))
    return out


def rle_encode(mask: np.ndarray) -> np.ndarray:
    """uint8 [h, w] -> column-major COCO RLE counts (int64)."""
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    counts = np.zeros(h * w + 1, np.int64)
    n = library().rle_encode(_ptr(mask, ctypes.c_uint8), h, w,
                             _ptr(counts, ctypes.c_int64))
    return counts[:n]


def lzw_decode(data: bytes, size: int) -> bytes:
    """TIFF LZW bytes -> at most `size` decoded bytes
    (data/tiff.py:lzw_decode_plain's result); raises ValueError on a
    code that is not yet in the table."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty(size, np.uint8)
    n = library().lzw_decode(_ptr(src, ctypes.c_uint8), len(src),
                             _ptr(out, ctypes.c_uint8), size)
    if n < 0:
        raise ValueError("TIFF LZW code that is not in its table")
    return out[:n].tobytes()


def zstd_decompress(data) -> bytes:
    """The content of the concatenated zstd frames in `data`
    (utils/zstd.py:decompress_plain's result); raises
    utils.zstd.ZstdError on a truncated, corrupt or unsupported input.
    The output is sized from the frames' content sizes, or, where a
    frame does not record its size, grown until it fits."""
    from livecell_tpu_torch.utils.zstd import ZstdError

    src = np.frombuffer(data, np.uint8)
    lib = library()
    cap = lib.zstd_content_size(_ptr(src, ctypes.c_uint8), len(src))
    exact = cap >= 0
    if not exact:
        cap = max(1 << 20, 4 * len(src))
    err = ctypes.create_string_buffer(256)
    while True:
        out = np.empty(max(cap, 1), np.uint8)
        n = lib.zstd_decompress(_ptr(src, ctypes.c_uint8), len(src),
                                _ptr(out, ctypes.c_uint8), cap, err, 256)
        if n >= 0:
            return out[:n].tobytes()
        if n == -2 and not exact:
            cap *= 4
            continue
        if n == -2:
            raise ZstdError("zstd: frame content size does not match its "
                            "blocks")
        raise ZstdError(err.value.decode())


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of `data`."""
    src = np.frombuffer(data, np.uint8)
    return int(library().crc32c(_ptr(src, ctypes.c_uint8), len(src)))
