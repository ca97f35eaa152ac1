"""Host-side data-path routines in C++ (ctypes bindings): the polygon
rasterizer and the COCO RLE codec of `rasterize.cc`.

The library is built with g++ at first use, not when this module is
imported, into `livecell_tpu_torch/build/librasterize-<hash>.so` (the
hash covers the source and the flags). It is compiled to a temporary
name and renamed into place, so processes that build at once never load
a half-written file. Without a compiler, or if the build fails,
`library()` is None and data/coco.py takes its numpy routines instead;
`backend()` says which path serves.
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

SRC = Path(__file__).resolve().parent / "rasterize.cc"
BUILD = SRC.parent.parent / "build"
FLAGS = ["-O3", "-shared", "-fPIC"]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD / f"librasterize-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
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
