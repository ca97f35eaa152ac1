"""zarr v2 arrays, read-only, without the zarr library: the chunked array
format Orbax writes each leaf of a checkpoint in
(train/jax_checkpoint.py).

An array is a `.zarray` JSON (zarr_format 2: shape, chunks, dtype,
order, fill_value, compressor, filters, dimension_separator) and one
value per chunk under the key of its grid index ("0.0"; "0" for a
zero-dimensional array). A chunk holds the
whole chunk shape, also at the array's edge. A chunk that is missing
holds the fill value (null reads as zero, as tensorstore reads it).

Read: the dtypes Orbax writes (DTYPES; "bfloat16" widened to float32,
exactly), C order, the "." separator, compressor null or zstd
(utils/zstd.py), no filters. Anything else raises UnsupportedArray
naming it.
"""

from __future__ import annotations

import itertools
import math
import time
from typing import Callable, Dict, Optional

import numpy as np

from livecell_tpu_torch.utils import zstd

# The stored dtype of each zarr dtype read (bfloat16 as its raw bits).
DTYPES = {"<f4": "<f4", "<f8": "<f8", "<i4": "<i4", "<i8": "<i8",
          "|b1": "|b1", "|u1": "|u1", "bfloat16": "<u2"}


class UnsupportedArray(ValueError):
    """A zarr array in a layout the reader refuses (named in the
    message)."""


def _fill(value):
    if value is None:
        return 0
    if isinstance(value, str):
        named = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if value not in named:
            raise UnsupportedArray(f"fill_value {value!r}")
        return named[value]
    return value


def read_array(meta: Dict, get: Callable[[str], Optional[bytes]],
               what: str = "zarr array",
               stats: Optional[Dict[str, float]] = None) -> np.ndarray:
    """The array `meta` (a parsed .zarray) describes, its chunks read by
    `get(chunk_key)` (None for a missing chunk). `stats`, where given,
    accumulates the seconds spent in zstd ("zstd_s") and the decoded
    bytes ("decoded_bytes")."""
    if meta.get("zarr_format") != 2:
        raise UnsupportedArray(f"{what}: zarr_format "
                               f"{meta.get('zarr_format')!r}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise UnsupportedArray(f"{what}: compressor {comp.get('id')!r} "
                               f"(only zstd is read)")
    if meta.get("filters"):
        raise UnsupportedArray(f"{what}: filters "
                               f"{[f.get('id') for f in meta['filters']]}")
    if meta.get("order", "C") != "C":
        raise UnsupportedArray(f"{what}: order {meta['order']!r}")
    if meta.get("dimension_separator", ".") != ".":
        raise UnsupportedArray(f"{what}: dimension_separator "
                               f"{meta['dimension_separator']!r}")
    if not isinstance(meta["dtype"], str) or meta["dtype"] not in DTYPES:
        raise UnsupportedArray(f"{what}: dtype {meta['dtype']!r}")
    bf16 = meta["dtype"] == "bfloat16"
    dt = np.dtype(DTYPES[meta["dtype"]])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise UnsupportedArray(f"{what}: chunks {chunks} for shape {shape}")
    fill = _fill(meta.get("fill_value"))
    if bf16 and fill != 0:
        raise UnsupportedArray(f"{what}: bfloat16 fill_value {fill!r}")
    out = np.full(shape, fill, dt)
    grid = [range(math.ceil(s / c)) for s, c in zip(shape, chunks)]
    size = math.prod(chunks) * dt.itemsize
    for idx in itertools.product(*grid):
        key = ".".join(map(str, idx)) if idx else "0"
        raw = get(key)
        if raw is None:
            continue
        if comp is not None:
            t = time.perf_counter()
            raw = zstd.decompress(raw)
            if stats is not None:
                stats["zstd_s"] = stats.get("zstd_s", 0.0) + (
                    time.perf_counter() - t)
        if stats is not None:
            stats["decoded_bytes"] = stats.get("decoded_bytes", 0) + len(raw)
        if len(raw) != size:
            raise ValueError(f"{what}: chunk {key} holds {len(raw)} bytes, "
                             f"its shape {chunks} needs {size}")
        chunk = np.frombuffer(raw, dt).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]
    if bf16:
        return (out.astype(np.uint32) << 16).view(np.float32)
    return out
