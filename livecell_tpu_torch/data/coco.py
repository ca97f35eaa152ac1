"""COCO annotation tooling: JSON index, RLE codec, polygon raster
(counterpart of livecell_tpu/data/coco.py).

pycocotools is not a dependency, so the port carries its own:

  * rle_decode / rle_encode: COCO uncompressed ({'counts': [..]}) and
    compressed (LEB128-style ascii string) RLE, column-major like COCO.
  * polygons_to_mask: even-odd scanline fill sampled at pixel centers,
    through the C++ routine of livecell_tpu_torch/native when it builds,
    else the numpy one here; both give the same pixels.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

from livecell_tpu_torch import native


# ----------------------------------------------------------------------
# RLE codec (COCO conventions: column-major, counts alternate 0s/1s).
# ----------------------------------------------------------------------

def rle_decode(rle: Dict, shape=None) -> np.ndarray:
    """Decode COCO RLE ('counts' list or compressed str) to uint8 [H, W]."""
    h, w = rle["size"] if shape is None else shape
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _rle_string_to_counts(counts)
    counts = np.asarray(counts, dtype=np.int64)
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    flat = np.pad(flat, (0, h * w - flat.size))
    return flat.reshape(w, h).T  # column-major


def rle_encode(mask: np.ndarray) -> Dict:
    """Encode a binary [H, W] mask as uncompressed COCO RLE."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)  # column-major
    change = np.flatnonzero(np.diff(flat)) + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]]))
    counts = runs.tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def _rle_string_to_counts(s) -> List[int]:
    """COCO compressed RLE string -> counts (LEB128 variant with deltas)."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _counts_to_rle_string(counts: Sequence[int]) -> str:
    """Inverse of _rle_string_to_counts."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


# ----------------------------------------------------------------------
# Polygon rasterization.
# ----------------------------------------------------------------------

def _rasterize_one(poly: np.ndarray, h: int, w: int) -> np.ndarray:
    """Even-odd scanline fill of one polygon (pixel centers at +0.5)."""
    xs, ys = poly[0::2], poly[1::2]
    n = len(xs)
    if n < 3:
        return np.zeros((h, w), np.uint8)
    x1, y1 = xs, ys
    x2, y2 = np.roll(xs, -1), np.roll(ys, -1)

    yc = np.arange(h, dtype=np.float64) + 0.5               # [H]
    # Edge e crosses row y iff min(y1,y2) <= yc < max(y1,y2).
    lo = np.minimum(y1, y2)[None, :]
    hi = np.maximum(y1, y2)[None, :]
    crossing = (yc[:, None] >= lo) & (yc[:, None] < hi)      # [H, E]
    dy = np.where(y2 - y1 == 0, 1.0, y2 - y1)
    t = (yc[:, None] - y1[None, :]) / dy[None, :]
    cx = x1[None, :] + t * (x2 - x1)[None, :]                # [H, E]
    cx = np.where(crossing, cx, np.inf)
    cx.sort(axis=1)

    mask = np.zeros((h, w + 1), np.int32)
    rows, cols = np.nonzero(np.isfinite(cx))
    # Pixel x is inside when count of crossings <= x+0.5 is odd; toggle
    # parity at ceil(cx - 0.5) and cumsum.
    starts = np.clip(np.ceil(cx[rows, cols] - 0.5).astype(np.int64), 0, w)
    np.add.at(mask, (rows, starts), 1)
    inside = np.cumsum(mask[:, :w], axis=1) % 2
    return inside.astype(np.uint8)


def polygons_to_mask(polygons: Sequence[Sequence[float]], h: int,
                     w: int) -> np.ndarray:
    """Rasterize COCO polygon segmentation (list of flat coord lists) to a
    uint8 [H, W] mask. Multiple polygons are unioned (the pycocotools
    annToMask merge behavior)."""
    out = np.zeros((h, w), np.uint8)
    for poly in polygons:
        p = np.asarray(poly, np.float64)
        if p.size < 6:
            continue
        if native.library() is not None:
            m = native.rasterize_polygon(p, h, w)
        else:
            m = _rasterize_one(p, h, w)
        out |= m
    return out


def ann_to_mask(ann: Dict, h: int, w: int) -> np.ndarray:
    """pycocotools coco.annToMask equivalent (reference dataset.py:54)."""
    seg = ann["segmentation"]
    if isinstance(seg, dict):
        return rle_decode(seg, (h, w))
    return polygons_to_mask(seg, h, w)


# ----------------------------------------------------------------------
# JSON index (the slice of pycocotools.COCO the pipelines use).
# ----------------------------------------------------------------------

class CocoIndex:
    """Index over a COCO-format annotation JSON.

    Provides the accessors the reference uses from pycocotools.COCO
    (preprocess_dataset.py:267-312, dataset.py:27-42): imgs by id,
    anns by image, categories.
    """

    def __init__(self, path_or_dict):
        if isinstance(path_or_dict, (str, bytes)) or hasattr(
                path_or_dict, "__fspath__"):
            with open(path_or_dict) as f:
                self.dataset = json.load(f)
        else:
            self.dataset = path_or_dict
        self.imgs = {img["id"]: img for img in self.dataset.get("images", [])}
        self.anns = {a["id"]: a for a in self.dataset.get("annotations", [])}
        self.img_to_anns = defaultdict(list)
        for a in self.dataset.get("annotations", []):
            self.img_to_anns[a["image_id"]].append(a)
        self.cats = {c["id"]: c
                     for c in self.dataset.get("categories", [])}

    def get_img_ids(self) -> List[int]:
        return list(self.imgs.keys())

    def load_imgs(self, ids) -> List[Dict]:
        return [self.imgs[i] for i in ids]

    def get_anns(self, img_id: int) -> List[Dict]:
        return list(self.img_to_anns.get(img_id, []))
