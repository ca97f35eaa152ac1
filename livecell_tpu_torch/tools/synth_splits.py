"""The three synthetic splits the quality tools read (counterpart of
scripts/make_synth_splits.py, with its own copy of
tests/util_fakedata.py:make_fake_livecell):

  sparse - uniform ellipses, 12 a frame (<= 7 instances a tile);
  lc     - LIVECell-shaped statistics (~305 instances a frame,
           lognormal radii, up to 3:1 aspects);
  dense  - 500 cells a frame (~111 instances a tile).

Each root gets `src/` (704x520 frames as grey TIFFs and the COCO
JSONs, LIVECell's source layout) and `split/` (the 5x5 tile tree of
data/tiling.py, with its 70/15/15 selection over the frames).

    python -m livecell_tpu_torch.tools.synth_splits \\
        --roots sparse:/tmp/synth lc:/tmp/lc dense:/tmp/dense \\
        [--frames 14 3 3] [--seed 0]

Every draw is make_fake_livecell's, in its order, so the source and
tiled annotations equal the JAX tool's at the same seed and mode. The
pixels are drawn with numpy and the port's polygon raster (the data
path needs no PIL), so they differ from PIL's at cell edges. Nothing
here touches a device.
"""

from __future__ import annotations

import argparse
import json
import math
import struct
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from livecell_tpu_torch.data.coco import polygons_to_mask
from livecell_tpu_torch.data.tiling import LIVECellPreprocessor

MODES = {
    "sparse": dict(cells_per_image=12),
    "lc": dict(stats="livecell"),
    "dense": dict(cells_per_image=500),
}

# LIVECell-scale morphology (reference README.md:324-327: 5,239 frames,
# >1.6M instances, ~305 a 704x520 frame; per-type sizes of ~100-3000
# px^2 with a median near 300-400 px^2, an equivalent radius of ~10 px;
# elongated types reach ~3:1).
LIVECELL_MEAN_INSTANCES_PER_FRAME = 305
LIVECELL_RADIUS_MEDIAN_PX = 10.0
LIVECELL_RADIUS_SIGMA = 0.45        # lognormal sigma of equiv. radius
LIVECELL_MAX_ASPECT = 3.0
BACKGROUND = 30


def ellipse_polygon(cx, cy, rx, ry, n=16, theta=0.0) -> List[float]:
    """Flat polygon of an ellipse rotated by `theta` radians."""
    ct, st = math.cos(theta), math.sin(theta)
    pts = []
    for i in range(n):
        a = 2 * math.pi * i / n
        ex, ey = rx * math.cos(a), ry * math.sin(a)
        pts.extend([cx + ex * ct - ey * st, cy + ex * st + ey * ct])
    return pts


def sample_livecell_instances(rng, frame_w, frame_h,
                              mean_count=LIVECELL_MEAN_INSTANCES_PER_FRAME
                              ) -> List[Tuple[float, ...]]:
    """(cx, cy, rx, ry, theta) tuples with LIVECell-like per-frame count
    and size statistics: a normal frame count, a lognormal equivalent
    radius, a uniform elongation up to 3:1."""
    count = max(1, int(rng.normal(mean_count, mean_count * 0.25)))
    out = []
    for _ in range(count):
        r = LIVECELL_RADIUS_MEDIAN_PX * math.exp(
            rng.normal(0.0, LIVECELL_RADIUS_SIGMA))
        aspect = rng.uniform(1.0, LIVECELL_MAX_ASPECT)
        rx, ry = r * math.sqrt(aspect), r / math.sqrt(aspect)
        out.append((rng.uniform(5, frame_w - 5), rng.uniform(5, frame_h - 5),
                    rx, ry, rng.uniform(0, math.pi)))
    return out


def sample_uniform_instances(rng, frame_w, frame_h, count
                             ) -> List[Tuple[float, ...]]:
    """`count` axis-aligned ellipses, centres 30 px or more from the
    border, radii 12-30 px."""
    return [(rng.uniform(30, frame_w - 30), rng.uniform(30, frame_h - 30),
             rng.uniform(12, 30), rng.uniform(12, 30), 0.0)
            for _ in range(count)]


def write_gray_tiff(path, arr: np.ndarray) -> None:
    """An uncompressed 8-bit grey baseline TIFF of `arr` [H, W] uint8:
    the header, the pixels as one strip, then the image directory."""
    h, w = arr.shape
    data = np.ascontiguousarray(arr, np.uint8).tobytes()
    ifd_at = 8 + len(data) + len(data) % 2
    short, long_ = 3, 4
    tags = [(256, long_, w), (257, long_, h), (258, short, 8),
            (259, short, 1), (262, short, 1), (273, long_, 8),
            (277, short, 1), (278, long_, h), (279, long_, len(data))]
    out = [b"II*\x00", struct.pack("<I", ifd_at), data,
           b"\x00" * (ifd_at - 8 - len(data)), struct.pack("<H", len(tags))]
    for tag, typ, value in tags:
        out.append(struct.pack("<HHIH2x", tag, typ, 1, value) if typ == short
                   else struct.pack("<HHII", tag, typ, 1, value))
    out.append(struct.pack("<I", 0))
    Path(path).write_bytes(b"".join(out))


def make_fake_livecell(root, images_per_split=(4, 1, 1), frame_w=704,
                       frame_h=520, cells_per_image=12, seed=0, stats=None,
                       mean_instances=None) -> Dict[str, np.ndarray]:
    """A LIVECell source tree under `root`: per-split image directories
    of grey TIFFs and COCO JSONs with polygon annotations, file names
    prefixed 'A172', image and annotation ids running across the splits.
    stats="livecell" samples LIVECell's per-frame statistics
    (sample_livecell_instances; `mean_instances` overrides the mean
    count), else `cells_per_image` uniform ellipses. Each cell is filled
    with one grey level of 120-220 on a background of 30. Returns
    {file name: frame [H, W] uint8}."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    categories = [{"id": 1, "name": "cell"}]
    frames = {}
    img_id = 0
    ann_id = 0
    for split, n_imgs in zip(("train", "val", "test"), images_per_split):
        img_dir = root / split / "images"
        img_dir.mkdir(parents=True, exist_ok=True)
        images, annotations = [], []
        for i in range(n_imgs):
            img_id += 1
            name = f"A172_Phase_{split}_{i:03d}.tif"
            canvas = np.full((frame_h, frame_w), BACKGROUND, np.uint8)
            if stats == "livecell":
                cells = sample_livecell_instances(
                    rng, frame_w, frame_h, mean_count=mean_instances
                    or LIVECELL_MEAN_INSTANCES_PER_FRAME)
            else:
                cells = sample_uniform_instances(rng, frame_w, frame_h,
                                                 cells_per_image)
            for cx, cy, rx, ry, theta in cells:
                poly = ellipse_polygon(cx, cy, rx, ry, theta=theta)
                canvas[polygons_to_mask([poly], frame_h, frame_w) > 0] = \
                    int(rng.uniform(120, 220))
                xs, ys = poly[0::2], poly[1::2]
                x1, y1 = max(min(xs), 0), max(min(ys), 0)
                x2, y2 = min(max(xs), frame_w), min(max(ys), frame_h)
                if x2 - x1 < 1 or y2 - y1 < 1:
                    continue  # fully outside after clamping
                ann_id += 1
                annotations.append({
                    "id": ann_id, "image_id": img_id, "category_id": 1,
                    "bbox": [x1, y1, x2 - x1, y2 - y1],
                    "area": (x2 - x1) * (y2 - y1),
                    "segmentation": [poly], "iscrowd": 0,
                })
            write_gray_tiff(img_dir / name, canvas)
            frames[name] = canvas
            images.append({"id": img_id, "file_name": name,
                           "width": frame_w, "height": frame_h})
        ann_dir = root / "annotations"
        ann_dir.mkdir(parents=True, exist_ok=True)
        with open(ann_dir / f"livecell_coco_{split}.json", "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": categories}, f)
    return frames


def build(name: str, root: Path, frames, seed: int) -> None:
    """Draw and tile the `name` split under `root` unless its tiled
    training split is there already."""
    src = root / "src"
    if not (root / "split" / "train").exists():
        make_fake_livecell(src, images_per_split=tuple(frames), seed=seed,
                           **MODES[name])
        LIVECellPreprocessor(str(src), str(root / "split"),
                             total_images=sum(frames)).preprocess()
    print(f"[{name}] ready at {root}/split", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--roots", nargs="+",
                        default=["sparse:/tmp/synth", "lc:/tmp/lc",
                                 "dense:/tmp/dense"],
                        help="mode:root pairs")
    parser.add_argument("--frames", nargs=3, type=int, default=[14, 3, 3],
                        help="source frames per train/val/test split")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    for pair in args.roots:
        name, root = pair.split(":", 1)
        build(name, Path(root), args.frames, args.seed)


if __name__ == "__main__":
    main()
