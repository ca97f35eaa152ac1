"""LIVECell tiling preprocessor (counterpart of
livecell_tpu/data/tiling.py).

Behavioral re-implementation of the reference CLI
(reference src/preprocess_dataset.py:16-373): identical grid geometry
(grid_size = int(sqrt(tiles)) + 2 mini-tiles, 3x3-mini-tile windows over
all positions -> 25 tiles of 300x222 for a 704x520 frame), identical
annotation remapping (drop if intersection < 30% of the object bbox
area, polygon translate+clamp, drop polygons with < 3 points, area =
clipped w*h), identical selection (file_name startswith 'A172', sorted,
first N per split with a 70/15/15 split of --num_images_per_split), and
identical outputs (per-split tile PNGs named
'{stem}_tile_{k:02d}.png', one COCO JSON per split, annotation ids
image_id*10000+k).

CLI flags keep the reference names:
  python -m livecell_tpu_torch.data.tiling --source_dir data \
      --output_dir data_split --num_images_per_split 100

`tile_frame` is the numpy body that cuts one decoded frame into tiles;
`LIVECellPreprocessor.process_image` reads a source frame with PIL
(imported there, so this module imports without PIL) and calls it.
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from livecell_tpu_torch.data.coco import CocoIndex, rle_decode, rle_encode
from livecell_tpu_torch.data.png import write_gray_png

TILES_PER_IMAGE = 25


def tile_grid(img_w: int, img_h: int, grid_size: int) -> Tuple[int, int]:
    """Mini-tile dimensions (reference calculate_tile_grid,
    preprocess_dataset.py:86-93)."""
    return img_w // grid_size, img_h // grid_size


def tile_coordinates(grid_size: int, mini_w: int, mini_h: int,
                     window: int = 3) -> List[Tuple[int, int, int, int]]:
    """All sliding-window tile rectangles (reference get_tile_coordinates,
    preprocess_dataset.py:95-124). Row-major over window positions."""
    tiles = []
    n_pos = grid_size - window + 1
    for row in range(n_pos):
        for col in range(n_pos):
            tiles.append((col * mini_w, row * mini_h,
                          (col + window) * mini_w, (row + window) * mini_h))
    return tiles


def remap_annotation(ann: Dict, tile: Tuple[int, int, int, int],
                     min_overlap: float = 0.3) -> Optional[Dict]:
    """Remap one COCO annotation into tile-local coordinates (reference
    remap_annotation_to_tile, preprocess_dataset.py:126-181)."""
    x_min, y_min, x_max, y_max = tile
    ox, oy, ow, oh = ann["bbox"]
    ix1 = max(x_min, ox)
    iy1 = max(y_min, oy)
    ix2 = min(x_max, ox + ow)
    iy2 = min(y_max, oy + oh)
    if ix1 >= ix2 or iy1 >= iy2:
        return None
    inter = (ix2 - ix1) * (iy2 - iy1)
    obj_area = ow * oh
    if obj_area <= 0 or inter / obj_area < min_overlap:
        return None

    new_ann = dict(ann)
    new_ann["bbox"] = [ix1 - x_min, iy1 - y_min, ix2 - ix1, iy2 - iy1]

    if "segmentation" in ann and isinstance(ann["segmentation"], list):
        new_seg = []
        for poly in ann["segmentation"]:
            pts = np.asarray(poly, dtype=np.float64).reshape(-1, 2)
            pts[:, 0] = np.clip(pts[:, 0] - x_min, 0, x_max - x_min)
            pts[:, 1] = np.clip(pts[:, 1] - y_min, 0, y_max - y_min)
            flat = pts.reshape(-1).tolist()
            if len(flat) >= 6:
                new_seg.append(flat)
        if not new_seg:
            return None
        new_ann["segmentation"] = new_seg
    elif isinstance(ann.get("segmentation"), dict):
        # Dict-RLE segmentation: decode, crop to the tile, re-encode.
        # (The reference would crash on these, preprocess_dataset.py:
        # 159-178 assumes polygon lists; passing the RLE through with
        # untranslated coordinates would silently corrupt the tile JSON.)
        dense = rle_decode(ann["segmentation"])
        crop = dense[int(y_min):int(y_max), int(x_min):int(x_max)]
        if not crop.any():
            return None
        new_ann["segmentation"] = rle_encode(np.ascontiguousarray(crop))

    new_ann["area"] = new_ann["bbox"][2] * new_ann["bbox"][3]
    return new_ann


def tile_frame(arr: np.ndarray, img_info: Dict, annotations: List[Dict],
               out_dir, first_id: int,
               grid_size: int = int(math.sqrt(TILES_PER_IMAGE)) + 2,
               window: int = 3, compress_level: int = 1) -> List[Dict]:
    """Cut one decoded source frame (uint8 [H, W, 3] or [H, W]) into the
    sliding-window tiles, write them as PNGs under `out_dir` and return
    one record per tile (id, file_name, width, height, annotations),
    tile ids first_id + 1, first_id + 2, ... A frame whose three
    channels are equal is written as 8-bit grey PNGs by the port's
    encoder; any other RGB frame through PIL, imported only then.
    """
    stem = Path(img_info["file_name"]).stem
    h, w = arr.shape[:2]
    mini_w, mini_h = tile_grid(w, h, grid_size)
    coords = tile_coordinates(grid_size, mini_w, mini_h, window)

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    # Decode once; tiles are strided views of this array. Prefilter
    # the tile x annotation pairing in one vectorized pass so
    # remap_annotation only runs on bboxes that can clear the 30%
    # overlap gate (a cell touches ~1-4 of the 25 tiles; the naive
    # loop is 25xA remaps per frame — reference
    # preprocess_dataset.py:229-240 does exactly that).
    # LIVECell microscopy is grayscale stored as RGB; when all three
    # channels match, write L-mode PNGs (3x fewer bytes to encode,
    # 3x less disk). Every consumer opens tiles with .convert("RGB"),
    # so the round-trip is pixel-identical.
    if (arr.ndim == 3 and arr.shape[2] == 3
            and (arr[..., 1] == arr[..., 0]).all()
            and (arr[..., 2] == arr[..., 0]).all()):
        arr = arr[..., 0]
    tiles_np = np.asarray(coords, dtype=np.float64)      # [T, 4] xyxy
    if annotations:
        bb = np.asarray([a["bbox"] for a in annotations],
                        dtype=np.float64)                 # [A, 4] xywh
        ix1 = np.maximum(tiles_np[:, None, 0], bb[None, :, 0])
        iy1 = np.maximum(tiles_np[:, None, 1], bb[None, :, 1])
        ix2 = np.minimum(tiles_np[:, None, 2], bb[None, :, 0] + bb[:, 2])
        iy2 = np.minimum(tiles_np[:, None, 3], bb[None, :, 1] + bb[:, 3])
        inter = (np.clip(ix2 - ix1, 0, None)
                 * np.clip(iy2 - iy1, 0, None))           # [T, A]
        area = np.maximum(bb[:, 2] * bb[:, 3], 1e-12)
        # Slightly below remap's 0.3 gate: the prefilter only needs
        # to be a superset; remap_annotation stays authoritative.
        cand = inter / area >= 0.29                       # [T, A]
    else:
        cand = np.zeros((len(coords), 0), dtype=bool)

    results = []
    for tile_idx, tc in enumerate(coords):
        new_id = first_id + tile_idx + 1
        tile_name = f"{stem}_tile_{tile_idx:02d}.png"
        x0, y0, x1, y1 = tc
        tile_arr = arr[y0:y1, x0:x1]
        if tile_arr.ndim == 2:
            write_gray_png(out_dir / tile_name, tile_arr,
                           compress_level)
        else:
            from PIL import Image

            Image.fromarray(tile_arr).save(
                out_dir / tile_name, compress_level=compress_level)

        tile_anns = []
        ann_id = new_id * 10000
        for ai in np.nonzero(cand[tile_idx])[0]:
            remapped = remap_annotation(annotations[ai], tc)
            if remapped is not None:
                ann_id += 1
                remapped["id"] = ann_id
                remapped["image_id"] = new_id
                tile_anns.append(remapped)

        results.append({
            "id": new_id, "file_name": tile_name,
            "width": tc[2] - tc[0], "height": tc[3] - tc[1],
            "annotations": tile_anns,
        })
    return results


class LIVECellPreprocessor:
    """Tile a LIVECell source tree into a data_split tree.

    Mirrors the reference class (preprocess_dataset.py:16-347) including
    its directory auto-detection (per-split train/val/test image dirs or
    one flat images/ dir) and progress behavior.
    """

    def __init__(self, source_dir: str, output_dir: str,
                 total_images: int = 100,
                 tiles_per_image: int = TILES_PER_IMAGE,
                 cell_type_prefix: str = "A172",
                 png_compress_level: int = 1):
        self.source_dir = Path(source_dir)
        self.output_dir = Path(output_dir)
        self.total_images = total_images
        # zlib level for tile PNGs. 1 encodes ~3x faster than PIL's
        # default 6 at ~15% larger files; pixels are identical. Pass 6
        # for byte-size parity with the reference's default save.
        self.png_compress_level = png_compress_level
        self.grid_size = int(math.sqrt(tiles_per_image)) + 2
        self.window = 3
        self.cell_type_prefix = cell_type_prefix

        n_train = int(total_images * 0.70)
        n_val = int(total_images * 0.15)
        self.split_limits = {"train": n_train, "val": n_val,
                             "test": total_images - n_train - n_val}
        self._detect_structure()

    def _detect_structure(self):
        self.annotations_dir = self.source_dir / "annotations"
        if (self.source_dir / "train" / "images").exists():
            self.images_dirs = {
                s: self.source_dir / s / "images"
                for s in ("train", "val", "test")}
        elif (self.source_dir / "images").exists():
            flat = self.source_dir / "images"
            self.images_dirs = {s: flat for s in ("train", "val", "test")}
        else:
            raise ValueError(
                f"Cannot detect valid LIVECell structure in {self.source_dir}")
        self.split_ann_files = {
            s: self.annotations_dir / f"livecell_coco_{s}.json"
            for s in ("train", "val", "test")}
        for s, p in self.split_ann_files.items():
            if not p.exists():
                raise ValueError(f"Missing annotation file for {s}: {p}")

    def _find_image(self, split: str, file_name: str) -> Optional[Path]:
        d = self.images_dirs[split]
        for p in (d / file_name, d / Path(file_name).name):
            if p.exists():
                return p
        return None

    def process_image(self, img_info: Dict, annotations: List[Dict],
                      img_counter: Dict[str, int], split: str) -> List[Dict]:
        from PIL import Image

        path = self._find_image(split, img_info["file_name"])
        if path is None:
            print(f"Image not found: {img_info['file_name']}, skipping")
            return []
        try:
            img = Image.open(path)
            if img.mode != "RGB":
                img = img.convert("RGB")
        except Exception as e:  # corrupt file: skip, like the reference
            print(f"Failed to load {path}: {e}, skipping")
            return []
        results = tile_frame(
            np.asarray(img), img_info, annotations,
            self.output_dir / split / "images", img_counter[split],
            self.grid_size, self.window, self.png_compress_level)
        img_counter[split] += len(results)
        return results

    def preprocess(self):
        img_counter = {"train": 0, "val": 0, "test": 0}
        for split, ann_path in self.split_ann_files.items():
            limit = self.split_limits[split]
            print(f"Processing {split} split (target: {limit} images)")
            if limit == 0:
                continue
            coco = CocoIndex(ann_path)

            valid = []
            for img in coco.load_imgs(coco.get_img_ids()):
                if img["file_name"].startswith(self.cell_type_prefix) and \
                        self._find_image(split, img["file_name"]):
                    valid.append(img)
            valid.sort(key=lambda x: x["file_name"])
            selected = valid[:limit]
            if len(selected) < limit:
                print(f"Warning: requested {limit} but only found "
                      f"{len(selected)} valid images")

            images_out, anns_out = [], []
            for info in selected:
                for tile in self.process_image(
                        info, coco.get_anns(info["id"]), img_counter, split):
                    images_out.append({k: tile[k] for k in
                                       ("id", "file_name", "width", "height")})
                    anns_out.extend(tile["annotations"])

            ann_dir = self.output_dir / "annotations"
            ann_dir.mkdir(parents=True, exist_ok=True)
            with open(ann_dir / f"livecell_coco_{split}.json", "w") as f:
                # dumps() uses the C encoder; dump() streams through the
                # pure-Python one (~10x slower — it was 43% of
                # preprocess time on the 8-frame bench).
                f.write(json.dumps(
                    {"images": images_out, "annotations": anns_out,
                     "categories": coco.dataset["categories"]}))
            print(f"{split} complete: {len(images_out)} tiles from "
                  f"{len(selected)} source images")
        print(f"Finished. Output directory: {self.output_dir}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Preprocess dataset by splitting images into tiles")
    parser.add_argument("--source_dir", type=str, default="data")
    parser.add_argument("--output_dir", type=str, default="data_split")
    parser.add_argument("--num_images_per_split", type=int, default=100,
                        help="TOTAL source images across splits (70/15/15)")
    parser.add_argument("--tile_overlap", type=int, default=0,
                        help="Overlap determined by 3x3 sliding window")
    args = parser.parse_args(argv)

    LIVECellPreprocessor(
        source_dir=args.source_dir, output_dir=args.output_dir,
        total_images=args.num_images_per_split).preprocess()


if __name__ == "__main__":
    main()
