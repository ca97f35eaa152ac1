"""LIVECell source-tree schema validator (counterpart of
livecell_tpu/data/validate.py).

Run before training on a freshly downloaded dataset to fail fast with a
precise message instead of mid-pipeline (the reference has no
equivalent; its preprocess_dataset.py crashes on the first malformed
annotation it touches). Checks the layout of a LIVECell download
(the reference's scripts/download_data.py):

    <root>/{train,val,test}/images/*.tif|png
    <root>/annotations/livecell_coco_{train,val,test}.json

and the COCO invariants the tiling preprocessor and PackedDataset rely
on: image records with id/file_name/width/height, annotations with
bbox/segmentation (polygon list or RLE dict) pointing at existing
images, and the single-category cell scheme.

    python -m livecell_tpu_torch.data.validate --data_dir data
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

SPLITS = ("train", "val", "test")
IMAGE_EXTS = {".tif", ".tiff", ".png", ".jpg", ".jpeg"}


@dataclass
class SplitReport:
    split: str
    n_images: int = 0
    n_annotations: int = 0
    n_polygon: int = 0
    n_rle: int = 0
    instances_per_image_max: int = 0
    errors: List[str] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.errors


def validate_split(root: Path, split: str,
                   check_files: bool = True) -> SplitReport:
    rep = SplitReport(split=split)
    img_dir = root / split / "images"
    ann_file = root / "annotations" / f"livecell_coco_{split}.json"

    if not img_dir.is_dir():
        rep.errors.append(f"missing image directory {img_dir}")
    if not ann_file.is_file():
        rep.errors.append(f"missing annotation file {ann_file}")
        return rep

    try:
        with open(ann_file) as f:
            coco = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        rep.errors.append(f"{ann_file}: unreadable JSON ({e})")
        return rep

    for key in ("images", "annotations", "categories"):
        if key not in coco:
            rep.errors.append(f"{ann_file}: missing COCO key '{key}'")
    if rep.errors:
        return rep

    cats = {c.get("id") for c in coco["categories"]}
    if len(cats) != 1:
        rep.warnings.append(
            f"{len(cats)} categories (LIVECell uses a single 'cell' "
            f"class; the pipeline trains binary heads)")

    ids_seen = set()
    by_image: Dict[int, int] = {}
    for img in coco["images"]:
        rep.n_images += 1
        for key in ("id", "file_name", "width", "height"):
            if key not in img:
                rep.errors.append(
                    f"image record missing '{key}': {img}")
                return rep
        if img["id"] in ids_seen:
            rep.errors.append(f"duplicate image id {img['id']}")
        ids_seen.add(img["id"])
        if check_files and img_dir.is_dir():
            p = img_dir / img["file_name"]
            if not p.is_file():
                rep.errors.append(f"listed image missing on disk: {p}")

    for ann in coco["annotations"]:
        rep.n_annotations += 1
        img_id = ann.get("image_id")
        if img_id not in ids_seen:
            rep.errors.append(
                f"annotation {ann.get('id')} references unknown "
                f"image_id {img_id}")
            continue
        by_image[img_id] = by_image.get(img_id, 0) + 1
        bbox = ann.get("bbox")
        if not (isinstance(bbox, (list, tuple)) and len(bbox) == 4):
            rep.errors.append(
                f"annotation {ann.get('id')}: bad bbox {bbox!r}")
            continue
        if bbox[2] <= 0 or bbox[3] <= 0:
            rep.warnings.append(
                f"annotation {ann.get('id')}: degenerate bbox {bbox}")
        seg = ann.get("segmentation")
        if isinstance(seg, dict):
            # Uncompressed RLE {counts: [...], size: [h, w]} — the
            # tiling preprocessor converts these (data/tiling.py:87-98).
            if "counts" not in seg or "size" not in seg:
                rep.errors.append(
                    f"annotation {ann.get('id')}: RLE without "
                    f"counts/size")
            else:
                rep.n_rle += 1
        elif isinstance(seg, list) and seg and \
                isinstance(seg[0], (list, tuple)):
            if any(len(p) < 6 or len(p) % 2 for p in seg):
                rep.errors.append(
                    f"annotation {ann.get('id')}: polygon with <3 "
                    f"points or odd length")
            else:
                rep.n_polygon += 1
        else:
            rep.errors.append(
                f"annotation {ann.get('id')}: segmentation neither "
                f"polygon list nor RLE dict: {type(seg).__name__}")

    if by_image:
        rep.instances_per_image_max = max(by_image.values())
    images_without = ids_seen - set(by_image)
    if images_without:
        rep.warnings.append(
            f"{len(images_without)} images carry no annotations")
    return rep


def validate_tree(data_dir: str, check_files: bool = True
                  ) -> List[SplitReport]:
    root = Path(data_dir)
    return [validate_split(root, s, check_files) for s in SPLITS]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Validate a LIVECell source tree before tiling")
    parser.add_argument("--data_dir", type=str, default="data")
    parser.add_argument("--no_check_files", action="store_true",
                        help="skip per-image disk existence checks "
                             "(fast mode for huge trees)")
    args = parser.parse_args(argv)

    reports = validate_tree(args.data_dir,
                            check_files=not args.no_check_files)
    failed = False
    for rep in reports:
        status = "OK" if rep.ok else "FAIL"
        print(f"[{status}] {rep.split}: {rep.n_images} images, "
              f"{rep.n_annotations} annotations "
              f"({rep.n_polygon} polygon / {rep.n_rle} RLE), "
              f"max {rep.instances_per_image_max} instances/image")
        for w in rep.warnings[:10]:
            print(f"    warning: {w}")
        for e in rep.errors[:20]:
            print(f"    error: {e}")
            failed = True
    if failed:
        print("Schema validation FAILED — fix the tree before tiling.")
        return 1
    print("Schema validation passed.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
