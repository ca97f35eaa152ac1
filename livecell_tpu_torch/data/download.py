"""LIVECell dataset downloader (counterpart of
livecell_tpu/data/download.py: the same sources, output layout and CLI).

Three COCO annotation JSONs plus images.zip from the LIVECell S3 bucket,
extracted and organized into <dest>/{train,val,test}/images by
membership in the train/val annotation files. Files are fetched with
urllib.request (the standard library), so the downloader needs neither
requests nor tqdm; progress is printed every 10%.

Usage: python -m livecell_tpu_torch.data.download [--dest data]
"""

from __future__ import annotations

import argparse
import json
import shutil
import urllib.request
import zipfile
from pathlib import Path

ANNOTATION_BASE_URL = (
    "https://livecell-dataset.s3.eu-central-1.amazonaws.com/"
    "LIVECell_dataset_2021/annotations/LIVECell")
IMAGES_URL = ("http://livecell-dataset.s3.eu-central-1.amazonaws.com/"
              "LIVECell_dataset_2021/images.zip")
ANNOTATIONS = {
    s: f"{ANNOTATION_BASE_URL}/livecell_coco_{s}.json"
    for s in ("train", "val", "test")}


def download_file(url: str, destination: Path, description: str = "",
                  chunk: int = 1 << 20):
    """Stream `url` into `destination`, printing progress in tenths of
    the announced length. The file is written under a temporary name and
    renamed when complete, so an interrupted download leaves no file
    that a later run would take as done."""
    destination = Path(destination)
    tmp = destination.with_name(destination.name + ".part")
    name = description or destination.name
    with urllib.request.urlopen(url) as response, open(tmp, "wb") as f:
        total = int(response.headers.get("content-length") or 0)
        done, shown = 0, 0
        while True:
            block = response.read(chunk)
            if not block:
                break
            done += f.write(block)
            if total and done * 10 // total > shown:
                shown = done * 10 // total
                print(f"  {name}: {done / 2**20:.1f} of "
                      f"{total / 2**20:.1f} MiB")
    tmp.replace(destination)
    print(f"  {name}: {done / 2**20:.1f} MiB")


def download_annotations(base: Path, annotations=None):
    ann_dir = base / "annotations"
    ann_dir.mkdir(parents=True, exist_ok=True)
    for split, url in (annotations or ANNOTATIONS).items():
        dest = ann_dir / f"livecell_coco_{split}.json"
        if dest.exists():
            print(f"{dest.name} already exists, skipping")
            continue
        download_file(url, dest, f"{split} annotations")


def organize_images(base: Path, tmp: Path):
    """Split extracted images into train/val/test by annotation membership
    (reference download_data.py:80-135)."""
    train_val = tmp / "images" / "livecell_train_val_images"
    test = tmp / "images" / "livecell_test_images"
    if not train_val.exists() or not test.exists():
        train_val = tmp / "livecell_train_val_images"
        test = tmp / "livecell_test_images"

    for split in ("train", "val", "test"):
        (base / split / "images").mkdir(parents=True, exist_ok=True)

    if test.exists():
        dest = base / "test" / "images"
        for img in test.glob("*"):
            if img.is_file():
                shutil.move(str(img), str(dest / img.name))

    membership = {}
    for split in ("train", "val"):
        p = base / "annotations" / f"livecell_coco_{split}.json"
        if p.exists():
            with open(p) as f:
                names = {img["file_name"] for img in json.load(f)["images"]}
            membership[split] = names

    if train_val.exists():
        for img in train_val.glob("*"):
            if not img.is_file():
                continue
            for split, names in membership.items():
                if img.name in names:
                    shutil.move(str(img),
                                str(base / split / "images" / img.name))
                    break


def download_and_extract_images(base: Path, url: str = IMAGES_URL):
    zip_path = base / "images.zip"
    if not zip_path.exists():
        download_file(url, zip_path, "images.zip")
    tmp = base / "temp_images"
    with zipfile.ZipFile(zip_path) as z:
        z.extractall(tmp)
    organize_images(base, tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    zip_path.unlink(missing_ok=True)


def main(argv=None, annotations=None, images_url: str = IMAGES_URL):
    """The CLI. `annotations` ({split: url}) and `images_url` replace the
    bucket's URLs, as a mirror or a local file:// tree would."""
    parser = argparse.ArgumentParser(description="LIVECell downloader")
    parser.add_argument("--dest", type=str, default="data")
    parser.add_argument("--annotations_only", action="store_true")
    args = parser.parse_args(argv)

    base = Path(args.dest)
    base.mkdir(parents=True, exist_ok=True)
    download_annotations(base, annotations)
    if not args.annotations_only:
        download_and_extract_images(base, images_url)
    print(f"Dataset saved to {base.resolve()}")


if __name__ == "__main__":
    main()
