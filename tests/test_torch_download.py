"""The port's LIVECell downloader and DVC pointers
(livecell_tpu_torch/data/download.py, data/dvc.py) against the JAX
package's, on local trees and file:// URLs only (nothing is fetched from
a network)."""

import json
import shutil
import zipfile
from pathlib import Path

import pytest

from livecell_tpu.data import download as jdl
from livecell_tpu.data import dvc as jdvc
from livecell_tpu_torch.data import download as dl
from livecell_tpu_torch.data import dvc


def make_tree(root: Path) -> Path:
    d = root / "data_split"
    (d / "sub" / "deeper").mkdir(parents=True)
    (d / "a.txt").write_bytes(b"hello")
    (d / "sub" / "b.bin").write_bytes(b"\x00" * 100)
    (d / "sub" / "deeper" / "c.json").write_text('{"x": 1}')
    return d


def test_pointers_and_hashes_match_jax(tmp_path):
    """tests/test_dvc.py's cases, byte for byte against the JAX package."""
    d = make_tree(tmp_path)
    assert dvc.dir_manifest(d) == jdvc.dir_manifest(d)
    assert dvc.dir_hash(dvc.dir_manifest(d)) == \
        jdvc.dir_hash(jdvc.dir_manifest(d))
    assert dvc.make_pointer(d) == jdvc.make_pointer(d)
    f = d / "a.txt"
    assert dvc.file_md5(f) == jdvc.file_md5(f)
    assert dvc.make_pointer(f) == jdvc.make_pointer(f)
    (d / "a.txt").write_bytes(b"hello2")
    assert dvc.make_pointer(d) == jdvc.make_pointer(d)

    port_cfg = dvc.write_dvc_config(tmp_path / "port", "gdrive://folder123")
    jax_cfg = jdvc.write_dvc_config(tmp_path / "jax", "gdrive://folder123")
    assert port_cfg.read_bytes() == jax_cfg.read_bytes()

    assert dvc.write_pointer(d).read_bytes() == \
        jdvc.make_pointer(d).encode()


def test_dvc_cli_matches_jax(tmp_path, capsys):
    """tests/test_validate.py:85's case on both CLIs."""
    d = make_tree(tmp_path)
    assert dvc.main(["--path", str(d), "--out",
                     str(tmp_path / "port.dvc")]) == 0
    assert jdvc.main(["--path", str(d), "--out",
                      str(tmp_path / "jax.dvc")]) == 0
    text = (tmp_path / "port.dvc").read_text()
    assert "md5:" in text and ".dir" in text and "nfiles:" in text
    assert text == (tmp_path / "jax.dvc").read_text()
    with pytest.raises(SystemExit):
        dvc.main(["--path", str(tmp_path / "missing")])


NAMES = {"train": ["A172_1.tif", "A172_2.tif"], "val": ["BV2_1.tif"],
         "test": ["SkBr3_1.tif", "SkBr3_2.tif"], "none": ["Huh7_9.tif"]}


def make_source(root: Path, nested: bool) -> Path:
    """A LIVECell-shaped source: annotation JSONs and images.zip with the
    train/val and test folders (under images/ or at the top)."""
    src = root / "src"
    (src / "annotations").mkdir(parents=True)
    for split in ("train", "val", "test"):
        (src / "annotations" / f"livecell_coco_{split}.json").write_text(
            json.dumps({"images": [{"id": i, "file_name": n} for i, n in
                                   enumerate(NAMES[split])],
                        "annotations": [], "categories": []}))
    prefix = "images/" if nested else ""
    with zipfile.ZipFile(src / "images.zip", "w") as z:
        for split, names in NAMES.items():
            folder = "livecell_test_images" if split == "test" else \
                "livecell_train_val_images"
            for n in names:
                z.writestr(f"{prefix}{folder}/{n}", f"pixels of {n}")
    return src


def tree(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("nested", [True, False])
def test_organize_images_matches_jax(tmp_path, nested):
    src = make_source(tmp_path, nested)
    out = {}
    for name, mod in (("port", dl), ("jax", jdl)):
        base = tmp_path / name
        shutil.copytree(src / "annotations", base / "annotations")
        shutil.copy(src / "images.zip", base / "images.zip")
        mod.download_and_extract_images(base)
        out[name] = tree(base)
    assert out["port"] == out["jax"]
    assert "train/images/A172_1.tif" in out["port"]
    assert "val/images/BV2_1.tif" in out["port"]
    assert "test/images/SkBr3_2.tif" in out["port"]
    assert not any("Huh7" in k for k in out["port"])
    assert "images.zip" not in out["port"]


def test_download_file_and_main_on_file_urls(tmp_path, capsys):
    src = make_source(tmp_path, nested=True)
    dest = tmp_path / "copy.zip"
    dl.download_file((src / "images.zip").as_uri(), dest)
    assert dest.read_bytes() == (src / "images.zip").read_bytes()
    assert not dest.with_name("copy.zip.part").exists()

    anns = {s: (src / "annotations" / f"livecell_coco_{s}.json").as_uri()
            for s in ("train", "val", "test")}
    base = tmp_path / "data"
    dl.main(["--dest", str(base)], annotations=anns,
            images_url=(src / "images.zip").as_uri())
    got = tree(base)
    assert got["annotations/livecell_coco_val.json"] == \
        (src / "annotations" / "livecell_coco_val.json").read_bytes()
    assert got["train/images/A172_2.tif"] == b"pixels of A172_2.tif"
    assert "Dataset saved to" in capsys.readouterr().out
    # A second run keeps the annotations it has.
    dl.main(["--dest", str(base), "--annotations_only"], annotations=anns)
    assert "already exists, skipping" in capsys.readouterr().out


def test_downloader_keeps_jax_sources():
    assert dl.ANNOTATIONS == jdl.ANNOTATIONS
    assert dl.IMAGES_URL == jdl.IMAGES_URL
