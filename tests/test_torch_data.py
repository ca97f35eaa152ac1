"""The port's host data path vs the JAX package's, on the CPU: the RLE
codec and the polygon raster (the C++ routines and the numpy ones), the
COCO index, the PNG encoder and decoder, the tiler, the schema
validator and the prefetcher. Every comparison here is exact: the same
bytes, pixels, JSON and reports."""

import json
import shutil
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from livecell_tpu.data import coco as jcoco
from livecell_tpu.data.png import encode_gray_png as j_encode_png
from livecell_tpu.data.tiling import LIVECellPreprocessor as JaxTiler
from livecell_tpu.data.validate import validate_tree as j_validate_tree
from livecell_tpu.utils.prefetch import prefetch as j_prefetch
from livecell_tpu_torch import native
from livecell_tpu_torch.data import coco
from livecell_tpu_torch.data.png import (
    decode_png, encode_gray_png, read_png, write_gray_png)
from livecell_tpu_torch.data.tiling import LIVECellPreprocessor, tile_frame
from livecell_tpu_torch.data.validate import validate_tree
from livecell_tpu_torch.utils.prefetch import prefetch
from tests.util_fakedata import make_fake_livecell


def masks(rng):
    """Random masks, and the edge cases of a run codec."""
    out = [(rng.uniform(size=(37, 23)) > p).astype(np.uint8)
           for p in (0.3, 0.7, 0.95)]
    out += [np.zeros((5, 4), np.uint8), np.ones((3, 3), np.uint8),
            np.eye(6, 9, dtype=np.uint8), np.ones((1, 7), np.uint8)]
    first = np.zeros((4, 6), np.uint8)
    first[0, 0] = 1
    return out + [first]


def test_rle_codec_matches_jax(rng):
    for m in masks(rng):
        enc = coco.rle_encode(m)
        assert enc == jcoco.rle_encode(m)
        np.testing.assert_array_equal(coco.rle_decode(enc),
                                      jcoco.rle_decode(enc))
        np.testing.assert_array_equal(coco.rle_decode(enc), m)
        s = coco._counts_to_rle_string(enc["counts"])
        assert s == jcoco._counts_to_rle_string(enc["counts"])
        assert coco._rle_string_to_counts(s) == \
            jcoco._rle_string_to_counts(s) == enc["counts"]
        np.testing.assert_array_equal(
            coco.rle_decode({"size": enc["size"], "counts": s}), m)


def test_native_rle_matches_jax(rng):
    assert native.backend() == "cpp"
    for m in masks(rng):
        want = jcoco.rle_encode(m)
        counts = native.rle_encode(m)
        assert counts.tolist() == want["counts"]
        np.testing.assert_array_equal(
            native.rle_decode(counts, *m.shape), jcoco.rle_decode(want))


def edge_polygons(rng):
    """Random polygons and the cases a scanline fill gets wrong first."""
    polys = [rng.uniform(-5, 45, size=2 * rng.integers(3, 14))
             for _ in range(12)]
    polys += [
        np.array([1, 1, 5, 1, 5, 4, 1, 4.]),             # pixel-edge box
        np.array([0.5, 0.5, 6.5, 0.5, 6.5, 3.5, 0.5, 3.5]),  # on centers
        np.array([-10, -10, 60, -10, 60, 60, -10, 60.]),  # covers all
        np.array([0, 0, 50, 0, 50, 40, 0, 40.]),          # the border
        np.array([60, 60, 80, 60, 80, 90.]),              # outside
        np.array([3, 3, 9, 3, 15, 3.]),                   # collinear
        np.array([2, 2, 20, 20, 2, 20, 20, 2.]),          # bow tie
        np.array([10.5, 2, 30.25, 2, 30.25, 2.5, 10.5, 2.5]),  # sub-row
        np.array([5, 5, 8, 5.]),                          # < 3 points
    ]
    return polys


@pytest.mark.parametrize("route", ["cpp", "numpy"])
def test_polygons_to_mask_matches_jax(rng, monkeypatch, route):
    if route == "numpy":
        monkeypatch.setattr(native, "library", lambda: None)
    assert native.backend() == route
    h, w = 40, 50
    polys = edge_polygons(rng)
    for p in polys:
        want = jcoco._rasterize_one(np.asarray(p, np.float64), h, w)
        if route == "cpp" and len(p) >= 6:
            np.testing.assert_array_equal(native.rasterize_polygon(p, h, w),
                                          want)
        np.testing.assert_array_equal(coco._rasterize_one(p, h, w), want)
        np.testing.assert_array_equal(
            coco.polygons_to_mask([p.tolist()], h, w),
            jcoco.polygons_to_mask([p.tolist()], h, w))
    union = [p.tolist() for p in polys[:5]]
    np.testing.assert_array_equal(coco.polygons_to_mask(union, h, w),
                                  jcoco.polygons_to_mask(union, h, w))
    ann = {"segmentation": union}
    np.testing.assert_array_equal(coco.ann_to_mask(ann, h, w),
                                  jcoco.ann_to_mask(ann, h, w))
    rle = {"segmentation": coco.rle_encode(
        coco.polygons_to_mask(union, h, w))}
    np.testing.assert_array_equal(coco.ann_to_mask(rle, h, w),
                                  jcoco.ann_to_mask(rle, h, w))


def test_native_library_builds_to_a_temporary_name(tmp_path, monkeypatch):
    """A build writes a temporary file and renames it into place, so a
    process never loads another's half-written library; a failed build
    leaves nothing behind and the numpy routines serve."""
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    path = native.library_path()
    assert path.parent == tmp_path / "build"
    assert native._build(path) and path.exists()
    assert not list(path.parent.glob("*.tmp"))
    monkeypatch.setattr(native, "FLAGS", ["-O3", "--no-such-flag"])
    bad = native.library_path()
    assert bad != path and not native._build(bad)
    assert not bad.exists() and not list(bad.parent.glob("*.tmp"))


# ---------------------------------------------------------------------------
# PNG.
# ---------------------------------------------------------------------------

def paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def filtered_png(arr: np.ndarray, ftype: int, ctype: int) -> bytes:
    """A PNG of `arr` ([H, W, C] uint8) whose every scanline is written
    with filter `ftype`, built here with zlib (PNG spec, section 9)."""
    h, w, ch = arr.shape
    x = arr.reshape(h, w * ch).astype(np.int64)
    rows = []
    for y in range(h):
        cur, prev = x[y], (x[y - 1] if y else np.zeros_like(x[y]))
        out = []
        for i in range(w * ch):
            a = cur[i - ch] if i >= ch else 0
            b = prev[i]
            c = prev[i - ch] if i >= ch else 0
            pred = [0, a, b, (a + b) // 2, paeth(a, b, c)][ftype]
            out.append((cur[i] - pred) & 0xFF)
        rows.append(bytes([ftype] + out))

    def chunk(typ, data):
        return struct.pack(">I", len(data)) + typ + data + struct.pack(
            ">I", zlib.crc32(typ + data))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def pil_rgb(data: bytes) -> np.ndarray:
    import io

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("ctype", [0, 2, 6])
def test_png_decoder_every_filter_type(rng, ftype, ctype):
    ch = {0: 1, 2: 3, 6: 4}[ctype]
    # Smooth rows with noise: every predictor term matters somewhere.
    arr = (np.cumsum(rng.integers(0, 40, (9, 13, ch)), axis=1)
           + rng.integers(0, 256, (9, 1, ch))).astype(np.uint8)
    data = filtered_png(arr, ftype, ctype)
    got = decode_png(data)
    assert got.shape == (9, 13, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, pil_rgb(data))
    np.testing.assert_array_equal(
        got, np.repeat(arr, 3, axis=2) if ch == 1 else arr[..., :3])


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "LA", "RGBA"])
def test_png_decoder_matches_pil_written_files(tmp_path, rng, mode):
    ch = {"L": 1, "RGB": 3, "P": 3, "LA": 2, "RGBA": 4}[mode]
    arr = (np.cumsum(rng.integers(0, 9, (31, 45, ch)), axis=0)
           % 256).astype(np.uint8)
    im = Image.fromarray(arr[..., 0] if ch == 1 else arr,
                         "RGB" if mode == "P" else mode)
    if mode == "P":
        im = im.convert("P")
    path = tmp_path / f"{mode}.png"
    im.save(path)
    with Image.open(path) as back:
        assert back.mode == mode
        want = np.asarray(back.convert("RGB"))
    np.testing.assert_array_equal(read_png(path), want)


def test_png_decoder_refuses_interlaced_and_16_bit():
    arr = np.zeros((4, 5, 1), np.uint8)
    data = bytearray(filtered_png(arr, 0, 0))
    ihdr = data.index(b"IHDR") + 4
    for offset, value, what in ((8, 16, "bit depth"), (12, 1, "interlaced")):
        bad = bytearray(data)
        bad[ihdr + offset] = value
        with pytest.raises(ValueError, match=what):
            decode_png(bytes(bad))


@pytest.mark.parametrize("level", [1, 6, 9])
def test_png_encoder_matches_jax(tmp_path, rng, level):
    arr = rng.integers(0, 256, (222, 300)).astype(np.uint8)
    data = encode_gray_png(arr, level)
    assert data == j_encode_png(arr, level)
    np.testing.assert_array_equal(decode_png(data)[..., 0], arr)
    write_gray_png(tmp_path / "t.png", arr, level)
    assert (tmp_path / "t.png").read_bytes() == data
    with pytest.raises(ValueError):
        encode_gray_png(arr.astype(np.int32))


# ---------------------------------------------------------------------------
# Tiler.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """A LIVECell-statistics source tree of 4/1/2 frames; one training
    frame is tinted, so its tiles go through the RGB branch."""
    src = make_fake_livecell(tmp_path_factory.mktemp("src"),
                             images_per_split=(4, 1, 2), stats="livecell",
                             mean_instances=40, seed=1)
    frame = sorted((src / "train" / "images").iterdir())[1]
    with Image.open(frame) as im:
        g = np.asarray(im.convert("L"))
    Image.fromarray(np.stack([g, g // 2, 255 - g], axis=2)).save(frame)
    return src


def tree_files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_tiler_matches_jax(source, tmp_path):
    JaxTiler(str(source), str(tmp_path / "jax"), total_images=7).preprocess()
    LIVECellPreprocessor(str(source), str(tmp_path / "port"),
                         total_images=7).preprocess()
    want, got = tree_files(tmp_path / "jax"), tree_files(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert len([k for k in got if k.endswith(".png")]) == 7 * 25
    for k in want:
        assert got[k] == want[k], k
    train = json.loads(got["annotations/livecell_coco_train.json"])
    assert len(train["images"]) == 100 and len(train["annotations"]) > 100


def test_tile_frame_is_the_tiler_body(source, tmp_path):
    """tile_frame on a decoded frame gives the tiler's tiles and records,
    ids counted from `first_id`."""
    info = json.loads((source / "annotations" / "livecell_coco_test.json")
                      .read_text())
    img = info["images"][0]
    anns = [a for a in info["annotations"] if a["image_id"] == img["id"]]
    with Image.open(source / "test" / "images" / img["file_name"]) as im:
        arr = np.asarray(im.convert("RGB"))
    recs = tile_frame(arr, img, anns, tmp_path / "tiles", 100)
    assert [r["id"] for r in recs] == list(range(101, 126))
    pre = LIVECellPreprocessor(str(source), str(tmp_path / "out"))
    counter = {"test": 100}
    want = pre.process_image(img, anns, counter, "test")
    assert counter["test"] == 125 and recs == want
    for r in recs:
        assert (tmp_path / "tiles" / r["file_name"]).read_bytes() == \
            (tmp_path / "out" / "test" / "images" / r["file_name"]
             ).read_bytes()


# ---------------------------------------------------------------------------
# Validator and prefetcher.
# ---------------------------------------------------------------------------

def broken_tree(source, root):
    """A copy of the source tree with one fault of each kind."""
    shutil.copytree(source, root)
    next((root / "train" / "images").iterdir()).unlink()
    p = root / "annotations" / "livecell_coco_val.json"
    d = json.loads(p.read_text())
    d["annotations"][0]["bbox"] = [1, 2, 3]
    d["annotations"][1]["segmentation"] = [[1, 2, 3, 4, 5]]
    d["annotations"][2]["segmentation"] = {"counts": [4, 2], "size": [2, 3]}
    d["annotations"][3]["segmentation"] = {"counts": [4, 2]}
    d["annotations"][4]["bbox"][2] = 0
    d["annotations"][5]["image_id"] = 999
    d["categories"].append({"id": 2, "name": "other"})
    p.write_text(json.dumps(d))
    (root / "annotations" / "livecell_coco_test.json").write_text("{")
    return root


def test_validate_matches_jax(source, tmp_path):
    for root in (source, broken_tree(source, tmp_path / "broken")):
        for check_files in (True, False):
            got = validate_tree(str(root), check_files)
            want = j_validate_tree(str(root), check_files)
            assert [vars(r) for r in got] == [vars(r) for r in want]
    assert not all(r.ok for r in got)


def test_prefetch_keeps_order_and_raises_after_the_items():
    assert list(prefetch(iter(range(50)), size=3)) == list(range(50)) == \
        list(j_prefetch(iter(range(50)), size=3))

    def failing():
        yield 1
        yield 2
        raise KeyError("boom")

    got = []
    with pytest.raises(KeyError, match="boom"):
        for x in prefetch(failing()):
            got.append(x)
    assert got == [1, 2]
