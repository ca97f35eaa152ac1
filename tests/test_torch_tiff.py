"""The port's TIFF reader (livecell_tpu_torch/data/tiff.py) against PIL:
`decode_tiff` must give PIL's `Image.open(p).convert("RGB")` bit for bit
on every file PIL writes here (raw, LZW, PackBits and both Deflate
tags; one strip and many; Predictor 2), on hand-made files PIL does not
write (big-endian, no RowsPerStrip, white-is-zero), on the repo's own
TIFF writers (tools/synth_splits.write_gray_tiff, and the PIL-drawn
frames of tests/util_fakedata.make_fake_livecell, which the JAX tests
tile), and raise on what it does not read: UnsupportedImage on a form
it does not read (the tiler then stops), ValueError on a file that does
not decode (the tiler skips it). The C++ LZW loop is held against its
Python version."""

import io
import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from livecell_tpu_torch import native
from livecell_tpu_torch.data import tiff
from livecell_tpu_torch.data.png import (
    UnsupportedImage, encode_gray_png, read_png, write_gray_png)
from livecell_tpu_torch.data.tiling import LIVECellPreprocessor, read_frame
from livecell_tpu_torch.tools.synth_splits import write_gray_tiff
from tests.util_fakedata import make_fake_livecell

ROOT = Path(__file__).resolve().parent.parent
H, W = 520, 704
COMPRESSIONS = ("raw", "tiff_lzw", "packbits", "tiff_deflate",
                "tiff_adobe_deflate")


def frame(kind: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (H, W) if kind == "grey" else (H, W, 3)
    return rng.integers(0, 256, shape, dtype=np.uint8)


def pil_tiff(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="TIFF", **kw)
    return buf.getvalue()


def pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def hand_tiff(arr: np.ndarray, order: str = "<", rows_per_strip=None,
              photometric: int = 1) -> bytes:
    """An uncompressed grey TIFF in byte order `order`, in strips of
    `rows_per_strip` rows (None: no RowsPerStrip tag, one strip)."""
    h, w = arr.shape
    rps = h if rows_per_strip is None else rows_per_strip
    strips = [arr[i:i + rps].tobytes() for i in range(0, h, rps)]
    n = len(strips)
    offsets, at = [], 8
    for s in strips:
        offsets.append(at)
        at += len(s)
    arrays_at = at
    ifd_at = arrays_at + 8 * n
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8]), (259, 3, [1]),
            (262, 3, [photometric]), (273, 4, offsets), (277, 3, [1])]
    if rows_per_strip is not None:
        tags.append((278, 4, [rps]))
    tags.append((279, 4, [len(s) for s in strips]))
    out = [b"II*\x00" if order == "<" else b"MM\x00*",
           struct.pack(order + "I", ifd_at), *strips,
           struct.pack(f"{order}{n}I", *offsets),
           struct.pack(f"{order}{n}I", *[len(s) for s in strips]),
           struct.pack(order + "H", len(tags))]
    for tag, typ, vals in tags:
        if len(vals) > 1:
            where = arrays_at if tag == 273 else arrays_at + 4 * n
            out.append(struct.pack(order + "HHII", tag, typ, len(vals),
                                   where))
        elif typ == 3:
            out.append(struct.pack(order + "HHIH2x", tag, typ, 1, vals[0]))
        else:
            out.append(struct.pack(order + "HHII", tag, typ, 1, vals[0]))
    out.append(struct.pack(order + "I", 0))
    return b"".join(out)


def synth_tiff(tmp_path) -> bytes:
    p = tmp_path / "synth.tif"
    write_gray_tiff(p, frame("grey", 3))
    return p.read_bytes()


def fakedata_tiff(tmp_path) -> bytes:
    make_fake_livecell(tmp_path / "src", images_per_split=(1, 0, 0))
    return (tmp_path / "src" / "train" / "images" /
            "A172_Phase_train_000.tif").read_bytes()


CASES = {}
for _kind in ("grey", "rgb"):
    for _comp in COMPRESSIONS:
        CASES[f"{_kind}-{_comp}-one-strip"] = (
            lambda tmp, k=_kind, c=_comp: pil_tiff(frame(k), compression=c))
        CASES[f"{_kind}-{_comp}-strips"] = (
            lambda tmp, k=_kind, c=_comp: pil_tiff(
                frame(k, 1), compression=c, strip_size=16 * W))
    for _comp in ("tiff_lzw", "tiff_deflate"):
        CASES[f"{_kind}-{_comp}-predictor2"] = (
            lambda tmp, k=_kind, c=_comp: pil_tiff(
                frame(k, 2), compression=c, tiffinfo={317: 2}))
CASES.update({
    "big-endian-strips": lambda tmp: hand_tiff(frame("grey", 4), ">", 7),
    "no-rows-per-strip": lambda tmp: hand_tiff(frame("grey", 5), ">"),
    "white-is-zero": lambda tmp: hand_tiff(frame("grey", 6), "<", 100, 0),
    "synth_splits.write_gray_tiff": synth_tiff,
    "util_fakedata.make_fake_livecell": fakedata_tiff,
})


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_tiff_equals_pil(case, tmp_path):
    data = CASES[case](tmp_path)
    got = tiff.decode_tiff(data)
    want = pil_rgb(data)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    assert np.array_equal(got, want)
    if case.startswith(("grey-", "rgb-")) and case.endswith("-strips") \
            and "raw" not in case:
        # strip_size counts bytes: 16 grey rows, 5 RGB rows a strip.
        strips = len(tiff._read_ifd(data)[tiff.STRIP_OFFSETS])
        assert strips == (33 if case.startswith("grey") else 104)


def bad_cases():
    grey16 = np.random.default_rng(0).integers(0, 65536, (H, W),
                                              dtype=np.uint16)
    pal = Image.fromarray(frame("grey")).convert("P")
    pbuf = io.BytesIO()
    pal.save(pbuf, format="TIFF")
    raw = pil_tiff(frame("grey"), compression="raw")
    lzw = pil_tiff(frame("grey"), compression="tiff_lzw")
    return {
        "jpeg": (pil_tiff(frame("rgb"), compression="jpeg"), "259"),
        "16-bit": (pil_tiff(grey16), "258"),
        "palette": (pbuf.getvalue(), "262"),
        "truncated-raw": (truncated_bytes(raw), "truncated"),
        "truncated-lzw": (truncated_bytes(lzw), "truncated"),
        "not-a-tiff": (b"\x89PNG\r\n\x1a\n" + bytes(64), "byte order"),
    }


def truncated_bytes(data: bytes) -> bytes:
    """`data` with its last strip cut in half. A directory that PIL
    wrote after the strips is kept: it moves to the cut."""
    order = "<"
    at = struct.unpack(order + "I", data[4:8])[0]
    n = struct.unpack(order + "H", data[at:at + 2])[0]
    tags = tiff._read_ifd(data)
    offsets, counts = tags[tiff.STRIP_OFFSETS], tags[tiff.STRIP_BYTES]
    end = offsets[-1] + counts[-1] // 2
    if at < offsets[0]:
        return data[:end]
    tail = bytearray(data[at:])
    shift = end - at
    # Out-of-line values of the directory move with it.
    for i in range(n):
        e = 2 + 12 * i
        tag, typ, count = struct.unpack(order + "HHI", tail[e:e + 8])
        size = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8}.get(typ, 4) * count
        if size > 4:
            (off,) = struct.unpack(order + "I", tail[e + 8:e + 12])
            if off >= at:
                tail[e + 8:e + 12] = struct.pack(order + "I", off + shift)
    return data[:4] + struct.pack(order + "I", end) + data[8:end] + bytes(tail)


@pytest.mark.parametrize("case", ["jpeg", "16-bit", "palette",
                                  "truncated-raw", "truncated-lzw",
                                  "not-a-tiff"])
def test_unsupported_tiff_raises(case):
    """A form the reader does not read raises UnsupportedImage (which
    stops the tiler); a file that does not decode raises a plain
    ValueError (which the tiler skips)."""
    data, words = bad_cases()[case]
    if case == "jpeg":
        assert tiff._read_ifd(data)[tiff.COMPRESSION] == [7]
    with pytest.raises(ValueError, match=words) as e:
        tiff.decode_tiff(data)
    assert isinstance(e.value, UnsupportedImage) == (
        case in ("jpeg", "16-bit", "palette"))


@pytest.mark.parametrize("case", ["16-bit tiff", "interlaced png"])
def test_unsupported_frame_stops_the_tiling_child(case, tmp_path):
    """`python -m livecell_tpu_torch.data.tiling` exits non-zero, naming
    the file and the tag, when a source frame is in a form the port's
    readers do not read; nothing is skipped in silence."""
    src = tmp_path / "src"
    make_fake_livecell(src, images_per_split=(2, 0, 0))
    bad = src / "train" / "images" / "A172_Phase_train_001.tif"
    if case == "16-bit tiff":
        grey16 = np.random.default_rng(1).integers(0, 65536, (H, W),
                                                  dtype=np.uint16)
        bad.write_bytes(pil_tiff(grey16))
        words = "258"
    else:
        # The frame stored as a PNG under a .png name, which the
        # annotations then point at, its IHDR marked interlaced (PIL
        # writes no interlaced PNG).
        png = bad.with_suffix(".png")
        data = bytearray(encode_gray_png(frame("grey", 3)))
        data[28] = 1
        data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
        png.write_bytes(bytes(data))
        with pytest.raises(UnsupportedImage, match="interlaced"):
            read_png(png)
        bad.unlink()
        ann = src / "annotations" / "livecell_coco_train.json"
        ann.write_text(ann.read_text().replace(bad.name, png.name))
        bad, words = png, "interlaced"
    r = subprocess.run(
        [sys.executable, "-m", "livecell_tpu_torch.data.tiling",
         "--source_dir", str(src), "--output_dir", str(tmp_path / "out"),
         "--num_images_per_split", "10"],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode != 0, r.stdout
    assert bad.name in r.stderr and words in r.stderr, r.stderr
    assert "skipping" not in r.stdout


@pytest.mark.parametrize("case", sorted(k for k in CASES if "lzw" in k))
def test_lzw_routes_agree(case, tmp_path):
    """The C++ loop gives the Python loop's bytes on every strip."""
    assert native.backend() == "cpp"
    data = CASES[case](tmp_path)
    tags = tiff._read_ifd(data)
    for off, n in zip(tags[tiff.STRIP_OFFSETS], tags[tiff.STRIP_BYTES]):
        strip = data[off:off + n]
        for size in (16 * W * 3, 7):
            assert native.lzw_decode(strip, size) == \
                tiff.lzw_decode_plain(strip, size)


def test_lzw_bad_code_raises():
    # 9-bit codes: 65 ('A'), then 300, which is not yet in the table.
    bits = f"{65:09b}{300:09b}{257:09b}"
    bits += "0" * (-len(bits) % 8)
    data = int(bits, 2).to_bytes(len(bits) // 8, "big")
    for route in (native.lzw_decode, tiff.lzw_decode_plain):
        with pytest.raises(ValueError, match="300|table"):
            route(data, 100)


def test_read_frame_routes_by_extension(tmp_path, monkeypatch):
    """.tif/.tiff through data/tiff.py, .png through data/png.py, other
    files through PIL; the tiler skips a file that does not decode."""
    grey = frame("grey", 7)
    (tmp_path / "a.tiff").write_bytes(pil_tiff(grey, compression="tiff_lzw"))
    write_gray_png(tmp_path / "a.png", grey)
    Image.fromarray(grey).save(tmp_path / "a.bmp")
    want = np.repeat(grey[..., None], 3, axis=2)
    for name in ("a.tiff", "a.png", "a.bmp"):
        assert np.array_equal(read_frame(tmp_path / name), want), name
    import PIL.Image

    def no_pil(*a, **k):
        raise AssertionError("PIL opened a TIFF or PNG")

    monkeypatch.setattr(PIL.Image, "open", no_pil)
    read_frame(tmp_path / "a.tiff")
    read_frame(tmp_path / "a.png")

    make_fake_livecell(tmp_path / "src", images_per_split=(2, 0, 0))
    bad = tmp_path / "src" / "train" / "images" / "A172_Phase_train_001.tif"
    bad.write_bytes(b"II*\x00" + bytes(4))
    pre = LIVECellPreprocessor(str(tmp_path / "src"), str(tmp_path / "out"),
                               total_images=2)
    pre.preprocess()
    tiles = sorted((tmp_path / "out" / "train" / "images").glob("*.png"))
    assert len(tiles) == 25
    assert all(p.name.startswith("A172_Phase_train_000") for p in tiles)
