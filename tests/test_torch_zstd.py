"""The port's zstd decoder (native/zstd.cc) and its Python twin
(utils/zstd.py:decompress_plain) against the `zstandard` library, which
makes the frames: both must return the compressed payload bit for bit,
and raise on a truncated or corrupted frame. Also CRC-32C and XXH64
against their published check values."""

import os

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from livecell_tpu_torch import native
from livecell_tpu_torch.utils import zstd
from livecell_tpu_torch.utils.zstd import ZstdError


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.backend() == "cpp"


def decoders():
    return [("cpp", native.zstd_decompress), ("plain", zstd.decompress_plain)]


def frame(data: bytes, level=3, checksum=True, size=True) -> bytes:
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=size).compress(data)


def payload(kind: str, n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.bytes(n)
    if kind == "runs":
        vals = rng.integers(0, 4, max(n // 64, 1)).astype(np.uint8)
        return np.repeat(vals, 64).tobytes()[:n]
    if kind == "floats":
        return rng.standard_normal(n // 4).astype(np.float32).tobytes()
    if kind == "text":
        words = [b"zstd", b"frame", b"block", b"huffman", b"fse", b" ", b"\n"]
        return b"".join(words[i] for i in rng.integers(0, 7, n))[:n]
    raise ValueError(kind)


KINDS = ["random", "runs", "floats", "text"]


@settings(max_examples=25, deadline=None)
@given(data=st.one_of(
    st.binary(max_size=64),
    st.builds(payload, st.sampled_from(KINDS),
              st.integers(0, 300_000), st.integers(0, 2 ** 16))),
       level=st.sampled_from([1, 3, 19, -5]),
       checksum=st.booleans(), size=st.booleans())
def test_decoders_return_zstandards_input(data, level, checksum, size):
    f = frame(data, level, checksum, size)
    for name, dec in decoders():
        assert dec(f) == data, name


@pytest.mark.parametrize("level", [1, 3, 19, -5])
@pytest.mark.parametrize("kind", KINDS)
def test_multi_block_frames(kind, level):
    """200 KB and more: two or more blocks, repeat offsets across them,
    the previous block's tables repeated."""
    data = payload(kind, 260_000, 7)
    f = frame(data, level)
    for name, dec in decoders():
        assert dec(f) == data, name


@pytest.mark.parametrize("data", [b"", b"a", payload("random", 1000, 5)],
                         ids=["empty", "one", "incompressible"])
def test_small_payloads(data):
    for checksum in (True, False):
        for size in (True, False):
            f = frame(data, 3, checksum, size)
            for name, dec in decoders():
                assert dec(f) == data, name


def test_concatenated_and_skippable_frames():
    a, b = payload("text", 5000, 1), payload("floats", 70_000, 2)
    skip = (0x184D2A53).to_bytes(4, "little") + (3).to_bytes(4, "little") \
        + b"abc"
    f = frame(a, 1) + skip + frame(b, 19, checksum=False, size=False) + \
        frame(b"", 3)
    for name, dec in decoders():
        assert dec(f) == a + b, name


def test_window_of_a_51_mb_chunk():
    """box_head/fc1/kernel of the full-width model is one 12,544 x 1,024
    f32 chunk; level 19 reaches back past 8 MB windows."""
    rng = np.random.default_rng(0)
    block = rng.standard_normal(1 << 20).astype(np.float32).tobytes()
    data = (block * 13)[:12544 * 1024 * 4]
    f = frame(data, 19)
    assert native.zstd_decompress(f) == data


@pytest.mark.parametrize("cut", [1, 4, 5, 13, 40, -1])
def test_truncated_frames_raise(cut):
    f = frame(payload("text", 20_000, 3), 3)
    bad = f[:cut] if cut > 0 else f[:cut]
    for name, dec in decoders():
        with pytest.raises(ZstdError):
            dec(bad)


@pytest.mark.parametrize("seed", range(12))
def test_bit_flips_raise(seed):
    """A flipped bit anywhere after the magic number: the frame raises
    (a flip in the checksum, the content size or the data is caught by
    the checksum, a size check or the decoder), never returns other
    bytes."""
    data = payload("text", 30_000, seed)
    f = bytearray(frame(data, 3))
    rng = np.random.default_rng(seed)
    pos = int(rng.integers(4, len(f)))
    f[pos] ^= 1 << int(rng.integers(0, 8))
    for name, dec in decoders():
        try:
            got = dec(bytes(f))
        except ZstdError:
            continue
        pytest.fail(f"{name}: a flipped bit at byte {pos} decoded "
                    f"({got == data})")


def test_dictionary_frames_are_refused():
    d = zstandard.train_dictionary(1024, [payload("text", 300, s)
                                          for s in range(200)])
    f = zstandard.ZstdCompressor(dict_data=d).compress(b"huffman fse")
    for name, dec in decoders():
        with pytest.raises(ZstdError, match="dictionary"):
            dec(f)


def test_not_a_frame_raises():
    for name, dec in decoders():
        with pytest.raises(ZstdError, match="magic"):
            dec(b"\x00" * 16)
        with pytest.raises(ZstdError, match="empty"):
            dec(b"")


def test_crc32c_and_xxh64_check_values():
    assert native.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c_plain(b"123456789") == 0xE3069283
    data = os.urandom(4099)
    assert native.crc32c(data) == zstd.crc32c_plain(data)
    # XXH64 of the empty input and of "abc" (seed 0).
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999


def test_without_a_compiler_the_plain_routines_serve(monkeypatch):
    data = payload("floats", 50_000, 9)
    monkeypatch.setattr(native, "library", lambda: None)
    assert native.backend() == "numpy"
    assert zstd.decompress(frame(data)) == data
    assert zstd.crc32c(b"123456789") == 0xE3069283


def test_library_hash_covers_both_sources(tmp_path, monkeypatch):
    """The library's name changes with either of its sources, so an
    edited decoder is never served by an older build."""
    copies = []
    for src in native.SOURCES:
        dst = tmp_path / src.name
        dst.write_bytes(src.read_bytes())
        copies.append(dst)
    monkeypatch.setattr(native, "SOURCES", copies)
    seen = {native.library_path()}
    for dst in copies:
        dst.write_bytes(dst.read_bytes() + b"\n// edited\n")
        seen.add(native.library_path())
    assert len(seen) == 3
    assert [p.name for p in copies] == ["rasterize.cc", "zstd.cc"]
