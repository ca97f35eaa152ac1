"""Zstandard frames (RFC 8878) and CRC-32C, without a zstd library.

Orbax stores each array chunk of a checkpoint as a zstd frame and each
OCDBT node as a zstd-compressed body under a CRC-32C
(utils/ocdbt.py, utils/zarr_v2.py). `decompress` and `crc32c` run the
C++ routines of native/zstd.cc where the port's library builds;
`decompress_plain` and `crc32c_plain` are their Python versions, which
serve without a compiler (and are slow: about 1 MB/s).

Both decoders take any number of concatenated frames (skippable frames
are skipped): raw, RLE and compressed blocks, Huffman literals in 1 or 4
streams (new or repeated tables), sequences with predefined, RLE,
FSE-compressed or repeated tables, the repeat offsets, frames with and
without a content size and a content checksum (XXH64, verified). A frame
that names a dictionary is refused; a truncated or corrupt input raises
ZstdError, never a short or wrong output.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from livecell_tpu_torch import native

MAGIC = 0xFD2FB528
BLOCK_MAX = 1 << 17


class ZstdError(ValueError):
    """A zstd input that does not decode (truncated, corrupt, or using a
    feature the decoder refuses)."""


def decompress(data: bytes) -> bytes:
    """The content of the zstd frames in `data` (decompress_plain's
    result), by the C++ decoder where it builds."""
    if native.library() is None:
        return decompress_plain(data)
    return native.zstd_decompress(data)


def crc32c(data: bytes) -> int:
    """CRC-32C of `data`, by the C++ routine where it builds."""
    if native.library() is None:
        return crc32c_plain(data)
    return native.crc32c(data)


# ---------------------------------------------------------------------------
# CRC-32C and XXH64.
# ---------------------------------------------------------------------------

def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC = _crc_table()


def crc32c_plain(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC[(c ^ b) & 255] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, \
    1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64


def xxh64(data: bytes) -> int:
    """XXH64 of `data` with seed 0."""
    n, p = len(data), 0
    if n >= 32:
        v = [(_P1 + _P2) & _M64, _P2, 0, (-_P1) & _M64]
        while p + 32 <= n:
            lanes = struct.unpack_from("<4Q", data, p)
            v = [_round(a, b) for a, b in zip(v, lanes)]
            p += 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
    else:
        h = _P5
    h = (h + n) & _M64
    while p + 8 <= n:
        (lane,) = struct.unpack_from("<Q", data, p)
        h = (_rotl(h ^ _round(0, lane), 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        (lane,) = struct.unpack_from("<I", data, p)
        h = (_rotl(h ^ (lane * _P1 & _M64), 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h = _rotl(h ^ (data[p] * _P5 & _M64), 11) * _P1 & _M64
        p += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)


# ---------------------------------------------------------------------------
# Bit streams and FSE tables.
# ---------------------------------------------------------------------------

class _Forward:
    """Little-endian, least significant bit first."""

    def __init__(self, data: bytes):
        self.data, self.bit = data, 0

    def read(self, nb: int) -> int:
        if self.bit + nb > len(self.data) * 8:
            raise ZstdError("zstd: truncated FSE table description")
        b = self.bit >> 3
        w = int.from_bytes(self.data[b:b + 4], "little")
        self.bit += nb
        return (w >> ((self.bit - nb) & 7)) & ((1 << nb) - 1)


class _Backward:
    """Read backward from the end mark; bits before the start read as
    zero and the position goes negative."""

    def __init__(self, data: bytes):
        if not data:
            raise ZstdError("zstd: empty bitstream")
        if data[-1] == 0:
            raise ZstdError("zstd: bitstream without its end mark")
        self.data = data
        self.pos = len(data) * 8 - (8 - (data[-1].bit_length() - 1))

    def read(self, nb: int) -> int:
        if nb == 0:
            return 0
        self.pos -= nb
        at = self.pos
        if at < 0:
            if at + nb <= 0:
                return 0
            w = int.from_bytes(self.data[:8], "little")
            return (w & ((1 << (nb + at)) - 1)) << -at
        b = at >> 3
        w = int.from_bytes(self.data[b:b + 8], "little")
        return (w >> (at & 7)) & ((1 << nb) - 1)


def _build_fse(norm: List[int], log: int) -> List[Tuple[int, int, int]]:
    """(symbol, bits, base) of each state."""
    size = 1 << log
    high = size
    sym = [0] * size
    nxt = []
    for s, p in enumerate(norm):
        if p == -1:
            high -= 1
            sym[high] = s
            nxt.append(1)
        else:
            nxt.append(max(p, 0))
    step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, p in enumerate(norm):
        for _ in range(max(p, 0)):
            sym[pos] = s
            pos = (pos + step) & mask
            while pos >= high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("zstd: FSE distribution does not fill its table")
    table = []
    for s in sym:
        d = nxt[s]
        nxt[s] += 1
        nb = log - (d.bit_length() - 1)
        table.append((s, nb, (d << nb) - size))
    return table


def _fse_description(data: bytes, max_log: int, max_symbol: int):
    """(table, log, bytes taken) of an FSE table description."""
    fin = _Forward(data)
    log = fin.read(4) + 5
    if log > max_log:
        raise ZstdError("zstd: FSE accuracy log too large")
    norm: List[int] = []
    remaining = 1 << log
    while remaining > 0:
        if len(norm) > max_symbol:
            raise ZstdError("zstd: FSE description has too many symbols")
        nb = (remaining + 1).bit_length()
        v = fin.read(nb)
        low = (1 << (nb - 1)) - 1
        threshold = (1 << nb) - 1 - (remaining + 1)
        if v & low < threshold:
            fin.bit -= 1
            v &= low
        elif v > low:
            v -= threshold
        prob = v - 1
        remaining -= abs(prob)
        norm.append(prob)
        if prob == 0:
            while True:
                rep = fin.read(2)
                if len(norm) + rep > max_symbol + 1:
                    raise ZstdError("zstd: FSE zero run past the symbols")
                norm += [0] * rep
                if rep != 3:
                    break
    if remaining != 0:
        raise ZstdError("zstd: FSE probabilities do not sum to 1")
    return _build_fse(norm, log), log, (fin.bit + 7) >> 3


# ---------------------------------------------------------------------------
# Huffman literals.
# ---------------------------------------------------------------------------

def _huffman(data: bytes):
    """((symbols, bits, max_bits), bytes taken) of a Huffman tree
    description."""
    if not data:
        raise ZstdError("zstd: truncated Huffman tree description")
    header = data[0]
    if header < 128:
        used = 1 + header
        if used > len(data) or header == 0:
            raise ZstdError("zstd: truncated Huffman weights")
        table, log, d = _fse_description(data[1:used], 6, 255)
        if d >= header:
            raise ZstdError("zstd: Huffman weights without a bitstream")
        bits = _Backward(data[1 + d:used])
        s1, s2 = bits.read(log), bits.read(log)
        w: List[int] = []
        while True:
            if len(w) > 253:
                raise ZstdError("zstd: too many Huffman weights")
            sym, nb, base = table[s1]
            w.append(sym)
            s1 = base + bits.read(nb)
            if bits.pos < 0:
                w.append(table[s2][0])
                break
            sym, nb, base = table[s2]
            w.append(sym)
            s2 = base + bits.read(nb)
            if bits.pos < 0:
                w.append(table[s1][0])
                break
    else:
        count = header - 127
        used = 1 + (count + 1) // 2
        if used > len(data):
            raise ZstdError("zstd: truncated Huffman weights")
        w = [(data[1 + i // 2] & 15) if i & 1 else (data[1 + i // 2] >> 4)
             for i in range(count)]
    if max(w) > 11:
        raise ZstdError("zstd: Huffman weight above 11")
    total = sum(1 << (x - 1) for x in w if x)
    if total == 0:
        raise ZstdError("zstd: Huffman weights all zero")
    max_bits = total.bit_length()
    if max_bits > 11:
        raise ZstdError("zstd: Huffman table deeper than 11 bits")
    left = (1 << max_bits) - total
    if left & (left - 1):
        raise ZstdError("zstd: Huffman weights do not complete a tree")
    w.append(left.bit_length())
    nbits = [max_bits + 1 - x if x else 0 for x in w]
    rank_count = [0] * 13
    for b in nbits:
        rank_count[b] += 1
    rank_idx = [0] * 13
    size = 1 << max_bits
    sym_of = [0] * size
    bits_of = [0] * size
    for i in range(max_bits, 0, -1):
        rank_idx[i - 1] = rank_idx[i] + rank_count[i] * (1 << (max_bits - i))
        for k in range(rank_idx[i], rank_idx[i - 1]):
            bits_of[k] = i
    if rank_idx[0] != size:
        raise ZstdError("zstd: bad Huffman code lengths")
    for s, b in enumerate(nbits):
        if b:
            n = 1 << (max_bits - b)
            sym_of[rank_idx[b]:rank_idx[b] + n] = [s] * n
            rank_idx[b] += n
    return (sym_of, bits_of, max_bits), used


def _huffman_stream(huf, data: bytes, count: int) -> bytes:
    sym_of, bits_of, mb = huf
    bits = _Backward(data)
    mask = (1 << mb) - 1
    state = bits.read(mb)
    out = bytearray()
    while bits.pos > -mb:
        if len(out) == count:
            raise ZstdError("zstd: Huffman stream longer than its literals")
        out.append(sym_of[state])
        nb = bits_of[state]
        state = ((state << nb) + bits.read(nb)) & mask
    if bits.pos != -mb or len(out) != count:
        raise ZstdError("zstd: Huffman stream not consumed exactly")
    return bytes(out)


# ---------------------------------------------------------------------------
# Blocks and frames.
# ---------------------------------------------------------------------------

_LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
               2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
_ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7
_OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5
_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                              256, 512, 1024, 2048, 4096, 8192, 16384,
                              32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                 131, 259, 515, 1027, 2051, 4099, 8195,
                                 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
# (default distribution, its log, largest log, largest symbol) by kind.
_SEQ = {"ll": (_LL_DEFAULT, 6, 9, 35), "of": (_OF_DEFAULT, 5, 8, 31),
        "ml": (_ML_DEFAULT, 6, 9, 52)}


class _Frame:
    def __init__(self):
        self.huf = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.rep = [1, 4, 8]


def _seq_table(fr: _Frame, kind: str, mode: int, data: bytes, at: int
               ) -> int:
    deflt, dlog, max_log, max_sym = _SEQ[kind]
    if mode == 0:
        fr.tables[kind] = (_build_fse(deflt, dlog), dlog)
        return at
    if mode == 1:
        if at >= len(data):
            raise ZstdError("zstd: truncated RLE sequence table")
        if data[at] > max_sym:
            raise ZstdError("zstd: RLE sequence symbol out of range")
        fr.tables[kind] = ([(data[at], 0, 0)], 0)
        return at + 1
    if mode == 2:
        table, log, used = _fse_description(data[at:], max_log, max_sym)
        fr.tables[kind] = (table, log)
        return at + used
    if fr.tables[kind] is None:
        raise ZstdError("zstd: repeated sequence table without a previous")
    return at


def _literals(fr: _Frame, data: bytes) -> Tuple[bytes, int]:
    """(literals, bytes taken) of a compressed block's literals
    section."""
    if not data:
        raise ZstdError("zstd: empty compressed block")
    ltype, sf = data[0] & 3, (data[0] >> 2) & 3
    if ltype < 2:
        if sf in (0, 2):
            hsize, regen = 1, data[0] >> 3
        else:
            hsize = 2 if sf == 1 else 3
            if len(data) < hsize:
                raise ZstdError("zstd: truncated literals header")
            regen = (data[0] >> 4) + (data[1] << 4) + (
                data[2] << 12 if sf == 3 else 0)
        if regen > BLOCK_MAX:
            raise ZstdError("zstd: literals larger than a block")
        if ltype == 0:
            if hsize + regen > len(data):
                raise ZstdError("zstd: truncated raw literals")
            return data[hsize:hsize + regen], hsize + regen
        if hsize + 1 > len(data):
            raise ZstdError("zstd: truncated RLE literals")
        return bytes([data[hsize]]) * regen, hsize + 1
    hsize = 3 if sf < 2 else 4 if sf == 2 else 5
    if len(data) < hsize:
        raise ZstdError("zstd: truncated literals header")
    v = int.from_bytes(data[:hsize], "little")
    wbits = 10 if sf < 2 else 14 if sf == 2 else 18
    regen = (v >> 4) & ((1 << wbits) - 1)
    csize = (v >> (4 + wbits)) & ((1 << wbits) - 1)
    if regen > BLOCK_MAX:
        raise ZstdError("zstd: literals larger than a block")
    if hsize + csize > len(data):
        raise ZstdError("zstd: truncated compressed literals")
    q = data[hsize:hsize + csize]
    if ltype == 2:
        fr.huf, used = _huffman(q)
        q = q[used:]
    elif fr.huf is None:
        raise ZstdError("zstd: treeless literals without a previous "
                        "Huffman table")
    if sf == 0:
        return _huffman_stream(fr.huf, q, regen), hsize + csize
    if len(q) < 6:
        raise ZstdError("zstd: truncated Huffman jump table")
    s1, s2, s3 = struct.unpack_from("<3H", q)
    if 6 + s1 + s2 + s3 > len(q):
        raise ZstdError("zstd: Huffman streams past the literals")
    seg = (regen + 3) // 4
    if 3 * seg > regen:
        raise ZstdError("zstd: too few literals for four streams")
    cuts = [6, 6 + s1, 6 + s1 + s2, 6 + s1 + s2 + s3, len(q)]
    counts = [seg, seg, seg, regen - 3 * seg]
    lits = b"".join(_huffman_stream(fr.huf, q[a:b], c)
                    for a, b, c in zip(cuts, cuts[1:], counts))
    return lits, hsize + csize


def _compressed_block(fr: _Frame, data: bytes, out: bytearray,
                      start: int) -> None:
    lits, at = _literals(fr, data)
    if at >= len(data):
        raise ZstdError("zstd: truncated sequences section")
    b0 = data[at]
    if b0 < 128:
        nseq, at = b0, at + 1
    elif b0 < 255:
        if at + 2 > len(data):
            raise ZstdError("zstd: truncated sequence count")
        nseq, at = ((b0 - 128) << 8) + data[at + 1], at + 2
    else:
        if at + 3 > len(data):
            raise ZstdError("zstd: truncated sequence count")
        nseq, at = data[at + 1] + (data[at + 2] << 8) + 0x7F00, at + 3
    lit_pos = 0
    if nseq == 0:
        if at != len(data):
            raise ZstdError("zstd: bytes after a block without sequences")
    else:
        if at >= len(data):
            raise ZstdError("zstd: truncated sequence modes")
        modes = data[at]
        if modes & 3:
            raise ZstdError("zstd: reserved bits set in the sequence modes")
        at += 1
        at = _seq_table(fr, "ll", modes >> 6, data, at)
        at = _seq_table(fr, "of", (modes >> 4) & 3, data, at)
        at = _seq_table(fr, "ml", (modes >> 2) & 3, data, at)
        (llt, lll), (oft, ofl), (mlt, mll) = (
            fr.tables["ll"], fr.tables["of"], fr.tables["ml"])
        bits = _Backward(data[at:])
        sl, so, sm = bits.read(lll), bits.read(ofl), bits.read(mll)
        rep = fr.rep
        for i in range(nseq):
            lc, oc, mc = llt[sl][0], oft[so][0], mlt[sm][0]
            ov = (1 << oc) + bits.read(oc)
            ml = _ML_BASE[mc] + bits.read(_ML_BITS[mc])
            ll = _LL_BASE[lc] + bits.read(_LL_BITS[lc])
            if ov > 3:
                off = ov - 3
                rep[:] = [off, rep[0], rep[1]]
            else:
                idx = ov - 1 + (ll == 0)
                if idx == 0:
                    off = rep[0]
                else:
                    off = rep[idx] if idx < 3 else rep[0] - 1
                    if idx > 1:
                        rep[2] = rep[1]
                    rep[1] = rep[0]
                    rep[0] = off
            if i + 1 < nseq:
                _, nb, base = llt[sl]
                sl = base + bits.read(nb)
                _, nb, base = mlt[sm]
                sm = base + bits.read(nb)
                _, nb, base = oft[so]
                so = base + bits.read(nb)
            if lit_pos + ll > len(lits):
                raise ZstdError("zstd: sequence past its literals")
            out += lits[lit_pos:lit_pos + ll]
            lit_pos += ll
            if off == 0 or off > len(out) - start:
                raise ZstdError("zstd: match offset before the start of the "
                                "frame")
            s = len(out) - off
            if off >= ml:
                out += out[s:s + ml]
            else:
                for k in range(ml):
                    out.append(out[s + k])
        if bits.pos != 0:
            raise ZstdError("zstd: sequence bitstream not consumed exactly")
    out += lits[lit_pos:]


def _frame_header(data: bytes, at: int) -> Tuple[int, Optional[int], bool]:
    """(offset after the header, content size or None, has checksum) of
    the frame whose header starts at `at` (after the magic)."""
    if at >= len(data):
        raise ZstdError("zstd: truncated frame header")
    fhd = data[at]
    if fhd & 8:
        raise ZstdError("zstd: reserved bit set in the frame header")
    fcs_flag, single, did = fhd >> 6, (fhd >> 5) & 1, fhd & 3
    p = at + 1 + (0 if single else 1)
    did_size = 4 if did == 3 else did
    fcs_size = single if fcs_flag == 0 else 1 << fcs_flag
    if p + did_size + fcs_size > len(data):
        raise ZstdError("zstd: truncated frame header")
    if int.from_bytes(data[p:p + did_size], "little"):
        raise ZstdError("zstd: frame names a dictionary, which is not "
                        "supported")
    p += did_size
    fcs = None
    if fcs_size:
        fcs = int.from_bytes(data[p:p + fcs_size], "little") + (
            256 if fcs_size == 2 else 0)
    return p + fcs_size, fcs, bool(fhd & 4)


def decompress_plain(data: bytes) -> bytes:
    """The Python version of native/zstd.cc's decoder."""
    data = bytes(data)
    if not data:
        raise ZstdError("zstd: empty input")
    out = bytearray()
    at = 0
    while at < len(data):
        if len(data) - at < 4:
            raise ZstdError("zstd: truncated frame magic")
        (magic,) = struct.unpack_from("<I", data, at)
        at += 4
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            if len(data) - at < 4:
                raise ZstdError("zstd: truncated skippable frame")
            (size,) = struct.unpack_from("<I", data, at)
            if len(data) - at - 4 < size:
                raise ZstdError("zstd: truncated skippable frame")
            at += 4 + size
            continue
        if magic != MAGIC:
            raise ZstdError("zstd: not a zstd frame (bad magic number)")
        at, fcs, checksum = _frame_header(data, at)
        start = len(out)
        fr = _Frame()
        last = False
        while not last:
            if len(data) - at < 3:
                raise ZstdError("zstd: truncated block header")
            bh = int.from_bytes(data[at:at + 3], "little")
            at += 3
            last, btype, size = bh & 1, (bh >> 1) & 3, bh >> 3
            if size > BLOCK_MAX:
                raise ZstdError("zstd: block larger than 128 KiB")
            if btype == 0:
                if len(data) - at < size:
                    raise ZstdError("zstd: truncated raw block")
                out += data[at:at + size]
                at += size
            elif btype == 1:
                if len(data) - at < 1:
                    raise ZstdError("zstd: truncated RLE block")
                out += bytes([data[at]]) * size
                at += 1
            elif btype == 2:
                if len(data) - at < size:
                    raise ZstdError("zstd: truncated compressed block")
                before = len(out)
                _compressed_block(fr, data[at:at + size], out, start)
                if len(out) - before > BLOCK_MAX:
                    raise ZstdError("zstd: block decodes past 128 KiB")
                at += size
            else:
                raise ZstdError("zstd: reserved block type")
        if fcs is not None and fcs != len(out) - start:
            raise ZstdError("zstd: frame content size does not match its "
                            "blocks")
        if checksum:
            if len(data) - at < 4:
                raise ZstdError("zstd: truncated content checksum")
            (want,) = struct.unpack_from("<I", data, at)
            if xxh64(bytes(out[start:])) & 0xFFFFFFFF != want:
                raise ZstdError("zstd: content checksum mismatch")
            at += 4
    return bytes(out)
