// Zstandard decoder (RFC 8878) and CRC-32C for the checkpoint reader
// (train/jax_checkpoint.py): Orbax stores each array chunk as a zstd
// frame and each OCDBT node as a zstd-compressed body with a CRC-32C.
// A second source of the library native/__init__.py builds with
// rasterize.cc; utils/zstd.py holds the Python twin of every routine.
//
// Decodes any number of concatenated frames (skippable frames are
// skipped): raw, RLE and compressed blocks; Huffman-coded literals in 1
// or 4 streams, with a new table (FSE-compressed or direct weights) or
// the previous one (treeless); sequences with predefined, RLE,
// FSE-compressed or repeated tables and the three repeat offsets; frames
// with and without a content size and a content checksum (XXH64,
// verified). A frame that names a dictionary is refused. A truncated or
// corrupt input raises an error: the routine never returns short output.

#include <cstdint>
#include <cstring>
#include <string>

namespace {

struct Failure {
  const char* what;
  bool too_small;
};

[[noreturn]] void fail(const char* what) { throw Failure{what, false}; }

inline int highest_bit(uint64_t v) { return 63 - __builtin_clzll(v); }

inline uint32_t load_le(const uint8_t* p, int n) {
  uint32_t v = 0;
  for (int i = 0; i < n; ++i) v |= static_cast<uint32_t>(p[i]) << (8 * i);
  return v;
}

// ---------------------------------------------------------------------------
// Bit streams.
// ---------------------------------------------------------------------------

// Little-endian, least significant bit first (FSE table descriptions).
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t bit;
  uint32_t read(int nb) {
    if (bit + nb > n * 8) fail("zstd: truncated FSE table description");
    uint32_t v = 0;
    for (int i = 0; i < nb; ++i, ++bit)
      v |= static_cast<uint32_t>((p[bit >> 3] >> (bit & 7)) & 1u) << i;
    return v;
  }
};

// Read backward from the end mark (the highest set bit of the last
// byte); bits before the start of the stream read as zero, and the
// position then goes negative, which the callers check.
struct BackwardBits {
  const uint8_t* p;
  size_t n;
  int64_t pos;

  void init(const uint8_t* src, size_t len) {
    if (len == 0) fail("zstd: empty bitstream");
    const uint8_t last = src[len - 1];
    if (last == 0) fail("zstd: bitstream without its end mark");
    p = src;
    n = len;
    pos = static_cast<int64_t>(len) * 8 - (8 - highest_bit(last));
  }
  // Bits [at, at + nb) with nb <= 32; negative positions are zero.
  uint64_t bits_at(int64_t at, int nb) const {
    if (at < 0) {
      if (at + nb <= 0) return 0;
      return bits_at(0, static_cast<int>(nb + at)) << (-at);
    }
    const size_t byte = static_cast<size_t>(at >> 3);
    uint64_t w = 0;
    if (byte + 8 <= n) {
      std::memcpy(&w, p + byte, 8);
    } else {
      for (size_t i = 0; byte + i < n; ++i)
        w |= static_cast<uint64_t>(p[byte + i]) << (8 * i);
    }
    return (w >> (at & 7)) & ((uint64_t{1} << nb) - 1);
  }
  uint64_t read(int nb) {
    if (nb == 0) return 0;
    pos -= nb;
    return bits_at(pos, nb);
  }
};

// ---------------------------------------------------------------------------
// FSE tables.
// ---------------------------------------------------------------------------

struct FseEntry {
  uint8_t symbol;
  uint8_t nbits;
  uint16_t base;
};

struct FseTable {
  int log;
  FseEntry e[512];
  bool valid = false;
};

void build_fse(FseTable& t, const int16_t* norm, int nsym, int log) {
  const int size = 1 << log;
  int high = size;
  uint16_t next[256];
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t.e[--high].symbol = static_cast<uint8_t>(s);
      next[s] = 1;
    } else {
      next[s] = static_cast<uint16_t>(norm[s] > 0 ? norm[s] : 0);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.e[pos].symbol = static_cast<uint8_t>(s);
      do pos = (pos + step) & mask; while (pos >= high);
    }
  }
  if (pos != 0) fail("zstd: FSE distribution does not fill its table");
  for (int i = 0; i < size; ++i) {
    const int s = t.e[i].symbol;
    const uint32_t d = next[s]++;
    const int nb = log - highest_bit(d);
    t.e[i].nbits = static_cast<uint8_t>(nb);
    t.e[i].base = static_cast<uint16_t>((d << nb) - size);
  }
  t.log = log;
  t.valid = true;
}

void rle_fse(FseTable& t, uint8_t symbol) {
  t.log = 0;
  t.e[0] = FseEntry{symbol, 0, 0};
  t.valid = true;
}

// An FSE table description (RFC 8878 section 4.1.1); returns the bytes
// it takes.
size_t read_fse_description(FseTable& t, const uint8_t* p, size_t n,
                            int max_log, int max_symbol) {
  ForwardBits in{p, n, 0};
  const int log = static_cast<int>(in.read(4)) + 5;
  if (log > max_log) fail("zstd: FSE accuracy log too large");
  int16_t norm[256];
  int remaining = 1 << log, s = 0;
  while (remaining > 0) {
    if (s > max_symbol) fail("zstd: FSE description has too many symbols");
    const int nb = highest_bit(static_cast<uint64_t>(remaining) + 1) + 1;
    uint32_t v = in.read(nb);
    const uint32_t low = (1u << (nb - 1)) - 1;
    const uint32_t threshold = (1u << nb) - 1 - (remaining + 1);
    if ((v & low) < threshold) {
      in.bit -= 1;
      v &= low;
    } else if (v > low) {
      v -= threshold;
    }
    const int prob = static_cast<int>(v) - 1;
    remaining -= prob < 0 ? -prob : prob;
    norm[s++] = static_cast<int16_t>(prob);
    if (prob == 0) {
      for (;;) {
        const uint32_t rep = in.read(2);
        for (uint32_t i = 0; i < rep; ++i) {
          if (s > max_symbol) fail("zstd: FSE zero run past the symbols");
          norm[s++] = 0;
        }
        if (rep != 3) break;
      }
    }
  }
  if (remaining != 0) fail("zstd: FSE probabilities do not sum to 1");
  build_fse(t, norm, s, log);
  return (in.bit + 7) >> 3;
}

// ---------------------------------------------------------------------------
// Huffman literals.
// ---------------------------------------------------------------------------

// Indexed by the next max_bits bits of a stream: the symbol (low byte)
// and its code length (high byte).
struct HufTable {
  int max_bits;
  uint16_t entry[2048];
  bool valid = false;
};

// A Huffman tree description (RFC 8878 section 4.2.1); returns its size.
size_t read_huffman(HufTable& h, const uint8_t* p, size_t n) {
  if (n < 1) fail("zstd: truncated Huffman tree description");
  const int header = p[0];
  uint8_t w[256];
  int count = 0;
  size_t used;
  if (header < 128) {
    // FSE-compressed weights, two interleaved states.
    used = 1 + static_cast<size_t>(header);
    if (used > n || header == 0) fail("zstd: truncated Huffman weights");
    FseTable t;
    const size_t d = read_fse_description(t, p + 1, header, 6, 255);
    if (d >= static_cast<size_t>(header))
      fail("zstd: Huffman weights without a bitstream");
    BackwardBits in;
    in.init(p + 1 + d, header - d);
    uint32_t s1 = static_cast<uint32_t>(in.read(t.log));
    uint32_t s2 = static_cast<uint32_t>(in.read(t.log));
    for (;;) {
      if (count > 253) fail("zstd: too many Huffman weights");
      w[count++] = t.e[s1].symbol;
      s1 = t.e[s1].base + static_cast<uint32_t>(in.read(t.e[s1].nbits));
      if (in.pos < 0) {
        w[count++] = t.e[s2].symbol;
        break;
      }
      w[count++] = t.e[s2].symbol;
      s2 = t.e[s2].base + static_cast<uint32_t>(in.read(t.e[s2].nbits));
      if (in.pos < 0) {
        w[count++] = t.e[s1].symbol;
        break;
      }
    }
  } else {
    count = header - 127;
    used = 1 + static_cast<size_t>((count + 1) / 2);
    if (used > n) fail("zstd: truncated Huffman weights");
    for (int i = 0; i < count; ++i)
      w[i] = (i & 1) ? (p[1 + i / 2] & 15) : (p[1 + i / 2] >> 4);
  }
  uint32_t total = 0;
  for (int i = 0; i < count; ++i) {
    if (w[i] > 11) fail("zstd: Huffman weight above 11");
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) fail("zstd: Huffman weights all zero");
  const int max_bits = highest_bit(total) + 1;
  if (max_bits > 11) fail("zstd: Huffman table deeper than 11 bits");
  const uint32_t left = (1u << max_bits) - total;
  if (left & (left - 1)) fail("zstd: Huffman weights do not complete a tree");
  w[count++] = static_cast<uint8_t>(highest_bit(left) + 1);
  uint32_t rank_count[13] = {0}, rank_idx[13] = {0};
  uint8_t bits[256];
  for (int i = 0; i < count; ++i) {
    bits[i] = w[i] ? static_cast<uint8_t>(max_bits + 1 - w[i]) : 0;
    rank_count[bits[i]]++;
  }
  rank_idx[max_bits] = 0;
  for (int i = max_bits; i >= 1; --i)
    rank_idx[i - 1] = rank_idx[i] + rank_count[i] * (1u << (max_bits - i));
  if (rank_idx[0] != (1u << max_bits)) fail("zstd: bad Huffman code lengths");
  for (int i = 0; i < count; ++i) {
    if (!bits[i]) continue;
    const uint32_t len = 1u << (max_bits - bits[i]);
    const uint16_t e = static_cast<uint16_t>(i | (bits[i] << 8));
    for (uint32_t k = 0; k < len; ++k) h.entry[rank_idx[bits[i]] + k] = e;
    rank_idx[bits[i]] += len;
  }
  h.max_bits = max_bits;
  h.valid = true;
  return used;
}

// One Huffman stream read backward: the next symbol is the table entry
// of the max_bits bits below `pos` (zeros below the stream's start),
// and it consumes its code length. A valid stream ends at pos 0 after
// exactly `count` symbols.
struct HufCursor {
  BackwardBits in;
  uint8_t* out;
  size_t k, count;

  // One 8-byte load covers the next four symbols (4 x 11 bits <= 57 - 11)
  // when the load lies inside the stream.
  bool fast() const {
    const int64_t base = in.pos - 57;
    return k + 4 <= count && base >= 0 &&
           static_cast<size_t>(base >> 3) + 8 <= in.n;
  }
  void four(const HufTable& h) {
    const int64_t lo = ((in.pos - 57) >> 3) * 8;
    uint64_t w;
    std::memcpy(&w, in.p + (lo >> 3), 8);
    const int mb = h.max_bits;
    const uint64_t mask = (uint64_t{1} << mb) - 1;
    for (int i = 0; i < 4; ++i) {
      const uint16_t e = h.entry[(w >> (in.pos - mb - lo)) & mask];
      out[k++] = static_cast<uint8_t>(e);
      in.pos -= e >> 8;
    }
  }
  void one(const HufTable& h) {
    if (k == count) fail("zstd: Huffman stream longer than its literals");
    const uint16_t e =
        h.entry[in.bits_at(in.pos - h.max_bits, h.max_bits)];
    out[k++] = static_cast<uint8_t>(e);
    in.pos -= e >> 8;
  }
  void finish(const HufTable& h) {
    while (in.pos > 0) {
      if (fast()) {
        four(h);
      } else {
        one(h);
      }
    }
    if (in.pos != 0 || k != count)
      fail("zstd: Huffman stream not consumed exactly");
  }
};

void huffman_streams(const HufTable& h, HufCursor* c, int n) {
  // The streams in turn while every one has four symbols in one load:
  // their loads and lookups overlap.
  if (n == 4) {
    while (c[0].fast() && c[1].fast() && c[2].fast() && c[3].fast()) {
      c[0].four(h);
      c[1].four(h);
      c[2].four(h);
      c[3].four(h);
    }
  }
  for (int i = 0; i < n; ++i) c[i].finish(h);
}

HufCursor huffman_cursor(const uint8_t* p, size_t n, uint8_t* out,
                         size_t count) {
  HufCursor c;
  c.in.init(p, n);
  c.out = out;
  c.k = 0;
  c.count = count;
  return c;
}

// ---------------------------------------------------------------------------
// Frames.
// ---------------------------------------------------------------------------

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {
    0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Output {
  uint8_t* dst;
  size_t cap;
  size_t len;
  void need(size_t k) const {
    if (len + k > cap) throw Failure{"zstd: output buffer too small", true};
  }
};

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  uint64_t rep[3];
  uint8_t literals[1 << 17];
};

const size_t kBlockMax = 1 << 17;

// Reads one sequence table by its mode; returns the bytes it takes.
size_t sequence_table(FseTable& t, int mode, const uint8_t* p, size_t n,
                      const int16_t* deflt, int nsym, int dlog, int max_log,
                      int max_symbol) {
  switch (mode) {
    case 0:
      build_fse(t, deflt, nsym, dlog);
      return 0;
    case 1:
      if (n < 1) fail("zstd: truncated RLE sequence table");
      if (p[0] > max_symbol) fail("zstd: RLE sequence symbol out of range");
      rle_fse(t, p[0]);
      return 1;
    case 2:
      return read_fse_description(t, p, n, max_log, max_symbol);
    default:
      if (!t.valid) fail("zstd: repeated sequence table without a previous");
      return 0;
  }
}

void compressed_block(FrameState& st, const uint8_t* p, size_t n,
                      Output& out, size_t frame_start) {
  // Literals section.
  if (n < 1) fail("zstd: empty compressed block");
  const int ltype = p[0] & 3, sf = (p[0] >> 2) & 3;
  size_t regen, csize = 0, hsize;
  if (ltype < 2) {
    if (sf == 0 || sf == 2) {
      hsize = 1;
      regen = p[0] >> 3;
    } else if (sf == 1) {
      hsize = 2;
      if (n < 2) fail("zstd: truncated literals header");
      regen = (p[0] >> 4) + (static_cast<size_t>(p[1]) << 4);
    } else {
      hsize = 3;
      if (n < 3) fail("zstd: truncated literals header");
      regen = (p[0] >> 4) + (static_cast<size_t>(p[1]) << 4) +
              (static_cast<size_t>(p[2]) << 12);
    }
    if (regen > kBlockMax) fail("zstd: literals larger than a block");
    if (ltype == 0) {
      if (hsize + regen > n) fail("zstd: truncated raw literals");
      std::memcpy(st.literals, p + hsize, regen);
      p += hsize + regen;
      n -= hsize + regen;
    } else {
      if (hsize + 1 > n) fail("zstd: truncated RLE literals");
      std::memset(st.literals, p[hsize], regen);
      p += hsize + 1;
      n -= hsize + 1;
    }
  } else {
    hsize = sf < 2 ? 3 : sf == 2 ? 4 : 5;
    if (n < hsize) fail("zstd: truncated literals header");
    uint64_t v = 0;
    for (size_t i = 0; i < hsize; ++i) v |= static_cast<uint64_t>(p[i]) << (8 * i);
    const int wbits = sf < 2 ? 10 : sf == 2 ? 14 : 18;
    regen = (v >> 4) & ((1u << wbits) - 1);
    csize = (v >> (4 + wbits)) & ((1u << wbits) - 1);
    if (regen > kBlockMax) fail("zstd: literals larger than a block");
    if (hsize + csize > n) fail("zstd: truncated compressed literals");
    const uint8_t* q = p + hsize;
    size_t qn = csize;
    if (ltype == 2) {
      const size_t t = read_huffman(st.huf, q, qn);
      q += t;
      qn -= t;
    } else if (!st.huf.valid) {
      fail("zstd: treeless literals without a previous Huffman table");
    }
    if (sf == 0) {
      HufCursor c = huffman_cursor(q, qn, st.literals, regen);
      huffman_streams(st.huf, &c, 1);
    } else {
      if (qn < 6) fail("zstd: truncated Huffman jump table");
      const size_t s1 = load_le(q, 2), s2 = load_le(q + 2, 2),
                   s3 = load_le(q + 4, 2);
      if (6 + s1 + s2 + s3 > qn) fail("zstd: Huffman streams past the literals");
      const size_t s4 = qn - 6 - s1 - s2 - s3;
      const size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("zstd: too few literals for four streams");
      const uint8_t* r = q + 6;
      HufCursor c[4] = {
          huffman_cursor(r, s1, st.literals, seg),
          huffman_cursor(r + s1, s2, st.literals + seg, seg),
          huffman_cursor(r + s1 + s2, s3, st.literals + 2 * seg, seg),
          huffman_cursor(r + s1 + s2 + s3, s4, st.literals + 3 * seg,
                         regen - 3 * seg)};
      huffman_streams(st.huf, c, 4);
    }
    p += hsize + csize;
    n -= hsize + csize;
  }

  // Sequences section.
  if (n < 1) fail("zstd: truncated sequences section");
  size_t nseq;
  if (p[0] < 128) {
    nseq = p[0];
    p += 1;
    n -= 1;
  } else if (p[0] < 255) {
    if (n < 2) fail("zstd: truncated sequence count");
    nseq = ((p[0] - 128u) << 8) + p[1];
    p += 2;
    n -= 2;
  } else {
    if (n < 3) fail("zstd: truncated sequence count");
    nseq = p[1] + (static_cast<size_t>(p[2]) << 8) + 0x7F00;
    p += 3;
    n -= 3;
  }
  size_t lit_pos = 0;
  if (nseq > 0) {
    if (n < 1) fail("zstd: truncated sequence modes");
    const int modes = p[0];
    if (modes & 3) fail("zstd: reserved bits set in the sequence modes");
    p += 1;
    n -= 1;
    size_t t = sequence_table(st.ll, modes >> 6, p, n, kLLDefault, 36, 6, 9, 35);
    p += t;
    n -= t;
    t = sequence_table(st.of, (modes >> 4) & 3, p, n, kOFDefault, 29, 5, 8, 31);
    p += t;
    n -= t;
    t = sequence_table(st.ml, (modes >> 2) & 3, p, n, kMLDefault, 53, 6, 9, 52);
    p += t;
    n -= t;
    BackwardBits in;
    in.init(p, n);
    uint32_t sl = static_cast<uint32_t>(in.read(st.ll.log));
    uint32_t so = static_cast<uint32_t>(in.read(st.of.log));
    uint32_t sm = static_cast<uint32_t>(in.read(st.ml.log));
    for (size_t i = 0; i < nseq; ++i) {
      const int lc = st.ll.e[sl].symbol, oc = st.of.e[so].symbol,
                mc = st.ml.e[sm].symbol;
      if (lc > 35 || mc > 52 || oc > 31) fail("zstd: sequence code out of range");
      const uint64_t ov = (uint64_t{1} << oc) + in.read(oc);
      const size_t ml = kMLBase[mc] + static_cast<size_t>(in.read(kMLBits[mc]));
      const size_t ll = kLLBase[lc] + static_cast<size_t>(in.read(kLLBits[lc]));
      uint64_t off;
      if (ov > 3) {
        off = ov - 3;
        st.rep[2] = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = off;
      } else {
        const int idx = static_cast<int>(ov) - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          off = st.rep[0];
        } else {
          off = idx < 3 ? st.rep[idx] : st.rep[0] - 1;
          if (idx > 1) st.rep[2] = st.rep[1];
          st.rep[1] = st.rep[0];
          st.rep[0] = off;
        }
      }
      if (i + 1 < nseq) {
        sl = st.ll.e[sl].base + static_cast<uint32_t>(in.read(st.ll.e[sl].nbits));
        sm = st.ml.e[sm].base + static_cast<uint32_t>(in.read(st.ml.e[sm].nbits));
        so = st.of.e[so].base + static_cast<uint32_t>(in.read(st.of.e[so].nbits));
      }
      if (lit_pos + ll > regen) fail("zstd: sequence past its literals");
      out.need(ll + ml);
      std::memcpy(out.dst + out.len, st.literals + lit_pos, ll);
      lit_pos += ll;
      out.len += ll;
      if (off == 0 || off > out.len - frame_start)
        fail("zstd: match offset before the start of the frame");
      uint8_t* d = out.dst + out.len;
      const uint8_t* s = d - off;
      if (off >= ml) {
        std::memcpy(d, s, ml);
      } else {
        for (size_t k = 0; k < ml; ++k) d[k] = s[k];
      }
      out.len += ml;
    }
    if (in.pos != 0) fail("zstd: sequence bitstream not consumed exactly");
  } else if (n != 0) {
    fail("zstd: bytes after a block without sequences");
  }
  out.need(regen - lit_pos);
  std::memcpy(out.dst + out.len, st.literals + lit_pos, regen - lit_pos);
  out.len += regen - lit_pos;
}

// XXH64 with seed 0.
const uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
               P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
               P5 = 2870177450012600261ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline uint64_t round64(uint64_t acc, uint64_t lane) {
  return rotl(acc + lane * P2, 31) * P1;
}
inline uint64_t merge64(uint64_t h, uint64_t v) {
  return (h ^ round64(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = round64(v1, rd64(p));
      v2 = round64(v2, rd64(p + 8));
      v3 = round64(v3, rd64(p + 16));
      v4 = round64(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge64(h, v1);
    h = merge64(h, v2);
    h = merge64(h, v3);
    h = merge64(h, v4);
  } else {
    h = P5;
  }
  h += n;
  while (p + 8 <= end) {
    h = rotl(h ^ round64(0, rd64(p)), 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h = rotl(h ^ (static_cast<uint64_t>(load_le(p, 4)) * P1), 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h = rotl(h ^ (*p * P5), 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

struct Header {
  size_t size;           // header bytes after the magic
  int64_t content_size;  // -1 when the frame does not record it
  bool checksum;
};

Header frame_header(const uint8_t* p, size_t n) {
  if (n < 1) fail("zstd: truncated frame header");
  const int fhd = p[0];
  if (fhd & 8) fail("zstd: reserved bit set in the frame header");
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, did = fhd & 3;
  size_t at = 1 + (single ? 0 : 1);
  const int did_size = did == 3 ? 4 : did;
  const int fcs_size = fcs_flag == 0 ? single : 1 << fcs_flag;
  if (at + did_size + fcs_size > n) fail("zstd: truncated frame header");
  uint32_t dict = 0;
  for (int i = 0; i < did_size; ++i) dict |= static_cast<uint32_t>(p[at + i]) << (8 * i);
  if (dict != 0) fail("zstd: frame names a dictionary, which is not supported");
  at += did_size;
  int64_t fcs = -1;
  if (fcs_size) {
    uint64_t v = 0;
    for (int i = 0; i < fcs_size; ++i) v |= static_cast<uint64_t>(p[at + i]) << (8 * i);
    if (fcs_size == 2) v += 256;
    fcs = static_cast<int64_t>(v);
  }
  at += fcs_size;
  return Header{at, fcs, ((fhd >> 2) & 1) != 0};
}

const uint32_t kMagic = 0xFD2FB528u;

bool skippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }

size_t decode_all(const uint8_t* src, size_t n, Output& out) {
  FrameState* st = new FrameState;
  struct Guard {
    FrameState* s;
    ~Guard() { delete s; }
  } guard{st};
  if (n == 0) fail("zstd: empty input");
  size_t at = 0;
  while (at < n) {
    if (n - at < 4) fail("zstd: truncated frame magic");
    const uint32_t magic = load_le(src + at, 4);
    at += 4;
    if (skippable(magic)) {
      if (n - at < 4) fail("zstd: truncated skippable frame");
      const size_t len = load_le(src + at, 4);
      if (n - at - 4 < len) fail("zstd: truncated skippable frame");
      at += 4 + len;
      continue;
    }
    if (magic != kMagic) fail("zstd: not a zstd frame (bad magic number)");
    const Header h = frame_header(src + at, n - at);
    at += h.size;
    const size_t start = out.len;
    st->huf.valid = st->ll.valid = st->of.valid = st->ml.valid = false;
    st->rep[0] = 1;
    st->rep[1] = 4;
    st->rep[2] = 8;
    for (bool last = false; !last;) {
      if (n - at < 3) fail("zstd: truncated block header");
      const uint32_t bh = load_le(src + at, 3);
      at += 3;
      last = bh & 1;
      const int type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      if (size > kBlockMax) fail("zstd: block larger than 128 KiB");
      if (type == 0) {
        if (n - at < size) fail("zstd: truncated raw block");
        out.need(size);
        std::memcpy(out.dst + out.len, src + at, size);
        out.len += size;
        at += size;
      } else if (type == 1) {
        if (n - at < 1) fail("zstd: truncated RLE block");
        out.need(size);
        std::memset(out.dst + out.len, src[at], size);
        out.len += size;
        at += 1;
      } else if (type == 2) {
        if (n - at < size) fail("zstd: truncated compressed block");
        const size_t before = out.len;
        compressed_block(*st, src + at, size, out, start);
        if (out.len - before > kBlockMax) fail("zstd: block decodes past 128 KiB");
        at += size;
      } else {
        fail("zstd: reserved block type");
      }
    }
    if (h.content_size >= 0 &&
        static_cast<uint64_t>(h.content_size) != out.len - start)
      fail("zstd: frame content size does not match its blocks");
    if (h.checksum) {
      if (n - at < 4) fail("zstd: truncated content checksum");
      const uint32_t want = load_le(src + at, 4);
      if (static_cast<uint32_t>(xxh64(out.dst + start, out.len - start)) != want)
        fail("zstd: content checksum mismatch");
      at += 4;
    }
  }
  return out.len;
}

uint32_t crc_table[256];
bool crc_ready = false;

}  // namespace

extern "C" {

// Decodes the concatenated frames of src into dst (at most cap bytes).
// Returns the byte count; -1 on a corrupt or unsupported input, with the
// reason in err (errlen bytes, NUL-terminated); -2 when cap is too small.
int64_t zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t cap, char* err, int64_t errlen) {
  Output out{dst, static_cast<size_t>(cap), 0};
  try {
    return static_cast<int64_t>(decode_all(src, static_cast<size_t>(n), out));
  } catch (const Failure& f) {
    if (errlen > 0) {
      std::strncpy(err, f.what, static_cast<size_t>(errlen) - 1);
      err[errlen - 1] = 0;
    }
    return f.too_small ? -2 : -1;
  }
}

// The sum of the content sizes the frames of src record; -1 when a frame
// does not record its size (or the headers do not parse).
int64_t zstd_content_size(const uint8_t* src, int64_t n) {
  size_t at = 0, total = 0, len = static_cast<size_t>(n);
  try {
    while (at < len) {
      if (len - at < 4) return -1;
      const uint32_t magic = load_le(src + at, 4);
      at += 4;
      if (skippable(magic)) {
        if (len - at < 4) return -1;
        at += 4 + load_le(src + at, 4);
        continue;
      }
      if (magic != kMagic) return -1;
      const Header h = frame_header(src + at, len - at);
      if (h.content_size < 0) return -1;
      total += static_cast<size_t>(h.content_size);
      at += h.size;
      // Walk the blocks to the next frame.
      for (bool last = false; !last;) {
        if (len - at < 3) return -1;
        const uint32_t bh = load_le(src + at, 3);
        last = bh & 1;
        at += 3 + (((bh >> 1) & 3) == 1 ? 1 : (bh >> 3));
        if (at > len) return -1;
      }
      if (h.checksum) at += 4;
    }
  } catch (const Failure&) {
    return -1;
  }
  return at == len ? static_cast<int64_t>(total) : -1;
}

// CRC-32C (Castagnoli, reflected 0x82F63B78), as OCDBT stores it.
uint32_t crc32c(const uint8_t* p, int64_t n) {
  if (!crc_ready) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      crc_table[i] = c;
    }
    crc_ready = true;
  }
  uint32_t c = 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; ++i) c = crc_table[(c ^ p[i]) & 255] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
