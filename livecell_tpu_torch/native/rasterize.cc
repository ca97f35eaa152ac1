// Host-side data-path routines of the port: an even-odd scanline polygon
// rasterizer (pixel-center sampling), a column-major COCO RLE decoder
// and encoder, and the TIFF LZW decoder of data/tiff.py, with a plain C
// interface for ctypes. The first three are the routines of
// livecell_tpu/native/rasterize.cc, which the port does not import.
//
// Built by livecell_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC rasterize.cc -o build/librasterize-<hash>.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Rasterize one polygon (flat x0,y0,x1,y1,... in pixel coordinates) into
// out[h*w] (row-major, 0/1). Even-odd rule sampled at pixel centers
// (x+0.5, y+0.5) — same convention as the numpy fallback in
// livecell_tpu_torch/data/coco.py.
void rasterize_polygon(const double* poly, int n_pts, int h, int w,
                       uint8_t* out) {
  if (n_pts < 3) return;
  std::vector<double> xs(n_pts), ys(n_pts);
  for (int i = 0; i < n_pts; ++i) {
    xs[i] = poly[2 * i];
    ys[i] = poly[2 * i + 1];
  }
  std::vector<double> crossings;
  std::vector<int> toggle(w + 1);
  for (int row = 0; row < h; ++row) {
    const double yc = row + 0.5;
    crossings.clear();
    for (int e = 0; e < n_pts; ++e) {
      const double y1 = ys[e], y2 = ys[(e + 1) % n_pts];
      const double lo = std::min(y1, y2), hi = std::max(y1, y2);
      if (yc >= lo && yc < hi) {
        const double x1 = xs[e], x2 = xs[(e + 1) % n_pts];
        const double t = (yc - y1) / (y2 - y1);
        crossings.push_back(x1 + t * (x2 - x1));
      }
    }
    if (crossings.empty()) continue;
    std::fill(toggle.begin(), toggle.end(), 0);
    for (double cx : crossings) {
      long start = std::lround(std::ceil(cx - 0.5));
      if (start < 0) start = 0;
      if (start > w) start = w;
      toggle[start] ^= 1;
    }
    int parity = 0;
    uint8_t* row_ptr = out + static_cast<size_t>(row) * w;
    for (int x = 0; x < w; ++x) {
      parity ^= toggle[x];
      row_ptr[x] |= static_cast<uint8_t>(parity);
    }
  }
}

// Decode COCO uncompressed RLE counts (column-major alternating 0/1 runs)
// into out[h*w] row-major.
void rle_decode(const int64_t* counts, int n_counts, int h, int w,
                uint8_t* out) {
  int64_t pos = 0;
  uint8_t val = 0;
  const int64_t total = static_cast<int64_t>(h) * w;
  for (int i = 0; i < n_counts && pos < total; ++i) {
    int64_t run = counts[i];
    if (run > total - pos) run = total - pos;
    if (val) {
      for (int64_t k = pos; k < pos + run; ++k) {
        // column-major index k -> (row = k % h, col = k / h)
        out[(k % h) * static_cast<int64_t>(w) + (k / h)] = 1;
      }
    }
    pos += run;
    val ^= 1;
  }
}

// Encode a row-major binary mask as column-major RLE. Returns the number
// of runs written to counts (capacity must be >= h*w+1).
int rle_encode(const uint8_t* mask, int h, int w, int64_t* counts) {
  const int64_t total = static_cast<int64_t>(h) * w;
  int n = 0;
  uint8_t cur = 0;
  int64_t run = 0;
  for (int64_t k = 0; k < total; ++k) {
    const uint8_t v = mask[(k % h) * static_cast<int64_t>(w) + (k / h)] ? 1
                                                                        : 0;
    if (v == cur) {
      ++run;
    } else {
      counts[n++] = run;
      cur = v;
      run = 1;
    }
  }
  counts[n++] = run;
  return n;
}

// TIFF LZW (TIFF 6.0, section 13): codes of 9-12 bits, most significant
// bit first, the width growing when the next free code is 511, 1023 or
// 2047. Writes at most `cap` bytes to dst and returns their count; stops
// at the end-of-information code or the end of src. Returns -1 on a code
// not yet in the table. The routine of data/tiff.py:lzw_decode_plain.
int64_t lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                   int64_t cap) {
  const int kClear = 256, kEoi = 257, kMax = 4096;
  int32_t prefix[kMax];
  int32_t length[kMax];
  uint8_t suffix[kMax];
  uint8_t first[kMax];
  for (int i = 0; i < 256; ++i) {
    prefix[i] = -1;
    length[i] = 1;
    suffix[i] = first[i] = static_cast<uint8_t>(i);
  }
  int next = 258, width = 9, prev = -1, nbits = 0;
  uint32_t buf = 0;
  int64_t pos = 0, out = 0;
  while (out < cap) {
    while (nbits < width) {
      if (pos >= n) return out;
      buf = (buf << 8) | src[pos++];
      nbits += 8;
    }
    nbits -= width;
    const int code = static_cast<int>(buf >> nbits);
    buf &= (1u << nbits) - 1;
    if (code == kEoi) break;
    if (code == kClear) {
      next = 258;
      width = 9;
      prev = -1;
      continue;
    }
    if (prev < 0) {
      if (code > 255) return -1;
    } else {
      if (code > next || (code == next && next == kMax)) return -1;
      if (next < kMax) {
        const uint8_t head = code < next ? first[code] : first[prev];
        prefix[next] = prev;
        suffix[next] = head;
        first[next] = first[prev];
        length[next] = length[prev] + 1;
        ++next;
      }
      if (next == 511 || next == 1023 || next == 2047) ++width;
    }
    // The entry's bytes, written back to front along its prefix chain.
    const int64_t len = length[code];
    for (int c = code, k = static_cast<int>(len) - 1; c >= 0;
         c = prefix[c], --k) {
      if (out + k < cap) dst[out + k] = suffix[c];
    }
    out = std::min(out + len, cap);
    prev = code;
  }
  return out;
}

}  // extern "C"
