// Shared device code of the RoIAlign kernels (roi_align.cu: K1-K3,
// ms_roi_align.cu: K5-K6): conversions between the feature dtype and
// f32, the pooled bilinear weight of one bin and one feature pixel, the
// tiled backward (K3, K6) and the forward gather over compact tap lists
// (K2, K5; its note is at its section below).
//
// The tiled backward replaces the Pallas kernel `_bwd_kernel`
// (livecell_tpu/ops/pallas_roi_align.py:152), which accumulated dF over
// ROI blocks in one f32 block resident in VMEM. Blocks on Hopper run in
// no order, so the backward gathers instead of scattering, and it is
// bound by bytes (g read once, dF written whole; each bin touches at most
// (2 ratio)^2 feature pixels, so the multiply-adds are few and the tensor
// cores have nothing to chew on). The row gather it replaces gave each
// block one feature row and walked every ROI of the image: a 136 KB row
// of f32 sums at P2 left one 4-warp block per SM, every block read every
// ROI's Wy column with strided loads, reloaded its Wx rows and ran the x
// loop over the whole map width (45x the byte bound for K3, 141x for
// K6). Here:
//   - a pre-pass writes each ROI's row and column span (the inclusive
//     range where its weights are non-zero, on its own level);
//   - one block of 4 warps owns one tile of kTileY x kTileX feature
//     pixels (one column a warp) and kSlice = 256 channels (8 a lane) of
//     one image (and one level), its f32 sums in registers (kTileY x kVec
//     a thread), 13 KB of shared memory whatever the map's size, so four
//     blocks (16 warps) fit on an SM; a warp's loads and stores of a
//     pixel's channels are contiguous (512 bytes in bf16);
//   - the block compacts the ROIs whose spans meet the tile into a list
//     in shared memory with warp ballots, in ROI index order, and walks
//     that list only, forming each listed ROI's weights on the tile's
//     rows and columns only (kStage ROIs staged at once);
//   - g is loaded as 16-byte vectors along channels, dF stored as 16-byte
//     vectors; a tile that no ROI meets stores zeros.
// (8 x 4 x 256 beat 8 x 8 x 128, 8 x 8 x 256, 4 x 8 x 256 and 4 x 16 x 128
// tiles at the training shapes on an H100; PERF.md section 6.)
// The sum order is the row gather's: for each output (y, x, c), ROIs in
// index order, bins p in order (skipping Wy[p, y] = 0), u the fmaf chain
// over the non-zero taps q in order rounded to T, then
// acc = fmaf(Wy[p, y], u, acc); skipped taps are exact zeros, so the
// result is the same bit for bit in every run. No atomics. Rounding
// follows the Pallas kernel: u in T (pallas_roi_align.py:170), dF summed
// in f32 and rounded once (:346).

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace livecell {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an f32 value to T and back (identity for T = float).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// The side of one bin of a box [lo, hi] (image coordinates) on an axis
// at `scale`, floored at 1 feature pixel before the division, and the
// coordinate of its sample s (of `ratio`) in bin p: torchvision RoIAlign,
// aligned=False, samples at offsets (s + 0.5) / ratio. The rounded
// intrinsics (__fmul_rn, ...) stop the compiler from fusing a*b+c into
// one FMA, so every step rounds where the plain PyTorch version's
// separate tensor ops round and the f32 weight agrees bit for bit.
__device__ __forceinline__ float bin_side(float lo, float hi, float scale,
                                          int n) {
  const float start = __fmul_rn(lo, scale);
  return __fdiv_rn(fmaxf(__fsub_rn(__fmul_rn(hi, scale), start), 1.0f),
                   (float)n);
}

__device__ __forceinline__ float sample_coord(float start, float bin, int p,
                                              int s, int ratio) {
  // (s + 0.5) / ratio in double, rounded once: the plain version's
  // Python scalar.
  const float off = (float)((s + 0.5) / ratio);
  return __fadd_rn(start, __fmul_rn(__fadd_rn((float)p, off), bin));
}

// The pooled weight of output bin p (of n) on feature pixel g along one
// axis of a box [lo, hi]: samples outside [-1, size] weigh 0, the mean
// of the samples' two-tap weights.
__device__ __forceinline__ float pooled_weight(float lo, float hi, float scale,
                                               int n, int size, int ratio,
                                               int p, int g) {
  const float start = __fmul_rn(lo, scale);
  const float bin = bin_side(lo, hi, scale, n);
  float acc = 0.0f;
  for (int s = 0; s < ratio; ++s) {
    const float c = sample_coord(start, bin, p, s, ratio);
    if (c >= -1.0f && c <= (float)size) {
      const float cc = fminf(fmaxf(c, 0.0f), (float)(size - 1));
      acc = __fadd_rn(
          acc, fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(cc, (float)g)))));
    }
  }
  return __fdiv_rn(acc, (float)ratio);
}

// The pixels of one axis where bin p's pooled weight can be non-zero: a
// sample's taps lie within one pixel of it (clamped to the map), and the
// samples of a bin ascend with s, so its taps lie between its first and
// last sample (computed as pooled_weight computes them) widened by one
// pixel; the window widens them by two and clamps to [0, size - 1]. A
// NaN end point gives the whole axis. Never empty.
__device__ __forceinline__ int2 bin_window(float lo, float hi, float scale,
                                           int n, int size, int ratio,
                                           int p) {
  const float start = __fmul_rn(lo, scale);
  const float bin = bin_side(lo, hi, scale, n);
  const float f0 = floorf(sample_coord(start, bin, p, 0, ratio)) - 2.0f;
  const float f1 =
      ceilf(sample_coord(start, bin, p, ratio - 1, ratio)) + 2.0f;
  return make_int2(f0 > 0.0f ? (int)fminf(f0, (float)(size - 1)) : 0,
                   f1 < (float)(size - 1) ? (int)fmaxf(f1, 0.0f) : size - 1);
}

// ---------------------------------------------------------------------------
// The tiled backward (K3, K6).
// ---------------------------------------------------------------------------

constexpr int kMaxBins = 16;       // largest out_size the kernels take
constexpr int kTileY = 8;          // feature rows of a tile
constexpr int kTileX = 4;          // feature columns of a tile: one a warp
constexpr int kVec = 8;            // channels of a thread
constexpr int kGroups = 32;        // channel groups of a block: one a lane
constexpr int kSlice = kVec * kGroups;             // channels of a block
constexpr int kTileThreads = kTileX * kGroups;     // 128
constexpr int kTileMinBlocks = 4;  // 16 warps on an SM: at most 128 registers
constexpr int kStage = 16;         // listed ROIs whose weights are staged
constexpr int kSpanThreads = 256;  // pre-passes: one warp per ROI
// A thread's kVec channels: for bf16 one 16-byte vector at c0 + 8 lane;
// for f32 two 16-byte vectors, at c0 + 4 lane and kHalf further, so that
// each warp's loads and stores of one pixel are contiguous.
constexpr int kHalf = kSlice / 2;
template <typename T>
__host__ __device__ constexpr int lane_channels() {
  return sizeof(T) == 4 ? 4 : kVec;
}

// An empty span has lo > hi: the pre-passes write lo = size, hi = -1.
struct __align__(16) TileShared {
  float wy[kStage][kMaxBins][kTileY];  // Wy[p, y0 + i], 0 past the map
  float wx[kStage][kMaxBins][kTileX];  // Wx[q, x0 + i], 0 past the map
  int list[kTileThreads];              // listed ROIs of this pass, in order
  int warp_hits[kTileThreads / 32];
};

// K2's and K3's weights: rows of K1's tensors Wy [K, n, H], Wx [K, n, W]
// (of one image, or of all images with a global ROI index). Row r of a
// ROI is Wy[p = r] for r < n, else Wx[q = r - n]; any of its pixels may
// hold a tap.
template <typename T>
struct RowWeights {
  const T* wy;
  const T* wx;
  int n, h, w;
  __device__ __forceinline__ float y(int roi, int p, int yy) const {
    return to_f32(wy[((size_t)roi * n + p) * h + yy]);
  }
  __device__ __forceinline__ float x(int roi, int q, int xx) const {
    return to_f32(wx[((size_t)roi * n + q) * w + xx]);
  }
  __device__ __forceinline__ float row(int roi, int r, int g) const {
    return r < n ? y(roi, r, g) : x(roi, r - n, g);
  }
  __device__ __forceinline__ int2 window(int, int r) const {
    return make_int2(0, (r < n ? h : w) - 1);
  }
};

// K5's and K6's weights: recomputed from the boxes [K, 4] on one level,
// rounded to T as K1 rounds them; row r as RowWeights', its taps inside
// bin_window.
template <typename T>
struct BoxWeights {
  const float* boxes;
  float scale;
  int n, h, w, ratio;
  __device__ __forceinline__ float y(int roi, int p, int yy) const {
    return round_to<T>(pooled_weight(boxes[roi * 4 + 1], boxes[roi * 4 + 3],
                                     scale, n, h, ratio, p, yy));
  }
  __device__ __forceinline__ float x(int roi, int q, int xx) const {
    return round_to<T>(pooled_weight(boxes[roi * 4], boxes[roi * 4 + 2],
                                     scale, n, w, ratio, q, xx));
  }
  __device__ __forceinline__ float row(int roi, int r, int g) const {
    return r < n ? y(roi, r, g) : x(roi, r - n, g);
  }
  __device__ __forceinline__ int2 window(int roi, int r) const {
    const bool is_y = r < n;
    return bin_window(boxes[roi * 4 + (is_y ? 1 : 0)],
                      boxes[roi * 4 + (is_y ? 3 : 2)], scale, n,
                      is_y ? h : w, ratio, is_y ? r : r - n);
  }
};

// A lane's kVec channels of one pixel as loaded: for bf16 one 16-byte
// vector, for f32 two, the second kHalf channels further (zeros when
// `hi`, the second vector lies inside the map's channels, is false).
template <typename T>
struct Raw;
template <>
struct Raw<__nv_bfloat16> {
  uint4 v;
};
template <>
struct Raw<float> {
  float4 a, b;
};

__device__ __forceinline__ void load_raw(const __nv_bfloat16* p, bool,
                                         Raw<__nv_bfloat16>& r) {
  r.v = *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void load_raw(const float* p, bool hi,
                                         Raw<float>& r) {
  r.a = *reinterpret_cast<const float4*>(p);
  r.b = hi ? *reinterpret_cast<const float4*>(p + kHalf)
           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void unpack(const Raw<__nv_bfloat16>& r,
                                       float (&v)[kVec]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&r.v);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const Raw<float>& r, float (&v)[kVec]) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, bool hi,
                                         float (&v)[kVec]) {
  Raw<T> r;
  load_raw(p, hi, r);
  unpack(r, v);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, bool,
                                          const float (&v)[kVec]) {
  uint4 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i)
    h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store_vec(float* p, bool hi,
                                          const float (&v)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  if (hi)
    *reinterpret_cast<float4*>(p + kHalf) = make_float4(v[4], v[5], v[6], v[7]);
}

// One listed ROI's share of a thread's sums: its column tx of the tile,
// its kVec channels (g_roi points at g[roi, 0, 0, ch]), staged weights j.
template <typename T>
__device__ __forceinline__ void accumulate_roi(const TileShared& sm, int j,
                                               const T* __restrict__ g_roi,
                                               int n, int c, int tx, bool hi,
                                               float (&acc)[kTileY][kVec]) {
  unsigned qmask = 0;  // bins q with a non-zero Wx tap on this column
  for (int q = 0; q < n; ++q)
    qmask |= (sm.wx[j][q][tx] != 0.0f ? 1u : 0u) << q;
  if (qmask == 0) return;
  for (int p = 0; p < n; ++p) {
    float wyv[kTileY];
#pragma unroll
    for (int i = 0; i < kTileY; i += 4) {
      const float4 y4 = *reinterpret_cast<const float4*>(&sm.wy[j][p][i]);
      wyv[i] = y4.x;
      wyv[i + 1] = y4.y;
      wyv[i + 2] = y4.z;
      wyv[i + 3] = y4.w;
    }
    bool any = false;
#pragma unroll
    for (int i = 0; i < kTileY; ++i) any |= wyv[i] != 0.0f;
    if (!any) continue;  // uniform across the block
    // u = sum_q Wx[q, x] g[p, q, :] over the non-zero taps, q in order;
    // two taps' loads are issued before their multiply-adds.
    const T* gp = g_roi + (size_t)p * n * c;
    float u[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) u[v] = 0.0f;
    for (unsigned m = qmask; m;) {
      const int qa = __ffs(m) - 1;
      m &= m - 1;
      float ga[kVec];
      load_vec(gp + (size_t)qa * c, hi, ga);
      if (m) {
        const int qb = __ffs(m) - 1;
        m &= m - 1;
        float gb[kVec];
        load_vec(gp + (size_t)qb * c, hi, gb);
        const float wa = sm.wx[j][qa][tx], wb = sm.wx[j][qb][tx];
#pragma unroll
        for (int v = 0; v < kVec; ++v) u[v] = fmaf(wa, ga[v], u[v]);
#pragma unroll
        for (int v = 0; v < kVec; ++v) u[v] = fmaf(wb, gb[v], u[v]);
      } else {
        const float wa = sm.wx[j][qa][tx];
#pragma unroll
        for (int v = 0; v < kVec; ++v) u[v] = fmaf(wa, ga[v], u[v]);
      }
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) u[v] = round_to<T>(u[v]);
#pragma unroll
    for (int i = 0; i < kTileY; ++i) {
      if (wyv[i] == 0.0f) continue;  // uniform across the block
#pragma unroll
      for (int v = 0; v < kVec; ++v) acc[i][v] = fmaf(wyv[i], u[v], acc[i][v]);
    }
  }
}

// dF of one tile: rows y0.., columns x0.. of the map df [h, w, c] of one
// image (and level), channels c0..c0 + kSlice, from that image's ROIs:
// spans [k] (int4: y_lo, y_hi, x_lo, x_hi), g [k, n, n, c], weights `wt`.
// Run by all kTileThreads threads of the block; writes every pixel of the
// tile inside the map, zeros where no ROI reaches.
template <typename T, typename Weights>
__device__ void backward_tile(const Weights& wt, const int4* __restrict__ spans,
                              const T* __restrict__ g, T* __restrict__ df,
                              int k, int n, int h, int w, int c, int y0,
                              int x0, int c0, TileShared& sm) {
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int tx = t / kGroups;
  const int x = x0 + tx;
  const int ch = c0 + (t % kGroups) * lane_channels<T>();
  const bool live = x < w && ch < c;
  const bool hi = ch + kHalf < c;
  const int y1 = min(y0 + kTileY, h) - 1, x1 = min(x0 + kTileX, w) - 1;
  const int per_roi = n * (kTileY + kTileX);

  float acc[kTileY][kVec];
#pragma unroll
  for (int i = 0; i < kTileY; ++i)
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[i][v] = 0.0f;

  for (int base = 0; base < k; base += kTileThreads) {
    // This pass's ROIs whose spans meet the tile, listed in index order.
    bool hit = false;
    if (base + t < k) {
      const int4 s = spans[base + t];
      hit = s.x <= s.y && s.z <= s.w && s.x <= y1 && s.y >= y0 &&
            s.z <= x1 && s.w >= x0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    __syncthreads();  // the previous pass's readers of the list are done
    if (lane == 0) sm.warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int at = 0, listed = 0;
#pragma unroll
    for (int i = 0; i < kTileThreads / 32; ++i) {
      at += i < warp ? sm.warp_hits[i] : 0;
      listed += sm.warp_hits[i];
    }
    if (hit) sm.list[at + __popc(ballot & ((1u << lane) - 1u))] = base + t;

    for (int s0 = 0; s0 < listed; s0 += kStage) {
      const int staged = min(kStage, listed - s0);
      __syncthreads();  // the list is written; the last stage's readers done
      for (int e = t; e < staged * per_roi; e += kTileThreads) {
        const int j = e / per_roi, r = e % per_roi;
        const int roi = sm.list[s0 + j];
        if (r < n * kTileY) {
          const int p = r / kTileY, i = r % kTileY;
          sm.wy[j][p][i] = y0 + i < h ? wt.y(roi, p, y0 + i) : 0.0f;
        } else {
          const int rx = r - n * kTileY;
          const int q = rx / kTileX, i = rx % kTileX;
          sm.wx[j][q][i] = x0 + i < w ? wt.x(roi, q, x0 + i) : 0.0f;
        }
      }
      __syncthreads();
      if (live) {
        for (int j = 0; j < staged; ++j)
          accumulate_roi<T>(sm, j, g + (size_t)sm.list[s0 + j] * n * n * c + ch,
                            n, c, tx, hi, acc);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < kTileY; ++i)
    if (y0 + i <= y1)
      store_vec(df + ((size_t)(y0 + i) * w + x) * c + ch, hi, acc[i]);
}

// ---------------------------------------------------------------------------
// The forward gather (K2, K5).
// ---------------------------------------------------------------------------
//
// It replaces the Pallas kernel `_fwd_kernel`
// (livecell_tpu/ops/pallas_roi_align.py:126), which ran out[p, q, c] =
// sum_y sum_x Wy[p, y] Wx[q, x] F[y, x, c] as two dense MXU matmuls over
// all of H and W, the row sum rounded to T (:138). On this card it is
// bound by bytes: a weight row has at most 2 ratio non-zero taps, so a
// bin reads at most (2 ratio)^2 = 16 feature vectors, the multiply-adds
// are few and the tensor cores have nothing dense to chew on; the least
// traffic is the output plus the feature pixels the taps touch. The
// gather it replaces gave a block one ROI and each of its 256 threads
// one channel: every thread walked all n^2 bins in series (a chain of
// 784 loads at 7x7, 3,136 at 14x14), each tap a 2-byte load with its own
// index arithmetic and zero tests, after the block had staged or computed
// full weight rows (n (H + W) values; 26 KB of shared memory at P2 for
// n = 14, sized by the largest level for every block) and scanned them
// for each row's non-zero range: 11-13x its byte bound for K2, 11-27x
// for K5. Here:
//   - a block of 4 warps owns one ROI; they first build, in shared
//     memory, a tap list for each of the ROI's 2n weight rows: the
//     (pixel, weight) pairs whose weight is non-zero, in ascending pixel
//     order (warp ballots), at most kMaxTaps = 2 kMaxRatio of them. K2
//     scans K1's rows; K5 evaluates pooled_weight only over bin_window,
//     never over a whole row. 2.4 KB of static shared memory on any map;
//   - the warps then take the n^2 bins (and 256-channel slices) in turn;
//     a lane owns 8 channels as 16-byte vectors (f32: two 4-channel
//     vectors half a slice apart), so one warp's loads of a pixel are 512
//     contiguous bytes in bf16 and the bins run in parallel;
//   - within a bin, the loads of two x taps' first four y taps (8
//     vectors; a sampling ratio of 2 has no more) are issued before
//     their multiply-adds, with a fixed, predicated trip count: 128
//     registers in bf16, 4 blocks an SM;
//   - a row with more non-zero taps than a list holds (K2 given weights
//     of a sampling ratio above kMaxRatio; K5's wrapper refuses such a
//     ratio) sends its whole ROI through the same gather over the weight
//     rows themselves, each from its first to its last non-zero pixel,
//     zeros skipped: slower, and the same result. No list is cut short.
// The sum order is the row-at-a-time gather's, so the output is the same
// bit for bit: for each output (p, q, c), x over the non-zero taps of
// Wx[q] in ascending order; t the fmaf chain from 0 over the non-zero
// taps of Wy[p], y ascending; acc = fmaf(wx, round_to<T>(t), acc) from 0;
// out = from_f32<T>(acc). A tap with a zero weight is skipped, never
// multiplied, so a non-finite feature value under it stays out of the
// sum. (4 warps and 2 x taps a group beat 2, 8 and 16 warps, 1 and 4 x
// taps a group and launch bounds of 2 to 4 blocks at the serving and
// training shapes on an H100; PERF.md section 6.)

constexpr int kMaxRatio = 4;             // largest sampling ratio of a list
constexpr int kMaxTaps = 2 * kMaxRatio;  // entries of a tap list
constexpr int kChunk = 4;                // y taps whose loads go together
constexpr int kFwdWarps = 4;             // warps of a forward block
constexpr int kFwdThreads = 32 * kFwdWarps;

// The tap lists of one ROI: row r < n is Wy[p = r], else Wx[q = r - n];
// first/last: the row's first and last non-zero pixel (0, -1 if none).
struct FwdShared {
  int idx[2 * kMaxBins][kMaxTaps];    // pixels, ascending
  float w[2 * kMaxBins][kMaxTaps];    // their non-zero weights, f32 of T
  int count[2 * kMaxBins];            // entries of each row
  int first[2 * kMaxBins];
  int last[2 * kMaxBins];
};

// Taps from the lists; the loads of kGroup x taps' y taps are issued
// together.
struct ListTaps {
  static constexpr int kGroup = 2;
  const FwdShared& sm;
  __device__ __forceinline__ int count(int r) const { return sm.count[r]; }
  __device__ __forceinline__ int index(int r, int i) const {
    return sm.idx[r][i];
  }
  __device__ __forceinline__ float weight(int r, int i) const {
    return sm.w[r][i];
  }
};

// Taps from the weight rows themselves: every pixel of a row from its
// first to its last non-zero one, zeros included (the gather skips
// them), one x tap at a time.
template <typename Weights>
struct RowTaps {
  static constexpr int kGroup = 1;
  const FwdShared& sm;
  Weights wt;
  int roi;
  __device__ __forceinline__ int count(int r) const {
    return sm.last[r] - sm.first[r] + 1;
  }
  __device__ __forceinline__ int index(int r, int i) const {
    return sm.first[r] + i;
  }
  __device__ __forceinline__ float weight(int r, int i) const {
    return wt.row(roi, r, sm.first[r] + i);
  }
};

// Builds the ROI's tap lists, the warps strided over its 2n rows, each
// scanning its rows' windows 32 pixels at a time. Run by the whole block;
// returns, in every thread, whether some row has more than kMaxTaps
// non-zero taps (its list then holds only the first kMaxTaps).
template <typename Weights>
__device__ __forceinline__ bool build_taps(const Weights& wt, int roi,
                                           FwdShared& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool over = false;
  for (int r = warp; r < 2 * wt.n; r += kFwdWarps) {
    const int2 win = wt.window(roi, r);
    int count = 0, first = 0, last = -1;
    for (int g0 = win.x; g0 <= win.y; g0 += 32) {  // uniform in the warp
      const int g = g0 + lane;
      const float v = g <= win.y ? wt.row(roi, r, g) : 0.0f;
      const unsigned nz = __ballot_sync(0xffffffffu, v != 0.0f);
      const int at = count + __popc(nz & ((1u << lane) - 1u));
      if (v != 0.0f && at < kMaxTaps) {
        sm.idx[r][at] = g;
        sm.w[r][at] = v;
      }
      if (nz) {
        if (count == 0) first = g0 + __ffs(nz) - 1;
        last = g0 + 31 - __clz(nz);
      }
      count += __popc(nz);
    }
    if (lane == 0) {
      sm.count[r] = count;
      sm.first[r] = first;
      sm.last[r] = last;
    }
    over |= count > kMaxTaps;
  }
  return __syncthreads_or(over);
}

// Entries i0.. of row r's taps, N of them; past the row's count, weight
// 0 (skipped).
template <int N, typename Taps>
__device__ __forceinline__ void tap_chunk(const Taps& taps, int r, int i0,
                                          int (&idx)[N], float (&wt)[N]) {
  const int count = taps.count(r);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool in = i0 + i < count;
    idx[i] = in ? taps.index(r, i0 + i) : 0;
    wt[i] = in ? taps.weight(r, i0 + i) : 0.0f;
  }
}

// t = fmaf(wy[j], F[y_j], t) over the loaded vectors with non-zero
// weights, j in order.
template <typename T>
__device__ __forceinline__ void fma_chunk(const Raw<T> (&raw)[kChunk],
                                          const float (&wy)[kChunk],
                                          float (&t)[kVec]) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (wy[j] == 0.0f) continue;
    float f[kVec];
    unpack(raw[j], f);
#pragma unroll
    for (int v = 0; v < kVec; ++v) t[v] = fmaf(wy[j], f[v], t[v]);
  }
}

// One bin (p, q) for a lane's kVec channels, `fc` pointing at F[0, 0,
// ch] of the map [h, w, c]. The loads of a group of x taps' first kChunk
// y taps are issued together; further y taps (a sampling ratio above 2)
// are loaded kChunk at a time for each x tap. Every row's taps ascend, so
// the sums run in the order the note above states.
template <typename T, typename Taps>
__device__ __forceinline__ void gather_bin(const Taps& taps,
                                           const T* __restrict__ fc, int p,
                                           int q, int n, int w, int c,
                                           bool hi, float (&acc)[kVec]) {
  constexpr int kGroup = Taps::kGroup;
  const int ny = taps.count(p), nx = taps.count(n + q);
  int ys[kChunk];
  float wys[kChunk];
  tap_chunk(taps, p, 0, ys, wys);
#pragma unroll
  for (int v = 0; v < kVec; ++v) acc[v] = 0.0f;
  for (int i0 = 0; i0 < nx; i0 += kGroup) {
    int xs[kGroup];
    float wxs[kGroup];
    tap_chunk(taps, n + q, i0, xs, wxs);
    Raw<T> raw[kGroup][kChunk];
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (wxs[i] != 0.0f && wys[j] != 0.0f)
          load_raw(fc + ((size_t)ys[j] * w + xs[i]) * c, hi, raw[i][j]);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (wxs[i] == 0.0f) continue;
      float t[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) t[v] = 0.0f;
      fma_chunk<T>(raw[i], wys, t);
      for (int j0 = kChunk; j0 < ny; j0 += kChunk) {
        int ym[kChunk];
        float wym[kChunk];
        tap_chunk(taps, p, j0, ym, wym);
        Raw<T> more[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          if (wym[j] != 0.0f)
            load_raw(fc + ((size_t)ym[j] * w + xs[i]) * c, hi, more[j]);
        fma_chunk<T>(more, wym, t);
      }
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        acc[v] = fmaf(wxs[i], round_to<T>(t[v]), acc[v]);
    }
  }
}

// The ROI's output ob [n, n, c] from its map fb [h, w, c], the warps
// strided over (bin, 256-channel slice) pairs, bins in order.
template <typename T, typename Taps>
__device__ __forceinline__ void gather_roi(const Taps& taps,
                                           const T* __restrict__ fb,
                                           T* __restrict__ ob, int n, int w,
                                           int c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slices = (c + kSlice - 1) / kSlice;
  for (int e = warp; e < n * n * slices; e += kFwdWarps) {
    const int bin = e / slices;
    const int ch = e % slices * kSlice + lane * lane_channels<T>();
    if (ch >= c) continue;
    const bool hi = ch + kHalf < c;
    float acc[kVec];
    gather_bin<T>(taps, fb + ch, bin / n, bin % n, n, w, c, hi, acc);
    store_vec(ob + (size_t)bin * c + ch, hi, acc);
  }
}

// The forward of one ROI: out ob [n, n, c] from the map fb [h, w, c] of
// its image (and level) and the weights `wt` (RowWeights, BoxWeights).
// Run by all kFwdThreads threads of the block.
template <typename T, typename Weights>
__device__ __forceinline__ void forward_roi(const Weights& wt, int roi,
                                            const T* __restrict__ fb,
                                            T* __restrict__ ob, int c,
                                            FwdShared& sm) {
  if (build_taps(wt, roi, sm))
    gather_roi<T>(RowTaps<Weights>{sm, wt, roi}, fb, ob, wt.n, wt.w, c);
  else
    gather_roi<T>(ListTaps{sm}, fb, ob, wt.n, wt.w, c);
}

}  // namespace livecell
