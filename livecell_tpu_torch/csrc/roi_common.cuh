// Shared device code of the RoIAlign kernels (roi_align.cu: K1-K3,
// ms_roi_align.cu: K5-K6): conversions between the feature dtype and
// f32, the pooled bilinear weight of one bin and one feature pixel, the
// forward gather of one ROI (K2, K5), and the tiled backward (K3, K6).
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

// The pooled weight of output bin p (of n) on feature pixel g along one
// axis of a box [lo, hi] (image coordinates): torchvision RoIAlign,
// aligned=False, `ratio` samples per bin at offsets (s + 0.5) / ratio,
// samples outside [-1, size] weigh 0, the side floored at 1 feature
// pixel, the mean of the samples' two-tap weights. The rounded
// intrinsics (__fmul_rn, ...) stop the compiler from fusing a*b+c into
// one FMA, so every step rounds where the plain PyTorch version's
// separate tensor ops round and the f32 weight agrees bit for bit.
__device__ __forceinline__ float pooled_weight(float lo, float hi, float scale,
                                               int n, int size, int ratio,
                                               int p, int g) {
  const float start = __fmul_rn(lo, scale);
  const float bin = __fdiv_rn(
      fmaxf(__fsub_rn(__fmul_rn(hi, scale), start), 1.0f), (float)n);
  float acc = 0.0f;
  for (int s = 0; s < ratio; ++s) {
    // (s + 0.5) / ratio in double, rounded once: the plain version's
    // Python scalar.
    const float off = (float)((s + 0.5) / ratio);
    const float c = __fadd_rn(start, __fmul_rn(__fadd_rn((float)p, off), bin));
    if (c >= -1.0f && c <= (float)size) {
      const float cc = fminf(fmaxf(c, 0.0f), (float)(size - 1));
      acc = __fadd_rn(
          acc, fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(cc, (float)g)))));
    }
  }
  return __fdiv_rn(acc, (float)ratio);
}

// The pooled contraction of one ROI, run by every thread of its block:
// out[p, q, c] = sum_y sum_x Wy[p, y] Wx[q, x] F[y, x, c] with f32
// accumulation, from the ROI's n Wy rows `sy` [n, h] and n Wx rows `sx`
// [n, w] staged in shared memory (as f32 values of T). `first`/`last`
// [2n] are shared scratch for each row's non-zero index range; the
// threads run across channels, so neighbouring threads load
// neighbouring channels of the NHWC map `fb` [h, w, c] (coalesced) and
// loop only over the non-zero taps. For T = bf16 the row contraction is
// rounded to bf16 before the column contraction, where the Pallas kernel
// rounds (livecell_tpu/ops/pallas_roi_align.py:138).
template <typename T>
__device__ void pool_roi(const float* sy, const float* sx, int* first,
                         int* last, const T* __restrict__ fb,
                         T* __restrict__ ob, int n, int h, int w, int c) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int r = warp; r < 2 * n; r += n_warps) {
    const bool is_y = r < n;
    const int len = is_y ? h : w;
    const float* row = is_y ? sy + r * h : sx + (r - n) * w;
    int lo = len, hi = -1;
    for (int i = lane; i < len; i += 32) {
      if (row[i] != 0.0f) {
        lo = min(lo, i);
        hi = max(hi, i);
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      first[r] = lo;
      last[r] = hi;
    }
  }
  __syncthreads();

  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    for (int p = 0; p < n; ++p) {
      const float* ry = sy + p * h;
      const int y0 = first[p], y1 = last[p];
      for (int q = 0; q < n; ++q) {
        const float* rx = sx + q * w;
        float acc = 0.0f;
        for (int x = first[n + q]; x <= last[n + q]; ++x) {
          const float wxv = rx[x];
          if (wxv == 0.0f) continue;  // uniform across the block
          float t = 0.0f;
          for (int y = y0; y <= y1; ++y) {
            const float wyv = ry[y];
            if (wyv == 0.0f) continue;
            t = fmaf(wyv, to_f32(fb[((size_t)y * w + x) * c + ch]), t);
          }
          acc = fmaf(wxv, round_to<T>(t), acc);
        }
        ob[((size_t)p * n + q) * c + ch] = from_f32<T>(acc);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The tiled backward (K3, K6).
// ---------------------------------------------------------------------------

constexpr int kMaxBins = 16;       // largest out_size the backward takes
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

// K3's weights: rows of K1's tensors Wy [K, n, H], Wx [K, n, W] of one
// image.
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
};

// K6's weights: recomputed from the boxes [K, 4] of one image on one
// level, rounded to T as K1 rounds them.
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
};

// `hi`: the second f32 vector lies inside the map's channels.
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, bool,
                                         float (&v)[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(const float* p, bool hi,
                                         float (&v)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = hi ? *reinterpret_cast<const float4*>(p + kHalf)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
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

}  // namespace livecell
