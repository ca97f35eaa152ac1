// Multiscale (FPN) RoIAlign on Hopper (sm_90a): the forward (K5) and its
// backward with respect to the four level maps (K6). Plain C entry
// points, loaded with ctypes by livecell_tpu_torch/ops/cuda_ms_roi_align.py,
// which holds the plain PyTorch version of each kernel, the launch
// counters and the level assignment.
//
// Semantics: torchvision MultiScaleRoIAlign over P2-P5 (strides 4, 8, 16,
// 32): each ROI pools from its LevelMapper level only (levels [B*K] int32,
// computed once by the wrapper and shared by both kernels and both plain
// versions, so none can disagree at a level boundary), by RoIAlign with
// aligned=False, `ratio` samples per bin, on that level at scale
// 0.25 / 2^l. The pooled weights are roi_common.cuh:pooled_weight rounded
// to the feature dtype, the values of K1 (roi_align.cu).
//
// K5 ms_roi_align_fwd_kernel replaces the JAX composition
//    `ms_roi_align_pallas` (livecell_tpu/ops/pallas_ms_roi.py:57), which
//    pools every ROI from all four levels with the Pallas kernels
//    `_weights_kernel` and `_fwd_kernel` (pallas_roi_align.py:90,126) and
//    keeps one level with `where`: 4x the work. Bound by bytes: each bin
//    reads at most (2 ratio)^2 feature vectors; the least traffic is the
//    output plus the feature pixels the taps touch. Its first design gave
//    a block one ROI and computed the ROI's n Wy rows and n Wx rows on its
//    level in full into shared memory (pooled_weight at n (H_l + W_l)
//    pixels, 3,304 at P2 for n = 7, though a row has at most 2 ratio
//    non-zero taps; the dynamic shared memory sized by the largest level
//    for every block, 26 KB for n = 14), scanned them again for each
//    row's non-zero range, then each of 256 threads took one channel and
//    walked every bin in series with 2-byte loads: 11x the byte bound at
//    the serving shape, 27x at T3's 14x14. It is now
//    roi_common.cuh:forward_roi on the ROI's own level with the weights
//    computed from the box (BoxWeights): one block per ROI builds each
//    row's list of non-zero taps, evaluating pooled_weight rounded to
//    the map's dtype only over the bin's window (its samples widened by
//    two pixels, clamped to the map), 2.4 KB of static shared memory on
//    every level; its warps share out the bins, 8 channels a lane in
//    16-byte vectors, each bin's tap loads issued before its
//    multiply-adds. The sum order is the old gather's, so the output is
//    the same bit for bit. The wrapper refuses a sampling ratio above 4,
//    the most a list of 8 taps holds.
//
// K6 ms_roi_align_bwd_kernel replaces the composition's backward, the
//    Pallas `_bwd_kernel` (pallas_roi_align.py:152) run once per level.
//    dF_l[b,y,x,c] = sum_k [level_k = l] sum_p Wy[k,p,y] u[k,p,x,c] with
//    u = sum_q Wx[k,q,x] g[b,k,p,q,c]. Bound by bytes: g read once, the
//    four maps' gradients written whole (about 0.2 GB in bf16 at 4
//    images, K = 512). The row gather it replaces worked as K3's did: one
//    block per feature row of one level, every block walking all K ROIs,
//    and its shared memory sized by the widest level for every block
//    (the f32 row of 272 x 128 sums, the Wx rows and g: about 163 KB, so
//    one 4-warp block per SM, even for the P5 rows that need 17 KB); for
//    each ROI that hit the row it recomputed n x W_l weights, 141x the
//    byte bound. It is now K3 on four levels, roi_common.cuh:
//    backward_tile with the weights recomputed from the box
//    (BoxWeights): ms_roi_spans_kernel computes each ROI's non-zero row
//    and column span on its own level with pooled_weight rounded to the
//    map's dtype, as the main kernel does (one warp per ROI, scanning a
//    window two pixels wider than the box on each side), and writes
//    empty spans for the other levels; one 4-warp block owns an 8 x 4
//    pixel tile of one level of one image and 256 channels (the tiles of
//    P2-P5 run in one grid), 13 KB of shared memory on every level, lists
//    the ROIs of its level whose spans meet the tile in index order and
//    recomputes their weights on the tile's rows and columns only. No
//    weight tensor is stored between the forward and the backward. The
//    sum order is the row gather's, so the result is the same bit for
//    bit, in every run, with no atomics. Rounding follows the Pallas
//    kernel: u rounded to the feature dtype, dF summed in f32 and
//    rounded once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "roi_common.cuh"

namespace {

using livecell::backward_tile;
using livecell::BoxWeights;
using livecell::forward_roi;
using livecell::FwdShared;
using livecell::kFwdThreads;
using livecell::kMaxBins;
using livecell::kMaxRatio;
using livecell::kSlice;
using livecell::kSpanThreads;
using livecell::kTileMinBlocks;
using livecell::kTileThreads;
using livecell::kTileX;
using livecell::kTileY;
using livecell::pooled_weight;
using livecell::round_to;
using livecell::TileShared;

constexpr int kLevels = 4;

// The four level maps (or their gradients) and their geometry.
struct Pyramid {
  void* ptr[kLevels];
  int h[kLevels];
  int w[kLevels];
  float scale[kLevels];
};

__device__ __forceinline__ int level_of(const int* levels, size_t roi) {
  return min(max(levels[roi], 0), kLevels - 1);
}

// One block per ROI (b * k + ki), on its own level; the shared memory is
// the ROI's tap lists, roi_common.cuh:FwdShared, static.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
ms_roi_align_fwd_kernel(Pyramid pyr, const float* __restrict__ boxes,
                        const int* __restrict__ levels, T* __restrict__ out,
                        int k, int n, int c, int ratio) {
  __shared__ FwdShared sm;
  const int roi = blockIdx.x;
  const int l = level_of(levels, roi);
  const int h = pyr.h[l], w = pyr.w[l];
  const BoxWeights<T> wt{boxes, pyr.scale[l], n, h, w, ratio};
  forward_roi<T>(wt, roi,
                 static_cast<const T*>(pyr.ptr[l]) +
                     (size_t)(roi / k) * h * w * c,
                 out + (size_t)roi * n * n * c, c, sm);
}

__host__ __device__ __forceinline__ int level_tiles(const Pyramid& pyr,
                                                    int l) {
  return ((pyr.h[l] + kTileY - 1) / kTileY) *
         ((pyr.w[l] + kTileX - 1) / kTileX);
}

// K6's pre-pass: one warp per ROI. On its own level l, the first and last
// feature row (column) where any of its n pooled weights, rounded to T,
// is non-zero: spans[l][roi] = (y_lo, y_hi, x_lo, x_hi), lo = size and
// hi = -1 if none; on the other levels an empty span. The samples of a
// box lie in [start, start + max(hi * scale - start, 1)], so its taps lie
// in that range widened by one pixel; the warp scans it widened by two,
// clamped to the map.
template <typename T>
__global__ void __launch_bounds__(kSpanThreads)
ms_roi_spans_kernel(Pyramid pyr, const float* __restrict__ boxes,
                    const int* __restrict__ levels, int4* __restrict__ spans,
                    long long rois, int n, int ratio) {
  const long long roi =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (roi >= rois) return;  // a whole warp leaves together
  const int l = level_of(levels, roi);
  const float scale = pyr.scale[l];
  int lo[2], hi[2];
  for (int a = 0; a < 2; ++a) {
    const int size = a ? pyr.w[l] : pyr.h[l];
    const float blo = boxes[roi * 4 + (a ? 0 : 1)];
    const float bhi = boxes[roi * 4 + (a ? 2 : 3)];
    const float start = __fmul_rn(blo, scale);
    const float end =
        start + fmaxf(__fsub_rn(__fmul_rn(bhi, scale), start), 1.0f);
    // A NaN end point gives the whole axis.
    const float f0 = floorf(start) - 2.0f, f1 = ceilf(end) + 2.0f;
    const int g0 = f0 > 0.0f ? (int)fminf(f0, (float)(size - 1)) : 0;
    const int g1 = f1 < (float)(size - 1) ? (int)fmaxf(f1, 0.0f) : size - 1;
    const int len = max(g1 - g0 + 1, 0);
    int first = size, last = -1;
    for (int i = lane; i < n * len; i += 32) {
      const int gg = g0 + i % len;
      if (round_to<T>(pooled_weight(blo, bhi, scale, n, size, ratio, i / len,
                                    gg)) != 0.0f) {
        first = min(first, gg);
        last = max(last, gg);
      }
    }
    lo[a] = __reduce_min_sync(0xffffffffu, first);
    hi[a] = __reduce_max_sync(0xffffffffu, last);
  }
  if (lane != 0) return;
  for (int lv = 0; lv < kLevels; ++lv)
    spans[lv * rois + roi] = lv == l ? make_int4(lo[0], hi[0], lo[1], hi[1])
                                     : make_int4(pyr.h[lv], -1, pyr.w[lv], -1);
}

// Grid (the tiles of P2-P5, P2's first, x channel slices, the slices of
// a tile side by side; images); the shared memory is
// roi_common.cuh:TileShared, static.
template <typename T>
__global__ void __launch_bounds__(kTileThreads, kTileMinBlocks)
ms_roi_align_bwd_kernel(Pyramid dpyr, const T* __restrict__ g,
                        const float* __restrict__ boxes,
                        const int4* __restrict__ spans, int b, int k, int n,
                        int c, int ratio) {
  __shared__ TileShared sm;
  const int slices = (c + kSlice - 1) / kSlice;
  int tile = blockIdx.x / slices, l = 0;
  while (l < kLevels - 1 && tile >= level_tiles(dpyr, l))
    tile -= level_tiles(dpyr, l++);
  const int h = dpyr.h[l], w = dpyr.w[l];
  const int tiles_x = (w + kTileX - 1) / kTileX;
  const size_t roi0 = (size_t)blockIdx.y * k;
  const BoxWeights<T> wt{boxes + roi0 * 4, dpyr.scale[l], n, h, w, ratio};
  backward_tile<T>(wt, spans + (size_t)l * b * k + roi0, g + roi0 * n * n * c,
                   static_cast<T*>(dpyr.ptr[l]) +
                       (size_t)blockIdx.y * h * w * c,
                   k, n, h, w, c, tile / tiles_x * kTileY,
                   tile % tiles_x * kTileX, blockIdx.x % slices * kSlice, sm);
}

Pyramid make_pyramid(void* const* ptrs, const int* hs, const int* ws) {
  Pyramid pyr;
  for (int l = 0; l < kLevels; ++l) {
    pyr.ptr[l] = ptrs[l];
    pyr.h[l] = hs[l];
    pyr.w[l] = ws[l];
    pyr.scale[l] = 0.25f / (float)(1 << l);
  }
  return pyr;
}

template <typename T>
cudaError_t launch_fwd(const Pyramid& pyr, const void* boxes,
                       const void* levels, void* out, int b, int k, int n,
                       int c, int ratio, cudaStream_t stream) {
  ms_roi_align_fwd_kernel<T><<<b * k, kFwdThreads, 0, stream>>>(
      pyr, static_cast<const float*>(boxes), static_cast<const int*>(levels),
      static_cast<T*>(out), k, n, c, ratio);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_spans(const Pyramid& pyr, const void* boxes,
                         const void* levels, void* spans, long long rois,
                         int n, int ratio, cudaStream_t stream) {
  const long long blocks = (rois * 32 + kSpanThreads - 1) / kSpanThreads;
  ms_roi_spans_kernel<T><<<blocks, kSpanThreads, 0, stream>>>(
      pyr, static_cast<const float*>(boxes), static_cast<const int*>(levels),
      static_cast<int4*>(spans), rois, n, ratio);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const Pyramid& dpyr, const void* g, const void* boxes,
                       const void* levels, void* spans, int b, int k, int n,
                       int c, int ratio, cudaStream_t stream) {
  if ((long long)b * k > 0) {
    const cudaError_t e = launch_spans<T>(dpyr, boxes, levels, spans,
                                          (long long)b * k, n, ratio, stream);
    if (e != cudaSuccess) return e;
  }
  int tiles = 0;
  for (int l = 0; l < kLevels; ++l) tiles += level_tiles(dpyr, l);
  const dim3 grid(tiles * ((c + kSlice - 1) / kSlice), b);
  ms_roi_align_bwd_kernel<T><<<grid, kTileThreads, 0, stream>>>(
      dpyr, static_cast<const T*>(g), static_cast<const float*>(boxes),
      static_cast<const int4*>(spans), b, k, n, c, ratio);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// feats: 4 pointers to [b, hs[l], ws[l], c] maps; boxes [b, k, 4] f32,
// levels [b, k] int32 in 0..3 -> out [b, k, n, n, c], all maps and out
// bf16 if `bf16`, else f32. c a multiple of 8, the maps and out 16-byte
// aligned, 1 <= ratio <= 4. Returns cudaGetLastError() after the launch.
int livecell_ms_roi_align_fwd(void* const* feats, const int* hs,
                              const int* ws, const void* boxes,
                              const void* levels, void* out, int b, int k,
                              int n, int c, int ratio, int bf16,
                              void* stream) {
  if (b * k == 0 || c == 0) return 0;
  if (n > kMaxBins || c % livecell::kVec != 0 || ratio < 1 ||
      ratio > kMaxRatio)
    return (int)cudaErrorInvalidValue;
  const Pyramid pyr = make_pyramid(feats, hs, ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_fwd<__nv_bfloat16>(pyr, boxes, levels, out, b, k, n, c,
                                       ratio, st)
           : launch_fwd<float>(pyr, boxes, levels, out, b, k, n, c, ratio, st);
  return (int)e;
}

// boxes [rois, 4] f32, levels [rois] int32 -> spans [4, rois] int4
// (y_lo, y_hi, x_lo, x_hi) on each level of maps hs x ws, K6's pre-pass
// alone (the backward launches it itself).
int livecell_ms_roi_spans(const int* hs, const int* ws, const void* boxes,
                          const void* levels, void* spans, long long rois,
                          int n, int ratio, int bf16, void* stream) {
  if (rois == 0) return 0;
  void* none[kLevels] = {nullptr, nullptr, nullptr, nullptr};
  const Pyramid pyr = make_pyramid(none, hs, ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_spans<__nv_bfloat16>(pyr, boxes, levels, spans, rois, n,
                                         ratio, st)
           : launch_spans<float>(pyr, boxes, levels, spans, rois, n, ratio,
                                 st);
  return (int)e;
}

// g [b, k, n, n, c], boxes [b, k, 4] f32, levels [b, k] int32 ->
// dfeats: 4 pointers to [b, hs[l], ws[l], c] (each written whole), all
// bf16 if `bf16`, else f32; spans [4, b, k] int4 is the pre-pass's
// scratch. c a multiple of 8, g and the gradients 16-byte aligned.
int livecell_ms_roi_align_bwd(void* const* dfeats, const int* hs,
                              const int* ws, const void* g, const void* boxes,
                              const void* levels, void* spans, int b, int k,
                              int n, int c, int ratio, int bf16,
                              void* stream) {
  if (b == 0 || c == 0) return 0;
  if (n > kMaxBins || c % livecell::kVec != 0)
    return (int)cudaErrorInvalidValue;
  const Pyramid dpyr = make_pyramid(dfeats, hs, ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_bwd<__nv_bfloat16>(dpyr, g, boxes, levels, spans, b, k,
                                       n, c, ratio, st)
           : launch_bwd<float>(dpyr, g, boxes, levels, spans, b, k, n, c,
                               ratio, st);
  return (int)e;
}

// Resident blocks of the forward kernel on one SM, or minus the CUDA
// error.
int livecell_ms_roi_align_fwd_blocks_per_sm(int bf16) {
  int blocks = 0;
  const cudaError_t e =
      bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, ms_roi_align_fwd_kernel<__nv_bfloat16>,
                 kFwdThreads, 0)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, ms_roi_align_fwd_kernel<float>, kFwdThreads, 0);
  return e == cudaSuccess ? blocks : -(int)e;
}

// Resident blocks of the backward kernel on one SM, or minus the CUDA
// error.
int livecell_ms_roi_align_bwd_blocks_per_sm(int bf16) {
  int blocks = 0;
  const cudaError_t e =
      bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, ms_roi_align_bwd_kernel<__nv_bfloat16>,
                 kTileThreads, 0)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, ms_roi_align_bwd_kernel<float>, kTileThreads, 0);
  return e == cudaSuccess ? blocks : -(int)e;
}

const char* livecell_ms_roi_align_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
