// RoIAlign forward on Hopper (sm_90a): the pooled bilinear weights (K1)
// and the pooled-feature gather (K2). Plain C entry points, loaded with
// ctypes by livecell_tpu_torch/ops/cuda_roi_align.py, which holds the
// plain PyTorch version of each kernel and the launch counters.
//
// Semantics: torchvision RoIAlign, aligned=False, `ratio` samples per
// bin and axis, samples outside [-1, size] weigh 0, side lengths
// floored at 1 feature pixel. The ratio x ratio sample mean factorizes
// into (mean of the y taps) x (mean of the x taps), so each output bin
// p has one pooled weight row over the feature rows (Wy) and one over
// the feature columns (Wx).
//
// K1 roi_weights_kernel replaces the Pallas kernel `_weights_kernel`
//    (livecell_tpu/ops/pallas_roi_align.py:90, entry `roi_weights`:101).
//    Bound by bytes: it reads 16 bytes per ROI and writes the weights
//    (7.6 MB at 32 images x 128 ROIs x 7 rows x (56 + 76) in bf16; 2.3 MB
//    at a frame's 25 x 50), so a call at the serving shapes is
//    launch-latency bound. The first design gave each element of Wy
//    [R, n, H] and Wx [R, n, W] a thread that found its row with 64-bit
//    divisions and ran roi_common.cuh:pooled_weight whole (a division for
//    the bin side, one in double per sample, one for the mean) to store 2
//    bytes: bound by instructions, about 15x its byte bound. Here each
//    thread writes one 16-byte vector of the flat output (8 bf16 or 4
//    f32; a vector crossing a row's end takes its rows in turn) with
//    32-bit index math. For each row it computes the constants once
//    (start, bin side), and for each valid sample its clamped coordinate
//    cc once: the sample's taps are positive on pixels floor(cc) and
//    floor(cc) + 1 only, so a sample that reaches none of the vector's
//    pixels is skipped, and one that does adds its taps to all of them
//    without a branch (+0 where it is more than a pixel away, which
//    leaves a sum of non-negative taps unchanged). The sample offsets
//    (s + 0.5) / ratio come from the host; the mean is a multiplication
//    by 1 / ratio where that is exact (ratio a power of two), else the
//    division. A call too small to fill the card (one tile's 50 ROIs)
//    is bound by the latency of a thread's chain, not by instructions:
//    there each thread writes one element through pooled_weight whole,
//    as the first design did, with 32-bit index math (one element of
//    the vector path a thread took 20% longer there). Every sum runs
//    over the same taps in pooled_weight's order with its float
//    operations, so every weight is the first design's bit for bit, and
//    the f32 weights agree with the plain version's.
//
// K2 roi_align_fwd_kernel replaces the Pallas kernel `_fwd_kernel`
//    (pallas_roi_align.py:126, entry `roi_align_pallas`:197 via
//    `_forward`:220). out[b,k,p,q,c] = sum_y sum_x Wy[b,k,p,y]
//    Wx[b,k,q,x] F[b,y,x,c], f32 accumulation, the row sum rounded to
//    bf16 for bf16 input where the Pallas kernel rounds (:138). Bound by
//    bytes: each weight row has at most 2*ratio non-zero taps, so a bin
//    gathers at most 16 feature vectors and the operations are few; the
//    least traffic is the feature map read once plus the weights and the
//    output (about 88 MB at 25 x 56 x 76 x 256 bf16, K = 50). The TPU
//    kernel ran the two contractions as dense MXU matmuls over all of H
//    and W. The gather that replaced it first gave each of a block's 256
//    threads one channel of one ROI and walked every bin in series, each
//    tap a 2-byte load, over full weight rows staged in shared memory
//    (11-13x the byte bound). It is now the one-level case of
//    roi_common.cuh:forward_roi with K1's rows (RowWeights): one block
//    per ROI builds each of its 2n rows' list of non-zero taps, scanning
//    the K1 row once, and its warps share out the bins, 8 channels a lane
//    in 16-byte vectors, each bin's tap loads issued before its
//    multiply-adds. The sum order is the old gather's, so the output is
//    the same bit for bit. A ROI with a row of more taps than a list
//    holds (a sampling ratio above 4) is gathered from its K1 rows.
//
// K3 roi_align_bwd_kernel replaces the Pallas kernel `_bwd_kernel`
//    (pallas_roi_align.py:152, called from the custom VJP `_bwd_rule`
//    :280). dF[b,y,x,c] = sum_k sum_p Wy[b,k,p,y] u[b,k,p,x,c] with
//    u = sum_q Wx[b,k,q,x] g[b,k,p,q,c], reusing K1's weights. Bound by
//    bytes: g, the weights and dF are each moved once (about 0.18 GB in
//    bf16 at 32 images, K = 128); the operations are few for the same
//    sparsity as K2's. The row gather it replaces gave each block one
//    feature row of one image and walked all K ROIs in it, reading each
//    ROI's Wy column with strided loads and its Wx rows again for every
//    ROI that hit the row, over the full map width (45x the byte bound
//    at 32 x 128, and 112 blocks at one image, fewer than the 132 SMs).
//    It is now the one-level case of roi_common.cuh:backward_tile:
//    roi_spans_kernel reads each ROI's non-zero row and column span off
//    its K1 rows (one warp per ROI), and one 4-warp block owns an 8 x 4
//    pixel tile and 256 channels, lists the ROIs whose spans meet the
//    tile in index order and reads only the tile's slices of their Wy and
//    Wx rows. The sum order is the row gather's, so the result is the
//    same bit for bit, in every run. Rounding follows the Pallas kernel:
//    u rounded to the features' dtype (pallas_roi_align.py:170), dF
//    summed in f32 and rounded once (:346).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "roi_common.cuh"

namespace {

using livecell::backward_tile;
using livecell::forward_roi;
using livecell::FwdShared;
using livecell::from_f32;
using livecell::kFwdThreads;
using livecell::kMaxBins;
using livecell::kSlice;
using livecell::kSpanThreads;
using livecell::kTileMinBlocks;
using livecell::kTileThreads;
using livecell::kTileX;
using livecell::kTileY;
using livecell::pooled_weight;
using livecell::RowWeights;
using livecell::sample_at;
using livecell::sample_offset;
using livecell::tap_weight;
using livecell::bin_side;
using livecell::TileShared;
using livecell::to_f32;

constexpr int kWeightThreads = 256;
constexpr int kHostOffsets = 16;  // sample offsets the host computes
// A call with fewer 16-byte vectors than this (about a quarter of the
// threads 132 SMs hold) is latency-bound: one element a thread instead.
constexpr int kMinVectors = 132 * 512;

// (s + 0.5) / ratio for s < kHostOffsets, computed on the host as
// sample_offset computes them (a double division, rounded once).
struct SampleOffsets {
  float v[kHostOffsets];
};

__device__ __forceinline__ float offset_of(const SampleOffsets& off, int s,
                                           int ratio) {
  return s < kHostOffsets ? off.v[s] : sample_offset(s, ratio);
}

// 16 bytes of weights, rounded to T.
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  livecell::store_vec(p, true, v);
}

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Thread v writes the kV elements v of Wy (v < vec_y) or v - vec_y of
// Wx, flat over [rois, n, size]: a 16-byte vector (kV = 16 / sizeof(T);
// a partial last vector element-wise), or (kV = 1) one element through
// pooled_weight whole. inv_ratio: 1 / ratio when that is exact (ratio a
// power of two), else 0.
template <typename T, int kV>
__global__ void __launch_bounds__(kWeightThreads)
roi_weights_kernel(const float* __restrict__ boxes, T* __restrict__ wy,
                   T* __restrict__ wx, int vec_y, int vec_total, int n_wy,
                   int n_wx, int n, int h, int w, int ratio, float scale,
                   float inv_ratio, SampleOffsets off) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= vec_total) return;
  const bool is_y = v < vec_y;
  const int e0 = (is_y ? v : v - vec_y) * kV;
  const int total = is_y ? n_wy : n_wx;
  const int size = is_y ? h : w;
  const int axis = is_y ? 1 : 0;  // the box's lo; hi is 2 further
  T* dst = (is_y ? wy : wx) + e0;
  int r = e0 / size, g = e0 - r * size;
  if constexpr (kV == 1) {
    const int roi = r / n;
    *dst = from_f32<T>(pooled_weight(boxes[roi * 4 + axis],
                                     boxes[roi * 4 + axis + 2], scale, n,
                                     size, ratio, r - roi * n, g));
  } else {
    float acc[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) acc[i] = 0.0f;
    // The vector's elements i0 .. i0 + len - 1 are pixels g .. g + len - 1
    // of row r (bin p of ROI roi); more than one row where the vector
    // crosses a row's end.
    for (int i0 = 0; i0 < kV && e0 + i0 < total;) {
      const int len = min(size - g, kV - i0);
      const int roi = r / n, p = r - roi * n;
      const float lo = boxes[roi * 4 + axis], hi = boxes[roi * 4 + axis + 2];
      const float start = __fmul_rn(lo, scale);
      const float bin = bin_side(lo, hi, scale, n);
      for (int s = 0; s < ratio; ++s) {
        const float c = sample_at(start, bin, p, offset_of(off, s, ratio));
        if (!(c >= -1.0f && c <= (float)size)) continue;  // NaN too
        const float cc = fminf(fmaxf(c, 0.0f), (float)(size - 1));
        // Its taps are positive on pixels floor(cc) and floor(cc) + 1 only.
        const int g0 = (int)cc;
        if (g0 + 1 < g || g0 >= g + len) continue;
#pragma unroll
        for (int i = 0; i < kV; ++i) {
          const float t = tap_weight(cc, g + i - i0);
          if (i >= i0 && i < i0 + len) acc[i] = __fadd_rn(acc[i], t);
        }
      }
      i0 += len;
      ++r;
      g = 0;
    }
    // The mean: a multiplication by 1 / ratio where that is exact gives the
    // same correctly rounded quotient as the division.
    float out[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i)
      out[i] = inv_ratio != 0.0f ? __fmul_rn(acc[i], inv_ratio)
                                 : __fdiv_rn(acc[i], (float)ratio);
    if (e0 + kV <= total) {
      store16(dst, out);
    } else {
#pragma unroll
      for (int i = 0; i < kV; ++i)
        if (e0 + i < total) dst[i] = from_f32<T>(out[i]);
    }
  }
}

template <typename T, int kV>
cudaError_t launch_weights_kv(const float* boxes, T* wy, T* wx, int n_wy,
                              int n_wx, int n, int h, int w, int ratio,
                              float scale, cudaStream_t stream) {
  const int vec_y = (n_wy + kV - 1) / kV;
  const int vec_total = vec_y + (n_wx + kV - 1) / kV;
  SampleOffsets off;
  for (int s = 0; s < kHostOffsets; ++s)
    off.v[s] = s < ratio ? (float)((s + 0.5) / ratio) : 0.0f;
  const float inv = (ratio & (ratio - 1)) == 0 ? 1.0f / ratio : 0.0f;
  roi_weights_kernel<T, kV><<<(vec_total + kWeightThreads - 1) /
                                  kWeightThreads,
                              kWeightThreads, 0, stream>>>(
      boxes, wy, wx, vec_y, vec_total, n_wy, n_wx, n, h, w, ratio, scale,
      inv, off);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_weights(const void* boxes, void* wy, void* wx, int rois,
                           int n, int h, int w, int ratio, float scale,
                           cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const int n_wy = rois * n * h, n_wx = rois * n * w;
  const float* b = static_cast<const float*>(boxes);
  T* y = static_cast<T*>(wy);
  T* x = static_cast<T*>(wx);
  return (n_wy + n_wx) / kV < kMinVectors
             ? launch_weights_kv<T, 1>(b, y, x, n_wy, n_wx, n, h, w, ratio,
                                       scale, stream)
             : launch_weights_kv<T, kV>(b, y, x, n_wy, n_wx, n, h, w, ratio,
                                        scale, stream);
}

// One block per ROI (b * k + ki); the shared memory is the ROI's tap
// lists, roi_common.cuh:FwdShared, static.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
roi_align_fwd_kernel(const T* __restrict__ feat, const T* __restrict__ wy,
                     const T* __restrict__ wx, T* __restrict__ out, int k,
                     int n, int h, int w, int c) {
  __shared__ FwdShared sm;
  const int roi = blockIdx.x;
  const RowWeights<T> wt{wy, wx, n, h, w};
  forward_roi<T>(wt, roi, feat + (size_t)(roi / k) * h * w * c,
                 out + (size_t)roi * n * n * c, c, sm);
}

template <typename T>
cudaError_t launch_fwd(const void* feat, const void* wy, const void* wx,
                       void* out, int b, int k, int n, int h, int w, int c,
                       cudaStream_t stream) {
  roi_align_fwd_kernel<T><<<b * k, kFwdThreads, 0, stream>>>(
      static_cast<const T*>(feat), static_cast<const T*>(wy),
      static_cast<const T*>(wx), static_cast<T*>(out), k, n, h, w, c);
  return cudaGetLastError();
}

// K3's pre-pass: one warp per ROI finds the first and last feature row
// where any of its n Wy rows is non-zero, and the same over its Wx rows:
// spans[roi] = (y_lo, y_hi, x_lo, x_hi), lo = size and hi = -1 if none.
template <typename T>
__global__ void __launch_bounds__(kSpanThreads)
roi_spans_kernel(const T* __restrict__ wy, const T* __restrict__ wx,
                 int4* __restrict__ spans, long long rois, int n, int h,
                 int w) {
  const long long roi =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (roi >= rois) return;  // a whole warp leaves together
  int lo[2], hi[2];
  for (int a = 0; a < 2; ++a) {
    const int size = a ? w : h;
    const T* rows = (a ? wx : wy) + roi * n * size;
    int l = size, u = -1;
    for (int i = lane; i < n * size; i += 32) {
      if (to_f32(rows[i]) != 0.0f) {
        l = min(l, i % size);
        u = max(u, i % size);
      }
    }
    lo[a] = __reduce_min_sync(0xffffffffu, l);
    hi[a] = __reduce_max_sync(0xffffffffu, u);
  }
  if (lane == 0) spans[roi] = make_int4(lo[0], hi[0], lo[1], hi[1]);
}

// Grid (tiles of the map x channel slices, the slices of a tile side by
// side; images); the shared memory is roi_common.cuh:TileShared, static.
template <typename T>
__global__ void __launch_bounds__(kTileThreads, kTileMinBlocks)
roi_align_bwd_kernel(const T* __restrict__ g, const T* __restrict__ wy,
                     const T* __restrict__ wx, const int4* __restrict__ spans,
                     T* __restrict__ dfeat, int k, int n, int h, int w,
                     int c) {
  __shared__ TileShared sm;
  const int slices = (c + kSlice - 1) / kSlice;
  const int tile = blockIdx.x / slices, tiles_x = (w + kTileX - 1) / kTileX;
  const size_t roi0 = (size_t)blockIdx.y * k;
  const RowWeights<T> wt{wy + roi0 * n * h, wx + roi0 * n * w, n, h, w};
  backward_tile<T>(wt, spans + roi0, g + roi0 * n * n * c,
                   dfeat + (size_t)blockIdx.y * h * w * c, k, n, h, w, c,
                   tile / tiles_x * kTileY, tile % tiles_x * kTileX,
                   blockIdx.x % slices * kSlice, sm);
}

template <typename T>
cudaError_t launch_spans(const void* wy, const void* wx, void* spans,
                         long long rois, int n, int h, int w,
                         cudaStream_t stream) {
  const long long blocks = (rois * 32 + kSpanThreads - 1) / kSpanThreads;
  roi_spans_kernel<T><<<blocks, kSpanThreads, 0, stream>>>(
      static_cast<const T*>(wy), static_cast<const T*>(wx),
      static_cast<int4*>(spans), rois, n, h, w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* wy, const void* wx,
                       void* spans, void* dfeat, int b, int k, int n, int h,
                       int w, int c, cudaStream_t stream) {
  if ((long long)b * k > 0) {
    const cudaError_t e =
        launch_spans<T>(wy, wx, spans, (long long)b * k, n, h, w, stream);
    if (e != cudaSuccess) return e;
  }
  const int tiles = ((h + kTileY - 1) / kTileY) * ((w + kTileX - 1) / kTileX);
  const dim3 grid(tiles * ((c + kSlice - 1) / kSlice), b);
  roi_align_bwd_kernel<T><<<grid, kTileThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(wy),
      static_cast<const T*>(wx), static_cast<const int4*>(spans),
      static_cast<T*>(dfeat), k, n, h, w, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// boxes [rois, 4] f32 -> wy [rois, n, h], wx [rois, n, w] (bf16 if
// `bf16`, else f32), wy and wx 16-byte aligned, rois * n * max(h, w)
// below 2^31, ratio >= 1. Returns cudaGetLastError() after the launch.
int livecell_roi_weights(const void* boxes, void* wy, void* wx,
                         long long rois, int n, int h, int w, int ratio,
                         float scale, int bf16, void* stream) {
  if (rois * n * (long long)(h + w) == 0) return 0;
  if (ratio < 1 ||
      rois * n * (long long)(h > w ? h : w) >= (1ll << 31) ||
      ((reinterpret_cast<uintptr_t>(wy) | reinterpret_cast<uintptr_t>(wx)) &
       15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_weights<__nv_bfloat16>(boxes, wy, wx, (int)rois, n, h, w,
                                           ratio, scale, st)
           : launch_weights<float>(boxes, wy, wx, (int)rois, n, h, w, ratio,
                                   scale, st);
  return (int)e;
}

// feat [b, h, w, c], wy [b, k, n, h], wx [b, k, n, w] -> out
// [b, k, n, n, c], all bf16 if `bf16`, else f32. c a multiple of 8, feat
// and out 16-byte aligned.
int livecell_roi_align_fwd(const void* feat, const void* wy, const void* wx,
                           void* out, int b, int k, int n, int h, int w,
                           int c, int bf16, void* stream) {
  if (b * k == 0 || c == 0) return 0;
  if (n > kMaxBins || c % livecell::kVec != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_fwd<__nv_bfloat16>(feat, wy, wx, out, b, k, n, h, w, c, st)
           : launch_fwd<float>(feat, wy, wx, out, b, k, n, h, w, c, st);
  return (int)e;
}

// wy [rois, n, h], wx [rois, n, w] -> spans [rois] int4 (y_lo, y_hi,
// x_lo, x_hi), K3's pre-pass alone (the backward launches it itself).
int livecell_roi_spans(const void* wy, const void* wx, void* spans,
                       long long rois, int n, int h, int w, int bf16,
                       void* stream) {
  if (rois == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_spans<__nv_bfloat16>(wy, wx, spans, rois, n, h, w, st)
           : launch_spans<float>(wy, wx, spans, rois, n, h, w, st);
  return (int)e;
}

// g [b, k, n, n, c], wy [b, k, n, h], wx [b, k, n, w] -> dfeat
// [b, h, w, c] (written whole), all bf16 if `bf16`, else f32; spans
// [b, k] int4 is the pre-pass's scratch. c a multiple of 8, g and dfeat
// 16-byte aligned.
int livecell_roi_align_bwd(const void* g, const void* wy, const void* wx,
                           void* spans, void* dfeat, int b, int k, int n,
                           int h, int w, int c, int bf16, void* stream) {
  if (b * h == 0 || w == 0 || c == 0) return 0;
  if (n > kMaxBins || c % livecell::kVec != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_bwd<__nv_bfloat16>(g, wy, wx, spans, dfeat, b, k, n, h,
                                       w, c, st)
           : launch_bwd<float>(g, wy, wx, spans, dfeat, b, k, n, h, w, c, st);
  return (int)e;
}

// Resident blocks of the forward kernel on one SM, or minus the CUDA
// error.
int livecell_roi_align_fwd_blocks_per_sm(int bf16) {
  int blocks = 0;
  const cudaError_t e =
      bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, roi_align_fwd_kernel<__nv_bfloat16>, kFwdThreads,
                 0)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, roi_align_fwd_kernel<float>, kFwdThreads, 0);
  return e == cudaSuccess ? blocks : -(int)e;
}

// Resident blocks of the backward kernel on one SM, or minus the CUDA
// error.
int livecell_roi_align_bwd_blocks_per_sm(int bf16) {
  int blocks = 0;
  const cudaError_t e =
      bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, roi_align_bwd_kernel<__nv_bfloat16>, kTileThreads,
                 0)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, roi_align_bwd_kernel<float>, kTileThreads, 0);
  return e == cudaSuccess ? blocks : -(int)e;
}

const char* livecell_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
