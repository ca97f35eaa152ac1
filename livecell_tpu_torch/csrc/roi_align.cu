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
//    One thread per element of Wy [R, n, H] and Wx [R, n, W]. Bound by
//    bytes: it reads 16 bytes per ROI and writes the weights (about
//    2.3 MB at 25 tiles x 50 ROIs x 7 rows x (56 + 76) in bf16), so a
//    call is launch-latency bound at the serving shapes. The weight is
//    roi_common.cuh:pooled_weight, which rounds where the plain
//    version's tensor ops round, so the f32 weights agree bit for bit.
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
using livecell::TileShared;
using livecell::to_f32;

constexpr int kWeightThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kWeightThreads)
roi_weights_kernel(const float* __restrict__ boxes, T* __restrict__ wy,
                   T* __restrict__ wx, long long n_wy, long long total,
                   int n, int h, int w, int ratio, float scale) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const bool is_y = i < n_wy;
  const long long j = is_y ? i : i - n_wy;
  const int size = is_y ? h : w;
  const int g = (int)(j % size);
  const long long r = j / size;
  const int p = (int)(r % n);
  const long long roi = r / n;
  const float lo = boxes[roi * 4 + (is_y ? 1 : 0)];
  const float hi = boxes[roi * 4 + (is_y ? 3 : 2)];

  (is_y ? wy : wx)[j] =
      from_f32<T>(pooled_weight(lo, hi, scale, n, size, ratio, p, g));
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
// `bf16`, else f32). Returns cudaGetLastError() after the launch.
int livecell_roi_weights(const void* boxes, void* wy, void* wx,
                         long long rois, int n, int h, int w, int ratio,
                         float scale, int bf16, void* stream) {
  const long long n_wy = rois * n * h;
  const long long total = n_wy + rois * n * w;
  if (total == 0) return 0;
  const long long blocks = (total + kWeightThreads - 1) / kWeightThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    roi_weights_kernel<__nv_bfloat16><<<blocks, kWeightThreads, 0, st>>>(
        static_cast<const float*>(boxes), static_cast<__nv_bfloat16*>(wy),
        static_cast<__nv_bfloat16*>(wx), n_wy, total, n, h, w, ratio, scale);
  } else {
    roi_weights_kernel<float><<<blocks, kWeightThreads, 0, st>>>(
        static_cast<const float*>(boxes), static_cast<float*>(wy),
        static_cast<float*>(wx), n_wy, total, n, h, w, ratio, scale);
  }
  return (int)cudaGetLastError();
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
