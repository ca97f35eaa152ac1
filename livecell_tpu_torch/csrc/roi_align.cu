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
//    Wx[b,k,q,x] F[b,y,x,c], f32 accumulation. Bound by bytes: each
//    weight row has at most 2*ratio non-zero taps, so a bin gathers at
//    most 16 feature vectors and the operations are few; the least
//    traffic is the feature map read once plus the weights and the
//    output (about 88 MB at 25 x 56 x 76 x 256 bf16, K = 50). The TPU
//    kernel ran the two contractions as dense MXU matmuls over all of
//    H and W; here one block owns one ROI, stages its 2n weight rows in
//    shared memory, finds each row's non-zero range once, and its
//    threads run across channels, so neighbouring threads load
//    neighbouring channels of the NHWC map (coalesced) and loop only
//    over the non-zero taps. For bf16 input the row contraction is
//    rounded to bf16 before the column contraction, where the Pallas
//    kernel rounds (pallas_roi_align.py:138).
//
// K3 roi_align_bwd_kernel replaces the Pallas kernel `_bwd_kernel`
//    (pallas_roi_align.py:152, called from the custom VJP `_bwd_rule`
//    :280). dF[b,y,x,c] = sum_k sum_p Wy[b,k,p,y] u[b,k,p,x,c] with
//    u = sum_q Wx[b,k,q,x] g[b,k,p,q,c], reusing K1's weights. Bound by
//    bytes: g, the weights and dF are each moved once (about 0.18 GB in
//    bf16 at 32 images, K = 128); the operations are few for the same
//    sparsity as K2's. The TPU kernel accumulated dF over ROI blocks in
//    one resident f32 block; blocks on Hopper run in no order, so this
//    kernel gathers instead of scattering: one block owns one feature
//    row y of one image and a slice of kBwdThreads channels, keeps that
//    row's f32 sums in shared memory (each thread its own channel
//    column, so no atomics and no bank conflicts), walks the image's
//    ROIs in order and skips those whose Wy rows miss y. The sum order
//    is fixed, so the result is the same in every run. Rounding follows
//    the Pallas kernel: g and u in the features' dtype (u summed in f32
//    and rounded to bf16 for bf16 input, pallas_roi_align.py:170), dF
//    summed in f32 and rounded once to the features' dtype (:346).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "roi_common.cuh"

namespace {

using livecell::from_f32;
using livecell::pool_roi;
using livecell::pooled_weight;
using livecell::round_to;
using livecell::to_f32;

constexpr int kFwdThreads = 256;
constexpr int kWeightThreads = 256;
constexpr int kBwdThreads = 128;   // channels per backward block
constexpr int kBwdRoiChunk = 64;   // ROIs whose Wy column is staged at once
constexpr int kMaxBins = 16;       // largest out_size the backward takes

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

// Dynamic shared memory: the ROI's n Wy rows (n*h floats), its n Wx
// rows (n*w floats), then the first and last non-zero index of each of
// the 2n rows.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
roi_align_fwd_kernel(const T* __restrict__ feat, const T* __restrict__ wy,
                     const T* __restrict__ wx, T* __restrict__ out, int k,
                     int n, int h, int w, int c) {
  extern __shared__ float smem[];
  float* sy = smem;                                // [n, h]
  float* sx = sy + n * h;                          // [n, w]
  int* first = reinterpret_cast<int*>(sx + n * w);  // [2n]
  int* last = first + 2 * n;                        // [2n]

  const int roi = blockIdx.x;  // b * k + ki
  const int b = roi / k;
  const T* wy_roi = wy + (size_t)roi * n * h;
  const T* wx_roi = wx + (size_t)roi * n * w;
  for (int i = threadIdx.x; i < n * h; i += blockDim.x)
    sy[i] = to_f32(wy_roi[i]);
  for (int i = threadIdx.x; i < n * w; i += blockDim.x)
    sx[i] = to_f32(wx_roi[i]);
  __syncthreads();

  pool_roi<T>(sy, sx, first, last, feat + (size_t)b * h * w * c,
              out + (size_t)roi * n * n * c, n, h, w, c);
}

template <typename T>
cudaError_t launch_fwd(const void* feat, const void* wy, const void* wx,
                       void* out, int b, int k, int n, int h, int w, int c,
                       cudaStream_t stream) {
  const size_t smem =
      (size_t)n * (h + w) * sizeof(float) + 4 * (size_t)n * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        roi_align_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  roi_align_fwd_kernel<T><<<b * k, kFwdThreads, smem, stream>>>(
      static_cast<const T*>(feat), static_cast<const T*>(wy),
      static_cast<const T*>(wx), static_cast<T*>(out), k, n, h, w, c);
  return cudaGetLastError();
}

// Dynamic shared memory: the row's f32 sums [w][kBwdThreads], the ROI's
// n Wx rows [n][w], each thread's n gradient values [n][kBwdThreads],
// then per column x the first and last bin q whose Wx tap is non-zero.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
roi_align_bwd_kernel(const T* __restrict__ g, const T* __restrict__ wy,
                     const T* __restrict__ wx, T* __restrict__ dfeat, int k,
                     int n, int h, int w, int c) {
  extern __shared__ float smem[];
  float* acc = smem;                          // [w, kBwdThreads]
  float* sx = acc + w * kBwdThreads;          // [n, w]
  float* gs = sx + n * w;                     // [n, kBwdThreads]
  int* qlo = reinterpret_cast<int*>(gs + n * kBwdThreads);  // [w]
  int* qhi = qlo + w;                                        // [w]
  __shared__ float s_wy[kBwdRoiChunk * kMaxBins];

  const int y = blockIdx.x;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int ch = blockIdx.z * kBwdThreads + t;
  const bool live = ch < c;
  for (int x = 0; x < w; ++x) acc[x * kBwdThreads + t] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kBwdRoiChunk) {
    const int kc = min(kBwdRoiChunk, k - k0);
    __syncthreads();  // the previous chunk's readers are done
    // Column y of the chunk's Wy rows: s_wy[kk * n + p].
    const size_t wy0 = ((size_t)b * k + k0) * n;
    for (int i = t; i < kc * n; i += kBwdThreads)
      s_wy[i] = to_f32(wy[(wy0 + i) * h + y]);
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      bool hit = false;
      for (int p = 0; p < n; ++p) hit |= s_wy[kk * n + p] != 0.0f;
      if (!hit) continue;  // uniform across the block
      const size_t roi = (size_t)b * k + k0 + kk;
      __syncthreads();  // the previous ROI's readers of sx/qlo are done
      const T* wx_roi = wx + roi * n * w;
      for (int x = t; x < w; x += kBwdThreads) {
        int lo = n, hi = -1;
        for (int q = 0; q < n; ++q) {
          const float v = to_f32(wx_roi[q * w + x]);
          sx[q * w + x] = v;
          if (v != 0.0f) {
            lo = min(lo, q);
            hi = q;
          }
        }
        qlo[x] = lo;
        qhi[x] = hi;
      }
      __syncthreads();
      if (!live) continue;
      const T* g_roi = g + roi * n * n * c + ch;
      for (int p = 0; p < n; ++p) {
        const float wyv = s_wy[kk * n + p];
        if (wyv == 0.0f) continue;
        for (int q = 0; q < n; ++q)
          gs[q * kBwdThreads + t] = to_f32(g_roi[((size_t)p * n + q) * c]);
        for (int x = 0; x < w; ++x) {
          const int lo = qlo[x], hi = qhi[x];
          if (lo > hi) continue;
          float u = 0.0f;
          for (int q = lo; q <= hi; ++q)
            u = fmaf(sx[q * w + x], gs[q * kBwdThreads + t], u);
          float& a = acc[x * kBwdThreads + t];
          a = fmaf(wyv, round_to<T>(u), a);
        }
      }
    }
  }
  if (!live) return;
  T* drow = dfeat + (((size_t)b * h + y) * w) * c + ch;
  for (int x = 0; x < w; ++x)
    drow[(size_t)x * c] = from_f32<T>(acc[x * kBwdThreads + t]);
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* wy, const void* wx,
                       void* dfeat, int b, int k, int n, int h, int w, int c,
                       cudaStream_t stream) {
  const size_t smem = ((size_t)w * kBwdThreads + (size_t)n * w +
                       (size_t)n * kBwdThreads) * sizeof(float) +
                      2 * (size_t)w * sizeof(int);
  // The 48 KB default covers static and dynamic shared memory together.
  if (smem + kBwdRoiChunk * kMaxBins * sizeof(float) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        roi_align_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(h, b, (c + kBwdThreads - 1) / kBwdThreads);
  roi_align_bwd_kernel<T><<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(wy),
      static_cast<const T*>(wx), static_cast<T*>(dfeat), k, n, h, w, c);
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
// [b, k, n, n, c], all bf16 if `bf16`, else f32.
int livecell_roi_align_fwd(const void* feat, const void* wy, const void* wx,
                           void* out, int b, int k, int n, int h, int w,
                           int c, int bf16, void* stream) {
  if (b * k == 0 || c == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_fwd<__nv_bfloat16>(feat, wy, wx, out, b, k, n, h, w, c, st)
           : launch_fwd<float>(feat, wy, wx, out, b, k, n, h, w, c, st);
  return (int)e;
}

// g [b, k, n, n, c], wy [b, k, n, h], wx [b, k, n, w] -> dfeat
// [b, h, w, c] (written whole), all bf16 if `bf16`, else f32.
int livecell_roi_align_bwd(const void* g, const void* wy, const void* wx,
                           void* dfeat, int b, int k, int n, int h, int w,
                           int c, int bf16, void* stream) {
  if (b * h == 0 || w == 0 || c == 0) return 0;
  if (n > kMaxBins) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_bwd<__nv_bfloat16>(g, wy, wx, dfeat, b, k, n, h, w, c, st)
           : launch_bwd<float>(g, wy, wx, dfeat, b, k, n, h, w, c, st);
  return (int)e;
}

const char* livecell_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
