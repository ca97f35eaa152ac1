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
//    keeps one level with `where`: 4x the work. Here one block owns one
//    ROI: it computes the ROI's n Wy rows and n Wx rows for its own level
//    into shared memory (n * (H_l + W_l) floats, 26 KB at P2 200x272 for
//    n = 14) and runs K2's gather (roi_common.cuh:pool_roi) on that level's
//    map only, threads across channels. Bound by bytes: each bin reads at
//    most (2 ratio)^2 feature vectors; the least traffic is the output
//    plus the feature pixels the taps touch.
//
// K6 ms_roi_align_bwd_kernel replaces the composition's backward, the
//    Pallas `_bwd_kernel` (pallas_roi_align.py:152) run once per level.
//    dF_l[b,y,x,c] = sum_k [level_k = l] sum_p Wy[k,p,y] u[k,p,x,c] with
//    u = sum_q Wx[k,q,x] g[b,k,p,q,c]. It gathers as K3 does: one block
//    owns one feature row y of one level of one image and kBwdThreads
//    channels, keeps the row's f32 sums in shared memory (272 x 128 x 4 B
//    = 136 KB at P2, under the 227 KB opt-in limit), walks the image's ROIs
//    in order, skips those of other levels and those whose Wy column
//    misses the row, and recomputes the weights of the rest inline, so no
//    weight tensor is stored between the forward and the backward. No
//    atomics and a fixed sum order: the same result in every run.
//    Rounding follows the Pallas kernel: g and u in the feature dtype (u
//    summed in f32 and rounded to bf16 for bf16 input), dF summed in f32
//    and rounded once. Bound by bytes: g read once, the four maps'
//    gradients written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "roi_common.cuh"

namespace {

using livecell::from_f32;
using livecell::pool_roi;
using livecell::pooled_weight;
using livecell::round_to;
using livecell::to_f32;

constexpr int kLevels = 4;
constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 128;   // channels per backward block
constexpr int kBwdRoiChunk = 64;   // ROIs whose Wy column is staged at once
constexpr int kMaxBins = 16;       // largest out_size the backward takes

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

// Dynamic shared memory, sized for the largest level: the ROI's n Wy rows
// (n*H_l floats), its n Wx rows (n*W_l floats), then the first and last
// non-zero index of each of the 2n rows.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
ms_roi_align_fwd_kernel(Pyramid pyr, const float* __restrict__ boxes,
                        const int* __restrict__ levels, T* __restrict__ out,
                        int k, int n, int c, int ratio) {
  extern __shared__ float smem[];
  const int roi = blockIdx.x;  // b * k + ki
  const int b = roi / k;
  const int l = level_of(levels, roi);
  const int h = pyr.h[l], w = pyr.w[l];
  const float scale = pyr.scale[l];
  float* sy = smem;                                 // [n, h]
  float* sx = sy + n * h;                           // [n, w]
  int* first = reinterpret_cast<int*>(sx + n * w);  // [2n]
  int* last = first + 2 * n;                        // [2n]

  const float* box = boxes + (size_t)roi * 4;
  const float x0 = box[0], y0 = box[1], x1 = box[2], y1 = box[3];
  // smem[i] for i < n*h is sy[i]; above, sx[i - n*h].
  for (int i = threadIdx.x; i < n * (h + w); i += blockDim.x) {
    const bool is_y = i < n * h;
    const int j = is_y ? i : i - n * h;
    const int size = is_y ? h : w;
    smem[i] = round_to<T>(pooled_weight(is_y ? y0 : x0, is_y ? y1 : x1,
                                        scale, n, size, ratio, j / size,
                                        j % size));
  }
  __syncthreads();

  const T* fb = static_cast<const T*>(pyr.ptr[l]) + (size_t)b * h * w * c;
  pool_roi<T>(sy, sx, first, last, fb, out + (size_t)roi * n * n * c, n, h,
              w, c);
}

// Dynamic shared memory, sized for the widest level: the row's f32 sums
// [w][kBwdThreads], the ROI's n Wx rows [n][w], each thread's n gradient
// values [n][kBwdThreads], then per column x the first and last bin q
// whose Wx tap is non-zero.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
ms_roi_align_bwd_kernel(Pyramid dpyr, const T* __restrict__ g,
                        const float* __restrict__ boxes,
                        const int* __restrict__ levels, int k, int n, int c,
                        int ratio) {
  extern __shared__ float smem[];
  __shared__ float s_wy[kBwdRoiChunk * kMaxBins];
  __shared__ int s_xlo[kBwdThreads / 32], s_xhi[kBwdThreads / 32];

  // blockIdx.x runs over the rows of all levels, P2's first.
  int y = blockIdx.x, l = 0;
  while (l < kLevels - 1 && y >= dpyr.h[l]) y -= dpyr.h[l++];
  const int h = dpyr.h[l], w = dpyr.w[l];
  const float scale = dpyr.scale[l];
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int ch = blockIdx.z * kBwdThreads + t;
  const bool live = ch < c;

  float* acc = smem;                                        // [w, threads]
  float* sx = acc + w * kBwdThreads;                        // [n, w]
  float* gs = sx + n * w;                                   // [n, threads]
  int* qlo = reinterpret_cast<int*>(gs + n * kBwdThreads);  // [w]
  int* qhi = qlo + w;                                       // [w]
  for (int x = 0; x < w; ++x) acc[x * kBwdThreads + t] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kBwdRoiChunk) {
    const int kc = min(kBwdRoiChunk, k - k0);
    __syncthreads();  // the previous chunk's readers are done
    // Row y of the chunk's Wy at this level (0 for other levels):
    // s_wy[kk * n + p].
    for (int i = t; i < kc * n; i += kBwdThreads) {
      const size_t roi = (size_t)b * k + k0 + i / n;
      s_wy[i] = level_of(levels, roi) != l
                    ? 0.0f
                    : round_to<T>(pooled_weight(boxes[roi * 4 + 1],
                                                boxes[roi * 4 + 3], scale, n,
                                                h, ratio, i % n, y));
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      bool hit = false;
      for (int p = 0; p < n; ++p) hit |= s_wy[kk * n + p] != 0.0f;
      if (!hit) continue;  // uniform across the block
      const size_t roi = (size_t)b * k + k0 + kk;
      const float bx0 = boxes[roi * 4], bx1 = boxes[roi * 4 + 2];
      __syncthreads();  // the previous ROI's readers of sx/qlo are done
      // The ROI's Wx rows, each column's non-zero bin range, and the
      // ROI's column range (per warp, then over the block).
      int xlo = w, xhi = -1;
      for (int x = t; x < w; x += kBwdThreads) {
        int lo = n, hi = -1;
        for (int q = 0; q < n; ++q) {
          const float v =
              round_to<T>(pooled_weight(bx0, bx1, scale, n, w, ratio, q, x));
          sx[q * w + x] = v;
          if (v != 0.0f) {
            lo = min(lo, q);
            hi = q;
          }
        }
        qlo[x] = lo;
        qhi[x] = hi;
        if (lo <= hi) {
          xlo = min(xlo, x);
          xhi = x;
        }
      }
      xlo = __reduce_min_sync(0xffffffffu, xlo);
      xhi = __reduce_max_sync(0xffffffffu, xhi);
      if (lane == 0) {
        s_xlo[warp] = xlo;
        s_xhi[warp] = xhi;
      }
      __syncthreads();
      if (!live) continue;
      for (int i = 0; i < kBwdThreads / 32; ++i) {
        xlo = min(xlo, s_xlo[i]);
        xhi = max(xhi, s_xhi[i]);
      }
      const T* g_roi = g + roi * n * n * c + ch;
      for (int p = 0; p < n; ++p) {
        const float wyv = s_wy[kk * n + p];
        if (wyv == 0.0f) continue;
        for (int q = 0; q < n; ++q)
          gs[q * kBwdThreads + t] = to_f32(g_roi[((size_t)p * n + q) * c]);
        for (int x = xlo; x <= xhi; ++x) {
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
  T* drow = static_cast<T*>(dpyr.ptr[l]) + (((size_t)b * h + y) * w) * c + ch;
  for (int x = 0; x < w; ++x)
    drow[(size_t)x * c] = from_f32<T>(acc[x * kBwdThreads + t]);
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
  int most = 0;
  for (int l = 0; l < kLevels; ++l) most = max(most, pyr.h[l] + pyr.w[l]);
  const size_t smem =
      (size_t)n * most * sizeof(float) + 4 * (size_t)n * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ms_roi_align_fwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  ms_roi_align_fwd_kernel<T><<<b * k, kFwdThreads, smem, stream>>>(
      pyr, static_cast<const float*>(boxes), static_cast<const int*>(levels),
      static_cast<T*>(out), k, n, c, ratio);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const Pyramid& dpyr, const void* g, const void* boxes,
                       const void* levels, int b, int k, int n, int c,
                       int ratio, cudaStream_t stream) {
  int widest = 0, rows = 0;
  for (int l = 0; l < kLevels; ++l) {
    widest = max(widest, dpyr.w[l]);
    rows += dpyr.h[l];
  }
  const size_t smem = ((size_t)widest * kBwdThreads + (size_t)n * widest +
                       (size_t)n * kBwdThreads) * sizeof(float) +
                      2 * (size_t)widest * sizeof(int);
  // The 48 KB default covers static and dynamic shared memory together.
  if (smem + kBwdRoiChunk * kMaxBins * sizeof(float) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ms_roi_align_bwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(rows, b, (c + kBwdThreads - 1) / kBwdThreads);
  ms_roi_align_bwd_kernel<T><<<grid, kBwdThreads, smem, stream>>>(
      dpyr, static_cast<const T*>(g), static_cast<const float*>(boxes),
      static_cast<const int*>(levels), k, n, c, ratio);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// feats: 4 pointers to [b, hs[l], ws[l], c] maps; boxes [b, k, 4] f32,
// levels [b, k] int32 in 0..3 -> out [b, k, n, n, c], all maps and out
// bf16 if `bf16`, else f32. Returns cudaGetLastError() after the launch.
int livecell_ms_roi_align_fwd(void* const* feats, const int* hs,
                              const int* ws, const void* boxes,
                              const void* levels, void* out, int b, int k,
                              int n, int c, int ratio, int bf16,
                              void* stream) {
  if (b * k == 0 || c == 0) return 0;
  const Pyramid pyr = make_pyramid(feats, hs, ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_fwd<__nv_bfloat16>(pyr, boxes, levels, out, b, k, n, c,
                                       ratio, st)
           : launch_fwd<float>(pyr, boxes, levels, out, b, k, n, c, ratio, st);
  return (int)e;
}

// g [b, k, n, n, c], boxes [b, k, 4] f32, levels [b, k] int32 ->
// dfeats: 4 pointers to [b, hs[l], ws[l], c] (each written whole), all
// bf16 if `bf16`, else f32.
int livecell_ms_roi_align_bwd(void* const* dfeats, const int* hs,
                              const int* ws, const void* g, const void* boxes,
                              const void* levels, int b, int k, int n, int c,
                              int ratio, int bf16, void* stream) {
  if (b == 0 || c == 0) return 0;
  if (n > kMaxBins) return (int)cudaErrorInvalidValue;
  const Pyramid dpyr = make_pyramid(dfeats, hs, ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_bwd<__nv_bfloat16>(dpyr, g, boxes, levels, b, k, n, c,
                                       ratio, st)
           : launch_bwd<float>(dpyr, g, boxes, levels, b, k, n, c, ratio, st);
  return (int)e;
}

const char* livecell_ms_roi_align_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
