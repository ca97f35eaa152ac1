// Shared device helpers of the RoIAlign kernels (roi_align.cu: K1-K3,
// ms_roi_align.cu: K5-K6): conversions between the feature dtype and
// f32, and the pooled bilinear weight of one bin and one feature pixel.

#pragma once

#include <cuda_bf16.h>

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

}  // namespace livecell
