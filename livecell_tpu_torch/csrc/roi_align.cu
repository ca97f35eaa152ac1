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
//    call is launch-latency bound at the serving shapes. The rounded
//    intrinsics (__fmul_rn, ...) stop the compiler from fusing a*b+c
//    into one FMA, so every step rounds where the plain version's
//    separate tensor ops round and the f32 weights agree bit for bit.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kWeightThreads = 256;

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

// Round an f32 partial sum to T and back (identity for T = float).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

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

  const float start = __fmul_rn(lo, scale);
  const float bin = __fdiv_rn(
      fmaxf(__fsub_rn(__fmul_rn(hi, scale), start), 1.0f), (float)n);
  float acc = 0.0f;
  for (int s = 0; s < ratio; ++s) {
    // (s + 0.5) / ratio in double, rounded once: the plain version's
    // Python scalar.
    const float off = (float)((s + 0.5) / ratio);
    const float c =
        __fadd_rn(start, __fmul_rn(__fadd_rn((float)p, off), bin));
    if (c >= -1.0f && c <= (float)size) {
      const float cc = fminf(fmaxf(c, 0.0f), (float)(size - 1));
      acc = __fadd_rn(
          acc, fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(cc, (float)g)))));
    }
  }
  (is_y ? wy : wx)[j] = from_f32<T>(__fdiv_rn(acc, (float)ratio));
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

  // One warp per row: the row's non-zero index range.
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

  const T* fb = feat + (size_t)b * h * w * c;
  T* ob = out + (size_t)roi * n * n * c;
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

const char* livecell_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
