// Fused anchor-GT matcher on Hopper (sm_90a): K4. Plain C entry point,
// loaded with ctypes by livecell_tpu_torch/ops/cuda_match.py, which holds
// the plain PyTorch version (`match_anchors_plain`) and the launch
// counter.
//
// K4 match_kernel replaces the Pallas kernel `_kernel`
//    (livecell_tpu/ops/pallas_match.py:44, entry `match_anchors_pallas`
//    :131). For every anchor of every image: the max IoU over the image's
//    valid GT (an invalid GT counts as IoU -1); with `full`, also the
//    regression targets of the first GT attaining that max, planar
//    [B, 4, N], and for every GT the first anchor attaining its max IoU.
//    The [B, N, I] IoU matrix never reaches device memory.
//
//    Bound by operations: about 20 f32 operations per anchor-GT pair
//    (two overlaps, the union, one division, the compares), 1.6e8 pairs
//    at the training shapes (38,304 anchors x 32 images x 128 GT, or x 1
//    image x 4,096 GT), against a few hundred kilobytes of input and
//    output. One thread per anchor keeps its box, running max, argmax
//    and matched GT box in registers; the block stages its image's GT in
//    tiles of kGtTile in shared memory (with their areas), so any GT
//    count fits, and every thread streams the same GT from shared
//    memory (a broadcast, no bank conflicts).
//
//    The per-GT best anchor is a reduction across blocks, which run in
//    no order. Each warp reduces its 32 anchors for a GT in two
//    instructions (`__reduce_max_sync` of the IoU's order-preserving
//    bits, `__ballot_sync` for the first lane at that max), the block
//    combines its warps in shared memory, and one 64-bit atomicMax per
//    block and GT merges a key that packs the IoU bits above the
//    complement of the anchor index: the largest IoU wins, and among
//    equal IoU the lowest anchor, which is jnp.argmax's first index.
//    The result does not depend on the order of the atomics.
//
//    The rounded intrinsics (__fsub_rn, __fmul_rn, ...) stop the
//    compiler from contracting a*b+c into one FMA, so every step rounds
//    where the plain version's separate tensor ops round and the IoU
//    agrees bit for bit; the targets' logf may differ from torch.log by
//    an ulp (tolerance 1e-5, the JAX kernel's).

#include <cuda_runtime.h>

namespace {

constexpr int kMatchThreads = 128;
constexpr int kWarps = kMatchThreads / 32;
constexpr int kGtTile = 256;

// Monotone map of a float onto unsigned ints (IoU has no NaN and, as
// computed, no negative zero).
__device__ __forceinline__ unsigned int order_bits(float v) {
  const unsigned int b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

template <bool kFull>
__global__ void __launch_bounds__(kMatchThreads)
match_kernel(const float4* __restrict__ anchors, const float4* __restrict__ gt,
             const unsigned char* __restrict__ valid,
             float* __restrict__ max_iou, float* __restrict__ tgt,
             unsigned long long* __restrict__ best_key, int n, int n_gt) {
  __shared__ float4 s_box[kGtTile];
  __shared__ float s_area[kGtTile];
  __shared__ int s_valid[kGtTile];
  __shared__ unsigned long long s_key[kFull ? kWarps : 1][kGtTile];

  const int b = blockIdx.y;
  const int a = blockIdx.x * kMatchThreads + threadIdx.x;
  const bool live = a < n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float4 an = live ? anchors[a] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float area_a = __fmul_rn(__fsub_rn(an.z, an.x), __fsub_rn(an.w, an.y));
  const float4* gtb = gt + (size_t)b * n_gt;
  const unsigned char* vb = valid + (size_t)b * n_gt;

  float best = -2.0f;  // below any IoU, so GT 0 always sets it first
  float4 mbox = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int g0 = 0; g0 < n_gt; g0 += kGtTile) {
    const int tg = min(kGtTile, n_gt - g0);
    __syncthreads();  // the previous tile's readers are done
    for (int j = threadIdx.x; j < tg; j += kMatchThreads) {
      const float4 g = gtb[g0 + j];
      s_box[j] = g;
      s_area[j] = __fmul_rn(__fsub_rn(g.z, g.x), __fsub_rn(g.w, g.y));
      s_valid[j] = vb[g0 + j] != 0;
    }
    __syncthreads();
    for (int j = 0; j < tg; ++j) {
      const float4 g = s_box[j];
      const float iw =
          fmaxf(__fsub_rn(fminf(an.z, g.z), fmaxf(an.x, g.x)), 0.0f);
      const float ih =
          fmaxf(__fsub_rn(fminf(an.w, g.w), fmaxf(an.y, g.y)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(area_a, s_area[j]), inter);
      float iou = uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
      iou = s_valid[j] ? iou : -1.0f;
      if (iou > best) {  // strict: the first GT among equal IoU
        best = iou;
        if (kFull) mbox = g;
      }
      if (kFull) {
        const unsigned int key = live ? order_bits(iou) : 0u;
        const unsigned int m = __reduce_max_sync(0xffffffffu, key);
        const unsigned int first = __ffs(__ballot_sync(0xffffffffu, key == m)) - 1;
        if (lane == 0) {
          const unsigned int idx =
              blockIdx.x * kMatchThreads + warp * 32 + first;
          s_key[warp][j] =
              m ? ((unsigned long long)m << 32) | (0xffffffffu - idx) : 0ull;
        }
      }
    }
    if (kFull) {
      __syncthreads();
      for (int j = threadIdx.x; j < tg; j += kMatchThreads) {
        unsigned long long k = 0;
        for (int w = 0; w < kWarps; ++w) k = s_key[w][j] > k ? s_key[w][j] : k;
        atomicMax(best_key + (size_t)b * n_gt + g0 + j, k);
      }
    }
  }
  if (!live) return;
  max_iou[(size_t)b * n + a] = best;
  if (kFull) {
    // ops.boxes.encode_boxes with the 1.0 size clamps
    // (pallas_match.py:84-96).
    const float aw = fmaxf(__fsub_rn(an.z, an.x), 1.0f);
    const float ah = fmaxf(__fsub_rn(an.w, an.y), 1.0f);
    const float acx = __fmul_rn(__fadd_rn(an.x, an.z), 0.5f);
    const float acy = __fmul_rn(__fadd_rn(an.y, an.w), 0.5f);
    const float bw = fmaxf(__fsub_rn(mbox.z, mbox.x), 1.0f);
    const float bh = fmaxf(__fsub_rn(mbox.w, mbox.y), 1.0f);
    const float bcx = __fmul_rn(__fadd_rn(mbox.x, mbox.z), 0.5f);
    const float bcy = __fmul_rn(__fadd_rn(mbox.y, mbox.w), 0.5f);
    float* tb = tgt + (size_t)b * 4 * n;
    tb[a] = __fdiv_rn(__fsub_rn(bcx, acx), aw);
    tb[n + a] = __fdiv_rn(__fsub_rn(bcy, acy), ah);
    tb[2 * (size_t)n + a] = logf(__fdiv_rn(bw, aw));
    tb[3 * (size_t)n + a] = logf(__fdiv_rn(bh, ah));
  }
}

// Keys -> anchor indices, in place.
__global__ void best_index_kernel(unsigned long long* key, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) key[i] = 0xffffffffull - (key[i] & 0xffffffffull);
}

}  // namespace

extern "C" {

// anchors [n, 4] f32, gt [b, n_gt, 4] f32, valid [b, n_gt] bool ->
// max_iou [b, n] f32; with `full` also tgt [b, 4, n] f32 and best
// [b, n_gt] int64. Returns cudaGetLastError() after the launches.
int livecell_match_anchors(const void* anchors, const void* gt,
                           const void* valid, void* max_iou, void* tgt,
                           void* best, int b, int n, int n_gt, int full,
                           void* stream) {
  if (b == 0 || n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kMatchThreads - 1) / kMatchThreads, b);
  const float4* an = static_cast<const float4*>(anchors);
  const float4* g = static_cast<const float4*>(gt);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  if (full) {
    unsigned long long* key = static_cast<unsigned long long*>(best);
    const int total = b * n_gt;
    cudaError_t e = cudaMemsetAsync(key, 0, (size_t)total * 8, st);
    if (e != cudaSuccess) return (int)e;
    match_kernel<true><<<grid, kMatchThreads, 0, st>>>(
        an, g, v, static_cast<float*>(max_iou), static_cast<float*>(tgt), key,
        n, n_gt);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    best_index_kernel<<<(total + 255) / 256, 256, 0, st>>>(key, total);
  } else {
    match_kernel<false><<<grid, kMatchThreads, 0, st>>>(
        an, g, v, static_cast<float*>(max_iou), nullptr, nullptr, n, n_gt);
  }
  return (int)cudaGetLastError();
}

const char* livecell_match_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
