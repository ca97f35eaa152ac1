// Fused anchor-GT matcher on Hopper (sm_90a): K4. Plain C entry point,
// loaded with ctypes by livecell_tpu_torch/ops/cuda_match.py, which holds
// the plain PyTorch version (`match_anchors_plain`), a plain emulation of
// this decomposition (`match_anchors_emulated`) and the launch counter.
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
//    output. The first design gave each thread one anchor and walked every
//    GT slot in series, an IEEE division and (full) a warp reduction per
//    pair: at one image of 4,096 GT that left about 9 warps an SM on long
//    dependent chains, and most of its pairs could not change the result.
//    Here:
//    - a block of kThreads threads owns kAnchors = 4 kThreads anchors of
//      one image (kPerThread a thread, kThreads apart, so stores stay
//      coalesced) and one chunk of the image's GT slots. Where images x
//      anchor blocks would leave the card short of blocks (one image), the
//      GT axis is split into chunks across a third grid dimension;
//    - the block stages only the valid GT of each tile of kThreads slots in
//      shared memory, compacted in index order (warp ballots), with their
//      slot indices;
//    - every valid IoU is >= +0 and an invalid one is -1, so an anchor's
//      max starts at +0 on the image's first valid GT, and only a pair with
//      a positive intersection can raise it: a pair whose intersection is
//      0 (IoU +0 exactly) costs the overlap test alone, no division;
//    - (full) a GT's best anchor is reduced over a warp only when one of
//      the warp's pairs has positive IoU, and merged across warps and
//      blocks with one 64-bit atomicMax of a key packing the IoU's order
//      bits above the complement of the anchor index. A GT that no anchor
//      overlaps (or an invalid one) keeps key 0, which means anchor 0: its
//      max IoU is +0 (or -1) at every anchor, and the first is anchor 0;
//    - with several chunks, each anchor's chunk max is merged the same
//      way, keyed by the complement of the GT slot (the first GT among
//      equal IoU); each image's first valid slot by atomicMin.
//      match_finalize_kernel then turns the keys into max_iou, the targets
//      and each GT's anchor index.
//    A max of keys does not depend on the order of the atomics, so the
//    outputs are the same in every run, and the same bit for bit as the
//    first design's: the IoU of every pair that can win is computed with
//    the same rounded intrinsics (__fsub_rn, __fmul_rn, ... stop the
//    compiler from contracting a*b+c into one FMA, so every step rounds
//    where the plain version's tensor ops round and max_iou agrees with
//    it bit for bit), and the targets with the same intrinsics and logf
//    (which may differ from torch.log by an ulp: tolerance 1e-5, the JAX
//    kernel's).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;                     // anchors of a thread
constexpr int kAnchors = kThreads * kPerThread;   // anchors of a block
constexpr int kWantBlocks = 2048;  // ~2 waves of resident blocks, 132 SMs
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kNoGt = 0x7f7f7f7f;  // cudaMemsetAsync(0x7f): no valid slot

// Monotone map of a float onto unsigned ints (IoU has no NaN and, as
// computed, no negative zero).
__device__ __forceinline__ unsigned int order_bits(float v) {
  const unsigned int b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The inverse of order_bits for a positive value.
__device__ __forceinline__ float positive_from_bits(unsigned int bits) {
  return __uint_as_float(bits & 0x7fffffffu);
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// ops.boxes.encode_boxes with the 1.0 size clamps (pallas_match.py:84-96)
// of GT box g against anchor `an`, into the planar targets tb [4, n].
__device__ __forceinline__ void encode(float4 an, float4 g, float* tb,
                                       size_t n, size_t a) {
  const float aw = fmaxf(__fsub_rn(an.z, an.x), 1.0f);
  const float ah = fmaxf(__fsub_rn(an.w, an.y), 1.0f);
  const float acx = __fmul_rn(__fadd_rn(an.x, an.z), 0.5f);
  const float acy = __fmul_rn(__fadd_rn(an.y, an.w), 0.5f);
  const float bw = fmaxf(__fsub_rn(g.z, g.x), 1.0f);
  const float bh = fmaxf(__fsub_rn(g.w, g.y), 1.0f);
  const float bcx = __fmul_rn(__fadd_rn(g.x, g.z), 0.5f);
  const float bcy = __fmul_rn(__fadd_rn(g.y, g.w), 0.5f);
  tb[a] = __fdiv_rn(__fsub_rn(bcx, acx), aw);
  tb[n + a] = __fdiv_rn(__fsub_rn(bcy, acy), ah);
  tb[2 * n + a] = logf(__fdiv_rn(bw, aw));
  tb[3 * n + a] = logf(__fdiv_rn(bh, ah));
}

// Grid (anchor blocks, images, GT chunks of `chunk` slots). `chunked`:
// more than one chunk, the results go to the keys akey [b, n] (64-bit
// when kFull, else the 32-bit order bits) and first [b]; otherwise the
// block writes max_iou and (kFull) tgt itself. best_key [b, n_gt] is
// written when kFull.
template <bool kFull>
__global__ void __launch_bounds__(kThreads)
match_kernel(const float4* __restrict__ anchors, const float4* __restrict__ gt,
             const unsigned char* __restrict__ valid,
             float* __restrict__ max_iou, float* __restrict__ tgt,
             unsigned long long* __restrict__ best_key,
             void* __restrict__ akey, int* __restrict__ first_valid, int n,
             int n_gt, int chunk, bool chunked) {
  __shared__ float4 s_box[kThreads];
  __shared__ float s_area[kThreads];
  __shared__ int s_idx[kThreads];
  __shared__ int s_count[kWarps];

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int a0 = blockIdx.x * kAnchors + threadIdx.x;
  const float4* gtb = gt + (size_t)b * n_gt;
  const unsigned char* vb = valid + (size_t)b * n_gt;
  const int g_lo = blockIdx.z * chunk, g_hi = min(n_gt, g_lo + chunk);

  float4 an[kPerThread];
  float area[kPerThread], best[kPerThread];
  int arg[kPerThread];  // GT slot of best, -1: none positive yet
#pragma unroll
  for (int s = 0; s < kPerThread; ++s) {
    const int a = a0 + s * kThreads;
    // A dead lane's empty box meets no GT: never a positive IoU.
    an[s] = a < n ? anchors[a] : make_float4(0.f, 0.f, 0.f, 0.f);
    area[s] = box_area(an[s]);
    best[s] = 0.0f;
    arg[s] = -1;
  }

  int first = -1;  // the chunk's first valid slot
  for (int t0 = g_lo; t0 < g_hi; t0 += kThreads) {
    // Stage this tile's valid GT, compacted in slot order.
    const int gi = t0 + threadIdx.x;
    const bool v = gi < g_hi && vb[gi] != 0;
    const unsigned ballot = __ballot_sync(kAllLanes, v);
    __syncthreads();  // the previous tile's readers are done
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int at = 0, count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? s_count[w] : 0;
      count += s_count[w];
    }
    if (v) {
      const int j = at + __popc(ballot & ((1u << lane) - 1u));
      const float4 g = gtb[gi];
      s_box[j] = g;
      s_area[j] = box_area(g);
      s_idx[j] = gi;
    }
    __syncthreads();
    if (count == 0) continue;
    if (first < 0) first = s_idx[0];

    for (int j = 0; j < count; ++j) {
      const float4 g = s_box[j];
      float inter[kPerThread];
      bool any = false;
#pragma unroll
      for (int s = 0; s < kPerThread; ++s) {
        const float iw =
            fmaxf(__fsub_rn(fminf(an[s].z, g.z), fmaxf(an[s].x, g.x)), 0.0f);
        const float ih =
            fmaxf(__fsub_rn(fminf(an[s].w, g.w), fmaxf(an[s].y, g.y)), 0.0f);
        inter[s] = __fmul_rn(iw, ih);
        any |= inter[s] > 0.0f;
      }
      unsigned int key = 0;  // kFull: this thread's best pair for GT j
      int key_anchor = 0;
      if (any) {
        const float ga = s_area[j];
#pragma unroll
        for (int s = 0; s < kPerThread; ++s) {
          if (!(inter[s] > 0.0f)) continue;
          const float uni = __fsub_rn(__fadd_rn(area[s], ga), inter[s]);
          const float iou =
              uni > 0.0f ? __fdiv_rn(inter[s], fmaxf(uni, 1e-12f)) : 0.0f;
          if (iou > best[s]) {  // strict: the first GT among equal IoU
            best[s] = iou;
            arg[s] = s_idx[j];
          }
          // Strict, s ascending: the thread's first anchor at its max.
          if (kFull && iou > 0.0f && order_bits(iou) > key) {
            key = order_bits(iou);
            key_anchor = a0 + s * kThreads;
          }
        }
      }
      if (kFull) {
        if (__any_sync(kAllLanes, key != 0)) {  // some lane has IoU > 0
          const unsigned int m = __reduce_max_sync(kAllLanes, key);
          const unsigned int lowest = __reduce_min_sync(
              kAllLanes, key == m ? (unsigned)key_anchor : 0xffffffffu);
          if (lane == 0)
            atomicMax(best_key + (size_t)b * n_gt + s_idx[j],
                      ((unsigned long long)m << 32) | (0xffffffffu - lowest));
        }
      }
    }
  }

  if (chunked) {
    if (blockIdx.x == 0 && threadIdx.x == 0 && first >= 0)
      atomicMin(first_valid + b, first);
#pragma unroll
    for (int s = 0; s < kPerThread; ++s) {
      const int a = a0 + s * kThreads;
      if (a >= n || arg[s] < 0) continue;
      const size_t i = (size_t)b * n + a;
      if (kFull)
        atomicMax(static_cast<unsigned long long*>(akey) + i,
                  ((unsigned long long)order_bits(best[s]) << 32) |
                      (0xffffffffu - (unsigned)arg[s]));
      else
        atomicMax(static_cast<unsigned int*>(akey) + i, order_bits(best[s]));
    }
    return;
  }
  // One chunk: the whole image. No valid GT: IoU -1 and GT 0 everywhere;
  // no positive IoU: +0 and the first valid GT.
#pragma unroll
  for (int s = 0; s < kPerThread; ++s) {
    const int a = a0 + s * kThreads;
    if (a >= n) continue;
    max_iou[(size_t)b * n + a] = first < 0 ? -1.0f : best[s];
    if (kFull) {
      const int g = arg[s] >= 0 ? arg[s] : max(first, 0);
      encode(an[s], gtb[g], tgt + (size_t)b * 4 * n, n, a);
    }
  }
}

// Keys -> outputs: for i < b * n (`chunked`) anchor i's max_iou and
// (kFull) targets from its key akey[i] and its image's first valid slot;
// then (kFull) each of the b * n_gt GT keys -> its anchor index, in place
// (key 0: anchor 0).
template <bool kFull>
__global__ void match_finalize_kernel(const float4* __restrict__ anchors,
                                      const float4* __restrict__ gt,
                                      const void* __restrict__ akey,
                                      const int* __restrict__ first_valid,
                                      float* __restrict__ max_iou,
                                      float* __restrict__ tgt,
                                      unsigned long long* __restrict__ best,
                                      int b, int n, int n_gt, bool chunked) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_anchor = chunked ? (long long)b * n : 0;
  if (i < n_anchor) {
    const int img = (int)(i / n), a = (int)(i - (long long)img * n);
    const int first = first_valid[img];
    const bool has = first != kNoGt;
    unsigned int bits;
    int g;
    if (kFull) {
      const unsigned long long k =
          static_cast<const unsigned long long*>(akey)[i];
      bits = (unsigned int)(k >> 32);
      g = bits ? (int)(0xffffffffu - (unsigned int)k) : (has ? first : 0);
    } else {
      bits = static_cast<const unsigned int*>(akey)[i];
      g = 0;
    }
    max_iou[i] = bits ? positive_from_bits(bits) : (has ? 0.0f : -1.0f);
    if (kFull)
      encode(anchors[a], gt[(size_t)img * n_gt + g], tgt + (size_t)img * 4 * n,
             n, a);
    return;
  }
  i -= n_anchor;
  if (kFull && i < (long long)b * n_gt) {
    const unsigned long long k = best[i];
    best[i] = k ? 0xffffffffull - (k & 0xffffffffull) : 0ull;
  }
}

// GT chunks of one call: one unless images x anchor blocks fall short of
// kWantBlocks, then enough to reach it, a chunk never below one tile of
// kThreads slots.
int gt_chunks(int b, int n, int n_gt) {
  const long long blocks = (long long)((n + kAnchors - 1) / kAnchors) * b;
  if (blocks >= kWantBlocks || n_gt <= kThreads) return 1;
  const long long want = (kWantBlocks + blocks - 1) / blocks;
  const long long most = (n_gt + kThreads - 1) / kThreads;
  const int chunks = (int)(want < most ? want : most);
  const int chunk = (n_gt + chunks - 1) / chunks;
  return (n_gt + chunk - 1) / chunk;
}

size_t key_bytes(int b, int n, int full) {
  return (size_t)b * n * (full ? 8 : 4);
}

}  // namespace

extern "C" {

// GT chunks the call at these shapes runs (1: no finalize pass unless
// `full`).
int livecell_match_chunks(int b, int n, int n_gt) {
  return gt_chunks(b, n, n_gt);
}

// Bytes of scratch the call at these shapes needs (0 with one chunk):
// the anchors' keys, then each image's first valid slot.
long long livecell_match_scratch_bytes(int b, int n, int n_gt, int full) {
  if (b == 0 || n == 0 || gt_chunks(b, n, n_gt) == 1) return 0;
  return (long long)(key_bytes(b, n, full) + (size_t)b * 4);
}

// anchors [n, 4] f32, gt [b, n_gt, 4] f32, valid [b, n_gt] bool ->
// max_iou [b, n] f32; with `full` also tgt [b, 4, n] f32 and best
// [b, n_gt] int64. scratch: livecell_match_scratch_bytes() bytes, 8-byte
// aligned. Returns cudaGetLastError() after the launches.
int livecell_match_anchors(const void* anchors, const void* gt,
                           const void* valid, void* max_iou, void* tgt,
                           void* best, void* scratch, int b, int n, int n_gt,
                           int full, void* stream) {
  if (b == 0 || n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = gt_chunks(b, n, n_gt);
  const int chunk = (n_gt + chunks - 1) / chunks;
  const bool chunked = chunks > 1;
  const dim3 grid((n + kAnchors - 1) / kAnchors, b, chunks);
  const float4* an = static_cast<const float4*>(anchors);
  const float4* g = static_cast<const float4*>(gt);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  float* mx = static_cast<float*>(max_iou);
  float* tg = static_cast<float*>(tgt);
  unsigned long long* key = static_cast<unsigned long long*>(best);
  char* akey = static_cast<char*>(scratch);
  int* first = chunked
                   ? reinterpret_cast<int*>(akey + key_bytes(b, n, full))
                   : nullptr;
  cudaError_t e;
  if (full) {
    e = cudaMemsetAsync(key, 0, (size_t)b * n_gt * 8, st);
    if (e != cudaSuccess) return (int)e;
  }
  if (chunked) {
    e = cudaMemsetAsync(akey, 0, key_bytes(b, n, full), st);
    if (e == cudaSuccess) e = cudaMemsetAsync(first, 0x7f, (size_t)b * 4, st);
    if (e != cudaSuccess) return (int)e;
  }
  if (full)
    match_kernel<true><<<grid, kThreads, 0, st>>>(an, g, v, mx, tg, key, akey,
                                                  first, n, n_gt, chunk,
                                                  chunked);
  else
    match_kernel<false><<<grid, kThreads, 0, st>>>(an, g, v, mx, nullptr,
                                                   nullptr, akey, first, n,
                                                   n_gt, chunk, chunked);
  e = cudaGetLastError();
  if (e != cudaSuccess || !(full || chunked)) return (int)e;
  const long long total =
      (chunked ? (long long)b * n : 0) + (full ? (long long)b * n_gt : 0);
  const unsigned blocks = (unsigned)((total + 255) / 256);
  if (full)
    match_finalize_kernel<true><<<blocks, 256, 0, st>>>(
        an, g, akey, first, mx, tg, key, b, n, n_gt, chunked);
  else
    match_finalize_kernel<false><<<blocks, 256, 0, st>>>(
        an, g, akey, first, mx, nullptr, nullptr, b, n, n_gt, chunked);
  return (int)cudaGetLastError();
}

const char* livecell_match_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
