// Fused greedy-NMS suppression fixpoint for Hopper (sm_90a).
//
// Replaces the TPU kernel lsfa_tpu/ops/pallas_nms.py::greedy_alive_pallas
// and computes what it computes, batched: for each batch item b, on boxes
// already in rank order,
//
//   sup[i, j] = (i < j) & (IoU(i, j) > thresh)       (+1 widths,
//               IoU = inter / max(union, 1e-10))
//   alive     = f(valid),  f(a) = valid & (a . sup == 0)
//
// re-applied until alive stops changing or `num_sweeps` applications were
// made (num_sweeps <= 0 returns valid). At the fixpoint this is the greedy
// keep set; an unconverged odd cap gives a subset of it. This is the same
// recurrence, cap and exit as the plain version in ops/nms.py, not a
// sequential greedy bit scan, which would differ when the cap is hit.
//
// What bounds it on the card, and what the design does about it:
//  * Phase 1 (build_sup) computes one IoU per pair: 2M per frame at
//    N = 2048, so it is bound by arithmetic and by launches. It stores
//    each comparison as ONE BIT, not as the TPU kernel's bf16 0/1 matrix:
//    64 rows per 64-bit word, in a (B, words, N) layout in which a warp's
//    32 columns write 32 neighbouring words. At (12, 2048) that is 6.3 MB,
//    which stays in the 50 MB L2 for phase 2.
//  * Phase 2 (sweep_fixpoint) is a latency-bound loop of at most 31
//    sweeps over ~64K word-ANDs per item. One block per item keeps
//    `alive` as bits in shared memory; each thread ORs alive & sup over
//    the words above its column (a 0/1 dot product is zero exactly when
//    this OR is zero), the block rebuilds the words with __ballot_sync,
//    and __syncthreads_or ends the loop at the fixpoint ON THE DEVICE, so
//    the host never waits on the exit test.
//
// The IoU must be bit-identical to the plain version's, which decides
// boxes that sit at the threshold: it is computed in the same order with
// round-to-nearest intrinsics, so no multiply-add is contracted into an
// FMA (the build also passes -fmad=false and never --use_fast_math).
//
// Plain C interface, bound with ctypes from ops/nms_cuda.py. The launch
// uses the caller's stream, does not synchronize, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kBits = 64;           // rows per suppression word
constexpr int kMaxSweepThreads = 1024;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

// IoU(r, c) > thresh, in the plain version's operation order.
__device__ __forceinline__ bool suppresses(float4 r, float ra, float4 c,
                                           float ca, float thresh) {
  float iw = __fadd_rn(__fsub_rn(fminf(r.z, c.z), fmaxf(r.x, c.x)), 1.0f);
  float ih = __fadd_rn(__fsub_rn(fminf(r.w, c.w), fmaxf(r.y, c.y)), 1.0f);
  float inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
  float uni = __fsub_rn(__fadd_rn(ra, ca), inter);
  float iou = __fdiv_rn(inter, fmaxf(uni, 1e-10f));
  return iou > thresh;
}

// grid (words, ceil(n / 64), batch), 64 threads. Block (w, jb, b) writes
// sup[b, w, j] for the 64 columns j of block jb: bit t is set when row
// i = 64 w + t satisfies i < j and IoU(i, j) > thresh.
__global__ void build_sup(const float4* __restrict__ boxes, int n, int words,
                          float thresh, u64* __restrict__ sup) {
  const int w = blockIdx.x;
  const int j = blockIdx.y * kBits + threadIdx.x;
  const int b = blockIdx.z;
  const float4* bx = boxes + (size_t)b * n;
  u64* out = sup + ((size_t)b * words + w) * n;
  if (w > (int)blockIdx.y) {          // every row of this word is below j
    if (j < n) out[j] = 0ull;
    return;
  }
  __shared__ float4 rows[kBits];
  __shared__ float row_area[kBits];
  const int i = w * kBits + threadIdx.x;
  if (i < n) {
    float4 r = bx[i];
    rows[threadIdx.x] = r;
    row_area[threadIdx.x] = box_area(r);
  }
  __syncthreads();
  if (j >= n) return;
  const int lim = min(min(kBits, n - w * kBits), j - w * kBits);
  u64 bits = 0ull;
  if (lim > 0) {
    const float4 c = bx[j];
    const float ca = box_area(c);
    for (int t = 0; t < lim; ++t)
      if (suppresses(rows[t], row_area[t], c, ca, thresh)) bits |= 1ull << t;
  }
  out[j] = bits;
}

__device__ __forceinline__ bool bit_of(const u64* words, int j) {
  return (words[j >> 6] >> (j & 63)) & 1ull;
}

// dst = f(src); returns, to every thread, whether any bit changed.
// blockDim.x is a multiple of 32 and the loop bound words*64 a multiple of
// 64, so every lane of a warp runs the same iterations and the full-mask
// ballot is safe.
__device__ bool sweep(const u64* __restrict__ sup, const u64* vbits,
                      const u64* src, u64* dst, int n, int words) {
  const int lane = threadIdx.x & 31;
  uint32_t* dst32 = reinterpret_cast<uint32_t*>(dst);
  int changed = 0;
  for (int j = threadIdx.x; j < words * kBits; j += blockDim.x) {
    bool keep = false;
    if (j < n && bit_of(vbits, j)) {
      u64 hit = 0ull;
      const int last = j >> 6;        // words holding rows i < j
      for (int w = 0; w <= last && !hit; ++w) hit = src[w] & sup[(size_t)w * n + j];
      keep = (hit == 0ull);
    }
    const uint32_t m = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) dst32[j >> 5] = m;
    changed |= (keep != bit_of(src, j));
  }
  return __syncthreads_or(changed) != 0;
}

// One block per batch item. Shared memory: valid, and two alive buffers,
// each `words` 64-bit words (bit t of word w is rank 64 w + t).
__global__ void sweep_fixpoint(const u64* __restrict__ sup,
                               const uint8_t* __restrict__ valid, int n,
                               int words, int num_sweeps,
                               uint8_t* __restrict__ alive_out,
                               uint8_t* __restrict__ converged_out) {
  extern __shared__ u64 smem[];
  u64* vbits = smem;
  u64* a = smem + words;
  u64* spare = smem + 2 * words;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const u64* sup_b = sup + (size_t)b * words * n;
  const uint8_t* v = valid + (size_t)b * n;

  uint32_t* v32 = reinterpret_cast<uint32_t*>(vbits);
  for (int j = threadIdx.x; j < words * kBits; j += blockDim.x) {
    const uint32_t m = __ballot_sync(0xffffffffu, j < n && v[j] != 0);
    if (lane == 0) v32[j >> 5] = m;
  }
  __syncthreads();

  const u64* alive = vbits;
  bool changed = true;                // unknown until a sweep says otherwise
  if (num_sweeps > 0) {
    changed = sweep(sup_b, vbits, vbits, a, n, words);
    for (int i = 1; i < num_sweeps && changed; ++i) {
      changed = sweep(sup_b, vbits, a, spare, n, words);
      u64* t = a;
      a = spare;
      spare = t;
    }
    alive = a;
  }
  // the last sweep changed nothing => f(alive) == alive; else test it
  const bool converged = !changed || !sweep(sup_b, vbits, alive, spare, n, words);

  for (int j = threadIdx.x; j < n; j += blockDim.x)
    alive_out[(size_t)b * n + j] = bit_of(alive, j) ? 1 : 0;
  if (threadIdx.x == 0) converged_out[b] = converged ? 1 : 0;
}

}  // namespace

// boxes (batch, n, 4) f32 rank-sorted, 16-byte aligned; valid (batch, n)
// u8; sup scratch (batch, ceil(n/64), n) u64; alive (batch, n) u8;
// converged (batch,) u8. Requires 0 < n, 0 < batch <= 65535.
extern "C" int nms_sweep_launch(const void* boxes, const void* valid,
                                int batch, int n, float iou_thresh,
                                int num_sweeps, void* sup, void* alive,
                                void* converged, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (n + kBits - 1) / kBits;
  build_sup<<<dim3(words, words, batch), kBits, 0, s>>>(
      static_cast<const float4*>(boxes), n, words, iou_thresh,
      static_cast<u64*>(sup));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = words * kBits < kMaxSweepThreads ? words * kBits : kMaxSweepThreads;
  const size_t smem = 3 * (size_t)words * sizeof(u64);
  sweep_fixpoint<<<batch, threads, smem, s>>>(
      static_cast<const u64*>(sup), static_cast<const uint8_t*>(valid), n,
      words, num_sweeps, static_cast<uint8_t*>(alive),
      static_cast<uint8_t*>(converged));
  return (int)cudaGetLastError();
}
