// Greedy-NMS suppression fixpoint for Hopper (sm_90a).
//
// Replaces the TPU kernel lsfa_tpu/ops/pallas_nms.py::greedy_alive_pallas
// and computes what it computes, batched: for each batch item b, on boxes
// already in rank order,
//
//   sup[i, j] = (i < j) & (IoU(i, j) > t)       (+1 widths,
//               IoU = fl(inter / max(union, 1e-10)), t = float32(thresh))
//   alive     = f(valid),  f(a) = valid & (a . sup == 0)
//
// re-applied until alive stops changing or `num_sweeps` applications were
// made (num_sweeps <= 0 returns valid). At the fixpoint this is the greedy
// keep set; an unconverged odd cap gives a subset of it. This is the same
// recurrence, cap and exit as the plain version in ops/nms.py, not a
// sequential greedy bit scan, which would differ when the cap is hit.
//
// What bounds it: arithmetic. One IoU test per pair of the strict upper
// triangle, about 16 float32 operations (8 for the two extents, 3 for the
// intersection, 3 for the union and its clamp, 1 division, 1 compare):
// 402 M operations at (12, 2048), 6.0 us at the H100's 67 TFLOP/s, and
// 3.5 us at (330, 300); the bytes (boxes and valid in, alive out) take
// well under a microsecond. The sweeps are a short serial chain (3-8
// sweeps on the main path) whose cost is latency, not throughput.
//
// What the design does about it:
//  * No division. fl(inter / u) > t exactly when inter > m u, or
//    inter == m u and t+ = nextafter(t, inf) has an even mantissa, where
//    m = (t + t+) / 2 is the rounding boundary between t and t+. m u is
//    exact in float64 (25 + 24 significant bits). A float32 filter decides
//    almost every pair with two directed-rounding products,
//    inter > fl_up(t+ u) (then above m u) or inter < fl_down(t u) (then
//    below it); a warp's tile in which some pair falls between the two is
//    built again with the exact float64 test. inter and union are computed
//    in the plain version's operation order with round-to-nearest
//    intrinsics, so no multiply-add is contracted (the build also passes
//    -fmad=false), and masks are bit-equal to the plain version's. For
//    t >= 0 and boxes of area >= 1 (every real proposal) the filter drops
//    two clamps that cannot change its answer (overlap_proper). The
//    build is bound by the SM's min/max/compare pipe, which runs at half
//    the float32 rate: per column and two rows, 10 min/max, 4 compares, 2
//    ballots and a few predicate operations.
//  * One launch for N <= 2048 (every main-path shape). Each item is one
//    thread-block cluster of C CTAs (C a power of two up to 16, picked from
//    B and N so that the grid covers the card's SMs: 16 at (1, 2048), 8 at
//    (12, 2048), 4 at (30, 300), 1 at (330, 300)). The 64-column chunks
//    of the item are dealt to the CTAs by cost (chunk c holds c + 1 tiles
//    of 64 x 64 tests). Each CTA copies all boxes into shared memory with
//    one bulk asynchronous copy behind an mbarrier and builds its chunks'
//    suppression words straight into shared memory: only the words
//    w <= j / 64 that the sweeps read, 64 rows per word, two rows a lane,
//    one __ballot_sync per 32 tests, warps taking tiles from a shared
//    counter. Nothing but alive and converged goes to device memory.
//  * The sweeps read the words from shared memory. After each sweep every
//    CTA writes its new alive bits into every CTA of the cluster through
//    distributed shared memory and the cluster synchronizes once; each CTA
//    then holds the whole alive vector and decides the exit at the
//    fixpoint itself, identically in all CTAs, on the device.
//  * N > 2048 (nms_tier = 0, tests) keeps two phases: the same tile build
//    over the upper-triangle tiles only into a (B, words, N) device
//    scratch, then one block per item sweeping it.
//
// Plain C interface, bound with ctypes from ops/nms_cuda.py. The launch
// uses the caller's stream, does not synchronize, allocates nothing, and
// returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int kBits = 64;              // rows per suppression word
constexpr int kFusedMaxWords = 32;     // fused path: N <= 2048
constexpr int kMaxCluster = 16;        // non-portable cluster size on H100
constexpr int kMaxSmem = 232448;       // shared memory one block can use
constexpr int kMaxSweepThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// The threshold as the division-free test uses it (ops/nms_cuda.py
// division_free_threshold): t, t+ = nextafter(t, inf), m = (t + t+) / 2.
struct Thresh {
  float lo;
  float hi;
  double mid;
  int tie_up;
};

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

// inter and u = max(union, 1e-10) of boxes r and c, in the plain version's
// operation order.
__device__ __forceinline__ void overlap(float4 r, float ra, float4 c, float ca,
                                        float& inter, float& u) {
  float iw = __fadd_rn(__fsub_rn(fminf(r.z, c.z), fmaxf(r.x, c.x)), 1.0f);
  float ih = __fadd_rn(__fsub_rn(fminf(r.w, c.w), fmaxf(r.y, c.y)), 1.0f);
  inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
  u = fmaxf(__fsub_rn(__fadd_rn(ra, ca), inter), 1e-10f);
}

// The same for the float32 filter when t >= 0 and every area of the item
// lies in [1, inf) ("proper" boxes), with two clamps fewer. Then u needs no
// clamp: iw <= the row's and the column's width and ih <= their heights
// (fl is monotone), so inter <= min(ra, ca) and fl(ra + ca) - inter >=
// 0.99. And ih needs none: if iw > 0 >= ih, inter' = iw ih <= 0 and
// u' >= ra + ca, so the filter says false, as for the true inter = 0; if
// inter' == 0 is undecided (t = 0), the exact pass recomputes the tile.
__device__ __forceinline__ void overlap_proper(float4 r, float ra, float4 c, float ca,
                                               float& inter, float& u) {
  float iw = __fadd_rn(__fsub_rn(fminf(r.z, c.z), fmaxf(r.x, c.x)), 1.0f);
  float ih = __fadd_rn(__fsub_rn(fminf(r.w, c.w), fmaxf(r.y, c.y)), 1.0f);
  inter = __fmul_rn(fmaxf(iw, 0.0f), ih);
  u = __fsub_rn(__fadd_rn(ra, ca), inter);
}

// fl(inter / u) > t, exactly, in float64.
__device__ __forceinline__ bool exact_over(float inter, float u, const Thresh& th) {
  const double p = __dmul_rn(th.mid, (double)u);
  const double x = (double)inter;
  return x > p || (x == p && th.tie_up);
}

// Tiles of the upper triangle: kOff lies wholly above the diagonal; kDiag
// crosses it (the pass masks i < j); kDiagTop crosses it with the lower 32
// rows wholly below its columns, so only the upper 32 are tested.
enum TileKind { kOff, kDiag, kDiagTop };

// One pass of a warp over the columns [j0, j0 + ncols) against rows
// [i0, i0 + 64): out[jj] gets the word whose bit t is
// sup[i0 + t, j0 + jj]. rbox/rarea hold the 64 rows, cbox/carea the
// columns. Lane l tests rows l and l + 32 against each column; the two
// ballots are the column's word. With kExact every test is exact; else
// the float32 filter decides, and the pass returns whether this lane met
// a pair between its two products. kProper takes overlap_proper for the
// filter.
template <TileKind kKind, bool kExact, bool kProper>
__device__ __forceinline__ bool tile_pass(const float4* rbox, const float* rarea, int i0,
                                          const float4* cbox, const float* carea, int j0,
                                          int ncols, const Thresh& th, u64* out) {
  constexpr bool kRowsB = kKind != kDiagTop;
  const int lane = threadIdx.x & 31;
  const float4 ra = rbox[lane], rb = rbox[lane + 32];
  const float aa = rarea[lane], ab = rarea[lane + 32];
  const int ia = i0 + lane, ib = ia + 32;
  const float hi = th.hi, lo = th.lo;
  bool amb = false;
#pragma unroll 8
  for (int jj = 0; jj < ncols; ++jj) {
    const float4 c = cbox[jj];
    const float ca = carea[jj];
    float xa, ua, xb = 0.0f, ub = 1.0f;
    if (kProper && !kExact) {
      overlap_proper(ra, aa, c, ca, xa, ua);
      if (kRowsB) overlap_proper(rb, ab, c, ca, xb, ub);
    } else {
      overlap(ra, aa, c, ca, xa, ua);
      if (kRowsB) overlap(rb, ab, c, ca, xb, ub);
    }
    bool ta, tb = false;
    if (kExact) {
      ta = exact_over(xa, ua, th);
      if (kRowsB) tb = exact_over(xb, ub, th);
    } else {
      // bitwise, not short-circuit, so that the loop has no branches
      ta = xa > __fmul_ru(hi, ua);
      bool undecided = xa >= __fmul_rd(lo, ua) & !ta;
      if (kRowsB) {
        tb = xb > __fmul_ru(hi, ub);
        undecided = undecided | (xb >= __fmul_rd(lo, ub) & !tb);
      }
      if (undecided) amb = true;
    }
    const int j = j0 + jj;
    if (kKind != kOff) {
      ta = ta & (ia < j);
      tb = tb & (ib < j);
    }
    const uint32_t bits_a = __ballot_sync(kFull, ta);
    const uint32_t bits_b = kRowsB ? __ballot_sync(kFull, tb) : 0u;
    if (lane == 0) out[jj] = ((u64)bits_b << 32) | bits_a;
  }
  return amb;
}

// A warp's tile of suppression words (see tile_pass): the filter pass, and
// the exact pass over the same tile when any lane met an undecided pair
// (rare: the band between the two products is a few float32 steps wide).
// Every lane of the warp calls it.
template <TileKind kKind, bool kProper>
__device__ __forceinline__ void build_tile_t(const float4* rbox, const float* rarea, int i0,
                                             const float4* cbox, const float* carea, int j0,
                                             int ncols, const Thresh& th, u64* out) {
  const bool undecided =
      tile_pass<kKind, false, kProper>(rbox, rarea, i0, cbox, carea, j0, ncols, th, out);
  if (__any_sync(kFull, undecided))
    tile_pass<kKind, true, false>(rbox, rarea, i0, cbox, carea, j0, ncols, th, out);
}

template <TileKind kKind>
__device__ __forceinline__ void build_tile_k(const float4* rbox, const float* rarea, int i0,
                                             const float4* cbox, const float* carea, int j0,
                                             int ncols, const Thresh& th, bool proper,
                                             u64* out) {
  if (proper)
    build_tile_t<kKind, true>(rbox, rarea, i0, cbox, carea, j0, ncols, th, out);
  else
    build_tile_t<kKind, false>(rbox, rarea, i0, cbox, carea, j0, ncols, th, out);
}

// `proper`: t >= 0 and every area of the item in [1, inf) (overlap_proper).
__device__ __forceinline__ void build_tile(const float4* rbox, const float* rarea, int i0,
                                           const float4* cbox, const float* carea, int j0,
                                           int ncols, const Thresh& th, bool proper, u64* out) {
  if (i0 + 63 < j0)
    build_tile_k<kOff>(rbox, rarea, i0, cbox, carea, j0, ncols, th, proper, out);
  else if (i0 + 32 >= j0 + ncols - 1)
    build_tile_k<kDiagTop>(rbox, rarea, i0, cbox, carea, j0, ncols, th, proper, out);
  else
    build_tile_k<kDiag>(rbox, rarea, i0, cbox, carea, j0, ncols, th, proper, out);
}

// Which CTA of an item's cluster owns each 64-column chunk. Chunk c holds
// (c + 1) * 64 suppression words and as many 64 x 64 tiles of tests.
struct Plan {
  unsigned char owner[kFusedMaxWords];
};

// Dynamic shared memory of the fused kernel, in this order: boxes
// (words * 64 float4), areas (words * 64 float), four alive buffers of 32
// words, the mbarrier, the owned chunks, their word offsets and their
// first build tasks (32 ints each), the number of owned chunks, of build
// tasks and the next free task (padded to 8 bytes), then the suppression
// words.
constexpr size_t kTableBytes = (3 * kFusedMaxWords + 4) * sizeof(int);

__host__ __device__ __forceinline__ size_t fused_head_bytes(int words) {
  return (size_t)words * kBits * (sizeof(float4) + sizeof(float)) +
         4 * kFusedMaxWords * sizeof(u64) + sizeof(u64) + kTableBytes;
}

// Columns of a warp's build task: 16 for small N, where there are few
// tiles to share among the warps, else 32, which loads the rows less often.
__device__ __forceinline__ int tile_cols(int n) { return n > 1024 ? 32 : 16; }

// Build tasks of a chunk per row word: its tile_cols(n)-column parts below n.
__device__ __forceinline__ int parts_of(int c, int n) {
  const int tw = tile_cols(n);
  return min(kBits / tw, (n - c * kBits + tw - 1) / tw);
}

__device__ __forceinline__ bool bit_of(const u64* words, int j) {
  return (words[j >> 6] >> (j & 63)) & 1ull;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// grid (batch * C), cluster (C), blockDim a multiple of 64. One cluster
// per item, CTA rank r of it owning the chunks c with plan.owner[c] == r.
__global__ void __launch_bounds__(512)
nms_fused(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid, int n,
          Thresh th, Plan plan, int num_sweeps, uint8_t* __restrict__ alive_out,
          uint8_t* __restrict__ converged_out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / csize;
  const int words = (n + kBits - 1) / kBits;
  const int cols = words * kBits;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  float4* box_s = reinterpret_cast<float4*>(smem);
  float* area_s = reinterpret_cast<float*>(box_s + cols);
  u64* abuf = reinterpret_cast<u64*>(area_s + cols);     // [4][32]
  u64* mbar = abuf + 4 * kFusedMaxWords;
  int* chunk_of = reinterpret_cast<int*>(mbar + 1);
  int* off_of = chunk_of + kFusedMaxWords;
  int* task_of = off_of + kFusedMaxWords;
  int* nloc_s = task_of + kFusedMaxWords;
  int* ntask_s = nloc_s + 1;
  int* next_task = nloc_s + 2;
  u64* sup_s = reinterpret_cast<u64*>(reinterpret_cast<unsigned char*>(chunk_of) + kTableBytes);

  // boxes: one bulk copy behind the mbarrier, overlapped with the rest
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(mbar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    int nloc = 0, off = 0, tasks = 0;
    for (int c = 0; c < words; ++c) {
      if (plan.owner[c] != rank) continue;
      chunk_of[nloc] = c;
      off_of[nloc] = off;
      task_of[nloc++] = tasks;
      off += (c + 1) * kBits;
      tasks += (c + 1) * parts_of(c, n);
    }
    *nloc_s = nloc;
    *ntask_s = tasks;
    *next_task = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)n * sizeof(float4);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_addr(mbar)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 ::"r"(smem_addr(box_s)), "l"(boxes + (size_t)b * n), "r"(bytes),
                 "r"(smem_addr(mbar)) : "memory");
  }
  // valid bits, whole item, in every CTA
  uint32_t* a32 = reinterpret_cast<uint32_t*>(abuf);
  for (int j0 = warp * 32; j0 < cols; j0 += blockDim.x) {
    const int j = j0 + lane;
    const uint32_t m = __ballot_sync(kFull, j < n && valid[(size_t)b * n + j] != 0);
    if (lane == 0) a32[j0 >> 5] = m;
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(mbar)) : "memory");
  }
  bool proper_here = th.lo >= 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float a = box_area(box_s[i]);
    area_s[i] = a;
    proper_here = proper_here && a >= 1.0f && a < INFINITY;
  }
  const bool proper = __syncthreads_and(proper_here) != 0;

  // build: tasks (owned chunk, row word w <= c, tile_cols(n) columns of
  // the chunk below n), taken by the warps from a shared counter
  const int nloc = *nloc_s, ntask = *ntask_s;
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(next_task, 1);
    t = __shfl_sync(kFull, t, 0);
    if (t >= ntask) break;
    int ci = 0;
    while (ci + 1 < nloc && task_of[ci + 1] <= t) ++ci;
    const int c = chunk_of[ci], parts = parts_of(c, n);
    const int w = (t - task_of[ci]) / parts, h = (t - task_of[ci]) % parts;
    const int tw = tile_cols(n), j0 = c * kBits + tw * h;
    build_tile(box_s + w * kBits, area_s + w * kBits, w * kBits, box_s + j0, area_s + j0, j0,
               min(tw, n - j0), th, proper, sup_s + off_of[ci] + w * kBits + tw * h);
  }
  // a cluster of one CTA needs no cluster barrier and no remote stores
  auto sync = [&]() {
    if (csize == 1)
      __syncthreads();
    else
      cluster.sync();
  };
  sync();              // sup_s complete, and every CTA of the cluster running

  // one sweep: buffer d = f(buffer s) in every CTA; returns whether it
  // changed anything (the same answer in every CTA)
  auto sweep_cluster = [&](int s, int d) -> bool {
    const u64* src = abuf + s * kFusedMaxWords;
    for (int lc0 = warp * 32; lc0 < nloc * kBits; lc0 += blockDim.x) {
      const int lc = lc0 + lane;
      const int ci = lc >> 6, c = chunk_of[ci], jj = lc & 63;
      const int j = c * kBits + jj;
      bool keep = false;
      if (j < n && bit_of(abuf, j)) {
        const u64* col = sup_s + off_of[ci] + jj;
        u64 hit = 0ull;
        for (int w = 0; w <= c && !hit; w += 4) {     // four independent loads a step
          hit = src[w] & col[w * kBits];
          if (w + 1 <= c) hit |= src[w + 1] & col[(w + 1) * kBits];
          if (w + 2 <= c) hit |= src[w + 2] & col[(w + 2) * kBits];
          if (w + 3 <= c) hit |= src[w + 3] & col[(w + 3) * kBits];
        }
        keep = (hit == 0ull);
      }
      const uint32_t m = __ballot_sync(kFull, keep);
      uint32_t* dst = a32 + 2 * kFusedMaxWords * d;
      if (csize == 1 && lane == 0) dst[j >> 5] = m;
      if (csize > 1 && lane < csize) cluster.map_shared_rank(dst, lane)[(j - lane) >> 5] = m;
    }
    sync();
    const u64* dw = abuf + d * kFusedMaxWords;
    return __any_sync(kFull, lane < words && dw[lane] != src[lane]);
  };

  // buffer 0 holds valid; alive rotates over 1, 2, 3, so a sweep never
  // writes a buffer that a slower CTA may still read or compare
  auto next = [](int k) { return k == 3 ? 1 : k + 1; };
  int alive = 0;
  bool changed = true;               // unknown until a sweep says otherwise
  if (num_sweeps > 0) {
    changed = sweep_cluster(0, 1);
    alive = 1;
    for (int i = 1; i < num_sweeps && changed; ++i) {
      changed = sweep_cluster(alive, next(alive));
      alive = next(alive);
    }
  }
  // the last sweep changed nothing => f(alive) == alive; else test it
  const bool converged = !changed || !sweep_cluster(alive, next(alive));

  const u64* a = abuf + alive * kFusedMaxWords;
  const int per = (n + csize - 1) / csize;
  const int lim = min(n, (rank + 1) * per);
  for (int j = rank * per + threadIdx.x; j < lim; j += blockDim.x)
    alive_out[(size_t)b * n + j] = bit_of(a, j) ? 1 : 0;
  if (rank == 0 && threadIdx.x == 0) converged_out[b] = converged ? 1 : 0;
}

// Two-phase path, N > 2048. grid (words * (words + 1) / 2, batch), 64
// threads: block k builds the tile of row word w and column chunk jb,
// w <= jb, into sup[b, w, 64 jb + (0..63)]; tiles below the diagonal are
// never read and never written.
__global__ void build_sup(const float4* __restrict__ boxes, int n, int words, Thresh th,
                          u64* __restrict__ sup) {
  const int k = blockIdx.x;
  int jb = (int)((sqrtf(8.0f * k + 1.0f) - 1.0f) * 0.5f);
  while ((jb + 1) * (jb + 2) / 2 <= k) ++jb;
  while (jb * (jb + 1) / 2 > k) --jb;
  const int w = k - jb * (jb + 1) / 2;
  const int b = blockIdx.y;
  __shared__ float4 rows[kBits], cols[kBits];
  __shared__ float row_area[kBits], col_area[kBits];
  const float4* bx = boxes + (size_t)b * n;
  const int t = threadIdx.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int i = w * kBits + t, j = jb * kBits + t;
  rows[t] = i < n ? bx[i] : zero;
  cols[t] = j < n ? bx[j] : zero;
  row_area[t] = box_area(rows[t]);
  col_area[t] = box_area(cols[t]);
  __syncthreads();
  const int h = t >> 5;                // warp h builds columns 32 h .. 32 h + 31
  const int j0 = jb * kBits + 32 * h;
  if (j0 < n)
    build_tile(rows, row_area, w * kBits, cols + 32 * h, col_area + 32 * h, j0, min(32, n - j0),
               th, false, sup + ((size_t)b * words + w) * n + j0);
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
    const uint32_t m = __ballot_sync(kFull, keep);
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
  extern __shared__ u64 smem64[];
  u64* vbits = smem64;
  u64* a = smem64 + words;
  u64* spare = smem64 + 2 * words;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const u64* sup_b = sup + (size_t)b * words * n;
  const uint8_t* v = valid + (size_t)b * n;

  uint32_t* v32 = reinterpret_cast<uint32_t*>(vbits);
  for (int j = threadIdx.x; j < words * kBits; j += blockDim.x) {
    const uint32_t m = __ballot_sync(kFull, j < n && v[j] != 0);
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

// The plan for `words` chunks over `csize` CTAs: chunks in descending
// cost go to the least-loaded CTA. *most gets the largest load in tiles.
Plan make_plan(int words, int csize, int* most) {
  Plan plan = {};
  int load[kMaxCluster] = {0};
  for (int c = words - 1; c >= 0; --c) {
    int r = 0;
    for (int q = 1; q < csize; ++q)
      if (load[q] < load[r]) r = q;
    plan.owner[c] = (unsigned char)r;
    load[r] += c + 1;
  }
  *most = 0;
  for (int q = 0; q < csize; ++q) *most = load[q] > *most ? load[q] : *most;
  return plan;
}

size_t fused_smem(int words, int most) {
  return fused_head_bytes(words) + (size_t)most * kBits * sizeof(u64);
}

// Per device: the SM count and the largest cluster that fits (16 where
// the card schedules a non-portable cluster of 16 at the largest shared
// memory the fused kernel asks for, else 8). The kernel's attributes are
// set on first use.
struct DeviceInfo {
  int sms = 0;
  int max_cluster = 0;
};

cudaError_t device_info(int device, DeviceInfo* out) {
  static DeviceInfo cache[64];
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  DeviceInfo& d = cache[device];
  if (d.sms == 0) {
    int sms = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(nms_fused, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(nms_fused, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    int most = 0;
    make_plan(kFusedMaxWords, kMaxCluster, &most);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kMaxCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(kMaxCluster);
    cfg.blockDim = dim3(512);
    cfg.dynamicSmemBytes = fused_smem(kFusedMaxWords, most);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, (const void*)nms_fused, &cfg) != cudaSuccess)
      clusters = 0;
    cudaGetLastError();               // a refused query is not an error of the launch
    d.max_cluster = clusters > 0 ? kMaxCluster : 8;
    d.sms = sms;
  }
  *out = d;
  return cudaSuccess;
}

// Cluster size for (batch, words): the power of two C up to the device's
// limit and `words` that minimizes the CTAs' rounds per SM,
// ceil(batch C / SMs), times the largest CTA's tiles plus kCtaTiles for
// what every CTA repeats (boxes, valid bits, sweeps), among those whose
// shared memory fits; the smallest such C on ties. Sizes that are not
// powers of two leave SMs of a GPC idle and measure slower.
constexpr int kCtaTiles = 4;

int pick_cluster(int batch, int words, const DeviceInfo& d) {
  int best = 0;
  long long best_cost = 0;
  const int top = words < d.max_cluster ? words : d.max_cluster;
  for (int c = 1; c <= top; c *= 2) {
    int most = 0;
    make_plan(words, c, &most);
    if (fused_smem(words, most) > (size_t)kMaxSmem) continue;
    const long long rounds = ((long long)batch * c + d.sms - 1) / d.sms;
    const long long cost = rounds * (most + kCtaTiles);
    if (best == 0 || cost < best_cost) {
      best = c;
      best_cost = cost;
    }
  }
  return best;
}

// Makes `device` current, so that device_info sets the kernel's
// attributes and queries occupancy on the card it caches them for.
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// The cluster size the fused path picks for (batch, n), 0 for the
// two-phase path (n > 2048), or a negative CUDA error.
extern "C" int nms_sweep_cluster_size(int batch, int n, int device) {
  const int words = (n + kBits - 1) / kBits;
  if (words > kFusedMaxWords) return 0;
  cudaError_t err = use_device(device);
  DeviceInfo d;
  if (err == cudaSuccess) err = device_info(device, &d);
  if (err != cudaSuccess) return -(int)err;
  return pick_cluster(batch, words, d);
}

// boxes (batch, n, 4) f32 rank-sorted, 16-byte aligned; valid (batch, n)
// u8; alive (batch, n) u8; converged (batch,) u8; the threshold as
// (t, t+, m, tie_up) from ops/nms_cuda.py::division_free_threshold. sup
// is a (batch, ceil(n/64), n) u64 scratch for n > 2048 and unused (may be
// null) otherwise. Requires 0 < n <= 8192, 0 < batch <= 65535.
extern "C" int nms_sweep_launch(const void* boxes, const void* valid, int batch, int n,
                                float t_lo, float t_hi, double mid, int tie_up,
                                int num_sweeps, void* sup, void* alive, void* converged,
                                int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Thresh th{t_lo, t_hi, mid, tie_up};
  const int words = (n + kBits - 1) / kBits;
  const float4* bx = static_cast<const float4*>(boxes);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  uint8_t* al = static_cast<uint8_t*>(alive);
  uint8_t* cv = static_cast<uint8_t*>(converged);

  if (words <= kFusedMaxWords) {
    DeviceInfo d;
    err = device_info(device, &d);
    if (err != cudaSuccess) return (int)err;
    const int csize = pick_cluster(batch, words, d);
    int most = 0;
    const Plan plan = make_plan(words, csize, &most);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = csize;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(batch * csize);
    // one sweep thread per column for a single CTA, at most 512
    cfg.blockDim = dim3(csize > 1 ? 512 : (words * kBits < 512 ? words * kBits : 512));
    cfg.dynamicSmemBytes = fused_smem(words, most);
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, nms_fused, bx, v, n, th, plan, num_sweeps, al, cv);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }

  build_sup<<<dim3(words * (words + 1) / 2, batch), kBits, 0, s>>>(
      bx, n, words, th, static_cast<u64*>(sup));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = words * kBits < kMaxSweepThreads ? words * kBits : kMaxSweepThreads;
  const size_t smem = 3 * (size_t)words * sizeof(u64);
  sweep_fixpoint<<<batch, threads, smem, s>>>(static_cast<const u64*>(sup), v, n, words,
                                              num_sweeps, al, cv);
  return (int)cudaGetLastError();
}
