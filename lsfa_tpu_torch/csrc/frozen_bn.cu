// Frozen (inference) BatchNorm with an optional ReLU, in one pass, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which
// fuses it into its neighbours. It was added because the plain chain on
// the card (upcast to float32, cuDNN's float32 bn_fw_inf, cast back, then
// the ReLU) launches 3-4 kernels and moves 24 bytes per bf16 element.
//
//   y = fma(float(x) - mean[c], k[c], beta[c]),   k[c] = gamma[c] * (1 / sqrt(var[c] + eps))
//
// in float32, the grouping of flax's BatchNorm ((x - mean) * (rsqrt(var +
// eps) * scale) + bias), with 1 / sqrt rounded as the CPU's invstd; then
// ReLU if asked, rounded once to the output type. Without gamma, k is
// the inverse deviation. The statistics (float32) and gamma and beta
// (float32, or bf16 where the parameters are stored in bf16) are read
// here: nothing prepares them per call.
//
// What bounds it: device memory. One read of x and one write of y (4
// bytes an element in bf16), (in + out bytes) / 3.35 TB/s on an H100; the
// arithmetic (a subtract and an FMA an element) is far below the card's.
//
// What the design does about it, by layout (the host picks the route):
//  * rows: channels-last (the models' NHWC viewed as NCHW), C % 8 == 0,
//    C <= 2048, 16-byte aligned. A block of 256 threads spans whole rows
//    of C / 8 groups of 8 channels; a thread owns one group, keeps its 8
//    channels' constants in registers and moves 8 elements per 16-byte
//    access (two for float32), 128 bytes of loads in flight, kept packed.
//    The grid is the card's resident blocks, or the slabs if fewer, so B
//    = 1 maps fill the SMs too; each block takes an even share of the
//    slabs.
//  * any: every other dense layout (bn_data's C = 3, NCHW): one element
//    per access, the constants from a table in shared memory (C <= 4096;
//    one wave of blocks steps over the tensor, so each block fills its
//    table once). No cell runs NCHW.
//
// Types (x -> y): bf16 -> bf16 and float32 -> float32, and float32 ->
// bf16, which a bf16 fusion BatchNorm takes on the float32 warped feature.
//
// Plain C interface, bound with ctypes from ops/bn_cuda.py. The launch
// uses the caller's stream, does not synchronize, allocates nothing, and
// returns cudaGetLastError(). With `empty` it launches an empty kernel
// on the grid it would use instead: the launch's own floor, to measure.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;             // elements per access of the rows route
constexpr int kUnroll = 4;          // elements in flight per thread of the any route
constexpr int kRowsMaxC = kThreads * kVec;
constexpr int kTableMaxC = 4096;    // 48 KB of shared memory at 12 bytes a channel
constexpr int kMaxDevices = 64;

// bits of `dtypes`: which arrays are bf16 (else float32); gamma and beta
// share one
enum : int { kXBf16 = 1, kYBf16 = 2, kAffineBf16 = 4 };

struct Affine {
  const float* mean;
  const float* var;
  const void* gamma;   // null: no scale
  const void* beta;
  bool bf16;           // gamma and beta
  float eps;
  int relu;
};

struct Chan {
  float m, k, b;
};

__device__ __forceinline__ float param(const void* p, bool bf16, int c) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
              : __ldg(static_cast<const float*>(p) + c);
}

__device__ __forceinline__ Chan channel(const Affine& a, int c) {
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__ldg(a.var + c), a.eps)));
  const float k = a.gamma ? __fmul_rn(inv, param(a.gamma, a.bf16, c)) : inv;
  return {__ldg(a.mean + c), k, param(a.beta, a.bf16, c)};
}

// NaN stays NaN through the ReLU, as torch.relu keeps it
__device__ __forceinline__ float apply(float x, const Chan& ch, int relu) {
  const float y = __fmaf_rn(__fsub_rn(x, ch.m), ch.k, ch.b);
  return (relu && y < 0.0f) ? 0.0f : y;
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// 8 elements as loaded, kept packed until they are used: 16 bytes of
// bf16 (4 registers), 32 of float32
template <typename T>
struct Pack;
template <>
struct Pack<__nv_bfloat16> {
  uint4 v;
};
template <>
struct Pack<float> {
  float4 lo, hi;
};

__device__ __forceinline__ Pack<__nv_bfloat16> load_pack(const __nv_bfloat16* p) {
  return {__ldg(reinterpret_cast<const uint4*>(p))};
}

__device__ __forceinline__ Pack<float> load_pack(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return {__ldg(q), __ldg(q + 1)};
}

// a bf16 is the top half of its float32
__device__ __forceinline__ void unpack(const Pack<__nv_bfloat16>& k, float (&f)[kVec]) {
  const uint32_t w[4] = {k.v.x, k.v.y, k.v.z, k.v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const Pack<float>& k, float (&f)[kVec]) {
  f[0] = k.lo.x; f[1] = k.lo.y; f[2] = k.lo.z; f[3] = k.lo.w;
  f[4] = k.hi.x; f[5] = k.hi.y; f[6] = k.hi.z; f[7] = k.hi.w;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[kVec]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

__device__ __forceinline__ void store8(float* p, const float (&f)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// rows: x is `rows` rows of C = kVec * groups channels. A slab is `per`
// = kThreads / groups rows of `groups` threads (the threads past per *
// groups idle). Block b takes an even share of the slabs, consecutive, in
// runs of 128 bytes of loads a thread; its first loads start before
// the channels' constants are formed, so that the two latencies overlap.
template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
bn_rows(const TI* __restrict__ x, TO* __restrict__ y, long long rows, int groups, Affine a) {
  constexpr int kLoads = 128 / (kVec * sizeof(TI));
  const int per = kThreads / groups;
  const int g = threadIdx.x % groups, r = threadIdx.x / groups;
  if (r >= per) return;
  const long long c = (long long)groups * kVec, step = per * c;
  const long long slabs = (rows + per - 1) / per;
  const long long lo = slabs * blockIdx.x / gridDim.x, hi = slabs * (blockIdx.x + 1) / gridDim.x;
  Chan ch[kVec];
  bool formed = false;
  for (long long s0 = lo; s0 < hi; s0 += kLoads) {
    const long long base = (s0 * per + r) * c + g * kVec;
    Pack<TI> raw[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (s0 + u < hi && (s0 + u) * per + r < rows) raw[u] = load_pack(x + base + u * step);
    if (!formed) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) ch[e] = channel(a, g * kVec + e);
      formed = true;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (!(s0 + u < hi && (s0 + u) * per + r < rows)) continue;
      float f[kVec];
      unpack(raw[u], f);
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] = apply(f[e], ch[e], a.relu);
      store8(y + base + u * step, f);
    }
  }
}

// any: n elements, element i in channel (i / inner) % c, c <= kTableMaxC.
template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
bn_any(const TI* __restrict__ x, TO* __restrict__ y, long long n, int c, long long inner,
       Affine a) {
  extern __shared__ float tab[];    // m, k, b of each channel
  for (int cc = threadIdx.x; cc < c; cc += kThreads) {
    const Chan ch = channel(a, cc);
    tab[3 * cc] = ch.m;
    tab[3 * cc + 1] = ch.k;
    tab[3 * cc + 2] = ch.b;
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i0 = (long long)blockIdx.x * kThreads + threadIdx.x; i0 < n;
       i0 += kUnroll * stride) {
    float f[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + u * stride < n) f[u] = load1(x + i0 + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * stride;
      if (i >= n) continue;
      const int cc = (int)((inner == 1 ? i : i / inner) % c);
      store1(y + i, apply(f[u], Chan{tab[3 * cc], tab[3 * cc + 1], tab[3 * cc + 2]}, a.relu));
    }
  }
}

__global__ void bn_empty() {}

// Blocks of `kernel` resident on the device at once (SMs x blocks per SM,
// no dynamic shared memory), queried once per kernel and device: the most
// blocks the rows and any routes launch.
template <auto kernel>
cudaError_t resident(int device, long long* out) {
  static std::atomic<int> cached[kMaxDevices];   // zero: not yet queried
  const int slot = device < kMaxDevices ? device : kMaxDevices - 1;
  int got = cached[slot].load(std::memory_order_relaxed);
  if (got == 0 || device >= kMaxDevices) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    got = sms * (per_sm > 0 ? per_sm : 1);
    cached[slot].store(got, std::memory_order_relaxed);
  }
  *out = got;
  return cudaSuccess;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }
long long min_ll(long long a, long long b) { return a < b ? a : b; }

template <typename TI, typename TO>
cudaError_t route(const void* xv, void* yv, long long n, int c, long long inner, const Affine& a,
                  bool empty, int device, cudaStream_t s) {
  const TI* x = static_cast<const TI*>(xv);
  TO* y = static_cast<TO*>(yv);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  long long most = 0;
  cudaError_t err;
  if (inner == 1 && c % kVec == 0 && c <= kRowsMaxC && aligned) {
    const int groups = c / kVec;
    const long long slabs = ceil_div(n / c, kThreads / groups);
    if ((err = resident<bn_rows<TI, TO>>(device, &most)) != cudaSuccess) return err;
    const unsigned grid = (unsigned)min_ll(slabs, most);
    if (empty) bn_empty<<<grid, kThreads, 0, s>>>();
    else bn_rows<TI, TO><<<grid, kThreads, 0, s>>>(x, y, n / c, groups, a);
  } else {
    // the table may leave fewer blocks resident: the rest wait their turn
    if ((err = resident<bn_any<TI, TO>>(device, &most)) != cudaSuccess) return err;
    const unsigned grid = (unsigned)min_ll(ceil_div(n, kThreads), most);
    const size_t table = 3 * sizeof(float) * c;
    if (empty) bn_empty<<<grid, kThreads, table, s>>>();
    else bn_any<TI, TO><<<grid, kThreads, table, s>>>(x, y, n, c, inner, a);
  }
  return cudaGetLastError();
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// x and y: n elements, dense, with the same strides; element i in channel
// (i / inner) % c (inner = 1 for channels-last, H * W for NCHW). mean and
// var hold c float32 values, beta (and gamma, or null) c values of the
// type kAffineBf16 names. `dtypes` says which arrays are bf16: x and y
// both, neither, or y alone. n > 0, 0 < c <= kTableMaxC.
extern "C" int frozen_bn_launch(const void* x, void* y, const float* mean, const float* var,
                                const void* gamma, const void* beta, int dtypes, long long n,
                                int c, long long inner, int relu, float eps, int empty,
                                int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const Affine a{mean, var, gamma, beta, (dtypes & kAffineBf16) != 0, eps, relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool xb = dtypes & kXBf16, yb = dtypes & kYBf16;
  if (xb && yb) err = route<__nv_bfloat16, __nv_bfloat16>(x, y, n, c, inner, a, empty, device, s);
  else if (yb) err = route<float, __nv_bfloat16>(x, y, n, c, inner, a, empty, device, s);
  else err = route<float, float>(x, y, n, c, inner, a, empty, device, s);
  return (int)err;
}
