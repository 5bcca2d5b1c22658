// K9 tanh-GELU for Hopper: forward and backward.
//
// Replaces: jax.nn.gelu (approximate=True, its default) in
// kubernetes1_tpu/workloads/bert.py, line 132 (on the (B*S, d_ff) output
// of x @ w_in) and line 151 (the MLM transform head, (B*S, d)):
//   y = x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3))).
// The kernel computes in f32 with the exact constants and rounds once to
// bf16.  (XLA:CPU rounds JAX's bf16 gelu after each op and casts sqrt(2/pi)
// to bf16; the round-once result is the better function and lies within
// 2^-7 * |x| of it.)  The elementwise products and sums are kept apart
// (__fmul_rn, __fadd_rn: no FMA contraction), as the plain version's
// separate ops round them.
//   backward: dx = bf16(dy * (cdf + x * 0.5 * (1 - t^2) * sqrt(2/pi) *
//             (1 + 3 * 0.044715 * x^2))), t = tanh(...), cdf = 0.5 (1 + t),
//             in f32.
//
// Bound on the H100: bytes.  Forward reads x and writes y (4 bytes an
// element, ~12 flops); backward reads x and dy and writes dx (6 bytes,
// ~20 flops): below the ~20 f32 flops a byte the card can do beside its
// HBM rate.
//
// Design: the f32 expression is fixed by the bit-equality with the plain
// version, so the speed is in how the work is fed.  Each thread loads
// kVec 16-byte vectors of 8 elements (of x, and of dy in the backward)
// before any arithmetic, neighbouring threads on neighbouring addresses,
// computes them and is done: a grid of many short blocks, whose turnover
// keeps loads in flight on every SM while others compute.  (On the H100 a
// grid of resident blocks walking the tensor, with or without the next
// vectors loaded ahead, measured ~18 % slower; 2 vectors of 256 threads
// were the best of 128-1024 threads by 2-8 vectors.)  Indices are 32-bit
// where the vector count allows it, and the bf16 <-> f32 conversions are
// the packed bf16x2 ones, which round as the scalar ones do.  At BERT's
// (16384, 4096) the kernel runs as fast as a torch copy of the same bytes,
// with ~27 (forward) and ~37 (backward) SASS instructions an element, a
// bit over half of the time the card takes to issue them: bytes, not
// issue, set its pace.

#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 2;  // 16-byte vectors a thread loads before computing
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kCoeff = 0.044715f;
constexpr float kCoeff3 = 0.134145f;  // 3 * 0.044715

// t = tanh(sqrt(2/pi) * (x + 0.044715 * x^3)), the order of jax.nn.gelu
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  return tanhf(__fmul_rn(kSqrt2OverPi, __fadd_rn(x, __fmul_rn(kCoeff, x3))));
}

__device__ __forceinline__ float gelu_fwd(float x) {
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.f, gelu_tanh(x))));
}

__device__ __forceinline__ float gelu_bwd(float x, float dy) {
  const float t = gelu_tanh(x);
  const float cdf = __fmul_rn(0.5f, __fadd_rn(1.f, t));
  // d/dx of the tanh's argument: sqrt(2/pi) * (1 + 3 * 0.044715 * x^2)
  const float dinner =
      __fmul_rn(kSqrt2OverPi, __fadd_rn(1.f, __fmul_rn(kCoeff3, __fmul_rn(x, x))));
  const float dcdf = __fmul_rn(__fmul_rn(0.5f, __fsub_rn(1.f, __fmul_rn(t, t))), dinner);
  return __fmul_rn(dy, __fadd_rn(cdf, __fmul_rn(x, dcdf)));
}

__device__ __forceinline__ uint4 fwd8(const uint4& xr) {
  const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&xr);
  uint4 res;
  __nv_bfloat162* yv = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(xv[e]);
    yv[e] = __floats2bfloat162_rn(gelu_fwd(f.x), gelu_fwd(f.y));
  }
  return res;
}

__device__ __forceinline__ uint4 bwd8(const uint4& xr, const uint4& dr) {
  const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&xr);
  const __nv_bfloat162* dv = reinterpret_cast<const __nv_bfloat162*>(&dr);
  uint4 res;
  __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(xv[e]), d = __bfloat1622float2(dv[e]);
    ov[e] = __floats2bfloat162_rn(gelu_bwd(f.x, d.x), gelu_bwd(f.y, d.y));
  }
  return res;
}

// Block b's threads take vectors b * kThreads * kVec + t + u * kThreads,
// u < kVec, all loaded before any is computed.
template <typename Index>
__global__ void __launch_bounds__(kThreads)
gelu_fwd_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, Index n8) {
  const Index i = static_cast<Index>(blockIdx.x) * (kThreads * kVec) + threadIdx.x;
  uint4 v[kVec];
#pragma unroll
  for (int u = 0; u < kVec; ++u)
    if (i + u * kThreads < n8) v[u] = x[i + u * kThreads];
#pragma unroll
  for (int u = 0; u < kVec; ++u)
    if (i + u * kThreads < n8) y[i + u * kThreads] = fwd8(v[u]);
}

template <typename Index>
__global__ void __launch_bounds__(kThreads)
gelu_bwd_kernel(const uint4* __restrict__ x, const uint4* __restrict__ dy,
                uint4* __restrict__ dx, Index n8) {
  const Index i = static_cast<Index>(blockIdx.x) * (kThreads * kVec) + threadIdx.x;
  uint4 xv[kVec], dv[kVec];
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    if (i + u * kThreads < n8) {
      xv[u] = x[i + u * kThreads];
      dv[u] = dy[i + u * kThreads];
    }
  }
#pragma unroll
  for (int u = 0; u < kVec; ++u)
    if (i + u * kThreads < n8) dx[i + u * kThreads] = bwd8(xv[u], dv[u]);
}

unsigned blocks_for(long long n8) {
  return static_cast<unsigned>((n8 + kThreads * kVec - 1) / (kThreads * kVec));
}

// 32-bit indices where the last block's i + kVec * kThreads stays below INT_MAX.
bool fits_int(long long n8) { return n8 <= INT_MAX - kThreads * kVec; }

}  // namespace

// x, y: n bf16 elements each, contiguous, 16-byte aligned; n % 8 == 0.
extern "C" int ktpu_gelu_fwd_bf16(const void* x, void* y, long long n, void* stream) {
  if (n <= 0 || n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n8 = n / 8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* xp = static_cast<const uint4*>(x);
  uint4* yp = static_cast<uint4*>(y);
  if (fits_int(n8))
    gelu_fwd_kernel<int><<<blocks_for(n8), kThreads, 0, st>>>(xp, yp, static_cast<int>(n8));
  else
    gelu_fwd_kernel<long long><<<blocks_for(n8), kThreads, 0, st>>>(xp, yp, n8);
  return static_cast<int>(cudaGetLastError());
}

// x, dy, dx: n bf16 elements each, contiguous, 16-byte aligned; n % 8 == 0.
extern "C" int ktpu_gelu_bwd_bf16(const void* x, const void* dy, void* dx, long long n,
                                  void* stream) {
  if (n <= 0 || n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n8 = n / 8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* xp = static_cast<const uint4*>(x);
  const uint4* dp = static_cast<const uint4*>(dy);
  uint4* op = static_cast<uint4*>(dx);
  if (fits_int(n8))
    gelu_bwd_kernel<int><<<blocks_for(n8), kThreads, 0, st>>>(xp, dp, op, static_cast<int>(n8));
  else
    gelu_bwd_kernel<long long><<<blocks_for(n8), kThreads, 0, st>>>(xp, dp, op, n8);
  return static_cast<int>(cudaGetLastError());
}
