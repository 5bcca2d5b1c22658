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
// Design: a grid-stride loop, 8 elements a thread a step with 16-byte
// loads and stores, neighbouring threads on neighbouring addresses (K4's).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kCoeff = 0.044715f;
constexpr float kCoeff3 = 0.134145f;  // 3 * 0.044715

// t = tanh(sqrt(2/pi) * (x + 0.044715 * x^3)), the order of jax.nn.gelu
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  return tanhf(__fmul_rn(kSqrt2OverPi, __fadd_rn(x, __fmul_rn(kCoeff, x3))));
}

__global__ void __launch_bounds__(kThreads)
gelu_fwd_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y,
                long long n8) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n8;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
    const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw);
    uint4 res;
    __nv_bfloat16* yv = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float xf = ktpu::bf2f(xv[e]);
      const float cdf = __fmul_rn(0.5f, __fadd_rn(1.f, gelu_tanh(xf)));
      yv[e] = ktpu::f2bf(__fmul_rn(xf, cdf));
    }
    reinterpret_cast<uint4*>(y)[i] = res;
  }
}

__global__ void __launch_bounds__(kThreads)
gelu_bwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                __nv_bfloat16* __restrict__ dx, long long n8) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n8;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const uint4 xraw = reinterpret_cast<const uint4*>(x)[i];
    const uint4 draw = reinterpret_cast<const uint4*>(dy)[i];
    const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&xraw);
    const __nv_bfloat16* dv = reinterpret_cast<const __nv_bfloat16*>(&draw);
    uint4 res;
    __nv_bfloat16* ov = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float xf = ktpu::bf2f(xv[e]);
      const float t = gelu_tanh(xf);
      const float cdf = __fmul_rn(0.5f, __fadd_rn(1.f, t));
      // d/dx of the tanh's argument: sqrt(2/pi) * (1 + 3 * 0.044715 * x^2)
      const float dinner = __fmul_rn(
          kSqrt2OverPi, __fadd_rn(1.f, __fmul_rn(kCoeff3, __fmul_rn(xf, xf))));
      const float dcdf = __fmul_rn(__fmul_rn(0.5f, __fsub_rn(1.f, __fmul_rn(t, t))), dinner);
      ov[e] = ktpu::f2bf(__fmul_rn(ktpu::bf2f(dv[e]), __fadd_rn(cdf, __fmul_rn(xf, dcdf))));
    }
    reinterpret_cast<uint4*>(dx)[i] = res;
  }
}

int grid_for(long long n8) {
  const long long blocks = (n8 + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);  // 16 blocks an SM
}

}  // namespace

// x, y: n bf16 elements each, contiguous; n % 8 == 0.
extern "C" int ktpu_gelu_fwd_bf16(const void* x, void* y, long long n, void* stream) {
  if (n <= 0 || n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  gelu_fwd_kernel<<<grid_for(n / 8), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n / 8);
  return static_cast<int>(cudaGetLastError());
}

// x, dy, dx: n bf16 elements each, contiguous; n % 8 == 0.
extern "C" int ktpu_gelu_bwd_bf16(const void* x, const void* dy, void* dx, long long n,
                                  void* stream) {
  if (n <= 0 || n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  gelu_bwd_kernel<<<grid_for(n / 8), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
      static_cast<__nv_bfloat16*>(dx), n / 8);
  return static_cast<int>(cudaGetLastError());
}
