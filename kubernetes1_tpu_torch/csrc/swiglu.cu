// K4 SwiGLU for Hopper: forward and backward.
//
// Replaces: kubernetes1_tpu/workloads/llama.py `layer_fn`, lines 166-168,
// jax.nn.silu(h @ w_gate) * (h @ w_up), the elementwise part XLA fuses
// between the two GEMMs and w_down.  g and u are the two bf16 GEMM outputs
// (rows, d_ff); the GEMMs stay cuBLAS.
//
// Roundings follow the plain version (F.silu(g) * u in bf16) and its
// autograd: s = bf16(g / (1 + exp(-g))), y = bf16(s * u);
//   backward: du = bf16(dy * s), ds = bf16(dy * u),
//             dg = bf16(ds * sig(g) * (1 + g * (1 - sig(g)))).
//
// Bound on the H100: bytes.  Forward reads g and u and writes y (6 bytes
// an element, ~5 flops); backward reads g, u, dy and writes dg, du
// (10 bytes, ~12 flops): far below the ~20 f32 flops a byte the card can
// do beside its HBM rate.
//
// Design: a grid-stride loop, 8 elements a thread a step with 16-byte
// loads and stores, neighbouring threads on neighbouring addresses.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(kThreads)
swiglu_fwd_kernel(const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ u,
                  __nv_bfloat16* __restrict__ y, long long n8) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n8;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const uint4 graw = reinterpret_cast<const uint4*>(g)[i];
    const uint4 uraw = reinterpret_cast<const uint4*>(u)[i];
    const __nv_bfloat16* gv = reinterpret_cast<const __nv_bfloat16*>(&graw);
    const __nv_bfloat16* uv = reinterpret_cast<const __nv_bfloat16*>(&uraw);
    uint4 res;
    __nv_bfloat16* yv = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float x = ktpu::bf2f(gv[e]);
      const float s = ktpu::bf2f(ktpu::f2bf(x / (1.f + expf(-x))));
      yv[e] = ktpu::f2bf(s * ktpu::bf2f(uv[e]));
    }
    reinterpret_cast<uint4*>(y)[i] = res;
  }
}

__global__ void __launch_bounds__(kThreads)
swiglu_bwd_kernel(const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ u,
                  const __nv_bfloat16* __restrict__ dy, __nv_bfloat16* __restrict__ dg,
                  __nv_bfloat16* __restrict__ du, long long n8) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n8;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const uint4 graw = reinterpret_cast<const uint4*>(g)[i];
    const uint4 uraw = reinterpret_cast<const uint4*>(u)[i];
    const uint4 draw = reinterpret_cast<const uint4*>(dy)[i];
    const __nv_bfloat16* gv = reinterpret_cast<const __nv_bfloat16*>(&graw);
    const __nv_bfloat16* uv = reinterpret_cast<const __nv_bfloat16*>(&uraw);
    const __nv_bfloat16* dv = reinterpret_cast<const __nv_bfloat16*>(&draw);
    uint4 gres, ures;
    __nv_bfloat16* dgv = reinterpret_cast<__nv_bfloat16*>(&gres);
    __nv_bfloat16* duv = reinterpret_cast<__nv_bfloat16*>(&ures);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float x = ktpu::bf2f(gv[e]), d = ktpu::bf2f(dv[e]);
      const float s = ktpu::bf2f(ktpu::f2bf(x / (1.f + expf(-x))));
      duv[e] = ktpu::f2bf(d * s);
      const float ds = ktpu::bf2f(ktpu::f2bf(d * ktpu::bf2f(uv[e])));
      const float sg = sigmoid(x);
      dgv[e] = ktpu::f2bf(ds * (sg * (1.f + x * (1.f - sg))));
    }
    reinterpret_cast<uint4*>(dg)[i] = gres;
    reinterpret_cast<uint4*>(du)[i] = ures;
  }
}

int grid_for(long long n8) {
  const long long blocks = (n8 + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);  // 16 blocks an SM
}

}  // namespace

// g, u, y: n bf16 elements each, contiguous; n % 8 == 0.
extern "C" int ktpu_swiglu_fwd_bf16(const void* g, const void* u, void* y, long long n,
                                    void* stream) {
  if (n <= 0 || n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  swiglu_fwd_kernel<<<grid_for(n / 8), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(u),
      static_cast<__nv_bfloat16*>(y), n / 8);
  return static_cast<int>(cudaGetLastError());
}

// g, u, dy, dg, du: n bf16 elements each, contiguous; n % 8 == 0.
extern "C" int ktpu_swiglu_bwd_bf16(const void* g, const void* u, const void* dy, void* dg,
                                    void* du, long long n, void* stream) {
  if (n <= 0 || n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  swiglu_bwd_kernel<<<grid_for(n / 8), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(u),
      static_cast<const __nv_bfloat16*>(dy), static_cast<__nv_bfloat16*>(dg),
      static_cast<__nv_bfloat16*>(du), n / 8);
  return static_cast<int>(cudaGetLastError());
}
