// K2 RMSNorm for Hopper.
//
// Replaces: kubernetes1_tpu/workloads/llama.py `rmsnorm` (the op XLA fuses
// there): var = mean(x.f32^2), y = (x * rsqrt(var + eps)).astype(x.dtype)
// * scale.astype(x.dtype).  Note the cast to bf16 BEFORE the multiply by
// the bf16 scale; the kernel rounds at the same two places.
//
// Bound on the H100: bytes.  Per row it reads d bf16 and writes d bf16 and
// does ~4 flops per element, about 1 flop per byte against the card's ~295
// bf16 flops per byte of HBM, so only memory traffic matters.
//
// Design: one block of 256 threads per row (d = 4096 on Llama-3-8B), 16-byte
// loads (8 bf16 per thread per step).  The sum of squares is taken in f32
// and reduced with warp shuffles.  The second pass re-reads the row, which a
// block has just read (8 KB), so it comes from L1/L2, not HBM: device memory
// sees each input byte once and each output byte once.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rmsnorm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ scale,
                    __nv_bfloat16* __restrict__ out, int d, float eps) {
  __shared__ float scratch[kThreads / 32];
  const long long row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * d;
  __nv_bfloat16* orow = out + row * d;

  float ss = 0.f;
  for (int c = threadIdx.x * 8; c < d; c += kThreads * 8) {
    uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(p[i]);
      ss += f.x * f.x + f.y * f.y;
    }
  }
  ss = ktpu::block_sum(ss, scratch);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  for (int c = threadIdx.x * 8; c < d; c += kThreads * 8) {
    uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    uint4 sraw = *reinterpret_cast<const uint4*>(scale + c);
    const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw);
    const __nv_bfloat16* sv = reinterpret_cast<const __nv_bfloat16*>(&sraw);
    uint4 res;
    __nv_bfloat16* ov = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float y = ktpu::bf2f(ktpu::f2bf(ktpu::bf2f(xv[i]) * r));
      ov[i] = ktpu::f2bf(y * ktpu::bf2f(sv[i]));
    }
    *reinterpret_cast<uint4*>(orow + c) = res;
  }
}

}  // namespace

// x, out: (rows, d) bf16 contiguous; scale: (d,) bf16; d % 8 == 0.
extern "C" int ktpu_rmsnorm_bf16(const void* x, const void* scale, void* out,
                                 int rows, int d, float eps, void* stream) {
  if (rows <= 0 || d <= 0 || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  rmsnorm_bf16_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(scale),
      static_cast<__nv_bfloat16*>(out), d, eps);
  return static_cast<int>(cudaGetLastError());
}
