// K2 RMSNorm for Hopper: forward and backward.
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
//
// Backward, with n = x * r (r = rsqrt(var + eps)) and y = bf16(n) * scale:
//   dn = bf16(dy * scale)                       (the bf16 product's VJP)
//   dx = bf16(r * dn - x * r^3 * sum(dn * x) / d)
//   dscale = bf16(sum over rows of dy * bf16(n))
// dscale sums over all rows, and blocks run in no order, so it is taken in
// two passes, deterministically: a fixed grid of P blocks walks the rows
// (row = block, block + P, ...), each thread keeping f32 sums for its own
// columns in shared memory, and writes its block's (d,) f32 partial; a
// second kernel adds the P partials of each column in block order.  The
// caller allocates the (P, d) f32 partials.  Its order differs from a
// plain row-order f32 sum only in association, ~1e-6 relative before the
// final bf16 rounding.  Bound: bytes (x, dy read, dx written, 6 bytes an
// element, plus the partials).

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

__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ scale,
                   const __nv_bfloat16* __restrict__ dy, __nv_bfloat16* __restrict__ dx,
                   float* __restrict__ partial, int rows, int d, float eps) {
  extern __shared__ float acc[];  // this block's dscale sums, (d,)
  __shared__ float scratch_ss[kThreads / 32], scratch_c[kThreads / 32];
  // each thread owns the same 8-column chunks in every loop below
  for (int c = threadIdx.x * 8; c < d; c += kThreads * 8)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[c + i] = 0.f;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const __nv_bfloat16* xr = x + row * d;
    const __nv_bfloat16* dyr = dy + row * d;
    float ss = 0.f, cs = 0.f;  // sum x^2, sum dn * x
    for (int c = threadIdx.x * 8; c < d; c += kThreads * 8) {
      const uint4 xraw = *reinterpret_cast<const uint4*>(xr + c);
      const uint4 draw = *reinterpret_cast<const uint4*>(dyr + c);
      const uint4 sraw = *reinterpret_cast<const uint4*>(scale + c);
      const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&xraw);
      const __nv_bfloat16* dv = reinterpret_cast<const __nv_bfloat16*>(&draw);
      const __nv_bfloat16* sv = reinterpret_cast<const __nv_bfloat16*>(&sraw);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xf = ktpu::bf2f(xv[i]);
        const float dn = ktpu::bf2f(ktpu::f2bf(ktpu::bf2f(dv[i]) * ktpu::bf2f(sv[i])));
        ss += xf * xf;
        cs += dn * xf;
      }
    }
    ss = ktpu::block_sum(ss, scratch_ss);
    cs = ktpu::block_sum(cs, scratch_c);
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float k = r * r * r * cs / static_cast<float>(d);
    __nv_bfloat16* dxr = dx + row * d;
    for (int c = threadIdx.x * 8; c < d; c += kThreads * 8) {
      const uint4 xraw = *reinterpret_cast<const uint4*>(xr + c);
      const uint4 draw = *reinterpret_cast<const uint4*>(dyr + c);
      const uint4 sraw = *reinterpret_cast<const uint4*>(scale + c);
      const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&xraw);
      const __nv_bfloat16* dv = reinterpret_cast<const __nv_bfloat16*>(&draw);
      const __nv_bfloat16* sv = reinterpret_cast<const __nv_bfloat16*>(&sraw);
      uint4 res;
      __nv_bfloat16* ov = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xf = ktpu::bf2f(xv[i]), dyf = ktpu::bf2f(dv[i]);
        const float dn = ktpu::bf2f(ktpu::f2bf(dyf * ktpu::bf2f(sv[i])));
        ov[i] = ktpu::f2bf(r * dn - xf * k);
        acc[c + i] += dyf * ktpu::bf2f(ktpu::f2bf(xf * r));
      }
      *reinterpret_cast<uint4*>(dxr + c) = res;
    }
    __syncthreads();  // scratch_* are rewritten by the next row's sums
  }
  float* out = partial + static_cast<long long>(blockIdx.x) * d;
  for (int c = threadIdx.x * 8; c < d; c += kThreads * 8)
#pragma unroll
    for (int i = 0; i < 8; ++i) out[c + i] = acc[c + i];
}

// dscale[c] = bf16(sum over the P partials, in block order).
__global__ void __launch_bounds__(kThreads)
rmsnorm_dscale_kernel(const float* __restrict__ partial, __nv_bfloat16* __restrict__ dscale,
                      int P, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += partial[static_cast<long long>(p) * d + c];
  dscale[c] = ktpu::f2bf(s);
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

// x, dy, dx: (rows, d) bf16 contiguous; scale, dscale: (d,) bf16; d % 8 == 0;
// partial: (P, d) f32 scratch, 1 <= P <= rows.  Two launches: the row pass
// on P blocks, then the column sums of the partials.
extern "C" int ktpu_rmsnorm_bwd_bf16(const void* x, const void* scale, const void* dy, void* dx,
                                     void* dscale, void* partial, int rows, int d, int P,
                                     float eps, void* stream) {
  if (rows <= 0 || d <= 0 || d % 8 != 0 || P <= 0 || P > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * d;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rmsnorm_bwd_kernel<<<P, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(scale),
      static_cast<const __nv_bfloat16*>(dy), static_cast<__nv_bfloat16*>(dx),
      static_cast<float*>(partial), rows, d, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rmsnorm_dscale_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(dscale), P, d);
  return static_cast<int>(cudaGetLastError());
}
