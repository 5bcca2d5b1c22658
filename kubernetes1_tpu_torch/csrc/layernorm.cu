// K7b LayerNorm for Hopper: forward and backward.
//
// Replaces: kubernetes1_tpu/workloads/bert.py `layernorm`, lines 113-118
// (the op XLA fuses there):
//   xf = x.astype(f32); mu = mean(xf); var = mean((xf - mu)^2) (two-pass,
//   not E[x^2] - E[x]^2); y = ((xf - mu) * rsqrt(var + eps) * scale + bias)
//   .astype(x.dtype), with f32 scale and bias (bert.py never casts them).
// The kernel rounds once, at the end, as JAX does.
//
// Bound on the H100: bytes.  Per row it reads d bf16 and writes d bf16 (4
// bytes an element, ~8 flops), far below the ~295 flops a byte at which
// the card's arithmetic would matter.
//
// Design: one warp per row, eight rows to a block of 256 threads, so no
// block-wide barrier is needed: each lane takes 8 columns at a time
// (16-byte loads of x, two float4 of scale and of bias), and the row's
// sums are warp shuffles.  The mean, the two-pass variance and the output
// are three walks over the row; the second and third re-read the row that
// the warp has just read (2 KB at BERT-large's d = 1024) from L1, so
// device memory sees each input byte once.  No FMA contraction in the
// output: (xf - mu) * r, * scale, + bias, each rounded, as the plain
// version's separate ops round them.
//
// Backward, as JAX differentiates the two-pass form (c = xf - mu,
// r = rsqrt(var + eps), g = dy * scale):
//   dc = g * r - c * r^3 * sum(g * c) / d      (through r, then var = mean(c^2))
//   dx = bf16(dc - sum(dc) / d)                 (through mu = mean(xf)),
//        with sum(dc) = r * sum(g) - r^3 * sum(g * c) * sum(c) / d;
//   dscale = sum over rows of dy * (c * r), dbias = sum over rows of dy, f32.
// dscale and dbias sum over all rows and blocks run in no order, so they
// are taken deterministically: a fixed grid of P blocks walks the rows
// (each warp rows w, w + 4P, ...), each warp adding into its own (2, d) f32
// slice of shared memory; the block adds its warps' slices in warp order
// into its (2, d) partial; a second kernel adds the P partials of each
// column in a fixed tree (32 lanes of partials, then the lanes in order).
// Bound: bytes (x, dy read, dx written: 6 bytes an element, plus the
// partials).

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // rows per block in the forward
constexpr int kThreads = kWarps * 32;
constexpr int kBwdWarps = 4;  // rows in flight per block in the backward
constexpr int kBwdThreads = kBwdWarps * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// The row's mean and r = 1 / sqrt(var + eps) by the two-pass form; also
// sum(xf - mu), which the backward's mean term needs.
__device__ __forceinline__ void row_stats(const __nv_bfloat16* xr, int d, float eps, int lane,
                                          float& mu, float& r, float& csum) {
  float s = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    float f[8];
    load8(xr + c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += f[i];
  }
  mu = warp_sum(s) / static_cast<float>(d);
  float v = 0.f, cs = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    float f[8];
    load8(xr + c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float dv = f[i] - mu;
      v += dv * dv;
      cs += dv;
    }
  }
  r = 1.f / sqrtf(warp_sum(v) / static_cast<float>(d) + eps);
  csum = warp_sum(cs);
}

__global__ void __launch_bounds__(kThreads)
layernorm_fwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                     long long rows, int d, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = blockIdx.x * static_cast<long long>(kWarps) + warp;
  if (row >= rows) return;
  const __nv_bfloat16* xr = x + row * d;
  float mu, r, csum;
  row_stats(xr, d, eps, lane, mu, r, csum);
  __nv_bfloat16* yr = y + row * d;
  for (int c = lane * 8; c < d; c += 256) {
    float f[8], sc[8], b[8];
    load8(xr + c, f);
    load8(scale + c, sc);
    load8(bias + c, b);
    uint4 res;
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o[i] = ktpu::f2bf(__fadd_rn(__fmul_rn(__fmul_rn(f[i] - mu, r), sc[i]), b[i]));
    *reinterpret_cast<uint4*>(yr + c) = res;
  }
}

__global__ void __launch_bounds__(kBwdThreads)
layernorm_bwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                     const __nv_bfloat16* __restrict__ dy, __nv_bfloat16* __restrict__ dx,
                     float* __restrict__ partial, long long rows, int d, float eps) {
  extern __shared__ float acc[];  // per warp: dscale sums (d), then dbias sums (d)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ds = acc + static_cast<long long>(warp) * 2 * d;
  float* db = ds + d;
  // each lane owns the same 8-column chunks of its warp's slice throughout
  for (int c = lane * 8; c < d; c += 256)
#pragma unroll
    for (int i = 0; i < 8; ++i) ds[c + i] = db[c + i] = 0.f;
  const float inv_d = 1.f / static_cast<float>(d);
  for (long long row = blockIdx.x * static_cast<long long>(kBwdWarps) + warp; row < rows;
       row += static_cast<long long>(gridDim.x) * kBwdWarps) {
    const __nv_bfloat16* xr = x + row * d;
    const __nv_bfloat16* dyr = dy + row * d;
    float mu, r, csum;
    row_stats(xr, d, eps, lane, mu, r, csum);
    float sg = 0.f, sgc = 0.f;  // sum g, sum g * c
    for (int c = lane * 8; c < d; c += 256) {
      float f[8], dv[8], sc[8];
      load8(xr + c, f);
      load8(dyr + c, dv);
      load8(scale + c, sc);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float gi = dv[i] * sc[i];
        sg += gi;
        sgc += gi * (f[i] - mu);
      }
    }
    sg = warp_sum(sg);
    sgc = warp_sum(sgc);
    const float k = r * r * r * sgc * inv_d;
    const float mean_dc = (r * sg - k * csum) * inv_d;
    __nv_bfloat16* dxr = dx + row * d;
    for (int c = lane * 8; c < d; c += 256) {
      float f[8], dv[8], sc[8];
      load8(xr + c, f);
      load8(dyr + c, dv);
      load8(scale + c, sc);
      uint4 res;
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ci = f[i] - mu;
        const float dc = dv[i] * sc[i] * r - k * ci;
        o[i] = ktpu::f2bf(dc - mean_dc);
        ds[c + i] += dv[i] * (ci * r);
        db[c + i] += dv[i];
      }
      *reinterpret_cast<uint4*>(dxr + c) = res;
    }
  }
  __syncthreads();
  // this block's partial: its warps' slices added in warp order
  float* out = partial + static_cast<long long>(blockIdx.x) * 2 * d;
  for (int c = threadIdx.x; c < 2 * d; c += kBwdThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) s += acc[static_cast<long long>(w) * 2 * d + c];
    out[c] = s;
  }
}

// out[c] = sum over the P partials of column c (of 2d: dscale, then dbias).
// A block takes 32 columns; its 8 warps' lanes each add every 8th partial
// of one column, then lane 0's warp adds the 8 sums in warp order.
__global__ void __launch_bounds__(256)
layernorm_colsum_kernel(const float* __restrict__ partial, float* __restrict__ dscale,
                        float* __restrict__ dbias, int P, int d) {
  __shared__ float part[8][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < 2 * d)
    for (int p = w; p < P; p += 8) s += partial[static_cast<long long>(p) * 2 * d + c];
  part[w][lane] = s;
  __syncthreads();
  if (w == 0 && c < 2 * d) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += part[i][lane];
    if (c < d) dscale[c] = t;
    else dbias[c - d] = t;
  }
}

}  // namespace

// x, y: (rows, d) bf16 contiguous; scale, bias: (d,) f32; d % 8 == 0.
extern "C" int ktpu_layernorm_fwd_bf16(const void* x, const void* scale, const void* bias,
                                       void* y, long long rows, int d, float eps,
                                       void* stream) {
  if (rows <= 0 || d <= 0 || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  layernorm_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

// x, dy, dx: (rows, d) bf16 contiguous; scale: (d,) f32; dscale, dbias: (d,)
// f32; d % 8 == 0; partial: (P, 2, d) f32 scratch, 1 <= P.  Two launches:
// the row pass on P blocks, then the column sums of the partials.
extern "C" int ktpu_layernorm_bwd_bf16(const void* x, const void* scale, const void* dy,
                                       void* dx, void* dscale, void* dbias, void* partial,
                                       long long rows, int d, int P, float eps, void* stream) {
  if (rows <= 0 || d <= 0 || d % 8 != 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * 2 * kBwdWarps * static_cast<size_t>(d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        layernorm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  layernorm_bwd_kernel<<<P, kBwdThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
      static_cast<const __nv_bfloat16*>(dy), static_cast<__nv_bfloat16*>(dx),
      static_cast<float*>(partial), rows, d, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  layernorm_colsum_kernel<<<(2 * d + 31) / 32, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dscale), static_cast<float*>(dbias),
      P, d);
  return static_cast<int>(cudaGetLastError());
}
