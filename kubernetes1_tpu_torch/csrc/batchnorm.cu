// K8 batch norm for Hopper: batch statistics, the folded apply (with the
// ReLU and residual add fused around it) and the backward.
//
// Replaces: kubernetes1_tpu/workloads/resnet.py `_bn` and the ReLU and
// residual add around it (resnet.py:105, 110-115), the ops XLA fuses there:
//   mean = E[x.f32], mean2 = E[x.f32^2] over N, H, W
//   var = max(mean2 - mean^2, 0);  inv = rsqrt(var + eps) * scale
//   w = bf16(inv);  b = bf16(bias - mean * inv);  y = x * w + b
// and relu(y), relu(y + r).  x is the NHWC activation seen as (M, C) bf16,
// M = N*H*W; scale and bias are f32 (C,).
//
// Bound on the H100: bytes.  Every pass does a few flops per element on
// 2-byte values, far below the ~295 flops per byte at which the card
// stops waiting on memory.
//
// Design.  The reductions (Σx and Σx² for the statistics; Σdy' and
// Σdy'·x for the backward) run over M, which goes from 1.6 M (the stem at
// batch 128) down to 6272, while C goes from 64 up to 2048, so the grid
// splits both: a block is (tx, ty) threads, tx groups of 8 channels (one
// 16-byte load each) by ty row lanes, tx * ty <= 256; grid.x covers C and
// grid.y = P blocks walk the rows.  Each thread keeps f32 sums for its 8
// channels; the block adds its row lanes in lane order in shared memory
// and writes one (2, C) f32 partial.  A second kernel adds the P partials
// of each channel in a fixed order (8 lanes, each over every 8th partial
// in block order, then the 8 lanes in order) and does the per-channel
// epilogue.  No atomics: the result depends only on the shape.  This is
// JAX's E[x²] − E[x]² formula, not Welford, as the contract asks.
// The apply and the backward's dx are grid-stride elementwise passes over
// 8 elements a thread, computing in f32 and rounding once to bf16.
//
// Backward, with dy' = dy masked by y > 0 where the layer has a ReLU
// (JAX's relu sends no gradient at 0), per channel (r = rsqrt(var + eps),
// gate = 1 where mean2 - mean^2 > 0, 1/2 at a tie, 0 where clamped, as
// the VJP of jnp.maximum):
//   d_b = Σdy', d_w = Σdy'·x, d_bias = d_b, d_inv = d_w − d_b·mean,
//   d_scale = d_inv·r, d_v = −½·d_inv·scale·r³·gate,
//   d_mean = −d_b·inv − 2·mean·d_v, d_mean2 = d_v,
//   dx = dy'·w + (d_mean + 2·x·d_mean2) / M,   dr = dy' (the residual's).
// JAX sums d_w and d_b in bf16 (the transpose of the bf16 broadcast); the
// kernel sums in f32.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;       // partial-sum lanes per channel in the finalize
constexpr int kFinalC = kThreads / kLanes;  // channels per finalize block

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(v[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* in) {
  uint4 raw;
  __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// One (2, C) f32 partial per block row.  kBwd = false: Σx, Σx².
// kBwd = true: Σdy', Σdy'·x, with dy' = dy masked by y > 0 when relu.
template <bool kBwd>
__global__ void __launch_bounds__(kThreads)
bn_partial_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                  const __nv_bfloat16* __restrict__ y, int relu, float* __restrict__ partial,
                  long long M, int C) {
  __shared__ float s1[kThreads * 8], s2[kThreads * 8];
  const int tx = blockDim.x, ty = blockDim.y;
  const int cg = blockIdx.x * tx + threadIdx.x;  // this thread's group of 8 channels
  float a[8], b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = b[i] = 0.f;
  if (cg * 8 < C) {
    const long long step = static_cast<long long>(gridDim.y) * ty;
    for (long long r = static_cast<long long>(blockIdx.y) * ty + threadIdx.y; r < M; r += step) {
      const long long off = r * C + cg * 8;
      float xv[8];
      load8(x + off, xv);
      if (!kBwd) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          a[i] += xv[i];
          b[i] += xv[i] * xv[i];
        }
      } else {
        float dv[8], yv[8];
        load8(dy + off, dv);
        if (relu) {
          load8(y + off, yv);
#pragma unroll
          for (int i = 0; i < 8; ++i) dv[i] = yv[i] > 0.f ? dv[i] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          a[i] += dv[i];
          b[i] += dv[i] * xv[i];
        }
      }
    }
  }
  const int width = tx * 8;  // channels this block covers
  const int base = threadIdx.y * width + threadIdx.x * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s1[base + i] = a[i];
    s2[base + i] = b[i];
  }
  __syncthreads();
  const int tid = threadIdx.y * tx + threadIdx.x;
  for (int k = tid; k < 2 * width; k += tx * ty) {
    const int q = k / width, col = k - q * width;
    const int c = blockIdx.x * width + col;
    if (c >= C) continue;
    const float* s = q ? s2 : s1;
    float acc = 0.f;
    for (int j = 0; j < ty; ++j) acc += s[j * width + col];
    partial[(static_cast<long long>(blockIdx.y) * 2 + q) * C + c] = acc;
  }
}

// Adds the P partials of each channel in a fixed order, then the epilogue.
// A block is kFinalC channels by kLanes lanes.  kBwd = false writes w, b
// (bf16) and stats = (mean, rstd, inv, gate) f32 (4, C).  kBwd = true
// writes dscale, dbias (f32) and coef = (d_mean / M, 2·d_mean2 / M) (2, C).
template <bool kBwd>
__global__ void __launch_bounds__(kThreads)
bn_finalize_kernel(const float* __restrict__ partial, int P, long long M, int C, float eps,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   float* __restrict__ stats, __nv_bfloat16* __restrict__ w,
                   __nv_bfloat16* __restrict__ b, float* __restrict__ dscale,
                   float* __restrict__ dbias, float* __restrict__ coef) {
  __shared__ float t1[kLanes][kFinalC], t2[kLanes][kFinalC];
  const int cl = threadIdx.x % kFinalC, lane = threadIdx.x / kFinalC;
  const int c = blockIdx.x * kFinalC + cl;
  float a = 0.f, q = 0.f;
  if (c < C) {
    for (int p = lane; p < P; p += kLanes) {
      a += partial[(static_cast<long long>(p) * 2) * C + c];
      q += partial[(static_cast<long long>(p) * 2 + 1) * C + c];
    }
  }
  t1[lane][cl] = a;
  t2[lane][cl] = q;
  __syncthreads();
  if (lane != 0 || c >= C) return;
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    s += t1[j][cl];
    s2 += t2[j][cl];
  }
  const float m = static_cast<float>(M);
  if (!kBwd) {
    const float mean = s / m, mean2 = s2 / m;
    // no fused multiply-add here: fma(-mean, mean, mean2) would keep the
    // square's rounding error, so a single row (mean2 = fl(x²)) would not
    // give the exact 0 (a tie, gate ½) that JAX's order of roundings gives
    const float d = __fsub_rn(mean2, __fmul_rn(mean, mean));
    const float rstd = rsqrtf(fmaxf(d, 0.f) + eps);
    const float inv = rstd * scale[c];
    w[c] = ktpu::f2bf(inv);
    b[c] = ktpu::f2bf(bias[c] - mean * inv);
    stats[c] = mean;
    stats[C + c] = rstd;
    stats[2 * C + c] = inv;
    stats[3 * C + c] = d > 0.f ? 1.f : (d == 0.f ? 0.5f : 0.f);
  } else {
    const float mean = stats[c], rstd = stats[C + c], inv = stats[2 * C + c];
    const float gate = stats[3 * C + c];
    const float d_b = s, d_w = s2;
    // unfused, as d above: a single row gives d_inv = 0 exactly
    const float d_inv = __fsub_rn(d_w, __fmul_rn(d_b, mean));
    const float d_v = -0.5f * d_inv * scale[c] * rstd * rstd * rstd * gate;
    dbias[c] = d_b;
    dscale[c] = d_inv * rstd;
    coef[c] = (-d_b * inv - 2.f * mean * d_v) / m;
    coef[C + c] = 2.f * d_v / m;
  }
}

// y = relu?(x * w + b [+ r]), in f32, rounded once.
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const __nv_bfloat16* __restrict__ b, const __nv_bfloat16* __restrict__ r,
                __nv_bfloat16* __restrict__ y, long long n8, int C, int relu) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n8;
       i += stride) {
    const long long off = i * 8;
    const int c = static_cast<int>(off % C);
    float xv[8], wv[8], bv[8], out[8];
    load8(x + off, xv);
    load8(w + c, wv);
    load8(b + c, bv);
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k] = fmaf(xv[k], wv[k], bv[k]);
    if (r != nullptr) {
      float rv[8];
      load8(r + off, rv);
#pragma unroll
      for (int k = 0; k < 8; ++k) out[k] += rv[k];
    }
    if (relu) {
#pragma unroll
      for (int k = 0; k < 8; ++k) out[k] = fmaxf(out[k], 0.f);
    }
    store8(y + off, out);
  }
}

// dx = dy' * w + coef0 + coef1 * x; dr = dy' where r is not null.
__global__ void __launch_bounds__(kThreads)
bn_dx_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
             const __nv_bfloat16* __restrict__ dy, const __nv_bfloat16* __restrict__ w,
             const float* __restrict__ coef, __nv_bfloat16* __restrict__ dx,
             __nv_bfloat16* __restrict__ dr, long long n8, int C, int relu) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n8;
       i += stride) {
    const long long off = i * 8;
    const int c = static_cast<int>(off % C);
    float xv[8], dv[8], wv[8], out[8];
    load8(x + off, xv);
    load8(dy + off, dv);
    load8(w + c, wv);
    if (relu) {
      float yv[8];
      load8(y + off, yv);
#pragma unroll
      for (int k = 0; k < 8; ++k) dv[k] = yv[k] > 0.f ? dv[k] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k] = dv[k] * wv[k] + coef[c + k] + coef[C + c + k] * xv[k];
    store8(dx + off, out);
    if (dr != nullptr) store8(dr + off, dv);
  }
}

// The partial passes' block: tx groups of 8 channels by ty row lanes.
dim3 partial_block(int C) {
  const int tx = C / 8 < 32 ? C / 8 : 32;
  return dim3(tx, kThreads / tx);
}

int elementwise_blocks(long long n8) {
  const long long want = (n8 + kThreads - 1) / kThreads;
  return static_cast<int>(want < 132 * 16 ? want : 132 * 16);
}

bool bad_shape(long long M, int C) { return M <= 0 || C <= 0 || C % 8 != 0; }

}  // namespace

// x: (M, C) bf16; scale, bias: (C,) f32; w, b: (C,) bf16 out; stats: (4, C)
// f32 out (mean, rstd, inv, gate); partial: (P, 2, C) f32 scratch.  C % 8
// == 0; 1 <= P.  Two launches: the partial sums, then the finalize.
extern "C" int ktpu_bn_stats_bf16(const void* x, const void* scale, const void* bias, void* w,
                                  void* b, void* stats, void* partial, long long M, int C,
                                  int P, float eps, void* stream) {
  if (bad_shape(M, C) || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block = partial_block(C);
  const dim3 grid((C / 8 + block.x - 1) / block.x, P);
  bn_partial_kernel<false><<<grid, block, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), nullptr, nullptr, 0, static_cast<float*>(partial),
      M, C);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bn_finalize_kernel<false><<<(C + kFinalC - 1) / kFinalC, kThreads, 0, st>>>(
      static_cast<const float*>(partial), P, M, C, eps, static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(stats),
      static_cast<__nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(b), nullptr, nullptr,
      nullptr);
  return static_cast<int>(cudaGetLastError());
}

// x, y: (M, C) bf16; w, b: (C,) bf16; r: (M, C) bf16 or null; C % 8 == 0.
extern "C" int ktpu_bn_apply_bf16(const void* x, const void* w, const void* b, const void* r,
                                  void* y, long long M, int C, int relu, void* stream) {
  if (bad_shape(M, C)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n8 = M * C / 8;
  bn_apply_kernel<<<elementwise_blocks(n8), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<const __nv_bfloat16*>(r),
      static_cast<__nv_bfloat16*>(y), n8, C, relu);
  return static_cast<int>(cudaGetLastError());
}

// x, dy, dx: (M, C) bf16; y: (M, C) bf16, read only when relu; dr: (M, C)
// bf16 or null; w: (C,) bf16; scale: (C,) f32; stats: (4, C) f32 from
// ktpu_bn_stats_bf16; dscale, dbias: (C,) f32 out; partial: (P, 2, C) and
// coef: (2, C) f32 scratch.  Three launches: the partial sums, the
// per-channel chain rule, the elementwise dx.
extern "C" int ktpu_bn_bwd_bf16(const void* x, const void* y, const void* dy, const void* w,
                                const void* scale, const void* stats, void* dx, void* dr,
                                void* dscale, void* dbias, void* partial, void* coef,
                                long long M, int C, int P, int relu, void* stream) {
  if (bad_shape(M, C) || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block = partial_block(C);
  const dim3 grid((C / 8 + block.x - 1) / block.x, P);
  bn_partial_kernel<true><<<grid, block, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
      static_cast<const __nv_bfloat16*>(y), relu, static_cast<float*>(partial), M, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bn_finalize_kernel<true><<<(C + kFinalC - 1) / kFinalC, kThreads, 0, st>>>(
      static_cast<const float*>(partial), P, M, C, 0.f, static_cast<const float*>(scale),
      nullptr, const_cast<float*>(static_cast<const float*>(stats)), nullptr, nullptr,
      static_cast<float*>(dscale), static_cast<float*>(dbias), static_cast<float*>(coef));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n8 = M * C / 8;
  bn_dx_kernel<<<elementwise_blocks(n8), kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y),
      static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(coef), static_cast<__nv_bfloat16*>(dx),
      static_cast<__nv_bfloat16*>(dr), n8, C, relu);
  return static_cast<int>(cudaGetLastError());
}
