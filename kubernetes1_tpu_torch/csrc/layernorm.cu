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
// Bound: bytes (x, dy read, dx written: 6 bytes an element; the sums are
// small).  What held the first kernel to a quarter of that: each row was
// walked four times, dy only after two dependent walks over x, with one
// 16-byte load per lane in flight and 16 warps an SM.  The design now is
// a persistent, warp-specialised kernel, one block an SM:
// - A ring of `stages` stages in shared memory, each W consecutive rows of
//   x and of dy, filled by one producer thread with two 1-D bulk copies
//   (the copy engine; no tensor map: a run of rows is contiguous) that
//   complete on the stage's `full` mbarrier; each of the W consumer warps
//   takes one row of a stage and releases it on the stage's `empty`
//   mbarrier.  At d = 1024: 4 stages of 8 rows, 128 KB, up to 96 KB in
//   flight an SM.
// - d <= 1024 (up to kRegChunks chunks of 256 columns a lane, a template
//   parameter): the consumer copies its row of x and dy into registers
//   (each lane 8 columns a chunk), releases the stage, and does the rest
//   from registers: mu, the two-pass variance, sum(g) and sum(g * c), dx
//   (16-byte stores).  dscale and dbias are summed in registers: a lane
//   owns the same columns for the whole launch.
// - d > 1024: the same ring with fewer consumer warps (as their shared
//   memory allows), each walking its row in shared memory in chunks of
//   256 columns, its dscale and dbias sums in its own slice of shared
//   memory (each lane owns its columns there too).
// - One launch, cooperative (every block resident): the block adds its
//   warps' sums in warp order into its (2, d) partial; after a grid
//   barrier (common.cuh's, which K8 uses too: an arrival count and a
//   generation word) every block adds its own share of the columns over
//   the P partials in common.cuh's fixed order.  No atomics on the sums:
//   the same bits on every run.  The row sums are taken in another order
//   than the first kernel's, so dx may differ from it by a bf16 step.
// Tried on the card and left out, slower or no faster: two levels of
// last-block tickets for the final sums in place of the barrier (each
// level waits out fences, an atomic and a one-block read of ~100 KB);
// 12 consumer warps; two blocks of 4 an SM; two rows a consumer with their
// sums interleaved; a 192 KB ring; dy * scale kept in registers.

#include <algorithm>

#include "common.cuh"

namespace {

using ktpu::mbar_arrive;
using ktpu::mbar_expect_tx;
using ktpu::mbar_init;
using ktpu::mbar_init_fence;
using ktpu::mbar_wait;
using ktpu::smem_addr;

constexpr int kWarps = 8;  // rows per block in the forward
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 lds16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  unpack8(lds16(p), f);
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// The row's mean and r = 1 / sqrt(var + eps) by the two-pass form.
__device__ __forceinline__ void row_stats(const __nv_bfloat16* xr, int d, float eps, int lane,
                                          float& mu, float& r) {
  float s = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    float f[8];
    load8(xr + c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += f[i];
  }
  mu = warp_sum(s) / static_cast<float>(d);
  float v = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    float f[8];
    load8(xr + c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float dv = f[i] - mu;
      v += dv * dv;
    }
  }
  r = 1.f / sqrtf(warp_sum(v) / static_cast<float>(d) + eps);
}

__global__ void __launch_bounds__(kThreads)
layernorm_fwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                     long long rows, int d, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = blockIdx.x * static_cast<long long>(kWarps) + warp;
  if (row >= rows) return;
  const __nv_bfloat16* xr = x + row * d;
  float mu, r;
  row_stats(xr, d, eps, lane, mu, r);
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

// ------------------------------------------------------------- backward

constexpr int kRegChunks = 4;           // 256-column chunks in registers: d <= 1024
constexpr int kBwdConsumers = 8;        // consumer warps at d <= 1024
constexpr int kBwdThreads = 32 * (kBwdConsumers + 1);
constexpr int kRingBytes = 128 * 1024;  // the ring at d <= 1024
constexpr int kMinStages = 3, kMaxStages = 8;
constexpr int kBarBytes = 2 * kMaxStages * 8;  // full[kMaxStages], then empty[kMaxStages]
constexpr int kSmemBudget = 200 * 1024;  // of the 227 KB a block may have

__host__ __device__ inline size_t round_up(size_t v, size_t m) { return (v + m - 1) / m * m; }

// The backward's shape for width d: chunks a lane keeps in registers (0:
// the row stays in shared memory), consumer warps, stages, shared bytes.
struct BwdPlan {
  int chunks, warps, stages;
  size_t smem;
};

inline BwdPlan bwd_plan(int d) {
  const size_t row = 4 * static_cast<size_t>(d);  // a row of x and one of dy
  const size_t fixed = kBarBytes + round_up(4 * static_cast<size_t>(d), 128);  // and scale
  BwdPlan p{};
  if (d <= kRegChunks * 256) {
    p.chunks = (d + 255) / 256;
    p.warps = kBwdConsumers;
    const size_t stage = p.warps * row;
    p.stages = static_cast<int>(
        std::min<size_t>(kMaxStages, std::max<size_t>(kMinStages, kRingBytes / stage)));
    p.smem = fixed + p.stages * stage;
  } else {  // a warp needs kMinStages rows and its (2, d) f32 sums
    p.chunks = 0;
    const size_t per_warp = kMinStages * row + 8 * static_cast<size_t>(d);
    p.warps = fixed < kSmemBudget ? static_cast<int>(std::min<size_t>(
                                        kBwdConsumers, (kSmemBudget - fixed) / per_warp))
                                  : 0;
    if (p.warps == 0) return p;
    const size_t sums = p.warps * 8 * static_cast<size_t>(d);
    p.stages = static_cast<int>(
        std::min<size_t>(kMaxStages, (kSmemBudget - fixed - sums) / (p.warps * row)));
    p.smem = fixed + p.stages * p.warps * row + sums;
  }
  return p;
}

__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

// A row's mu and r and the two coefficients of its dx: k = r^3 sum(g c) / d
// and mean_dc = (r sum(g) - k sum(c)) / d.
struct RowCoef {
  float mu, r, k, mean_dc;
};

// From the lane's chunks of the row: `get(j, xf, dyf)` unpacks chunk j
// (columns 256 j + 8 lane .. + 8) of x and dy.
template <typename Get>
__device__ __forceinline__ RowCoef row_coef(int chunks, int d, float eps, int lane,
                                            const float* sc, Get get) {
  const float inv_d = 1.f / static_cast<float>(d);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < chunks; ++j) {
    if (256 * j + 8 * lane >= d) continue;
    float f[8], dv[8];
    get(j, f, dv);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += f[i];
  }
  RowCoef rc;
  rc.mu = warp_sum(s) / static_cast<float>(d);
  float v = 0.f, cs = 0.f, sg = 0.f, sgc = 0.f;
#pragma unroll
  for (int j = 0; j < chunks; ++j) {
    const int col = 256 * j + 8 * lane;
    if (col >= d) continue;
    float f[8], dv[8], w[8];
    get(j, f, dv);
    load8(sc + col, w);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float c = f[i] - rc.mu;
      v += c * c;
      cs += c;
      const float g = dv[i] * w[i];
      sg += g;
      sgc += g * c;
    }
  }
  v = warp_sum(v);
  cs = warp_sum(cs);
  sg = warp_sum(sg);
  sgc = warp_sum(sgc);
  rc.r = 1.f / sqrtf(v / static_cast<float>(d) + eps);
  rc.k = rc.r * rc.r * rc.r * sgc * inv_d;
  rc.mean_dc = (rc.r * sg - rc.k * cs) * inv_d;
  return rc;
}

// dx of the 8 columns at col into out[col..], and their terms of dscale
// and dbias added into ds and db.
__device__ __forceinline__ void dx_chunk(const float (&f)[8], const float (&dv)[8],
                                         const float* sc, int col, const RowCoef& rc,
                                         __nv_bfloat16* out, float (&ds)[8], float (&db)[8]) {
  float w[8];
  load8(sc + col, w);
  uint4 res;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float ci = f[i] - rc.mu;
    const float dc = dv[i] * w[i] * rc.r - rc.k * ci;
    o[i] = ktpu::f2bf(dc - rc.mean_dc);
    ds[i] += dv[i] * (ci * rc.r);
    db[i] += dv[i];
  }
  *reinterpret_cast<uint4*>(out + col) = res;
}

// Block b's share of the final sums: float4 columns [n4 b / P,
// n4 (b + 1) / P) of the P (2, d) partials (n4 = d / 2 float4s a row), up
// to blockDim.x columns at a time, each added over the partials in
// ktpu::column_lanes' fixed order: float4 q of a row goes to dscale below
// d / 4, else to dbias.
__device__ __forceinline__ void column_sums(const float* __restrict__ partial, int n4,
                                            float* dscale, float* dbias, float4* red) {
  const int P = gridDim.x;
  const int q0 = static_cast<int>(static_cast<long long>(n4) * blockIdx.x / P);
  const int q1 = static_cast<int>(static_cast<long long>(n4) * (blockIdx.x + 1) / P);
  for (int qa = q0; qa < q1; qa += blockDim.x) {
    const int nq = min(q1 - qa, static_cast<int>(blockDim.x));
    const int lanes = ktpu::column_lanes(reinterpret_cast<const float4*>(partial), n4, P, nq,
                                         [&](int c) -> long long { return qa + c; }, red);
    __syncthreads();
    if (threadIdx.x < nq) {
      const float4 t = ktpu::column_total(red, nq, lanes, threadIdx.x);
      const int q = qa + threadIdx.x, split = n4 / 2;
      if (q < split) reinterpret_cast<float4*>(dscale)[q] = t;
      else reinterpret_cast<float4*>(dbias)[q - split] = t;
    }
    __syncthreads();  // red is read before the next columns' lanes write it
  }
}

// One launch: dx, dscale, dbias.  Block b owns rows [rows b / P,
// rows (b + 1) / P); warps 0..W-1 consume, warp W produces.  CHUNKS > 0:
// d <= 256 CHUNKS, the row in registers; 0: the row in shared memory.
// partial: (P, 2, d) f32, the blocks' sums; sync: (count, generation),
// the grid barrier's words (count left 0).  Every block must be resident
// (a cooperative launch).
template <int CHUNKS>
__global__ void __launch_bounds__(kBwdThreads, 1)
layernorm_bwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                     const __nv_bfloat16* __restrict__ dy, __nv_bfloat16* __restrict__ dx,
                     float* __restrict__ dscale, float* __restrict__ dbias,
                     float* __restrict__ partial, unsigned* __restrict__ sync,
                     long long rows, int d, float eps, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float4 red[kBwdThreads];  // the final sums' lanes
  constexpr int NC = CHUNKS ? CHUNKS : 1;
  const int W = blockDim.x / 32 - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t full = smem_addr(smem), empty = full + 8 * kMaxStages;
  float* sc = reinterpret_cast<float*>(smem + kBarBytes);
  unsigned char* ring = smem + kBarBytes + round_up(4 * static_cast<size_t>(d), 128);
  const long long row_bytes = 2LL * d;  // one row of one tensor
  const long long stage_bytes = 2 * W * row_bytes;
  // the warps' (2, d) sums: in the ring once it is drained, or (CHUNKS 0)
  // after it from the start
  float* sums = reinterpret_cast<float*>(CHUNKS ? ring : ring + stages * stage_bytes);
  const long long P = gridDim.x;
  const long long r_begin = rows * blockIdx.x / P, r_end = rows * (blockIdx.x + 1) / P;
  const int n_stages = static_cast<int>((r_end - r_begin + W - 1) / W);

  // stage k: rows r_begin + k W .. + W, into ring slot k % stages
  const bool producer = warp == W && lane == 0;
  const unsigned seen = ktpu::lead_thread() ? ktpu::barrier_generation(sync) : 0;
  auto issue = [&](int k) {
    const int s = k % stages;
    const long long r0 = r_begin + static_cast<long long>(k) * W;
    const long long n_rows = r_end - r0 < W ? r_end - r0 : W;
    const uint32_t bytes = static_cast<uint32_t>(n_rows * row_bytes);
    const uint32_t dst = smem_addr(ring + s * stage_bytes);
    mbar_expect_tx(full + 8 * s, 2 * bytes);
    ktpu::bulk_load(dst, x + r0 * d, bytes, full + 8 * s);
    ktpu::bulk_load(dst + static_cast<uint32_t>(W * row_bytes), dy + r0 * d, bytes,
                    full + 8 * s);
  };
  if (producer) {  // the first round of stages is on its way before anything else
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, W);
    }
    mbar_init_fence();
    for (int k = 0; k < stages && k < n_stages; ++k) issue(k);
  }
  for (int c = threadIdx.x; c < d; c += blockDim.x) sc[c] = scale[c];
  if (CHUNKS == 0)
    for (long long i = threadIdx.x; i < 2LL * W * d; i += blockDim.x) sums[i] = 0.f;
  __syncthreads();

  float ds[NC][8], db[NC][8];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) ds[j][i] = db[j][i] = 0.f;

  if (warp == W) {  // the producer: each later stage once its slot is released
    if (producer) {
      for (int k = stages; k < n_stages; ++k) {
        mbar_wait(empty + 8 * (k % stages), ((k / stages) & 1) ^ 1);
        issue(k);
      }
    }
    __syncwarp();
  } else {  // a consumer: row r_begin + k W + warp of each stage k
    float* my_sums = sums + 2LL * warp * d;
    for (int k = 0; k < n_stages; ++k) {
      const int s = k % stages;
      mbar_wait(full + 8 * s, (k / stages) & 1);
      const long long row = r_begin + static_cast<long long>(k) * W + warp;
      const bool have = row < r_end;
      const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(ring + s * stage_bytes) +
                                static_cast<long long>(warp) * d;
      const __nv_bfloat16* dys = xs + static_cast<long long>(W) * d;
      __nv_bfloat16* dxr = dx + row * d;
      if (CHUNKS) {
        uint4 xv[NC], dv[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int col = 256 * j + 8 * lane;
          xv[j] = dv[j] = make_uint4(0, 0, 0, 0);
          if (have && col < d) {
            xv[j] = lds16(xs + col);
            dv[j] = lds16(dys + col);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);  // the row is in registers
        if (!have) continue;
        auto get = [&](int j, float (&f)[8], float (&g)[8]) {
          unpack8(xv[j], f);
          unpack8(dv[j], g);
        };
        const RowCoef rc = row_coef(NC, d, eps, lane, sc, get);
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int col = 256 * j + 8 * lane;
          if (col >= d) continue;
          float f[8], g[8];
          get(j, f, g);
          dx_chunk(f, g, sc, col, rc, dxr, ds[j], db[j]);
        }
      } else {
        if (have) {
          auto get = [&](int j, float (&f)[8], float (&g)[8]) {
            load8(xs + 256 * j + 8 * lane, f);
            load8(dys + 256 * j + 8 * lane, g);
          };
          const RowCoef rc = row_coef((d + 255) / 256, d, eps, lane, sc, get);
          for (int col = 8 * lane; col < d; col += 256) {
            float f[8], g[8], a[8], b[8];
            get(col / 256, f, g);
            load8(my_sums + col, a);
            load8(my_sums + d + col, b);
            dx_chunk(f, g, sc, col, rc, dxr, a, b);
            store8(my_sums + col, a);
            store8(my_sums + d + col, b);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
    }
  }
  __syncthreads();  // every stage consumed: the ring is free
  if (CHUNKS && warp < W) {
    float* my_sums = sums + 2LL * warp * d;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = 256 * j + 8 * lane;
      if (col >= d) continue;
      store8(my_sums + col, ds[j]);
      store8(my_sums + d + col, db[j]);
    }
  }
  __syncthreads();
  // this block's partial: its warps' sums in warp order
  const int n4 = d / 2;  // float4s of a (2, d) row
  float4* part = reinterpret_cast<float4*>(partial + 2LL * d * blockIdx.x);
  const float4* sums4 = reinterpret_cast<const float4*>(sums);
  for (int q = threadIdx.x; q < n4; q += blockDim.x) {
    float4 t = sums4[q];
    for (int w = 1; w < W; ++w) ktpu::sum_into(t, sums4[static_cast<long long>(w) * n4 + q]);
    part[q] = t;
  }
  // when every block's partial is out, each block adds its share of columns
  ktpu::grid_barrier(sync, P, seen);
  column_sums(partial, n4, dscale, dbias, red);
}

using BwdKernel = void (*)(const __nv_bfloat16*, const float*, const __nv_bfloat16*,
                           __nv_bfloat16*, float*, float*, float*, unsigned*, long long, int,
                           float, int);

inline BwdKernel bwd_kernel(int chunks) {
  switch (chunks) {
    case 1: return layernorm_bwd_kernel<1>;
    case 2: return layernorm_bwd_kernel<2>;
    case 3: return layernorm_bwd_kernel<3>;
    case 4: return layernorm_bwd_kernel<4>;
    default: return layernorm_bwd_kernel<0>;
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

// The backward's grid at width d on the current device: *resident, the
// blocks the SMs hold at once (the launch is cooperative), and *warps, the
// rows a block takes at a time (its consumer warps).  A launch over rows
// takes at most min(*resident, ceil(rows / *warps)) blocks.
extern "C" int ktpu_layernorm_bwd_grid(int d, int* resident, int* warps) {
  if (d <= 0 || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const BwdPlan p = bwd_plan(d);
  if (p.warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  const BwdKernel fn = bwd_kernel(p.chunks);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p.smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, 32 * (p.warps + 1), p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *resident = sms * per_sm;
  *warps = p.warps;
  return 0;
}

// x, dy, dx: (rows, d) bf16 contiguous; scale: (d,) f32; dscale, dbias:
// (d,) f32 out; d % 8 == 0; P blocks, 1 <= P <= ktpu_layernorm_bwd_grid's;
// partial: (P, 2, d) f32 scratch; sync: 2 uint32, the first 0 (left 0).
// One cooperative launch.
extern "C" int ktpu_layernorm_bwd_bf16(const void* x, const void* scale, const void* dy,
                                       void* dx, void* dscale, void* dbias, void* partial,
                                       void* sync, long long rows, int d, int P, float eps,
                                       void* stream) {
  if (rows <= 0 || d <= 0 || d % 8 != 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const BwdPlan p = bwd_plan(d);
  if (p.warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  const BwdKernel kernel = bwd_kernel(p.chunks);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(p.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const float* sp = static_cast<const float*>(scale);
  const __nv_bfloat16* dyp = static_cast<const __nv_bfloat16*>(dy);
  __nv_bfloat16* dxp = static_cast<__nv_bfloat16*>(dx);
  float* dsp = static_cast<float*>(dscale);
  float* dbp = static_cast<float*>(dbias);
  float* pp = static_cast<float*>(partial);
  unsigned* syncp = static_cast<unsigned*>(sync);
  int stages = p.stages;
  void* args[] = {&xp, &sp, &dyp, &dxp, &dsp, &dbp, &pp, &syncp, &rows, &d, &eps, &stages};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(P),
                                  dim3(32 * (p.warps + 1)), args, p.smem,
                                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
