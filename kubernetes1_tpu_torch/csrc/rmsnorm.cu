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
// Forward: one block of 256 threads per row (d = 4096 on Llama-3-8B),
// 16-byte loads (8 bf16 per thread per step).  The sum of squares is taken
// in f32 and reduced with warp shuffles.  The second pass re-reads the row,
// which a block has just read (8 KB), so it comes from L1/L2, not HBM:
// device memory sees each input byte once and each output byte once.
//
// Backward, with n = x * r (r = rsqrt(var + eps)) and y = bf16(n) * scale:
//   dn = bf16(dy * scale)                       (the bf16 product's VJP)
//   dx = bf16(r * dn - x * r^3 * sum(dn * x) / d)
//   dscale = bf16(sum over rows of dy * bf16(n)), summed in f32.
// Bound: bytes (x, dy read, dx written: 6 bytes an element; dscale and the
// blocks' partial sums are small).  What held the first backward to 43 %
// of that at 8192 x 4096:
// 1. Two launches: the second added the (P, d) f32 partials of P = 264
//    blocks on d / 256 blocks (16 at d = 4096), each thread walking its
//    column's 264 partials one load after another, on 6-12 % of the SMs.
// 2. A serial row pass: a block of 256 threads walked ~31 rows, each read
//    twice with one 16-byte load of x, dy and scale a thread in flight,
//    then two block-wide sums (each a __syncthreads), so an SM had ~16 KB
//    in flight and waited out each row's reductions before its next loads.
// 3. dscale summed in shared memory, thread t owning acc[8t .. 8t + 7]: an
//    8-way bank conflict on each read-modify-write, for every element.
// The design now, one cooperative launch, one block an SM (grid from the
// occupancy API, `ktpu_rmsnorm_bwd_grid`):
// - Rows in flight: one producer thread fills a ring of stages in shared
//   memory with 1-D bulk copies (the copy engine; a run of rows is
//   contiguous) that complete on the stage's `full` mbarrier; a stage is
//   G consecutive rows of x and of dy, one for each group of consumer
//   warps, 64 KB at Llama's widths, 3 stages (~190 KB in flight an SM).
// - Width classes.  d <= 16384: a row in registers.  A group of
//   ceil(d / 1024) warps takes a row (a warpgroup at d = 4096, 2 warps at
//   2048, one warp at d <= 1024), 16 consumer warps a block in all; each
//   lane copies its 4 chunks of 8 columns of x and dy from the stage into
//   registers (32 columns, 32 registers) and releases the stage.  The
//   row's sums of x^2 and dn * x go across the group with shuffles, one
//   shared-memory exchange and a named barrier (`bar.sync 1 + group`), not
//   a block-wide barrier; one warp needs neither.  Then dx, with 16-byte
//   stores.  d > 16384 (no model of the repo): a block of 512 threads
//   takes a row at a time and walks it twice in device memory (the second
//   walk from L2), its dscale sums in the block's own partial row.
// - dscale in registers: a lane owns the same columns for the whole
//   launch.  The block adds its groups' sums in group order into its (d,)
//   f32 partial; after the grid barrier (common.cuh's: an arrival count
//   and a generation word) every block adds its share of the columns over
//   the P partials in common.cuh's fixed order and rounds them to bf16.
//   No atomics on any sum: the same bits on every run.  The row sums are
//   taken in another order than the first kernel's, so dx may differ from
//   it by a bf16 step.
// - dn = bf16(dy * scale) two columns at a time with one bf16 multiply: a
//   product of two bf16 values is exact in f32, so it rounds as the f32
//   product's rounding does; the other roundings to bf16 go in pairs.
// What holds it now: the SMs do not stream at one rate.  Per-block
// timestamps on the card showed that with the same rows each, some SMs
// finish their loop well before the rest, the same SMs whether a block's
// rows are contiguous or strided, and the launch waits for the last; the
// start before the first stage lands and the final sums after the last
// loop are the rest (chip_smoke.py prints the fixed cost a launch and the
// streaming rate at d = 4096).
// Tried on the card and left out, slower or no faster: 8 or 12 consumer
// warps; a ring of 2 stages; stages taken strided across the blocks;
// each lane filling its own ring with cp.async in place of the producer's
// bulk copies (the same rate: the SMs' rates are the memory system's,
// not the copy engine's); the last 10-30 % of the stages claimed one at a
// time from a counter, each claimed stage its own partial row so that the
// sums keep a fixed order (slower: a barrier of all consumer warps for
// each claimed stage, and the shared memory of a ring stage for the
// groups' sums).

#include <algorithm>

#include "common.cuh"

namespace {

using ktpu::mbar_arrive;
using ktpu::mbar_expect_tx;
using ktpu::mbar_init;
using ktpu::mbar_init_fence;
using ktpu::mbar_wait;
using ktpu::smem_addr;

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

// ------------------------------------------------------------- backward

constexpr int kChunks = 4;                      // 8-column chunks a lane keeps of a row
constexpr int kWarpCols = 32 * 8 * kChunks;     // columns a warp of a group covers: 1024
constexpr int kConsumerWarps = 16;              // rows in registers: d <= 16 * 1024
constexpr int kMaxThreads = 32 * (kConsumerWarps + 1);
constexpr int kWideThreads = 512;               // d > 16384
constexpr int kMaxStages = 8;
constexpr int kBarBytes = 2 * kMaxStages * 8;   // full[kMaxStages], then empty[kMaxStages]
constexpr int kSmemBudget = 220 * 1024;         // of the 227 KB a block may have

__host__ __device__ inline size_t round_up(size_t v, size_t m) { return (v + m - 1) / m * m; }

// The backward's shape for width d.  group_warps: warps a row (0: d >
// 16384, the wide kernel); groups: rows a block takes at a time; stages
// of the ring; threads a block; dynamic shared bytes.
struct BwdPlan {
  int group_warps, groups, stages, threads;
  size_t smem;
};

inline BwdPlan bwd_plan(int d) {
  BwdPlan p{};
  p.group_warps = (d + kWarpCols - 1) / kWarpCols;
  if (p.group_warps > kConsumerWarps) {
    p.group_warps = 0;
    p.groups = 1;
    p.threads = kWideThreads;
    return p;
  }
  p.groups = kConsumerWarps / p.group_warps;
  p.threads = 32 * (p.groups * p.group_warps + 1);
  const size_t fixed = kBarBytes + round_up(2 * static_cast<size_t>(d), 128);  // and scale
  const size_t stage = static_cast<size_t>(p.groups) * 4 * d;  // G rows of x and of dy
  p.stages = static_cast<int>(std::min<size_t>(kMaxStages, (kSmemBudget - fixed) / stage));
  // the ring is reused for the groups' sums (<= a stage) and the final sums' lanes
  p.smem = fixed + std::max<size_t>(p.stages * stage, sizeof(float4) * p.threads);
  return p;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
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

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

// dn = bf16(dy * scale) of 8 columns, as 4 bf16 pairs: a product of two
// bf16 values is exact in f32, so one bf16 multiply rounds it as the f32
// product's rounding to bf16 does.
__device__ __forceinline__ uint4 mul8(const uint4& a, const uint4& b) {
  uint4 out;
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) po[i] = __hmul2_rn(pa[i], pb[i]);
  return out;
}

// The 8 columns' terms of the row sums, sum x^2 and sum dn * x, into two
// chains each (even and odd columns).
__device__ __forceinline__ void row_terms(const uint4& xraw, const uint4& dyraw,
                                          const uint4& sraw, float (&ss)[2], float (&cs)[2]) {
  float xf[8], dn[8];
  unpack8(xraw, xf);
  unpack8(mul8(dyraw, sraw), dn);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    ss[i & 1] += xf[i] * xf[i];
    cs[i & 1] += dn[i] * xf[i];
  }
}

// dx of the 8 columns (r, k = r^3 sum(dn x) / d) and their dscale terms
// added into ds; the roundings to bf16 two at a time.
__device__ __forceinline__ uint4 dx_terms(const uint4& xraw, const uint4& dyraw,
                                          const uint4& sraw, float r, float k,
                                          float (&ds)[8]) {
  float xf[8], dyf[8], dn[8];
  unpack8(xraw, xf);
  unpack8(dyraw, dyf);
  unpack8(mul8(dyraw, sraw), dn);
  uint4 res;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    o[i / 2] = __floats2bfloat162_rn(r * dn[i] - xf[i] * k, r * dn[i + 1] - xf[i + 1] * k);
    const float2 n = __bfloat1622float2(__floats2bfloat162_rn(xf[i] * r, xf[i + 1] * r));
    ds[i] += dyf[i] * n.x;
    ds[i + 1] += dyf[i + 1] * n.y;
  }
  return res;
}

// Block b's share of dscale: float4 columns [n4 b / P, n4 (b + 1) / P) of
// the P (d,) partials (n4 = d / 4), up to blockDim.x at a time, each added
// over the partials in ktpu::column_lanes' fixed order and rounded to bf16.
__device__ __forceinline__ void dscale_sums(const float* __restrict__ partial, int n4,
                                            __nv_bfloat16* dscale, float4* red) {
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
      const __nv_bfloat162 v[2] = {__floats2bfloat162_rn(t.x, t.y),
                                   __floats2bfloat162_rn(t.z, t.w)};
      *reinterpret_cast<uint2*>(dscale + 4LL * (qa + threadIdx.x)) =
          *reinterpret_cast<const uint2*>(v);
    }
    __syncthreads();  // red is read before the next columns' lanes write it
  }
}

// d <= 16384.  One launch: dx and dscale.  Block b owns rows [rows b / P,
// rows (b + 1) / P); consumer warps 0..W-1 form W / group_warps groups, a
// row each per stage; warp W produces.  Lane t of a group (t < 32 W_g)
// owns columns 8 (t + 32 W_g j) .. + 8, j < kChunks.  partial: (P, d) f32,
// the blocks' sums; sync: (count, generation), the grid barrier's words
// (count left 0).  Every block must be resident (a cooperative launch).
__global__ void __launch_bounds__(kMaxThreads, 1)
rmsnorm_bwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ scale,
                   const __nv_bfloat16* __restrict__ dy, __nv_bfloat16* __restrict__ dx,
                   __nv_bfloat16* __restrict__ dscale, float* __restrict__ partial,
                   unsigned* __restrict__ sync, long long rows, int d, float eps,
                   int group_warps, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float2 row_red[2][kConsumerWarps];  // a group's row sums, by row parity
  const int W = blockDim.x / 32 - 1;
  const int G = W / group_warps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t full = smem_addr(smem), empty = full + 8 * kMaxStages;
  __nv_bfloat16* sc = reinterpret_cast<__nv_bfloat16*>(smem + kBarBytes);
  unsigned char* ring = smem + kBarBytes + round_up(2 * static_cast<size_t>(d), 128);
  const long long row_bytes = 2LL * d;  // one row of one tensor
  const long long stage_bytes = 2 * G * row_bytes;
  const long long P = gridDim.x;
  const long long r_begin = rows * blockIdx.x / P, r_end = rows * (blockIdx.x + 1) / P;
  const int n_stages = static_cast<int>((r_end - r_begin + G - 1) / G);

  // stage k: rows r_begin + k G .. + G, into ring slot k % stages
  const bool producer = warp == W && lane == 0;
  const unsigned seen = ktpu::lead_thread() ? ktpu::barrier_generation(sync) : 0;
  auto issue = [&](int k) {
    const int s = k % stages;
    const long long r0 = r_begin + static_cast<long long>(k) * G;
    const long long n_rows = r_end - r0 < G ? r_end - r0 : G;
    const uint32_t bytes = static_cast<uint32_t>(n_rows * row_bytes);
    const uint32_t dst = smem_addr(ring + s * stage_bytes);
    mbar_expect_tx(full + 8 * s, 2 * bytes);
    ktpu::bulk_load(dst, x + r0 * d, bytes, full + 8 * s);
    ktpu::bulk_load(dst + static_cast<uint32_t>(G * row_bytes), dy + r0 * d, bytes,
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
  for (int c = threadIdx.x * 8; c < d; c += blockDim.x * 8)
    *reinterpret_cast<uint4*>(sc + c) = load16(scale + c);
  __syncthreads();

  const int group = warp / group_warps, gt = 32 * group_warps;
  const int t = (warp - group * group_warps) * 32 + lane;  // the lane's place in its group
  float ds[kChunks][8];
#pragma unroll
  for (int j = 0; j < kChunks; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) ds[j][i] = 0.f;

  if (warp == W) {  // the producer: each later stage once its slot is released
    if (producer) {
      for (int k = stages; k < n_stages; ++k) {
        mbar_wait(empty + 8 * (k % stages), ((k / stages) & 1) ^ 1);
        issue(k);
      }
    }
    __syncwarp();
  } else {  // a group: row r_begin + k G + group of each stage k
    for (int k = 0; k < n_stages; ++k) {
      const int s = k % stages;
      mbar_wait(full + 8 * s, (k / stages) & 1);
      const long long row = r_begin + static_cast<long long>(k) * G + group;
      const bool have = row < r_end;  // the same in the whole group
      const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(ring + s * stage_bytes) +
                                static_cast<long long>(group) * d;
      const __nv_bfloat16* dys = xs + static_cast<long long>(G) * d;
      uint4 xv[kChunks], dv[kChunks];
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int col = 8 * (t + gt * j);
        xv[j] = dv[j] = make_uint4(0, 0, 0, 0);
        if (have && col < d) {
          xv[j] = load16(xs + col);
          dv[j] = load16(dys + col);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);  // the row is in registers
      if (!have) continue;
      float ssp[2] = {0.f, 0.f}, csp[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int col = 8 * (t + gt * j);
        if (col < d) row_terms(xv[j], dv[j], load16(sc + col), ssp, csp);
      }
      float ss = warp_sum(ssp[0] + ssp[1]);
      float cs = warp_sum(csp[0] + csp[1]);
      if (group_warps > 1) {  // across the group's warps, in warp order
        float2* red = row_red[k & 1];
        if (lane == 0) red[warp] = make_float2(ss, cs);
        named_barrier(1 + group, gt);
        ss = cs = 0.f;
        for (int w = group * group_warps; w < (group + 1) * group_warps; ++w) {
          ss += red[w].x;
          cs += red[w].y;
        }
      }
      const float r = rsqrtf(ss / static_cast<float>(d) + eps);
      const float kk = r * r * r * cs / static_cast<float>(d);
      __nv_bfloat16* dxr = dx + row * d;
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int col = 8 * (t + gt * j);
        if (col < d)
          *reinterpret_cast<uint4*>(dxr + col) =
              dx_terms(xv[j], dv[j], load16(sc + col), r, kk, ds[j]);
      }
    }
  }
  __syncthreads();  // every stage consumed: the ring is free
  float* sums = reinterpret_cast<float*>(ring);  // (G, d): each group's dscale sums
  if (warp < W) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int col = 8 * (t + gt * j);
      if (col < d) store8(sums + static_cast<long long>(group) * d + col, ds[j]);
    }
  }
  __syncthreads();
  // this block's partial: its groups' sums in group order
  const int n4 = d / 4;
  float4* part = reinterpret_cast<float4*>(partial + static_cast<long long>(d) * blockIdx.x);
  const float4* sums4 = reinterpret_cast<const float4*>(sums);
  for (int q = threadIdx.x; q < n4; q += blockDim.x) {
    float4 v = sums4[q];
    for (int g = 1; g < G; ++g) ktpu::sum_into(v, sums4[static_cast<long long>(g) * n4 + q]);
    part[q] = v;
  }
  // when every block's partial is out, each block adds its share of columns
  ktpu::grid_barrier(sync, P, seen);
  dscale_sums(partial, n4, dscale, reinterpret_cast<float4*>(ring));
}

// d > 16384: a block of kWideThreads takes one row at a time and walks it
// twice in device memory; thread t owns columns 8 t + 8 kWideThreads j of
// the block's partial row, where its dscale sums are kept.  Then as above.
__global__ void __launch_bounds__(kWideThreads, 1)
rmsnorm_bwd_wide_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ scale,
                        const __nv_bfloat16* __restrict__ dy, __nv_bfloat16* __restrict__ dx,
                        __nv_bfloat16* __restrict__ dscale, float* __restrict__ partial,
                        unsigned* __restrict__ sync, long long rows, int d, float eps) {
  __shared__ float scratch_ss[kWideThreads / 32], scratch_cs[kWideThreads / 32];
  __shared__ float4 red[kWideThreads];
  const unsigned seen = ktpu::lead_thread() ? ktpu::barrier_generation(sync) : 0;
  const long long P = gridDim.x;
  const long long r_begin = rows * blockIdx.x / P, r_end = rows * (blockIdx.x + 1) / P;
  float* part = partial + static_cast<long long>(d) * blockIdx.x;
  const float zero[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int c = threadIdx.x * 8; c < d; c += kWideThreads * 8) store8(part + c, zero);
  for (long long row = r_begin; row < r_end; ++row) {
    const __nv_bfloat16* xr = x + row * d;
    const __nv_bfloat16* dyr = dy + row * d;
    float ssp[2] = {0.f, 0.f}, csp[2] = {0.f, 0.f};
    for (int c = threadIdx.x * 8; c < d; c += kWideThreads * 8)
      row_terms(load16(xr + c), load16(dyr + c), load16(scale + c), ssp, csp);
    // each scratch is written again only after the other's __syncthreads
    const float ss = ktpu::block_sum(ssp[0] + ssp[1], scratch_ss);
    const float cs = ktpu::block_sum(csp[0] + csp[1], scratch_cs);
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float kk = r * r * r * cs / static_cast<float>(d);
    __nv_bfloat16* dxr = dx + row * d;
    for (int c = threadIdx.x * 8; c < d; c += kWideThreads * 8) {
      float acc[8];
      load8(part + c, acc);
      *reinterpret_cast<uint4*>(dxr + c) =
          dx_terms(load16(xr + c), load16(dyr + c), load16(scale + c), r, kk, acc);
      store8(part + c, acc);
    }
  }
  ktpu::grid_barrier(sync, P, seen);
  dscale_sums(partial, d / 4, dscale, red);
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

// The backward's grid at width d on the current device: *resident, the
// blocks the SMs hold at once (the launch is cooperative), and
// *rows_per_block, the rows a block takes at a time (its groups).  A
// launch over rows takes at most min(*resident, ceil(rows / *rows_per_block))
// blocks.
extern "C" int ktpu_rmsnorm_bwd_grid(int d, int* resident, int* rows_per_block) {
  if (d <= 0 || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const BwdPlan p = bwd_plan(d);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    if (p.group_warps == 0) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rmsnorm_bwd_wide_kernel,
                                                        p.threads, 0);
    } else {
      e = cudaFuncSetAttribute(rmsnorm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(p.smem));
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rmsnorm_bwd_kernel,
                                                          p.threads, p.smem);
    }
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *resident = sms * per_sm;
  *rows_per_block = p.groups;
  return 0;
}

// x, dy, dx: (rows, d) bf16 contiguous; scale, dscale: (d,) bf16; d % 8 == 0;
// P blocks, 1 <= P <= ktpu_rmsnorm_bwd_grid's; partial: (P, d) f32
// scratch; sync: 2 uint32, the first 0 (left 0).  One cooperative launch.
extern "C" int ktpu_rmsnorm_bwd_bf16(const void* x, const void* scale, const void* dy, void* dx,
                                     void* dscale, void* partial, void* sync, long long rows,
                                     int d, int P, float eps, void* stream) {
  if (rows <= 0 || d <= 0 || d % 8 != 0 || P <= 0 || P > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdPlan p = bwd_plan(d);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* sp = static_cast<const __nv_bfloat16*>(scale);
  const __nv_bfloat16* dyp = static_cast<const __nv_bfloat16*>(dy);
  __nv_bfloat16* dxp = static_cast<__nv_bfloat16*>(dx);
  __nv_bfloat16* dsp = static_cast<__nv_bfloat16*>(dscale);
  float* pp = static_cast<float*>(partial);
  unsigned* syncp = static_cast<unsigned*>(sync);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (p.group_warps == 0) {
    void* args[] = {&xp, &sp, &dyp, &dxp, &dsp, &pp, &syncp, &rows, &d, &eps};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(rmsnorm_bwd_wide_kernel),
                                    dim3(P), dim3(p.threads), args, 0, st);
  } else {
    e = cudaFuncSetAttribute(rmsnorm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    int group_warps = p.group_warps, stages = p.stages;
    void* args[] = {&xp, &sp, &dyp, &dxp, &dsp, &pp, &syncp, &rows, &d, &eps,
                    &group_warps, &stages};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(rmsnorm_bwd_kernel), dim3(P),
                                    dim3(p.threads), args, p.smem, st);
  }
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
