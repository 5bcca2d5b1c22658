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
// Design.  M goes from 1.6 M rows (the stem at batch 128) down to 6272,
// while C goes from 64 up to 2048, so every grid splits both: a block is
// (tx, ty) threads, tx groups of 8 channels (one 16-byte load each,
// neighbouring threads on neighbouring addresses) by ty row lanes,
// tx * ty <= 512; grid.x covers C and the grid.y = P blocks of a column
// walk its rows.  A thread keeps one group of 8 channels for the whole
// launch, so their w, b and coefficients sit in registers and no pass
// computes a channel index per vector.  The reductions' grids hold the
// blocks that are resident at once (the occupancy API, asked once); the
// apply's is one short block per 2 * ty rows.
//
// Reductions (Σx and Σx² for the statistics; Σdy' and Σdy'·x for the
// backward), one launch each: a thread sums its rows with 2-4 rows' loads
// in flight; the block adds its row lanes in lane order and writes a
// (2, width) f32 partial; the last of a column's P blocks to finish (a
// ticket counter, the only atomic, which that block resets for the next
// call) adds the column's P partials in a fixed order with all its threads
// and does the per-channel epilogue.  No atomic touches a sum: the result
// depends only on the shape and the grid, and two runs give the same bits.
// This is JAX's E[x²] − E[x]² formula, not Welford, as the contract asks.
// The backward goes on in the same launch: its grid is persistent, every
// block resident (a cooperative launch), the column's other blocks wait
// for the last one's per-channel coefficients, then each block runs dx
// over its own rows, the rows it summed last first, so that where x, dy
// and the mask fit in the 50 MB L2 the second read comes from there.
// (Against two launches, sums with the chain rule and then dx, this
// measured faster on an H100 at ResNet-50's stem, stage 1 and stage 4
// batch norms, slower at stage 3.)
//
// Where the layer has a ReLU, the apply also writes a (M, C/8) byte mask
// of y > 0, taken on the rounded bf16 y (bit k of byte (row, g) is channel
// 8g + k): the backward's only use of y, read as 1/8 byte an element
// where y is 2, twice.  The backward reads x, dy and the mask for its sums
// (4.125 bytes an element), then again in the dx pass, which writes dx
// (and dr): 10.25 bytes an element at the stem, the least being 6.125.
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
//
// Across ranks (data parallelism: each rank holds M rows of a global batch
// of n·M, and JAX's statistics are over the global batch), a launch cannot
// wait for a collective that the host issues, so the one-launch kernels
// split at their per-channel step:
//   forward:  bn_sums (this rank's (2, C) Σx, Σx², the same partials and
//             fixed-order column total as the statistics) -> all-reduce on
//             the host -> bn_fold_apply (the apply, each block first folding
//             its own channels' global sums over M·n rows with the
//             statistics kernel's per-channel code; the blocks of the grid's
//             first row also write w, b and stats for the backward): two
//             launches, where a fold of its own would be a third whose
//             36 bytes a channel take a launch's fixed cost;
//   backward: bn_bwd_sums (this rank's Σdy', Σdy'·x, and dscale, dbias from
//             them: the train step averages those with every gradient) ->
//             all-reduce -> bn_bwd_dx (the coefficients from the global
//             sums and M·n rows, then dx and dr over the rank's rows).
// With one rank the split gives the one-launch kernels' bits: the same
// partials in the same order, and the same per-channel functions.  It
// reads x, dy and the mask twice in the backward, as the one launch does
// beyond L2; it is the simple form, not a tuned one.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;  // threads a block; tx * ty <= kThreads
constexpr int kMaxTx = 16;     // groups of 8 channels a block spans (128 channels)
constexpr int kBlocksPerSm = 2;
constexpr int kApplyRows = 2;  // rows a thread of the apply loads up front

__device__ __forceinline__ uint4 ld16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(v[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* in) {
  uint4 raw;
  __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  return raw;
}

// Bit k set where bf16 value k of the 8 is > 0 (not +0, -0 or negative).
__device__ __forceinline__ unsigned positive_bits(const uint4& raw) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bits |= (static_cast<short>(w[i] & 0xffffu) > 0 ? 1u : 0u) << (2 * i);
    bits |= (static_cast<short>(w[i] >> 16) > 0 ? 1u : 0u) << (2 * i + 1);
  }
  return bits;
}

__device__ __forceinline__ void load_coef(const float* p, float* out) {
  const float4 lo = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = lo.x, out[1] = lo.y, out[2] = lo.z, out[3] = lo.w;
  out[4] = hi.x, out[5] = hi.y, out[6] = hi.z, out[7] = hi.w;
}

// One row's contribution to a thread's 8 sums.  kBwd = false: Σx, Σx².
// kBwd = true: Σdy', Σdy'·x, with dy' = dy where bit k of mk is set.
template <bool kBwd>
__device__ __forceinline__ void accumulate8(const uint4& xr, const uint4& dr, unsigned mk,
                                            float* a, float* b) {
  float xv[8];
  unpack8(xr, xv);
  if (!kBwd) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      a[k] += xv[k];
      b[k] += xv[k] * xv[k];
    }
  } else {
    float dv[8];
    unpack8(dr, dv);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float d = (mk >> k) & 1u ? dv[k] : 0.f;
      a[k] += d;
      b[k] += d * xv[k];
    }
  }
}

// A thread's sums over its rows r0, r0 + step, ... < M of the 8 channels
// from column col, kUnroll rows' loads issued before their adds.  The
// mask is read only where it is not null (a layer with a ReLU).
template <bool kBwd>
__device__ __forceinline__ void thread_sums(const __nv_bfloat16* __restrict__ x,
                                            const __nv_bfloat16* __restrict__ dy,
                                            const uint8_t* __restrict__ mask, long long M, int C,
                                            int col, long long r0, long long step, float* a,
                                            float* b) {
  constexpr int kUnroll = kBwd ? 2 : 4;
  const int G = C / 8;
  long long r = r0;
  for (; r + (kUnroll - 1) * step < M; r += kUnroll * step) {
    uint4 xr[kUnroll], dr[kUnroll] = {};
    unsigned mk[kUnroll] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = r + u * step;
      xr[u] = ld16(x + row * C + col);
      if (kBwd) {
        dr[u] = ld16(dy + row * C + col);
        mk[u] = mask != nullptr ? mask[row * G + col / 8] : 0xffu;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) accumulate8<kBwd>(xr[u], dr[u], mk[u], a, b);
  }
  for (; r < M; r += step) {
    uint4 dr = make_uint4(0, 0, 0, 0);
    unsigned mk = 0xffu;
    if (kBwd) {
      dr = ld16(dy + r * C + col);
      if (mask != nullptr) mk = mask[r * G + col / 8];
    }
    accumulate8<kBwd>(ld16(x + r * C + col), dr, mk, a, b);
  }
}

// The block adds its row lanes in lane order and writes partial row
// blockIdx.y of (P, 2, C); then thread 0 takes the column's ticket.
// Returns, in every thread, whether this block is the last of the
// column's P blocks to get there: that block sees every partial of the
// column.  sync: the column's barrier words (ktpu::barrier_arrive).
// smem: 2 * kThreads * 8 floats.
__device__ __forceinline__ bool block_partial(const float* a, const float* b, float* smem,
                                              float* __restrict__ partial,
                                              unsigned* __restrict__ sync, int C) {
  const int tx = blockDim.x, ty = blockDim.y, width = tx * 8;
  const int tid = threadIdx.y * tx + threadIdx.x;
  float* s1 = smem;
  float* s2 = smem + ty * width;
  const int base = threadIdx.y * width + threadIdx.x * 8;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s1[base + k] = a[k];
    s2[base + k] = b[k];
  }
  __syncthreads();
  for (int k = tid; k < 2 * width; k += tx * ty) {
    const int q = k / width, col = k - q * width;
    const int c = blockIdx.x * width + col;
    if (c >= C) continue;
    const float* s = q ? s2 : s1;
    float acc = 0.f;
    for (int j = 0; j < ty; ++j) acc += s[j * width + col];
    partial[(static_cast<long long>(blockIdx.y) * 2 + q) * C + c] = acc;
  }
  return ktpu::barrier_arrive(sync, gridDim.y);
}

// In the column's last block: channel c's two sums over the P partials
// (ktpu::column_lanes' fixed order).  Threads tid < width get the totals
// of channel blockIdx.x * width + tid in s and s2; returns whether that is
// a channel.
__device__ __forceinline__ bool column_totals(const float* __restrict__ partial, float* smem,
                                              int C, float& s, float& s2) {
  const int width = blockDim.x * 8, outs = 2 * width;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  // output o: sum q = o / width of channel blockIdx.x * width + o % width
  auto col = [&](int o) -> long long {
    const int q = o / width, c = blockIdx.x * width + (o - q * width);
    return c < C ? static_cast<long long>(q) * C + c : -1;
  };
  const int lanes = ktpu::column_lanes(partial, 2LL * C, gridDim.y, outs, col, smem);
  __syncthreads();
  if (tid >= width) return false;
  s = ktpu::column_total(smem, outs, lanes, tid);
  s2 = ktpu::column_total(smem, outs, lanes, width + tid);
  return blockIdx.x * width + tid < C;
}

// One channel's fold: w, b (bf16) and its stats (mean, rstd, inv, gate).
struct Fold {
  __nv_bfloat16 w, b;
  float mean, rstd, inv, gate;
};

// The fold of a channel's sums s = Σx, s2 = Σx² over m rows.  The
// statistics kernel and the split apply both call it, so that they give
// the same bits.
__device__ __forceinline__ Fold fold_values(float s, float s2, float m, float scale, float bias,
                                            float eps) {
  const float mean = s / m, mean2 = s2 / m;
  // no fused multiply-add here: fma(-mean, mean, mean2) would keep the
  // square's rounding error, so a single row (mean2 = fl(x²)) would not
  // give the exact 0 (a tie, gate ½) that JAX's order of roundings gives
  const float d = __fsub_rn(mean2, __fmul_rn(mean, mean));
  const float rstd = rsqrtf(fmaxf(d, 0.f) + eps);
  const float inv = rstd * scale;
  return Fold{ktpu::f2bf(inv), ktpu::f2bf(__fmaf_rn(-mean, inv, bias)), mean, rstd, inv,
              d > 0.f ? 1.f : (d == 0.f ? 0.5f : 0.f)};
}

// Channel c's fold written out: w[c], b[c] and column c of stats (4, C).
__device__ __forceinline__ void store_fold(const Fold& f, int c, int C,
                                           __nv_bfloat16* __restrict__ w,
                                           __nv_bfloat16* __restrict__ b,
                                           float* __restrict__ stats) {
  w[c] = f.w;
  b[c] = f.b;
  stats[c] = f.mean;
  stats[C + c] = f.rstd;
  stats[2 * C + c] = f.inv;
  stats[3 * C + c] = f.gate;
}

// Channel c's d_inv = d_w − d_b·mean from its sums d_b = Σdy', d_w =
// Σdy'·x; unfused, as d in the fold: a single row gives d_inv = 0 exactly.
__device__ __forceinline__ float bwd_d_inv(float d_b, float d_w, int c,
                                           const float* __restrict__ stats) {
  return __fsub_rn(d_w, __fmul_rn(d_b, stats[c]));
}

// Channel c's dx coefficients (c0, c1) = (d_mean / m, 2·d_mean2 / m) from
// its sums over m rows, each op rounded on its own (no contraction), so
// that every kernel that calls it gets the same bits.
__device__ __forceinline__ void bwd_coef(float d_b, float d_w, float m, int c, int C,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ stats, float& c0,
                                         float& c1) {
  const float mean = stats[c], rstd = stats[C + c], inv = stats[2 * C + c];
  const float gate = stats[3 * C + c];
  const float d_inv = bwd_d_inv(d_b, d_w, c, stats);
  const float d_v = -0.5f * d_inv * scale[c] * rstd * rstd * rstd * gate;
  c0 = __fdiv_rn(__fsub_rn(__fmul_rn(-d_b, inv), __fmul_rn(2.f * mean, d_v)), m);
  c1 = __fdiv_rn(2.f * d_v, m);
}

// Statistics in one launch (kFold): w, b (bf16) and stats = (mean, rstd,
// inv, gate) f32 (4, C).  Without kFold (bn_sums): this launch's (2, C)
// sums Σx, Σx² in `sums`, from the same partials in the same order.
// sync: the columns' ticket counters (2 words each).
template <bool kFold>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bn_stats_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, __nv_bfloat16* __restrict__ w,
                __nv_bfloat16* __restrict__ b, float* __restrict__ stats,
                float* __restrict__ sums, float* __restrict__ partial,
                unsigned* __restrict__ sync, long long M, int C, float eps) {
  __shared__ float smem[2 * kThreads * 8];
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * 8;
  float a[8], q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = q[k] = 0.f;
  if (col < C)
    thread_sums<false>(x, nullptr, nullptr, M, C, col,
                       static_cast<long long>(blockIdx.y) * blockDim.y + threadIdx.y,
                       static_cast<long long>(gridDim.y) * blockDim.y, a, q);
  if (!block_partial(a, q, smem, partial, sync + 2 * blockIdx.x, C)) return;
  float s, s2;
  if (column_totals(partial, smem, C, s, s2)) {
    const int c = blockIdx.x * blockDim.x * 8 + threadIdx.y * blockDim.x + threadIdx.x;
    if (kFold) {
      store_fold(fold_values(s, s2, static_cast<float>(M), scale[c], bias[c], eps), c, C, w, b,
                 stats);
    } else {
      sums[c] = s;
      sums[C + c] = s2;
    }
  }
  // the next call's ticket; no block waits on this column's generation
  if (ktpu::lead_thread()) sync[2 * blockIdx.x] = 0;
}

// dx = dy'·w + c0 + c1·x, and dr = dy' where dr is not null, over one row.
__device__ __forceinline__ void dx_row(const uint4& xr, const uint4& dr, unsigned mk,
                                       const float* wv, const float* c0, const float* c1,
                                       __nv_bfloat16* pdx, __nv_bfloat16* pdr) {
  float xv[8], dv[8], out[8];
  unpack8(xr, xv);
  unpack8(dr, dv);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    dv[k] = (mk >> k) & 1u ? dv[k] : 0.f;
    out[k] = dv[k] * wv[k] + c0[k] + c1[k] * xv[k];
  }
  *reinterpret_cast<uint4*>(pdx) = pack8(out);
  if (pdr != nullptr) *reinterpret_cast<uint4*>(pdr) = pack8(dv);
}

// The dx pass over a thread's rows r0, r0 + step, ... < M, two rows' loads
// in flight, from the last row: the rows this thread summed last are read
// again first, while L2 may still hold them.
__device__ __forceinline__ void dx_rows(const __nv_bfloat16* __restrict__ x,
                                        const uint8_t* __restrict__ mask,
                                        const __nv_bfloat16* __restrict__ dy, const float* wv,
                                        const float* c0, const float* c1,
                                        __nv_bfloat16* __restrict__ dx,
                                        __nv_bfloat16* __restrict__ dr, long long M, int C,
                                        int col, long long r0, long long step) {
  if (r0 >= M) return;
  const int G = C / 8;
  auto mask_at = [&](long long row) { return mask != nullptr ? mask[row * G + col / 8] : 0xffu; };
  long long r = r0 + (M - 1 - r0) / step * step;
  for (; r - step >= 0; r -= 2 * step) {
    const long long o0 = r * C + col, o1 = (r - step) * C + col;
    const uint4 x0 = ld16(x + o0), x1 = ld16(x + o1), d0 = ld16(dy + o0), d1 = ld16(dy + o1);
    const unsigned m0 = mask_at(r), m1 = mask_at(r - step);
    dx_row(x0, d0, m0, wv, c0, c1, dx + o0, dr != nullptr ? dr + o0 : nullptr);
    dx_row(x1, d1, m1, wv, c0, c1, dx + o1, dr != nullptr ? dr + o1 : nullptr);
  }
  if (r >= 0) {
    const long long o = r * C + col;
    dx_row(ld16(x + o), ld16(dy + o), mask_at(r), wv, c0, c1, dx + o,
           dr != nullptr ? dr + o : nullptr);
  }
}

// Backward in one launch, a persistent grid with every block resident (a
// cooperative launch): the sums of dy' and dy'·x; in the column's last
// block the per-channel chain rule: dscale, dbias (f32) and coef =
// (d_mean / M, 2·d_mean2 / M) (2, C); the column's other blocks wait for
// that block's coef (sync word 2c+1, a generation count that it moves),
// and every block does dx over its own rows, last first.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bn_bwd_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ mask,
              const __nv_bfloat16* __restrict__ dy, const __nv_bfloat16* __restrict__ w,
              const float* __restrict__ scale, const float* __restrict__ stats,
              __nv_bfloat16* __restrict__ dx, __nv_bfloat16* __restrict__ dr,
              float* __restrict__ dscale, float* __restrict__ dbias, float* __restrict__ partial,
              float* __restrict__ coef, unsigned* __restrict__ sync, long long M, int C) {
  __shared__ float smem[2 * kThreads * 8];
  unsigned* const column_sync = sync + 2 * blockIdx.x;
  // read before this block's ticket
  const unsigned seen = ktpu::lead_thread() ? ktpu::barrier_generation(column_sync) : 0;
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * 8;
  const long long r0 = static_cast<long long>(blockIdx.y) * blockDim.y + threadIdx.y;
  const long long step = static_cast<long long>(gridDim.y) * blockDim.y;
  float a[8], q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = q[k] = 0.f;
  if (col < C) thread_sums<true>(x, dy, mask, M, C, col, r0, step, a, q);
  if (block_partial(a, q, smem, partial, column_sync, C)) {
    float d_b, d_w;
    if (column_totals(partial, smem, C, d_b, d_w)) {
      const int c = blockIdx.x * blockDim.x * 8 + threadIdx.y * blockDim.x + threadIdx.x;
      dbias[c] = d_b;
      dscale[c] = bwd_d_inv(d_b, d_w, c, stats) * stats[C + c];
      bwd_coef(d_b, d_w, static_cast<float>(M), c, C, scale, stats, coef[c], coef[C + c]);
    }
    ktpu::barrier_release(column_sync);  // coef is visible before the generation moves
  } else {
    ktpu::barrier_wait(column_sync, seen);
  }
  if (col >= C) return;
  float wv[8], c0[8], c1[8];
  unpack8(ld16(w + col), wv);
  load_coef(coef + col, c0);
  load_coef(coef + C + col, c1);
  dx_rows(x, mask, dy, wv, c0, c1, dx, dr, M, C, col, r0, step);
}

// The split backward's sums: this launch's (2, C) Σdy', Σdy'·x in `sums`
// (the one-launch backward's partials, in its order), and in the column's
// last block dscale and dbias from them.  Not cooperative: no block waits.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bn_bwd_sums_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ mask,
                   const __nv_bfloat16* __restrict__ dy, const float* __restrict__ stats,
                   float* __restrict__ sums, float* __restrict__ dscale,
                   float* __restrict__ dbias, float* __restrict__ partial,
                   unsigned* __restrict__ sync, long long M, int C) {
  __shared__ float smem[2 * kThreads * 8];
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * 8;
  float a[8], q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = q[k] = 0.f;
  if (col < C)
    thread_sums<true>(x, dy, mask, M, C, col,
                      static_cast<long long>(blockIdx.y) * blockDim.y + threadIdx.y,
                      static_cast<long long>(gridDim.y) * blockDim.y, a, q);
  if (!block_partial(a, q, smem, partial, sync + 2 * blockIdx.x, C)) return;
  float d_b, d_w;
  if (column_totals(partial, smem, C, d_b, d_w)) {
    const int c = blockIdx.x * blockDim.x * 8 + threadIdx.y * blockDim.x + threadIdx.x;
    sums[c] = d_b;
    sums[C + c] = d_w;
    dbias[c] = d_b;
    dscale[c] = bwd_d_inv(d_b, d_w, c, stats) * stats[C + c];
  }
  if (ktpu::lead_thread()) sync[2 * blockIdx.x] = 0;
}

// The split backward's dx: each thread's 8 channels' coefficients from the
// all-reduced sums over M_global rows, then dx (and dr) over its own rows
// of this rank's M, as the one-launch backward's dx pass.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bn_bwd_dx_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ mask,
                 const __nv_bfloat16* __restrict__ dy, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ scale, const float* __restrict__ stats,
                 const float* __restrict__ sums, __nv_bfloat16* __restrict__ dx,
                 __nv_bfloat16* __restrict__ dr, long long M, long long M_global, int C) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (col >= C) return;
  const float m = static_cast<float>(M_global);
  float wv[8], c0[8], c1[8];
  unpack8(ld16(w + col), wv);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    bwd_coef(sums[col + k], sums[C + col + k], m, col + k, C, scale, stats, c0[k], c1[k]);
  dx_rows(x, mask, dy, wv, c0, c1, dx, dr, M, C, col,
          static_cast<long long>(blockIdx.y) * blockDim.y + threadIdx.y,
          static_cast<long long>(gridDim.y) * blockDim.y);
}

// y = relu?(x * w + b [+ r]), in f32, rounded once; where mask is not
// null (a ReLU) also the byte mask of y > 0 on the rounded y.  A thread
// loads kApplyRows rows (of x and r) before computing them and is done: a
// grid of many short blocks, which streams faster here than resident
// blocks walking the rows.
// kFold (the split forward's apply): w and b are not read but folded from
// the (2, C) sums over M_all rows (every rank's), each block its own
// columns' channels in its prologue (fold_values, one thread a channel,
// into shared memory) while its rows' loads are in flight; the blocks of
// grid row 0 also write them (w_out, b_out) and stats (4, C) for the
// backward.  The fold's four loads go out ahead of the rows': on an H100
// that cost more at ResNet-50's stem (1.040 of bn_apply's time, against
// 1.029 with them after the rows') but less over the 53 layers of a
// split step (its batch norm +0.047 ms over the one-launch kernels',
// against +0.076), whose small layers wait on the prologue's latency.
template <bool kFold>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const __nv_bfloat16* __restrict__ b, const __nv_bfloat16* __restrict__ r,
                __nv_bfloat16* __restrict__ y, uint8_t* __restrict__ mask,
                const float* __restrict__ sums, const float* __restrict__ scale,
                const float* __restrict__ bias, __nv_bfloat16* __restrict__ w_out,
                __nv_bfloat16* __restrict__ b_out, float* __restrict__ stats, long long M,
                long long M_all, int C, float eps) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (!kFold && col >= C) return;
  const int width = blockDim.x * 8, tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int c = blockIdx.x * width + tid;
  const bool folds = kFold && tid < width && c < C;
  float s = 0.f, s2 = 0.f, sc = 0.f, bi = 0.f;
  if (folds) {
    s = sums[c];
    s2 = sums[C + c];
    sc = scale[c];
    bi = bias[c];
  }
  const int G = C / 8;
  const long long row0 =
      static_cast<long long>(blockIdx.y) * blockDim.y * kApplyRows + threadIdx.y;
  uint4 xs[kApplyRows], rs[kApplyRows];
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int u = 0; u < kApplyRows; ++u) {
    const long long row = row0 + u * blockDim.y;
    if (col < C && row < M) {
      xs[u] = ld16(x + row * C + col);
      rs[u] = r != nullptr ? ld16(r + row * C + col) : zero;
    }
  }
  float wv[8], bv[8];
  if (kFold) {
    __shared__ __align__(16) float fw[kMaxTx * 8];
    __shared__ __align__(16) float fb[kMaxTx * 8];
    if (folds) {
      const Fold f = fold_values(s, s2, static_cast<float>(M_all), sc, bi, eps);
      fw[tid] = __bfloat162float(f.w);
      fb[tid] = __bfloat162float(f.b);
      if (blockIdx.y == 0) store_fold(f, c, C, w_out, b_out, stats);
    }
    __syncthreads();
    if (col >= C) return;
    const float4* pw = reinterpret_cast<const float4*>(fw + threadIdx.x * 8);
    const float4* pb = reinterpret_cast<const float4*>(fb + threadIdx.x * 8);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 w4 = pw[h], b4 = pb[h];
      wv[4 * h] = w4.x, wv[4 * h + 1] = w4.y, wv[4 * h + 2] = w4.z, wv[4 * h + 3] = w4.w;
      bv[4 * h] = b4.x, bv[4 * h + 1] = b4.y, bv[4 * h + 2] = b4.z, bv[4 * h + 3] = b4.w;
    }
  } else {
    unpack8(ld16(w + col), wv);
    unpack8(ld16(b + col), bv);
  }
#pragma unroll
  for (int u = 0; u < kApplyRows; ++u) {
    const long long row = row0 + u * blockDim.y;
    if (row >= M) break;
    float xv[8], out[8];
    unpack8(xs[u], xv);
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k] = fmaf(xv[k], wv[k], bv[k]);
    if (r != nullptr) {
      float rv[8];
      unpack8(rs[u], rv);
#pragma unroll
      for (int k = 0; k < 8; ++k) out[k] += rv[k];
    }
    if (mask != nullptr) {
#pragma unroll
      for (int k = 0; k < 8; ++k) out[k] = fmaxf(out[k], 0.f);
    }
    const uint4 packed = pack8(out);
    *reinterpret_cast<uint4*>(y + row * C + col) = packed;
    if (mask != nullptr) mask[row * G + col / 8] = static_cast<uint8_t>(positive_bits(packed));
  }
}

// Every grid's block: tx groups of 8 channels by ty row lanes.
dim3 block_for(int C) {
  const int tx = C / 8 < kMaxTx ? C / 8 : kMaxTx;
  return dim3(tx, kThreads / tx);
}

int columns(int C, const dim3& block) { return (C / 8 + block.x - 1) / block.x; }

template <typename Kernel>
int resident_blocks(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return per_sm * sms;
}

// The apply's grid: the reductions' columns by one block per kApplyRows * ty
// rows.
dim3 apply_grid(long long M, int C, const dim3& block) {
  const long long rows = static_cast<long long>(block.y) * kApplyRows;
  return dim3(columns(C, block), static_cast<unsigned>((M + rows - 1) / rows));
}

bool bad_shape(long long M, int C) { return M <= 0 || C <= 0 || C % 8 != 0; }

}  // namespace

// The blocks of a reduction grid that are resident at once on this card:
// the wrapper sizes P (and the partial scratch) from it, P * columns <= it.
extern "C" int ktpu_bn_resident_blocks(int* out) {
  const int s = resident_blocks(bn_stats_kernel<true>), b = resident_blocks(bn_bwd_kernel);
  *out = s < b ? s : b;
  return static_cast<int>(cudaGetLastError());
}

// x: (M, C) bf16; scale, bias: (C,) f32; w, b: (C,) bf16 out; stats: (4, C)
// f32 out (mean, rstd, inv, gate); partial: (P, 2, C) f32 scratch; sync: 2
// zeroed uint32 a column of 128 channels, left zeroed.  C % 8 == 0;
// 1 <= P.  One launch.
extern "C" int ktpu_bn_stats_bf16(const void* x, const void* scale, const void* bias, void* w,
                                  void* b, void* stats, void* partial, void* sync, long long M,
                                  int C, int P, float eps, void* stream) {
  if (bad_shape(M, C) || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block = block_for(C);
  bn_stats_kernel<true>
      <<<dim3(columns(C, block), P), block, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
          static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(w),
          static_cast<__nv_bfloat16*>(b), static_cast<float*>(stats), nullptr,
          static_cast<float*>(partial), static_cast<unsigned*>(sync), M, C, eps);
  return static_cast<int>(cudaGetLastError());
}

// The split forward's first launch.  x: (M, C) bf16; sums: (2, C) f32 out
// (Σx, Σx²); partial, sync and P as for ktpu_bn_stats_bf16, whose partials
// and order it keeps.
extern "C" int ktpu_bn_sums_bf16(const void* x, void* sums, void* partial, void* sync,
                                 long long M, int C, int P, void* stream) {
  if (bad_shape(M, C) || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block = block_for(C);
  bn_stats_kernel<false>
      <<<dim3(columns(C, block), P), block, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(x), nullptr, nullptr, nullptr, nullptr, nullptr,
          static_cast<float*>(sums), static_cast<float*>(partial), static_cast<unsigned*>(sync),
          M, C, 0.f);
  return static_cast<int>(cudaGetLastError());
}

// x, y: (M, C) bf16; w, b: (C,) bf16; r: (M, C) bf16 or null; mask: (M,
// C/8) uint8 out, or null for no ReLU; C % 8 == 0.
extern "C" int ktpu_bn_apply_bf16(const void* x, const void* w, const void* b, const void* r,
                                  void* y, void* mask, long long M, int C, void* stream) {
  if (bad_shape(M, C)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block = block_for(C);
  bn_apply_kernel<false><<<apply_grid(M, C, block), block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<const __nv_bfloat16*>(r),
      static_cast<__nv_bfloat16*>(y), static_cast<uint8_t*>(mask), nullptr, nullptr, nullptr,
      nullptr, nullptr, nullptr, M, M, C, 0.f);
  return static_cast<int>(cudaGetLastError());
}

// The split forward's apply, after bn_sums and the all-reduce.  x, y: (M, C)
// bf16 (this rank's rows); sums: (2, C) f32, Σx and Σx² summed over every
// rank; M_all: the rows of every rank; scale, bias: (C,) f32; r, mask as
// for ktpu_bn_apply_bf16; w, b: (C,) bf16 out and stats: (4, C) f32 out,
// as ktpu_bn_stats_bf16 writes them.  One launch.
extern "C" int ktpu_bn_fold_apply_bf16(const void* x, const void* sums, const void* scale,
                                       const void* bias, const void* r, void* y, void* mask,
                                       void* w, void* b, void* stats, long long M,
                                       long long M_all, int C, float eps, void* stream) {
  if (bad_shape(M, C) || M_all < M) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block = block_for(C);
  bn_apply_kernel<true><<<apply_grid(M, C, block), block, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), nullptr, nullptr,
      static_cast<const __nv_bfloat16*>(r), static_cast<__nv_bfloat16*>(y),
      static_cast<uint8_t*>(mask), static_cast<const float*>(sums),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(b), static_cast<float*>(stats),
      M, M_all, C, eps);
  return static_cast<int>(cudaGetLastError());
}

// x, dy, dx: (M, C) bf16; mask: (M, C/8) uint8 from ktpu_bn_apply_bf16, or
// null for no ReLU; dr: (M, C) bf16 or null; w: (C,) bf16; scale: (C,) f32;
// stats: (4, C) f32 from ktpu_bn_stats_bf16; dscale, dbias: (C,) f32 out;
// partial: (P, 2, C) and coef: (2, C) f32 scratch; sync as for the
// statistics.  One cooperative launch: P * columns <= the resident blocks
// (ktpu_bn_resident_blocks), or it returns an error and runs nothing.
extern "C" int ktpu_bn_bwd_bf16(const void* x, const void* mask, const void* dy, const void* w,
                                const void* scale, const void* stats, void* dx, void* dr,
                                void* dscale, void* dbias, void* partial, void* coef, void* sync,
                                long long M, int C, int P, void* stream) {
  if (bad_shape(M, C) || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block = block_for(C), grid(columns(C, block), P);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  const __nv_bfloat16* dyp = static_cast<const __nv_bfloat16*>(dy);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
  const float* sp = static_cast<const float*>(scale);
  const float* stp = static_cast<const float*>(stats);
  __nv_bfloat16* dxp = static_cast<__nv_bfloat16*>(dx);
  __nv_bfloat16* drp = static_cast<__nv_bfloat16*>(dr);
  float* dsp = static_cast<float*>(dscale);
  float* dbp = static_cast<float*>(dbias);
  float* pp = static_cast<float*>(partial);
  float* cp = static_cast<float*>(coef);
  unsigned* syp = static_cast<unsigned*>(sync);
  void* args[] = {&xp, &mp, &dyp, &wp, &sp, &stp, &dxp, &drp, &dsp, &dbp, &pp, &cp, &syp, &M, &C};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&bn_bwd_kernel),
                                                      grid, block, args, 0,
                                                      static_cast<cudaStream_t>(stream)));
}

// The split backward's first launch.  x, dy: (M, C) bf16; mask as for
// ktpu_bn_bwd_bf16; stats: (4, C) f32 from the split apply; sums: (2, C) f32 out
// (Σdy', Σdy'·x over these M rows); dscale, dbias: (C,) f32 out, from
// these sums; partial, sync and P as for ktpu_bn_bwd_bf16, whose partials
// and order it keeps.  Not cooperative.
extern "C" int ktpu_bn_bwd_sums_bf16(const void* x, const void* mask, const void* dy,
                                     const void* stats, void* sums, void* dscale, void* dbias,
                                     void* partial, void* sync, long long M, int C, int P,
                                     void* stream) {
  if (bad_shape(M, C) || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block = block_for(C);
  bn_bwd_sums_kernel<<<dim3(columns(C, block), P), block, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const __nv_bfloat16*>(dy), static_cast<const float*>(stats),
      static_cast<float*>(sums), static_cast<float*>(dscale), static_cast<float*>(dbias),
      static_cast<float*>(partial), static_cast<unsigned*>(sync), M, C);
  return static_cast<int>(cudaGetLastError());
}

// The split backward's dx.  x, dy, dx: (M, C) bf16 (this rank's rows); mask,
// dr, w, scale, stats as for ktpu_bn_bwd_bf16; sums: (2, C) f32, Σdy' and
// Σdy'·x summed over every rank; M_global: the rows of every rank; P as
// for the sums (the grid walks the rows as the one-launch dx pass does).
extern "C" int ktpu_bn_bwd_dx_bf16(const void* x, const void* mask, const void* dy,
                                   const void* w, const void* scale, const void* stats,
                                   const void* sums, void* dx, void* dr, long long M,
                                   long long M_global, int C, int P, void* stream) {
  if (bad_shape(M, C) || M_global < M || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block = block_for(C);
  bn_bwd_dx_kernel<<<dim3(columns(C, block), P), block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(stats),
      static_cast<const float*>(sums), static_cast<__nv_bfloat16*>(dx),
      static_cast<__nv_bfloat16*>(dr), M, M_global, C);
  return static_cast<int>(cudaGetLastError());
}
