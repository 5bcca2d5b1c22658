// K1 causal GQA attention and K7a non-causal attention for Hopper: forward
// and backward, one tile loop for both (`causal` picks the mask).
//
// Replaces: kubernetes1_tpu/workloads/llama.py `attention`, i.e.
// jax.nn.dot_product_attention(q, k, v, is_causal=True), and
// kubernetes1_tpu/workloads/bert.py:129, jax.nn.dot_product_attention(q, k,
// v) with no mask, which XLA lowers to QK^T (f32 accumulate) * hd^-0.5, the
// mask, f32 softmax, probs cast to bf16, P.V.  q: (B, S, H, hd), k/v: (B, S,
// Hkv, hd), bf16; query head n reads kv head n / (H / Hkv), as JAX's (B, T,
// K, G, hd) reshape does (BERT: H == Hkv).
//
// The two masks: causal keeps key <= query, which also hides every key past
// S from a real query row.  Non-causal walks every K/V tile, so the keys
// past S in the last tile (zero-filled: a zero key scores 0, not -inf) are
// masked to -inf explicitly, in the forward and in the backward's P^T.
//
// Bound on the H100: operations at the decode server's shapes.  4*hd flops
// per unmasked (query, key) pair: at B=8, S=1024, H=32, hd=128 that is
// ~69 GFLOP against ~168 MB of q, k, v and o, about 400 flops per byte,
// above the card's ~295 bf16 flops per byte.  BERT-large's non-causal
// B=32, S=512, H=16, hd=64: 34.4 GFLOP against 134 MB, ~256 flops per byte,
// just under that line, so bytes and operations bound it about equally.
//
// Design (flash attention, forward only, no KV cache, as the JAX engine):
// - one block of 4 warps per (64-row query tile, q head, batch row); each
//   warp owns 16 query rows.  Tiles are launched last-first, so the long
//   causal rows start early and the short ones fill the tail;
// - the block walks 64-row K/V tiles up to the causal diagonal (every tile
//   when non-causal), through
//   a two-stage ring in shared memory (2 stages x (K + V) x 17 KB, rows
//   padded by 16 bytes so ldmatrix hits 32 distinct banks): cp.async fetches
//   tile j+1 while the tensor cores work on tile j.  K and V of a kv head are
//   never repeated in memory: the q heads of one group read the same tiles,
//   from L2;
// - the products run on the tensor cores through mma.sync m16n8k16 (bf16 in,
//   f32 accumulate), B operands fetched with ldmatrix (.trans for V).  Q
//   stays in registers for the whole block; the score accumulator is
//   re-packed in registers as the A operand of P.V, so the probabilities
//   never touch shared or device memory;
// - online softmax with the running max and sum in f32.  Probabilities are
//   rounded to bf16 for P.V (as JAX rounds them), unnormalised; the output
//   is divided by the f32 row sum at the end;
// - K/V rows past S are zero-filled (cp.async with source size 0), so a
//   masked (zero) probability never meets garbage; query rows past S are
//   computed and not stored; non-causal masks the keys past S to -inf.
// - optionally (training), the f32 log-sum-exp of each row, m + log(l), for
//   the backward; serving passes a null pointer and writes none.
// Not yet: TMA, wgmma, warp specialisation.
//
// Backward (flash-attention style, recomputing P from q, k and the lse):
//   D = rowsum(dO o O);  P = exp(scale * Q K^T - lse) under the mask;
//   dV = P^T dO;  dS = P o (dO V^T - D);  dK = scale * dS^T Q;  dQ = scale * dS K.
// P meets dO and dS meets Q and K in bf16 on the tensor cores (f32
// accumulate), as the forward rounds P for P.V; attention_bwd_plain in
// kernels/attention.py rounds at the same places.  Bound: operations,
// 2.5x the forward's (five products of 2*hd flops per unmasked pair
// against the forward's two).  Design:
// - one block of 4 warps per (64-row key tile, kv head, batch row).  The
//   block keeps its K and V tiles in shared memory and walks, for each of
//   the H/Hkv query heads of its kv head, the query tiles from the diagonal
//   down (from tile 0 when non-causal); each warp owns 16 key rows and accumulates their dK and dV in
//   registers across all those heads and tiles, so GQA is summed in place,
//   with no K/V repeat and no atomics on dK, dV;
// - dQ of a query tile gets a part from every key tile, so the blocks add
//   into an f32 (B, S, H, hd) buffer with float2 atomics; a last pass
//   scales it and rounds it to bf16.  D comes from a first pass;
// - per query tile: S^T = K Q^T (warp: 16 keys x 64 queries), P^T, dV +=
//   P^T dO, dP^T = V dO^T, dS^T, dK += dS^T Q, all with the score tiles in
//   registers re-packed as A operands as in the forward; dS goes through
//   shared memory once, transposed, for dQ = dS K (warp: 16 queries).
// Not yet: a second stage for the Q/dO tiles, wgmma, a dQ pass without
// atomics.
//
// Ring attention's backward (K6, kubernetes1_tpu/workloads/ringattention.py,
// the gradient of `_block_attn`, `_merge` and the normalise at :100-101 that
// jax.grad derives) is the same tile loop in an accumulating mode (template
// flag ACCUM, entry ktpu_ring_block_bwd_bf16): one (q block, kv block) pair
// of the ring, its P recomputed from the FINAL lse of the ring's forward and
// its D = rowsum(dO o O) from the final output, so the block's gradients are
// its exact share of the whole.  dQ takes its scale in the tile pass and
// adds into the caller's f32 buffer by the same atomics (no zeroing, no
// rounding pass); dK and dV are ADDED into caller-owned f32 buffers (the K/V
// block's accumulators, which travel around the ring with it): each (key
// tile, kv head, batch row) has one owning block, so a plain read-add-write
// suffices.  With ACCUM false the code is the one above, unchanged.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kBlockM = 64;  // query rows per block, 16 per warp
constexpr int kBlockN = 64;  // key/value rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 -> one register of two bf16, `lo` in the low half (lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

// Four 8x8 bf16 matrices; lane l addresses row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// Three blocks per SM (<= 170 registers a thread; hd=128 then spills 36
// bytes): the extra resident warps hide the K/V fetches and the softmax,
// 0.36 vs 0.43 ms at B=8, S=1024 on an H100 (chip_smoke.py shapes).
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 3)
attention_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int Hkv, float scale) {
  static_assert(HD % 16 == 0 && HD <= 128, "head_dim must be a multiple of 16, <= 128");
  constexpr int KSTEPS = HD / 16;  // k-steps of QK^T
  constexpr int DTILES = HD / 8;   // n-tiles of the output (even: ldmatrix takes two)
  constexpr int LD = HD + 8;       // padded smem row (elements)
  constexpr int CHUNKS = HD / 8;   // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Tile = __nv_bfloat16[kBlockN][LD];
  Tile* ks = reinterpret_cast<Tile*>(smem_raw);  // ks[stage], then vs[stage]
  Tile* vs = ks + 2;

  const int qt = gridDim.x - 1 - blockIdx.x;  // last tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair

  const long long q_row = static_cast<long long>(H) * HD;  // stride of s in q and o
  const long long kv_row = static_cast<long long>(Hkv) * HD;
  const __nv_bfloat16* qb = q + static_cast<long long>(b) * S * q_row + h * HD;
  const __nv_bfloat16* kb = k + static_cast<long long>(b) * S * kv_row + kvh * HD;
  const __nv_bfloat16* vb = v + static_cast<long long>(b) * S * kv_row + kvh * HD;
  __nv_bfloat16* ob = o + static_cast<long long>(b) * S * q_row + h * HD;

  const int r0 = qt * kBlockM + warp * 16 + g;  // this thread's two query rows
  const int r1 = r0 + 8;

  // Q fragments (A operand, row-major 16 x 16 per k-step), rows past S = 0.
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + t * 2;
    qf[kk][0] = r0 < S ? ld32(qb + r0 * q_row + c) : 0u;
    qf[kk][1] = r1 < S ? ld32(qb + r1 * q_row + c) : 0u;
    qf[kk][2] = r0 < S ? ld32(qb + r0 * q_row + c + 8) : 0u;
    qf[kk][3] = r1 < S ? ld32(qb + r1 * q_row + c + 8) : 0u;
  }

  float acc[DTILES][4];
#pragma unroll
  for (int n = 0; n < DTILES; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0, r1
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the running sums

  // one 64-row K tile and V tile into ring stage `st`, rows past S zeroed
  auto load_tile = [&](int j, int st) {
    for (int idx = threadIdx.x; idx < kBlockN * CHUNKS; idx += kThreads) {
      const int row = idx / CHUNKS, col = (idx % CHUNKS) * 8;
      const int kvr = j * kBlockN + row;
      const long long off = (kvr < S ? kvr : 0) * kv_row + col;
      cp_async16(&ks[st][row][col], kb + off, kvr < S);
      cp_async16(&vs[st][row][col], vb + off, kvr < S);
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  // kBlockM == kBlockN: tile qt holds the diagonal
  const int last = CAUSAL ? qt : (S + kBlockN - 1) / kBlockN - 1;
  for (int j = 0; j <= last; ++j) {
    const int kv0 = j * kBlockN;
    const int st = j & 1;
    if (j < last) load_tile(j + 1, st ^ 1);
    cp_async_commit();   // an empty group on the last tile keeps the count uniform
    cp_async_wait<1>();  // tile j has landed (tile j+1 may still be in flight)
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys: 8 n-tiles of 8 keys.
    float sc[kBlockN / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row, matrix of this lane
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int n = 0; n < kBlockN / 8; n += 2) {
        // B[k][n] = K[n][k]: matrices (keys n, dims lo), (n, hi), (n+1, lo), (n+1, hi)
        uint32_t b[4];
        ldmatrix_x4(b, &ks[st][(n + (lm >> 1)) * 8 + lr][kk * 16 + (lm & 1) * 8]);
        mma_16816(sc[n], qf[kk], b[0], b[1]);
        mma_16816(sc[n + 1], qf[kk], b[2], b[3]);
      }
    }

    // Scale in f32, mask above the diagonal (causal) or past S (non-causal),
    // update the running max.
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[n][e] * scale;
        if (j == last) {
          const int col = kv0 + n * 8 + t * 2 + (e & 1);
          const int row = e < 2 ? r0 : r1;
          if (CAUSAL ? col > row : col >= S) s = -INFINITY;
        }
        sc[n][e] = s;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {  // the 4 threads sharing a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // Every tile holds key kv0, which is unmasked (causal: kv0 <= the row's
    // index; non-causal: kv0 < S), so mx is finite.
    const float alpha0 = __expf(m0 - mx0), alpha1 = __expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < DTILES; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
      sc[n][0] = __expf(sc[n][0] - m0);
      sc[n][1] = __expf(sc[n][1] - m0);
      sc[n][2] = __expf(sc[n][2] - m1);
      sc[n][3] = __expf(sc[n][3] - m1);
      l0 += sc[n][0] + sc[n][1];
      l1 += sc[n][2] + sc[n][3];
    }

    // O += P V: the score tiles 2kk, 2kk+1 are the A operand of k-step kk.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < DTILES; n += 2) {
        // B[k][n] = V[k][d], transposed: (keys lo, dims n), (hi, n), (lo, n+1), (hi, n+1)
        uint32_t b[4];
        ldmatrix_x4_trans(b, &vs[st][kk * 16 + (lm & 1) * 8 + lr][(n + (lm >> 1)) * 8]);
        mma_16816(acc[n], pa, b[0], b[1]);
        mma_16816(acc[n + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration's prefetch
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  if (lse != nullptr && t == 0) {  // the 4 threads of a row hold the same m, l
    float* lb = lse + (static_cast<long long>(b) * H + h) * S;
    if (r0 < S) lb[r0] = m0 + logf(l0);
    if (r1 < S) lb[r1] = m1 + logf(l1);
  }
#pragma unroll
  for (int n = 0; n < DTILES; ++n) {
    const int c = n * 8 + t * 2;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + r0 * q_row + c) = pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * q_row + c) = pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int HD, bool CAUSAL>
void launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
            int H, int Hkv, float scale, cudaStream_t stream) {
  constexpr int smem = 2 * 2 * kBlockN * (HD + 8) * sizeof(__nv_bfloat16);  // 2 stages, K and V
  static bool attr_set = false;  // above 48 KB needs the opt-in, once per process
  if (!attr_set) {
    cudaFuncSetAttribute(attention_fwd_kernel<HD, CAUSAL>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attr_set = true;
  }
  const dim3 grid((S + kBlockM - 1) / kBlockM, H, B);
  attention_fwd_kernel<HD, CAUSAL><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, S, H, Hkv,
      scale);
}

// ------------------------------------------------------------------ backward

// D[b, h, s] = sum over the head's dims of dO * O, f32; one warp a (b, s, h) row.
__global__ void __launch_bounds__(256)
attention_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                           const __nv_bfloat16* __restrict__ dout, float* __restrict__ delta,
                           long long rows, int S, int H, int hd) {
  const long long row = blockIdx.x * 8ll + (threadIdx.x >> 5);  // (b * S + s) * H + h
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const __nv_bfloat16* orow = o + row * hd;
  const __nv_bfloat16* drow = dout + row * hd;
  float acc = 0.f;
  for (int c = lane * 2; c < hd; c += 64) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + c));
    const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(drow + c));
    acc += a.x * d.x + a.y * d.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long bs = row / H;
    const int h = static_cast<int>(row % H);
    const long long b = bs / S, s_ = bs % S;
    delta[(b * H + h) * S + s_] = acc;
  }
}

// dq = bf16(dq_acc * scale), 4 elements a thread a step.
__global__ void __launch_bounds__(256)
attention_bwd_dq_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ dq,
                        long long n4, float scale) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n4; i += gridDim.x * 256ll) {
    const float4 a = reinterpret_cast<const float4*>(acc)[i];
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(dq + i * 4);
    out[0] = __floats2bfloat162_rn(a.x * scale, a.y * scale);
    out[1] = __floats2bfloat162_rn(a.z * scale, a.w * scale);
  }
}

// GradT: bf16 dK, dV stored (ACCUM false) or f32 accumulators added into.
template <int HD, bool CAUSAL, bool ACCUM>
__global__ void __launch_bounds__(kThreads, 2)
attention_bwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq_acc,
                     std::conditional_t<ACCUM, float, __nv_bfloat16>* __restrict__ dk,
                     std::conditional_t<ACCUM, float, __nv_bfloat16>* __restrict__ dv,
                     int S, int H, int Hkv, float scale) {
  constexpr int KSTEPS = HD / 16;
  constexpr int DTILES = HD / 8;
  constexpr int LD = HD + 8;
  constexpr int LDS = kBlockM + 8;  // dS rows (keys), padded
  constexpr int CHUNKS = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Tile = __nv_bfloat16[kBlockN][LD];
  Tile& ks = *reinterpret_cast<Tile*>(smem_raw);
  Tile& vs = *(reinterpret_cast<Tile*>(smem_raw) + 1);
  Tile& qs = *(reinterpret_cast<Tile*>(smem_raw) + 2);
  Tile& dos = *(reinterpret_cast<Tile*>(smem_raw) + 3);
  auto& dss = *reinterpret_cast<__nv_bfloat16(*)[kBlockM][LDS]>(smem_raw + 4 * sizeof(Tile));
  float* lse_s = reinterpret_cast<float*>(smem_raw + 4 * sizeof(Tile) +
                                          sizeof(__nv_bfloat16) * kBlockM * LDS);
  float* d_s = lse_s + kBlockM;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int nq = (S + kBlockM - 1) / kBlockM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;
  const long long q_row = static_cast<long long>(H) * HD;
  const long long kv_row = static_cast<long long>(Hkv) * HD;
  const __nv_bfloat16* kb = k + static_cast<long long>(b) * S * kv_row + kvh * HD;
  const __nv_bfloat16* vb = v + static_cast<long long>(b) * S * kv_row + kvh * HD;
  const int k0 = kt * kBlockN;  // first key of the tile

  for (int idx = threadIdx.x; idx < kBlockN * CHUNKS; idx += kThreads) {
    const int row = idx / CHUNKS, col = (idx % CHUNKS) * 8;
    const int kr = k0 + row;
    const long long off = (kr < S ? kr : 0) * kv_row + col;
    cp_async16(&ks[row][col], kb + off, kr < S);
    cp_async16(&vs[row][col], vb + off, kr < S);
  }
  cp_async_commit();

  float dka[DTILES][4], dva[DTILES][4];
#pragma unroll
  for (int n = 0; n < DTILES; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const int wk = warp * 16;  // this warp's first key row in the tile

  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const __nv_bfloat16* qb = q + static_cast<long long>(b) * S * q_row + h * HD;
    const __nv_bfloat16* dob = dout + static_cast<long long>(b) * S * q_row + h * HD;
    const float* lse_b = lse + (static_cast<long long>(b) * H + h) * S;
    const float* del_b = delta + (static_cast<long long>(b) * H + h) * S;
    float* dqb = dq_acc + static_cast<long long>(b) * S * q_row + h * HD;

    for (int qt = CAUSAL ? kt : 0; qt < nq; ++qt) {
      const int q0 = qt * kBlockM;
      __syncthreads();  // the previous tile's qs, dos, dss, lse_s, d_s are no longer read
      for (int idx = threadIdx.x; idx < kBlockM * CHUNKS; idx += kThreads) {
        const int row = idx / CHUNKS, col = (idx % CHUNKS) * 8;
        const int qr = q0 + row;
        const long long off = (qr < S ? qr : 0) * q_row + col;
        cp_async16(&qs[row][col], qb + off, qr < S);
        cp_async16(&dos[row][col], dob + off, qr < S);
      }
      cp_async_commit();
      if (threadIdx.x < kBlockM) {
        const int qr = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qr < S ? lse_b[qr] : 0.f;
        d_s[threadIdx.x] = qr < S ? del_b[qr] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // S^T = K Q^T: 16 keys x 64 queries (8 n-tiles of 8 queries)
      float st[kBlockM / 8][4];
#pragma unroll
      for (int n = 0; n < kBlockM / 8; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int c = kk * 16 + t * 2;
        const uint32_t a[4] = {ld32(&ks[wk + g][c]), ld32(&ks[wk + g + 8][c]),
                               ld32(&ks[wk + g][c + 8]), ld32(&ks[wk + g + 8][c + 8])};
#pragma unroll
        for (int n = 0; n < kBlockM / 8; n += 2) {
          uint32_t bq[4];  // B[dim][query] = Q[query][dim]
          ldmatrix_x4(bq, &qs[(n + (lm >> 1)) * 8 + lr][kk * 16 + (lm & 1) * 8]);
          mma_16816(st[n], a, bq[0], bq[1]);
          mma_16816(st[n + 1], a, bq[2], bq[3]);
        }
      }
      // P^T = exp(scale * S^T - lse[query]) where query < S and key <= query
      // (causal) or key < S (non-causal), else 0
#pragma unroll
      for (int n = 0; n < kBlockM / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = n * 8 + t * 2 + (e & 1);
          const int key = k0 + wk + g + (e < 2 ? 0 : 8);
          const int qr = q0 + qi;
          const bool keep = qr < S && (CAUSAL ? key <= qr : key < S);
          st[n][e] = keep ? __expf(st[n][e] * scale - lse_s[qi]) : 0.f;
        }
      }
      // dV += P^T dO (k-steps over queries)
#pragma unroll
      for (int kk = 0; kk < kBlockM / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                                pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                                pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                                pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < DTILES; n += 2) {
          uint32_t bd[4];  // B[query][dim] = dO[query][dim]
          ldmatrix_x4_trans(bd, &dos[kk * 16 + (lm & 1) * 8 + lr][(n + (lm >> 1)) * 8]);
          mma_16816(dva[n], pa, bd[0], bd[1]);
          mma_16816(dva[n + 1], pa, bd[2], bd[3]);
        }
      }
      // dP^T = V dO^T: 16 keys x 64 queries
      float dp[kBlockM / 8][4];
#pragma unroll
      for (int n = 0; n < kBlockM / 8; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int c = kk * 16 + t * 2;
        const uint32_t a[4] = {ld32(&vs[wk + g][c]), ld32(&vs[wk + g + 8][c]),
                               ld32(&vs[wk + g][c + 8]), ld32(&vs[wk + g + 8][c + 8])};
#pragma unroll
        for (int n = 0; n < kBlockM / 8; n += 2) {
          uint32_t bd[4];  // B[dim][query] = dO[query][dim]
          ldmatrix_x4(bd, &dos[(n + (lm >> 1)) * 8 + lr][kk * 16 + (lm & 1) * 8]);
          mma_16816(dp[n], a, bd[0], bd[1]);
          mma_16816(dp[n + 1], a, bd[2], bd[3]);
        }
      }
      // dS^T = P^T o (dP^T - D[query]); its bf16 copy goes to dss[query][key]
#pragma unroll
      for (int n = 0; n < kBlockM / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = n * 8 + t * 2 + (e & 1);
          dp[n][e] = st[n][e] * (dp[n][e] - d_s[qi]);
          dss[qi][wk + g + (e < 2 ? 0 : 8)] = __float2bfloat16_rn(dp[n][e]);
        }
      }
      // dK += dS^T Q (k-steps over queries)
#pragma unroll
      for (int kk = 0; kk < kBlockM / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                                pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                                pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < DTILES; n += 2) {
          uint32_t bq[4];  // B[query][dim] = Q[query][dim]
          ldmatrix_x4_trans(bq, &qs[kk * 16 + (lm & 1) * 8 + lr][(n + (lm >> 1)) * 8]);
          mma_16816(dka[n], pa, bq[0], bq[1]);
          mma_16816(dka[n + 1], pa, bq[2], bq[3]);
        }
      }
      __syncthreads();  // dss complete

      // dQ[query] += dS K: this warp's 16 queries x HD, 16 dims at a time
      const int wq = warp * 16;
      uint32_t sa[kBlockN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        const int c = kk * 16 + t * 2;
        sa[kk][0] = ld32(&dss[wq + g][c]);
        sa[kk][1] = ld32(&dss[wq + g + 8][c]);
        sa[kk][2] = ld32(&dss[wq + g][c + 8]);
        sa[kk][3] = ld32(&dss[wq + g + 8][c + 8]);
      }
      const int qr0 = q0 + wq + g, qr1 = qr0 + 8;
#pragma unroll
      for (int n = 0; n < DTILES; n += 2) {
        float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk) {
          uint32_t bk[4];  // B[key][dim] = K[key][dim]
          ldmatrix_x4_trans(bk, &ks[kk * 16 + (lm & 1) * 8 + lr][(n + (lm >> 1)) * 8]);
          mma_16816(a0, sa[kk], bk[0], bk[1]);
          mma_16816(a1, sa[kk], bk[2], bk[3]);
        }
        const int c = n * 8 + t * 2;
        if constexpr (ACCUM) {  // no rounding pass follows: scale here
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a0[e] *= scale;
            a1[e] *= scale;
          }
        }
        if (qr0 < S) {
          atomicAdd(reinterpret_cast<float2*>(dqb + qr0 * q_row + c), make_float2(a0[0], a0[1]));
          atomicAdd(reinterpret_cast<float2*>(dqb + qr0 * q_row + c + 8), make_float2(a1[0], a1[1]));
        }
        if (qr1 < S) {
          atomicAdd(reinterpret_cast<float2*>(dqb + qr1 * q_row + c), make_float2(a0[2], a0[3]));
          atomicAdd(reinterpret_cast<float2*>(dqb + qr1 * q_row + c + 8), make_float2(a1[2], a1[3]));
        }
      }
    }
  }

  // dK (scaled) and dV of this warp's 16 keys
  auto* dkb = dk + static_cast<long long>(b) * S * kv_row + kvh * HD;
  auto* dvb = dv + static_cast<long long>(b) * S * kv_row + kvh * HD;
  const int kr0 = k0 + wk + g, kr1 = kr0 + 8;
  if constexpr (ACCUM) {  // this block owns these rows of the accumulators
    auto add2 = [](float* p, float x, float y) {
      float2 a = *reinterpret_cast<float2*>(p);
      a.x += x;
      a.y += y;
      *reinterpret_cast<float2*>(p) = a;
    };
#pragma unroll
    for (int n = 0; n < DTILES; ++n) {
      const int c = n * 8 + t * 2;
      if (kr0 < S) {
        add2(dkb + kr0 * kv_row + c, dka[n][0] * scale, dka[n][1] * scale);
        add2(dvb + kr0 * kv_row + c, dva[n][0], dva[n][1]);
      }
      if (kr1 < S) {
        add2(dkb + kr1 * kv_row + c, dka[n][2] * scale, dka[n][3] * scale);
        add2(dvb + kr1 * kv_row + c, dva[n][2], dva[n][3]);
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < DTILES; ++n) {
      const int c = n * 8 + t * 2;
      if (kr0 < S) {
        *reinterpret_cast<uint32_t*>(dkb + kr0 * kv_row + c) = pack_bf16(dka[n][0] * scale, dka[n][1] * scale);
        *reinterpret_cast<uint32_t*>(dvb + kr0 * kv_row + c) = pack_bf16(dva[n][0], dva[n][1]);
      }
      if (kr1 < S) {
        *reinterpret_cast<uint32_t*>(dkb + kr1 * kv_row + c) = pack_bf16(dka[n][2] * scale, dka[n][3] * scale);
        *reinterpret_cast<uint32_t*>(dvb + kr1 * kv_row + c) = pack_bf16(dva[n][2], dva[n][3]);
      }
    }
  }
}

template <int HD, bool CAUSAL, bool ACCUM>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, float* dq_acc, void* dk, void* dv,
                       int B, int S, int H, int Hkv, float scale, cudaStream_t stream) {
  using GradT = std::conditional_t<ACCUM, float, __nv_bfloat16>;
  constexpr int smem = 4 * kBlockN * (HD + 8) * sizeof(__nv_bfloat16) +
                       kBlockM * (kBlockM + 8) * sizeof(__nv_bfloat16) + 2 * kBlockM * sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_bwd_kernel<HD, CAUSAL, ACCUM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((S + kBlockN - 1) / kBlockN, Hkv, B);
  attention_bwd_kernel<HD, CAUSAL, ACCUM><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta,
      dq_acc, static_cast<GradT*>(dk), static_cast<GradT*>(dv), S, H, Hkv, scale);
  return cudaGetLastError();
}

template <bool CAUSAL>
int launch_hd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
              int H, int Hkv, int hd, float scale, cudaStream_t st) {
  switch (hd) {
    case 16: launch<16, CAUSAL>(q, k, v, o, lse, B, S, H, Hkv, scale, st); break;
    case 32: launch<32, CAUSAL>(q, k, v, o, lse, B, S, H, Hkv, scale, st); break;
    case 64: launch<64, CAUSAL>(q, k, v, o, lse, B, S, H, Hkv, scale, st); break;
    case 128: launch<128, CAUSAL>(q, k, v, o, lse, B, S, H, Hkv, scale, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool CAUSAL, bool ACCUM = false>
cudaError_t launch_bwd_hd(const void* q, const void* k, const void* v, const void* dout,
                          const float* l, const float* dl, float* acc, void* dk, void* dv,
                          int B, int S, int H, int Hkv, int hd, float scale, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_bwd<16, CAUSAL, ACCUM>(q, k, v, dout, l, dl, acc, dk, dv, B, S, H, Hkv, scale, st);
    case 32: return launch_bwd<32, CAUSAL, ACCUM>(q, k, v, dout, l, dl, acc, dk, dv, B, S, H, Hkv, scale, st);
    case 64: return launch_bwd<64, CAUSAL, ACCUM>(q, k, v, dout, l, dl, acc, dk, dv, B, S, H, Hkv, scale, st);
    case 128: return launch_bwd<128, CAUSAL, ACCUM>(q, k, v, dout, l, dl, acc, dk, dv, B, S, H, Hkv, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_delta(const void* o, const void* dout, void* delta, int B, int S, int H,
                         int hd, cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * S * H;
  attention_bwd_delta_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      static_cast<float*>(delta), rows, S, H, hd);
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, S, Hkv, hd); bf16 contiguous; H % Hkv == 0;
// hd in {16, 32, 64, 128}.  lse: null, or (B, H, S) f32 to receive each
// row's log-sum-exp of the scaled scores (for the backward).  causal: 1
// keeps key <= query (K1), 0 keeps every key < S (K7a).
extern "C" int ktpu_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int B, int S, int H, int Hkv, int hd,
                                       float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return causal ? launch_hd<true>(q, k, v, o, l, B, S, H, Hkv, hd, scale, st)
                : launch_hd<false>(q, k, v, o, l, B, S, H, Hkv, hd, scale, st);
}

// Shapes as the forward; o, dout: (B, S, H, hd) bf16; lse: (B, H, S) f32 from
// the forward; scratch: delta (B, H, S) f32 and dq_acc (B, S, H, hd) f32
// (zeroed here); out: dq like q, dk and dv like k, bf16; causal as the
// forward.  Three launches: D, the tile pass, the dQ rounding.
extern "C" int ktpu_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       void* delta, void* dq_acc, void* dq, void* dk, void* dv,
                                       int B, int S, int H, int Hkv, int hd, float scale,
                                       int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * S * H;
  cudaError_t e = cudaMemsetAsync(dq_acc, 0, sizeof(float) * rows * hd, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((e = launch_delta(o, dout, delta, B, S, H, hd, st)) != cudaSuccess) return static_cast<int>(e);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* acc = static_cast<float*>(dq_acc);
  e = causal ? launch_bwd_hd<true>(q, k, v, dout, l, dl, acc, dk, dv, B, S, H, Hkv, hd, scale, st)
             : launch_bwd_hd<false>(q, k, v, dout, l, dl, acc, dk, dv, B, S, H, Hkv, hd, scale, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n4 = rows * hd / 4;
  const long long blocks = (n4 + 255) / 256;
  attention_bwd_dq_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
      acc, static_cast<__nv_bfloat16*>(dq), n4, scale);
  return static_cast<int>(cudaGetLastError());
}

// One (q block, kv block) pair of ring attention's backward (K6), both
// blocks S rows long: shapes as the backward above; lse (B, H, S) f32 the
// ring's final log-sum-exp; delta (B, H, S) f32, D = rowsum(dO o O) of the
// ring's final output, computed here first when o is not null (the ring's
// first step) and read as given otherwise.  Adds: dq_acc (B, S, H, hd) f32
// += scale * dS K; dk_acc, dv_acc (B, S, Hkv, hd) f32 += scale * dS^T Q,
// P^T dO.  causal: 1 for the diagonal block (key <= query within the
// block), 0 for a block wholly behind (or any block of a non-causal ring).
// One launch (two when o is given).
extern "C" int ktpu_ring_block_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        void* delta, void* dq_acc, void* dk_acc, void* dv_acc,
                                        int B, int S, int H, int Hkv, int hd, float scale,
                                        int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (o != nullptr && (e = launch_delta(o, dout, delta, B, S, H, hd, st)) != cudaSuccess)
    return static_cast<int>(e);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* acc = static_cast<float*>(dq_acc);
  e = causal
          ? launch_bwd_hd<true, true>(q, k, v, dout, l, dl, acc, dk_acc, dv_acc, B, S, H, Hkv, hd, scale, st)
          : launch_bwd_hd<false, true>(q, k, v, dout, l, dl, acc, dk_acc, dv_acc, B, S, H, Hkv, hd, scale, st);
  return static_cast<int>(e);
}
