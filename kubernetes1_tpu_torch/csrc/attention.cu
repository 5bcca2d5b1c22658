// K1 causal GQA attention for Hopper (forward).
//
// Replaces: kubernetes1_tpu/workloads/llama.py `attention`, i.e.
// jax.nn.dot_product_attention(q, k, v, is_causal=True), which XLA lowers
// to QK^T (f32 accumulate) * hd^-0.5, causal mask, f32 softmax, probs cast
// to bf16, P.V.  q: (B, S, H, hd), k/v: (B, S, Hkv, hd), bf16; query head n
// reads kv head n / (H / Hkv), as JAX's (B, T, K, G, hd) reshape does.
//
// Bound on the H100: operations at the decode server's shapes.  4*hd flops
// per unmasked (query, key) pair: at B=8, S=1024, H=32, hd=128 that is
// ~69 GFLOP against ~168 MB of q, k, v and o, about 400 flops per byte,
// above the card's ~295 bf16 flops per byte.
//
// Design (flash attention, forward only, no KV cache, as the JAX engine):
// - one block of 4 warps per (64-row query tile, q head, batch row); each
//   warp owns 16 query rows.  Tiles are launched last-first, so the long
//   causal rows start early and the short ones fill the tail;
// - the block walks 64-row K/V tiles only up to the causal diagonal, through
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
//   computed and not stored.
// Not yet: TMA, wgmma, warp specialisation.

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
template <int HD>
__global__ void __launch_bounds__(kThreads, 3)
attention_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int S, int H, int Hkv, float scale) {
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

  for (int j = 0; j <= qt; ++j) {  // kBlockM == kBlockN: tile qt holds the diagonal
    const int kv0 = j * kBlockN;
    const int st = j & 1;
    if (j < qt) load_tile(j + 1, st ^ 1);
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

    // Scale in f32, mask above the diagonal, update the running max.
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[n][e] * scale;
        if (j == qt) {
          const int col = kv0 + n * 8 + t * 2 + (e & 1);
          const int row = e < 2 ? r0 : r1;
          if (col > row) s = -INFINITY;
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
    // Every row sees key kv0 <= its own index in every tile, so mx is finite.
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
#pragma unroll
  for (int n = 0; n < DTILES; ++n) {
    const int c = n * 8 + t * 2;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + r0 * q_row + c) = pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * q_row + c) = pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int HD>
void launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
            int Hkv, float scale, cudaStream_t stream) {
  constexpr int smem = 2 * 2 * kBlockN * (HD + 8) * sizeof(__nv_bfloat16);  // 2 stages, K and V
  static bool attr_set = false;  // above 48 KB needs the opt-in, once per process
  if (!attr_set) {
    cudaFuncSetAttribute(attention_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attr_set = true;
  }
  const dim3 grid((S + kBlockM - 1) / kBlockM, H, B);
  attention_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, H, Hkv, scale);
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, S, Hkv, hd); bf16 contiguous; H % Hkv == 0;
// hd in {16, 32, 64, 128}.
extern "C" int ktpu_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                       int B, int S, int H, int Hkv, int hd, float scale,
                                       void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: launch<16>(q, k, v, o, B, S, H, Hkv, scale, st); break;
    case 32: launch<32>(q, k, v, o, B, S, H, Hkv, scale, st); break;
    case 64: launch<64>(q, k, v, o, B, S, H, Hkv, scale, st); break;
    case 128: launch<128>(q, k, v, o, B, S, H, Hkv, scale, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
