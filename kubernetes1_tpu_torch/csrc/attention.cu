// K1 causal GQA attention and K7a non-causal attention for Hopper, and the
// block forward and accumulating backward of K6 ring attention: one forward
// tile loop and one two-pass backward, written for sm_90a with wgmma, TMA
// and mbarriers.  `causal` picks the mask.
//
// Replaces: kubernetes1_tpu/workloads/llama.py `attention`, i.e.
// jax.nn.dot_product_attention(q, k, v, is_causal=True) (:147), and
// kubernetes1_tpu/workloads/bert.py:129, jax.nn.dot_product_attention(q, k,
// v) with no mask, which XLA lowers to QK^T (f32 accumulate) * hd^-0.5, the
// mask, f32 softmax, probabilities cast to bf16, P.V; and the gradient that
// jax.grad derives from them.  Ring attention (K6,
// kubernetes1_tpu/workloads/ringattention.py:29-59, `_block_attn`, `_merge`
// and the normalise at :100-101) runs the forward with the lse for each
// (q block, kv block) pair and the backward in an accumulating mode (ACCUM).
// q: (B, S, H, hd), k/v: (B, S, Hkv, hd), bf16; query head n reads kv head
// n / (H / Hkv), as JAX's (B, T, K, G, hd) reshape does (BERT: H == Hkv).
//
// The two masks: causal keeps key <= query, which also hides every key past
// S from a real query row.  Non-causal walks every K/V tile, so the keys
// past S in the last tile (zero-filled by TMA: a zero key scores 0, not
// -inf) are masked to -inf explicitly, in the forward and in both backward
// passes.
//
// Bound on the H100: operations.  The forward does 4*hd flops per unmasked
// (query, key) pair: at the decode server's B=8, S=1024, H=32, hd=128 that
// is ~69 GFLOP against ~168 MB, ~400 flops per byte, above the card's ~295
// bf16 flops per byte (0.070 ms at 989 TFLOP/s).  BERT-large's B=32,
// S=512, H=16, hd=64 has ~256 flops per byte, just under it.  The backward's
// algorithm needs 5 products (10*hd flops per pair); this design runs 7
// (S and dP twice, once in each pass): the price of a dQ without atomics,
// so it can reach at most 5/7 of the bound.
//
// What it replaced (PRs 1-6): mma.sync m16n8k16 tile loops (Ampere's
// instruction) fed by cp.async, every warp re-reading K and V through
// ldmatrix, and a backward whose blocks added each 64 x hd f32 dQ tile into
// a (B, S, H, hd) f32 scratch with float2 atomics: 2.2 GB of read-modify-
// write a call at the Llama train shape, 17.2 GB for a ring block of 8192,
// and a result that changed with the blocks' order.
//
// Design (FlashAttention-3's shape, kept simple).  Every kernel is a block
// of one producer warpgroup (warpgroup 0: setmaxnreg down to 24 registers,
// one thread issues every TMA load) and NC consumer warpgroups, each owning
// 64 rows of the block's tile: two in the forward and the dK/dV pass
// (setmaxnreg up to 240, nearly all of which the dK/dV pass uses for dK,
// dV of 64 keys and two score tiles), three in the dQ pass (up to 160).
// One block fills an SM's registers.  A consumer warpgroup's index is a
// compile-time constant in each of its copies, so every shared-memory
// descriptor is warp-uniform (uniform registers).  Tiles are loaded by TMA
// (cp.async.bulk.tensor, tensor maps of (B, S, Hx, hd) as dims (hd, Hx, S,
// B), box (min(hd, 64), 1, rows, 1)), 128B-swizzled (64B, 32B at hd 32,
// 16: the row of a box is the swizzle's width; hd 128 loads two 64-column
// parts), rows past S zero-filled; the expected byte count of a barrier is
// the whole box.  Streamed tiles go through a ring of kStages = 2 stages
// with full (TMA complete_tx) and empty (one arrival per consumer warp)
// mbarriers, phase parity tracked per round.  The products are wgmma
// m64nNk16 (bf16 in, f32 accumulate): score products read both operands
// from shared memory, K-major (SS); products into O, dV, dK and dQ take the
// probabilities or dS from registers, re-packed from the score
// accumulator's layout (which is the register A layout of m64nNk16), and
// the other operand MN-major from shared memory, with the instruction's
// transpose (RS).  The accumulators are never read between
// wgmma.commit_group and its wait_group (register fences order them), and
// the kernels make no calls, so ptxas serialises no wgmma (a device printf
// made it serialise every one).  Grids put the tile index slowest, so the
// longest tiles of every head launch first and the short ones fill the tail.
// The elementwise work between the products is what the tile loops wait
// on, so it is kept short: exponentials in base 2 with the scale folded in
// (exp(scale s - lse) = 2^(s scale log2 e - lse log2 e), one FFMA and one
// ex2.approx.ftz a score), and masks as selects on values computed for
// every score, with no branch (a masked score's exponential or lse may be
// anything; the select drops it).
// - Forward: one block per (128 query rows, q head, batch row), the last
//   rows first.  Q loaded once; K/V tiles of 128 keys through the ring, K
//   and V on separate barriers.  S = Q K^T (SS, m64n128), online softmax in
//   f32 (mask on the tiles that reach the diagonal or S, running max of
//   the raw scores and sum), P rounded to bf16 in registers, O += P V (RS, V
//   as the MN-major B operand).  O / l stored as bf16 from registers; the
//   lse m scale + log(l) when asked (training, the ring).  Q 32 KB plus
//   2 x (K + V) 64 KB = 161 KB of shared memory at hd 128.
// - Backward: D = rowsum(dO o O) (a small pass), then two tile passes that
//   write every gradient once, with no atomics anywhere, so the result does
//   not depend on the blocks' order (chip_smoke.py checks the bits):
//   * dK/dV pass: one block per (128 keys, kv head, batch row); K and V
//     loaded once; the producer streams Q, dO (64 query rows each) and
//     their lse and D over the G query heads of the kv head and the query
//     tiles from the diagonal down (every tile when non-causal).  lse and D
//     come as 1-D TMA boxes of 68 values from the 4-value boundary at or
//     before the tile's first row (a TMA start must be 16-byte aligned).
//     Per tile: S^T = K Q^T and dP^T = V dO^T (SS, m64n64), P^T and dS^T =
//     P^T o (dP^T - D) in registers, dV += P^T dO and dK += dS^T Q (RS).
//     GQA sums in place; dK (scaled), dV stored once as bf16, or, with
//     ACCUM, added into the ring's f32 accumulators by their one owner.
//     131 KB of shared memory at hd 128.
//   * dQ pass: one block per (192 query rows, q head, batch row), the last
//     rows first; Q, dO kept (lse and D of a thread's two rows in
//     registers), K/V tiles of 64 keys streamed up to the diagonal.  Per
//     tile: S = Q K^T, dP = dO V^T (SS), P and dS in registers, dQ += dS K
//     (RS).  dQ scaled, stored once as bf16, or, with ACCUM, added into the
//     caller's f32 buffer by its one owner.  161 KB at hd 128.
//   P meets dO and dS meets Q and K in bf16 (f32 accumulate), as the
//   forward rounds P for P.V; attention_bwd_dkdv_plain and
//   attention_bwd_dq_plain in kernels/attention.py round at the same
//   places.  A consumer warpgroup skips (but still releases) a tile whose
//   every query lies before every key it owns.
// - Every head dim of HEAD_DIMS (16, 32, 64, 128) runs this design; only
//   the swizzle width and the number of column parts differ.
// - Host side: the tensor maps are encoded on every call with
//   cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no
//   -lcuda), and passed as __grid_constant__ CUtensorMap parameters.
// Measured against the plain versions, the library (SDPA) and the PR 6
// loops in PERF.md (chip_smoke.py on one H100).  Tried on the card and
// left out, slower or no faster: three consumer warpgroups in the forward;
// three stages; issuing the next tile's products behind the current ones
// within a warpgroup (ptxas then serialises wgmma, advisories C7511-C7520,
// or the dK/dV pass spills); masks computed on edge tiles only; the two
// consumer warpgroups in ping-pong on named barriers; interleaving the
// independent products' k-steps.  Not yet: a persistent scheduler (one
// block per SM walking tiles, so an epilogue overlaps the next tile's
// loads), the softmax overlapped with the next tile's products (a second
// score accumulator where registers allow), TMA stores of O and the
// gradients, the dQ pass folded into the dK/dV pass's schedule (it would
// need atomics or a reduction across a cluster's shared memory).

#include <cuda.h>  // CUtensorMap and its enums (types only: the driver is reached at run time)

#include <type_traits>

#include "common.cuh"

namespace {

using ktpu::mbar_arrive;
using ktpu::mbar_expect_tx;
using ktpu::mbar_init;
using ktpu::mbar_init_fence;
using ktpu::mbar_wait;
using ktpu::smem_addr;

using bf16 = __nv_bfloat16;

constexpr int kStages = 2;                        // depth of every TMA ring
constexpr int kProducerRegs = 24;

// A block of one producer warpgroup and NC consumer warpgroups (64 rows of
// a tile each); the producer's registers go to the consumers.
template <int NC>
struct Roles {
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kConsumerRegs = (65536 / 128 - kProducerRegs) / NC / 8 * 8;
};

// Consumer warpgroups of each kernel: the dK/dV pass needs 240 registers
// a thread (dK, dV of 64 keys and the two score tiles), so it runs two;
// the dQ pass fits 160 and runs three (faster than two on the H100); the
// forward runs two (three measured slower).
constexpr int kFwdWGs = 2, kKvWGs = 2, kDqWGs = 3;
constexpr int kFwdRows = 64 * kFwdWGs, kFwdKeys = 128;  // forward: query rows a block, keys a tile
constexpr int kKvRows = 64 * kKvWGs, kKvQueries = 64;   // dK/dV pass: keys a block, queries a tile
constexpr int kDqRows = 64 * kDqWGs, kDqKeys = 64;      // dQ pass: query rows a block, keys a tile
constexpr int kStatBox = kKvQueries + 4;          // dK/dV pass: lse and D values a load,
constexpr int kStatSlot = (kStatBox * 4 + 127) / 128 * 128;  // in a 128-byte aligned slot

// One head dim's tiles in shared memory: each tile is kParts column parts
// of rows x kCols, a row of a part kSpan bytes (the swizzle's width).
template <int HD>
struct Tile {
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 128, "head_dim in {16, 32, 64, 128}");
  static constexpr int kSpan = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int kParts = HD * 2 / kSpan;
  static constexpr int kCols = kSpan / 2;
  static constexpr uint64_t kLayout = kSpan == 128 ? 1 : kSpan == 64 ? 2 : 3;  // wgmma swizzle code
  static constexpr uint32_t kGroup = 8 * kSpan;  // bytes of 8 rows of a part
  template <int R>
  __host__ __device__ static constexpr uint32_t bytes() { return R * HD * 2; }
};

// The dynamic shared memory's first 1024-byte boundary: a 128B-swizzled
// tile's atoms (8 rows of 128 bytes) must start on one.
__device__ __forceinline__ uint32_t smem_base(const void* raw) {
  return (smem_addr(raw) + 1023u) & ~1023u;
}

// --------------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// R rows from `row0` of head `head`, batch row `b`, every column part.
template <int HD, int R>
__device__ __forceinline__ void load_rows(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                          int head, int row0, int b) {
  using T = Tile<HD>;
#pragma unroll
  for (int p = 0; p < T::kParts; ++p)
    tma_load_4d(dst + p * R * T::kSpan, map, bar, p * T::kCols, head, row0, b);
}

// ------------------------------------------------------------------- wgmma

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32 | layout << 62;
}

// K-major operand: rows [r0, r0 + 64 or N) of an R-row tile, head-dim
// columns [16 kk, 16 kk + 16): the start moves within the swizzle atom.
template <int HD, int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  using T = Tile<HD>;
  const int col = kk * 16;
  return smem_desc(tile + (col / T::kCols) * (R * T::kSpan) + r0 * T::kSpan + (col % T::kCols) * 2,
                   16, T::kGroup, T::kLayout);
}

// MN-major operand: rows [16 kk, 16 kk + 16) of an R-row tile (the
// product's k), the kCols columns of part p (its n, one swizzle atom wide,
// so the offset between atoms along n is never used; both offsets are set
// to the 8-row stride along k).
template <int HD, int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int p, int kk) {
  using T = Tile<HD>;
  return smem_desc(tile + p * (R * T::kSpan) + kk * 16 * T::kSpan, T::kGroup, T::kGroup,
                   T::kLayout);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Ties each accumulator register to this point of the instruction stream:
// read after wgmma.wait_group, never between commit and wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Runs f(std::integral_constant<int, c>) for this thread's consumer
// warpgroup c < NC (warpgroup c + 1 of the block): c is a constant in each
// copy, so that every shared-memory descriptor is warp-uniform.
template <int NC, typename F>
__device__ __forceinline__ void for_consumer(F&& f) {
  const int c = threadIdx.x / 128 - 1;
  if (c == 0) f(std::integral_constant<int, 0>{});
  else if constexpr (NC == 2) f(std::integral_constant<int, 1>{});
  else if (c == 1) f(std::integral_constant<int, 1>{});
  else f(std::integral_constant<int, 2>{});
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// D (64 x 64, f32) {=, +=} A (64 x 16, smem) B^T (B: 64 x 16, smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, f32) {=, +=} A (64 x 16, smem) B^T (B: 128 x 16, smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 16, f32) {=, +=} A (64 x 16, registers) B (16 x 16, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D (64 x 32, f32) {=, +=} A (64 x 16, registers) B (16 x 32, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) {=, +=} A (64 x 16, registers) B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}


template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db, 1);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db, 1);
  else wgmma_rs_n64(d, a, db, 1);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (ex2.approx), subnormal results flushed
// to 0.  Softmax in base 2 with the scale folded in: exp(scale (s - m)) =
// 2^(s scale log2(e) - m scale log2(e)), one FFMA and this per score.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 -> one register of two bf16, `lo` in the low half (lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The score accumulator (64 x 16 kt columns, per thread 8 kt values) as
// the register A operand of k-steps 0..kt-1: columns 16 kk .. 16 kk + 15
// are n8 blocks 2 kk and 2 kk + 1, the same thread's values.
template <int KT>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KT][4], const float (&s)[KT * 8]) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// ------------------------------------------------------------------ forward

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(Roles<kFwdWGs>::kThreads, 1)
attention_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int Hkv, float scale) {
  using T = Tile<HD>;
  constexpr int BM = kFwdRows, BN = kFwdKeys;
  static_assert(BM == BN, "every tile up to the diagonal holds a key before every row");
  constexpr uint32_t QB = T::template bytes<BM>(), KB = T::template bytes<BN>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = smem_base(smem_raw);
  const uint32_t sk = sq + QB, sv = sk + kStages * KB;
  const uint32_t q_full = sv + kStages * KB;  // then k_full[], v_full[], empty[]
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages, empty = v_full + 8 * kStages;

  // the query tile varies slowest: the last (longest causal) rows of every
  // head launch first, the short ones fill the tail
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / Hkv);
  const int q0 = qt * BM;
  const int n_tiles = ((CAUSAL ? min(q0 + BM, S) : S) + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kFwdWGs * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, QB);
      load_rows<HD, BM>(&tm_q, sq, q_full, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(empty + 8 * st, ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * st, KB);
        load_rows<HD, BN>(&tm_k, sk + st * KB, k_full + 8 * st, kvh, j * BN, b);
        mbar_expect_tx(v_full + 8 * st, KB);
        load_rows<HD, BN>(&tm_v, sv + st * KB, v_full + 8 * st, kvh, j * BN, b);
      }
    }
  } else {  // consumers: warpgroup c owns query rows q0 + 64 c .. q0 + 64 c + 63
    setmaxnreg_inc<Roles<kFwdWGs>::kConsumerRegs>();
    for_consumer<kFwdWGs>([&](auto wg) {
      constexpr int c = decltype(wg)::value;
      const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
      const int g = lane / 4, t = lane % 4;  // accumulator row group / column pair
      const int r0 = q0 + 64 * c + 16 * warp + g, r1 = r0 + 8;  // this thread's two rows

      float acc[T::kParts][T::kCols / 2];
#pragma unroll
      for (int p = 0; p < T::kParts; ++p)
#pragma unroll
        for (int i = 0; i < T::kCols / 2; ++i) acc[p][i] = 0.f;
      const float sl2 = scale * kLog2e;
      float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0, r1 (raw scores)
      float l0 = 0.f, l1 = 0.f;              // this thread's part of the running sums

      mbar_wait(q_full, 0);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages, ph = (j / kStages) & 1;
        const int kv0 = j * BN;
        float s[BN / 2];  // S = Q K^T: rows r0 (e < 2), r1; key kv0 + 8 n + 2 t + (e & 1)
        mbar_wait(k_full + 8 * st, ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss_n128(s, desc_k<HD, BM>(sq, 64 * c, kk), desc_k<HD, BN>(sk + st * KB, 0, kk), kk);
        wgmma_commit();
        wgmma_wait();
        reg_fence(s);

        // Mask above the diagonal (causal) or past S (non-causal) on the
        // tiles that reach them, update the running max of the raw scores.
        const bool edge = CAUSAL ? kv0 + BN - 1 > q0 + 64 * c : kv0 + BN > S;
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * n + e];
            if (edge) {
              const int col = kv0 + 8 * n + 2 * t + (e & 1);
              if (CAUSAL ? col > (e < 2 ? r0 : r1) : col >= S) x = -INFINITY;
            }
            s[4 * n + e] = x;
          }
          mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {  // the 4 threads sharing a row
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        // Every tile holds key kv0, which is unmasked (causal: kv0 <= the
        // block's first row, as BM == BN; non-causal: kv0 < S), so mx is finite.
        const float alpha0 = exp2_ftz((m0 - mx0) * sl2), alpha1 = exp2_ftz((m1 - mx1) * sl2);
        m0 = mx0;
        m1 = mx1;
        const float ms0 = m0 * sl2, ms1 = m1 * sl2;
        l0 *= alpha0;
        l1 *= alpha1;
#pragma unroll
        for (int p = 0; p < T::kParts; ++p)
#pragma unroll
          for (int n = 0; n < T::kCols / 8; ++n) {
            acc[p][4 * n + 0] *= alpha0;
            acc[p][4 * n + 1] *= alpha0;
            acc[p][4 * n + 2] *= alpha1;
            acc[p][4 * n + 3] *= alpha1;
          }
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
          s[4 * n + 0] = exp2_ftz(fmaf(s[4 * n + 0], sl2, -ms0));
          s[4 * n + 1] = exp2_ftz(fmaf(s[4 * n + 1], sl2, -ms0));
          s[4 * n + 2] = exp2_ftz(fmaf(s[4 * n + 2], sl2, -ms1));
          s[4 * n + 3] = exp2_ftz(fmaf(s[4 * n + 3], sl2, -ms1));
          l0 += s[4 * n + 0] + s[4 * n + 1];
          l1 += s[4 * n + 2] + s[4 * n + 3];
        }
        uint32_t pa[BN / 16][4];  // P in bf16, the A operand of P V
        pack_a<BN / 16>(pa, s);

        mbar_wait(v_full + 8 * st, ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int p = 0; p < T::kParts; ++p)
            wgmma_rs<T::kCols>(acc[p], pa[kk], desc_mn<HD, BN>(sv + st * KB, p, kk));
        wgmma_commit();
        wgmma_wait();
#pragma unroll
        for (int p = 0; p < T::kParts; ++p) reg_fence(acc[p]);
        if (lane == 0) mbar_arrive(empty + 8 * st);  // this warp no longer reads stage st
      }

#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      if (lse != nullptr && t == 0) {  // the 4 threads of a row hold the same m, l
        float* lb = lse + (static_cast<long long>(b) * H + h) * S;
        if (r0 < S) lb[r0] = m0 * scale + logf(l0);
        if (r1 < S) lb[r1] = m1 * scale + logf(l1);
      }
      const long long q_row = static_cast<long long>(H) * HD;  // stride of s in o
      bf16* ob = o + static_cast<long long>(b) * S * q_row + h * HD;
#pragma unroll
      for (int p = 0; p < T::kParts; ++p)
#pragma unroll
        for (int n = 0; n < T::kCols / 8; ++n) {
          const int col = p * T::kCols + 8 * n + 2 * t;
          if (r0 < S)
            *reinterpret_cast<uint32_t*>(ob + r0 * q_row + col) =
                pack_bf16(acc[p][4 * n] * inv0, acc[p][4 * n + 1] * inv0);
          if (r1 < S)
            *reinterpret_cast<uint32_t*>(ob + r1 * q_row + col) =
                pack_bf16(acc[p][4 * n + 2] * inv1, acc[p][4 * n + 3] * inv1);
        }
    });
  }
}

// ------------------------------------------------------------------ backward

// D[b, h, s] = sum over the head's dims of dO * O, f32; one warp a (b, s, h) row.
__global__ void __launch_bounds__(256)
attention_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                           float* __restrict__ delta, long long rows, int S, int H, int hd) {
  const long long row = blockIdx.x * 8ll + (threadIdx.x >> 5);  // (b * S + s) * H + h
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* orow = o + row * hd;
  const bf16* drow = dout + row * hd;
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

// Row `row` (< S), columns col, col + 1 of a gradient: stored as bf16, or
// added into an f32 accumulator (ACCUM: the caller's buffer, which this
// thread alone writes).
template <bool ACCUM>
__device__ __forceinline__ void put2(std::conditional_t<ACCUM, float, bf16>* p, float x, float y) {
  if constexpr (ACCUM) {
    float2 a = *reinterpret_cast<float2*>(p);
    a.x += x;
    a.y += y;
    *reinterpret_cast<float2*>(p) = a;
  } else {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
  }
}

// dK/dV pass: one block per (kKvRows keys, kv head, batch row).
template <int HD, bool CAUSAL, bool ACCUM>
__global__ void __launch_bounds__(Roles<kKvWGs>::kThreads, 1)
attention_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_lse,
                          const __grid_constant__ CUtensorMap tm_delta,
                          std::conditional_t<ACCUM, float, bf16>* __restrict__ dk,
                          std::conditional_t<ACCUM, float, bf16>* __restrict__ dv,
                          int S, int H, int Hkv, float scale) {
  using T = Tile<HD>;
  constexpr int BN = kKvRows, BM = kKvQueries;
  constexpr uint32_t KB = T::template bytes<BN>(), QB = T::template bytes<BM>();
  // A tile's lse or D: a box of kStatBox values from a 16-byte aligned
  // start (a TMA coordinate's bytes must be).
  constexpr uint32_t RB = kStatSlot;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sk = smem_base(smem_raw), sv = sk + KB;
  const uint32_t sq = sv + KB, sdo = sq + kStages * QB;  // [stage]
  const uint32_t sl = sdo + kStages * QB, sd = sl + kStages * RB;
  const uint32_t kv_full = sd + kStages * RB;  // then full[], empty[]
  const uint32_t full = kv_full + 8, empty = full + 8 * kStages;

  const int kt = blockIdx.z, kvh = blockIdx.x, b = blockIdx.y;  // the longest key tiles first
  const int G = H / Hkv;
  const int k0 = kt * BN;
  const int qt0 = CAUSAL ? k0 / BM : 0;  // the first query tile with a query >= k0
  const int per = (S + BM - 1) / BM - qt0, total = G * per;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kKvWGs * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * KB);
      load_rows<HD, BN>(&tm_k, sk, kv_full, kvh, k0, b);
      load_rows<HD, BN>(&tm_v, sv, kv_full, kvh, k0, b);
      for (int i = 0; i < total; ++i) {
        const int st = i % kStages;
        const int h = kvh * G + i / per, q0 = (qt0 + i % per) * BM;
        mbar_wait(empty + 8 * st, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, 2 * QB + 2 * kStatBox * sizeof(float));
        load_rows<HD, BM>(&tm_q, sq + st * QB, full + 8 * st, h, q0, b);
        load_rows<HD, BM>(&tm_do, sdo + st * QB, full + 8 * st, h, q0, b);
        // lse and D of rows (b, h, q0 ..), from the 4-value boundary at or
        // before them: rows past S read the next row's values (or zeros at
        // the end); their P is masked to 0.
        const int at = ((b * H + h) * S + q0) & ~3;
        tma_load_1d(sl + st * RB, &tm_lse, full + 8 * st, at);
        tma_load_1d(sd + st * RB, &tm_delta, full + 8 * st, at);
      }
    }
  } else {  // consumers: warpgroup c owns keys k0 + 64 c .. k0 + 64 c + 63
    setmaxnreg_inc<Roles<kKvWGs>::kConsumerRegs>();
    for_consumer<kKvWGs>([&](auto wg) {
      constexpr int c = decltype(wg)::value;
      const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
      const int g = lane / 4, t = lane % 4;
      const int kc0 = k0 + 64 * c;
      const int key0 = kc0 + 16 * warp + g;  // this thread's keys: key0 (e < 2), key0 + 8
      const float sl2 = scale * kLog2e;

      float dka[T::kParts][T::kCols / 2], dva[T::kParts][T::kCols / 2];
#pragma unroll
      for (int p = 0; p < T::kParts; ++p)
#pragma unroll
        for (int i = 0; i < T::kCols / 2; ++i) dka[p][i] = dva[p][i] = 0.f;

      mbar_wait(kv_full, 0);
      for (int i = 0; i < total; ++i) {
        const int st = i % kStages, ph = (i / kStages) & 1;
        const int q0 = (qt0 + i % per) * BM;
        // row q0's lse and D in the stage's boxes
        const int shift = ((b * H + kvh * G + i / per) * S + q0) & 3;
        const float* ls = reinterpret_cast<const float*>(smem_raw + (sl - smem_addr(smem_raw)) + st * RB) + shift;
        const float* ds = ls + (sd - sl) / 4;
        mbar_wait(full + 8 * st, ph);
        if (!(CAUSAL && q0 + BM <= kc0)) {  // else every query of the tile precedes every key
          // S^T = K Q^T and dP^T = V dO^T: keys x queries; query q0 + 8 n + 2 t + (e & 1)
          float s[BM / 2], dp[BM / 2];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            wgmma_ss_n64(s, desc_k<HD, BN>(sk, 64 * c, kk), desc_k<HD, BM>(sq + st * QB, 0, kk), kk);
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            wgmma_ss_n64(dp, desc_k<HD, BN>(sv, 64 * c, kk), desc_k<HD, BM>(sdo + st * QB, 0, kk), kk);
          wgmma_commit();
          wgmma_wait();
          reg_fence(s);
          reg_fence(dp);
          // P^T = exp(scale S^T - lse[query]) where query < S and key <= query
          // (causal) or key < S (non-causal), else 0; dS^T = P^T o (dP^T - D).
          // Computed for every entry and then selected: no branch.
#pragma unroll
          for (int n = 0; n < BM / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qi = 8 * n + 2 * t + (e & 1);
              const int q = q0 + qi, key = key0 + (e < 2 ? 0 : 8);
              const bool keep = q < S && (CAUSAL ? key <= q : key < S);
              float p = exp2_ftz(fmaf(s[4 * n + e], sl2, -ls[qi] * kLog2e));
              p = keep ? p : 0.f;
              s[4 * n + e] = p;
              dp[4 * n + e] = keep ? p * (dp[4 * n + e] - ds[qi]) : 0.f;
            }
          }
          uint32_t pa[BM / 16][4], da[BM / 16][4];
          pack_a<BM / 16>(pa, s);
          pack_a<BM / 16>(da, dp);
          // dV += P^T dO, dK += dS^T Q (k over the tile's queries)
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
            for (int p = 0; p < T::kParts; ++p)
              wgmma_rs<T::kCols>(dva[p], pa[kk], desc_mn<HD, BM>(sdo + st * QB, p, kk));
#pragma unroll
          for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
            for (int p = 0; p < T::kParts; ++p)
              wgmma_rs<T::kCols>(dka[p], da[kk], desc_mn<HD, BM>(sq + st * QB, p, kk));
          wgmma_commit();
          wgmma_wait();
#pragma unroll
          for (int p = 0; p < T::kParts; ++p) {
            reg_fence(dka[p]);
            reg_fence(dva[p]);
          }
        }
        if (lane == 0) mbar_arrive(empty + 8 * st);
      }

      const long long kv_row = static_cast<long long>(Hkv) * HD;
      auto* dkb = dk + static_cast<long long>(b) * S * kv_row + kvh * HD;
      auto* dvb = dv + static_cast<long long>(b) * S * kv_row + kvh * HD;
      const int kr1 = key0 + 8;
#pragma unroll
      for (int p = 0; p < T::kParts; ++p)
#pragma unroll
        for (int n = 0; n < T::kCols / 8; ++n) {
          const int col = p * T::kCols + 8 * n + 2 * t;
          if (key0 < S) {
            put2<ACCUM>(dkb + key0 * kv_row + col, dka[p][4 * n] * scale, dka[p][4 * n + 1] * scale);
            put2<ACCUM>(dvb + key0 * kv_row + col, dva[p][4 * n], dva[p][4 * n + 1]);
          }
          if (kr1 < S) {
            put2<ACCUM>(dkb + kr1 * kv_row + col, dka[p][4 * n + 2] * scale, dka[p][4 * n + 3] * scale);
            put2<ACCUM>(dvb + kr1 * kv_row + col, dva[p][4 * n + 2], dva[p][4 * n + 3]);
          }
        }
    });
  }
}

// dQ pass: one block per (kDqRows query rows, q head, batch row).
template <int HD, bool CAUSAL, bool ACCUM>
__global__ void __launch_bounds__(Roles<kDqWGs>::kThreads, 1)
attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        std::conditional_t<ACCUM, float, bf16>* __restrict__ dq, int S, int H,
                        int Hkv, float scale) {
  using T = Tile<HD>;
  constexpr int BM = kDqRows, BN = kDqKeys;
  constexpr uint32_t QB = T::template bytes<BM>(), KB = T::template bytes<BN>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = smem_base(smem_raw), sdo = sq + QB;
  const uint32_t sk = sdo + QB, sv = sk + kStages * KB;  // [stage]
  const uint32_t q_full = sv + kStages * KB;             // then full[], empty[]
  const uint32_t full = q_full + 8, empty = full + 8 * kStages;

  const int qt = gridDim.z - 1 - blockIdx.z;  // the last (longest causal) rows first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / Hkv);
  const int q0 = qt * BM;
  const int n_tiles = ((CAUSAL ? min(q0 + BM, S) : S) + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kDqWGs * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * QB);
      load_rows<HD, BM>(&tm_q, sq, q_full, h, q0, b);
      load_rows<HD, BM>(&tm_do, sdo, q_full, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(empty + 8 * st, ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, 2 * KB);
        load_rows<HD, BN>(&tm_k, sk + st * KB, full + 8 * st, kvh, j * BN, b);
        load_rows<HD, BN>(&tm_v, sv + st * KB, full + 8 * st, kvh, j * BN, b);
      }
    }
  } else {  // consumers: warpgroup c owns query rows q0 + 64 c .. q0 + 64 c + 63
    setmaxnreg_inc<Roles<kDqWGs>::kConsumerRegs>();
    for_consumer<kDqWGs>([&](auto wg) {
      constexpr int c = decltype(wg)::value;
      const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
      const int g = lane / 4, t = lane % 4;
      const int last_row = q0 + 64 * c + 63;
      const int r0 = q0 + 64 * c + 16 * warp + g, r1 = r0 + 8;
      const long long stat = (static_cast<long long>(b) * H + h) * S;
      const float sl2 = scale * kLog2e;  // scores and lse in base 2 below
      const float lse0 = r0 < S ? lse[stat + r0] * kLog2e : 0.f;
      const float lse1 = r1 < S ? lse[stat + r1] * kLog2e : 0.f;
      const float d0 = r0 < S ? delta[stat + r0] : 0.f, d1 = r1 < S ? delta[stat + r1] : 0.f;

      float dqa[T::kParts][T::kCols / 2];
#pragma unroll
      for (int p = 0; p < T::kParts; ++p)
#pragma unroll
        for (int i = 0; i < T::kCols / 2; ++i) dqa[p][i] = 0.f;

      mbar_wait(q_full, 0);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages, ph = (j / kStages) & 1;
        const int kv0 = j * BN;
        mbar_wait(full + 8 * st, ph);
        if (!(CAUSAL && kv0 > last_row)) {  // else every key of the tile follows every row
          // S = Q K^T and dP = dO V^T: rows r0 (e < 2), r1; key kv0 + 8 n + 2 t + (e & 1)
          float s[BN / 2], dp[BN / 2];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            wgmma_ss_n64(s, desc_k<HD, BM>(sq, 64 * c, kk), desc_k<HD, BN>(sk + st * KB, 0, kk), kk);
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            wgmma_ss_n64(dp, desc_k<HD, BM>(sdo, 64 * c, kk), desc_k<HD, BN>(sv + st * KB, 0, kk), kk);
          wgmma_commit();
          wgmma_wait();
          reg_fence(s);
          reg_fence(dp);
          // dS = P o (dP - D), P = exp(scale S - lse) under the mask
#pragma unroll
          for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = kv0 + 8 * n + 2 * t + (e & 1), row = e < 2 ? r0 : r1;
              const bool keep = row < S && (CAUSAL ? key <= row : key < S);
              float p = exp2_ftz(fmaf(s[4 * n + e], sl2, -(e < 2 ? lse0 : lse1)));  // no branch
              p = keep ? p : 0.f;
              dp[4 * n + e] = keep ? p * (dp[4 * n + e] - (e < 2 ? d0 : d1)) : 0.f;
            }
          }
          uint32_t da[BN / 16][4];
          pack_a<BN / 16>(da, dp);
          // dQ += dS K (k over the tile's keys)
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
            for (int p = 0; p < T::kParts; ++p)
              wgmma_rs<T::kCols>(dqa[p], da[kk], desc_mn<HD, BN>(sk + st * KB, p, kk));
          wgmma_commit();
          wgmma_wait();
#pragma unroll
          for (int p = 0; p < T::kParts; ++p) reg_fence(dqa[p]);
        }
        if (lane == 0) mbar_arrive(empty + 8 * st);
      }

      const long long q_row = static_cast<long long>(H) * HD;
      auto* dqb = dq + static_cast<long long>(b) * S * q_row + h * HD;
#pragma unroll
      for (int p = 0; p < T::kParts; ++p)
#pragma unroll
        for (int n = 0; n < T::kCols / 8; ++n) {
          const int col = p * T::kCols + 8 * n + 2 * t;
          if (r0 < S) put2<ACCUM>(dqb + r0 * q_row + col, dqa[p][4 * n] * scale, dqa[p][4 * n + 1] * scale);
          if (r1 < S)
            put2<ACCUM>(dqb + r1 * q_row + col, dqa[p][4 * n + 2] * scale, dqa[p][4 * n + 3] * scale);
        }
    });
  }
}

}  // namespace

// -------------------------------------------------------------------- host

namespace {

// cuTensorMapEncodeTiled, reached through the runtime: no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                    : nullptr;
  }();
  return fn;
}

// (B, S, Hx, hd) bf16 as dims (hd, Hx, S, B); a box is `rows` rows of one
// head, min(hd, 64) columns (the swizzle's width); rows past S read zeros.
bool map_rows(CUtensorMap* m, const void* base, int B, int S, int Hx, int hd, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(Hx),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * Hx, row * Hx * S};
  const int span = hd * 2 < 128 ? hd * 2 : 128;
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(span / 2), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = span == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// n f32 values in a row; a box is `len` of them, zeros past the end.
bool map_vec(CUtensorMap* m, const float* base, long long n, int len) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)}, stride[1] = {dims[0] * 4};  // unread at rank 1
  const cuuint32_t box[1] = {static_cast<cuuint32_t>(len)}, one[1] = {1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base), dims, stride, box,
             one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Dynamic shared memory: the tiles, their barriers, and room to align the
// first tile to 1024 bytes.
constexpr int smem_bytes(uint32_t tiles, int barriers) { return 1024 + tiles + 8 * barriers; }

// Each kernel's dynamic shared memory, as its first lines lay it out.
template <int HD>
constexpr int fwd_smem() {
  using T = Tile<HD>;
  return smem_bytes(T::template bytes<kFwdRows>() + 2 * kStages * T::template bytes<kFwdKeys>(),
                    1 + 3 * kStages);
}
template <int HD>
constexpr int dkdv_smem() {
  using T = Tile<HD>;
  return smem_bytes(2 * T::template bytes<kKvRows>() +
                        kStages * (2 * T::template bytes<kKvQueries>() + 2 * kStatSlot),
                    1 + 2 * kStages);
}
template <int HD>
constexpr int dq_smem() {
  using T = Tile<HD>;
  return smem_bytes(2 * T::template bytes<kDqRows>() + 2 * kStages * T::template bytes<kDqKeys>(),
                    1 + 2 * kStages);
}

// Above 48 KB of shared memory needs the opt-in, once per kernel and process.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return e;
}

template <int HD, bool CAUSAL>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int S, int H, int Hkv, float scale, cudaStream_t st) {
  using T = Tile<HD>;
  CUtensorMap tq, tk, tv;
  if (!map_rows(&tq, q, B, S, H, HD, kFwdRows) || !map_rows(&tk, k, B, S, Hkv, HD, kFwdKeys) ||
      !map_rows(&tv, v, B, S, Hkv, HD, kFwdKeys))
    return cudaErrorInvalidValue;
  constexpr int smem = fwd_smem<HD>();
  static bool done = false;
  if (const cudaError_t e = opt_in(attention_fwd_kernel<HD, CAUSAL>, smem, done)) return e;
  const dim3 grid(H, B, (S + kFwdRows - 1) / kFwdRows);
  attention_fwd_kernel<HD, CAUSAL><<<grid, Roles<kFwdWGs>::kThreads, smem, st>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, S, H, Hkv, scale);
  return cudaGetLastError();
}

cudaError_t launch_delta(const void* o, const void* dout, float* delta, int B, int S, int H, int hd,
                         cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * S * H;
  attention_bwd_delta_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta, rows, S, H, hd);
  return cudaGetLastError();
}

// The two passes of the backward (D already in `delta`).  dq, dk, dv:
// bf16 stores, or f32 accumulators added into (ACCUM).
template <int HD, bool CAUSAL, bool ACCUM>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                       int S, int H, int Hkv, float scale, cudaStream_t st) {
  using T = Tile<HD>;
  using GradT = std::conditional_t<ACCUM, float, bf16>;
  CUtensorMap kv_q, kv_do, kv_k, kv_v, kv_l, kv_d, dq_q, dq_do, dq_k, dq_v;
  const long long rows = static_cast<long long>(B) * H * S;
  if (!map_rows(&kv_q, q, B, S, H, HD, kKvQueries) || !map_rows(&kv_do, dout, B, S, H, HD, kKvQueries) ||
      !map_rows(&kv_k, k, B, S, Hkv, HD, kKvRows) || !map_rows(&kv_v, v, B, S, Hkv, HD, kKvRows) ||
      !map_vec(&kv_l, lse, rows, kStatBox) || !map_vec(&kv_d, delta, rows, kStatBox) ||
      !map_rows(&dq_q, q, B, S, H, HD, kDqRows) || !map_rows(&dq_do, dout, B, S, H, HD, kDqRows) ||
      !map_rows(&dq_k, k, B, S, Hkv, HD, kDqKeys) || !map_rows(&dq_v, v, B, S, Hkv, HD, kDqKeys))
    return cudaErrorInvalidValue;

  constexpr int smem_kv = dkdv_smem<HD>();
  static bool done_kv = false;
  if (const cudaError_t e = opt_in(attention_bwd_dkdv_kernel<HD, CAUSAL, ACCUM>, smem_kv, done_kv))
    return e;
  attention_bwd_dkdv_kernel<HD, CAUSAL, ACCUM>
      <<<dim3(Hkv, B, (S + kKvRows - 1) / kKvRows), Roles<kKvWGs>::kThreads, smem_kv, st>>>(
          kv_q, kv_k, kv_v, kv_do, kv_l, kv_d, static_cast<GradT*>(dk), static_cast<GradT*>(dv), S,
          H, Hkv, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  constexpr int smem_q = dq_smem<HD>();
  static bool done_q = false;
  if ((e = opt_in(attention_bwd_dq_kernel<HD, CAUSAL, ACCUM>, smem_q, done_q)) != cudaSuccess) return e;
  attention_bwd_dq_kernel<HD, CAUSAL, ACCUM>
      <<<dim3(H, B, (S + kDqRows - 1) / kDqRows), Roles<kDqWGs>::kThreads, smem_q, st>>>(
          dq_q, dq_do, dq_k, dq_v, lse, delta, static_cast<GradT*>(dq), S, H, Hkv, scale);
  return cudaGetLastError();
}

template <bool CAUSAL>
cudaError_t launch_fwd_hd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                          int S, int H, int Hkv, int hd, float scale, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_fwd<16, CAUSAL>(q, k, v, o, lse, B, S, H, Hkv, scale, st);
    case 32: return launch_fwd<32, CAUSAL>(q, k, v, o, lse, B, S, H, Hkv, scale, st);
    case 64: return launch_fwd<64, CAUSAL>(q, k, v, o, lse, B, S, H, Hkv, scale, st);
    case 128: return launch_fwd<128, CAUSAL>(q, k, v, o, lse, B, S, H, Hkv, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool CAUSAL, bool ACCUM>
cudaError_t launch_bwd_hd(const void* q, const void* k, const void* v, const void* dout,
                          const float* l, const float* d, void* dq, void* dk, void* dv, int B,
                          int S, int H, int Hkv, int hd, float scale, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_bwd<16, CAUSAL, ACCUM>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, Hkv, scale, st);
    case 32: return launch_bwd<32, CAUSAL, ACCUM>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, Hkv, scale, st);
    case 64: return launch_bwd<64, CAUSAL, ACCUM>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, Hkv, scale, st);
    case 128: return launch_bwd<128, CAUSAL, ACCUM>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, Hkv, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// The shapes every entry takes: positive sizes, H a multiple of Hkv, the
// grid's y and z in range, and (b, h, s) rows that a 32-bit TMA
// coordinate reaches.
bool shapes_ok(int B, int S, int H, int Hkv) {
  return B > 0 && S > 0 && H > 0 && Hkv > 0 && H % Hkv == 0 && B <= 65535 &&
         S <= 64 * 65535 && static_cast<long long>(B) * H * S < (1ll << 31);
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, S, Hkv, hd); bf16 contiguous, 16-byte
// aligned; H % Hkv == 0; hd in {16, 32, 64, 128}.  lse: null, or (B, H, S)
// f32 to receive each row's log-sum-exp of the scaled scores (for the
// backward).  causal: 1 keeps key <= query (K1), 0 keeps every key < S
// (K7a).  One launch.
extern "C" int ktpu_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int B, int S, int H, int Hkv, int hd,
                                       float scale, int causal, void* stream) {
  if (!shapes_ok(B, S, H, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return static_cast<int>(causal ? launch_fwd_hd<true>(q, k, v, o, l, B, S, H, Hkv, hd, scale, st)
                                 : launch_fwd_hd<false>(q, k, v, o, l, B, S, H, Hkv, hd, scale, st));
}

// Shapes as the forward; o, dout: (B, S, H, hd) bf16; lse: (B, H, S) f32 from
// the forward; scratch: delta (B, H, S) f32; out: dq like q, dk and dv like
// k, bf16, each written once; causal as the forward.  Three launches: D,
// the dK/dV pass, the dQ pass.
extern "C" int ktpu_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv, int B, int S,
                                       int H, int Hkv, int hd, float scale, int causal,
                                       void* stream) {
  if (!shapes_ok(B, S, H, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* d = static_cast<float*>(delta);
  cudaError_t e = launch_delta(o, dout, d, B, S, H, hd, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* l = static_cast<const float*>(lse);
  e = causal ? launch_bwd_hd<true, false>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, Hkv, hd, scale, st)
             : launch_bwd_hd<false, false>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, Hkv, hd, scale, st);
  return static_cast<int>(e);
}

// One (q block, kv block) pair of ring attention's backward (K6), both
// blocks S rows long: shapes as the backward above; lse (B, H, S) f32 the
// ring's final log-sum-exp; delta (B, H, S) f32, D = rowsum(dO o O) of the
// ring's final output, computed here first when o is not null (the ring's
// first step) and read as given otherwise.  Adds: dq_acc (B, S, H, hd) f32
// += scale * dS K; dk_acc, dv_acc (B, S, Hkv, hd) f32 += scale * dS^T Q,
// P^T dO, each element by the one block that owns it.  causal: 1 for the
// diagonal block (key <= query within the block), 0 for a block wholly
// behind (or any block of a non-causal ring).  Two launches (three when o
// is given).
extern "C" int ktpu_ring_block_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        void* delta, void* dq_acc, void* dk_acc, void* dv_acc,
                                        int B, int S, int H, int Hkv, int hd, float scale,
                                        int causal, void* stream) {
  if (!shapes_ok(B, S, H, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* d = static_cast<float*>(delta);
  cudaError_t e;
  if (o != nullptr && (e = launch_delta(o, dout, d, B, S, H, hd, st)) != cudaSuccess)
    return static_cast<int>(e);
  const float* l = static_cast<const float*>(lse);
  e = causal ? launch_bwd_hd<true, true>(q, k, v, dout, l, d, dq_acc, dk_acc, dv_acc, B, S, H, Hkv, hd, scale, st)
             : launch_bwd_hd<false, true>(q, k, v, dout, l, d, dq_acc, dk_acc, dv_acc, B, S, H, Hkv, hd, scale, st);
  return static_cast<int>(e);
}

// The launch shape of each kernel at head dim hd, for reports: which = 0
// the forward, 1 the dK/dV pass, 2 the dQ pass.  Fills the dynamic shared
// memory in bytes, the threads of a block and the registers a consumer
// thread gets after setmaxnreg (the producer keeps 24).  Returns 0, or
// cudaErrorInvalidValue for another hd or which.
extern "C" int ktpu_attention_kernel_info(int which, int hd, int* smem, int* threads,
                                          int* consumer_regs) {
  if (which < 0 || which > 2) return static_cast<int>(cudaErrorInvalidValue);
  auto pick = [which](int fwd, int dkdv, int dq) { return which == 0 ? fwd : which == 1 ? dkdv : dq; };
  switch (hd) {
    case 16: *smem = pick(fwd_smem<16>(), dkdv_smem<16>(), dq_smem<16>()); break;
    case 32: *smem = pick(fwd_smem<32>(), dkdv_smem<32>(), dq_smem<32>()); break;
    case 64: *smem = pick(fwd_smem<64>(), dkdv_smem<64>(), dq_smem<64>()); break;
    case 128: *smem = pick(fwd_smem<128>(), dkdv_smem<128>(), dq_smem<128>()); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  *threads = pick(Roles<kFwdWGs>::kThreads, Roles<kKvWGs>::kThreads, Roles<kDqWGs>::kThreads);
  *consumer_regs = pick(Roles<kFwdWGs>::kConsumerRegs, Roles<kKvWGs>::kConsumerRegs,
                        Roles<kDqWGs>::kConsumerRegs);
  return 0;
}
