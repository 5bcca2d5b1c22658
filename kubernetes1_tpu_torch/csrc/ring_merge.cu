// K6 ring attention's online-softmax merge for Hopper.
//
// Replaces: kubernetes1_tpu/workloads/ringattention.py `_merge` (:50-59),
// which folds one block's partial (o unnormalised, row max m, row sum l)
// into the running accumulator, and the normalise-and-cast at :100-101.  The
// port keeps each partial in the lse form, a normalised o with its row
// log-sum-exp (o_norm = o / l, lse = m + log l: the same function), so the
// fold of block n into accumulator a is, per (b, s, h) row,
//   lse = mx + log(exp(lse_a - mx) + exp(lse_n - mx)),  mx = max(lse_a, lse_n)
//   o   = o_a * exp(lse_a - lse) + o_n * exp(lse_n - lse)
// in f32; a row with both lse at -inf (nothing folded yet) stays o = 0,
// lse = -inf.  The products and the sum are kept apart (__fmul_rn,
// __fadd_rn: no FMA contraction) and exp/log are the accurate expf/logf, as
// the plain version's separate torch ops compute them.
//
// Layouts: o_acc (B, S, H, hd) f32, o_blk (B, S, H, hd) bf16 (the block
// kernel's output), lse (B, H, S) f32.  The new lse goes to its own buffer
// (lse_out): the threads of one row all read lse_acc, so none may overwrite
// it.  `out` null: o_acc is updated in place; `out` given (the ring's last
// merge): the merged o is written there as bf16 instead, rounded once.
//
// Bound on the H100: bytes.  Per element of o it reads 4 + 2 bytes and
// writes 4 (or 2), ~3 flops; per row of hd elements 12 bytes of lse and a
// few exp/log.  At Llama-3-8B's widths and a block of 8192 tokens
// (33.5 M elements) that is ~335 MB, ~0.1 ms at 3.35 TB/s.
//
// Design: a grid-stride loop, 8 elements of o a thread a step (two 16-byte
// f32 loads, one 16-byte bf16 load), neighbouring threads on neighbouring
// addresses; the hd / 8 threads of one row compute its weights from the
// same two lse values (served from L1).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool FINAL>
__global__ void __launch_bounds__(kThreads)
ring_merge_kernel(float* __restrict__ o_acc, const float* __restrict__ lse_a,
                  const __nv_bfloat16* __restrict__ o_blk, const float* __restrict__ lse_n,
                  float* __restrict__ lse_out, __nv_bfloat16* __restrict__ out, long long n8,
                  int S, int H, int chunks) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n8;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long row = i / chunks;  // (b * S + s) * H + h
    const int h = static_cast<int>(row % H);
    const long long bs = row / H;
    const long long li = (bs / S * H + h) * S + bs % S;  // (b, h, s)
    const float la = lse_a[li], ln = lse_n[li];
    const float mx = fmaxf(la, ln);
    float lse = -INFINITY, wa = 0.f, wb = 0.f;
    if (mx != -INFINITY) {
      lse = __fadd_rn(mx, logf(__fadd_rn(expf(__fsub_rn(la, mx)), expf(__fsub_rn(ln, mx)))));
      wa = expf(__fsub_rn(la, lse));
      wb = expf(__fsub_rn(ln, lse));
    }
    if (i % chunks == 0) lse_out[li] = lse;

    const float4* oa = reinterpret_cast<const float4*>(o_acc) + 2 * i;
    const float4 a0 = oa[0], a1 = oa[1];
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const uint4 raw = reinterpret_cast<const uint4*>(o_blk)[i];
    const __nv_bfloat16* nb = reinterpret_cast<const __nv_bfloat16*>(&raw);
    float r[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      r[e] = __fadd_rn(__fmul_rn(a[e], wa), __fmul_rn(ktpu::bf2f(nb[e]), wb));
    if constexpr (FINAL) {
      uint4 res;
      __nv_bfloat16* rv = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
      for (int e = 0; e < 8; ++e) rv[e] = ktpu::f2bf(r[e]);
      reinterpret_cast<uint4*>(out)[i] = res;
    } else {
      float4* ow = reinterpret_cast<float4*>(o_acc) + 2 * i;
      ow[0] = make_float4(r[0], r[1], r[2], r[3]);
      ow[1] = make_float4(r[4], r[5], r[6], r[7]);
    }
  }
}

}  // namespace

// o_acc: (B, S, H, hd) f32; lse_acc, lse_blk, lse_out: (B, H, S) f32;
// o_blk: (B, S, H, hd) bf16; out: null (o_acc updated in place) or
// (B, S, H, hd) bf16 for the merged output; all contiguous, 16-byte
// aligned; hd % 8 == 0.  One launch.
extern "C" int ktpu_ring_merge(void* o_acc, const void* lse_acc, const void* o_blk,
                               const void* lse_blk, void* lse_out, void* out, int B, int S,
                               int H, int hd, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n8 = static_cast<long long>(B) * S * H * hd / 8;
  const long long want = (n8 + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < 132 * 16 ? want : 132 * 16);  // 16 blocks an SM
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(o_acc);
  const float* la = static_cast<const float*>(lse_acc);
  const __nv_bfloat16* ob = static_cast<const __nv_bfloat16*>(o_blk);
  const float* ln = static_cast<const float*>(lse_blk);
  float* lo = static_cast<float*>(lse_out);
  if (out != nullptr)
    ring_merge_kernel<true><<<grid, kThreads, 0, st>>>(
        acc, la, ob, ln, lo, static_cast<__nv_bfloat16*>(out), n8, S, H, hd / 8);
  else
    ring_merge_kernel<false><<<grid, kThreads, 0, st>>>(acc, la, ob, ln, lo, nullptr, n8, S, H,
                                                        hd / 8);
  return static_cast<int>(cudaGetLastError());
}
