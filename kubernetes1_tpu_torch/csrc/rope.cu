// K3 RoPE for Hopper: q and k rotated in one launch, forward and backward.
//
// Replaces: kubernetes1_tpu/workloads/llama.py `rope` (called once for q and
// once for k there).  It is a HALF-SPLIT rotation (jnp.split(x, 2) on the
// last axis), not an even/odd interleave: with x1 = x[..., :hd/2] and
// x2 = x[..., hd/2:], out = concat(x1*cos - x2*sin, x2*cos + x1*sin), in f32,
// cast back to bf16.  freqs = theta^(-i/(hd/2)), angle = position * freq,
// and positions are arange(S) on every row.
//
// Bound on the H100: bytes.  It reads q and k once and writes them once;
// the ~6 flops per pair are nothing beside that.
//
// Design: one block per token (b, s).  The block's first hd/2 threads
// compute the cos/sin table for that position once, into shared memory, so
// the transcendental work is hd/2 per token and not per head; then the
// block's threads sweep the (H + Hkv) heads, two neighbouring pairs a
// thread (4-byte accesses), neighbouring threads on neighbouring addresses.
// Products and sums use the _rn intrinsics so that nvcc does not contract
// them into FMAs: the rounding then matches the plain version (separate
// multiplies and adds) step for step.
//
// Backward: the VJP of a rotation is the rotation by -angle, applied to
// dq and dk.  The `inverse` flag negates the sine in the table; since
// a * (-s) == -(a * s) and a - (-b) == a + b exactly, the result stays
// bit-equal to the plain version rotating with cos and -sin.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Rotates the pairs (i, i + half) and (i + 1, i + 1 + half) of one head:
// 4-byte loads and stores of two neighbouring lanes.
__device__ __forceinline__ void rotate2(const __nv_bfloat16* __restrict__ src,
                                        __nv_bfloat16* __restrict__ dst, int i, int half,
                                        const float* __restrict__ table) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + i));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + i + half));
  const float c0 = table[i], c1 = table[i + 1], s0 = table[half + i], s1 = table[half + i + 1];
  *reinterpret_cast<__nv_bfloat162*>(dst + i) = __floats2bfloat162_rn(
      __fsub_rn(__fmul_rn(a.x, c0), __fmul_rn(b.x, s0)),
      __fsub_rn(__fmul_rn(a.y, c1), __fmul_rn(b.y, s1)));
  *reinterpret_cast<__nv_bfloat162*>(dst + i + half) = __floats2bfloat162_rn(
      __fadd_rn(__fmul_rn(b.x, c0), __fmul_rn(a.x, s0)),
      __fadd_rn(__fmul_rn(b.y, c1), __fmul_rn(a.y, s1)));
}

__global__ void __launch_bounds__(kThreads)
rope_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 __nv_bfloat16* __restrict__ qo, __nv_bfloat16* __restrict__ ko,
                 int S, int H, int Hkv, int hd, float theta, bool inverse) {
  extern __shared__ float table[];  // cos[hd/2], then sin[hd/2]
  const long long tok = blockIdx.x;
  const int pos = static_cast<int>(tok % S);
  const int half = hd / 2;
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    const float freq = powf(theta, __fdiv_rn(-static_cast<float>(i), static_cast<float>(half)));
    const float ang = __fmul_rn(static_cast<float>(pos), freq);
    table[i] = cosf(ang);
    table[half + i] = inverse ? -sinf(ang) : sinf(ang);
  }
  __syncthreads();

  const long long qoff = tok * H * hd, koff = tok * Hkv * hd;
  const int per_head = half / 2;  // lane pairs of one head
  const int nq = H * per_head, nk = Hkv * per_head;
  for (int p = threadIdx.x; p < nq + nk; p += blockDim.x) {
    if (p < nq) {
      const int h = p / per_head, i = (p % per_head) * 2;
      rotate2(q + qoff + h * hd, qo + qoff + h * hd, i, half, table);
    } else {
      const int h = (p - nq) / per_head, i = ((p - nq) % per_head) * 2;
      rotate2(k + koff + h * hd, ko + koff + h * hd, i, half, table);
    }
  }
}

}  // namespace

// q, qo: (B, S, H, hd); k, ko: (B, S, Hkv, hd); bf16 contiguous; hd % 4 == 0.
// inverse != 0 rotates by -angle (the backward, on dq and dk).
extern "C" int ktpu_rope_bf16(const void* q, const void* k, void* qo, void* ko, int B,
                              int S, int H, int Hkv, int hd, float theta, int inverse,
                              void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || hd <= 0 || hd % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * hd;
  rope_bf16_kernel<<<B * S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<__nv_bfloat16*>(qo), static_cast<__nv_bfloat16*>(ko), S, H, Hkv, hd, theta,
      inverse != 0);
  return static_cast<int>(cudaGetLastError());
}
