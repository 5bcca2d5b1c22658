// K5 fused cross-entropy for Hopper: forward and backward over bf16 logits.
//
// Replaces: kubernetes1_tpu/workloads/llama.py `loss_fn`, lines 196-202:
// logits.astype(f32), jax.nn.log_softmax, take_along_axis of the target,
// mean.  Per row of the bf16 logits (rows, vocab):
//   forward:  lse = log(sum(exp(x))), loss = lse - x[target], both f32;
//   backward: dlogits = bf16((exp(x - lse) - onehot(target)) * grad[row]),
//             which is where the VJP of JAX's astype(float32) rounds it.
// The mean over rows stays a torch op.  Neither the f32 logits, their
// log-softmax nor their f32 gradient exist in device memory: at
// Llama-3-8B's 8192 x 128256 each would be 4.2 GB.
//
// Bound on the H100: bytes.  Forward reads the logits once (2 bytes and
// ~4 flops an element); backward reads them and writes the gradient (4
// bytes, ~4 flops).  The backward may write over the logits in place
// (dlogits == logits): each element is read and then written by the same
// thread.
//
// Design: one block of 512 threads per row.  Forward: each thread keeps an
// online (max, sum of exp) pair over its elements, 8 at a time (16-byte
// loads when vocab % 8 == 0, scalar loads otherwise), then the pairs are
// merged across the warp with shuffles and across the warps in shared
// memory.  A target outside [0, vocab) gives a NaN loss.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;

// Merge (m, s) with (m2, s2): the sum of exp relative to the larger max.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;  // both empty
  s = s * __expf(m - mx) + s2 * __expf(m2 - mx);
  m = mx;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const __nv_bfloat16* __restrict__ logits, const long long* __restrict__ targets,
                float* __restrict__ loss, float* __restrict__ lse, int V) {
  __shared__ float sm_m[kThreads / 32], sm_s[kThreads / 32];
  const long long row = blockIdx.x;
  const __nv_bfloat16* x = logits + row * V;
  float m = -INFINITY, s = 0.f;
  if (kVec) {
    for (int c = threadIdx.x * 8; c < V; c += kThreads * 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + c);
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
      float f[8], mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        f[e] = ktpu::bf2f(v[e]);
        mx = fmaxf(mx, f[e]);
      }
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) part += __expf(f[e] - mx);
      merge(m, s, mx, part);
    }
  } else {
    for (int c = threadIdx.x; c < V; c += kThreads) merge(m, s, ktpu::bf2f(x[c]), 1.f);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sm_m[warp] = m;
    sm_s[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? sm_m[lane] : -INFINITY;
    s = lane < kThreads / 32 ? sm_s[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
      merge(m, s, m2, s2);
    }
    if (lane == 0) {
      const float l = m + logf(s);
      const long long t = targets[row];
      lse[row] = l;
      loss[row] = (t >= 0 && t < V) ? l - ktpu::bf2f(x[t]) : NAN;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const __nv_bfloat16* logits, const long long* __restrict__ targets,
                const float* __restrict__ lse, const float* __restrict__ grad,
                __nv_bfloat16* dlogits, int V) {
  const long long row = blockIdx.x;
  const __nv_bfloat16* x = logits + row * V;
  __nv_bfloat16* dx = dlogits + row * V;
  const float l = lse[row], gr = grad[row];
  const long long t = targets[row];
  if (kVec) {
    for (int c = threadIdx.x * 8; c < V; c += kThreads * 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + c);
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
      uint4 res;
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float p = __expf(ktpu::bf2f(v[e]) - l);
        o[e] = ktpu::f2bf((p - (c + e == t ? 1.f : 0.f)) * gr);
      }
      *reinterpret_cast<uint4*>(dx + c) = res;
    }
  } else {
    for (int c = threadIdx.x; c < V; c += kThreads) {
      const float p = __expf(ktpu::bf2f(x[c]) - l);
      dx[c] = ktpu::f2bf((p - (c == t ? 1.f : 0.f)) * gr);
    }
  }
}

}  // namespace

// logits: (rows, V) bf16 contiguous; targets: (rows,) int64; loss, lse: (rows,) f32.
extern "C" int ktpu_xent_fwd_bf16(const void* logits, const void* targets, void* loss,
                                  void* lse, int rows, int V, void* stream) {
  if (rows <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const __nv_bfloat16*>(logits);
  const auto* t = static_cast<const long long*>(targets);
  if (V % 8 == 0)
    xent_fwd_kernel<true><<<rows, kThreads, 0, st>>>(x, t, static_cast<float*>(loss),
                                                     static_cast<float*>(lse), V);
  else
    xent_fwd_kernel<false><<<rows, kThreads, 0, st>>>(x, t, static_cast<float*>(loss),
                                                      static_cast<float*>(lse), V);
  return static_cast<int>(cudaGetLastError());
}

// logits, dlogits: (rows, V) bf16 contiguous, dlogits may be logits (in
// place); targets: (rows,) int64; lse, grad: (rows,) f32.
extern "C" int ktpu_xent_bwd_bf16(const void* logits, const void* targets, const void* lse,
                                  const void* grad, void* dlogits, int rows, int V,
                                  void* stream) {
  if (rows <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const __nv_bfloat16*>(logits);
  const auto* t = static_cast<const long long*>(targets);
  const auto* l = static_cast<const float*>(lse);
  const auto* g = static_cast<const float*>(grad);
  auto* dx = static_cast<__nv_bfloat16*>(dlogits);
  if (V % 8 == 0)
    xent_bwd_kernel<true><<<rows, kThreads, 0, st>>>(x, t, l, g, dx, V);
  else
    xent_bwd_kernel<false><<<rows, kThreads, 0, st>>>(x, t, l, g, dx, V);
  return static_cast<int>(cudaGetLastError());
}
