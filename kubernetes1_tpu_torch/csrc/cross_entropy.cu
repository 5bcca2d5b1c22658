// K5 fused cross-entropy for Hopper: forward and backward over bf16 or f32
// logits (one template on the element type).
//
// Replaces: kubernetes1_tpu/workloads/llama.py `loss_fn`, lines 196-202
// (bf16 logits): logits.astype(f32), jax.nn.log_softmax, take_along_axis of
// the target, mean; and kubernetes1_tpu/workloads/bert.py `mlm_loss_fn`,
// lines 157-166, whose logits are f32 (the bf16 decode plus the f32
// mlm_bias): log_softmax, take_along_axis, the masked mean.  Per row of the
// logits (rows, vocab):
//   forward:  lse = log(sum(exp(x))), loss = lse - x[target], both f32;
//   backward: dlogits = T((exp(x - lse) - onehot(target)) * grad[row]): for
//             bf16 where the VJP of JAX's astype(float32) rounds it, for
//             f32 not rounded at all.
// The mean (Llama) or the mask weighting (BERT) over rows stays a torch
// op.  For bf16 logits neither the f32 logits, their log-softmax nor their
// f32 gradient exist in device memory: at Llama-3-8B's 8192 x 128256 each
// would be 4.2 GB.  For f32 logits the log-softmax and a second gradient
// tensor never exist: at BERT's 16384 x 30522 each would be 2.0 GB.
//
// Bound on the H100: bytes.  Forward reads the logits once (2 or 4 bytes
// and ~4 flops an element); backward reads them and writes the gradient
// (4 or 8 bytes, ~4 flops).  The backward may write over the logits in
// place (dlogits == logits): each element is read and then written by the
// same thread.
//
// Design: one block of 512 threads per row.  Forward: each thread keeps an
// online (max, sum of exp) pair over its elements, VEC at a time (bf16: 8,
// 16-byte loads, when vocab % 8 == 0; f32: 4 or 2, 16- or 8-byte loads,
// when vocab % 4 or % 2 == 0 -- BERT's 30522 takes 2; scalar loads
// otherwise), then the pairs are merged across the warp with shuffles and
// across the warps in shared memory.  A target outside [0, vocab) gives a
// NaN loss.
//
// Vocab-parallel partial (ktpu_xent_part_*): under JAX's param specs the
// logits are split over the tp ranks by vocab (llama.py:93 `unembed`
// P("fsdp", "tp"); bert.py:64,153, the tied decode of `embed` P("tp",
// "fsdp")), and JAX's log_softmax reduces across the split.  The same row
// loop over a rank's block of V columns, the block starting at global
// column v0, writes per row the block's lse and the target's logit where
// the target lies in [v0, v0 + V), else 0.  The wrapper adds the ranks'
// target logits and takes the log-sum-exp of their lse; the backward is
// ktpu_xent_bwd_* fed the global lse and targets - v0 (no one-hot outside
// [0, V)).  Bound: bytes, as the forward.

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

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return ktpu::bf2f(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return ktpu::f2bf(v);
}
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

// The register type of one VEC-element load: 16, 8 or 4 bytes.
template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned; };

// PART: `out` gets the target's logit (0 outside [v0, v0 + V)), else the
// loss (NaN for a target outside [0, V)).
template <typename T, int VEC, bool PART>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const T* __restrict__ logits, const long long* __restrict__ targets,
                float* __restrict__ out, float* __restrict__ lse, int V, long long v0) {
  __shared__ float sm_m[kThreads / 32], sm_s[kThreads / 32];
  const long long row = blockIdx.x;
  const T* x = logits + row * V;
  float m = -INFINITY, s = 0.f;
  if constexpr (VEC > 1) {
    using R = typename Raw<VEC * sizeof(T)>::type;
    for (int c = threadIdx.x * VEC; c < V; c += kThreads * VEC) {
      const R raw = *reinterpret_cast<const R*>(x + c);
      const T* v = reinterpret_cast<const T*>(&raw);
      float f[VEC], mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        f[e] = to_f(v[e]);
        mx = fmaxf(mx, f[e]);
      }
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) part += __expf(f[e] - mx);
      merge(m, s, mx, part);
    }
  } else {
    for (int c = threadIdx.x; c < V; c += kThreads) merge(m, s, to_f(x[c]), 1.f);
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
      const long long t = targets[row] - v0;
      const bool inside = t >= 0 && t < V;
      lse[row] = l;
      if constexpr (PART) out[row] = inside ? to_f(x[t]) : 0.f;
      else out[row] = inside ? l - to_f(x[t]) : NAN;
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const T* logits, const long long* __restrict__ targets,
                const float* __restrict__ lse, const float* __restrict__ grad,
                T* dlogits, int V) {
  const long long row = blockIdx.x;
  const T* x = logits + row * V;
  T* dx = dlogits + row * V;
  const float l = lse[row], gr = grad[row];
  const long long t = targets[row];
  if constexpr (VEC > 1) {
    using R = typename Raw<VEC * sizeof(T)>::type;
    for (int c = threadIdx.x * VEC; c < V; c += kThreads * VEC) {
      const R raw = *reinterpret_cast<const R*>(x + c);
      const T* v = reinterpret_cast<const T*>(&raw);
      R res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float p = __expf(to_f(v[e]) - l);
        o[e] = from_f<T>((p - (c + e == t ? 1.f : 0.f)) * gr);
      }
      *reinterpret_cast<R*>(dx + c) = res;
    }
  } else {
    for (int c = threadIdx.x; c < V; c += kThreads) {
      const float p = __expf(to_f(x[c]) - l);
      dx[c] = from_f<T>((p - (c == t ? 1.f : 0.f)) * gr);
    }
  }
}

// The widest load that every row start allows (rows of V elements in a
// 16-byte aligned tensor): bf16 8 or 1 elements, f32 4, 2 or 1.
template <typename T>
int vec_for(int V) {
  if (sizeof(T) == 2) return V % 8 == 0 ? 8 : 1;
  return V % 4 == 0 ? 4 : (V % 2 == 0 ? 2 : 1);
}

template <typename T, bool PART>
int launch_fwd(const void* logits, const void* targets, void* loss, void* lse, int rows, int V,
               long long v0, void* stream) {
  if (rows <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const T*>(logits);
  const auto* t = static_cast<const long long*>(targets);
  auto* lo = static_cast<float*>(loss);
  auto* ls = static_cast<float*>(lse);
  const int vec = vec_for<T>(V);
  if constexpr (sizeof(T) == 2) {
    if (vec == 8) xent_fwd_kernel<T, 8, PART><<<rows, kThreads, 0, st>>>(x, t, lo, ls, V, v0);
    else xent_fwd_kernel<T, 1, PART><<<rows, kThreads, 0, st>>>(x, t, lo, ls, V, v0);
  } else {
    if (vec == 4) xent_fwd_kernel<T, 4, PART><<<rows, kThreads, 0, st>>>(x, t, lo, ls, V, v0);
    else if (vec == 2) xent_fwd_kernel<T, 2, PART><<<rows, kThreads, 0, st>>>(x, t, lo, ls, V, v0);
    else xent_fwd_kernel<T, 1, PART><<<rows, kThreads, 0, st>>>(x, t, lo, ls, V, v0);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* logits, const void* targets, const void* lse, const void* grad,
               void* dlogits, int rows, int V, void* stream) {
  if (rows <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const T*>(logits);
  const auto* t = static_cast<const long long*>(targets);
  const auto* l = static_cast<const float*>(lse);
  const auto* g = static_cast<const float*>(grad);
  auto* dx = static_cast<T*>(dlogits);
  const int vec = vec_for<T>(V);
  if constexpr (sizeof(T) == 2) {
    if (vec == 8) xent_bwd_kernel<T, 8><<<rows, kThreads, 0, st>>>(x, t, l, g, dx, V);
    else xent_bwd_kernel<T, 1><<<rows, kThreads, 0, st>>>(x, t, l, g, dx, V);
  } else {
    if (vec == 4) xent_bwd_kernel<T, 4><<<rows, kThreads, 0, st>>>(x, t, l, g, dx, V);
    else if (vec == 2) xent_bwd_kernel<T, 2><<<rows, kThreads, 0, st>>>(x, t, l, g, dx, V);
    else xent_bwd_kernel<T, 1><<<rows, kThreads, 0, st>>>(x, t, l, g, dx, V);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits: (rows, V) bf16 or f32 contiguous; targets: (rows,) int64; loss,
// lse: (rows,) f32.
extern "C" int ktpu_xent_fwd_bf16(const void* logits, const void* targets, void* loss,
                                  void* lse, int rows, int V, void* stream) {
  return launch_fwd<__nv_bfloat16, false>(logits, targets, loss, lse, rows, V, 0, stream);
}

extern "C" int ktpu_xent_fwd_f32(const void* logits, const void* targets, void* loss,
                                 void* lse, int rows, int V, void* stream) {
  return launch_fwd<float, false>(logits, targets, loss, lse, rows, V, 0, stream);
}

// The vocab-parallel partial: logits (rows, V) one rank's block of the
// vocab, starting at global column v0; targets: (rows,) int64 global ids;
// tgt, lse: (rows,) f32.
extern "C" int ktpu_xent_part_bf16(const void* logits, const void* targets, void* tgt,
                                   void* lse, int rows, int V, long long v0, void* stream) {
  return launch_fwd<__nv_bfloat16, true>(logits, targets, tgt, lse, rows, V, v0, stream);
}

extern "C" int ktpu_xent_part_f32(const void* logits, const void* targets, void* tgt,
                                  void* lse, int rows, int V, long long v0, void* stream) {
  return launch_fwd<float, true>(logits, targets, tgt, lse, rows, V, v0, stream);
}

// logits, dlogits: (rows, V) contiguous, of one dtype (bf16 or f32),
// dlogits may be logits (in place); targets: (rows,) int64; lse, grad:
// (rows,) f32.
extern "C" int ktpu_xent_bwd_bf16(const void* logits, const void* targets, const void* lse,
                                  const void* grad, void* dlogits, int rows, int V,
                                  void* stream) {
  return launch_bwd<__nv_bfloat16>(logits, targets, lse, grad, dlogits, rows, V, stream);
}

extern "C" int ktpu_xent_bwd_f32(const void* logits, const void* targets, const void* lse,
                                 const void* grad, void* dlogits, int rows, int V,
                                 void* stream) {
  return launch_bwd<float>(logits, targets, lse, grad, dlogits, rows, V, stream);
}
