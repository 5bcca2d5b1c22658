// Shared by every kernel library of the port: the C-callable error string
// that the Python loader binds, and the bf16 helpers the kernels use.
// Each csrc/*.cu is built into its own shared library, so each carries its
// own copy of ktpu_error_string.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

extern "C" const char* ktpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace ktpu {

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ __nv_bfloat16 f2bf(float v) { return __float2bfloat16_rn(v); }

// Sum over the whole block; every thread gets the total.  `scratch` holds
// one float per warp.  Block size is a multiple of 32, at most 1024.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  v = lane < nwarps ? scratch[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}


// ------------------------------------------------ mbarriers and bulk copies
// The Hopper pipeline's pieces (attention.cu, layernorm.cu): a copy engine
// (TMA) fills shared memory and reports the bytes to an mbarrier; the
// threads that use the data wait on the barrier's phase.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both
// 16-byte aligned) by the copy engine, completing on `bar`: a 1-D bulk
// copy, no tensor map.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar) : "memory");
}


// ------------------------------------------- cross-block barrier and sums
// The one-launch reductions (batchnorm.cu, layernorm.cu): every block
// writes a partial sum, then the blocks meet at a barrier on two words
// of global memory, an arrival count and a generation.  The block whose
// arrival is the n-th may work first (K8 adds a column's partials there),
// then sets the count back to 0 for the next call and moves the
// generation; the others wait for it to move.  The lead thread reads the
// generation at the start of the kernel (barrier_generation), before its
// block can arrive.  A block that waits must be resident with the last
// one: the launch is cooperative.  A launch meets each barrier once.

__device__ __forceinline__ bool lead_thread() { return threadIdx.x == 0 && threadIdx.y == 0; }

__device__ __forceinline__ unsigned barrier_generation(const unsigned* sync) {
  return *reinterpret_cast<const volatile unsigned*>(sync + 1);
}

// Every thread of the block: its writes are visible before the block
// arrives.  True, in every thread, in the block whose arrival is the n-th.
__device__ __forceinline__ bool barrier_arrive(unsigned* sync, unsigned n) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (lead_thread()) {
    last = atomicAdd(sync, 1u) == n - 1;
    if (last) __threadfence();  // then the others' writes are seen
  }
  __syncthreads();
  return last;
}

// The lead thread of the last block: the count is 0 again and the
// generation moves.  No fence between them: a barrier is met once a
// launch, and the next launch, which counts again, starts after this one
// ends.
__device__ __forceinline__ void barrier_open(unsigned* sync) {
  *sync = 0;
  atomicAdd(sync + 1, 1u);
}

// In the last block, after it wrote what the others wait for: those
// writes are visible, then the barrier opens.
__device__ __forceinline__ void barrier_release(unsigned* sync) {
  __threadfence();
  __syncthreads();
  if (lead_thread()) barrier_open(sync);
}

// In the other blocks: wait until the generation has moved past `seen`.
__device__ __forceinline__ void barrier_wait(const unsigned* sync, unsigned seen) {
  if (lead_thread()) {
    while (barrier_generation(sync) == seen) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// Every block waits for every other (a cooperative launch).
__device__ __forceinline__ void grid_barrier(unsigned* sync, unsigned n, unsigned seen) {
  if (barrier_arrive(sync, n)) {
    if (lead_thread()) barrier_open(sync);  // nothing written since arriving
  } else {
    barrier_wait(sync, seen);
  }
}

__device__ __forceinline__ void sum_into(float& a, float b) { a += b; }
__device__ __forceinline__ void sum_into(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// A sum over the P rows of the blocks' partials, in a fixed order, by the
// whole block: n outputs (n <= the block's threads), output o in column
// col(o) of a row (a negative column is no output: its sum is 0), rows
// `stride` elements apart.  Thread t takes output t % n as lane
// l = t / n of L = threads / n lanes, and adds rows l, l + L, ... with
// up to kSumLoads loads in flight, read from L2 (the partials are other
// blocks'); the lane's sum goes to red[l n + o], and column_total then
// adds output o's L lanes in order, after a __syncthreads.  The result
// depends on P, n and the block's size only: two runs give the same bits.
constexpr int kSumLoads = 8;

template <typename T, typename Col>
__device__ __forceinline__ int column_lanes(const T* __restrict__ partial, long long stride,
                                            int P, int n, Col col, T* red) {
  const int threads = blockDim.x * blockDim.y, t = threadIdx.y * blockDim.x + threadIdx.x;
  const int lanes = threads / n, o = t % n, lane = t / n;
  if (lane >= lanes) return lanes;
  T acc{};
  const long long c = col(o);
  if (c >= 0) {
    const T* p = partial + c;
    int j = lane;
    for (; j + (kSumLoads - 1) * lanes < P; j += kSumLoads * lanes) {
      T v[kSumLoads];
#pragma unroll
      for (int u = 0; u < kSumLoads; ++u) v[u] = __ldcg(p + (j + u * lanes) * stride);
#pragma unroll
      for (int u = 0; u < kSumLoads; ++u) sum_into(acc, v[u]);
    }
    if (j < P) {  // the last rows, fewer than kSumLoads, loaded at once
      T v[kSumLoads - 1];
#pragma unroll
      for (int u = 0; u < kSumLoads - 1; ++u)
        if (j + u * lanes < P) v[u] = __ldcg(p + (j + u * lanes) * stride);
#pragma unroll
      for (int u = 0; u < kSumLoads - 1; ++u)
        if (j + u * lanes < P) sum_into(acc, v[u]);
    }
  }
  red[lane * n + o] = acc;
  return lanes;
}

template <typename T>
__device__ __forceinline__ T column_total(const T* red, int n, int lanes, int o) {
  T t{};
  for (int l = 0; l < lanes; ++l) sum_into(t, red[l * n + o]);
  return t;
}

}  // namespace ktpu
