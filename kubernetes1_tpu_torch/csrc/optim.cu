// K10 AdamW, K10b Adafactor and K10c SGD with momentum for Hopper: the
// optimizer updates as multi-tensor kernels over every f32 leaf at once.
//
// Replaces the updates that XLA fuses into the JAX package's donated step
// executables (the optax transformations, applied by optax.apply_updates):
//   K10  optax.adamw(lr, weight_decay=wd), kubernetes1_tpu/workloads/
//        llama.py:210,229-230 (wd 0.1), bert.py:171,191-192 (wd 0.01),
//        llama_bench.py:72.  With t = count + 1:
//          m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
//          u = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p
//          p = p + (-lr) u
//   K10b optax.adafactor(lr), llama_bench.py:74 (optax 0.2.6
//        factorized.scale_by_factored_rms, clip_by_block_rms(1),
//        scale(lr), scale_by_param_block_rms(1e-3), scale(-1)).  With
//        decay = 1 - t^-0.8 and g2 = g^2 + 1e-30, per leaf: factored (two
//        dims >= 128): v_row = decay v_row + (1 - decay) mean(g2 over d0),
//        v_col likewise over d1, u = g (v_row / mean(v_row))^-1/2 v_col^-1/2;
//        else v = decay v + (1 - decay) g2, u = g v^-1/2.  Then, per JAX
//        leaf (the stacked (L, ...) array: one number for all layers),
//        u = u / max(1, rms(u)), and p = p - lr max(rms(p), 1e-3) u.
//   K10c optax.sgd(lr, momentum=0.9), resnet.py:143,166,
//        resnet_bench.py:51, llama_bench.py:76:  t = g + 0.9 t;  p = p + (-lr) t
//
// Bound on the H100: bytes.  A few flops per 4-byte value.  The least an
// update moves is each input read once and each output written once:
// AdamW 28 bytes a parameter (p, g, m, v in; p, m, v out), SGD 20,
// Adafactor 12 for a factored leaf (its row and column statistics are
// small) and 20 for one that is not.
//
// Design.  One launch covers every leaf.  The caller keeps a device-side
// table of `Leaf` entries (pointers, sizes, 64-bit offsets) built once,
// and a column of gradient pointers that it refreshes each step; block b
// finds its leaf by a binary search over the leaves' first blocks.  A
// flat pass gives each block kChunk contiguous elements of one leaf:
// 16-byte loads and stores, a scalar tail where a leaf's size is not a
// multiple of 4.  The step count is a device int32 (optax's count); the
// bias corrections and Adafactor's decay are computed from it on the
// device, and the update increments it, so a step reads nothing back.
//
// Adafactor needs the row and column means of g^2 and two sums over each
// whole JAX leaf group before it can update, so it is five launches:
//   A   a factored leaf in tiles of kRows x kCols: per-tile column sums
//       and per-tile row sums of g2 (each tile writes its own slots);
//       where the caller asks (read_p), also each block's sum of p^2,
//       which for an unfactored leaf is all A does;
//   FA  per factored leaf, the row and column sums of the tiles added in
//       tile order, the new v_row and v_col (in place) and per-block sums
//       of the new v_row (for its mean);
//   B   u as above (v updated in place for unfactored leaves), and the
//       block's sum of u^2;
//   FB  per group, the sums of p^2 and u^2 over its blocks in block order:
//       the clip divisor and the parameter scale;  the count + 1;
//   C   u again from g and the new statistics, then p; and each block's
//       sum of the new p^2, for the next step's FB.
// Every reduction is a fixed tree over per-block f32 partials: no atomics,
// so the result depends only on the shapes, as in K8.
//
// What bounds it: bytes.  optax's chain needs three passes over g (the
// statistics need every g^2 of a stacked leaf, u needs the statistics,
// the clip needs sum(u^2) over the stacked leaf before any p is written),
// and a stacked leaf (up to ~1 GB) does not stay in the 50 MB of L2.  So
// the floor of this algorithm is 20 bytes a factored parameter (g three
// times, p read once and written once) against the bound's 12.  It gets
// there by carrying sum(p^2) across steps: C adds the p it writes in the
// same per-thread order and block tree that A uses when it reads p, so
// the next step's A reads only g, and the sums have the same bits either
// way.  The caller asks A to read p at the first update and whenever p
// was written by anything but C (kernels/optim.py, LeafTable).  The tile
// loops load 4-8 rows before they use any, so 8 16-byte loads a thread
// are in flight, and C walks its tiles last first, where B has just left
// g in L2.
//
// (AdamW and SGD read and write each value once: at their bounds' bytes.)

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 32768;    // elements of a flat pass's block
constexpr int kRows = 32;              // rows of an Adafactor tile
constexpr int kCols = 4 * kThreads;    // columns of an Adafactor tile
constexpr int kFin = 4 * kThreads;     // statistics of one finalize block

// One leaf of the table (mirrored in kernels/optim.py, LEAF_DTYPE).
struct Leaf {
  float* p;
  float* s0;          // AdamW m; SGD trace; Adafactor v (flat) or v_row
  float* s1;          // AdamW v; Adafactor v_col (factored)
  long long n;        // elements
  long long rows;     // Adafactor, factored: rows R of the (R, n / R) matrix
  long long block0;   // the leaf's first block in the A, B, C and flat grids
  long long fblock0;  // Adafactor: its first block in the FA grid
  long long part;     // Adafactor: offset of its tile sums in the workspace
  int group;          // Adafactor: its JAX leaf group
  int mode;           // Adafactor: kFlat, kFactoredCols or kFactoredRows
};
static_assert(sizeof(Leaf) == 72, "Leaf is mirrored in kernels/optim.py");

// kFactoredCols: optax's d0 (the axis v_row averages over) is the columns,
// so v_row has R entries and v_col n / R; kFactoredRows: d0 is the rows.
enum { kFlat = 0, kFactoredCols = 1, kFactoredRows = 2 };

// The leaf whose blocks hold block b: the last leaf whose first block is
// at most b (leaves with no blocks share their successor's first block).
__device__ __forceinline__ int find_leaf(const Leaf* leaves, int n_leaves, long long b,
                                         bool fin) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    const long long first = fin ? leaves[mid].fblock0 : leaves[mid].block0;
    if (first <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void store4(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

// Elements [c, c + 4) of a row of `cols` floats: a 16-byte load where the
// row width keeps every row 16-byte aligned, else scalar loads (0 past
// the end).
__device__ __forceinline__ void load_row4(const float* row, long long c, long long cols,
                                          bool vec, float* out) {
  if (vec) {
    load4(row + c, out);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = c + k < cols ? row[c + k] : 0.f;
  }
}

__device__ __forceinline__ void store_row4(float* row, long long c, long long cols, bool vec,
                                           const float* in) {
  if (vec) {
    store4(row + c, in);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c + k < cols) row[c + k] = in[k];
  }
}

template <int K> using Width = std::integral_constant<int, K>;

// Calls f(i, Width<4>) for the elements [start, end) of a flat leaf in
// groups of 4 (16-byte accesses at element i) up to the last multiple of
// 4, then f(i, Width<1>) one at a time.  `start` is a multiple of 4.
template <typename F>
__device__ __forceinline__ void for_chunk(long long start, long long end, F f) {
  const long long vend = start + ((end - start) & ~3LL);
  for (long long i = start + 4LL * threadIdx.x; i < vend; i += 4LL * kThreads) f(i, Width<4>{});
  for (long long i = vend + threadIdx.x; i < end; i += kThreads) f(i, Width<1>{});
}

// K (4 or 1) floats at p[i].
template <int K>
__device__ __forceinline__ void load_k(const float* p, long long i, float* out) {
  if (K == 4) load4(p + i, out); else out[0] = p[i];
}

template <int K>
__device__ __forceinline__ void store_k(float* p, long long i, const float* in) {
  if (K == 4) store4(p + i, in); else p[i] = in[0];
}

// ------------------------------------------------------------ K10 AdamW

__global__ void __launch_bounds__(kThreads)
adamw_kernel(const Leaf* __restrict__ leaves, const float* const* __restrict__ grads,
             int n_leaves, const int* __restrict__ count, float lr, float b1, float b2,
             float omb1, float omb2, float eps, float wd) {
  const long long b = blockIdx.x;
  const int li = find_leaf(leaves, n_leaves, b, false);
  const Leaf L = leaves[li];
  const float* g = grads[li];
  const float t = static_cast<float>(*count + 1);
  const float bc1 = 1.f - powf(b1, t), bc2 = 1.f - powf(b2, t);
  const long long start = (b - L.block0) * kChunk;
  const long long end = min(start + kChunk, L.n);
  for_chunk(start, end, [&](long long i, auto width) {
    constexpr int k = decltype(width)::value;
    float pv[4], gv[4], mv[4], vv[4];
    load_k<k>(L.p, i, pv);
    load_k<k>(g, i, gv);
    load_k<k>(L.s0, i, mv);
    load_k<k>(L.s1, i, vv);
#pragma unroll
    for (int e = 0; e < k; ++e) {
      mv[e] = omb1 * gv[e] + b1 * mv[e];
      vv[e] = omb2 * (gv[e] * gv[e]) + b2 * vv[e];
      const float u = (mv[e] / bc1) / (sqrtf(vv[e] / bc2) + eps) + wd * pv[e];
      pv[e] = pv[e] + u * -lr;
    }
    store_k<k>(L.p, i, pv);
    store_k<k>(L.s0, i, mv);
    store_k<k>(L.s1, i, vv);
  });
}

__global__ void increment_kernel(int* count) { *count += 1; }

// ------------------------------------------------------ K10c SGD momentum

__global__ void __launch_bounds__(kThreads)
sgdm_kernel(const Leaf* __restrict__ leaves, const float* const* __restrict__ grads,
            int n_leaves, float lr, float momentum) {
  const long long b = blockIdx.x;
  const int li = find_leaf(leaves, n_leaves, b, false);
  const Leaf L = leaves[li];
  const float* g = grads[li];
  const long long start = (b - L.block0) * kChunk;
  const long long end = min(start + kChunk, L.n);
  for_chunk(start, end, [&](long long i, auto width) {
    constexpr int k = decltype(width)::value;
    float pv[4], gv[4], tv[4];
    load_k<k>(L.p, i, pv);
    load_k<k>(g, i, gv);
    load_k<k>(L.s0, i, tv);
#pragma unroll
    for (int e = 0; e < k; ++e) {
      tv[e] = gv[e] + momentum * tv[e];
      pv[e] = pv[e] + tv[e] * -lr;
    }
    store_k<k>(L.p, i, pv);
    store_k<k>(L.s0, i, tv);
  });
}

// ------------------------------------------------------- K10b Adafactor

struct Tile {
  long long R, C, band, cc, r0, r1, c;
  bool vec;
};

// Block b's tile of a factored leaf: row band `band` (kRows rows) by
// column chunk `cc` (kCols columns); this thread's 4 columns start at c.
__device__ __forceinline__ Tile tile_of(const Leaf& L, long long b) {
  Tile T;
  T.R = L.rows;
  T.C = L.n / L.rows;
  const long long nbc = (T.C + kCols - 1) / kCols;
  const long long tile = b - L.block0;
  T.band = tile / nbc;
  T.cc = tile - T.band * nbc;
  T.r0 = T.band * kRows;
  T.r1 = min(T.r0 + kRows, T.R);
  T.c = T.cc * kCols + 4LL * threadIdx.x;
  T.vec = (T.C & 3) == 0;
  return T;
}

__device__ __forceinline__ float decay_at(const int* count, float decay_exp) {
  return 1.f - powf(static_cast<float>(*count + 1), -decay_exp);
}

__device__ __forceinline__ float rsqrt_f(float x) { return 1.f / sqrtf(x); }

// mean(v_row) of a factored leaf: its FA blocks' sums, added in order.
__device__ __forceinline__ float vrow_mean(const Leaf* leaves, int li, int n_leaves,
                                           long long n_fblocks, const float* vpart) {
  const Leaf& L = leaves[li];
  const long long f1 = li + 1 < n_leaves ? leaves[li + 1].fblock0 : n_fblocks;
  float s = 0.f;
  for (long long f = L.fblock0; f < f1; ++f) s += vpart[f];
  const long long nrow = L.mode == kFactoredCols ? L.rows : L.n / L.rows;
  return s / static_cast<float>(nrow);
}

// The factored update's two factors for this block's tile: fr[r - r0] for
// each row (shared), fc[k] for this thread's columns; u = (g*first)*second
// with optax's v_row factor first.
struct Factors {
  float fc[4];
  bool row_first;
};

__device__ __forceinline__ Factors tile_factors(const Leaf& L, const Tile& T, float rcm,
                                                float* fr) {
  Factors F;
  F.row_first = L.mode == kFactoredCols;
  if (threadIdx.x < T.r1 - T.r0) {
    const long long i = T.r0 + threadIdx.x;
    fr[threadIdx.x] = F.row_first ? rsqrt_f(L.s0[i] / rcm) : rsqrt_f(L.s1[i]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long j = T.c + k;
    F.fc[k] = j < T.C ? (F.row_first ? rsqrt_f(L.s1[j]) : rsqrt_f(L.s0[j] / rcm)) : 0.f;
  }
  __syncthreads();
  return F;
}

__device__ __forceinline__ float factored_u(float g, float frow, float fcol, bool row_first) {
  return row_first ? (g * frow) * fcol : (g * fcol) * frow;
}

// Loads U rows of a tile, from row r, into v[u] (zeros past the tile's
// last row or past the row's end), all before any is used.
template <int U>
__device__ __forceinline__ void load_rows4(const float* base, const Tile& T, long long r,
                                           float (&v)[U][4]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (r + u < T.r1 && T.c < T.C) {
      load_row4(base + (r + u) * T.C, T.c, T.C, T.vec, v[u]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[u][k] = 0.f;
    }
  }
}

// sum(p^2) of one thread, element by element in the order of the tile
// loops (rows, then this thread's 4 columns) or of for_chunk: A (reading
// p) and C (writing it) add the same values in the same order.
__device__ __forceinline__ float add_square(float acc, float p) { return __fmaf_rn(p, p, acc); }

// A: tile sums of g2 (factored) and, with kReadP, the block's sum of p^2.
template <bool kReadP>
__global__ void __launch_bounds__(kThreads)
adafactor_a_kernel(const Leaf* __restrict__ leaves, const float* const* __restrict__ grads,
                   int n_leaves, float* __restrict__ fpart, float* __restrict__ ppart,
                   float eps) {
  constexpr int U = kReadP ? 4 : 8;  // rows loaded at once: 8 loads a thread in flight
  __shared__ float red[kThreads / 32][kRows];
  __shared__ float scratch[32];
  const long long b = blockIdx.x;
  const int li = find_leaf(leaves, n_leaves, b, false);
  const Leaf L = leaves[li];
  float pp = 0.f;
  if (L.mode == kFlat) {
    if (!kReadP) return;  // C of the last step left this block's sum of p^2
    const long long start = (b - L.block0) * kChunk;
    for_chunk(start, min(start + kChunk, L.n), [&](long long i, auto width) {
      constexpr int k = decltype(width)::value;
      float pv[4];
      load_k<k>(L.p, i, pv);
#pragma unroll
      for (int e = 0; e < k; ++e) pp = add_square(pp, pv[e]);
    });
  } else {
    const float* g = grads[li];
    const Tile T = tile_of(L, b);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float col[4] = {0.f, 0.f, 0.f, 0.f};
    for (long long r = T.r0; r < T.r1; r += U) {
      float gv[U][4], pv[U][4];
      load_rows4<U>(g, T, r, gv);
      if (kReadP) load_rows4<U>(L.p, T, r, pv);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u >= T.r1) break;  // the same for the whole block
        float rs = 0.f;
        if (T.c < T.C) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (T.c + k < T.C) {
              const float s = gv[u][k] * gv[u][k] + eps;
              col[k] += s;
              rs += s;
              if (kReadP) pp = add_square(pp, pv[u][k]);
            }
          }
        }
        rs = warp_sum(rs);
        if (lane == 0) red[warp][r + u - T.r0] = rs;
      }
    }
    __syncthreads();
    float* colpart = fpart + L.part;                                // (bands, C)
    float* rowpart = colpart + (T.R + kRows - 1) / kRows * T.C;     // (chunks, R)
    if (threadIdx.x < T.r1 - T.r0) {
      float s = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) s += red[w][threadIdx.x];
      rowpart[T.cc * T.R + T.r0 + threadIdx.x] = s;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (T.c + k < T.C) colpart[T.band * T.C + T.c + k] = col[k];
    if (!kReadP) return;
  }
  pp = ktpu::block_sum(pp, scratch);
  if (threadIdx.x == 0) ppart[b] = pp;
}

// FA: per factored leaf, kFin of its R + C statistics a block (rows first,
// then columns): the means of g2, the new v_row and v_col in place, and
// the block's sum of the new v_row.  A thread's kFin / kThreads statistics
// each add up to one tile sum per column chunk (a row) or per row band (a
// column: ~1000 of them down a 32000-row embedding), in order; the loads
// of all of them go out kSumLoads at a time before their adds.
__global__ void __launch_bounds__(kThreads)
adafactor_fa_kernel(const Leaf* __restrict__ leaves, int n_leaves,
                    const float* __restrict__ fpart, float* __restrict__ vpart,
                    const int* __restrict__ count, float decay_exp) {
  constexpr int J = kFin / kThreads, kSumLoads = 8;
  __shared__ float scratch[32];
  const long long b = blockIdx.x;
  const Leaf L = leaves[find_leaf(leaves, n_leaves, b, true)];
  const long long R = L.rows, C = L.n / L.rows;
  const long long bands = (R + kRows - 1) / kRows, chunks = (C + kCols - 1) / kCols;
  const float* colpart = fpart + L.part;
  const float* rowpart = colpart + bands * C;
  const float decay = decay_at(count, decay_exp);
  const bool cols_d0 = L.mode == kFactoredCols;
  // statistic j: row k < R (its mean over the columns) or column k - R
  const float* src[J];
  long long stride[J], n[J], idx[J];
  bool row[J];
  float sum[J];
  long long most = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const long long k = (b - L.fblock0) * kFin + j * kThreads + threadIdx.x;
    sum[j] = 0.f;
    row[j] = k < R;
    n[j] = k >= R + C ? 0 : (row[j] ? chunks : bands);
    idx[j] = row[j] ? k : k - R;
    src[j] = row[j] ? rowpart + k : colpart + idx[j];
    stride[j] = row[j] ? R : C;
    most = n[j] > most ? n[j] : most;
  }
  for (long long i0 = 0; i0 < most; i0 += kSumLoads) {
    float t[J][kSumLoads];
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int u = 0; u < kSumLoads; ++u)
        t[j][u] = i0 + u < n[j] ? src[j][(i0 + u) * stride[j]] : 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int u = 0; u < kSumLoads; ++u)
        if (i0 + u < n[j]) sum[j] += t[j][u];
  }
  float vrow_sum = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (n[j] == 0) break;
    const float mean = sum[j] / static_cast<float>(row[j] ? C : R);
    const bool is_vrow = row[j] == cols_d0;  // a row's mean is over the columns
    float* v = is_vrow ? L.s0 : L.s1;
    const float nv = decay * v[idx[j]] + (1.f - decay) * mean;
    v[idx[j]] = nv;
    if (is_vrow) vrow_sum += nv;
  }
  vrow_sum = ktpu::block_sum(vrow_sum, scratch);
  if (threadIdx.x == 0) vpart[b] = vrow_sum;
}

// B: u, the new v of unfactored leaves, and the block's sum of u^2.
__global__ void __launch_bounds__(kThreads)
adafactor_b_kernel(const Leaf* __restrict__ leaves, const float* const* __restrict__ grads,
                   int n_leaves, long long n_fblocks, const float* __restrict__ vpart,
                   float* __restrict__ upart, const int* __restrict__ count, float decay_exp,
                   float eps) {
  __shared__ float fr[kRows];
  __shared__ float scratch[32];
  const long long b = blockIdx.x;
  const int li = find_leaf(leaves, n_leaves, b, false);
  const Leaf L = leaves[li];
  const float* g = grads[li];
  float uu = 0.f;
  if (L.mode == kFlat) {
    const float decay = decay_at(count, decay_exp);
    const long long start = (b - L.block0) * kChunk;
    for_chunk(start, min(start + kChunk, L.n), [&](long long i, auto width) {
    constexpr int k = decltype(width)::value;
      float gv[4], vv[4];
      load_k<k>(g, i, gv);
      load_k<k>(L.s0, i, vv);
#pragma unroll
      for (int e = 0; e < k; ++e) {
        vv[e] = decay * vv[e] + (1.f - decay) * (gv[e] * gv[e] + eps);
        const float u = gv[e] * rsqrt_f(vv[e]);
        uu += u * u;
      }
      store_k<k>(L.s0, i, vv);
    });
  } else {
    const Tile T = tile_of(L, b);
    const Factors F = tile_factors(L, T, vrow_mean(leaves, li, n_leaves, n_fblocks, vpart), fr);
    if (T.c < T.C) {
      constexpr int U = 8;
      for (long long r = T.r0; r < T.r1; r += U) {
        float gv[U][4];
        load_rows4<U>(g, T, r, gv);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (r + u >= T.r1) break;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float v = factored_u(gv[u][k], fr[r + u - T.r0], F.fc[k], F.row_first);
            uu += T.c + k < T.C ? v * v : 0.f;
          }
        }
      }
    }
  }
  uu = ktpu::block_sum(uu, scratch);
  if (threadIdx.x == 0) upart[b] = uu;
}

// FB: per group, the sums of p^2 and u^2 over its blocks, in block order:
// gstat = (max(1, rms(u) / clip), max(rms(p), min_scale)).  Block 0 also
// counts the step.
__global__ void __launch_bounds__(kThreads)
adafactor_fb_kernel(const long long* __restrict__ groups, const float* __restrict__ ppart,
                    const float* __restrict__ upart, float* __restrict__ gstat,
                    int* __restrict__ count, float clip, float min_scale) {
  __shared__ float scratch[32];
  const long long b0 = groups[3 * blockIdx.x], b1 = groups[3 * blockIdx.x + 1];
  const float n = static_cast<float>(groups[3 * blockIdx.x + 2]);
  float sp = 0.f, su = 0.f;
  for (long long i = b0 + threadIdx.x; i < b1; i += kThreads) {
    sp += ppart[i];
    su += upart[i];
  }
  sp = ktpu::block_sum(sp, scratch);
  __syncthreads();  // scratch is reused
  su = ktpu::block_sum(su, scratch);
  if (threadIdx.x == 0) {
    gstat[2 * blockIdx.x] = fmaxf(1.f, sqrtf(su / n) / clip);
    const float rms_p = sqrtf(sp / n);
    gstat[2 * blockIdx.x + 1] = rms_p <= min_scale ? min_scale : rms_p;
    if (blockIdx.x == 0) *count += 1;
  }
}

// C: u again, then p = p + -(((u / clip_div) * lr) * p_scale), and the
// block's sum of the new p^2 (A's order).  Blocks walk the tiles last
// first: B read the last ones last, so they may still be in L2.
__global__ void __launch_bounds__(kThreads)
adafactor_c_kernel(const Leaf* __restrict__ leaves, const float* const* __restrict__ grads,
                   int n_leaves, long long n_fblocks, const float* __restrict__ vpart,
                   const float* __restrict__ gstat, float* __restrict__ ppart, float lr) {
  __shared__ float fr[kRows];
  __shared__ float scratch[32];
  const long long b = gridDim.x - 1LL - blockIdx.x;
  const int li = find_leaf(leaves, n_leaves, b, false);
  const Leaf L = leaves[li];
  const float* g = grads[li];
  const float div = gstat[2 * L.group], scale = gstat[2 * L.group + 1];
  float pp = 0.f;
  if (L.mode == kFlat) {
    const long long start = (b - L.block0) * kChunk;
    for_chunk(start, min(start + kChunk, L.n), [&](long long i, auto width) {
      constexpr int k = decltype(width)::value;
      float pv[4], gv[4], vv[4];
      load_k<k>(L.p, i, pv);
      load_k<k>(g, i, gv);
      load_k<k>(L.s0, i, vv);
#pragma unroll
      for (int e = 0; e < k; ++e) {
        const float u = gv[e] * rsqrt_f(vv[e]);
        pv[e] = pv[e] + -(((u / div) * lr) * scale);
        pp = add_square(pp, pv[e]);
      }
      store_k<k>(L.p, i, pv);
    });
  } else {
    const Tile T = tile_of(L, b);
    const Factors F = tile_factors(L, T, vrow_mean(leaves, li, n_leaves, n_fblocks, vpart), fr);
    if (T.c < T.C) {
      constexpr int U = 4;
      for (long long r = T.r0; r < T.r1; r += U) {
        float gv[U][4], pv[U][4];
        load_rows4<U>(g, T, r, gv);
        load_rows4<U>(L.p, T, r, pv);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (r + u >= T.r1) break;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float v = factored_u(gv[u][k], fr[r + u - T.r0], F.fc[k], F.row_first);
            pv[u][k] = pv[u][k] + -(((v / div) * lr) * scale);
            if (T.c + k < T.C) pp = add_square(pp, pv[u][k]);
          }
          store_row4(L.p + (r + u) * T.C, T.c, T.C, T.vec, pv[u]);
        }
      }
    }
  }
  pp = ktpu::block_sum(pp, scratch);
  if (threadIdx.x == 0) ppart[b] = pp;
}

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// leaves: n_leaves Leaf entries (device); grads: n_leaves f32 pointers
// (device); count: int32 (device), incremented.  nblocks: the flat grid
// (sum over leaves of ceil(n / kChunk)).  omb1, omb2: 1 - b1 and 1 - b2,
// rounded from double as optax's f32 arithmetic rounds them.  Two
// launches: the update, then the count.
extern "C" int ktpu_adamw_f32(const void* leaves, const void* grads, int n_leaves,
                              long long nblocks, void* count, float lr, float b1, float b2,
                              float omb1, float omb2, float eps, float wd, void* stream) {
  if (n_leaves <= 0 || nblocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  adamw_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0, st>>>(
      static_cast<const Leaf*>(leaves), static_cast<const float* const*>(grads), n_leaves,
      static_cast<const int*>(count), lr, b1, b2, omb1, omb2, eps, wd);
  const int e = last_error();
  if (e) return e;
  increment_kernel<<<1, 1, 0, st>>>(static_cast<int*>(count));
  return last_error();
}

// As ktpu_adamw_f32; the table's s0 is the momentum trace.  One launch.
extern "C" int ktpu_sgdm_f32(const void* leaves, const void* grads, int n_leaves,
                             long long nblocks, float lr, float momentum, void* stream) {
  if (n_leaves <= 0 || nblocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  sgdm_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), static_cast<const float* const*>(grads), n_leaves, lr,
      momentum);
  return last_error();
}

// leaves, grads, count as for AdamW, leaves ordered by group; nblocks: the
// A/B/C grid (flat leaves ceil(n / kChunk) blocks, factored ones
// ceil(R / kRows) * ceil(C / kCols) tiles); n_fblocks: the FA grid
// (ceil((R + C) / kFin) per factored leaf); groups: (n_groups, 3) int64
// (first block, end block, elements).  Scratch, f32: fpart (each factored
// leaf's ceil(R / kRows) * C + ceil(C / kCols) * R tile sums, at its
// `part`), vpart (n_fblocks), ppart and upart (nblocks), gstat
// (2 n_groups).  ppart is also state: each block's sum of p^2, which C
// leaves for the next call; read_p != 0 has A sum p^2 from p instead
// (required at the first call, and after anything else wrote p).  Five
// launches.
extern "C" int ktpu_adafactor_f32(const void* leaves, const void* grads, int n_leaves,
                                  long long nblocks, long long n_fblocks, const void* groups,
                                  int n_groups, void* fpart, void* vpart, void* ppart,
                                  void* upart, void* gstat, void* count, int read_p, float lr,
                                  float decay_exp, float eps, float clip, float min_scale,
                                  void* stream) {
  if (n_leaves <= 0 || nblocks <= 0 || n_groups <= 0 || n_fblocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Leaf* lv = static_cast<const Leaf*>(leaves);
  const float* const* gp = static_cast<const float* const*>(grads);
  const unsigned grid = static_cast<unsigned>(nblocks);
  auto a_kernel = read_p ? adafactor_a_kernel<true> : adafactor_a_kernel<false>;
  a_kernel<<<grid, kThreads, 0, st>>>(lv, gp, n_leaves, static_cast<float*>(fpart),
                                      static_cast<float*>(ppart), eps);
  int e = last_error();
  if (e) return e;
  if (n_fblocks > 0) {
    adafactor_fa_kernel<<<static_cast<unsigned>(n_fblocks), kThreads, 0, st>>>(
        lv, n_leaves, static_cast<const float*>(fpart), static_cast<float*>(vpart),
        static_cast<const int*>(count), decay_exp);
    if ((e = last_error())) return e;
  }
  adafactor_b_kernel<<<grid, kThreads, 0, st>>>(lv, gp, n_leaves, n_fblocks,
                                                static_cast<const float*>(vpart),
                                                static_cast<float*>(upart),
                                                static_cast<const int*>(count), decay_exp, eps);
  if ((e = last_error())) return e;
  adafactor_fb_kernel<<<n_groups, kThreads, 0, st>>>(
      static_cast<const long long*>(groups), static_cast<const float*>(ppart),
      static_cast<const float*>(upart), static_cast<float*>(gstat), static_cast<int*>(count),
      clip, min_scale);
  if ((e = last_error())) return e;
  adafactor_c_kernel<<<grid, kThreads, 0, st>>>(lv, gp, n_leaves, n_fblocks,
                                                static_cast<const float*>(vpart),
                                                static_cast<const float*>(gstat),
                                                static_cast<float*>(ppart), lr);
  return last_error();
}
