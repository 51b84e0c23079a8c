// K4 and K5: per-coordinate order statistics over the worker axis of a
// (W, D) message matrix, for any W >= 1.
//
// K4 coordinate_median: out[d] = the median of z[:, d]; for even W, the mean
// of the two middle order statistics ((lo + hi) * 0.5, as jnp.median does).
// Replaces: repro/kernels/robust_stats.py, coordinate_median_call
// (_median_kernel).
// K5 trimmed_mean: out[d] = the mean of z[:, d]'s order statistics of rank
// [trim, W - trim).  Replaces: repro/kernels/robust_stats.py,
// trimmed_mean_call (_trimmed_kernel).
//
// The TPU kernels keep a (W, tile) slab in VMEM and sort it along the worker
// axis.  Here a block of kTile threads owns kTile coordinates, one column per
// thread, and each thread ranks its column's values by counting,
//
//     rank(i) = #{j : v_j < v_i  or  (v_j == v_i and j < i)},
//
// which with ties broken by row index is a permutation of 0..W-1: the value
// of each rank is the sorted order's, whatever the order of equal values,
// and no sort is needed.  Candidates are ranked kGroup at a time, so one
// load serves kGroup comparisons.  K5 adds the values of rank
// [trim, W - trim) in row order with float32 accumulation, so it sums in
// another order than a sort would (rtol 1e-5 against the plain version);
// K4 selects, so it is bitwise.  Two routes for the column's values, with
// the same arithmetic and so the same bits:
//
// * W <= 454: the block stages its (W, kTile) slab in shared memory (W *
//   kTile * 4 bytes; dynamic shared memory above 48 KB): shared memory
//   serves as the per-thread array that registers cannot be.
// * W > 454, whose slab would pass the 232,448 bytes a block may use: the
//   ranks are counted from global memory, each thread re-reading its column
//   (W^2 loads a coordinate, coalesced across the warp, from L1/L2).
//   Correct for any W; not fast.
// Both use 32 registers and no spills.
//
// Bound on the H100: the W * D * 4 bytes of z are read from HBM once
// (11.1 MB at W = 70, D = 39,760: 3.3 us), but the counting does W^2
// comparisons per coordinate (4,900 at W = 70), one thread per coordinate:
// this simple form is bound by instruction issue and latency (about nine
// warps per SM at D = 39,760), not by HBM.  Splitting a column's candidates
// over several threads, or a selection network in registers, is later work.
//
// NaN: every comparison with NaN is false, so a NaN gets rank 0 and the
// ranks of its column are no longer a permutation; that column's result is
// then unspecified and may differ from the plain version (which sorts NaN
// last).  NaN rows come only from the fault attacks, which the guards of
// the reference remove before aggregation.
#include "common.cuh"

namespace {

constexpr int kTile = 128;   // coordinates (threads) per block
constexpr int kGroup = 4;    // candidates ranked per pass over the column
// The most rows whose (W, kTile) float32 slab fits the 232,448 bytes of
// shared memory a block may use on Hopper.
constexpr int kMaxSlabRows = 454;

// One thread's column: row i of the slab in shared memory (rows kTile floats
// apart) ...
struct SlabColumn {
  const float* v;
  __device__ __forceinline__ float operator[](int i) const { return v[i * kTile]; }
};
// ... or of z itself in global memory (rows D floats apart).
struct GlobalColumn {
  const float* v;
  int64_t D;
  __device__ __forceinline__ float operator[](int i) const {
    return __ldg(v + static_cast<int64_t>(i) * D);
  }
};

// Ranks of the kGroup candidates i0 .. i0 + kGroup - 1 of one column.
template <typename Col>
__device__ __forceinline__ void rank_group(const Col& v, int W, int i0,
                                           float (&c)[kGroup], int (&r)[kGroup]) {
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    c[g] = v[i0 + g];
    r[g] = 0;
  }
  // Rows before the group rank below an equal candidate ...
  for (int j = 0; j < i0; ++j) {
    const float vj = v[j];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) r[g] += (vj <= c[g]);
  }
  // ... rows inside the group by their index ...
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      r[g] += (c[j] < c[g]) || (c[j] == c[g] && j < g);
  }
  // ... and rows after it only when strictly smaller.
  for (int j = i0 + kGroup; j < W; ++j) {
    const float vj = v[j];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) r[g] += (vj < c[g]);
  }
}

template <typename Col>
__device__ __forceinline__ int rank_one(const Col& v, int W, int i, float ci) {
  int r = 0;
  for (int j = 0; j < i; ++j) r += (v[j] <= ci);
  for (int j = i + 1; j < W; ++j) r += (v[j] < ci);
  return r;
}

// kMedian: out = (value of rank lo + value of rank hi) * 0.5, or the value of
// rank lo when lo == hi.  Otherwise: out = mean of the values of rank
// [lo, hi).
template <bool kMedian, typename Col>
__device__ __forceinline__ float order_stat(const Col& v, int W, int lo, int hi) {
  float a = 0.f, b = 0.f, acc = 0.f;
  auto take = [&](float ci, int r) {
    if (kMedian) {
      if (r == lo) a = ci;
      if (r == hi) b = ci;
    } else if (r >= lo && r < hi) {
      acc += ci;
    }
  };
  int i = 0;
  for (; i + kGroup <= W; i += kGroup) {
    float c[kGroup];
    int r[kGroup];
    rank_group(v, W, i, c, r);
#pragma unroll
    for (int g = 0; g < kGroup; ++g) take(c[g], r[g]);
  }
  for (; i < W; ++i) {
    const float ci = v[i];
    take(ci, rank_one(v, W, i, ci));
  }
  if (kMedian) return (lo == hi) ? a : (a + b) * 0.5f;
  return acc / static_cast<float>(hi - lo);
}

template <bool kMedian>
__global__ void order_stat_kernel(const float* __restrict__ z,
                                  float* __restrict__ out, int W, int64_t D,
                                  int lo, int hi) {
  extern __shared__ float slab[];   // (W, kTile)
  const int t = threadIdx.x;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kTile + t;
  if (col >= D) return;   // each thread touches only its own column
  float* v = slab + t;
  for (int w = 0; w < W; ++w) v[w * kTile] = z[static_cast<int64_t>(w) * D + col];
  out[col] = order_stat<kMedian>(SlabColumn{v}, W, lo, hi);
}

template <bool kMedian>
__global__ void order_stat_global_kernel(const float* __restrict__ z,
                                         float* __restrict__ out, int W, int64_t D,
                                         int lo, int hi) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  if (col >= D) return;
  out[col] = order_stat<kMedian>(GlobalColumn{z + col, D}, W, lo, hi);
}

template <bool kMedian>
int launch(const float* z, float* out, int W, long long D, int lo, int hi,
           void* stream) {
  if (D == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((D + kTile - 1) / kTile);
  if (W > kMaxSlabRows) {
    order_stat_global_kernel<kMedian><<<blocks, kTile, 0, s>>>(
        z, out, W, static_cast<int64_t>(D), lo, hi);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(W) * kTile * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        order_stat_kernel<kMedian>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  order_stat_kernel<kMedian><<<blocks, kTile, smem, s>>>(
      z, out, W, static_cast<int64_t>(D), lo, hi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z: (W, D) float32 contiguous, out: (D,); W >= 1.
REPRO_EXPORT int coordinate_median_f32(const float* z, float* out, int W,
                                       long long D, void* stream) {
  return launch<true>(z, out, W, D, (W - 1) / 2, W / 2, stream);
}

// z: (W, D) float32 contiguous, out: (D,); 0 <= trim, 2 * trim < W.
REPRO_EXPORT int trimmed_mean_f32(const float* z, float* out, int W,
                                  long long D, int trim, void* stream) {
  return launch<false>(z, out, W, D, trim, W - trim, stream);
}
