// Device pieces shared by the kernels that read only some rows of a matrix
// (K3 weighted_sum, the masked route of K2 partial_sqdist, K7
// masked_neighbor_reduce): compacting a row of weights or mask entries into
// the ascending list of the rows to read, fixed-order block sums, the loads
// of a warp's 128 coordinates of one row (256 for a bfloat16 row read 16
// bytes a lane), and the fixed-order sum of the kept rows that K3 and K7's
// trim-0 route share.
#pragma once

#include "common.cuh"

namespace rows {

// Row predicates for compact().
struct NonZero {
  __device__ bool operator()(float x) const { return x != 0.f; }
};
struct Positive {
  __device__ bool operator()(float x) const { return x > 0.f; }
};

// Compacts the entries i in [lo, hi) of `v` for which keep(v[i]) holds into
// s_row[k] = i (and s_val[k] = v[i] unless s_val is null), k = 0, 1, ... in
// ascending order of i: a ballot and a prefix count per warp, the warps in
// order.  s_row (and s_val) must hold hi - lo entries.  Returns the count, the
// same in every thread.  Every thread of the block (32 * kWarps) must call it.
// It passes a barrier before it writes the lists, so the block may call it
// again while warps still read the last lists, and ends with one, so the
// lists may be read right away.
template <int kWarps, typename Keep>
__device__ int compact(const float* __restrict__ v, int lo, int hi, Keep keep,
                       int* s_row, float* s_val, int* warp_n) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int n = 0;
  for (int i0 = lo; i0 < hi; i0 += 32 * kWarps) {
    const int i = i0 + static_cast<int>(threadIdx.x);
    const float x = i < hi ? v[i] : 0.f;
    const bool on = i < hi && keep(x);
    const unsigned bits = __ballot_sync(0xffffffffu, on);
    if (lane == 0) warp_n[warp] = __popc(bits);
    __syncthreads();
    int at = n, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? warp_n[w] : 0;
      total += warp_n[w];
    }
    if (on) {
      const int k = at + __popc(bits & ((1u << lane) - 1u));
      if (s_val != nullptr) s_val[k] = x;
      s_row[k] = i;
    }
    n += total;
    __syncthreads();
  }
  return n;
}

// Sum over a warp in a fixed tree, returned to every lane.
__device__ __forceinline__ float warp_total(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the block (32 * kWarps threads) in a fixed order (each warp's
// tree, then the warps in order), returned to every thread.  Every thread
// must call it; s_warp holds kWarps floats.
template <int kWarps>
__device__ float block_total(float v, float* s_warp) {
  v = warp_total(v);
  if (threadIdx.x % 32 == 0) s_warp[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += s_warp[w];
  __syncthreads();
  return total;
}

// The coordinate of value i (0..3) that load_cols gives `lane`.
template <bool VEC>
__device__ __forceinline__ int64_t col_of(int64_t d0, int lane, int i) {
  return VEC ? d0 + 4 * lane + i : d0 + lane + 32 * i;
}

// The 4 coordinates of `lane` in the 128 starting at d0, from row `p`, as
// float32: d0 + 4 lane + i with VEC (one 4-element load where all 4 lie
// below D: a float4, or 8 bytes of bfloat16), else d0 + lane + 32 i.
// Coordinates past D read 0.  VEC needs p aligned to 4 elements and d0 a
// multiple of 4.  A bfloat16 row converts exactly, so every sum over it is
// the sum over its float32 upcast.
template <bool VEC, typename T>
__device__ __forceinline__ float4 load_cols(const T* p, int64_t d0, int lane,
                                            int64_t D) {
  float x[4];
  if (VEC && d0 + 4 * lane + 3 < D) return ldg4_f32(p + d0 + 4 * lane);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t d = col_of<VEC>(d0, lane, i);
    x[i] = d < D ? ldg_f32(p + d) : 0.f;
  }
  return make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void add4(const float4& v, float4& acc) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// Stores the 4 values of `lane` (as load_cols laid them out) below D; one
// float4 store where VEC, D % 4 == 0 and all 4 lie below D.
template <bool VEC>
__device__ __forceinline__ void store_cols(float* p, int64_t d0, int lane,
                                           int64_t D, const float4& v) {
  if (VEC && (D & 3) == 0 && d0 + 4 * lane + 3 < D) {
    *reinterpret_cast<float4*>(p + d0 + 4 * lane) = v;
    return;
  }
  const float y[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t d = col_of<VEC>(d0, lane, i);
    if (d < D) p[d] = y[i];
  }
}

// The 8-column layout of a bfloat16 row: `lane` holds the 8 coordinates
// d0 + 8 lane + i (i = 0..7) of the 256 from d0, in one 16-byte load, so a
// warp moves 512 bytes of a row as the float32 4-column layout does.
// load_cols8 returns the raw words (ldg8_raw), converted where they are
// added.  Where not all 8 lie below D, one 2-byte load per coordinate below
// D and 0 (+0.0) past it.  p must be aligned to 8 elements and d0 a
// multiple of 8.
__device__ __forceinline__ uint4 load_cols8(const __nv_bfloat16* p, int64_t d0,
                                            int lane, int64_t D) {
  const int64_t d = d0 + 8 * lane;
  if (d + 7 < D) return ldg8_raw(p + d);
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p) + d;
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned lo = d + 2 * i < D ? __ldg(h + 2 * i) : 0u;
    const unsigned hi = d + 2 * i + 1 < D ? __ldg(h + 2 * i + 1) : 0u;
    w[i] = lo | hi << 16;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Stores the 8 values of `lane` (as load_cols8 lays them out, lo the first
// 4) below D: two float4 stores where D % 4 == 0 and all 8 lie below D.
__device__ __forceinline__ void store_cols8(float* p, int64_t d0, int lane,
                                            int64_t D, const float4& lo,
                                            const float4& hi) {
  const int64_t d = d0 + 8 * lane;
  if ((D & 3) == 0 && d + 7 < D) {
    *reinterpret_cast<float4*>(p + d) = lo;
    *reinterpret_cast<float4*>(p + d + 4) = hi;
    return;
  }
  const float y[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (d + i < D) p[d + i] = y[i];
}

// The two column layouts of sum_kept_rows.  A lane loads its kN coordinates
// of a row as a Raw, turns them into kN / 4 float4s of values where it adds
// them, and stores its kN sums; a block covers kCols = 32 kN coordinates.
// Cols4: load_cols/store_cols (float32 rows, and bfloat16 rows whose base
// or strides do not allow Cols8).
template <bool VEC>
struct Cols4 {
  static constexpr int kN = 4;
  static constexpr int kCols = 32 * kN;
  using Raw = float4;
  template <typename T>
  __device__ static Raw load(const T* p, int64_t d0, int lane, int64_t D) {
    return load_cols<VEC>(p, d0, lane, D);
  }
  __device__ static void values(const Raw& r, float4 (&v)[1]) { v[0] = r; }
  __device__ static void store(float* p, int64_t d0, int lane, int64_t D,
                               const float4 (&v)[1]) {
    store_cols<VEC>(p, d0, lane, D, v[0]);
  }
};

// Cols8: load_cols8/store_cols8 (bfloat16 rows with Cols8::fits).
struct Cols8 {
  static constexpr int kN = 8;
  static constexpr int kCols = 32 * kN;
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p, int64_t d0, int lane, int64_t D) {
    return load_cols8(p, d0, lane, D);
  }
  __device__ static void values(const Raw& u, float4 (&v)[2]) {
    v[0] = bf16x4_f32(make_uint2(u.x, u.y));
    v[1] = bf16x4_f32(make_uint2(u.z, u.w));
  }
  __device__ static void store(float* p, int64_t d0, int lane, int64_t D,
                               const float4 (&v)[2]) {
    store_cols8(p, d0, lane, D, v[0], v[1]);
  }
  // Rows at base z with strides ld and rs (elements) take this layout: z
  // 16-byte aligned, ld and rs multiples of 8.
  __host__ static bool fits(const __nv_bfloat16* z, int64_t ld, int64_t rs) {
    return reinterpret_cast<uintptr_t>(z) % 16 == 0 && ld % 8 == 0 && rs % 8 == 0;
  }
};

// ---- Fixed-order sums of the rows a predicate keeps (K3 weighted_sum, K7's
// trim-0 route) -----------------------------------------------------------------

constexpr int kSumWarps = 8;                 // warps per block, each over a share of the rows
constexpr int kSumThreads = 32 * kSumWarps;
constexpr int kSumUnroll = 8;                // rows in flight per warp
constexpr int kSumCap = 2048;                // entries compacted at a time

__device__ __forceinline__ void fma4(float w, const float4& v, float4& acc) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

// Bytes of dynamic shared memory sum_kept_rows needs for S entries.
__host__ __forceinline__ size_t kept_rows_smem(long long S, bool weighted) {
  return static_cast<size_t>(S < kSumCap ? S : kSumCap) * (weighted ? 8 : 4);
}

// The block body of a sum over the rows s of z (at z + s * ld) whose entry
// v[s] (s in [0, S)) passes keep, times v[s] with kWeighted, else once each,
// over the Cols::kCols coordinates from d0 = blockIdx.x * Cols::kCols.  The
// kept entries are compacted kSumCap at a time, ascending, into
// kept_rows_smem(S, kWeighted) bytes of dynamic shared memory; warp w takes
// the compacted rows w, w + 8, ... with up to kSumUnroll rows' loads in
// flight and carries its sum from chunk to chunk; the 8 warps' sums are
// added in warp order.  The order of each coordinate's sum depends on
// nothing but v, not on the layout (Cols) or the grid, so every run and
// every layout gives the same bits: a bfloat16 row on Cols8 gives the bits
// of its float32 upcast on Cols4.  S <= kSumCap (one chunk) takes a
// straight-line call of the same chunk body, with the same bits: on the
// H100 it saves about 0.18 us of K3's 5 us at workload B and 3 us of K7's
// 157 us at D (tools/torch_kernel_times.py).  Every thread of the block
// (kSumThreads) must call it.
// Returns true in warp 0, whose lanes then hold in acc the sums of their
// Cols::kN coordinates (as Cols lays them out), false elsewhere.  z may be
// float32 or bfloat16 (T), with a Cols that takes it.
template <class Cols, bool kWeighted, typename T, typename Keep>
__device__ bool sum_kept_rows(const T* __restrict__ z, const float* __restrict__ v,
                              int S, Keep keep, int64_t ld, int64_t D,
                              float4 (&acc)[Cols::kN / 4]) {
  constexpr int kV = Cols::kN / 4;
  extern __shared__ int s_row[];   // a chunk's kept rows, then (kWeighted) their weights
  float* s_wt = kWeighted ? reinterpret_cast<float*>(s_row + min(S, kSumCap)) : nullptr;
  __shared__ int warp_n[kSumWarps];
  __shared__ float4 part[kSumWarps - 1][kV][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * Cols::kCols;
#pragma unroll
  for (int h = 0; h < kV; ++h) acc[h] = make_float4(0.f, 0.f, 0.f, 0.f);
  auto chunk = [&](int lo, int hi) {
    const int n = compact<kSumWarps>(v, lo, hi, keep, s_row, s_wt, warp_n);
    for (int j = warp; j < n; j += kSumUnroll * kSumWarps) {
      typename Cols::Raw x[kSumUnroll];   // up to kSumUnroll rows' loads in flight, then in order
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u)
        if (j + u * kSumWarps < n)
          x[u] = Cols::load(z + s_row[j + u * kSumWarps] * ld, d0, lane, D);
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u)
        if (j + u * kSumWarps < n) {
          float4 val[kV];
          Cols::values(x[u], val);
#pragma unroll
          for (int h = 0; h < kV; ++h) {
            if (kWeighted)
              fma4(s_wt[j + u * kSumWarps], val[h], acc[h]);
            else
              add4(val[h], acc[h]);
          }
        }
    }
  };
  if (S <= kSumCap)
    chunk(0, S);
  else
    for (int c0 = 0; c0 < S; c0 += kSumCap) chunk(c0, min(S, c0 + kSumCap));
  if (warp > 0) {
#pragma unroll
    for (int h = 0; h < kV; ++h) part[warp - 1][h][lane] = acc[h];
  }
  __syncthreads();
  if (warp != 0) return false;
#pragma unroll
  for (int i = 0; i < kSumWarps - 1; ++i) {
#pragma unroll
    for (int h = 0; h < kV; ++h) add4(part[i][h][lane], acc[h]);
  }
  return true;
}

// n rows (or receivers) over the grid's y and z dimensions, each at most
// 65,535 blocks: grid_yz(x, n) launches x blocks along x for each, and a
// block serves row grid_row() (none at all when it is n or more).
__host__ __forceinline__ dim3 grid_yz(unsigned x, long long n) {
  const long long y = n < 65535 ? n : 65535;
  return dim3(x, static_cast<unsigned>(y), static_cast<unsigned>((n + y - 1) / y));
}

__device__ __forceinline__ int64_t grid_row() {
  return static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
}

}  // namespace rows
