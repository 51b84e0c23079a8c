// K2 and K3: the two sweeps of one Weiszfeld iteration, for one (W, D)
// message matrix (the master step) or for a batch of R receivers, each with
// its own (S, D) view of the senders (the decentralized step's masked
// Weiszfeld, all receivers in lockstep).  Row s of receiver r lies at
// z + r * rs + s * ld (ld >= D floats between rows, rs between receivers;
// rs = 0 shares one matrix among all receivers); a single matrix is the case
// R = 1, and gives the same bits as before the receiver axis existed.
//
// K2 partial_sqdist: out[r, s] = sum_d (z[r, s, d] - y[r, d])^2.
// Replaces: repro/kernels/weiszfeld.py, partial_sqdist_call (_sqdist_kernel),
// which carries the (W,) sum across a sequential grid over p-tiles.  Hopper's
// blocks run in no order, so the port reduces in two passes: a (D-chunk,
// sender, receiver) grid writes one partial sum per block into an
// (R * S, nchunks) scratch buffer, then one block per (receiver, sender) sums
// its row.  Both passes reduce in a fixed tree (warp shuffles, then the warps
// in order) and use no atomics, so the same inputs give the same bits on
// every run.
//
// K3 weighted_sum: out[r, d] = sum_s a[r, s] * z[r, s, d]  (unnormalized).
// Replaces: repro/kernels/weiszfeld.py, weighted_sum_call (_wsum_kernel).
// It reads only the rows of nonzero weight: each block of 8 warps first
// compacts its receiver's nonzero weights into shared memory as (row,
// weight) pairs in ascending row order (a ballot and a prefix count per
// warp), then covers 128 coordinates, 4 consecutive ones a thread (float4
// loads where the base and the row stride allow, else 4 scalar loads, so a
// column slice z[..., a:b] of a wider buffer is read in place).  The
// compacted rows are split across the warps (warp w takes rows w, w + 8,
// ...), each warp keeps up to 8 rows' loads in flight, and the 8 partial
// sums are added in warp order in shared memory.  The split depends on nothing but
// the weights, so a single matrix gives the same bits as each receiver of a
// batch, and every run the same bits.  For finite z a row of weight exactly
// 0 adds +-0, so skipping it changes no sum.  A zero-weight row holding inf
// or NaN is the one input on which the kernel and the plain version part
// (0 * inf is NaN there, skipped here); the reference's masked engine
// promises that mask-0 senders do not influence the result
// (repro/topology/masked.py), and the skip keeps that promise.
//
// K6 partial_sqdist_segments: out[w, s] = sum over the coordinates d of
// segment s of (z[w, d] - y[d])^2, for s in [0, L); a coordinate whose
// seg_ids[d] lies outside [0, L) (padding) counts nowhere.
// Replaces: repro/kernels/weiszfeld.py, partial_sqdist_segments_call
// (_sqdist_seg_kernel), which takes an (L, p) one-hot membership matrix and
// accumulates a (W, L) block across its sequential grid.  The port takes the
// (D,) int32 ids instead (the same function without L x the bytes) and
// reduces in two passes like K2: a (D-chunk, worker) grid writes one partial
// sum per (worker, segment, chunk) -- each block sums only the segments its
// chunk holds, one fixed-order block reduction each, and writes 0 for the
// rest -- then one block per (worker, segment) sums its row of chunks.  No
// atomics: the same inputs give the same bits on every run.
//
// Bound on the H100: device-memory bytes.  Each sweep reads the z bytes once
// (W * D * 4 = 11.1 MB at W = 70, D = 39,760; R * S * D * 4 = 779 MB for
// the decentralized exchange at R = S = 70, of which K3 needs only the 409 MB
// of rows of nonzero weight under workload D's mask) for 2-3 flops per
// element (K6 also reads the D * 4 bytes of the ids).  Inside the master's Weiszfeld
// loop z is re-read every iteration and fits in the 50 MB L2, so the sweeps
// may run above the HBM rate; the decentralized exchange does not fit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kChunk = kThreads * kItems;  // coordinates per first-pass block

// Deterministic block sum; the result is valid in thread 0 only.  Every
// thread of the block must call it; it may be called again right away.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += warp_sums[i];
  }
  __syncthreads();
  return total;
}

// Block-wide min of `lo` and max of `hi`, returned to every thread.
__device__ void block_range(int& lo, int& hi) {
  __shared__ int warp_lo[kWarps], warp_hi[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if ((threadIdx.x & 31) == 0) {
    warp_lo[threadIdx.x >> 5] = lo;
    warp_hi[threadIdx.x >> 5] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    lo = min(lo, warp_lo[i]);
    hi = max(hi, warp_hi[i]);
  }
  __syncthreads();
}

// Grid (nchunks, S, R); partial[(r * S + s) * nchunks + chunk].
__global__ void sqdist_partial_kernel(const float* __restrict__ z,
                                      const float* __restrict__ y,
                                      float* __restrict__ partial, int64_t D,
                                      int64_t ld, int64_t rs, int nchunks) {
  const int w = blockIdx.y;
  const int r = blockIdx.z;
  const float* zw = z + static_cast<int64_t>(r) * rs + static_cast<int64_t>(w) * ld;
  y += static_cast<int64_t>(r) * D;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kChunk + threadIdx.x;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = start + static_cast<int64_t>(k) * kThreads;
    if (i < D) {
      const float d = zw[i] - y[i];
      acc = fmaf(d, d, acc);
    }
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0)
    partial[(static_cast<int64_t>(r) * gridDim.y + w) * nchunks + blockIdx.x] = s;
}

__global__ void sqdist_finish_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int nchunks) {
  const float* row = partial + static_cast<int64_t>(blockIdx.x) * nchunks;
  float acc = 0.f;
  for (int c = threadIdx.x; c < nchunks; c += kThreads) acc += row[c];
  const float s = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

// Pass one of K6: partial[(w * L + s) * nchunks + chunk].
__global__ void sqdist_segments_partial_kernel(const float* __restrict__ z,
                                               const float* __restrict__ y,
                                               const int* __restrict__ seg,
                                               float* __restrict__ partial,
                                               int64_t D, int L, int nchunks) {
  const int w = blockIdx.y;
  const float* zw = z + static_cast<int64_t>(w) * D;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kChunk + threadIdx.x;
  float d2[kItems];
  int sid[kItems];
  int lo = L, hi = -1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = start + static_cast<int64_t>(k) * kThreads;
    d2[k] = 0.f;
    sid[k] = -1;
    if (i < D) {
      const int s = seg[i];
      if (s >= 0 && s < L) {
        const float d = zw[i] - y[i];
        d2[k] = d * d;
        sid[k] = s;
        lo = min(lo, s);
        hi = max(hi, s);
      }
    }
  }
  block_range(lo, hi);   // the segments this chunk holds: [lo, hi]
  float* out = partial + static_cast<int64_t>(w) * L * nchunks + blockIdx.x;
  for (int s = 0; s < L; ++s) {
    float total = 0.f;
    if (s >= lo && s <= hi) {   // the same branch for the whole block
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kItems; ++k) acc += (sid[k] == s) ? d2[k] : 0.f;
      total = block_sum(acc);
    }
    if (threadIdx.x == 0) out[static_cast<int64_t>(s) * nchunks] = total;
  }
}

constexpr int kWsWarps = 8;                  // warps per block, each over a share of the rows
constexpr int kWsThreads = 32 * kWsWarps;
constexpr int kWsCols = 32 * 4;              // coordinates per block, 4 a thread
constexpr int kWsUnroll = 8;                 // rows in flight per thread

// The 4 coordinates of `lane` in the block's 128 starting at d0, from row
// `p`: d0 + 4 lane + i with VEC (one float4 where all 4 lie below D), else
// d0 + lane + 32 i.  Coordinates past D read 0.
template <bool VEC>
__device__ __forceinline__ float4 load_cols(const float* p, int64_t d0, int lane,
                                            int64_t D) {
  float x[4];
  if (VEC && d0 + 4 * lane + 3 < D)
    return __ldg(reinterpret_cast<const float4*>(p + d0 + 4 * lane));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t d = VEC ? d0 + 4 * lane + i : d0 + lane + 32 * i;
    x[i] = d < D ? __ldg(p + d) : 0.f;
  }
  return make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void fma4(float w, const float4& v, float4& acc) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

// Grid (D-blocks of 128, R); a: (R, W) contiguous, out: (R, D) contiguous;
// W * 8 bytes of dynamic shared memory.  VEC: z, ld and rs allow float4
// loads (16-byte-aligned base, ld and rs multiples of 4).
template <bool VEC>
__global__ void __launch_bounds__(kWsThreads)
weighted_sum_kernel(const float* __restrict__ z, const float* __restrict__ a,
                    float* __restrict__ out, int W, int64_t D, int64_t ld,
                    int64_t rs) {
  extern __shared__ float s_wt[];   // nonzero weights, then their rows
  int* s_row = reinterpret_cast<int*>(s_wt + W);
  __shared__ int warp_n[kWsWarps];
  __shared__ float4 part[kWsWarps - 1][32];
  const int r = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  a += static_cast<int64_t>(r) * W;

  int n = 0;   // nonzero weights compacted so far
  for (int w0 = 0; w0 < W; w0 += kWsThreads) {
    const int w = w0 + threadIdx.x;
    const float x = w < W ? a[w] : 0.f;
    const bool keep = x != 0.f;
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_n[warp] = __popc(mask);
    __syncthreads();
    int at = n, total = 0;
#pragma unroll
    for (int i = 0; i < kWsWarps; ++i) {
      at += i < warp ? warp_n[i] : 0;
      total += warp_n[i];
    }
    if (keep) {
      const int k = at + __popc(mask & ((1u << lane) - 1u));
      s_wt[k] = x;
      s_row[k] = w;
    }
    n += total;
    __syncthreads();
  }

  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * kWsCols;
  z += static_cast<int64_t>(r) * rs;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = warp; j < n; j += kWsUnroll * kWsWarps) {
    float4 v[kWsUnroll];   // up to kWsUnroll rows' loads in flight, then in order
#pragma unroll
    for (int u = 0; u < kWsUnroll; ++u)
      if (j + u * kWsWarps < n)
        v[u] = load_cols<VEC>(z + s_row[j + u * kWsWarps] * ld, d0, lane, D);
#pragma unroll
    for (int u = 0; u < kWsUnroll; ++u)
      if (j + u * kWsWarps < n) fma4(s_wt[j + u * kWsWarps], v[u], acc);
  }

  if (warp > 0) part[warp - 1][lane] = acc;
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int i = 0; i < kWsWarps - 1; ++i) {
    const float4 p = part[i][lane];
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
  out += static_cast<int64_t>(r) * D;
  const float y[4] = {acc.x, acc.y, acc.z, acc.w};
  if (VEC && (D & 3) == 0 && d0 + 4 * lane + 3 < D) {
    *reinterpret_cast<float4*>(out + d0 + 4 * lane) = acc;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t d = VEC ? d0 + 4 * lane + i : d0 + lane + 32 * i;
    if (d < D) out[d] = y[i];
  }
}

template <bool VEC>
int launch_weighted_sum(const float* z, const float* a, float* out, int R, int W,
                        int64_t D, int64_t ld, int64_t rs, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(W) * 8;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        weighted_sum_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((D + kWsCols - 1) / kWsCols),
                  static_cast<unsigned>(R));
  weighted_sum_kernel<VEC><<<grid, kWsThreads, smem, s>>>(z, a, out, W, D, ld, rs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Columns of the (W, ncols) float32 scratch buffer partial_sqdist_f32 needs.
REPRO_EXPORT int partial_sqdist_scratch_cols(long long D) {
  return static_cast<int>((D + kChunk - 1) / kChunk);
}

// z: (R, W, D) at z[r * rs + w * ld + d], y: (R, D), partial: (R * W,
// partial_sqdist_scratch_cols(D)), out: (R, W); float32, y, partial and out
// contiguous; W, R <= 65,535.  Launches both passes on `stream`.
REPRO_EXPORT int partial_sqdist_f32(const float* z, const float* y,
                                    float* partial, float* out, int R, int W,
                                    long long D, long long ld, long long rs,
                                    void* stream) {
  if (W == 0 || R == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const int nchunks = partial_sqdist_scratch_cols(D);
  if (nchunks > 0) {
    const dim3 grid(static_cast<unsigned>(nchunks), static_cast<unsigned>(W),
                    static_cast<unsigned>(R));
    sqdist_partial_kernel<<<grid, kThreads, 0, s>>>(
        z, y, partial, static_cast<int64_t>(D), static_cast<int64_t>(ld),
        static_cast<int64_t>(rs), nchunks);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  sqdist_finish_kernel<<<static_cast<unsigned>(R) * W, kThreads, 0, s>>>(
      partial, out, nchunks);
  return static_cast<int>(cudaGetLastError());
}

// z: (R, W, D) at z[r * rs + w * ld + d], a: (R, W), out: (R, D); float32,
// a and out contiguous; W * 8 bytes of shared memory (above 48 KB by
// opt-in), so W <= 12,288; R <= 65,535.
REPRO_EXPORT int weighted_sum_f32(const float* z, const float* a, float* out,
                                  int R, int W, long long D, long long ld,
                                  long long rs, void* stream) {
  if (D == 0 || R == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = reinterpret_cast<uintptr_t>(z) % 16 == 0 && ld % 4 == 0 &&
                   rs % 4 == 0;
  return vec ? launch_weighted_sum<true>(z, a, out, R, W, D, ld, rs, s)
             : launch_weighted_sum<false>(z, a, out, R, W, D, ld, rs, s);
}

// z: (W, D), y: (D,), seg: (D,) int32, partial: (W, L,
// partial_sqdist_scratch_cols(D)), out: (W, L); float32, contiguous.
// Launches both passes on `stream`.
REPRO_EXPORT int partial_sqdist_segments_f32(const float* z, const float* y,
                                             const int* seg, float* partial,
                                             float* out, int W, long long D,
                                             int L, void* stream) {
  if (W == 0 || L == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const int nchunks = partial_sqdist_scratch_cols(D);
  if (nchunks > 0) {
    const dim3 grid(static_cast<unsigned>(nchunks), static_cast<unsigned>(W));
    sqdist_segments_partial_kernel<<<grid, kThreads, 0, s>>>(
        z, y, seg, partial, static_cast<int64_t>(D), L, nchunks);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  // (W * L) rows of nchunks partials, summed one block per row.
  sqdist_finish_kernel<<<static_cast<unsigned>(W) * L, kThreads, 0, s>>>(
      partial, out, nchunks);
  return static_cast<int>(cudaGetLastError());
}
