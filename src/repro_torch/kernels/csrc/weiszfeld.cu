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
// One thread per (receiver, coordinate) loops over the S rows in order; the
// receiver's S weights sit in shared memory and a warp's loads of one row
// are coalesced along D.  A column slice z[..., a:b] of a wider buffer is
// read in place.
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
// the decentralized exchange at R = S = 70) for 2-3 flops per element (K6
// also reads the D * 4 bytes of the ids).  Inside the master's Weiszfeld
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

// Grid (D-blocks, R); a: (R, W) contiguous, out: (R, D) contiguous.
__global__ void weighted_sum_kernel(const float* __restrict__ z,
                                    const float* __restrict__ a,
                                    float* __restrict__ out, int W, int64_t D,
                                    int64_t ld, int64_t rs) {
  extern __shared__ float s_a[];
  const int r = blockIdx.y;
  a += static_cast<int64_t>(r) * W;
  for (int w = threadIdx.x; w < W; w += blockDim.x) s_a[w] = a[w];
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= D) return;
  z += static_cast<int64_t>(r) * rs;
  float acc = 0.f;
#pragma unroll 8
  for (int w = 0; w < W; ++w) acc = fmaf(s_a[w], z[static_cast<int64_t>(w) * ld + i], acc);
  out[static_cast<int64_t>(r) * D + i] = acc;
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
// a and out contiguous; W * 4 bytes of shared memory, so W <= 12,288;
// R <= 65,535.
REPRO_EXPORT int weighted_sum_f32(const float* z, const float* a, float* out,
                                  int R, int W, long long D, long long ld,
                                  long long rs, void* stream) {
  if (D == 0 || R == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned>((D + kThreads - 1) / kThreads),
                  static_cast<unsigned>(R));
  weighted_sum_kernel<<<grid, kThreads, W * sizeof(float),
                        static_cast<cudaStream_t>(stream)>>>(
      z, a, out, W, static_cast<int64_t>(D), static_cast<int64_t>(ld),
      static_cast<int64_t>(rs));
  return static_cast<int>(cudaGetLastError());
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
