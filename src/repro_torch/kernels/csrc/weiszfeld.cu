// K2 and K3: the two sweeps of one Weiszfeld iteration over the (W, D)
// message matrix.
//
// K2 partial_sqdist: out[w] = sum_d (z[w, d] - y[d])^2.
// Replaces: repro/kernels/weiszfeld.py, partial_sqdist_call (_sqdist_kernel),
// which carries the (W,) sum across a sequential grid over p-tiles.  Hopper's
// blocks run in no order, so the port reduces in two passes: a (D-chunk,
// worker) grid writes one partial sum per block into a (W, nchunks) scratch
// buffer, then one block per worker sums its row.  Both passes reduce in a
// fixed tree (warp shuffles, then the warps in order) and use no atomics, so
// the same inputs give the same bits on every run.
//
// K3 weighted_sum: out[d] = sum_w a[w] * z[w, d]  (unnormalized).
// Replaces: repro/kernels/weiszfeld.py, weighted_sum_call (_wsum_kernel).
// One thread per coordinate loops over the W rows in order; the W weights sit
// in shared memory and a warp's loads of one row are coalesced along D.
//
// Bound on the H100: device-memory bytes.  Each sweep reads the W * D * 4
// bytes of z once (11.1 MB at W = 70, D = 39,760) for 2-3 flops per element.
// Inside the Weiszfeld loop z is re-read every iteration and fits in the
// 50 MB L2, so the sweeps may run above the HBM rate.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kChunk = kThreads * kItems;  // coordinates per first-pass block

// Deterministic block sum; the result is valid in thread 0 only.
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
  return total;
}

__global__ void sqdist_partial_kernel(const float* __restrict__ z,
                                      const float* __restrict__ y,
                                      float* __restrict__ partial, int64_t D,
                                      int nchunks) {
  const int w = blockIdx.y;
  const float* zw = z + static_cast<int64_t>(w) * D;
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
  if (threadIdx.x == 0) partial[static_cast<int64_t>(w) * nchunks + blockIdx.x] = s;
}

__global__ void sqdist_finish_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int nchunks) {
  const float* row = partial + static_cast<int64_t>(blockIdx.x) * nchunks;
  float acc = 0.f;
  for (int c = threadIdx.x; c < nchunks; c += kThreads) acc += row[c];
  const float s = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

__global__ void weighted_sum_kernel(const float* __restrict__ z,
                                    const float* __restrict__ a,
                                    float* __restrict__ out, int W, int64_t D) {
  extern __shared__ float s_a[];
  for (int w = threadIdx.x; w < W; w += blockDim.x) s_a[w] = a[w];
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= D) return;
  float acc = 0.f;
#pragma unroll 8
  for (int w = 0; w < W; ++w) acc = fmaf(s_a[w], z[static_cast<int64_t>(w) * D + i], acc);
  out[i] = acc;
}

}  // namespace

// Columns of the (W, ncols) float32 scratch buffer partial_sqdist_f32 needs.
REPRO_EXPORT int partial_sqdist_scratch_cols(long long D) {
  return static_cast<int>((D + kChunk - 1) / kChunk);
}

// z: (W, D), y: (D,), partial: (W, partial_sqdist_scratch_cols(D)),
// out: (W,); float32, contiguous.  Launches both passes on `stream`.
REPRO_EXPORT int partial_sqdist_f32(const float* z, const float* y,
                                    float* partial, float* out, int W,
                                    long long D, void* stream) {
  if (W == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const int nchunks = partial_sqdist_scratch_cols(D);
  if (nchunks > 0) {
    const dim3 grid(static_cast<unsigned>(nchunks), static_cast<unsigned>(W));
    sqdist_partial_kernel<<<grid, kThreads, 0, s>>>(z, y, partial,
                                                    static_cast<int64_t>(D), nchunks);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  sqdist_finish_kernel<<<W, kThreads, 0, s>>>(partial, out, nchunks);
  return static_cast<int>(cudaGetLastError());
}

// z: (W, D), a: (W,), out: (D,); float32, contiguous; W * 4 bytes of shared
// memory, so W <= 12,288.
REPRO_EXPORT int weighted_sum_f32(const float* z, const float* a, float* out,
                                  int W, long long D, void* stream) {
  if (D == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((D + kThreads - 1) / kThreads);
  weighted_sum_kernel<<<blocks, kThreads, W * sizeof(float),
                        static_cast<cudaStream_t>(stream)>>>(z, a, out, W,
                                                             static_cast<int64_t>(D));
  return static_cast<int>(cudaGetLastError());
}
