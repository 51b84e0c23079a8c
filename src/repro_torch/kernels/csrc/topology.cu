// K7 masked_neighbor_reduce: per receiver r and coordinate d, the mean of
// the masked senders' values x[r, s, d] (mask[r, s] > 0) after dropping the
// `trim` largest and the `trim` smallest of them, divided by
// max(n_r - 2 * trim, 1) with n_r = sum_s mask[r, s].  trim = 0 is the
// masked mean.  It is the decentralized trimmed mean of
// repro_torch/topology/masked.py, and its initial masked mean of a masked
// Weiszfeld solve.
// Replaces: repro/kernels/topology.py, masked_neighbor_reduce_call
// (_masked_reduce_kernel), which keeps one receiver's (S, tile) slab in VMEM
// and runs `trim` rounds of "drop one occurrence of the masked max, then of
// the masked min" before a masked sum: no sort.
//
// Here a block of kTile threads owns kTile coordinates of one receiver
// (grid: D-tiles x R).  It stages the receiver's mask row (S floats) and its
// (S, kTile) slab in dynamic shared memory, one column per thread, with
// coalesced loads along D; the ragged D edge is masked in the kernel.  Each
// of the `trim` rounds is one pass over the thread's column that finds the
// first (lowest sender index) masked maximum and minimum among the values
// still present; both are struck out by writing NaN into the slab (NaN is
// never a maximum, a minimum or a survivor).  When the two coincide (one
// value left, or all left are equal) a second pass strikes the next present
// value instead: the survivors then hold the same values as in the
// reference's max-then-min order.  The survivors are summed in sender order
// in float32, so the result agrees with the sort-based plain version to
// rtol 1e-5, not bitwise.
//
// Strides: x[r, s, d] lies at r * rs + s * ss + d, so a column slice of a
// wider exchange, or one shared message row per sender broadcast to every
// receiver (rs = 0), is read in place.  The mask and the output are
// contiguous (R, S) and (R, D).
//
// Bound on the H100: device-memory bytes.  It reads only the masked
// senders' values, once: nnz(mask) * D * 4 bytes (398 MB of the 779 MB
// exchange under the 70-node erdos_renyi(p = 0.5) mask at D = 39,760:
// 119 us at 3.35 TB/s).  This simple form does not reach it: each thread has
// one load in flight at a time, and then makes `trim` passes over its
// column in shared memory (910 shared loads per coordinate at S = 70,
// trim = 12).  Several loads in flight per thread, and part of the column
// kept in registers, are later work.
//
// NaN inputs: a NaN in the exchange is indistinguishable from a struck value
// and drops out of that column's result (the plain version sorts NaN last).
// NaN messages come only from the fault attacks, which are not ported.
#include "common.cuh"

namespace {

constexpr int kTile = 128;   // coordinates (threads) per block

__device__ __forceinline__ bool present(float v) { return v == v; }

__global__ void masked_reduce_kernel(const float* __restrict__ x,
                                     const float* __restrict__ mask,
                                     float* __restrict__ out, int S,
                                     int64_t D, int64_t rs, int64_t ss,
                                     int trim) {
  extern __shared__ float smem[];
  float* m = smem;            // (S,) mask row of this receiver
  float* slab = smem + S;     // (S, kTile)
  const int r = blockIdx.y;
  const int t = threadIdx.x;
  for (int s = t; s < S; s += kTile) m[s] = mask[static_cast<int64_t>(r) * S + s];
  __syncthreads();
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kTile + t;
  if (col >= D) return;   // each thread touches only its own column
  const float* xr = x + static_cast<int64_t>(r) * rs + col;
  float* v = slab + t;
  float n = 0.f;
  for (int s = 0; s < S; ++s) {
    const bool on = m[s] > 0.f;
    // Senders outside the neighbourhood are struck from the start.
    v[s * kTile] = on ? xr[static_cast<int64_t>(s) * ss] : __int_as_float(0x7fc00000);
    n += m[s];
  }
  for (int round = 0; round < trim; ++round) {
    int imax = -1, imin = -1;
    float vmax = 0.f, vmin = 0.f;
    for (int s = 0; s < S; ++s) {
      const float vs = v[s * kTile];
      if (!present(vs)) continue;
      if (imax < 0 || vs > vmax) { vmax = vs; imax = s; }
      if (imin < 0 || vs < vmin) { vmin = vs; imin = s; }
    }
    if (imax < 0) break;   // nothing left to strike
    v[imax * kTile] = __int_as_float(0x7fc00000);
    if (imin == imax) {
      // One value left, or all equal: strike the next present one.
      imin = -1;
      for (int s = 0; s < S && imin < 0; ++s)
        if (present(v[s * kTile])) imin = s;
    }
    if (imin >= 0) v[imin * kTile] = __int_as_float(0x7fc00000);
  }
  float acc = 0.f;
  for (int s = 0; s < S; ++s) {
    const float vs = v[s * kTile];
    if (present(vs)) acc += vs;
  }
  out[static_cast<int64_t>(r) * D + col] = acc / fmaxf(n - 2.f * trim, 1.f);
}

size_t smem_bytes(int S) {
  return static_cast<size_t>(S) * (kTile + 1) * sizeof(float);
}

}  // namespace

// Dynamic shared memory a launch with S senders needs (the wrapper refuses
// an S whose need exceeds the 232,448 bytes a block may use on Hopper).
REPRO_EXPORT long long masked_neighbor_reduce_smem_bytes(int S) {
  return static_cast<long long>(smem_bytes(S));
}

// x: (R, S, D) float32 at x[r * rs + s * ss + d]; mask: (R, S), out: (R, D)
// float32 contiguous; 0 <= trim; R <= 65,535.
REPRO_EXPORT int masked_neighbor_reduce_f32(const float* x, const float* mask,
                                            float* out, int R, int S,
                                            long long D, long long rs,
                                            long long ss, int trim,
                                            void* stream) {
  if (R == 0 || D == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = smem_bytes(S);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        masked_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((D + kTile - 1) / kTile),
                  static_cast<unsigned>(R));
  masked_reduce_kernel<<<grid, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      x, mask, out, S, static_cast<int64_t>(D), static_cast<int64_t>(rs),
      static_cast<int64_t>(ss), trim);
  return static_cast<int>(cudaGetLastError());
}
