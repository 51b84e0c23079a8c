// K2 and K3: the two sweeps of one Weiszfeld iteration, for one (W, D)
// message matrix (the master step) or for a batch of R receivers, each with
// its own (S, D) view of the senders (the decentralized step's masked
// Weiszfeld, all receivers in lockstep).  Row s of receiver r lies at
// z + r * rs + s * ld (ld >= D floats between rows, rs between receivers;
// rs = 0 shares one matrix among all receivers); a single matrix is the case
// R = 1, and gives the same bits as before the receiver axis existed.  Any
// W, S and R that fit in memory: rows and receivers are spread over the
// grid's y and z dimensions (rows.cuh's grid_yz), past the 65,535 blocks of
// one.
//
// K2 partial_sqdist: out[r, s] = sum_d (z[r, s, d] - y[r, d])^2.
// Replaces: repro/kernels/weiszfeld.py, partial_sqdist_call (_sqdist_kernel),
// which carries the (W,) sum across a sequential grid over p-tiles.  Hopper's
// blocks run in no order, so the port reduces in two passes and two routes:
//
// * unmasked: a (D-chunk of 2,048, sender, receiver) grid writes one partial
//   sum per block into an (R * S, nchunks) scratch buffer, then one block
//   per (receiver, sender) sums its row.  Both passes reduce in a fixed tree
//   (warp shuffles, then the warps in order).
// * masked (an (R, S) mask given; the masked Weiszfeld multiplies the
//   distance of every sender of mask <= 0 by 0): a block owns one receiver's
//   chunk of 512 coordinates.  It compacts the receiver's members (mask > 0)
//   as K3 compacts weights, loads y[r, chunk] once into registers, and
//   streams only the members' rows: float4 loads where the base and strides
//   allow, rows split across 8 warps (warp w takes members w, w + 8, ...),
//   two rows (8 float4 loads a lane) in flight per warp.  Each (member,
//   chunk) partial is one warp's fixed tree; the finish pass sums a member's
//   partials in the unmasked route's fixed order and writes exactly 0 for a
//   non-member, whose row is never read.  So the bits depend on nothing but
//   the inputs (not on R, the grid or the other receivers).  For finite z a
//   non-member's distance only ever meets a weight of 0, so leaving it at 0
//   changes no iterate.  A mask-0 row holding inf or NaN is the one input on
//   which the masked route and the unmasked one part (inf or NaN there, and
//   the masked Weiszfeld's 0 / inf or 0 / NaN weight after it; 0 here, the
//   row never read, as the plain version's where(mask > 0, sq, 0) gives);
//   the reference's masked engine promises that mask-0 senders do not
//   influence the result (repro/topology/masked.py), and the skip keeps that
//   promise.  It is K3's non-finite zero-weight edge, below.  96 registers
//   (97 with float4 loads), no spills.
// No atomics: the same inputs give the same bits on every run.
//
// K3 weighted_sum: out[r, d] = sum_s a[r, s] * z[r, s, d]  (unnormalized).
// Replaces: repro/kernels/weiszfeld.py, weighted_sum_call (_wsum_kernel).
// It reads only the rows of nonzero weight, in rows.cuh's sum_kept_rows
// (the body K7's trim-0 route shares): each block of 8 warps compacts
// its receiver's nonzero weights, 2,048 weights at a time, into shared
// memory as (row, weight) pairs in ascending row order (a ballot and a
// prefix count per warp), then covers 128 coordinates, 4
// consecutive ones a thread (float4 loads where the base and the row stride
// allow, else 4 scalar loads, so a column slice z[..., a:b] of a wider buffer
// is read in place).  The compacted rows of each chunk are split across the
// warps (warp w takes rows w, w + 8, ...), each warp keeps up to 8 rows'
// loads in flight and carries its sum from chunk to chunk, and the 8 partial
// sums are added in warp order in shared memory.  The split depends on
// nothing but the weights, so a single matrix gives the same bits as each
// receiver of a batch, and every run the same bits.  For finite z a row of
// weight exactly 0 adds +-0, so skipping it changes no sum.  A zero-weight row
// holding inf or NaN is the one input on which the kernel and the plain
// version part (0 * inf is NaN there, skipped here); the reference's masked
// engine promises that mask-0 senders do not influence the result
// (repro/topology/masked.py), and the skip keeps that promise.  64
// registers, no spills.
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
// the decentralized exchange at R = S = 70, of which K3 and the masked K2
// need only the 398.3 MB of the 2,504 member rows under workload D's mask;
// with y (or the output) and the mask, 409.4 MB: 122.2 us at 3.35 TB/s) for
// 2-3 flops per element (K6 also reads the D * 4 bytes of the ids).  Inside
// the master's Weiszfeld loop z is re-read every iteration and fits in the
// 50 MB L2, so the sweeps may run above the HBM rate; the decentralized
// exchange does not fit.
#include "common.cuh"
#include "rows.cuh"

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

// Grid (nchunks, rows::grid_yz over the R * S rows); row q = r * S + s
// writes partial[q * nchunks + chunk].
__global__ void sqdist_partial_kernel(const float* __restrict__ z,
                                      const float* __restrict__ y,
                                      float* __restrict__ partial, int R, int S,
                                      int64_t D, int64_t ld, int64_t rs,
                                      int nchunks) {
  const int64_t q = rows::grid_row();
  if (q >= static_cast<int64_t>(R) * S) return;   // the whole block
  // (r, w) from q; no division for a single matrix, a 32-bit one where q fits.
  int64_t r = 0, w = q;
  if (R > 1) {
    r = q <= 0xffffffffLL ? static_cast<uint32_t>(q) / static_cast<uint32_t>(S) : q / S;
    w = q - r * S;
  }
  const float* zw = z + r * rs + w * ld;
  y += r * D;
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
  if (threadIdx.x == 0) partial[q * nchunks + blockIdx.x] = s;
}

// One block per row of nchunks partials; with kMasked, a row whose mask
// entry is <= 0 was never written and its output is exactly 0.
template <bool kMasked>
__global__ void sqdist_finish_kernel(const float* __restrict__ partial,
                                     const float* __restrict__ mask,
                                     float* __restrict__ out, int nchunks) {
  if (kMasked && !(mask[blockIdx.x] > 0.f)) {
    if (threadIdx.x == 0) out[blockIdx.x] = 0.f;
    return;   // the whole block: no barrier below is reached
  }
  const float* row = partial + static_cast<int64_t>(blockIdx.x) * nchunks;
  float acc = 0.f;
  for (int c = threadIdx.x; c < nchunks; c += kThreads) acc += row[c];
  const float s = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

// Pass one of K6, grid (nchunks, rows::grid_yz over W): partial[(w * L +
// s) * nchunks + chunk].
__global__ void sqdist_segments_partial_kernel(const float* __restrict__ z,
                                               const float* __restrict__ y,
                                               const int* __restrict__ seg,
                                               float* __restrict__ partial,
                                               int W, int64_t D, int L,
                                               int nchunks) {
  const int64_t w = rows::grid_row();
  if (w >= W) return;   // the whole block
  const float* zw = z + w * D;
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
  float* out = partial + w * L * nchunks + blockIdx.x;
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

// The masked route of K2: 8 warps, 512 coordinates a block (kSqVec float4
// groups of 128 per lane), two member rows in flight per warp.
constexpr int kSqWarps = 8;
constexpr int kSqThreads = 32 * kSqWarps;
constexpr int kSqVec = 4;
constexpr int kSqCols = 128 * kSqVec;
constexpr int kSqRows = 2;
constexpr int kSqCap = 2048;   // mask entries compacted at a time (8 KB)

__device__ __forceinline__ float sq4(const float4& z, const float4& y, float acc) {
  float d = z.x - y.x;
  acc = fmaf(d, d, acc);
  d = z.y - y.y;
  acc = fmaf(d, d, acc);
  d = z.z - y.z;
  acc = fmaf(d, d, acc);
  d = z.w - y.w;
  return fmaf(d, d, acc);
}

// Grid (D-chunks of kSqCols, rows::grid_yz over R);
// partial[(r * S + s) * nchunks + chunk] for the members s of receiver r
// only.  VEC: z, ld, rs, y and D allow float4 loads.
template <bool VEC>
__global__ void __launch_bounds__(kSqThreads)
sqdist_masked_partial_kernel(const float* __restrict__ z, const float* __restrict__ y,
                             const float* __restrict__ mask,
                             float* __restrict__ partial, int R, int S, int64_t D,
                             int64_t ld, int64_t rs, int nchunks) {
  __shared__ int s_row[kSqCap];
  __shared__ int warp_n[kSqWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t r = rows::grid_row();
  if (r >= R) return;   // the whole block
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * kSqCols;
  float4 yv[kSqVec];
#pragma unroll
  for (int v = 0; v < kSqVec; ++v)
    yv[v] = rows::load_cols<VEC>(y + r * D, d0 + 128 * v, lane, D);
  z += r * rs;
  mask += r * S;
  partial += r * S * nchunks + blockIdx.x;
  for (int c0 = 0; c0 < S; c0 += kSqCap) {
    const int n = rows::compact<kSqWarps>(mask, c0, min(S, c0 + kSqCap),
                                          rows::Positive(), s_row, nullptr, warp_n);
    for (int j = warp; j < n; j += kSqRows * kSqWarps) {
      float4 zv[kSqRows][kSqVec];
#pragma unroll
      for (int u = 0; u < kSqRows; ++u)
        if (j + u * kSqWarps < n) {
          const float* row = z + s_row[j + u * kSqWarps] * ld;
#pragma unroll
          for (int v = 0; v < kSqVec; ++v)
            zv[u][v] = rows::load_cols<VEC>(row, d0 + 128 * v, lane, D);
        }
#pragma unroll
      for (int u = 0; u < kSqRows; ++u)
        if (j + u * kSqWarps < n) {   // the same for the whole warp
          float acc = 0.f;
#pragma unroll
          for (int v = 0; v < kSqVec; ++v) acc = sq4(zv[u][v], yv[v], acc);
          acc = rows::warp_total(acc);
          if (lane == 0)
            partial[static_cast<int64_t>(s_row[j + u * kSqWarps]) * nchunks] = acc;
        }
    }
  }
}

// Grid (D-blocks of rows::kSumCols, rows::grid_yz over R); a: (R, W)
// contiguous, out: (R, D) contiguous; rows::kept_rows_smem(W, true) bytes
// of dynamic shared memory.  VEC: z, ld and rs allow float4 loads
// (16-byte-aligned base, ld and rs multiples of 4).
template <bool VEC>
__global__ void __launch_bounds__(rows::kSumThreads)
weighted_sum_kernel(const float* __restrict__ z, const float* __restrict__ a,
                    float* __restrict__ out, int R, int W, int64_t D, int64_t ld,
                    int64_t rs) {
  const int64_t r = rows::grid_row();
  if (r >= R) return;   // the whole block
  float4 acc;
  if (rows::sum_kept_rows<VEC, true>(z + r * rs, a + r * W, W, rows::NonZero(), ld, D,
                                     acc))
    rows::store_cols<VEC>(out + r * D, static_cast<int64_t>(blockIdx.x) * rows::kSumCols,
                          threadIdx.x % 32, D, acc);
}

template <bool VEC>
int launch_weighted_sum(const float* z, const float* a, float* out, int R, int W,
                        int64_t D, int64_t ld, int64_t rs, cudaStream_t s) {
  const dim3 grid = rows::grid_yz(
      static_cast<unsigned>((D + rows::kSumCols - 1) / rows::kSumCols), R);
  weighted_sum_kernel<VEC><<<grid, rows::kSumThreads, rows::kept_rows_smem(W, true), s>>>(
      z, a, out, R, W, D, ld, rs);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Columns of the (W, ncols) float32 scratch buffer partial_sqdist_f32 needs.
REPRO_EXPORT int partial_sqdist_scratch_cols(long long D) {
  return static_cast<int>((D + kChunk - 1) / kChunk);
}

// Columns of the (R * S, ncols) scratch buffer partial_sqdist_masked_f32 needs.
REPRO_EXPORT int partial_sqdist_masked_scratch_cols(long long D) {
  return static_cast<int>((D + kSqCols - 1) / kSqCols);
}

// z: (R, W, D) at z[r * rs + w * ld + d], y: (R, D), partial: (R * W,
// partial_sqdist_scratch_cols(D)), out: (R, W); float32, y, partial and out
// contiguous.  Launches both passes on `stream`.
REPRO_EXPORT int partial_sqdist_f32(const float* z, const float* y,
                                    float* partial, float* out, int R, int W,
                                    long long D, long long ld, long long rs,
                                    void* stream) {
  if (W == 0 || R == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const int nchunks = partial_sqdist_scratch_cols(D);
  if (nchunks > 0) {
    const dim3 grid = rows::grid_yz(static_cast<unsigned>(nchunks),
                                    static_cast<long long>(R) * W);
    sqdist_partial_kernel<<<grid, kThreads, 0, s>>>(
        z, y, partial, R, W, static_cast<int64_t>(D), static_cast<int64_t>(ld),
        static_cast<int64_t>(rs), nchunks);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  sqdist_finish_kernel<false><<<static_cast<unsigned>(R) * W, kThreads, 0, s>>>(
      partial, nullptr, out, nchunks);
  return static_cast<int>(cudaGetLastError());
}

// The masked route: as partial_sqdist_f32 with mask (R, S) float32
// contiguous; rows of mask <= 0 are not read and their out is 0.  partial:
// (R * S, partial_sqdist_masked_scratch_cols(D)).
REPRO_EXPORT int partial_sqdist_masked_f32(const float* z, const float* y,
                                           const float* mask, float* partial,
                                           float* out, int R, int S, long long D,
                                           long long ld, long long rs,
                                           void* stream) {
  if (S == 0 || R == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const int nchunks = partial_sqdist_masked_scratch_cols(D);
  if (nchunks > 0) {
    const bool vec = aligned16(z) && aligned16(y) && ld % 4 == 0 && rs % 4 == 0 &&
                     D % 4 == 0;
    const dim3 grid = rows::grid_yz(static_cast<unsigned>(nchunks), R);
    if (vec)
      sqdist_masked_partial_kernel<true><<<grid, kSqThreads, 0, s>>>(
          z, y, mask, partial, R, S, static_cast<int64_t>(D),
          static_cast<int64_t>(ld), static_cast<int64_t>(rs), nchunks);
    else
      sqdist_masked_partial_kernel<false><<<grid, kSqThreads, 0, s>>>(
          z, y, mask, partial, R, S, static_cast<int64_t>(D),
          static_cast<int64_t>(ld), static_cast<int64_t>(rs), nchunks);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  sqdist_finish_kernel<true><<<static_cast<unsigned>(R) * S, kThreads, 0, s>>>(
      partial, mask, out, nchunks);
  return static_cast<int>(cudaGetLastError());
}

// z: (R, W, D) at z[r * rs + w * ld + d], a: (R, W), out: (R, D); float32,
// a and out contiguous; min(W, 2,048) * 8 bytes of shared memory.
REPRO_EXPORT int weighted_sum_f32(const float* z, const float* a, float* out,
                                  int R, int W, long long D, long long ld,
                                  long long rs, void* stream) {
  if (D == 0 || R == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(z) && ld % 4 == 0 && rs % 4 == 0;
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
    const dim3 grid = rows::grid_yz(static_cast<unsigned>(nchunks), W);
    sqdist_segments_partial_kernel<<<grid, kThreads, 0, s>>>(
        z, y, seg, partial, W, static_cast<int64_t>(D), L, nchunks);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  // (W * L) rows of nchunks partials, summed one block per row.
  sqdist_finish_kernel<false><<<static_cast<unsigned>(W) * L, kThreads, 0, s>>>(
      partial, nullptr, out, nchunks);
  return static_cast<int>(cudaGetLastError());
}
