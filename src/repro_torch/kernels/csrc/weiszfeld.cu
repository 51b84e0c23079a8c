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
//   (warp shuffles, then the warps in order).  A bfloat16 z takes one
//   launch with the same sums where its layout allows (below).
// * masked (an (R, S) mask given; the masked Weiszfeld multiplies the
//   distance of every sender of mask <= 0 by 0): a block owns one receiver's
//   chunk of 512 coordinates.  It compacts the receiver's members (mask > 0)
//   as K3 compacts weights, loads y[r, chunk] once into registers, and
//   streams only the members' rows: float4 loads where the base and strides
//   allow, rows split across 8 warps (warp w takes members w, w + 8, ...),
//   two rows (8 float4 loads a lane; four rows in bfloat16, below) in
//   flight per warp.  Each (member,
//   chunk) partial is one warp's fixed tree; the finish pass sums a member's
//   partials in the unmasked route's fixed order and writes exactly 0 for a
//   non-member, whose row is never read.  So the bits depend on nothing but
//   the inputs (not on R, the grid or the other receivers).  For finite z a
//   non-member's distance only ever meets a weight of 0, so leaving it at 0
//   changes no iterate; a mask-0 row holding inf or NaN gives 0 too, as the
//   plain version's where(mask > 0, sq, 0) does (the unmasked route would
//   give inf or NaN).  The reference's masked engine promises that mask-0
//   senders do not influence the result (repro/topology/masked.py); the
//   port keeps that promise in its kernels and plain versions alike, where
//   the reference's own jnp engine lets 0 * inf through.  96 registers (97
//   with float4 loads; 92 for bfloat16), no spills.
// No atomics: the same inputs give the same bits on every run.
//
// bfloat16 messages (the bf16 wire): every kernel here also takes z (the
// matrix or the exchange) in bfloat16, with y, the weights, the mask and
// the outputs in float32 (the *_bf16 entry points).  A bf16 value converts
// to float32 exactly (a shift) and the order of every sum is the float32
// kernel's, so the bf16 route gives the bits of the float32 kernel run on
// z.float() (laid out alike: a slice of the upcast for a slice), at half
// the bytes of z.  The routes were redesigned for 2-byte rows, because a
// conversion right after each load waited for that load, so a warp's row
// loads ran one after another, and 8-byte loads halved the bytes in flight:
// * The unmasked K2 takes one of two layouts, decided before the launch by
//   the base, the strides and D alone (partial_sqdist_cluster_fits):
//   - "cluster" (z 16-byte aligned, ld and rs multiples of 8, 1 to 8,192
//     chunks of 2,048): one launch and no scratch (sqdist_cluster_kernel).
//     A warp computes a whole (row, chunk) partial: lane l stands for the
//     float32 first pass's threads 8l .. 8l + 7, whose coordinates at step
//     k are the 8 adjacent c0 + 256k + 8l + j, so one 16-byte load a step
//     (all 8 of z's and y's 16 float4 loads in flight before any is used)
//     feeds 8 fmaf chains in the float32 order, and the 256 threads' tree
//     is replayed in the warp (block_sum8).  A thread-block cluster of C <=
//     8 blocks of 8 warps covers one row across all of D, block b the
//     chunks b, b + C, ... (C = 3 at B's 20 chunks: 210 blocks).  Each
//     partial lands in block 0's shared memory: block 0's own with a store,
//     the others' with st.async, whose bytes complete a transaction count
//     on block 0's mbarrier (set before the cluster barrier that every block
//     passes before its first send).  Block 0 waits on it, then sums the
//     row in sqdist_finish_kernel's order and tree; the others leave as
//     soon as they have sent.  No atomics, no counter, no second kernel, no
//     fence: on the H100 a cluster.sync() (its release is a MEMBAR.ALL.GPU)
//     cost more than the finish kernel it replaced, and two rows a warp
//     sharing y's loads (fewer, larger warps) ran slower than one.  128
//     registers, nchunks * 4 bytes of shared memory in block 0.  Bound: z's
//     W D 2 bytes with y and out, 5.73 MB at B: 1.71 us at 3.35 TB/s.
//   - "two-pass" (every other view): the float32 route's two kernels with
//     each element of z loaded as 2 bytes (sqdist_partial_kernel: 8 scalar
//     loads a thread, 256 coordinates apart).
// * K3 (and K7 "sum", the same body) reads a 16-byte aligned z with strides
//   that are multiples of 8 elements 8 coordinates a lane, one 16-byte load
//   of raw words converted where they are added (rows.cuh's Cols8): 256
//   coordinates a block, half the blocks, each moving a float32 block's
//   bytes a row.  Each coordinate's sum keeps its order (the rows split
//   over the warps by the weights alone), so no bit moves.  Other bases and
//   strides take the 4-element or the scalar path, as before.
// * The masked K2 with 4-element loads holds each group's raw 8 bytes until
//   it sums them and keeps 4 member rows in flight a warp instead of 2 (the
//   same registers and 128 bytes a lane): 2 rounds of loads at workload D's
//   36 members a receiver instead of 3, in the same blocks.  Each lane keeps
//   its coordinates and each (member, chunk) partial its fmaf chain and
//   warp tree, so every partial keeps its bits.
// * K6 with 4-element loads issues the raw 8 bytes of all its 4 rows' groups
//   (8 loads a thread) before converting any, in the same blocks and lanes,
//   and squares them in the float32 code (square_row), so each row's sum
//   keeps its order (64 registers).  It keeps 4 rows a block: 8 would hold
//   64 squares a thread for the segment sums (about 130 registers, one
//   block an SM), or recompute them from the raw words in other code than
//   float32's.
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
// is read in place; a bfloat16 z 256 coordinates, 8 a thread, below).  The compacted rows of each chunk are split across the
// warps (warp w takes rows w, w + 8, ...), each warp keeps up to 8 rows'
// loads in flight and carries its sum from chunk to chunk, and the 8 partial
// sums are added in warp order in shared memory.  The split depends on
// nothing but the weights, so a single matrix gives the same bits as each
// receiver of a batch, and every run the same bits.  For finite z a row of
// weight exactly 0 adds +-0, so skipping it changes no sum; a zero-weight row
// holding inf or NaN contributes nothing, here and in the plain version
// (which zeroes such rows before its product), as the masked engine's
// promise above asks.  64 registers, no spills (bfloat16's 16-byte route:
// 80, 8 bytes spilled).
//
// K6 partial_sqdist_segments: out[w, s] = sum over the coordinates d of
// segment s of (z[w, d] - y[d])^2, for s in [0, L); a coordinate whose
// seg_ids[d] lies outside [0, L) (padding) counts nowhere.
// Replaces: repro/kernels/weiszfeld.py, partial_sqdist_segments_call
// (_sqdist_seg_kernel), which takes an (L, p) one-hot membership matrix and
// accumulates a (W, L) block across its sequential grid.  The port takes the
// (D,) int32 ids instead (the same function without L x the bytes) and
// reduces in one launch.  A block of 256 threads owns a chunk of 2,048
// coordinates, 8 a thread (float4 loads of z, y and the ids where the bases
// and D allow; scalar loads otherwise), for a group of 4 workers: it loads
// the chunk's y and ids once for the 4 rows, so they cross L2 ceil(W / 4)
// times rather than W times.
//
// * Each block finds the range [lo, hi] of the segments its chunk holds, and
//   each row's sum of squares in one fixed-order reduction (each thread's 8
//   in order, a warp tree, the warps in order; the 4 rows share the
//   barriers).  A chunk of one segment, all but the boundary chunks of the
//   packed leaves (at workload B the third leaf holds 39,200 of the 39,760
//   coordinates), is done: those sums are its partials.  Otherwise the
//   block reduces each segment of [lo, hi] the same way.  Its thread 0
//   writes the partials of those segments only, and lo and hi.
// * Then thread 0 signals through an integer counter per group of workers:
//   one device-scope acq_rel fetch_add, whose release covers the block's
//   writes (all its own).  The block that arrives last (its acquire, then a
//   barrier) sums, for each row and segment, the partials of the chunks
//   whose [lo, hi] holds the segment, in chunk order (half a warp per (row,
//   segment), lane l taking chunks l, l + 16, ... in order, then a fixed
//   tree), writes the rows, and sets the counter back to 0.  The counters
//   live in a buffer the wrapper keeps per device and stream, zeroed once,
//   so no call needs a memset.
//
// Why this shape: on the H100 the signal costs more with more blocks, and
// the last block's sums cost about one L2 round trip per pair a warp takes
// in turn, so a block takes few enough rows that each half warp finishes
// one (row, segment) pair at workload B; one thread writes and signals,
// because every thread fencing before the signal cost more than the whole
// pass's reduction.
//
// Integer counters only: no float atomics, and every sum runs in an order
// fixed by the shapes and ids, so the same inputs give the same bits on
// every run.  A segment that holds no coordinate gives exactly 0.
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
#include <climits>
#include <cooperative_groups.h>
#include <cuda/atomic>
#include <type_traits>

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

// Grid (nchunks, rows::grid_yz over the R * S rows); row q = r * S + s
// writes partial[q * nchunks + chunk].
template <typename T>
__global__ void sqdist_partial_kernel(const T* __restrict__ z,
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
  const T* zw = z + r * rs + w * ld;
  y += r * D;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kChunk + threadIdx.x;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = start + static_cast<int64_t>(k) * kThreads;
    if (i < D) {
      const float d = to_f32(zw[i]) - y[i];
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

// ---- K2 bf16 unmasked: one launch, the finish pass in a thread-block cluster --

constexpr int kClWarps = 8;                  // warps a block, one chunk at a time each
constexpr int kClThreads = 32 * kClWarps;
constexpr int kClMaxBlocks = 8;              // the portable cluster size
constexpr int kClMaxChunks = 8192;           // block 0 keeps a row's partials: 32 KB

// block_sum over sqdist_partial_kernel's 256 threads, done by one warp whose
// lane l holds threads 8l .. 8l + 7's values in v[0 .. 7]: thread t = 8l + j
// sits in warp l / 4 at lane 8 (l % 4) + j, so the float32 kernel's
// __shfl_down_sync by 16 and 8 lanes are shuffles by 2 and 1 lanes here, by
// 4, 2 and 1 sums within v, and the warps' sums, added in order from 0.f,
// are lanes 0, 4, ..., 28's.  Every addition is the float32 kernel's, on the
// same operands: the same bits, in every lane.  All 32 lanes must call it.
__device__ __forceinline__ float block_sum8(const float (&v)[kItems]) {
  float a[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) a[j] = v[j] + __shfl_down_sync(0xffffffffu, v[j], 2);
#pragma unroll
  for (int j = 0; j < kItems; ++j) a[j] += __shfl_down_sync(0xffffffffu, a[j], 1);
  const float c0 = a[0] + a[4], c1 = a[1] + a[5], c2 = a[2] + a[6], c3 = a[3] + a[7];
  const float e = (c0 + c2) + (c1 + c3);   // warp l / 4's sum, in lanes l % 4 == 0
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += __shfl_sync(0xffffffffu, e, 4 * w);
  return total;
}

// y[d0 + 8 lane + i] (i = 0..7) as float32, 0 past D: two float4 loads with
// VY (y 16-byte aligned) where all 8 lie below D (always with FULL).
template <bool FULL, bool VY>
__device__ __forceinline__ void load_y8(const float* y, int64_t d0, int lane, int64_t D,
                                        float (&v)[kItems]) {
  const int64_t d = d0 + 8 * lane;
  if (VY && (FULL || d + 7 < D)) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(y + d));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(y + d + 4));
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) v[i] = FULL || d + i < D ? __ldg(y + d + i) : 0.f;
}

// The partial of row zr over the chunk of kChunk coordinates from c0, with
// sqdist_partial_kernel's bits, in every lane.  FULL: the whole chunk lies
// below D (no test a load).
template <bool FULL, bool VY>
__device__ __forceinline__ float chunk_partial(const __nv_bfloat16* zr, const float* yr,
                                               int64_t c0, int lane, int64_t D) {
  // Every load in flight (the row's raw words, then y) before any is used.
  uint4 raw[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t d0 = c0 + k * kThreads;
    raw[k] = FULL ? ldg8_raw(zr + d0 + 8 * lane) : rows::load_cols8(zr, d0, lane, D);
  }
  float yv[kItems][kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) load_y8<FULL, VY>(yr, c0 + k * kThreads, lane, D, yv[k]);
  // Lane l runs the fmaf chains of the float32 kernel's threads 8l + j:
  // coordinate c0 + 8l + j + 256k at step k.  Past D, z and y read +0.0, so
  // the step adds +0 to a sum of squares (>= +0, +inf or NaN): no bit moves.
  float acc[kItems] = {};
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const float4 lo = bf16x4_f32(make_uint2(raw[k].x, raw[k].y));
    const float4 hi = bf16x4_f32(make_uint2(raw[k].z, raw[k].w));
    const float zv[kItems] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const float d = zv[j] - yv[k][j];
      acc[j] = fmaf(d, d, acc[j]);
    }
  }
  return block_sum8(acc);
}

// The shared::cluster address of `p` (this block's shared memory) in the
// shared memory of the cluster's block `rank`.
__device__ __forceinline__ unsigned cluster_addr(const void* p, unsigned rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// Grid (C, rows::grid_yz over the R * W rows), cluster (C, 1, 1): the C
// blocks of a cluster cover one row (row w of receiver r) across all
// nchunks chunks, block b the chunks b, b + C, ..., warp i of them to warp
// i % kClWarps.  Each partial goes to slot c of block 0's shared memory
// (nchunks floats): block 0's own with a store, the others' with st.async,
// which counts its bytes on block 0's mbarrier.  Block 0 waits there, then
// sums the row.  z: 16-byte aligned, ld and rs multiples of 8
// (rows::Cols8::fits).  VY: y 16-byte aligned at every receiver's row.
template <bool VY>
__global__ void __launch_bounds__(kClThreads)
sqdist_cluster_kernel(const __nv_bfloat16* __restrict__ z, const float* __restrict__ y,
                      float* __restrict__ out, int R, int W, int64_t D, int64_t ld,
                      int64_t rs, int nchunks) {
  namespace cg = cooperative_groups;
  extern __shared__ float s_part[];                  // block 0's: the row's partials
  __shared__ alignas(8) unsigned long long s_bar;    // block 0's: the others' have landed
  cg::cluster_group cluster = cg::this_cluster();
  const int64_t q = rows::grid_row();
  if (q >= static_cast<int64_t>(R) * W) return;   // the whole cluster
  // (r, w) from q; no division for a single matrix, a 32-bit one where q fits.
  int64_t r = 0, w = q;
  if (R > 1) {
    r = q <= 0xffffffffLL ? static_cast<uint32_t>(q) / static_cast<uint32_t>(W) : q / W;
    w = q - r * W;
  }
  const int C = static_cast<int>(cluster.num_blocks());
  const int b = static_cast<int>(cluster.block_rank());
  const unsigned bar = static_cast<unsigned>(__cvta_generic_to_shared(&s_bar));
  if (b == 0 && threadIdx.x == 0) {
    // One arrival (this one) and the bytes of the other blocks' partials.
    const unsigned bytes = 4u * static_cast<unsigned>(nchunks - (nchunks + C - 1) / C);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
  }
  // The cluster barrier's arrival now and its wait after the first chunk:
  // block 0 has started and set up its mbarrier before any partial is sent.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* zr = z + r * rs + w * ld;
  const float* yr = y + r * D;
  const unsigned part_a = cluster_addr(s_part, 0), bar_a = cluster_addr(&s_bar, 0);
  bool waited = false;
  for (int c = b + C * warp; c < nchunks; c += C * kClWarps) {
    const int64_t c0 = static_cast<int64_t>(c) * kChunk;
    const float p = c0 + kChunk <= D ? chunk_partial<true, VY>(zr, yr, c0, lane, D)
                                     : chunk_partial<false, VY>(zr, yr, c0, lane, D);
    if (!waited) {   // the same in the whole warp
      asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
      waited = true;
    }
    if (lane == 0) {
      if (b == 0)
        s_part[c] = p;
      else
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
            :: "r"(part_a + 4u * static_cast<unsigned>(c)), "r"(__float_as_uint(p)),
               "r"(bar_a) : "memory");
    }
  }
  if (!waited) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (b != 0) return;   // nothing reads this block's shared memory
  __syncthreads();      // block 0's own partials
  if (warp != 0) return;
  for (unsigned done = 0; !done;)   // the others' partials
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar) : "memory");
  // sqdist_finish_kernel's order: thread c (lane c / 8, value c % 8 here)
  // adds partials c, c + 256, ... from 0.f, then block_sum.
  float acc[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int c = 8 * lane + j;
    acc[j] = c < nchunks ? 0.f + s_part[c] : 0.f;
  }
  if (nchunks > kThreads) {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      for (int c = 8 * lane + j + kThreads; c < nchunks; c += kThreads) acc[j] += s_part[c];
  }
  const float s = block_sum8(acc);
  if (lane == 0) out[q] = s;
}

// ---- K6: one launch; the last block of each group of workers finishes it --

constexpr int kSegThreads = 256;
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kSegRows = 4;                          // workers a block
constexpr int kSegVecs = 2;                          // float4 groups a thread
constexpr int kSegItems = 4 * kSegVecs;              // coordinates a thread
constexpr int kSegChunk = kSegThreads * kSegItems;   // 2,048 a block

// The coordinate of item i of thread t in the chunk from c0: group i / 4
// covers the 1,024 coordinates from c0 + 1,024 (i / 4), 4 consecutive ones
// a thread with VEC (one float4), else one every 256.
template <bool VEC>
__device__ __forceinline__ int64_t seg_coord(int64_t c0, int t, int i) {
  const int64_t base = c0 + 4 * kSegThreads * (i / 4);
  return VEC ? base + 4 * t + i % 4 : base + t + kSegThreads * (i % 4);
}

// Each of the kSegRows values summed over the block in a fixed order (each
// warp's tree, then the warps in order), to every thread.  Every thread must
// call it; it may be called again right away.
__device__ __forceinline__ void row_totals(float (&v)[kSegRows],
                                           float (*s_part)[kSegRows]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < kSegRows; ++r) {
    const float x = rows::warp_total(v[r]);
    if (lane == 0) s_part[warp][r] = x;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kSegRows; ++r) {
    v[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kSegWarps; ++i) v[r] += s_part[i][r];
  }
  __syncthreads();
}

// One row's squares of the thread's coordinates (0 outside every segment)
// and their sum in item order: the same code on every load path, so the
// bfloat16 route squares and adds exactly as float32 does.
__device__ __forceinline__ void square_row(const float (&zv)[kSegItems],
                                           const float (&yv)[kSegItems],
                                           const int (&sid)[kSegItems],
                                           float (&d2)[kSegItems], float& tot) {
  tot = 0.f;
#pragma unroll
  for (int i = 0; i < kSegItems; ++i) {
    const float e = zv[i] - yv[i];
    d2[i] = sid[i] >= 0 ? e * e : 0.f;
    tot += d2[i];
  }
}

// Grid (nchunks, rows::grid_yz over the ceil(W / kSegRows) groups of
// workers).  partial: (W, L, nchunks), entry (w, s, c) written only when s
// lies in chunk c's [lo, hi]; span: (>= groups, nchunks, 2) that [lo, hi]
// (lo > hi: the chunk holds no segment); arrived: (>= groups,) zeros on
// entry, zeros again on exit.  VEC: z aligned to 4 elements, y and seg
// 16-byte aligned and D % 4 == 0.
template <bool VEC, typename T>
__global__ void __launch_bounds__(kSegThreads)
sqdist_segments_kernel(const T* __restrict__ z, const float* __restrict__ y,
                       const int* __restrict__ seg, float* __restrict__ partial,
                       int* __restrict__ span, unsigned* __restrict__ arrived,
                       float* __restrict__ out, int W, int64_t D, int L,
                       int nchunks) {
  __shared__ float s_part[kSegWarps][kSegRows];
  __shared__ int s_lo[kSegWarps], s_hi[kSegWarps];
  __shared__ bool s_last;
  const int64_t g = rows::grid_row();
  const int64_t w0 = g * kSegRows;
  if (w0 >= W) return;   // the whole block
  const int rows_here = static_cast<int>(min(static_cast<int64_t>(kSegRows), W - w0));
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int c = blockIdx.x;
  const int64_t c0 = static_cast<int64_t>(c) * kSegChunk;
  // y and the ids of the thread's coordinates, once for all the rows.
  float yv[kSegItems];
  int sid[kSegItems];   // the coordinate's segment, -1 for none
#pragma unroll
  for (int v = 0; v < kSegVecs; ++v) {
    const int64_t d0 = seg_coord<VEC>(c0, t, 4 * v);
    if (VEC && d0 < D) {   // D % 4 == 0: all four lie below D
      const float4 b = __ldg(reinterpret_cast<const float4*>(y + d0));
      const int4 q = __ldg(reinterpret_cast<const int4*>(seg + d0));
      yv[4 * v] = b.x; yv[4 * v + 1] = b.y; yv[4 * v + 2] = b.z; yv[4 * v + 3] = b.w;
      sid[4 * v] = q.x; sid[4 * v + 1] = q.y; sid[4 * v + 2] = q.z; sid[4 * v + 3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t d = seg_coord<VEC>(c0, t, 4 * v + k);
        yv[4 * v + k] = d < D ? __ldg(y + d) : 0.f;
        sid[4 * v + k] = d < D ? __ldg(seg + d) : -1;
      }
    }
  }
  int lo = INT_MAX, hi = -1;
#pragma unroll
  for (int i = 0; i < kSegItems; ++i) {
    if (sid[i] < 0 || sid[i] >= L) sid[i] = -1;
    if (sid[i] >= 0) {
      lo = min(lo, sid[i]);
      hi = max(hi, sid[i]);
    }
  }
  // Each row's squares, and each thread's sum of them in order.
  float d2[kSegRows][kSegItems], tot[kSegRows];
  if constexpr (VEC && std::is_same<T, __nv_bfloat16>::value) {
    // bfloat16: every row's raw words in flight at once (no load waits on
    // another's conversion), converted where they are squared.  VEC means
    // D % 4 == 0, so a group lies below D whole or not at all (then +0.0).
    uint2 raw[kSegRows][kSegVecs];
#pragma unroll
    for (int r = 0; r < kSegRows; ++r)
#pragma unroll
      for (int v = 0; v < kSegVecs; ++v) {
        const int64_t d0 = seg_coord<true>(c0, t, 4 * v);
        raw[r][v] = r < rows_here && d0 < D ? ldg4_raw(z + (w0 + r) * D + d0)
                                            : make_uint2(0u, 0u);
      }
#pragma unroll
    for (int r = 0; r < kSegRows; ++r) {
      float zv[kSegItems];
#pragma unroll
      for (int v = 0; v < kSegVecs; ++v) {
        const float4 a = bf16x4_f32(raw[r][v]);
        zv[4 * v] = a.x; zv[4 * v + 1] = a.y; zv[4 * v + 2] = a.z; zv[4 * v + 3] = a.w;
      }
      square_row(zv, yv, sid, d2[r], tot[r]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kSegRows; ++r) {
      float zv[kSegItems];
      const T* zr = z + (w0 + r) * D;
#pragma unroll
      for (int v = 0; v < kSegVecs; ++v) {
        const int64_t d0 = seg_coord<VEC>(c0, t, 4 * v);
        if (r < rows_here && VEC && d0 < D) {
          const float4 a = ldg4_f32(zr + d0);
          zv[4 * v] = a.x; zv[4 * v + 1] = a.y; zv[4 * v + 2] = a.z; zv[4 * v + 3] = a.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int64_t d = seg_coord<VEC>(c0, t, 4 * v + k);
            zv[4 * v + k] = r < rows_here && d < D ? ldg_f32(zr + d) : 0.f;
          }
        }
      }
      square_row(zv, yv, sid, d2[r], tot[r]);
    }
  }
  // The chunk's segment range [lo, hi] and each row's sum, to every thread.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  row_totals(tot, s_part);   // its barriers publish s_lo and s_hi
#pragma unroll
  for (int i = 0; i < kSegWarps; ++i) {
    lo = min(lo, s_lo[i]);
    hi = max(hi, s_hi[i]);
  }
  // Thread 0 writes every partial and the span, then signals: one thread's
  // release covers all of the block's writes.
  float* pw = partial + w0 * L * nchunks + c;   // row w0 + r, segment s: + (r L + s) nchunks
  if (lo == hi) {   // one segment: each row's sum is its partial
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < kSegRows; ++r)
        if (r < rows_here) pw[(static_cast<int64_t>(r) * L + lo) * nchunks] = tot[r];
    }
  } else {
    for (int s = lo; s <= hi; ++s) {   // the same range in every thread
      float acc[kSegRows];
#pragma unroll
      for (int r = 0; r < kSegRows; ++r) {
        acc[r] = 0.f;
#pragma unroll
        for (int i = 0; i < kSegItems; ++i) acc[r] += sid[i] == s ? d2[r][i] : 0.f;
      }
      row_totals(acc, s_part);
      if (t == 0) {
#pragma unroll
        for (int r = 0; r < kSegRows; ++r)
          if (r < rows_here) pw[(static_cast<int64_t>(r) * L + s) * nchunks] = acc[r];
      }
    }
  }
  if (t == 0) {
    int* sp = span + (g * nchunks + c) * 2;
    sp[0] = lo;
    sp[1] = hi;
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> count(arrived[g]);
    s_last = count.fetch_add(1u, cuda::memory_order_acq_rel) ==
             static_cast<unsigned>(nchunks - 1);
    if (s_last) count.store(0u, cuda::memory_order_relaxed);   // all have arrived
  }
  __syncthreads();
  if (!s_last) return;
  // The last block (thread 0's acquire, then the barrier): out[w, s] = the
  // partials of the chunks that hold s, in chunk order.  Each half warp
  // takes one (row, segment) pair a round (row-major: pairs 2 warp + half,
  // then 16 further each round), its lane l the chunks l, l + 16, ..., then
  // a fixed tree over the 16 lanes.
  const int* sg = span + g * nchunks * 2;
  const int half = lane / 16, hl = lane % 16;
  int r = 0, s = 2 * warp + half;
  while (s >= L) s -= L, ++r;   // that pair, without a division
  for (int64_t q0 = 0; q0 < static_cast<int64_t>(rows_here) * L; q0 += 2 * kSegWarps) {
    const bool valid = r < rows_here;   // the same for the round's 16 lanes
    const float* ps = pw - c + (static_cast<int64_t>(valid ? r : 0) * L + s) * nchunks;
    float acc = 0.f;
#pragma unroll 2
    for (int cc = hl; cc < nchunks; cc += 16) {
      const int a = __ldcg(sg + 2 * cc), b = __ldcg(sg + 2 * cc + 1);
      const float x = valid ? __ldcg(ps + cc) : 0.f;
      acc += a <= s && s <= b ? x : 0.f;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (hl == 0 && valid) out[(w0 + r) * L + s] = acc;
    for (s += 2 * kSegWarps; s >= L && r < rows_here;) s -= L, ++r;
  }
}

// The masked route of K2: 8 warps, 512 coordinates a block (kSqVec groups
// of 128 per lane, 4 coordinates a lane each), SqRows::kRows member rows in
// flight per warp.
constexpr int kSqWarps = 8;
constexpr int kSqThreads = 32 * kSqWarps;
constexpr int kSqVec = 4;
constexpr int kSqCols = 128 * kSqVec;
constexpr int kSqCap = 2048;   // mask entries compacted at a time (8 KB)

// A lane's loads of one member row's group of 4 coordinates, as load_cols
// lays them out: float4s of float32 (or of a bfloat16 row converted at the
// load, on the scalar path), two rows in flight per warp.
template <bool VEC, typename T>
struct SqRows {
  static constexpr int kRows = 2;
  using Raw = float4;
  __device__ static Raw load(const T* p, int64_t d0, int lane, int64_t D) {
    return rows::load_cols<VEC>(p, d0, lane, D);
  }
  __device__ static float4 value(const Raw& r) { return r; }
};

// bfloat16 with VEC: the raw 8 bytes of each group (ldg4_raw), converted
// where they are summed, so that every row's loads are in flight before the
// first returns; four rows in flight per warp, in the registers float32
// uses for two (the same 128 bytes a lane).  VEC means D % 4 == 0, so a
// group lies below D whole or not at all (then +0.0, as load_cols gives).
template <>
struct SqRows<true, __nv_bfloat16> {
  static constexpr int kRows = 4;
  using Raw = uint2;
  __device__ static Raw load(const __nv_bfloat16* p, int64_t d0, int lane, int64_t D) {
    return d0 + 4 * lane < D ? ldg4_raw(p + d0 + 4 * lane) : make_uint2(0u, 0u);
  }
  __device__ static float4 value(const Raw& u) { return bf16x4_f32(u); }
};

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
// only.  VEC: z, ld, rs, y and D allow 4-element loads.
template <bool VEC, typename T>
__global__ void __launch_bounds__(kSqThreads)
sqdist_masked_partial_kernel(const T* __restrict__ z, const float* __restrict__ y,
                             const float* __restrict__ mask,
                             float* __restrict__ partial, int R, int S, int64_t D,
                             int64_t ld, int64_t rs, int nchunks) {
  using Rows = SqRows<VEC, T>;
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
    for (int j = warp; j < n; j += Rows::kRows * kSqWarps) {
      typename Rows::Raw zv[Rows::kRows][kSqVec];
#pragma unroll
      for (int u = 0; u < Rows::kRows; ++u)
        if (j + u * kSqWarps < n) {
          const T* row = z + s_row[j + u * kSqWarps] * ld;
#pragma unroll
          for (int v = 0; v < kSqVec; ++v) zv[u][v] = Rows::load(row, d0 + 128 * v, lane, D);
        }
#pragma unroll
      for (int u = 0; u < Rows::kRows; ++u)
        if (j + u * kSqWarps < n) {   // the same for the whole warp
          float acc = 0.f;
#pragma unroll
          for (int v = 0; v < kSqVec; ++v) acc = sq4(Rows::value(zv[u][v]), yv[v], acc);
          acc = rows::warp_total(acc);
          if (lane == 0)
            partial[static_cast<int64_t>(s_row[j + u * kSqWarps]) * nchunks] = acc;
        }
    }
  }
}

// Grid (D-blocks of Cols::kCols, rows::grid_yz over R); a: (R, W)
// contiguous, out: (R, D) contiguous; rows::kept_rows_smem(W, true) bytes
// of dynamic shared memory.  Cols: rows::Cols8 where Cols8::fits, else
// rows::Cols4<VEC>, VEC where z, ld and rs allow 4-element loads (base
// aligned to 4 elements, ld and rs multiples of 4).
template <class Cols, typename T>
__global__ void __launch_bounds__(rows::kSumThreads)
weighted_sum_kernel(const T* __restrict__ z, const float* __restrict__ a,
                    float* __restrict__ out, int R, int W, int64_t D, int64_t ld,
                    int64_t rs) {
  const int64_t r = rows::grid_row();
  if (r >= R) return;   // the whole block
  float4 acc[Cols::kN / 4];
  if (rows::sum_kept_rows<Cols, true>(z + r * rs, a + r * W, W, rows::NonZero(), ld, D,
                                      acc))
    Cols::store(out + r * D, static_cast<int64_t>(blockIdx.x) * Cols::kCols,
                threadIdx.x % 32, D, acc);
}

template <class Cols, typename T>
int launch_weighted_sum(const T* z, const float* a, float* out, int R, int W,
                        int64_t D, int64_t ld, int64_t rs, cudaStream_t s) {
  const dim3 grid = rows::grid_yz(
      static_cast<unsigned>((D + Cols::kCols - 1) / Cols::kCols), R);
  weighted_sum_kernel<Cols, T><<<grid, rows::kSumThreads, rows::kept_rows_smem(W, true), s>>>(
      z, a, out, R, W, D, ld, rs);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int scratch_cols(long long D) { return static_cast<int>((D + kChunk - 1) / kChunk); }
int masked_scratch_cols(long long D) {
  return static_cast<int>((D + kSqCols - 1) / kSqCols);
}
int segment_chunks(long long D) {
  return D > 0 ? static_cast<int>((D + kSegChunk - 1) / kSegChunk) : 1;
}

template <typename T>
int partial_sqdist(const T* z, const float* y, float* partial, float* out, int R,
                   int W, long long D, long long ld, long long rs, void* stream) {
  if (W == 0 || R == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const int nchunks = scratch_cols(D);
  if (nchunks > 0) {
    const dim3 grid = rows::grid_yz(static_cast<unsigned>(nchunks),
                                    static_cast<long long>(R) * W);
    sqdist_partial_kernel<T><<<grid, kThreads, 0, s>>>(
        z, y, partial, R, W, static_cast<int64_t>(D), static_cast<int64_t>(ld),
        static_cast<int64_t>(rs), nchunks);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  sqdist_finish_kernel<false><<<static_cast<unsigned>(R) * W, kThreads, 0, s>>>(
      partial, nullptr, out, nchunks);
  return static_cast<int>(cudaGetLastError());
}

// The cluster size for nchunks chunks: one chunk a warp up to kClMaxBlocks
// blocks, then several a warp.
int cluster_blocks(long long nchunks) {
  const long long c = (nchunks + kClWarps - 1) / kClWarps;
  return static_cast<int>(c < kClMaxBlocks ? c : kClMaxBlocks);
}

// Whether a bfloat16 z takes sqdist_cluster_kernel: 1 to kClMaxChunks chunks,
// and z, ld and rs fit its 16-byte loads.
bool sqdist_cluster_fits(const __nv_bfloat16* z, long long D, long long ld, long long rs) {
  const long long nchunks = (D + kChunk - 1) / kChunk;
  return nchunks >= 1 && nchunks <= kClMaxChunks && rows::Cols8::fits(z, ld, rs);
}

int partial_sqdist_cluster(const __nv_bfloat16* z, const float* y, float* out, int R, int W,
                           long long D, long long ld, long long rs, void* stream) {
  if (W == 0 || R == 0) return static_cast<int>(cudaGetLastError());
  const int nchunks = scratch_cols(D);
  const int C = cluster_blocks(nchunks);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = rows::grid_yz(static_cast<unsigned>(C), static_cast<long long>(R) * W);
  cfg.blockDim = dim3(kClThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(nchunks) * sizeof(float);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool vy = aligned16(y) && (R == 1 || D % 4 == 0);
  const int64_t d = static_cast<int64_t>(D), l = static_cast<int64_t>(ld),
                s = static_cast<int64_t>(rs);
  const cudaError_t e =
      vy ? cudaLaunchKernelEx(&cfg, sqdist_cluster_kernel<true>, z, y, out, R, W, d, l, s,
                              nchunks)
         : cudaLaunchKernelEx(&cfg, sqdist_cluster_kernel<false>, z, y, out, R, W, d, l, s,
                              nchunks);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T>
int partial_sqdist_masked(const T* z, const float* y, const float* mask,
                          float* partial, float* out, int R, int S, long long D,
                          long long ld, long long rs, void* stream) {
  if (S == 0 || R == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const int nchunks = masked_scratch_cols(D);
  if (nchunks > 0) {
    const bool vec = aligned4(z) && aligned16(y) && ld % 4 == 0 && rs % 4 == 0 &&
                     D % 4 == 0;
    const dim3 grid = rows::grid_yz(static_cast<unsigned>(nchunks), R);
    if (vec)
      sqdist_masked_partial_kernel<true, T><<<grid, kSqThreads, 0, s>>>(
          z, y, mask, partial, R, S, static_cast<int64_t>(D),
          static_cast<int64_t>(ld), static_cast<int64_t>(rs), nchunks);
    else
      sqdist_masked_partial_kernel<false, T><<<grid, kSqThreads, 0, s>>>(
          z, y, mask, partial, R, S, static_cast<int64_t>(D),
          static_cast<int64_t>(ld), static_cast<int64_t>(rs), nchunks);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  sqdist_finish_kernel<true><<<static_cast<unsigned>(R) * S, kThreads, 0, s>>>(
      partial, mask, out, nchunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int weighted_sum(const T* z, const float* a, float* out, int R, int W, long long D,
                 long long ld, long long rs, void* stream) {
  if (D == 0 || R == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (rows::Cols8::fits(z, ld, rs))
      return launch_weighted_sum<rows::Cols8, T>(z, a, out, R, W, D, ld, rs, s);
  }
  const bool vec = aligned4(z) && ld % 4 == 0 && rs % 4 == 0;
  return vec ? launch_weighted_sum<rows::Cols4<true>, T>(z, a, out, R, W, D, ld, rs, s)
             : launch_weighted_sum<rows::Cols4<false>, T>(z, a, out, R, W, D, ld, rs, s);
}

template <typename T>
int partial_sqdist_segments(const T* z, const float* y, const int* seg,
                            float* partial, int* span, unsigned* arrived,
                            float* out, int W, long long D, int L, void* stream) {
  if (W == 0 || L == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const int nchunks = segment_chunks(D);
  const dim3 grid = rows::grid_yz(static_cast<unsigned>(nchunks),
                                  (static_cast<long long>(W) + kSegRows - 1) / kSegRows);
  const bool vec = aligned4(z) && aligned16(y) && aligned16(seg) && D % 4 == 0;
  if (vec)
    sqdist_segments_kernel<true, T><<<grid, kSegThreads, 0, s>>>(
        z, y, seg, partial, span, arrived, out, W, static_cast<int64_t>(D), L,
        nchunks);
  else
    sqdist_segments_kernel<false, T><<<grid, kSegThreads, 0, s>>>(
        z, y, seg, partial, span, arrived, out, W, static_cast<int64_t>(D), L,
        nchunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Columns of the (W, ncols) float32 scratch buffer partial_sqdist_* needs.
REPRO_EXPORT int partial_sqdist_scratch_cols(long long D) { return scratch_cols(D); }

// Columns of the (R * S, ncols) scratch buffer partial_sqdist_masked_* needs.
REPRO_EXPORT int partial_sqdist_masked_scratch_cols(long long D) {
  return masked_scratch_cols(D);
}

// K2's layout for a bfloat16 z (R, W, D) at z[r * rs + w * ld + d]: 1 where
// partial_sqdist_cluster_bf16 takes it (one launch, no scratch), else 0
// (partial_sqdist_bf16's two passes).  Decided by the base, the strides and
// D alone.
REPRO_EXPORT int partial_sqdist_cluster_fits(const __nv_bfloat16* z, long long D,
                                             long long ld, long long rs) {
  return sqdist_cluster_fits(z, D, ld, rs) ? 1 : 0;
}

// The unmasked K2 on a bfloat16 z that partial_sqdist_cluster_fits admits:
// y (R, D), out (R, W), both contiguous float32; one kernel launch on
// `stream` (a cluster of up to 8 blocks for each pair of rows), no scratch.
// The bits of partial_sqdist_f32 on z.float().
REPRO_EXPORT int partial_sqdist_cluster_bf16(const __nv_bfloat16* z, const float* y,
                                             float* out, int R, int W, long long D,
                                             long long ld, long long rs, void* stream) {
  return partial_sqdist_cluster(z, y, out, R, W, D, ld, rs, stream);
}

// Chunks of K6's grid for D coordinates (at least 1, so that every worker's
// row is written even at D = 0).
REPRO_EXPORT int partial_sqdist_segments_chunks(long long D) { return segment_chunks(D); }

// Each entry point below comes twice: *_f32 for a float32 z and *_bf16 for a
// bfloat16 z (the same kernel with the bf16 load); every other argument is
// float32 (or int32 for seg) in both.
#define REPRO_WEISZFELD_EXPORTS(SFX, T)                                            \
  /* z: (R, W, D) at z[r * rs + w * ld + d], y: (R, D), partial: (R * W,      \
     partial_sqdist_scratch_cols(D)), out: (R, W); y, partial and out         \
     contiguous.  Launches both passes on `stream`. */                        \
  REPRO_EXPORT int partial_sqdist_##SFX(const T* z, const float* y, float* partial, \
                                        float* out, int R, int W, long long D,  \
                                        long long ld, long long rs, void* stream) { \
    return partial_sqdist<T>(z, y, partial, out, R, W, D, ld, rs, stream);      \
  }                                                                             \
  /* The masked route: mask (R, S) float32 contiguous; rows of mask <= 0 are  \
     not read and their out is 0.  partial: (R * S,                           \
     partial_sqdist_masked_scratch_cols(D)). */                               \
  REPRO_EXPORT int partial_sqdist_masked_##SFX(                                 \
      const T* z, const float* y, const float* mask, float* partial, float* out, \
      int R, int S, long long D, long long ld, long long rs, void* stream) {   \
    return partial_sqdist_masked<T>(z, y, mask, partial, out, R, S, D, ld, rs,  \
                                    stream);                                    \
  }                                                                             \
  /* z: (R, W, D) at z[r * rs + w * ld + d], a: (R, W), out: (R, D); a and out \
     contiguous; min(W, 2,048) * 8 bytes of shared memory. */                 \
  REPRO_EXPORT int weighted_sum_##SFX(const T* z, const float* a, float* out,   \
                                      int R, int W, long long D, long long ld,  \
                                      long long rs, void* stream) {             \
    return weighted_sum<T>(z, a, out, R, W, D, ld, rs, stream);                 \
  }                                                                             \
  /* z: (W, D), y: (D,), seg: (D,) int32, partial: (W, L, nchunks) float32,   \
     span: (W, nchunks, 2) int32 (ceil(W / 4) rows used), arrived: (>= W,)    \
     uint32 zeros (zeros again when the kernel ends), out: (W, L); nchunks =  \
     partial_sqdist_segments_chunks(D); contiguous.  One launch. */           \
  REPRO_EXPORT int partial_sqdist_segments_##SFX(                               \
      const T* z, const float* y, const int* seg, float* partial, int* span,    \
      unsigned* arrived, float* out, int W, long long D, int L, void* stream) { \
    return partial_sqdist_segments<T>(z, y, seg, partial, span, arrived, out, W, \
                                      D, L, stream);                            \
  }

REPRO_WEISZFELD_EXPORTS(f32, float)
REPRO_WEISZFELD_EXPORTS(bf16, __nv_bfloat16)
