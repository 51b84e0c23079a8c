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
// axis.  Here one thread owns one column (coordinate), and two designs
// serve it.
//
// K4 and K5 at W <= 128 (kNetCap): a sorting network in registers.  Each
// thread loads its column's W values into registers (W coalesced loads, all
// in flight at once), pads them with +inf to N, W rounded up to a multiple
// of 8 (one network for each of the 16 widths N = 8, 16, ..., 128), and runs
// Batcher's odd-even merge sort on them: the network for the next power of
// two with every compare-exchange that touches a wire >= N left out (its
// min goes to the lower wire, so +inf padding there would never move).
// NaN orders last, as the plain version's sort puts it: each NaN enters the
// network as +inf and is counted, and a rank of W - #NaN or more is NaN.
// One warp a block, so the ~1,243 warps at D = 39,760 spread evenly over
// the 132 SMs; no shared memory.
//
// * K4 reads only ranks (N - 8) / 2 .. N / 2, which hold lo and hi for
//   every W of the bucket, so the compiler drops every compare-exchange
//   whose outputs cannot reach them: at W = 70 (N = 72) 1,163 float min/max
//   a coordinate (robust_stats.median_network_ops), against the W^2 = 4,900
//   comparisons of the rank count below (94 registers at N = 72, 160 at
//   N = 128, no spills).  The selection moves values, so the result is the
//   plain version's bits (a zero's sign aside where -0 and +0 share a
//   column: the sort leaves their order open, while FMNMX puts -0 first),
//   and (lo + hi) * 0.5 is computed with the same two roundings.
// * K5 adds the kept ranks [trim, W - trim) in ascending rank order in
//   float32 and divides by W - 2 trim.  trim is a runtime value, so every
//   rank may be read and only the compare-exchanges on wires >= N are gone:
//   750 at N = 72, 1,500 float min/max a coordinate
//   (robust_stats.trimmed_network_ops).  The sum is one fully unrolled loop
//   over the wires with a predicate, so v[] is never indexed by a runtime
//   rank and stays in registers (96 registers at N = 72, 158 at N = 128,
//   no spills).  It adds only kept values: a sum of every value less the
//   tails would let dropped rows of 1e6 cancel the kept values' digits.  The result is NaN exactly when #NaN > trim (a NaN is
//   then among the kept ranks), as the plain version's mean of the sorted
//   kept rows gives; +inf and -inf among the kept ranks give NaN in both.
//   It sums in rank order, the plain version in its own: rtol 1e-5, and the
//   same bits on every launch.
//
// Past that cap a block of kTile threads owns kTile coordinates, one column
// per thread, and each thread ranks its column's values by counting,
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
// (11.1 MB at W = 70, D = 39,760: 3.3 us).  At 64 float min/max results per
// clock per SM (half the float32 FMA rate) on 132 SMs at 1.98 GHz, K4's
// network takes 2.8 us at W = 70, below the bytes, and K5's 3.6 us, just
// above them.  The rank count does W^2 comparisons per coordinate and is
// bound by instruction issue and latency (about nine warps per SM at
// D = 39,760), not by HBM.
//
// bfloat16 messages (the bf16 wire, the *_bf16 entry points): every route
// takes z in bfloat16 and loads it into the same registers (or the same
// float32 slab) as the float32 kernel, converted exactly; nothing else
// changes, so the bf16 route gives the bits of the float32 kernel run on
// z.float(), reading half the bytes.  The output stays float32.  K4's
// network route on a bfloat16 z with D even and a 4-byte aligned base takes
// two columns a thread instead (median_pairs_kernel, the "pairs" layout):
// one 4-byte load a row reads both columns (a warp reads 128 bytes a row,
// not 64), each word's two halves are keyed into 16-bit integers that order
// like the upcast values (median_keys: NaN above +inf, -0 below +0), and the
// same pruned network runs on words with packed min.s16x2/max.s16x2, one
// VIMNMX.S16x2 ordering both columns: at W = 70 the float network's 1,163
// min/max as 1,141 VIMNMX.S16x2 and 11 three-input VIMNMX3.S16x2 (ptxas
// fuses those pairs), against 1,163 FMNMX for one column in float32; 1,920
// instructions in all, 80 registers.  Its instruction floor, 1,163 x 19,880
// pairs / (64 a clock x 132 SMs x 1.98 GHz) = 1.38 us, is below the bytes'
// 1.71 us; its 622 one-warp blocks put two warps on some of the 528 warp
// schedulers, so it runs near twice one warp's issue time.  A rank from
// W - #NaN on keys above +inf, so NaN needs no count.  The
// selected keys unkey to the exact bf16 values, and (lo + hi) * 0.5 takes
// float32's two roundings: the float32 kernel's bits, zeros too, because
// Hopper's FMNMX also orders -0 below +0 (held on the card on every column
// of +-0 at W = 1..9).  The two halves' ranks are the same, so one network
// serves both.  K5 takes the same views two columns a thread
// (trimmed_pairs_kernel, its own "pairs" layout): the same loads and keys,
// the unpruned network on words (1,500 packed min/max for two columns at W
// = 70, where float32 runs 1,500 FMNMX for one; instruction floor 1,500 x
// 19,880 / (64 x 132 x 1.98 GHz) = 1.78 us, just above the bytes), and the
// kept ranks unkeyed and summed per column as the float32 kernel sums them.
// Other bf16 views and W past 128 load one column a thread as above.
//
// NaN on the rank-count routes: every comparison with NaN is false, so a
// NaN gets rank 0 and the ranks of its column are no longer a permutation;
// that column's result is then unspecified and may differ from the plain
// version (which sorts NaN last).  NaN rows come only from the fault
// attacks, which the guards of the reference remove before aggregation.
#include <cmath>

#include "common.cuh"
#include "keys.cuh"

namespace {

// ---- K4 and K5 at W <= kNetCap: a sorting network in registers ------------

constexpr int kNetCap = 128;     // the most workers the network route takes
constexpr int kNetStep = 8;      // one network per multiple of 8 workers
constexpr int kNetThreads = 32;  // one column a thread, one warp a block

__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// One stage of Batcher's odd-even merge sort on P = pow2_at_least(N) wires,
// merge size p = 2^SP, distance k = 2^SK, keeping only the compare-exchanges
// between wires below N (min to the lower wire).
template <int N, int SP, int SK>
__device__ __forceinline__ void sort_stage(float (&v)[N]) {
  constexpr int P = pow2_at_least(N), p = 1 << SP, k = 1 << SK;
#pragma unroll
  for (int j = k % p; j + k < P; j += 2 * k) {
#pragma unroll
    for (int i = 0; i < k; ++i) {
      const int a = i + j, b = a + k;
      if (b < N && a / (2 * p) == b / (2 * p)) {
        const float x = v[a], y = v[b];
        v[a] = fminf(x, y);
        v[b] = fmaxf(x, y);
      }
    }
  }
}

// The stages in order: SP = 0, 1, ...; within each, SK = SP down to 0.
template <int N, int SP = 0, int SK = 0>
__device__ __forceinline__ void sort_network(float (&v)[N]) {
  if constexpr ((1 << SP) < pow2_at_least(N)) {
    sort_stage<N, SP, SK>(v);
    if constexpr (SK > 0)
      sort_network<N, SP, SK - 1>(v);
    else
      sort_network<N, SP + 1, SP + 1>(v);
  }
}

// Column `col` of the (W, D) matrix z into v[0 .. W), +inf in v[W .. N) and
// in place of each NaN; returns the number of NaN.
template <int N, typename T>
__device__ __forceinline__ int load_column(const T* __restrict__ z, int W,
                                           int64_t D, int64_t col, float (&v)[N]) {
  int nan = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float x = i < W ? ldg_f32(z + static_cast<int64_t>(i) * D + col) : INFINITY;
    const bool is_nan = x != x;
    nan += is_nan;
    v[i] = is_nan ? INFINITY : x;
  }
  return nan;
}

// The median of each column for W in (N - kNetStep, N]: the values of ranks
// lo = (W - 1) / 2 and hi = W / 2 of the sorted column, NaN from rank
// W - #NaN on.
template <int N, typename T>
__global__ void __launch_bounds__(kNetThreads)
median_network_kernel(const T* __restrict__ z, float* __restrict__ out, int W,
                      int64_t D) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kNetThreads + threadIdx.x;
  if (col >= D) return;
  float v[N];
  const int nan = load_column<N>(z, W, D, col, v);
  sort_network<N>(v);
  const int lo = (W - 1) / 2, hi = W / 2;
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int r = (N - kNetStep) / 2; r <= N / 2; ++r) {   // every lo and hi of the bucket
    if (r == lo) a = v[r];
    if (r == hi) b = v[r];
  }
  if (lo >= W - nan) a = NAN;
  if (hi >= W - nan) b = NAN;
  out[col] = lo == hi ? a : __fmul_rn(__fadd_rn(a, b), 0.5f);
}

// The mean of each column's values of rank [trim, W - trim) for W in
// (N - kNetStep, N], summed in ascending rank order; NaN when a NaN (sorted
// last) falls in that range, that is when #NaN > trim.
template <int N, typename T>
__global__ void __launch_bounds__(kNetThreads)
trimmed_network_kernel(const T* __restrict__ z, float* __restrict__ out, int W,
                       int64_t D, int trim) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kNetThreads + threadIdx.x;
  if (col >= D) return;
  float v[N];
  const int nan = load_column<N>(z, W, D, col, v);
  sort_network<N>(v);
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < N; ++r)   // a predicate per wire: v[] stays in registers
    if (r >= trim && r < W - trim) acc += v[r];
  out[col] = nan > trim ? NAN : acc / static_cast<float>(W - 2 * trim);
}

// Launches K4's (kMedian) or K5's network for the smallest multiple of
// kNetStep >= W.
template <bool kMedian, typename T, int N = kNetStep>
int launch_network(const T* z, float* out, int W, long long D, int trim,
                   cudaStream_t s) {
  if constexpr (N < kNetCap) {
    if (W > N) return launch_network<kMedian, T, N + kNetStep>(z, out, W, D, trim, s);
  }
  const unsigned blocks = static_cast<unsigned>((D + kNetThreads - 1) / kNetThreads);
  if constexpr (kMedian)
    median_network_kernel<N, T><<<blocks, kNetThreads, 0, s>>>(z, out, W,
                                                                static_cast<int64_t>(D));
  else
    trimmed_network_kernel<N, T><<<blocks, kNetThreads, 0, s>>>(
        z, out, W, static_cast<int64_t>(D), trim);
  return static_cast<int>(cudaGetLastError());
}

// ---- K4 bf16: two columns a thread on packed 16-bit keys --------------------
//
// The same pruned network as sort_network, on words of two keys (keys.cuh),
// each compare-exchange one pair_min and one pair_max for both columns.  Kept
// apart from the float template that K5 and the float32 kernel share, so
// their SASS does not move.

template <int N, int SP, int SK>
__device__ __forceinline__ void sort_stage_pairs(unsigned (&v)[N]) {
  constexpr int P = pow2_at_least(N), p = 1 << SP, k = 1 << SK;
#pragma unroll
  for (int j = k % p; j + k < P; j += 2 * k) {
#pragma unroll
    for (int i = 0; i < k; ++i) {
      const int a = i + j, b = a + k;
      if (b < N && a / (2 * p) == b / (2 * p)) {
        const unsigned x = v[a], y = v[b];
        v[a] = pair_min(x, y);
        v[b] = pair_max(x, y);
      }
    }
  }
}

template <int N, int SP = 0, int SK = 0>
__device__ __forceinline__ void sort_network_pairs(unsigned (&v)[N]) {
  if constexpr ((1 << SP) < pow2_at_least(N)) {
    sort_stage_pairs<N, SP, SK>(v);
    if constexpr (SK > 0)
      sort_network_pairs<N, SP, SK - 1>(v);
    else
      sort_network_pairs<N, SP + 1, SP + 1>(v);
  }
}

// K4's keys of a word of two raw bfloat16 values: a NaN half first loses
// its sign bit (a negative NaN becomes a positive one), then each half b
// keys as b for b >= 0 and b ^ 0x7fff for b < 0 (prmt replicates each half's
// sign bit over it), the order of keys.cuh's pair_keys for every other
// value.  So every NaN half keys in (0x7f80, 0x7fff]: above +inf's 0x7f80,
// at most the pads' kPairTop.  Five instructions a word.
__device__ __forceinline__ unsigned median_keys(unsigned w) {
  const unsigned t = (w & 0x7fff7fffu) + 0x007f007fu;   // bit 15 of a half: NaN
  w &= ~(t & 0x80008000u);
  unsigned sign;
  asm("prmt.b32 %0, %1, 0, 0xbb99;" : "=r"(sign) : "r"(w));
  return w ^ (sign & 0x7fff7fffu);
}

// The raw bfloat16 bits of both halves of a median_keys word, in two
// instructions (the sign spread by prmt, as in median_keys): the keys'
// inverse for every value, and for a NaN key (a cleared sign bit) a
// positive NaN.
__device__ __forceinline__ unsigned pair_raw(unsigned k) {
  unsigned sign;
  asm("prmt.b32 %0, %1, 0, 0xbb99;" : "=r"(sign) : "r"(k));
  return k ^ (sign & 0x7fff7fffu);
}

// The float32 value of a half of a sorted key word (its key in the low 16
// bits of `half`): NaN for a key above +inf's (a NaN or a pad: ranks from
// W - #NaN on), else the half's raw bfloat16 value, exactly.
__device__ __forceinline__ float key_value16(unsigned half) {
  const unsigned k = half & 0xffffu;
  return static_cast<short>(k) > 0x7f80 ? NAN : __uint_as_float(pair_values(k) << 16);
}

// median_network_kernel for columns 2p and 2p + 1, p < P (P = D / 2 words a
// row): thread p loads word p of each row (4 bytes, W loads in flight as raw
// words), keys the words (median_keys) and pads them with kPairTop to N.
// NaN and the pads key above every other value, so ranks below W - #NaN
// hold a column's other values in the float32 kernel's order (its NaN enter
// as +inf), and a rank from W - #NaN on keys above +inf and reads NaN.  out
// must be 8-byte aligned.
template <int N>
__global__ void __launch_bounds__(kNetThreads)
median_pairs_kernel(const __nv_bfloat16* __restrict__ z, float* __restrict__ out,
                    int W, int64_t P) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kNetThreads + threadIdx.x;
  if (p >= P) return;
  // Row i's word through a pointer stepped a row at a time; rows below
  // N - kNetStep always exist (W > N - kNetStep), so only the bucket's last
  // kNetStep are tested.
  const unsigned* row = reinterpret_cast<const unsigned*>(z) + p;
  unsigned v[N];
#pragma unroll
  for (int i = 0; i < N; ++i, row += P)
    v[i] = i < N - kNetStep || i < W ? __ldg(row) : kPairTop;
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = median_keys(v[i]);
  sort_network_pairs<N>(v);
  const int lo = (W - 1) / 2, hi = W / 2;
  unsigned ka = 0, kb = 0;
#pragma unroll
  for (int r = (N - kNetStep) / 2; r <= N / 2; ++r) {   // every lo and hi of the bucket
    if (r == lo) ka = v[r];
    if (r == hi) kb = v[r];
  }
  const float a0 = key_value16(ka), b0 = key_value16(kb);
  const float a1 = key_value16(ka >> 16), b1 = key_value16(kb >> 16);
  reinterpret_cast<float2*>(out)[p] =
      lo == hi ? make_float2(a0, a1)
               : make_float2(__fmul_rn(__fadd_rn(a0, b0), 0.5f),
                             __fmul_rn(__fadd_rn(a1, b1), 0.5f));
}

// Launches median_pairs_kernel for the smallest multiple of kNetStep >= W.
template <int N = kNetStep>
int launch_median_pairs(const __nv_bfloat16* z, float* out, int W, long long D,
                        cudaStream_t s) {
  if constexpr (N < kNetCap) {
    if (W > N) return launch_median_pairs<N + kNetStep>(z, out, W, D, s);
  }
  const long long P = D / 2;
  const unsigned blocks = static_cast<unsigned>((P + kNetThreads - 1) / kNetThreads);
  median_pairs_kernel<N><<<blocks, kNetThreads, 0, s>>>(z, out, W, static_cast<int64_t>(P));
  return static_cast<int>(cudaGetLastError());
}

// Whether K4's bf16 route takes two columns a thread: the network route (W
// <= kNetCap), D even and a 4-byte aligned z, so that every pair's word is
// aligned (and out 8-byte aligned for its float2 stores).
bool median_pairs_fit(const __nv_bfloat16* z, const float* out, int W, long long D) {
  return W <= kNetCap && D > 0 && D % 2 == 0 && reinterpret_cast<uintptr_t>(z) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 8 == 0;
}

// ---- K5 bf16: two columns a thread on packed 16-bit keys --------------------
//
// trimmed_network_kernel for columns 2p and 2p + 1, p < P, on median_pairs
// keys: the loads and keys of median_pairs_kernel, the unpruned network
// (trim is a runtime value, so every rank may be read: 750 compare-exchanges
// at N = 72, one pair_min and one pair_max each for both columns), then each
// half's kept ranks [trim, W - trim) unkeyed (both halves of a word in two
// instructions, pair_raw) and added in ascending rank order in float32 from
// +0, and divided by W - 2 trim: the float32 kernel's arithmetic on the same
// values.  No NaN count: NaN keys lie above +inf, so a NaN falls in the kept
// range exactly when #NaN > trim, that is when the highest kept key is a
// NaN's, and the column then gets NAN as in the float32 kernel (the adds
// alone would give Hopper's arithmetic NaN word 0x7fffffff, not NAN's
// 0x7fc00000).  A NaN from +inf - inf among the kept values comes from the
// same adds in both kernels.  out must be 8-byte aligned.
template <int N>
__global__ void __launch_bounds__(kNetThreads)
trimmed_pairs_kernel(const __nv_bfloat16* __restrict__ z, float* __restrict__ out,
                     int W, int64_t P, int trim) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kNetThreads + threadIdx.x;
  if (p >= P) return;
  const unsigned* row = reinterpret_cast<const unsigned*>(z) + p;
  unsigned v[N];
#pragma unroll
  for (int i = 0; i < N; ++i, row += P)
    v[i] = i < N - kNetStep || i < W ? __ldg(row) : kPairTop;
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = median_keys(v[i]);
  sort_network_pairs<N>(v);
  float acc0 = 0.f, acc1 = 0.f;
  unsigned top = 0;   // the word of the highest kept rank
#pragma unroll
  for (int r = 0; r < N; ++r)   // a predicate per wire: v[] stays in registers
    if (r >= trim && r < W - trim) {
      const unsigned raw = pair_raw(v[r]);
      acc0 += __uint_as_float(raw << 16);
      acc1 += __uint_as_float(raw & 0xffff0000u);
      top = v[r];
    }
  // A column holds more than trim NaN exactly when its highest kept key is a
  // NaN's; the float32 kernel then writes NAN (the sum's adds would give
  // another NaN word).
  const float kept = static_cast<float>(W - 2 * trim);
  const bool nan0 = static_cast<short>(top & 0xffffu) > 0x7f80;
  const bool nan1 = static_cast<short>(top >> 16) > 0x7f80;
  reinterpret_cast<float2*>(out)[p] =
      make_float2(nan0 ? NAN : acc0 / kept, nan1 ? NAN : acc1 / kept);
}

// Launches trimmed_pairs_kernel for the smallest multiple of kNetStep >= W.
template <int N = kNetStep>
int launch_trimmed_pairs(const __nv_bfloat16* z, float* out, int W, long long D,
                         int trim, cudaStream_t s) {
  if constexpr (N < kNetCap) {
    if (W > N) return launch_trimmed_pairs<N + kNetStep>(z, out, W, D, trim, s);
  }
  const long long P = D / 2;
  const unsigned blocks = static_cast<unsigned>((P + kNetThreads - 1) / kNetThreads);
  trimmed_pairs_kernel<N><<<blocks, kNetThreads, 0, s>>>(z, out, W,
                                                          static_cast<int64_t>(P), trim);
  return static_cast<int>(cudaGetLastError());
}

// ---- The rank count: K4 and K5 past kNetCap ---------------------------------

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
// ... or of z itself in global memory (rows D elements apart).
template <typename T>
struct GlobalColumn {
  const T* v;
  int64_t D;
  __device__ __forceinline__ float operator[](int i) const {
    return ldg_f32(v + static_cast<int64_t>(i) * D);
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

template <bool kMedian, typename T>
__global__ void order_stat_kernel(const T* __restrict__ z,
                                  float* __restrict__ out, int W, int64_t D,
                                  int lo, int hi) {
  extern __shared__ float slab[];   // (W, kTile), float32 for either T
  const int t = threadIdx.x;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kTile + t;
  if (col >= D) return;   // each thread touches only its own column
  float* v = slab + t;
  for (int w = 0; w < W; ++w) v[w * kTile] = to_f32(z[static_cast<int64_t>(w) * D + col]);
  out[col] = order_stat<kMedian>(SlabColumn{v}, W, lo, hi);
}

template <bool kMedian, typename T>
__global__ void order_stat_global_kernel(const T* __restrict__ z,
                                         float* __restrict__ out, int W, int64_t D,
                                         int lo, int hi) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  if (col >= D) return;
  out[col] = order_stat<kMedian>(GlobalColumn<T>{z + col, D}, W, lo, hi);
}

template <bool kMedian, typename T>
int launch(const T* z, float* out, int W, long long D, int lo, int hi,
           void* stream) {
  if (D == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((D + kTile - 1) / kTile);
  if (W > kMaxSlabRows) {
    order_stat_global_kernel<kMedian, T><<<blocks, kTile, 0, s>>>(
        z, out, W, static_cast<int64_t>(D), lo, hi);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(W) * kTile * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        order_stat_kernel<kMedian, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  order_stat_kernel<kMedian, T><<<blocks, kTile, smem, s>>>(
      z, out, W, static_cast<int64_t>(D), lo, hi);
  return static_cast<int>(cudaGetLastError());
}

// The network route up to kNetCap workers; past it the rank count of ranks
// lo and hi (K4) or of the kept range [lo, hi) (K5).
template <bool kMedian, typename T>
int launch_any(const T* z, float* out, int W, long long D, int trim,
               void* stream) {
  if (W > kNetCap) {
    const int lo = kMedian ? (W - 1) / 2 : trim, hi = kMedian ? W / 2 : W - trim;
    return launch<kMedian, T>(z, out, W, D, lo, hi, stream);
  }
  if (D == 0) return static_cast<int>(cudaGetLastError());
  return launch_network<kMedian, T>(z, out, W, D, trim, static_cast<cudaStream_t>(stream));
}

}  // namespace

// z: (W, D) float32 (*_f32) or bfloat16 (*_bf16) contiguous, out: (D,)
// float32; W >= 1.
REPRO_EXPORT int coordinate_median_f32(const float* z, float* out, int W,
                                       long long D, void* stream) {
  return launch_any<true, float>(z, out, W, D, 0, stream);
}

// The bf16 route reports its layout: 1 for two columns a thread
// (median_pairs_fit), else 0 (one a thread, as float32).
REPRO_EXPORT int coordinate_median_bf16(const __nv_bfloat16* z, float* out, int W,
                                        long long D, int* layout, void* stream) {
  *layout = median_pairs_fit(z, out, W, D) ? 1 : 0;
  if (*layout == 1)
    return launch_median_pairs(z, out, W, D, static_cast<cudaStream_t>(stream));
  return launch_any<true, __nv_bfloat16>(z, out, W, D, 0, stream);
}

// As above; 0 <= trim, 2 * trim < W.
REPRO_EXPORT int trimmed_mean_f32(const float* z, float* out, int W,
                                  long long D, int trim, void* stream) {
  return launch_any<false, float>(z, out, W, D, trim, stream);
}

// The bf16 route reports its layout as coordinate_median_bf16 does (the
// same views take two columns a thread).
REPRO_EXPORT int trimmed_mean_bf16(const __nv_bfloat16* z, float* out, int W,
                                   long long D, int trim, int* layout, void* stream) {
  *layout = median_pairs_fit(z, out, W, D) ? 1 : 0;
  if (*layout == 1)
    return launch_trimmed_pairs(z, out, W, D, trim, static_cast<cudaStream_t>(stream));
  return launch_any<false, __nv_bfloat16>(z, out, W, D, trim, stream);
}
