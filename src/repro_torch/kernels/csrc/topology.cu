// K7 masked_neighbor_reduce: per receiver r and coordinate d, the mean of
// the masked senders' values x[r, s, d] (mask[r, s] > 0, the members) after
// dropping the `trim` largest and the `trim` smallest of them, divided by
// max(n_r - 2 * trim, 1) with n_r = sum_s mask[r, s].  trim = 0 is the
// masked mean; a receiver with at most 2 * trim members gives exactly 0.  It
// is the decentralized trimmed mean of repro_torch/topology/masked.py, and
// the initial masked mean of a masked Weiszfeld solve.
// Replaces: repro/kernels/topology.py, masked_neighbor_reduce_call
// (_masked_reduce_kernel), which keeps one receiver's (S, tile) slab in VMEM
// and runs `trim` rounds of "drop one occurrence of the masked max, then of
// the masked min" before a masked sum: no sort.
//
// Bound on the H100: device-memory bytes.  Only the members' values are
// needed, once: nnz(mask) * D * 4 bytes (398.3 MB of the 779 MB exchange
// under workload D's 70-node erdos_renyi(p = 0.5) mask at D = 39,760; with
// the mask and the (R, D) output, 409.4 MB: 122.21 us at 3.35 TB/s).
// "select" is bound by its integer min/max instead (below): at D's mask and
// trim 12, 63,072 a key word over the 70 receivers
// (topology.select_minmax_ops), 149.9 us in float32 at 64 a clock on each
// of 132 SMs at 1,980 MHz, and 75.0 us in bfloat16's pairs, where one
// packed min/max orders two coordinates.
//
// Every route starts the same way: a block owns one receiver (the grid's y
// and z dimensions, rows.cuh's grid_yz, so any R) and a tile of
// coordinates, and sums the receiver's mask row in a fixed order (n_r).
// "sum" and "select" compact the members into an ascending list of senders
// in shared memory, up to 2,048 at a time (a ballot and a prefix count per
// warp, rows.cuh), and "rank" skips the non-members.  Only the members' rows
// are read, along D and coalesced, so any S runs and no slab is staged.  masked_neighbor_reduce_f32 picks the route from trim and
// reports it back, and the wrapper counts it (topology.ROUTE_LAUNCHES):
//
// * "sum", trim = 0: the fixed-order sum of the members' rows, in the body
//   K3 runs (rows.cuh's sum_kept_rows: 8 warps over 128 coordinates, 4 a
//   lane, float4 loads where the base and strides allow; 256 coordinates, 8
//   a lane in one 16-byte load, for a bfloat16 exchange whose base is
//   16-byte aligned and whose strides are multiples of 8; members split
//   across the warps, warp w taking members w, w + 8, ...; up to 8 rows'
//   loads in flight a warp; the 8 partial sums added in warp order),
//   divided by max(n_r, 1).
// * "select", 1 <= trim <= 16 (a template over trim): one coordinate a
//   thread, 128 a block, coalesced scalar loads, 4 rows in flight, one pass.
//   The first 2 * trim members' values are sorted at once in registers (a
//   bitonic network), giving two sorted register arrays: the trim smallest
//   (bot) and the trim largest (top).  Every later value k is inserted into
//   both (a'[i] = max(a[i], min(a[i-1], k)) for the descending top, 2 *
//   trim integer min/max a value per array), and exactly one value leaves
//   the pair of arrays for the kept set: the median of (largest of bot, k,
//   smallest of top), which is added to the sum.  So the sum holds exactly
//   the values of ranks [trim, m - trim) (m members), each added once, in
//   member order: no value is read twice and no dropped value is ever
//   added, so rows many orders of magnitude larger than the rest leave no
//   trace once dropped (the form that sums everything and subtracts the
//   tails would cancel).  Values are compared as integer keys ordered like
//   the floats, with NaN above +inf.  The compiler folds every
//   compare-exchange of the first sort that meets a pad slot: at trim 12,
//   336 min/max for the 24 members on 32 wires, then 48 a later member
//   (the SASS: 528 VIMNMX, the sort's and 4 unrolled members').  A bfloat16
//   exchange whose base is 4-byte aligned and whose strides are even takes
//   two coordinates a thread instead (masked_select_pairs_kernel, below):
//   16-bit keys, two to a word, ordered by one packed min/max, so half the
//   min/max, the loads and the blocks for the same coordinates.
// * "rank", trim > 16: each member's value is ranked against the others,
//   rank = #{j : key_j < key_i or (key_j == key_i and j < i)} (a permutation
//   of 0..m-1, so the values of ranks [trim, m - trim) are the sort's), and
//   those ranks are summed in member order: O(m^2) loads per coordinate,
//   from L1/L2.  Correct for every trim; not fast.
//
// The kept values are the same multiset as the sort's of the plain version
// (masked_neighbor_reduce_plain) whatever the ties; they are summed in
// another order, so the result agrees to rtol 1e-5, not bitwise.  Every
// route sums in an order fixed by the inputs: the same bits on every run.
//
// Registers and spills of each specialisation (`nvcc -Xptxas -v`, printed by
// chip_smoke.py's build phase): "select" 32 registers at trim 1-4, 40 at
// 5-6, 48 at 7-10, 56 at 11-14, 64 at 15-16, and the pairs within 8 of
// those (56 at trim 12); "sum" 68 with scalar loads, 64 with float4 loads, 80 on
// bfloat16's 16-byte route (8 bytes spilled, the only spill); "rank" 30.
//
// NaN inputs: a member's NaN is not struck out; it is ordered above +inf, so
// it is dropped when it falls among the trim largest, and a kept NaN (with
// trim = 0 every member is kept) makes its coordinate's result NaN.  The
// plain version orders the non-members after every member, a NaN member
// included, so it gives the same NaN.  Non-members are never read, so a
// NaN or inf there changes nothing, here and in the plain version: the
// reference's masked engine promises that mask-0 senders do not influence
// the result (repro/topology/masked.py).
//
// bfloat16 exchange (the bf16 wire, masked_neighbor_reduce_bf16): every
// route loads x in bfloat16, converted exactly to the float32 it works on;
// the order of every sum and comparison is the float32 kernel's, so the
// bf16 route gives the bits of the float32 kernel run on x.float(), at half
// the bytes of the members' rows.  "rank" also keeps its mapping of
// coordinates to threads, and so does "select" on an exchange whose base or
// strides rule out its pairs (whose keys order as the float32 keys of the
// upcast values, so they keep and drop the same values and sum each
// coordinate's in the same order); "sum" reads an aligned exchange 8 coordinates
// a lane (rows.cuh's Cols8: half the blocks of the 4-a-lane layout, each
// moving a float32 block's bytes a row, and the raw words held until they
// are added, so a warp's row loads are all in flight at once), which moves
// no coordinate's sum.  The mask and the output stay float32.
//
// Strides: x[r, s, d] lies at r * rs + s * ss + d, so a column slice of a
// wider exchange, or one shared message row per sender broadcast to every
// receiver (rs = 0), is read in place.  The mask and the output are
// contiguous (R, S) and (R, D).
#include <climits>
#include <type_traits>

#include "common.cuh"
#include "keys.cuh"
#include "rows.cuh"

namespace {

constexpr int kCap = 2048;              // members compacted at a time
constexpr int kMaxSelectTrim = 16;

// Routes, as masked_neighbor_reduce_f32 reports them (topology.ROUTES).
constexpr int kRouteSum = 0;
constexpr int kRouteSelect = 1;
constexpr int kRouteRank = 2;

// Layouts of "select", as masked_neighbor_reduce_f32 reports them
// (topology.SELECT_LAYOUTS); the other routes report kLayoutOne.
constexpr int kLayoutOne = 0;
constexpr int kLayoutPairs = 1;

// Integer keys ordered as the floats are, NaN above +inf (and -0 below +0,
// which no sum can tell apart).
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return v != v ? INT_MAX : (b >= 0 ? b : b ^ 0x7fffffff);
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// n_r: the receiver's mask row summed in a fixed order, to every thread.
template <int kWarps>
__device__ float mask_total(const float* __restrict__ m, int S, float* s_red) {
  float part = 0.f;
  for (int s = threadIdx.x; s < S; s += 32 * kWarps) part += m[s];
  return rows::block_total<kWarps>(part, s_red);
}

// ---- "sum": trim = 0 -------------------------------------------------------

template <class Cols, typename T>
__global__ void __launch_bounds__(rows::kSumThreads)
masked_sum_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                  float* __restrict__ out, int R, int S, int64_t D, int64_t rs,
                  int64_t ss) {
  __shared__ float s_red[rows::kSumWarps];
  const int64_t r = rows::grid_row();
  if (r >= R) return;   // the whole block
  mask += r * S;
  const float n = mask_total<rows::kSumWarps>(mask, S, s_red);
  float4 acc[Cols::kN / 4];
  if (!rows::sum_kept_rows<Cols, false>(x + r * rs, mask, S, rows::Positive(), ss, D, acc))
    return;
  const float den = fmaxf(n, 1.f);
#pragma unroll
  for (int h = 0; h < Cols::kN / 4; ++h)
    acc[h] = make_float4(acc[h].x / den, acc[h].y / den, acc[h].z / den, acc[h].w / den);
  Cols::store(out + r * D, static_cast<int64_t>(blockIdx.x) * Cols::kCols,
              threadIdx.x % 32, D, acc);
}

template <class Cols, typename E>
int launch_sum(const E* x, const float* mask, float* out, int R, int S, int64_t D,
               int64_t rs, int64_t ss, cudaStream_t s) {
  const dim3 grid = rows::grid_yz(static_cast<unsigned>((D + Cols::kCols - 1) / Cols::kCols), R);
  masked_sum_kernel<Cols, E><<<grid, rows::kSumThreads, rows::kept_rows_smem(S, false), s>>>(
      x, mask, out, R, S, D, rs, ss);
  return static_cast<int>(cudaGetLastError());
}

// ---- "select": 1 <= trim <= 16 ------------------------------------------------

constexpr int kSelWarps = 4;
constexpr int kSelThreads = 32 * kSelWarps;   // one coordinate a thread
constexpr int kSelUnroll = 4;

__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// Ascending bitonic sort of a register array (N a power of two); every index
// is known at compile time, so the array stays in registers, and a
// comparison with a constant pad folds away.
template <int N>
__device__ __forceinline__ void bitonic_sort(int (&a)[N]) {
#pragma unroll
  for (int k = 2; k <= N; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const int lo = min(a[i], a[l]), hi = max(a[i], a[l]);
          const bool up = (i & k) == 0;
          a[i] = up ? lo : hi;
          a[l] = up ? hi : lo;
        }
      }
    }
  }
}

// Inserts k into top[] (descending: the T largest so far) and bot[]
// (ascending: the T smallest), each slot from the old values only.
template <int T>
__device__ __forceinline__ void insert(int (&top)[T], int (&bot)[T], int k) {
#pragma unroll
  for (int i = T - 1; i > 0; --i) {
    top[i] = max(top[i], min(top[i - 1], k));
    bot[i] = min(bot[i], max(bot[i - 1], k));
  }
  top[0] = max(top[0], k);
  bot[0] = min(bot[0], k);
}

template <int T, typename E>
__global__ void __launch_bounds__(kSelThreads)
masked_select_kernel(const E* __restrict__ x, const float* __restrict__ mask,
                     float* __restrict__ out, int R, int S, int64_t D, int64_t rs,
                     int64_t ss) {
  constexpr int kN = pow2_at_least(2 * T);
  __shared__ int s_row[kCap];
  __shared__ int warp_n[kSelWarps];
  __shared__ float s_red[kSelWarps];
  const int64_t r = rows::grid_row();
  if (r >= R) return;   // the whole block
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kSelThreads + threadIdx.x;
  const bool live = col < D;   // threads past D still take part in the barriers
  mask += r * S;
  x += r * rs + (live ? col : 0);
  const float n = mask_total<kSelWarps>(mask, S, s_red);
  int top[T], bot[T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    top[i] = INT_MIN;
    bot[i] = INT_MAX;
  }
  float acc = 0.f;   // the kept values, each added once
  int seen = 0;      // members streamed so far (the same in every thread)
  for (int c0 = 0; c0 < S; c0 += kCap) {
    const int cnt = rows::compact<kSelWarps>(mask, c0, min(S, c0 + kCap),
                                             rows::Positive(), s_row, nullptr, warp_n);
    int j = 0;
    if (seen == 0 && cnt >= 2 * T) {
      // The first 2T members, sorted at once: the T smallest and T largest.
      int a[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i)
        a[i] = i < 2 * T ? order_key(live ? ldg_f32(x + s_row[i] * ss) : 0.f) : INT_MAX;
      bitonic_sort<kN>(a);
#pragma unroll
      for (int i = 0; i < T; ++i) {
        bot[i] = a[i];
        top[i] = a[2 * T - 1 - i];
      }
      j = seen = 2 * T;
    }
    for (; j < cnt; j += kSelUnroll) {
      float v[kSelUnroll];
#pragma unroll
      for (int u = 0; u < kSelUnroll; ++u)
        v[u] = (live && j + u < cnt) ? ldg_f32(x + s_row[j + u] * ss) : 0.f;
#pragma unroll
      for (int u = 0; u < kSelUnroll; ++u)
        if (j + u < cnt) {
          const int k = order_key(v[u]);
          // Past 2T members the arrays and the kept values partition the
          // members; k pushes out exactly one value into the kept ones: the
          // median of (largest of bot, k, smallest of top).
          if (seen >= 2 * T) acc += key_value(max(bot[T - 1], min(k, top[T - 1])));
          insert<T>(top, bot, k);
          ++seen;
        }
    }
  }
  if (live) out[r * D + col] = acc / fmaxf(n - 2.f * T, 1.f);
}

// ---- "select", two bfloat16 coordinates a thread ------------------------------
//
// A bfloat16 value's key fits 16 bits, so a thread orders two adjacent
// coordinates at once: their keys are the two signed 16-bit halves of one
// word (the low half the even coordinate), read as one 4-byte load a member
// row, and Hopper's packed min.s16x2/max.s16x2 (VIMNMX.S16x2, one
// instruction) orders both.  The 16-bit key of the raw bits b is b for
// b >= 0 and b ^ 0x7fff for b < 0, and 0x7fff for every NaN: the order of
// order_key on the upcast value (that key is this one times 2^16, plus
// 0xffff for a negative value), ties and -0 < +0 included, NaN above +inf.
// The network, the inserts and the medians are masked_select_kernel's, on
// words, so the same values are kept, each unpacked to its float32 value
// and added to its own coordinate's sum in member order: the float32
// kernel's bits.  pairs_fit decides before the launch; the last pair of an
// odd D reads its low half alone (a 2-byte load).  The word network and
// inserts below are kept apart from the float32 kernel's: written as one
// template over both key widths, they moved that kernel's SASS (and time).
// The keys and the packed min/max are keys.cuh's, which K4's pairs layout
// shares.

// Each half's value, exactly as float32, added to its coordinate's sum.
__device__ __forceinline__ void add_pair(float (&acc)[2], unsigned k) {
  const unsigned v = pair_values(k);
  acc[0] += __uint_as_float(v << 16);
  acc[1] += __uint_as_float(v & 0xffff0000u);
}

// The raw word of the pair at p (4-byte aligned); with !full only its low
// half, so the last pair of an odd D reads nothing past D.
__device__ __forceinline__ unsigned load_pair(const __nv_bfloat16* p, bool full) {
  return full ? __ldg(reinterpret_cast<const unsigned*>(p))
              : static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// Whether the pairs may read x: a 4-byte aligned base and even strides put
// every pair's word on a 4-byte boundary.
bool pairs_fit(const __nv_bfloat16* x, int64_t ss, int64_t rs) {
  return reinterpret_cast<uintptr_t>(x) % 4 == 0 && ss % 2 == 0 && rs % 2 == 0;
}

// bitonic_sort on words whose slots from `live` on hold kPairTop.  The
// compiler cannot fold an asm min/max with a constant pad, so the pads are
// tracked at compile time instead: a compare-exchange with a pad is a move,
// one of two pads nothing; the same keys end in the same slots.
template <int N>
__device__ __forceinline__ void bitonic_sort_pairs(unsigned (&a)[N], int live) {
  bool pad[N];
#pragma unroll
  for (int i = 0; i < N; ++i) pad[i] = i >= live;
#pragma unroll
  for (int k = 2; k <= N; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int l = i ^ j;
        if (l > i && !(pad[i] && pad[l])) {
          const bool up = (i & k) == 0;
          if (pad[i] || pad[l]) {   // the key goes to the low slot, the pad up
            const unsigned v = pad[i] ? a[l] : a[i];
            a[i] = up ? v : kPairTop;
            a[l] = up ? kPairTop : v;
            pad[i] = !up;
            pad[l] = up;
          } else {
            const unsigned lo = pair_min(a[i], a[l]), hi = pair_max(a[i], a[l]);
            a[i] = up ? lo : hi;
            a[l] = up ? hi : lo;
          }
        }
      }
    }
  }
}

// insert on words.
template <int T>
__device__ __forceinline__ void insert_pairs(unsigned (&top)[T], unsigned (&bot)[T],
                                             unsigned k) {
#pragma unroll
  for (int i = T - 1; i > 0; --i) {
    top[i] = pair_max(top[i], pair_min(top[i - 1], k));
    bot[i] = pair_min(bot[i], pair_max(bot[i - 1], k));
  }
  top[0] = pair_max(top[0], k);
  bot[0] = pair_min(bot[0], k);
}

template <int T>
__global__ void __launch_bounds__(kSelThreads)
masked_select_pairs_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ mask, float* __restrict__ out,
                           int R, int S, int64_t D, int64_t rs, int64_t ss) {
  constexpr int kN = pow2_at_least(2 * T);
  __shared__ int s_row[kCap];
  __shared__ int warp_n[kSelWarps];
  __shared__ float s_red[kSelWarps];
  const int64_t r = rows::grid_row();
  if (r >= R) return;   // the whole block
  const int64_t col = 2 * (static_cast<int64_t>(blockIdx.x) * kSelThreads + threadIdx.x);
  const bool live = col < D;        // threads past D still take part in the barriers
  const bool full = col + 1 < D;    // both coordinates of the pair live
  mask += r * S;
  x += r * rs + (live ? col : 0);
  const float n = mask_total<kSelWarps>(mask, S, s_red);
  unsigned top[T], bot[T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    top[i] = kPairBottom;
    bot[i] = kPairTop;
  }
  float acc[2] = {0.f, 0.f};   // the kept values, each added once
  int seen = 0;                // members streamed so far (the same in every thread)
  for (int c0 = 0; c0 < S; c0 += kCap) {
    const int cnt = rows::compact<kSelWarps>(mask, c0, min(S, c0 + kCap),
                                             rows::Positive(), s_row, nullptr, warp_n);
    int j = 0;
    if (seen == 0 && cnt >= 2 * T) {
      unsigned a[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i)
        a[i] = i < 2 * T ? pair_keys(live ? load_pair(x + s_row[i] * ss, full) : 0u)
                         : kPairTop;
      bitonic_sort_pairs<kN>(a, 2 * T);
#pragma unroll
      for (int i = 0; i < T; ++i) {
        bot[i] = a[i];
        top[i] = a[2 * T - 1 - i];
      }
      j = seen = 2 * T;
    }
    for (; j < cnt; j += kSelUnroll) {
      unsigned v[kSelUnroll];
#pragma unroll
      for (int u = 0; u < kSelUnroll; ++u)
        v[u] = (live && j + u < cnt) ? load_pair(x + s_row[j + u] * ss, full) : 0u;
#pragma unroll
      for (int u = 0; u < kSelUnroll; ++u)
        if (j + u < cnt) {
          const unsigned k = pair_keys(v[u]);
          if (seen >= 2 * T) add_pair(acc, pair_max(bot[T - 1], pair_min(k, top[T - 1])));
          insert_pairs<T>(top, bot, k);
          ++seen;
        }
    }
  }
  const float den = fmaxf(n - 2.f * T, 1.f);
  if (live) out[r * D + col] = acc[0] / den;
  if (full) out[r * D + col + 1] = acc[1] / den;
}

// ---- "rank": any trim ---------------------------------------------------------

constexpr int kRankThreads = 128;

template <typename E>
__global__ void __launch_bounds__(kRankThreads)
masked_rank_kernel(const E* __restrict__ x, const float* __restrict__ mask,
                   float* __restrict__ out, int R, int S, int64_t D, int64_t rs,
                   int64_t ss, int trim) {
  __shared__ float s_red[kRankThreads / 32];
  const int64_t r = rows::grid_row();
  if (r >= R) return;   // the whole block
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kRankThreads + threadIdx.x;
  mask += r * S;
  x += r * rs + col;
  const float n = mask_total<kRankThreads / 32>(mask, S, s_red);
  float part = 0.f;
  for (int s = threadIdx.x; s < S; s += kRankThreads) part += mask[s] > 0.f ? 1.f : 0.f;
  const int members = static_cast<int>(rows::block_total<kRankThreads / 32>(part, s_red));
  if (col >= D) return;   // past the barriers
  float acc = 0.f;
  for (int i = 0; i < S; ++i) {
    if (!(mask[i] > 0.f)) continue;
    const float vi = ldg_f32(x + i * ss);
    const int ki = order_key(vi);
    int rank = 0;
    for (int j = 0; j < S; ++j) {
      if (!(mask[j] > 0.f)) continue;
      const int kj = order_key(ldg_f32(x + j * ss));
      rank += (kj < ki) || (kj == ki && j < i);
    }
    if (rank >= trim && rank < members - trim) acc += vi;
  }
  out[r * D + col] = acc / fmaxf(n - 2.f * trim, 1.f);
}

template <int T, typename E>
int launch_select(const E* x, const float* mask, float* out, int R, int S,
                  int64_t D, int64_t rs, int64_t ss, cudaStream_t s) {
  const dim3 grid = rows::grid_yz(static_cast<unsigned>((D + kSelThreads - 1) / kSelThreads), R);
  masked_select_kernel<T, E><<<grid, kSelThreads, 0, s>>>(x, mask, out, R, S, D, rs, ss);
  return static_cast<int>(cudaGetLastError());
}

// "select" at trim T: two coordinates a thread for a bfloat16 x that
// pairs_fit admits (its 4-byte loads are never tried and then dropped),
// else one; *layout says which ran.
template <int T, typename E>
int select_layout(const E* x, const float* mask, float* out, int R, int S, int64_t D,
                  int64_t rs, int64_t ss, int* layout, cudaStream_t s) {
  if constexpr (std::is_same<E, __nv_bfloat16>::value) {
    if (pairs_fit(x, ss, rs)) {
      *layout = kLayoutPairs;
      constexpr int64_t kCols = 2 * kSelThreads;
      const dim3 grid = rows::grid_yz(static_cast<unsigned>((D + kCols - 1) / kCols), R);
      masked_select_pairs_kernel<T><<<grid, kSelThreads, 0, s>>>(x, mask, out, R, S, D,
                                                                  rs, ss);
      return static_cast<int>(cudaGetLastError());
    }
  }
  *layout = kLayoutOne;
  return launch_select<T, E>(x, mask, out, R, S, D, rs, ss, s);
}

template <typename E>
int masked_neighbor_reduce(const E* x, const float* mask, float* out, int R, int S,
                           long long D, long long rs, long long ss, int trim,
                           int* route, int* layout, void* stream) {
  *route = trim == 0 ? kRouteSum : trim <= kMaxSelectTrim ? kRouteSelect : kRouteRank;
  *layout = kLayoutOne;
  if (R == 0 || D == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  if (*route == kRouteSum) {
    if constexpr (std::is_same<E, __nv_bfloat16>::value) {
      if (rows::Cols8::fits(x, ss, rs))
        return launch_sum<rows::Cols8>(x, mask, out, R, S, D, rs, ss, s);
    }
    return aligned4(x) && ss % 4 == 0 && rs % 4 == 0
               ? launch_sum<rows::Cols4<true>>(x, mask, out, R, S, D, rs, ss, s)
               : launch_sum<rows::Cols4<false>>(x, mask, out, R, S, D, rs, ss, s);
  }
  if (*route == kRouteSelect) {
    switch (trim) {
#define REPRO_SELECT(T) \
  case T:               \
    return select_layout<T, E>(x, mask, out, R, S, D, rs, ss, layout, s);
      REPRO_SELECT(1) REPRO_SELECT(2) REPRO_SELECT(3) REPRO_SELECT(4)
      REPRO_SELECT(5) REPRO_SELECT(6) REPRO_SELECT(7) REPRO_SELECT(8)
      REPRO_SELECT(9) REPRO_SELECT(10) REPRO_SELECT(11) REPRO_SELECT(12)
      REPRO_SELECT(13) REPRO_SELECT(14) REPRO_SELECT(15) REPRO_SELECT(16)
#undef REPRO_SELECT
    }
    *route = kRouteRank;   // a trim with no case above: the rank count serves any
  }
  const dim3 grid = rows::grid_yz(static_cast<unsigned>((D + kRankThreads - 1) / kRankThreads), R);
  masked_rank_kernel<E><<<grid, kRankThreads, 0, s>>>(x, mask, out, R, S, D, rs, ss, trim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (R, S, D) float32 (*_f32) or bfloat16 (*_bf16) at x[r * rs + s * ss + d];
// mask: (R, S), out: (R, D) float32 contiguous; 0 <= trim.  Picks the route
// from trim and writes its code to *route: 0 "sum" (trim 0), 1 "select"
// (1 <= trim <= 16), 2 "rank" (beyond); and "select"'s layout to *layout: 0
// one coordinate a thread, 1 two (bfloat16 with a 4-byte aligned base and
// even strides).
REPRO_EXPORT int masked_neighbor_reduce_f32(const float* x, const float* mask,
                                            float* out, int R, int S,
                                            long long D, long long rs,
                                            long long ss, int trim, int* route,
                                            int* layout, void* stream) {
  return masked_neighbor_reduce<float>(x, mask, out, R, S, D, rs, ss, trim, route,
                                       layout, stream);
}

REPRO_EXPORT int masked_neighbor_reduce_bf16(const __nv_bfloat16* x,
                                             const float* mask, float* out, int R,
                                             int S, long long D, long long rs,
                                             long long ss, int trim, int* route,
                                             int* layout, void* stream) {
  return masked_neighbor_reduce<__nv_bfloat16>(x, mask, out, R, S, D, rs, ss, trim,
                                               route, layout, stream);
}
