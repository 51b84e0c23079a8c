// K1: fused SAGA correction and in-place table update on the packed
// (W, J, D) SAGA table, all workers in one launch.
//
// Replaces: repro/kernels/saga_correct.py, saga_correct_call (_saga_kernel),
// which handles one worker's (J, p) table with a scalar-prefetched row index
// and aliases the table input->output so only the touched row moves.
//
// Per worker w with drawn row r = idx[w] and state row c = rows[w] (c = w
// when rows is null):
//   delta  = g[w] - T[c, r]
//   msg[w] = delta + avg[c]
//   avg[c] = avg[c] + delta / J          (in place)
//   T[c, r] = g[w]                       (in place, after the old row is read)
// The client-row route (rows given) works on a table resident per client,
// (C, J, D) with avg (C, D), under partial participation: the round's cohort
// reads and writes its own rows in place, and no (W, J, D) copy of the
// cohort's rows is made.  The rows must be distinct (the participation
// plan's cohorts are); two workers on one client would race.
// The arithmetic and its order are those of core/saga.py's
// saga_correct_scatter, so the result is bitwise the plain PyTorch version's
// (IEEE division: no fast-math flags).
//
// The bf16 route (saga_correct_bf16: g, table, avg and msg all bfloat16, the
// bf16 wire's SAGA state) rounds to bfloat16 after every operation, as the
// reference's jnp engine does (XLA rounds each bf16 op) and as PyTorch's bf16
// ops do:  delta = bf16(g - T), msg = bf16(delta + avg),
// avg = bf16(avg + bf16(delta / J)), each operation on the exact float32
// values of its bf16 operands.  So it is bitwise the plain version on bf16
// tensors too.  (The reference's Pallas kernel rounds once at the end; its
// step does not run it.)  It moves half the bytes: 6 * W * D * 2.
//
// Bound on the H100: device-memory bytes.  Each call reads g, the old row and
// avg and writes msg, avg and the new row: 6 * W * D * 4 bytes against 3
// flops per element.  Design: a 2-D grid over (D-chunk, worker); each block
// loads its worker's row index itself (the TPU's scalar prefetch), each
// thread handles kItems coordinates kThreads apart so a warp's loads and
// stores are coalesced, and only row r of the table is touched -- the rest
// of the 9.5 GB table is never read.  An index outside [0, J), or a client row
// outside [0, C), writes NaN into that worker's message and leaves the state
// untouched.  The client row is one more 8-byte load per block.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kChunk = kThreads * kItems;

template <typename T>
__global__ void saga_correct_kernel(const T* __restrict__ g, T* __restrict__ table,
                                    T* __restrict__ avg,
                                    const int64_t* __restrict__ idx,
                                    const int64_t* __restrict__ rows,
                                    T* __restrict__ msg, int J, int64_t C,
                                    int64_t D) {
  const int w = blockIdx.y;
  const int64_t row = idx[w];
  const int64_t client = rows != nullptr ? rows[w] : w;
  const int64_t base = static_cast<int64_t>(w) * D;
  const int64_t state = client * D;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kChunk + threadIdx.x;
  if (row < 0 || row >= J || client < 0 || client >= C) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = start + static_cast<int64_t>(k) * kThreads;
      if (i < D) msg[base + i] = from_f32<T>(nanf(""));
    }
    return;
  }
  T* trow = table + (client * J + row) * D;
  const float j = static_cast<float>(J);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = start + static_cast<int64_t>(k) * kThreads;
    if (i < D) {
      const T gi = g[base + i];
      // Each operation rounds to T (a no-op for float32).
      const float delta = to_f32(from_f32<T>(to_f32(gi) - to_f32(trow[i])));
      const float a = to_f32(avg[state + i]);
      msg[base + i] = from_f32<T>(delta + a);
      avg[state + i] = from_f32<T>(a + to_f32(from_f32<T>(delta / j)));
      trow[i] = gi;
    }
  }
}

template <typename T>
int launch(const T* g, T* table, T* avg, const int64_t* idx, const int64_t* rows,
           T* msg, int W, int J, long long C, long long D, void* stream) {
  if (W == 0 || D == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned>((D + kChunk - 1) / kChunk),
                  static_cast<unsigned>(W));
  saga_correct_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, table, avg, idx, rows, msg, J, static_cast<int64_t>(C),
      static_cast<int64_t>(D));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g, msg: (W, D); table: (C, J, D); avg: (C, D); idx: (W,) int64; rows:
// (W,) int64 distinct client rows, or null for rows 0..W-1 (then C = W); all
// float32 (saga_correct_f32) or all bfloat16 (saga_correct_bf16), contiguous,
// on one device.  Returns cudaGetLastError() after the launch.
REPRO_EXPORT int saga_correct_f32(const float* g, float* table, float* avg,
                                  const int64_t* idx, const int64_t* rows,
                                  float* msg, int W, int J, long long C,
                                  long long D, void* stream) {
  return launch<float>(g, table, avg, idx, rows, msg, W, J, C, D, stream);
}

REPRO_EXPORT int saga_correct_bf16(const __nv_bfloat16* g, __nv_bfloat16* table,
                                   __nv_bfloat16* avg, const int64_t* idx,
                                   const int64_t* rows, __nv_bfloat16* msg, int W,
                                   int J, long long C, long long D, void* stream) {
  return launch<__nv_bfloat16>(g, table, avg, idx, rows, msg, W, J, C, D, stream);
}
