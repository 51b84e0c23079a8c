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

__global__ void saga_correct_kernel(const float* __restrict__ g,
                                    float* __restrict__ table,
                                    float* __restrict__ avg,
                                    const int64_t* __restrict__ idx,
                                    const int64_t* __restrict__ rows,
                                    float* __restrict__ msg, int J, int64_t C,
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
      if (i < D) msg[base + i] = nanf("");
    }
    return;
  }
  float* trow = table + (client * J + row) * D;
  const float j = static_cast<float>(J);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = start + static_cast<int64_t>(k) * kThreads;
    if (i < D) {
      const float gi = g[base + i];
      const float delta = gi - trow[i];
      const float a = avg[state + i];
      msg[base + i] = delta + a;
      avg[state + i] = a + delta / j;
      trow[i] = gi;
    }
  }
}

}  // namespace

// g, msg: (W, D); table: (C, J, D); avg: (C, D); idx: (W,) int64; rows:
// (W,) int64 distinct client rows, or null for rows 0..W-1 (then C = W); all
// float32, contiguous, on one device.  Returns cudaGetLastError() after the
// launch.
REPRO_EXPORT int saga_correct_f32(const float* g, float* table, float* avg,
                                  const int64_t* idx, const int64_t* rows,
                                  float* msg, int W, int J, long long C,
                                  long long D, void* stream) {
  if (W == 0 || D == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned>((D + kChunk - 1) / kChunk),
                  static_cast<unsigned>(W));
  saga_correct_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, table, avg, idx, rows, msg, J, static_cast<int64_t>(C),
      static_cast<int64_t>(D));
  return static_cast<int>(cudaGetLastError());
}
