// 16-bit order keys of bfloat16 values, two to a 32-bit word, ordered by
// Hopper's packed signed min/max (min.s16x2/max.s16x2: one VIMNMX.S16x2
// for both halves).  K7 "select"'s pairs layout (topology.cu) and K4's
// pairs layout (robust_stats.cu, which keys NaN its own way) order two
// adjacent coordinates at once on them.  The key of the raw bits b is b for
// b >= 0, b ^ 0x7fff for b < 0 and 0x7fff for every NaN: the order of the
// upcast float32 values, ties and -0 < +0 included, NaN above +inf.  The
// low half of a word is the even coordinate.
#pragma once

#include "common.cuh"

constexpr unsigned kPairBottom = 0x80008000u, kPairTop = 0x7fff7fffu;   // pads

__device__ __forceinline__ unsigned pair_min(unsigned a, unsigned b) {
  unsigned d;
  asm("min.s16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ unsigned pair_max(unsigned a, unsigned b) {
  unsigned d;
  asm("max.s16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The keys of a word of two raw bfloat16 values (K7's).
__device__ __forceinline__ unsigned pair_keys(unsigned w) {
  // A NaN half (|b| > 0x7f80: bit 15 of |b| + 0x7f) becomes 0x7fff first.
  const unsigned nan = (((w & 0x7fff7fffu) + 0x007f007fu) >> 15) & 0x00010001u;
  w = (w & ~(nan * 0xffffu)) | (nan * 0x7fffu);
  return w ^ (((w >> 15) & 0x00010001u) * 0x7fffu);
}

// The raw bfloat16 bits of both halves of a key word (a NaN half's key
// gives back a NaN).
__device__ __forceinline__ unsigned pair_values(unsigned k) {
  return k ^ (((k >> 15) & 0x00010001u) * 0x7fffu);
}
