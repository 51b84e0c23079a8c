// Shared pieces of the port's CUDA sources: the export macro, the error
// text lookup every library exposes to its ctypes wrapper, and the loads of
// the two message dtypes (float32 and the bf16 wire's bfloat16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

REPRO_EXPORT const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A message element as float32: a bfloat16 is the top half of a float32's
// bits, so its conversion is exact (a shift) and every kernel that loads
// bf16 through these computes on the same floats as on the upcast input.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __uint_as_float(static_cast<unsigned>(__bfloat16_as_ushort(x)) << 16);
}

// One element through the read-only cache, as float32.
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const __nv_bfloat16* p) {
  return __uint_as_float(
      static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
}

// The raw words of 4 (8) consecutive bfloat16 elements in one 8-byte
// (16-byte) load, p aligned to their size; element i is the low half of
// word i / 2 when i is even, the high half when odd.  A kernel that keeps
// several loads in flight holds the words and converts them where it uses
// the values: a conversion right after a load waits for that load before
// the next one starts.
__device__ __forceinline__ uint2 ldg4_raw(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ uint4 ldg8_raw(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The float32 values of 4 bfloat16 elements held as two raw words (exact).
__device__ __forceinline__ float4 bf16x4_f32(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Four consecutive elements (16 bytes of float32, 8 of bfloat16) in one
// load; p must be aligned to their size.
__device__ __forceinline__ float4 ldg4_f32(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4_f32(const __nv_bfloat16* p) {
  return bf16x4_f32(ldg4_raw(p));
}

// float32 -> the element type, rounding to nearest even for bfloat16.
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Bytes of one element.
template <typename T>
constexpr int elem_bytes() { return static_cast<int>(sizeof(T)); }

// Whether p may be read with ldg4_f32 (4 elements' alignment).
template <typename T>
__host__ __forceinline__ bool aligned4(const T* p) {
  return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}
