// K8 flash attention: per batch b and query head h,
//   out[b, :, h] = softmax(mask(q[b, :, h] . k[b, :, g]^T * hd^-0.5)) . v[b, :, g]
// with g = h / (H / KV) the key/value head of h's group (GQA and MQA read
// the shared head in place; nothing is repeated).  The mask keeps key
// position kpos < S, and in causal mode also kpos <= qpos; a masked score is
// -1e30 (not -inf).  Arithmetic is float32 throughout: the online softmax of
// the reference (running max m, sum l and output o per query row; for each
// key tile m' = max(m, rowmax s), p = exp(s - m'), l = l * exp(m - m') +
// rowsum p, o = o * exp(m - m') + p . v) and a final o / max(l, 1e-30).
// Inputs are float32 or bfloat16 (converted to float32 on load); the output
// is written in float32 or bfloat16.
// Replaces: repro/kernels/flash_attention.py, flash_attention_call
// (_flash_kernel), which runs the same recurrence over a (BH, q block, kv
// block) grid whose kv axis is sequential on the TPU, with the heads
// repeated for GQA beforehand (repro/kernels/ops.py) and ragged S padded.
//
// Here one block of 128 threads owns BQ = 8 * RT query rows of one (b, h)
// (grid: query tiles x H x B, the longest causal rows first) and loops over
// the key tiles itself: Hopper's blocks run in parallel, so the sequential
// kv grid axis of the TPU becomes a loop inside the block.  The query tile
// is staged once, transposed, in shared memory; each key/value tile of BK
// keys is staged in shared memory in turn.  Thread (ty, tx) (8 x 16) keeps
// the running max, sum and output of rows ty * RT .. ty * RT + RT - 1 in
// registers: the scores of columns tx, tx + 16, ... of the tile and the
// output columns tx * HD / 16 .. of the head.  A row's max and sum are
// reduced across its 16 lanes by warp shuffles.  Rows and keys past S and
// head dimensions past hd are zero-filled in shared memory and masked, so
// nothing is padded in device memory; in causal mode the key tiles past the
// tile's last row are skipped.  The head dimension is a compile-time bound
// HD in {16, 32, 64, 128, 256} (hd <= HD).
//
// Strides: q[b, s, h, d] lies at b * qsb + s * qss + h * qsh + d (the same
// for k and v with their own strides), so the (B, S, H * hd) projections are
// read in place; out is contiguous (B, S, H, hd).
//
// Bound on the H100: operations.  Causal attention at the served shape
// (B, S, H, KV, hd) = (4, 2048, 28, 4, 128) needs 2 * B * H * S * (S + 1) *
// hd = 1.2e11 FLOP, 122 us at the 989 TFLOP/s of the bf16 tensor cores,
// while q, k, v and out move 134 MB (40 us at 3.35 TB/s).  This simple form
// does not come near it: it multiplies on the float32 CUDA cores (67 TFLOP/s
// at best, about 1.8 ms for that work), reading two operands from shared
// memory for every one to four FMAs.  Tensor cores (mma.sync or wgmma, with
// p rounded to bf16 for p . v) change the numbers against the float32
// reference and are later work.  PERF.md section 6 has its measured time
// beside this bound, its plain version and the library call.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;      // 8 row groups x 16 lanes
constexpr float kNegInf = -1e30f;  // the reference's mask value

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch's cast
}

// N consecutive floats of shared memory into registers, in 16- or 8-byte
// loads where the layout allows (the callers keep those offsets aligned).
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&r)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(p)[i];
      r[4 * i] = x.x; r[4 * i + 1] = x.y; r[4 * i + 2] = x.z; r[4 * i + 3] = x.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 x = reinterpret_cast<const float2*>(p)[i];
      r[2 * i] = x.x; r[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = p[i];
  }
}

// Shared-memory layout, in floats:
//   qt[HD][QLD]  the query tile, transposed (tile row r in column r)
//   ks[BK][KLD]  the key tile, rows padded by one against bank conflicts
//   vs[BK][HD]   the value tile
//   pt[BK][QLD]  the tile's probabilities, transposed
template <int HD, int RT, int BK>
struct Tile {
  static constexpr int BQ = 8 * RT;    // query rows per block
  static constexpr int QLD = BQ + 4;   // keeps 16-byte alignment
  static constexpr int KLD = HD + 1;
  static constexpr int CS = BK / 16;   // score columns per thread
  static constexpr int CO = HD / 16;   // output columns per thread
  static constexpr size_t kFloats =
      static_cast<size_t>(HD) * QLD + BK * KLD + BK * HD + BK * QLD;
};

template <int HD, int RT, int BK, typename T, typename TO>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, TO* __restrict__ out, int S,
                      int H, int KV, int hd, int64_t qsb, int64_t qss,
                      int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                      int64_t vsb, int64_t vss, int64_t vsh, int causal,
                      float scale) {
  using L = Tile<HD, RT, BK>;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* ks = qt + HD * L::QLD;
  float* vs = ks + BK * L::KLD;
  float* pt = vs + BK * HD;

  const int t = threadIdx.x;
  const int ty = t / 16, tx = t % 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * L::BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + g * ksh;
  const T* vb = v + b * vsb + g * vsh;

  for (int i = t; i < L::BQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int row = q0 + r;
    qt[d * L::QLD + r] =
        (row < S && d < hd) ? to_f32(qb[static_cast<int64_t>(row) * qss + d]) : 0.f;
  }

  float o[RT][L::CO];
  float m[RT], l[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::CO; ++c) o[i][c] = 0.f;
  }

  const int q_last = min(q0 + L::BQ, S) - 1;
  int nk = (S + BK - 1) / BK;
  if (causal) nk = min(nk, q_last / BK + 1);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's ks, vs and pt are no longer read
    for (int i = t; i < BK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int key = k0 + r;
      float kval = 0.f, vval = 0.f;
      if (key < S && d < hd) {
        kval = to_f32(kb[static_cast<int64_t>(key) * kss + d]);
        vval = to_f32(vb[static_cast<int64_t>(key) * vss + d]);
      }
      ks[r * L::KLD + d] = kval;
      vs[r * HD + d] = vval;
    }
    __syncthreads();

    float s[RT][L::CS];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < L::CS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RT];
      load_row<RT>(qt + d * L::QLD + ty * RT, qv);
      float kv[L::CS];
#pragma unroll
      for (int j = 0; j < L::CS; ++j) kv[j] = ks[(tx + 16 * j) * L::KLD + d];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < L::CS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int row = q0 + ty * RT + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < L::CS; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool keep = key < S && (!causal || key <= row);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < L::CS; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < L::CO; ++c) o[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < L::CS; ++j)
#pragma unroll
      for (int i = 0; i < RT; ++i) pt[(tx + 16 * j) * L::QLD + ty * RT + i] = s[i][j];
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RT];
      load_row<RT>(pt + kk * L::QLD + ty * RT, pv);
      float vv[L::CO];
      load_row<L::CO>(vs + kk * HD + tx * L::CO, vv);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int c = 0; c < L::CO; ++c) o[i][c] = fmaf(pv[i], vv[c], o[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + ty * RT + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    TO* orow = out + ((static_cast<int64_t>(b) * S + row) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < L::CO; ++c) {
      const int d = tx * L::CO + c;
      if (d < hd) orow[d] = from_f32<TO>(o[i][c] / denom);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int B, S, H, KV, hd;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal;
  float scale;
  cudaStream_t stream;
};

template <int HD, int RT, int BK, typename T, typename TO>
int launch(const Args& a) {
  using L = Tile<HD, RT, BK>;
  const size_t smem = L::kFloats * sizeof(float);
  auto kernel = flash_attn_fwd_kernel<HD, RT, BK, T, TO>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((a.S + L::BQ - 1) / L::BQ),
                  static_cast<unsigned>(a.H), static_cast<unsigned>(a.B));
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<TO*>(a.out), a.S, a.H, a.KV,
      a.hd, a.qsb, a.qss, a.qsh, a.ksb, a.kss, a.ksh, a.vsb, a.vss, a.vsh,
      a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// Type codes: 0 float32, 1 bfloat16.  Inputs share one type; the output is
// the input's type or float32.
template <int HD, int RT, int BK>
int launch_types(const Args& a, int in_type, int out_type) {
  if (in_type == 0 && out_type == 0) return launch<HD, RT, BK, float, float>(a);
  if (in_type == 1 && out_type == 1)
    return launch<HD, RT, BK, __nv_bfloat16, __nv_bfloat16>(a);
  if (in_type == 1 && out_type == 0)
    return launch<HD, RT, BK, __nv_bfloat16, float>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: (B, S, H, hd), k and v: (B, S, KV, hd) at the given element strides
// (the last dimension contiguous), H a multiple of KV; out: (B, S, H, hd)
// contiguous.  1 <= hd <= 256; B, H <= 65,535.  scale = hd^-0.5.
REPRO_EXPORT int flash_attention_fwd(const void* q, const void* k,
                                     const void* v, void* out, int in_type,
                                     int out_type, int B, int S, int H, int KV,
                                     int hd, long long qsb, long long qss,
                                     long long qsh, long long ksb,
                                     long long kss, long long ksh,
                                     long long vsb, long long vss,
                                     long long vsh, int causal, float scale,
                                     void* stream) {
  if (B == 0 || S == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0 || hd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, B, S, H, KV, hd, qsb, qss, qsh, ksb, kss, ksh,
               vsb, vss, vsh, causal, scale, static_cast<cudaStream_t>(stream)};
  if (hd <= 16) return launch_types<16, 8, 32>(a, in_type, out_type);
  if (hd <= 32) return launch_types<32, 8, 32>(a, in_type, out_type);
  if (hd <= 64) return launch_types<64, 8, 32>(a, in_type, out_type);
  if (hd <= 128) return launch_types<128, 8, 32>(a, in_type, out_type);
  if (hd <= 256) return launch_types<256, 4, 32>(a, in_type, out_type);
  return static_cast<int>(cudaErrorInvalidValue);
}
