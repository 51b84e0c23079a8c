// K8 flash attention: per batch b and query head h,
//   out[b, :, h] = softmax(mask(q[b, :, h] . k[b, :, g]^T * hd^-0.5)) . v[b, :, g]
// with g = h / (H / KV) the key/value head of h's group (GQA and MQA read
// the shared head in place; nothing is repeated).  The mask keeps key
// position kpos < S, in causal mode also kpos <= qpos, and with a sliding
// window w (causal only) also kpos > qpos - w; a masked score is -1e30 (not
// -inf).  Every route runs the online softmax of the reference
// (running max m, sum l and output o per query row; for each key tile
// m' = max(m, rowmax s), p = exp(s - m'), l = l * exp(m - m') + rowsum p,
// o = o * exp(m - m') + p . v) in float32 and ends with o / max(l, 1e-30).
// The output is written in float32 or bfloat16.
// Replaces: repro/kernels/flash_attention.py, flash_attention_call
// (_flash_kernel), which runs the same recurrence over a (BH, q block, kv
// block) grid whose kv axis is sequential on the TPU, with the heads
// repeated for GQA beforehand (repro/kernels/ops.py) and ragged S padded.
// Hopper's blocks run in parallel, so on both routes one block owns a tile
// of query rows of one (b, h) (grid: query tiles x H x B, the longest causal
// rows first) and loops over the key tiles itself; in causal mode the key
// tiles past the block's last row are skipped, and with a window the tiles
// wholly below the band of the block's first row (keys <= q0 - w) too: the
// loop starts at tile max(0, q0 - w + 1) / tile.  A tile that crosses the
// band's lower edge takes the elementwise mask.  Rows of a block whose band
// starts later see some leading tiles fully masked: their running max stays
// -1e30 there, and the first tile with a kept key rescales what those tiles
// summed by exp(-1e30 - m) = 0, so they leave no trace (every row keeps at
// least its own key).
//
// The window replaces the reference's _sliding (repro/models/attention.py),
// a jnp function that slices a (window + q_chunk)-key span per query chunk;
// its Pallas K8 takes no window.  Windowed work is sum_q min(q + 1, w)
// pairs at 4 hd FLOP each.
//
// Bound on the H100: operations.  Causal attention at the served shape
// (B, S, H, KV, hd) = (4, 2048, 28, 4, 128) needs 2 * B * H * S * (S + 1) *
// hd = 1.2e11 FLOP, 122 us at the 989 TFLOP/s of the bf16 tensor cores,
// while q, k, v and out move 134 MB (40 us at 3.35 TB/s).  PERF.md section 6
// has each route's measured time beside this bound, its plain version and
// the library call.
//
// Two routes (flash_attention.variant in the wrapper picks one):
//
// * wgmma (flash_attention_fwd_wgmma): bfloat16 inputs with hd 64 or 128, a
//   16-byte-aligned base and strides that are multiples of 16 bytes.  It
//   multiplies on the tensor cores, the only way to the bound above.  One
//   block of 288 threads owns 128 query rows: two consumer warpgroups of 64
//   rows each and one producer warp.  The producer loads the query tile once
//   and the key and value tiles of 128 keys through a two-stage ring in
//   shared memory with TMA (cp.async.bulk.tensor), 128-byte swizzled, and
//   signals each stage on a "full" mbarrier; the consumers arrive on the
//   stage's "empty" mbarrier when their products have read it (160 KB at hd
//   128).  The tensor maps are encoded on the host over (hd, heads, S, B)
//   with the projections' own strides, so GQA and the (B, S, H * hd) layout
//   are read in place, and TMA zero-fills the rows past S.  Each consumer
//   warpgroup computes s = q . k^T with wgmma m64n128k16 (both operands in
//   shared memory, bf16 in, float32 accumulate: a product of two bf16 values
//   is exact in float32, so s differs from the reference's float32 scores
//   only in the order of summation), masks keys >= S and, on the diagonal,
//   keys past the query with -1e30, and runs the online softmax on the
//   accumulator fragment in registers: the row max and (at the end) the row
//   sum across the quad of threads that holds a row by shuffles, exp as
//   exp2 with log2(e) folded into the scale, l summed from the float32 p.
//   Then o += p . v with wgmma m64n{hd}k16, p rounded to bf16 in registers
//   as the A operand and v read from shared memory as an MN-major B operand
//   (transpose bit set).  p lies in [0, 1], so its rounding (8 significant
//   bits) moves each weight by at most 2^-8 of itself and o by at most
//   2^-8 max|v|; the rounding errors take both signs, so the output moves
//   far less in practice (tests/test_torch_models.py pins it).
// * simt (flash_attention_fwd): every other input -- float32 (tensor cores
//   would take it as TF32, 10 mantissa bits), head dims other than 64 and
//   128 (1 <= hd <= 256), unaligned views.  Arithmetic is float32
//   throughout; bfloat16 inputs are converted on load.  One block of 128
//   threads owns BQ = 8 * RT query rows.  The query tile is staged once,
//   transposed, in shared memory; each key/value tile of BK keys is staged
//   in shared memory in turn.  Thread (ty, tx) (8 x 16) keeps the running
//   max, sum and output of rows ty * RT .. ty * RT + RT - 1 in registers:
//   the scores of columns tx, tx + 16, ... of the tile and the output
//   columns tx * HD / 16 .. of the head.  A row's max and sum are reduced
//   across its 16 lanes by warp shuffles.  Rows and keys past S and head
//   dimensions past hd are zero-filled in shared memory and masked, so
//   nothing is padded in device memory.  The head dimension is a
//   compile-time bound HD in {16, 32, 64, 128, 256} (hd <= HD).  It
//   multiplies on the float32 CUDA cores (67 TFLOP/s at best, about 1.8 ms
//   for the served shape's work), reading two operands from shared memory
//   for every one to four FMAs.
//
// Strides: q[b, s, h, d] lies at b * qsb + s * qss + h * qsh + d (the same
// for k and v with their own strides), so the (B, S, H * hd) projections are
// read in place; out is contiguous (B, S, H, hd).
#include "common.cuh"

#include <cuda.h>
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
                      int window, float scale) {
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
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  for (int kt = kt0; kt < nk; ++kt) {
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
        const bool keep = key < S && (!causal || key <= row) &&
                          (window <= 0 || key > row - window);
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
  int window;   // 0: none; else >= 1, with causal
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
      a.causal, a.window, a.scale);
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
// contiguous.  1 <= hd <= 256; B, H <= 65,535.  window: 0 for none, else
// >= 1 and causal set.  scale = hd^-0.5.
REPRO_EXPORT int flash_attention_fwd(const void* q, const void* k,
                                     const void* v, void* out, int in_type,
                                     int out_type, int B, int S, int H, int KV,
                                     int hd, long long qsb, long long qss,
                                     long long qsh, long long ksb,
                                     long long kss, long long ksh,
                                     long long vsb, long long vss,
                                     long long vsh, int causal, int window,
                                     float scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0 || hd <= 0 || window < 0 || (window > 0 && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, B, S, H, KV, hd, qsb, qss, qsh, ksb, kss, ksh,
               vsb, vss, vsh, causal, window, scale,
               static_cast<cudaStream_t>(stream)};
  if (hd <= 16) return launch_types<16, 8, 32>(a, in_type, out_type);
  if (hd <= 32) return launch_types<32, 8, 32>(a, in_type, out_type);
  if (hd <= 64) return launch_types<64, 8, 32>(a, in_type, out_type);
  if (hd <= 128) return launch_types<128, 8, 32>(a, in_type, out_type);
  if (hd <= 256) return launch_types<256, 4, 32>(a, in_type, out_type);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// The wgmma route (bf16, hd 64 or 128).

namespace {

constexpr int kRows = 128;                    // query rows per block
constexpr int kKeys = 128;                    // keys per tile
constexpr int kConsumers = 2;                 // warpgroups of 64 query rows
constexpr int kWgThreads = 128 * kConsumers + 32;   // + one producer warp
constexpr int kStages = 2;
constexpr long long kWaitCycles = 1ll << 34;  // ~9 s: a lost barrier traps

// Shared memory in bytes from a 1024-byte-aligned base.  A tile of 128 rows
// is stored as hd / 64 column blocks of [128 rows][64 bf16], each row 128
// bytes, in TMA's 128-byte swizzle (the wgmma B128 layout).
template <int HD>
struct WgSmem {
  static constexpr int kBlocks = HD / 64;
  static constexpr int kBlockBytes = 128 * 128;
  static constexpr int kTile = kBlocks * kBlockBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;                      // + stage * kTile
  static constexpr int kV = kK + kStages * kTile;       // + stage * kTile
  static constexpr int kBar = kV + kStages * kTile;     // full[2], empty[2], q
  static constexpr int kAlloc = kBar + 64 + 1024;       // + slack for the alignment
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of the given parity.  A
// wait that outlasts kWaitCycles traps, so a fault ends the launch with an
// error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWaitCycles) __trap();
}

// One TMA box of `map` at coordinates (c0, c1, c2, c3) into shared memory at
// `dst`, completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// After a wait: the accumulator's later readers depend on this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, float32) = [d +] a . b^T, a (64 x 16) and b (128 x 16) bf16 in
// shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N, float32) += a . b, a (64 x 16) bf16 in registers (four pairs a
// thread), b (16 x N) bf16 in shared memory, MN-major (transposed).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo, low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Accumulator fragment of wgmma m64nN (float32): thread t of warp w of the
// warpgroup holds, for each column block j of 8, d[4j], d[4j + 1] at row
// 16w + t / 4, columns 8j + 2 (t % 4) + {0, 1}, and d[4j + 2], d[4j + 3] at
// the row 8 below.  The A fragment of m64nNk16 has the same rows, so the
// scores of keys 16kk .. 16kk + 15 become p . v's A operand with no shuffle:
// {pair(d[8kk], d[8kk + 1]), pair(d[8kk + 2], d[8kk + 3]), pair(d[8kk + 4],
// d[8kk + 5]), pair(d[8kk + 6], d[8kk + 7])}.
//
// kWindowed: the launch has a window (> 0).  A compile-time flag, so the
// kernel without one is the causal/bidirectional kernel it was before the
// window came (a runtime test cost it 21 % at the served qwen2-7b's
// per-layer shape on an H100, at the same 168 registers).
template <int HD, bool kWindowed, typename TO>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attn_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap qmap,
                            __grid_constant__ const CUtensorMap kmap,
                            __grid_constant__ const CUtensorMap vmap,
                            TO* __restrict__ out, int S, int H, int KV,
                            int causal, int window, float scale_log2) {
  using L = WgSmem<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + L::kBar;        // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;  // empty[s] = empty0 + 8 s
  const uint32_t qbar = empty0 + 8 * kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int q_last = min(q0 + kRows, S) - 1;
  int nk = (S + kKeys - 1) / kKeys;
  if (causal) nk = min(nk, q_last / kKeys + 1);
  // With a window the loop starts at the first tile the block's band
  // reaches; stages and barrier parities count iterations (it = kt - kt0),
  // so the ring runs as from tile 0.
  const int kt0 = kWindowed ? max(0, q0 - window + 1) / kKeys : 0;
  const int n_it = nk - kt0;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * kConsumers);   // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {
    // Producer: the query tile once, then the key/value ring.
    if (lane == 0) {
      mbar_expect_tx(qbar, L::kTile);
      for (int c = 0; c < L::kBlocks; ++c)
        tma_load(base + L::kQ + c * L::kBlockBytes, &qmap, qbar, 64 * c, h, q0, b);
      for (int it = 0; it < n_it; ++it) {
        const int kt = kt0 + it;
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(empty0 + 8 * st, (it / kStages - 1) & 1);
        const uint32_t full = full0 + 8 * st;
        mbar_expect_tx(full, 2 * L::kTile);
        for (int c = 0; c < L::kBlocks; ++c) {
          const int off = st * L::kTile + c * L::kBlockBytes;
          tma_load(base + L::kK + off, &kmap, full, 64 * c, g, kt * kKeys, b);
          tma_load(base + L::kV + off, &vmap, full, 64 * c, g, kt * kKeys, b);
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: query rows q0 + 64 wg .. q0 + 64 wg + 63.
  const int wg = warp / 4;
  const int row0 = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;   // and row0 + 8
  const int col = 2 * (lane % 4);
  float o[HD / 2];
  float s[64];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  // This warpgroup's 64 query rows start 64 rows (8 KB) into each column block.
  const uint32_t qa = base + L::kQ + wg * 64 * 128;
  mbar_wait(qbar, 0);

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    const int k0 = (kt0 + it) * kKeys;
    mbar_wait(full0 + 8 * st, (it / kStages) & 1);
    const uint32_t kb = base + L::kK + st * L::kTile;
    const uint32_t vb = base + L::kV + st * L::kTile;

    // s = q . k^T over hd in steps of 16: 32 bytes along a swizzled row of a
    // column block; 8-row groups 1024 bytes apart.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * L::kBlockBytes + (kk % 4) * 32;
      wgmma_ss_n128(s, desc_b128(qa + off, 16, 1024), desc_b128(kb + off, 16, 1024),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Scale into log2 units and mask where the tile reaches past S, in
    // causal mode past this warpgroup's first row, or with a window below
    // the band of its last row (key <= row - window).
    const bool edge = k0 + kKeys > S || (causal && k0 + kKeys - 1 > q0 + 64 * wg) ||
                      (kWindowed && k0 <= q0 + 64 * wg + 63 - window);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale_log2;
        if (edge) {
          const int key = k0 + 8 * j + col + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (key >= S || (causal && key > row) ||
              (kWindowed && key <= row - window))
            x = kNegInf;
        }
        s[4 * j + e] = x;
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float r0 = 0.f, r1 = 0.f;
    uint32_t pa[32];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p0 = exp2f(s[4 * j] - mn0), p1 = exp2f(s[4 * j + 1] - mn0);
      const float p2 = exp2f(s[4 * j + 2] - mn1), p3 = exp2f(s[4 * j + 3] - mn1);
      r0 += p0 + p1;
      r1 += p2 + p3;
      pa[2 * j] = pack_bf16(p0, p1);
      pa[2 * j + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * c0 + r0;   // this thread's share of the row sums
    l1 = l1 * c1 + r1;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= c0;
      o[4 * j + 1] *= c0;
      o[4 * j + 2] *= c1;
      o[4 * j + 3] *= c1;
    }

    // o += p . v over the tile's keys in steps of 16 (2,048 bytes of v).
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                             pa[4 * kk + 3]};
      wgmma_rs<HD>(o, a, desc_b128(vb + kk * 2048, L::kBlockBytes, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty0 + 8 * st);   // this warp is done with the stage
    __syncwarp();
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int row1 = row0 + 8;
  TO* out0 = out + ((static_cast<int64_t>(b) * S + row0) * H + h) * HD + col;
  TO* out1 = out + ((static_cast<int64_t>(b) * S + row1) * H + h) * HD + col;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (row0 < S) store_pair(out0 + 8 * j, o[4 * j] / d0, o[4 * j + 1] / d0);
    if (row1 < S) store_pair(out1 + 8 * j, o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the CUDA runtime (no
// link against libcuda); null where it is not offered.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map over (hd, heads, S, B) at the given element strides of
// heads, S and B, in boxes of (64, 1, 128, 1), 128-byte swizzled; rows past
// S read as zeros.
bool encode_map(CUtensorMap* map, const void* ptr, int hd, int heads, int S,
                int B, long long sh, long long ss, long long sb) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(kRows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool kWindowed, typename TO>
int launch_wgmma_kernel(const Args& a) {
  alignas(64) CUtensorMap qm, km, vm;
  if (!encode_map(&qm, a.q, HD, a.H, a.S, a.B, a.qsh, a.qss, a.qsb) ||
      !encode_map(&km, a.k, HD, a.KV, a.S, a.B, a.ksh, a.kss, a.ksb) ||
      !encode_map(&vm, a.v, HD, a.KV, a.S, a.B, a.vsh, a.vss, a.vsb))
    return static_cast<int>(cudaErrorInvalidValue);
  using L = WgSmem<HD>;
  auto kernel = flash_attn_fwd_wgmma_kernel<HD, kWindowed, TO>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((a.S + kRows - 1) / kRows),
                  static_cast<unsigned>(a.H), static_cast<unsigned>(a.B));
  kernel<<<grid, kWgThreads, L::kAlloc, a.stream>>>(
      qm, km, vm, static_cast<TO*>(a.out), a.S, a.H, a.KV, a.causal, a.window,
      a.scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, typename TO>
int launch_wgmma(const Args& a) {
  return a.window > 0 ? launch_wgmma_kernel<HD, true, TO>(a)
                      : launch_wgmma_kernel<HD, false, TO>(a);
}

}  // namespace

// The wgmma route: q, k, v bfloat16 (in_type 1) with hd 64 or 128, each
// base 16-byte aligned and each stride over (B, S, heads) a positive
// multiple of 8 elements (the wrapper passes a valid stride for a dimension
// of size 1); otherwise as flash_attention_fwd.  Returns
// cudaErrorInvalidValue for any other input or if a tensor map cannot be
// encoded.
REPRO_EXPORT int flash_attention_fwd_wgmma(
    const void* q, const void* k, const void* v, void* out, int in_type,
    int out_type, int B, int S, int H, int KV, int hd, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int window,
    float scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  if (in_type != 1 || KV <= 0 || H % KV != 0 || window < 0 ||
      (window > 0 && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, B, S, H, KV, hd, qsb, qss, qsh, ksb, kss, ksh,
               vsb, vss, vsh, causal, window, scale,
               static_cast<cudaStream_t>(stream)};
  if (hd == 64 && out_type == 1) return launch_wgmma<64, __nv_bfloat16>(a);
  if (hd == 64 && out_type == 0) return launch_wgmma<64, float>(a);
  if (hd == 128 && out_type == 1) return launch_wgmma<128, __nv_bfloat16>(a);
  if (hd == 128 && out_type == 0) return launch_wgmma<128, float>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
