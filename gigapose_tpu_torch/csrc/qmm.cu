// W8A8 int8 serving kernels for Hopper (sm_90a), bound with ctypes through
// plain C entry points (gp_qmm_quant_rows, gp_qmm_gemm, gp_qmm_attention).
// Built by gigapose_tpu_torch/kernels/build.py, without --use_fast_math: the
// divisions (but for the attention's p, see there), exp and tanh are the
// IEEE / accurate forms, LayerNorm's rsqrt is rsqrtf as the plain version's
// torch.rsqrt computes it on the card (and jax.lax.rsqrt in the TPU kernel), and
// every product and sum that the plain PyTorch version rounds separately is
// written with __fmul_rn / __fadd_rn so that nvcc cannot contract it to FMA.
//
// Replaces the three TPU kernels of gigapose_tpu/ops/qmm.py:
//   _qmm_kernel (qmm)                   -> quant_rows + gemm
//   _qmm_mlp_kernel (qmm_mlp)           -> quant_rows(LN) + gemm(GELU)
//                                          + quant_rows + gemm(residual)
//   _attn_block_kernel (qmm_attn_block) -> quant_rows(LN) + gemm(bf16 qkv)
//                                          + attention + quant_rows
//                                          + gemm(residual)
// On the TPU each is one kernel whose (T, 4C) hidden or (Np, 3C) qkv stays in
// VMEM. Neither fits in the 227 KB of shared memory a Hopper block can use,
// so here each is a chain of kernels whose intermediates (int8 rows, f32 row
// scales, bf16 qkv, f32 context and hidden) pass through device memory.
//
// What bounds them on an H100 SXM, at the ViT-L serving shape (T = 32 x 257
// tokens, C = 1024, 16 heads of 64, hidden 4096):
// - the GEMMs: the four matmuls of a block are 2 * T * C * 12C = 207 GOP,
//   0.1 ms on the int8 tensor cores (1,979 TOP/s dense). With their inputs
//   and outputs in device memory the bytes bound proj, fc1 and fc2 (23-44
//   us at 3.35 TB/s: fc1 writes a 135 MB f32 hidden) and the operations
//   bound qkv (26 us). What holds this design back is the feed of its
//   k-loop: a 128 x 128 tile takes 32 KB of shared memory per 128-deep
//   k-block for 4 MOP, and the 5 stages that shared memory leaves room for
//   do not cover a stage's round trip (TMA, wgmma, release across the
//   cluster), so the tensor cores wait. Sharing the A tile across a 2-CTA
//   cluster cuts each CTA's L2 reads to 24 KB a k-block and helped; sharing
//   B as well (2 x 2 CTAs) did not. fc1's tanh-GELU epilogue issues about
//   40 instructions an output and outlasts the k-loop it runs under.
// - quant_rows: bytes only (one f32 row in, int8 row and scale out).
// - attention: bytes. Per block 50.5 MB of bf16 qkv in and 33.7 MB of f32
//   context out need 25 us; its 8.7 GFLOP need 9 us on the bf16 tensor
//   cores. So each head's K and V go into shared memory once, and the score
//   rows never leave registers.
//
// Kernels:
// - quant_rows: reads each row from device memory once, as 16-byte vectors
//   held in registers (at most 8 a thread): one warp per row while the row
//   has at most 256 vectors (K <= 1024 f32, 2048 bf16; 8 rows per CTA,
//   which stage gamma and beta in shared memory once, while their rows are
//   in flight), else one CTA of 256 threads per row (K <= 8192 f32, 16384
//   bf16). From the registers: [two-pass LayerNorm: mean, then mean of
//   squared deviations, each summed in f64 and rounded once, eps 1e-6] ->
//   row absmax -> scale = max(absmax, 1e-20) / 127 -> q = clamp(rint(x /
//   scale), +-127), written as packed 4- or 8-byte int8 groups, coalesced
//   across the warp. Without LayerNorm the bytes bound it; with it, the
//   three row reductions in a chain (mean, variance, absmax) add about half.
// - gemm: C = A . B^T with A the (T, K) int8 rows and B^T the (N, K) int8
//   weight (the JAX (K, N) weight stored K-contiguous), both K-major as
//   int8 wgmma reads them. Persistent clusters of two CTAs (as many as fit
//   on the card at once) walk pairs of adjacent 128 x 128 output tiles (one
//   m-tile, two n-tiles), n fastest. In each CTA a producer warpgroup (40
//   registers, setmaxnreg) issues TMA loads (tensor maps encoded per launch
//   on the host, boxes of 128-byte rows in the 128-byte swizzle, zero-filled
//   past T, N and K) into a 5-stage ring of 32 KB: its own B^T tile, and
//   half the rows of the shared A tile multicast into both CTAs, so each
//   CTA draws 24 KB, not 32, from L2 per k-block of 128. Each stage has a
//   pair of mbarriers (full: the TMA bytes landed; empty: both CTAs' wgmmas
//   on it are done). Two consumer warpgroups (232 registers) take the CTA's
//   tiles in turn (ping-pong): each holds a whole tile as two m64n128 int32
//   accumulators fed by wgmma.mma_async m64n128k32 s8, and a named barrier
//   hands the tensor cores from one warpgroup's k-loop to the other's, so
//   one warpgroup's epilogue runs under the other's products while the
//   producer keeps the ring full. The epilogue is exact int32 -> f32, then
//   acc * xs * ws + b in that order, and per mode: f32 out; f32 res + ls *
//   y; f32 tanh-GELU; bf16 out. It goes through shared memory in 64 x 32
//   chunks, three buffers a warpgroup: the residual copied into the chunk
//   with cp.async two chunks ahead, each fragment's result written over it, the
//   chunk stored with 16-byte row-contiguous stores (element stores where N
//   * size is not a multiple of 16 bytes). ws, bias and ls of the tile sit
//   in shared memory, loaded once per tile; xs once per fragment row.
// - attention: one CTA per (head, batch element), the head fastest, with
//   as many warps (at most 10) as take its 16-query blocks in two rounds. K and V of the head (bf16, Np rounded up to 16 keys, 16-byte
//   rows padded to 144 bytes) are copied into shared memory once with
//   cp.async: 93 KB at Np = 320, so two CTAs share an SM. Each warp takes
//   16-query blocks, its q fragments in registers straight from device
//   memory, and makes three passes over the keys in blocks of 16, each
//   recomputing s = (q . k^T, bf16 mma.sync m16n8k16, f32 accumulate, K by
//   ldmatrix) * hd^-1/2 + key_bias: the row max; the row sum of
//   exp(s - max), in f64 rounded once to f32 as the reference sums it; then p = bf16(exp(s - max) / sum), packed from the
//   accumulator registers into the A fragment of p . v (V by
//   ldmatrix.trans), f32 accumulate. The output is never rescaled: this is
//   not an online softmax, and p is rounded to bf16 after the division by
//   the full row sum, where the reference rounds it. Keys past Np get a
//   -inf bias and masked keys (-1e9) give exp = 0 exactly, so padded tokens
//   never reach real rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::u64;

constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ unsigned ld32(const void* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// (lo, hi) -> bf16x2 with lo at the lower address, as an mma operand or a
// packed store
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// ---------------------------------------------------------------- quant_rows

constexpr int kRowBlock = 256;  // threads per CTA
constexpr int kRowVecs = 8;     // 16-byte vectors a thread holds: 32 f32 or 64 bf16 values

// a 16-byte vector as f32 values (bf16 -> f32 is exact)
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the lower address holds the lower half
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// sum or max over the threads of one row: a warp, or the whole block
template <bool kMax, int kRowThreads, typename V>
__device__ __forceinline__ V row_reduce(V v, V* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const V o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? (o > v ? o : v) : v + o;
  }
  if constexpr (kRowThreads == 32) {
    return v;
  } else {
    static_assert(kRowThreads == kRowBlock, "a row is a warp or the whole block");
    __syncthreads();  // red may still be read by the previous reduction
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    V r = red[0];
    for (int w = 1; w < kRowBlock / 32; ++w) r = kMax ? (red[w] > r ? red[w] : r) : r + red[w];
    return r;
  }
}

template <typename T, int kRowThreads>
__global__ void __launch_bounds__(kRowBlock) quant_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, int8_t* __restrict__ xq,
    float* __restrict__ xs, int rows, int K) {
  constexpr int kE = 16 / sizeof(T);  // values per vector
  // one warp per row: the CTA's rows share gamma and beta, staged once
  constexpr bool kStage = kRowThreads == 32;
  __shared__ double red[kRowBlock / 32];
  __shared__ __align__(16) float gb[2][kStage ? 32 * kRowVecs * kE : 4];
  const int t = threadIdx.x % kRowThreads;
  const int row = blockIdx.x * (kRowBlock / kRowThreads) + threadIdx.x / kRowThreads;
  const int nvec = K / kE;
  // vector c = t + i * kRowThreads of the row, read once; zeros past the row
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  uint4 u[kRowVecs];
#pragma unroll
  for (int i = 0; i < kRowVecs; ++i) {
    const int c = t + i * kRowThreads;
    u[i] = row < rows && c < nvec ? __ldcs(xr + c) : make_uint4(0u, 0u, 0u, 0u);
  }
  if (kStage && gamma != nullptr) {  // while the rows are in flight
    for (int c = threadIdx.x; c < K / 4; c += kRowBlock) {
      reinterpret_cast<float4*>(gb[0])[c] = __ldg(reinterpret_cast<const float4*>(gamma) + c);
      reinterpret_cast<float4*>(gb[1])[c] = __ldg(reinterpret_cast<const float4*>(beta) + c);
    }
    __syncthreads();
  }
  if (row >= rows) return;  // whole warps: the block-per-row grid has no spare rows
  float v[kRowVecs][kE];
#pragma unroll
  for (int i = 0; i < kRowVecs; ++i) unpack(u[i], v[i]);
  if (gamma != nullptr) {
    // the mean of the row and of its f32 squared deviations, each summed in
    // f64 and rounded once: the sums' own order does not show, so the one
    // step that separates the kernel from the plain version is the plain
    // f32 sums' rounding alone
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < kRowVecs; ++i)
#pragma unroll
      for (int e = 0; e < kE; ++e) s += (double)v[i][e];
    const float mu = (float)(row_reduce<false, kRowThreads>(s, red) / K);
    double q = 0.0;
#pragma unroll
    for (int i = 0; i < kRowVecs; ++i)
      if (t + i * kRowThreads < nvec)
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const float d = __fsub_rn(v[i][e], mu);
          q += (double)__fmul_rn(d, d);
        }
    const float var = (float)(row_reduce<false, kRowThreads>(q, red) / K);
    const float rstd = rsqrtf(__fadd_rn(var, kLnEps));  // what torch.rsqrt gives on the card
#pragma unroll
    for (int i = 0; i < kRowVecs; ++i) {
      const int c = t + i * kRowThreads;
      if (c >= nvec) continue;
#pragma unroll
      for (int k = 0; k < kE / 4; ++k) {
        const int j = c * (kE / 4) + k;  // float4 index into gamma, beta
        const float4 gv = kStage ? reinterpret_cast<const float4*>(gb[0])[j]
                                 : __ldg(reinterpret_cast<const float4*>(gamma) + j);
        const float4 bv = kStage ? reinterpret_cast<const float4*>(gb[1])[j]
                                 : __ldg(reinterpret_cast<const float4*>(beta) + j);
        const float gs[4] = {gv.x, gv.y, gv.z, gv.w}, bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& y = v[i][4 * k + e];
          y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(y, mu), rstd), gs[e]), bs[e]);
        }
      }
    }
  }
  float m = 0.f;  // past the row every value is 0
#pragma unroll
  for (int i = 0; i < kRowVecs; ++i)
#pragma unroll
    for (int e = 0; e < kE; ++e) m = fmaxf(m, fabsf(v[i][e]));
  const float scale = fmaxf((float)row_reduce<true, kRowThreads>((double)m, red), 1e-20f) / 127.0f;
#pragma unroll
  for (int i = 0; i < kRowVecs; ++i) {
    const int c = t + i * kRowThreads;
    if (c >= nvec) continue;
    unsigned w[kE / 4];
#pragma unroll
    for (int k = 0; k < kE / 4; ++k) {
      w[k] = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float q = fminf(fmaxf(rintf(v[i][4 * k + e] / scale), -127.f), 127.f);
        w[k] |= ((unsigned)(int)q & 0xffu) << (8 * e);
      }
    }
    int8_t* dst = xq + (size_t)row * K + c * kE;
    if constexpr (kE == 4)
      *reinterpret_cast<unsigned*>(dst) = w[0];
    else
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  }
  if (t == 0) xs[row] = scale;
}

template <typename T>
int launch_quant_rows(const void* x, const float* gamma, const float* beta, int8_t* xq,
                      float* xs, int rows, int K, cudaStream_t s) {
  const int nvec = K / (16 / (int)sizeof(T));
  const T* xt = static_cast<const T*>(x);
  if (nvec <= 32 * kRowVecs)
    quant_rows_kernel<T, 32><<<(rows + kRowBlock / 32 - 1) / (kRowBlock / 32), kRowBlock, 0, s>>>(
        xt, gamma, beta, xq, xs, rows, K);
  else if (nvec <= kRowBlock * kRowVecs)
    quant_rows_kernel<T, kRowBlock><<<rows, kRowBlock, 0, s>>>(xt, gamma, beta, xq, xs, rows, K);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------- gemm

constexpr int kTileM = 128, kTileN = 128;  // one consumer warpgroup's output tile
constexpr int kTileK = 128;                // int8 values per k-block: one swizzle row
constexpr int kRing = 5;                   // stages
constexpr int kOpBytes = 128 * kTileK;     // one operand's tile: 16 KB
constexpr int kStageBytes = 2 * kOpBytes;  // A then B^T
constexpr int kCluster = 2;                // CTAs on adjacent n-tiles, sharing the A tile
constexpr int kASlice = kTileM / kCluster;  // rows of A each CTA loads for the cluster
constexpr int kEpiCols = 32;               // columns per epilogue chunk
constexpr int kEpiLd = kEpiCols + 8;       // chunk row stride in floats: conflict-free
constexpr int kEpiFloats = 64 * kEpiLd;    // one 64-row chunk buffer: 10 KB
constexpr int kEpiBufs = 3;                // per warpgroup: the residual two chunks ahead
constexpr int kEpiChunks = 2 * (kTileN / kEpiCols);  // per tile: 2 row halves x 4
constexpr int kGemmThreads = 384;  // two consumer warpgroups and a producer warpgroup
constexpr int kBarChunk = 1;       // named barriers 1, 2: one warpgroup's threads
constexpr int kBarTurn = 3;        // 3, 4: warpgroup w may start its k-loop
constexpr size_t kRingBytes = (size_t)kRing * kStageBytes;
constexpr size_t kGemmSmem = 1024  // slack to align the ring to the swizzle's 1024 bytes
                             + kRingBytes
                             + 2 * kEpiBufs * kEpiFloats * 4  // chunk buffers
                             + 2 * 3 * kTileN * 4      // ws, bias, ls per warpgroup
                             + 2 * kRing * 8;          // full and empty mbarriers
enum { kOutF32 = 0, kOutF32Res = 1, kOutF32Gelu = 2, kOutBf16 = 3 };

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}


// 0.5 * x * (1 + tanh(c * (x + 0.044715 * x * x * x))), left to right
__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  const float t = tanhf(__fmul_rn(c, __fadd_rn(x, cube)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, t));
}

// starts copying rows r0.. r0 + 63, columns c0.. c0 + 31 of the (T, N)
// residual into a chunk buffer (wt: the thread in its warpgroup), 16 bytes
// a copy where `vec`, zeros past T and N
__device__ __forceinline__ void chunk_in(float* buf, const float* __restrict__ res, int r0,
                                         int c0, int T, int N, bool vec, int wt) {
  if (vec) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int q = wt + 128 * p, lr = q >> 3, lc = (q & 7) * 4;
      const int row = r0 + lr, col = c0 + lc;
      const bool ok = row < T && col < N;
      cp_async16(buf + lr * kEpiLd + lc, ok ? res + (size_t)row * N + col : res, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int p = 0; p < 16; ++p) {
      const int q = wt + 128 * p, lr = q >> 5, lc = q & 31;
      const int row = r0 + lr, col = c0 + lc;
      const bool ok = row < T && col < N;
      cp_async4(buf + lr * kEpiLd + lc, ok ? res + (size_t)row * N + col : res, ok ? 4 : 0);
    }
  }
  cp_async_commit();
}

// a chunk buffer to rows r0.., columns c0.. of the (T, N) output, as
// 16-byte row-contiguous stores where `vec`, rounded to bf16 in that mode
template <int kMode>
__device__ __forceinline__ void chunk_out(void* out, const float* buf, int r0, int c0, int T,
                                          int N, bool vec, int wt) {
  if constexpr (kMode == kOutBf16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    if (vec) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int q = wt + 128 * p, lr = q >> 2, lc = (q & 3) * 8;
        const int row = r0 + lr, col = c0 + lc;
        if (row >= T || col >= N) continue;
        const float4 a = *reinterpret_cast<const float4*>(buf + lr * kEpiLd + lc);
        const float4 b = *reinterpret_cast<const float4*>(buf + lr * kEpiLd + lc + 4);
        *reinterpret_cast<uint4*>(o + (size_t)row * N + col) =
            make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                       pack_bf16(b.z, b.w));
      }
    } else {
#pragma unroll 4
      for (int p = 0; p < 16; ++p) {
        const int q = wt + 128 * p, lr = q >> 5, lc = q & 31;
        const int row = r0 + lr, col = c0 + lc;
        if (row < T && col < N)
          o[(size_t)row * N + col] = __float2bfloat16_rn(buf[lr * kEpiLd + lc]);
      }
    }
  } else {
    float* o = static_cast<float*>(out);
    if (vec) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int q = wt + 128 * p, lr = q >> 3, lc = (q & 7) * 4;
        const int row = r0 + lr, col = c0 + lc;
        if (row < T && col < N)
          *reinterpret_cast<float4*>(o + (size_t)row * N + col) =
              *reinterpret_cast<const float4*>(buf + lr * kEpiLd + lc);
      }
    } else {
#pragma unroll 4
      for (int p = 0; p < 16; ++p) {
        const int q = wt + 128 * p, lr = q >> 5, lc = q & 31;
        const int row = r0 + lr, col = c0 + lc;
        if (row < T && col < N) o[(size_t)row * N + col] = buf[lr * kEpiLd + lc];
      }
    }
  }
}

// Launched in clusters of kCluster CTAs. The cluster walks groups of
// adjacent output tiles (one m-tile, n-tiles kCluster np + r), n fastest;
// CTA r of the cluster takes n-tile kCluster np + r, loads its own B^T
// tile and rows r kASlice.. of the shared A tile, multicast to every CTA.
template <int kMode>
__global__ void __launch_bounds__(kGemmThreads, 1) gemm_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    const float* __restrict__ xs, const float* __restrict__ ws,
    const float* __restrict__ bias, const float* __restrict__ res,
    const float* __restrict__ ls, void* __restrict__ out, int T, int N, int K, int vec) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the same offset in every CTA
  float* epi_all = reinterpret_cast<float*>(smem_raw + (ring - raw) + kRingBytes);
  float* vec_all = epi_all + 2 * kEpiBufs * kEpiFloats;
  const uint32_t bars = ring + kRingBytes + (2 * kEpiBufs * kEpiFloats + 2 * 3 * kTileN) * 4;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kRing + s); };

  const int tid = threadIdx.x, warp = tid >> 5;
  const unsigned rank = hopper::cluster_rank();
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;
  const int pairs_n = ((N + kTileN - 1) / kTileN + kCluster - 1) / kCluster;
  const int pairs = (T + kTileM - 1) / kTileM * pairs_n;
  const int ktiles = (K + kTileK - 1) / kTileK;

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      hopper::mbar_init(full(s), 1);          // the producer's arrival, plus the TMA bytes
      hopper::mbar_init(empty(s), kCluster);  // the consuming warpgroup of each CTA
    }
    hopper::mbar_init_fence();
  }
  hopper::cluster_sync();  // both CTAs' barriers exist before either copies or arrives

  if (warp >= 8) {  // ------------------------------------------ producer
    hopper::setmaxnreg_dec<40>();
    if (tid == 256) {
      int it = 0;  // k-blocks issued, over all of this CTA's tiles
      for (int p = cluster; p < pairs; p += clusters) {
        const int m0 = p / pairs_n * kTileM;
        const int n0 = (p % pairs_n * kCluster + (int)rank) * kTileN;
        for (int kb = 0; kb < ktiles; ++kb, ++it) {
          const int s = it % kRing;
          // stage s is free in every CTA: this CTA's slice of A goes to all
          hopper::mbar_wait(empty(s), ((it / kRing) & 1) ^ 1);
          hopper::mbar_expect_tx(full(s), kStageBytes);
          const uint32_t st = ring + s * kStageBytes;
          hopper::tma_load_2d_multicast(st + rank * kASlice * kTileK, &map_a, full(s),
                                        kb * kTileK, m0 + kASlice * (int)rank,
                                        (1u << kCluster) - 1);
          hopper::tma_load_2d(st + kOpBytes, &map_b, full(s), kb * kTileK, n0);
        }
      }
      // stay until every CTA's consumers have released every stage: their
      // last arrivals land in this CTA's shared memory
      for (int k = 0; k < kRing; ++k, ++it)
        hopper::mbar_wait(empty(it % kRing), ((it / kRing) & 1) ^ 1);
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  hopper::setmaxnreg_inc<232>();
  const int lane = tid & 31, wg = warp >> 2, wt = tid & 127, ww = warp & 3;
  const int g = lane >> 2, tig = lane & 3;
  float* bufs = epi_all + wg * kEpiBufs * kEpiFloats;  // chunk q goes to buffer q % 3
  float* v_ws = vec_all + wg * 3 * kTileN;
  float* v_b = v_ws + kTileN;
  float* v_ls = v_b + kTileN;
  int acc[2][64] = {};  // rows 0-63 and 64-127 of the tile
  int it = 0;           // k-blocks consumed by either warpgroup, as the producer counts them
  for (int i = 0, p = cluster; p < pairs; ++i, p += clusters) {
    if ((i & 1) != wg) {  // the other warpgroup's tile
      it += ktiles;
      continue;
    }
    const int m0 = p / pairs_n * kTileM;
    const int n0 = (p % pairs_n * kCluster + (int)rank) * kTileN;
    {  // the tile's column vectors, read once (the last chunk's barrier freed them)
      const int col = n0 + wt;
      v_ws[wt] = col < N ? ws[col] : 0.f;
      v_b[wt] = col < N ? bias[col] : 0.f;
      if constexpr (kMode == kOutF32Res) v_ls[wt] = col < N ? ls[col] : 0.f;
    }
    // the residual's first two chunks land during the k-loop, once the last
    // tile's final chunk (in buffer 1) is stored
    if constexpr (kMode == kOutF32Res) {
      hopper::bar_sync(kBarChunk + wg, 128);
      chunk_in(bufs, res, m0, n0, T, N, vec, wt);
      chunk_in(bufs + kEpiFloats, res, m0, n0 + kEpiCols, T, N, vec, wt);
    }
    if (i > 0) hopper::bar_sync(kBarTurn + wg, 256);  // the other k-loop is done
    for (int kb = 0; kb < ktiles; ++kb, ++it) {
      const int s = it % kRing;
      hopper::mbar_wait(full(s), (it / kRing) & 1);
      const uint32_t a_s = ring + s * kStageBytes, b_s = a_s + kOpBytes;
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kTileK / 32; ++k) {  // 32 int8 = 32 bytes per step
        const u64 db = hopper::smem_desc(b_s + 32 * k);
        hopper::wgmma_s8(acc[0], hopper::smem_desc(a_s + 32 * k), db, kb > 0 || k > 0);
        hopper::wgmma_s8(acc[1], hopper::smem_desc(a_s + kOpBytes / 2 + 32 * k), db,
                         kb > 0 || k > 0);
      }
      hopper::wgmma_commit();
      if (kb > 0) {  // the previous k-block's products are done: free its stage everywhere
        hopper::wgmma_wait<1>();
        if (wt == 0)
          for (unsigned c = 0; c < kCluster; ++c)
            hopper::mbar_arrive_cluster(empty((it - 1) % kRing), c);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_acc(acc[0]);
    hopper::fence_acc(acc[1]);
    if (wt == 0)
      for (unsigned c = 0; c < kCluster; ++c)
        hopper::mbar_arrive_cluster(empty((it - 1) % kRing), c);
    if (p + clusters < pairs) hopper::bar_arrive(kBarTurn + (wg ^ 1), 256);

    // epilogue, under the other warpgroup's k-loop
    hopper::bar_sync(kBarChunk + wg, 128);  // the column vectors are in place
    float xr[2][2];  // xs of rows 64 h + 16 ww + g + 8 r
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + 64 * h + 16 * ww + g + 8 * r;
        xr[h][r] = row < T ? xs[row] : 0.f;
      }
#pragma unroll
    for (int q = 0; q < kEpiChunks; ++q) {
      const int h = q / (kTileN / kEpiCols), c = q % (kTileN / kEpiCols);
      const int r0 = m0 + 64 * h, c0 = n0 + c * kEpiCols;
      float* buf = bufs + q % kEpiBufs * kEpiFloats;
      if constexpr (kMode == kOutF32Res) {
        if (q + 1 < kEpiChunks)  // this thread's part of chunk q (q + 1 may be in flight)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
        hopper::bar_sync(kBarChunk + wg, 128);  // everyone's; chunk q - 1 is stored
        if (q + 2 < kEpiChunks) {
          const int qn = q + 2, hn = qn / (kTileN / kEpiCols), cn = qn % (kTileN / kEpiCols);
          chunk_in(bufs + qn % kEpiBufs * kEpiFloats, res, m0 + 64 * hn, n0 + cn * kEpiCols, T,
                   N, vec, wt);
        }
      }
#pragma unroll
      for (int jj = 0; jj < kEpiCols / 8; ++jj) {
        const int j = c * (kEpiCols / 8) + jj;  // n8 block of the accumulator
        const int lc = 8 * jj + 2 * tig, tc = c * kEpiCols + lc;
        const float2 w2 = *reinterpret_cast<const float2*>(v_ws + tc);
        const float2 b2 = *reinterpret_cast<const float2*>(v_b + tc);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float* e = buf + (16 * ww + g + 8 * r) * kEpiLd + lc;
          const float a0 = __int2float_rn(acc[h][4 * j + 2 * r]);
          const float a1 = __int2float_rn(acc[h][4 * j + 2 * r + 1]);
          float y0 = __fmul_rn(__fmul_rn(a0, xr[h][r]), w2.x);
          float y1 = __fmul_rn(__fmul_rn(a1, xr[h][r]), w2.y);
          y0 = __fadd_rn(y0, b2.x);
          y1 = __fadd_rn(y1, b2.y);
          if constexpr (kMode == kOutF32Res) {
            const float2 l2 = *reinterpret_cast<const float2*>(v_ls + tc);
            y0 = __fadd_rn(e[0], __fmul_rn(y0, l2.x));
            y1 = __fadd_rn(e[1], __fmul_rn(y1, l2.y));
          }
          if constexpr (kMode == kOutF32Gelu) {
            y0 = gelu_tanh(y0);
            y1 = gelu_tanh(y1);
          }
          *reinterpret_cast<float2*>(e) = make_float2(y0, y1);
        }
      }
      // chunk q is complete, and every thread has stored chunk q - 1: the
      // buffers that chunks q + 1 and q + 2 fill are free
      hopper::bar_sync(kBarChunk + wg, 128);
      chunk_out<kMode>(out, buf, r0, c0, T, N, vec, wt);
    }
  }
}

template <int kMode>
int launch_gemm(const void* xq, const void* xs, const void* wt, const void* ws,
                const void* bias, const void* res, const void* ls, void* out, int T, int N,
                int K, cudaStream_t stream) {
  static int resident_cache[hopper::kMaxDevices] = {};
  const int resident = hopper::resident_clusters(gemm_kernel<kMode>, resident_cache, kCluster,
                                                 kGemmThreads, (int)kGemmSmem);
  if (resident < 0) return -resident;
  CUtensorMap map_a, map_b;  // A changes at every call: encoded per launch (host only)
  if (!hopper::encode_kmajor_s8(&map_a, xq, T, K, kASlice) ||
      !hopper::encode_kmajor_s8(&map_b, wt, N, K, kTileN))
    return (int)cudaErrorInvalidValue;
  const int pairs =
      (T + kTileM - 1) / kTileM * (((N + kTileN - 1) / kTileN + kCluster - 1) / kCluster);
  const size_t esize = kMode == kOutBf16 ? 2 : 4;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = (N * esize) % 16 == 0 && aligned(out) && (res == nullptr || aligned(res));
  cudaLaunchAttribute cluster;
  cudaLaunchConfig_t cfg =
      hopper::cluster_config(&cluster, kCluster, kGemmThreads, (int)kGemmSmem, stream);
  cfg.gridDim = dim3((pairs < resident ? pairs : resident) * kCluster);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gemm_kernel<kMode>, map_a, map_b, static_cast<const float*>(xs),
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<const float*>(res), static_cast<const float*>(ls), out, T, N, K, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- attention

constexpr int kAttnMaxWarps = 10;  // 16-query blocks of Np <= 320 in at most two rounds
constexpr int kMaxKeys = 320;
constexpr int kHD = 64;
constexpr int kKS = kHD + 8;  // K / V row stride in bf16: 144 bytes, conflict-free ldmatrix

// smem: K bf16 [Nk][kKS] | V bf16 [Nk][kKS] | key bias f32 [Nk], where Nk
// is Np rounded up to 16 keys; 93,440 bytes at Nk = 320, two CTAs per SM
size_t attn_smem_bytes(int nk) { return (size_t)nk * kKS * 2 * 2 + (size_t)nk * 4; }

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// s for the warp's 16 queries and keys key0 .. key0 + 15: s[n][e] is row
// g + 8 (e >> 1), key key0 + 8 n + 2 tig + (e & 1), as the f32 accumulator
// of two m16n8k16 tiles; s = (q . k^T) * scale + key_bias in that order
__device__ __forceinline__ void scores16(float (&s)[2][4], const unsigned (&qa)[4][4],
                                         uint32_t k_s, const float* bias_s, int key0,
                                         float scale, int lane) {
  const int tig = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // head columns 32 h .. 32 h + 31: two k16 steps
      unsigned kb[4];
      ldsm_x4(kb, k_s + ((key0 + 8 * n + (lane & 7)) * kKS + 32 * h + (lane >> 3) * 8) * 2);
      mma_bf16(s[n], qa[2 * h], kb[0], kb[1]);
      mma_bf16(s[n], qa[2 * h + 1], kb[2], kb[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[n][e] = __fadd_rn(__fmul_rn(s[n][e], scale), bias_s[key0 + 8 * n + 2 * tig + (e & 1)]);
  }
}

__global__ void __launch_bounds__(kAttnMaxWarps * 32, 2) attention_kernel(
    const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ key_bias,
    float* __restrict__ ctx, int Np, int H, int Nk, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t k_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t v_s = k_s + Nk * kKS * 2;
  float* bias_s = reinterpret_cast<float*>(smem_raw + 2 * Nk * kKS * 2);

  const int h = blockIdx.x, b = blockIdx.y;
  const int C = H * kHD;
  const size_t ld = 3 * (size_t)C;
  const __nv_bfloat16* base = qkv + (size_t)b * Np * ld + h * kHD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int nthreads = blockDim.x;

  // K and V of this head, once: 16-byte rows, zero past Np; padded keys
  // get a -inf bias, so exp gives them p = 0
  for (int i = tid; i < 2 * Nk * 8; i += nthreads) {
    const int which = i >= Nk * 8;  // 0: K, 1: V
    const int r = i - which * Nk * 8, key = r >> 3, ch = r & 7;
    const bool ok = key < Np;
    cp_async16(smem_raw + which * Nk * kKS * 2 + (key * kKS + ch * 8) * 2,
               ok ? base + key * ld + (1 + which) * C + ch * 8 : base, ok ? 16 : 0);
  }
  cp_async_commit();
  for (int i = tid; i < Nk; i += nthreads) bias_s[i] = i < Np ? key_bias[i] : -INFINITY;
  cp_async_wait<0>();
  __syncthreads();

  for (int q0 = warp * 16; q0 < Np; q0 += nthreads / 2) {  // nthreads / 32 warps x 16 rows
    unsigned qa[4][4];  // A fragments of q for the four k16 steps over the head
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + g + (e & 1) * 8;
        qa[kk][e] = row < Np ? ld32(base + row * ld + kk * 16 + (e >> 1) * 8 + tig * 2) : 0u;
      }

    // pass 1: row maxima (rows g and g + 8)
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int key0 = 0; key0 < Nk; key0 += 16) {
      float s[2][4];
      scores16(s, qa, k_s, bias_s, key0, scale, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        m0 = fmaxf(m0, fmaxf(s[n][0], s[n][1]));
        m1 = fmaxf(m1, fmaxf(s[n][2], s[n][3]));
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    // pass 2: row sums of exp(s - max), in f64 and rounded once to f32, as
    // the reference sums them: the sum's order then does not show
    double d0 = 0.0, d1 = 0.0;
    for (int key0 = 0; key0 < Nk; key0 += 16) {
      float s[2][4];
      scores16(s, qa, k_s, bias_s, key0, scale, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          d0 += (double)expf(__fsub_rn(s[n][e], m0));
          d1 += (double)expf(__fsub_rn(s[n][2 + e], m1));
        }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      d0 += __shfl_xor_sync(0xffffffffu, d0, off);
      d1 += __shfl_xor_sync(0xffffffffu, d1, off);
    }
    const float l0 = (float)d0, l1 = (float)d1;
    // pass 3: p = bf16(exp(s - max) / sum), straight from the accumulator
    // registers into the A fragment of p . v. The quotient is e times the
    // correctly rounded reciprocal, corrected once with an fma (Markstein):
    // the IEEE quotient for all but rare inputs, and those are one f32 ulp
    // off, far below the bf16 rounding that follows
    const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);
    auto div = [](float e, float l, float r) {
      const float q = __fmul_rn(e, r);
      return __fmaf_rn(__fmaf_rn(-q, l, e), r, q);
    };
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    for (int key0 = 0; key0 < Nk; key0 += 16) {
      float s[2][4];
      scores16(s, qa, k_s, bias_s, key0, scale, lane);
      unsigned pa[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        pa[2 * n] = pack_bf16(div(expf(__fsub_rn(s[n][0], m0)), l0, r0),
                              div(expf(__fsub_rn(s[n][1], m0)), l0, r0));
        pa[2 * n + 1] = pack_bf16(div(expf(__fsub_rn(s[n][2], m1)), l1, r1),
                                  div(expf(__fsub_rn(s[n][3], m1)), l1, r1));
      }
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {  // head columns 16 jp .. 16 jp + 15
        unsigned vb[4];
        ldsm_x4_trans(vb, v_s + ((key0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kKS +
                                 (2 * jp + (lane >> 4)) * 8) * 2);
        mma_bf16(o[2 * jp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * jp + 1], pa, vb[2], vb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = q0 + g + half * 8;
        if (row < Np)
          *reinterpret_cast<float2*>(ctx + ((size_t)b * Np + row) * C + h * kHD + j * 8 +
                                     tig * 2) = make_float2(o[j][2 * half], o[j][2 * half + 1]);
      }
  }
}

int launch_attention(const void* qkv, const void* key_bias, void* ctx, int B, int Np, int H,
                     float scale, cudaStream_t stream) {
  const int nk = (Np + 15) / 16 * 16;
  const size_t smem = attn_smem_bytes(nk);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // as many warps as split the 16-query blocks into two rounds: a third
  // round for one block (Np = 257 has 17) would idle the other warps
  const int warps = min(kAttnMaxWarps, ((Np + 15) / 16 + 1) / 2);
  attention_kernel<<<dim3(H, B), warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(key_bias),
      static_cast<float*>(ctx), Np, H, nk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// All arrays contiguous on the current device; each entry point returns the
// CUDA error of its launch (0 on success) and runs asynchronously on `stream`.

// x (T, K) f32 (dtype 0) or bf16 (dtype 1), 16-byte aligned, K a multiple
// of 16 and at most 8192 (f32) or 16384 (bf16); gamma / beta (K,) f32,
// 16-byte aligned, or both null (no LayerNorm) -> xq (T, K) int8, xs (T,) f32.
extern "C" int gp_qmm_quant_rows(const void* x, int dtype, const void* gamma,
                                 const void* beta, void* xq, void* xs, int T, int K,
                                 void* stream) {
  if (T <= 0 || K <= 0 || K % 16 || (gamma == nullptr) != (beta == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  int8_t* q = static_cast<int8_t*>(xq);
  float* sc = static_cast<float*>(xs);
  if (dtype == 0) return launch_quant_rows<float>(x, g, be, q, sc, T, K, s);
  if (dtype == 1) return launch_quant_rows<__nv_bfloat16>(x, g, be, q, sc, T, K, s);
  return (int)cudaErrorInvalidValue;
}

// xq (T, K) int8 and wt (N, K) int8, both 16-byte aligned (TMA), xs (T,)
// f32, ws / bias / ls (N,) f32, res (T, N) f32 (mode 1 only) -> out (T, N):
// mode 0 f32, 1 f32 res + ls * y, 2 f32 tanh-GELU, 3 bf16. K must be a
// multiple of 16.
extern "C" int gp_qmm_gemm(const void* xq, const void* xs, const void* wt, const void* ws,
                           const void* bias, const void* res, const void* ls, void* out,
                           int T, int N, int K, int mode, void* stream) {
  if (T <= 0 || N <= 0 || K <= 0 || K % 16) return (int)cudaErrorInvalidValue;
  if (mode == kOutF32Res && (res == nullptr || ls == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kOutF32: return launch_gemm<kOutF32>(xq, xs, wt, ws, bias, res, ls, out, T, N, K, s);
    case kOutF32Res:
      return launch_gemm<kOutF32Res>(xq, xs, wt, ws, bias, res, ls, out, T, N, K, s);
    case kOutF32Gelu:
      return launch_gemm<kOutF32Gelu>(xq, xs, wt, ws, bias, res, ls, out, T, N, K, s);
    case kOutBf16: return launch_gemm<kOutBf16>(xq, xs, wt, ws, bias, res, ls, out, T, N, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// qkv (B * Np, 3 * H * hd) bf16 laid out [token][3][H][hd], key_bias (Np,)
// f32 -> ctx (B * Np, H * hd) f32. hd is 64 (ViT-S/B/L/g), Np at most 320.
extern "C" int gp_qmm_attention(const void* qkv, const void* key_bias, void* ctx, int B,
                                int Np, int H, int hd, float scale, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || Np <= 0 || Np > kMaxKeys)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd != kHD) return (int)cudaErrorInvalidValue;
  return launch_attention(qkv, key_bias, ctx, B, Np, H, scale, s);
}
