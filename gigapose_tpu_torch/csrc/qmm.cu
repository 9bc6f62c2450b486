// W8A8 int8 serving kernels for Hopper (sm_90a), bound with ctypes through
// plain C entry points (gp_qmm_quant_rows, gp_qmm_gemm, gp_qmm_attention).
// Built by gigapose_tpu_torch/kernels/build.py, without --use_fast_math: the
// divisions, square root, exp and tanh are the IEEE / accurate forms, and
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
// What bounds them on an H100, at the ViT-L serving shape (T = 32 x 257
// tokens, C = 1024, hidden 4096): the four matmuls of a block are
// 2 * T * C * 12C = 207 GOP, which the int8 tensor cores (1,979 TOP/s dense)
// could do in 0.1 ms; the intermediates and the residual stream are ~0.7 GB
// of traffic per block (0.2 ms at 3.35 TB/s), most of it the f32 hidden.
// This first version issues the matmuls as warp-level mma.sync (m16n8k32
// s8 -> s32) from shared-memory tiles loaded with cp.async, which reaches a
// fraction of the wgmma rate. The attention core (8.7 GFLOP per block at
// B=32) runs one CTA per SM for its 180 KB of shared memory and does not
// overlap its phases; on an H100 it takes about a third of the int8 AE's
// time at B=32. wgmma / TMA tiles, keeping the hidden and the qkv on chip,
// and a denser attention core are later work.
//
// Kernels:
// - quant_rows: one block of 256 threads per row. [Two-pass LayerNorm:
//   mean, then mean of squared deviations, eps 1e-6] -> row absmax ->
//   scale = max(absmax, 1e-20) / 127 -> q = clamp(rint(x / scale), +-127).
//   The row is re-read from L1/L2 at each pass instead of held in
//   registers, so any K works.
// - gemm: C = A . B^T with A the (T, K) int8 rows and B^T the (N, K) int8
//   weight (the JAX (K, N) weight stored K-contiguous). 128 x 128 x 64 block
//   tiles, 3-stage cp.async ring (zero-filled past the ragged edges), 8 warps
//   of 64 x 32, int32 accumulators. The epilogue is exact int32 -> f32, then
//   acc * xs * ws + b in that order, and per mode: f32 out; f32 res + ls * y;
//   f32 tanh-GELU; bf16 out.
// - attention: one CTA per (64-query tile, head, batch element). Q tile, all
//   keys and V^T (bf16) and the 64 x Nk f32 score rows live in shared memory
//   (180 KB at Nk = 320). s = (q . k^T, f32 accumulate via bf16 mma.sync)
//   * hd^-1/2 + key_bias; row max; exp(s - max); divided by the row sum;
//   rounded to bf16 in place; then p . v, f32 accumulate. No online softmax:
//   p is rounded to bf16 after the division, where the reference rounds it.
//   Keys past Np are zero and get p = 0; masked keys (-1e9) give exp = 0
//   exactly, so padded tokens never reach real rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ unsigned ld32(const void* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// ---------------------------------------------------------------- quant_rows

constexpr int kRowThreads = 256;

template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read by the previous reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kRowThreads / 32; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads) quant_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, int8_t* __restrict__ xq,
    float* __restrict__ xs, int K) {
  __shared__ float red[kRowThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * K;
  const bool ln = gamma != nullptr;
  float mu = 0.f, rstd = 1.f;
  if (ln) {
    float s = 0.f;
    for (int i = threadIdx.x; i < K; i += kRowThreads) s += to_f32(xr[i]);
    mu = block_reduce<false>(s, red) / (float)K;
    float q = 0.f;
    for (int i = threadIdx.x; i < K; i += kRowThreads) {
      const float d = __fsub_rn(to_f32(xr[i]), mu);
      q = __fadd_rn(q, __fmul_rn(d, d));
    }
    const float var = block_reduce<false>(q, red) / (float)K;
    rstd = 1.0f / sqrtf(__fadd_rn(var, kLnEps));
  }
  auto value = [&](int i) {
    const float v = to_f32(xr[i]);
    if (!ln) return v;
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), rstd), gamma[i]), beta[i]);
  };
  float m = 0.f;
  for (int i = threadIdx.x; i < K; i += kRowThreads) m = fmaxf(m, fabsf(value(i)));
  const float scale = fmaxf(block_reduce<true>(m, red), 1e-20f) / 127.0f;
  for (int i = threadIdx.x; i < K; i += kRowThreads) {
    const float q = fminf(fmaxf(rintf(value(i) / scale), -127.f), 127.f);
    xq[row * K + i] = (int8_t)q;
  }
  if (threadIdx.x == 0) xs[row] = scale;
}

// ---------------------------------------------------------------------- gemm

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3, kGemmThreads = 256;
constexpr int kRowBytes = kBK + 16;  // 80: 16-byte rows, conflict-free fragment reads
constexpr int kStageBytes = (kBM + kBN) * kRowBytes;
constexpr int kGemmSmem = kStages * kStageBytes;  // 61,440 bytes
enum { kOutF32 = 0, kOutF32Res = 1, kOutF32Gelu = 2, kOutBf16 = 3 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

template <int kMode>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(
    const int8_t* __restrict__ a, const float* __restrict__ xs,
    const int8_t* __restrict__ bt, const float* __restrict__ ws,
    const float* __restrict__ bias, const float* __restrict__ res,
    const float* __restrict__ ls, void* __restrict__ out, int T, int N, int K) {
  extern __shared__ __align__(16) int8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int ktiles = (K + kBK - 1) / kBK;

  // rows 0..kBM-1 of a stage are A rows m0.., rows kBM.. are B^T rows n0..
  auto load_stage = [&](int stage, int kt) {
    int8_t* dst = smem + stage * kStageBytes;
    const int k0 = kt * kBK;
    for (int i = tid; i < (kBM + kBN) * (kBK / 16); i += kGemmThreads) {
      const int r = i / (kBK / 16), c = (i % (kBK / 16)) * 16;
      const bool is_a = r < kBM;
      const int grow = is_a ? m0 + r : n0 + r - kBM;
      const int8_t* base = is_a ? a : bt;
      const bool ok = grow < (is_a ? T : N) && k0 + c < K;
      const int8_t* src = ok ? base + (size_t)grow * K + k0 + c : base;
      cp_async16(dst + r * kRowBytes + c, src, ok ? 16 : 0);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; stage kt-1 is free for the next load
    if (kt + kStages - 1 < ktiles) load_stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
    const int8_t* as = smem + (kt % kStages) * kStageBytes;
    const int8_t* bs = as + kBM * kRowBytes;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = as + (wm * 64 + mi * 16 + g) * kRowBytes + kk + tig * 4;
        af[mi][0] = ld32(p);
        af[mi][1] = ld32(p + 8 * kRowBytes);
        af[mi][2] = ld32(p + 16);
        af[mi][3] = ld32(p + 8 * kRowBytes + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = bs + (wn * 32 + ni * 8 + g) * kRowBytes + kk + tig * 4;
        bf[ni][0] = ld32(p);
        bf[ni][1] = ld32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 64 + mi * 16 + g + (e >> 1) * 8;
        const int col = n0 + wn * 32 + ni * 8 + tig * 2 + (e & 1);
        if (row >= T || col >= N) continue;
        float y = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][e]), xs[row]), ws[col]);
        y = __fadd_rn(y, bias[col]);
        const size_t o = (size_t)row * N + col;
        if constexpr (kMode == kOutF32Res) y = __fadd_rn(res[o], __fmul_rn(y, ls[col]));
        if constexpr (kMode == kOutF32Gelu) y = gelu_tanh(y);
        if constexpr (kMode == kOutBf16) {
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
        } else {
          static_cast<float*>(out)[o] = y;
        }
      }
}

template <int kMode>
int launch_gemm(const void* xq, const void* xs, const void* wt, const void* ws,
                const void* bias, const void* res, const void* ls, void* out, int T, int N,
                int K, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kBN - 1) / kBN, (T + kBM - 1) / kBM);
  gemm_kernel<kMode><<<grid, kGemmThreads, kGemmSmem, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wt), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<const float*>(res),
      static_cast<const float*>(ls), out, T, N, K);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- attention

constexpr int kAttnThreads = 256;
constexpr int kQTile = 64;
constexpr int kMaxKeys = 320;

// smem: S f32 [64][Nk + 4] | Q bf16 [64][HD + 8] | K bf16 [Nk][HD + 8]
//       | V^T bf16 [HD][Nk + 8]; the paddings make every fragment read
//       conflict-free (row strides of 4 mod 32 words) and keep rows 16-byte
//       aligned. p is written as bf16 over the first half of each S row.
size_t attn_smem_bytes(int hd, int nk) {
  return (size_t)kQTile * (nk + 4) * 4 + (size_t)(kQTile + nk) * (hd + 8) * 2 +
         (size_t)hd * (nk + 8) * 2;
}

template <int HD>
__global__ void __launch_bounds__(kAttnThreads) attention_kernel(
    const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ key_bias,
    float* __restrict__ ctx, int Np, int H, int Nk, float scale) {
  constexpr int QS = HD + 8;
  constexpr int kVec = 8;  // bf16 per 16-byte load
  constexpr int kChunks = HD / kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SS = Nk + 4, VS = Nk + 8;
  float* S = reinterpret_cast<float*>(smem_raw);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(S + kQTile * SS);
  __nv_bfloat16* Ks = Qs + kQTile * QS;
  __nv_bfloat16* Vt = Ks + Nk * QS;

  const int q0 = blockIdx.x * kQTile, h = blockIdx.y, b = blockIdx.z;
  const int C = H * HD;
  const size_t ld = 3 * (size_t)C;
  const __nv_bfloat16* base = qkv + (size_t)b * Np * ld + h * HD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;

  // Q tile rows, then all K rows; zero past Np
  for (int i = tid; i < (kQTile + Nk) * kChunks; i += kAttnThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    const bool is_q = r < kQTile;
    const int tok = is_q ? q0 + r : r - kQTile;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (tok < Np) v = *reinterpret_cast<const uint4*>(base + tok * ld + (is_q ? 0 : C) + c);
    *reinterpret_cast<uint4*>(Qs + r * QS + c) = v;  // Ks follows Qs: row r - 64 of K
  }
  // V transposed: Vt[d][key]
  for (int i = tid; i < Nk * kChunks; i += kAttnThreads) {
    const int key = i / kChunks, c = (i % kChunks) * kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (key < Np) v = *reinterpret_cast<const uint4*>(base + key * ld + 2 * C + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) Vt[(c + j) * VS + key] = e[j];
  }
  __syncthreads();

  const int rb = warp & 3;    // 16-row block of the query tile
  const int half = warp >> 2;  // which half of the key tiles / head columns
  {
    unsigned af[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const __nv_bfloat16* p = Qs + (rb * 16 + g) * QS + kk * 16 + tig * 2;
      af[kk][0] = ld32(p);
      af[kk][1] = ld32(p + 8 * QS);
      af[kk][2] = ld32(p + 8);
      af[kk][3] = ld32(p + 8 * QS + 8);
    }
    for (int nt = half; nt < Nk / 8; nt += 2) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const __nv_bfloat16* p = Ks + (nt * 8 + g) * QS + kk * 16 + tig * 2;
        mma_bf16(c, af[kk], ld32(p), ld32(p + 8));
      }
      float* s = S + (rb * 16 + g) * SS + nt * 8 + tig * 2;
      s[0] = c[0];
      s[1] = c[1];
      s[8 * SS] = c[2];
      s[8 * SS + 1] = c[3];
    }
  }
  __syncthreads();

  // softmax per row, one warp per row; p overwrites the row as bf16
  constexpr int kCols = kMaxKeys / 32;
  for (int r = warp; r < kQTile; r += kAttnThreads / 32) {
    float* srow = S + r * SS;
    float v[kCols];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int c = lane + 32 * i;
      v[i] = -INFINITY;
      if (c < Np) {
        v[i] = __fadd_rn(__fmul_rn(srow[c], scale), key_bias[c]);
        m = fmaxf(m, v[i]);
      }
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      v[i] = lane + 32 * i < Np ? expf(__fsub_rn(v[i], m)) : 0.f;
      sum += v[i];
    }
    sum = warp_sum(sum);
    __syncwarp();  // every lane has read the row before any lane overwrites it
    __nv_bfloat16* prow = reinterpret_cast<__nv_bfloat16*>(srow);
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int c = lane + 32 * i;
      if (c < Nk) prow[c] = __float2bfloat16_rn(v[i] / sum);
    }
  }
  __syncthreads();

  // ctx = p . v: each warp 16 rows x HD/2 columns
  {
    constexpr int kNT = HD / 16;  // n8 tiles in HD/2 columns
    const __nv_bfloat16* P = reinterpret_cast<const __nv_bfloat16*>(S);
    const int PS = 2 * SS;
    float acc[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int kk = 0; kk < Nk; kk += 16) {
      unsigned af[4];
      const __nv_bfloat16* p = P + (rb * 16 + g) * PS + kk + tig * 2;
      af[0] = ld32(p);
      af[1] = ld32(p + 8 * PS);
      af[2] = ld32(p + 8);
      af[3] = ld32(p + 8 * PS + 8);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const __nv_bfloat16* vp = Vt + (half * (HD / 2) + j * 8 + g) * VS + kk + tig * 2;
        mma_bf16(acc[j], af, ld32(vp), ld32(vp + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + rb * 16 + g + (e >> 1) * 8;
        const int d = half * (HD / 2) + j * 8 + tig * 2 + (e & 1);
        if (r < Np) ctx[((size_t)b * Np + r) * C + h * HD + d] = acc[j][e];
      }
  }
}

template <int HD>
int launch_attention(const void* qkv, const void* key_bias, void* ctx, int B, int Np, int H,
                     float scale, cudaStream_t stream) {
  const int nk = (Np + 63) / 64 * 64;
  const size_t smem = attn_smem_bytes(HD, nk);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Np + kQTile - 1) / kQTile, H, B);
  attention_kernel<HD><<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(key_bias),
      static_cast<float*>(ctx), Np, H, nk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// All arrays contiguous on the current device; each entry point returns the
// CUDA error of its launch (0 on success) and runs asynchronously on `stream`.

// x (T, K) f32 (dtype 0) or bf16 (dtype 1); gamma / beta (K,) f32 or both
// null (no LayerNorm) -> xq (T, K) int8, xs (T,) f32.
extern "C" int gp_qmm_quant_rows(const void* x, int dtype, const void* gamma,
                                 const void* beta, void* xq, void* xs, int T, int K,
                                 void* stream) {
  if (T <= 0 || K <= 0 || (gamma == nullptr) != (beta == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  int8_t* q = static_cast<int8_t*>(xq);
  float* sc = static_cast<float*>(xs);
  if (dtype == 0)
    quant_rows_kernel<float><<<T, kRowThreads, 0, s>>>(static_cast<const float*>(x), g, be, q,
                                                        sc, K);
  else if (dtype == 1)
    quant_rows_kernel<__nv_bfloat16><<<T, kRowThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), g, be, q, sc, K);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// xq (T, K) int8, xs (T,) f32, wt (N, K) int8, ws / bias / ls (N,) f32,
// res (T, N) f32 (mode 1 only) -> out (T, N): mode 0 f32, 1 f32 res + ls * y,
// 2 f32 tanh-GELU, 3 bf16. K must be a multiple of 16.
extern "C" int gp_qmm_gemm(const void* xq, const void* xs, const void* wt, const void* ws,
                           const void* bias, const void* res, const void* ls, void* out,
                           int T, int N, int K, int mode, void* stream) {
  if (T <= 0 || N <= 0 || K <= 0 || K % 16 || (T + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
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
  if (hd != 64) return (int)cudaErrorInvalidValue;
  return launch_attention<64>(qkv, key_bias, ctx, B, Np, H, scale, s);
}
