// W8A8 int8 serving kernels for Hopper (sm_90a), bound with ctypes through
// plain C entry points (gp_qmm_quant_rows, gp_qmm_gemm, gp_qmm_attention).
// Built by gigapose_tpu_torch/kernels/build.py, without --use_fast_math: the
// divisions (but for the attention's p, see there), square root, exp and
// tanh are the IEEE / accurate forms, and
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
//   0.1 ms on the int8 tensor cores (1,979 TOP/s dense); with their inputs
//   and outputs in device memory the bytes bound each at 23-44 us (3.35
//   TB/s). They issue warp-level mma.sync (m16n8k32 s8 -> s32) from
//   shared-memory tiles loaded with cp.async, a fraction of the wgmma rate;
//   wgmma / TMA tiles are the next redesign.
// - quant_rows: bytes only (one f32 row in, int8 row and scale out).
// - attention: bytes. Per block 50.5 MB of bf16 qkv in and 33.7 MB of f32
//   context out need 25 us; its 8.7 GFLOP need 9 us on the bf16 tensor
//   cores. So each head's K and V go into shared memory once, and the score
//   rows never leave registers.
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

// (lo, hi) -> bf16x2 with lo at the lower address, as an mma operand
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
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
  if (hd != kHD) return (int)cudaErrorInvalidValue;
  return launch_attention(qkv, key_bias, ctx, B, Np, H, scale, s);
}
