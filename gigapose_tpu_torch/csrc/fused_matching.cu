// Fused template matching for Hopper (sm_90a), bound with ctypes through
// plain C entry points (gp_fused_match, gp_split_tf32). Built by
// gigapose_tpu_torch/kernels/build.py.
//
// Replaces the TPU kernel gigapose_tpu/ops/pallas_matching.py:_match_kernel
// (launched by pallas_match_scores). Per (detection b, view v of object
// labels[b]) it computes what that kernel computes:
//
//   sim[s, t]  = <store[label, v, s], tar[b, t]>          (f32 accumulate)
//   sim        = sim * src_m[s] * tar_m[t]                  (this order)
//   simz       = sim < thr ? 0 : sim
//   score_t2s[t], idx_t2s[t] = max / first argmax over s   (per query patch)
//   score_s2t[s], idx_s2t[s] = max / first argmax over t   (per template patch)
//   valid[t]   = score_t2s[t] >= thr
//                & cycle: |loc(idx_s2t[idx_t2s[t]]) - loc(t)| <= patch_thr,
//                         score_s2t[idx_t2s[t]] >= thr     (when patch_thr > 0)
//                & tar_m[t] > 0 & src_m[idx_t2s[t]] > 0
//                & idx_s2t[t] != 0 & idx_t2s[t] != 0      (the reference's quirks)
//   sim_avg    = any(valid) ? sum(score_t2s * valid) / num_patches^2 : 0
//
// Both kernels run one CTA of two warpgroups per (detection, view), on a
// grid with the detection fastest, so the CTAs in flight share a few views
// and each (label, view) tile comes from HBM about once per batch, then from
// L2. The CTA walks the template patches in strips of 128 rows (64 per
// warpgroup); each strip is a wgmma product per warpgroup with A the
// warpgroup's 64 template rows and B all 256 query patches, K-major in
// shared memory in the 128-byte swizzle that wgmma reads; the 64 x 256 f32
// strip stays in registers (128 per thread). A finished strip is masked and
// thresholded in registers, in the reference's order; row maxima come from a
// per-thread scan and a quad shuffle, column maxima from a reduce-scatter
// over the warp's 8 row groups and a shared-memory exchange across the 8
// warps, folded into a running maximum per column. Every reduction compares
// (value, index) keys: the larger value wins and, on equal values, the
// smaller index, so the order of the reduction does not matter and ties keep
// the reference's first index. After thresholding every value is 0 or >= thr
// > 0, so the key is the float's bits above the complemented index, compared
// as an unsigned 64-bit integer; an all-zero column gives index 0, as the
// idx != 0 guards need.
//
// bf16 store (the serving store): match_bf16_kernel. Bound on an H100 SXM:
// 2*B*V*P^2*C operations (696 GFLOP at the serving shape B=32, V=162,
// P=256, C=1024), 0.70 ms at the 989 TFLOP/s of the bf16 tensor cores; the
// bytes (the labelled views of the store, the query, the outputs) need under
// 0.1 ms at 3.35 TB/s. Products are wgmma.mma_async m64n256k16 (bf16 in, f32
// accumulate); the channels stream in chunks of 64 through a 4-stage
// cp.async ring (16 KB of A and 32 KB of B per stage, zero-filled past P
// and C). What bounds this design first is the query's re-reads from L2
// (1 MB per CTA), not the tensor cores.
//
// f32 store: match_f32_kernel, on the tensor cores in TF32 with a
// three-product split ("3xTF32") that keeps f32-grade scores. Each f32
// operand is split as x = hi + lo with hi = tf32(x) (cvt.rna: the nearest
// value with 10 mantissa bits, ties away from zero) and lo = tf32(x - hi),
// where x - hi is exact in f32; then
//
//   <s, t> ~ hi_s . hi_t + hi_s . lo_t + lo_s . hi_t.
//
// Accuracy: |x - hi| <= 2^-11 |x| and |x - hi - lo| <= 2^-11 |x - hi| <=
// 2^-22 |x|. A product s_i t_i loses lo_s lo_t and the rounding of both
// lo's: at most about 3 * 2^-22 = 7e-7 of |s_i t_i|, and the tensor cores
// multiply tf32 values exactly. Both inputs are L2-normalized (the
// contract), so sum_i |s_i t_i| <= 1 (Cauchy-Schwarz) and a score moves by
// at most about 7e-7 before the f32 sums: the order of the sums' own
// rounding, which the kernel-against-plain tolerance (1e-4) already covers.
//
// The sums: wgmma's f32 accumulation does not round to nearest. Each
// product step errs by up to an ulp of the running sum, toward zero (as
// measured on an H100: over C = 1024 channels, 384 steps, a score near 1
// lost up to 1.1e-5 from sums started at 0). Each strip's sums therefore
// start at kAccStart = -0.5, taken off again in the epilogue: a score in
// [0, 1] then runs within [-0.5, 0.5], where the ulps are half those near
// 1 and the errors change sign half-way (2.8e-6 at the serving shape on the
// same card).
//
// Bound: the three products are 3 * 696 GFLOP at the serving shape, 4.22 ms
// at the 495 TFLOP/s of TF32 (the first version's scalar f32 FMAs could not
// go below 10.38 ms at the 67 TFLOP/s of the CUDA cores); the bytes need
// about 0.11 ms. The L2 reads come next: each CTA reads its view (1 MB)
// once and the query's hi and lo (2 MB) once per 128-row strip, 5 MB a CTA
// and 26 GB a launch at the serving shape. On an H100 the launch takes
// about 6.7 ms, the same with no products at all 5.3 ms and with one
// product a k-step 4.5 ms (scripts/match_f32_variants.py). Two-CTA clusters
// that multicast the query to two views of a detection brought the loads
// alone to 3.0 ms but left the launch where it was (6.86 ms, against 6.64
// without them in the same run), and so did a producer warp feeding 5
// stages of 16 channels with the products of one stage left running while
// the next is read (6.82 ms): neither is kept.
//
// Design: split_tf32_kernel writes the query's hi and lo once per launch
// into scratch (2, B, P, Cp), Cp = C rounded up to 4 with zeros, so that the
// V CTAs of a detection do not each split the same query. Per 32-channel
// stage (one 128-byte row of f32), TMA loads A (128 template rows of the
// view, f32), B_hi and B_lo (256 query rows each) into a 2-stage ring (80 KB
// a stage) on an mbarrier. The maps are 3-D, (C, P, O*V) for the store and
// (Cp, P, 2B) for the query, so that rows past P read as zeros and never as
// the next view's rows. wgmma takes a TF32 A operand from registers only in
// this form, so each thread reads its A fragment (4 values a k8 step) from
// shared memory and splits it there; every k8 step issues three
// wgmma.mma_async m64n256k8 tf32 (A from registers, B from shared memory).
// TMA needs 16-byte row strides: where C is not a multiple of 4, A comes
// through 4-byte cp.async copies with zero fill instead (the route is the
// wrapper's choice by shape, ops/fused_matching.py:match_f32_route). The
// strip epilogue and the final cycle check are match_bf16_kernel's.
// scripts/match_f32_variants.py times the kernel against copies of itself,
// some with the statements after a `// [cut <variants>]` marker removed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxP = 256;  // query columns (patches) a CTA holds

// -------------------------------------------------------------- bf16 store

constexpr int kWgThreads = 256;           // two warpgroups
constexpr int kWgWarps = kWgThreads / 32;
constexpr int kTileRows = 128;            // template rows per strip, 64 per warpgroup
constexpr int kTileC = 64;                // channels per stage: one 128-byte swizzle row
constexpr int kRing = 4;                  // stages
constexpr int kABytes = kTileRows * 128;  // 16 KB
constexpr int kBBytes = kMaxP * 128;      // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr size_t kWgSmem = 1024  // slack to align the ring to the swizzle's 1024 bytes
                           + (size_t)kRing * kStageBytes
                           + (size_t)kWgWarps * kMaxP * 8  // column partials
                           + 4 * kMaxP * 4                 // src_m, tar_m, score_s2t, idx_s2t
                           + 2 * kWgWarps * 4;             // block reduction

typedef unsigned long long u64;

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::smem_desc;  // K-major operand in the 128-byte swizzle

// d (64 x 256, f32) = [d +] A (64 x 16, bf16) . B^T (256 x 16, bf16)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], u64 da, u64 db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
        "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "r"(acc));
}

// (value >= 0, index) as one ordered key: larger value first, then smaller index
__device__ __forceinline__ u64 make_key(float x, int i) {
  return ((u64)__float_as_uint(x) << 32) | (u64)(0xffffffffu - (unsigned)i);
}
__device__ __forceinline__ u64 kmax(u64 a, u64 b) { return a > b ? a : b; }
__device__ __forceinline__ float key_value(u64 k) { return __uint_as_float((unsigned)(k >> 32)); }
__device__ __forceinline__ int key_index(u64 k) { return (int)(0xffffffffu - (unsigned)k); }

// one ring stage: template rows s0.. (A, 128 rows) and all query rows (B,
// 256 rows), channels c0..c0+63, as 128-byte rows whose 16-byte chunk ch
// lands at chunk ch ^ (row % 8); zero past P and C
__device__ __forceinline__ void load_stage(uint32_t stage, const __nv_bfloat16* src,
                                           const __nv_bfloat16* tq, int s0, int c0, int P,
                                           int C, int tid) {
#pragma unroll 4
  for (int i = tid; i < (kTileRows + kMaxP) * 8; i += kWgThreads) {
    const int r = i >> 3, ch = i & 7;
    const bool is_a = r < kTileRows;
    const int row = is_a ? s0 + r : r - kTileRows;
    const int cc = c0 + ch * 8;
    const bool ok = row < P && cc < C;
    const __nv_bfloat16* g = ok ? (is_a ? src : tq) + (size_t)row * C + cc : tq;
    cp_async16(stage + r * 128 + ((ch ^ (r & 7)) << 4), g, ok ? 16 : 0);
  }
}

// 16 column keys (8 n8 tiles x 2 columns) held by the 8 row groups of a
// warp -> each lane keeps the max over the warp of 2 of them (reduce-scatter
// over lane bits 4, 3, 2): afterwards k[0], k[1] are columns of n8 tile g.
// Each step keeps the half selected by the lane's bit and trades the other
// half with the partner lane, which keeps that one.
template <int kHalf, int kBit>
__device__ __forceinline__ void keep_half(u64 (&k)[16], int lane) {
  const bool hi = lane & kBit;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const u64 send = hi ? k[i] : k[i + kHalf];
    const u64 keep = hi ? k[i + kHalf] : k[i];
    k[i] = kmax(keep, __shfl_xor_sync(0xffffffffu, send, kBit));
  }
}
__device__ __forceinline__ void reduce_scatter_rows(u64 (&k)[16], int lane) {
  keep_half<8, 16>(k, lane);
  keep_half<4, 8>(k, lane);
  keep_half<2, 4>(k, lane);
}

__global__ void __launch_bounds__(kWgThreads, 1) match_bf16_kernel(
    const __nv_bfloat16* __restrict__ tar, const __nv_bfloat16* __restrict__ store,
    const float* __restrict__ tar_mask, const float* __restrict__ store_mask,
    const int* __restrict__ labels, float* __restrict__ sim_avg,
    int* __restrict__ idx_out, float* __restrict__ score_out,
    int* __restrict__ valid_out, int O, int V, int P, int C, float thr,
    int patch_thr, int num_patches) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* base = smem_raw + (ring - raw);
  u64* colpart = reinterpret_cast<u64*>(base + kRing * kStageBytes);  // [warp][t]
  float* src_m = reinterpret_cast<float*>(colpart + kWgWarps * kMaxP);
  float* tar_m = src_m + kMaxP;
  float* s2t_score = tar_m + kMaxP;
  int* s2t_idx = reinterpret_cast<int*>(s2t_score + kMaxP);
  float* red = reinterpret_cast<float*>(s2t_idx + kMaxP);

  const int b = blockIdx.x;  // the detection runs fastest
  const int v = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, g = lane >> 2, tig = lane & 3;
  const int label = min(max(labels[b], 0), O - 1);
  const size_t view = (size_t)label * V + v;
  const __nv_bfloat16* src = store + view * P * C;
  const __nv_bfloat16* tq = tar + (size_t)b * P * C;

  for (int i = tid; i < kMaxP; i += kWgThreads) {
    src_m[i] = i < P ? store_mask[view * P + i] : 0.f;
    tar_m[i] = i < P ? tar_mask[(size_t)b * P + i] : 0.f;
  }

  const int nchunks = (C + kTileC - 1) / kTileC;
  const int total = nchunks * ((P + kTileRows - 1) / kTileRows);
#pragma unroll
  for (int it = 0; it < kRing - 1; ++it) {
    if (it < total)
      load_stage(ring + it * kStageBytes, src, tq, it / nchunks * kTileRows,
                 it % nchunks * kTileC, P, C, tid);
    cp_async_commit();
  }

  u64 col_key = 0;  // running (max, first argmax) of column t = tid; below every real key
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int it = 0; it < total; ++it) {
    cp_async_wait<kRing - 2>();  // this thread's part of stage `it` has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();  // every part has; every wgmma of it - 1 is done
    const int nx = it + kRing - 1;
    if (nx < total)
      load_stage(ring + (nx % kRing) * kStageBytes, src, tq, nx / nchunks * kTileRows,
                 nx % nchunks * kTileC, P, C, tid);
    cp_async_commit();

    const int kc = it % nchunks;
    const uint32_t a_s = ring + (it % kRing) * kStageBytes + wg * (kABytes / 2);
    const uint32_t b_s = ring + (it % kRing) * kStageBytes + kABytes;
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kTileC / 16; ++k)  // 16 channels = 32 bytes per step
      wgmma_m64n256k16(acc, smem_desc(a_s + 32 * k), smem_desc(b_s + 32 * k),
                       (kc > 0 || k > 0) ? 1 : 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    if (kc != nchunks - 1) continue;

    // ---- the strip is complete: rows r0 and r0 + 8 of this thread, columns
    // 8j + 2 tig + {0, 1} in acc[4j + {0, 1}] (row r0) and acc[4j + {2, 3}]
    const int r0 = it / nchunks * kTileRows + wg * 64 + (warp & 3) * 16 + g;
    const float sm0 = src_m[r0], sm1 = src_m[r0 + 8];
    // a quarter of the n8 tiles at a time, so that each quarter's registers
    // die as it is done: mask in the reference's order and threshold; scan
    // the two rows; reduce each column over the thread's two rows, then over
    // the warp's 16, into the warp's slot of colpart
    u64 rk0 = 0, rk1 = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      u64 k[16];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * q + jj;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = 8 * j + 2 * tig + e;
          const float tm = tar_m[t];
          float x0 = acc[4 * j + e] * sm0 * tm;
          float x1 = acc[4 * j + 2 + e] * sm1 * tm;
          x0 = x0 < thr ? 0.f : x0;
          x1 = x1 < thr ? 0.f : x1;
          rk0 = kmax(rk0, make_key(x0, t));
          rk1 = kmax(rk1, make_key(x1, t));
          k[2 * jj + e] = kmax(make_key(x0, r0), make_key(x1, r0 + 8));
        }
      }
      reduce_scatter_rows(k, lane);
      const int t = (8 * q + g) * 8 + 2 * tig;
      colpart[warp * kMaxP + t] = k[0];
      colpart[warp * kMaxP + t + 1] = k[1];
    }
    // rows: the quad holds all 256 columns of rows r0 and r0 + 8
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      rk0 = kmax(rk0, __shfl_xor_sync(0xffffffffu, rk0, off));
      rk1 = kmax(rk1, __shfl_xor_sync(0xffffffffu, rk1, off));
    }
    if (tig == 0) {
      if (r0 < P) { s2t_score[r0] = key_value(rk0); s2t_idx[r0] = key_index(rk0); }
      if (r0 + 8 < P) { s2t_score[r0 + 8] = key_value(rk1); s2t_idx[r0 + 8] = key_index(rk1); }
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWgWarps; ++w) col_key = kmax(col_key, colpart[w * kMaxP + tid]);
    // colpart is written again only after the next iteration's __syncthreads
  }
  cp_async_wait<0>();
  __syncthreads();

  float contrib = 0.f;
  float count = 0.f;
  if (tid < P) {
    const int t = tid;
    const int j = key_index(col_key);
    const float col_max = key_value(col_key);
    bool ok = col_max >= thr;
    if (patch_thr > 0) {
      const int ic = s2t_idx[j];
      const float dx = (float)(ic % num_patches - t % num_patches);
      const float dy = (float)(ic / num_patches - t / num_patches);
      ok = ok && sqrtf(dx * dx + dy * dy) <= (float)patch_thr && s2t_score[j] >= thr;
    }
    ok = ok && tar_m[t] > 0.f && src_m[j] > 0.f && s2t_idx[t] != 0 && j != 0;
    const size_t o = ((size_t)b * V + v) * P + t;
    idx_out[o] = j;
    score_out[o] = col_max;
    valid_out[o] = ok ? 1 : 0;
    if (ok) { contrib = col_max; count = 1.f; }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    contrib += __shfl_xor_sync(0xffffffffu, contrib, off);
    count += __shfl_xor_sync(0xffffffffu, count, off);
  }
  if (lane == 0) {
    red[warp] = contrib;
    red[kWgWarps + warp] = count;
  }
  __syncthreads();
  if (tid == 0) {
    float total_s = 0.f, n = 0.f;
    for (int w = 0; w < kWgWarps; ++w) { total_s += red[w]; n += red[kWgWarps + w]; }
    sim_avg[(size_t)b * V + v] = n > 0.f ? total_s / (float)(num_patches * num_patches) : 0.f;
  }
}

// --------------------------------------------------------------- f32 store

constexpr int kF32C = 32;                    // channels per stage: one 128-byte row of f32
constexpr int kF32Ring = 2;                  // stages
constexpr int kF32ABytes = kTileRows * 128;  // 16 KB: 128 template rows
constexpr int kF32BBytes = kMaxP * 128;      // 32 KB: all query rows, hi or lo
constexpr int kF32StageBytes = kF32ABytes + 2 * kF32BBytes;
constexpr size_t kF32Smem = 1024  // slack to align the ring to the swizzle's 1024 bytes
                            + (size_t)kF32Ring * kF32StageBytes
                            + (size_t)kWgWarps * kMaxP * 8  // column partials
                            + 4 * kMaxP * 4                 // src_m, tar_m, score_s2t, idx_s2t
                            + 2 * kWgWarps * 4              // block reduction
                            + kF32Ring * 8;                 // one mbarrier a stage
// where each strip's sums start, and what the epilogue takes off again
// (the header says why)
constexpr float kAccStart = -0.5f;

// x rounded to tf32 (cvt.rna: nearest, ties away from zero), as f32 bits
// with the 13 low mantissa bits zero
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}
// x = hi + lo up to 2^-22 |x|: hi = tf32(x), lo = tf32(x - hi), x - hi exact
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// (rows, C) -> hi and lo (rows, Cp) each, one after the other in out;
// channels C..Cp-1 are zeros
__global__ void split_tf32_kernel(const float* __restrict__ x, float* __restrict__ out,
                                  int rows, int C, int Cp) {
  const size_t n = (size_t)rows * Cp;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % Cp);
    const float v = c < C ? x[i / Cp * C + c] : 0.f;
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    out[i] = __uint_as_float(hi);
    out[n + i] = __uint_as_float(lo);
  }
}

// d (64 x 256, f32) = [d +] A (64 x 8, tf32, registers) . B^T (256 x 8,
// tf32, K-major in shared memory). A's fragment: rows g and g + 8 of the
// warp's 16, columns tig and tig + 4 (a[0]: (g, tig), a[1]: (g + 8, tig),
// a[2]: (g, tig + 4), a[3]: (g + 8, tig + 4))
__device__ __forceinline__ void wgmma_tf32(float (&d)[128], const uint32_t (&a)[4], u64 db,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
      "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, "
      "%102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// element (row, c) of a tile of 32-float rows in the 128-byte swizzle: the
// 16-byte chunk c / 4 of row `row` lies at chunk (c / 4) ^ (row % 8)
__device__ __forceinline__ int swz_f32(int row, int c) {
  return row * 128 + (((c >> 2) ^ (row & 7)) << 4) + (c & 3) * 4;
}

// kTma: the template rows come through TMA (C a multiple of 4), else
// through 4-byte cp.async copies; the query's hi and lo always through TMA
template <bool kTma>
__global__ void __launch_bounds__(kWgThreads, 1) match_f32_kernel(
    const __grid_constant__ CUtensorMap map_src, const __grid_constant__ CUtensorMap map_tar,
    const float* __restrict__ store, const float* __restrict__ tar_mask,
    const float* __restrict__ store_mask, const int* __restrict__ labels,
    float* __restrict__ sim_avg, int* __restrict__ idx_out, float* __restrict__ score_out,
    int* __restrict__ valid_out, int B, int O, int V, int P, int C, float thr, int patch_thr,
    int num_patches) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* base = smem_raw + (ring - raw);
  u64* colpart = reinterpret_cast<u64*>(base + kF32Ring * kF32StageBytes);  // [warp][t]
  float* src_m = reinterpret_cast<float*>(colpart + kWgWarps * kMaxP);
  float* tar_m = src_m + kMaxP;
  float* s2t_score = tar_m + kMaxP;
  int* s2t_idx = reinterpret_cast<int*>(s2t_score + kMaxP);
  float* red = reinterpret_cast<float*>(s2t_idx + kMaxP);
  const uint32_t bars = static_cast<uint32_t>(__cvta_generic_to_shared(red + 2 * kWgWarps));
  auto full = [&](int s) { return bars + 8 * s; };  // the stage's bytes landed

  const int b = blockIdx.x;  // the detection runs fastest
  const int v = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, g = lane >> 2, tig = lane & 3;
  const int label = min(max(labels[b], 0), O - 1);
  const int view = label * V + v;
  const float* src = store + (size_t)view * P * C;

  for (int i = tid; i < kMaxP; i += kWgThreads) {
    src_m[i] = i < P ? store_mask[(size_t)view * P + i] : 0.f;
    tar_m[i] = i < P ? tar_mask[(size_t)b * P + i] : 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < kF32Ring; ++s) hopper::mbar_init(full(s), 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int nchunks = (C + kF32C - 1) / kF32C;
  const int total = nchunks * ((P + kTileRows - 1) / kTileRows);
  // the loads of iteration `it` (template rows it / nchunks * 128.., channels
  // it % nchunks * 32..) into stage it % kF32Ring; the cp.async route commits
  // one group a call
  auto issue = [&](int it) {
    const int s = it % kF32Ring;
    const uint32_t st = ring + s * kF32StageBytes;
    const int s0 = it / nchunks * kTileRows, c0 = it % nchunks * kF32C;
    if (tid == 0) {
      hopper::mbar_expect_tx(full(s), (kTma ? kF32ABytes : 0) + 2 * kF32BBytes);
      if (kTma) hopper::tma_load_3d(st, &map_src, full(s), c0, s0, view);
      hopper::tma_load_3d(st + kF32ABytes, &map_tar, full(s), c0, 0, b);               // hi
      hopper::tma_load_3d(st + kF32ABytes + kF32BBytes, &map_tar, full(s), c0, 0, B + b);  // lo
    }
    if (!kTma) {
      unsigned char* a_s = base + s * kF32StageBytes;
#pragma unroll 4
      for (int i = tid; i < kTileRows * kF32C; i += kWgThreads) {
        const int r = i / kF32C, c = i % kF32C;
        const bool ok = s0 + r < P && c0 + c < C;
        hopper::cp_async4(a_s + swz_f32(r, c), ok ? src + (size_t)(s0 + r) * C + c0 + c : src,
                          ok ? 4 : 0);
      }
      hopper::cp_async_commit();
    }
  };
  for (int it = 0; it < kF32Ring; ++it) {
    if (it < total) issue(it);
    else if (!kTma) hopper::cp_async_commit();  // one group per stage, as the waits count
  }

  u64 col_key = 0;  // running (max, first argmax) of column t = tid; below every real key
  float acc[128];
  const int ra = wg * 64 + (warp & 3) * 16 + g;  // this thread's A rows: ra, ra + 8

  for (int it = 0; it < total; ++it) {
    const int s = it % kF32Ring;
    if (!kTma) {
      hopper::cp_async_wait<kF32Ring - 1>();  // this thread's copies of stage `it` have landed
      __syncthreads();                        // every thread's have
    }
    hopper::mbar_wait(full(s), (it / kF32Ring) & 1);
    const unsigned char* a_s = base + s * kF32StageBytes;
    const uint32_t b_s = ring + s * kF32StageBytes + kF32ABytes;
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int k = 0; k < kF32C / 8; ++k) {
      const int c = 8 * k + tig;
      const float x[4] = {*reinterpret_cast<const float*>(a_s + swz_f32(ra, c)),
                          *reinterpret_cast<const float*>(a_s + swz_f32(ra + 8, c)),
                          *reinterpret_cast<const float*>(a_s + swz_f32(ra, c + 4)),
                          *reinterpret_cast<const float*>(a_s + swz_f32(ra + 8, c + 4))};
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(x[e], hi[k][e], lo[k][e]);
    }
    const int kc = it % nchunks;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = kAccStart;
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kF32C / 8; ++k) {  // 8 channels = 32 bytes per step
      const u64 dhi = smem_desc(b_s + 32 * k), dlo = smem_desc(b_s + kF32BBytes + 32 * k);
      // [cut no_mma]
      wgmma_tf32(acc, hi[k], dhi, 1);
      // [cut no_mma, no_lo]
      wgmma_tf32(acc, hi[k], dlo, 1);
      // [cut no_mma, no_lo]
      wgmma_tf32(acc, lo[k], dhi, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    __syncthreads();  // every read of stage s (A fragments, wgmma) is done
    if (it + kF32Ring < total)
      issue(it + kF32Ring);
    else if (!kTma)
      hopper::cp_async_commit();
    if (kc != nchunks - 1) continue;

    // ---- the strip is complete: match_bf16_kernel's epilogue. Rows r0 and
    // r0 + 8 of this thread, columns 8j + 2 tig + {0, 1} in acc[4j + {0, 1}]
    // (row r0) and acc[4j + {2, 3}] (row r0 + 8)
    const int r0 = it / nchunks * kTileRows + ra;
    const float sm0 = src_m[r0], sm1 = src_m[r0 + 8];
    u64 rk0 = 0, rk1 = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      u64 k[16];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * q + jj;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = 8 * j + 2 * tig + e;
          const float tm = tar_m[t];
          float x0 = (acc[4 * j + e] - kAccStart) * sm0 * tm;
          float x1 = (acc[4 * j + 2 + e] - kAccStart) * sm1 * tm;
          x0 = x0 < thr ? 0.f : x0;
          x1 = x1 < thr ? 0.f : x1;
          rk0 = kmax(rk0, make_key(x0, t));
          rk1 = kmax(rk1, make_key(x1, t));
          k[2 * jj + e] = kmax(make_key(x0, r0), make_key(x1, r0 + 8));
        }
      }
      reduce_scatter_rows(k, lane);
      const int t = (8 * q + g) * 8 + 2 * tig;
      colpart[warp * kMaxP + t] = k[0];
      colpart[warp * kMaxP + t + 1] = k[1];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      rk0 = kmax(rk0, __shfl_xor_sync(0xffffffffu, rk0, off));
      rk1 = kmax(rk1, __shfl_xor_sync(0xffffffffu, rk1, off));
    }
    if (tig == 0) {
      if (r0 < P) { s2t_score[r0] = key_value(rk0); s2t_idx[r0] = key_index(rk0); }
      if (r0 + 8 < P) { s2t_score[r0 + 8] = key_value(rk1); s2t_idx[r0 + 8] = key_index(rk1); }
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWgWarps; ++w) col_key = kmax(col_key, colpart[w * kMaxP + tid]);
    // colpart is written again only after the next strip's __syncthreads
  }
  if (!kTma) hopper::cp_async_wait<0>();
  __syncthreads();

  float contrib = 0.f;
  float count = 0.f;
  if (tid < P) {
    const int t = tid;
    const int j = key_index(col_key);
    const float col_max = key_value(col_key);
    bool ok = col_max >= thr;
    if (patch_thr > 0) {
      const int ic = s2t_idx[j];
      const float dx = (float)(ic % num_patches - t % num_patches);
      const float dy = (float)(ic / num_patches - t / num_patches);
      ok = ok && sqrtf(dx * dx + dy * dy) <= (float)patch_thr && s2t_score[j] >= thr;
    }
    ok = ok && tar_m[t] > 0.f && src_m[j] > 0.f && s2t_idx[t] != 0 && j != 0;
    const size_t o = ((size_t)b * V + v) * P + t;
    idx_out[o] = j;
    score_out[o] = col_max;
    valid_out[o] = ok ? 1 : 0;
    if (ok) { contrib = col_max; count = 1.f; }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    contrib += __shfl_xor_sync(0xffffffffu, contrib, off);
    count += __shfl_xor_sync(0xffffffffu, count, off);
  }
  if (lane == 0) {
    red[warp] = contrib;
    red[kWgWarps + warp] = count;
  }
  __syncthreads();
  if (tid == 0) {
    float total_s = 0.f, n = 0.f;
    for (int w = 0; w < kWgWarps; ++w) { total_s += red[w]; n += red[kWgWarps + w]; }
    sim_avg[(size_t)b * V + v] = n > 0.f ? total_s / (float)(num_patches * num_patches) : 0.f;
  }
}

template <bool kTma>
cudaError_t launch_f32(const CUtensorMap& map_src, const CUtensorMap& map_tar, const float* store,
                       const float* tm, const float* sm, const int* lab, float* avg, int* ix,
                       float* sc, int* va, int B, int O, int V, int P, int C, float thr,
                       int patch_thr, int num_patches, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      match_f32_kernel<kTma>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kF32Smem);
  if (err != cudaSuccess) return err;
  match_f32_kernel<kTma><<<dim3(B, V), kWgThreads, kF32Smem, s>>>(
      map_src, map_tar, store, tm, sm, lab, avg, ix, sc, va, B, O, V, P, C, thr, patch_thr,
      num_patches);
  return cudaSuccess;
}

}  // namespace

// x (rows, C) f32 -> out (2, rows, Cp) f32: tf32 hi, then lo, channels past
// C zero (Cp a multiple of 4, at least C). Returns the CUDA error code of the
// launch (0 on success); the kernel runs asynchronously on `stream`.
extern "C" int gp_split_tf32(const void* x, void* out, int rows, int C, int Cp, void* stream) {
  if (rows <= 0 || C <= 0 || Cp < C || Cp % 4) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)rows * Cp;
  const size_t blocks = (n + 255) / 256;
  split_tf32_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows, C, Cp);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32 features (match_f32_kernel: `split` holds the query's
// tf32 hi and lo as gp_split_tf32 writes them, rows of Cp; route 0 loads
// the template rows with TMA, which needs C a multiple of 4, route 1 with
// 4-byte cp.async copies), 1 = bfloat16 features (match_bf16_kernel; C a
// multiple of 8, so that every row is 16-byte aligned; split, Cp and route
// unused). Masks are f32, labels int32, all arrays contiguous on the
// current device. Returns the CUDA error code of the launch (0 on success);
// the kernel runs asynchronously on `stream`.
extern "C" int gp_fused_match(const void* tar, const void* store,
                              const void* tar_mask, const void* store_mask,
                              const void* labels, void* sim_avg, void* idx,
                              void* score, void* valid, int B, int O, int V, int P,
                              int C, int dtype, float thr, int patch_thr,
                              int num_patches, const void* split, int Cp, int route,
                              void* stream) {
  if (B <= 0 || O <= 0 || V <= 0 || P <= 0 || P > kMaxP || C <= 0 || B > 65535 || V > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tm = static_cast<const float*>(tar_mask);
  const float* sm = static_cast<const float*>(store_mask);
  const int* lab = static_cast<const int*>(labels);
  float* avg = static_cast<float*>(sim_avg);
  int* ix = static_cast<int*>(idx);
  float* sc = static_cast<float*>(score);
  int* va = static_cast<int*>(valid);
  cudaError_t err;
  if (dtype == 0) {
    if (split == nullptr || Cp < C || Cp % 4 || (route != 0 && route != 1) ||
        (route == 0 && C % 4))
      return (int)cudaErrorInvalidValue;
    const float* st = static_cast<const float*>(store);
    CUtensorMap map_src = {}, map_tar;  // encoded per launch (host only)
    if (!hopper::encode_rows_f32(&map_tar, split, Cp, P, 2 * B, kMaxP) ||
        (route == 0 && !hopper::encode_rows_f32(&map_src, st, C, P, O * V, kTileRows)))
      return (int)cudaErrorInvalidValue;
    err = route == 0 ? launch_f32<true>(map_src, map_tar, st, tm, sm, lab, avg, ix, sc, va, B, O,
                                        V, P, C, thr, patch_thr, num_patches, s)
                     : launch_f32<false>(map_src, map_tar, st, tm, sm, lab, avg, ix, sc, va, B,
                                         O, V, P, C, thr, patch_thr, num_patches, s);
    if (err != cudaSuccess) return (int)err;
  } else if (dtype == 1) {
    if (C % 8) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(match_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kWgSmem);
    if (err != cudaSuccess) return (int)err;
    match_bf16_kernel<<<dim3(B, V), kWgThreads, kWgSmem, s>>>(
        static_cast<const __nv_bfloat16*>(tar), static_cast<const __nv_bfloat16*>(store), tm,
        sm, lab, avg, ix, sc, va, O, V, P, C, thr, patch_thr, num_patches);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
