// Fused template matching for Hopper (sm_90a), bound with ctypes through a
// plain C entry point (gp_fused_match). Built by gigapose_tpu_torch/kernels/build.py.
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
// Bound on an H100 SXM: 2*B*V*P^2*C operations (696 GFLOP at the serving
// shape B=32, V=162, P=256, C=1024), 0.70 ms at the 989 TFLOP/s of the bf16
// tensor cores; the bytes (the labelled views of the store, the query, the
// outputs) need under 0.1 ms at 3.35 TB/s.
//
// bf16 store (the serving store): match_bf16_kernel. One CTA of two
// warpgroups per (detection, view), on a grid with the detection fastest,
// so the CTAs in flight share a few views and each (label, view) tile comes
// from HBM about once per batch, then from L2. The CTA walks the template
// patches in strips of 128 rows (64 per warpgroup). Each strip is a
// wgmma.mma_async m64n256k16 product per warpgroup (bf16 in, f32
// accumulate): A the warpgroup's 64 template rows, B all 256 query patches,
// both K-major in shared memory in the 128-byte swizzle that wgmma reads;
// the 64 x 256 f32 strip stays in registers (128 per thread). The channels
// stream in chunks of 64 through a 4-stage cp.async ring (16 KB of A and
// 32 KB of B per stage, zero-filled past P and C). A finished strip is
// masked and thresholded in registers, in the reference's order; row maxima
// come from a per-thread scan and a quad shuffle, column maxima from a
// reduce-scatter over the warp's 8 row groups and a shared-memory exchange
// across the 8 warps, folded into a running maximum per column. Every
// reduction compares (value, index) keys: the larger value wins and, on
// equal values, the smaller index, so the order of the reduction does not
// matter and ties keep the reference's first index. After thresholding
// every value is 0 or >= thr > 0, so the key is the float's bits above the
// complemented index, compared as an unsigned 64-bit integer; an all-zero
// column gives index 0, as the idx != 0 guards need. What bounds this
// design first is the query's re-reads from L2 (1 MB per CTA), not the
// tensor cores.
//
// f32 store: match_f32_kernel, the first version's design. Tensor cores do
// not keep full f32 inputs, so its 2*B*V*P^2*C FLOPs run as f32 FMAs on the
// CUDA cores (67 TFLOP/s peak: 10.4 ms at the serving shape). One CTA of 256
// threads per (view, detection) walks 64-row strips, each a 64 x 256 GEMM
// over 32-channel chunks staged as f32 in shared memory, thresholded into a
// shared strip buffer, then reduced by rows (warp shuffles) and by columns
// (running maxima that move only on a strictly greater value).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxP = 256;  // query columns (patches) a CTA holds

// --------------------------------------------------------------- f32 store

constexpr int kThreads = 256;  // one thread per query column in the reductions
constexpr int kStrip = 64;     // template rows per strip
constexpr int kChunk = 32;     // channels per shared-memory stage
constexpr int kPad = kChunk + 1;  // row stride: conflict-free column reads
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kStrip / kWarps;  // 8 strip rows per warp
constexpr int kCols = kMaxP / 32;       // 8 query columns per lane

constexpr size_t kSmemFloats =
    kStrip * kPad          // a: src strip chunk [row][c]
    + kMaxP * kPad         // b: query chunk [t][c]
    + kStrip * kMaxP       // strip: thresholded similarity [row][t]
    + 4 * kMaxP            // src_m, tar_m, score_s2t, idx_s2t
    + 2 * kWarps;          // block reduction
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

__global__ void __launch_bounds__(kThreads, 2) match_f32_kernel(
    const float* __restrict__ tar, const float* __restrict__ store,
    const float* __restrict__ tar_mask, const float* __restrict__ store_mask,
    const int* __restrict__ labels, float* __restrict__ sim_avg,
    int* __restrict__ idx_out, float* __restrict__ score_out,
    int* __restrict__ valid_out, int O, int V, int P, int C, float thr,
    int patch_thr, int num_patches) {
  extern __shared__ float smem[];
  float* a_s = smem;
  float* b_s = a_s + kStrip * kPad;
  float* strip = b_s + kMaxP * kPad;
  float* src_m = strip + kStrip * kMaxP;
  float* tar_m = src_m + kMaxP;
  float* s2t_score = tar_m + kMaxP;
  int* s2t_idx = reinterpret_cast<int*>(s2t_score + kMaxP);
  float* red = reinterpret_cast<float*>(s2t_idx + kMaxP);

  const int v = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // an out-of-range label reads the nearest object, as an XLA gather clamps
  const int label = min(max(labels[b], 0), O - 1);
  const size_t view = (size_t)label * V + v;
  const float* src = store + view * P * C;
  const float* tq = tar + (size_t)b * P * C;

  for (int i = tid; i < kMaxP; i += kThreads) {
    src_m[i] = i < P ? store_mask[view * P + i] : 0.f;
    tar_m[i] = i < P ? tar_mask[(size_t)b * P + i] : 0.f;
  }
  float col_max = -INFINITY;  // running max / first argmax of column t = tid
  int col_idx = 0;

  for (int s0 = 0; s0 < P; s0 += kStrip) {
    float acc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < C; c0 += kChunk) {
      for (int e = tid; e < kStrip * kChunk; e += kThreads) {
        const int r = e / kChunk, c = e % kChunk;
        const int s = s0 + r, cc = c0 + c;
        a_s[r * kPad + c] = (s < P && cc < C) ? src[(size_t)s * C + cc] : 0.f;
      }
      for (int e = tid; e < kMaxP * kChunk; e += kThreads) {
        const int t = e / kChunk, c = e % kChunk;
        const int cc = c0 + c;
        b_s[t * kPad + c] = (t < P && cc < C) ? tq[(size_t)t * C + cc] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kChunk; ++c) {
        float av[kRows], bv[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) av[i] = a_s[(warp * kRows + i) * kPad + c];
#pragma unroll
        for (int j = 0; j < kCols; ++j) bv[j] = b_s[(lane + 32 * j) * kPad + c];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // mask in the reference's order, threshold, park the strip in smem
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = warp * kRows + i;
      const float sm = src_m[s0 + r];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int t = lane + 32 * j;
        const float x = acc[i][j] * sm * tar_m[t];
        strip[r * kMaxP + t] = x < thr ? 0.f : x;
      }
    }
    __syncthreads();

    // rows: complete score_s2t / idx_s2t (first index on ties)
    for (int i = 0; i < kRows; ++i) {
      const int r = warp * kRows + i;
      float best = -INFINITY;
      int bi = 0;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int t = lane + 32 * j;
        if (t < P) {
          const float x = strip[r * kMaxP + t];
          if (x > best) { best = x; bi = t; }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
      }
      if (lane == 0 && s0 + r < P) {
        s2t_score[s0 + r] = best;
        s2t_idx[s0 + r] = bi;
      }
    }
    // columns: strictly greater only, rows in increasing s
    if (tid < P) {
      const int rows = min(kStrip, P - s0);
      for (int r = 0; r < rows; ++r) {
        const float x = strip[r * kMaxP + tid];
        if (x > col_max) { col_max = x; col_idx = s0 + r; }
      }
    }
    __syncthreads();
  }

  float contrib = 0.f;
  float count = 0.f;
  if (tid < P) {
    const int t = tid;
    const int j = col_idx;
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
    red[kWarps + warp] = count;
  }
  __syncthreads();
  if (tid == 0) {
    float total = 0.f, n = 0.f;
    for (int w = 0; w < kWarps; ++w) { total += red[w]; n += red[kWarps + w]; }
    sim_avg[(size_t)b * V + v] = n > 0.f ? total / (float)(num_patches * num_patches) : 0.f;
  }
}

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

}  // namespace

// dtype: 0 = float32 features (match_f32_kernel), 1 = bfloat16 features
// (match_bf16_kernel; C a multiple of 8, so that every row is 16-byte
// aligned). Masks are f32, labels int32, all arrays contiguous on the
// current device. Returns the CUDA error code of the launch (0 on success);
// the kernel runs asynchronously on `stream`.
extern "C" int gp_fused_match(const void* tar, const void* store,
                              const void* tar_mask, const void* store_mask,
                              const void* labels, void* sim_avg, void* idx,
                              void* score, void* valid, int B, int O, int V, int P,
                              int C, int dtype, float thr, int patch_thr,
                              int num_patches, void* stream) {
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
    err = cudaFuncSetAttribute(match_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    match_f32_kernel<<<dim3(V, B), kThreads, kSmemBytes, s>>>(
        static_cast<const float*>(tar), static_cast<const float*>(store), tm, sm, lab, avg,
        ix, sc, va, O, V, P, C, thr, patch_thr, num_patches);
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
