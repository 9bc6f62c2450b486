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
// What bounds it on an H100: the template store is read once per detection,
// B*V*P*C elements (at the serving shape B=32, V=162, P=256, C=1024 in bf16,
// 2.7 GB, under 1 ms at 3.35 TB/s; a label-grouped schedule would bring that
// to the O*V*P*C bytes of the store itself), against 2*B*V*P^2*C = 695 GFLOP.
// The FLOPs dominate. This first version runs them as f32 FMAs on the CUDA
// cores (67 TFLOP/s peak, so 10 ms at best), not on the tensor cores: it is
// the simple, exact design, and wgmma/TMA tiles are later work.
//
// Design. One CTA of 256 threads per (detection, view); the label is read
// from device memory (no scalar prefetch on the GPU). The 256 x 256 f32
// similarity tile (256 KB) does not fit the 227 KB a block may use, so the
// CTA walks the template patches in strips of 64 rows. Each strip is a
// 64 x 256 GEMM over channel chunks of 32 (both operands staged as f32 in
// shared memory, each thread owning an 8 x 8 register tile), thresholded
// into a shared strip buffer. A finished strip gives the complete
// score_s2t / idx_s2t of its rows (one warp per row, shuffle argmax) and
// updates each query column's running max / argmax. Strips run in
// increasing s and a running maximum moves only on a strictly greater
// value, so ties keep the first index: after thresholding most entries are
// exactly 0, and an all-zero column must give idx_t2s = 0 for the
// idx != 0 guards to match. The cycle gather idx_s2t[idx_t2s[t]] is a plain
// shared-memory read once all strips are done.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // one thread per query column in the reductions
constexpr int kStrip = 64;     // template rows per strip
constexpr int kMaxP = 256;     // query columns (patches) the CTA holds
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) match_kernel(
    const T* __restrict__ tar, const T* __restrict__ store,
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
  const T* src = store + view * P * C;
  const T* tq = tar + (size_t)b * P * C;

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
        a_s[r * kPad + c] = (s < P && cc < C) ? to_f32(src[(size_t)s * C + cc]) : 0.f;
      }
      for (int e = tid; e < kMaxP * kChunk; e += kThreads) {
        const int t = e / kChunk, c = e % kChunk;
        const int cc = c0 + c;
        b_s[t * kPad + c] = (t < P && cc < C) ? to_f32(tq[(size_t)t * C + cc]) : 0.f;
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

template <typename T>
int launch(const void* tar, const void* store, const void* tar_mask,
           const void* store_mask, const void* labels, void* sim_avg, void* idx,
           void* score, void* valid, int B, int O, int V, int P, int C, float thr,
           int patch_thr, int num_patches, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      match_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(V, B);
  match_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(tar), static_cast<const T*>(store),
      static_cast<const float*>(tar_mask), static_cast<const float*>(store_mask),
      static_cast<const int*>(labels), static_cast<float*>(sim_avg),
      static_cast<int*>(idx), static_cast<float*>(score), static_cast<int*>(valid),
      O, V, P, C, thr, patch_thr, num_patches);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 features, 1 = bfloat16 features. Masks are f32, labels
// int32, all arrays contiguous on the current device. Returns the CUDA error
// code of the launch (0 on success); the kernel runs asynchronously on `stream`.
extern "C" int gp_fused_match(const void* tar, const void* store,
                              const void* tar_mask, const void* store_mask,
                              const void* labels, void* sim_avg, void* idx,
                              void* score, void* valid, int B, int O, int V, int P,
                              int C, int dtype, float thr, int patch_thr,
                              int num_patches, void* stream) {
  if (B <= 0 || O <= 0 || V <= 0 || P <= 0 || P > kMaxP || C <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(tar, store, tar_mask, store_mask, labels, sim_avg, idx,
                         score, valid, B, O, V, P, C, thr, patch_thr, num_patches, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(tar, store, tar_mask, store_mask, labels, sim_avg,
                                 idx, score, valid, B, O, V, P, C, thr, patch_thr,
                                 num_patches, s);
  return (int)cudaErrorInvalidValue;
}
