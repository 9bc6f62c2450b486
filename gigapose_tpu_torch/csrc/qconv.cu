// Int8 convolutions of the int8 IST serving path for Hopper (sm_90a), bound
// with ctypes through plain C entry points (gp_qconv_act_scale,
// gp_qconv_quantize, gp_qconv_conv). Built by
// gigapose_tpu_torch/kernels/build.py with -fmad=false and without
// --use_fast_math: the quantization gives the codes of the IEEE quotient
// (quant1), and every product and sum of the epilogue is rounded on its
// own, in the plain version's order (ops/qconv.py).
//
// Replaces no Pallas kernel: the JAX package's int8 IST
// (gigapose_tpu/models/ist_int8.py:_qconv) is XLA code, an int8
// lax.conv_general_dilated with int32 accumulation (ist_int8.py:144-149)
// between elementwise scale, round and clip passes. PyTorch on CUDA has no
// int8 convolution, so the port brings its own:
//
// - act_absmax_kernel: the per-image activation scale of the dynamic scheme,
//   scale[b] = max(max |x[b]| / 127, 1e-12). A grid of (blocks per image,
//   images); each block reduces its slice with 16-byte loads and takes the
//   image's maximum with atomicMax on the bit pattern (non-negative floats
//   order as unsigned integers); the last block to finish (a counter after
//   a fence) turns the maxima into scales. Bytes bound it: x is read once.
// - quantize_kernel: f32 NHWC -> int8 NHWC, q = clip(rint(x / s), +-127)
//   with rint half to even of the IEEE quotient (quant1) and the per-image
//   scale (stride 1) or one static scale (stride 0); one image per grid
//   row, 16 bytes in and 4 bytes out a thread. Bytes bound it.
// - qconv_kernel<BN>: an implicit-GEMM convolution, out (M = B*OH*OW,
//   N = O) = im2col(xq) (M, K = KH*KW*C) . w^T with w the (O, K) int8
//   weight, K-contiguous, in the (kh, kw, c) order of an HWIO kernel. C must
//   be a multiple of 16 (the wrapper pads other C with zero codes, which add
//   nothing to an integer sum), so K is too.
//   Persistent clusters of two CTAs of 384 threads (as many as fit on the
//   card at once, one CTA per SM) walk pairs of adjacent 128 x BN output
//   tiles (two m-tiles, one n-tile), the N tile fastest. In each CTA a
//   producer warpgroup (56 registers, setmaxnreg) fills a ring of stages,
//   each one k-block of 128 int8 values of both operands:
//   * the weight tile (BN x 128): thread 0 loads half its rows by TMA and
//     multicasts them into both CTAs (the (O, K) weight is exactly a
//     K-major wgmma operand; tensor map encoded per launch, 128-byte
//     swizzle, zeros past O and K);
//   * the im2col tile (128 x 128), never through device memory, by one of
//     two routes chosen by the wrapper from the shape
//     (ops/qconv.py:im2col_route):
//     - TMA window (C a multiple of 128, and every 128-row tile a rows x
//       cols window of one image: 1 x 128, 2 x 64, 4 x 32, 8 x 16 at the
//       IST's shapes): the k-block is 128 channels of one tap, so thread 0
//       loads it as one box of a 4-D tensor map over the NHWC input (c, w,
//       h, b), the box the window with the conv stride as its traversal
//       stride, started at the tap's top-left input pixel; the box lands in
//       the 128-byte swizzle wgmma reads, and TMA fills the padding
//       (negative coordinates) and images past B with zeros.
//     - gather (any other shape: the stem's 3 channels padded to 16, the IST's
//       192-channel inputs, odd test shapes): all 128 producer threads copy
//       16-byte chunks with cp.async into the same swizzled layout. Each
//       chunk is 16 channels of one tap, so a k-block may straddle taps
//       (192 = 128 + 64) at no cost: each thread owns one chunk column of
//       the k-block, finds its (kh, kw, c) once per k-block and copies it
//       for 8 rows, whose image, top-left tap and validity it reads from a
//       per-tile row table in shared memory. Tiles may cross images and M
//       need not be a multiple of 128; copies outside the image, past M or
//       past K are zero-filled by the copy itself (src-size 0), and each
//       thread's copies complete on the stage's full barrier
//       (cp.async.mbarrier.arrive.noinc) beside the TMA bytes.
//   Two consumer warpgroups (224 registers) take 64 rows of the tile each
//   and multiply with wgmma.mma_async m64nBNk32 s8 -> s32, four per
//   k-block, the accumulator exact in int32 (at most 127^2 * 4608 = 7.4e7 <
//   2^31 at the IST's widest conv); each releases a stage in both CTAs once
//   its products on it are done.
//   N tiles, chosen by the wrapper from the shape (ops/qconv.py:n_tile):
//   BN = 128 (ring of 5 stages) for O <= 128 (the stem, stage 1), for the
//   out conv and other shapes; 192 (4 stages) for O <= 192 or a multiple of
//   192 (stage 2, no wasted columns); 256 (3 stages) for a multiple of 256
//   that still gives 96 tiles (stages 3-4).
//   The epilogue is fused and goes through shared memory in 64 x 32 chunks,
//   three buffers a warpgroup: exact int32 -> f32, acc * (sx * ws) + b, then
//   + residual and ReLU when asked, each step rounded on its own; the
//   residual is copied into the chunk with cp.async two chunks ahead, each
//   fragment's result written over it, the chunk stored with 16-byte
//   row-contiguous stores (element stores where O is not a multiple of 4).
//   With an output scale so (one static scale: the next conv's) it stores
//   int8 codes clip(rint(y / so), +-127) instead of f32, 4 bytes a store:
//   what quantize_kernel would make of the f32 output, a quarter of its
//   bytes, and no quantize launch.
//   What bounds it (PERF.md §6, from variants with parts cut out on
//   an H100): at the IST's shapes at B = 32 the function's bytes (f32
//   output, residual, int8 input) bound 11 of the 16 shapes, and the
//   products (1.25 T int8 operations for the 21 convs) need 0.63 ms at
//   1,979 TOP/s. The gather's reads took a third of l1's 3x3 (each input
//   pixel is read 9 times, from L2); the TMA window took that off. What
//   remains at l1 is the k-loop and the epilogue in turn (a ping-pong of
//   the two warpgroups did not help). In the int8 output quant4's warp
//   vote and its division cost more than the quantize launch they save at
//   the 32 x 32 and 16 x 16 shapes (the next step there).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::u64;

constexpr int kThreads = 256;  // act_absmax, quantize

// ------------------------------------------------------------ act_absmax

__global__ void __launch_bounds__(kThreads)
act_absmax_kernel(const float* __restrict__ x, unsigned* __restrict__ bits,
                  float* __restrict__ scale, int B, long long E) {
  const float* xb = x + (long long)blockIdx.y * E;
  const long long stride = (long long)gridDim.x * blockDim.x;
  float m = 0.f;
  if ((E & 3) == 0) {
    const float4* v = reinterpret_cast<const float4*>(xb);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < (E >> 2);
         i += stride) {
      float4 f = v[i];
      m = fmaxf(m, fmaxf(fmaxf(fabsf(f.x), fabsf(f.y)), fmaxf(fabsf(f.z), fabsf(f.w))));
    }
  } else {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < E; i += stride)
      m = fmaxf(m, fabsf(xb[i]));
  }
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[kThreads / 32];
  __shared__ bool last;
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(&bits[blockIdx.y], __float_as_uint(m));
    __threadfence();
    unsigned ticket = atomicAdd(&bits[B], 1u);
    last = ticket == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      float a = __uint_as_float(atomicOr(&bits[b], 0u));
      scale[b] = fmaxf(__fdiv_rn(a, 127.f), 1e-12f);
    }
  }
}

// ------------------------------------------------------------ quantize

// clip(rint(v / s), +-127) with the IEEE quotient, given r = quant_rcp(s).
// The division costs about 40 instructions, and its slow path (which a zero
// takes) hundreds, so t = v * r decides where it may: while r is a normal
// float, t is within 1.5 * 2^-23 |t| of v / s and of its correctly rounded
// quotient, at most 2.3e-5 for |t| <= 129; so where t lies farther than
// 2^-12 from the midpoint between two integers both round to rint(t), and
// beyond 129 both clip. Only near a midpoint (about 1 code in 2,000), for a
// NaN t or r is the quotient computed (quant_div).
__device__ __forceinline__ int quant_mul(float v, float r, bool& decided) {
  const float t = __fmul_rn(v, r);
  const float q = rintf(t);
  // |t - q| is exact: t and its nearest integer lie within a factor 2
  decided = fabsf(__fsub_rn(t, q)) < 0.499755859375f || fabsf(t) > 129.f;
  return (int)fminf(fmaxf(q, -127.f), 127.f);
}
__device__ __forceinline__ int quant_div(float v, float s) {
  return max(-127, min(127, __float2int_rn(__fdiv_rn(v, s))));
}
__device__ __forceinline__ signed char quant1(float v, float s, float r) {
  bool decided;
  int c = quant_mul(v, r, decided);
  if (__builtin_expect(!decided, 0)) c = quant_div(v, s);  // a branch: never speculated
  return (signed char)c;
}

// the reciprocal quant1 takes: NaN (always divide) where the product may
// not decide: s not positive and finite, or 1 / s subnormal or infinite
__device__ __forceinline__ float quant_rcp(float s) {
  const float r = __frcp_rn(s);
  return s > 0.f && r >= 1.17549435e-38f && r < INFINITY ? r : __int_as_float(0x7fc00000);
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, const float* __restrict__ sx, int sx_stride,
                int8_t* __restrict__ q, long long E) {
  // one image per grid row: its scale is read once, no index division
  const long long off = (long long)blockIdx.y * E;
  const float s = sx[blockIdx.y * sx_stride], r = quant_rcp(s);
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if ((E & 3) == 0) {  // 4 elements a thread: 16 bytes in, 4 out
    const float4* v = reinterpret_cast<const float4*>(x + off);
    char4* o = reinterpret_cast<char4*>(q + off);
    for (; i < (E >> 2); i += stride) {
      float4 f = v[i];
      o[i] = make_char4(quant1(f.x, s, r), quant1(f.y, s, r), quant1(f.z, s, r),
                        quant1(f.w, s, r));
    }
  } else {
    for (; i < E; i += stride) q[off + i] = quant1(x[off + i], s, r);
  }
}

// ------------------------------------------------------------ qconv

struct ConvShape {
  int B, H, W, C, OH, OW, N, KS, stride, pad, K, M;
  int win_cols;  // > 0: the im2col tile is a window of this many columns, loaded by TMA
};

constexpr int kConvThreads = 384;  // two consumer warpgroups and a producer warpgroup
constexpr int kBM = 128;           // output rows (pixels) per tile: 64 per consumer warpgroup
constexpr int kBK = 128;           // int8 values per k-block: one 128-byte swizzle row
constexpr int kABytes = kBM * kBK;  // the im2col tile of a stage: 16 KB
constexpr int kEpiCols = 32;        // columns per epilogue chunk
constexpr int kEpiLd = kEpiCols + 8;     // chunk row stride in floats: conflict-free
constexpr int kEpiFloats = 64 * kEpiLd;  // one 64-row chunk buffer: 10 KB
constexpr int kEpiBufs = 3;              // per warpgroup: the residual two chunks ahead
constexpr int kBarEpi = 1;               // named barriers 1, 2: one consumer warpgroup
constexpr int kBarProd = 3;              // 3: the producer warpgroup
constexpr int kFullArrivals = 129;       // 128 producer threads' copies + the TMA's arrival
constexpr int kCluster = 2;  // CTAs on adjacent m-tiles, sharing the weight tile
constexpr int kMaxSmem = 232448;         // what a block may use (227 KB)

template <int BN>
struct Tile {
  static constexpr int kStages = BN == 128 ? 5 : BN == 192 ? 4 : 3;
  static constexpr int kBBytes = BN * kBK;  // the weight tile of a stage
  static constexpr int kBSlice = BN / kCluster;  // its rows each CTA loads for the cluster
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  // ring | chunk buffers | ws, bias per warpgroup | row table | barriers
  static constexpr int kEpiOff = kRingBytes;
  static constexpr int kVecOff = kEpiOff + 2 * kEpiBufs * kEpiFloats * 4;
  static constexpr int kRowOff = kVecOff + 2 * 2 * BN * 4;
  static constexpr int kBarOff = kRowOff + kBM * 16;
  static constexpr int kSmem = 1024 + kBarOff + 2 * kStages * 8;  // 1024: aligning the ring
  static_assert(kSmem <= kMaxSmem, "the ring does not fit in shared memory");
  static_assert(kStageBytes % 1024 == 0 && kBSlice * kBK % 1024 == 0,
                "stages and slices must keep the swizzle's 1024-byte alignment");
};

// the stage's full barrier gets one arrival once this thread's earlier
// copies have landed (counted in kFullArrivals: noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar) : "memory");
}
// the copies' generic-proxy writes, seen after the full barrier, ordered
// before this thread's wgmma (async-proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// starts copying rows r0.. r0 + 63, columns c0.. c0 + 31 of the (M, N)
// residual into a chunk buffer (wt: the thread in its warpgroup), 16 bytes
// a copy where `vec`, zeros past M and N
__device__ __forceinline__ void chunk_in(float* buf, const float* __restrict__ res, int r0,
                                         int c0, int M, int N, bool vec, int wt) {
  if (vec) {
    #pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int q = wt + 128 * p, lr = q >> 3, lc = (q & 7) * 4;
      const int row = r0 + lr, col = c0 + lc;
      const bool ok = row < M && col < N;
      cp_async16(buf + lr * kEpiLd + lc, ok ? res + (size_t)row * N + col : res, ok ? 16 : 0);
    }
  } else {
    #pragma unroll 4
    for (int p = 0; p < 16; ++p) {
      const int q = wt + 128 * p, lr = q >> 5, lc = q & 31;
      const int row = r0 + lr, col = c0 + lc;
      const bool ok = row < M && col < N;
      cp_async4(buf + lr * kEpiLd + lc, ok ? res + (size_t)row * N + col : res, ok ? 4 : 0);
    }
  }
  cp_async_commit();
}

// four f32 values -> their int8 codes under (so, ro), packed: the product
// decides (quant_mul), and where it does not for some thread the warp takes
// the division together, one uniform branch instead of one per value
__device__ __forceinline__ unsigned quant4(float4 v, float so, float ro) {
  bool d0, d1, d2, d3;
  int c0 = quant_mul(v.x, ro, d0), c1 = quant_mul(v.y, ro, d1);
  int c2 = quant_mul(v.z, ro, d2), c3 = quant_mul(v.w, ro, d3);
  // [cut no_vote] (scripts/qconv_variants.py)
  if (__builtin_expect(!__all_sync(0xffffffffu, d0 && d1 && d2 && d3), 0)) {
    if (!d0) c0 = quant_div(v.x, so);
    if (!d1) c1 = quant_div(v.y, so);
    if (!d2) c2 = quant_div(v.z, so);
    if (!d3) c3 = quant_div(v.w, so);
  }
  return (c0 & 0xff) | (c1 & 0xff) << 8 | (c2 & 0xff) << 16 | (unsigned)(c3 & 0xff) << 24;
}

// a chunk buffer to rows r0.., columns c0.. of the (M, N) output: f32, or
// int8 codes under the output scale (so, ro) where q8; 16-byte (f32) or
// 4-byte (int8) row-contiguous stores where `vec`. Every thread of the
// warp runs each round (quant4 votes).
__device__ __forceinline__ void chunk_out(void* out, const float* buf, int r0, int c0, int M,
                                          int N, bool vec, bool q8, float so, float ro, int wt) {
  if (vec) {
    #pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int q = wt + 128 * p, lr = q >> 3, lc = (q & 7) * 4;
      const int row = r0 + lr, col = c0 + lc;
      const bool in = row < M && col < N;
      const float4 v = *reinterpret_cast<const float4*>(buf + lr * kEpiLd + lc);
      const size_t o = (size_t)row * N + col;
      if (q8) {
        const unsigned codes = quant4(v, so, ro);
        if (in) *reinterpret_cast<unsigned*>(static_cast<int8_t*>(out) + o) = codes;
      } else if (in) {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = v;
      }
    }
  } else {
    #pragma unroll 4
    for (int p = 0; p < 16; ++p) {
      const int q = wt + 128 * p, lr = q >> 5, lc = q & 31;
      const int row = r0 + lr, col = c0 + lc;
      if (row >= M || col >= N) continue;
      const float v = buf[lr * kEpiLd + lc];
      const size_t o = (size_t)row * N + col;
      if (q8)
        static_cast<int8_t*>(out)[o] = quant1(v, so, ro);
      else
        static_cast<float*>(out)[o] = v;
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kConvThreads, 1) qconv_kernel(
    const __grid_constant__ CUtensorMap map_w, const __grid_constant__ CUtensorMap map_x,
    const int8_t* __restrict__ x,
    const float* __restrict__ sx, int sx_stride, const float* __restrict__ ws,
    const float* __restrict__ bias, const float* __restrict__ res, void* __restrict__ out,
    const float* __restrict__ out_scale, ConvShape s, int relu, int vec) {
  using T = Tile<BN>;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* base = smem_raw + (ring - raw);
  float* epi_all = reinterpret_cast<float*>(base + T::kEpiOff);
  float* vec_all = reinterpret_cast<float*>(base + T::kVecOff);
  int4* rows = reinterpret_cast<int4*>(base + T::kRowOff);
  const uint32_t bars = ring + T::kBarOff;
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (S + i); };

  const int tid = threadIdx.x, warp = tid >> 5;
  const unsigned rank = hopper::cluster_rank();
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;
  // the cluster walks groups of kCluster adjacent m-tiles (one n-tile), n
  // fastest; CTA r takes m-tile kCluster mg + r (past M: its rows are
  // zeros and it stores nothing, but it still loads its weight slice)
  const int tiles_n = (s.N + BN - 1) / BN;
  const int groups = ((s.M + kBM - 1) / kBM + kCluster - 1) / kCluster * tiles_n;
  const int ktiles = (s.K + kBK - 1) / kBK;
  auto tile_m0 = [&](int grp) { return (grp / tiles_n * kCluster + (int)rank) * kBM; };

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      hopper::mbar_init(full(i), s.win_cols > 0 ? 1 : kFullArrivals);
      hopper::mbar_init(empty(i), 2 * kCluster);  // each consumer warpgroup of each CTA
    }
    hopper::mbar_init_fence();
  }
  hopper::cluster_sync();  // every CTA's barriers exist before any copies or arrives

  if (warp >= 8) {  // ------------------------------------------ producer
    hopper::setmaxnreg_dec<56>();
    const int pt = tid - 256;
    const bool window = s.win_cols > 0;
    if (window && pt != 0) return;  // one thread issues the TMA loads of both operands
    const int chunk = pt & 7, r0 = pt >> 3;  // this thread's chunk column and first row
    const int per_image = s.OH * s.OW;
    int it = 0;  // k-blocks issued, over all of this CTA's tiles
    for (int grp = cluster; grp < groups; grp += clusters) {
      const int m0 = tile_m0(grp), n0 = grp % tiles_n * BN;
      // the window's image and its top-left tap (past M: an image past B, all zeros)
      const int wb = m0 / per_image, wrem = m0 - wb * per_image;
      const int wy = wrem / s.OW * s.stride - s.pad, wx = wrem % s.OW * s.stride - s.pad;
      if (!window) {
        hopper::bar_sync(kBarProd, 128);  // every producer thread is done with the last table
        // row pt of the tile: its image's first byte plus its top-left tap's offset
        const int m = m0 + pt;
        int4 e = make_int4(0, -0x40000000, 0, 0);  // past M: never inside the image
        if (m < s.M) {
          const int b = m / per_image, rem = m - b * per_image;
          const int oh = rem / s.OW, ow = rem - oh * s.OW;
          const int ih0 = oh * s.stride - s.pad, iw0 = ow * s.stride - s.pad;
          e = make_int4(b * s.H * s.W * s.C + (ih0 * s.W + iw0) * s.C, ih0, iw0, 0);
        }
        rows[pt] = e;
        hopper::bar_sync(kBarProd, 128);
      }
      for (int kb = 0; kb < ktiles; ++kb, ++it) {
        const int st = it % S;
        // stage st is free in every CTA: this CTA's weight slice goes to all
        hopper::mbar_wait(empty(st), ((it / S) & 1) ^ 1);
        const uint32_t a_s = ring + st * T::kStageBytes;
        if (pt == 0) {
          hopper::mbar_expect_tx(full(st), T::kBBytes + (window ? kABytes : 0));
          hopper::tma_load_2d_multicast(a_s + kABytes + rank * T::kBSlice * kBK, &map_w, full(st),
                                        kb * kBK, n0 + (int)rank * T::kBSlice,
                                        (1u << kCluster) - 1);
        }
        if (window) {  // C is a multiple of 128: the k-block is 128 channels of one tap
          const int tap = kb * kBK / s.C, kh = tap / s.KS;
          hopper::tma_load_4d(a_s, &map_x, full(st), kb * kBK - tap * s.C, wx + tap - kh * s.KS,
                              wy + kh, wb);
          continue;
        }
        // this thread's 16 channels: one tap (kh, kw), channels ci.. ci + 15
        const int k = kb * kBK + chunk * 16;
        const bool kin = k < s.K;
        const int tap = kin ? k / s.C : 0;
        const int ci = k - tap * s.C;
        const int kh = tap / s.KS, kw = tap - kh * s.KS;
        const int koff = (kh * s.W + kw) * s.C + ci;
        #pragma unroll 2
        for (int i = 0; i < 8; ++i) {
          const int r = r0 + 16 * i;
          const int4 e = rows[r];
          const int ih = e.y + kh, iw = e.z + kw;
          const bool ok = kin && (unsigned)ih < (unsigned)s.H && (unsigned)iw < (unsigned)s.W;
          // [cut no_gather, zfill] (scripts/qconv_variants.py)
          cp_async16(a_s + r * kBK + ((chunk ^ (r & 7)) << 4), ok ? x + (e.x + koff) : x,
                     ok ? 16 : 0);
        }
        cp_async_arrive(full(st));
      }
    }
    // stay until every CTA's consumers have released every stage: their
    // last arrivals land in this CTA's shared memory
    for (int k = 0; k < S; ++k, ++it) hopper::mbar_wait(empty(it % S), ((it / S) & 1) ^ 1);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ------------------------------------------------------------- consumers
  hopper::setmaxnreg_inc<224>();
  const int lane = tid & 31, wg = warp >> 2, wt = tid & 127, ww = warp & 3;
  const int g = lane >> 2, tig = lane & 3;
  float* bufs = epi_all + wg * kEpiBufs * kEpiFloats;  // chunk q goes to buffer q % 3
  float* v_ws = vec_all + wg * 2 * BN;
  float* v_b = v_ws + BN;
  const int per_image = s.OH * s.OW;
  const bool has_res = res != nullptr, q8 = out_scale != nullptr;
  const float so = q8 ? *out_scale : 0.f, ro = quant_rcp(so);
  constexpr int kChunks = BN / kEpiCols;
  int acc[BN / 2] = {};
  int it = 0;  // k-blocks consumed, as the producer counts them
  for (int grp = cluster; grp < groups; grp += clusters) {
    const int m0 = tile_m0(grp) + 64 * wg, n0 = grp % tiles_n * BN;  // this warpgroup's rows
    // the last tile's chunks are computed and being stored: the column
    // vectors and the first two buffers are free
    hopper::bar_sync(kBarEpi + wg, 128);
    for (int c = wt; c < BN; c += 128) {
      const int col = n0 + c;
      v_ws[c] = col < s.N ? ws[col] : 0.f;
      v_b[c] = col < s.N ? bias[col] : 0.f;
    }
    if (has_res) {  // the residual's first two chunks land during the k-loop
      chunk_in(bufs, res, m0, n0, s.M, s.N, vec, wt);
      chunk_in(bufs + kEpiFloats, res, m0, n0 + kEpiCols, s.M, s.N, vec, wt);
    }
    for (int kb = 0; kb < ktiles; ++kb, ++it) {
      const int st = it % S;
      hopper::mbar_wait(full(st), (it / S) & 1);
      fence_proxy_async();
      const uint32_t a_s = ring + st * T::kStageBytes + wg * (kABytes / 2);
      const uint32_t b_s = ring + st * T::kStageBytes + kABytes;
      hopper::wgmma_fence();
      #pragma unroll
      for (int k = 0; k < kBK / 32; ++k)  // 32 int8 = 32 bytes per step
        // [cut no_mma] (scripts/qconv_variants.py)
        hopper::wgmma_s8(acc, hopper::smem_desc(a_s + 32 * k), hopper::smem_desc(b_s + 32 * k),
                         kb > 0 || k > 0);
      hopper::wgmma_commit();
      if (kb > 0) {  // the previous k-block's products are done: free its stage everywhere
        hopper::wgmma_wait<1>();
        if (wt == 0)
          for (unsigned c = 0; c < kCluster; ++c)
            hopper::mbar_arrive_cluster(empty((it - 1) % S), c);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_acc(acc);
    if (wt == 0)
      for (unsigned c = 0; c < kCluster; ++c) hopper::mbar_arrive_cluster(empty((it - 1) % S), c);

    // epilogue: acc * (sx * ws) + b [+ residual] [relu] [-> int8], each step rounded
    hopper::bar_sync(kBarEpi + wg, 128);  // the column vectors are in place
    float xr[2];  // sx of rows 16 ww + g + 8 r
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 16 * ww + g + 8 * r;
      xr[r] = row < s.M ? sx[(row / per_image) * sx_stride] : 0.f;
    }
    #pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      float* buf = bufs + q % kEpiBufs * kEpiFloats;
      if (has_res) {
        if (q + 1 < kChunks)  // this thread's part of chunk q (q + 1 may be in flight)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
        hopper::bar_sync(kBarEpi + wg, 128);  // everyone's; chunk q - 1 is stored
        if (q + 2 < kChunks)
          chunk_in(bufs + (q + 2) % kEpiBufs * kEpiFloats, res, m0, n0 + (q + 2) * kEpiCols,
                   s.M, s.N, vec, wt);
      }
      #pragma unroll
      for (int jj = 0; jj < kEpiCols / 8; ++jj) {
        const int j = q * (kEpiCols / 8) + jj;  // n8 block of the accumulator
        const int lc = 8 * jj + 2 * tig, tc = q * kEpiCols + lc;
        const float2 w2 = *reinterpret_cast<const float2*>(v_ws + tc);
        const float2 b2 = *reinterpret_cast<const float2*>(v_b + tc);
        #pragma unroll
        for (int r = 0; r < 2; ++r) {
          float* e = buf + (16 * ww + g + 8 * r) * kEpiLd + lc;
          float y0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * r]), __fmul_rn(xr[r], w2.x));
          float y1 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * r + 1]), __fmul_rn(xr[r], w2.y));
          y0 = __fadd_rn(y0, b2.x);
          y1 = __fadd_rn(y1, b2.y);
          if (has_res) {
            y0 = __fadd_rn(y0, e[0]);
            y1 = __fadd_rn(y1, e[1]);
          }
          if (relu) {
            y0 = y0 > 0.f ? y0 : 0.f;
            y1 = y1 > 0.f ? y1 : 0.f;
          }
          *reinterpret_cast<float2*>(e) = make_float2(y0, y1);
        }
      }
      // chunk q is complete, and every thread has stored chunk q - 1: the
      // buffers that chunks q + 1 and q + 2 fill are free
      hopper::bar_sync(kBarEpi + wg, 128);
      // [cut no_epi] (scripts/qconv_variants.py)
      chunk_out(out, buf, m0, n0 + q * kEpiCols, s.M, s.N, vec, q8, so, ro, wt);
    }
  }
}

// the int8 NHWC input as a 4-D tensor map (c, w, h, b) whose box is one
// k-block of the im2col tile: 128 channels of a rows x cols window of
// output pixels, every stride-th input column and row (the traversal
// stride), in the 128-byte swizzle; zeros outside the input (the padding,
// negative coordinates, images past B)
bool encode_window(CUtensorMap* map, const void* x, const ConvShape& s) {
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return false;
  const int rows = kBM / s.win_cols;
  const cuuint64_t dims[4] = {(cuuint64_t)s.C, (cuuint64_t)s.W, (cuuint64_t)s.H, (cuuint64_t)s.B};
  const cuuint64_t strides[3] = {(cuuint64_t)s.C, (cuuint64_t)s.W * s.C,
                                 (cuuint64_t)s.H * s.W * s.C};
  const cuuint32_t box[4] = {(cuuint32_t)kBK, (cuuint32_t)(s.win_cols * s.stride),
                             (cuuint32_t)(rows * s.stride), 1u};
  const cuuint32_t step[4] = {1u, (cuuint32_t)s.stride, (cuuint32_t)s.stride, 1u};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch_conv(const ConvShape& s, const void* x, const void* sx, int sx_stride, const void* w,
                const void* ws, const void* bias, const void* res, void* out,
                const void* out_scale, int relu, cudaStream_t stream) {
  static int resident_cache[hopper::kMaxDevices] = {};
  const int resident = hopper::resident_clusters(qconv_kernel<BN>, resident_cache, kCluster,
                                                 kConvThreads, Tile<BN>::kSmem);
  if (resident < 0) return -resident;
  CUtensorMap map_w, map_x = {};
  if (!hopper::encode_kmajor_s8(&map_w, w, s.N, s.K, Tile<BN>::kBSlice) ||
      (s.win_cols > 0 && !encode_window(&map_x, x, s)))
    return (int)cudaErrorInvalidValue;
  const long long groups = (long long)(((s.M + kBM - 1) / kBM + kCluster - 1) / kCluster) *
                           ((s.N + BN - 1) / BN);
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = s.N % 4 == 0 && aligned(out) && (res == nullptr || aligned(res));
  cudaLaunchAttribute cluster;
  cudaLaunchConfig_t cfg =
      hopper::cluster_config(&cluster, kCluster, kConvThreads, Tile<BN>::kSmem, stream);
  cfg.gridDim = dim3((unsigned)(groups < resident ? groups : resident) * kCluster);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, qconv_kernel<BN>, map_w, map_x, static_cast<const int8_t*>(x),
      static_cast<const float*>(sx),
      sx_stride, static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<const float*>(res), out, static_cast<const float*>(out_scale), s, relu, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, E) f32 (E = H*W*C), scratch: B + 1 unsigned, scale: (B,) f32.
extern "C" int gp_qconv_act_scale(const void* x, void* scratch, void* scale, int B,
                                  long long E, void* stream) {
  if (B <= 0 || B > 65535 || E <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(unsigned) * (B + 1), st);
  if (err != cudaSuccess) return (int)err;
  // about 16 vectors a thread, at most 512 blocks an image
  long long per_block = (long long)kThreads * 64;
  long long nb = (E + per_block - 1) / per_block;
  dim3 grid((unsigned)(nb < 1 ? 1 : (nb > 512 ? 512 : nb)), B);
  act_absmax_kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(x),
                                               static_cast<unsigned*>(scratch),
                                               static_cast<float*>(scale), B, E);
  return (int)cudaGetLastError();
}

// x: (B, E) f32 -> q: (B, E) int8 with scale sx[b * sx_stride].
extern "C" int gp_qconv_quantize(const void* x, const void* sx, int sx_stride, void* q, int B,
                                 long long E, void* stream) {
  if (B <= 0 || B > 65535 || E <= 0 || (sx_stride != 0 && sx_stride != 1))
    return (int)cudaErrorInvalidValue;
  // about 4 vectors a thread, spread over the images
  long long per_image = (E & 3) == 0 ? E >> 2 : E;
  long long nb = (per_image + kThreads * 4 - 1) / (kThreads * 4);
  dim3 grid((unsigned)(nb > 4096 ? 4096 : nb), B);
  quantize_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(sx), sx_stride,
      static_cast<int8_t*>(q), E);
  return (int)cudaGetLastError();
}

// x: (B, H, W, C) int8 with C a multiple of 16, w: (N, KS*KS*C) int8, both
// 16-byte aligned (TMA and the 16-byte gathers), ws / bias: (N,) f32, res:
// (B, OH, OW, N) f32 or null, out_scale: one f32 or null -> out (B, OH, OW,
// N): f32, or int8 codes clip(rint(y / out_scale), +-127) where out_scale
// is given. bn: the N tile, 128, 192 or 256 (ops/qconv.py:n_tile);
// win_cols: 0 gathers the im2col tile with cp.async, else the TMA window's
// columns (ops/qconv.py:im2col_route decides).
extern "C" int gp_qconv_conv(const void* x, const void* sx, int sx_stride, const void* w,
                             const void* ws, const void* bias, const void* res, void* out,
                             const void* out_scale, int B, int H, int W, int C, int OH, int OW,
                             int N, int KS, int stride, int pad, int relu, int bn, int win_cols,
                             void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 || OH <= 0 || OW <= 0 || N <= 0 ||
      KS <= 0 || stride <= 0 || pad < 0 || (sx_stride != 0 && sx_stride != 1))
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * OH * OW;
  const long long K = (long long)KS * KS * C;
  // every row-table offset (the top-left tap may lie pad rows and columns
  // before the image), each tap's offset from it and every index stay
  // inside int32
  if (M > 0x7fffffffLL - kBM || K > 0x7fffffffLL ||
      (long long)B * H * W * C + (long long)(KS + pad) * (W + 1) * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const ConvShape s{B, H, W, C, OH, OW, N, KS, stride, pad, (int)K, (int)M, win_cols};
  // the window route: the caller (ops/qconv.py:im2col_route) chose it for a
  // shape whose every 128-row tile is a window of one image; here only what
  // the kernel and the box need: a k-block is one tap, the window whole
  // rows, its box at most 256 input columns and rows
  if (win_cols != 0 && (C % kBK || win_cols < 0 || kBM % win_cols ||
                        win_cols * stride > 256 || kBM / win_cols * stride > 256))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel_tile) {
    return launch_conv<decltype(kernel_tile)::value>(s, x, sx, sx_stride, w, ws, bias, res, out,
                                                     out_scale, relu, st);
  };
  switch (bn) {
    case 128: return launch(std::integral_constant<int, 128>());
    case 192: return launch(std::integral_constant<int, 192>());
    case 256: return launch(std::integral_constant<int, 256>());
    default: return (int)cudaErrorInvalidValue;
  }
}
