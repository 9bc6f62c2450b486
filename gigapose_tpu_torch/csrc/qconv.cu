// Int8 convolutions of the int8 IST serving path for Hopper (sm_90a), bound
// with ctypes through plain C entry points (gp_qconv_act_scale,
// gp_qconv_quantize, gp_qconv_conv). Built by
// gigapose_tpu_torch/kernels/build.py with -fmad=false and without
// --use_fast_math: the division of the quantization is the IEEE one
// (__fdiv_rn), and every product and sum of the epilogue is rounded on its
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
//   with rint half to even (__float2int_rn) and the per-image scale (stride
//   1) or one static scale (stride 0); one image per grid row, 16 bytes in
//   and 4 bytes out a thread. Bytes bound it.
// - qconv_kernel: an implicit-GEMM convolution, out (M = B*OH*OW, N = O)
//   = im2col(xq) (M, K = KH*KW*C) . w^T with w the (O, K) int8 weight,
//   K-contiguous, in the (kh, kw, c) order of an HWIO kernel. A 256-thread
//   block computes a 128 x 128 output tile in k-steps of 64: it gathers the
//   im2col tile from the int8 NHWC input into shared memory (never through
//   device memory), zero codes in the padding and past K, and its 8 warps
//   (4 along M, 2 along N) multiply with mma.sync m16n8k32 s8 into int32
//   (at most 127^2 * 4608 = 7.4e7 < 2^31 at the IST's widest conv). When C
//   is a multiple of 64 a k-step lies inside one (kh, kw) tap as 64
//   contiguous channels, so each row of the tile is four 16-byte cp.async
//   copies (zero-filled outside the image), double-buffered against the
//   products; otherwise (the 7x7 stem, C = 3, K = 147) the block gathers
//   byte by byte, one k-step at a time. Shared memory rows are 80 bytes (64
//   + 16), which keeps the fragment loads free of bank conflicts. The
//   epilogue is fused: exact int32 -> f32, acc * (sx * ws) + b, then
//   + residual and ReLU when asked, f32 NHWC out.
//   What bounds it: at the IST's shapes at B = 32 the f32 output (and
//   residual) and the int8 input dominate; the products (1.25 T int8
//   operations for the 21 convs) need 0.63 ms at 1,979 TOP/s. mma.sync
//   reaches a part of the tensor cores' rate that only wgmma gets in full,
//   and the 128-wide N tile wastes a third of the 192-channel stage.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int kRow = BK + 16;  // bytes per shared-memory row

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

__device__ __forceinline__ signed char quant1(float v, float s) {
  int q = __float2int_rn(__fdiv_rn(v, s));
  return (signed char)max(-127, min(127, q));
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, const float* __restrict__ sx, int sx_stride,
                int8_t* __restrict__ q, long long E) {
  // one image per grid row: its scale is read once, no index division
  const long long off = (long long)blockIdx.y * E;
  const float s = sx[blockIdx.y * sx_stride];
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if ((E & 3) == 0) {  // 4 elements a thread: 16 bytes in, 4 out
    const float4* v = reinterpret_cast<const float4*>(x + off);
    char4* o = reinterpret_cast<char4*>(q + off);
    for (; i < (E >> 2); i += stride) {
      float4 f = v[i];
      o[i] = make_char4(quant1(f.x, s), quant1(f.y, s), quant1(f.z, s), quant1(f.w, s));
    }
  } else {
    for (; i < E; i += stride) q[off + i] = quant1(x[off + i], s);
  }
}

// ------------------------------------------------------------ qconv

struct ConvShape {
  int B, H, W, C, OH, OW, N, KS, stride, pad, K, M;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n"); }

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One output row's place in the input: the image's first byte, the top-left
// tap's position, and whether the row exists.
struct RowPos {
  const int8_t* img;
  int ih0, iw0;
  bool valid;
};

__device__ __forceinline__ RowPos row_pos(const int8_t* x, const ConvShape& s, int m) {
  RowPos r;
  r.valid = m < s.M;
  int mm = r.valid ? m : 0;
  int b = mm / (s.OH * s.OW);
  int rem = mm - b * s.OH * s.OW;
  int oh = rem / s.OW, ow = rem - oh * s.OW;
  r.img = x + (long long)b * s.H * s.W * s.C;
  r.ih0 = oh * s.stride - s.pad;
  r.iw0 = ow * s.stride - s.pad;
  return r;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
qconv_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx, int sx_stride,
             const int8_t* __restrict__ w, const float* __restrict__ ws,
             const float* __restrict__ bias, const float* __restrict__ res,
             float* __restrict__ out, ConvShape s, int relu) {
  __shared__ __align__(16) int8_t As[2][BM][kRow];
  __shared__ __align__(16) int8_t Bs[2][BN][kRow];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int KT = (s.K + BK - 1) / BK;

  // the rows this thread loads: VEC two rows (tid / 4 and + 64) at 16-byte
  // chunk tid % 4; otherwise one row (tid / 2) at bytes (tid % 2) * 32 .. + 32
  const int ld_row = VEC ? tid >> 2 : tid >> 1;
  RowPos ra[2] = {row_pos(x, s, m0 + ld_row), row_pos(x, s, m0 + ld_row + 64)};
  const int8_t* wrow[2];
  bool wvalid[2];
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    wvalid[i] = n0 + ld_row + 64 * i < s.N;
    wrow[i] = w + (long long)(wvalid[i] ? n0 + ld_row + 64 * i : 0) * s.K;
  }

  auto load_vec = [&](int stage, int kt) {
    const int k0 = kt * BK, chunk = tid & 3;
    const int tap = k0 / s.C, c0 = k0 - tap * s.C + chunk * 16;
    const int kh = tap / s.KS, kw = tap - kh * s.KS;
    #pragma unroll
    for (int i = 0; i < 2; ++i) {
      const RowPos& r = ra[i];
      int ih = r.ih0 + kh, iw = r.iw0 + kw;
      bool ok = r.valid && ih >= 0 && ih < s.H && iw >= 0 && iw < s.W;
      const int8_t* src = ok ? r.img + ((long long)ih * s.W + iw) * s.C + c0 : x;
      cp_async16(&As[stage][ld_row + 64 * i][chunk * 16], src, ok);
      cp_async16(&Bs[stage][ld_row + 64 * i][chunk * 16], wrow[i] + k0 + chunk * 16,
                 wvalid[i]);
    }
  };

  auto load_bytes = [&](int kt) {  // byte gather into stage 0
    const int kk0 = (tid & 1) * 32, k0 = kt * BK + kk0;
    const RowPos& r = ra[0];
    int tap = k0 / s.C, ci = k0 - tap * s.C;
    #pragma unroll 2
    for (int j = 0; j < 32; j += 4) {
      unsigned packed = 0, wpacked = 0;
      #pragma unroll
      for (int u = 0; u < 4; ++u) {
        int k = k0 + j + u;
        unsigned v = 0, wv = 0;
        if (k < s.K) {
          int kh = tap / s.KS, kw = tap - kh * s.KS;
          int ih = r.ih0 + kh, iw = r.iw0 + kw;
          if (r.valid && ih >= 0 && ih < s.H && iw >= 0 && iw < s.W)
            v = (unsigned char)r.img[((long long)ih * s.W + iw) * s.C + ci];
          if (wvalid[0]) wv = (unsigned char)wrow[0][k];
        }
        packed |= v << (8 * u);
        wpacked |= wv << (8 * u);
        if (++ci == s.C) {
          ci = 0;
          ++tap;
        }
      }
      *reinterpret_cast<unsigned*>(&As[0][ld_row][kk0 + j]) = packed;
      *reinterpret_cast<unsigned*>(&Bs[0][ld_row][kk0 + j]) = wpacked;
    }
  };

  int acc[2][8][4];
  #pragma unroll
  for (int mi = 0; mi < 2; ++mi)
    #pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      #pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  auto compute = [&](int stage) {
    #pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned a[2][4], b[8][2];
      #pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = &As[stage][warp_m * 32 + mi * 16 + g][ks + t * 4];
        a[mi][0] = lds32(p);
        a[mi][1] = lds32(p + 8 * kRow);
        a[mi][2] = lds32(p + 16);
        a[mi][3] = lds32(p + 8 * kRow + 16);
      }
      #pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int8_t* p = &Bs[stage][warp_n * 64 + ni * 8 + g][ks + t * 4];
        b[ni][0] = lds32(p);
        b[ni][1] = lds32(p + 16);
      }
      #pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        #pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
  };

  if (VEC) {
    load_vec(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < KT; ++kt) {
      if (kt + 1 < KT) load_vec((kt + 1) & 1, kt + 1);
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();
      compute(kt & 1);
      __syncthreads();
    }
  } else {
    for (int kt = 0; kt < KT; ++kt) {
      load_bytes(kt);
      __syncthreads();
      compute(0);
      __syncthreads();
    }
  }

  // epilogue: acc * (sx * ws) + b [+ residual] [relu], each step rounded
  const int per_image = s.OH * s.OW;
  #pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    #pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + warp_m * 32 + mi * 16 + g + half * 8;
      if (m >= s.M) continue;
      const float sxm = sx[(m / per_image) * sx_stride];
      #pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        #pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + warp_n * 64 + ni * 8 + t * 2 + j;
          if (n >= s.N) continue;
          const long long o = (long long)m * s.N + n;
          float y = __fmul_rn(__int2float_rn(acc[mi][ni][half * 2 + j]), __fmul_rn(sxm, ws[n]));
          y = __fadd_rn(y, bias[n]);
          if (res != nullptr) y = __fadd_rn(y, res[o]);
          if (relu) y = y > 0.f ? y : 0.f;
          out[o] = y;
        }
      }
    }
  }
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

// x: (B, H, W, C) int8, w: (N, KS*KS*C) int8, ws / bias: (N,) f32, res / out:
// (B, OH, OW, N) f32 (res may be null).
extern "C" int gp_qconv_conv(const void* x, const void* sx, int sx_stride, const void* w,
                             const void* ws, const void* bias, const void* res, void* out, int B,
                             int H, int W, int C, int OH, int OW, int N, int KS, int stride,
                             int pad, int relu, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || OH <= 0 || OW <= 0 || N <= 0 || KS <= 0 ||
      stride <= 0 || pad < 0 || (sx_stride != 0 && sx_stride != 1))
    return (int)cudaErrorInvalidValue;
  long long M = (long long)B * OH * OW;
  long long K = (long long)KS * KS * C;
  if (M > 0x7fffffffLL - BM || K > 0x7fffffffLL || (long long)B * H * W * C > 0x7fffffffLL ||
      (M + BM - 1) / BM > 0x7fffffffLL || (N + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  ConvShape s{B, H, W, C, OH, OW, N, KS, stride, pad, (int)K, (int)M};
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(x), static_cast<const float*>(sx), sx_stride,
        static_cast<const int8_t*>(w), static_cast<const float*>(ws),
        static_cast<const float*>(bias), static_cast<const float*>(res),
        static_cast<float*>(out), s, relu);
  };
  if (C % 64 == 0)
    args(qconv_kernel<true>);
  else
    args(qconv_kernel<false>);
  return (int)cudaGetLastError();
}
