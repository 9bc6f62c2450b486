// Batched z-buffer rasterizer for the refiner's device renderer.
//
// Replaces gigapose_tpu/render/jax_renderer.py:200-326 (`rasterize`, XLA
// code vmapped over the batch by refiner/device_render.py:render_rgb): per
// view, camera-space vertices and screen coordinates; per (pixel, face) the
// affine edge functions at pixel centres, the inside test and the
// perspective depth; the nearest face with first-index ties; then one
// attribute pass for the winning face (perspective-correct vertex colours,
// the flat camera-facing normal, headlight shade 0.35 + 0.65 |n_z|, clip to
// [0, 255] and truncation to uint8). The plain PyTorch version is
// gigapose_tpu_torch/render/rasterize.py:rasterize_plain; its culling is
// rasterize.py:cull_boxes_plain and cull_row_span.
//
// Four launches on the caller's stream:
//   prep_kernel     one thread per (view, vertex) and per pixel: camera
//                   space, screen coordinates (-1e9 for z <= 1e-6); every
//                   pixel's z-buffer key set to ~0 (empty), the big-face
//                   counter to 0;
//   face_kernel     one thread per (view, face): edge coefficients, 1/area,
//                   1/z per vertex, validity (|area| > 1e-9, every depth
//                   > 1e-6) and the face's cull box (below). A face whose box
//                   holds at most kSmallBox pixels tests them itself; a larger
//                   one is appended to a list: a warp's big faces take their
//                   slots and first box rows by one 64-bit atomicAdd;
//   big_kernel      a fixed grid of warps splits the rows of all big faces
//                   evenly, a contiguous run per warp and a row per lane; a
//                   row tests only the columns where the accepting triangle
//                   (below) can reach, so neither a face that covers the view
//                   nor a long diagonal sliver serializes a thread;
//   resolve_kernel  one thread per pixel: decodes the key into the depth and
//                   the face and shades the pixel (the attribute pass).
// No library primitive lays out the work: no scan, no sort, no host sync.
//
// The z-buffer: every test that passes does one 64-bit atomicMin of
//   key = (uint64(float_as_uint(d)) << 32) | face
// on its pixel, where d = 1 / max(inv_z, 1e-30) is positive and finite, so
// its bits order as the float does. The least key is the least depth, then
// the least face index: the plain version's rule (argmin's first index in a
// chunk, a strict `<` across chunks), whatever order the atomics land in,
// so the result is deterministic and the faces need no order.
//
// Cost: the tests of each valid face at the pixel centres of its cull box,
// or of its row spans for a big face (below), so the work follows the faces
// that can cover a pixel and not B x H x W x F; padded, invalid and
// off-screen faces cost the face pass only. The bound of the function is
// bytes (inputs read once, the four outputs written once); atomics touch
// the 8-byte key of a pixel once per covering face. Faces scatter to pixels
// rather than pixels walking binned face lists (tile binning): the key
// compare makes the order of the faces irrelevant, so there are no per-tile
// lists to size, fill in face order or scan, only 8 bytes a pixel.
//
// The cull must be conservative against the rounded inside test, or the
// kernel stops being bit-equal to its plain version. With u = 2^-24 and
// vertices v_i = (x_i, y_i) the f32 screen values, the test computes
//   E0 = (C0 + A0 fx) + B0 fy,  C0 = x1 y2 - x2 y1,  A0 = y1 - y2, B0 = x2 - x1
//   w0 = E0 * fl(1 / area),  w1 likewise,  w2 = (1 - w0) - w1,
// every operation rounded on its own (-fmad=false). Standard bounds give
//   |E0 - e0| <= gamma_4 (|x1 y2| + |x2 y1| + |A0| fx + |B0| fy)
//            <= gamma_4 (2 M^2 + D (W + H))           (fx <= W, fy <= H)
//   |area - A| <= gamma_3 (|x1-x0||y2-y0| + |x2-x0||y1-y0|) <= 6.02 u D^2 =: dA
// with gamma_k = k u / (1 - k u), M the largest |coordinate| of the face, D
// the larger side of its screen box and A the exact doubled signed area.
// If dA <= |area| / 4, A has the sign of area and |A| >= Alow = |area| - dA.
// A pixel centre p passes only if w0, w1 >= 0 and fl(1 - w0) >= w1, so
// w0 in [0, 1] and w0 + w1 <= 1 + u. Solving w0 = E0 / area (1 + d1)(1 + d2)
// for the exact barycentric l0 = e0 / A gives
//   |l0 - w0| <= eps = 1.0001 (dA / Alow + 2.01 u)
//                      + 4.01 u (2 M^2 + D (W + H)) / Alow
// (an underflow of w0 to -0 adds below 2^-149, inside the rounded-up
// constants), so p's exact barycentrics satisfy l0, l1 >= -t01 = -eps and
// l2 >= -t2 = -(u + 2 eps). Those three half-planes bound a triangle with
// corners P_i = v_i + sum_{j != i} t_j (v_i - v_j) (the barycentric
// simplex's corners l_j = -t_j, l_i = 1 + the other two t), so p lies in
// the box of P0, P1, P2: the face's screen box, grown about t D along the
// face's own extent. The cull box is the pixels whose centre lies in that
// box widened by kSlack = 1/4 px; a big face whose corners all lie within
// kReachMax of the origin tests in each row only the pixels whose centre
// lies within kSlack of the triangle's cut by the band of half-width kSlack
// about the row's centre line. The slack covers the
// rounding of this arithmetic: with t D <= kReachMax = 2^14 px, a corner
// near the view has its terms below 3 2^14 + W + H = Q, so its 6 roundings
// move it by at most 6 u Q (a point of the true triangle then lies within
// that of one of the computed triangle, whose band cut the row span holds),
// a crossing of the band's lines (corners below 2^14; the edge's inverse
// slope rounded, times the band's offset from a corner) adds 6 u Q and the
// pixel bounds 2 u Q: 0.1 px at W + H = 2^16 (the wrapper's limit), under
// 1/4; a corner far from the view moves a box side only through the clamp
// to the view, as it would exactly. In the
// face's terms, since |A| >= l_min^2 sin(theta_min) (l_min its shortest
// edge, theta_min its smallest angle), the box grows by about
//   t D ~ 8 u D (2 M^2 + D (W + H)) / (l_min^2 sin theta_min)
// pixels: large coordinates, short edges and thin angles widen it. Every
// quantity is evaluated in f32 with the constants rounded up (a few
// roundings of positive terms, 1e-6 relative, inside the 0.25 % the
// constants carry). A face with dA > |area| / 4, or (2 t01 + t2) D not
// finite or above kReachMax, is tested at the whole view (a flag in
// cull_boxes_plain); no face is dropped on a heuristic.
//
// Rounding: this source is built with -fmad=false (kernels/build.py), so
// every product and sum is rounded on its own, in the plain version's
// order, and divisions and square roots are IEEE (nvcc's defaults): the
// z-buffer, the face ids and the colours equal the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEpsZ = 1e-6f;
constexpr float kEpsArea = 1e-9f;
constexpr float kU = 5.9604645e-8f;  // 2^-24, f32's unit roundoff
constexpr int kThreads = 256;
constexpr float kSlack = 0.25f;   // px around the cull box for its own rounding
constexpr float kReachMax = 16384.0f;  // px a cull box may grow by (2^14)
constexpr int kSmallBox = 32;     // pixels a face thread tests itself
constexpr int kBigBlocks = 528;   // big_kernel's grid: four blocks per SM of an H100
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kEmpty = ~0ull;

struct FaceSetup {
  float A0, B0, C0, A1, B1, C1, inv_area;  // w_k = (C_k + A_k fx + B_k fy) * inv_area
  float iz0, iz1, iz2;                     // 1/z of the three vertices
  float cx[3], cy[3];                      // corners of the region the test can accept
  int x0, x1, y0, y1;                      // cull box, inclusive; empty when x0 > x1
  bool whole;                              // the bound failed: the whole view
  bool spans;                              // corners within kReachMax: row spans
};

__global__ void prep_kernel(const float* __restrict__ verts, const float* __restrict__ K,
                            const float* __restrict__ T, int B, int V, int vs, int pixels,
                            float* __restrict__ cam, float* __restrict__ scr,
                            unsigned long long* __restrict__ keys,
                            unsigned long long* __restrict__ counter) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < pixels) keys[i] = kEmpty;
  if (i == 0) *counter = 0;
  if (i >= B * V) return;
  const int b = i / V;
  const float* t = T + b * 16;
  const float* k = K + b * 9;
  const float* p = verts + 3 * ((size_t)b * vs + (i - b * V));
  const float vx = p[0], vy = p[1], vz = p[2];
  const float x = ((t[0] * vx + t[1] * vy) + t[2] * vz) + t[3];
  const float y = ((t[4] * vx + t[5] * vy) + t[6] * vz) + t[7];
  const float z = ((t[8] * vx + t[9] * vy) + t[10] * vz) + t[11];
  cam[3 * i] = x;
  cam[3 * i + 1] = y;
  cam[3 * i + 2] = z;
  if (z > kEpsZ) {
    scr[2 * i] = ((k[0] * x + k[1] * y) + k[2] * z) / z;
    scr[2 * i + 1] = ((k[3] * x + k[4] * y) + k[5] * z) / z;
  } else {
    scr[2 * i] = -1e9f;
    scr[2 * i + 1] = -1e9f;
  }
}

// Face `face` of view b -> its set-up; false for an invalid face
// (degenerate, padded or behind the camera), which has no box.
__device__ __forceinline__ bool face_setup(const int* __restrict__ faces,
                                           const float* __restrict__ cam,
                                           const float* __restrict__ scr, int face, int b,
                                           int V, int fs, int H, int W, FaceSetup& s) {
  const int* f = faces + 3 * ((size_t)b * fs + face);
  const int v0 = b * V + f[0], v1 = b * V + f[1], v2 = b * V + f[2];
  const float x0 = scr[2 * v0], y0 = scr[2 * v0 + 1];
  const float x1 = scr[2 * v1], y1 = scr[2 * v1 + 1];
  const float x2 = scr[2 * v2], y2 = scr[2 * v2 + 1];
  const float z0 = cam[3 * v0 + 2], z1 = cam[3 * v1 + 2], z2 = cam[3 * v2 + 2];
  const float area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
  if (!(fabsf(area) > kEpsArea && z0 > kEpsZ && z1 > kEpsZ && z2 > kEpsZ)) return false;
  s.A0 = y1 - y2;
  s.B0 = x2 - x1;
  s.C0 = x1 * y2 - x2 * y1;
  s.A1 = y2 - y0;
  s.B1 = x0 - x2;
  s.C1 = x2 * y0 - x0 * y2;
  s.inv_area = 1.0f / area;
  s.iz0 = 1.0f / fmaxf(z0, kEpsZ);
  s.iz1 = 1.0f / fmaxf(z1, kEpsZ);
  s.iz2 = 1.0f / fmaxf(z2, kEpsZ);
  // the cull box (see the head of this file), in cull_boxes_plain's order
  const float xmin = fminf(fminf(x0, x1), x2), xmax = fmaxf(fmaxf(x0, x1), x2);
  const float ymin = fminf(fminf(y0, y1), y2), ymax = fmaxf(fmaxf(y0, y1), y2);
  const float D = fmaxf(xmax - xmin, ymax - ymin);
  const float M = fmaxf(fmaxf(fmaxf(fabsf(x0), fabsf(x1)), fabsf(x2)),
                        fmaxf(fmaxf(fabsf(y0), fabsf(y1)), fabsf(y2)));
  const float a = fabsf(area);
  const float view = (float)(W + H);
  const float dA = (6.02f * kU) * (D * D);
  const float a_low = a - dA;
  const float eps = 1.0001f * (dA / a_low + 2.01f * kU)
                    + (4.01f * kU) * ((2.0f * (M * M) + D * view) / a_low);
  const float t2 = kU + 2.0f * eps;
  s.whole = !(dA <= 0.25f * a && (2.0f * eps + t2) * D <= kReachMax);
  if (s.whole) {
    s.x0 = 0;
    s.x1 = W - 1;
    s.y0 = 0;
    s.y1 = H - 1;
    return true;
  }
  // the corners P_i of the region the rounded test can accept
  s.cx[0] = (x0 + eps * (x0 - x1)) + t2 * (x0 - x2);
  s.cx[1] = (x1 + eps * (x1 - x0)) + t2 * (x1 - x2);
  s.cx[2] = (x2 + eps * (x2 - x0)) + eps * (x2 - x1);
  s.cy[0] = (y0 + eps * (y0 - y1)) + t2 * (y0 - y2);
  s.cy[1] = (y1 + eps * (y1 - y0)) + t2 * (y1 - y2);
  s.cy[2] = (y2 + eps * (y2 - y0)) + eps * (y2 - y1);
  const float lox = fminf(fminf(s.cx[0], s.cx[1]), s.cx[2]);
  const float hix = fmaxf(fmaxf(s.cx[0], s.cx[1]), s.cx[2]);
  const float loy = fminf(fminf(s.cy[0], s.cy[1]), s.cy[2]);
  const float hiy = fmaxf(fmaxf(s.cy[0], s.cy[1]), s.cy[2]);
  s.spans = fmaxf(fmaxf(-lox, hix), fmaxf(-loy, hiy)) <= kReachMax;
  // pixel i has its centre at i + 0.5: the first and last whose centre lies
  // within kSlack of that box, clamped in float before the conversion
  s.x0 = (int)ceilf(fminf(fmaxf((lox - kSlack) - 0.5f, 0.0f), (float)W));
  s.x1 = (int)floorf(fminf(fmaxf((hix + kSlack) - 0.5f, -1.0f), (float)(W - 1)));
  s.y0 = (int)ceilf(fminf(fmaxf((loy - kSlack) - 0.5f, 0.0f), (float)H));
  s.y1 = (int)floorf(fminf(fmaxf((hiy + kSlack) - 0.5f, -1.0f), (float)(H - 1)));
  return true;
}

// The inverse slopes dx / dy of the accepting triangle's edges (k, k + 1),
// 0 for a horizontal edge, which crosses no band line.
__device__ __forceinline__ void edge_slopes(const FaceSetup& s, float slope[3]) {
  for (int k = 0; k < 3; ++k) {
    const int j = k == 2 ? 0 : k + 1;
    slope[k] = s.cy[k] == s.cy[j] ? 0.0f : (s.cx[j] - s.cx[k]) / (s.cy[j] - s.cy[k]);
  }
}

// The columns of row py that a big face tests: the pixels whose centre lies
// within kSlack of the accepting triangle's cut by the band
// |y - (py + 0.5)| <= kSlack (its corners in the band and its edges'
// crossings of the band's two lines), within the cull box; the box's whole
// row for a whole-view face or one with a corner beyond kReachMax px.
// -> first, last (empty when first > last).
__device__ __forceinline__ void row_span(const FaceSetup& s, const float slope[3], int py,
                                         int W, int& first, int& last) {
  if (s.whole || !s.spans) {
    first = s.x0;
    last = s.x1;
    return;
  }
  const float c = (float)py + 0.5f;
  const float band[2] = {c - kSlack, c + kSlack};
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (s.cy[k] >= band[0] && s.cy[k] <= band[1]) {
      lo = fminf(lo, s.cx[k]);
      hi = fmaxf(hi, s.cx[k]);
    }
    const int j = k == 2 ? 0 : k + 1;
    const float ya = s.cy[k], yb = s.cy[j];
    if (ya == yb) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (band[e] >= fminf(ya, yb) && band[e] <= fmaxf(ya, yb)) {
        const float x = s.cx[k] + (band[e] - ya) * slope[k];
        lo = fminf(lo, x);
        hi = fmaxf(hi, x);
      }
    }
  }
  first = max(s.x0, (int)ceilf(fminf(fmaxf((lo - kSlack) - 0.5f, 0.0f), (float)W)));
  last = min(s.x1, (int)floorf(fminf(fmaxf((hi + kSlack) - 0.5f, -1.0f), (float)(W - 1))));
}

// The inside test and depth of one (pixel, face) pair, in the plain
// version's order, and the z-buffer update.
__device__ __forceinline__ void test_pixel(const FaceSetup& s, int px, int py, int W,
                                           unsigned int face,
                                           unsigned long long* __restrict__ view_keys) {
  const float fx = (float)px + 0.5f;
  const float fy = (float)py + 0.5f;
  const float w0 = ((s.C0 + s.A0 * fx) + s.B0 * fy) * s.inv_area;
  const float w1 = ((s.C1 + s.A1 * fx) + s.B1 * fy) * s.inv_area;
  const float w2 = (1.0f - w0) - w1;
  if (w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f) {
    const float inv_z = (w0 * s.iz0 + w1 * s.iz1) + w2 * s.iz2;
    const float d = 1.0f / fmaxf(inv_z, 1e-30f);
    const unsigned long long key =
        ((unsigned long long)__float_as_uint(d) << 32) | (unsigned long long)face;
    atomicMin(view_keys + (size_t)py * W + px, key);
  }
}

__global__ void __launch_bounds__(kThreads)
face_kernel(const int* __restrict__ faces, const float* __restrict__ cam,
            const float* __restrict__ scr, int B, int V, int F, int fs, int H, int W,
            unsigned long long* __restrict__ keys, int* __restrict__ big_face,
            unsigned int* __restrict__ big_start, unsigned long long* __restrict__ counter) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  FaceSetup s;
  int b = 0;
  bool small = false;
  unsigned long long take = 0;  // a big face: one list slot (high word), its rows (low word)
  if (i < B * F) {
    b = i / F;
    if (face_setup(faces, cam, scr, i - b * F, b, V, fs, H, W, s)) {
      const int bw = s.x1 - s.x0 + 1, bh = s.y1 - s.y0 + 1;
      if (bw > 0 && bh > 0) {
        if (bw * bh > kSmallBox) take = (1ull << 32) | (unsigned int)bh;
        else small = true;
      }
    }
  }
  // the warp's big faces take their slots and first rows with one atomicAdd:
  // an inclusive scan of `take` over the lanes, the last lane adds the total
  // (slots and row starts then grow together, warp after warp)
  const int lane = threadIdx.x & 31;
  unsigned long long scan = take;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long up = __shfl_up_sync(0xffffffffu, scan, d);
    if (lane >= d) scan += up;
  }
  unsigned long long base = 0;
  if (lane == 31 && scan != 0) base = atomicAdd(counter, scan);
  base = __shfl_sync(0xffffffffu, base, 31);
  if (take != 0) {
    const unsigned long long at = base + scan - take;
    big_face[at >> 32] = i;
    big_start[at >> 32] = (unsigned int)at;
  }
  if (!small) return;
  unsigned long long* view_keys = keys + (size_t)b * H * W;
  for (int py = s.y0; py <= s.y1; ++py)
    for (int px = s.x0; px <= s.x1; ++px) test_pixel(s, px, py, W, i - b * F, view_keys);
}

// The big faces' rows split evenly over a fixed grid of warps, a
// contiguous run per warp; the warp finds the face of the run's first row by
// a binary search of the row starts, then walks the run 32 rows at a time,
// a row per lane: each lane moves on to the face that owns its row (the
// faces' set-up recomputed, the same bits), computes the row's span and
// tests its pixels.
__global__ void __launch_bounds__(kThreads)
big_kernel(const int* __restrict__ faces, const float* __restrict__ cam,
           const float* __restrict__ scr, int V, int F, int fs, int H, int W,
           unsigned long long* __restrict__ keys, const int* __restrict__ big_face,
           const unsigned int* __restrict__ big_start,
           const unsigned long long* __restrict__ counter) {
  const unsigned long long c = *counter;
  const unsigned int n_big = (unsigned int)(c >> 32);
  const unsigned long long total = c & 0xffffffffull;
  const unsigned long long warps = (unsigned long long)gridDim.x * kWarps;
  const unsigned long long per = (total + warps - 1) / warps;
  const unsigned long long first = (blockIdx.x * kWarps + threadIdx.x / 32) * per;
  const unsigned long long end = min(total, first + per);
  if (first >= end) return;
  const int lane = threadIdx.x & 31;
  unsigned int lo = 0, hi = n_big - 1;  // the last slot whose start <= first
  while (lo < hi) {
    const unsigned int mid = (lo + hi + 1) / 2;
    if (big_start[mid] <= first) lo = mid; else hi = mid - 1;
  }
  unsigned int slot = lo - 1;
  unsigned long long start = 0, next = 0;
  FaceSetup s;
  float slope[3];
  int b = 0, face = 0;
  for (unsigned long long row = first + lane; row < end; row += 32) {
    if (row >= next) {  // on to the face that owns this row
      do {
        ++slot;
        next = slot + 1 < n_big ? big_start[slot + 1] : total;
      } while (row >= next);
      start = big_start[slot];
      const int i = big_face[slot];
      b = i / F;
      face = i - b * F;
      face_setup(faces, cam, scr, face, b, V, fs, H, W, s);
      edge_slopes(s, slope);
    }
    const int py = s.y0 + (int)(row - start);
    int x_first, x_last;
    row_span(s, slope, py, W, x_first, x_last);
    unsigned long long* view_keys = keys + (size_t)b * H * W;
    for (int px = x_first; px <= x_last; ++px) test_pixel(s, px, py, W, face, view_keys);
  }
}

__global__ void __launch_bounds__(kThreads)
resolve_kernel(const int* __restrict__ faces, const float* __restrict__ colors,
               const float* __restrict__ cam, const float* __restrict__ scr,
               const unsigned long long* __restrict__ keys, int V, int fs, int cs, int H,
               int W, uint8_t* __restrict__ rgba, float* __restrict__ depth,
               float* __restrict__ normals, int* __restrict__ face_id) {
  const int b = blockIdx.y;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= H * W) return;
  const float fx = (float)(pix % W) + 0.5f;
  const float fy = (float)(pix / W) + 0.5f;
  const size_t o = (size_t)b * H * W + pix;
  const unsigned long long key = keys[o];
  uint8_t* px = rgba + 4 * o;
  if (key == kEmpty) {
    px[0] = px[1] = px[2] = px[3] = 0;
    depth[o] = 0.0f;
    normals[3 * o] = normals[3 * o + 1] = normals[3 * o + 2] = 0.0f;
    face_id[o] = 0;
    return;
  }
  const float best = __uint_as_float((unsigned int)(key >> 32));
  const int best_f = (int)(key & 0xffffffffu);
  // attribute pass: barycentrics of the winning face recomputed in the
  // reference's unexpanded form (jax_renderer.py:290-326)
  const int* f = faces + 3 * ((size_t)b * fs + best_f);
  const int v[3] = {b * V + f[0], b * V + f[1], b * V + f[2]};
  const float x0 = scr[2 * v[0]], y0 = scr[2 * v[0] + 1];
  const float x1 = scr[2 * v[1]], y1 = scr[2 * v[1] + 1];
  const float x2 = scr[2 * v[2]], y2 = scr[2 * v[2] + 1];
  const float area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
  const float inv_area = 1.0f / (fabsf(area) > kEpsArea ? area : 1.0f);
  float w[3];
  w[0] = ((x1 - fx) * (y2 - fy) - (x2 - fx) * (y1 - fy)) * inv_area;
  w[1] = ((x2 - fx) * (y0 - fy) - (x0 - fx) * (y2 - fy)) * inv_area;
  w[2] = (1.0f - w[0]) - w[1];
  float a[3];
  for (int k = 0; k < 3; ++k) a[k] = (w[k] * (1.0f / fmaxf(cam[3 * v[k] + 2], kEpsZ))) * best;
  const float* c0 = colors + 3 * ((size_t)b * cs + f[0]);
  const float* c1 = colors + 3 * ((size_t)b * cs + f[1]);
  const float* c2 = colors + 3 * ((size_t)b * cs + f[2]);

  const float* p0 = cam + 3 * v[0];
  const float* p1 = cam + 3 * v[1];
  const float* p2 = cam + 3 * v[2];
  const float e1x = p1[0] - p0[0], e1y = p1[1] - p0[1], e1z = p1[2] - p0[2];
  const float e2x = p2[0] - p0[0], e2y = p2[1] - p0[1], e2z = p2[2] - p0[2];
  const float nx = e1y * e2z - e1z * e2y;
  const float ny = e1z * e2x - e1x * e2z;
  const float nz = e1x * e2y - e1y * e2x;
  const float nl = fmaxf(sqrtf((nx * nx + ny * ny) + nz * nz), 1e-20f);
  float n[3] = {nx / nl, ny / nl, nz / nl};
  if (n[2] > 0.0f) {
    n[0] = -n[0];
    n[1] = -n[1];
    n[2] = -n[2];
  }
  const float shade = 0.35f + 0.65f * fabsf(n[2]);
  for (int c = 0; c < 3; ++c) {
    const float col = (a[0] * c0[c] + a[1] * c1[c]) + a[2] * c2[c];
    px[c] = (uint8_t)fminf(fmaxf(col * shade, 0.0f), 255.0f);  // truncation, as astype(uint8)
    normals[3 * o + c] = n[c];
  }
  px[3] = 255;
  depth[o] = best;
  face_id[o] = best_f;
}

}  // namespace

// vs, fs, cs: the batch strides of verts, faces and colors in rows (V, F
// and V, or 0 for one mesh shared by every view); keys: B*H*W uint64
// scratch; big: 2*B*F int32 scratch (the big faces and their first rows);
// counter: one uint64. B*F*H must stay below 2^32 (the counter's row word).
extern "C" int gp_rasterize(const float* verts, const int* faces, const float* colors,
                            const float* K, const float* T, int B, int V, int F, int H, int W,
                            int vs, int fs, int cs,
                            float* cam, float* scr, unsigned long long* keys, int* big,
                            unsigned long long* counter, uint8_t* rgba, float* depth,
                            float* normals, int* face_id, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const int pixels = B * H * W;
  const int prep = pixels > B * V ? pixels : B * V;
  prep_kernel<<<(prep + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      verts, K, T, B, V, vs, pixels, cam, scr, keys, counter);
  if (F > 0) {
    int* big_face = big;
    unsigned int* big_start = reinterpret_cast<unsigned int*>(big) + (size_t)B * F;
    face_kernel<<<(B * F + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        faces, cam, scr, B, V, F, fs, H, W, keys, big_face, big_start, counter);
    big_kernel<<<kBigBlocks, kThreads, 0, stream>>>(faces, cam, scr, V, F, fs, H, W, keys,
                                                    big_face, big_start, counter);
  }
  dim3 grid((H * W + kThreads - 1) / kThreads, B);
  resolve_kernel<<<grid, kThreads, 0, stream>>>(faces, colors, cam, scr, keys, V, fs, cs, H,
                                                W, rgba, depth, normals, face_id);
  return (int)cudaGetLastError();
}
