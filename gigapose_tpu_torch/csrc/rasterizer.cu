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
// gigapose_tpu_torch/render/rasterize.py:rasterize_plain.
//
// Three launches on the caller's stream:
//   vertex_kernel  one thread per (view, vertex): camera space, screen
//                  coordinates (-1e9 for z <= 1e-6);
//   face_kernel    one thread per (view, face): edge coefficients, 1/area,
//                  1/z per vertex and validity (|area| > 1e-9, every depth
//                  > 1e-6), 48 bytes per face;
//   raster_kernel  one thread per pixel of one view: walks the faces in
//                  order through shared memory, TILE at a time, keeping the
//                  best depth and face id in registers (a strict `<`, so
//                  the first face of equal depth wins, as JAX's argmin in a
//                  chunk and strict `<` across chunks do), then shades its
//                  pixel.
//
// Cost: every pixel tests every face (24 f32 operations a test: the
// face's validity, two edge functions of 5, w2 2, three inside compares,
// the 1/z interpolation 5, the clamp, the reciprocal and the depth compare;
// no binning or culling), so B x H x W x F tests: at B = 8, 160 x 160 and
// 20k faces 4e9, where the function needs only each face's tests at the
// pixels of its screen bounding box (chip_smoke.py counts both). The face
// records are read from shared memory as warp-wide broadcasts. Tile binning
// and a per-tile bounding-box cull are the next design step.
//
// Rounding: this source is built with -fmad=false (kernels/build.py), so
// every product and sum is rounded on its own, in the plain version's
// order, and divisions and square roots are IEEE (nvcc's defaults): the
// z-buffer, the face ids and the colours match the plain version on the
// card up to the order of its gathers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEpsZ = 1e-6f;
constexpr float kEpsArea = 1e-9f;
constexpr int kThreads = 256;
constexpr int kTile = 256;  // faces per shared-memory stage: 12 KB

struct __align__(16) FaceRec {
  float4 e0;  // A0, B0, C0, 1/area: w0 = (C0 + A0 fx + B0 fy) / area
  float4 e1;  // A1, B1, C1, valid (1 or 0)
  float4 iz;  // 1/z of the three vertices, unused
};

__global__ void vertex_kernel(const float* __restrict__ verts, const float* __restrict__ K,
                              const float* __restrict__ T, int B, int V,
                              float* __restrict__ cam, float* __restrict__ scr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * V) return;
  const int b = i / V;
  const float* t = T + b * 16;
  const float* k = K + b * 9;
  const float vx = verts[3 * i], vy = verts[3 * i + 1], vz = verts[3 * i + 2];
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

__global__ void face_kernel(const int* __restrict__ faces, const float* __restrict__ cam,
                            const float* __restrict__ scr, int B, int V, int F,
                            FaceRec* __restrict__ recs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * F) return;
  const int b = i / F;
  const int* f = faces + 3 * i;
  const int v0 = b * V + f[0], v1 = b * V + f[1], v2 = b * V + f[2];
  const float x0 = scr[2 * v0], y0 = scr[2 * v0 + 1];
  const float x1 = scr[2 * v1], y1 = scr[2 * v1 + 1];
  const float x2 = scr[2 * v2], y2 = scr[2 * v2 + 1];
  const float z0 = cam[3 * v0 + 2], z1 = cam[3 * v1 + 2], z2 = cam[3 * v2 + 2];
  const float area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
  const bool valid = fabsf(area) > kEpsArea && z0 > kEpsZ && z1 > kEpsZ && z2 > kEpsZ;
  FaceRec r;
  r.e0 = make_float4(y1 - y2, x2 - x1, x1 * y2 - x2 * y1, valid ? 1.0f / area : 0.0f);
  r.e1 = make_float4(y2 - y0, x0 - x2, x2 * y0 - x0 * y2, valid ? 1.0f : 0.0f);
  r.iz = make_float4(1.0f / fmaxf(z0, kEpsZ), 1.0f / fmaxf(z1, kEpsZ), 1.0f / fmaxf(z2, kEpsZ),
                     0.0f);
  recs[i] = r;
}

__global__ void __launch_bounds__(kThreads)
raster_kernel(const int* __restrict__ faces, const float* __restrict__ colors,
              const float* __restrict__ cam, const float* __restrict__ scr,
              const FaceRec* __restrict__ recs, int V, int F, int H, int W,
              uint8_t* __restrict__ rgba, float* __restrict__ depth,
              float* __restrict__ normals, int* __restrict__ face_id) {
  __shared__ FaceRec tile[kTile];
  const int b = blockIdx.y;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  const bool live = pix < H * W;
  const float fx = (float)(pix % W) + 0.5f;
  const float fy = (float)(pix / W) + 0.5f;
  const FaceRec* view = recs + (size_t)b * F;

  float best = INFINITY;
  int best_f = 0;
  for (int f0 = 0; f0 < F; f0 += kTile) {
    const int n = min(kTile, F - f0);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) tile[j] = view[f0 + j];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const FaceRec& r = tile[j];
      if (r.e1.w == 0.0f) continue;  // degenerate, padded or behind the camera
      const float w0 = ((r.e0.z + r.e0.x * fx) + r.e0.y * fy) * r.e0.w;
      const float w1 = ((r.e1.z + r.e1.x * fx) + r.e1.y * fy) * r.e0.w;
      const float w2 = (1.0f - w0) - w1;
      if (w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f) {
        const float inv_z = (w0 * r.iz.x + w1 * r.iz.y) + w2 * r.iz.z;
        const float d = 1.0f / fmaxf(inv_z, 1e-30f);
        if (d < best) {
          best = d;
          best_f = f0 + j;
        }
      }
    }
  }
  if (!live) return;

  const size_t o = (size_t)b * H * W + pix;
  uint8_t* px = rgba + 4 * o;
  if (!(best < INFINITY)) {
    px[0] = px[1] = px[2] = px[3] = 0;
    depth[o] = 0.0f;
    normals[3 * o] = normals[3 * o + 1] = normals[3 * o + 2] = 0.0f;
    face_id[o] = 0;
    return;
  }
  // attribute pass: barycentrics of the winning face recomputed in the
  // reference's unexpanded form (jax_renderer.py:290-326)
  const int* f = faces + 3 * ((size_t)b * F + best_f);
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
  const float* c0 = colors + 3 * v[0];
  const float* c1 = colors + 3 * v[1];
  const float* c2 = colors + 3 * v[2];

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

extern "C" int gp_rasterize(const float* verts, const int* faces, const float* colors,
                            const float* K, const float* T, int B, int V, int F, int H, int W,
                            float* cam, float* scr, void* face_recs, uint8_t* rgba,
                            float* depth, float* normals, int* face_id, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (V > 0) {
    vertex_kernel<<<(B * V + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        verts, K, T, B, V, cam, scr);
  }
  if (F > 0) {
    face_kernel<<<(B * F + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        faces, cam, scr, B, V, F, static_cast<FaceRec*>(face_recs));
  }
  dim3 grid((H * W + kThreads - 1) / kThreads, B);
  raster_kernel<<<grid, kThreads, 0, stream>>>(faces, colors, cam, scr,
                                               static_cast<const FaceRec*>(face_recs), V, F,
                                               H, W, rgba, depth, normals, face_id);
  return (int)cudaGetLastError();
}
