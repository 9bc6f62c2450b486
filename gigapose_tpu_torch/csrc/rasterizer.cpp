// Host software rasterizer of the port: a copy of native/rasterizer.cpp,
// unchanged in what it computes, so that the port reads no file of the JAX
// package. Built with the host compiler and the flags of native/Makefile
// (gigapose_tpu_torch/kernels/build.py: build_host), so its renders are
// bit-identical to the JAX package's.
//
// Geometry: perspective pinhole (OpenCV convention, +z forward), z-buffered
// triangle rasterization with barycentric-interpolated depth and color,
// Lambertian headlight + ambient shading, per-vertex colors when the mesh
// has them (PLY) else light grey. Exposed through a plain C ABI (ctypes).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>
#include <algorithm>

namespace {

struct Mesh {
  std::vector<float> verts;    // 3 * n_verts
  std::vector<uint8_t> colors; // 3 * n_verts (optional; empty -> grey)
  std::vector<int> faces;      // 3 * n_faces
  float diameter = 0.f;
  float center[3] = {0.f, 0.f, 0.f};
};

static void compute_bounds(Mesh* m) {
  if (m->verts.empty()) return;
  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  for (size_t i = 0; i < m->verts.size(); i += 3)
    for (int c = 0; c < 3; ++c) {
      lo[c] = std::min(lo[c], m->verts[i + c]);
      hi[c] = std::max(hi[c], m->verts[i + c]);
    }
  float d = 0;
  for (int c = 0; c < 3; ++c) {
    m->center[c] = 0.5f * (lo[c] + hi[c]);
    d += (hi[c] - lo[c]) * (hi[c] - lo[c]);
  }
  m->diameter = std::sqrt(d);
}

// ---------------------------------------------------------------- PLY loader
struct PlyProp { std::string type, name; };

static bool load_ply(const std::string& path, Mesh* m) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  std::string line, format;
  size_t n_verts = 0, n_faces = 0;
  std::vector<PlyProp> vprops;
  std::string face_count_type = "uchar", face_index_type = "int";
  bool in_vertex = false, in_face = false;
  if (!std::getline(f, line) || line.substr(0, 3) != "ply") return false;
  while (std::getline(f, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    std::istringstream ss(line);
    std::string tok; ss >> tok;
    if (tok == "format") { ss >> format; }
    else if (tok == "element") {
      std::string name; size_t n; ss >> name >> n;
      in_vertex = name == "vertex"; in_face = name == "face";
      if (in_vertex) n_verts = n;
      if (in_face) n_faces = n;
    } else if (tok == "property") {
      std::string t; ss >> t;
      if (t == "list") {
        std::string ct, it, nm; ss >> ct >> it >> nm;
        if (in_face) { face_count_type = ct; face_index_type = it; }
      } else if (in_vertex) {
        std::string nm; ss >> nm;
        vprops.push_back({t, nm});
      }
    } else if (tok == "end_header") break;
  }
  auto type_size = [](const std::string& t) -> int {
    if (t == "char" || t == "uchar" || t == "int8" || t == "uint8") return 1;
    if (t == "short" || t == "ushort" || t == "int16" || t == "uint16") return 2;
    if (t == "int" || t == "uint" || t == "int32" || t == "uint32" || t == "float" || t == "float32") return 4;
    if (t == "double" || t == "float64") return 8;
    return 4;
  };
  m->verts.assign(3 * n_verts, 0.f);
  bool has_color = false;
  for (auto& p : vprops)
    if (p.name == "red" || p.name == "r") has_color = true;
  if (has_color) m->colors.assign(3 * n_verts, 200);

  bool ascii = format == "ascii";
  if (ascii) {
    for (size_t v = 0; v < n_verts; ++v) {
      std::getline(f, line);
      std::istringstream ss(line);
      double val;
      for (auto& p : vprops) {
        ss >> val;
        if (p.name == "x") m->verts[3 * v] = (float)val;
        else if (p.name == "y") m->verts[3 * v + 1] = (float)val;
        else if (p.name == "z") m->verts[3 * v + 2] = (float)val;
        else if (p.name == "red" || p.name == "r") m->colors[3 * v] = (uint8_t)val;
        else if (p.name == "green" || p.name == "g") m->colors[3 * v + 1] = (uint8_t)val;
        else if (p.name == "blue" || p.name == "b") m->colors[3 * v + 2] = (uint8_t)val;
      }
    }
    for (size_t t = 0; t < n_faces; ++t) {
      std::getline(f, line);
      std::istringstream ss(line);
      int n; ss >> n;
      std::vector<int> idx(n);
      for (int i = 0; i < n; ++i) ss >> idx[i];
      for (int i = 2; i < n; ++i) {  // fan-triangulate
        m->faces.push_back(idx[0]);
        m->faces.push_back(idx[i - 1]);
        m->faces.push_back(idx[i]);
      }
    }
  } else {  // binary_little_endian
    auto read_as_double = [&](const std::string& t) -> double {
      char buf[8];
      f.read(buf, type_size(t));
      if (t == "float" || t == "float32") { float x; memcpy(&x, buf, 4); return x; }
      if (t == "double" || t == "float64") { double x; memcpy(&x, buf, 8); return x; }
      if (t == "uchar" || t == "uint8") { return (double)(uint8_t)buf[0]; }
      if (t == "char" || t == "int8") { return (double)(int8_t)buf[0]; }
      if (t == "ushort" || t == "uint16") { uint16_t x; memcpy(&x, buf, 2); return x; }
      if (t == "short" || t == "int16") { int16_t x; memcpy(&x, buf, 2); return x; }
      if (t == "uint" || t == "uint32") { uint32_t x; memcpy(&x, buf, 4); return x; }
      int32_t x; memcpy(&x, buf, 4); return x;
    };
    for (size_t v = 0; v < n_verts; ++v) {
      for (auto& p : vprops) {
        double val = read_as_double(p.type);
        if (p.name == "x") m->verts[3 * v] = (float)val;
        else if (p.name == "y") m->verts[3 * v + 1] = (float)val;
        else if (p.name == "z") m->verts[3 * v + 2] = (float)val;
        else if (p.name == "red" || p.name == "r") m->colors[3 * v] = (uint8_t)val;
        else if (p.name == "green" || p.name == "g") m->colors[3 * v + 1] = (uint8_t)val;
        else if (p.name == "blue" || p.name == "b") m->colors[3 * v + 2] = (uint8_t)val;
      }
    }
    for (size_t t = 0; t < n_faces; ++t) {
      int n = (int)read_as_double(face_count_type);
      std::vector<int> idx(n);
      for (int i = 0; i < n; ++i) idx[i] = (int)read_as_double(face_index_type);
      for (int i = 2; i < n; ++i) {
        m->faces.push_back(idx[0]);
        m->faces.push_back(idx[i - 1]);
        m->faces.push_back(idx[i]);
      }
    }
  }
  return !m->verts.empty() && !m->faces.empty();
}

// ---------------------------------------------------------------- OBJ loader
static bool load_obj(const std::string& path, Mesh* m) {
  std::ifstream f(path);
  if (!f) return false;
  std::string line;
  while (std::getline(f, line)) {
    if (line.rfind("v ", 0) == 0) {
      std::istringstream ss(line.substr(2));
      float x, y, z;
      ss >> x >> y >> z;
      m->verts.push_back(x); m->verts.push_back(y); m->verts.push_back(z);
      float r, g, b;  // some OBJs carry vertex colors after xyz
      if (ss >> r >> g >> b) {
        m->colors.push_back((uint8_t)(r * 255));
        m->colors.push_back((uint8_t)(g * 255));
        m->colors.push_back((uint8_t)(b * 255));
      }
    } else if (line.rfind("f ", 0) == 0) {
      std::istringstream ss(line.substr(2));
      std::vector<int> idx;
      std::string tok;
      while (ss >> tok) {
        idx.push_back(std::stoi(tok.substr(0, tok.find('/'))) - 1);
      }
      for (size_t i = 2; i < idx.size(); ++i) {
        m->faces.push_back(idx[0]);
        m->faces.push_back(idx[i - 1]);
        m->faces.push_back(idx[i]);
      }
    }
  }
  if (m->colors.size() != m->verts.size()) m->colors.clear();
  return !m->verts.empty() && !m->faces.empty();
}

}  // namespace

extern "C" {

void* grast_load_mesh(const char* path, int* status) {
  Mesh* m = new Mesh();
  std::string p(path);
  bool ok = false;
  if (p.size() > 4 && p.substr(p.size() - 4) == ".ply") ok = load_ply(p, m);
  else if (p.size() > 4 && p.substr(p.size() - 4) == ".obj") ok = load_obj(p, m);
  if (!ok) { delete m; *status = 1; return nullptr; }
  compute_bounds(m);
  *status = 0;
  return m;
}

void grast_free_mesh(void* handle) { delete (Mesh*)handle; }

double grast_mesh_diameter(void* handle) { return ((Mesh*)handle)->diameter; }

void grast_mesh_center(void* handle, float* out3) {
  memcpy(out3, ((Mesh*)handle)->center, 3 * sizeof(float));
}

int grast_num_vertices(void* handle) {
  return (int)(((Mesh*)handle)->verts.size() / 3);
}

// Render the mesh under object pose T (4x4 row-major, object->camera, units of
// the mesh) through intrinsics K (3x3 row-major). Writes RGBA uint8 (H*W*4)
// and depth float (H*W, camera units; 0 = background). out_normals, when
// non-null, receives the unit camera-space face normal per pixel (H*W*3
// float, 0 = background) — the capability behind megapose's normals render
// pass (reference: panda3d_scene_renderer.py use_normals_texture).
int grast_render2(void* handle, const float* K, const float* T, int W, int H,
                  uint8_t* out_rgba, float* out_depth, float* out_normals) {
  Mesh* m = (Mesh*)handle;
  const size_t nv = m->verts.size() / 3;
  std::vector<float> cam(3 * nv);       // camera-space vertices
  std::vector<float> scr(2 * nv);       // pixel coords
  for (size_t i = 0; i < nv; ++i) {
    const float* v = &m->verts[3 * i];
    float x = T[0] * v[0] + T[1] * v[1] + T[2] * v[2] + T[3];
    float y = T[4] * v[0] + T[5] * v[1] + T[6] * v[2] + T[7];
    float z = T[8] * v[0] + T[9] * v[1] + T[10] * v[2] + T[11];
    cam[3 * i] = x; cam[3 * i + 1] = y; cam[3 * i + 2] = z;
    if (z > 1e-6f) {
      scr[2 * i] = (K[0] * x + K[1] * y + K[2] * z) / z;
      scr[2 * i + 1] = (K[3] * x + K[4] * y + K[5] * z) / z;
    } else {
      scr[2 * i] = scr[2 * i + 1] = -1e9f;
    }
  }
  memset(out_rgba, 0, (size_t)W * H * 4);
  for (int i = 0; i < W * H; ++i) out_depth[i] = 0.f;
  if (out_normals) memset(out_normals, 0, (size_t)W * H * 3 * sizeof(float));
  std::vector<float> zbuf((size_t)W * H, 1e30f);

  const bool has_color = !m->colors.empty();
  const size_t nf = m->faces.size() / 3;
  for (size_t t = 0; t < nf; ++t) {
    const int i0 = m->faces[3 * t], i1 = m->faces[3 * t + 1], i2 = m->faces[3 * t + 2];
    const float z0 = cam[3 * i0 + 2], z1 = cam[3 * i1 + 2], z2 = cam[3 * i2 + 2];
    if (z0 <= 1e-6f || z1 <= 1e-6f || z2 <= 1e-6f) continue;
    const float x0 = scr[2 * i0], y0 = scr[2 * i0 + 1];
    const float x1 = scr[2 * i1], y1 = scr[2 * i1 + 1];
    const float x2 = scr[2 * i2], y2 = scr[2 * i2 + 1];
    const float area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
    if (std::fabs(area) < 1e-9f) continue;
    int xmin = std::max(0, (int)std::floor(std::min({x0, x1, x2})));
    int xmax = std::min(W - 1, (int)std::ceil(std::max({x0, x1, x2})));
    int ymin = std::max(0, (int)std::floor(std::min({y0, y1, y2})));
    int ymax = std::min(H - 1, (int)std::ceil(std::max({y0, y1, y2})));
    if (xmin > xmax || ymin > ymax) continue;

    // face normal in camera space for headlight shading
    float e1[3] = {cam[3 * i1] - cam[3 * i0], cam[3 * i1 + 1] - cam[3 * i0 + 1], z1 - z0};
    float e2[3] = {cam[3 * i2] - cam[3 * i0], cam[3 * i2 + 1] - cam[3 * i0 + 1], z2 - z0};
    float n[3] = {e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
                  e1[0] * e2[1] - e1[1] * e2[0]};
    float nl = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    float shade = 1.0f;
    float nu[3] = {0.f, 0.f, 0.f};
    if (nl > 0) {
      // headlight along +z: |cos| so winding doesn't matter
      shade = 0.35f + 0.65f * std::fabs(n[2] / nl);
      nu[0] = n[0] / nl; nu[1] = n[1] / nl; nu[2] = n[2] / nl;
      // orient towards the camera (-z facing) so winding doesn't matter
      if (nu[2] > 0) { nu[0] = -nu[0]; nu[1] = -nu[1]; nu[2] = -nu[2]; }
    }
    const float inv_area = 1.0f / area;
    const float iz0 = 1.0f / z0, iz1 = 1.0f / z1, iz2 = 1.0f / z2;
    for (int py = ymin; py <= ymax; ++py) {
      for (int px = xmin; px <= xmax; ++px) {
        const float fx = px + 0.5f, fy = py + 0.5f;
        float w0 = ((x1 - fx) * (y2 - fy) - (x2 - fx) * (y1 - fy)) * inv_area;
        float w1 = ((x2 - fx) * (y0 - fy) - (x0 - fx) * (y2 - fy)) * inv_area;
        float w2 = 1.0f - w0 - w1;
        if (w0 < 0 || w1 < 0 || w2 < 0) continue;
        // perspective-correct depth
        float iz = w0 * iz0 + w1 * iz1 + w2 * iz2;
        float z = 1.0f / iz;
        size_t pix = (size_t)py * W + px;
        if (z >= zbuf[pix]) continue;
        zbuf[pix] = z;
        out_depth[pix] = z;
        float r = 200, g = 200, b = 200;
        if (has_color) {
          // perspective-correct color interpolation
          float a0 = w0 * iz0 * z, a1 = w1 * iz1 * z, a2 = w2 * iz2 * z;
          r = a0 * m->colors[3 * i0] + a1 * m->colors[3 * i1] + a2 * m->colors[3 * i2];
          g = a0 * m->colors[3 * i0 + 1] + a1 * m->colors[3 * i1 + 1] + a2 * m->colors[3 * i2 + 1];
          b = a0 * m->colors[3 * i0 + 2] + a1 * m->colors[3 * i1 + 2] + a2 * m->colors[3 * i2 + 2];
        }
        out_rgba[4 * pix] = (uint8_t)std::min(255.f, r * shade);
        out_rgba[4 * pix + 1] = (uint8_t)std::min(255.f, g * shade);
        out_rgba[4 * pix + 2] = (uint8_t)std::min(255.f, b * shade);
        out_rgba[4 * pix + 3] = 255;
        if (out_normals) {
          out_normals[3 * pix] = nu[0];
          out_normals[3 * pix + 1] = nu[1];
          out_normals[3 * pix + 2] = nu[2];
        }
      }
    }
  }
  return 0;
}

int grast_render(void* handle, const float* K, const float* T, int W, int H,
                 uint8_t* out_rgba, float* out_depth) {
  return grast_render2(handle, K, T, W, H, out_rgba, out_depth, nullptr);
}

}  // extern "C"
