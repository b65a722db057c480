// Native asset-IO runtime for cpuvox_tpu_torch (a copy of csrc/voxio.cpp).
//
// The reference parses .obj with a streaming C# reader (Assets/Code/Utils/
// ObjModel.cs:10-196) and reports ~30 s for the 800 MB powerplant model
// (README.md:69).  This is the equivalent native tier for the TPU build: a
// single-pass .obj parser that emits flat arrays (positions, vertex colors, uvs,
// material ids) ready to wrap as numpy, exposed through a C ABI consumed via
// ctypes (cpuvox_tpu_torch/assets/native.py).  Faces are fan-triangulated and negative
// (relative) indices resolve per the .obj spec.
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC voxio.cpp -o libvoxio.so

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct V3 { float x, y, z; };
struct V2 { float u, v; };

struct ObjData {
  std::vector<V3> out_pos;       // per emitted vertex
  std::vector<uint8_t> out_col;  // rgba per emitted vertex
  std::vector<V2> out_uv;
  std::vector<int32_t> out_mat;
  std::string mtllib;            // relative path from the obj, if any
  std::string material_names;    // '\n'-joined, in first-use order
  std::string error;
};

// fast float parse: sign, int part, frac part, exponent
inline const char* parse_float(const char* p, float* out) {
  while (*p == ' ' || *p == '\t') p++;
  bool neg = false;
  if (*p == '-') { neg = true; p++; }
  else if (*p == '+') p++;
  double v = 0.0;
  while (*p >= '0' && *p <= '9') { v = v * 10.0 + (*p - '0'); p++; }
  if (*p == '.') {
    p++;
    double scale = 0.1;
    while (*p >= '0' && *p <= '9') { v += (*p - '0') * scale; scale *= 0.1; p++; }
  }
  if (*p == 'e' || *p == 'E') {
    p++;
    bool eneg = false;
    if (*p == '-') { eneg = true; p++; } else if (*p == '+') p++;
    int e = 0;
    while (*p >= '0' && *p <= '9') { e = e * 10 + (*p - '0'); p++; }
    double pw = 1.0;
    for (int i = 0; i < e; i++) pw *= 10.0;
    v = eneg ? v / pw : v * pw;
  }
  *out = neg ? (float)-v : (float)v;
  return p;
}

inline const char* parse_int(const char* p, long* out) {
  while (*p == ' ' || *p == '\t') p++;
  bool neg = false;
  if (*p == '-') { neg = true; p++; }
  long v = 0;
  while (*p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); p++; }
  *out = neg ? -v : v;
  return p;
}

struct FaceEntry { long v; long vt; };

}  // namespace

extern "C" {

void* voxio_obj_parse(const char* path, int swap_yz) {
  FILE* f = fopen(path, "rb");
  auto* d = new ObjData();
  if (!f) {
    d->error = "cannot open file";
    return d;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* buf = (char*)malloc(size + 2);
  if (!buf) { d->error = "oom"; fclose(f); return d; }
  size_t rd = fread(buf, 1, size, f);
  fclose(f);
  buf[rd] = '\n';
  buf[rd + 1] = 0;

  std::vector<V3> positions;
  std::vector<uint8_t> colors;  // rgb per position
  std::vector<V2> uvs;
  std::vector<FaceEntry> face;
  face.reserve(8);

  int active_mat = -1;
  std::vector<std::string> mat_names;

  const char* p = buf;
  const char* end = buf + rd;
  while (p < end) {
    // line starts at p
    if (p[0] == 'v' && p[1] == ' ') {
      p += 2;
      V3 v;
      p = parse_float(p, &v.x);
      p = parse_float(p, &v.y);
      p = parse_float(p, &v.z);
      if (swap_yz) { float t = v.y; v.y = v.z; v.z = t; }
      positions.push_back(v);
      // optional vertex color extension (ObjModel.cs:71-75)
      float r = 1.f, g = 1.f, b = 1.f;
      const char* q = p;
      while (*q == ' ' || *q == '\t') q++;
      if (*q != '\n' && *q != '\r' && *q != 0) {
        p = parse_float(p, &r);
        p = parse_float(p, &g);
        const char* q2 = p;
        while (*q2 == ' ' || *q2 == '\t') q2++;
        if (*q2 != '\n' && *q2 != '\r') {
          p = parse_float(p, &b);
        } else {  // only 5 floats: not a color line; treat as white
          r = g = b = 1.f;
        }
      }
      auto clamp255 = [](float c) {
        float s = c * 255.0f + 0.5f;
        if (s < 0) s = 0;
        if (s > 255) s = 255;
        return (uint8_t)s;
      };
      colors.push_back(clamp255(r));
      colors.push_back(clamp255(g));
      colors.push_back(clamp255(b));
    } else if (p[0] == 'v' && p[1] == 't' && p[2] == ' ') {
      p += 3;
      V2 t;
      p = parse_float(p, &t.u);
      p = parse_float(p, &t.v);
      uvs.push_back(t);
    } else if (p[0] == 'f' && p[1] == ' ') {
      p += 2;
      face.clear();
      while (true) {
        while (*p == ' ' || *p == '\t') p++;
        if (*p == '\n' || *p == '\r' || *p == 0) break;
        long vi = 0, ti = 0;
        bool has_t = false;
        p = parse_int(p, &vi);
        if (*p == '/') {
          p++;
          if (*p != '/' && *p != ' ') {
            p = parse_int(p, &ti);
            has_t = true;
          }
          if (*p == '/') {
            p++;
            long ni;
            p = parse_int(p, &ni);  // normals ignored (ObjModel.cs:42)
          }
        }
        long vr = vi > 0 ? vi - 1 : (long)positions.size() + vi;
        long tr = !has_t ? -1 : (ti > 0 ? ti - 1 : (long)uvs.size() + ti);
        face.push_back({vr, tr});
      }
      for (size_t k = 1; k + 1 < face.size(); k++) {  // fan triangulation
        const FaceEntry tri[3] = {face[0], face[k], face[k + 1]};
        for (const auto& fe : tri) {
          if (fe.v < 0 || fe.v >= (long)positions.size()) continue;
          d->out_pos.push_back(positions[fe.v]);
          d->out_col.push_back(colors[fe.v * 3 + 0]);
          d->out_col.push_back(colors[fe.v * 3 + 1]);
          d->out_col.push_back(colors[fe.v * 3 + 2]);
          d->out_col.push_back(255);
          if (fe.vt >= 0 && fe.vt < (long)uvs.size()) {
            d->out_uv.push_back(uvs[fe.vt]);
          } else {
            d->out_uv.push_back({0.f, 0.f});
          }
          d->out_mat.push_back(active_mat);
        }
      }
    } else if (!strncmp(p, "usemtl ", 7)) {
      p += 7;
      const char* e = p;
      while (*e && *e != '\n' && *e != '\r') e++;
      std::string name(p, e - p);
      active_mat = -1;
      for (size_t i = 0; i < mat_names.size(); i++) {
        if (mat_names[i] == name) { active_mat = (int)i; break; }
      }
      if (active_mat < 0) {
        mat_names.push_back(name);
        active_mat = (int)mat_names.size() - 1;
      }
    } else if (!strncmp(p, "mtllib ", 7)) {
      p += 7;
      const char* e = p;
      while (*e && *e != '\n' && *e != '\r') e++;
      d->mtllib = std::string(p, e - p);
    }
    while (p < end && *p != '\n') p++;
    p++;  // skip newline
  }
  free(buf);
  std::string joined;
  for (size_t i = 0; i < mat_names.size(); i++) {
    if (i) joined += '\n';
    joined += mat_names[i];
  }
  d->material_names = joined;
  return d;
}

long voxio_obj_vertex_count(void* h) {
  return (long)((ObjData*)h)->out_pos.size();
}

const char* voxio_obj_error(void* h) { return ((ObjData*)h)->error.c_str(); }
const char* voxio_obj_mtllib(void* h) { return ((ObjData*)h)->mtllib.c_str(); }
const char* voxio_obj_materials(void* h) {
  return ((ObjData*)h)->material_names.c_str();
}

void voxio_obj_fill(void* h, float* positions, uint8_t* colors, float* uvs,
                    int32_t* mats) {
  ObjData* d = (ObjData*)h;
  size_t n = d->out_pos.size();
  memcpy(positions, d->out_pos.data(), n * sizeof(V3));
  memcpy(colors, d->out_col.data(), n * 4);
  memcpy(uvs, d->out_uv.data(), n * sizeof(V2));
  memcpy(mats, d->out_mat.data(), n * sizeof(int32_t));
}

void voxio_obj_close(void* h) { delete (ObjData*)h; }

}  // extern "C"
