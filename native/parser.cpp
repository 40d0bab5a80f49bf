// Native .scn scene parser -> JSON.
//
// Native counterpart of the reference's host-side C++ parser
// (`parseScene`, reference src/scene.cpp:12-227): same grammar, same
// semantics as the Python parser in skele_raytracer_tpu/scene/parser.py
// (the semantic source of truth; the two are cross-checked by
// tests/test_native_parser.py). Used for large scene files (dragon.scn is
// ~15k lines) where Python tokenization shows up in end-to-end latency.
//
// ABI: two functions, C linkage. `skt_parse_scene_json(path)` returns a
// heap JSON string (NULL if the file can't be opened); `skt_free` releases
// it. JSON keeps the interface hop trivially versionable.
//
// Semantics mirrored from the reference (each noted in the Python parser):
//  * material state machine: the current material applies to later shapes
//  * triangle indices parsed as floats, truncated
//  * directional_light channels clamped to <= 1.0, light KEPT here (the
//    reference's failure to push_back is a parity-mode drop applied later)
//  * ambient_light accumulates across lines
//  * unknown commands are skipped
//  * missing/invalid fields read as 0.0 (deterministic stand-in for the
//    reference's uninitialized-sscanf-output UB)

#include <algorithm>
#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

namespace {

struct Vec3 {
  double x = 0, y = 0, z = 0;
};

struct Material {
  Vec3 ambient, diffuse, specular, transmissive;
  double power = 1.0, ior = 1.0;
};

struct Sphere {
  Vec3 center;
  double radius = 0;
  Material mat;
};

struct Triangle {
  Vec3 v0, v1, v2;
  Material mat;
};

struct Light {
  Vec3 a;  // position or direction
  Vec3 colour;
};

struct FogVol {
  Vec3 center;
  double radius = 0;
  Vec3 albedo;
  double scattering = 0, absorption = 0;
};

struct Parsed {
  int width = 1920, height = 1080, max_depth = 1;
  std::string output_image;
  Vec3 ambient, background;
  Vec3 cam_pos, cam_dir, cam_up;
  double half_height_angle = 0;
  std::vector<Vec3> vertices;
  std::vector<Sphere> spheres;
  std::vector<Triangle> triangles;
  std::vector<Light> point_lights, directional_lights;
  std::vector<FogVol> fog;
};

double to_f(const std::vector<std::string>& tok, size_t i) {
  if (i >= tok.size()) return 0.0;
  char* end = nullptr;
  double v = std::strtod(tok[i].c_str(), &end);
  return end == tok[i].c_str() ? 0.0 : v;
}

Vec3 to_v3(const std::vector<std::string>& tok, size_t i) {
  return {to_f(tok, i), to_f(tok, i + 1), to_f(tok, i + 2)};
}

void parse_line(const std::string& line, Parsed& out, Material& mat) {
  std::istringstream ss(line);
  std::vector<std::string> tok;
  for (std::string w; ss >> w;) tok.push_back(w);
  if (tok.empty() || tok[0][0] == '#') return;
  const std::string& cmd = tok[0];

  if (cmd == "sphere") {
    Sphere s;
    s.center = to_v3(tok, 1);
    s.radius = to_f(tok, 4);
    s.mat = mat;
    out.spheres.push_back(s);
  } else if (cmd == "vertex") {
    out.vertices.push_back(to_v3(tok, 1));
  } else if (cmd == "triangle") {
    // Indices are read as floats and truncated (reference src/scene.cpp:69-74).
    long i0 = (long)to_f(tok, 1), i1 = (long)to_f(tok, 2), i2 = (long)to_f(tok, 3);
    long n = (long)out.vertices.size();
    if (i0 < 0 || i1 < 0 || i2 < 0 || i0 >= n || i1 >= n || i2 >= n) {
      std::fprintf(stderr, "triangle indices (%ld,%ld,%ld) out of range; skipped\n",
                   i0, i1, i2);
      return;
    }
    Triangle t;
    t.v0 = out.vertices[i0];
    t.v1 = out.vertices[i1];
    t.v2 = out.vertices[i2];
    t.mat = mat;
    out.triangles.push_back(t);
  } else if (cmd == "camera") {
    out.cam_pos = to_v3(tok, 1);
    out.cam_dir = to_v3(tok, 4);
    out.cam_up = to_v3(tok, 7);
    out.half_height_angle = to_f(tok, 10);
  } else if (cmd == "film_resolution") {
    out.width = (int)to_f(tok, 1);
    out.height = (int)to_f(tok, 2);
  } else if (cmd == "background") {
    out.background = to_v3(tok, 1);
  } else if (cmd == "material") {
    mat.ambient = to_v3(tok, 1);
    mat.diffuse = to_v3(tok, 4);
    mat.specular = to_v3(tok, 7);
    mat.power = to_f(tok, 10);
    mat.transmissive = to_v3(tok, 11);
    mat.ior = to_f(tok, 14);
  } else if (cmd == "directional_light") {
    Light l;
    // Channel clamp at 1.0 (reference src/scene.cpp:143-154).
    l.colour = {std::min(to_f(tok, 1), 1.0), std::min(to_f(tok, 2), 1.0),
                std::min(to_f(tok, 3), 1.0)};
    l.a = to_v3(tok, 4);
    out.directional_lights.push_back(l);
  } else if (cmd == "point_light") {
    Light l;
    l.colour = to_v3(tok, 1);
    l.a = to_v3(tok, 4);
    out.point_lights.push_back(l);
  } else if (cmd == "ambient_light") {
    Vec3 v = to_v3(tok, 1);  // accumulates (reference src/scene.cpp:187-189)
    out.ambient.x += v.x;
    out.ambient.y += v.y;
    out.ambient.z += v.z;
  } else if (cmd == "max_depth") {
    out.max_depth = (int)to_f(tok, 1);
  } else if (cmd == "output_image") {
    out.output_image = tok.size() > 1 ? tok[1] : "";
  } else if (cmd == "spherical_fog") {
    FogVol f;
    f.center = to_v3(tok, 1);
    f.radius = to_f(tok, 4);
    f.albedo = to_v3(tok, 5);
    f.scattering = to_f(tok, 8);
    f.absorption = to_f(tok, 9);
    out.fog.push_back(f);
  } else {
    std::fprintf(stderr, "unknown command: %s\n", cmd.c_str());
  }
}

void j_str(std::string& o, const std::string& s) {
  o += '"';
  for (char c : s) {
    switch (c) {
      case '"': o += "\\\""; break;
      case '\\': o += "\\\\"; break;
      case '\n': o += "\\n"; break;
      case '\t': o += "\\t"; break;
      case '\r': o += "\\r"; break;
      default:
        if ((unsigned char)c < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof buf, "\\u%04x", c);
          o += buf;
        } else {
          o += c;
        }
    }
  }
  o += '"';
}

void j_num(std::string& o, double v) {
  char buf[40];
  std::snprintf(buf, sizeof buf, "%.17g", v);
  o += buf;
}

void j_vec(std::string& o, const Vec3& v) {
  o += '[';
  j_num(o, v.x);
  o += ',';
  j_num(o, v.y);
  o += ',';
  j_num(o, v.z);
  o += ']';
}

void j_mat(std::string& o, const Material& m) {
  o += "\"ambient\":";
  j_vec(o, m.ambient);
  o += ",\"diffuse\":";
  j_vec(o, m.diffuse);
  o += ",\"specular\":";
  j_vec(o, m.specular);
  o += ",\"transmissive\":";
  j_vec(o, m.transmissive);
  o += ",\"power\":";
  j_num(o, m.power);
  o += ",\"ior\":";
  j_num(o, m.ior);
}

std::string to_json(const Parsed& p) {
  std::string o;
  o.reserve(1 << 16);
  o += '{';
  o += "\"width\":";
  j_num(o, p.width);
  o += ",\"height\":";
  j_num(o, p.height);
  o += ",\"max_depth\":";
  j_num(o, p.max_depth);
  o += ",\"output_image\":";
  j_str(o, p.output_image);
  o += ",\"ambient\":";
  j_vec(o, p.ambient);
  o += ",\"background\":";
  j_vec(o, p.background);
  o += ",\"camera\":{\"position\":";
  j_vec(o, p.cam_pos);
  o += ",\"direction\":";
  j_vec(o, p.cam_dir);
  o += ",\"up\":";
  j_vec(o, p.cam_up);
  o += ",\"half_height_angle\":";
  j_num(o, p.half_height_angle);
  o += '}';

  o += ",\"vertices\":[";
  for (size_t i = 0; i < p.vertices.size(); ++i) {
    if (i) o += ',';
    j_vec(o, p.vertices[i]);
  }
  o += "],\"spheres\":[";
  for (size_t i = 0; i < p.spheres.size(); ++i) {
    if (i) o += ',';
    o += "{\"center\":";
    j_vec(o, p.spheres[i].center);
    o += ",\"radius\":";
    j_num(o, p.spheres[i].radius);
    o += ',';
    j_mat(o, p.spheres[i].mat);
    o += '}';
  }
  o += "],\"triangles\":[";
  for (size_t i = 0; i < p.triangles.size(); ++i) {
    if (i) o += ',';
    o += "{\"v0\":";
    j_vec(o, p.triangles[i].v0);
    o += ",\"v1\":";
    j_vec(o, p.triangles[i].v1);
    o += ",\"v2\":";
    j_vec(o, p.triangles[i].v2);
    o += ',';
    j_mat(o, p.triangles[i].mat);
    o += '}';
  }
  o += "],\"point_lights\":[";
  for (size_t i = 0; i < p.point_lights.size(); ++i) {
    if (i) o += ',';
    o += "{\"position\":";
    j_vec(o, p.point_lights[i].a);
    o += ",\"colour\":";
    j_vec(o, p.point_lights[i].colour);
    o += '}';
  }
  o += "],\"directional_lights\":[";
  for (size_t i = 0; i < p.directional_lights.size(); ++i) {
    if (i) o += ',';
    o += "{\"direction\":";
    j_vec(o, p.directional_lights[i].a);
    o += ",\"colour\":";
    j_vec(o, p.directional_lights[i].colour);
    o += '}';
  }
  o += "],\"fog\":[";
  for (size_t i = 0; i < p.fog.size(); ++i) {
    if (i) o += ',';
    o += "{\"center\":";
    j_vec(o, p.fog[i].center);
    o += ",\"radius\":";
    j_num(o, p.fog[i].radius);
    o += ",\"albedo\":";
    j_vec(o, p.fog[i].albedo);
    o += ",\"scattering\":";
    j_num(o, p.fog[i].scattering);
    o += ",\"absorption\":";
    j_num(o, p.fog[i].absorption);
    o += '}';
  }
  o += "]}";
  return o;
}

}  // namespace

extern "C" {

// Binary P6 PPM writer with the reference's quantization (min(1, v) * 255
// per channel, reference src/main.cpp:88-101). `data` is [h*w*3] float32
// radiance. Returns 0 on success. The native path quantizes + streams the
// 6 MB 1080p raster without a Python-side uint8 copy.
int skt_write_ppm(const char* path, int w, int h, const float* data) {
  std::FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  std::fprintf(f, "P6\n%d %d\n255\n", w, h);
  const size_t n = (size_t)w * h * 3;
  std::vector<unsigned char> row(n < 4096 ? n : 4096);
  size_t i = 0;
  while (i < n) {
    size_t chunk = std::min(row.size(), n - i);
    for (size_t j = 0; j < chunk; ++j) {
      float v = data[i + j];
      if (v < 0.0f) v = 0.0f;
      if (v > 1.0f) v = 1.0f;
      row[j] = (unsigned char)(v * 255.0f);
    }
    if (std::fwrite(row.data(), 1, chunk, f) != chunk) {
      std::fclose(f);
      return 2;
    }
    i += chunk;
  }
  return std::fclose(f) == 0 ? 0 : 3;
}

char* skt_parse_scene_json(const char* path) {
  std::ifstream in(path);
  if (!in) return nullptr;
  Parsed p;
  Material mat;
  for (std::string line; std::getline(in, line);) parse_line(line, p, mat);
  std::string json = to_json(p);
  char* out = (char*)std::malloc(json.size() + 1);
  std::memcpy(out, json.c_str(), json.size() + 1);
  return out;
}

void skt_free(void* p) { std::free(p); }

}  // extern "C"
