// Native host-side renderer: the TPU-suite equivalent of the reference's
// C++ TinyRenderer rasterizer behind p.getCameraImage
// [ref: env_bases.py · BaseBulletEnv.render — SURVEY §3.4].
//
// Analytic ray tracer over the engine's primitive geoms (sphere, capsule,
// cylinder-as-capsule, box, ground plane): one ray per pixel, nearest-hit
// shading with Lambert + checkerboard floor. ~2 ms for 320x240 with ~20
// geoms at -O2 — easily real-time for debug viewing, entirely off the
// training path.
//
// C ABI (ctypes): each geom is 24 floats:
//   [0]  type:   1=sphere 2=capsule 4=box
//   [1]  radius (sphere/capsule)
//   [2..4]   p0 (sphere center / capsule end A / box center)
//   [5..7]   p1 (capsule end B; unused otherwise)
//   [8..16]  R row-major world rotation (box only)
//   [17..19] half-sizes (box only)
//   [20..22] rgb in [0,1]
//   [23] unused
//
// build: g++ -O2 -shared -fPIC -o librender.so render.cpp

#include <cmath>
#include <cstdint>
#include <algorithm>

namespace {

struct V3 {
  float x, y, z;
};
static inline V3 v(float a, float b, float c) { return {a, b, c}; }
static inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 operator*(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
static inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float norm(V3 a) { return std::sqrt(dot(a, a)); }
static inline V3 normalize(V3 a) {
  float n = norm(a);
  return n > 1e-12f ? (1.0f / n) * a : v(0, 0, 1);
}

constexpr float INF = 1e30f;

// ray-sphere: returns t or INF
static float hit_sphere(V3 o, V3 d, V3 c, float r, V3* n) {
  V3 oc = o - c;
  float b = dot(oc, d);
  float disc = b * b - (dot(oc, oc) - r * r);
  if (disc < 0) return INF;
  float t = -b - std::sqrt(disc);
  if (t < 1e-4f) return INF;
  V3 p = o + t * d;
  *n = normalize(p - c);
  return t;
}

// ray-capsule (segment a-b, radius r): infinite-cylinder test clamped to
// the segment plus end-sphere tests.
static float hit_capsule(V3 o, V3 d, V3 a, V3 b, float r, V3* n) {
  V3 ab = b - a;
  float L2 = dot(ab, ab);
  float best = INF;
  V3 bn = {0, 0, 1};
  if (L2 > 1e-12f) {
    V3 u = (1.0f / std::sqrt(L2)) * ab;
    V3 oa = o - a;
    V3 dp = d - dot(d, u) * u;
    V3 op = oa - dot(oa, u) * u;
    float A = dot(dp, dp);
    if (A > 1e-12f) {
      float B = dot(dp, op);
      float C = dot(op, op) - r * r;
      float disc = B * B - A * C;
      if (disc >= 0) {
        float t = (-B - std::sqrt(disc)) / A;
        if (t > 1e-4f) {
          V3 p = o + t * d;
          float s = dot(p - a, u);
          if (s >= 0 && s * s <= L2) {
            best = t;
            bn = normalize(p - (a + s * u));
          }
        }
      }
    }
  }
  V3 ns;
  float t = hit_sphere(o, d, a, r, &ns);
  if (t < best) { best = t; bn = ns; }
  t = hit_sphere(o, d, b, r, &ns);
  if (t < best) { best = t; bn = ns; }
  *n = bn;
  return best;
}

// ray-OBB (center c, rotation R row-major world<-local, half h)
static float hit_box(V3 o, V3 d, V3 c, const float* R, V3 h, V3* n) {
  // to local frame: l = R^T (w - c)
  V3 rel = o - c;
  V3 lo = v(R[0] * rel.x + R[3] * rel.y + R[6] * rel.z,
            R[1] * rel.x + R[4] * rel.y + R[7] * rel.z,
            R[2] * rel.x + R[5] * rel.y + R[8] * rel.z);
  V3 ld = v(R[0] * d.x + R[3] * d.y + R[6] * d.z,
            R[1] * d.x + R[4] * d.y + R[7] * d.z,
            R[2] * d.x + R[5] * d.y + R[8] * d.z);
  float tmin = -INF, tmax = INF;
  int axis = 0;
  float side = 1.0f;
  const float lov[3] = {lo.x, lo.y, lo.z}, ldv[3] = {ld.x, ld.y, ld.z},
              hv[3] = {h.x, h.y, h.z};
  for (int i = 0; i < 3; ++i) {
    if (std::fabs(ldv[i]) < 1e-9f) {
      if (std::fabs(lov[i]) > hv[i]) return INF;
      continue;
    }
    float inv = 1.0f / ldv[i];
    float t1 = (-hv[i] - lov[i]) * inv, t2 = (hv[i] - lov[i]) * inv;
    float s = -1.0f;
    if (t1 > t2) { std::swap(t1, t2); s = 1.0f; }
    if (t1 > tmin) { tmin = t1; axis = i; side = s; }
    tmax = std::min(tmax, t2);
    if (tmin > tmax) return INF;
  }
  if (tmin < 1e-4f) return INF;
  // local normal -> world (row-major R maps local->world as R * nl)
  float nl[3] = {0, 0, 0};
  nl[axis] = side;
  *n = v(R[0] * nl[0] + R[1] * nl[1] + R[2] * nl[2],
         R[3] * nl[0] + R[4] * nl[1] + R[5] * nl[2],
         R[6] * nl[0] + R[7] * nl[1] + R[8] * nl[2]);
  return tmin;
}

}  // namespace

extern "C" {

// geoms: n x 24 floats (layout above). cam_target/cam params follow the
// reference camera: follow target, distance, yaw (deg), pitch (deg)
// [ref: env_bases.py · Camera/camera_adjust].
void render_rgb(const float* geoms, int n, const float* cam_target,
                float cam_dist, float yaw_deg, float pitch_deg,
                uint8_t* out, int width, int height) {
  const float deg = 0.017453292519943295f;
  float cy = std::cos(yaw_deg * deg), sy = std::sin(yaw_deg * deg);
  float cp = std::cos(pitch_deg * deg), sp = std::sin(pitch_deg * deg);
  V3 target = v(cam_target[0], cam_target[1], cam_target[2]);
  // camera on a yaw/pitch orbit around the target
  V3 eye = target + cam_dist * v(cy * cp, sy * cp, -sp);
  V3 fwd = normalize(target - eye);
  V3 right = normalize(cross(fwd, v(0, 0, 1)));
  V3 up = cross(right, fwd);
  float fov = 60.0f * deg;
  float tanf2 = std::tan(fov / 2);
  float aspect = float(width) / float(height);

  V3 light = normalize(v(-0.4f, 0.3f, 0.85f));

  for (int py = 0; py < height; ++py) {
    for (int px = 0; px < width; ++px) {
      float ux = (2.0f * (px + 0.5f) / width - 1.0f) * tanf2 * aspect;
      float uy = (1.0f - 2.0f * (py + 0.5f) / height) * tanf2;
      V3 d = normalize(fwd + ux * right + uy * up);

      float best = INF;
      V3 bn = {0, 0, 1}, color = {1, 1, 1};
      for (int i = 0; i < n; ++i) {
        const float* g = geoms + 24 * i;
        V3 nrm;
        float t = INF;
        int type = int(g[0]);
        V3 p0 = v(g[2], g[3], g[4]);
        if (type == 1) {
          t = hit_sphere(eye, d, p0, g[1], &nrm);
        } else if (type == 2) {
          t = hit_capsule(eye, d, p0, v(g[5], g[6], g[7]), g[1], &nrm);
        } else if (type == 4) {
          t = hit_box(eye, d, p0, g + 8, v(g[17], g[18], g[19]), &nrm);
        }
        if (t < best) {
          best = t;
          bn = nrm;
          color = v(g[20], g[21], g[22]);
        }
      }
      // ground plane z=0
      if (d.z < -1e-6f) {
        float t = -eye.z / d.z;
        if (t > 1e-4f && t < best) {
          best = t;
          bn = v(0, 0, 1);
          V3 p = eye + t * d;
          int check = (int(std::floor(p.x)) + int(std::floor(p.y))) & 1;
          color = check ? v(0.55f, 0.70f, 0.55f) : v(0.45f, 0.62f, 0.45f);
        }
      }

      uint8_t* px_out = out + 3 * (py * width + px);
      if (best >= INF) {  // sky gradient
        float tsky = 0.5f * (d.z + 1.0f);
        px_out[0] = uint8_t(200 - 60 * tsky);
        px_out[1] = uint8_t(220 - 40 * tsky);
        px_out[2] = 255;
        continue;
      }
      float lambert = std::max(0.0f, dot(bn, light));
      float shade = 0.35f + 0.65f * lambert;
      px_out[0] = uint8_t(std::min(255.0f, 255.0f * color.x * shade));
      px_out[1] = uint8_t(std::min(255.0f, 255.0f * color.y * shade));
      px_out[2] = uint8_t(std::min(255.0f, 255.0f * color.z * shade));
    }
  }
}

}  // extern "C"
