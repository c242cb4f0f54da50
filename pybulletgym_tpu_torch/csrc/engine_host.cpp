// Host twin of engine.cu, for the CPU tests only: the same engine_core.h
// arithmetic in a loop over envs, each env's lane group emulated (EACH_LANE
// loops over the lanes, group_sum replays the card's butterfly), built with
// g++ -O2 -ffp-contract=off and loaded through ctypes. It lets a machine
// without a GPU run the kernels' own C++ against the plain PyTorch version,
// at every group width, and in each size class of the tables (built with
// -DENG_BIG_TABLES, -DENG_HUGE_TABLES or -DENG_SIZED_TABLES and the model's
// -DSIZED_MAX_* caps, as the card's large, huge and sized libraries are).
// No env path routes to it.

#include <vector>

#include "engine_core.h"

namespace {

template <int G>
void physics(const eng::Tables& t, const float* q, const float* v, const float* tau,
             float* q_out, float* v_out, float* d_out, int B) {
  std::vector<float> scratch(t.sc_stride);
  const eng::Group<G> g = {0, 0u};
  for (int i = 0; i < B; ++i)
    eng::physics_step_one<G>(t, g, scratch.data(), i, B, q, v, tau, q_out, v_out, d_out);
}

// Env i's physics step alone, its scratch copied out (tests only: L, M and
// the forward-solved rows as the step leaves them; with the tables'
// stop_after, as a substep leaves them when it stops).
template <int G>
void physics_scratch(const eng::Tables& t, const float* q, const float* v, const float* tau,
                     int i, int B, float* out) {
  std::vector<float> q_out(t.nq * B), v_out(t.nv * B), d_out(t.nr * B + 1);
  const eng::Group<G> g = {0, 0u};
  eng::physics_step_one<G>(t, g, out, i, B, q, v, tau, q_out.data(), v_out.data(), d_out.data());
}

template <int G>
void env(const eng::Tables& t, const eng::EnvIO& io, int B) {
  std::vector<float> scratch(t.sc_stride);
  const eng::Group<G> g = {0, 0u};
  for (int i = 0; i < B; ++i) eng::env_step_one<G>(t, io, g, scratch.data(), i, B);
}

// The group widths the libraries are built for (ops/cuda_engine.py ·
// LANE_WIDTHS); tables of any other width are refused.
template <template <int> class F, class... A>
int by_lanes(int lanes, A&&... a) {
  switch (lanes) {
    case 4: F<4>::run(a...); return 0;
    case 8: F<8>::run(a...); return 0;
    case 16: F<16>::run(a...); return 0;
    case 32: F<32>::run(a...); return 0;
    default: return 1;
  }
}

template <int G>
struct Physics {
  template <class... A>
  static void run(A&&... a) { physics<G>(a...); }
};

template <int G>
struct Scratch {
  template <class... A>
  static void run(A&&... a) { physics_scratch<G>(a...); }
};

template <int G>
struct Env {
  template <class... A>
  static void run(A&&... a) { env<G>(a...); }
};

}  // namespace

extern "C" {

int eng_tables_layout(int32_t* out, int cap) { return eng::tables_layout(out, cap); }

int eng_tables_bytes() { return (int)sizeof(eng::Tables); }

// The butterflies the twin has run since the last call (engine_core.h ·
// host_group_sums: a group_sum, group_sum2 or group_sum4 is one); the count
// starts again from 0.
long long host_group_sums_take() {
  const long long n = eng::host_group_sums();
  eng::host_group_sums() = 0;
  return n;
}

// Returns 1 for tables of a group width the twin is not built for.
int host_physics_step(const void* tables, const float* q, const float* v, const float* tau,
                      float* q_out, float* v_out, float* d_out, int B) {
  const eng::Tables& t = *(const eng::Tables*)tables;
  return by_lanes<Physics>(t.lanes, t, q, v, tau, q_out, v_out, d_out, B);
}

// `out`: tables.sc_stride floats
int host_physics_scratch(const void* tables, const float* q, const float* v, const float* tau,
                         int i, int B, float* out) {
  const eng::Tables& t = *(const eng::Tables*)tables;
  return by_lanes<Scratch>(t.lanes, t, q, v, tau, i, B, out);
}

int host_env_step(const void* tables, const float* q, const float* v, const float* act,
                  const float* aux, const uint8_t* term, const uint8_t* trunc,
                  const int32_t* step_count, const uint32_t* epoch, const uint32_t* seed,
                  const int32_t* env_id, float* q_out, float* v_out, float* obs,
                  float* reward, uint8_t* term_out, uint8_t* trunc_out, int32_t* step_out,
                  uint32_t* epoch_out, float* aux_out, float* comps, int B) {
  const eng::Tables& t = *(const eng::Tables*)tables;
  eng::EnvIO io = {q, v, act, aux, term, trunc, step_count, epoch, seed, env_id,
                   q_out, v_out, obs, reward, term_out, trunc_out, step_out,
                   epoch_out, aux_out, comps};
  return by_lanes<Env>(t.lanes, t, io, B);
}

}  // extern "C"
