// Host twin of engine.cu, for the CPU tests only: the same engine_core.h
// arithmetic in a loop over envs, built with g++ -O2 -ffp-contract=off and
// loaded through ctypes. It lets a machine without a GPU run the kernels'
// own C++ against the plain PyTorch version. No env path routes to it.

#include "engine_core.h"

extern "C" {

int eng_tables_layout(int32_t* out, int cap) { return eng::tables_layout(out, cap); }

int eng_tables_bytes() { return (int)sizeof(eng::Tables); }

// caps_id picks the instantiation, as in engine.cu; returns 1 for an
// unknown one.
int host_physics_step(const void* tables, const float* q, const float* v, const float* tau,
                      float* q_out, float* v_out, float* d_out, int B, int caps_id) {
  const eng::Tables& t = *(const eng::Tables*)tables;
  for (int i = 0; i < B; ++i) {
    if (caps_id == eng::CapsWalker::ID)
      eng::physics_step_one<eng::CapsWalker>(t, i, B, q, v, tau, q_out, v_out, d_out);
    else if (caps_id == eng::CapsLarge::ID)
      eng::physics_step_one<eng::CapsLarge>(t, i, B, q, v, tau, q_out, v_out, d_out);
    else
      return 1;
  }
  return 0;
}

int host_env_step(const void* tables, const float* q, const float* v, const float* act,
                  const float* aux, const uint8_t* term, const uint8_t* trunc,
                  const int32_t* step_count, const uint32_t* epoch, const uint32_t* seed,
                  const int32_t* env_id, float* q_out, float* v_out, float* obs,
                  float* reward, uint8_t* term_out, uint8_t* trunc_out, int32_t* step_out,
                  uint32_t* epoch_out, float* aux_out, float* comps, int B, int caps_id) {
  const eng::Tables& t = *(const eng::Tables*)tables;
  eng::EnvIO io = {q, v, act, aux, term, trunc, step_count, epoch, seed, env_id,
                   q_out, v_out, obs, reward, term_out, trunc_out, step_out,
                   epoch_out, aux_out, comps};
  for (int i = 0; i < B; ++i) {
    if (caps_id == eng::CapsWalker::ID)
      eng::env_step_one<eng::CapsWalker>(t, io, i, B);
    else if (caps_id == eng::CapsLarge::ID)
      eng::env_step_one<eng::CapsLarge>(t, io, i, B);
    else
      return 1;
  }
  return 0;
}

}  // extern "C"
