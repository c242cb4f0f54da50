// Host twin of task_step.cu, for the CPU tests only: task_core.h in a loop
// over envs (each env's lane group emulated as in engine_host.cpp), built
// per task by ops/task_kernel.py with g++ -O1 -ffp-contract=off -include
// <the task's generated hooks header>, and -DENG_BIG_TABLES,
// -DENG_HUGE_TABLES or -DENG_SIZED_TABLES (with the model's -DSIZED_MAX_*
// caps) for a model of the large, huge or sized class, as task_step.cu is.
// No env path routes to it.

#include <vector>

#include "task_core.h"

namespace {

template <int G>
void run(const eng::Tables& t, const eng::EnvIO& io, int B) {
  std::vector<float> scratch(t.sc_stride);
  const eng::Group<G> g = {0, 0u};
  for (int i = 0; i < B; ++i) eng::task_step_one<G>(t, io, g, scratch.data(), i, B);
}

}  // namespace

extern "C" {

int eng_tables_layout(int32_t* out, int cap) { return eng::tables_layout(out, cap); }

int eng_tables_bytes() { return (int)sizeof(eng::Tables); }

// Returns 1 for tables of a group width the twin is not built for.
int host_task_step(const void* tables, const float* q, const float* v, const float* act,
                   const float* aux, const uint8_t* term, const uint8_t* trunc,
                   const int32_t* step_count, const uint32_t* epoch, const uint32_t* seed,
                   const int32_t* env_id, float* q_out, float* v_out, float* obs,
                   float* reward, uint8_t* term_out, uint8_t* trunc_out, int32_t* step_out,
                   uint32_t* epoch_out, float* aux_out, float* comps, int B) {
  const eng::Tables& t = *(const eng::Tables*)tables;
  eng::EnvIO io = {q, v, act, aux, term, trunc, step_count, epoch, seed, env_id,
                   q_out, v_out, obs, reward, term_out, trunc_out, step_out,
                   epoch_out, aux_out, comps};
  switch (t.lanes) {
    case 4: run<4>(t, io, B); return 0;
    case 8: run<8>(t, io, B); return 0;
    case 16: run<16>(t, io, B); return 0;
    case 32: run<32>(t, io, B); return 0;
    default: return 1;
  }
}

}  // extern "C"
