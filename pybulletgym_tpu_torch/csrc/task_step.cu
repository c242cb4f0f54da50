// CUDA kernel of the env step of any task, for Hopper (sm_90a): one
// launch an env step, the counterpart of the TPU kernel that
//   pybulletgym_tpu/ops/pallas_engine.py · make_pallas_env_step
// traces for any task. Built per task by ops/task_kernel.py: nvcc
// -DENG_LANES=G -include <the task's generated hooks header> task_step.cu.
// The hooks run in the leader lane of each env's group (task_core.h), the
// substeps of engine_core.h on the whole group, with the scratch in
// dynamic shared memory as in engine.cu. Built with -DENG_BIG_TABLES for a
// model over the default caps (engine_core.h's large class), with
// -DENG_HUGE_TABLES for a model over the large caps or whose scratch
// outgrows shared memory, or with -DENG_SIZED_TABLES and the model's caps
// (-DSIZED_MAX_*) for any larger model: the kernel then reads the tables
// from a copy in global memory (ENG_TABLES_PARAM), runs the default class's
// substep with the sweep by row windows, and keeps the whole scratch in a device buffer of B
// envs' slices (buf, after the tables), no shared memory, as engine.cu's
// large, huge and sized builds.

#include <cuda_runtime.h>

#include "task_core.h"

#ifndef ENG_LANES
#error "build with -DENG_LANES=G (G: 4, 8, 16 or 32)"
#endif

namespace {

constexpr int G = ENG_LANES;
constexpr int kMaxThreads = 128;    // E * G
constexpr int kMaxShared = 232448;  // 227 KB: a block's dynamic shared memory on sm_90

// As engine.cu · shared_bytes: none in the large, huge and sized builds.
size_t shared_bytes(int E, int stride) {
#ifdef ENG_GLOBAL_TABLES
  (void)E, (void)stride;
  return 0;
#else
  return (size_t)E * stride * sizeof(float);
#endif
}

__device__ __forceinline__ eng::Group<G> my_group() {
  const int wl = threadIdx.x & 31;
  const uint32_t ones = G == 32 ? 0xffffffffu : ((1u << G) - 1u);
  eng::Group<G> g;
  g.lane = wl & (G - 1);
  g.mask = ones << (wl & ~(G - 1));
  return g;
}

__global__ void __launch_bounds__(kMaxThreads)
task_step_kernel(ENG_TABLES_PARAM, ENG_BUF_PARAM eng::EnvIO io, int B) {
  ENG_TABLES_BIND
  extern __shared__ float smem[];
  const int E = blockDim.x / G, e = threadIdx.x / G;
  const int i = blockIdx.x * E + e;
  if (i >= B) return;
  eng::task_step_one<G>(t, io, my_group(), ENG_ENV_SCRATCH(e, i), i, B);
}

}  // namespace

extern "C" {

int eng_lanes() { return G; }

int eng_tables_layout(int32_t* out, int cap) { return eng::tables_layout(out, cap); }

int eng_tables_bytes() { return (int)sizeof(eng::Tables); }

// As engine.cu · eng_launch_config, for task_step_kernel: out[0] = E, the
// envs a block, out[1] = resident blocks per SM, out[2] = dynamic shared
// bytes a block, out[3] = registers a thread, out[4] = local (stack) bytes
// a thread.
int task_launch_config(int stride, int32_t* out) {
  const void* fn = (const void*)task_step_kernel;
#ifdef ENG_GLOBAL_TABLES
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxL1);
#else
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
#endif
  if (err != cudaSuccess) return (int)err;
  int best_e = 0, best_blocks = 0;
  for (int E = 1; E * G <= kMaxThreads; E *= 2) {
    const size_t bytes = shared_bytes(E, stride);
    if (bytes > kMaxShared) break;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, E * G, bytes);
    if (err != cudaSuccess) return (int)err;
    if (blocks * E >= best_blocks * best_e) {
      best_e = E;
      best_blocks = blocks;
    }
  }
  if (best_e == 0 || best_blocks == 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = best_e;
  out[1] = best_blocks;
  out[2] = (int32_t)shared_bytes(best_e, stride);
  out[3] = attr.numRegs;
  out[4] = (int32_t)attr.localSizeBytes;
  return 0;
}

// The arguments of engine.cu · launch_env_step (in the large, huge and
// sized builds, the device copy of the tables after the host one, as
// launch_physics_step, then its buffer).
int launch_task_step(const void* tables, ENG_DEV_TABLES ENG_BUF_PARAM const float* q, const float* v,
                     const float* act, const float* aux, const uint8_t* term, const uint8_t* trunc,
                     const int32_t* step_count, const uint32_t* epoch, const uint32_t* seed,
                     const int32_t* env_id, float* q_out, float* v_out, float* obs,
                     float* reward, uint8_t* term_out, uint8_t* trunc_out, int32_t* step_out,
                     uint32_t* epoch_out, float* aux_out, float* comps, int B, int E,
                     void* stream) {
  if (B <= 0) return 0;
  eng::EnvIO io = {q, v, act, aux, term, trunc, step_count, epoch, seed, env_id,
                   q_out, v_out, obs, reward, term_out, trunc_out, step_out,
                   epoch_out, aux_out, comps};
  const eng::Tables& tg = *(const eng::Tables*)tables;
  if (tg.lanes != G || tg.nv > eng::lane_nv<G>() || E < 1 || E * G > kMaxThreads ||
      shared_bytes(E, tg.sc_stride) > kMaxShared)
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + E - 1) / E;
  task_step_kernel<<<blocks, E * G, shared_bytes(E, tg.sc_stride), (cudaStream_t)stream>>>(
      ENG_KERNEL_TABLES(tg), ENG_KERNEL_BUF io, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
