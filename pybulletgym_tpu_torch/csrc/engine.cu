// CUDA kernels of the env-step engine, for Hopper (sm_90a).
//
// physics_step_kernel replaces the TPU kernel
//   pybulletgym_tpu/ops/pallas_engine.py · make_pallas_physics_step
// (frame_skip substeps: FK, RNE + CRBA, Cholesky, narrowphase, PGS in
// Cholesky square-root space, semi-implicit Euler), and env_step_kernel
// replaces
//   pybulletgym_tpu/ops/pallas_engine.py · make_pallas_env_step
// (auto-reset with Threefry draws, torques, the substeps, obs/reward/
// termination, NaN guard, step count and truncation).
//
// Design: one thread per env, 128 threads a block, any batch size (the
// ragged edge is masked). The algorithm lives once in engine_core.h and
// loops over the model's tables, which each block first copies from device
// memory into shared memory; every thread then reads the same table entry
// at the same time (a broadcast). State is batch-trailing (rows, B), so the
// loads and stores of one row are coalesced across a warp.
//
// What bounds it on this card: not bytes (a HalfCheetah env moves ~200
// bytes a step) but the latency of a few thousand dependent scalar
// float operations per substep and the traffic to local memory: the
// per-thread scratch (M and L are nv*nv, the forward-solved constraint rows
// y_rows are rows*3*nv = 432 floats for HalfCheetah, 1050 for Ant) does not
// fit in registers and lives in local memory, cached in L1/L2; the stack
// frame is sized by the caps (~16 KB), not by the model. Ant's free root
// couples every dof to the root's six, so its M and L are dense and each
// contact row's forward solve runs over all 14 dofs: ~2.3x HalfCheetah's
// operations a step. Models with more dofs and rows (the humanoid's nv=23
// and 95+ rows) would spill far more.
// Making it fast (scratch in shared memory, warp-cooperative solves,
// specialising the loops per model) is later work; this version is the
// plain, correct one.
//
// No atomics and no cross-thread reductions: a launch is bitwise repeatable.

#include <cuda_runtime.h>

#include "engine_core.h"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void load_tables(const eng::Tables* __restrict__ tg,
                                            eng::Tables& t) {
  const int32_t* src = reinterpret_cast<const int32_t*>(tg);
  int32_t* dst = reinterpret_cast<int32_t*>(&t);
  for (int k = threadIdx.x; k < (int)(sizeof(eng::Tables) / 4); k += blockDim.x)
    dst[k] = src[k];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
physics_step_kernel(const eng::Tables* __restrict__ tg, const float* __restrict__ q,
                    const float* __restrict__ v, const float* __restrict__ tau,
                    float* __restrict__ q_out, float* __restrict__ v_out,
                    float* __restrict__ d_out, int B) {
  __shared__ eng::Tables t;
  load_tables(tg, t);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) eng::physics_step_one(t, i, B, q, v, tau, q_out, v_out, d_out);
}

__global__ void __launch_bounds__(kThreads)
env_step_kernel(const eng::Tables* __restrict__ tg, eng::EnvIO io, int B) {
  __shared__ eng::Tables t;
  load_tables(tg, t);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) eng::env_step_one(t, io, i, B);
}

}  // namespace

extern "C" {

int eng_tables_layout(int32_t* out, int cap) { return eng::tables_layout(out, cap); }

int eng_tables_bytes() { return (int)sizeof(eng::Tables); }

// All pointers are device pointers; returns cudaGetLastError() of the launch.
int launch_physics_step(const void* tables, const float* q, const float* v,
                        const float* tau, float* q_out, float* v_out, float* d_out,
                        int B, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  physics_step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const eng::Tables*)tables, q, v, tau, q_out, v_out, d_out, B);
  return (int)cudaGetLastError();
}

int launch_env_step(const void* tables, const float* q, const float* v, const float* act,
                    const float* aux, const uint8_t* term, const uint8_t* trunc,
                    const int32_t* step_count, const uint32_t* epoch, const uint32_t* seed,
                    const int32_t* env_id, float* q_out, float* v_out, float* obs,
                    float* reward, uint8_t* term_out, uint8_t* trunc_out, int32_t* step_out,
                    uint32_t* epoch_out, float* aux_out, float* comps, int B, void* stream) {
  if (B <= 0) return 0;
  eng::EnvIO io = {q, v, act, aux, term, trunc, step_count, epoch, seed, env_id,
                   q_out, v_out, obs, reward, term_out, trunc_out, step_out,
                   epoch_out, aux_out, comps};
  const int blocks = (B + kThreads - 1) / kThreads;
  env_step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const eng::Tables*)tables, io, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
