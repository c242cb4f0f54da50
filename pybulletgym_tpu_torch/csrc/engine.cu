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
// loops over the model's tables, which are the kernel's parameter (a
// __grid_constant__ struct of ~19 KB, within Hopper's 32 KB of kernel
// parameters): every thread reads the same table entry at the same time, a
// broadcast from the constant cache. The kernels use no shared memory, so
// the SM's unified L1/shared memory stays L1 for the local-memory scratch
// (a copy of the tables into shared memory cost the walkers 5-11%). State
// is batch-trailing (rows, B), so the loads and stores of one row are
// coalesced across a warp.
//
// What bounds it on this card: not bytes (a HalfCheetah env moves ~200
// bytes a step) but the latency of a few thousand dependent scalar
// float operations per substep and the traffic to local memory: the
// per-thread scratch (M and L are nv*nv, the forward-solved constraint rows
// y_rows are rows*3*nv floats: 432 for HalfCheetah, 1050 for Ant, 6555 for
// the humanoid, 9135 for FlagrunHarder) does not fit in registers and lives
// in local memory, cached in L1/L2. The stack frame is sized by the caps of
// the instantiation, not by the model: each kernel is built twice, for the
// walkers (CapsWalker, nv <= 16, 32 rows, a ~16 KB frame) and for the
// humanoid family (CapsLarge, nv <= 32, 108 rows, a ~69 KB frame that CUDA
// reserves for every resident thread), and the launcher picks one by the
// tables' caps_id. A free root couples every dof to the root's six, so M
// and L are dense and each contact row's forward solve runs over all dofs.
// Making it fast (scratch in shared memory, warp-cooperative solves,
// specialising the loops per model) is later work; this version is the
// plain, correct one.
//
// No atomics and no cross-thread reductions: a launch is bitwise repeatable.

#include <cuda_runtime.h>

#include "engine_core.h"

namespace {

constexpr int kThreads = 128;

template <class C>
__global__ void __launch_bounds__(kThreads)
physics_step_kernel(const __grid_constant__ eng::Tables t, const float* __restrict__ q,
                    const float* __restrict__ v, const float* __restrict__ tau,
                    float* __restrict__ q_out, float* __restrict__ v_out,
                    float* __restrict__ d_out, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) eng::physics_step_one<C>(t, i, B, q, v, tau, q_out, v_out, d_out);
}

template <class C>
__global__ void __launch_bounds__(kThreads)
env_step_kernel(const __grid_constant__ eng::Tables t, eng::EnvIO io, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) eng::env_step_one<C>(t, io, i, B);
}

}  // namespace

extern "C" {

int eng_tables_layout(int32_t* out, int cap) { return eng::tables_layout(out, cap); }

int eng_tables_bytes() { return (int)sizeof(eng::Tables); }

// `tables` is a host pointer (copied into the launch's parameters), every
// other pointer a device pointer; caps_id is the tables' caps_id (0 the
// walker instantiation, 1 the large one). Returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for an unknown caps_id.
int launch_physics_step(const void* tables, const float* q, const float* v,
                        const float* tau, float* q_out, float* v_out, float* d_out,
                        int B, int caps_id, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  const eng::Tables& tg = *(const eng::Tables*)tables;
  cudaStream_t st = (cudaStream_t)stream;
  if (caps_id == eng::CapsWalker::ID)
    physics_step_kernel<eng::CapsWalker><<<blocks, kThreads, 0, st>>>(tg, q, v, tau, q_out,
                                                                      v_out, d_out, B);
  else if (caps_id == eng::CapsLarge::ID)
    physics_step_kernel<eng::CapsLarge><<<blocks, kThreads, 0, st>>>(tg, q, v, tau, q_out,
                                                                     v_out, d_out, B);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int launch_env_step(const void* tables, const float* q, const float* v, const float* act,
                    const float* aux, const uint8_t* term, const uint8_t* trunc,
                    const int32_t* step_count, const uint32_t* epoch, const uint32_t* seed,
                    const int32_t* env_id, float* q_out, float* v_out, float* obs,
                    float* reward, uint8_t* term_out, uint8_t* trunc_out, int32_t* step_out,
                    uint32_t* epoch_out, float* aux_out, float* comps, int B, int caps_id,
                    void* stream) {
  if (B <= 0) return 0;
  eng::EnvIO io = {q, v, act, aux, term, trunc, step_count, epoch, seed, env_id,
                   q_out, v_out, obs, reward, term_out, trunc_out, step_out,
                   epoch_out, aux_out, comps};
  const int blocks = (B + kThreads - 1) / kThreads;
  const eng::Tables& tg = *(const eng::Tables*)tables;
  cudaStream_t st = (cudaStream_t)stream;
  if (caps_id == eng::CapsWalker::ID)
    env_step_kernel<eng::CapsWalker><<<blocks, kThreads, 0, st>>>(tg, io, B);
  else if (caps_id == eng::CapsLarge::ID)
    env_step_kernel<eng::CapsLarge><<<blocks, kThreads, 0, st>>>(tg, io, B);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
