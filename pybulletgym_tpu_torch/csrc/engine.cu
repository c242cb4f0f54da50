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
// What bounds it on this card: not bytes (a HalfCheetah env moves ~350
// bytes a step) and not the float rate, but the latency of long chains of
// dependent operations per env: the factorization of M, the forward solves
// of every constraint row, and the PGS sweeps, which are Gauss-Seidel over
// rows, each row a dot product followed by an update. Those chains need
// their scratch close and many envs in flight on every SM. So every class
// runs them over the dof tree's root paths (engine_core.h ·
// ENG_PATH_FIELDS, ltl_factor): M = L^T L without fill, each row's solve,
// storage, set-up and sweep over its support, which keeps an env's whole
// scratch small (Atlas 20,308 bytes against 48,604 with dense L and rows,
// Humanoid 28,140, FlagrunHarder 31,372; two Humanoids in one scene
// 20,736 against 63,872), and its PGS sweep runs one butterfly a contact
// row and one a limit pair (contact_step, limit_step; win_step).
//
// Design. A group of G lanes of one warp steps one env (G a power of two,
// one library per G, built from this file with -DENG_LANES=G; pack_physics
// picks G from the model's dofs). The lanes split the parallel phases of
// engine_core.h: dofs (passive forces, CRBA rows, Jacobian entries, z),
// rows (narrowphase, the PGS set-up), right-hand sides (the forward
// solves, one lane each), a dof's ancestors' rows (each step of the
// factorization), bodies (the integration); the body-recursive
// parts (FK, RNE, the composite inertias, reset, the task's outputs) run in
// one lane. Each PGS dot product is lane products plus a fixed xor
// butterfly (__shfl_xor_sync over the group), its update lane-parallel on
// registers; __syncwarp of the group separates phases. No atomics and no
// cross-group communication: a launch is bitwise repeatable.
//
// The scratch of each env is a slice of dynamic shared memory laid out by
// pack_physics from the model's sizes (Tables::sc), so nothing lives in
// local memory: the stack frame is a few hundred bytes and the launch
// reserves no per-thread local memory to speak of. A block holds E envs
// (E*G threads, E*stride floats of shared memory); eng_launch_config picks
// the E that keeps the most envs resident per SM (the occupancy API), so B
// = 4096 spreads over all 132 SMs. The tables stay a __grid_constant__
// kernel parameter (~26 KB, within Hopper's 32 KB): the hot PGS sweep reads
// them at uniform indices (a constant-cache broadcast); the once-a-substep
// phases read them at lane-divergent indices. State is batch-trailing
// (rows, B); a group's lanes read and write an env's rows.
//
// The large size class (-DENG_BIG_TABLES, engine_core.h: up to 64 bodies and
// nv 64) builds physics_step_kernel only, with the tables (~70 KB) in global
// memory: a pointer parameter (ENG_TABLES_PARAM), its launcher taking the
// device copy beside the host one. The huge class (-DENG_HUGE_TABLES: up to
// 128 bodies and nv 128) and the sized class (-DENG_SIZED_TABLES: caps set by
// the host from the model, any size) do the same with their tables. The
// three run the default class's substep over root paths; their PGS sweep
// holds a row by its window of two mask words (engine_core.h ·
// pgs_sweeps_win), since their models' many dofs would not fit a whole row
// in a lane's registers. Their whole
// scratch lives in a device buffer of B envs' slices of sc_stride floats
// (buf, an argument after the tables): a block asks for no shared memory,
// the SM's memory serves as L1 for the slices, and E comes from the
// occupancy API on registers alone.
// env_step_kernel's task classes all fit the default class; any other task
// over its caps runs task_step_kernel's large, huge or sized build
// (task_step.cu).
//
// Timing on a card: `python3 pybulletgym_tpu_torch/tools/kernel_ab.py ROOT_A
// ROOT_B` times both kernels in two checkouts (P C C P, graph-replayed
// launches; `--lanes` sweeps G), and `tools/kernel_phases.py` splits the env
// kernel's time into the sweeps, the rest of the substeps and the rest.

#include <cuda_runtime.h>

#include "engine_core.h"

#ifndef ENG_LANES
#error "build with -DENG_LANES=G (G: 4, 8, 16 or 32)"
#endif

namespace {

constexpr int G = ENG_LANES;
constexpr int kMaxThreads = 128;  // E * G
constexpr int kMinBlocks = 4;     // of 128 threads an SM: at most 128 registers a thread
constexpr int kMaxShared = 232448;  // 227 KB: a block's dynamic shared memory on sm_90

// Dynamic shared bytes of a block of E envs of `stride` floats: their
// scratch, or none in the large, huge and sized builds (the scratch in buf).
size_t shared_bytes(int E, int stride) {
#ifdef ENG_GLOBAL_TABLES
  (void)E, (void)stride;
  return 0;
#else
  return (size_t)E * stride * sizeof(float);
#endif
}

// This thread's group: its lanes in the warp.
__device__ __forceinline__ eng::Group<G> my_group() {
  const int wl = threadIdx.x & 31;
  const uint32_t ones = G == 32 ? 0xffffffffu : ((1u << G) - 1u);
  eng::Group<G> g;
  g.lane = wl & (G - 1);
  g.mask = ones << (wl & ~(G - 1));
  return g;
}

__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
physics_step_kernel(ENG_TABLES_PARAM, ENG_BUF_PARAM const float* __restrict__ q,
                    const float* __restrict__ v, const float* __restrict__ tau,
                    float* __restrict__ q_out, float* __restrict__ v_out,
                    float* __restrict__ d_out, int B) {
  ENG_TABLES_BIND
  extern __shared__ float smem[];
  const int E = blockDim.x / G, e = threadIdx.x / G;
  const int i = blockIdx.x * E + e;
  if (i >= B) return;  // the whole group: its lanes share i
  eng::physics_step_one<G>(t, my_group(), ENG_ENV_SCRATCH(e, i), i, B, q, v, tau, q_out, v_out,
                           d_out);
}

#ifndef ENG_GLOBAL_TABLES
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
env_step_kernel(const __grid_constant__ eng::Tables t, eng::EnvIO io, int B) {
  extern __shared__ float smem[];
  const int E = blockDim.x / G, e = threadIdx.x / G;
  const int i = blockIdx.x * E + e;
  if (i >= B) return;
  eng::env_step_one<G>(t, io, my_group(), smem + e * t.sc_stride, i, B);
}
#endif

int launch_check(const eng::Tables& t, int E) {
  if (t.lanes != G || t.nv > eng::lane_nv<G>() || E < 1 || E * G > kMaxThreads ||
      shared_bytes(E, t.sc_stride) > kMaxShared)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

int eng_lanes() { return G; }

int eng_tables_layout(int32_t* out, int cap) { return eng::tables_layout(out, cap); }

int eng_tables_bytes() { return (int)sizeof(eng::Tables); }

// The launch configuration for an env scratch of `stride` floats: out[0] =
// E, the envs a block, out[1] = resident blocks per SM, out[2] = dynamic
// shared bytes a block, out[3] = registers a thread, out[4] = local (stack)
// bytes a thread. kernel 0 is physics_step_kernel, 1 env_step_kernel (not
// in the large, huge and sized builds). E is the power of two (E * G <= 128
// threads, E * stride floats <= 227 KB; in the large, huge and sized builds
// no shared memory) that keeps the most envs resident per SM, the larger on a
// tie. Returns a cudaError_t, or cudaErrorInvalidValue if one env's scratch
// does not fit.
int eng_launch_config(int kernel, int stride, int32_t* out) {
#ifdef ENG_GLOBAL_TABLES
  if (kernel != 0) return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)physics_step_kernel;
#else
  const void* fn = kernel == 0 ? (const void*)physics_step_kernel : (const void*)env_step_kernel;
#endif
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

// `tables` is a host pointer (copied into the launch's parameters; in the
// large, huge and sized builds the device copy `dev_tables` is the kernel's
// and `tables` is only checked), every other pointer a device pointer (in
// the large, huge and sized builds `buf`, B x tables.sc_stride floats,
// follows `dev_tables`); E is eng_launch_config's envs a block. Returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for tables of another G, more dofs than
// this library's lanes hold (eng::lane_nv) or an E that does not fit.
int launch_physics_step(const void* tables, ENG_DEV_TABLES ENG_BUF_PARAM const float* q,
                        const float* v, const float* tau, float* q_out, float* v_out,
                        float* d_out, int B, int E, void* stream) {
  if (B <= 0) return 0;
  const eng::Tables& tg = *(const eng::Tables*)tables;
  if (int err = launch_check(tg, E)) return err;
  const int blocks = (B + E - 1) / E;
  physics_step_kernel<<<blocks, E * G, shared_bytes(E, tg.sc_stride), (cudaStream_t)stream>>>(
      ENG_KERNEL_TABLES(tg), ENG_KERNEL_BUF q, v, tau, q_out, v_out, d_out, B);
  return (int)cudaGetLastError();
}

#ifndef ENG_GLOBAL_TABLES
int launch_env_step(const void* tables, const float* q, const float* v, const float* act,
                    const float* aux, const uint8_t* term, const uint8_t* trunc,
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
  if (int err = launch_check(tg, E)) return err;
  const int blocks = (B + E - 1) / E;
  env_step_kernel<<<blocks, E * G, shared_bytes(E, tg.sc_stride), (cudaStream_t)stream>>>(
      tg, io, B);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
