// The env step of any task, one env per lane group: the task's hooks,
// translated from its Python by ops/task_kernel.py into the functions of
// namespace `hooks`, around engine_core.h's substeps.
//
// The counterpart of the TPU kernel that pallas_engine.py ·
// make_pallas_env_step traces for any task: auto-reset with the task's own
// initial_state (its Threefry draws included), its pre-physics hook, the
// clip and its torques, frame_skip substeps, its outputs, the NaN guard,
// the step count and truncation, in the order of envs/base.py ·
// compose_env_step. The hooks are scalar per env, so they run in the
// group's leader lane (as the hand-written tasks' outputs do in
// env_step_kernel); the substeps run on the whole group.
//
// Included after the generated hooks header (nvcc/g++ -include), by
// task_step.cu (the kernel) and task_step_host.cpp (its host twin, for the
// CPU tests). The generated header provides, in namespace hooks:
//   constexpr int NAUX, NCOMP, NOBS;
//   initial_state(seed, env_id, epoch, q, v, aux)
//   pre_physics(q, v, aux, seed, env_id, epoch)
//   action_tau(act, tau)
//   output(q, v, depth, act, aux, seed, env_id, epoch, obs, reward, term, aux2, comps)
// with aux and reward components in sorted key order.

#pragma once

#include "engine_core.h"

namespace eng {

template <int G>
ENG_HD void task_step_one(const Tables& t, const EnvIO& io, const Group<G>& g,
                          float* base, int i, int B) {
  const Scr s = scratch(t, base);
  const bool done = io.term[i] != 0 || io.trunc[i] != 0;
  const uint32_t epoch = io.epoch[i] + (done ? 1u : 0u);
  const uint32_t seed = io.seed[i];
  const int32_t env_id = io.env_id[i];
  const int32_t step_count = done ? 0 : io.step_count[i];
  EACH_LANE(g, l) {
    for (int k = l; k < t.nq; k += G) s.q[k] = io.q[k * B + i];
    for (int k = l; k < t.nv; k += G) {
      s.v[k] = io.v[k * B + i];
      s.tau[k] = 0.f;
    }
    for (int k = l; k < t.act; k += G) s.act[k] = jclip(io.act[k * B + i], -1.f, 1.f);
    for (int r = l; r < t.nr; r += G) s.depth[r] = 0.f;
  }
  dofs_fill(t, g, s);
  g.sync();
  // the task state lives in the leader's registers across the substeps
  float aux[hooks::NAUX > 0 ? hooks::NAUX : 1];
  if (g.leader()) {
    for (int k = 0; k < hooks::NAUX; ++k) aux[k] = io.aux[k * B + i];
    // auto-reset [ref: env_bases.py · BaseBulletEnv.reset], then the task's
    // pre-physics hook and torques [ref: WalkerBase.apply_action]
    if (done) hooks::initial_state(seed, env_id, epoch, s.q, s.v, aux);
    hooks::pre_physics(s.q, s.v, aux, seed, env_id, epoch);
    hooks::action_tau(s.act, s.tau);
  }
  g.sync();
  for (int st = 0; st < t.frame_skip; ++st) substep(t, g, s);

  // the task's outputs, the NaN guard and the scalars: one lane
  if (g.leader()) {
    float obs[hooks::NOBS > 0 ? hooks::NOBS : 1], aux2[hooks::NAUX > 0 ? hooks::NAUX : 1],
        comps[hooks::NCOMP > 0 ? hooks::NCOMP : 1], reward;
    bool term;
    hooks::output(s.q, s.v, s.depth, s.act, aux, seed, env_id, epoch, obs, reward, term, aux2,
                  comps);
    // NaN guard [ref: walker_base_env.py · step isfinite check], the reward
    // included as in the TPU kernel body
    bool fin = finite(reward);
    for (int k = 0; k < hooks::NOBS; ++k) fin = fin && finite(obs[k]);
    for (int k = 0; k < t.nq; ++k) fin = fin && finite(s.q[k]);
    for (int k = 0; k < t.nv; ++k) fin = fin && finite(s.v[k]);
    term = term || !fin;
    const int32_t step2 = step_count + 1;
    io.reward[i] = finite(reward) ? reward : 0.f;
    io.term_out[i] = term ? 1 : 0;
    io.trunc_out[i] = (step2 >= t.max_steps) && !term ? 1 : 0;
    io.step_out[i] = step2;
    io.epoch_out[i] = epoch;
    for (int k = 0; k < hooks::NOBS; ++k) io.obs[k * B + i] = finite(obs[k]) ? obs[k] : 0.f;
    for (int k = 0; k < hooks::NAUX; ++k) io.aux_out[k * B + i] = aux2[k];
    for (int k = 0; k < hooks::NCOMP; ++k) io.comps[k * B + i] = comps[k];
  }
  EACH_LANE(g, l) {
    for (int k = l; k < t.nq; k += G) io.q_out[k * B + i] = s.q[k];
    for (int k = l; k < t.nv; k += G) io.v_out[k * B + i] = s.v[k];
  }
}

}  // namespace eng
