"""Batched functional env core: state, auto-reset, episode bookkeeping.

The reference's env loop is host-side Python over one Bullet world per env
object [ref: env_bases.py · BaseBulletEnv.step/reset]; here an env *batch*
is a tuple of tensors and one step is

    action -> torques -> frame_skip physics substeps -> obs/reward/done
           -> auto-reset (per env, on the next step) -> bookkeeping

On a CUDA device the whole step is one kernel launch
(`ops.cuda_engine.make_cuda_env_step`); `env_step_plain` is its plain
PyTorch version, composed hook by hook exactly as the kernel body is, and
serves CPU tensors. Auto-reset uses gymnasium's "next-step" semantics: the
obs returned alongside done=True is the terminal obs; the following step
starts the new episode.

NaN guard: the reference forces done when the state goes non-finite
[ref: walker_base_env.py · step]; the same is done per env in the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

from pybulletgym_tpu_torch.models.schema import Model
from pybulletgym_tpu_torch.ops import contacts as ct
from pybulletgym_tpu_torch.ops import smath as sm
from pybulletgym_tpu_torch.ops.cuda_engine import make_cuda_env_step
from pybulletgym_tpu_torch.ops.step import PhysicsConfig, make_physics_step_plain, sc_rows


class EnvState(NamedTuple):
    """Everything about a batch of envs, batch-trailing layout.

    Field names and layouts are those of the JAX package's `EnvState`.
    `aux` holds task-specific per-env scalars (potential, walk target, ...);
    `rewards` holds the reference's reward decomposition
    [ref: walker_base_env.py · step — self.rewards list].
    """

    q: torch.Tensor            # (nq, B) float32
    v: torch.Tensor            # (nv, B) float32
    obs: torch.Tensor          # (obs_dim, B) float32
    reward: torch.Tensor       # (B,) float32
    terminated: torch.Tensor   # (B,) bool
    truncated: torch.Tensor    # (B,) bool
    step_count: torch.Tensor   # (B,) int32
    epoch: torch.Tensor        # (B,) uint32 — reset counter, feeds RNG streams
    env_id: torch.Tensor       # (B,) int32
    seed: torch.Tensor         # (B,) uint32
    aux: Dict[str, torch.Tensor]
    rewards: Dict[str, torch.Tensor]

    @property
    def done(self):
        return self.terminated | self.truncated


class Task:
    """Per-env-family behavior: initial states, torque mapping, obs/reward.

    Concrete tasks implement the *scalar-core* hooks, which operate on SoA
    lists of per-env scalar tensors of any shape:

      initial_state_scalar(seed, env_id, epoch) -> (q_list, v_list, aux)
      action_tau_scalar(a_list) -> tau_list (0.0 = structural zero)
      output_scalar(q_list, v_list, depth_list, a_list, aux, ids=None)
          -> (obs_list, reward, terminated_bool, new_aux, reward_components)

    `ids` is the per-env RNG identity (seed, env_id, epoch).
    """

    model: Model
    physics: PhysicsConfig
    obs_dim: int
    act_dim: int
    max_episode_steps: int

    def initial_state_scalar(self, seed, env_id, epoch):
        raise NotImplementedError

    def action_tau_scalar(self, a):
        raise NotImplementedError

    def output_scalar(self, q, v, depths, a, aux, ids=None):
        raise NotImplementedError

    def pre_physics_scalar(self, q, v, aux, ids=None):
        """Optional pre-step state edit; default is identity."""
        return q, v, aux


def _is0f(x):
    return isinstance(x, float) and x == 0.0


def reset_fn(task: Task, seed, env_id, epoch) -> EnvState:
    """Fresh episodes for every env: seed/epoch (B,) uint32, env_id (B,) int32.

    Runs the task hooks in plain torch on whatever device the inputs are on
    (the JAX package runs its reset as plain XLA ops too)."""
    q, v, aux = task.initial_state_scalar(seed, env_id, epoch)
    zero = torch.zeros_like(q[0])
    n_rows = _n_rows(task)
    obs, _, _, aux, comps = task.output_scalar(
        list(q), list(v), [zero] * n_rows, [zero] * task.act_dim, aux,
        (seed, env_id, epoch),
    )
    B = seed.shape[-1]
    dev = seed.device
    zb = lambda: torch.zeros((B,), dtype=torch.float32, device=dev)  # noqa: E731
    return EnvState(
        q=torch.stack(list(q), 0), v=torch.stack(list(v), 0),
        obs=torch.stack(list(obs), 0), reward=zb(),
        terminated=torch.zeros((B,), dtype=torch.bool, device=dev),
        truncated=torch.zeros((B,), dtype=torch.bool, device=dev),
        step_count=torch.zeros((B,), dtype=torch.int32, device=dev),
        epoch=epoch.to(torch.uint32), env_id=env_id.to(torch.int32),
        seed=seed.to(torch.uint32),
        aux=dict(aux), rewards={k: zb() for k in comps},
    )


def _n_rows(task: Task) -> int:
    return len(sc_rows(ct.build_contact_plan(task.model, task.physics.solver)))


def env_step_plain(task: Task, state: EnvState, action,
                   frame_skip: Optional[int] = None) -> EnvState:
    """One env step for every env, plain torch; action (act, B).

    Composes the hooks exactly as the kernel body does: done -> epoch+1,
    initial state selected where done, step count reset, pre-physics hook,
    action clip then torques (structural-zero taus as zeros), `frame_skip`
    physics substeps (default: the task's), outputs, the NaN guard, then
    step+1 and truncation."""
    m = task.model
    cfg = task.physics
    if frame_skip is not None:
        cfg = dataclasses.replace(cfg, frame_skip=int(frame_skip))
    physics = make_physics_step_plain(m, cfg)[0]
    done = state.terminated | state.truncated
    epoch = (state.epoch.to(torch.int64) + done.to(torch.int64)).to(torch.uint32)
    seed, env_id = state.seed, state.env_id

    # ---- auto-reset [ref: env_bases.py · BaseBulletEnv.reset] ------------
    fq, fv, faux = task.initial_state_scalar(seed, env_id, epoch)
    q = [torch.where(done, fq[i], state.q[i]) for i in range(m.nq)]
    v = [torch.where(done, fv[i], state.v[i]) for i in range(m.nv)]
    aux = {k: torch.where(done, faux[k], state.aux[k]) for k in sorted(faux)}
    step_count = torch.where(done, torch.zeros_like(state.step_count), state.step_count)
    ids = (seed, env_id, epoch)
    q, v, aux = task.pre_physics_scalar(q, v, aux, ids)

    # ---- torques [ref: WalkerBase.apply_action] ----------------------------
    a = [torch.clamp(action[i], -1.0, 1.0) for i in range(task.act_dim)]
    zero = torch.zeros_like(q[0])
    tau = [t if not _is0f(t) else zero for t in task.action_tau_scalar(a)]

    # ---- physics: frame_skip substeps [ref: World.step] --------------------
    q2, v2, d = physics(
        torch.stack(list(q), 0), torch.stack(list(v), 0), torch.stack(tau, 0)
    )

    # ---- observations / rewards [ref: WalkerBaseBulletEnv.step] ------------
    obs, reward, term, aux2, comps = task.output_scalar(
        list(q2), list(v2), list(d), a, aux, ids
    )

    # NaN guard [ref: walker_base_env.py · step isfinite check]
    finite = sm.isfinite(reward)
    for x in list(obs) + list(q2) + list(v2):
        finite = finite & sm.isfinite(x)
    term = term | ~finite
    obs = [torch.where(sm.isfinite(o), o, 0.0) for o in obs]
    reward = torch.where(sm.isfinite(reward), reward, 0.0)

    step2 = step_count + 1
    trunc = (step2 >= task.max_episode_steps) & ~term
    return EnvState(
        q=q2, v=v2, obs=torch.stack(obs, 0), reward=reward,
        terminated=term, truncated=trunc, step_count=step2, epoch=epoch,
        env_id=env_id, seed=seed,
        aux={k: aux2[k] for k in sorted(aux2)},
        rewards={k: comps[k] for k in sorted(comps)},
    )


class BatchedEnv:
    """A fixed batch of envs on one device.

    The batch-leading (B, dim) convention is used at this public boundary;
    internally everything is batch-trailing. On a CUDA device every step is
    one launch of the env-step kernel; on the CPU the same wrapper runs the
    plain version. The device is the GPU unless the caller asks for "cpu";
    a CUDA device without a GPU raises here, at construction.
    """

    def __init__(self, task: Task, batch_size: int, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"BatchedEnv(device={device!r}): no CUDA device is available"
            )
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device!r}")
        self.task = task
        self.batch_size = int(batch_size)
        self.step_fn = make_cuda_env_step(task)

    @property
    def observation_size(self) -> int:
        return self.task.obs_dim

    @property
    def action_size(self) -> int:
        return self.task.act_dim

    def reset(self, seed: int = 0, epoch: int = 0, first_env: int = 0) -> EnvState:
        """Fresh episodes for the batch. `first_env` is the global index of
        its first env when the batch is one shard of a larger one
        (`parallel.mesh`): the envs' `env_id`s, which key their reset and
        auto-reset draws, are first_env ... first_env + B - 1."""
        B, dev = self.batch_size, self.device
        return reset_fn(
            self.task,
            torch.full((B,), int(seed) & 0xFFFFFFFF, dtype=torch.uint32, device=dev),
            torch.arange(first_env, first_env + B, dtype=torch.int32, device=dev),
            torch.full((B,), int(epoch) & 0xFFFFFFFF, dtype=torch.uint32, device=dev),
        )

    def step(self, state: EnvState, action) -> EnvState:
        """action: (B, act_dim) batch-leading (public convention)."""
        action = torch.as_tensor(action, dtype=torch.float32, device=self.device)
        expect = (self.batch_size, self.task.act_dim)
        if tuple(action.shape) != expect:
            raise ValueError(f"action shape {tuple(action.shape)} != {expect}")
        return self.step_fn(state, action.T.contiguous())

    @staticmethod
    def observations(state: EnvState):
        """(B, obs_dim) batch-leading view of the current observations."""
        return state.obs.T

