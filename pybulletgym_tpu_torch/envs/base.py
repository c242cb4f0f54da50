"""Batched functional env core: state, auto-reset, episode bookkeeping.

The reference's env loop is host-side Python over one Bullet world per env
object [ref: env_bases.py · BaseBulletEnv.step/reset]; here an env *batch*
is a tuple of tensors and one step is

    action -> torques -> frame_skip physics substeps -> obs/reward/done
           -> auto-reset (per env, on the next step) -> bookkeeping

Two backends step any `Task` on a CUDA device. "fused" (the default, the
counterpart of the JAX package's Pallas env step): the whole step is one
kernel launch (`ops.cuda_engine.make_cuda_env_step`): `env_step_kernel`
for the task classes it implements (`env_kernel_supports`), else
`task_step_kernel`, into which the task's own hooks are translated
(`ops.task_kernel`). "composed" (the counterpart of the JAX package's XLA
`make_env` step): the hooks run as torch ops around one launch of the
physics kernel (`ComposedEnvStep`), replayed from a CUDA graph by default.
Both compose the hooks in one order (`compose_env_step`); `env_step_plain`
is that order with the plain physics and serves CPU tensors. Auto-reset uses gymnasium's
"next-step" semantics: the obs returned alongside done=True is the terminal
obs; the following step starts the new episode.

NaN guard: the reference forces done when the state goes non-finite
[ref: walker_base_env.py · step]; the same is done per env in the batch.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, NamedTuple, Optional

import torch

from pybulletgym_tpu_torch.models.schema import Model
from pybulletgym_tpu_torch.ops import contacts as ct
from pybulletgym_tpu_torch.ops import cuda_engine as ce
from pybulletgym_tpu_torch.ops import smath as sm
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

    The stacked-array adapters below adapt them to (rows, B) tensors, as the
    JAX `Task`'s do for its XLA path; a structural-zero torque becomes a row
    of zeros.
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

    # ---- stacked-array adapters -------------------------------------------

    def initial_state(self, seed, env_id, epoch):
        q, v, aux = self.initial_state_scalar(seed, env_id, epoch)
        return torch.stack(list(q), 0), torch.stack(list(v), 0), aux

    def action_tau(self, action):
        tau = self.action_tau_scalar([action[i] for i in range(self.act_dim)])
        zero = action.new_zeros(action.shape[-1:])
        return torch.stack([zero if _is0f(t) else t for t in tau], 0)

    def pre_physics(self, q, v, aux, ids):
        q2, v2, aux2 = self.pre_physics_scalar(list(q), list(v), aux, ids)
        return torch.stack(list(q2), 0), torch.stack(list(v2), 0), aux2

    def output(self, q, v, depths, action, aux, ids=None):
        obs, reward, term, aux2, comps = self.output_scalar(
            list(q), list(v), list(depths), list(action), aux, ids)
        return torch.stack(list(obs), 0), reward, term, aux2, comps


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


def compose_env_step(task: Task, physics: Callable, state: EnvState, action) -> EnvState:
    """One env step for every env: the task's hooks as torch ops around
    `physics(q, v, tau) -> (q', v', depths)`; action (act, B).

    The order of the TPU kernel body (pallas_engine.py · make_pallas_env_step),
    which the CUDA env-step kernel follows too: done -> epoch+1, the initial
    state selected where done, step count reset, the pre-physics hook,
    action clip then torques (structural-zero taus as zeros), physics,
    outputs, the NaN guard, then step+1 and truncation. Aux and reward
    components keep any keys, in sorted order.

    The NaN guard counts the reward, as the Pallas body does
    (pallas_engine.py:186-191); the JAX package's XLA `make_env` leaves the
    reward out of it (envs/base.py:197-204)."""
    done = state.terminated | state.truncated
    epoch = (state.epoch.to(torch.int64) + done.to(torch.int64)).to(torch.uint32)
    seed, env_id = state.seed, state.env_id
    ids = (seed, env_id, epoch)

    # ---- auto-reset [ref: env_bases.py · BaseBulletEnv.reset] ------------
    fq, fv, faux = task.initial_state(seed, env_id, epoch)
    q = torch.where(done, fq, state.q)
    v = torch.where(done, fv, state.v)
    aux = {k: torch.where(done, faux[k], state.aux[k]) for k in sorted(faux)}
    step_count = torch.where(done, torch.zeros_like(state.step_count), state.step_count)
    if type(task).pre_physics_scalar is not Task.pre_physics_scalar:
        q, v, aux = task.pre_physics(q, v, aux, ids)

    # ---- torques [ref: WalkerBase.apply_action] ----------------------------
    a = torch.clamp(action, -1.0, 1.0)

    # ---- physics: frame_skip substeps [ref: World.step] --------------------
    q2, v2, d = physics(q, v, task.action_tau(a))

    # ---- observations / rewards [ref: WalkerBaseBulletEnv.step] ------------
    obs, reward, term, aux2, comps = task.output(q2, v2, d, a, aux, ids)

    # NaN guard [ref: walker_base_env.py · step isfinite check]
    finite = (sm.isfinite(reward) & sm.isfinite(obs).all(0) & sm.isfinite(q2).all(0)
              & sm.isfinite(v2).all(0))
    term = term | ~finite
    obs = torch.where(sm.isfinite(obs), obs, 0.0)
    reward = torch.where(sm.isfinite(reward), reward, 0.0)

    step2 = step_count + 1
    trunc = (step2 >= task.max_episode_steps) & ~term
    return EnvState(
        q=q2, v=v2, obs=obs, reward=reward,
        terminated=term, truncated=trunc, step_count=step2, epoch=epoch,
        env_id=env_id, seed=seed,
        aux={k: aux2[k] for k in sorted(aux2)},
        rewards={k: comps[k] for k in sorted(comps)},
    )


def env_step_plain(task: Task, state: EnvState, action,
                   frame_skip: Optional[int] = None) -> EnvState:
    """One env step for every env in plain torch (`compose_env_step` with
    the plain physics); action (act, B). `frame_skip` overrides the task's
    number of physics substeps (0: the post-reset state)."""
    cfg = task.physics
    if frame_skip is not None:
        cfg = dataclasses.replace(cfg, frame_skip=int(frame_skip))
    return compose_env_step(task, make_physics_step_plain(task.model, cfg)[0], state, action)


# the state fields the composed step reads (besides aux), copied into a
# captured graph's input buffers at every call
_STEP_INPUTS = ("q", "v", "terminated", "truncated", "step_count", "epoch", "env_id", "seed")


class _StepGraph:
    """One CUDA graph of `compose_env_step` for one batch shape: static
    input buffers, the captured step, and its static outputs."""

    def __init__(self, task: Task, physics, state: EnvState, action):
        dev = state.q.device
        # the library, the launch configuration and the large, huge and
        # sized classes' scratch buffer: not capturable
        physics.prepare(dev, state.q.shape[-1])
        self.physics = physics
        self.state = state._replace(
            obs=None, reward=None, rewards=None,
            aux={k: x.clone() for k, x in state.aux.items()},
            **{k: getattr(state, k).clone() for k in _STEP_INPUTS})
        self.action = action.clone()
        n_rows = physics.n_rows

        def no_physics(q, v, tau):  # the warm-up launches no kernel, so counts no launch
            return q.clone(), v.clone(), q.new_zeros((n_rows, q.shape[-1]))

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            compose_env_step(task, no_physics, self.state, self.action)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        before = dict(ce.CAPTURED)
        try:
            with torch.cuda.graph(self.graph):
                self.out = compose_env_step(task, physics, self.state, self.action)
        except RuntimeError as e:
            raise RuntimeError(
                f"{type(task).__name__}: capturing the composed env step in a CUDA graph "
                f"failed at the op in the traceback above ({e}); graph=False steps it "
                "eagerly") from e
        # the kernel launches the graph recorded, which each replay repeats
        self.recorded = {k: ce.CAPTURED[k] - before[k] for k in before}
        if self.recorded != dict(dict.fromkeys(before, 0), **{physics.kernel: 1}):
            raise RuntimeError(f"the captured composed step recorded the kernel launches "
                               f"{self.recorded}, expected {physics.kernel} once")

    def __call__(self, state: EnvState, action) -> EnvState:
        pairs = [(self.action, action, "action")] + [
            (getattr(self.state, k), getattr(state, k), k) for k in _STEP_INPUTS] + [
            (x, state.aux.get(k), f"aux[{k!r}]") for k, x in self.state.aux.items()]
        for dst, src, name in pairs:
            if (not isinstance(src, torch.Tensor) or src.shape != dst.shape
                    or src.dtype != dst.dtype or src.device != dst.device):
                raise ValueError(f"{name}: expected {dst.dtype} {tuple(dst.shape)} on "
                                 f"{dst.device} as at the capture")
        if sorted(state.aux) != sorted(self.state.aux):
            raise ValueError(f"aux keys {sorted(state.aux)} differ from the capture's "
                             f"{sorted(self.state.aux)}")
        for dst, src, _ in pairs:
            dst.copy_(src)
        self.graph.replay()
        for k, n in self.recorded.items():
            ce.LAUNCHES[k] += n
        self.physics.launches += self.recorded[self.physics.kernel]
        o = self.out
        return o._replace(
            env_id=state.env_id, seed=state.seed,
            aux={k: x.clone() for k, x in o.aux.items()},
            rewards={k: x.clone() for k, x in o.rewards.items()},
            **{k: getattr(o, k).clone() for k in
               ("q", "v", "obs", "reward", "terminated", "truncated", "step_count", "epoch")})


class ComposedEnvStep:
    """step(state: EnvState, action (act, B)) -> EnvState for any `Task`:
    `compose_env_step` with the task's hooks as torch ops and one physics
    step (the counterpart of the JAX package's `make_env` step).

    CPU tensors take the plain physics. CUDA tensors take
    `physics_step_kernel` (`ops.cuda_engine.CudaPhysicsStep`, one launch an
    env step for all `frame_skip` substeps; its large build for a model over
    the default tables' caps, its huge build for one over the large caps or
    whose scratch outgrows shared memory, its sized build, with caps set
    from the model, for any larger one), built at the first CUDA call or by
    `prepare`, which on a CUDA device also allocates the large, huge and
    sized classes' scratch buffer. With `graph=True`
    the first CUDA call for a batch shape warms the hooks up on a side
    stream (no physics launch) and captures the whole step in a
    `torch.cuda.CUDAGraph`; every call then copies the state and action into
    the graph's inputs, replays it and returns fresh copies of its outputs.
    A capture that fails raises; nothing falls back to eager steps. The task's
    `max_episode_steps`, `frame_skip` and constants are frozen into the
    graph: after changing one, build a new step. `graph=False` steps eagerly
    (thousands of launches a step). `launches` counts physics-kernel
    launches, each replay the one its graph recorded; `capture_ms` is the last capture's host time,
    warm-up included."""

    backend = "composed"

    def __init__(self, task: Task, graph: bool = True):
        self.task, self.graph = task, bool(graph)
        self._plain = make_physics_step_plain(task.model, task.physics)[0]
        self._cuda = None
        self._graphs: Dict[tuple, _StepGraph] = {}
        self.capture_ms = None

    @property
    def launches(self) -> int:
        return 0 if self._cuda is None else self._cuda.launches

    def physics(self, device: torch.device):
        """The physics step for tensors on `device`."""
        if device.type == "cpu":
            return self._plain
        if self._cuda is None:
            self._cuda = ce.make_cuda_physics_step(self.task.model, self.task.physics)[0]
        return self._cuda

    def prepare(self, device: torch.device, B: Optional[int] = None):
        """The physics step for `device`; on a CUDA device with a batch of B
        envs also its library, launch configuration, tables on the card and
        (large, huge and sized classes) scratch buffer, ahead of any capture."""
        phys = self.physics(device)
        if device.type == "cuda" and B is not None:
            phys.prepare(device, B)
        return phys

    def eager(self, state: EnvState, action) -> EnvState:
        return compose_env_step(self.task, self.physics(state.q.device), state, action)

    def __call__(self, state: EnvState, action) -> EnvState:
        dev = state.q.device
        if dev.type != "cuda" or not self.graph:
            return self.eager(state, action)
        key = (dev, tuple(state.q.shape), tuple(sorted(state.aux)))
        if key not in self._graphs:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            self._graphs[key] = _StepGraph(self.task, self.physics(dev), state, action)
            torch.cuda.synchronize(dev)
            self.capture_ms = (time.perf_counter() - t0) * 1e3
        return self._graphs[key](state, action)


def make_env_step(task: Task, backend: str = "fused", graph: bool = True):
    """The env step `step(state, action (act, B)) -> EnvState` for `task`.
    "fused": one kernel launch a step (`make_cuda_env_step`: env_step_kernel
    or task_step_kernel). "composed": `ComposedEnvStep(task, graph)`;
    `graph` concerns it only. Both run the plain version on CPU tensors."""
    if backend == "fused":
        return ce.make_cuda_env_step(task)
    if backend == "composed":
        return ComposedEnvStep(task, graph)
    raise ValueError(f"unknown backend {backend!r}: 'fused' or 'composed'")


def make_env(task: Task):
    """(reset, step) for any task, the counterpart of the JAX package's
    `make_env`: reset(seed, env_id, epoch) is `reset_fn`, and step(state,
    action (act, B)) is the eager composed step (`ComposedEnvStep` with
    graph=False: one physics-kernel launch an env step on CUDA tensors, the
    plain physics on CPU tensors)."""
    return functools.partial(reset_fn, task), ComposedEnvStep(task, graph=False)


class BatchedEnv:
    """A fixed batch of envs on one device.

    The batch-leading (B, dim) convention is used at this public boundary;
    internally everything is batch-trailing. `backend` and `graph` pick the
    step (`make_env_step`): on a CUDA device "fused" is one kernel launch a
    step for any task (`step_fn.kernel` names the kernel), and "composed"
    runs the task's hooks in torch around one physics-kernel launch,
    replayed from a CUDA graph unless graph=False. On the CPU either runs
    the plain version. The device is the GPU unless the caller asks for
    "cpu". A CUDA device without a GPU and hooks that "fused" cannot
    translate (on any device) raise here, at construction; no model size is
    refused (`ops.cuda_engine.caps_class`). On a CUDA device the step's
    buffers (the large, huge and sized classes': B slices of one env's scratch,
    stored by the model's root paths) are allocated here too, once; a
    buffer that does not fit the card raises, naming the bytes an env.
    """

    def __init__(self, task: Task, batch_size: int, device="cuda",
                 backend: str = "fused", graph: bool = True):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"BatchedEnv(device={device!r}): no CUDA device is available"
            )
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device!r}")
        self.task = task
        self.batch_size = int(batch_size)
        self.step_fn = make_env_step(task, backend, graph)
        self.backend = self.step_fn.backend
        prepare = getattr(self.step_fn, "prepare", None)  # the wrappers built per task
        if prepare is not None:
            prepare(self.device, self.batch_size)

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

