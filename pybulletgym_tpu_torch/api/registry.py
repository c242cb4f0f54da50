"""Env registry for the port: the reference env IDs that the torch package
runs [ref: pybulletgym/envs/__init__.py — gym.envs.registration.register].

All 26 IDs of the JAX package's registry: the MJCF walkers (Hopper,
Walker2D, HalfCheetah, Ant), the humanoid family (Humanoid,
HumanoidFlagrun, HumanoidFlagrunHarder), Atlas (a URDF robot), the pendula
(InvertedPendulum, its swing-up, InvertedDoublePendulum) and the
manipulators (Reacher, Pusher, Striker, Thrower, and the MuJoCo mirrors of
the last three, which reuse the same tasks at Gym's 100-step horizon), and
the Gym-MuJoCo mirror family (`envs/mujoco_family.py`: Hopper, Walker2D,
HalfCheetah, Ant, Humanoid, Reacher, InvertedPendulum and
InvertedDoublePendulum `*MuJoCoEnv-v0`). Any other ID raises `KeyError`
listing the known ones. The registry's horizon overrides the task's own
(ReacherMuJoCoEnv-v0: 150 steps). ``register(id, task_factory,
max_episode_steps)`` adds a user's ID (any `Task`) or replaces one; the
entry points below then take it, and so does `parallel.ppo.train`.

Three entry points: ``make(id)``, a single-env adapter (`api/gym_adapter.py`);
``make_batched(id, batch_size)``, the native batched env; ``make_task(id)``.
`register_with_gymnasium` (run when the package is imported) registers
every ID with gymnasium under the namespace ``pybulletgym_tpu_torch/``, so
``gymnasium.make("pybulletgym_tpu_torch/HopperPyBulletEnv-v0")`` builds the
port's adapter. The bare IDs stay the JAX package's: the port never
registers or displaces them, whichever package is imported first.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    id: str
    task_factory: Callable
    max_episode_steps: int
    reward_threshold: Optional[float]


def _walker(spec_name: str) -> Callable:
    def factory():
        from pybulletgym_tpu_torch.envs import locomotion as loco

        return loco.WalkerTask(getattr(loco, spec_name))

    return factory


def _task(class_name: str, module: str = "locomotion", **kw) -> Callable:
    def factory():
        import importlib

        mod = importlib.import_module(f"pybulletgym_tpu_torch.envs.{module}")
        return getattr(mod, class_name)(**kw)

    return factory


def _mj(class_name: str) -> Callable:
    return _task(class_name, "mujoco_family")


registry: Dict[str, EnvSpec] = {
    s.id: s for s in (
        EnvSpec("HopperPyBulletEnv-v0", _walker("HOPPER"), 1000, 2500.0),
        EnvSpec("Walker2DPyBulletEnv-v0", _walker("WALKER2D"), 1000, 2500.0),
        EnvSpec("HalfCheetahPyBulletEnv-v0", _walker("HALF_CHEETAH"), 1000, 3000.0),
        EnvSpec("AntPyBulletEnv-v0", _walker("ANT"), 1000, 2500.0),
        EnvSpec("HumanoidPyBulletEnv-v0", _walker("HUMANOID"), 1000, None),
        EnvSpec("HumanoidFlagrunPyBulletEnv-v0", _task("HumanoidFlagrunTask"), 1000, 2000.0),
        EnvSpec("HumanoidFlagrunHarderPyBulletEnv-v0", _task("HumanoidFlagrunHarderTask"),
                1000, None),
        EnvSpec("AtlasPyBulletEnv-v0", _walker("ATLAS"), 1000, None),
        EnvSpec("InvertedPendulumPyBulletEnv-v0",
                _task("InvertedPendulumTask", "pendula", swingup=False), 1000, 950.0),
        EnvSpec("InvertedPendulumSwingupPyBulletEnv-v0",
                _task("InvertedPendulumTask", "pendula", swingup=True), 1000, 800.0),
        EnvSpec("InvertedDoublePendulumPyBulletEnv-v0",
                _task("InvertedDoublePendulumTask", "pendula"), 1000, 9100.0),
        EnvSpec("ReacherPyBulletEnv-v0", _task("ReacherTask", "manipulation"), 150, 18.0),
        EnvSpec("PusherPyBulletEnv-v0", _task("PusherTask", "manipulation"), 150, 18.0),
        EnvSpec("StrikerPyBulletEnv-v0", _task("StrikerTask", "manipulation"), 100, 18.0),
        EnvSpec("ThrowerPyBulletEnv-v0", _task("ThrowerTask", "manipulation"), 100, 18.0),
        EnvSpec("PusherMuJoCoEnv-v0", _task("PusherTask", "manipulation"), 100, 0.0),
        EnvSpec("StrikerMuJoCoEnv-v0", _task("StrikerTask", "manipulation"), 100, 0.0),
        EnvSpec("ThrowerMuJoCoEnv-v0", _task("ThrowerTask", "manipulation"), 100, 0.0),
        EnvSpec("InvertedPendulumMuJoCoEnv-v0", _mj("InvertedPendulumMuJoCoTask"), 1000, 950.0),
        EnvSpec("InvertedDoublePendulumMuJoCoEnv-v0", _mj("InvertedDoublePendulumMuJoCoTask"),
                1000, 9100.0),
        EnvSpec("HopperMuJoCoEnv-v0", _mj("HopperMuJoCoTask"), 1000, 3800.0),
        EnvSpec("Walker2DMuJoCoEnv-v0", _mj("Walker2DMuJoCoTask"), 1000, None),
        EnvSpec("HalfCheetahMuJoCoEnv-v0", _mj("HalfCheetahMuJoCoTask"), 1000, 4800.0),
        EnvSpec("AntMuJoCoEnv-v0", _mj("AntMuJoCoTask"), 1000, 6000.0),
        EnvSpec("ReacherMuJoCoEnv-v0", _mj("ReacherMuJoCoTask"), 150, 18.0),
        EnvSpec("HumanoidMuJoCoEnv-v0", _mj("HumanoidMuJoCoTask"), 1000, None),
    )
}


def register(id: str, task_factory: Callable, max_episode_steps: int,
             reward_threshold: Optional[float] = None) -> None:
    """Add env `id` (or replace it): `task_factory()` returns a fresh `Task`,
    whose horizon becomes `max_episode_steps`. On the card its env step is
    one launch of `task_step_kernel`, its hooks translated into it
    (`ops.task_kernel`). Call `register_with_gymnasium()` again to make it known
    to gymnasium as ``pybulletgym_tpu_torch/<id>``."""
    registry[id] = EnvSpec(id, task_factory, max_episode_steps, reward_threshold)


def make_task(id: str):
    """The Task (model + scalar hooks) behind an env id; a fresh instance."""
    if id not in registry:
        raise KeyError(f"unknown env id {id!r}; known: {sorted(registry)}")
    spec = registry[id]
    task = spec.task_factory()
    task.max_episode_steps = spec.max_episode_steps
    return task


def make_batched(id: str, batch_size: int, device="cuda", backend: str = "fused",
                 graph: bool = True):
    """A `BatchedEnv` of `batch_size` envs on `device`: the GPU unless the
    caller asks for "cpu" (without a GPU, "cuda" raises). `backend` and
    `graph` go to `BatchedEnv` (by default one kernel launch a step)."""
    from pybulletgym_tpu_torch.envs.base import BatchedEnv

    return BatchedEnv(make_task(id), batch_size, device=device, backend=backend, graph=graph)


def make(id: str, device="cuda", render_mode: Optional[str] = None,
         backend: str = "fused", graph: bool = True):
    """A single-env gymnasium adapter (`api/gym_adapter.py · GymAdapter`)
    on `device`: the GPU unless the caller asks for "cpu". `backend` and
    `graph` go to its `BatchedEnv`."""
    from pybulletgym_tpu_torch.api.gym_adapter import GymAdapter

    return GymAdapter(make_task(id), registry[id], render_mode=render_mode, device=device,
                      backend=backend, graph=graph)


NAMESPACE = "pybulletgym_tpu_torch"


def register_with_gymnasium() -> None:
    """Register every ID with gymnasium as ``pybulletgym_tpu_torch/<id>``
    (called again, the IDs added by `register` since); does nothing where
    gymnasium is not installed. Keyword arguments of
    ``gymnasium.make`` (``device``, ``render_mode``) reach the adapter."""
    try:
        import gymnasium
        from gymnasium.envs.registration import register as gym_register
    except ImportError:
        return
    for spec in registry.values():
        gym_id = f"{NAMESPACE}/{spec.id}"
        if gym_id in gymnasium.registry:
            continue
        gym_register(
            id=gym_id,
            entry_point=f"{NAMESPACE}.api.gym_adapter:make_adapter",
            max_episode_steps=None,  # the env truncates by itself
            reward_threshold=spec.reward_threshold,
            kwargs={"env_id": spec.id},
            disable_env_checker=True,
        )
