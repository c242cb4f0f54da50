"""Env registry for the port: the reference env IDs that the torch package
runs [ref: pybulletgym/envs/__init__.py — gym.envs.registration.register].

The MJCF walkers are ported so far: Hopper, Walker2D, HalfCheetah, Ant and
the humanoid family (Humanoid, HumanoidFlagrun, HumanoidFlagrunHarder);
any other ID raises `KeyError` listing the known ones.
Nothing is registered with gymnasium (the JAX package registers the same
IDs for itself on import).
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


def _task(class_name: str) -> Callable:
    def factory():
        from pybulletgym_tpu_torch.envs import locomotion as loco

        return getattr(loco, class_name)()

    return factory


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
    )
}


def make_task(id: str):
    """The Task (model + scalar hooks) behind an env id; a fresh instance."""
    if id not in registry:
        raise KeyError(f"unknown env id {id!r}; known: {sorted(registry)}")
    spec = registry[id]
    task = spec.task_factory()
    task.max_episode_steps = spec.max_episode_steps
    return task


def make_batched(id: str, batch_size: int, device="cuda"):
    """A `BatchedEnv` of `batch_size` envs on `device`: the GPU unless the
    caller asks for "cpu" (without a GPU, "cuda" raises)."""
    from pybulletgym_tpu_torch.envs.base import BatchedEnv

    return BatchedEnv(make_task(id), batch_size, device=device)
