"""gymnasium adapters over the batched env: counterpart of the JAX
package's `api/gym_adapter.py`.

`GymAdapter` is one `BatchedEnv` of B=1 with gymnasium 1.x semantics
(reset -> (obs, info), step -> 5-tuple); `VectorAdapter` is B envs behind
gymnasium's vector API, whose next-step auto-reset is what `envs.base`
implements on the device. On a CUDA device each `step` is one launch of
the env-step kernel and one copy of its outputs to the host.

gymnasium is optional here. Where it is installed the adapters subclass
`gymnasium.Env` and `gymnasium.vector.VectorEnv` and their spaces are
`gymnasium.spaces.Box`; where it is not, they are plain classes with the
same methods and their spaces are the `Box` record below. The env step is
the same either way.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

try:
    import gymnasium
except ImportError:
    gymnasium = None


class Box(NamedTuple):
    """The fields of `gymnasium.spaces.Box` that the adapters fill, where
    gymnasium is not installed."""

    low: np.ndarray
    high: np.ndarray
    shape: Tuple[int, ...]
    dtype: type


def _box(low: float, high: float, shape: Tuple[int, ...]):
    if gymnasium is not None:
        return gymnasium.spaces.Box(low, high, shape, np.float32)
    return Box(np.full(shape, low, np.float32), np.full(shape, high, np.float32), shape,
               np.float32)


def _batch_space(space, n: int):
    if gymnasium is not None:
        return gymnasium.vector.utils.batch_space(space, n)
    return Box(np.stack([space.low] * n), np.stack([space.high] * n), (n,) + space.shape,
               space.dtype)


def _to_host(state):
    """(obs (B, obs_dim) float32, reward (B,) float32, terminated and
    truncated (B,) bool, {component: (B,) float32}) from one copy: the rows
    are stacked on the device (the flags as 0.0/1.0, exactly) and brought to
    the host together."""
    comps = list(state.rewards)
    rows = torch.cat([state.obs, state.reward[None], state.terminated[None].float(),
                      state.truncated[None].float(), *(state.rewards[k][None] for k in comps)], 0)
    host = rows.cpu().numpy()
    n = state.obs.shape[0]
    return (np.ascontiguousarray(host[:n].T), host[n].copy(), host[n + 1] != 0.0,
            host[n + 2] != 0.0, {k: host[n + 3 + i].copy() for i, k in enumerate(comps)})


class _Epochs:
    """The reset rule of the JAX adapters: a seed starts epoch 0 of its
    stream; a reset without one takes the next epoch of the last seed
    (seed 0 at first), so episodes draw fresh, reproducible states."""

    def __init__(self):
        self.seed, self.epoch = 0, -1

    def next(self, seed: Optional[int]) -> Tuple[int, int]:
        if seed is not None:
            self.seed, self.epoch = seed, 0
        else:
            self.epoch += 1
        return self.seed, self.epoch


class GymAdapter(gymnasium.Env if gymnasium is not None else object):
    """One env (a `BatchedEnv` of B=1) on `device`: the GPU unless the
    caller asks for "cpu"; `backend` and `graph` go to the `BatchedEnv`."""

    metadata = {"render_modes": ["rgb_array", "human"]}

    def __init__(self, task, spec, render_mode: Optional[str] = None, device="cuda",
                 backend: str = "fused", graph: bool = True):
        from pybulletgym_tpu_torch.envs.base import BatchedEnv

        self._env = BatchedEnv(task, 1, device=device, backend=backend, graph=graph)
        self._spec = spec
        self._state = None
        self._epochs = _Epochs()
        self._human_broken = False
        self.render_mode = render_mode
        # [ref: robot_bases.py · XmlBasedRobot.__init__ — Box(-1,1) actions,
        #  unbounded observations]
        self.action_space = _box(-1.0, 1.0, (task.act_dim,))
        self.observation_space = _box(-np.inf, np.inf, (task.obs_dim,))

    def reset(self, *, seed: Optional[int] = None, options=None):
        seed, epoch = self._epochs.next(seed)
        self._state = self._env.reset(seed=seed, epoch=epoch)
        return self._state.obs[:, 0].cpu().numpy(), {}

    def step(self, action):
        if self._state is None:
            raise RuntimeError("call reset() first")
        a = np.asarray(action, np.float32).reshape(1, -1)
        self._state = self._env.step(self._state, a)
        obs, reward, term, trunc, comps = _to_host(self._state)
        return (obs[0], float(reward[0]), bool(term[0]), bool(trunc[0]),
                {k: float(v[0]) for k, v in comps.items()})

    def render(self):
        """The rgb_array frame of the current state; in "human" mode the
        frame is shown (matplotlib) and None returned. Where no window can
        open, "human" warns once and returns None."""
        from pybulletgym_tpu_torch.utils.render import render_state

        frame = render_state(self._env.task, self._state)
        if self.render_mode == "human":
            self._show(frame)
            return None
        return frame

    def _show(self, frame):
        if self._human_broken:
            return
        try:
            import matplotlib

            if not hasattr(self, "_imshow"):
                import matplotlib.pyplot as plt

                if matplotlib.get_backend().lower() == "agg":
                    raise RuntimeError("no interactive matplotlib backend")
                plt.ion()
                self._fig, ax = plt.subplots(num=self._spec.id)
                ax.set_axis_off()
                self._imshow = ax.imshow(frame)
            else:
                self._imshow.set_data(frame)
            self._fig.canvas.draw_idle()
            self._fig.canvas.flush_events()
        except Exception as e:  # a display boundary: no matplotlib, backend or display
            self._human_broken = True
            warnings.warn(
                f"render_mode='human' unavailable ({e!r}); use render_mode='rgb_array' "
                "to get the frames"
            )

    def close(self):
        if hasattr(self, "_fig"):
            import matplotlib.pyplot as plt

            plt.close(self._fig)


class _PlainVectorEnv:
    """What `VectorAdapter` takes from `gymnasium.vector.VectorEnv`, where
    gymnasium is not installed."""

    def close(self, **kwargs):
        self.close_extras(**kwargs)


class VectorAdapter(gymnasium.vector.VectorEnv if gymnasium is not None else _PlainVectorEnv):
    """`num_envs` envs on `device` behind gymnasium's vector API: numpy in
    and out, (B, dim) batch-leading; `backend` and `graph` go to the
    `BatchedEnv`."""

    metadata = {"render_modes": []}

    def __init__(self, env_id: str, num_envs: int, device="cuda", backend: str = "fused",
                 graph: bool = True):
        from pybulletgym_tpu_torch.api.registry import make_batched, registry

        self._env = make_batched(env_id, num_envs, device=device, backend=backend, graph=graph)
        task = self._env.task
        self.spec = registry[env_id]
        self.num_envs = num_envs
        self.single_action_space = _box(-1.0, 1.0, (task.act_dim,))
        self.single_observation_space = _box(-np.inf, np.inf, (task.obs_dim,))
        self.action_space = _batch_space(self.single_action_space, num_envs)
        self.observation_space = _batch_space(self.single_observation_space, num_envs)
        self._state = None
        self._epochs = _Epochs()

    def reset(self, *, seed: Optional[int] = None, options=None):
        seed, epoch = self._epochs.next(seed)
        self._state = self._env.reset(seed=seed, epoch=epoch)
        return self._state.obs.T.contiguous().cpu().numpy(), {}

    def step(self, actions):
        if self._state is None:
            raise RuntimeError("call reset() first")
        a = np.asarray(actions, np.float32).reshape(self.num_envs, -1)
        self._state = self._env.step(self._state, a)
        return _to_host(self._state)

    def close_extras(self, **kwargs):
        pass


def make_adapter(env_id: str, **kwargs) -> GymAdapter:
    """gymnasium's entry point for ``pybulletgym_tpu_torch/<env_id>``;
    `kwargs` (``device``, ``render_mode``, ``backend``, ``graph``) go to
    `GymAdapter`."""
    from pybulletgym_tpu_torch.api import registry as reg

    return GymAdapter(reg.make_task(env_id), reg.registry[env_id], **kwargs)


def make_vec(env_id: str, num_envs: int, device="cuda", backend: str = "fused",
             graph: bool = True) -> VectorAdapter:
    """`num_envs` envs of `env_id` behind the vector API, on `device`: the
    GPU unless the caller asks for "cpu". `backend` and `graph` go to its
    `BatchedEnv` ("composed" runs a task whose hooks "fused" cannot
    translate)."""
    return VectorAdapter(env_id, num_envs, device=device, backend=backend, graph=graph)
