"""Pendulum tasks: InvertedPendulum (+Swingup), InvertedDoublePendulum
(torch port of the JAX package's `envs/pendula.py`, formula for formula).

* InvertedPendulum [ref: …/envs/pendulum/inverted_pendulum_env.py]: torque
  100·clip(a) on the slider; reward 1 a step, done when |θ| > 0.2. The
  swing-up variant resets the pole hanging (θ = π + u), rewards cos θ and
  never terminates.
* InvertedDoublePendulum [ref: …/inverted_double_pendulum_env.py]: torque
  200·clip(a); reward 10 − dist_penalty − vel_penalty with dist_penalty =
  0.01·x² + (y + 0.3 − 2)², vel_penalty = 1e-3·θ₁'² + 5e-3·θ₂'², where (x,
  y) are pole2's COM x and height; done when y + 0.3 <= 1.
* Scene: gravity 9.8, timestep 0.0165, frame_skip 1; reset joint angles ~
  U(-0.1, 0.1) (stream 0, and 1 for the second hinge), zero velocity.
"""

from __future__ import annotations

import numpy as np
import torch

from pybulletgym_tpu_torch.envs.base import Task
from pybulletgym_tpu_torch.envs.locomotion import _qadr
from pybulletgym_tpu_torch.models.assets import asset_path
from pybulletgym_tpu_torch.models.mjcf import load_mjcf
from pybulletgym_tpu_torch.ops import dynamics as dyn
from pybulletgym_tpu_torch.ops import rand
from pybulletgym_tpu_torch.ops.contacts import SolverConfig
from pybulletgym_tpu_torch.ops.step import PhysicsConfig


def _physics():
    return PhysicsConfig(timestep=0.0165, frame_skip=1, gravity=(0.0, 0.0, -9.8),
                         solver=SolverConfig())


def _like(seed):
    return torch.zeros(seed.shape, dtype=torch.float32, device=seed.device)


class InvertedPendulumTask(Task):
    """Cart-pole balance or swing-up [ref: …/robots/pendula/interted_pendulum.py
    · InvertedPendulum]."""

    def __init__(self, swingup: bool = False):
        self.swingup = swingup
        self.model = load_mjcf(asset_path("inverted_pendulum.xml"))
        self.physics = _physics()
        m = self.model
        self.slider_dof = m.dof_index("slider")
        self.hinge_dof = m.dof_index("hinge")
        self.slider_qadr = _qadr(m, self.slider_dof)
        self.hinge_qadr = _qadr(m, self.hinge_dof)
        self.obs_dim = 5
        self.act_dim = 1
        self.max_episode_steps = 1000
        self.torque_gain = 100.0

    def initial_state_scalar(self, seed, env_id, epoch):
        like = _like(seed)
        q = [torch.full_like(like, float(x)) for x in self.model.qpos0]
        u = rand.uniform(seed, 0, env_id, epoch, -0.1, 0.1)
        q[self.hinge_qadr] = (np.pi if self.swingup else 0.0) + u
        v = [torch.zeros_like(like) for _ in range(self.model.nv)]
        return q, v, {}

    def action_tau_scalar(self, a):
        tau = [0.0] * self.model.nv
        tau[self.slider_dof] = self.torque_gain * a[0]
        return tau

    def output_scalar(self, q, v, depths, a, aux, ids=None):
        theta = q[self.hinge_qadr]
        obs = [q[self.slider_qadr], v[self.slider_dof], torch.cos(theta), torch.sin(theta),
               v[self.hinge_dof]]
        if self.swingup:
            reward = torch.cos(theta)
            terminated = torch.zeros_like(reward, dtype=torch.bool)
        else:
            reward = torch.ones_like(theta)
            terminated = torch.abs(theta) > 0.2
        return obs, reward, terminated, dict(aux), {"reward": reward}


class InvertedDoublePendulumTask(Task):
    """[ref: …/robots/pendula/inverted_double_pendulum.py +
    …/envs/pendulum/inverted_double_pendulum_env.py]."""

    def __init__(self):
        self.model = load_mjcf(asset_path("inverted_double_pendulum.xml"))
        self.physics = _physics()
        m = self.model
        self.slider_dof = m.dof_index("slider")
        self.j1_dof = m.dof_index("hinge")
        self.j2_dof = m.dof_index("hinge2")
        self.slider_qadr = _qadr(m, self.slider_dof)
        self.j1_qadr = _qadr(m, self.j1_dof)
        self.j2_qadr = _qadr(m, self.j2_dof)
        self.pole2 = m.body_index("pole2")
        self.obs_dim = 9
        self.act_dim = 1
        self.max_episode_steps = 1000
        self.torque_gain = 200.0

    def initial_state_scalar(self, seed, env_id, epoch):
        like = _like(seed)
        q = [torch.full_like(like, float(x)) for x in self.model.qpos0]
        q[self.j1_qadr] = rand.uniform(seed, 0, env_id, epoch, -0.1, 0.1)
        q[self.j2_qadr] = rand.uniform(seed, 1, env_id, epoch, -0.1, 0.1)
        v = [torch.zeros_like(like) for _ in range(self.model.nv)]
        return q, v, {}

    def action_tau_scalar(self, a):
        tau = [0.0] * self.model.nv
        tau[self.slider_dof] = self.torque_gain * a[0]
        return tau

    def output_scalar(self, q, v, depths, a, aux, ids=None):
        fk = dyn.forward_kinematics(self.model, q, v, with_inertia=False)
        com2 = fk.com[self.pole2]
        pos_x, pos_y = com2[0], com2[2]  # reference naming: y is height
        theta, theta_dot = q[self.j1_qadr], v[self.j1_dof]
        gamma, gamma_dot = q[self.j2_qadr], v[self.j2_dof]
        obs = [q[self.slider_qadr], v[self.slider_dof], pos_x,
               torch.cos(theta), torch.sin(theta), theta_dot,
               torch.cos(gamma), torch.sin(gamma), gamma_dot]
        h = pos_y + 0.3 - 2.0
        dist_penalty = 0.01 * (pos_x * pos_x) + h * h
        vel_penalty = 1e-3 * (theta_dot * theta_dot) + 5e-3 * (gamma_dot * gamma_dot)
        alive = 10.0 * torch.ones_like(pos_x)
        reward = alive - dist_penalty - vel_penalty
        terminated = (pos_y + 0.3) <= 1.0
        comps = {"alive": alive, "dist_penalty": -dist_penalty, "vel_penalty": -vel_penalty}
        return obs, reward, terminated, dict(aux), comps
