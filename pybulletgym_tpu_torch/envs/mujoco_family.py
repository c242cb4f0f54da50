"""MuJoCo-parity env family: the ``*MuJoCoEnv-v0`` mirrors (torch port of
the JAX package's `envs/mujoco_family.py`, formula for formula)
[ref: pybulletgym/envs/mujoco/**].

Same engine and timing as the PyBullet-family tasks, but the Gym-MuJoCo-v2
obs/reward/termination contracts:

* Hopper:      obs 11 = [qpos[1:], clip(qvel, ±10)];
               r = 1 + vx - 1e-3·Σa²; done unless z>0.7, |ang|<0.2,
               all |state[2:]|<100
* Walker2d:    obs 17 = [qpos[1:], clip(qvel, ±10)];
               r = 1 + vx - 1e-3·Σa²; done unless 0.8<z<2.0, |ang|<1.0
* HalfCheetah: obs 17 = [qpos[1:], qvel]; r = vx - 0.1·Σa²; never done
* Ant:         obs 111 = [z, quat, joints, qvel_mj(14), cfrc_ext(84)=0];
               r = vx + 1 - 0.5·Σa²; done unless 0.2<=z<=1.0 (and finite)
* Humanoid:    obs 376 = [qpos[2:], qvel_mj(23), 331 zeros];
               r = 5 + 1.25·vx - 0.1·Σa²; done unless 1.0<z<2.0
* Reacher:     obs 11 = [cos th, sin th, target, qvel_arm, tip - target];
               r = -|tip - target| - Σa²; never done
* InvertedPendulum:       obs 4 = [qpos, qvel]; r = 1; done |theta|>0.2
* InvertedDoublePendulum: obs 11 = [x, sin th, cos th, qvel, 3 zeros];
               r = 10 - 0.01·x_tip² - (y_tip-2)² - 1e-3·v1² - 5e-3·v2²;
               done when y_tip <= 1

Torque: gear·ctrlrange_hi·clip(a, -1, 1) on each actuated dof. Reset:
qpos0 + U(±noise) on stream i for q[i] and U(±noise) on stream nq + i for
v[i] (a free joint's quaternion too, left unnormalised). Forward velocity
vx = (x - aux["x"]) / control_dt, the position difference of the root x,
held in aux between steps.
"""

from __future__ import annotations

import torch

from pybulletgym_tpu_torch.envs.base import Task
from pybulletgym_tpu_torch.models.assets import asset_path
from pybulletgym_tpu_torch.models.mjcf import load_mjcf
from pybulletgym_tpu_torch.ops import dynamics as dyn
from pybulletgym_tpu_torch.ops import rand
from pybulletgym_tpu_torch.ops import smath as sm
from pybulletgym_tpu_torch.ops.contacts import SolverConfig
from pybulletgym_tpu_torch.ops.step import PhysicsConfig


def _like(seed):
    return torch.zeros(seed.shape, dtype=torch.float32, device=seed.device)


def _sq_sum(xs):
    """sum(x * x for x in xs), Python's left-to-right sum."""
    return sum(x * x for x in xs)


class _MjBase(Task):
    """Shared plumbing: model load, torque map, uniform reset noise."""

    xml: str
    reset_noise: float = 0.005
    frame_skip: int = 4
    timestep: float = 0.0165 / 4

    def __init__(self):
        self.model = load_mjcf(asset_path(self.xml))
        self.physics = PhysicsConfig(
            timestep=self.timestep, frame_skip=self.frame_skip,
            gravity=(0.0, 0.0, -9.8), solver=SolverConfig(),
        )
        m = self.model
        self.act_dofs = [a.v_adr for a in m.actuators]
        self.torque_gain = [a.gear * a.ctrlrange[1] for a in m.actuators]
        self.act_dim = len(m.actuators)
        self.max_episode_steps = 1000
        self._setup()

    def _setup(self):
        pass

    def action_tau_scalar(self, a):
        tau = [0.0] * self.model.nv
        for i, d in enumerate(self.act_dofs):
            tau[d] = self.torque_gain[i] * a[i]
        return tau

    def initial_state_scalar(self, seed, env_id, epoch):
        m = self.model
        like = _like(seed)
        n = self.reset_noise
        q = [float(m.qpos0[i]) + rand.uniform(seed, i, env_id, epoch, -n, n)
             for i in range(m.nq)]
        v = [rand.uniform(seed, m.nq + i, env_id, epoch, -n, n) for i in range(m.nv)]
        q = [torch.zeros_like(like) + x for x in q]
        v = [torch.zeros_like(like) + x for x in v]
        return q, v, self._init_aux(q, v)

    def _init_aux(self, q, v):
        return {"x": q[0]}

    def _vx(self, q, aux):
        return (q[0] - aux["x"]) / self.physics.control_dt


class _MjPlanarWalker(_MjBase):
    """Hopper / Walker2d / HalfCheetah: the planar root (rootx, rootz, rooty)."""

    ctrl_coef: float
    alive_bonus: float
    clip_qvel: bool

    def output_scalar(self, q, v, depths, a, aux, ids=None):
        x = q[0]
        vx = self._vx(q, aux)
        qv = [torch.clamp(vi, -10.0, 10.0) for vi in v] if self.clip_qvel else list(v)
        obs = list(q[1:]) + qv
        ctrl = self.ctrl_coef * _sq_sum(a)
        reward = self.alive_bonus + vx - ctrl
        terminated = self._done(q, v)
        comps = {"forward": vx, "ctrl_cost": -ctrl, "alive": self.alive_bonus + 0.0 * vx}
        return obs, reward, terminated, {"x": x}, comps

    def _done(self, q, v):
        raise NotImplementedError


class HopperMuJoCoTask(_MjPlanarWalker):
    """[ref: pybulletgym/envs/mujoco/envs/locomotion/hopper_env.py]"""

    xml = "hopper.xml"
    ctrl_coef = 1e-3
    alive_bonus = 1.0
    clip_qvel = True
    obs_dim = 11

    def _done(self, q, v):
        z, ang = q[1], q[2]
        healthy = (z > 0.7) & (torch.abs(ang) < 0.2)
        for s in list(q[2:]) + list(v):
            healthy = healthy & (torch.abs(s) < 100.0)
        return ~healthy


class Walker2DMuJoCoTask(_MjPlanarWalker):
    """[ref: …/mujoco/envs/locomotion/walker2d_env.py]"""

    xml = "walker2d.xml"
    ctrl_coef = 1e-3
    alive_bonus = 1.0
    clip_qvel = True
    obs_dim = 17

    def _done(self, q, v):
        z, ang = q[1], q[2]
        return ~((z > 0.8) & (z < 2.0) & (torch.abs(ang) < 1.0))


class HalfCheetahMuJoCoTask(_MjPlanarWalker):
    """[ref: …/mujoco/envs/locomotion/half_cheetah_env.py]"""

    xml = "half_cheetah.xml"
    ctrl_coef = 0.1
    alive_bonus = 0.0
    clip_qvel = False
    obs_dim = 17
    reset_noise = 0.1

    def _done(self, q, v):
        return torch.zeros_like(q[0], dtype=torch.bool)


def _mj_qvel(q, v):
    """MuJoCo's free-root qvel: the body-frame linear velocity turned to the
    world frame by the root quaternion, the angular one as it is, then the
    joints."""
    R = sm.m3_from_quat((q[3], q[4], q[5], q[6]))
    return list(sm.m3_vec(R, (v[3], v[4], v[5]))) + [v[0], v[1], v[2]] + list(v[6:])


class _MjFreeWalker(_MjBase):
    """Ant / Humanoid: a free root. obs = [qpos[2:], MuJoCo's qvel, zero
    blocks]; reward = alive + fwd·vx - ctrl·Σa²."""

    ctrl_coef: float
    alive_bonus: float
    fwd_coef: float
    n_zero: int

    def output_scalar(self, q, v, depths, a, aux, ids=None):
        x = q[0]
        vx = self._vx(q, aux)
        zero = 0.0 * x
        obs = list(q[2:]) + _mj_qvel(q, v) + [zero] * self.n_zero
        ctrl = self.ctrl_coef * _sq_sum(a)
        fwd = self.fwd_coef * vx
        reward = self.alive_bonus + fwd - ctrl
        comps = {"forward": fwd, "alive": self.alive_bonus + zero, "ctrl_cost": -ctrl}
        return obs, reward, self._done(q, v), {"x": x}, comps


class AntMuJoCoTask(_MjFreeWalker):
    """[ref: …/mujoco/envs/locomotion/ant_env.py] — obs 111 with the
    cfrc_ext block (84) zero (the reference's Bullet port cannot produce
    MuJoCo constraint forces either); r = vx + 1 - 0.5·Σa²."""

    xml = "ant.xml"
    obs_dim = 111
    reset_noise = 0.1
    ctrl_coef, alive_bonus, fwd_coef, n_zero = 0.5, 1.0, 1.0, 84

    def _done(self, q, v):
        z = q[2]
        finite = torch.isfinite(z)
        for s in list(q) + list(v):
            finite = finite & torch.isfinite(s)
        return ~(finite & (z >= 0.2) & (z <= 1.0))


class HumanoidMuJoCoTask(_MjFreeWalker):
    """[ref: …/mujoco/envs/locomotion/humanoid_env.py] — obs 376 =
    [qpos[2:](22), qvel(23), cinert(140), cvel(84), qfrc_actuator(23),
    cfrc_ext(84)] with the last four blocks zero; r = 5 + 1.25·vx -
    0.1·Σa² (impact cost 0)."""

    xml = "humanoid.xml"
    obs_dim = 376
    reset_noise = 0.01
    ctrl_coef, alive_bonus, fwd_coef, n_zero = 0.1, 5.0, 1.25, 140 + 84 + 23 + 84

    def _done(self, q, v):
        z = q[2]
        return ~((z > 1.0) & (z < 2.0))


def _world(fk, host, pos):
    return sm.v3_add(fk.p[host], sm.m3_vec(fk.R[host], tuple(float(x) for x in pos)))


class ReacherMuJoCoTask(_MjBase):
    """[ref: …/mujoco/envs/manipulation/reacher_env.py] — Gym-Reacher-v2.
    Reset: the joints ~ U(±0.1) (streams 0, 1), the target in the 0.2-radius
    disk (r = 0.2·sqrt(U) on stream 2, angle U(±3.14159) on stream 3), the
    arm's velocities U(±0.005) on streams 4 + dof, the target's zero."""

    xml = "reacher.xml"
    obs_dim = 11
    frame_skip = 1
    timestep = 0.0165

    def _setup(self):
        m = self.model
        self.j0 = m.dof_index("joint0")
        self.j1 = m.dof_index("joint1")
        self.tx = m.dof_index("target_x")
        self.ty = m.dof_index("target_y")
        self.fingertip = m.frames["fingertip"]
        self.target = m.frames["target"]

    def initial_state_scalar(self, seed, env_id, epoch):
        m = self.model
        like = _like(seed)
        q = [torch.full_like(like, float(x)) for x in m.qpos0]
        q[self.j0] = rand.uniform(seed, 0, env_id, epoch, -0.1, 0.1)
        q[self.j1] = rand.uniform(seed, 1, env_id, epoch, -0.1, 0.1)
        u = rand.uniform(seed, 2, env_id, epoch, 0.0, 1.0)
        ang = rand.uniform(seed, 3, env_id, epoch, -3.14159, 3.14159)
        r = 0.2 * torch.sqrt(u)
        q[self.tx] = r * torch.cos(ang)
        q[self.ty] = r * torch.sin(ang)
        v = [rand.uniform(seed, 4 + i, env_id, epoch, -0.005, 0.005) for i in range(m.nv)]
        v[self.tx] = torch.zeros_like(like)
        v[self.ty] = torch.zeros_like(like)
        return q, v, {}

    def _vec(self, q, v):
        fk = dyn.forward_kinematics(self.model, q, v, with_inertia=False)
        tip = _world(fk, *self.fingertip[:2])
        tgt = _world(fk, *self.target[:2])
        return tuple(a - b for a, b in zip(tip, tgt))

    def output_scalar(self, q, v, depths, a, aux, ids=None):
        vec = self._vec(q, v)
        obs = [torch.cos(q[self.j0]), torch.cos(q[self.j1]),
               torch.sin(q[self.j0]), torch.sin(q[self.j1]),
               q[self.tx], q[self.ty], v[self.j0], v[self.j1], vec[0], vec[1], vec[2]]
        reward_dist = -torch.sqrt(_sq_sum(vec) + 1e-12)
        reward_ctrl = -_sq_sum(a)
        reward = reward_dist + reward_ctrl
        terminated = torch.zeros_like(reward, dtype=torch.bool)
        return obs, reward, terminated, dict(aux), {"dist": reward_dist, "ctrl": reward_ctrl}


class InvertedPendulumMuJoCoTask(_MjBase):
    """[ref: …/mujoco/envs/pendulum/inverted_pendulum_env.py]"""

    xml = "inverted_pendulum.xml"
    obs_dim = 4
    frame_skip = 1
    timestep = 0.0165
    reset_noise = 0.01

    def output_scalar(self, q, v, depths, a, aux, ids=None):
        obs = list(q) + list(v)
        reward = torch.ones_like(q[0])
        terminated = torch.abs(q[1]) > 0.2
        return obs, reward, terminated, dict(aux), {"reward": reward}

    def _init_aux(self, q, v):
        return {}


class InvertedDoublePendulumMuJoCoTask(_MjBase):
    """[ref: …/mujoco/envs/pendulum/inverted_double_pendulum_env.py] — obs
    11 with the qfrc_constraint block zero; the tip is pole2's frame plus
    (0, 0, 0.6) (inverted_double_pendulum.xml:39)."""

    xml = "inverted_double_pendulum.xml"
    obs_dim = 11
    frame_skip = 1
    timestep = 0.0165
    reset_noise = 0.01
    TIP = (0.0, 0.0, 0.6)

    def _setup(self):
        self.pole2 = self.model.body_index("pole2")

    def output_scalar(self, q, v, depths, a, aux, ids=None):
        fk = dyn.forward_kinematics(self.model, q, v, with_inertia=False)
        tip = _world(fk, self.pole2, self.TIP)
        x_tip, y_tip = tip[0], tip[2]
        zero = 0.0 * q[0]
        obs = [q[0], torch.sin(q[1]), torch.sin(q[2]), torch.cos(q[1]), torch.cos(q[2]),
               v[0], v[1], v[2], zero, zero, zero]
        dist_penalty = 0.01 * x_tip ** 2 + (y_tip - 2.0) ** 2
        vel_penalty = 1e-3 * v[1] ** 2 + 5e-3 * v[2] ** 2
        reward = 10.0 - dist_penalty - vel_penalty
        terminated = y_tip <= 1.0
        comps = {"alive": 10.0 + zero, "dist_penalty": -dist_penalty,
                 "vel_penalty": -vel_penalty}
        return obs, reward, terminated, dict(aux), comps

    def _init_aux(self, q, v):
        return {}
