"""Manipulation tasks: Reacher, Pusher, Striker, Thrower (torch port).

Counterpart of the JAX package's `envs/manipulation.py`; every hook is the
same float32 formula in the same order, and every reset draw the same
Threefry stream:

* Reacher [ref: …/robots/manipulators/reacher.py · Reacher]: no plane,
  gravity 0, timestep 0.0165, frame_skip 1; torque 0.05·clip(a) on the
  central and elbow joints; reset central and elbow ~ U(-3.14, 3.14)
  (streams 0, 1), target ~ U(-0.27, 0.27)² (streams 2, 3); obs(9) =
  [target, fingertip - target (xy), cos θ, sin θ, 0.1·θ', elbow
  (limit-normalized), 0.1·elbow']; reward = progress + electricity +
  stuck_joint, never terminates.
* Pusher, Striker, Thrower (Gym-v2 contracts over the repository's
  assets): a 7-dof arm, torque = gear·ctrlrange_hi·clip(a) = 2a; obs(23) =
  [arm q, arm q', tips_arm, object, goal]; arm velocities reset to
  U(-0.005, 0.005) on streams 10 + dof; never terminate.
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
from pybulletgym_tpu_torch.ops import smath as sm
from pybulletgym_tpu_torch.ops.contacts import SolverConfig
from pybulletgym_tpu_torch.ops.step import PhysicsConfig


def _like(seed):
    return torch.zeros(seed.shape, dtype=torch.float32, device=seed.device)


def _push_scale(d):
    """max(1, 0.18 / d): the factor that moves a point at distance d out to
    0.18. The division is a tensor's (`0.18 / d` would be torch's
    reciprocal times 0.18, which rounds twice)."""
    return torch.clamp_min(torch.full_like(d, 0.18) / d, 1.0)


def _world(fk, frame):
    """World position of a model frame (host body, local position)."""
    host, pos = frame[0], frame[1]
    return sm.v3_add(fk.p[host], sm.m3_vec(fk.R[host], tuple(float(x) for x in pos)))


class ReacherTask(Task):
    TARG_LIMIT = 0.27

    def __init__(self):
        self.model = load_mjcf(asset_path("reacher.xml"))
        self.physics = PhysicsConfig(
            timestep=0.0165, frame_skip=1, gravity=(0.0, 0.0, 0.0), solver=SolverConfig(),
        )
        m = self.model
        self.central_dof = m.dof_index("joint0")
        self.elbow_dof = m.dof_index("joint1")
        self.tx_dof = m.dof_index("target_x")
        self.ty_dof = m.dof_index("target_y")
        self.central_qadr = _qadr(m, self.central_dof)
        self.elbow_qadr = _qadr(m, self.elbow_dof)
        self.tx_qadr = _qadr(m, self.tx_dof)
        self.ty_qadr = _qadr(m, self.ty_dof)
        lo, hi = m.jnt_range[self.elbow_dof]
        self.elbow_mid = 0.5 * (lo + hi)
        self.elbow_halfrange = 0.5 * (hi - lo)
        self.fingertip = m.frames["fingertip"][:2]
        self.target_frame = m.frames["target"][:2]
        self.obs_dim = 9
        self.act_dim = 2
        self.max_episode_steps = 150
        self.torque_gain = 0.05

    def initial_state_scalar(self, seed, env_id, epoch):
        like = _like(seed)
        q = [torch.full_like(like, float(x)) for x in self.model.qpos0]
        q[self.central_qadr] = rand.uniform(seed, 0, env_id, epoch, -3.14, 3.14)
        q[self.elbow_qadr] = rand.uniform(seed, 1, env_id, epoch, -3.14, 3.14)
        q[self.tx_qadr] = rand.uniform(seed, 2, env_id, epoch, -self.TARG_LIMIT, self.TARG_LIMIT)
        q[self.ty_qadr] = rand.uniform(seed, 3, env_id, epoch, -self.TARG_LIMIT, self.TARG_LIMIT)
        v = [torch.zeros_like(like) for _ in range(self.model.nv)]
        return q, v, {"potential": self._potential(self._to_target(q, v))}

    def _to_target(self, q, v):
        fk = dyn.forward_kinematics(self.model, q, v, with_inertia=False)
        tip, tgt = _world(fk, self.fingertip), _world(fk, self.target_frame)
        return tuple(a - b for a, b in zip(tip, tgt))

    @staticmethod
    def _potential(d):
        return -100.0 * torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])

    def action_tau_scalar(self, a):
        tau = [0.0] * self.model.nv
        tau[self.central_dof] = self.torque_gain * a[0]
        tau[self.elbow_dof] = self.torque_gain * a[1]
        return tau

    def output_scalar(self, q, v, depths, a, aux, ids=None):
        theta = q[self.central_qadr]
        theta_dot = 0.1 * v[self.central_dof]
        gamma_rel = (q[self.elbow_qadr] - float(self.elbow_mid)) / float(self.elbow_halfrange)
        gamma_dot = 0.1 * v[self.elbow_dof]
        d = self._to_target(q, v)
        obs = [q[self.tx_qadr], q[self.ty_qadr], d[0], d[1],
               torch.cos(theta), torch.sin(theta), theta_dot, gamma_rel, gamma_dot]
        potential = self._potential(d)
        progress = potential - aux["potential"]
        electricity = (
            -0.10 * (torch.abs(a[0] * theta_dot) + torch.abs(a[1] * gamma_dot))
            - 0.01 * (torch.abs(a[0]) + torch.abs(a[1]))
        )
        stuck = torch.where(torch.abs(torch.abs(gamma_rel) - 1.0) < 0.01, -0.1, 0.0)
        reward = progress + electricity + stuck
        terminated = torch.zeros_like(reward, dtype=torch.bool)
        comps = {"progress": progress, "electricity": electricity, "stuck_joint": stuck}
        return obs, reward, terminated, {"potential": potential}, comps


class _ArmTask(Task):
    """What Pusher, Striker and Thrower share: the arm's torques and
    observation, the velocity reset and the three frames."""

    def _arm(self, model, pairs):
        self.model = model
        self.physics = PhysicsConfig(
            timestep=0.0165, frame_skip=1, gravity=(0.0, 0.0, -9.8),
            solver=SolverConfig(self_collision_pairs=pairs),
        )
        self.arm_dofs = [a.v_adr for a in model.actuators]
        self.arm_qadr = [_qadr(model, d) for d in self.arm_dofs]
        self.gains = [float(a.gear * a.ctrlrange[1]) for a in model.actuators]
        self.tips = model.frames["tips_arm"]
        self.obj_frame = model.frames["object"]
        self.goal_frame = model.frames["goal"]
        self.obs_dim = 23
        self.act_dim = 7

    def _v_reset(self, seed, env_id, epoch, still):
        """U(-0.005, 0.005) on stream 10 + dof for every dof, then 0 for the
        dofs in `still` (the object's and the goal's slides)."""
        v = [rand.uniform(seed, 10 + i, env_id, epoch, -0.005, 0.005)
             for i in range(self.model.nv)]
        for dof in still:
            v[dof] = torch.zeros_like(v[dof])
        return v

    def action_tau_scalar(self, a):
        tau = [0.0] * self.model.nv
        for i, dof in enumerate(self.arm_dofs):
            tau[dof] = self.gains[i] * a[i]
        return tau

    def _points_obs(self, q, v):
        fk = dyn.forward_kinematics(self.model, q, v, with_inertia=False)
        tips, obj, goal = (_world(fk, f) for f in (self.tips, self.obj_frame, self.goal_frame))
        obs = ([q[qa] for qa in self.arm_qadr] + [v[d] for d in self.arm_dofs]
               + list(tips) + list(obj) + list(goal))
        return tips, obj, goal, obs


class PusherTask(_ArmTask):
    """7-dof arm pushing a cylinder to a goal on a table [ref:
    …/robots/manipulators/pusher.py · Pusher] — Gym-Pusher-v2: reward =
    dist + 0.5·near + 0.1·ctrl with dist = -|object - goal|, near = -|tips
    - object|, ctrl = -Σa²; reset: object xy ~ (U(-0.3, 0), U(-0.2, 0.2))
    (streams 0, 1), pushed out radially to >= 0.18 from the goal at the
    origin."""

    XML = "pusher.xml"
    # fingertip/forearm capsules vs the object, as the asset's masks pair them
    PAIRS = (("geom15", "geom19"), ("geom16", "geom19"), ("geom17", "geom19"))

    def __init__(self):
        m = load_mjcf(asset_path(self.XML))
        self._arm(m, self.PAIRS)
        self.obj_x = m.dof_index("obj_slidey")  # document order: first slide
        self.obj_y = m.dof_index("obj_slidex")
        self.goal_x = m.dof_index("goal_slidey")
        self.goal_y = m.dof_index("goal_slidex")
        self.max_episode_steps = 150

    def _still(self):
        return (self.obj_x, self.obj_y, self.goal_x, self.goal_y)

    def initial_state_scalar(self, seed, env_id, epoch):
        m = self.model
        like = _like(seed)
        q = [torch.full_like(like, float(x)) for x in m.qpos0]
        cx = rand.uniform(seed, 0, env_id, epoch, -0.3, 0.0)
        cy = rand.uniform(seed, 1, env_id, epoch, -0.2, 0.2)
        d = torch.sqrt(cx * cx + cy * cy) + 1e-9
        scale = _push_scale(d)
        q[_qadr(m, self.obj_x)] = cx * scale
        q[_qadr(m, self.obj_y)] = cy * scale
        q[_qadr(m, self.goal_x)] = torch.zeros_like(like)
        q[_qadr(m, self.goal_y)] = torch.zeros_like(like)
        return q, self._v_reset(seed, env_id, epoch, self._still()), {}

    def output_scalar(self, q, v, depths, a, aux, ids=None):
        tips, obj, goal, obs = self._points_obs(q, v)
        d_no = tuple(o - g for o, g in zip(obj, goal))
        d_to = tuple(t - o for t, o in zip(tips, obj))
        reward_dist = -torch.sqrt(sum(x * x for x in d_no) + 1e-12)
        reward_near = -torch.sqrt(sum(x * x for x in d_to) + 1e-12)
        reward_ctrl = -sum(ai * ai for ai in a)
        reward = reward_dist + 0.5 * reward_near + 0.1 * reward_ctrl
        terminated = torch.zeros_like(reward, dtype=torch.bool)
        comps = {"dist": reward_dist, "near": 0.5 * reward_near, "ctrl": 0.1 * reward_ctrl}
        return obs, reward, terminated, dict(aux), comps


class StrikerTask(PusherTask):
    """Strike the ball so that it slides to the goal [ref:
    …/envs/manipulation/striker_env.py · StrikerBulletEnv] — Gym-Striker-v2
    over the repository's striker.xml: reward = 3·dist + 0.1·ctrl + 0.5·near
    with dist = -(the episode's least |ball - goal|), near = -|ball - tips|
    until the arm first comes within 0.1 of the ball, then -|ball - where it
    struck|; reset: the ball at world BALL_WORLD, the goal ~ (U(0.15, 0.7),
    U(0.1, 1.0)) (streams 0, 1) pushed out to >= 0.18 from the ball."""

    XML = "striker.xml"
    PAIRS = (
        ("wrist_c1", "ball_geom"), ("wrist_c2", "ball_geom"),
        ("wrist_c3", "ball_geom"), ("strike_plate", "ball_geom"),
    )
    BALL_WORLD = (0.5, -0.175)

    def __init__(self):
        super().__init__()
        self.max_episode_steps = 100
        m = self.model
        # world-frame base offsets of the slide chains (host constants)
        self._obj_base = np.asarray(m.frames["object"][1][:2], np.float64)
        self._goal_base = np.asarray(m.frames["goal"][1][:2], np.float64)

    def initial_state_scalar(self, seed, env_id, epoch):
        m = self.model
        like = _like(seed)
        q = [torch.full_like(like, float(x)) for x in m.qpos0]
        bx, by = self.BALL_WORLD
        # slides are (slidey, slidex) in document order
        q[_qadr(m, self.obj_x)] = torch.full_like(like, float(by - self._obj_base[1]))
        q[_qadr(m, self.obj_y)] = torch.full_like(like, float(bx - self._obj_base[0]))
        gx = rand.uniform(seed, 0, env_id, epoch, 0.15, 0.7)
        gy = rand.uniform(seed, 1, env_id, epoch, 0.1, 1.0)
        dx, dy = gx - bx, gy - by
        d = torch.sqrt(dx * dx + dy * dy) + 1e-9
        scale = _push_scale(d)
        gx = bx + dx * scale
        gy = by + dy * scale
        q[_qadr(m, self.goal_x)] = gy - float(self._goal_base[1])
        q[_qadr(m, self.goal_y)] = gx - float(self._goal_base[0])
        v = self._v_reset(seed, env_id, epoch, self._still())
        aux = {"min_dist": torch.full_like(like, 1e3), "striked": torch.zeros_like(like),
               "strike_x": torch.zeros_like(like), "strike_y": torch.zeros_like(like),
               "strike_z": torch.zeros_like(like)}
        return q, v, aux

    def output_scalar(self, q, v, depths, a, aux, ids=None):
        tips, obj, goal, obs = self._points_obs(q, v)
        vec1 = tuple(o - t for o, t in zip(obj, tips))
        vec2 = tuple(o - g for o, g in zip(obj, goal))
        d1 = torch.sqrt(sum(x * x for x in vec1) + 1e-12)
        d2 = torch.sqrt(sum(x * x for x in vec2) + 1e-12)
        min_dist = torch.minimum(aux["min_dist"], d2)
        newly = (d1 < 0.1) & (aux["striked"] < 0.5)
        striked = torch.maximum(aux["striked"], newly.to(torch.float32))
        sx = torch.where(newly, tips[0], aux["strike_x"])
        sy = torch.where(newly, tips[1], aux["strike_y"])
        sz = torch.where(newly, tips[2], aux["strike_z"])
        vec3 = (obj[0] - sx, obj[1] - sy, obj[2] - sz)
        d3 = torch.sqrt(sum(x * x for x in vec3) + 1e-12)
        reward_near = torch.where(striked > 0.5, -d3, -d1)
        reward_dist = -min_dist
        reward_ctrl = -sum(ai * ai for ai in a)
        reward = 3.0 * reward_dist + 0.1 * reward_ctrl + 0.5 * reward_near
        terminated = torch.zeros_like(reward, dtype=torch.bool)
        aux2 = {"min_dist": min_dist, "striked": striked,
                "strike_x": sx, "strike_y": sy, "strike_z": sz}
        comps = {"dist": 3.0 * reward_dist, "near": 0.5 * reward_near,
                 "ctrl": 0.1 * reward_ctrl}
        return obs, reward, terminated, aux2, comps


class ThrowerTask(_ArmTask):
    """Throw the free ball so that it lands near the goal [ref:
    …/envs/manipulation/thrower_env.py · ThrowerBulletEnv] —
    Gym-Thrower-v2 over the repository's thrower.xml: reward = dist +
    0.002·ctrl with dist the xy distance to the goal from the ball, or from
    where it first fell below z = -0.25; reset: goal ~ U(-0.3, 0.3)²
    (streams 0, 1)."""

    def __init__(self):
        m = load_mjcf(asset_path("thrower.xml"))
        self._arm(m, (("geom15", "ball_geom"), ("geom16", "ball_geom"),
                      ("geom17", "ball_geom")))
        self.goal_x = m.dof_index("goal_slidey")
        self.goal_y = m.dof_index("goal_slidex")
        self.max_episode_steps = 100

    def initial_state_scalar(self, seed, env_id, epoch):
        m = self.model
        like = _like(seed)
        q = [torch.full_like(like, float(x)) for x in m.qpos0]
        q[_qadr(m, self.goal_x)] = rand.uniform(seed, 0, env_id, epoch, -0.3, 0.3)
        q[_qadr(m, self.goal_y)] = rand.uniform(seed, 1, env_id, epoch, -0.3, 0.3)
        v = self._v_reset(seed, env_id, epoch, (self.goal_x, self.goal_y))
        aux = {"hit": torch.zeros_like(like), "hit_x": torch.zeros_like(like),
               "hit_y": torch.zeros_like(like)}
        return q, v, aux

    def output_scalar(self, q, v, depths, a, aux, ids=None):
        tips, obj, goal, obs = self._points_obs(q, v)
        newly = (obj[2] < -0.25) & (aux["hit"] < 0.5)
        hit = torch.maximum(aux["hit"], newly.to(torch.float32))
        hx = torch.where(newly, obj[0], aux["hit_x"])
        hy = torch.where(newly, obj[1], aux["hit_y"])
        bx = torch.where(hit > 0.5, hx, obj[0])
        by = torch.where(hit > 0.5, hy, obj[1])
        gx, gy = bx - goal[0], by - goal[1]
        reward_dist = -torch.sqrt(gx * gx + gy * gy + 1e-12)
        reward_ctrl = -sum(ai * ai for ai in a)
        reward = reward_dist + 0.002 * reward_ctrl
        terminated = torch.zeros_like(reward, dtype=torch.bool)
        aux2 = {"hit": hit, "hit_x": hx, "hit_y": hy}
        comps = {"dist": reward_dist, "ctrl": 0.002 * reward_ctrl}
        return obs, reward, terminated, aux2, comps
