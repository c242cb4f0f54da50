"""Locomotion tasks: the Roboschool walker contract (torch port).

Counterpart of the JAX package's `envs/locomotion.py` for the MJCF walkers
(WalkerSpec, WalkerTask) and the Hopper, Walker2D, HalfCheetah and Ant specs:

* obs  = clip(concat(more(8), joints(2n), feet_contact(nf)), -5, 5)
  [ref: …/robots/locomotors/walker_base.py · WalkerBase.calc_state]
* joint obs are limit-normalized positions and 0.1-scaled velocities
  [ref: robot_bases.py · Joint.current_relative_position]
* reward = alive + progress + electricity + joints_at_limit + feet_collision
  with electricity_cost=-2.0, stall_torque_cost=-0.1,
  joints_at_limit_cost=-0.1
  [ref: …/envs/locomotion/walker_base_env.py · WalkerBaseBulletEnv.step]
* torque_j = power * power_coef_j * clip(a_j, -1, 1)
  [ref: walker_base.py · WalkerBase.apply_action]
* reset: every ordered joint set to uniform(-0.1, 0.1), zero velocity
  [ref: walker_base.py · robot_specific_reset]
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pybulletgym_tpu_torch.envs.base import Task
from pybulletgym_tpu_torch.models.assets import asset_path
from pybulletgym_tpu_torch.models.mjcf import load_mjcf
from pybulletgym_tpu_torch.models.schema import GeomType, Model
from pybulletgym_tpu_torch.ops import dynamics as dyn
from pybulletgym_tpu_torch.ops import rand
from pybulletgym_tpu_torch.ops import smath as sm
from pybulletgym_tpu_torch.ops.contacts import SolverConfig, build_contact_plan, plan_row_geoms
from pybulletgym_tpu_torch.ops.step import PhysicsConfig


@dataclasses.dataclass(frozen=True)
class WalkerSpec:
    """Static description of one locomotion env (SURVEY §2.4/§2.6)."""

    name: str
    xml: str
    power: float
    alive_mode: str                     # 'hopper' | 'cheetah' | 'ant' | 'humanoid'
    foot_geoms: Tuple[str, ...]         # geom names, reference foot_list order
    coef_overrides: Dict[str, float] = dataclasses.field(default_factory=dict)
    cost_scale: float = 1.0             # Humanoid: 4.25
    # stall-torque cost scale; None = same as cost_scale. FlagrunHarder
    # quarters ONLY the electricity term (`electricity_cost /= 4` in the
    # reference), leaving stall torque at the humanoid 4.25 (ADVICE r1)
    stall_scale: Optional[float] = None
    max_episode_steps: int = 1000
    self_collision: Tuple[Tuple[str, str], ...] = ()
    # bodies excluded from the reference `parts` mean (non-robot bodies,
    # e.g. the FlagrunHarder cube lives in a separate Bullet body there)
    exclude_parts: Tuple[str, ...] = ()
    # robot_body link (MJCF walkers: "torso"; Atlas URDF: "pelvis")
    base_body_name: str = "torso"


class WalkerTask(Task):
    electricity_cost = -2.0
    stall_torque_cost = -0.1
    joints_at_limit_cost = -0.1
    foot_collision_cost = -1.0

    def __init__(self, spec: WalkerSpec):
        self.spec = spec
        self.model = load_mjcf(asset_path(spec.xml))
        if not any(
            g.gtype == GeomType.PLANE and g.body == -1
            for g in self.model.geoms
        ):
            raise NotImplementedError(f"{spec.name}: models without a floor plane are not ported yet")
        m = self.model
        sc = spec.self_collision
        if sc and sc[0] == "full":
            raise NotImplementedError(f"{spec.name}: full self-collision is not ported yet")
        solver = SolverConfig(self_collision_pairs=sc)
        # Walker timing [ref: scene_bases.py · SinglePlayerStadiumScene]:
        # gravity 9.8, timestep 0.0165/4, frame_skip 4.
        self.physics = PhysicsConfig(
            timestep=0.0165 / 4, frame_skip=4, gravity=(0.0, 0.0, -9.8), solver=solver
        )

        # ordered joints = actuated joints in document order
        # [ref: robot_bases.py · XmlBasedRobot.addToScene — ordered_joints]
        self.act_dofs = np.array([a.v_adr for a in m.actuators], np.int32)
        self.act_qadr = np.array(
            [_qadr(m, a.v_adr) for a in m.actuators], np.int32
        )
        gains = []
        for a in m.actuators:
            coef = spec.coef_overrides.get(a.joint, a.gear)
            gains.append(spec.power * coef)
        self.gains = np.array(gains, np.float32)[:, None]
        lo = m.jnt_range[self.act_dofs, 0].astype(np.float32)
        hi = m.jnt_range[self.act_dofs, 1].astype(np.float32)
        self.j_mid = ((lo + hi) / 2.0)[:, None]
        self.j_halfrange = ((hi - lo) / 2.0)[:, None]

        self.act_dim = len(m.actuators)
        self.obs_dim = 8 + 2 * self.act_dim + len(spec.foot_geoms)
        self.max_episode_steps = spec.max_episode_steps

        # foot geom -> contact candidate rows (static)
        row_geoms = plan_row_geoms(build_contact_plan(m, solver))
        self.foot_rows = tuple(
            tuple(i for i, g in enumerate(row_geoms) if g == fg)
            for fg in spec.foot_geoms
        )
        for fg, rows in zip(spec.foot_geoms, self.foot_rows):
            if not rows:
                raise ValueError(f"{spec.name}: foot geom {fg!r} has no contact rows")

        self.base_body = m.body_index(spec.base_body_name)
        # original MJCF frames for the mean-parts xyz (reference `parts`)
        self.part_frames = tuple(
            (host, np.asarray(pos), np.asarray(quat))
            for name, (host, pos, quat) in m.frames.items()
            if host >= 0 and name not in spec.exclude_parts
        )
        self.initial_z = self._initial_z()
        self.walk_target = (1e3, 0.0)

    # ------------------------------------------------------------------
    def _initial_z(self) -> float:
        m = self.model
        q = [torch.tensor(float(x), dtype=torch.float32) for x in m.qpos0]
        v = [torch.tensor(0.0, dtype=torch.float32)] * m.nv
        fk = dyn.forward_kinematics(m, q, v, with_inertia=False)
        return float(fk.com[self.base_body][2])

    def initial_state_scalar(self, seed, env_id, epoch):
        m = self.model
        like = torch.zeros(seed.shape, dtype=torch.float32, device=seed.device)
        q = [torch.full_like(like, float(x)) for x in m.qpos0]
        for i, qa in enumerate(self.act_qadr):
            u = rand.uniform(seed, i, env_id, epoch, -0.1, 0.1)
            q[qa] = float(m.qpos0[qa]) + u
        v = [torch.zeros_like(like) for _ in range(m.nv)]
        tx = torch.full_like(like, self.walk_target[0])
        ty = torch.full_like(like, self.walk_target[1])
        aux = {
            # exact reset potential (reference: reset() ends with
            # calc_potential() [ref: env_bases.py · BaseBulletEnv.reset])
            "potential": self._potential(q, v, tx, ty),
            "initial_z": torch.full_like(like, self.initial_z),
            "target_x": tx,
            "target_y": ty,
        }
        return q, v, aux

    def _potential(self, q, v, tx, ty):
        fk = dyn.forward_kinematics(self.model, q, v, with_inertia=False)
        bx, by = self._mean_parts_xy(fk)
        dx, dy = tx - bx, ty - by
        dist = torch.sqrt(dx * dx + dy * dy)
        return -dist / self.physics.control_dt

    def _mean_parts_xy(self, fk):
        xs, ys = [], []
        for host, pos, quat in self.part_frames:
            p = sm.v3_add(fk.p[host], sm.m3_vec(fk.R[host], tuple(float(x) for x in pos)))
            xs.append(p[0])
            ys.append(p[1])
        return sum(xs) / len(xs), sum(ys) / len(ys)

    def action_tau_scalar(self, a):
        tau = [0.0] * self.model.nv
        for i, d in enumerate(self.act_dofs):
            tau[int(d)] = float(self.gains[i, 0]) * a[i]
        return tau

    # ------------------------------------------------------------------
    def output_scalar(self, q, v, depths, a, aux, ids=None):
        m = self.model
        fk = dyn.forward_kinematics(m, q, v, with_inertia=False)
        like = q[0]

        # ---- joint observations [ref: Joint.current_relative_position] --
        rel, jspeed = [], []
        for i in range(self.act_dim):
            rel.append(
                (q[int(self.act_qadr[i])] - float(self.j_mid[i, 0]))
                / float(self.j_halfrange[i, 0])
            )
            jspeed.append(0.1 * v[int(self.act_dofs[i])])
        joints_at_limit = sum(
            (torch.abs(r) > 0.99).to(torch.float32) for r in rel
        )

        # ---- base pose & velocity ------------------------------------
        Rb = fk.R[self.base_body]
        com = fk.com[self.base_body]
        roll = sm.atan2(Rb[7], Rb[8])
        pitch = sm.atan2(-Rb[6], torch.sqrt(Rb[7] * Rb[7] + Rb[8] * Rb[8]))
        yaw = sm.atan2(Rb[3], Rb[0])
        ang, lin_o = fk.vel[self.base_body]
        vel = sm.v3_add(lin_o, sm.v3_cross(ang, com))      # base COM velocity

        # mean of part xyz (reference body_xyz; z comes from the base)
        bx, by = self._mean_parts_xy(fk)
        bz = com[2]

        tx, ty = aux["target_x"], aux["target_y"]
        dx, dy = tx - bx, ty - by
        angle_to_target = sm.atan2(dy, dx) - yaw
        dist = torch.sqrt(dx * dx + dy * dy)

        cy, sy = torch.cos(-yaw), torch.sin(-yaw)
        vx = cy * vel[0] - sy * vel[1]
        vy = sy * vel[0] + cy * vel[1]
        vz = vel[2]

        # ---- feet contact flags (getContactPoints replacement) --------
        feet = []
        for rows in self.foot_rows:
            flag = (depths[rows[0]] > 0.0)
            for r in rows[1:]:
                flag = flag | (depths[r] > 0.0)
            feet.append(flag.to(torch.float32))

        more = [
            bz - aux["initial_z"],
            torch.sin(angle_to_target),
            torch.cos(angle_to_target),
            0.3 * vx,
            0.3 * vy,
            0.3 * vz,
            roll,
            pitch,
        ]
        jobs = []
        for r, s in zip(rel, jspeed):
            jobs += [r, s]
        obs = [torch.clamp(x, -5.0, 5.0) for x in (more + jobs + feet)]

        # ---- rewards [ref: walker_base_env.py · step] ------------------
        alive = self._alive(bz, pitch, feet)
        potential = -dist / self.physics.control_dt
        progress = potential - aux["potential"]
        n = float(self.act_dim)
        stall_scale = (
            self.spec.cost_scale if self.spec.stall_scale is None
            else self.spec.stall_scale
        )
        electricity = (
            self.spec.cost_scale * self.electricity_cost
            * sum(torch.abs(ai * si) for ai, si in zip(a, jspeed)) / n
            + stall_scale * self.stall_torque_cost
            * sum(ai * ai for ai in a) / n
        )
        limit_cost = self.joints_at_limit_cost * joints_at_limit
        feet_collision = torch.zeros_like(alive)  # stadium ground only
        reward = alive + progress + electricity + limit_cost + feet_collision
        terminated = alive < 0

        new_aux = dict(aux)
        new_aux["potential"] = potential
        new_aux["target_x"] = tx
        new_aux["target_y"] = ty
        comps = {
            "alive": alive,
            "progress": progress,
            "electricity": electricity,
            "joints_at_limit": limit_cost,
            "feet_collision": feet_collision,
        }
        return obs, reward, terminated, new_aux, comps

    def _alive(self, z, pitch, feet):
        """alive_bonus(z, pitch) [ref: per-robot classes, SURVEY §2.6]."""
        mode = self.spec.alive_mode
        one = torch.ones_like(z)
        if mode == "hopper":  # Hopper & Walker2D
            ok = (z > 0.8) & (torch.abs(pitch) < 1.0)
            return torch.where(ok, one, -one)
        if mode == "cheetah":
            # dead if a shin or thigh (foot_list indices 1,2,4,5) touches
            bad_touch = (feet[1] + feet[2] + feet[4] + feet[5]) > 0.5
            ok = (torch.abs(pitch) < 1.0) & ~bad_touch
            return torch.where(ok, one, -one)
        if mode == "ant":
            return torch.where(z > 0.26, one, -one)
        if mode == "humanoid":
            return torch.where(z > 0.78, 2.0 * one, -one)
        raise ValueError(mode)


def _qadr(model: Model, v_adr: int) -> int:
    for b in model.bodies:
        if b.v_adr == v_adr:
            return b.q_adr
    raise ValueError(v_adr)


# ---------------------------------------------------------------------------
# roster (SURVEY §2.4/§2.6 constants)
# ---------------------------------------------------------------------------

HOPPER = WalkerSpec(
    name="hopper",
    xml="hopper.xml",
    power=0.75,
    alive_mode="hopper",
    foot_geoms=("foot_geom",),
)

WALKER2D = WalkerSpec(
    name="walker2d",
    xml="walker2d.xml",
    power=0.40,
    alive_mode="hopper",
    foot_geoms=("foot_geom", "foot_left_geom"),
    coef_overrides={"foot_joint": 30.0, "foot_left_joint": 30.0},
)

HALF_CHEETAH = WalkerSpec(
    name="half_cheetah",
    xml="half_cheetah.xml",
    power=0.90,
    alive_mode="cheetah",
    foot_geoms=("ffoot", "fshin", "fthigh", "bfoot", "bshin", "bthigh"),
    coef_overrides={
        "bthigh": 120.0, "bshin": 90.0, "bfoot": 60.0,
        "fthigh": 140.0, "fshin": 60.0, "ffoot": 30.0,
    },
)

ANT = WalkerSpec(
    name="ant",
    xml="ant.xml",
    power=2.5,
    alive_mode="ant",
    foot_geoms=(
        "left_ankle_geom", "right_ankle_geom", "third_ankle_geom", "fourth_ankle_geom"
    ),
)
