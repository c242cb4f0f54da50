"""Locomotion tasks: the Roboschool walker contract (torch port).

Counterpart of the JAX package's `envs/locomotion.py`: WalkerSpec and
WalkerTask (MJCF walkers, and URDF robots on the added stadium floor), the
Hopper, Walker2D, HalfCheetah, Ant, Humanoid and Atlas specs, and the
Flagrun tasks (HumanoidFlagrunTask, HumanoidFlagrunHarderTask):

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
from pybulletgym_tpu_torch.models.schema import Geom, GeomType, Model
from pybulletgym_tpu_torch.ops import dynamics as dyn
from pybulletgym_tpu_torch.ops import rand
from pybulletgym_tpu_torch.ops import smath as sm
from pybulletgym_tpu_torch.ops.contacts import (
    SolverConfig, build_contact_plan, full_self_collision_pairs, plan_row_geoms,
)
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
    # URDF models: spawn height of the root link (loadURDF basePosition)
    root_height: float = 0.0


class WalkerTask(Task):
    electricity_cost = -2.0
    stall_torque_cost = -0.1
    joints_at_limit_cost = -0.1
    foot_collision_cost = -1.0

    def __init__(self, spec: WalkerSpec):
        self.spec = spec
        if spec.xml.endswith(".urdf"):
            from pybulletgym_tpu_torch.models.urdf import load_urdf

            self.model = load_urdf(
                asset_path(spec.xml), root_free=True,
                root_pos=(0.0, 0.0, spec.root_height),
            )
        else:
            self.model = load_mjcf(asset_path(spec.xml))
        # URDF files carry no world geometry; give them the stadium ground
        # the reference loads separately via loadSDF (analytic half-space,
        # friction 0.8 [ref: scene_stadium.py · StadiumScene])
        if not any(
            g.gtype == GeomType.PLANE and g.body == -1
            for g in self.model.geoms
        ):
            floor = Geom(
                "floor", -1, GeomType.PLANE, np.zeros(3), np.zeros(3),
                np.array([1.0, 0.0, 0.0, 0.0]), 0.8, 1, 1,
            )
            self.model = dataclasses.replace(
                self.model, geoms=self.model.geoms + (floor,)
            )
        m = self.model
        sc = spec.self_collision
        if sc and sc[0] == "full":
            # every non-ancestor pair of the robot, then any explicit pairs
            # after the sentinel (FlagrunHarder's cube against the robot);
            # the cube is a separate body in the reference, not in the set
            sc = full_self_collision_pairs(m, exclude_geoms=("cube_geom",)) + tuple(sc[1:])
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
        dist0 = torch.sqrt(dx * dx + dy * dy)
        # flag retargeting hook (identity for plain walkers)
        # [ref: HumanoidFlagrun.calc_state — flag_reposition when
        #  walk_target_dist < 1 or flag_timeout expires]
        tx, ty, aux = self._retarget(bx, by, dist0, aux, ids)
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
        alive, aux = self._alive_aux(bz, pitch, feet, aux)
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

    def _retarget(self, bx, by, dist, aux, ids):
        """Walk-target selection hook; plain walkers keep (1000, 0)."""
        return aux["target_x"], aux["target_y"], aux

    def _alive_aux(self, z, pitch, feet, aux):
        """Alive-bonus hook; stateful variants (FlagrunHarder) override."""
        return self._alive(z, pitch, feet), aux

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

# Humanoid self-collision: the reference loads with URDF_USE_SELF_COLLISION
# | EXCLUDE_ALL_PARENTS [ref: MJCFBasedRobot.reset, self_collision=True];
# the "full" sentinel generates the all-non-ancestor pair set from the
# model at build time (ops.contacts.full_self_collision_pairs: 66 pairs).

HUMANOID = WalkerSpec(
    name="humanoid",
    xml="humanoid.xml",
    power=0.41,
    alive_mode="humanoid",
    foot_geoms=("right_foot", "left_foot"),
    cost_scale=4.25,
    self_collision=("full",),
    coef_overrides={
        "abdomen_z": 100.0, "abdomen_y": 100.0, "abdomen_x": 100.0,
        "right_hip_x": 100.0, "right_hip_z": 100.0, "right_hip_y": 300.0,
        "right_knee": 200.0,
        "left_hip_x": 100.0, "left_hip_z": 100.0, "left_hip_y": 300.0,
        "left_knee": 200.0,
        "right_shoulder1": 75.0, "right_shoulder2": 75.0, "right_elbow": 75.0,
        "left_shoulder1": 75.0, "left_shoulder2": 75.0, "left_elbow": 75.0,
    },
)


# Atlas [ref: SURVEY §2.4 row AtlasPyBulletEnv-v0 — URDF robot, 1000
# steps]. The asset is an authored stand-in (tools/gen_atlas_urdf.py):
# the real atlas_v4 URDF is absent offline. Deviations (PARITY.md):
# power=1.0 with gear = URDF <limit effort> (torque saturates at the
# joint's rated effort), humanoid-style alive bonus on the pelvis.
ATLAS = WalkerSpec(
    name="atlas",
    xml="atlas.urdf",
    power=1.0,
    alive_mode="humanoid",
    foot_geoms=("r_foot_box", "l_foot_box"),
    cost_scale=4.25,
    base_body_name="pelvis",
    root_height=0.95,
)


# ---------------------------------------------------------------------------
# Flagrun family [ref: …/robots/locomotors/humanoid_flagrun.py ·
# HumanoidFlagrun / HumanoidFlagrunHarder]
# ---------------------------------------------------------------------------

# Roboschool stadium extents: halflen 105/4, halfwidth 50/4, compacted x0.5
# [ref: scene_stadium.py · StadiumScene + HumanoidFlagrun.flag_reposition
#  (more_compact = 0.5)].
FLAG_X = 0.5 * 105.0 / 4.0
FLAG_Y = 0.5 * 50.0 / 4.0
FLAG_TIMEOUT = 600.0 / 4.0   # 600 frames / frame_skip [ref: flag_reposition]
FLAG_STREAM = 101            # rand stream ids disjoint from joint resets


class HumanoidFlagrunTask(WalkerTask):
    """Humanoid chasing repositioned flags. The walk target re-randomizes
    when reached (dist < 1) or when the flag timer expires
    [ref: HumanoidFlagrun.calc_state/flag_reposition]."""

    def __init__(self, spec: Optional[WalkerSpec] = None):
        super().__init__(spec if spec is not None else HUMANOID_FLAGRUN)

    def _draw_flag(self, ids, count):
        seed, env_id, epoch = ids
        # unique counter per (episode, flag index): hash-combine epoch/count
        e2 = rand.hash_epoch(epoch, count)
        tx = rand.uniform(seed, FLAG_STREAM, env_id, e2, -FLAG_X, FLAG_X)
        ty = rand.uniform(seed, FLAG_STREAM + 1, env_id, e2, -FLAG_Y, FLAG_Y)
        return tx, ty

    def initial_state_scalar(self, seed, env_id, epoch):
        q, v, aux = super().initial_state_scalar(seed, env_id, epoch)
        count = torch.zeros_like(aux["target_x"])
        tx, ty = self._draw_flag((seed, env_id, epoch), count)
        aux["target_x"], aux["target_y"] = tx, ty
        aux["flag_timeout"] = torch.full_like(tx, FLAG_TIMEOUT)
        aux["flag_count"] = count
        # reset potential against the drawn flag (reference reset() ends
        # with calc_potential [ref: env_bases.py · BaseBulletEnv.reset])
        aux["potential"] = self._potential(q, v, tx, ty)
        return q, v, aux

    def _retarget(self, bx, by, dist, aux, ids):
        timeout = aux["flag_timeout"] - 1.0
        need = (dist < 1.0) | (timeout <= 0.0)
        count = aux["flag_count"]
        ntx, nty = self._draw_flag(ids, count + 1.0)
        tx = torch.where(need, ntx, aux["target_x"])
        ty = torch.where(need, nty, aux["target_y"])
        aux = dict(aux)
        aux["flag_timeout"] = torch.where(need, FLAG_TIMEOUT, timeout)
        aux["flag_count"] = torch.where(need, count + 1.0, count)
        return tx, ty, aux


class HumanoidFlagrunHarderTask(HumanoidFlagrunTask):
    """Flagrun + adversity [ref: HumanoidFlagrunHarder]: electricity cost
    quartered (crawling allowed), an aggressive cube hurled at the torso
    every 30 frames, and a get-up state machine replacing the alive bonus:
    potential_leak = 2 * clip(z, 0, 0.8)/0.8 while fewer than 170
    consecutive low-z frames, else -1."""

    GROUND_LIMIT = 170.0
    CUBE_PERIOD = 30
    CUBE_MIN_FRAME = 100
    LIE_STREAMS = (120, 121)           # lying?, which side
    CUBE_STREAMS = (110, 111, 112, 113, 114)  # angle, speed, jitter x/y/z
    CUBE_FROM_DIST = 4.0

    def __init__(self):
        super().__init__(HUMANOID_FLAGRUN_HARDER)
        m = self.model
        self.cube_body = m.body_index("aggressive_cube")
        self.cube_qadr = m.bodies[self.cube_body].q_adr
        self.cube_vadr = m.bodies[self.cube_body].v_adr

    def initial_state_scalar(self, seed, env_id, epoch):
        q, v, aux = super().initial_state_scalar(seed, env_id, epoch)
        like = aux["target_x"]
        aux["ground_counter"] = torch.zeros_like(like)
        aux["frame"] = torch.zeros_like(like)
        # reference pins initial_z to 0.8 [ref: FlagrunHarder
        # robot_specific_reset — self.initial_z = 0.8]
        aux["initial_z"] = torch.full_like(like, 0.8)

        # half the episodes start lying down and must get up
        # [ref: HumanoidFlagrunHarder — random on-ground initial pose]:
        # root pitched ±90° about y at z = 0.3
        lying = rand.uniform(seed, self.LIE_STREAMS[0], env_id, epoch) < 0.5
        sign = torch.where(
            rand.uniform(seed, self.LIE_STREAMS[1], env_id, epoch) < 0.5, 1.0, -1.0
        )
        c = float(np.cos(np.pi / 4.0))
        root = self.model.bodies[self.base_body].q_adr
        q = list(q)
        q[root + 2] = torch.where(lying, 0.3, q[root + 2])          # z
        q[root + 3] = torch.where(lying, c, q[root + 3])            # w
        q[root + 5] = torch.where(lying, sign * c, q[root + 5])     # qy
        return q, v, aux

    def pre_physics_scalar(self, q, v, aux, ids=None):
        """Hurl the cube at the torso every CUBE_PERIOD frames while the
        robot is standing [ref: HumanoidFlagrunHarder.alive_bonus —
        aggressive_cube.reset_position/reset_velocity]."""
        frame = aux["frame"]
        period_hit = (frame % float(self.CUBE_PERIOD)) == 0.0
        throw = period_hit & (frame > float(self.CUBE_MIN_FRAME)) & (
            aux["ground_counter"] == 0.0
        )

        seed, env_id, epoch = ids
        e2 = rand.hash_epoch(epoch, frame)
        s_angle, s_speed, s_jx, s_jy, s_jz = self.CUBE_STREAMS
        angle = rand.uniform(seed, s_angle, env_id, e2, -3.14, 3.14)
        speed = rand.uniform(seed, s_speed, env_id, e2, 20.0, 30.0)
        from_dist = self.CUBE_FROM_DIST

        # torso position ~ root free-joint translation (q[0:3]), led by the
        # robot's current velocity over the cube's travel time [ref:
        # HumanoidFlagrunHarder — target_xyz += robot_speed*time_to_travel].
        # Root free-joint dofs are [ang_body(3), lin_body(3)]; rotate the
        # body-frame linear velocity into world by the root quaternion.
        root_quat = (q[3], q[4], q[5], q[6])
        vel_world = sm.quat_rotate(root_quat, (v[3], v[4], v[5]))
        lead = from_dist / speed
        txyz = (
            q[0] + vel_world[0] * lead,
            q[1] + vel_world[1] * lead,
            q[2] + vel_world[2] * lead,
        )
        px = txyz[0] + from_dist * torch.cos(angle)
        py = txyz[1] + from_dist * torch.sin(angle)
        pz = txyz[2] + 1.0
        dvec = (txyz[0] - px, txyz[1] - py, txyz[2] - pz)
        dn = torch.sqrt(dvec[0] * dvec[0] + dvec[1] * dvec[1] + dvec[2] * dvec[2]) + 1e-9
        jx = rand.uniform(seed, s_jx, env_id, e2, -1.0, 1.0)
        jy = rand.uniform(seed, s_jy, env_id, e2, -1.0, 1.0)
        jz = rand.uniform(seed, s_jz, env_id, e2, -1.0, 1.0)
        vx = speed * dvec[0] / dn + jx
        vy = speed * dvec[1] / dn + jy
        vz = speed * dvec[2] / dn + jz

        q = list(q)
        v = list(v)
        qa, va = self.cube_qadr, self.cube_vadr
        one = torch.ones_like(px)
        new_q = (px, py, pz, one, 0.0 * one, 0.0 * one, 0.0 * one)
        for i, val in enumerate(new_q):
            q[qa + i] = torch.where(throw, val, q[qa + i])
        # cube free-joint dofs: [ang_body(3), lin_body(3)]; identity
        # orientation at throw time => body frame == world frame
        new_v = (0.0 * one, 0.0 * one, 0.0 * one, vx, vy, vz)
        for i, val in enumerate(new_v):
            v[va + i] = torch.where(throw, val, v[va + i])
        return q, v, aux

    def _alive_aux(self, z, pitch, feet, aux):
        """Get-up state machine [ref: HumanoidFlagrunHarder.alive_bonus]:
        count consecutive low-z frames (decay when recovered); alive =
        potential_leak while the counter is under GROUND_LIMIT, else -1."""
        counter = aux["ground_counter"]
        counter = torch.where(
            z < 0.8, counter + 1.0, torch.clamp_min(counter - 1.0, 0.0)
        )
        leak = 2.0 * torch.clamp(z, 0.0, 0.8) / 0.8
        alive = torch.where(counter < self.GROUND_LIMIT, leak, -torch.ones_like(z))
        aux = dict(aux)
        aux["ground_counter"] = counter
        aux["frame"] = aux["frame"] + 1.0
        return alive, aux


HUMANOID_FLAGRUN = dataclasses.replace(HUMANOID, name="humanoid_flagrun")

# cube <-> robot contact pairs: the hurled cube must actually knock the
# robot [ref: HumanoidFlagrunHarder — aggressive_cube]. The reference cube
# is a small Bullet box; here a sphere proxy (r=0.06) against the torso,
# head, and limbs (documented deviation).
_CUBE_PAIRS = tuple(
    ("cube_geom", g) for g in (
        "torso1", "head", "uwaist", "lwaist", "butt",
        "right_thigh1", "left_thigh1", "right_uarm1", "left_uarm1",
    )
)

HUMANOID_FLAGRUN_HARDER = dataclasses.replace(
    HUMANOID,
    name="humanoid_flagrun_harder",
    xml="humanoid_cube.xml",
    cost_scale=4.25 / 4.0,   # electricity quartered [ref: FlagrunHarder]
    stall_scale=4.25,        # stall torque stays at full humanoid scale
    exclude_parts=("aggressive_cube",),
    self_collision=("full",) + _CUBE_PAIRS,
)
