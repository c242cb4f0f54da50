"""Models over the default tables' caps: the large class of the kernels'
tables (engine_core.h, -DENG_BIG_TABLES), on a scene of two Humanoids in
one worldbody (36 bodies, nq 48, nv 46, 34 actuators, 58 floor rows, 68
limit rows) and on seven free balls (nv 42). Held against the JAX package
and the plain version, at small sizes (eager JAX costs ~7 s a substep of
the scene on a CPU):

(a) the scene's `Model` equals the JAX package's, field by field;
(b) one `make_physics_step_plain` substep at B=4 against one eager JAX
    `make_substep_scalar` substep, the feet in the floor;
(c) `env_step_plain` of `TwoHumanoidTask` (a user's task over the scene,
    written once for each package) against the eager JAX kernel body at
    frame_skip 0 (a forced reset: q, epoch and step count bitwise) and 1;
(d) the large class's host twins (`HostTwin.physics_step`, `HostTaskTwin`:
    the kernels' own C++ built with g++ and -DENG_BIG_TABLES, the substep
    over the dof tree's root paths) against the plain step at B=8 for 3
    steps of one substep, resets bitwise; the scratch by root paths against
    its dense sizes;
(e) the seven balls through the large physics twin against plain;
(f) the size class of every shipped ID is the default (its tables 26,096
    bytes), that of the scene and the balls the large one, and eleven balls
    (nv 66) go on to the huge one (tests/test_torch_huge_models.py);
(g) the scene registered by ID runs through `make_batched(device="cpu")`
    with both backends, and its state through `utils.interop` both ways.

Bounds: the JAX package's humanoid-family budget
(tests/test_pallas_equivalence.py:80-86): median |dq| < 1.5e-3, mean
< 5e-3, max < 8e-2; the walkers' mean < 1e-5 where it holds.
"""

import copy
import ctypes
import dataclasses
import xml.etree.ElementTree as ET

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybulletgym_tpu_torch as pt
from pybulletgym_tpu.envs import base as base_j
from pybulletgym_tpu.models import mjcf as mjcf_j
from pybulletgym_tpu.ops import contacts as ct_j
from pybulletgym_tpu.ops import rand as rand_j
from pybulletgym_tpu.ops import step as step_j
from pybulletgym_tpu_torch.api.registry import registry
from pybulletgym_tpu_torch.envs import base as base_t
from pybulletgym_tpu_torch.envs.base import env_step_plain, reset_fn
from pybulletgym_tpu_torch.models import mjcf as mjcf_t
from pybulletgym_tpu_torch.models.assets import asset_path
from pybulletgym_tpu_torch.ops import contacts as ct_t
from pybulletgym_tpu_torch.ops import cuda_engine as ce
from pybulletgym_tpu_torch.ops import dynamics as dyn_t
from pybulletgym_tpu_torch.ops import rand as rand_t
from pybulletgym_tpu_torch.ops import step as step_t
from pybulletgym_tpu_torch.ops import task_kernel as tk
from pybulletgym_tpu_torch.utils.interop import env_state_from_numpy, env_state_to_numpy
from test_torch_engine import _jax_kernel_body
from test_torch_humanoid import _q_bounds
from test_torch_models import _same

SCENE_ID = "TwoHumanoids-v0"


def humanoids_xml(n: int = 2) -> str:
    """n copies of the repository's humanoid.xml in one worldbody: copy k's
    (k >= 2) body, joint, geom and actuator names prefixed with "h{k}_", its
    torso 1.5 (k - 1) m along y."""
    root = ET.parse(asset_path("humanoid.xml")).getroot()
    world, motors = root.find("worldbody"), root.find("actuator")
    body, motor_list = world.find("body"), list(motors)
    for k in range(2, n + 1):
        torso = copy.deepcopy(body)
        for el in torso.iter():
            if "name" in el.attrib:
                el.set("name", f"h{k}_" + el.get("name"))
        torso.set("pos", f"0 {1.5 * (k - 1)} 1.4")
        world.append(torso)
        for m in motor_list:
            m2 = copy.deepcopy(m)
            m2.set("name", f"h{k}_" + m.get("name"))
            m2.set("joint", f"h{k}_" + m.get("joint"))
            motors.append(m2)
    return ET.tostring(root, encoding="unicode")


def two_humanoids_xml() -> str:
    return humanoids_xml(2)


def humanoids_task(pkg, xp, n: int = 2):
    """The task over `humanoids_xml(n)` for the package `pkg` (a namespace
    of its Task, parse_mjcf, rand, PhysicsConfig and SolverConfig), with
    `xp` its array namespace. Reset: qpos0 plus U(±0.01) on every q (stream
    j) and U(±0.01) on every v (stream nq + d); torque: each actuator's gear
    times the clipped action; obs: every humanoid's q less each root's x and
    y, and 0.1 v; reward: the torsos' world x-velocities plus 1 alive each;
    done: any torso below z 0.8."""

    class TwoHumanoidTask(pkg.Task):
        NOISE = 0.01

        def __init__(self, xml: str):
            self.model = m = pkg.parse_mjcf(xml, "two_humanoids" if n == 2 else f"humanoids{n}")
            self.physics = pkg.PhysicsConfig(solver=pkg.SolverConfig())
            self.act_dofs = [a.v_adr for a in m.actuators]
            self.gears = [float(a.gear) for a in m.actuators]
            names = ["torso"] + [f"h{k}_torso" for k in range(2, n + 1)]
            roots = [m.bodies[m.body_index(name)] for name in names]
            self.root_q = [b.q_adr for b in roots]
            self.root_v = [b.v_adr for b in roots]
            drop = {r + k for r in self.root_q for k in (0, 1)}
            self.obs_q = [j for j in range(m.nq) if j not in drop]
            self.obs_dim = len(self.obs_q) + m.nv
            self.act_dim = len(self.act_dofs)
            self.max_episode_steps = 1000

        def initial_state_scalar(self, seed, env_id, epoch):
            m, n = self.model, self.NOISE
            q = [float(m.qpos0[j]) + pkg.rand.uniform(seed, j, env_id, epoch, -n, n)
                 for j in range(m.nq)]
            v = [pkg.rand.uniform(seed, m.nq + d, env_id, epoch, -n, n) for d in range(m.nv)]
            return q, v, {}

        def action_tau_scalar(self, a):
            tau = [0.0] * self.model.nv
            for d, g, ai in zip(self.act_dofs, self.gears, a):
                tau[d] = g * ai
            return tau

        def _vx(self, q, v, r, d):
            """The torso's world x-velocity: the first row of its rotation
            times the free joint's body-frame linear velocity."""
            w, x, y, z = q[r + 3], q[r + 4], q[r + 5], q[r + 6]
            return ((1.0 - 2.0 * (y * y + z * z)) * v[d + 3] + 2.0 * (x * y - w * z) * v[d + 4]
                    + 2.0 * (x * z + w * y) * v[d + 5])

        def output_scalar(self, q, v, depths, a, aux, ids=None):
            obs = [q[j] for j in self.obs_q] + [0.1 * x for x in v]
            progress = sum(self._vx(q, v, r, d) for r, d in zip(self.root_q, self.root_v))
            alive = xp.full_like(q[0], float(n))
            fallen = q[self.root_q[0] + 2] < 0.8
            for r in self.root_q[1:]:
                fallen = fallen | (q[r + 2] < 0.8)
            return obs, progress + float(n), fallen, dict(aux), {"alive": alive, "progress": progress}

    if n != 2:
        TwoHumanoidTask.__name__ = TwoHumanoidTask.__qualname__ = f"Humanoids{n}Task"
    return TwoHumanoidTask


_PKG_J = type("pkg", (), dict(
    Task=base_j.Task, parse_mjcf=staticmethod(mjcf_j.parse_mjcf), rand=rand_j,
    PhysicsConfig=step_j.PhysicsConfig, SolverConfig=ct_j.SolverConfig))
_PKG_T = type("pkg", (), dict(
    Task=base_t.Task, parse_mjcf=staticmethod(mjcf_t.parse_mjcf), rand=rand_t,
    PhysicsConfig=step_t.PhysicsConfig, SolverConfig=ct_t.SolverConfig))
TwoHumanoidJ, TwoHumanoidT = humanoids_task(_PKG_J, jnp), humanoids_task(_PKG_T, torch)


def balls_xml(n: int, z: float = 1.0) -> str:
    """n free spheres of radius 0.1 above a floor plane (6n dofs)."""
    balls = "".join(
        f'<body name="b{i}" pos="{0.3 * i} 0 {z}"><joint name="j{i}" type="free"/>'
        f'<geom name="g{i}" type="sphere" size="0.1"/></body>' for i in range(n))
    return ('<mujoco model="balls"><worldbody><geom name="floor" type="plane" '
            f'size="10 10 0.1"/>{balls}</worldbody></mujoco>')


@pytest.fixture(scope="module")
def scene():
    xml = two_humanoids_xml()
    return TwoHumanoidJ(xml), TwoHumanoidT(xml)


def _ids(B, seed=3):
    return (torch.full((B,), seed, dtype=torch.uint32), torch.arange(B, dtype=torch.int32),
            torch.zeros(B, dtype=torch.uint32))


def _feet_down(task, s, depth=0.01):
    """The state `s` with both torsos lowered so that the deepest floor row
    of each env lies `depth` into the floor."""
    plan = ct_t.build_contact_plan(task.model, task.physics.solver)
    fk = dyn_t.forward_kinematics(task.model, list(s.q), list(s.v), with_inertia=False)
    d = torch.stack(list(ct_t.narrowphase_scalar(task.model, fk, plan).depth))
    q = s.q.clone()
    for r in task.root_q:
        q[r + 2] -= depth - d.max(0).values
    return s._replace(q=q)


def _torques(task, B, seed):
    a = np.random.default_rng(seed).uniform(-1, 1, (task.act_dim, B)).astype(np.float32)
    tau = np.zeros((task.model.nv, B), np.float32)
    tau[task.act_dofs] = np.asarray(task.gears, np.float32)[:, None] * a
    return a, tau


def test_scene_model_equals_jax(scene):
    """(a)"""
    tj, tt = scene
    _same(tj.model, tt.model, "model")
    m = tt.model
    floor, pairs = ct_t.build_contact_plan(m, tt.physics.solver)
    assert (len(m.bodies), m.nq, m.nv, len(m.actuators)) == (36, 48, 46, 34)
    assert (len(floor), len(pairs), int(ct_t.build_limit_plan(m).dof.shape[0])) == (58, 0, 68)
    _same(ct_j.build_contact_plan(tj.model, tj.physics.solver), (floor, pairs), "contact plan")


def test_physics_step_plain_matches_jax(scene):
    """(b) one substep from a reset with the feet 1 cm into the floor"""
    tj, tt = scene
    B = 4
    s = _feet_down(tt, reset_fn(tt, *_ids(B)))
    _, tau = _torques(tt, B, 9)
    substep, _, n_rows = step_j.make_substep_scalar(tj.model, tj.physics)
    qj, vj, dj = substep([jnp.asarray(r) for r in s.q.numpy()],
                         [jnp.asarray(r) for r in s.v.numpy()], [jnp.asarray(r) for r in tau])
    cfg1 = dataclasses.replace(tt.physics, frame_skip=1)
    q2, v2, d2 = step_t.make_physics_step_plain(tt.model, cfg1)[0](s.q, s.v,
                                                                   torch.from_numpy(tau))
    assert n_rows == 58 and d2.shape == (58, B) and (d2 > 0).any(0).all()
    _q_bounds(np.abs(np.stack([np.asarray(x) for x in qj]) - q2.numpy()), 1e-5)
    assert np.abs(np.stack([np.asarray(x) for x in dj]) - d2.numpy()).max() < 1e-5
    dv = np.abs(np.stack([np.asarray(x) for x in vj]) - v2.numpy())
    assert np.median(dv) < 1.5e-3, np.median(dv)


def test_env_step_plain_matches_jax_kernel_body(scene):
    """(c) frame_skip 0 with envs 0 and 2 forced to reset, then 1"""
    tj, tt = scene
    B = 4
    s = reset_fn(tt, *_ids(B))
    forced = torch.tensor([True, False, True, False])
    s = s._replace(terminated=forced, step_count=torch.full((B,), 7, dtype=torch.int32))
    a, _ = _torques(tt, B, 4)
    for fs in (0, 1):
        jx = _jax_kernel_body(tj, env_state_to_numpy(s), a, fs)
        pt_ = env_state_to_numpy(env_step_plain(tt, s, torch.from_numpy(a), fs))
        if fs == 0:
            np.testing.assert_array_equal(jx["q"], pt_["q"])
            np.testing.assert_array_equal(jx["v"], pt_["v"])
        else:
            _q_bounds(np.abs(jx["q"] - pt_["q"]), 1e-5)
        for k in ("epoch", "step_count", "terminated", "truncated"):
            np.testing.assert_array_equal(jx[k], pt_[k], err_msg=k)
        np.testing.assert_allclose(jx["obs"], pt_["obs"], atol=1e-5)
        np.testing.assert_allclose(jx["reward"], pt_["reward"], atol=1e-4)
        s = env_state_from_numpy(pt_, device="cpu")._replace(env_id=s.env_id, seed=s.seed)


def _rollout(step, s, acts, forced_at=1):
    """3 steps of `step`, envs 0 and 5 forced to reset before step
    `forced_at`; returns the states after each step."""
    out = []
    for t, a in enumerate(acts):
        if t == forced_at:
            f = torch.zeros_like(s.terminated)
            f[[0, 5]] = True
            s = s._replace(terminated=s.terminated | f)
        s = step(s, a)
        out.append(s)
    return out


def test_large_twins_match_plain(scene):
    """(d) B=8, 3 steps of one substep"""
    _, tt = scene
    B = 8
    s0 = _feet_down(tt, reset_fn(tt, *_ids(B, 5)), 0.005)
    acts = [torch.from_numpy(_torques(tt, B, 20 + t)[0]) for t in range(3)]
    plain = _rollout(lambda s, a: env_step_plain(tt, s, a, 1), s0, acts)
    twin = tk.HostTaskTwin(tt, frame_skip=1)
    assert ce.tables_class(twin.tables) == ce.LARGE and twin.tables.caps_id == ce.CAPS_BIG
    assert (twin.tables.lanes, twin.tables.nv, twin.tables.nl, twin.tables.nr) == (32, 46, 68, 58)
    got = _rollout(twin, s0, acts)
    for t, (p, h) in enumerate(zip(plain, got)):
        _q_bounds((p.q - h.q).abs().numpy(), 1e-5)
        assert torch.equal(p.epoch, h.epoch) and torch.equal(p.step_count, h.step_count)
        assert (p.obs - h.obs).abs().max() < 1e-2 and (p.reward - h.reward).abs().max() < 1e-2
    reset = copy.copy(twin)  # the same library, its tables at frame_skip 0
    reset.tables = type(twin.tables).from_buffer_copy(twin.tables)
    reset.tables.frame_skip = 0
    forced = plain[0]._replace(terminated=torch.ones(B, dtype=torch.bool))
    pr, hr = env_step_plain(tt, forced, acts[1], 0), reset(forced, acts[1])
    assert torch.equal(pr.q, hr.q) and torch.equal(pr.v, hr.v)  # the reset draws bitwise

    # the physics twin from the plain rollout's states and torques (the
    # task has no pre-physics hook): its envs not reset in the step
    tab = ce.pack_physics(tt.model, dataclasses.replace(tt.physics, frame_skip=1))
    assert ce.tables_class(tab) == ce.LARGE and ctypes.sizeof(tab) == 70104
    # one env's scratch, the whole of it in the device buffer: 20,736 B by
    # root paths, 63,872 B with L and Y dense
    assert 4 * ce.buffer_floats(tab) == 4 * tab.sc_stride == 20736
    assert 4 * ce.dense_stride(tab) == 63872
    hw = ce.HostTwin()
    for t, (s, p) in enumerate(zip([s0] + plain[:2], plain)):
        tau = torch.zeros((tt.model.nv, B))
        tau[tt.act_dofs] = torch.tensor(tt.gears)[:, None] * acts[t].clamp(-1.0, 1.0)
        qh, vh, dh = hw.physics_step(tab, s.q, s.v, tau)
        kept = p.epoch == s.epoch
        assert int(kept.sum()) == (6 if t == 1 else 8)
        _q_bounds((p.q - qh)[:, kept].abs().numpy(), 1e-5)


def test_free_balls_through_the_large_twin(tmp_path):
    """(e) seven free balls (nv 42) dropped onto the floor from 9 cm, under
    their radius: every ball touches"""
    model = mjcf_t.parse_mjcf(balls_xml(7, 0.09), "balls")
    cfg = step_t.PhysicsConfig()
    tab = ce.pack_physics(model, cfg)
    assert model.nv == 42 and ce.tables_class(tab) == ce.LARGE and tab.lanes == 32
    B = 8
    rng = np.random.default_rng(2)
    q = torch.from_numpy(np.repeat(model.qpos0[:, None], B, 1).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-0.5, 0.5, (model.nv, B)).astype(np.float32))
    plain = step_t.make_physics_step_plain(model, cfg)[0]
    hw = ce.HostTwin()
    for _ in range(3):
        tau = torch.from_numpy(rng.uniform(-1, 1, (model.nv, B)).astype(np.float32))
        qp, vp, dp = plain(q, v, tau)
        qh, vh, dh = hw.physics_step(tab, q, v, tau)
        dq = (qp - qh).abs()
        assert dq.mean() < 1e-5 and dq.max() < 1e-2, (dq.mean(), dq.max())
        assert (dp - dh).abs().max() < 1e-5
        q, v = qp, vp
    assert (dp > -0.02).all()


def test_size_classes():
    """(f)"""
    Tables, caps = ce.tables_type()
    BigTables, big = ce.tables_type(True)
    # the default class's tables: 26,096 B of fields, and 4,088 B of its root
    # paths and limit steps (engine_core.h · ENG_PATH_FIELDS); the large
    # class's: 52,688 B of the default class's fields at its caps, 7,944 B
    # of the root paths and 9,472 B of the sweep's windows (ENG_WIN_FIELDS)
    assert ctypes.sizeof(Tables) == 30184 and ctypes.sizeof(BigTables) == 70104
    assert {k: big["MAX_" + k] for k in ("BODIES", "NV", "NQ", "ROWS", "PAIRS", "LIMITS",
                                         "ACT")} == dict(BODIES=64, NV=64, NQ=80, ROWS=256,
                                                         PAIRS=128, LIMITS=128, ACT=64)
    shipped = [k for k in registry if k.endswith(("PyBulletEnv-v0", "MuJoCoEnv-v0"))]
    assert len(shipped) == 26
    for env_id in shipped:
        task = pt.make_task(env_id)
        assert ce.caps_class(task.model, task.physics, task.act_dim) in (0, 1), env_id
        t = ce.pack_physics(task.model, task.physics, act=task.act_dim)
        assert type(t) is Tables and ce.tables_class(t) == ce.DEFAULT, env_id
    scene = mjcf_t.parse_mjcf(two_humanoids_xml(), "two_humanoids")
    balls = mjcf_t.parse_mjcf(balls_xml(7), "balls")
    cfg = step_t.PhysicsConfig()
    assert ce._pick_caps(36, 48, 46, 58, 0, 68, 34) == ce.CAPS_BIG
    for m in (scene, balls):
        t = ce.pack_physics(m, cfg)
        assert type(t) is BigTables and t.caps_id == ce.CAPS_BIG and t.lanes == 32
        assert t.nv <= ce.lane_nv(32, True) == 64 and ce.lane_nv(32) == 40
    # eleven balls (nv 66) pass the large caps: the huge class takes them
    t = ce.pack_physics(mjcf_t.parse_mjcf(balls_xml(11), "balls"), cfg)
    assert ce.tables_class(t) == ce.HUGE and t.caps_id == ce.CAPS_HUGE and t.nv == 66 > big["MAX_NV"]


def test_scene_by_id_with_both_backends(scene):
    """(g)"""
    xml = two_humanoids_xml()

    def factory():  # one substep a step, to keep the plain version's CPU time down
        task = TwoHumanoidT(xml)
        task.physics = dataclasses.replace(task.physics, frame_skip=1)
        return task

    pt.register(SCENE_ID, factory, 1000)
    B = 2
    envs = {b: pt.make_batched(SCENE_ID, B, device="cpu", backend=b)
            for b in ("fused", "composed")}
    assert envs["fused"].step_fn.kernel == "task_step_kernel_large"
    assert envs["fused"].step_fn.size == ce.LARGE and envs["composed"].backend == "composed"
    a = np.random.default_rng(1).uniform(-1, 1, (B, 34)).astype(np.float32)
    out = {b: e.step(e.reset(seed=2), a) for b, e in envs.items()}
    for k in ("q", "v", "obs", "reward", "terminated", "epoch"):
        assert torch.equal(getattr(out["fused"], k), getattr(out["composed"], k)), k
    assert out["fused"].obs.shape == (44 + 46, B) and torch.isfinite(out["fused"].q).all()
    back = env_state_from_numpy(env_state_to_numpy(out["fused"]), device="cpu")
    for k in ("q", "v", "obs", "reward", "terminated", "truncated", "step_count", "epoch"):
        assert torch.equal(getattr(back, k), getattr(out["fused"], k)), k
    assert sorted(back.rewards) == ["alive", "progress"] and back.aux == {}
