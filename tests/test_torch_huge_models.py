"""Models past the large tables' caps: the huge class of the kernels'
tables (engine_core.h, -DENG_HUGE_TABLES: up to 128 bodies and nv 128, a
four-word root-path mask, the whole scratch in a device buffer), on a scene of four Humanoids in one worldbody (72 bodies, nq 96,
nv 92, 68 actuators, 116 floor rows, 136 limit rows; its one-env scratch
233,796 bytes, over a block's 232,448) and on eleven free balls (nv 66, nq
77). Held against the JAX package and the plain version, at small sizes:

(a) the scene's `Model` and contact plan equal the JAX package's, field by
    field;
(b) the eleven balls: one `make_physics_step_plain` substep at B=4 against
    one eager JAX `make_substep_scalar` substep, every ball in the floor;
(c) the huge class's host twins (`HostTwin.physics_step`, `HostTaskTwin`:
    the kernels' own C++ built with g++ and -DENG_HUGE_TABLES, Y in a heap
    buffer of its own) against the plain step at one substep a step: the
    scene at B=2 for 2 steps, the balls at B=8 for 3, resets bitwise; the
    mask words of dofs 64-127 zeroed in a copy of the tables change what
    the twin computes, so the C++ reads them;
(d) size classes: the 26 shipped IDs stay default, the two-Humanoid scene
    and seven balls large; eleven balls, three and four Humanoids huge; a
    model past the huge caps, or whose scratch outside Y passes a block's
    shared memory, takes the sized class (tests/test_torch_sized_models.py);
(e) `FourHumanoids-v0` registered and made by ID with `device="cpu"`, both
    backends, B=2 and one substep: the fused step is
    `task_step_kernel_huge`'s wrapper, and the two backends agree bitwise.

Bounds: the JAX package's humanoid-family budget
(tests/test_pallas_equivalence.py:80-86): median |dq| < 1.5e-3, max < 8e-2,
mean < 5e-3, and the walkers' mean < 1e-5 where it holds; the balls the
walkers' mean < 1e-5 and max < 1e-2 (:38-40).
"""

import copy
import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybulletgym_tpu_torch as pt
from pybulletgym_tpu.models import mjcf as mjcf_j
from pybulletgym_tpu.ops import contacts as ct_j
from pybulletgym_tpu.ops import step as step_j
from pybulletgym_tpu_torch.api.registry import registry
from pybulletgym_tpu_torch.envs.base import env_step_plain, reset_fn
from pybulletgym_tpu_torch.models import mjcf as mjcf_t
from pybulletgym_tpu_torch.ops import contacts as ct_t
from pybulletgym_tpu_torch.ops import cuda_engine as ce
from pybulletgym_tpu_torch.ops import step as step_t
from pybulletgym_tpu_torch.ops import task_kernel as tk
from test_torch_big_models import (_PKG_J, _PKG_T, _feet_down, _ids, _torques, balls_xml,
                                   humanoids_task, humanoids_xml)
from test_torch_humanoid import _q_bounds
from test_torch_models import _same

SCENE_ID = "FourHumanoids-v0"
FourHumanoidJ, FourHumanoidT = humanoids_task(_PKG_J, jnp, 4), humanoids_task(_PKG_T, torch, 4)


@pytest.fixture(scope="module")
def scene():
    xml = humanoids_xml(4)
    return FourHumanoidJ(xml), FourHumanoidT(xml)


def _high_words_zeroed(tab):
    """A copy of huge tables with every body's mask words 2 and 3 (dofs
    64-127) zeroed, and those words of every set the substep reads (each
    dof's ancestors, each row's support, each pair row's body a's path)."""
    probe = type(tab).from_buffer_copy(tab)
    nb = len(probe.anc_mask)
    for i in range(probe.nb):
        probe.anc_mask_hi[nb + i] = probe.anc_mask_hi[2 * nb + i] = 0
    for name in ("dof_anc", "path_u", "pair_pa"):
        arr = getattr(probe, name)
        for j in range(len(arr) // 4):
            arr[4 * j + 2] = arr[4 * j + 3] = 0
    return probe


def test_scene_model_equals_jax(scene):
    """(a)"""
    tj, tt = scene
    _same(tj.model, tt.model, "model")
    m = tt.model
    floor, pairs = ct_t.build_contact_plan(m, tt.physics.solver)
    assert (len(m.bodies), m.nq, m.nv, len(m.actuators)) == (72, 96, 92, 68)
    assert (len(floor), len(pairs), int(ct_t.build_limit_plan(m).dof.shape[0])) == (116, 0, 136)
    _same(ct_j.build_contact_plan(tj.model, tj.physics.solver), (floor, pairs), "contact plan")
    # the fourth humanoid's root path reaches dofs 69-91: words 2 and 3
    t = ce.pack_physics(m, tt.physics)
    foot = m.body_index("h4_left_shin")
    assert {d for d in range(128) if ce.root_path(t, foot) >> d & 1} == \
        set(m.ancestor_dofs[foot]) and min(m.ancestor_dofs[foot]) == 69


def test_balls_physics_step_plain_matches_jax():
    """(b) one substep of eleven balls, each 1 cm in the floor"""
    mj, mt = (mod.parse_mjcf(balls_xml(11, 0.09), "balls") for mod in (mjcf_j, mjcf_t))
    _same(mj, mt, "model")
    assert (mt.nv, mt.nq) == (66, 77)
    B = 4
    rng = np.random.default_rng(6)
    q = np.repeat(mt.qpos0[:, None], B, 1).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (mt.nv, B)).astype(np.float32)
    tau = rng.uniform(-1, 1, (mt.nv, B)).astype(np.float32)
    cfg_j, cfg_t = step_j.PhysicsConfig(frame_skip=1), step_t.PhysicsConfig(frame_skip=1)
    substep, _, n_rows = step_j.make_substep_scalar(mj, cfg_j)
    qj, vj, dj = (np.stack([np.asarray(x) for x in out]) for out in substep(
        [jnp.asarray(r) for r in q], [jnp.asarray(r) for r in v], [jnp.asarray(r) for r in tau]))
    q2, v2, d2 = step_t.make_physics_step_plain(mt, cfg_t)[0](*map(torch.from_numpy, (q, v, tau)))
    assert n_rows == 11 and (d2 > 0).all()
    dq = np.abs(qj - q2.numpy())
    assert dq.mean() < 1e-5 and dq.max() < 1e-2, (dq.mean(), dq.max())
    assert np.abs(dj - d2.numpy()).max() < 1e-5
    assert np.abs(vj - v2.numpy()).mean() < 1e-4


def test_huge_twins_match_plain(scene):
    """(c) the scene: B=2, 2 steps of one substep, env 0 forced to reset
    before the second"""
    _, tt = scene
    B = 2
    s0 = _feet_down(tt, reset_fn(tt, *_ids(B, 5)), 0.005)
    acts = [torch.from_numpy(_torques(tt, B, 30 + t)[0]) for t in range(2)]
    cfg1 = dataclasses.replace(tt.physics, frame_skip=1)

    def forced_rollout(step):
        out, s = [], s0
        for t, a in enumerate(acts):
            if t == 1:
                s = s._replace(terminated=s.terminated | torch.tensor([True, False]))
            s = step(s, a)
            out.append(s)
        return out

    plain = forced_rollout(lambda s, a: env_step_plain(tt, s, a, 1))
    twin = tk.HostTaskTwin(tt, frame_skip=1)
    t = twin.tables
    assert ce.tables_class(t) == ce.HUGE and t.caps_id == ce.CAPS_HUGE
    assert (t.lanes, t.nb, t.nv, t.nr, t.nl, t.act) == (32, 72, 92, 116, 136, 68)
    # the task kernel's scratch at its dense sizes, which choose the class:
    # 233,796 bytes in all, over a block's 232,448 (Y 180,420, the rest
    # 53,380); laid out by root paths, 42,368 (128-byte aligned), all in
    # the device buffer
    shared, y = ce._scratch_sizes(t.nb, t.nq, t.nv, t.nr, t.npair, t.nl, t.act, t.naux,
                                  t.obs_dim)
    assert 4 * (sum(shared.values()) | 1) == 53380 and 4 * y["Y"] == 180420
    assert 53380 + 180420 > ce.MAX_SHARED_BYTES
    assert t.sc_stride * 4 == ce.buffer_floats(t) * 4 == 42368
    for p, h in zip(plain, forced_rollout(twin)):
        _q_bounds((p.q - h.q).abs().numpy(), 1e-5)
        assert torch.equal(p.epoch, h.epoch) and torch.equal(p.step_count, h.step_count)
        assert (p.obs - h.obs).abs().max() < 1e-2 and (p.reward - h.reward).abs().max() < 1e-2
    reset = copy.copy(twin)  # the same library, its tables at frame_skip 0
    reset.tables = type(t).from_buffer_copy(t)
    reset.tables.frame_skip = 0
    forced = plain[0]._replace(terminated=torch.ones(B, dtype=torch.bool))
    pr, hr = env_step_plain(tt, forced, acts[1], 0), reset(forced, acts[1])
    assert torch.equal(pr.q, hr.q) and torch.equal(pr.v, hr.v)  # the reset draws bitwise

    # the physics twin from the plain rollout's first state and torques
    tab = ce.pack_physics(tt.model, cfg1)
    assert ce.tables_class(tab) == ce.HUGE and ctypes.sizeof(tab) == ctypes.sizeof(ce.tables_type(ce.HUGE)[0])
    tau = torch.zeros((tt.model.nv, B))
    tau[tt.act_dofs] = torch.tensor(tt.gears)[:, None] * acts[0].clamp(-1.0, 1.0)
    hw = ce.HostTwin()
    qh, vh, dh = hw.physics_step(tab, s0.q, s0.v, tau)
    _q_bounds((plain[0].q - qh).abs().numpy(), 1e-5)
    # without words 2 and 3 the CRBA and the Jacobians lose dofs 64-91
    _, vx, _ = hw.physics_step(_high_words_zeroed(tab), s0.q, s0.v, tau)
    assert not torch.allclose(vx[69:], vh[69:], atol=1e-3)


def test_balls_through_the_huge_twin():
    """(c) eleven balls (nv 66) dropped onto the floor from 9 cm, under
    their radius: B=8, 3 steps"""
    model = mjcf_t.parse_mjcf(balls_xml(11, 0.09), "balls")
    cfg = step_t.PhysicsConfig()
    tab = ce.pack_physics(model, cfg)
    assert ce.tables_class(tab) == ce.HUGE and tab.lanes == 32 and ce.lane_nv(32, ce.HUGE) == 128
    # the last ball's dofs 60-65 span mask words 1 and 2
    assert ce.root_path(tab, 10) == sum(1 << d for d in range(60, 66))
    B = 8
    rng = np.random.default_rng(2)
    q = torch.from_numpy(np.repeat(model.qpos0[:, None], B, 1).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-0.5, 0.5, (model.nv, B)).astype(np.float32))
    plain = step_t.make_physics_step_plain(model, cfg)[0]
    hw = ce.HostTwin()
    for k in range(3):
        tau = torch.from_numpy(rng.uniform(-1, 1, (model.nv, B)).astype(np.float32))
        qp, vp, dp = plain(q, v, tau)
        qh, vh, dh = hw.physics_step(tab, q, v, tau)
        dq = (qp - qh).abs()
        assert dq.mean() < 1e-5 and dq.max() < 1e-2, (dq.mean(), dq.max())
        assert (dp - dh).abs().max() < 1e-5
        if k == 0:  # without word 2 the last ball's dofs 64, 65 lose their contact
            _, vx, _ = hw.physics_step(_high_words_zeroed(tab), q, v, tau)
            assert not torch.allclose(vx[64:], vh[64:], atol=1e-3)
        q, v = qp, vp
    assert (dp > -0.02).all()


def test_size_classes():
    """(d)"""
    Big, big = ce.tables_type(ce.LARGE)
    Huge, huge = ce.tables_type(ce.HUGE)
    assert ce.tables_type(True)[0] is Big and ctypes.sizeof(Big) == 70104
    assert {k: huge["MAX_" + k] for k in ("BODIES", "NV", "NQ", "ROWS", "PAIRS", "LIMITS",
                                          "ACT")} == dict(BODIES=128, NV=128, NQ=160, ROWS=512,
                                                          PAIRS=256, LIMITS=256, ACT=128)
    assert huge["MASK_WORDS"] == 4 and big["MASK_WORDS"] == 2
    shipped = [k for k in registry if k.endswith(("PyBulletEnv-v0", "MuJoCoEnv-v0"))]
    assert len(shipped) == 26
    for env_id in shipped:
        task = pt.make_task(env_id)
        assert ce.caps_class(task.model, task.physics, task.act_dim) in (0, 1), env_id
    cfg = step_t.PhysicsConfig()
    humanoids = {n: mjcf_t.parse_mjcf(humanoids_xml(n), f"humanoids{n}") for n in (2, 3, 4)}
    balls = {n: mjcf_t.parse_mjcf(balls_xml(n), "balls") for n in (7, 11, 22)}
    for m in (humanoids[2], balls[7]):
        assert type(ce.pack_physics(m, cfg)) is Big
    for m in (humanoids[3], humanoids[4], balls[11]):
        t = ce.pack_physics(m, cfg)
        assert type(t) is Huge and t.caps_id == ce.CAPS_HUGE and t.lanes == 32, m.name
        assert ce.buffer_floats(t) % ce.Y_ALIGN == 0 and ce.buffer_floats(t) > 0
    # large by its sizes, huge by its scratch: nv 64 and 256 rows need 233 KB of Y
    assert ce._pick_caps(64, 80, 64, 100, 0, 128, 64) == ce.CAPS_BIG
    assert ce._pick_caps(64, 80, 64, 256, 0, 128, 64, 240000) == ce.CAPS_HUGE
    # past the huge caps: the sized class (tests/test_torch_sized_models.py)
    t = ce.pack_physics(balls[22], cfg)
    assert t.nv == 132 and t.caps_id == ce.CAPS_SIZED and ce.tables_class(t) == ce.SIZED
    assert ce._pick_caps(129, 150, 120, 10, 0, 0) == ce.CAPS_SIZED
    # the four-word mask: dofs 0-127, refused past them
    assert ce._root_path_words([0, 33, 64, 127], 4) == (1, 2, 1, 0x80000000)
    with pytest.raises(ValueError, match="root-path mask"):
        ce._root_path_words([3, 128], 4)
    # a scratch outside Y over a block's shared memory: the sized class
    t = ce.pack_physics(humanoids[4], cfg)
    shared, y = ce._scratch_sizes(t.nb, 60000, t.nv, t.nr, t.npair, t.nl, t.act)
    outside = 4 * sum(shared.values())
    assert outside > ce.MAX_SHARED_BYTES
    assert ce._pick_caps(t.nb, 60000, t.nv, t.nr, t.npair, t.nl, t.act, outside + 4 * y["Y"],
                         outside) == ce.CAPS_SIZED
    assert ce._pick_caps(64, 80, 64, 256, 0, 128, 64, 240000, 240000) == ce.CAPS_SIZED


def test_scene_by_id_with_both_backends():
    """(e)"""
    xml = humanoids_xml(4)

    def factory():  # one substep a step, to keep the plain version's CPU time down
        task = FourHumanoidT(xml)
        task.physics = dataclasses.replace(task.physics, frame_skip=1)
        return task

    pt.register(SCENE_ID, factory, 1000)
    B = 2
    envs = {b: pt.make_batched(SCENE_ID, B, device="cpu", backend=b)
            for b in ("fused", "composed")}
    assert envs["fused"].step_fn.kernel == "task_step_kernel_huge"
    assert envs["fused"].step_fn.size == ce.HUGE and envs["composed"].backend == "composed"
    a = np.random.default_rng(1).uniform(-1, 1, (B, 68)).astype(np.float32)
    out = {b: e.step(e.reset(seed=2), a) for b, e in envs.items()}
    for k in ("q", "v", "obs", "reward", "terminated", "epoch"):
        assert torch.equal(getattr(out["fused"], k), getattr(out["composed"], k)), k
    assert out["fused"].obs.shape == (88 + 92, B) and torch.isfinite(out["fused"].q).all()
    assert sorted(out["fused"].rewards) == ["alive", "progress"]
    assert torch.equal(out["fused"].rewards["alive"], torch.full((B,), 4.0))
