"""Models past the huge class: the sized class of the kernels' tables
(engine_core.h, -DENG_SIZED_TABLES with caps set from the model's own sizes:
a root-path mask of ceil(nv / 32) words, the whole scratch in one buffer an
env, no model size refused), on a scene of ten Humanoids in one worldbody
(180 bodies, nq 240, nv 230, 170 actuators, 290 floor rows, 340 limit rows;
its scratch outside Y 260,404 bytes, over a block's 232,448, and eight mask
words) and on 22 and 40 free balls (nv 132 and 240; the forty's scratch
outside Y 250,404 bytes). Held against the JAX package and the plain
version, at small sizes:

(a) the ten-Humanoid scene's `Model` and contact plan equal the JAX
    package's, field by field; its tenth Humanoid's root paths lie in mask
    words 6 and 7;
(b) the forty balls: one `make_physics_step_plain` substep at B=4 against
    one eager JAX `make_substep_scalar` substep, every ball in the floor;
(c) the sized class's host twins (the kernels' own C++ built with g++ and
    -DENG_SIZED_TABLES, the whole scratch in one heap buffer an env) against
    the plain step at one substep a step: `HostTwin.physics_step` on the
    forty balls at B=8 for 3 steps, the mask words of dofs 128-255 zeroed in
    a copy of the tables changing what it computes, so the C++ reads them;
    `HostTaskTwin` on a task over the 22 balls at B=8 for 3 steps, env 0
    forced to reset before the second, resets bitwise;
(d) size classes: the 26 shipped IDs stay default and the large and huge
    assignments of test_torch_huge_models.py stay; 22 and 40 balls, six and
    ten Humanoids go to the sized class, with caps rounded up from their
    sizes;
(e) a scene by ID with both backends: tests/test_torch_sized_scene.py
    (split off to keep this file under its 40 s).

Bounds: the balls take the walkers' bounds of the JAX package
(tests/test_pallas_equivalence.py:38-40): mean |dq| < 1e-5, max < 1e-2; the
scene's two backends are held bitwise.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybulletgym_tpu_torch as pt
from pybulletgym_tpu.models import mjcf as mjcf_j
from pybulletgym_tpu.ops import contacts as ct_j
from pybulletgym_tpu.ops import step as step_j
from pybulletgym_tpu_torch.api.registry import registry
from pybulletgym_tpu_torch.envs.base import Task, env_step_plain, reset_fn
from pybulletgym_tpu_torch.models import mjcf as mjcf_t
from pybulletgym_tpu_torch.ops import contacts as ct_t
from pybulletgym_tpu_torch.ops import cuda_engine as ce
from pybulletgym_tpu_torch.ops import rand
from pybulletgym_tpu_torch.ops import step as step_t
from pybulletgym_tpu_torch.ops import task_kernel as tk
from test_torch_big_models import _PKG_J, _PKG_T, _ids, balls_xml, humanoids_task, humanoids_xml
from test_torch_models import _same

def _walkers(dq):
    dq = dq.abs()
    assert dq.mean() < 1e-5 and dq.max() < 1e-2, (dq.mean(), dq.max())


def _words_zeroed(tab, first):
    """A copy of sized tables with every body's mask words >= `first`
    zeroed, and those words of every set the substep reads (each dof's
    ancestors, each row's support, each pair row's body a's path)."""
    probe = type(tab).from_buffer_copy(tab)
    nb = len(probe.anc_mask)
    words = len(probe.anc_mask_hi) // nb + 1
    for w in range(max(first, 1), words):
        for i in range(probe.nb):
            probe.anc_mask_hi[(w - 1) * nb + i] = 0
    for name in ("dof_anc", "path_u", "pair_pa"):
        arr = getattr(probe, name)
        for j in range(len(arr) // words):
            for w in range(first, words):
                arr[words * j + w] = 0
    return probe


class BallsTask(Task):
    """A user's task over `balls_xml(n, 0.09)`, one substep a step. Reset:
    qpos0 with ball k's height plus U(±0.01) (stream k) and its last dof's
    velocity U(±0.5) (stream n + k), the other velocities 0; torque: 2 a on
    each ball's last dof; obs: q and v; reward: the balls' summed height;
    done: the first ball below the floor by 1 m."""

    def __init__(self, n: int):
        self.model = m = mjcf_t.parse_mjcf(balls_xml(n, 0.09), "balls")
        self.physics = step_t.PhysicsConfig(frame_skip=1)
        self.act_dim, self.obs_dim, self.max_episode_steps = n, m.nq + m.nv, 1000

    def initial_state_scalar(self, seed, env_id, epoch):
        m, n = self.model, self.act_dim
        zero = torch.zeros_like(env_id, dtype=torch.float32)
        q = [zero + float(x) for x in m.qpos0]
        v = [zero] * m.nv
        for k in range(n):
            q[7 * k + 2] = q[7 * k + 2] + rand.uniform(seed, k, env_id, epoch, -0.01, 0.01)
            v[6 * k + 5] = rand.uniform(seed, n + k, env_id, epoch, -0.5, 0.5)
        return q, v, {}

    def action_tau_scalar(self, a):
        tau = [0.0] * self.model.nv
        for k, ak in enumerate(a):
            tau[6 * k + 5] = 2.0 * ak
        return tau

    def output_scalar(self, q, v, depths, a, aux, ids=None):
        height = q[2]
        for k in range(1, self.act_dim):
            height = height + q[7 * k + 2]
        return list(q) + list(v), height, q[2] < -1.0, dict(aux), {"height": height}


@pytest.fixture(scope="module")
def scene():
    xml = humanoids_xml(10)
    return humanoids_task(_PKG_J, jnp, 10)(xml), humanoids_task(_PKG_T, torch, 10)(xml)


def test_scene_model_equals_jax(scene):
    """(a)"""
    tj, tt = scene
    _same(tj.model, tt.model, "model")
    m = tt.model
    floor, pairs = ct_t.build_contact_plan(m, tt.physics.solver)
    assert (len(m.bodies), m.nq, m.nv, len(m.actuators)) == (180, 240, 230, 170)
    assert (len(floor), len(pairs), int(ct_t.build_limit_plan(m).dof.shape[0])) == (290, 0, 340)
    _same(ct_j.build_contact_plan(tj.model, tj.physics.solver), (floor, pairs), "contact plan")
    t = ce.pack_physics(m, tt.physics)
    assert ce.tables_class(t) == ce.SIZED and len(t.anc_mask_hi) == 7 * len(t.anc_mask)
    # the tenth Humanoid's root paths start at its free joint, dof 207: the
    # shin's in word 6 (dofs 207-223), the left forearm's in words 6 and 7
    for body, words in (("h10_left_shin", (6,)), ("h10_left_lower_arm", (6, 7))):
        i = m.body_index(body)
        path = ce.root_path(t, i)
        assert {d for d in range(256) if path >> d & 1} == set(m.ancestor_dofs[i])
        assert min(m.ancestor_dofs[i]) == 207
        assert [w for w in range(8) if path >> (32 * w) & 0xFFFFFFFF] == list(words), body


def test_balls_physics_step_plain_matches_jax():
    """(b) one substep of forty balls, each 1 cm in the floor"""
    mj, mt = (mod.parse_mjcf(balls_xml(40, 0.09), "balls") for mod in (mjcf_j, mjcf_t))
    _same(mj, mt, "model")
    assert (mt.nv, mt.nq) == (240, 280)
    B = 4
    rng = np.random.default_rng(8)
    q = np.repeat(mt.qpos0[:, None], B, 1).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (mt.nv, B)).astype(np.float32)
    tau = rng.uniform(-1, 1, (mt.nv, B)).astype(np.float32)
    cfg_j, cfg_t = step_j.PhysicsConfig(frame_skip=1), step_t.PhysicsConfig(frame_skip=1)
    substep, _, n_rows = step_j.make_substep_scalar(mj, cfg_j)
    qj, vj, dj = (np.stack([np.asarray(x) for x in out]) for out in substep(
        [jnp.asarray(r) for r in q], [jnp.asarray(r) for r in v], [jnp.asarray(r) for r in tau]))
    q2, v2, d2 = step_t.make_physics_step_plain(mt, cfg_t)[0](*map(torch.from_numpy, (q, v, tau)))
    assert n_rows == 40 and (d2 > 0).all()
    _walkers(torch.from_numpy(qj) - q2)
    assert np.abs(dj - d2.numpy()).max() < 1e-5
    assert np.abs(vj - v2.numpy()).mean() < 1e-4


def test_balls_through_the_sized_physics_twin():
    """(c) forty balls (nv 240) dropped onto the floor from 9 cm, under
    their radius: B=8, 3 steps of one substep"""
    model = mjcf_t.parse_mjcf(balls_xml(40, 0.09), "balls")
    cfg = step_t.PhysicsConfig(frame_skip=1)
    tab = ce.pack_physics(model, cfg)
    caps = ce.tables_caps(tab)
    assert ce.tables_class(tab) == ce.SIZED and tab.caps_id == ce.CAPS_SIZED
    assert tab.lanes == 32 and ce.lane_nv(32, ce.SIZED, caps) == 256
    # the scratch outside Y alone, at its dense sizes, is over a block's
    # shared memory: the whole of it lives in the buffer, 128-byte aligned;
    # laid out by root paths, L is 40 balls' ancestor rows of 1-6 floats
    assert ce.buffer_floats(tab) == tab.sc_stride and tab.sc_stride % ce.Y_ALIGN == 0
    dense = ce.dense_stride(tab)
    assert dense * 4 - 4 * (tab.nv * (tab.nv | 1)) > 0 and dense * 4 > 250400
    assert ce.scratch_layout(type(tab).from_buffer_copy(tab))["L"][1] == 40 * 21
    # the last ball's dofs 234-239: mask word 7
    assert ce.root_path(tab, 39) == sum(1 << d for d in range(234, 240))
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
        _walkers(qp - qh)
        assert (dp - dh).abs().max() < 1e-5
        if k == 0:  # without words 4-7 the CRBA and the contacts lose dofs 128-239
            _, vx, _ = hw.physics_step(_words_zeroed(tab, 4), q, v, tau)
            assert not torch.allclose(vx[128:], vh[128:], atol=1e-3)
            assert torch.equal(vx[:126], vh[:126])  # balls 0-20 keep their words 0-3
        q, v = qp, vp
    assert (dp > -0.02).all()


def test_sized_task_twin_matches_plain():
    """(c) a user's task over 22 balls (nv 132: mask word 4): B=8, 3 steps
    of one substep, env 0 forced to reset before the second"""
    task = BallsTask(22)
    B = 8
    s0 = reset_fn(task, *_ids(B, 5))
    acts = [torch.from_numpy(np.random.default_rng(30 + t).uniform(
        -1, 1, (task.act_dim, B)).astype(np.float32)) for t in range(3)]
    forced = torch.zeros(B, dtype=torch.bool)
    forced[0] = True

    def rollout(step):
        out, s = [], s0
        for t, a in enumerate(acts):
            if t == 1:
                s = s._replace(terminated=s.terminated | forced)
            s = step(s, a)
            out.append(s)
        return out

    plain = rollout(lambda s, a: env_step_plain(task, s, a))
    twin = tk.HostTaskTwin(task)
    t = twin.tables
    assert ce.tables_class(t) == ce.SIZED and t.caps_id == ce.CAPS_SIZED
    assert (t.lanes, t.nb, t.nv, t.nr, t.nl, t.act) == (32, 22, 132, 22, 0, 22)
    assert ce.tables_caps(t) == (32, 160, 160, 32, 32, 32, 160, 32, 160)
    for p, h in zip(plain, rollout(twin)):
        _walkers(p.q - h.q)
        assert torch.equal(p.epoch, h.epoch) and torch.equal(p.step_count, h.step_count)
        assert torch.equal(p.terminated, h.terminated)
        assert (p.obs - h.obs).abs().max() < 1e-2 and (p.reward - h.reward).abs().max() < 1e-2
    assert plain[1].epoch[0] == 1 and plain[1].step_count[0] == 1
    # the reset alone: the same library, its tables at frame_skip 0
    reset = copy.copy(twin)
    reset.tables = type(t).from_buffer_copy(t)
    reset.tables.frame_skip = 0
    done = plain[0]._replace(terminated=torch.ones(B, dtype=torch.bool))
    pr, hr = env_step_plain(task, done, acts[1], 0), reset(done, acts[1])
    assert torch.equal(pr.q, hr.q) and torch.equal(pr.v, hr.v)  # the reset draws bitwise


def test_shipped_large_and_huge_classes_unchanged():
    """(d) the classes below the sized one"""
    shipped = [k for k in registry if k.endswith(("PyBulletEnv-v0", "MuJoCoEnv-v0"))]
    assert len(shipped) == 26
    for env_id in shipped:
        task = pt.make_task(env_id)
        assert ce.caps_class(task.model, task.physics, task.act_dim) in (0, 1), env_id
    cfg = step_t.PhysicsConfig()
    for xml, cls in ((humanoids_xml(2), ce.LARGE), (balls_xml(7), ce.LARGE),
                     (humanoids_xml(3), ce.HUGE), (humanoids_xml(4), ce.HUGE),
                     (balls_xml(11), ce.HUGE)):
        t = ce.pack_physics(mjcf_t.parse_mjcf(xml, "m"), cfg)
        assert ce.tables_class(t) == cls and ce.tables_caps(t) is None
        # the large and huge classes keep the whole scratch in their buffer
        assert ce.buffer_floats(t) == t.sc_stride and t.sc_stride % ce.Y_ALIGN == 0
    # the huge class's four words hold dofs 0-127; the sized class's more
    with pytest.raises(ValueError, match="root-path mask"):
        ce._root_path_words([3, 128], 4)
    assert ce._root_path_words([0, 128, 255], 8) == (1, 0, 0, 0, 1, 0, 0, 0x80000000)


@pytest.mark.parametrize("name, act, caps, outside, y", [
    ("humanoids6", 102, (128, 160, 160, 192, 32, 224, 160, 128, 160), 105460, 404212),
    ("humanoids10", 170, (192, 256, 256, 320, 32, 352, 256, 192, 256), 260404, 1118964),
    ("balls22", 0, (32, 160, 160, 32, 32, 32, 160, 32, 160), 80700, 35644),
    ("balls40", 0, (64, 256, 288, 64, 32, 32, 256, 64, 288), 250404, 116644),
])
def test_sized_class(name, act, caps, outside, y):
    """(d) past the huge caps (nv over 128) or a block's shared memory (the
    scratch outside Y over 232,448 bytes): the sized class, its caps the
    sizes rounded up to multiples of 32 (actuators one a dof, part frames
    one a body, a draw for every q and dof), no refusal"""
    n = int(name.lstrip("humanoidsbl"))
    m = mjcf_t.parse_mjcf(humanoids_xml(n) if name.startswith("h") else balls_xml(n), name)
    cfg = step_t.PhysicsConfig()
    _, pairs, rows, _, nl = ce._plans(m, cfg)
    shared, ys = ce._scratch_sizes(len(m.bodies), m.nq, m.nv, len(rows), len(pairs), nl, act)
    assert (4 * (sum(shared.values()) | 1), 4 * ys["Y"]) == (outside, y)
    assert ce.caps_class(m, cfg, act) == ce.CAPS_SIZED
    t = ce.pack_physics(m, cfg, act=act)
    assert type(t) is ce.tables_type(ce.SIZED, caps)[0] and ce.tables_caps(t) == caps
    assert ce.sized_caps(len(m.bodies), m.nq, m.nv, len(rows), len(pairs), nl, act) == caps
    assert t.caps_id == ce.CAPS_SIZED and t.lanes == 32 and ce.buffer_floats(t) == t.sc_stride
    assert len(t.anc_mask) == caps[0] and len(t.anc_mask_hi) == caps[0] * (caps[1] // 32 - 1)
    flags = ce.class_flags(ce.SIZED, caps)
    assert flags[0] == ce.SIZED_FLAG and f"-DSIZED_MASK_WORDS={caps[1] // 32}" in flags
    assert f"-DSIZED_MAX_NV={caps[1]}" in flags and len(flags) == 11
    # the whole scratch in the buffer: at its dense sizes (L and Y's rows
    # dense) at least what lives outside Y and Y; by root paths less
    assert ce.dense_stride(t) * 4 >= outside + y - 4
    assert ce.buffer_floats(t) < ce.dense_stride(t) and t.sc_stride % ce.Y_ALIGN == 0
    assert (outside > ce.MAX_SHARED_BYTES) == (name in ("humanoids10", "balls40"))


def test_sized_caps_round_up():
    """(d) the caps' rounding: multiples of 32, at least one each, actuators
    one a dof, part frames one a body, a draw for every q and dof; a model of
    many bodies and few dofs (201 bodies welded to 6 dofs) keeps the two mask
    words that anc_mask and anc_mask_hi hold"""
    assert ce.sized_caps(180, 240, 230, 290, 0, 340, 170) == (192, 256, 256, 320, 32, 352, 256,
                                                              192, 256)
    assert ce.sized_caps(33, 1, 1, 0, 0, 0, 40) == (64, 32, 32, 32, 32, 32, 64, 64, 32)
    caps = ce.sized_caps(201, 7, 6, 1, 0, 0)
    assert caps == (224, 32, 32, 32, 32, 32, 32, 224, 32)
    Tables, c = ce.tables_type(ce.SIZED, caps)
    assert c["MASK_WORDS"] == 2 and len(Tables().anc_mask_hi) == 224
    assert "-DSIZED_MASK_WORDS=2" in ce.class_flags(ce.SIZED, caps)
    assert ce._pick_caps(201, 7, 6, 1, 0, 0) == ce.CAPS_SIZED
    with pytest.raises(ValueError, match="only it"):
        ce.tables_type(ce.HUGE, caps)
