"""The large, huge and sized classes' tree blocks (engine_core.h ·
ENG_TREE_FIELDS): every dof loop of their substep bounded by a model's
trees, L stored by blocks and Y's rows over their supports, against the
dense loops of the same code (the tables widened to one block,
`ops.cuda_engine.widen_blocks`) and the plain version, at small sizes:

(a) the tree ranges and row supports that `pack_physics` gives two, four
    and ten Humanoids, 7, 22 and 40 balls, and a scene of touching trees
    with pair rows (one within a tree, one between two trees with a third
    tree's dofs between them), as parsed and with two trees' bodies
    interleaved, with eight balls (nv 70: huge) and with four (nv 46:
    large), equal ranges derived from the JAX package's
    `Model.ancestor_dofs` and plans;
(b) the large, huge and sized host twins (the kernels' own C++ built with
    g++) on two Humanoids (large), three Humanoids (huge), 22 balls (sized)
    and the pair scenes, as parsed and interleaved (huge and large), equal
    the same twins given widened tables bit for bit (a zero's sign
    included), over 3 steps (the task twin with a forced reset), and stay
    within the plain version's bounds;
(c) `substep_flops` counts the bounded loops: n copies of a tree cost n
    times one copy's Cholesky and back substitution, a floor row's forward
    solve what one copy's does, and widened tables the dense count (two
    Humanoids: 288,882 operations a substep against 900,939);
(d) torch's CUDA results at ties of zeros of maximum, minimum, clamp,
    clamp_min, clamp_max, amax and amin, bit for bit, through
    `HostTaskTwin` (TIE_BITS of tests/torch_user_tasks.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_user_tasks as ut
from pybulletgym_tpu.models import mjcf as mjcf_j
from pybulletgym_tpu.ops import contacts as ct_j
from pybulletgym_tpu.ops import step as step_j
from pybulletgym_tpu_torch.envs import pendula
from pybulletgym_tpu_torch.envs.base import env_step_plain, reset_fn
from pybulletgym_tpu_torch.models import mjcf as mjcf_t
from pybulletgym_tpu_torch.ops import contacts as ct_t
from pybulletgym_tpu_torch.ops import cuda_engine as ce
from pybulletgym_tpu_torch.ops import step as step_t
from pybulletgym_tpu_torch.ops import task_kernel as tk
from test_torch_big_models import _PKG_T, _ids, balls_xml, humanoids_task, humanoids_xml
from test_torch_humanoid import _q_bounds
from test_torch_sized_models import BallsTask, _walkers

SCENES = {"humanoids4": (humanoids_xml, 4), "humanoids10": (humanoids_xml, 10),
          "balls22": (balls_xml, 22), "balls40": (balls_xml, 40),
          "humanoids2": (humanoids_xml, 2), "balls7": (balls_xml, 7)}


def _blocks_from_jax(mj):
    """Each dof's block from the JAX model alone: a body's own dofs are its
    ancestor_dofs less its parent's, a tree the bodies under one child of
    the world, its interval widened over its dofs and merged with any
    overlapping one."""
    anc = [set(a) for a in mj.ancestor_dofs]
    trees = {}
    for i, b in enumerate(mj.bodies):
        r = i
        while mj.bodies[r].parent >= 0:
            r = mj.bodies[r].parent
        own = anc[i] - (anc[b.parent] if b.parent >= 0 else set())
        trees.setdefault(r, set()).update(own)
    spans = sorted((min(d), max(d) + 1) for d in trees.values())
    merged = []
    for lo, hi in spans:
        if merged and lo < merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    block = {}
    for lo, hi in merged:
        block.update({d: (lo, hi) for d in range(lo, hi)})
    return block


@pytest.mark.parametrize("name", list(SCENES))
def test_tree_ranges_match_the_jax_model(name):
    """(a)"""
    xml, n = SCENES[name]
    mj, mt = (mod.parse_mjcf(xml(n), name) for mod in (mjcf_j, mjcf_t))
    cfg = step_t.PhysicsConfig()
    t = ce.pack_physics(mt, cfg)
    large = name in ("humanoids2", "balls7")
    assert ce.tables_class(t) == ce.LARGE if large else ce.tables_class(t) in (ce.HUGE, ce.SIZED)
    block = _blocks_from_jax(mj)
    assert [(t.dof_lo[d], t.dof_hi[d]) for d in range(t.nv)] == [block[d] for d in range(t.nv)]
    floor, pairs = ct_j.build_contact_plan(mj, cfg.solver)
    bodies = [c.body for c in floor for _ in range(4 if c.kind == "disk" else 1)]
    assert not pairs and len(bodies) == t.nr
    for r, b in enumerate(bodies):
        path = mj.ancestor_dofs[b]
        assert (t.row_lo[r], t.row_hi[r]) == (min(path), block[max(path)][1]), r
    lim = ct_j.build_limit_plan(mj)
    for m, d in enumerate([] if lim is None else np.asarray(lim.dof).tolist()):
        assert (t.lim_lo[m], t.lim_hi[m]) == (d, block[d][1])
    # one block a Humanoid (23 dofs) or a ball (6); L and Y stored by them
    width = 23 if name.startswith("h") else 6
    assert {hi - lo for lo, hi in block.values()} == {width}
    layout = ce.scratch_layout(type(t).from_buffer_copy(t))
    assert layout["L"][1] == (t.nv // width) * width * (width | 1)
    ys = 3 * sum(t.row_hi[r] - t.row_lo[r] for r in range(t.nr))
    ys += sum(t.lim_hi[m] - t.lim_lo[m] for m in range(t.nl))
    assert layout["Y"][1] == max((t.nv | 1) + ys, (t.nv | 1) + 25 * t.nb)
    wide = ce.scratch_layout(ce.widen_blocks(t))
    assert wide["L"][1] == t.nv * (t.nv | 1)
    assert wide["Y"][1] == (t.nv | 1) + (3 * t.nr + t.nl) * t.nv


def _humanoids(n):
    task = humanoids_task(_PKG_T, torch, n)(humanoids_xml(n))
    task.physics = dataclasses.replace(task.physics, frame_skip=1)
    return task


def _rollout(step, s0, acts, forced):
    out, s = [], s0
    for t, a in enumerate(acts):
        if t == 1:
            s = s._replace(terminated=s.terminated | forced)
        s = step(s, a)
        out.append(s)
    return out


def _bits(x):
    """A tensor's bit pattern: float32 as int32, so that -0.0 differs from +0.0."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _same_state(a, b):
    for k in ("q", "v", "obs", "reward", "terminated", "truncated", "step_count", "epoch"):
        assert _same_bits(getattr(a, k), getattr(b, k)), k


_TWIN_CLASS = {"humanoids3": ce.HUGE, "balls22": ce.SIZED, "humanoids2": ce.LARGE}


@pytest.mark.parametrize("scene", ["humanoids3", "balls22", "humanoids2"])
def test_task_twin_equals_the_widened_tables(scene):
    """(b) the task twin, 3 steps of one substep, env 0 forced to reset
    before the second; the plain version's bounds on the first step"""
    task = BallsTask(22) if scene == "balls22" else _humanoids(int(scene[-1]))
    B = 2
    s0 = reset_fn(task, *_ids(B, 5))
    acts = [torch.from_numpy(np.random.default_rng(30 + t).uniform(
        -1, 1, (task.act_dim, B)).astype(np.float32)) for t in range(3)]
    forced = torch.tensor([True, False])
    twin = tk.HostTaskTwin(task)
    assert ce.tables_class(twin.tables) == _TWIN_CLASS[scene]
    tree = _rollout(twin, s0, acts, forced)
    twin.tables = ce.widen_blocks(twin.tables)
    for a, b in zip(tree, _rollout(twin, s0, acts, forced)):
        _same_state(a, b)
    assert tree[1].epoch[0] == 1 and tree[1].step_count[0] == 1
    p = env_step_plain(task, s0, acts[0])
    if scene != "balls22":
        _q_bounds((p.q - tree[0].q).abs().numpy(), 1e-5)
    else:
        _walkers(p.q - tree[0].q)


@pytest.mark.parametrize("scene", ["humanoids3", "balls22", "humanoids2"])
def test_physics_twin_equals_the_widened_tables(scene):
    """(b) the physics twin, 3 steps of one substep from a seeded state"""
    if scene != "balls22":
        task = _humanoids(int(scene[-1]))
        m, cfg = task.model, task.physics
        s0 = reset_fn(task, *_ids(2, 5))
        q, v = s0.q, s0.v
    else:
        m = mjcf_t.parse_mjcf(balls_xml(22, 0.09), "balls")
        cfg = step_t.PhysicsConfig(frame_skip=1)
        rng = np.random.default_rng(2)
        q = torch.from_numpy(np.repeat(m.qpos0[:, None], 2, 1).astype(np.float32))
        v = torch.from_numpy(rng.uniform(-0.5, 0.5, (m.nv, 2)).astype(np.float32))
    t = ce.pack_physics(m, cfg)
    assert ce.tables_class(t) == _TWIN_CLASS[scene]
    w = ce.widen_blocks(t)
    hw = ce.HostTwin()
    rng = np.random.default_rng(3)
    for _ in range(3):
        tau = torch.from_numpy(rng.uniform(-1, 1, (m.nv, 2)).astype(np.float32))
        got, dense = hw.physics_step(t, q, v, tau), hw.physics_step(w, q, v, tau)
        assert all(_same_bits(x, y) for x, y in zip(got, dense))
        q, v = got[0], got[1]


# Three touching trees and eight balls (nv 70: the huge class) or four (nv
# 46: the large class): tree A, a free sphere with two hinged capsules that
# cross at its centre (one limited); tree M, a ball far off; tree C, a free
# sphere overlapping A's, with two hinged capsules; and the balls. Pair
# rows: A's two capsules (one tree) and the spheres of A and C (two trees,
# M's dofs between them).
_ARMS = ('<body name="{p}a"><joint name="{p}ja" type="hinge" axis="0 1 0"{lim}/>'
         '<geom name="{p}ga" type="capsule" fromto="0 0 0 0.3 0 -0.1" size="0.04"/></body>'
         '<body name="{p}b"><joint name="{p}jb" type="hinge" axis="1 0 0"/>'
         '<geom name="{p}gb" type="capsule" fromto="0 0 0 0.3 0 -0.05" size="0.04"/></body>')
PAIRS = (("Aga", "Agb"), ("As", "Cs"))


def pairs_xml(n_balls: int = 8) -> str:
    tree = ('<body name="{p}" pos="{x} 0 0.5"><joint name="{p}j" type="free"/>'
            '<geom name="{p}s" type="sphere" size="0.1"/>' + _ARMS + '</body>')
    balls = "".join(f'<body name="b{i}" pos="{0.3 * i} 2 0.09"><joint name="bj{i}" type="free"/>'
                    f'<geom name="bg{i}" type="sphere" size="0.1"/></body>' for i in range(n_balls))
    return ('<mujoco model="pairs"><worldbody><geom name="floor" type="plane" size="10 10 0.1"/>'
            + tree.format(p="A", x=0, lim=' limited="true" range="-30 30"')
            + '<body name="M" pos="5 0 0.09"><joint name="Mj" type="free"/>'
            '<geom name="Ms" type="sphere" size="0.1"/></body>'
            + tree.format(p="C", x=0.15, lim="") + balls + '</worldbody></mujoco>')


def _reorder(m, order):
    """The model `m` (either package's) with its bodies in `order` (old
    indices, each parent before its children) and the dofs and q entries
    renumbered in that order, as a loader emitting them so would give."""
    new = {old: k for k, old in enumerate(order)}
    bodies, qmap, vmap = [], [], []
    for old in order:
        b = m.bodies[old]
        nq, nv = (7, 6) if b.jtype == mjcf_t.JointType.FREE else (1, 1)
        bodies.append(dataclasses.replace(b, parent=new.get(b.parent, -1), q_adr=len(qmap),
                                          v_adr=len(vmap)))
        qmap += range(b.q_adr, b.q_adr + nq)
        vmap += range(b.v_adr, b.v_adr + nv)
    vnew = {old: k for k, old in enumerate(vmap)}
    body_dofs = [tuple(range(b.v_adr, b.v_adr + len(m.body_dofs[old])))
                 for b, old in zip(bodies, order)]
    anc = []
    for i, b in enumerate(bodies):
        anc.append((anc[b.parent] if b.parent >= 0 else ()) + body_dofs[i])
    at = lambda x: np.asarray(x)[vmap]  # noqa: E731
    moved = lambda d: {k: (new.get(i, -1), p, q) for k, (i, p, q) in d.items()}  # noqa: E731
    return m.replace(
        bodies=tuple(bodies), qpos0=np.asarray(m.qpos0)[qmap], dof_armature=at(m.dof_armature),
        dof_damping=at(m.dof_damping), dof_stiffness=at(m.dof_stiffness),
        dof_springref=at(m.dof_springref), jnt_limited=at(m.jnt_limited),
        jnt_range=at(m.jnt_range),
        geoms=tuple(dataclasses.replace(g, body=new.get(g.body, -1)) for g in m.geoms),
        actuators=tuple(dataclasses.replace(a, v_adr=vnew[a.v_adr]) for a in m.actuators),
        frames=moved(m.frames), sites=moved(m.sites), body_dofs=tuple(body_dofs),
        ancestor_dofs=tuple(anc), joint_names=tuple(m.joint_names[d] for d in vmap),
        dof_body=tuple(new[m.dof_body[d]] for d in vmap))


# the pair scenes: (balls, interleaved?, the tables' class, nv)
PAIR_SCENES = {"parsed": (8, False, ce.HUGE, 70), "interleaved": (8, True, ce.HUGE, 70),
               "large_parsed": (4, False, ce.LARGE, 46),
               "large_interleaved": (4, True, ce.LARGE, 46)}


def _pair_scene(name, mod):
    """The pair scene `name` of PAIR_SCENES for the loader `mod`: as parsed,
    or with A's and C's bodies interleaved (A, C, A's arms, M, C's arms,
    the balls), so that the two trees' dof intervals overlap and merge into
    one block with M inside it."""
    balls, interleaved, _, _ = PAIR_SCENES[name]
    m = mod.parse_mjcf(pairs_xml(balls), "pairs")
    if interleaved:
        idx = {b.name: i for i, b in enumerate(m.bodies)}
        first = ["A", "C", "Aa", "Ab", "M", "Ca", "Cb"]
        m = _reorder(m, [idx[n] for n in first] + [i for i in range(len(m.bodies))
                                                   if m.bodies[i].name not in first])
    return m


def _pair_cfgs():
    return tuple(pkg.PhysicsConfig(frame_skip=1, solver=ct.SolverConfig(self_collision_pairs=PAIRS))
                 for pkg, ct in ((step_j, ct_j), (step_t, ct_t)))


@pytest.mark.parametrize("name", list(PAIR_SCENES))
def test_pair_and_interleaved_supports_match_the_jax_plan(name):
    """(a) the pair scene: blocks from the JAX model (two, A's and C's, merged
    where interleaved), each floor, pair and limit row's support from the
    JAX contact and limit plans: a pair row's runs from the first dof on
    one of its bodies' root paths but not both to the end of the block of
    the last, across M where the pair is A's and C's spheres"""
    cfg_j, cfg_t = _pair_cfgs()
    mj, mt = _pair_scene(name, mjcf_j), _pair_scene(name, mjcf_t)
    t = ce.pack_physics(mt, cfg_t)
    _, interleaved, size, nv = PAIR_SCENES[name]
    assert ce.tables_class(t) == size and (t.nv, t.npair) == (nv, 2)
    block = _blocks_from_jax(mj)
    assert [(t.dof_lo[d], t.dof_hi[d]) for d in range(t.nv)] == [block[d] for d in range(t.nv)]
    a, m_, c = (mj.body_index(n) for n in ("A", "M", "C"))
    if interleaved:
        assert block[0] == (0, 22) and block[mj.body_dofs[m_][0]] == (0, 22)
    else:
        assert (block[0], block[8], block[14]) == ((0, 8), (8, 14), (14, 22))
    floor, pairs = ct_j.build_contact_plan(mj, cfg_j.solver)
    nfloor = sum(4 if f.kind == "disk" else 1 for f in floor)
    assert t.nr == nfloor + 2 and len(pairs) == 2
    for r, f in enumerate(floor):
        path = mj.ancestor_dofs[f.body]
        assert (t.row_lo[r], t.row_hi[r]) == (min(path), block[max(path)][1]), r
    for k, p in enumerate(pairs):
        dofs = set(mj.ancestor_dofs[p.body_a]) ^ set(mj.ancestor_dofs[p.body_b])
        r = nfloor + k
        assert (t.row_lo[r], t.row_hi[r]) == (min(dofs), block[max(dofs)][1]), k
    across = nfloor + [p.geom for p in pairs].index("As")
    assert t.row_lo[across] <= mj.body_dofs[m_][0] < t.row_hi[across]
    lim = ct_j.build_limit_plan(mj)
    dofs = np.asarray(lim.dof).tolist()
    assert len(dofs) == t.nl and mj.joint_names[dofs[0]] == "Aja"
    for k, d in enumerate(dofs):
        assert (t.lim_lo[k], t.lim_hi[k]) == (d, block[d][1])


@pytest.mark.parametrize("name", list(PAIR_SCENES))
def test_pair_scene_twin_equals_the_widened_tables(name):
    """(b) the pair scene through the huge or large physics twin, 3 steps of
    one substep: bit for bit the widened tables', both pair rows in
    contact, and within the walkers' bounds of the plain version"""
    _, cfg = _pair_cfgs()
    m = _pair_scene(name, mjcf_t)
    t = ce.pack_physics(m, cfg)
    assert ce.tables_class(t) == PAIR_SCENES[name][2]
    w = ce.widen_blocks(t)
    hw = ce.HostTwin()
    plain = step_t.make_physics_step_plain(m, cfg)[0]
    rng = np.random.default_rng(7)
    q = torch.from_numpy(np.repeat(m.qpos0[:, None], 2, 1).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-0.5, 0.5, (m.nv, 2)).astype(np.float32))
    for k in range(3):
        tau = torch.from_numpy(rng.uniform(-1, 1, (m.nv, 2)).astype(np.float32))
        got, dense = hw.physics_step(t, q, v, tau), hw.physics_step(w, q, v, tau)
        assert all(_same_bits(x, y) for x, y in zip(got, dense))
        if k == 0:
            assert (got[2][t.nr - 2:] > 0).all()  # both pair rows in contact
            _walkers(plain(q, v, tau)[0] - got[0])
        q, v = got[0], got[1]


def test_substep_flops_count_the_blocks():
    """(c)"""
    cfg = step_t.PhysicsConfig()
    one = mjcf_t.parse_mjcf(humanoids_xml(1), "h1")
    fact1, solve1 = ce._chol_flops(one.nv)
    for n in (4, 10):
        t = ce.pack_physics(mjcf_t.parse_mjcf(humanoids_xml(n), f"h{n}"), cfg)
        fact, back, _ = ce._tree_chol_flops(t)
        assert (fact, back) == (n * fact1, n * solve1)
        assert ce._tree_solve_flops(t, 0, t.nv) == n * solve1
        last = t.nr - 1  # a floor row of the last Humanoid: one copy's solve
        assert ce._tree_solve_flops(t, t.row_lo[last], t.row_hi[last]) == solve1
        w = ce.widen_blocks(t)
        assert ce._tree_chol_flops(w)[:2] == ce._chol_flops(t.nv)
        assert ce.substep_flops(w) > 9 * ce.substep_flops(t)
    balls = ce.pack_physics(mjcf_t.parse_mjcf(balls_xml(40, 0.09), "balls"), cfg)
    assert ce._tree_chol_flops(balls)[:2] == tuple(40 * x for x in ce._chol_flops(6))
    # two Humanoids, the large class: the blocks' count and the dense one
    t = ce.pack_physics(mjcf_t.parse_mjcf(humanoids_xml(2), "h2"), cfg)
    assert ce.tables_class(t) == ce.LARGE
    assert ce._tree_chol_flops(t)[:2] == (2 * fact1, 2 * solve1)
    assert (ce.substep_flops(t), ce.substep_flops(ce.widen_blocks(t))) == (288882, 900939)


class TieProbe(pendula.InvertedPendulumTask):
    """InvertedPendulum's model; obs: the ties of zeros of tie_values on
    the clipped actions x = a[0], y = a[1]."""

    def __init__(self):
        super().__init__()
        self.act_dim = 2
        self.obs_dim = len(ut.TIE_BITS)

    def action_tau_scalar(self, a):
        return super().action_tau_scalar(a[:1])

    def output_scalar(self, q, v, depths, a, aux, ids=None):
        _, reward, term, aux2, comps = super().output_scalar(q, v, depths, a[:1], aux, ids)
        return list(ut.tie_values(a[0], a[1], torch).values()), reward, term, aux2, comps


def test_zero_ties_take_torch_cuda_bits():
    """(d) envs 0 and 1: x, y = -0.0, +0.0 and +0.0, -0.0"""
    task = TieProbe()
    s = reset_fn(task, *_ids(2, 1))
    acts = torch.tensor([[-0.0, 0.0], [0.0, -0.0]])
    out = tk.HostTaskTwin(task)(s, acts)
    assert list(ut.tie_values(acts[0], acts[1], torch)) == list(ut.TIE_BITS)
    for k, (name, bits) in enumerate(ut.TIE_BITS.items()):
        assert (out.obs[k] == 0).all(), name
        assert torch.signbit(out.obs[k]).tolist() == list(bits), name
