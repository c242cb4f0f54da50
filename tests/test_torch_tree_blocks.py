"""The large, huge and sized classes' root paths and window fields
(engine_core.h · ENG_PATH_FIELDS, ENG_WIN_FIELDS) against the model's trees,
at small sizes (the substep itself on these classes: tests/test_torch_tree_paths.py):

(a) the supports that `pack_physics` gives two, four and ten Humanoids, 7,
    22 and 40 balls, and a scene of touching trees with pair rows (one
    within a tree, one between two trees with a third tree's dofs between
    them), as parsed and with two trees' bodies interleaved, with eight
    balls (nv 70: huge) and with four (nv 46: large): each dof's lowest
    ancestor, each floor, pair and limit row's support, its size and its
    sweep window, and L's and Y's floats, equal what the JAX package's
    `Model.ancestor_dofs` and plans give;
(b) torch's CUDA results at ties of zeros of maximum, minimum, clamp,
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
from pybulletgym_tpu_torch.envs.base import reset_fn
from pybulletgym_tpu_torch.models import mjcf as mjcf_t
from pybulletgym_tpu_torch.ops import contacts as ct_t
from pybulletgym_tpu_torch.ops import cuda_engine as ce
from pybulletgym_tpu_torch.ops import step as step_t
from pybulletgym_tpu_torch.ops import task_kernel as tk
from test_torch_big_models import _PKG_T, _ids, balls_xml, humanoids_task, humanoids_xml

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


def _mask(dofs):
    return sum(1 << int(d) for d in dofs)


def _words(t):
    return len(t.dof_anc) // len(t.dof_depth)


def _row_mask(t, j):
    w = _words(t)
    return sum(t.path_u[w * j + k] << 32 * k for k in range(w))


def _assert_window(t, j, mask):
    """Row j's support `mask`, its size and its sweep window's words"""
    assert _row_mask(t, j) == mask and t.path_n[j] == bin(mask).count("1"), j
    first, last = ((mask & -mask).bit_length() - 1) // 32, (mask.bit_length() - 1) // 32
    assert (t.path_w0[j], t.path_w1[j]) == (min(first, _words(t) - 2), last), j


def _assert_dof_lo(t, mj):
    """Each dof's lowest ancestor (or itself) from the JAX model's root paths"""
    for d in range(t.nv):
        anc = [e for e in mj.ancestor_dofs[mj.dof_body[d]] if e < d]
        assert t.dof_lo[d] == (min(anc) if anc else d), d


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
    _assert_dof_lo(t, mj)
    # a tree's dofs hang from its first: one block a Humanoid (23 dofs) or a
    # ball (6), each dof's lowest ancestor its block's first dof
    width = 23 if name.startswith("h") else 6
    assert {hi - lo for lo, hi in block.values()} == {width}
    assert [t.dof_lo[d] for d in range(t.nv)] == [block[d][0] for d in range(t.nv)]
    floor, pairs = ct_j.build_contact_plan(mj, cfg.solver)
    bodies = [c.body for c in floor for _ in range(4 if c.kind == "disk" else 1)]
    assert not pairs and len(bodies) == t.nr
    for r, b in enumerate(bodies):
        _assert_window(t, r, _mask(mj.ancestor_dofs[b]))
    lim = ct_j.build_limit_plan(mj)
    chains = []
    for m, d in enumerate([] if lim is None else np.asarray(lim.dof).tolist()):
        chains.append([e for e in mj.ancestor_dofs[mj.dof_body[d]] if e <= d])
        _assert_window(t, t.nr + m, _mask(chains[-1]))
    # L by ancestor rows; Y's rows over their supports, a limit pair's one
    layout = ce.scratch_layout(type(t).from_buffer_copy(t))
    depth = [len([e for e in mj.ancestor_dofs[mj.dof_body[d]] if e < d]) for d in range(t.nv)]
    assert layout["L"][1] == sum(k + 1 for k in depth) < t.nv * (t.nv | 1)
    second = ce.limit_seconds([c[-1] for c in chains])
    ys = 3 * sum(t.path_n[r] for r in range(t.nr))
    ys += sum(len(c) for c, sec in zip(chains, second) if not sec)
    assert layout["Y"][1] == max((t.nv | 1) + ys, (t.nv | 1) + 25 * t.nb)


def _humanoids(n):
    task = humanoids_task(_PKG_T, torch, n)(humanoids_xml(n))
    task.physics = dataclasses.replace(task.physics, frame_skip=1)
    return task


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
    """(a) the pair scene: each dof's lowest ancestor from the JAX model,
    each floor, pair and limit row's support from the JAX contact and limit
    plans: a pair row's the union of its bodies' root paths (body a's path
    first, `pair_pa`, and its dofs off b's, `pair_na`), which leaves out M
    where the pair is A's and C's spheres, whose dof intervals merge into
    one block with M inside where interleaved"""
    cfg_j, cfg_t = _pair_cfgs()
    mj, mt = _pair_scene(name, mjcf_j), _pair_scene(name, mjcf_t)
    t = ce.pack_physics(mt, cfg_t)
    _, interleaved, size, nv = PAIR_SCENES[name]
    assert ce.tables_class(t) == size and (t.nv, t.npair) == (nv, 2)
    block = _blocks_from_jax(mj)
    _assert_dof_lo(t, mj)
    m_ = mj.body_index("M")
    if interleaved:
        assert block[0] == (0, 22) and block[mj.body_dofs[m_][0]] == (0, 22)
    else:
        assert (block[0], block[8], block[14]) == ((0, 8), (8, 14), (14, 22))
    floor, pairs = ct_j.build_contact_plan(mj, cfg_j.solver)
    nfloor = sum(4 if f.kind == "disk" else 1 for f in floor)
    assert t.nr == nfloor + 2 and len(pairs) == 2
    for r, f in enumerate(floor):
        _assert_window(t, r, _mask(mj.ancestor_dofs[f.body]))
    w = _words(t)
    for k, p in enumerate(pairs):
        a, b = (set(mj.ancestor_dofs[x]) for x in (p.body_a, p.body_b))
        _assert_window(t, nfloor + k, _mask(a | b))
        assert sum(t.pair_pa[w * k + i] << 32 * i for i in range(w)) == _mask(a)
        assert t.pair_na[k] == len(a - b)
    across = nfloor + [p.geom for p in pairs].index("As")
    assert not _row_mask(t, across) >> mj.body_dofs[m_][0] & 1
    lim = ct_j.build_limit_plan(mj)
    dofs = np.asarray(lim.dof).tolist()
    assert len(dofs) == t.nl and mj.joint_names[dofs[0]] == "Aja"
    for k, d in enumerate(dofs):
        _assert_window(t, t.nr + k, _mask(e for e in mj.ancestor_dofs[mj.dof_body[d]] if e <= d))


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
