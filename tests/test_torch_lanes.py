"""The lane-group core of the CUDA kernels (csrc/engine_core.h), on the host
twin at every group width G that the libraries are built for
(ops/cuda_engine.py · LANE_WIDTHS).

The host twin emulates an env's G lanes: each parallel phase runs once per
lane, and the PGS sweep's dot products sum the lanes' partials through the
card's xor butterfly in the card's order. So these tests hold the kernels'
own arithmetic, reduction order included, at each width:

(a) two env steps (B=4, every 3rd env forced to reset before the first) vs
    env_step_plain on HalfCheetah (hinge and slide joints), Ant (a free
    root, dense M), Humanoid (66 pair rows, nv=23 over narrow groups),
    Pusher (disk rows, empty aux) and Reacher (no contact rows, nv=4 under
    wide groups). Bounds, PERF.md §2 (test_pallas_equivalence.py:38-51 and
    :80-86): the walkers and the fixed-base family mean |dq| < 3e-4, max
    < 1e-2, obs mean < 1e-3, reward median < 5e-3; the humanoid family
    median/mean/max |dq| < 1.5e-3 / 5e-3 / 8e-2, aux median < 5e-2;
    termination flips < 1%; epoch, step count and truncation exact. The
    post-reset q and v (frame_skip=0) are bitwise the plain version's at
    every width, and two twin calls on the same inputs agree bitwise.
(b) the scratch layout that the wrapper computes from each model's sizes
    fits one block's 227 KB of shared memory for all 26 IDs, its arrays are
    disjoint where they are live together, and a model over the tables'
    caps raises.
(c) the dofs each width's library holds (engine_core.h · lane_nv: its
    lanes' dof vectors are sized by it): pick_lanes gives every model the
    narrowest width that holds it, Atlas's 36 dofs two chunks at G=32, and
    the launch refuses tables of more dofs than their width holds.
    test_torch_atlas_twin.py runs the twin at G=32 on Atlas.
"""

import shutil

import numpy as np
import pytest
import torch

from pybulletgym_tpu_torch import make_batched, make_task
from pybulletgym_tpu_torch.api.registry import registry
from pybulletgym_tpu_torch.envs.base import env_step_plain
from pybulletgym_tpu_torch.ops import cuda_engine as ce

MODELS = ("HalfCheetahPyBulletEnv-v0", "AntPyBulletEnv-v0", "HumanoidPyBulletEnv-v0",
          "PusherPyBulletEnv-v0", "ReacherPyBulletEnv-v0")
HUMANOIDS = ("HumanoidPyBulletEnv-v0",)
B = 4


@pytest.fixture(scope="module")
def twin():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the host twin")
    return ce.HostTwin()


@pytest.fixture(scope="module")
def plain_runs():
    """Per model: the inputs of two env steps and the plain version's
    outputs, computed once for every width."""
    cache = {}

    def get(env_id):
        if env_id not in cache:
            task = make_task(env_id)
            s0 = make_batched(env_id, B, device="cpu").reset(seed=5)
            forced = torch.zeros(B, dtype=torch.bool)
            forced[::3] = True
            s0 = s0._replace(terminated=forced)
            rng = np.random.default_rng(5)
            acts = [torch.from_numpy(rng.uniform(-1, 1, (task.act_dim, B)).astype(np.float32))
                    for _ in range(2)]
            reset = env_step_plain(task, s0, acts[0], frame_skip=0)
            s1 = env_step_plain(task, s0, acts[0])
            s2 = env_step_plain(task, s1, acts[1])
            cache[env_id] = (task, s0, acts, reset, (s1, s2))
        return cache[env_id]

    return get


def _bounds(a, b, humanoid):
    dq = (a.q - b.q).abs()
    if humanoid:
        assert dq.median() < 1.5e-3 and dq.mean() < 5e-3 and dq.max() < 8e-2, dq.max()
        for k in b.aux:
            assert (a.aux[k] - b.aux[k]).abs().median() < 5e-2, k
    else:
        assert dq.mean() < 3e-4 and dq.max() < 1e-2, dq.max()
        assert (a.obs - b.obs).abs().mean() < 1e-3
        assert (a.reward - b.reward).abs().median() < 5e-3
    assert (a.terminated != b.terminated).float().mean() < 0.01
    for name in ("epoch", "step_count", "truncated"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _tables(task, G, frame_skip=None):
    t = ce.pack_tables(task, frame_skip)
    t.lanes = G
    return t


@pytest.mark.parametrize("G", ce.LANE_WIDTHS)
@pytest.mark.parametrize("env_id", MODELS)
def test_lane_group_env_step_matches_plain(env_id, G, twin, plain_runs):
    task, s0, acts, reset_p, plain = plain_runs(env_id)
    reset_h = twin.env_step(_tables(task, G, frame_skip=0), task, s0, acts[0])
    assert torch.equal(reset_h.q, reset_p.q) and torch.equal(reset_h.v, reset_p.v)
    tab = _tables(task, G)
    sh = s0
    for t, sp in enumerate(plain):
        out = twin.env_step(tab, task, sh, acts[t])
        again = twin.env_step(tab, task, sh, acts[t])
        for name in ("q", "v", "obs", "reward", "terminated"):
            assert torch.equal(getattr(out, name), getattr(again, name)), name
        _bounds(out, sp, env_id in HUMANOIDS)
        sh = out


@pytest.mark.parametrize("G", ce.LANE_WIDTHS)
def test_lane_group_physics_step_matches_plain(G, twin):
    """The physics kernel's body on Ant (the free root) at each width"""
    task = make_task("AntPyBulletEnv-v0")
    s = make_batched("AntPyBulletEnv-v0", B, device="cpu").reset(seed=6)
    a = np.random.default_rng(6).uniform(-1, 1, (task.act_dim, B)).astype(np.float32)
    tau = torch.zeros((task.model.nv, B))
    tau[task.act_dofs] = torch.from_numpy(task.gains * a)
    tab = ce.pack_physics(task.model, task.physics)
    tab.lanes = G
    phys = ce.make_cuda_physics_step(task.model, task.physics)[0]
    qp, vp, dp = phys(s.q, s.v, tau)  # CPU tensors: the plain version
    qh, vh, dh = twin.physics_step(tab, s.q, s.v, tau)
    dq = (qp - qh).abs()
    assert dq.mean() < 3e-4 and dq.max() < 1e-2
    assert ((dp > 0) != (dh > 0)).float().mean() < 0.01
    assert phys.launches == 0


@pytest.mark.parametrize("env_id", sorted(registry))
def test_scratch_layout_fits_a_block(env_id):
    task = make_task(env_id)
    t = ce.pack_tables(task)
    layout = ce.scratch_layout(t)
    assert t.lanes == ce.pick_lanes(t.nv) and t.lanes in ce.LANE_WIDTHS
    assert t.sc_stride % 2 == 1 and t.sc_ld % 2 == 1 and t.sc_ld >= t.nv
    assert 4 * t.sc_stride <= ce.MAX_SHARED_BYTES
    assert list(t.sc[:len(layout)]) == [layout[k][0] for k in ce.scratch_slots()]
    # the arrays live together are disjoint and inside the stride; inert,
    # avp, f and obs lie in Y's rows 1.. (dead while they are live)
    y0, ny = layout["Y"]
    aliased = ("inert", "avp", "f", "obs")
    spans = sorted((o, o + n) for k, (o, n) in layout.items() if k not in aliased and n)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])) and spans[-1][1] <= t.sc_stride
    for k in aliased:
        o, n = layout[k]
        assert y0 + t.sc_ld <= o and o + n <= y0 + ny, k
    # Y holds the dynamics row and every row over its root-path support: a
    # contact row's three directions over its bodies' paths, a limit row
    # over its dof's ancestors and the dof (a limit pair's two rows one)
    nfloor = t.nr - t.npair
    paths = [ce.root_path(t, t.row_body[r]) if r < nfloor else
             ce.root_path(t, t.pair_a[r - nfloor]) | ce.root_path(t, t.pair_b[r - nfloor])
             for r in range(t.nr)]
    second = ce.limit_pairs(t)
    lims = sum(t.dof_depth[t.lim_dof[m]] + 1 for m in range(t.nl) if not second[m])
    assert ny >= t.sc_ld + 3 * sum(bin(p).count("1") for p in paths) + lims


def test_scratch_layout_refuses_what_does_not_fit():
    task = make_task("HumanoidFlagrunHarderPyBulletEnv-v0")
    t = ce.pack_tables(task)
    t.nr = 700  # a model whose constraint rows would not fit one block
    with pytest.raises(NotImplementedError, match="shared memory"):
        ce.scratch_layout(t)


def test_lane_bound_per_width():
    """(c)"""
    _, caps = ce.tables_type()
    assert [ce.lane_nv(G) for G in ce.LANE_WIDTHS] == [4, 12, 16, caps["MAX_NV"]]
    for nv in range(1, caps["MAX_NV"] + 1):
        G = ce.pick_lanes(nv)
        assert nv <= ce.lane_nv(G) and all(nv > ce.lane_nv(w) for w in ce.LANE_WIDTHS if w < G)
    with pytest.raises(NotImplementedError, match="exceed"):
        ce.pick_lanes(caps["MAX_NV"] + 1)
    atlas = ce.pack_tables(make_task("AtlasPyBulletEnv-v0"))
    assert (atlas.nv, atlas.lanes) == (36, 32) and -(-atlas.nv // 32) == 2 <= -(-caps["MAX_NV"] // 32)
    humanoid = ce.pack_tables(make_task("HumanoidPyBulletEnv-v0"))
    humanoid.lanes = 16  # 23 dofs: the library of 16 lanes holds 16
    with pytest.raises(ValueError, match="23 dofs exceed"):
        ce.launch_config(humanoid, "env_step_kernel")
