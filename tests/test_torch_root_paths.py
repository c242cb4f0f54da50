"""The default class's root paths (csrc/engine_core.h · ENG_PATH_FIELDS,
ltl_factor, path_solve_t) on the host twin (the core built with g++), on
Atlas, Humanoid, HalfCheetah and Ant.

(a) The twin's factor of M = L^T L (ancestor rows, a substep stopped after
    the factorization) reproduces the twin's own M (its CRBA rows, a
    substep stopped before the factorization) and the plain version's
    `dynamics.mass_matrix`: L^T L against M within rtol 1e-5 (atol 1e-5 of
    M's largest entry, for the entries that cancel). The factor's dofs are
    the model's in the order of `dof_perm` (a free joint's linear dofs
    first).
(b) Each forward-solved row Y_r = L^-T J_r^T, solved densely in float64 from
    the twin's L and the plain version's contact Jacobians
    (`contacts.scalar_jacobians`) or a limit row's unit vector, is zero off
    the row's root path (its bodies' root paths), and the twin's row,
    stored over that path, equals it there (atol 1e-4 of the row's largest
    entry).
(c) One twin env step against env_step_plain, every 3rd env forced to
    reset: the resets bitwise (frame_skip=0), the twin bitwise repeatable,
    and the family's budget (tests/test_pallas_equivalence.py: the walkers'
    mean/max |dq| 3e-4 / 1e-2, mean |dobs| 1e-3, median |dreward| 5e-3,
    flips < 1%; the humanoid family's median/mean/max 1.5e-3 / 5e-3 / 8e-2,
    aux median 5e-2); Atlas and Humanoid one substep (frame_skip=1), whose
    plain step takes seconds a substep on a CPU.
(d) Atlas's `substep_flops` over root paths, the dense count beside.
(e) Atlas's bytes an env, its L and Y floats.
"""

import shutil

import numpy as np
import pytest
import torch

from pybulletgym_tpu_torch import make_task
from pybulletgym_tpu_torch.envs.base import BatchedEnv, env_step_plain
from pybulletgym_tpu_torch.ops import contacts as ct
from pybulletgym_tpu_torch.ops import cuda_engine as ce
from pybulletgym_tpu_torch.ops import dynamics as dyn

ATLAS = "AtlasPyBulletEnv-v0"
HUMANOID = "HumanoidPyBulletEnv-v0"
IDS = (ATLAS, HUMANOID, "HalfCheetahPyBulletEnv-v0", "AntPyBulletEnv-v0")


@pytest.fixture(scope="module")
def twin():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the host twin")
    return ce.HostTwin()


def _state(task, B=2, seed=5):
    """A post-reset state with random velocities and torques (numpy seed)."""
    s = BatchedEnv(task, B, device="cpu").reset(seed=seed)
    rng = np.random.default_rng(seed)
    v = s.v + torch.from_numpy(rng.uniform(-0.5, 0.5, s.v.shape).astype(np.float32))
    tau = torch.from_numpy(rng.uniform(-1, 1, s.v.shape).astype(np.float32))
    return s.q.contiguous(), v.contiguous(), tau


def _ancestors(t, d):
    """Dof d's ancestors in the dof tree, lowest first."""
    mask = ce.root_path(t, t.dof_body[d])
    return [e for e in range(d) if mask >> e & 1]


def _dense(t, rows):
    """The dense lower triangle of a matrix stored by ancestor rows."""
    out = np.zeros((t.nv, t.nv))
    for d in range(t.nv):
        r = rows[t.anc_row[d]:t.anc_row[d] + t.dof_depth[d] + 1]
        out[d, _ancestors(t, d) + [d]] = r
    return out


def _scratch(twin, task, stop, q, v, tau):
    t = ce.pack_physics(task.model, task.physics, frame_skip=1)
    t.stop_after = stop
    return t, twin.physics_scratch(t, q, v, tau), ce.scratch_layout(t)


def _support(t, r):
    """Contact row r's positions: its dofs in the order Y stores them."""
    nfloor = t.nr - t.npair
    a = ce.root_path(t, t.row_body[r] if r < nfloor else t.pair_a[r - nfloor])
    b = 0 if r < nfloor else ce.root_path(t, t.pair_b[r - nfloor])
    bits = lambda m: [d for d in range(t.nv) if m >> d & 1]  # noqa: E731
    return bits(a) + bits(b & ~a), a | b


def _solve_t(L, b):
    """x = L^-T b by back substitution (float64): no term off a row's path."""
    x = np.zeros_like(b)
    for i in range(len(b) - 1, -1, -1):
        x[i] = (b[i] - L[i + 1:, i] @ x[i + 1:]) / L[i, i]
    return x


@pytest.mark.parametrize("env_id", IDS)
def test_factor_reproduces_m(env_id, twin):
    """(a)"""
    task = make_task(env_id)
    q, v, tau = _state(task)
    t, crba, lay = _scratch(twin, task, 2, q, v, tau)
    _, fact, _ = _scratch(twin, task, 3, q, v, tau)
    o, n = lay["L"]
    M = _dense(t, crba[o:o + n].astype(np.float64))
    M = M + np.tril(M, -1).T
    L = _dense(t, fact[o:o + n].astype(np.float64))
    atol = 1e-5 * np.abs(M).max()
    np.testing.assert_allclose(L.T @ L, M, rtol=1e-5, atol=atol)
    fk = dyn.forward_kinematics(task.model, [q[i] for i in range(t.nq)],
                                [v[i] for i in range(t.nv)])
    plain = np.array([[float(x[0]) if torch.is_tensor(x) else x for x in row]
                      for row in dyn.mass_matrix(task.model, fk)])  # the lower triangle
    perm = list(t.dof_perm[:t.nv])
    assert sorted(perm) == list(range(t.nv)) and all(perm[p] == d for d, p in enumerate(perm))
    plain = plain + np.tril(plain, -1).T
    np.testing.assert_allclose(M, plain[np.ix_(perm, perm)], rtol=1e-5, atol=atol)
    assert n == sum(t.dof_depth[d] + 1 for d in range(t.nv)) < t.nv * t.nv


@pytest.mark.parametrize("env_id", IDS)
def test_rows_stay_on_their_root_paths(env_id, twin):
    """(b)"""
    task = make_task(env_id)
    model = task.model
    q, v, tau = _state(task)
    t, sc, lay = _scratch(twin, task, 0, q, v, tau)
    L = _dense(t, sc[lay["L"][0]:lay["L"][0] + lay["L"][1]].astype(np.float64))
    y = sc[lay["Y"][0]:].astype(np.float64)
    fk = dyn.forward_kinematics(model, [q[i] for i in range(t.nq)], [v[i] for i in range(t.nv)])
    plan = ct.build_contact_plan(model, task.physics.solver)
    J = ct.scalar_jacobians(model, fk, ct.narrowphase_scalar(model, fk, plan))
    assert len(J) == t.nr > 0
    env0 = lambda x: float(x[0]) if torch.is_tensor(x) else float(x)  # noqa: E731
    rows = []
    perm = list(t.dof_perm[:t.nv])  # the factor's dofs (a free joint's linear first)
    for r, row in enumerate(J):
        dofs, path = _support(t, r)
        for k, Jd in enumerate(row):
            rows.append((np.array([env0(x) for x in Jd])[perm], dofs, path,
                         t.path_y[r] + k * len(dofs)))
    for m in range(t.nl):
        d = t.lim_dof[m]
        e = np.zeros(t.nv)
        e[d] = 1.0
        dofs = _ancestors(t, d) + [d]
        rows.append((e, dofs, sum(1 << x for x in dofs), t.path_y[t.nr + m]))
    for b, dofs, path, off in rows:
        x = _solve_t(L, b)
        off_path = [d for d in range(t.nv) if not path >> d & 1]
        assert (x[off_path] == 0).all()
        np.testing.assert_allclose(y[off:off + len(dofs)], x[dofs], rtol=0,
                                   atol=1e-4 * np.abs(x).max())


@pytest.mark.parametrize("env_id", IDS)
def test_twin_step_matches_plain(env_id, twin):
    """(c)"""
    task = make_task(env_id)
    humanoid = env_id == HUMANOID
    fs = 1 if env_id in (ATLAS, HUMANOID) else None
    B = 3
    tab, tab0 = ce.pack_tables(task, frame_skip=fs), ce.pack_tables(task, frame_skip=0)
    assert tab.caps_id in (0, 1) and tab.lanes == ce.pick_lanes(tab.nv)
    s = BatchedEnv(task, B, device="cpu").reset(seed=4)
    forced = torch.zeros(B, dtype=torch.bool)
    forced[::3] = True
    s = s._replace(terminated=forced)
    a = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (task.act_dim, B)).astype(
        np.float32))
    r0h, r0p = twin.env_step(tab0, task, s, a), env_step_plain(task, s, a, frame_skip=0)
    assert torch.equal(r0h.q, r0p.q) and torch.equal(r0h.v, r0p.v)
    sh = twin.env_step(tab, task, s, a)
    again = twin.env_step(tab, task, s, a)
    for name in ("q", "v", "obs", "reward", "terminated"):
        assert torch.equal(getattr(sh, name), getattr(again, name)), name
    sp = env_step_plain(task, s, a, frame_skip=fs)
    dq = (sh.q - sp.q).abs()
    if humanoid:
        assert dq.median() < 1.5e-3 and dq.mean() < 5e-3 and dq.max() < 8e-2, dq.max()
        for k in sp.aux:
            assert (sh.aux[k] - sp.aux[k]).abs().median() < 5e-2, k
    else:
        assert dq.mean() < 3e-4 and dq.max() < 1e-2, dq.max()
        assert (sh.obs - sp.obs).abs().mean() < 1e-3
        assert (sh.reward - sp.reward).abs().median() < 5e-3
    assert (sh.terminated != sp.terminated).float().mean() < 0.01
    for name in ("epoch", "step_count", "truncated"):
        assert torch.equal(getattr(sh, name), getattr(sp, name)), name


def test_atlas_work_over_root_paths():
    """(d) one substep's operations: over root paths (since the sweep by each
    row's block, its Gram entries and limit pairs: 156,225 before), and the
    dense count of the dense Cholesky and rows (4.0x)"""
    t = ce.pack_tables(make_task(ATLAS))
    assert (ce.substep_flops(t), ce.substep_flops(t, dense=True)) == (151335, 600923)
    assert ce.work_per_env_step(t)[0] == 613812


def test_atlas_bytes_an_env():
    """(e) 20,308 bytes an env (48,604 with L and Y dense; 20,932 with a row
    of Y a limit row): L 351 floats (1,332 dense), Y 2,284 (8,695; 2,614),
    the dof records 144 (4 words a dof)"""
    t = ce.pack_tables(make_task(ATLAS))
    lay = ce.scratch_layout(t)
    assert (4 * t.sc_stride, lay["L"][1], lay["Y"][1], lay["dofs"][1]) == (20308, 351, 2284, 144)
    assert max(t.dof_depth[d] for d in range(t.nv)) + 1 == 16 <= ce.tables_type()[1]["PATH_CAP"]
