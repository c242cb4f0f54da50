"""The large, huge and sized classes on the default class's substep
(csrc/engine_core.h: M = L^T L over the dof tree, ltl_factor; each row's
forward solve over its support, path_solve_t, or path_solve_mem past
PATH_CAP; the PGS sweep by each row's window, pgs_sweeps_win) through the
host twin (the core built with g++), on small tree scenes: two Humanoids
(large), three (huge), 22 balls (sized), seven balls moved into the
22 balls' sized build (`ops.cuda_engine.tables_in_class`), the pair scenes of
tests/test_torch_tree_blocks.py with four balls (large) and eight (huge),
a scene whose pair row spans three mask words (huge: the sweep's further
windows) and a chain of 26 hinges on the floor (large: supports past
PATH_CAP, solved in the scratch). One substep (frame_skip 1) at B=2. And
Humanoid's and Atlas's physics step, the same in the large and huge
classes' tables as in the default class's.

(a) The twin's factor (a substep stopped after the factorization) against
    its own M (stopped before it): L^T L within rtol 1e-5 (atol 1e-5 of
    M's largest entry), M against the plain version's
    `dynamics.mass_matrix` in the factor's dof order (`dof_perm`), L stored
    by ancestor rows.
(b) Each forward-solved row Y_r = L^-T J_r^T, solved densely in float64
    from the twin's L and the plain version's contact Jacobians or a limit
    row's unit vector, is zero off the row's support (its bodies' root
    paths) and the twin's row, stored over it, equals it there (atol 1e-4
    of the row's largest entry).
(c) The set-up's Gram entries (y_n.y_t1, y_n.y_t2, y_t1.y_t2) and each limit
    pair's |w|^2 against float64 dots of the twin's rows (rtol 1e-5 of
    |a| |b|); the pair's inverse diagonal bitwise 1 / (|w|^2 + reg).
(d) A limit pair's two rows share one row of Y (`ce.limit_seconds`), equal
    bit for bit to both rows of the layout with a row of Y a limit row
    (`ce.unpaired_limits`); every contact row's Y too.
(e) One sweep runs one butterfly a contact row and one a limit step (the
    twin's count, `HostTwin.group_sums`, and `ce.sweep_group_sums`), a
    pair row over three mask words too.
(f) One physics step of the twin against the plain step: the humanoid
    family's budget (median/mean/max |dq| 1.5e-3 / 5e-3 / 8e-2,
    tests/test_pallas_equivalence.py:80-86), the balls' and the pair
    scenes' mean/max 1e-5 / 1e-2 (as tests/test_torch_sized_models.py holds
    the sized twins), the chain's the walkers' (3e-4 / 1e-2,
    tests/test_pallas_equivalence.py:38-40: 26 coupled contacts, whose
    sums over root paths the PGS iterates amplify as the default class's
    twin does on the same chain); depths within 1e-5; where the JAX
    package's eager substep takes a few seconds on a CPU (the balls and
    the pair scenes; the Humanoids' plain step is held to it by
    tests/test_torch_big_models.py), the same budget against it.
(g) The window fields from the model: each dof's lowest ancestor
    (`dof_lo`, its tree's first dof), each row's support size, its window's
    first and last words and its support's (and a pair row's body a's)
    words in the window, and L's floats over root paths.
"""

import dataclasses
import functools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pybulletgym_tpu.models import mjcf as mjcf_j
from pybulletgym_tpu.ops import contacts as ct_j
from pybulletgym_tpu.ops import step as step_j
from pybulletgym_tpu_torch import make_task
from pybulletgym_tpu_torch.envs.base import BatchedEnv, reset_fn
from pybulletgym_tpu_torch.models import mjcf as mjcf_t
from pybulletgym_tpu_torch.ops import contacts as ct_t
from pybulletgym_tpu_torch.ops import cuda_engine as ce
from pybulletgym_tpu_torch.ops import dynamics as dyn
from pybulletgym_tpu_torch.ops import step as step_t
from test_torch_big_models import _feet_down, _ids, balls_xml, humanoids_xml
from test_torch_tree_blocks import PAIR_SCENES, PAIRS, _blocks_from_jax, _humanoids, _pair_scene
from torch_scenes import WIDE_PAIRS, chain_xml, wide_xml

B = 2
# scene -> (its tables' class, whether the JAX package's eager substep is held)
SCENES = {"humanoids2": (ce.LARGE, False), "humanoids3": (ce.HUGE, False),
          "balls22": (ce.SIZED, True), "balls7_sized": (ce.SIZED, True),
          "large_parsed": (ce.LARGE, True), "parsed": (ce.HUGE, True),
          "wide": (ce.HUGE, True), "chain": (ce.LARGE, False)}
HUMANOIDS = ("humanoids2", "humanoids3")


def _model(name, mod):
    if name.startswith("humanoids"):
        return mod.parse_mjcf(humanoids_xml(int(name[-1])), name)
    if name.startswith("balls"):
        return mod.parse_mjcf(balls_xml(int(name[5:].split("_")[0]), 0.09), "balls")
    if name == "wide":
        return mod.parse_mjcf(wide_xml(), "wide")
    if name == "chain":
        return mod.parse_mjcf(chain_xml(), "chain")
    return _pair_scene(name, mod)


def _cfgs(name):
    """(the JAX package's config, the port's): one substep, the scene's
    self-collision pairs"""
    pairs = WIDE_PAIRS if name == "wide" else PAIRS if name in PAIR_SCENES else None
    return tuple(pkg.PhysicsConfig(frame_skip=1, solver=ct.SolverConfig(
        **({"self_collision_pairs": pairs} if pairs else {})))
                 for pkg, ct in ((step_j, ct_j), (step_t, ct_t)))


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(the torch model, its config, its tables, q, v, tau): a post-reset
    state with the feet 1 cm into the floor (the Humanoids), the balls 1 cm
    under their radius, the pair scenes as parsed; random velocities and
    torques (numpy seeds)."""
    m = _model(name, mjcf_t)
    cfg = _cfgs(name)[1]
    rng = np.random.default_rng(11)
    if name in HUMANOIDS:
        task = _humanoids(int(name[-1]))
        s = _feet_down(task, reset_fn(task, *_ids(B, 5)), 0.01)
        q, v = s.q.contiguous(), s.v + torch.from_numpy(
            rng.uniform(-0.2, 0.2, s.v.shape).astype(np.float32))
    else:
        q = torch.from_numpy(np.repeat(m.qpos0[:, None], B, 1).astype(np.float32))
        v = torch.from_numpy(rng.uniform(-0.5, 0.5, (m.nv, B)).astype(np.float32))
    tau = torch.from_numpy(rng.uniform(-1, 1, (m.nv, B)).astype(np.float32))
    t = ce.pack_physics(m, cfg)
    if name == "balls7_sized":  # in the library of the 22 balls' caps
        assert ce.tables_class(t) == ce.LARGE
        t = ce.tables_in_class(t, ce.SIZED, ce.tables_caps(_scene("balls22")[2]))
    assert ce.tables_class(t) == SCENES[name][0]
    return m, cfg, t, q, v.contiguous(), tau


@pytest.fixture(scope="module")
def twin():
    """The host twin, its libraries of the four classes built at once (g++
    in parallel: about 8 s each on one core)"""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the host twin")
    caps = ce.tables_caps(_scene("balls22")[2])
    ce.Builds([ce.host_job(ce.DEFAULT), ce.host_job(ce.LARGE), ce.host_job(ce.HUGE),
               ce.host_job(ce.SIZED, caps)]).wait()
    return ce.HostTwin()


def _ancestors(t, d):
    mask = ce.root_path(t, t.dof_body[d])
    return [e for e in range(d) if mask >> e & 1]


def _dense(t, rows):
    """The dense lower triangle of a matrix stored by ancestor rows."""
    out = np.zeros((t.nv, t.nv))
    for d in range(t.nv):
        out[d, _ancestors(t, d) + [d]] = rows[t.anc_row[d]:t.anc_row[d] + t.dof_depth[d] + 1]
    return out


def _support(t, r):
    """Contact row r's dofs in the order Y stores them (body a's path, then
    body b's own), and its mask."""
    nfloor = t.nr - t.npair
    a = ce.root_path(t, t.row_body[r] if r < nfloor else t.pair_a[r - nfloor])
    b = 0 if r < nfloor else ce.root_path(t, t.pair_b[r - nfloor])
    bits = lambda m: [d for d in range(t.nv) if m >> d & 1]  # noqa: E731
    return bits(a) + bits(b & ~a), a | b


def _scratch(twin, name, stop=0, tables=None, iterations=None):
    _, _, t, q, v, tau = _scene(name)
    t = type(t).from_buffer_copy(tables if tables is not None else t)
    t.stop_after = stop
    if iterations is not None:
        t.iterations = iterations
    return t, twin.physics_scratch(t, q, v, tau), ce.scratch_layout(type(t).from_buffer_copy(t))


def _arr(sc, lay, name):
    o, n = lay[name]
    return sc[o:o + n]


@pytest.mark.parametrize("name", list(SCENES))
def test_factor_reproduces_m(name, twin):
    """(a)"""
    m, _, _, q, v, _ = _scene(name)
    t, crba, lay = _scratch(twin, name, 2)
    _, fact, _ = _scratch(twin, name, 3)
    o, n = lay["L"]
    M = _dense(t, crba[o:o + n].astype(np.float64))
    M = M + np.tril(M, -1).T
    L = _dense(t, fact[o:o + n].astype(np.float64))
    atol = 1e-5 * np.abs(M).max()
    np.testing.assert_allclose(L.T @ L, M, rtol=1e-5, atol=atol)
    fk = dyn.forward_kinematics(m, [q[i] for i in range(t.nq)], [v[i] for i in range(t.nv)])
    plain = np.array([[float(x[0]) if torch.is_tensor(x) else x for x in row]
                      for row in dyn.mass_matrix(m, fk)])
    perm = list(t.dof_perm[:t.nv])
    assert sorted(perm) == list(range(t.nv)) and all(perm[p] == d for d, p in enumerate(perm))
    plain = plain + np.tril(plain, -1).T
    np.testing.assert_allclose(M, plain[np.ix_(perm, perm)], rtol=1e-5, atol=atol)
    assert n == sum(t.dof_depth[d] + 1 for d in range(t.nv)) < t.nv * t.nv


@pytest.mark.parametrize("name", list(SCENES))
def test_rows_stay_on_their_root_paths(name, twin):
    """(b)"""
    m, cfg, _, q, v, _ = _scene(name)
    t, sc, lay = _scratch(twin, name)
    L = _dense(t, _arr(sc, lay, "L").astype(np.float64))
    y = sc[lay["Y"][0]:].astype(np.float64)
    fk = dyn.forward_kinematics(m, [q[i] for i in range(t.nq)], [v[i] for i in range(t.nv)])
    J = ct_t.scalar_jacobians(m, fk, ct_t.narrowphase_scalar(
        m, fk, ct_t.build_contact_plan(m, cfg.solver)))
    assert len(J) == t.nr > 0
    env0 = lambda x: float(x[0]) if torch.is_tensor(x) else float(x)  # noqa: E731
    perm = list(t.dof_perm[:t.nv])
    rows = []
    for r, row in enumerate(J):
        dofs, path = _support(t, r)
        for k, Jd in enumerate(row):
            rows.append((np.array([env0(x) for x in Jd])[perm], dofs, path,
                         t.path_y[r] + k * len(dofs)))
    for mm in range(t.nl):
        d = t.lim_dof[mm]
        e = np.zeros(t.nv)
        e[d] = 1.0
        dofs = _ancestors(t, d) + [d]
        rows.append((e, dofs, sum(1 << x for x in dofs), t.path_y[t.nr + mm]))
    for b, dofs, path, off in rows:
        x = np.zeros_like(b)
        for i in range(t.nv - 1, -1, -1):  # L^-T b in float64
            x[i] = (b[i] - L[i + 1:, i] @ x[i + 1:]) / L[i, i]
        assert (x[[d for d in range(t.nv) if not path >> d & 1]] == 0).all()
        np.testing.assert_allclose(y[off:off + len(dofs)], x[dofs], rtol=0,
                                   atol=1e-4 * np.abs(x).max())
    if name == "chain":
        assert max(len(_support(t, r)[0]) for r in range(t.nr)) == 26 > ce.tables_type()[1][
            "PATH_CAP"]


CROW = ("lam_n", "lam_t1", "lam_t2", "lam_p", "b_vel", "b_pos", "dinv_n", "dinv_t1", "dinv_t2",
        "gram_n1", "gram_n2", "gram_12")


@pytest.mark.parametrize("name", list(SCENES))
def test_gram_entries(name, twin):
    """(c)"""
    t, sc, lay = _scratch(twin, name, iterations=0)
    y = sc[lay["Y"][0]:].astype(np.float64)
    c = _arr(sc, lay, "crow").reshape(t.nr, len(CROW))
    lrow = _arr(sc, lay, "lrow").reshape(t.nl, 3)
    assert lay["crow"][1] == len(CROW) * t.nr and t.nr > 0 and lay["dinv"][1] == 0
    for r in range(t.nr):
        n = len(_support(t, r)[0])
        yn, y1, y2 = (y[t.path_y[r] + k * n:t.path_y[r] + (k + 1) * n] for k in range(3))
        for k, (a, b) in enumerate(((yn, y1), (yn, y2), (y1, y2))):
            assert abs(c[r, CROW.index("gram_n1") + k] - a @ b) <= (
                1e-5 * np.linalg.norm(a) * np.linalg.norm(b)), (r, k)
    second = ce.limit_pairs(t)
    reg = np.float32(t.reg)
    for m in range(1, t.nl):
        if second[m]:
            n = len(_ancestors(t, t.lim_dof[m])) + 1
            w = y[t.path_y[t.nr + m]:t.path_y[t.nr + m] + n]
            np.testing.assert_allclose(lrow[m, 2], w @ w, rtol=1e-5)
            assert lrow[m - 1, 2] == np.float32(1) / (lrow[m, 2] + reg)


@pytest.mark.parametrize("name", list(SCENES))
def test_limit_pairs_share_one_row(name, twin):
    """(d)"""
    t0 = _scene(name)[2]
    u0 = ce.unpaired_limits(t0)
    t, yt, lt = _scratch(twin, name, iterations=0)
    u, yu, lu = _scratch(twin, name, tables=u0, iterations=0)
    lu = ce.scratch_layout(type(u).from_buffer_copy(u), pair_limits=False)
    yt, yu = yt[lt["Y"][0]:], yu[lu["Y"][0]:]
    second = ce.limit_pairs(t)
    assert list(ce.limit_seconds([t.lim_dof[m] for m in range(t.nl)])) == [bool(x) for x in second]
    assert not any(ce.limit_pairs(u)) and t.lim_steps == t.nl - sum(second)
    assert (sum(second) > 0) == (t.nl > 0) and (t.nl > 0) == (name in HUMANOIDS + (
        "large_parsed", "parsed", "chain"))
    bits = lambda x: x.view(np.uint32)  # noqa: E731
    for r in range(t.nr):
        n = 3 * len(_support(t, r)[0])
        assert t.path_y[r] == u.path_y[r]
        assert np.array_equal(bits(yt[t.path_y[r]:t.path_y[r] + n]),
                              bits(yu[u.path_y[r]:u.path_y[r] + n])), r
    for m in range(t.nl):
        n = len(_ancestors(t, t.lim_dof[m])) + 1
        j = t.nr + m
        if second[m]:
            assert t.path_y[j] == t.path_y[j - 1] and t.lim_dof[m] == t.lim_dof[m - 1]
            assert np.array_equal(bits(yu[u.path_y[j]:u.path_y[j] + n]),
                                  bits(yu[u.path_y[j - 1]:u.path_y[j - 1] + n])), m
        assert np.array_equal(bits(yt[t.path_y[j]:t.path_y[j] + n]),
                              bits(yu[u.path_y[j]:u.path_y[j] + n])), m


@pytest.mark.parametrize("name", list(SCENES))
def test_one_butterfly_a_row(name, twin):
    """(e)"""
    t = _scene(name)[2]
    assert ce.sweep_group_sums(t) == t.nr + t.lim_steps
    twin.group_sums(t)
    _scratch(twin, name)
    assert twin.group_sums(t) == t.iterations * (t.nr + t.lim_steps)
    wide = [j for j in range(t.nr + t.nl) if t.path_w1[j] > t.path_w0[j] + 1]
    assert (wide == [t.nr - 1]) == (name == "wide") and (wide == []) == (name != "wide")


@pytest.mark.parametrize("name", list(SCENES))
def test_twin_step_matches_plain(name, twin):
    """(f)"""
    m, cfg, t, q, v, tau = _scene(name)
    qh, vh, dh = twin.physics_step(t, q, v, tau)
    again = twin.physics_step(t, q, v, tau)
    assert all(torch.equal(a, b) for a, b in zip((qh, vh, dh), again))
    qp, vp, dp = step_t.make_physics_step_plain(m, cfg)[0](q, v, tau)
    refs = [(qp, dp)]
    if SCENES[name][1]:
        mj = _model(name, mjcf_j)
        substep = step_j.make_substep_scalar(mj, _cfgs(name)[0])[0]
        qj, _, dj = (torch.from_numpy(np.stack([np.asarray(x) for x in out])) for out in substep(
            [jnp.asarray(r) for r in q.numpy()], [jnp.asarray(r) for r in v.numpy()],
            [jnp.asarray(r) for r in tau.numpy()]))
        refs.append((qj, dj))
    assert (dh > 0).any()  # in contact
    for qr, dr in refs:
        dq = (qh - qr).abs()
        if name in HUMANOIDS:
            assert dq.median() < 1.5e-3 and dq.mean() < 5e-3 and dq.max() < 8e-2, dq.max()
        else:
            mean = 3e-4 if name == "chain" else 1e-5
            assert dq.mean() < mean and dq.max() < 1e-2, (dq.mean(), dq.max())
        assert (dh - dr).abs().max() < 1e-5


@pytest.mark.parametrize("name", list(SCENES))
def test_window_fields(name):
    """(g)"""
    _, _, t, _, _, _ = _scene(name)
    words = len(t.dof_anc) // len(t.dof_depth)
    mj = _model(name, mjcf_j)
    block = _blocks_from_jax(mj) if name != "chain" else {d: (0, t.nv) for d in range(t.nv)}
    for d in range(t.nv):
        anc = _ancestors(t, d)
        assert t.dof_lo[d] == (anc[0] if anc else d) and block[d][0] <= t.dof_lo[d] <= d
        assert sum(t.dof_anc[words * d + w] << 32 * w for w in range(words)) == sum(
            1 << e for e in anc)
    if name in HUMANOIDS or name.startswith("balls"):  # a tree's first dof
        assert [t.dof_lo[d] for d in range(t.nv)] == [block[d][0] for d in range(t.nv)]
    for j in range(t.nr + t.nl):
        u = sum(t.path_u[words * j + w] << 32 * w for w in range(words))
        assert u and t.path_n[j] == bin(u).count("1")
        first, last = ((u & -u).bit_length() - 1) // 32, (u.bit_length() - 1) // 32
        w0 = min(first, words - 2)
        assert t.path_w0[j] == w0 and t.path_w1[j] == last
        assert t.path_win[2 * j] | t.path_win[2 * j + 1] << 32 == u >> 32 * w0 & (1 << 64) - 1
        if j < t.nr:
            assert u == _support(t, j)[1]
        k = j - (t.nr - t.npair)
        if 0 <= k < t.npair:  # body a's path in the row's window, and its size
            a = ce.root_path(t, t.pair_a[k])
            assert t.pair_win[2 * k] | t.pair_win[2 * k + 1] << 32 == a >> 32 * w0 & (1 << 64) - 1
            assert t.pair_nab[k] == bin(a).count("1")
    lay = ce.scratch_layout(type(t).from_buffer_copy(t))
    assert lay["L"][1] == sum(t.dof_depth[d] + 1 for d in range(t.nv))
    assert lay["dofs"][1] == ce.dof_words(ce.tables_class(t), ce.tables_caps(t)) * t.nv
    assert 4 * t.sc_stride == 4 * ce.buffer_floats(t) and t.sc_stride % ce.Y_ALIGN == 0


def test_chain_and_wide_scenes_classes():
    """The chain's supports (26 dofs) send it past the default class, and
    the wide scene's pair row spans mask words 0 and 2"""
    cfg = _cfgs("chain")[1]
    m = _model("chain", mjcf_t)
    assert m.nv == 26 and ce.caps_class(m, cfg) == ce.CAPS_BIG
    t = _scene("wide")[2]
    r = t.nr - 1
    assert t.npair == 1 and (t.path_w0[r], t.path_w1[r]) == (0, 2) and t.path_n[r] == 12


@pytest.mark.parametrize("size", [ce.LARGE, ce.HUGE])
@pytest.mark.parametrize("env_id", ["HumanoidPyBulletEnv-v0", "AtlasPyBulletEnv-v0"])
def test_global_classes_step_as_the_default(env_id, size, twin):
    """A default-class model's physics step (one substep, from a post-reset
    state with random velocities and torques) in the large and huge
    classes' tables (`tables_in_class`): the same values as the default
    class's (torch.equal: a zero's sign apart), the window sweep's sums
    those of the default class's sweep"""
    task = make_task(env_id)
    t = ce.pack_physics(task.model, dataclasses.replace(task.physics, frame_skip=1))
    s = BatchedEnv(task, B, device="cpu").reset(seed=4)
    rng = np.random.default_rng(4)
    v = (s.v + torch.from_numpy(rng.uniform(-0.5, 0.5, s.v.shape).astype(np.float32)))
    tau = torch.from_numpy(rng.uniform(-1, 1, s.v.shape).astype(np.float32))
    g = ce.tables_in_class(t, size)
    assert ce.tables_class(g) == size and g.lanes == t.lanes
    twin.group_sums(t), twin.group_sums(g)
    want = twin.physics_step(t, s.q.contiguous(), v.contiguous(), tau)
    n = twin.group_sums(t)
    got = twin.physics_step(g, s.q.contiguous(), v.contiguous(), tau)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert twin.group_sums(g) == n == B * t.iterations * (t.nr + t.lim_steps)
