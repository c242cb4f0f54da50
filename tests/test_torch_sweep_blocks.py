"""The default class's PGS sweep by each row's own block (csrc/engine_core.h ·
contact_step, limit_step, sweep_limits) on the host twin (the core built
with g++), on Humanoid, FlagrunHarder, Atlas, HalfCheetah and Hopper.

(a) The set-up's Gram entries of each contact row (y_n.y_t1, y_n.y_t2,
    y_t1.y_t2, in its block of the scratch's `crow`) and each limit pair's
    |w|^2 (its second row's block of `lrow`) against float64 dots of the
    twin's own rows of Y (rtol 1e-5 of |a| |b|); the pair's inverse
    diagonal bitwise 1 / (|w|^2 + reg) in float32.
(b) A limit pair's two rows share one row of Y (`ce.limit_seconds`), and
    that row equals, bit for bit, both rows of the layout with a row of Y a
    limit row (`ce.unpaired_limits`), whose two rows are themselves equal
    bit for bit; every contact row's Y too.
(c) The twin's sweeps (a substep with `iterations` 0 leaves the set-up and
    z as the sweeps find them; then run through) against a float64
    Gauss-Seidel in `solve_scalar`'s
    per-direction order (normal, tangents, split impulse; then the limit
    rows) on the same rows, right-hand sides and inverse diagonals: z, zp
    and every multiplier within 1e-5 of their largest magnitude, with the
    model pressed into the floor so that normals and tangents are active.
(d) One sweep runs one butterfly a contact row and one a limit row or pair
    (the twin's count of group sums, `HostTwin.group_sums`), and three a
    contact row and one a limit row in the tree classes' count
    (`ce.sweep_group_sums`); the unpaired layout one a limit row.
(e) One twin env step against env_step_plain, every 3rd env forced to reset,
    within the budgets of tests/test_pallas_equivalence.py (the walkers'
    mean/max |dq| 3e-4 / 1e-2, mean |dobs| 1e-3, median |dreward| 5e-3,
    flips < 1%; the humanoid family's median/mean/max 1.5e-3 / 5e-3 / 8e-2,
    aux median 5e-2), resets bitwise; FlagrunHarder with its cube thrown on
    the step; the large models one substep (their plain step takes seconds
    a substep on a CPU).
(f) Atlas's and Humanoid's operations an env step and bytes an env pinned.
"""

import shutil

import numpy as np
import pytest
import torch

from pybulletgym_tpu_torch import make_task
from pybulletgym_tpu_torch.envs.base import BatchedEnv, env_step_plain
from pybulletgym_tpu_torch.ops import cuda_engine as ce

ATLAS = "AtlasPyBulletEnv-v0"
HUMANOID = "HumanoidPyBulletEnv-v0"
HARDER = "HumanoidFlagrunHarderPyBulletEnv-v0"
CHEETAH = "HalfCheetahPyBulletEnv-v0"
HOPPER = "HopperPyBulletEnv-v0"
IDS = (HUMANOID, ATLAS, CHEETAH, HOPPER)


@pytest.fixture(scope="module")
def twin():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the host twin")
    return ce.HostTwin()


def _ancestors(t, d):
    mask = ce.root_path(t, t.dof_body[d])
    return [e for e in range(d) if mask >> e & 1]


def _support(t, r):
    """Contact row r's dofs in the order Y stores them (body a's path, then
    body b's own)."""
    nfloor = t.nr - t.npair
    a = ce.root_path(t, t.row_body[r] if r < nfloor else t.pair_a[r - nfloor])
    b = 0 if r < nfloor else ce.root_path(t, t.pair_b[r - nfloor])
    bits = lambda m: [d for d in range(t.nv) if m >> d & 1]  # noqa: E731
    return bits(a) + bits(b & ~a)


def _arr(sc, lay, name):
    o, n = lay[name]
    return sc[o:o + n]


# each contact row's block of `crow` and each limit row's of `lrow`
# (engine_core.h · CRow, LRow): the column of each of their scalars
CROW = ("lam_n", "lam_t1", "lam_t2", "lam_p", "b_vel", "b_pos", "dinv_n", "dinv_t1", "dinv_t2",
        "gram_n1", "gram_n2", "gram_12")
LROW = ("lam_l", "b_l", "d_l")


def _rows(sc, lay, t):
    """{scalar: its values by row} from the scratch's crow and lrow blocks."""
    c = _arr(sc, lay, "crow").reshape(t.nr, len(CROW))
    lim = _arr(sc, lay, "lrow").reshape(t.nl, len(LROW))
    out = {k: c[:, i] for i, k in enumerate(CROW)}
    out.update({k: lim[:, i] for i, k in enumerate(LROW)})
    return out


def _pressed(task, seed=5, depth=0.05):
    """A post-reset state moved down until its deepest floor row is `depth`
    into the floor, sliding and sinking (numpy seed), and random torques."""
    s = BatchedEnv(task, 2, device="cpu").reset(seed=seed)
    rng = np.random.default_rng(seed)
    free = task.model.nq != task.model.nv
    v = s.v + torch.from_numpy(rng.uniform(-0.2, 0.2, s.v.shape).astype(np.float32))
    v[3 if free else 0] += 0.4  # along the floor
    v[5 if free else 1] -= 0.5  # into it
    tau = torch.from_numpy(rng.uniform(-1, 1, s.v.shape).astype(np.float32))
    q = s.q.clone()
    t = _tables(task, False)
    lay = ce.scratch_layout(t)
    dep = _arr(ce.HostTwin().physics_scratch(t, q, v.contiguous(), tau), lay, "depth")
    q[2 if free else 1] -= depth - dep[:t.nr - t.npair].max()
    return q.contiguous(), v.contiguous(), tau


def _tables(task, sweeps=True, unpaired=False):
    """One substep's tables; without `sweeps` (iterations 0) a step leaves
    the set-up, and z, as the sweeps would find them."""
    t = ce.pack_physics(task.model, task.physics, frame_skip=1)
    if unpaired:
        t = ce.unpaired_limits(t)
    if not sweeps:
        t.iterations = 0
    return t


@pytest.mark.parametrize("env_id", IDS)
def test_gram_entries(env_id, twin):
    """(a)"""
    task = make_task(env_id)
    t = _tables(task, False)
    lay = ce.scratch_layout(type(t).from_buffer_copy(t))
    sc = twin.physics_scratch(t, *_pressed(task))
    y = sc[lay["Y"][0]:].astype(np.float64)
    rows = _rows(sc, lay, t)
    assert lay["crow"][1] == len(CROW) * t.nr and t.nr > 0 and lay["dinv"][1] == 0
    for r in range(t.nr):
        n = len(_support(t, r))
        yn, y1, y2 = (y[t.path_y[r] + k * n:t.path_y[r] + (k + 1) * n] for k in range(3))
        for k, (a, b) in enumerate(((yn, y1), (yn, y2), (y1, y2))):
            scale = np.linalg.norm(a) * np.linalg.norm(b)
            got = rows[("gram_n1", "gram_n2", "gram_12")[k]][r]
            assert abs(got - a @ b) <= 1e-5 * scale, (r, k)
    second = ce.limit_pairs(t)
    assert sum(second) == t.nl // 2 > 0
    reg = np.float32(t.reg)
    for m in range(1, t.nl):
        if second[m]:
            n = len(_ancestors(t, t.lim_dof[m])) + 1
            w = y[t.path_y[t.nr + m]:t.path_y[t.nr + m] + n]
            np.testing.assert_allclose(rows["d_l"][m], w @ w, rtol=1e-5)
            assert rows["d_l"][m - 1] == np.float32(1) / (rows["d_l"][m] + reg)


@pytest.mark.parametrize("env_id", IDS)
def test_limit_pairs_share_one_row(env_id, twin):
    """(b)"""
    task = make_task(env_id)
    t, u = _tables(task, False), _tables(task, False, unpaired=True)
    assert list(ce.limit_seconds([t.lim_dof[m] for m in range(t.nl)])) == [
        bool(x) for x in ce.limit_pairs(t)]
    assert not any(ce.limit_pairs(u))
    lt = ce.scratch_layout(type(t).from_buffer_copy(t))
    lu = ce.scratch_layout(type(u).from_buffer_copy(u), pair_limits=False)
    last = t.nr + t.nl - 1  # the last limit row's Y offset: half the limit rows' floats before it
    assert t.path_y[last] < u.path_y[last] and lt["Y"][1] <= lu["Y"][1]
    args = _pressed(task)
    yt = twin.physics_scratch(t, *args)[lt["Y"][0]:]
    yu = twin.physics_scratch(u, *args)[lu["Y"][0]:]
    bits = lambda x: x.view(np.uint32)  # noqa: E731
    for r in range(t.nr):
        n = 3 * len(_support(t, r))
        assert t.path_y[r] == u.path_y[r]
        assert np.array_equal(bits(yt[t.path_y[r]:t.path_y[r] + n]),
                              bits(yu[u.path_y[r]:u.path_y[r] + n])), r
    for m in range(t.nl):
        n = len(_ancestors(t, t.lim_dof[m])) + 1
        j = t.nr + m
        if ce.limit_pairs(t)[m]:
            assert t.path_y[j] == t.path_y[j - 1] and t.lim_dof[m] == t.lim_dof[m - 1]
            assert np.array_equal(bits(yu[u.path_y[j]:u.path_y[j] + n]),
                                  bits(yu[u.path_y[j - 1]:u.path_y[j - 1] + n])), m
        assert np.array_equal(bits(yt[t.path_y[j]:t.path_y[j] + n]),
                              bits(yu[u.path_y[j]:u.path_y[j] + n])), m


def _gauss_seidel(t, sc, lay):
    """solve_scalar's sweeps in float64 (t.iterations of them) from the
    set-up in `sc` (a substep without sweeps): each direction's dot after
    the previous update."""
    y = sc[lay["Y"][0]:].astype(np.float64)
    pre = {k: x.astype(np.float64) for k, x in _rows(sc, lay, t).items()}
    rows = []
    for r in range(t.nr):
        dofs = _support(t, r)
        n, off = len(dofs), t.path_y[r]
        dirs = []
        for k in range(3):
            x = np.zeros(t.nv)
            x[dofs] = y[off + k * n:off + (k + 1) * n]
            dirs.append(x)
        rows.append(dirs)
    lims = []
    for m in range(t.nl):
        dofs = _ancestors(t, t.lim_dof[m]) + [t.lim_dof[m]]
        x = np.zeros(t.nv)
        x[dofs] = y[t.path_y[t.nr + m]:t.path_y[t.nr + m] + len(dofs)]
        lims.append(x)
    z, zp = _arr(sc, lay, "z").astype(np.float64), np.zeros(t.nv)
    dinv = np.stack([pre["dinv_n"], pre["dinv_t1"], pre["dinv_t2"]], 1).reshape(-1)
    bv, bp, bl = pre["b_vel"], pre["b_pos"], pre["b_l"]
    second = ce.limit_pairs(t)
    # a pair's inverse diagonal: its first row's
    dl = [pre["d_l"][m - 1] if second[m] else pre["d_l"][m] for m in range(t.nl)]
    lam = {k: np.zeros(t.nr) for k in ("lam_n", "lam_t1", "lam_t2", "lam_p")}
    lam["lam_l"] = np.zeros(t.nl)
    ln, l1, l2, lp, ll = (lam[k] for k in ("lam_n", "lam_t1", "lam_t2", "lam_p", "lam_l"))
    for _ in range(t.iterations):
        for r in range(t.nr):
            yn, y1, y2 = rows[r]
            new = max(ln[r] + (bv[r] - yn @ z) * dinv[3 * r], 0.0)
            z += yn * (new - ln[r])
            ln[r] = new
            hi = float(np.float32(t.row_mu[r])) * new
            new = min(max(l1[r] - (y1 @ z) * dinv[3 * r + 1], -hi), hi)
            z += y1 * (new - l1[r])
            l1[r] = new
            new = min(max(l2[r] - (y2 @ z) * dinv[3 * r + 2], -hi), hi)
            z += y2 * (new - l2[r])
            l2[r] = new
            new = max(lp[r] + (bp[r] - yn @ zp) * dinv[3 * r], 0.0)
            zp += yn * (new - lp[r])
            lp[r] = new
        for m in range(t.nl):
            sign = float(t.lim_sign[m])
            new = max(ll[m] + (bl[m] - sign * (lims[m] @ z)) * dl[m], 0.0)
            z += lims[m] * sign * (new - ll[m])
            ll[m] = new
    return dict(lam, z=z, zp=zp)


@pytest.mark.parametrize("env_id", IDS)
def test_sweeps_match_float64_gauss_seidel(env_id, twin):
    """(c)"""
    task = make_task(env_id)
    args = _pressed(task)
    t = _tables(task, False)
    lay = ce.scratch_layout(type(t).from_buffer_copy(t))
    want = _gauss_seidel(_tables(task), twin.physics_scratch(t, *args), lay)
    got = twin.physics_scratch(_tables(task), *args)
    assert (want["lam_n"] > 0).sum() >= 2 and (want["lam_p"] > 0).sum() >= 2
    assert (want["lam_l"] > 0).any() or t.nl == 0 or env_id == CHEETAH
    if env_id in (HUMANOID, ATLAS):
        assert (want["lam_t1"] != 0).sum() >= 2  # friction active beside the normals
    got = dict(_rows(got, lay, t), z=_arr(got, lay, "z"), zp=_arr(got, lay, "zp"))
    for name, x in want.items():
        err = np.abs(got[name] - x).max()
        assert err <= 1e-5 * max(np.abs(x).max(), 1e-12), (name, err)


@pytest.mark.parametrize("env_id", IDS + (HARDER,))
def test_one_butterfly_a_row(env_id, twin):
    """(d)"""
    task = make_task(env_id)
    args = _pressed(task)
    t, u = _tables(task), _tables(task, unpaired=True)
    pairs = sum(ce.limit_pairs(t))
    assert ce.sweep_group_sums(t) == t.nr + t.nl - pairs and pairs == t.nl // 2
    assert ce.sweep_group_sums(u) == t.nr + t.nl
    twin.group_sums(t)
    twin.physics_scratch(t, *args)
    assert twin.group_sums(t) == t.iterations * (t.nr + t.nl - pairs)
    twin.physics_scratch(u, *args)
    assert twin.group_sums(u) == t.iterations * (t.nr + t.nl)
    # against the per-direction sweep: 3 butterflies a contact row (the
    # normal's two dots shared one) and one a limit row
    want = {HUMANOID: (319, 112), HARDER: (349, 122), ATLAS: (234, 88), CHEETAH: (60, 22),
            HOPPER: (30, 11)}[env_id]
    assert (3 * t.nr + t.nl, ce.sweep_group_sums(t)) == want


def _assert_budget(sh, sp, humanoid):
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


@pytest.mark.parametrize("env_id", (HUMANOID, HARDER, ATLAS, CHEETAH, HOPPER))
def test_twin_step_matches_plain(env_id, twin):
    """(e)"""
    task = make_task(env_id)
    large = env_id in (HUMANOID, HARDER, ATLAS)
    fs = 1 if large else None
    B = 3
    tab, tab0 = ce.pack_tables(task, frame_skip=fs), ce.pack_tables(task, frame_skip=0)
    assert tab.caps_id in (0, 1) and any(ce.limit_pairs(tab))
    s = BatchedEnv(task, B, device="cpu").reset(seed=6)
    forced = torch.zeros(B, dtype=torch.bool)
    forced[::3] = True
    s = s._replace(terminated=forced)
    if env_id == HARDER:  # the cube thrown on this step (frame 120, no get-up count)
        aux = dict(s.aux)
        aux["frame"] = torch.full_like(aux["frame"], 120.0)
        aux["ground_counter"] = torch.zeros_like(aux["ground_counter"])
        s = s._replace(aux=aux)
    a = torch.from_numpy(np.random.default_rng(6).uniform(-1, 1, (task.act_dim, B)).astype(
        np.float32))
    r0h, r0p = twin.env_step(tab0, task, s, a), env_step_plain(task, s, a, frame_skip=0)
    assert torch.equal(r0h.q, r0p.q) and torch.equal(r0h.v, r0p.v)
    sh = twin.env_step(tab, task, s, a)
    sp = env_step_plain(task, s, a, frame_skip=fs)
    if env_id == HARDER:
        cq = slice(task.cube_qadr, task.cube_qadr + 7)
        assert ((sh.q[cq][2] - s.q[cq][2]).abs()[~forced] > 0.05).all()  # thrown
        assert (sh.q[cq] - sp.q[cq]).abs().max() < 1e-3
    _assert_budget(sh, sp, env_id in (HUMANOID, HARDER))


def test_work_and_bytes_pinned():
    """(f) Atlas: 151,335 operations a substep (156,225 with a row of Y a
    limit row and the per-direction sweep), 20,308 bytes an env (Y 2,284
    floats, the contact rows' scalars 696: 12 a row, the Gram entries among
    them); Humanoid: 224,463 and 28,140 (Y 3,820 and 1,140), each env step's
    operations as work_per_env_step counts them"""
    for env_id, want in ((ATLAS, (151335, 613812, 20308, 2284, 696)),
                         (HUMANOID, (224463, 902549, 28140, 3820, 1140))):
        t = ce.pack_tables(make_task(env_id))
        lay = ce.scratch_layout(type(t).from_buffer_copy(t))
        got = (ce.substep_flops(t), ce.work_per_env_step(t)[0], 4 * t.sc_stride, lay["Y"][1],
               lay["crow"][1])
        assert got == want, (env_id, got)
