"""Atlas (AtlasPyBulletEnv-v0: a URDF robot, 31 bodies, nq 37, nv 36) on the
port, against the JAX package, at B = 2-4 with eager JAX: a true-CPU XLA
compile of Atlas takes very long (PARITY.md:89), so nothing here is jitted.

(a) the port's URDF loader: every field of the Model for atlas.urdf equals
    the JAX loader's exactly, and so do the task's constants, the contact
    plan (58 point rows on the added floor; 24 box corners at radius 0, the
    feet's 16 among them) and the limit plan (60 rows).
(b) make_physics_step_plain vs one eager JAX `make_substep_scalar` substep
    from a post-reset state with random torques; and, in float64, from a
    state with the right foot pressed into the floor, through the contact
    solve of its 8 box-corner rows (radius 0), where the two agree exactly.
(c) env_step_plain vs the eager JAX kernel body with frame_skip 0 (every
    other env forced to reset: q, the epoch and the step count bitwise),
    and with frame_skip 1 vs that substep followed by the JAX output hook.
(d) termination at the edges of the humanoid alive test (pelvis COM just
    below and above 0.78): the JAX output hook, the port's and the host
    twin agree exactly.
(e) the shipped trainstate loads leaf for leaf (obs 70, act 30).

Bounds: mean |dq| < 1e-5 and |d depth| < 1e-5 where the same float32
formulas run in the same order; the walkers' budget elsewhere
(tests/test_pallas_equivalence.py:38-40). test_torch_atlas_twin.py holds
the kernels' C++.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybulletgym_tpu as pg
from pybulletgym_tpu.models.urdf import load_urdf as load_urdf_j
from pybulletgym_tpu.ops import contacts as ct_j
from pybulletgym_tpu.ops import step as step_j
from pybulletgym_tpu_torch import make_task
from pybulletgym_tpu_torch.envs.base import env_step_plain
from pybulletgym_tpu_torch.models.assets import asset_path
from pybulletgym_tpu_torch.models.urdf import load_urdf as load_urdf_t
from pybulletgym_tpu_torch.ops import contacts as ct_t
from pybulletgym_tpu_torch.ops import cuda_engine as ce
from pybulletgym_tpu_torch.ops.step import make_physics_step_plain
from pybulletgym_tpu_torch.utils.interop import (
    env_state_from_numpy, env_state_to_numpy, train_state_from_npz,
)
from test_torch_engine import _jax_kernel_body, _jax_reset
from test_torch_atlas_twin import _right_foot_pressed
from test_torch_humanoid import _at_height, _reset
from test_torch_models import _same

ATLAS = "AtlasPyBulletEnv-v0"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tasks():
    return pg.make_task(ATLAS), make_task(ATLAS)


@pytest.fixture(scope="module")
def substep1(tasks):
    """One eager JAX substep (the slow part of this file, ~12 s) from a
    post-reset state (B=2) with random actions, shared by (b) and (c)."""
    tj, tt = tasks
    s = env_state_to_numpy(_reset(tt, 2, 9))
    a = np.random.default_rng(9).uniform(-1, 1, (tt.act_dim, 2)).astype(np.float32)
    tau = np.zeros((tt.model.nv, 2), np.float32)
    tau[tt.act_dofs] = tt.gains * a
    substep, _, n_rows = step_j.make_substep_scalar(tj.model, tj.physics)
    out = substep([jnp.asarray(r) for r in s["q"]], [jnp.asarray(r) for r in s["v"]],
                  [jnp.asarray(r) for r in tau])
    qj, vj, dj = ([np.asarray(x) for x in part] for part in out)
    return s, a, tau, n_rows, (qj, vj, dj)


def test_urdf_model_equal():
    """(a) the loader alone, then the task's model (with the added floor)"""
    path = asset_path("atlas.urdf")
    for kw in ({"root_free": True}, {"root_free": True, "root_pos": (0.0, 0.0, 0.95)}):
        mj, mt = load_urdf_j(path, **kw), load_urdf_t(path, **kw)
        assert sorted(mj.__dataclass_fields__) == sorted(mt.__dataclass_fields__)
        for f in mj.__dataclass_fields__:
            _same(getattr(mj, f), getattr(mt, f), f)
    assert (len(mt.bodies), mt.nq, mt.nv, len(mt.actuators)) == (31, 37, 36, 30)
    assert [a.gear for a in mt.actuators] == [a.gear for a in mj.actuators]  # gear = effort
    assert sorted(d for d in mt.ancestor_dofs[mt.body_index("r_foot")]) == [*range(6), *range(30, 36)]


def test_task_and_plans_equal(tasks):
    """(a) the task: the floor geom, feet, parts, gains and ranges, initial
    z; the contact and limit plans"""
    tj, tt = tasks
    _same(tj.model.geoms, tt.model.geoms, "geoms")
    assert tt.model.geoms[-1].name == "floor" and tt.model.geoms[-1].body == -1
    assert tt.foot_rows == tj.foot_rows == (tuple(range(50, 58)), tuple(range(37, 45)))
    assert tt.base_body == tj.base_body == tt.model.body_index("pelvis")
    _same(tj.part_frames, tt.part_frames, "part_frames")
    for name in ("gains", "act_dofs", "act_qadr", "j_mid", "j_halfrange"):
        np.testing.assert_array_equal(getattr(tj, name), getattr(tt, name), err_msg=name)
    assert (tt.obs_dim, tt.act_dim, tt.max_episode_steps) == (70, 30, 1000)
    assert tt.initial_z == tj.initial_z and tt.spec.root_height == tj.spec.root_height == 0.95
    pj = ct_j.build_contact_plan(tj.model, tj.physics.solver)
    pt = ct_t.build_contact_plan(tt.model, tt.physics.solver)
    assert [tuple(c) for c in pj[0]] == [tuple(c) for c in pt[0]] and pt[1] == pj[1] == []
    assert ct_t.plan_rows(pt) == 58 and ct_t.plan_row_geoms(pt) == ct_j.plan_row_geoms(pj)
    corners = [r for r, c in enumerate(pt[0]) if c.radius == 0.0]  # the three boxes'
    assert len(corners) == 24 and all(c.kind == "point" for c in pt[0])
    assert set(tt.foot_rows[0] + tt.foot_rows[1]) <= set(corners)
    lj, lt = ct_j.build_limit_plan(tj.model), ct_t.build_limit_plan(tt.model)
    for f in lj._fields:
        np.testing.assert_array_equal(getattr(lj, f), getattr(lt, f))
    assert lt.dof.shape == (60,)


def test_physics_step_plain_matches_jax(tasks, substep1):
    """(b) one substep"""
    _, tt = tasks
    s, _, tau, n_rows, (qj, vj, dj) = substep1
    cfg1 = dataclasses.replace(tt.physics, frame_skip=1)
    q2, v2, d2 = make_physics_step_plain(tt.model, cfg1)[0](
        torch.from_numpy(s["q"]), torch.from_numpy(s["v"]), torch.from_numpy(tau))
    assert n_rows == 58 and d2.shape == (58, 2)
    dq = np.abs(np.stack(qj) - q2.numpy())
    assert dq.mean() < 1e-5 and dq.max() < 1e-2, (dq.mean(), dq.max())
    assert np.abs(np.stack(dj) - d2.numpy()).max() < 1e-5
    dv = np.abs(np.stack(vj) - v2.numpy())
    assert np.median(dv) < 1e-3 and dv.mean() < 1e-4, (np.median(dv), dv.mean())


def test_pressed_foot_substep_matches_jax_in_float64(tasks):
    """(b) The right foot 3 mm into the floor, random torques: its corner
    rows are active in both envs, and the plain step equals JAX's substep.
    In float32 the two part by float32 round-off that the contact solve
    amplifies (a few 1e-3 in v, |v| up to 57); in float64 the same
    formulas agree to round-off of that precision."""
    tj, tt = tasks
    q, v = _right_foot_pressed(tt, 2)
    a = np.random.default_rng(9).uniform(-1, 1, (tt.act_dim, 2))
    tau = np.zeros((tt.model.nv, 2))
    tau[tt.act_dofs] = tt.gains * a
    q, v = q.numpy().astype(np.float64), v.numpy().astype(np.float64)
    substep = step_j.make_substep_scalar(tj.model, tj.physics)[0]
    with jax.enable_x64(True):
        out = substep(*([jnp.asarray(r, jnp.float64) for r in x] for x in (q, v, tau)))
        qj, vj, dj = (np.stack([np.asarray(x) for x in part]) for part in out)
    assert vj.dtype == np.float64
    cfg1 = dataclasses.replace(tt.physics, frame_skip=1)
    q2, v2, d2 = make_physics_step_plain(tt.model, cfg1)[0](
        torch.from_numpy(q), torch.from_numpy(v), torch.from_numpy(tau))
    assert v2.dtype == torch.float64
    right = list(tt.foot_rows[0])
    assert (dj[right] > 0).any(0).all() and (d2.numpy()[right] > 0).any(0).all()
    assert np.abs(dj - d2.numpy()).max() < 1e-12
    assert np.abs(qj - q2.numpy()).max() < 1e-12
    assert np.abs(vj - v2.numpy()).max() < 1e-9, np.abs(vj - v2.numpy()).max()


def test_env_step_plain_reset_matches_jax_kernel_body(tasks):
    """(c) frame_skip=0: envs 0 and 2 forced to reset (env 0's epoch wraps)"""
    tj, tt = tasks
    B = 4
    sj = env_state_to_numpy(_reset(tt, B, 21))
    sj["terminated"] = np.array([True, False, True, False])
    sj["epoch"] = np.array([2**32 - 1, 7, 0, 3], np.uint32)
    sj["step_count"] = np.array([17, 40, 3, 999], np.int32)
    a = np.random.default_rng(21).uniform(-1.5, 1.5, (tt.act_dim, B)).astype(np.float32)
    rj = _jax_kernel_body(tj, sj, a, frame_skip=0)
    rt = env_step_plain(tt, env_state_from_numpy(sj, device="cpu"), torch.from_numpy(a),
                        frame_skip=0)
    np.testing.assert_array_equal(rj["q"], rt.q.numpy())  # reset draws bitwise
    for k in ("epoch", "step_count", "terminated", "truncated"):
        np.testing.assert_array_equal(rj[k], getattr(rt, k).numpy(), err_msg=k)
    assert rt.epoch.tolist() == [0, 7, 1, 3] and rt.truncated.tolist() == [False] * 3 + [True]
    for k in ("initial_z", "target_x", "target_y"):
        np.testing.assert_array_equal(rj["aux"][k], rt.aux[k].numpy(), err_msg=k)
    np.testing.assert_allclose(rj["aux"]["potential"], rt.aux["potential"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(rj["obs"], rt.obs.numpy(), atol=1e-5)
    np.testing.assert_allclose(rj["reward"], rt.reward.numpy(), atol=1e-3)


def test_env_step_plain_substep_matches_jax(tasks, substep1):
    """(c) frame_skip=1, no reset: the JAX substep, then its output hook"""
    tj, tt = tasks
    s, a, _, n_rows, (qj, vj, dj) = substep1
    ids = tuple(jnp.asarray(s[k]) for k in ("seed", "env_id", "epoch"))
    aj = [jnp.clip(jnp.asarray(x), -1.0, 1.0) for x in a]
    obs, reward, term, aux2, _ = tj.output_scalar(
        [jnp.asarray(x) for x in qj], [jnp.asarray(x) for x in vj],
        [jnp.asarray(x) for x in dj], aj, {k: jnp.asarray(x) for k, x in s["aux"].items()}, ids)
    rt = env_step_plain(tt, env_state_from_numpy(s, device="cpu"), torch.from_numpy(a),
                        frame_skip=1)
    dq = np.abs(np.stack(qj) - rt.q.numpy())
    assert dq.mean() < 1e-5 and dq.max() < 1e-2, (dq.mean(), dq.max())
    dobs = np.abs(np.stack([np.asarray(x) for x in obs]) - rt.obs.numpy())
    assert dobs.mean() < 1e-3, dobs.mean()
    assert np.median(np.abs(np.asarray(reward) - rt.reward.numpy())) < 5e-3
    np.testing.assert_array_equal(np.asarray(term), rt.terminated.numpy())
    for k in aux2:
        np.testing.assert_allclose(np.asarray(aux2[k]), rt.aux[k].numpy(), rtol=1e-5, atol=1e-4)


def test_termination_matches_jax_and_the_twin(tasks):
    """(d) The pelvis COM just below and above 0.78: the JAX package's
    output hook, the port's and the host twin (the kernels' C++,
    frame_skip 0: outputs on the given state) agree on termination exactly
    and on alive and reward to float32 round-off."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the host twin")
    tj, tt = tasks
    B = 4
    z, want = [0.77, 0.78 - 1e-5, 0.78 + 1e-5, 0.79], [1, 1, 0, 0]
    s = _at_height(tt, B, 31, z)
    n_rows = len(step_j.sc_rows(ct_j.build_contact_plan(tj.model, tj.physics.solver)))
    ids = (s["seed"], s["env_id"], s["epoch"])
    oj = tj.output_scalar([jnp.asarray(x) for x in s["q"]], [jnp.asarray(x) for x in s["v"]],
                          [jnp.zeros(B)] * n_rows, [jnp.zeros(B)] * tj.act_dim,
                          {k: jnp.asarray(x) for k, x in s["aux"].items()},
                          tuple(jnp.asarray(x) for x in ids))
    zt = torch.zeros(B)
    ot = tt.output_scalar(list(torch.from_numpy(s["q"])), list(torch.from_numpy(s["v"])),
                          [zt] * n_rows, [zt] * tt.act_dim,
                          {k: torch.from_numpy(x) for k, x in s["aux"].items()},
                          tuple(torch.from_numpy(x.astype(np.int64)) for x in ids))
    oh = ce.HostTwin().env_step(ce.pack_tables(tt, frame_skip=0), tt,
                                env_state_from_numpy(s, device="cpu"), torch.zeros((tt.act_dim, B)))
    term = {"jax": np.asarray(oj[2]), "port": ot[2].numpy(), "twin": oh.terminated.numpy()}
    for k, x in term.items():
        np.testing.assert_array_equal(x, np.array(want, bool), err_msg=k)
    alive_j = np.asarray(oj[4]["alive"])
    np.testing.assert_array_equal(alive_j, [-1.0, -1.0, 2.0, 2.0])
    np.testing.assert_allclose(ot[4]["alive"].numpy(), alive_j, atol=1e-6)
    np.testing.assert_allclose(oh.rewards["alive"].numpy(), alive_j, atol=1e-6)
    np.testing.assert_allclose(ot[1].numpy(), np.asarray(oj[1]), atol=1e-3)
    np.testing.assert_allclose(oh.reward.numpy(), np.asarray(oj[1]), atol=1e-3)


def test_shipped_trainstate_loads():
    """(e) the PPO checkpoint's leaves, in the JAX flatten order"""
    path = os.path.join(ROOT, "examples", "weights", f"{ATLAS}.trainstate.npz")
    ts, _ = train_state_from_npz(path, device="cpu")
    leaves = ts.params.leaves()
    assert tuple(leaves[0].shape) == (70, 256) and tuple(leaves[-1].shape) == (30,)
    assert tuple(ts.obs_stats.mean.shape) == (70,)
    with np.load(path) as d:
        for k, x in enumerate(leaves):
            np.testing.assert_array_equal(x.detach().numpy(), d[f"leaf_{k}"], err_msg=str(k))


def golden_witness(n_steps, out=None, log=print):
    """The TPU golden's rollout (B=2, seed 1234, its actions) in float32
    three ways on the host CPU: the eager JAX kernel body (the formulas of
    the XLA path that recorded the golden, without the TPU's bf16
    products), the port's plain step and the host twin. Logs, for each
    step, median |dobs| of each against the golden and of the port against
    JAX. The JAX rollout's obs, reward and terminated are returned and,
    given `out`, saved there after every step in the goldens' format."""
    tj, tt = pg.make_task(ATLAS), make_task(ATLAS)
    g = np.load(os.path.join(ROOT, "tests", "goldens", f"{ATLAS}.npz"))
    B, seed = int(g["batch"]), int(g["seed"])
    acts = np.random.default_rng(seed).uniform(
        -1, 1, (int(g["n_steps"]), B, tt.act_dim)).astype(np.float32)
    sj = _jax_reset(tj, B, seed)
    sp = env_state_from_numpy(sj, device="cpu")
    st = sp
    tab = ce.pack_tables(tt)
    twin = ce.HostTwin()
    rec = {"obs": [], "reward": [], "terminated": []}
    for t in range(n_steps):
        rj = _jax_kernel_body(tj, sj, acts[t].T, frame_skip=tt.physics.frame_skip)
        sj = dict(sj, **{k: rj[k] for k in ("q", "v", "aux", "terminated", "truncated",
                                             "step_count", "epoch")})
        a = torch.from_numpy(acts[t].T.copy())
        sp, st = env_step_plain(tt, sp, a), twin.env_step(tab, tt, st, a)
        med = {k: float(np.median(np.abs(o - g["obs"][t])))
               for k, o in (("jax", rj["obs"]), ("plain", sp.obs.numpy()), ("twin", st.obs.numpy()))}
        d = np.abs(sp.obs.numpy() - rj["obs"])
        log(f"step {t + 1}: median |dobs| vs golden jax {med['jax']:.3e} plain {med['plain']:.3e} "
            f"twin {med['twin']:.3e}; plain vs jax median {np.median(d):.3e} max {d.max():.3e} "
            f"max |dq| {np.abs(sp.q.numpy() - rj['q']).max():.3e} "
            f"max |dv| {np.abs(sp.v.numpy() - rj['v']).max():.3e}; "
            f"terminated jax {rj['terminated'].tolist()} golden {g['terminated'][t].tolist()}")
        for k in rec:
            rec[k].append(rj[k])
        if out is not None:
            np.savez_compressed(out, **{k: np.stack(x) for k, x in rec.items()},
                                seed=seed, n_steps=t + 1, batch=B,
                                source="pybulletgym_tpu, eager kernel body, float32",
                                platform="cpu")
    return {k: np.stack(x) for k, x in rec.items()}


if __name__ == "__main__":
    # PYTHONPATH=.:tests python tests/test_torch_atlas.py [n_steps [out.npz]]:
    # golden_witness above (about a minute a step: eager JAX)
    import sys

    golden_witness(int(sys.argv[1]) if len(sys.argv) > 1 else 5,
                   sys.argv[2] if len(sys.argv) > 2 else None,
                   log=lambda m: print(m, flush=True))
