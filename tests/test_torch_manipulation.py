"""The manipulators (Reacher, Pusher, Striker, Thrower) on the port, against
the JAX package, at small sizes (B = 2-3, eager JAX).

(a) every hook of each task against the JAX task on the same numpy-made
    inputs: initial_state_scalar bitwise (q, v and the draws; aux to 1e-6
    relative), action_tau_scalar exact, output_scalar (obs to 1e-6; reward,
    aux and reward components to 1e-5; termination exact). The inputs reach the
    tasks' branches: Striker's arm within 0.1 of the ball and a struck
    ball, Thrower's ball below -0.25 and one that fell earlier.
(b) env_step_plain vs the eager JAX kernel body (test_torch_engine.
    _jax_kernel_body) with frame_skip 0 (a forced reset: reset q, epoch and
    step count bitwise) and 1 (mean |dq| < 1e-5, the walkers' bound of
    test_torch_humanoid.py; obs to 1e-4, reward to 1e-3).
(c) make_physics_step_plain vs one eager JAX substep, mean |dq| < 1e-5 and
    depths to 1e-5: on Pusher with the object cylinder pressed 5 mm into
    the table (its disk rows touch; its axis stands on the plane, so the
    rim directions take the degenerate branch), and on HalfCheetah with
    `bthigh` made a cylinder whose slanted rim touches the floor (the
    regular branch).
test_torch_manipulation_twin.py holds the kernels' C++ to the plain version.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybulletgym_tpu as pg
from pybulletgym_tpu.envs import locomotion as loco_j
from pybulletgym_tpu.models.schema import GeomType as GeomType_j
from pybulletgym_tpu.ops import step as step_j
from pybulletgym_tpu_torch import make_task
from pybulletgym_tpu_torch.envs import locomotion as loco_t
from pybulletgym_tpu_torch.envs.base import env_step_plain, reset_fn
from pybulletgym_tpu_torch.envs.locomotion import _qadr
from pybulletgym_tpu_torch.envs.manipulation import _world
from pybulletgym_tpu_torch.models.schema import GeomType, JointType
from pybulletgym_tpu_torch.ops import dynamics as dyn_t
from pybulletgym_tpu_torch.ops.step import make_physics_step_plain
from pybulletgym_tpu_torch.utils.interop import env_state_from_numpy, env_state_to_numpy
from test_torch_engine import _jax_kernel_body, disk_touch_state, disked_cheetah

REACHER = "ReacherPyBulletEnv-v0"
PUSHER = "PusherPyBulletEnv-v0"
STRIKER = "StrikerPyBulletEnv-v0"
THROWER = "ThrowerPyBulletEnv-v0"
ARMS = (PUSHER, STRIKER, THROWER)


def ids_np(B, seed=11):
    """(seed, env_id, epoch) as numpy; the last epoch is 2^32 - 1."""
    epoch = np.array([0, 7, 2**32 - 1, 3][:B], np.uint32)
    return np.full(B, seed, np.uint32), np.arange(B, dtype=np.int32), epoch


def _j(xs):
    return tuple(jnp.asarray(x) for x in xs)


def _t(xs):
    return tuple(torch.from_numpy(np.asarray(x).astype(np.int64)) for x in xs)


def _rows(xs):
    return np.stack([np.asarray(x, np.float32) * np.ones(1, np.float32) for x in xs])


def _reset_np(tt, B, seed=11):
    return env_state_to_numpy(reset_fn(tt, *(torch.from_numpy(x) for x in ids_np(B, seed))))


def _near_ball(tt, s):
    """Env 0 of the numpy state `s` with the arm in a pose whose tips hang
    within 0.05 of the object's height, and the object slid under them."""
    m = tt.model
    rng = np.random.default_rng(0)
    n = 4096
    qs = np.repeat(s["q"][:, :1], n, 1)
    lo, hi = m.jnt_range[tt.arm_dofs, 0], m.jnt_range[tt.arm_dofs, 1]
    qs[tt.arm_qadr] = rng.uniform(lo[:, None], hi[:, None], (len(lo), n)).astype(np.float32)
    fk = dyn_t.forward_kinematics(m, list(torch.from_numpy(qs)),
                                  list(torch.zeros((m.nv, n))), with_inertia=False)
    tips = np.stack([x.numpy() for x in _world(fk, tt.tips)])
    obj = np.stack([x.numpy() for x in _world(fk, tt.obj_frame)])
    k = int(np.argmin(np.abs(tips[2] - obj[2])))
    assert abs(tips[2, k] - obj[2, k]) < 0.05
    q = s["q"].copy()
    q[:, 0] = qs[:, k]
    # the object's slides: obj_x along world y, obj_y along world x
    q[_qadr(m, tt.obj_x), 0] += tips[1, k] - obj[1, k]
    q[_qadr(m, tt.obj_y), 0] += tips[0, k] - obj[0, k]
    return q


def output_inputs(tt, B, seed=11, edit_q=None):
    """Numpy inputs of output_scalar near a reset state: (q, v, depths, a,
    aux), with the tasks' branches reached (see the module docstring)."""
    rng = np.random.default_rng(seed)
    s = _reset_np(tt, B, seed)
    q = s["q"] + rng.normal(0, 0.05, s["q"].shape).astype(np.float32)
    aux = {k: x.copy() for k, x in s["aux"].items()}
    if "striked" in aux:  # env 0: the tips at the ball; env 1 struck before
        q[:, 0] = _near_ball(tt, s)[:, 0]
        aux["striked"][1] = 1.0
        aux["strike_x"][1], aux["strike_y"][1], aux["strike_z"][1] = 0.6, -0.3, -0.2
        aux["min_dist"][:] = [0.8, 0.2, 5.0][:B]
    if "hit" in aux:  # env 0's ball below -0.25 now; env 1's fell earlier
        ball = next(b.q_adr for b in tt.model.bodies if b.jtype == JointType.FREE)
        q[ball + 2, 0] = -0.5
        aux["hit"][1], aux["hit_x"][1], aux["hit_y"][1] = 1.0, 0.3, -0.4
    if edit_q is not None:
        edit_q(q)
    v = rng.normal(0, 0.5, s["v"].shape).astype(np.float32)
    n_rows = make_physics_step_plain(tt.model, tt.physics)[2]
    d = rng.normal(0, 0.01, (n_rows, B)).astype(np.float32)
    a = rng.uniform(-1, 1, (tt.act_dim, B)).astype(np.float32)
    return q, v, d, a, aux


def check_hooks(tj, tt, B=3, edit_q=None):
    """(a) for one task pair: the reset bitwise, torques exact, outputs
    close (obs to 1e-6: XLA's and torch's sin/cos agree to round-off).
    Returns both packages' outputs."""
    ids = ids_np(B)
    qj, vj, auxj = tj.initial_state_scalar(*_j(ids))
    qt, vt, auxt = tt.initial_state_scalar(*_t(ids))
    np.testing.assert_array_equal(_rows(qj), torch.stack(list(qt)).numpy())
    np.testing.assert_array_equal(_rows(vj), torch.stack(list(vt)).numpy())
    assert sorted(auxj) == sorted(auxt)
    for k in auxj:
        np.testing.assert_allclose(np.asarray(auxj[k]) * np.ones(B), auxt[k].numpy(), rtol=1e-6,
                                   err_msg=k)

    rng = np.random.default_rng(5)
    a = rng.uniform(-1, 1, (tt.act_dim, B)).astype(np.float32)
    tau_j = tj.action_tau_scalar(list(jnp.asarray(a)))
    tau_t = tt.action_tau_scalar(list(torch.from_numpy(a)))
    assert len(tau_j) == len(tau_t) == tt.model.nv
    for x, y in zip(tau_j, tau_t):
        if isinstance(x, float):
            assert isinstance(y, float) and x == y == 0.0
        else:
            np.testing.assert_array_equal(np.asarray(x), y.numpy())

    q, v, d, a, aux = output_inputs(tt, B, edit_q=edit_q)
    oj = tj.output_scalar(list(jnp.asarray(q)), list(jnp.asarray(v)), list(jnp.asarray(d)),
                          list(jnp.asarray(a)), {k: jnp.asarray(x) for k, x in aux.items()},
                          _j(ids))
    ot = tt.output_scalar(list(torch.from_numpy(q)), list(torch.from_numpy(v)),
                          list(torch.from_numpy(d)), list(torch.from_numpy(a)),
                          {k: torch.from_numpy(x) for k, x in aux.items()}, _t(ids))
    np.testing.assert_allclose(_rows(oj[0]), torch.stack(list(ot[0])).numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(oj[1]), ot[1].numpy(), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(oj[2]) * np.ones(B, bool), ot[2].numpy())
    for j, t in ((oj[3], ot[3]), (oj[4], ot[4])):
        assert sorted(j) == sorted(t)
        for k in j:
            np.testing.assert_allclose(np.asarray(j[k]) * np.ones(B), t[k].numpy(), atol=1e-5,
                                       err_msg=k)
    return oj, ot


@pytest.mark.parametrize("env_id", (REACHER,) + ARMS)
def test_hooks_match_jax(env_id):
    """(a)"""
    tj, tt = pg.make_task(env_id), make_task(env_id)
    oj, ot = check_hooks(tj, tt)
    if env_id == STRIKER:  # the strike: env 0 newly, env 1 before, env 2 not
        np.testing.assert_array_equal(ot[3]["striked"].numpy(), [1.0, 1.0, 0.0])
    if env_id == THROWER:
        np.testing.assert_array_equal(ot[3]["hit"].numpy(), [1.0, 1.0, 0.0])


def env_step_state(tt, B=3, seed=21):
    """A numpy post-reset state with env 0 forced to reset (its epoch
    wrapping), env 1 one step from truncation, and (Striker) env 2 with the
    tips at the ball."""
    s = _reset_np(tt, B, seed)
    s["terminated"] = np.array([True, False, False][:B])
    s["epoch"] = np.array([2**32 - 1, 4, 0][:B], np.uint32)
    s["step_count"] = np.array([17, tt.max_episode_steps - 1, 3][:B], np.int32)
    if "striked" in s["aux"]:
        s["q"][:, 2] = _near_ball(tt, {"q": s["q"][:, 2:]})[:, 0]
    return s


@pytest.mark.parametrize("env_id", (REACHER,) + ARMS)
def test_env_step_plain_matches_jax_kernel_body(env_id):
    """(b)"""
    tj, tt = pg.make_task(env_id), make_task(env_id)
    sj = env_step_state(tt)
    st = env_state_from_numpy(sj, device="cpu")
    a = np.random.default_rng(21).uniform(-1.5, 1.5, (tt.act_dim, 3)).astype(np.float32)
    for fs in (0, 1):
        rj = _jax_kernel_body(tj, sj, a, frame_skip=fs)
        rt = env_step_plain(tt, st, torch.from_numpy(a), frame_skip=fs)
        for k in ("epoch", "step_count", "truncated", "terminated"):
            np.testing.assert_array_equal(rj[k], getattr(rt, k).numpy(), err_msg=k)
        if fs == 0:
            np.testing.assert_array_equal(rj["q"], rt.q.numpy())  # reset q bitwise
        assert np.abs(rj["q"] - rt.q.numpy()).mean() < 1e-5
        np.testing.assert_allclose(rj["obs"], rt.obs.numpy(), atol=1e-4)
        np.testing.assert_allclose(rj["reward"], rt.reward.numpy(), atol=1e-3)
        for k in rj["aux"]:
            np.testing.assert_allclose(rj["aux"][k], rt.aux[k].numpy(), rtol=1e-5, atol=1e-4)
    assert rt.truncated.tolist() == [False, True, False]


def _lowered(model, body, dz):
    """`model` (either package) with `body` moved down by dz."""
    i = model.body_index(body)
    b = model.bodies[i]
    low = dataclasses.replace(b, pos=np.asarray(b.pos) - np.array([0.0, 0.0, dz]))
    return model.replace(bodies=model.bodies[:i] + (low,) + model.bodies[i + 1:])


def _one_substep(tj, model_j, tt, model_t, q, v, tau):
    """One eager JAX substep and the plain version's, from numpy (q, v,
    tau); returns |dq| and both depth arrays."""
    cfg_j = dataclasses.replace(tj.physics, frame_skip=1)
    cfg_t = dataclasses.replace(tt.physics, frame_skip=1)
    substep, _, _ = step_j.make_substep_scalar(model_j, cfg_j)
    qj, _, dj = substep(list(jnp.asarray(q)), list(jnp.asarray(v)), list(jnp.asarray(tau)))
    q2, _, d2 = make_physics_step_plain(model_t, cfg_t)[0](
        torch.from_numpy(q), torch.from_numpy(v), torch.from_numpy(tau))
    dq = np.abs(_rows(qj) - q2.numpy())
    return dq, _rows(dj), d2.numpy()


def test_physics_pusher_disk_rows_degenerate_branch():
    """(c) Pusher, the object 5 mm into the table: its bottom cap's four rim
    rows (6-9) touch by 5 mm, its top cap's (10-13) are 9.5 cm clear."""
    tj, tt = pg.make_task(PUSHER), make_task(PUSHER)
    mj, mt = _lowered(tj.model, "object", 0.005), _lowered(tt.model, "object", 0.005)
    s = _reset_np(tt, 2, 3)
    a = np.random.default_rng(3).uniform(-1, 1, (tt.act_dim, 2)).astype(np.float32)
    tau = np.zeros((tt.model.nv, 2), np.float32)
    tau[tt.arm_dofs] = 2.0 * a
    dq, dj, dt = _one_substep(tj, mj, tt, mt, s["q"], s["v"], tau)
    assert dq.mean() < 1e-5, dq.mean()
    np.testing.assert_allclose(dj, dt, atol=1e-5)
    np.testing.assert_allclose(dt[6:10], 0.005, atol=1e-6)
    assert (dt[10:14] < -0.09).all()


def test_physics_disked_cheetah_regular_branch():
    """(c) HalfCheetah with a cylinder thigh, its slanted rim 3 mm into the
    floor: the four rows of its lower cap differ (regular branch)."""
    tt = disked_cheetah(loco_t.WalkerTask(loco_t.HALF_CHEETAH), GeomType.CYLINDER)
    tj = disked_cheetah(loco_j.WalkerTask(loco_j.HALF_CHEETAH), GeomType_j.CYLINDER)
    s, disk = disk_touch_state(tt, 2, 8)
    tau = np.random.default_rng(8).uniform(-60, 60, (tt.model.nv, 2)).astype(np.float32)
    tau[:3] = 0.0  # the root is not actuated
    dq, dj, dt = _one_substep(tj, tj.model, tt, tt.model, s.q.numpy(), s.v.numpy(), tau)
    assert dq.mean() < 1e-5, dq.mean()
    np.testing.assert_allclose(dj, dt, atol=1e-5)
    np.testing.assert_allclose(dt[disk].max(0), 3e-3, atol=1e-6)
    assert np.ptp(dt[disk[:4]], axis=0).min() > 1e-3  # the rim is tilted
