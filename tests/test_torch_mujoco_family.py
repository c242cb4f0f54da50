"""The Gym-MuJoCo mirror family (`envs/mujoco_family.py`: the eight
`*MuJoCoEnv-v0` IDs) on the port, against the JAX package, at small sizes
(B = 3, eager JAX).

(a) every hook against the JAX task on the same numpy-made inputs:
    initial_state_scalar (q, v and aux bitwise, but ReacherMuJoCo's target
    x, y to 1 ulp: r·cos and r·sin of the disk draw go through XLA's and
    torch's CPU sqrt, sin and cos, which round differently in about 1% of
    the draws), action_tau_scalar exact, output_scalar (obs to 1e-6;
    reward, aux and reward components to 1e-5; termination exact), with
    env 1 past the termination test of the walkers and the pendula.
(b) env_step_plain vs the eager JAX kernel body with frame_skip 0 (a
    forced reset: q bitwise but Reacher's target, epoch and step count
    exact) and 1 (mean |dq| < 1e-5, the walkers' bound of
    test_torch_humanoid.py; obs to 1e-4 absolute or relative, since
    ReacherMuJoCo's gear of 200 spins the arm at tens of rad/s in one
    substep; reward to 1e-3), and the registry:
    26 IDs, Reacher's horizon 150 over the task's own 1000.
test_torch_mujoco_family_twin.py holds the kernels' C++ to the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybulletgym_tpu as pg
from pybulletgym_tpu_torch import make_task
from pybulletgym_tpu_torch.api.registry import registry
from pybulletgym_tpu_torch.envs.base import env_step_plain
from pybulletgym_tpu_torch.utils.interop import env_state_from_numpy
from test_torch_engine import _jax_kernel_body
from test_torch_manipulation import _j, _rows, _t, env_step_state, ids_np, output_inputs

MJ = ("HopperMuJoCoEnv-v0", "Walker2DMuJoCoEnv-v0", "HalfCheetahMuJoCoEnv-v0",
      "AntMuJoCoEnv-v0", "HumanoidMuJoCoEnv-v0", "ReacherMuJoCoEnv-v0",
      "InvertedPendulumMuJoCoEnv-v0", "InvertedDoublePendulumMuJoCoEnv-v0")
REACHER = "ReacherMuJoCoEnv-v0"
# env 1's edit (q index, value), which ends its episode
EDIT = {"HopperMuJoCoEnv-v0": (1, 0.5), "Walker2DMuJoCoEnv-v0": (2, 1.3),
        "AntMuJoCoEnv-v0": (2, 1.4), "HumanoidMuJoCoEnv-v0": (2, 0.8),
        "InvertedPendulumMuJoCoEnv-v0": (1, 0.5), "InvertedDoublePendulumMuJoCoEnv-v0": (1, 1.4)}


def ulps(a, b):
    """|a - b| in float32 spacings (same-signed finite values)."""
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


def target_rows(tt):
    """ReacherMuJoCo's target slides, the reset entries held to 1 ulp."""
    return [tt.tx, tt.ty] if hasattr(tt, "tx") else []


def assert_reset_q(qj, qt, tt):
    rows = target_rows(tt)
    keep = [i for i in range(qt.shape[0]) if i not in rows]
    np.testing.assert_array_equal(qj[keep], qt[keep])
    if rows:
        assert ulps(qj[rows], qt[rows]).max() <= 1


@pytest.mark.parametrize("env_id", MJ)
def test_hooks_match_jax(env_id):
    """(a)"""
    tj, tt = pg.make_task(env_id), make_task(env_id)
    B = 3
    ids = ids_np(B)
    qj, vj, auxj = tj.initial_state_scalar(*_j(ids))
    qt, vt, auxt = tt.initial_state_scalar(*_t(ids))
    assert_reset_q(_rows(qj), torch.stack(list(qt)).numpy(), tt)
    np.testing.assert_array_equal(_rows(vj), torch.stack(list(vt)).numpy())
    assert sorted(auxj) == sorted(auxt)
    for k in auxj:
        np.testing.assert_array_equal(np.asarray(auxj[k]) * np.ones(B, np.float32),
                                      auxt[k].numpy(), err_msg=k)

    a = np.random.default_rng(5).uniform(-1, 1, (tt.act_dim, B)).astype(np.float32)
    tau_j = tj.action_tau_scalar(list(jnp.asarray(a)))
    tau_t = tt.action_tau_scalar(list(torch.from_numpy(a)))
    assert len(tau_j) == len(tau_t) == tt.model.nv
    for x, y in zip(tau_j, tau_t):
        if isinstance(x, float):
            assert isinstance(y, float) and x == y == 0.0
        else:
            np.testing.assert_array_equal(np.asarray(x), y.numpy())

    edit = EDIT.get(env_id)

    def edit_q(q):
        if edit is not None:
            q[edit[0], 1] = edit[1]

    q, v, d, a, aux = output_inputs(tt, B, edit_q=edit_q)
    oj = tj.output_scalar(list(jnp.asarray(q)), list(jnp.asarray(v)), list(jnp.asarray(d)),
                          list(jnp.asarray(a)), {k: jnp.asarray(x) for k, x in aux.items()},
                          _j(ids))
    ot = tt.output_scalar(list(torch.from_numpy(q)), list(torch.from_numpy(v)),
                          list(torch.from_numpy(d)), list(torch.from_numpy(a)),
                          {k: torch.from_numpy(x) for k, x in aux.items()}, _t(ids))
    assert len(ot[0]) == tt.obs_dim
    np.testing.assert_allclose(_rows(oj[0]), torch.stack(list(ot[0])).numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(oj[1]), ot[1].numpy(), rtol=1e-6, atol=1e-5)
    term = np.asarray(oj[2]) * np.ones(B, bool)
    np.testing.assert_array_equal(term, ot[2].numpy())
    if edit is not None:
        assert term[1]
    for j, t in ((oj[3], ot[3]), (oj[4], ot[4])):
        assert sorted(j) == sorted(t)
        for k in j:
            np.testing.assert_allclose(np.asarray(j[k]) * np.ones(B), t[k].numpy(),
                                       rtol=1e-6, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("env_id", MJ)
def test_env_step_plain_matches_jax_kernel_body(env_id):
    """(b)"""
    tj, tt = pg.make_task(env_id), make_task(env_id)
    tj.max_episode_steps = tt.max_episode_steps
    sj = env_step_state(tt)
    st = env_state_from_numpy(sj, device="cpu")
    a = np.random.default_rng(21).uniform(-1.5, 1.5, (tt.act_dim, 3)).astype(np.float32)
    for fs in (0, 1):
        rj = _jax_kernel_body(tj, sj, a, frame_skip=fs)
        rt = env_step_plain(tt, st, torch.from_numpy(a), frame_skip=fs)
        for k in ("epoch", "step_count", "truncated", "terminated"):
            np.testing.assert_array_equal(rj[k], getattr(rt, k).numpy(), err_msg=k)
        if fs == 0:
            assert_reset_q(rj["q"], rt.q.numpy(), tt)
        assert np.abs(rj["q"] - rt.q.numpy()).mean() < 1e-5
        np.testing.assert_allclose(rj["obs"], rt.obs.numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(rj["reward"], rt.reward.numpy(), rtol=1e-5, atol=1e-3)
        for k in rj["aux"]:
            np.testing.assert_allclose(rj["aux"][k], rt.aux[k].numpy(), rtol=1e-5, atol=1e-4)
    assert rt.epoch.tolist() == [0, 4, 0] and rt.step_count.tolist()[1] == tt.max_episode_steps


def test_registry_has_the_family():
    assert len(registry) == 26 and sorted(registry) == sorted(pg.registry)
    assert all(k in registry for k in MJ)
    for env_id in MJ:  # the JAX registry's horizons
        assert make_task(env_id).max_episode_steps == pg.make_task(env_id).max_episode_steps
    assert make_task(REACHER).max_episode_steps == 150
    with pytest.raises(KeyError, match="known"):
        make_task("NoSuchEnv-v0")
