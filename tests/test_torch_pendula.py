"""The pendula (InvertedPendulum, its swing-up, InvertedDoublePendulum) on
the port, against the JAX package, at small sizes (B = 3, eager JAX).

(a) every hook against the JAX task on the same numpy-made inputs:
    initial_state_scalar bitwise (the swing-up's pi + u included),
    action_tau_scalar exact, output_scalar (obs to 1e-6, reward and reward
    components to 1e-5, termination exact), with env 1 past the
    termination test (|theta| > 0.2; pole2's COM below 0.7).
(b) env_step_plain vs the eager JAX kernel body with frame_skip 0 (a
    forced reset: reset q, epoch and step count bitwise) and 1 (mean |dq|
    < 1e-5, the walkers' bound of test_torch_humanoid.py; obs to 1e-4,
    reward to 1e-3).
test_torch_manipulation_twin.py holds the kernels' C++ to the plain version.
"""

import numpy as np
import pytest
import torch

import pybulletgym_tpu as pg
from pybulletgym_tpu_torch import make_task
from pybulletgym_tpu_torch.envs.base import env_step_plain
from pybulletgym_tpu_torch.utils.interop import env_state_from_numpy
from test_torch_engine import _jax_kernel_body
from test_torch_manipulation import check_hooks, env_step_state

PENDULA = ("InvertedPendulumPyBulletEnv-v0", "InvertedPendulumSwingupPyBulletEnv-v0",
           "InvertedDoublePendulumPyBulletEnv-v0")


def _tip_over(tt):
    """Env 1's first hinge at 1.4 rad: past |theta| > 0.2, and the double
    pendulum's pole2 low enough to end the episode."""
    def edit(q):
        q[tt.hinge_qadr if hasattr(tt, "hinge_qadr") else tt.j1_qadr, 1] = 1.4
    return edit


@pytest.mark.parametrize("env_id", PENDULA)
def test_hooks_match_jax(env_id):
    """(a)"""
    tj, tt = pg.make_task(env_id), make_task(env_id)
    _, ot = check_hooks(tj, tt, edit_q=_tip_over(tt))
    swingup = getattr(tt, "swingup", False)
    assert ot[2].tolist() == [False, not swingup, False]


@pytest.mark.parametrize("env_id", PENDULA)
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
    assert rt.epoch.tolist() == [0, 4, 0] and rt.step_count.tolist() == [1, 1000, 4]
