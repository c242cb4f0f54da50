"""The backend choice through `make_vec` and `ppo.train`: both take
`backend=` and `graph=` and pass them to `make_batched`, as `make` does.
Shown on the CPU with a registered task whose reward takes
`torch.special.i0e` (the exponentially scaled Bessel function I0), an op
that the hook translation (`ops.task_kernel`) refuses: the default "fused"
raises naming the op, and "composed" runs it."""

import numpy as np
import pytest
import torch

import pybulletgym_tpu_torch as pt
from pybulletgym_tpu_torch.envs import pendula
from pybulletgym_tpu_torch.parallel import ppo

ID = "BesselPendulum-v0"


class BesselPendulum(pendula.InvertedPendulumTask):
    """InvertedPendulum paid i0e of its reward less the cart's squared
    position."""

    def output_scalar(self, q, v, depths, a, aux, ids=None):
        obs, reward, term, aux2, comps = super().output_scalar(q, v, depths, a, aux, ids)
        return obs, torch.special.i0e(reward - q[0] * q[0]), term, aux2, comps


@pytest.fixture(scope="module", autouse=True)
def registered():
    pt.register(ID, BesselPendulum, 1000)


def test_make_vec_default_refuses_the_op():
    with pytest.raises(NotImplementedError, match="i0e"):
        pt.make_vec(ID, 2, device="cpu")


def test_make_vec_composed_runs_it():
    vec = pt.make_vec(ID, 3, device="cpu", backend="composed", graph=False)
    env = vec._env
    assert env.backend == "composed" and env.step_fn.backend == "composed"
    assert env.step_fn.graph is False
    obs, _ = vec.reset(seed=1)
    obs2, reward, term, trunc, _ = vec.step(np.zeros((3, 1), np.float32))
    assert obs.shape == obs2.shape == (3, env.task.obs_dim)
    x = vec._state.q[0]  # the cart, after the step
    np.testing.assert_array_equal(reward, torch.special.i0e(1.0 - x * x).numpy())
    assert ((0.0 < reward) & (reward < 1.0)).all()


def test_ppo_train_composed_runs_it():
    cfg = ppo.PPOConfig(rollout_length=2, num_epochs=1, num_minibatches=2)
    with pytest.raises(NotImplementedError, match="i0e"):
        ppo.train(ID, 8, 1, cfg, device="cpu")
    ts, es, metrics = ppo.train(ID, 8, 1, cfg, device="cpu", backend="composed")
    assert es.q.shape[-1] == 8
    assert all(np.isfinite(float(x)) for x in metrics.values())
    assert 0.0 < float(metrics["reward_mean"]) < 1.0  # i0e of about 1
