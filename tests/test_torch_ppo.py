"""The port's PPO learner against the JAX package's `parallel/ppo.py`.

(a) ActorCritic logp, entropy, value and sampling vs JAX `networks` on the
    same numpy parameters: atol 1e-5 (float32 matmuls in two libraries).
(b) ObsStats.update and _adam vs JAX's: atol 1e-6 (same formulas, same
    order; only the reduction order of the sums differs).
(c) The slice as a whole: one train step on Ant resumed in both packages
    from the shipped `AntPyBulletEnv-v0.trainstate.npz` (settled Adam
    moments, so a real difference is not hidden under a first step's
    +-lr), B=8, T=2, 1 epoch x 2 minibatches, normalize_obs. The JAX side
    is its jitted train step on the XLA env step; the port runs its plain
    env step and is fed JAX's sampling noise. Loss and metrics rtol 1e-4,
    except reward_mean: its progress term is a difference of two potentials
    near -6.06e4, whose float32 spacing is 3.9e-3, and the XLA env step
    rounds that difference otherwise (per-env progress differs by up to one
    spacing while q differs by 2e-7), so it gets atol 4e-3. Params, Adam
    moments and obs stats atol 1e-5.
(d) train_state_from_npz reads the leaves in JAX's own flatten order.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import pybulletgym_tpu as pg
from pybulletgym_tpu.parallel import networks as nets_j
from pybulletgym_tpu.parallel import ppo as ppo_j
from pybulletgym_tpu.utils import checkpoint
from pybulletgym_tpu_torch import make_task
from pybulletgym_tpu_torch.parallel import ppo as ppo_t
from pybulletgym_tpu_torch.parallel.networks import ActorCritic
from pybulletgym_tpu_torch.utils.interop import (
    env_state_from_numpy, env_state_to_numpy, train_state_from_npz,
)

ENV = "AntPyBulletEnv-v0"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINSTATE = os.path.join(ROOT, "examples", "weights", f"{ENV}.trainstate.npz")


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _ac_from_jax(p) -> ActorCritic:
    t = lambda xs: [torch.tensor(np.array(x)) for x in xs]  # noqa: E731
    return ActorCritic(t(p.policy.weights), t(p.policy.biases), t(p.value.weights),
                       t(p.value.biases), torch.tensor(np.asarray(p.log_std)))


def test_actor_critic_matches_jax():
    """(a)"""
    pj = nets_j.init_actor_critic(jax.random.PRNGKey(3), 28, 8, (64, 64))
    pj = pj._replace(log_std=jnp.linspace(-1.0, 0.5, 8, dtype=jnp.float32))
    ac = _ac_from_jax(pj)
    rng = np.random.default_rng(3)
    obs = rng.normal(0, 2, (16, 28)).astype(np.float32)
    act = rng.normal(0, 1, (16, 8)).astype(np.float32)
    lj, ej = nets_j.policy_logp_entropy(pj, jnp.asarray(obs), jnp.asarray(act))
    lt, et = ac.policy_logp_entropy(torch.from_numpy(obs), torch.from_numpy(act))
    np.testing.assert_allclose(_np(lt), np.asarray(lj), atol=1e-5)
    np.testing.assert_allclose(_np(et), np.asarray(ej), atol=1e-5)
    np.testing.assert_allclose(_np(ac.value_apply(torch.from_numpy(obs))),
                               np.asarray(nets_j.value_apply(pj, jnp.asarray(obs))), atol=1e-5)
    key = jax.random.PRNGKey(5)
    aj, spj = nets_j.policy_sample(pj, jnp.asarray(obs), key)
    eps = np.asarray(jax.random.normal(key, (16, 8), jnp.float32))
    at, spt = ac.policy_sample(torch.from_numpy(obs), eps=torch.tensor(eps))
    np.testing.assert_allclose(_np(at), np.asarray(aj), atol=1e-5)
    np.testing.assert_allclose(_np(spt), np.asarray(spj), atol=1e-5)
    # the init draws from a torch.Generator: same shapes and scales, other numbers
    fresh = ActorCritic.init(28, 8, (64, 64), torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(p.shape) for p in fresh.leaves()] == [x.shape for x in jax.tree.leaves(pj)]
    assert float(fresh.policy_w[-1].detach().abs().max()) < 0.01 and not fresh.log_std.any()


def test_obs_stats_and_adam_match_jax():
    """(b)"""
    rng = np.random.default_rng(7)
    mean, var = rng.normal(0, 1, 28).astype(np.float32), rng.uniform(0.1, 3, 28).astype(np.float32)
    obs = rng.normal(0.5, 2, (64, 28)).astype(np.float32)
    sj = ppo_j.ObsStats(jnp.asarray(mean), jnp.asarray(var), jnp.float32(1234.0)).update(jnp.asarray(obs))
    st = ppo_t.ObsStats(torch.tensor(mean), torch.tensor(var), torch.tensor(1234.0)).update(
        torch.tensor(obs))
    for a, b in zip(sj, st):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=1e-6)
    np.testing.assert_allclose(_np(st.normalize(torch.tensor(obs))),
                               np.asarray(sj.normalize(jnp.asarray(obs))), atol=1e-6)

    shapes = [(28, 64), (64,), (8,)]
    arr = lambda s, scale=1.0: rng.normal(0, scale, s).astype(np.float32)  # noqa: E731
    p, g = [arr(s) for s in shapes], [arr(s, 0.3) for s in shapes]
    m, v = [arr(s, 0.01) for s in shapes], [np.abs(arr(s, 1e-3)) for s in shapes]
    for count in (0, 3, 22080):  # a first step, an early one, the shipped state's
        outj = ppo_j._adam([jnp.asarray(x) for x in p], [jnp.asarray(x) for x in g],
                           [jnp.asarray(x) for x in m], [jnp.asarray(x) for x in v],
                           jnp.int32(count), 3e-4)
        outt = ppo_t._adam([torch.tensor(x) for x in p], [torch.tensor(x) for x in g],
                           [torch.tensor(x) for x in m], [torch.tensor(x) for x in v],
                           torch.tensor(count, dtype=torch.int32), 3e-4)
        for xj, xt in zip(outj[:3], outt[:3]):
            for a, b in zip(xj, xt):
                np.testing.assert_allclose(_np(b), np.asarray(a), atol=1e-6)
        assert int(outt[3]) == int(outj[3]) == count + 1


def _jax_template(cfg):
    env = pg.make_batched(ENV, 8, backend="xla", jit=False)
    like = ppo_j.init_train_state(jax.random.PRNGKey(0), env.observation_size,
                                  env.action_size, cfg)
    return env, checkpoint.load(TRAINSTATE, like)


def _port_leaves(ts, key):
    """The port's TrainState laid out as JAX's tree.flatten lays out its own."""
    return [*ts.params.leaves(), *ts.opt_m, *ts.opt_v, ts.opt_count, key,
            *ts.obs_stats]


def test_train_state_from_npz_follows_jax_order():
    """(d)"""
    _, tsj = _jax_template(ppo_j.PPOConfig())
    tst, key = train_state_from_npz(TRAINSTATE, device="cpu")
    leaves_j = jax.tree.leaves(tsj)
    leaves_t = _port_leaves(tst, key)
    assert len(leaves_t) == len(leaves_j) == 44
    for k, (a, b) in enumerate(zip(leaves_j, leaves_t)):
        np.testing.assert_array_equal(np.asarray(a), _np(b), err_msg=f"leaf {k}")
    # field by field, from the JAX names
    np.testing.assert_array_equal(np.asarray(tsj.params.value.weights[2]), _np(tst.params.value_w[2]))
    np.testing.assert_array_equal(np.asarray(tsj.opt_v.policy.biases[1]),
                                  _np(tst.opt_v[len(tst.params.policy_w) + 1]))
    assert int(tst.opt_count) == int(tsj.opt_count) == 22080
    np.testing.assert_array_equal(key, np.asarray(tsj.key))


def test_train_step_matches_jax():
    """(c)"""
    kw = dict(rollout_length=2, num_epochs=1, num_minibatches=2, normalize_obs=True)
    cfg_j, cfg_t = ppo_j.PPOConfig(**kw), ppo_t.PPOConfig(**kw)
    env, tsj = _jax_template(cfg_j)
    esj = env.reset(seed=0)
    step_j = jax.jit(ppo_j.make_train_step(env.task, cfg_j, step_fn=env._step))
    tsj2, esj2, mj = step_j(tsj, esj)
    # JAX's noise, derived as ppo.py:199 and :150 derive it
    _, k_roll, _ = jax.random.split(tsj.key, 3)
    eps = np.stack([np.asarray(jax.random.normal(k, (8, env.action_size), jnp.float32))
                    for k in jax.random.split(k_roll, cfg_j.rollout_length)])

    tst, _ = train_state_from_npz(TRAINSTATE, device="cpu")
    est = env_state_from_numpy(env_state_to_numpy(esj), device="cpu")
    step_t = ppo_t.make_train_step(make_task(ENV), cfg_t)  # CPU tensors: the plain env step
    tst2, est2, mt = step_t(tst, est, eps=torch.from_numpy(eps))

    for k in ("loss", "done_frac", "value_mean"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(mt["reward_mean"]), float(mj["reward_mean"]), atol=4e-3)
    assert int(tst2.opt_count) == int(tsj2.opt_count) == 22080 + 2
    leaves_j = jax.tree.leaves(tsj2)
    leaves_t = _port_leaves(tst2, np.asarray(tsj2.key))
    for k, (a, b) in enumerate(zip(leaves_j, leaves_t)):
        if k == 40:  # the JAX key: the port draws from its own generator
            continue
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=1e-5, err_msg=f"leaf {k}")
    assert not np.array_equal(_np(tst2.params.policy_w[0]),
                              np.load(TRAINSTATE)["leaf_0"])  # the step moved the weights
    np.testing.assert_allclose(_np(est2.obs), np.asarray(esj2.obs), atol=1e-4)
