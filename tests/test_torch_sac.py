"""The port's SAC learner (`parallel/sac.py`) against the JAX package's
`parallel/sac.py`.

(a) sample_action, det_action and q_apply vs JAX on the same numpy
    parameters and JAX's noise: atol 1e-5 (float32 matmuls in two
    libraries); init_mlp's scales (1/sqrt(fan_in), the last layer
    final_scale / sqrt(fan_in)) and zero biases, as JAX's init_mlp.
(b) sac_state_from_npz reads the shipped HopperMuJoCoEnv-v0 learner in JAX's
    own flatten order: leaf for leaf against `utils/checkpoint.load` on the
    learner tuple of `init_sac_state`, exact.
(c) The slice as a whole: one SAC iteration on HopperMuJoCoEnv-v0 resumed in
    both packages from the shipped learner (settled Adam moments, hidden
    256x256), B=8, steps_per_iter=2, updates_per_iter=2, batch_size=16,
    warmup_steps=0. The JAX side is its jitted iteration on the XLA env step;
    the port runs its plain env step and is fed JAX's draws, replayed from
    JAX's key splits (sac.py:215, :170, :179, :186). Losses and metrics rtol
    1e-4; the actor, targets, log_alpha and the three Adam states atol 1e-5
    with rtol 1e-5 (the second moments reach 1e3, where 1e-5 is below
    float32's spacing); the critics the same on at least 98% of each leaf's
    entries and within one Adam step, lr = 3e-4, on the rest: the shipped
    critics are saturated (on the minibatches, 1 - h^2 < 1e-3 for most of
    the 256 units of the second layer), there XLA's and torch's CPU tanh
    round apart by an ulp, the gradient through 1 - h^2 differs by a large
    fraction of itself, and Adam's step, normalised by its second moment,
    follows it (measured: 1.8% of one 256x256 weight differ by up to
    1.05e-4). The ring: pointer and nonterminal flags exact; actions (tanh of
    float32 matmuls in two libraries: 0.3% differ, by up to 3e-6),
    rewards and observations (two env steps) to 1e-5; within the port,
    slot 0's next observation is slot 1's observation and slot 1's the
    returned state's, bitwise.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import pybulletgym_tpu as pg
from pybulletgym_tpu.parallel import networks as nets_j
from pybulletgym_tpu.parallel import sac as sac_j
from pybulletgym_tpu.utils import checkpoint
from pybulletgym_tpu_torch import make_task
from pybulletgym_tpu_torch.parallel import sac as sac_t
from pybulletgym_tpu_torch.parallel.networks import MLPParams, init_mlp
from pybulletgym_tpu_torch.utils.interop import (
    env_state_from_numpy, env_state_to_numpy, sac_state_from_npz,
)

ENV = "HopperMuJoCoEnv-v0"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEARNER = os.path.join(ROOT, "examples", "weights", f"{ENV}.saclearner.npz")
B = 8


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _mlp_t(p) -> MLPParams:
    return MLPParams(tuple(torch.tensor(np.array(w)) for w in p.weights),
                     tuple(torch.tensor(np.array(b)) for b in p.biases))


def test_actor_and_critic_match_jax():
    """(a)"""
    obs_dim, act_dim = 11, 3
    actor_j = nets_j.init_mlp(jax.random.PRNGKey(1), (obs_dim, 32, 32, 2 * act_dim), 0.5)
    q_j = nets_j.init_mlp(jax.random.PRNGKey(2), (obs_dim + act_dim, 32, 32, 1), 1.0)
    rng = np.random.default_rng(1)
    obs = rng.normal(0, 2, (16, obs_dim)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    aj, lj = sac_j.sample_action(actor_j, jnp.asarray(obs), key)
    eps = np.array(jax.random.normal(key, (16, act_dim), jnp.float32))
    at, lt = sac_t.sample_action(_mlp_t(actor_j), torch.from_numpy(obs), torch.from_numpy(eps))
    np.testing.assert_allclose(_np(at), np.asarray(aj), atol=1e-5)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), atol=1e-5)
    np.testing.assert_allclose(_np(sac_t.det_action(_mlp_t(actor_j), torch.from_numpy(obs))),
                               np.asarray(sac_j.det_action(actor_j, jnp.asarray(obs))), atol=1e-5)
    act = rng.uniform(-1, 1, (16, act_dim)).astype(np.float32)
    np.testing.assert_allclose(
        _np(sac_t.q_apply(_mlp_t(q_j), torch.from_numpy(obs), torch.from_numpy(act))),
        np.asarray(sac_j.q_apply(q_j, jnp.asarray(obs), jnp.asarray(act))), atol=1e-5)

    sizes = (obs_dim, 32, 32, 2 * act_dim)
    for final in (0.01, 1.0):
        gen = torch.Generator().manual_seed(3)
        p = init_mlp(sizes, final, gen, "cpu")
        raw = torch.Generator().manual_seed(3)
        pj = nets_j.init_mlp(jax.random.PRNGKey(3), sizes, final)
        kj = jax.random.split(jax.random.PRNGKey(3), len(sizes) - 1)
        for i, (w, b) in enumerate(zip(p.weights, p.biases)):
            scale = (final if i == len(sizes) - 2 else 1.0) / math.sqrt(sizes[i])
            draw = torch.randn((sizes[i], sizes[i + 1]), generator=raw)
            np.testing.assert_allclose(_np(w), _np(draw) * np.float32(scale), rtol=1e-6)
            nj = np.asarray(jax.random.normal(kj[i], (sizes[i], sizes[i + 1]), jnp.float32))
            np.testing.assert_allclose(np.asarray(pj.weights[i]), nj * np.float32(scale), rtol=1e-6)
            assert not b.any() and not np.asarray(pj.biases[i]).any()


def _learner_of(ss):
    return (ss.actor, ss.critics, ss.targets, ss.log_alpha, ss.opt_actor, ss.opt_critic,
            ss.opt_alpha, ss.key)


def _jax_state(cfg):
    env = pg.make_batched(ENV, B, backend="xla", jit=False)
    ss = sac_j.init_sac_state(jax.random.PRNGKey(0), env.observation_size, env.action_size,
                              B, cfg)
    lt = checkpoint.load(LEARNER, _learner_of(ss))
    return env, ss._replace(actor=lt[0], critics=lt[1], targets=lt[2], log_alpha=lt[3],
                            opt_actor=lt[4], opt_critic=lt[5], opt_alpha=lt[6], key=lt[7])


def _port_leaves(ss):
    """The port's learner laid out as JAX's tree.flatten lays out its own
    (the key left out: the port draws from a generator)."""
    def opt(o):
        return [*o[0], *o[1], o[2]]
    return [*ss.actor.leaves(), *ss.critics.leaves(), *ss.targets.leaves(), ss.log_alpha,
            *opt(ss.opt_actor), *opt(ss.opt_critic), *opt(ss.opt_alpha)]


def test_sac_state_from_npz_follows_jax_order():
    """(b)"""
    _, ssj = _jax_state(sac_j.SACConfig())
    sst = sac_state_from_npz(LEARNER, B, sac_t.SACConfig(), device="cpu")
    leaves_j = jax.tree.leaves(_learner_of(ssj))
    leaves_t = _port_leaves(sst)
    assert len(leaves_j) == 73 and len(leaves_t) == 72
    for k, (a, b) in enumerate(zip(leaves_j, leaves_t)):
        np.testing.assert_array_equal(np.asarray(a), _np(b), err_msg=f"leaf {k}")
        assert np.asarray(a).dtype == _np(b).dtype, k
    np.testing.assert_array_equal(np.asarray(ssj.targets.q2.weights[1]),
                                  _np(sst.targets.q2.weights[1]))
    np.testing.assert_array_equal(np.asarray(ssj.opt_critic[1].q1.biases[0]),
                                  _np(sst.opt_critic[1][3]))
    k0, k1 = (int(x) for x in np.asarray(ssj.key))
    assert sst.generator.initial_seed() == (k0 << 32) | k1
    assert int(sst.opt_actor[2]) == int(ssj.opt_actor[2]) > 0
    assert sst.buf_ptr == 0 and not sst.buf_full and tuple(sst.buf_obs.shape) == (512, 11, B)


def _jax_draws(ssj, esj, cfg, act_dim):
    """Every draw of one jitted iteration, from the JAX key's splits."""
    _, k_coll, k_upd = jax.random.split(ssj.key, 3)
    pi, ar = [], []
    for k in jax.random.split(k_coll, cfg.steps_per_iter):
        pi.append(np.asarray(jax.random.normal(k, (B, act_dim), jnp.float32)))
        ar.append(np.asarray(jax.random.uniform(jax.random.fold_in(k, 1), (B, act_dim),
                                                minval=-1.0, maxval=1.0)))
    hi = max(int(ssj.buf_ptr) + cfg.steps_per_iter, 1)
    slots, envs, nxt, upd = [], [], [], []
    for k in jax.random.split(k_upd, cfg.updates_per_iter):
        k_samp, k_next, k_pi = jax.random.split(k, 3)
        ks, ke = jax.random.split(k_samp)
        slots.append(np.asarray(jax.random.randint(ks, (cfg.batch_size,), 0, hi)))
        envs.append(np.asarray(jax.random.randint(ke, (cfg.batch_size,), 0, B)))
        nxt.append(np.asarray(jax.random.normal(k_next, (cfg.batch_size, act_dim), jnp.float32)))
        upd.append(np.asarray(jax.random.normal(k_pi, (cfg.batch_size, act_dim), jnp.float32)))
    f = lambda xs: torch.from_numpy(np.stack(xs))  # noqa: E731
    i = lambda xs: torch.from_numpy(np.stack(xs).astype(np.int64))  # noqa: E731
    return {"pi_eps": f(pi), "a_rand": f(ar), "slots": i(slots), "envs": i(envs),
            "next_eps": f(nxt), "pi_eps_upd": f(upd)}


def test_iteration_matches_jax():
    """(c)"""
    kw = dict(steps_per_iter=2, updates_per_iter=2, batch_size=16, warmup_steps=0)
    cfg_j, cfg_t = sac_j.SACConfig(**kw), sac_t.SACConfig(**kw)
    env, ssj = _jax_state(cfg_j)
    esj = env.reset(seed=0)
    draws = _jax_draws(ssj, esj, cfg_j, env.action_size)
    it_j = jax.jit(sac_j.make_sac_iteration(env.task, cfg_j, step_fn=env._step))
    ssj2, esj2, mj = it_j(ssj, esj)

    sst = sac_state_from_npz(LEARNER, B, cfg_t, device="cpu")
    est = env_state_from_numpy(env_state_to_numpy(esj), device="cpu")
    it_t = sac_t.make_sac_iteration(make_task(ENV), cfg_t)  # CPU tensors: the plain env step
    sst2, est2, mt = it_t(sst, est, draws=draws)

    for k in ("reward_mean", "critic_loss", "actor_loss", "alpha"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-4, err_msg=k)
    leaves_j = jax.tree.leaves(_learner_of(ssj2))[:-1]
    leaves_t = _port_leaves(sst2)
    critics = range(len(sst2.actor.leaves()), len(sst2.actor.leaves()) + 12)
    for k, (a, b) in enumerate(zip(leaves_j, leaves_t)):
        a, b = np.asarray(a), _np(b)
        if a.dtype == np.int32:  # the Adam counts
            assert int(a) == int(b) == int(np.load(LEARNER)[f"leaf_{k}"]) + 2, k
        elif k in critics:
            off = ~np.isclose(b, a, rtol=1e-5, atol=1e-5)
            assert off.mean() <= 0.02 and np.abs(b - a).max() < cfg_t.learning_rate, k
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5, err_msg=f"leaf {k}")
    assert not np.array_equal(_np(sst2.actor.weights[0]), np.load(LEARNER)["leaf_0"])
    assert sst2.buf_ptr == int(ssj2.buf_ptr) == 2 and not sst2.buf_full
    np.testing.assert_array_equal(_np(sst2.buf_nonterm), np.asarray(ssj2.buf_nonterm))
    for name in ("buf_act", "buf_rew", "buf_obs", "buf_next_obs"):
        np.testing.assert_allclose(_np(getattr(sst2, name)), np.asarray(getattr(ssj2, name)),
                                   atol=1e-5, err_msg=name)
    assert torch.equal(sst2.buf_next_obs[0], sst2.buf_obs[1])
    assert torch.equal(sst2.buf_next_obs[1], est2.obs)
    np.testing.assert_allclose(_np(est2.obs), np.asarray(esj2.obs), atol=1e-5)
