"""Data parallelism over the env axis (`pybulletgym_tpu_torch/parallel/mesh.py`)
on the CPU over gloo, against the unsharded port and the JAX package. The
ranks are processes started by `mesh.launch`; their code is in
`torch_mesh_workers.py`, which imports no JAX.

(a) In one process: the shards of D=2 and 4 (`shard_env_state`) side by
    side are the global state, and `gather_env_state` on a world of one
    rank gives it back; a shard's own reset (`BatchedEnv.reset(first_env=)`)
    is bitwise the slice of a global reset (Hopper, B=16); a world-1 mesh's
    PPO train step is bitwise the unsharded one (mesh=None), entropy term
    included.
(b) 2 ranks: 5 sharded steps of Hopper at B=16, seeded actions, every third
    env forced to reset before step 3: the gathered state is bitwise the
    unsharded port's after every step. Envs 0 and 1 take the actions of the
    JAX package's recorded CPU rollout (tests/goldens, seed 1234) and stay
    within test_torch_engine.py's bound of it (median |dobs| < 1e-3 at step
    5, terminated equal at every step).
(c) 2 ranks: one PPO train step on Ant resumed from the shipped trainstate,
    B=8, T=2, 1 epoch x 2 minibatches, normalize_obs and entropy_coef 0.01
    (the entropy term's gradient must count once, not once a rank), fed
    JAX's noise, against the JAX jitted unsharded train step under
    test_torch_ppo.py's bounds; the parameters bitwise equal on both ranks.
(d) 2 ranks: one SAC iteration on HopperMuJoCo from the shipped learner with
    JAX's draws (env indices of the global batch), under test_torch_sac.py's
    bounds; each rank's ring is its block of JAX's; the learner bitwise
    equal on both ranks.
(e) 4 ranks: one step of `ppo.train` over a `make_mesh_2d(n_hosts=2)` mesh on
    InvertedPendulum, B=16, finite and within atol 1e-5 of the unsharded
    `ppo.train`'s.
(f) `entry.dryrun_multichip(2, device="cpu")` prints ok with a finite loss.
(g) 2 ranks: a user's task by its registered ID (ShapedAnt,
    tests/torch_user_tasks.py; each rank registers it and translates its
    hooks for the fused step, `task_step_kernel`'s wrapper, whose plain
    version steps CPU tensors): 3 sharded steps at B=4, every third env
    forced to reset before step 1, the gathered state bitwise the unsharded
    port's after every step.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pybulletgym_tpu.parallel import ppo as ppo_j
from pybulletgym_tpu.parallel import sac as sac_j
from pybulletgym_tpu_torch import entry, make_batched
from pybulletgym_tpu_torch.parallel import mesh as pmesh
from pybulletgym_tpu_torch.parallel import ppo
from pybulletgym_tpu_torch.utils.interop import env_state_to_numpy
from test_torch_ppo import TRAINSTATE, _jax_template
from test_torch_sac import LEARNER, _jax_draws, _jax_state, _learner_of
from torch_mesh_workers import ppo_leaves, run_jobs
import torch_user_tasks as ut

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOPPER = "HopperPyBulletEnv-v0"
ANT = "AntPyBulletEnv-v0"
MJ_HOPPER = "HopperMuJoCoEnv-v0"
PENDULUM = "InvertedPendulumPyBulletEnv-v0"
CPU = torch.device("cpu")
PPO_KW = dict(rollout_length=2, num_epochs=1, num_minibatches=2, normalize_obs=True,
              entropy_coef=0.01)
SAC_KW = dict(steps_per_iter=2, updates_per_iter=2, batch_size=16, warmup_steps=0)


def _leaves(s):
    return [x for f in s for x in ([f[k] for k in sorted(f)] if isinstance(f, dict) else [f])]


def _assert_states_equal(a, b):
    """Two numpy EnvState dicts, bit for bit."""
    for k in a:
        if isinstance(a[k], dict):
            assert sorted(a[k]) == sorted(b[k]), k
            for n in a[k]:
                np.testing.assert_array_equal(a[k][n], b[k][n], err_msg=f"{k}.{n}")
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture
def world1(tmp_path):
    pmesh.init_distributed(f"file://{tmp_path}/store", 1, 0, device="cpu")
    try:
        yield pmesh.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_shards_and_shard_resets(world1):
    """(a) shard, gather, and a shard's reset"""
    s = make_batched(HOPPER, 16, device="cpu").reset(seed=3)
    for D in (2, 4):
        b = 16 // D
        shards = [pmesh.shard_env_state(s, pmesh.Mesh(D, r, ("env",), (D,), CPU))
                  for r in range(D)]
        for full, *parts in zip(_leaves(s), *[_leaves(x) for x in shards]):
            assert torch.equal(full, torch.cat(parts, -1)) and parts[0].is_contiguous()
        for r in range(D):
            own = make_batched(HOPPER, b, device="cpu").reset(seed=3, first_env=r * b)
            for x, y in zip(_leaves(own), _leaves(shards[r])):
                assert x.dtype == y.dtype and torch.equal(x, y)
    back = pmesh.gather_env_state(pmesh.shard_env_state(s, world1), world1)
    _assert_states_equal(env_state_to_numpy(back), env_state_to_numpy(s))
    with pytest.raises(ValueError):
        pmesh.Mesh(3, 0, ("env",), (3,), CPU).block(16)


def test_world_of_one_is_the_unsharded_step(world1):
    """(a) a world-1 mesh's train step, bitwise"""
    cfg = ppo.PPOConfig(**PPO_KW, hidden=(16, 16))
    env = make_batched(HOPPER, 8, device="cpu")
    out = []
    for mesh in (None, world1):
        ts = ppo.init_train_state(0, env.observation_size, env.action_size, cfg, "cpu")
        if mesh is not None:
            pmesh.replicated(ts, mesh)
        step = ppo.make_train_step(env.task, cfg, step_fn=env.step_fn, mesh=mesh)
        ts, es, m = step(ts, env.reset(seed=5))
        out.append((ppo_leaves(ts), env_state_to_numpy(es), {k: float(x) for k, x in m.items()}))
    (la, ea, ma), (lb, eb, mb) = out
    for k, (x, y) in enumerate(zip(la, lb)):
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {k}")
    _assert_states_equal(ea, eb)
    assert ma == mb


@pytest.fixture(scope="module")
def world2():
    """One world of 2 ranks running (b), (c) and (d); the inputs from JAX."""
    gold = np.load(os.path.join(ROOT, "tests", "goldens", f"{HOPPER}.cpu.npz"))
    seed, B, T = int(gold["seed"]), 16, 5
    acts = np.random.default_rng(7).uniform(-1, 1, (T, B, 3)).astype(np.float32)
    acts[:, :2] = np.random.default_rng(seed).uniform(
        -1, 1, (int(gold["n_steps"]), 2, 3)).astype(np.float32)[:T]
    forced = np.zeros(B, bool)
    forced[2::3] = True
    steps = dict(env=HOPPER, seed=seed, actions=acts, forced=forced, forced_step=2)

    env_p, tsj = _jax_template(ppo_j.PPOConfig(**PPO_KW))
    esj_p = env_p.reset(seed=0)
    _, k_roll, _ = jax.random.split(tsj.key, 3)
    eps = np.stack([np.asarray(jax.random.normal(k, (8, env_p.action_size), jnp.float32))
                    for k in jax.random.split(k_roll, PPO_KW["rollout_length"])])
    ppo_job = dict(env=ANT, cfg=PPO_KW, trainstate=TRAINSTATE, eps=eps,
                   state=env_state_to_numpy(esj_p))

    env_s, ssj = _jax_state(sac_j.SACConfig(**SAC_KW))
    esj_s = env_s.reset(seed=0)
    draws = _jax_draws(ssj, esj_s, sac_j.SACConfig(**SAC_KW), env_s.action_size)
    sac_job = dict(env=MJ_HOPPER, cfg=SAC_KW, learner=LEARNER, state=env_state_to_numpy(esj_s),
                   draws={k: x.numpy() for k, x in draws.items()})

    user_forced = np.zeros(4, bool)
    user_forced[::3] = True
    user = dict(env=ut.SHAPED_ANT_ID, seed=5, forced=user_forced, forced_step=1,
                actions=np.random.default_rng(9).uniform(-1, 1, (3, 4, 8)).astype(np.float32))

    ranks = pmesh.launch(run_jobs, 2, {"steps": ("env_steps", steps), "ppo": ("ppo", ppo_job),
                                       "sac": ("sac", sac_job),
                                       "user": ("user_env_steps", user)},
                         device="cpu", timeout=300)
    return dict(ranks=ranks, steps=steps, gold=gold, ppo=(env_p, tsj, esj_p),
                sac=(env_s, ssj, esj_s), user=user)


def test_sharded_env_steps_are_the_unsharded_steps(world2):
    """(b)"""
    job, gold = world2["steps"], world2["gold"]
    env = make_batched(HOPPER, 16, device="cpu")
    s = env.reset(seed=job["seed"])
    for t, a in enumerate(job["actions"]):
        if t == job["forced_step"]:
            s = s._replace(terminated=s.terminated | torch.from_numpy(job["forced"]))
        s = env.step(s, torch.from_numpy(a))
        ref = env_state_to_numpy(s)
        for r in world2["ranks"]:
            _assert_states_equal(r["steps"]["states"][t], ref)
        np.testing.assert_array_equal(ref["terminated"][:2], gold["terminated"][t])
    assert (ref["epoch"] == job["forced"]).all()  # the forced envs reset, once
    med = np.median(np.abs(ref["obs"][:, :2] - gold["obs"][4]))
    assert med < 1e-3, med
    assert all(r["steps"]["launches"] == 0 for r in world2["ranks"])  # the plain step
    assert world2["ranks"][1]["mesh"] == (2, 1, ("env",), (2,))


def test_sharded_ppo_step_matches_jax(world2):
    """(c)"""
    env, tsj, esj = world2["ppo"]
    cfg_j = ppo_j.PPOConfig(**PPO_KW)
    tsj2, esj2, mj = jax.jit(ppo_j.make_train_step(env.task, cfg_j, step_fn=env._step))(tsj, esj)
    r0, r1 = (r["ppo"] for r in world2["ranks"])
    for a, b in zip(r0["leaves"], r1["leaves"]):
        np.testing.assert_array_equal(a, b)  # replicated, bit for bit
    assert r0["metrics"] == r1["metrics"]
    for k in ("loss", "done_frac", "value_mean"):
        np.testing.assert_allclose(r0["metrics"][k], float(mj[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(r0["metrics"]["reward_mean"], float(mj["reward_mean"]), atol=4e-3)
    leaves_j = jax.tree.leaves(tsj2)
    leaves_j = leaves_j[:40] + leaves_j[41:]  # the JAX key left out
    assert len(leaves_j) == len(r0["leaves"]) == 43
    for k, (a, b) in enumerate(zip(leaves_j, r0["leaves"])):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5, err_msg=f"leaf {k}")
    assert int(r0["leaves"][39]) == 22080 + 2
    assert not np.array_equal(r0["leaves"][0], np.load(TRAINSTATE)["leaf_0"])
    np.testing.assert_allclose(r0["state"]["obs"], np.asarray(esj2.obs), atol=1e-4)
    assert (r0["state"]["env_id"] == np.arange(8)).all()


def test_sharded_sac_iteration_matches_jax(world2):
    """(d)"""
    env, ssj, esj = world2["sac"]
    cfg_j = sac_j.SACConfig(**SAC_KW)
    ssj2, esj2, mj = jax.jit(sac_j.make_sac_iteration(env.task, cfg_j, step_fn=env._step))(
        ssj, esj)
    r0, r1 = (r["sac"] for r in world2["ranks"])
    for a, b in zip(r0["leaves"], r1["leaves"]):
        np.testing.assert_array_equal(a, b)
    assert r0["metrics"] == r1["metrics"]
    for k in ("reward_mean", "critic_loss", "actor_loss", "alpha"):
        np.testing.assert_allclose(r0["metrics"][k], float(mj[k]), rtol=1e-4, err_msg=k)
    leaves_j = jax.tree.leaves(_learner_of(ssj2))[:-1]
    n_actor = 6
    for k, (a, b) in enumerate(zip(leaves_j, r0["leaves"])):
        a = np.asarray(a)
        if a.dtype == np.int32:
            assert int(a) == int(b) == int(np.load(LEARNER)[f"leaf_{k}"]) + 2, k
        elif n_actor <= k < n_actor + 12:  # the saturated critics (test_torch_sac.py)
            off = ~np.isclose(b, a, rtol=1e-5, atol=1e-5)
            assert off.mean() <= 0.02 and np.abs(b - a).max() < cfg_j.learning_rate, k
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5, err_msg=f"leaf {k}")
    for rank, r in enumerate((r0, r1)):
        assert r["buf_ptr"] == int(ssj2.buf_ptr) == 2
        for name, x in r["ring"].items():
            ref = np.asarray(getattr(ssj2, name))[..., rank * 4:(rank + 1) * 4]
            np.testing.assert_allclose(x, ref, atol=1e-5, err_msg=f"rank {rank} {name}")
    np.testing.assert_allclose(r0["state"]["obs"], np.asarray(esj2.obs), atol=1e-5)


def test_ppo_step_on_a_host_env_mesh():
    """(e)"""
    cfg_kw = dict(rollout_length=4, num_epochs=1, num_minibatches=2, hidden=(16, 16),
                  entropy_coef=0.01)
    job = dict(env=PENDULUM, cfg=cfg_kw, batch=16, seed=0)
    ranks = pmesh.launch(run_jobs, 4, {"e": ("ppo_train", job)}, 2, device="cpu",
                         timeout=300)
    ts, es, m = ppo.train(PENDULUM, 16, 1, ppo.PPOConfig(**cfg_kw), seed=0, device="cpu")
    assert [r["mesh"][1:] for r in ranks] == [(k, ("host", "env"), (2, 2)) for k in range(4)]
    for r in ranks:
        for k, (a, b) in enumerate(zip(ppo_leaves(ts), r["e"]["leaves"])):
            np.testing.assert_allclose(b, a, atol=1e-5, err_msg=f"leaf {k}")
            np.testing.assert_array_equal(b, ranks[0]["e"]["leaves"][k])
        for k, x in m.items():
            assert np.isfinite(r["e"]["metrics"][k])
            np.testing.assert_allclose(r["e"]["metrics"][k], float(x), atol=1e-5, err_msg=k)
    np.testing.assert_allclose(ranks[0]["e"]["state"]["obs"], es.obs.numpy(), atol=1e-5)


def test_dryrun_multichip_on_cpu(capsys):
    """(f)"""
    rec = entry.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip(2): ok, loss=" in out and "gloo" in out
    assert np.isfinite(rec["loss"]) and rec["devices"] == ["cpu", "cpu"]
    assert rec["env_step_launches"] == [0, 0]  # the plain step on the CPU
    assert rec["physics_step_launches"] == [0, 0]


def test_sharded_user_task_steps_are_the_unsharded_steps(world2):
    """(g)"""
    from pybulletgym_tpu_torch.api import registry as reg
    from pybulletgym_tpu_torch.envs import locomotion as loco
    import pybulletgym_tpu_torch as pt

    job = world2["user"]
    saved = dict(reg.registry)
    pt.register(job["env"], ut.shaped_ant(loco, torch, ut.NN_TORCH), ut.SHAPED_ANT_STEPS)
    try:
        env = make_batched(job["env"], 4, device="cpu")
    finally:
        reg.registry.clear()
        reg.registry.update(saved)
    assert env.backend == "fused" and env.step_fn.kernel == "task_step_kernel"
    s = env.reset(seed=job["seed"])
    for t, a in enumerate(job["actions"]):
        if t == job["forced_step"]:
            s = s._replace(terminated=s.terminated | torch.from_numpy(job["forced"]))
        s = env.step(s, torch.from_numpy(a))
        ref = env_state_to_numpy(s)
        for r in world2["ranks"]:
            _assert_states_equal(r["user"]["states"][t], ref)
    assert (ref["epoch"] == job["forced"]).all() and "speed_avg" in ref["aux"]
    for r in world2["ranks"]:
        assert r["user"]["kernel"] == "task_step_kernel" and r["user"]["launches"] == 0
