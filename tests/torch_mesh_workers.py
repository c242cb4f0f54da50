"""Rank functions for tests/test_torch_mesh.py. Each runs in a process of its
own, started by `pybulletgym_tpu_torch.parallel.mesh.launch` (spawn), which
imports this module by name: it imports no JAX. Inputs and results cross as
numpy arrays."""

import torch

from pybulletgym_tpu_torch import make_batched, make_task
from pybulletgym_tpu_torch.parallel import mesh as pmesh
from pybulletgym_tpu_torch.parallel import ppo, sac
from pybulletgym_tpu_torch.utils.interop import (
    env_state_from_numpy, env_state_to_numpy, sac_state_from_npz, train_state_from_npz,
)


def _np(x):
    return x.detach().cpu().numpy().copy()  # a copy: the learners update in place


def ppo_leaves(ts):
    """A TrainState's tensors in the JAX flatten order, the key left out."""
    return [_np(x) for x in [*ts.params.leaves(), *ts.opt_m, *ts.opt_v, ts.opt_count,
                             *ts.obs_stats]]


def sac_leaves(ss):
    """An SACState's learner in the JAX flatten order, the key left out."""
    def opt(o):
        return [*o[0], *o[1], o[2]]
    return [_np(x) for x in [*ss.actor.leaves(), *ss.critics.leaves(), *ss.targets.leaves(),
                             ss.log_alpha, *opt(ss.opt_actor), *opt(ss.opt_critic),
                             *opt(ss.opt_alpha)]]


def _env_steps(mesh, job):
    """(b) the rank resets its block of the batch (`first_env`) and steps it;
    the gathered state after every step."""
    B = job["actions"].shape[1]
    lo, hi = mesh.block(B)
    env = make_batched(job["env"], hi - lo, device="cpu")
    assert env.backend == "fused"
    s = env.reset(seed=job["seed"], first_env=lo)
    out = []
    for t, a in enumerate(job["actions"]):
        if t == job["forced_step"]:
            s = s._replace(terminated=s.terminated | torch.from_numpy(job["forced"][lo:hi]))
        s = env.step(s, torch.from_numpy(a[lo:hi]))
        out.append(env_state_to_numpy(pmesh.gather_env_state(s, mesh)))
    return dict(states=out, launches=env.step_fn.launches, kernel=env.step_fn.kernel)


def _user_env_steps(mesh, job):
    """(g) a user's task by its ID (ShapedAnt, registered in the rank, its
    hooks translated there): as (b)."""
    import pybulletgym_tpu_torch as pt
    from pybulletgym_tpu_torch.envs import locomotion as loco
    import torch_user_tasks as ut

    pt.register(job["env"], ut.shaped_ant(loco, torch, ut.NN_TORCH), ut.SHAPED_ANT_STEPS)
    return _env_steps(mesh, job)


def _ppo_step(mesh, job):
    """(c) one sharded PPO train step from a checkpoint, fed given noise."""
    cfg = ppo.PPOConfig(**job["cfg"])
    ts, _ = train_state_from_npz(job["trainstate"], device="cpu")
    es = pmesh.shard_env_state(env_state_from_numpy(job["state"], device="cpu"), mesh)
    step = ppo.make_train_step(make_task(job["env"]), cfg, mesh=mesh)
    ts, es, m = step(pmesh.replicated(ts, mesh), es, eps=torch.from_numpy(job["eps"]))
    return dict(metrics={k: float(x) for k, x in m.items()}, leaves=ppo_leaves(ts),
                state=env_state_to_numpy(pmesh.gather_env_state(es, mesh)))


def _sac_iteration(mesh, job):
    """(d) one sharded SAC iteration from the shipped learner, fed given draws."""
    cfg = sac.SACConfig(**job["cfg"])
    B = job["state"]["q"].shape[-1]
    ss = sac_state_from_npz(job["learner"], B // mesh.world, cfg, device="cpu")
    es = pmesh.shard_env_state(env_state_from_numpy(job["state"], device="cpu"), mesh)
    draws = {k: torch.from_numpy(x) for k, x in job["draws"].items()}
    it = sac.make_sac_iteration(make_task(job["env"]), cfg, mesh=mesh)
    ss, es, m = it(ss, es, draws=draws)
    ring = {k: _np(getattr(ss, k)) for k in ("buf_obs", "buf_act", "buf_rew", "buf_next_obs",
                                             "buf_nonterm")}
    return dict(metrics={k: float(x) for k, x in m.items()}, leaves=sac_leaves(ss), ring=ring,
                buf_ptr=ss.buf_ptr, state=env_state_to_numpy(pmesh.gather_env_state(es, mesh)))


def _ppo_train(mesh, job):
    """(e) `ppo.train` over the mesh for one step, from a fresh, seeded
    learner: each rank resets its own block."""
    ts, es, m = ppo.train(job["env"], job["batch"], 1, ppo.PPOConfig(**job["cfg"]),
                          seed=job["seed"], mesh=mesh)
    return dict(metrics={k: float(x) for k, x in m.items()}, leaves=ppo_leaves(ts),
                state=env_state_to_numpy(pmesh.gather_env_state(es, mesh)))


JOBS = {"env_steps": _env_steps, "user_env_steps": _user_env_steps, "ppo": _ppo_step,
        "sac": _sac_iteration, "ppo_train": _ppo_train}


def run_jobs(jobs, hosts=None):
    """Every job of `jobs` ({name: (kind, inputs)}) in one world of ranks on
    the CPU, on a ('env',) mesh or, with `hosts`, a ('host', 'env') one."""
    torch.set_num_threads(2)
    mesh = (pmesh.make_mesh(device="cpu") if hosts is None
            else pmesh.make_mesh_2d(hosts, device="cpu"))
    out = {"mesh": (mesh.world, mesh.rank, mesh.axis_names, mesh.shape)}
    for name, (kind, job) in jobs.items():
        out[name] = JOBS[kind](mesh, job)
    return out

