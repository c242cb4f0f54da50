"""Entry points of the port: the flagship env step, and a dry run of the
sharded PPO train step (the counterparts of `__graft_entry__.entry` and
`__graft_entry__.dryrun_multichip` in the JAX package).

    python -c "from pybulletgym_tpu_torch import entry; entry.dryrun_multichip(2)"
"""

from __future__ import annotations

import math

import torch

CHEETAH = "HalfCheetahPyBulletEnv-v0"


def entry(device="cuda"):
    """(fn, example_args) for the flagship step: the batched HalfCheetah env
    step (BASELINE.md config 3), one env-step kernel launch on the card
    (B=1024), the plain version on the CPU (B=256)."""
    from pybulletgym_tpu_torch.api.registry import make_batched

    B = 1024 if torch.device(device).type == "cuda" else 256
    env = make_batched(CHEETAH, B, device=device)
    state = env.reset(seed=0)
    action = torch.zeros((env.action_size, B), device=env.device)
    return env.step_fn, (state, action)


def _dryrun_rank(device):
    import torch.distributed as dist

    from pybulletgym_tpu_torch.api.registry import make_batched
    from pybulletgym_tpu_torch.ops import cuda_engine as ce
    from pybulletgym_tpu_torch.parallel import mesh as pmesh
    from pybulletgym_tpu_torch.parallel import ppo

    mesh = pmesh.make_mesh(device=device)
    b = 8  # envs a rank: B = 8 n, as the JAX dry run
    env = make_batched("HopperPyBulletEnv-v0", b, device=mesh.device)
    cfg = ppo.PPOConfig(rollout_length=4, num_epochs=2, num_minibatches=2, hidden=(32, 32))
    ts = pmesh.replicated(ppo.init_train_state(0, env.observation_size, env.action_size, cfg,
                                               mesh.device), mesh)
    es = env.reset(seed=0, first_env=mesh.rank * b)
    step = ppo.make_train_step(env.task, cfg, step_fn=env.step_fn, mesh=mesh)
    ce.reset_launch_counts()
    ts, es, metrics = step(ts, es)
    return dict(backend=dist.get_backend(), device=str(mesh.device),
                loss=float(metrics["loss"]), reward_mean=float(metrics["reward_mean"]),
                env_step_launches=ce.LAUNCHES["env_step_kernel"],
                physics_step_launches=ce.LAUNCHES["physics_step_kernel"])


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One sharded PPO train step (rollout, GAE, minibatch updates) over an
    n_devices ``('env',)`` mesh on tiny shapes: Hopper, B = 8 n_devices,
    rollout 4, 2 epochs x 2 minibatches, hidden 32x32. The ranks are new
    processes (`parallel.mesh.launch`): one a card over NCCL when there are
    n_devices cards, else sharing the cards over gloo; on the CPU (gloo)
    only when the caller passes device="cpu". Prints the backend and the
    devices, then ``dryrun_multichip(n): ok, loss=..., reward_mean=...``;
    returns rank 0's record (and each rank's device)."""
    from pybulletgym_tpu_torch.parallel import mesh as pmesh

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip(device='cuda'): no CUDA device is available")
    if torch.device(device).type == "cuda":
        from pybulletgym_tpu_torch.ops import cuda_engine as ce

        ce.load_cuda_library()  # build once here, not once a rank
    ranks = pmesh.launch(_dryrun_rank, n_devices, device, device=device)
    rec = dict(ranks[0], devices=[r["device"] for r in ranks],
               env_step_launches=[r["env_step_launches"] for r in ranks],
               physics_step_launches=[r["physics_step_launches"] for r in ranks])
    print(f"dryrun_multichip({n_devices}): {rec['backend']} over {rec['devices']}", flush=True)
    if not math.isfinite(rec["loss"]):
        raise RuntimeError(f"dryrun_multichip({n_devices}): non-finite loss {rec['loss']}")
    print(f"dryrun_multichip({n_devices}): ok, loss={rec['loss']:.4f}, "
          f"reward_mean={rec['reward_mean']:.4f}", flush=True)
    return rec
