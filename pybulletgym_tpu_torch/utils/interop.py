"""Carry env state and policy weights between the JAX package and the port.

States cross as plain numpy: a dict with the `EnvState` field names, whose
`aux` and `rewards` entries are dicts of (B,) arrays. Weights cross as the
npz files that `examples/weights/` ships (keys `n_layers`, `w{i}`, `b{i}`,
optional `normalized`/`obs_mean`/`obs_var` and `squash`). A PPO learner's
state, and a SAC learner's (`*.saclearner.npz`), cross as the JAX package's
`utils/checkpoint.py` npz (`leaf_{i}`, read with numpy alone).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pybulletgym_tpu_torch.envs.base import EnvState
from pybulletgym_tpu_torch.parallel.networks import ActorCritic, MLPPolicy

_DTYPES = {
    "q": torch.float32, "v": torch.float32, "obs": torch.float32,
    "reward": torch.float32, "terminated": torch.bool, "truncated": torch.bool,
    "step_count": torch.int32, "epoch": torch.uint32, "env_id": torch.int32,
    "seed": torch.uint32,
}


def env_state_from_numpy(d: Dict, device="cuda") -> EnvState:
    """numpy dict (JAX `EnvState` field names) -> the port's `EnvState` on
    `device` (the GPU unless the caller asks for the CPU, as every entry
    point of the port)."""
    def t(x, dtype):
        return torch.as_tensor(np.array(x, copy=True)).to(dtype).to(device)

    fields = {k: t(d[k], dt) for k, dt in _DTYPES.items()}
    fields["aux"] = {k: t(d["aux"][k], torch.float32) for k in sorted(d["aux"])}
    fields["rewards"] = {k: t(d["rewards"][k], torch.float32) for k in sorted(d["rewards"])}
    return EnvState(**fields)


def env_state_to_numpy(state) -> Dict:
    """An `EnvState` of either package -> numpy dict with the same fields."""
    out = {}
    for k in _DTYPES:
        x = getattr(state, k)
        out[k] = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    for k in ("aux", "rewards"):
        out[k] = {
            n: (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))
            for n, x in getattr(state, k).items()
        }
    return out


def policy_from_npz(path: str, device="cuda") -> MLPPolicy:
    """A shipped policy npz -> `MLPPolicy` on `device` (the GPU unless the
    caller asks for "cpu")."""
    with np.load(path) as d:
        n = int(d["n_layers"])
        ws = [torch.as_tensor(d[f"w{i}"], dtype=torch.float32) for i in range(n)]
        bs = [torch.as_tensor(d[f"b{i}"], dtype=torch.float32) for i in range(n)]
        norm = None
        if "normalized" in d and bool(d["normalized"]):
            norm = (torch.as_tensor(d["obs_mean"], dtype=torch.float32),
                    torch.as_tensor(d["obs_var"], dtype=torch.float32))
        squash = "squash" in d and bool(d["squash"])
    return MLPPolicy(ws, bs, squash=squash, norm=norm).to(device)


def policy_to_npz(path: str, ts, normalized: Optional[bool] = None) -> None:
    """Write a PPO `TrainState`'s networks as the JAX package's example
    scripts write them (the keys `policy_from_npz` and `examples/enjoy.py`
    read): `n_layers`, `log_std`, `w{i}`, `b{i}`, `vw{i}`, `vb{i}`; with
    `normalized` (True or False, as `examples/train_loop.py` writes) also
    `obs_mean`, `obs_var` and `normalized`."""
    def np_(x):
        return x.detach().cpu().numpy()

    p = ts.params
    extra = {} if normalized is None else dict(
        obs_mean=np_(ts.obs_stats.mean), obs_var=np_(ts.obs_stats.var),
        normalized=bool(normalized))
    np.savez_compressed(
        path,
        n_layers=len(p.policy_w),
        log_std=np_(p.log_std),
        **{f"w{i}": np_(w) for i, w in enumerate(p.policy_w)},
        **{f"b{i}": np_(b) for i, b in enumerate(p.policy_b)},
        **{f"vw{i}": np_(w) for i, w in enumerate(p.value_w)},
        **{f"vb{i}": np_(b) for i, b in enumerate(p.value_b)},
        **extra,
    )


def train_state_from_npz(path: str, device="cuda", seed: int = 0) -> Tuple[object, np.ndarray]:
    """A JAX `ppo.TrainState` checkpoint (`utils/checkpoint.py · save`) ->
    (the port's `ppo.TrainState` on `device`, the JAX key as uint32[2]).

    The leaves are in `jax.tree.flatten(TrainState)` order: params
    (policy weights, policy biases, value weights, value biases, log_std),
    opt_m and opt_v (each like params), opt_count, key, obs_stats (mean,
    var, count). The layer count follows from the number of leaves. The JAX
    key is returned as data; the port's sampling draws from a
    torch.Generator seeded with `seed`."""
    from pybulletgym_tpu_torch.parallel.ppo import ObsStats, TrainState

    dev = torch.device(device)
    with np.load(path) as d:
        leaves = []
        while f"leaf_{len(leaves)}" in d:
            leaves.append(np.array(d[f"leaf_{len(leaves)}"]))
    n_params = (len(leaves) - 5) // 3
    n_layers = (n_params - 1) // 4
    if len(leaves) != 3 * n_params + 5 or n_params != 4 * n_layers + 1 or n_layers < 1:
        raise ValueError(f"{path}: {len(leaves)} leaves do not form a PPO TrainState")
    t = lambda x: torch.as_tensor(x, dtype=torch.float32).to(dev)  # noqa: E731

    def params(xs):
        L = n_layers
        return xs[:L], xs[L:2 * L], xs[2 * L:3 * L], xs[3 * L:4 * L], xs[4 * L]

    pw, pb, vw, vb, log_std = params([t(x) for x in leaves[:n_params]])
    ac = ActorCritic(pw, pb, vw, vb, log_std)
    shapes = [tuple(p.shape) for p in ac.leaves()]
    opt_m = [t(x) for x in leaves[n_params:2 * n_params]]
    opt_v = [t(x) for x in leaves[2 * n_params:3 * n_params]]
    if [tuple(x.shape) for x in opt_m] != shapes or [tuple(x.shape) for x in opt_v] != shapes:
        raise ValueError(f"{path}: Adam moments do not match the parameters' shapes")
    count, key, mean, var, n_seen = leaves[3 * n_params:]
    stats = ObsStats(t(mean), t(var), t(n_seen))
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    ts = TrainState(ac, opt_m, opt_v, torch.as_tensor(count, dtype=torch.int32).to(dev), gen, stats)
    return ts, np.asarray(key, np.uint32)


def _leaves(path):
    with np.load(path) as d:
        leaves = []
        while f"leaf_{len(leaves)}" in d:
            leaves.append(np.array(d[f"leaf_{len(leaves)}"]))
    return leaves


def sac_state_from_npz(path: str, num_envs: int, cfg=None, device="cuda"):
    """A shipped SAC learner (`*.saclearner.npz`: the JAX tuple (actor,
    critics, targets, log_alpha, opt_actor, opt_critic, opt_alpha, key),
    tools/train_campaign.py · learner_of) -> the port's `sac.SACState` on
    `device` for `num_envs` envs, with an empty replay ring of
    `cfg.buffer_slots` slots.

    The leaves are in `jax.tree.flatten` order: the actor's weights then
    biases; each critic's (q1, q2), then the targets' likewise; log_alpha;
    the actor's Adam moments m, v and count; the critics' likewise; the
    temperature's (m, v, count); the key. The layer count follows from the
    number of leaves (73 for two hidden layers). The port's draws come from
    a torch.Generator seeded with the key's two words, (k0 << 32) | k1."""
    from pybulletgym_tpu_torch.parallel import sac

    cfg = cfg or sac.SACConfig()
    dev = torch.device(device)
    leaves = _leaves(path)
    # L layers: actor 2L, critics 4L, targets 4L, log_alpha, actor moments
    # 2 x 2L + count, critic moments 2 x 4L + count, (m, v, count), key
    L = (len(leaves) - 7) // 22
    if len(leaves) != 22 * L + 7 or L < 1:
        raise ValueError(f"{path}: {len(leaves)} leaves do not form a SAC learner")
    t = lambda x: torch.as_tensor(x).to(dev)  # noqa: E731
    xs = [t(x) for x in leaves]
    cut = iter(np.cumsum([2 * L, 4 * L, 4 * L, 1, 2 * L, 2 * L, 1, 4 * L, 4 * L, 1, 1, 1, 1]))
    parts, start = [], 0
    for end in cut:
        parts.append(xs[start:end])
        start = end
    actor_l, crit_l, targ_l, (log_alpha,), am, av, (ac,), cm, cv, (cc,), (lm,), (lv,), (lc,) = \
        parts[:13]
    key = np.asarray(leaves[-1], np.uint32)
    if key.shape != (2,):
        raise ValueError(f"{path}: the last leaf is not a JAX key")
    actor, critics = sac.unflatten_mlp(actor_l), sac.unflatten_q(crit_l)
    obs_dim, act_dim = actor.weights[0].shape[0], actor.weights[-1].shape[1] // 2
    if [tuple(x.shape) for x in am] != [tuple(x.shape) for x in actor_l] or \
            [tuple(x.shape) for x in cm] != [tuple(x.shape) for x in crit_l]:
        raise ValueError(f"{path}: Adam moments do not match the parameters' shapes")
    if tuple(cfg.hidden) != tuple(w.shape[1] for w in actor.weights[:-1]):
        raise ValueError(f"{path}: hidden sizes differ from the config's {cfg.hidden}")
    i32 = lambda x: x.to(torch.int32)  # noqa: E731
    gen = torch.Generator(device=dev).manual_seed((int(key[0]) << 32) | int(key[1]))
    return sac.empty_ring(actor, critics, sac.unflatten_q(targ_l), log_alpha,
                          (am, av, i32(ac)), (cm, cv, i32(cc)), ([lm], [lv], i32(lc)), gen,
                          obs_dim, act_dim, int(num_envs), cfg)
