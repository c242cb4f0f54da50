"""Soft Actor-Critic over batched envs: the off-policy companion to
`parallel.ppo` (counterpart of the JAX package's `parallel/sac.py`).

One `iteration` collects `steps_per_iter` env steps into an on-device
replay ring and then takes `updates_per_iter` gradient updates: twin-Q
critics, the tanh-squashed Gaussian actor, the entropy temperature, and
Polyak-averaged target critics. The ring is batch-trailing like `EnvState`
((slots, dim, B)); a minibatch gathers `batch_size` (slot, env) pairs. The
collect writes the ring's slots in place (the JAX package returns a new
ring), so the state passed in and the one returned share its tensors.

Written for eager PyTorch: the JAX package's `lax.scan`s are Python loops,
its `value_and_grad` is autograd, and `ppo._adam` is shared (with no
gradient clip, `max_norm=1e9`). The ring's write pointer and its full flag
are host integers (they follow from the iteration count alone), so the
warm-up test and the update gate need no device sync. On the GPU the
collect's env step is the CUDA `env_step_kernel` (`CudaEnvStep`), launched
once per collect step; the MLP products go to `torch.matmul`, as the JAX
package leaves them to XLA. No gradient flows through the env step.

The random draws come from the state's `torch.Generator`, so the port does
not draw the JAX package's numbers; `iteration(ss, es, draws=...)` takes
given draws instead, which is how a test feeds both the same numbers.

Over a mesh (`parallel.mesh`, data parallelism over the env axis) the
iteration computes what the JAX iteration computes under its global
sharding semantics (a minibatch drawn from the whole batch's replay):
  * collect and replay are sharded: each rank steps its block of the envs
    (one env-step kernel launch a collect step) and its ring holds only
    those envs; the collect's and the warm-up's noise is drawn for the
    whole batch from the replicated generator and sliced, and the actor
    runs on the rank's rows alone. The library may round a row apart at
    that shape (PPO's rollout avoids this with `mesh.global_rows`, for
    its 32 steps of contacts); a collect's 4 steps stay within the
    learner's bounds (tests/test_torch_mesh.py, `chip_smoke.py`), and
    the actor's forward at the global row count would cost a rank more
    than its env step at 16384 envs a rank
    (`tools/mesh_forward_cost.py`);
  * every rank draws the same global (slot, env) indices; each fills the
    rows of the envs it holds, and one all_gather gives every rank the
    minibatch's `batch_size` rows, bit for bit;
  * the update then runs alike on every rank, with no gradient collective:
    at batch_size 1024 and 256x256 MLPs, three gradient reductions an
    update would cost more than the repeated compute, and the ranks'
    parameters stay bitwise equal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from pybulletgym_tpu_torch.envs.base import EnvState, Task, make_env_step
from pybulletgym_tpu_torch.parallel import mesh as pmesh
from pybulletgym_tpu_torch.parallel.networks import MLPParams, init_mlp
from pybulletgym_tpu_torch.parallel.ppo import _adam


@dataclasses.dataclass(frozen=True)
class SACConfig:
    hidden: Tuple[int, ...] = (256, 256)
    discount: float = 0.99
    tau: float = 0.005              # Polyak rate for target critics
    learning_rate: float = 3e-4
    alpha_lr: float = 3e-4
    init_alpha: float = 0.2
    # entropy target: -act_dim (SAC default)
    buffer_slots: int = 512         # capacity = slots * num_envs transitions
    steps_per_iter: int = 4         # env steps collected per iteration
    updates_per_iter: int = 4       # gradient updates per iteration
    batch_size: int = 1024          # minibatch transitions per update
    warmup_steps: int = 32          # random-policy slots before learning
    pre_reg: float = 1e-3           # penalty on the pre-tanh mean's magnitude
    alpha_min: float = 0.01         # floor for the entropy temperature


class QParams(NamedTuple):
    q1: MLPParams
    q2: MLPParams

    def leaves(self) -> List[torch.Tensor]:
        return [*self.q1.leaves(), *self.q2.leaves()]


class SACState(NamedTuple):
    """sac.py · SACState. Each `opt_*` is (m, v, count): the Adam moments in
    the parameters' leaf order and an int32 count. `generator` draws the
    port's noise (the JAX package's `key`)."""

    actor: MLPParams                # outputs concat(mean, log_std)
    critics: QParams
    targets: QParams
    log_alpha: torch.Tensor         # () float32
    opt_actor: tuple
    opt_critic: tuple
    opt_alpha: tuple
    generator: torch.Generator
    # replay ring: (slots, dim, B) batch-trailing like EnvState
    buf_obs: torch.Tensor
    buf_act: torch.Tensor
    buf_rew: torch.Tensor           # (slots, B)
    buf_next_obs: torch.Tensor
    buf_nonterm: torch.Tensor       # (slots, B) 1 - terminated (truncation bootstraps)
    buf_ptr: int                    # next slot (host)
    buf_full: bool


LOG_STD_MIN, LOG_STD_MAX = -10.0, 2.0
_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def unflatten_mlp(leaves) -> MLPParams:
    """An MLPParams from its leaves: the weights, then the biases."""
    n = len(leaves) // 2
    return MLPParams(tuple(leaves[:n]), tuple(leaves[n:]))


def unflatten_q(leaves) -> QParams:
    """A QParams from its leaves: q1's, then q2's."""
    n = len(leaves) // 2
    return QParams(unflatten_mlp(leaves[:n]), unflatten_mlp(leaves[n:]))


def actor_dist(actor: MLPParams, obs):
    out = actor.apply(obs)
    mean, log_std = torch.chunk(out, 2, dim=-1)
    return mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)


def _squash(mean, log_std, eps):
    """tanh(mean + std·eps) and its change-of-variables log-prob."""
    a = torch.tanh(mean + torch.exp(log_std) * eps)
    logp = torch.sum(-0.5 * eps ** 2 - log_std - _HALF_LOG_2PI - torch.log(1.0 - a ** 2 + 1e-6),
                     dim=-1)
    return a, logp


def sample_action(actor: MLPParams, obs, eps):
    """tanh-squashed Gaussian (sac.py · sample_action) with the standard
    normal noise `eps` of the mean's shape given."""
    mean, log_std = actor_dist(actor, obs)
    return _squash(mean, log_std, eps)


def det_action(actor: MLPParams, obs):
    mean, _ = actor_dist(actor, obs)
    return torch.tanh(mean)


def q_apply(q: MLPParams, obs, act):
    return q.apply(torch.cat([obs, act], dim=-1))[..., 0]


def _opt(leaves):
    return ([torch.zeros_like(x) for x in leaves], [torch.zeros_like(x) for x in leaves],
            torch.zeros((), dtype=torch.int32, device=leaves[0].device))


def init_sac_state(seed: int, obs_dim: int, act_dim: int, num_envs: int, cfg: SACConfig,
                   device="cuda") -> SACState:
    """Fresh learner (sac.py · init_sac_state) from a seeded torch.Generator,
    an empty ring; on the GPU unless the caller asks for the CPU."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    actor = init_mlp((obs_dim, *cfg.hidden, 2 * act_dim), 0.01, gen, dev)
    q = [init_mlp((obs_dim + act_dim, *cfg.hidden, 1), 1.0, gen, dev) for _ in range(2)]
    critics = QParams(*q)
    targets = unflatten_q([x.clone() for x in critics.leaves()])
    log_alpha = torch.tensor(math.log(cfg.init_alpha), dtype=torch.float32, device=dev)
    return empty_ring(actor, critics, targets, log_alpha, _opt(actor.leaves()),
                      _opt(critics.leaves()), _opt([log_alpha]), gen, obs_dim, act_dim,
                      num_envs, cfg)


def empty_ring(actor, critics, targets, log_alpha, opt_actor, opt_critic, opt_alpha, generator,
               obs_dim, act_dim, num_envs, cfg) -> SACState:
    """An SACState of the given learner with an empty replay ring."""
    S, B, dev = cfg.buffer_slots, num_envs, log_alpha.device
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)  # noqa: E731
    return SACState(actor, critics, targets, log_alpha, opt_actor, opt_critic, opt_alpha,
                    generator, z(S, obs_dim, B), z(S, act_dim, B), z(S, B), z(S, obs_dim, B),
                    torch.ones((S, B), dtype=torch.float32, device=dev), 0, False)


def make_sac_iteration(task: Task, cfg: SACConfig, step_fn: Optional[Callable] = None,
                       mesh: Optional[pmesh.Mesh] = None):
    """iteration(ss, es, draws=None) -> (ss, es, metrics).

    `step_fn(state, action (act, B))` is the env step; by default
    `make_env_step(task)`: one kernel launch a step for any task (the plain
    version on CPU tensors). `draws`,
    if given, replaces every random draw: "pi_eps" and "a_rand" (T, B, act)
    per collect step (the policy noise, the warm-up's uniform actions);
    "slots" and "envs" (U, batch) int64, "next_eps" and "pi_eps_upd" (U,
    batch, act) per update (the minibatch, the next action's noise, the
    actor's noise). With a `mesh`, `es` and the ring are this rank's shard
    (`sac_state_from_npz(path, B // mesh.world, ...)`), the learner is
    replicated, the draws span the global batch and the metrics are the
    global batch's (module docstring)."""
    if step_fn is None:
        step_fn = make_env_step(task)
    act_dim = task.act_dim
    target_entropy = -float(act_dim)
    S, T, U, N = cfg.buffer_slots, cfg.steps_per_iter, cfg.updates_per_iter, cfg.batch_size
    log_alpha_min = math.log(cfg.alpha_min)
    D, rank = (1, 0) if mesh is None else (mesh.world, mesh.rank)

    def normal(gen, shape, dev):
        return torch.randn(shape, generator=gen, device=dev)

    @torch.no_grad()
    def collect(ss: SACState, es: EnvState, draws, random_policy: bool):
        B, dev = es.obs.shape[-1], es.obs.device
        rows = slice(rank * B, (rank + 1) * B)  # this rank's block of the global batch
        rews = []
        for t in range(T):
            obs = es.obs.T
            if random_policy:
                a = (draws["a_rand"][t] if draws else
                     torch.rand((B * D, act_dim), generator=ss.generator, device=dev) * 2 - 1)
                a = a[rows]
            else:
                eps = draws["pi_eps"][t] if draws else normal(ss.generator, (B * D, act_dim), dev)
                a, _ = sample_action(ss.actor, obs, eps[rows])
            es2 = step_fn(es, a.T.contiguous())
            # next-step autoreset: es2.obs at done IS the terminal obs
            ptr = ss.buf_ptr % S
            ss.buf_obs[ptr] = es.obs
            ss.buf_act[ptr] = a.T
            ss.buf_rew[ptr] = es2.reward
            ss.buf_next_obs[ptr] = es2.obs
            ss.buf_nonterm[ptr] = 1.0 - es2.terminated.to(torch.float32)
            ss = ss._replace(buf_ptr=ss.buf_ptr + 1, buf_full=ss.buf_full or ss.buf_ptr + 1 >= S)
            rews.append(es2.reward)
            es = es2
        return ss, es, torch.stack(rews)

    def sample_batch(ss: SACState, u, draws):
        B, dev = ss.buf_rew.shape[-1], ss.buf_rew.device
        if draws:
            slots, envs = draws["slots"][u], draws["envs"][u]
        else:
            hi = S if ss.buf_full else max(ss.buf_ptr, 1)
            slots = torch.randint(0, hi, (N,), generator=ss.generator, device=dev)
            envs = torch.randint(0, B * D, (N,), generator=ss.generator, device=dev)
        if mesh is None:
            return (ss.buf_obs[slots, :, envs], ss.buf_act[slots, :, envs],
                    ss.buf_rew[slots, envs], ss.buf_next_obs[slots, :, envs],
                    ss.buf_nonterm[slots, envs])
        # every rank fills every row from its own ring (a row of an env it does
        # not hold reads its env 0), and each row is then taken from its owner
        owner = torch.div(envs, B, rounding_mode="floor")
        local = torch.where(owner == rank, envs - rank * B, torch.zeros_like(envs))
        mine = torch.cat([ss.buf_obs[slots, :, local], ss.buf_act[slots, :, local],
                          ss.buf_rew[slots, local][:, None], ss.buf_next_obs[slots, :, local],
                          ss.buf_nonterm[slots, local][:, None]], 1)
        parts = pmesh.all_gather_env([mine], mesh, [0])[0].view(D, N, -1)
        full = parts[owner, torch.arange(N, device=dev)]
        obs_dim = ss.buf_obs.shape[1]
        obs, act, rew, next_obs, nonterm = full.split([obs_dim, act_dim, 1, obs_dim, 1], 1)
        return obs, act, rew[:, 0], next_obs, nonterm[:, 0]

    def update(ss: SACState, u, draws):
        obs, act, rew, next_obs, nonterm = sample_batch(ss, u, draws)
        dev = obs.device
        eps_next = draws["next_eps"][u] if draws else normal(ss.generator, (N, act_dim), dev)
        eps_pi = draws["pi_eps_upd"][u] if draws else normal(ss.generator, (N, act_dim), dev)
        with torch.no_grad():
            alpha = torch.exp(ss.log_alpha)
            na, nlogp = sample_action(ss.actor, next_obs, eps_next)
            tq = torch.minimum(q_apply(ss.targets.q1, next_obs, na),
                               q_apply(ss.targets.q2, next_obs, na))
            y = rew + cfg.discount * nonterm * (tq - alpha * nlogp)

        cleaves = [x.detach().requires_grad_(True) for x in ss.critics.leaves()]
        crit = unflatten_q(cleaves)
        e1 = q_apply(crit.q1, obs, act) - y
        e2 = q_apply(crit.q2, obs, act) - y
        closs = 0.5 * torch.mean(e1 ** 2 + e2 ** 2)
        cgrad = torch.autograd.grad(closs, cleaves)
        m, v, c = ss.opt_critic
        new, m, v, c = _adam([x.detach() for x in cleaves], cgrad, m, v, c,
                             cfg.learning_rate, max_norm=1e9)
        critics, opt_critic = unflatten_q(new), (m, v, c)

        aleaves = [x.detach().requires_grad_(True) for x in ss.actor.leaves()]
        mean, log_std = actor_dist(unflatten_mlp(aleaves), obs)
        a, logp = _squash(mean, log_std, eps_pi)
        q = torch.minimum(q_apply(critics.q1, obs, a), q_apply(critics.q2, obs, a))
        reg = cfg.pre_reg * torch.mean(torch.sum(mean ** 2, dim=-1))
        aloss = torch.mean(alpha * logp - q) + reg
        agrad = torch.autograd.grad(aloss, aleaves)
        m, v, c = ss.opt_actor
        new, m, v, c = _adam([x.detach() for x in aleaves], agrad, m, v, c,
                             cfg.learning_rate, max_norm=1e9)
        actor, opt_actor = unflatten_mlp(new), (m, v, c)

        with torch.no_grad():
            # d/dlog_alpha of -mean(log_alpha * (logp + target_entropy))
            gl = -torch.mean(logp.detach() + target_entropy)
            m, v, c = ss.opt_alpha
            (log_alpha,), m, v, c = _adam([ss.log_alpha], [gl], m, v, c, cfg.alpha_lr,
                                          max_norm=1e9)
            log_alpha = torch.clamp(log_alpha, min=log_alpha_min)
            targets = unflatten_q([(1 - cfg.tau) * t + cfg.tau * p for t, p in
                                   zip(ss.targets.leaves(), critics.leaves())])
        ss = ss._replace(actor=actor, critics=critics, targets=targets, log_alpha=log_alpha,
                         opt_actor=opt_actor, opt_critic=opt_critic, opt_alpha=(m, v, c))
        return ss, (closs.detach(), aloss.detach(), torch.exp(log_alpha))

    def iteration(ss: SACState, es: EnvState, draws: Optional[Dict[str, torch.Tensor]] = None):
        random_policy = (not ss.buf_full) and ss.buf_ptr < cfg.warmup_steps
        ss, es, rews = collect(ss, es, draws, random_policy)
        zero = torch.zeros((), dtype=torch.float32, device=rews.device)
        metrics = (zero, zero, torch.exp(ss.log_alpha))
        if ss.buf_full or ss.buf_ptr >= cfg.warmup_steps:
            for u in range(U):
                ss, metrics = update(ss, u, draws)
        closs, aloss, alpha = metrics
        if mesh is not None:
            rews = pmesh.all_gather_env([rews], mesh, [1])[0]
        return ss, es, {"reward_mean": rews.mean(), "critic_loss": closs,
                        "actor_loss": aloss, "alpha": alpha}

    return iteration
