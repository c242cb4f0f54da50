"""PPO learner (BASELINE.md config 4: Ant, 4096 envs, full rollout loop):
rollout -> GAE -> clipped-surrogate updates with Adam.

Counterpart of the JAX package's `parallel/ppo.py`, written for eager
PyTorch: the rollout and the GAE recursion are Python loops over time (the
JAX package's `lax.scan`s), the gradient comes from autograd (its
`jax.value_and_grad`), and `_adam` repeats its update formula for formula,
global-norm clip and bias-correction order included (`torch.optim.Adam`
orders its arithmetic differently). Minibatches are contiguous env-axis
slices, as there.

On the GPU the rollout's env step is the CUDA `env_step_kernel` (the
wrapper `ops.cuda_engine.CudaEnvStep`), launched once per rollout step; the
MLP products go to `torch.matmul`. No gradient flows through the env step,
as in the JAX package.

The sampling noise comes from a `torch.Generator`, so the port does not
draw the JAX package's numbers; `train_step(..., eps=...)` takes given
noise instead, which is how a test feeds both the same draws.

Over a mesh (`parallel.mesh`, data parallelism over the env axis) each
rank steps its block of the envs and replicates everything else:
  * the rollout is sharded: the env-step kernel is launched on the rank's
    envs. The policy runs on the rank's rows placed among zeros at the
    global batch's row count (`mesh.global_rows`): the library picks its
    GEMM by shape, and at a shard's row count it rounds the policy's first
    product differently (measured on the H100 at 2048 against 4096 rows),
    an ulp that 32 steps of contacts grow to 0.2 in the observations. At
    the global shape each row rounds as it does unsharded, and the sharded
    rollout is bitwise the unsharded one. The noise is drawn for the whole
    batch from the replicated generator, so a sharded run draws the numbers
    an unsharded one draws;
  * one all_gather of the trajectory, the raw observations and the last
    values; GAE, the minibatch membership (contiguous env slices of the
    global batch), the advantage normalisation and the observation
    statistics are then computed on every rank by the unsharded formulas;
  * each rank takes a 1/D share of a minibatch's env columns; its losses
    are its rows' means times 1/D (so that the ranks' sum is the
    minibatch's mean), the entropy term, which depends on `log_std` alone,
    is added on rank 0 only, and the gradients (with the loss) are summed
    over the ranks in one all_reduce of a flat buffer, which hands every
    rank the same bits (ring and tree reductions reduce each chunk once and
    send it on). Adam then runs alike on every rank, and the parameters
    stay bitwise replicated (held by the tests and `chip_smoke.py`).
The gradient's products run on a share of a minibatch's rows, which the
library may round differently for another shape, and the ranks' partial
sums add in another order: the parameters agree with the unsharded step's
within rounding, not bitwise. A world of one rank is bitwise the unsharded
step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from pybulletgym_tpu_torch.envs.base import EnvState, Task, make_env_step
from pybulletgym_tpu_torch.parallel import mesh as pmesh
from pybulletgym_tpu_torch.parallel.networks import ActorCritic


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    rollout_length: int = 32
    num_epochs: int = 4
    num_minibatches: int = 4
    discount: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.0
    learning_rate: float = 3e-4
    max_grad_norm: float = 0.5
    hidden: Tuple[int, ...] = (64, 64)
    normalize_obs: bool = False
    # 0 = constant lr; otherwise linear anneal to 0 over this many Adam
    # updates (= iters * num_epochs * num_minibatches)
    total_updates: int = 0


class ObsStats(NamedTuple):
    """Running observation statistics (parallel Welford)."""

    mean: torch.Tensor   # (obs_dim,)
    var: torch.Tensor    # (obs_dim,)
    count: torch.Tensor  # () float32

    def normalize(self, obs):
        return torch.clamp((obs - self.mean) / torch.sqrt(self.var + 1e-8), -10.0, 10.0)

    def update(self, obs2d):
        """Fold a (N, obs_dim) batch of observations."""
        # n as a float32 tensor: `scalar / tensor` would multiply by a
        # reciprocal and round differently from the JAX package's division
        n = torch.tensor(float(obs2d.shape[0]), device=obs2d.device)
        bm = obs2d.mean(0)
        centered = obs2d - bm
        bv = (centered * centered).mean(0)  # jnp.var's two-pass formula
        tot = self.count + n
        delta = bm - self.mean
        mean = self.mean + delta * (n / tot)
        m2 = self.var * self.count + bv * n + delta ** 2 * self.count * n / tot
        return ObsStats(mean, m2 / tot, tot)


class TrainState(NamedTuple):
    params: ActorCritic
    opt_m: List[torch.Tensor]   # Adam first moment, in `params.leaves()` order
    opt_v: List[torch.Tensor]   # Adam second moment
    opt_count: torch.Tensor     # () int32: Adam updates so far
    generator: torch.Generator  # the rollout's sampling noise
    obs_stats: ObsStats


class Transition(NamedTuple):
    obs: torch.Tensor        # (B, obs_dim)
    action: torch.Tensor     # (B, act)
    logp: torch.Tensor       # (B,)
    value: torch.Tensor      # (B,)
    reward: torch.Tensor     # (B,)
    done: torch.Tensor       # (B,) float — episode boundary AFTER this step
    truncated: torch.Tensor  # (B,) float


def init_train_state(seed: int, obs_dim: int, act_dim: int, cfg: PPOConfig,
                     device="cuda") -> TrainState:
    """Fresh parameters from a seeded torch.Generator, zero moments, unit
    observation variance (ppo.py · init_train_state)."""
    device = torch.device(device)
    init_gen = torch.Generator(device=device).manual_seed(int(seed))
    params = ActorCritic.init(obs_dim, act_dim, cfg.hidden, init_gen, device)
    zeros = [torch.zeros_like(p) for p in params.leaves()]
    stats = ObsStats(torch.zeros((obs_dim,), device=device), torch.ones((obs_dim,), device=device),
                     torch.zeros((), device=device))
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    return TrainState(params, zeros, [z.clone() for z in zeros],
                      torch.zeros((), dtype=torch.int32, device=device), gen, stats)


@torch.no_grad()
def _adam(params, grads, m, v, count, lr, b1=0.9, b2=0.999, eps=1e-8, max_norm=0.5):
    """ppo.py · _adam on lists of tensors: global-norm clip, then the
    moments, then the bias-corrected step. Returns (params, m, v, count)."""
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads) + 1e-12)
    scale = torch.clamp(max_norm / gnorm, max=1.0)
    grads = [g * scale for g in grads]
    count = count + 1
    m = [b1 * mm + (1 - b1) * g for mm, g in zip(m, grads)]
    v = [b2 * vv + (1 - b2) * g * g for vv, g in zip(v, grads)]
    c = count.to(torch.float32)
    mhat_scale = 1.0 / (1 - b1 ** c)
    vhat_scale = 1.0 / (1 - b2 ** c)
    params = [p - lr * (mm * mhat_scale) / (torch.sqrt(vv * vhat_scale) + eps)
              for p, mm, vv in zip(params, m, v)]
    return params, m, v, count


def _normalized(advs):
    return (advs - torch.mean(advs)) / (torch.std(advs, unbiased=False) + 1e-8)


def make_train_step(task: Task, cfg: PPOConfig, step_fn: Optional[Callable] = None,
                    mesh: Optional[pmesh.Mesh] = None):
    """train_step(ts, es, eps=None) -> (ts, es, metrics).

    One call = `rollout_length` env steps + num_epochs x num_minibatches
    PPO updates. `step_fn(state, action (act, B))` is the env step; by
    default `make_env_step(task)`: one kernel launch a step for any task
    (the plain version on CPU tensors). `eps` (T, B, act), if given,
    replaces the sampling noise.
    With a `mesh`, `es` is this rank's shard (`mesh.shard_env_state`, or a
    reset with `first_env`), `ts` is replicated, `eps` spans the global
    batch, and the metrics are the global batch's (module docstring)."""
    if step_fn is None:
        step_fn = make_env_step(task)
    T = cfg.rollout_length
    D, rank = (1, 0) if mesh is None else (mesh.world, mesh.rank)

    def rows_of(obs):
        """(the policy's input, this rank's rows of its output): over a mesh
        the rank's rows at their place among zeros (`mesh.global_rows`)."""
        b = obs.shape[0]
        return (obs if mesh is None else pmesh.global_rows(obs, mesh),
                slice(rank * b, (rank + 1) * b))

    @torch.no_grad()
    def rollout(params: ActorCritic, norm, es: EnvState, gen, eps):
        steps, raw = [], []
        for t in range(T):
            obs = norm(es.obs.T)  # (B, obs_dim)
            full, rows = rows_of(obs)
            # the noise is drawn for all of `full`'s rows: the global batch's
            a, logp = params.policy_sample(full, gen, None if eps is None else eps[t])
            a, logp, val = a[rows], logp[rows], params.value_apply(full)[rows]
            es2 = step_fn(es, torch.clamp(a, -1.0, 1.0).T.contiguous())
            steps.append(Transition(
                obs=obs, action=a, logp=logp, value=val, reward=es2.reward,
                done=(es2.terminated | es2.truncated).to(torch.float32),
                truncated=es2.truncated.to(torch.float32),
            ))
            # raw obs go separately: the stats fold UNnormalized data
            raw.append(es.obs.T)
            es = es2
        traj = Transition(*[torch.stack(xs, 0) for xs in zip(*steps)])
        return es, traj, torch.stack(raw, 0)

    def gae(traj: Transition, last_value):
        """ppo.py · gae: next-step auto-reset semantics, so value[t+1] at an
        episode boundary is V(terminal obs); terminated steps bootstrap 0,
        truncated ones from the critic, and the recursion is cut at every
        boundary with this step's done flag."""
        adv_next, v_next = torch.zeros_like(last_value), last_value
        advs = [None] * T
        for t in range(T - 1, -1, -1):
            terminated = traj.done[t] - traj.truncated[t]  # disjoint flags
            delta = traj.reward[t] + cfg.discount * v_next * (1.0 - terminated) - traj.value[t]
            adv = delta + cfg.discount * cfg.gae_lambda * (1.0 - traj.done[t]) * adv_next
            advs[t] = adv
            adv_next, v_next = adv, traj.value[t]
        advs = torch.stack(advs, 0)
        return advs, advs + traj.value

    def loss_fn(params: ActorCritic, batch: Transition, adv_n, returns):
        """This rank's share of the minibatch loss: its rows' means times
        1/D (exactly 1 unsharded), the entropy term on rank 0 only."""
        logp, entropy = params.policy_logp_entropy(batch.obs, batch.action)
        ratio = torch.exp(logp - batch.logp)
        unclipped = ratio * adv_n
        clipped = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n
        pg_loss = -torch.mean(torch.minimum(unclipped, clipped)) * (1.0 / D)
        value = params.value_apply(batch.obs)
        v_loss = 0.5 * torch.mean((value - returns) ** 2) * (1.0 / D)
        loss = pg_loss + cfg.value_coef * v_loss
        return loss - cfg.entropy_coef * entropy if rank == 0 else loss

    def train_step(ts: TrainState, es: EnvState, eps: Optional[torch.Tensor] = None):
        params = ts.params
        norm = ts.obs_stats.normalize if cfg.normalize_obs else (lambda x: x)
        es, traj, raw_obs = rollout(params, norm, es, ts.generator, eps)
        with torch.no_grad():
            full, rows = rows_of(norm(es.obs.T))
            last_value = params.value_apply(full)[rows]
        if mesh is not None:  # the global batch on every rank
            *fields, raw_obs, last_value = pmesh.all_gather_env(
                [*traj, raw_obs, last_value], mesh, [1] * (len(traj) + 1) + [0])
            traj = Transition(*fields)
        advs, returns = gae(traj, last_value)
        obs_stats = (ts.obs_stats.update(raw_obs.reshape(-1, raw_obs.shape[-1]))
                     if cfg.normalize_obs else ts.obs_stats)

        # (T, B, ...) -> minibatches as contiguous env-axis slices
        B = traj.reward.shape[-1]
        mb = cfg.num_minibatches
        if B % mb:
            raise ValueError(f"batch {B} must divide num_minibatches {mb}")
        n = B // mb
        if n % D:
            raise ValueError(f"a minibatch's {n} envs do not split over {D} ranks")
        s = n // D  # this rank's share of a minibatch's envs
        leaves = params.leaves()
        m, v, count = ts.opt_m, ts.opt_v, ts.opt_count
        losses = []
        for _ in range(cfg.num_epochs):
            for i in range(mb):
                lo = i * n + rank * s
                sl = lambda x: x[:, lo:lo + s].reshape(T * s, *x.shape[2:])  # noqa: E731
                batch = Transition(*[sl(x) for x in traj])
                adv_n = _normalized(advs[:, i * n:(i + 1) * n].reshape(T * n))
                adv_n = adv_n.view(T, n)[:, rank * s:(rank + 1) * s].reshape(T * s)
                loss = loss_fn(params, batch, adv_n, sl(returns))
                grads = torch.autograd.grad(loss, leaves)
                if mesh is not None:  # the sum over ranks, loss included
                    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
                    dist.all_reduce(flat, group=mesh.group)
                    *grads, loss = flat.split([g.numel() for g in grads] + [1])
                    grads = [g.view(p.shape) for g, p in zip(grads, leaves)]
                    loss = loss[0]
                lr = cfg.learning_rate
                if cfg.total_updates:
                    frac = 1.0 - count.to(torch.float32) / cfg.total_updates
                    lr = lr * torch.clamp(frac, min=0.0)
                new, m, v, count = _adam([p.detach() for p in leaves], grads, m, v, count,
                                         lr, max_norm=cfg.max_grad_norm)
                with torch.no_grad():
                    for p, x in zip(leaves, new):
                        p.copy_(x)
                losses.append(loss.detach())
        metrics: Dict[str, torch.Tensor] = {
            "loss": torch.stack(losses).mean(),
            "reward_mean": traj.reward.mean(),
            "done_frac": traj.done.mean(),
            "value_mean": traj.value.mean(),
        }
        return TrainState(params, m, v, count, ts.generator, obs_stats), es, metrics

    return train_step


def train(env_id: str, batch_size: int, num_iterations: int,
          cfg: Optional[PPOConfig] = None, seed: int = 0, device="cuda",
          progress: Optional[Callable] = None, resume_from: Optional[str] = None,
          mesh: Optional[pmesh.Mesh] = None, backend: str = "fused", graph: bool = True,
          resume_env_from: Optional[str] = None):
    """Training driver: build the env batch and the train step, loop.
    `resume_from`: a TrainState checkpoint (`utils/checkpoint.py` npz, of
    either package) to continue from instead of a fresh init; its shapes
    must be those of `cfg` on this env (else ValueError, as in the JAX
    package). A file of the port's restores the sampling stream exactly,
    one of the JAX package's seeds it with the key.
    `resume_env_from`: an `EnvState` checkpoint of `batch_size` envs to
    continue instead of a reset; with both, a run continued from the files
    another run saved is that run continued (bitwise on one device).
    With a `mesh` (every rank calls train), `batch_size` is the global
    batch, `device` is the mesh's, each rank resets and steps its block of
    the envs, and the learner state is broadcast from rank 0 (every rank
    passes the same `backend` and `graph`, which go to the env batch's
    `make_batched`: "composed" trains a task whose hooks "fused" cannot
    translate). Returns (ts, es: this rank's shard under a mesh, metrics of
    the last step)."""
    from pybulletgym_tpu_torch.api.registry import make_batched
    from pybulletgym_tpu_torch.utils import checkpoint

    cfg = cfg or PPOConfig()
    lo, hi = (0, batch_size) if mesh is None else mesh.block(batch_size)
    if mesh is not None:
        device = mesh.device
        if resume_env_from is not None:
            raise ValueError("resume_env_from continues an unsharded run; it takes no mesh")
    env = make_batched(env_id, hi - lo, device=device, backend=backend, graph=graph)
    train_step = make_train_step(env.task, cfg, step_fn=env.step_fn, mesh=mesh)
    ts = init_train_state(seed, env.observation_size, env.action_size, cfg, device)
    if resume_from is not None:
        ts = checkpoint.load(resume_from, ts)
    if mesh is not None:
        pmesh.shard_params(ts, mesh)
    es = env.reset(seed=seed, first_env=lo)
    if resume_env_from is not None:
        es = checkpoint.load(resume_env_from, es)
    metrics = None
    for it in range(num_iterations):
        ts, es, metrics = train_step(ts, es)
        if progress is not None:
            progress(it, {k: float(x) for k, x in metrics.items()})
    return ts, es, metrics
