"""Policy networks: the counterpart of the JAX package's
`parallel/networks.py` as `nn.Module`s.

The reference ships `SmallReactivePolicy` — a two-hidden-layer MLP with
frozen numpy weights [ref: examples/roboschool-weights/enjoy_TF_*.py] — as
its only "model". `MLPPolicy` runs such shipped weights; `ActorCritic` is
the trainable Gaussian actor-critic of the PPO learner; `MLPParams` (built
by `init_mlp`) is the plain parameter pair of SAC's actor and twin critics
(`parallel/sac.py`). Weights keep the
JAX layout (in, out), so checkpoints cross without transposes. Matrix
products go to `torch.matmul`, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn


class MLPPolicy(nn.Module):
    """tanh MLP over (B, obs) inputs, with the shipped-policy conventions:

    optional observation normalisation ``clip((x - mean) / sqrt(var + 1e-8),
    -10, 10)``, tanh hidden layers, and a tanh head if `squash` (SAC) or a
    ``clip(-1, 1)`` head otherwise.
    """

    def __init__(self, weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                 squash: bool = False,
                 norm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        super().__init__()
        self.weights = nn.ParameterList([nn.Parameter(w, requires_grad=False) for w in weights])
        self.biases = nn.ParameterList([nn.Parameter(b, requires_grad=False) for b in biases])
        self.squash = bool(squash)
        self.normalized = norm is not None
        if norm is not None:
            self.register_buffer("obs_mean", norm[0])
            self.register_buffer("obs_std", torch.sqrt(norm[1] + 1e-8))

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        h = obs
        if self.normalized:
            h = torch.clamp((h - self.obs_mean) / self.obs_std, -10.0, 10.0)
        h = mlp_apply(self.weights, self.biases, h)
        return torch.tanh(h) if self.squash else torch.clamp(h, -1.0, 1.0)


def mlp_apply(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    """tanh hidden layers, linear head (networks.py · mlp_apply)."""
    h = x
    n = len(weights)
    for i in range(n):
        h = h @ weights[i] + biases[i]
        if i < n - 1:
            h = torch.tanh(h)
    return h


class MLPParams(NamedTuple):
    """An MLP's weights (in, out) and biases, in layer order: networks.py ·
    MLPParams, whose pytree flattens to the weights, then the biases."""

    weights: Tuple[torch.Tensor, ...]
    biases: Tuple[torch.Tensor, ...]

    def leaves(self) -> List[torch.Tensor]:
        return [*self.weights, *self.biases]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.weights, self.biases, x)


def init_mlp(sizes: Sequence[int], final_scale: float = 0.01,
             generator: Optional[torch.Generator] = None, device="cuda") -> MLPParams:
    """N(0, 1) * scale / sqrt(fan_in) weights (scale 1, the last layer
    `final_scale`), zero biases: networks.py · init_mlp, drawn from a
    seeded torch.Generator instead of a JAX key. On the GPU unless the
    caller asks for another device."""
    ws, bs = [], []
    n = len(sizes) - 1
    for i in range(n):
        scale = final_scale if i == n - 1 else 1.0
        w = torch.randn((sizes[i], sizes[i + 1]), generator=generator, device=device)
        ws.append(w * (scale / math.sqrt(sizes[i])))
        bs.append(torch.zeros((sizes[i + 1],), device=device))
    return MLPParams(tuple(ws), tuple(bs))


class ActorCritic(nn.Module):
    """Gaussian policy MLP, value MLP and a state-independent `log_std`
    (networks.py · ACParams). `leaves()` lists the parameters in the JAX
    pytree's flatten order: policy weights, policy biases, value weights,
    value biases, log_std."""

    def __init__(self, policy_w, policy_b, value_w, value_b, log_std):
        super().__init__()
        P = lambda xs: nn.ParameterList([nn.Parameter(x) for x in xs])  # noqa: E731
        self.policy_w, self.policy_b = P(policy_w), P(policy_b)
        self.value_w, self.value_b = P(value_w), P(value_b)
        self.log_std = nn.Parameter(log_std)

    @classmethod
    def init(cls, obs_dim: int, act_dim: int, hidden: Sequence[int] = (64, 64),
             generator: Optional[torch.Generator] = None, device="cuda") -> "ActorCritic":
        """networks.py · init_actor_critic: policy head scaled by 0.01,
        value head by 1, log_std zeros. On the GPU unless the caller asks
        for another device."""
        pw, pb = init_mlp((obs_dim, *hidden, act_dim), 0.01, generator, device)
        vw, vb = init_mlp((obs_dim, *hidden, 1), 1.0, generator, device)
        return cls(pw, pb, vw, vb, torch.zeros((act_dim,), device=device))

    def leaves(self) -> List[nn.Parameter]:
        return [*self.policy_w, *self.policy_b, *self.value_w, *self.value_b, self.log_std]

    def policy_mean(self, obs):
        return mlp_apply(self.policy_w, self.policy_b, obs)

    def policy_sample(self, obs, generator: Optional[torch.Generator] = None,
                      eps: Optional[torch.Tensor] = None):
        """obs (B, obs_dim) -> (action (B, act), logp (B,)). The noise is
        `eps` when given (a test feeds JAX's), else N(0, 1) from `generator`."""
        mean = self.policy_mean(obs)
        if eps is None:
            eps = torch.randn(mean.shape, generator=generator, device=mean.device)
        a = mean + torch.exp(self.log_std) * eps
        return a, _gauss_logp(a, mean, self.log_std)

    def policy_logp_entropy(self, obs, actions):
        mean = self.policy_mean(obs)
        logp = _gauss_logp(actions, mean, self.log_std)
        ent = torch.sum(self.log_std + 0.5 * math.log(2 * math.pi * math.e))
        return logp, ent

    def value_apply(self, obs):
        return mlp_apply(self.value_w, self.value_b, obs)[..., 0]


def _gauss_logp(a, mean, log_std):
    z = (a - mean) / torch.exp(log_std)
    return torch.sum(-0.5 * z * z - log_std - 0.5 * math.log(2 * math.pi), dim=-1)
