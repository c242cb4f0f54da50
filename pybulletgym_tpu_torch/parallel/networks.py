"""Policy networks: the counterpart of the JAX package's `mlp_apply`
(`parallel/networks.py`) as an `nn.Module`.

The reference ships `SmallReactivePolicy` — a two-hidden-layer MLP with
frozen numpy weights [ref: examples/roboschool-weights/enjoy_TF_*.py] — as
its only "model". Matrix products go to `torch.matmul`, as the JAX package
leaves them to XLA.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

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
        n = len(self.weights)
        for i in range(n):
            h = h @ self.weights[i] + self.biases[i]
            if i < n - 1:
                h = torch.tanh(h)
        return torch.tanh(h) if self.squash else torch.clamp(h, -1.0, 1.0)
