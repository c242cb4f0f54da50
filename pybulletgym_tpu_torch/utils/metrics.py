"""On-device episode statistics over auto-resetting env batches:
counterpart of the JAX package's `utils/metrics.py`.

The reference exposes per-step reward components on the env object
[ref: walker_base_env.py · step — self.rewards] and leaves episode
aggregation to user code; with thousands of auto-resetting envs on a card
that aggregation lives on the device too. `EpisodeStats` is a NamedTuple of
tensors folded through `update` after each env step; `update` never
synchronises, and host code reads the means whenever convenient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class EpisodeStats(NamedTuple):
    running_return: torch.Tensor   # (B,) float32 current-episode accumulated reward
    running_length: torch.Tensor   # (B,) float32
    sum_returns: torch.Tensor      # () float32 sum of completed-episode returns
    sum_lengths: torch.Tensor      # () float32
    n_episodes: torch.Tensor       # () int32

    @classmethod
    def init(cls, batch: int, device="cuda") -> "EpisodeStats":
        """Zeros for `batch` envs on `device` (the GPU unless the caller
        asks for "cpu")."""
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
        return cls(z(batch), z(batch), z(), z(), torch.zeros((), dtype=torch.int32, device=device))

    def update(self, reward, done) -> "EpisodeStats":
        """Fold one env step: `reward` (B,) float32, `done` (B,) bool — the
        step's terminal flag (terminated | truncated)."""
        r = self.running_return + reward
        l = self.running_length + 1.0  # noqa: E741
        d = done.to(torch.float32)
        return EpisodeStats(
            running_return=r * (1.0 - d),
            running_length=l * (1.0 - d),
            sum_returns=self.sum_returns + torch.sum(r * d),
            sum_lengths=self.sum_lengths + torch.sum(l * d),
            n_episodes=self.n_episodes + torch.sum(done, dtype=torch.int32),
        )

    def mean_return(self) -> torch.Tensor:
        return self.sum_returns / torch.clamp(self.n_episodes, min=1).to(torch.float32)

    def mean_length(self) -> torch.Tensor:
        return self.sum_lengths / torch.clamp(self.n_episodes, min=1).to(torch.float32)
