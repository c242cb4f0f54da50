"""Carry env state and policy weights between the JAX package and the port.

States cross as plain numpy: a dict with the `EnvState` field names, whose
`aux` and `rewards` entries are dicts of (B,) arrays. Weights cross as the
npz files that `examples/weights/` ships (keys `n_layers`, `w{i}`, `b{i}`,
optional `normalized`/`obs_mean`/`obs_var` and `squash`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pybulletgym_tpu_torch.envs.base import EnvState
from pybulletgym_tpu_torch.parallel.networks import MLPPolicy

_DTYPES = {
    "q": torch.float32, "v": torch.float32, "obs": torch.float32,
    "reward": torch.float32, "terminated": torch.bool, "truncated": torch.bool,
    "step_count": torch.int32, "epoch": torch.uint32, "env_id": torch.int32,
    "seed": torch.uint32,
}


def env_state_from_numpy(d: Dict, device="cpu") -> EnvState:
    """numpy dict (JAX `EnvState` field names) -> the port's `EnvState`."""
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


def policy_from_npz(path: str, device="cpu") -> MLPPolicy:
    """A shipped policy npz -> `MLPPolicy` on `device`."""
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
