"""pybulletgym_tpu_torch — the PyTorch + CUDA port of pybulletgym_tpu.

The batched env step of the JAX package, rebuilt on torch: plain PyTorch
versions of the scalar engine (FK -> CRBA/RNE -> Cholesky -> narrowphase ->
square-root-space PGS -> semi-implicit Euler, then obs/reward/auto-reset)
run on the CPU, and hand-written CUDA kernels for Hopper (`csrc/`) run the
whole env step in one launch on the GPU. The JAX package is the frozen
reference it is held against; this package never imports jax.

All 26 env IDs of the JAX package (`api/registry.py`) and any user task
(`register`: its hooks are translated into a CUDA kernel,
`ops/task_kernel.py`), the PPO and SAC
learners (`parallel.ppo`, `parallel.sac`), the gymnasium API (`make`,
`make_vec`, `api/gym_adapter.py`; every ID registered with gymnasium as
``pybulletgym_tpu_torch/<id>`` on import, where gymnasium is installed),
and the utils: episode statistics (`utils.metrics`), checkpoints
(`utils.checkpoint`), rendering (`utils.render`) and the SDF importer
(`models.sdf`).
Entry points run on the GPU unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

from pybulletgym_tpu_torch.api.registry import (  # noqa: F401
    make, make_batched, make_task, register, register_with_gymnasium, registry,
)
from pybulletgym_tpu_torch.api.gym_adapter import make_vec  # noqa: F401

register_with_gymnasium()
