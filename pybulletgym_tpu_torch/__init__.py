"""pybulletgym_tpu_torch — the PyTorch + CUDA port of pybulletgym_tpu.

The batched env step of the JAX package, rebuilt on torch: plain PyTorch
versions of the scalar engine (FK -> CRBA/RNE -> Cholesky -> narrowphase ->
square-root-space PGS -> semi-implicit Euler, then obs/reward/auto-reset)
run on the CPU, and hand-written CUDA kernels for Hopper (`csrc/`) run the
whole env step in one launch on the GPU. The JAX package is the frozen
reference it is held against; this package never imports jax.

So far: 17 of the JAX package's 26 env IDs (the MJCF walkers, the humanoid
family, the pendula and the manipulators; `api/registry.py`) and the PPO
learner (`parallel.ppo`).
Entry points run on the GPU unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

from pybulletgym_tpu_torch.api.registry import make_batched, make_task  # noqa: F401
