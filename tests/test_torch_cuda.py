"""The CUDA kernels on a GPU, against their plain PyTorch versions.

This file imports torch and the port only, never jax, so it runs on a GPU
machine without the JAX package (tests/conftest.py imports jax, hence
`--noconftest`):

    python -m pytest --noconftest tests/test_torch_cuda.py

Without a GPU every test here skips. The bounds are the walker budget of
test_pallas_equivalence.py:38-51, as chip_smoke.py holds them.
"""

import pytest
import torch

from pybulletgym_tpu_torch import make_batched, make_task
from pybulletgym_tpu_torch.envs.base import env_step_plain
from pybulletgym_tpu_torch.ops import cuda_engine as ce

ENV = "HalfCheetahPyBulletEnv-v0"
B = 300  # two full blocks of 128 threads and a ragged third

pytestmark = pytest.mark.cuda


def bounds_env(a, b, nf):
    """Env-step parity: q mean/max, continuous obs, foot-flag, reward and
    termination bounds; epoch, step count and truncation exact."""
    dq = (a.q - b.q).abs()
    dob = (a.obs - b.obs).abs()
    assert dq.mean() < 3e-4 and dq.max() < 1e-2
    assert dob[:-nf].mean() < 1e-3
    assert (dob[-nf:] > 0.5).float().mean() < 0.01
    assert (a.reward - b.reward).abs().median() < 5e-3
    assert (a.terminated != b.terminated).float().mean() < 0.01
    for name in ("epoch", "step_count", "truncated"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.fixture(scope="module")
def task():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return make_task(ENV)


def _state(seed):
    """A CUDA batch after reset, with every 3rd env due for an auto-reset."""
    env = make_batched(ENV, B, device="cuda")
    s = env.reset(seed=seed)
    forced = torch.zeros(B, dtype=torch.bool, device="cuda")
    forced[::3] = True
    return env, s._replace(terminated=forced)


def test_env_kernel_matches_plain(task):
    env, s = _state(2)
    g = torch.Generator(device="cuda").manual_seed(2)
    a = torch.rand((task.act_dim, B), device="cuda", generator=g) * 2 - 1
    out = env.step_fn(s, a)
    assert env.step_fn.launches == 1
    bounds_env(out, env_step_plain(task, s, a), len(task.foot_rows))
    # the post-reset q, before any physics, is bitwise the plain one
    forced = s.terminated
    reset_k = ce.make_cuda_env_step(task, frame_skip=0)(s, a)
    reset_p = env_step_plain(task, s, a, frame_skip=0)
    assert torch.equal(reset_k.q[:, forced], reset_p.q[:, forced])
    # no atomics: the same inputs give the same bits
    again = env.step_fn(s, a)
    for name in ("q", "v", "obs", "reward", "terminated", "truncated", "step_count", "epoch"):
        assert torch.equal(getattr(out, name), getattr(again, name)), name


def test_physics_kernel_matches_plain(task):
    _, s = _state(3)
    phys = ce.make_cuda_physics_step(task.model, task.physics)[0]
    g = torch.Generator(device="cuda").manual_seed(3)
    tau = torch.zeros((task.model.nv, B), device="cuda")
    act = torch.as_tensor(task.act_dofs, dtype=torch.int64, device="cuda")
    gains = torch.as_tensor(task.gains, device="cuda")
    tau[act] = gains * (torch.rand((task.act_dim, B), device="cuda", generator=g) * 2 - 1)
    qk, vk, dk = phys(s.q, s.v, tau)
    qp, vp, dp = phys.plain(s.q, s.v, tau)
    dq = (qk - qp).abs()
    assert dq.mean() < 3e-4 and dq.max() < 1e-2
    assert ((dk > 0) != (dp > 0)).float().mean() < 0.01
    assert torch.isfinite(vk).all() and phys.launches == 1


def test_wrappers_refuse_bad_cuda_inputs(task):
    env, s = _state(4)
    a = torch.zeros((task.act_dim, B), device="cuda")
    with pytest.raises(TypeError, match="q: dtype"):
        env.step_fn(s._replace(q=s.q.double()), a)
    with pytest.raises(ValueError, match="action: shape"):
        env.step_fn(s, a[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        env.step_fn(s, torch.zeros((B, task.act_dim), device="cuda").T)
    with pytest.raises(ValueError, match="on cpu"):
        env.step_fn(s, a.cpu())
    phys = ce.make_cuda_physics_step(task.model, task.physics)[0]
    with pytest.raises(ValueError, match="tau: shape"):
        phys(s.q, s.v, torch.zeros((task.model.nv, B + 1), device="cuda"))
    assert env.step_fn.launches == 0 and phys.launches == 0
