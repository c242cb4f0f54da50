"""The CUDA kernels' C++ (csrc/engine_core.h built with g++, the host twin)
on the fixed-base family: Reacher, Pusher, Striker, Thrower and the pendula.

(a) the host twin vs env_step_plain for each task kind: one full step with
    every 3rd env forced to reset (reset q, v and aux bitwise through
    frame_skip=0; the step bitwise repeatable), with Striker's arm at the
    ball and Thrower's ball fallen in one env. Bounds: the walkers' budget
    of test_pallas_equivalence.py:38-51 (mean |dq| < 3e-4, max < 1e-2, obs
    mean < 1e-3, reward median < 5e-3, termination flips < 1%) and the
    walkers' mean |dq| < 1e-5 of the plain version's own tests; epoch, step
    count and truncation exact.
(b) the 20-step goldens replayed on the host twin: the CPU-recorded ones
    (Reacher and the pendula) at the JAX package's CPU drift budget, median
    |dobs| < 1e-3 at step 5 and < 3e-2 at step 20; the TPU-recorded ones
    (Pusher, Striker, Thrower and their MuJoCo mirrors) at the TPU budget
    of test_torch_humanoid_twin.py, 1e-2 and 3e-2; terminated equal.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from pybulletgym_tpu_torch import make_batched, make_task
from pybulletgym_tpu_torch.envs.base import env_step_plain
from pybulletgym_tpu_torch.models.schema import JointType
from pybulletgym_tpu_torch.ops import cuda_engine as ce
from pybulletgym_tpu_torch.utils.interop import env_state_from_numpy, env_state_to_numpy
from test_torch_cuda import bounds_fixed
from test_torch_manipulation import _near_ball

KINDS = ("ReacherPyBulletEnv-v0", "PusherPyBulletEnv-v0", "StrikerPyBulletEnv-v0",
         "ThrowerPyBulletEnv-v0", "InvertedPendulumPyBulletEnv-v0",
         "InvertedPendulumSwingupPyBulletEnv-v0", "InvertedDoublePendulumPyBulletEnv-v0")
CPU_GOLDENS = ("ReacherPyBulletEnv-v0", "InvertedPendulumPyBulletEnv-v0",
               "InvertedPendulumSwingupPyBulletEnv-v0", "InvertedDoublePendulumPyBulletEnv-v0")
TPU_GOLDENS = ("PusherPyBulletEnv-v0", "StrikerPyBulletEnv-v0", "ThrowerPyBulletEnv-v0",
               "PusherMuJoCoEnv-v0", "StrikerMuJoCoEnv-v0", "ThrowerMuJoCoEnv-v0")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def twin():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the host twin")
    return ce.HostTwin()


def _state(env_id, task, B):
    """A post-reset batch, every 3rd env due for an auto-reset; Striker's env
    1 with the tips at the ball, Thrower's env 1 with the ball at z = -0.5."""
    s = env_state_to_numpy(make_batched(env_id, B, device="cpu").reset(seed=4))
    s["terminated"] = np.arange(B) % 3 == 0
    if "striked" in s["aux"]:
        s["q"][:, 1] = _near_ball(task, {"q": s["q"][:, 1:]})[:, 0]
    if "hit" in s["aux"]:
        ball = next(b.q_adr for b in task.model.bodies if b.jtype == JointType.FREE)
        s["q"][ball + 2, 1] = -0.5
    return env_state_from_numpy(s, device="cpu")


@pytest.mark.parametrize("env_id", KINDS)
def test_host_twin_env_step(env_id, twin):
    """(a)"""
    task = make_task(env_id)
    B = 6
    tab, tab0 = ce.pack_tables(task), ce.pack_tables(task, frame_skip=0)
    s = _state(env_id, task, B)
    a = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (task.act_dim, B)).astype(np.float32))
    r0h, r0p = twin.env_step(tab0, task, s, a), env_step_plain(task, s, a, frame_skip=0)
    assert torch.equal(r0h.q, r0p.q) and torch.equal(r0h.v, r0p.v)  # the reset draws
    for k in ("hit", "min_dist", "striked"):
        if k in r0p.aux:
            assert torch.equal(r0h.aux[k], r0p.aux[k]), k
    sh = twin.env_step(tab, task, s, a)
    assert torch.equal(sh.q, twin.env_step(tab, task, s, a).q)  # repeatable
    sp = env_step_plain(task, s, a)
    bounds_fixed(sh, sp)
    assert (sh.q - sp.q).abs().mean() < 1e-5
    assert sorted(sh.rewards) == sorted(sp.rewards) and sorted(sh.aux) == sorted(sp.aux)
    for k in sp.rewards:
        assert (sh.rewards[k] - sp.rewards[k]).abs().max() < 1e-4, k
    if "striked" in sp.aux:  # the strike is seen in env 1, as the plain version sees it
        assert sp.aux["striked"][1] == 1.0 and torch.equal(sh.aux["striked"], sp.aux["striked"])
    if "hit" in sp.aux:
        assert sp.aux["hit"][1] == 1.0 and torch.equal(sh.aux["hit"], sp.aux["hit"])


@pytest.mark.parametrize("env_id", CPU_GOLDENS + TPU_GOLDENS)
def test_golden_rollout_on_host_twin(env_id, twin):
    """(b)"""
    tpu = env_id in TPU_GOLDENS
    g = np.load(os.path.join(ROOT, "tests", "goldens", f"{env_id}{'' if tpu else '.cpu'}.npz"))
    B, n, seed = int(g["batch"]), int(g["n_steps"]), int(g["seed"])
    task = make_task(env_id)
    tab = ce.pack_tables(task)
    s = make_batched(env_id, B, device="cpu").reset(seed=seed)
    acts = np.random.default_rng(seed).uniform(-1, 1, (n, B, task.act_dim)).astype(np.float32)
    meds = []
    for t in range(n):
        s = twin.env_step(tab, task, s, torch.from_numpy(acts[t].T.copy()))
        meds.append(np.median(np.abs(s.obs.numpy() - g["obs"][t])))
        np.testing.assert_array_equal(s.terminated.numpy(), g["terminated"][t])
    assert meds[4] < (1e-2 if tpu else 1e-3) and meds[-1] < 3e-2, meds
