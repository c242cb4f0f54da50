"""The CUDA kernels' C++ (csrc/engine_core.h built with g++, the host twin)
on the Gym-MuJoCo mirror family: the eight `*MuJoCoEnv-v0` IDs, in their
four task kinds (the walkers, Reacher, the two pendula).

(a) the host twin vs env_step_plain for each ID: one full step with every
    3rd env forced to reset. The reset (frame_skip=0): q, v and aux bitwise,
    but ReacherMuJoCo's target x, y to 1 ulp (glibc's sqrtf/cosf/sinf
    against torch's vectorised CPU ones; on the card both are CUDA's). The
    step bitwise repeatable. Bounds: the walkers' budget of
    test_pallas_equivalence.py:38-51 (mean |dq| < 3e-4, max < 1e-2, obs mean
    < 1e-3, reward median < 5e-3, termination flips < 1%, aux medians <
    5e-3), reward components to 1e-4 (relative for the walkers, whose vx
    divides by the 16.5 ms control step); epoch, step count and truncation
    exact. Hopper's env 1 is past its |q[2:]| < 100 test, Ant's env 1 above
    z = 1.
(b) the 20-step goldens replayed on the host twin: the seven CPU-recorded
    ones at the JAX package's CPU drift budget, median |dobs| < 1e-3 at step
    5 and < 3e-2 at step 20; HumanoidMuJoCo's, recorded on a TPU only, at
    the TPU budget of test_torch_humanoid_twin.py, 1e-2 and 3e-2;
    terminated equal. Ant's and HumanoidMuJoCo's medians over all entries
    are those of their zero blocks (84 of 111, 331 of 376), so the entries
    the tasks compute are held too: AntMuJoCo's to the CPU budget,
    HumanoidMuJoCo's 45 to < 3e-2 at steps 5 and 20 as built (1.65e-2 and
    2.18e-2 measured), and to < 1e-2 at step 5 on the twin built with
    ENG_BF16_PROBE, which rounds the XLA path's product operands to bf16 as
    the TPU that recorded the golden did (4.1e-3 measured;
    tools/bf16_probe.py).
(c) the Tables struct, which the kernels take as a parameter, stays under
    the 32,764-byte limit of a kernel's parameters with the draw cap at 34.
"""

import ctypes
import os
import shutil

import numpy as np
import pytest
import torch

from pybulletgym_tpu_torch import make_batched, make_task
from pybulletgym_tpu_torch.envs.base import env_step_plain
from pybulletgym_tpu_torch.ops import cuda_engine as ce
from pybulletgym_tpu_torch.utils.interop import env_state_from_numpy, env_state_to_numpy
from test_torch_cuda import bounds_fixed
from test_torch_mujoco_family import MJ, target_rows, ulps

CPU_GOLDENS = tuple(k for k in MJ if k != "HumanoidMuJoCoEnv-v0")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def twin():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the host twin")
    return ce.HostTwin()


def _state(env_id, B):
    """A post-reset batch, every 3rd env due for an auto-reset; Hopper's env
    1 with a joint past 100, Ant's env 1 above z = 1."""
    s = env_state_to_numpy(make_batched(env_id, B, device="cpu").reset(seed=4))
    s["terminated"] = np.arange(B) % 3 == 0
    if env_id == "HopperMuJoCoEnv-v0":
        s["q"][4, 1] = 150.0
    if env_id == "AntMuJoCoEnv-v0":
        s["q"][2, 1] = 1.5
    return env_state_from_numpy(s, device="cpu")


@pytest.mark.parametrize("env_id", MJ)
def test_host_twin_env_step(env_id, twin):
    """(a)"""
    task = make_task(env_id)
    B = 6
    tab, tab0 = ce.pack_tables(task), ce.pack_tables(task, frame_skip=0)
    s = _state(env_id, B)
    a = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (task.act_dim, B)).astype(np.float32))
    r0h, r0p = twin.env_step(tab0, task, s, a), env_step_plain(task, s, a, frame_skip=0)
    rows = target_rows(task)
    keep = [j for j in range(task.model.nq) if j not in rows]
    assert torch.equal(r0h.q[keep], r0p.q[keep]) and torch.equal(r0h.v, r0p.v)
    if rows:
        assert ulps(r0h.q[rows].numpy(), r0p.q[rows].numpy()).max() <= 1
    for k in r0p.aux:
        assert torch.equal(r0h.aux[k], r0p.aux[k]), k
    sh = twin.env_step(tab, task, s, a)
    assert torch.equal(sh.q, twin.env_step(tab, task, s, a).q)  # repeatable
    sp = env_step_plain(task, s, a)
    bounds_fixed(sh, sp)
    assert (sh.q - sp.q).abs().mean() < 1e-5
    assert sorted(sh.rewards) == sorted(sp.rewards) and sorted(sh.aux) == sorted(sp.aux)
    for k in sp.rewards:
        np.testing.assert_allclose(sh.rewards[k].numpy(), sp.rewards[k].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    if env_id in ("HopperMuJoCoEnv-v0", "AntMuJoCoEnv-v0"):
        assert bool(sp.terminated[1]) and bool(sh.terminated[1])


def _golden(twin, env_id, tpu):
    """Replay the golden on `twin`: the median |dobs| at each step over all
    entries and over the computed ones; terminated equal at every step."""
    g = np.load(os.path.join(ROOT, "tests", "goldens", f"{env_id}{'' if tpu else '.cpu'}.npz"))
    B, n, seed = int(g["batch"]), int(g["n_steps"]), int(g["seed"])
    task = make_task(env_id)
    tab = ce.pack_tables(task)
    live = task.obs_dim - getattr(task, "n_zero", 0)
    s = make_batched(env_id, B, device="cpu").reset(seed=seed)
    acts = np.random.default_rng(seed).uniform(-1, 1, (n, B, task.act_dim)).astype(np.float32)
    meds, live_meds = [], []
    for t in range(n):
        s = twin.env_step(tab, task, s, torch.from_numpy(acts[t].T.copy()))
        d = np.abs(s.obs.numpy() - g["obs"][t])
        meds.append(np.median(d))
        live_meds.append(np.median(d[:live]))
        np.testing.assert_array_equal(s.terminated.numpy(), g["terminated"][t])
    return meds, live_meds


@pytest.mark.parametrize("env_id", MJ)
def test_golden_rollout_on_host_twin(env_id, twin):
    """(b)"""
    tpu = env_id not in CPU_GOLDENS
    meds, live = _golden(twin, env_id, tpu)
    assert meds[4] < (1e-2 if tpu else 1e-3) and meds[-1] < 3e-2, meds
    assert live[4] < (3e-2 if tpu else 1e-3) and live[-1] < 3e-2, live
    if tpu:
        _, live_bf16 = _golden(ce.HostTwin(bf16_probe=True), env_id, tpu)
        assert live_bf16[4] < 1e-2 and live_bf16[-1] < 3e-2, live_bf16


def test_tables_fit_a_kernel_parameter():
    """(c)"""
    tables, caps = ce.tables_type()
    assert caps["MAX_DRAWS"] >= caps["MAX_NQ"] and caps["MAX_DRAWS"] >= caps["MAX_NV"]
    assert ctypes.sizeof(tables) < 32764
