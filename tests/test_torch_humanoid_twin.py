"""The CUDA kernels' C++ (csrc/engine_core.h built with g++, the host twin)
on the humanoid family, against the plain version and the goldens.

(c) the host twin vs env_step_plain for Humanoid, Flagrun and
    FlagrunHarder: one full step with every 3rd env forced to reset
    (bitwise reset q through frame_skip=0, bitwise repeatable), and the
    physics step on the large scratch instantiation.
(d) the TPU-recorded 20-step goldens replayed on the host twin.
(f) a foot row above 31 (the humanoid's feet are rows 13, 59-67 and 18,
    80-85) seen by the kernel's row -> foot table.

Bounds are the humanoid-family budget of tests/test_pallas_equivalence.py:
80-86 (median |dq| < 1.5e-3, mean < 5e-3, max < 8e-2, termination flips
< 1%, aux median < 5e-2) and the walkers' mean < 1e-5 where it holds.
"""

import ctypes
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from pybulletgym_tpu_torch import make_task
from pybulletgym_tpu_torch.envs.base import BatchedEnv, env_step_plain
from pybulletgym_tpu_torch.ops import cuda_engine as ce
from pybulletgym_tpu_torch.ops.step import make_physics_step_plain

HUMANOID = "HumanoidPyBulletEnv-v0"
FLAGRUN = "HumanoidFlagrunPyBulletEnv-v0"
HARDER = "HumanoidFlagrunHarderPyBulletEnv-v0"
FAMILY = (HUMANOID, FLAGRUN, HARDER)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def twin():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the host twin")
    return ce.HostTwin()


def bounds_humanoid(a, b):
    """Env-step parity of the humanoid family: q within the family budget
    and the walkers' mean, termination flips, aux; epoch, step count and
    truncation exact."""
    dq = (a.q - b.q).abs()
    assert dq.median() < 1.5e-3 and dq.mean() < 1e-5 and dq.max() < 8e-2, dq.max()
    assert (a.terminated != b.terminated).float().mean() < 0.01
    for k in b.aux:
        assert (a.aux[k] - b.aux[k]).abs().median() < 5e-2, k
    for name in ("epoch", "step_count", "truncated"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("env_id", FAMILY)
def test_host_twin_env_step(env_id, twin):
    """(c) one full step, every 3rd env forced to reset"""
    task = make_task(env_id)
    B = 6
    tab, tab0 = ce.pack_tables(task), ce.pack_tables(task, frame_skip=0)
    assert tab.caps_id == 1 and tab.npair in (66, 75)
    s = BatchedEnv(task, B, device="cpu").reset(seed=4)
    forced = torch.zeros(B, dtype=torch.bool)
    forced[::3] = True
    s = s._replace(terminated=forced)
    a = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (task.act_dim, B)).astype(np.float32))
    r0h, r0p = twin.env_step(tab0, task, s, a), env_step_plain(task, s, a, frame_skip=0)
    assert torch.equal(r0h.q, r0p.q)  # reset q (lying poses too) bitwise
    for k in ("target_x", "target_y", "flag_count", "flag_timeout", "frame"):
        if k in r0p.aux:  # the flag draws bitwise
            assert torch.equal(r0h.aux[k], r0p.aux[k]), k
    sh = twin.env_step(tab, task, s, a)
    assert torch.equal(sh.q, twin.env_step(tab, task, s, a).q)  # repeatable
    bounds_humanoid(sh, env_step_plain(task, s, a))
    assert (1 - sh.q[3:7].norm(dim=0)).abs().max() < 1e-5  # the root quaternion


def test_host_twin_physics_step(twin):
    """(c) physics: one substep of FlagrunHarder (two free joints, 75 pairs)"""
    task = make_task(HARDER)
    B = 6
    s = BatchedEnv(task, B, device="cpu").reset(seed=0)
    tau = torch.zeros((task.model.nv, B))
    a = np.random.default_rng(3).uniform(-1, 1, (task.act_dim, B)).astype(np.float32)
    tau[task.act_dofs] = torch.from_numpy(task.gains * a)
    tab = ce.pack_physics(task.model, task.physics, frame_skip=1)
    assert tab.caps_id == 1 and tab.frame_skip == 1
    cfg = dataclasses.replace(task.physics, frame_skip=1)
    qp, vp, dp = make_physics_step_plain(task.model, cfg)[0](s.q, s.v, tau)
    qh, vh, dh = twin.physics_step(tab, s.q, s.v, tau)
    dq = (qp - qh).abs()
    assert dq.median() < 1.5e-3 and dq.mean() < 1e-5 and dq.max() < 8e-2
    assert ((dp > 0) != (dh > 0)).float().mean() < 0.01


@pytest.mark.parametrize("env_id", FAMILY)
def test_golden_rollout_on_host_twin(env_id, twin):
    """(d) The goldens were recorded on a TPU (the JAX package skips them on
    other platforms: exact replay is platform-specific), whose float32
    matrix products round otherwise; the stiff rest-pose pair overlaps
    amplify that from the first step. So the bound is the humanoid aux
    budget's order: median |dobs| < 1e-2 at step 5 and < 3e-2 at step 20,
    terminated equal."""
    g = np.load(os.path.join(ROOT, "tests", "goldens", f"{env_id}.npz"))
    B, n, seed = int(g["batch"]), int(g["n_steps"]), int(g["seed"])
    task = make_task(env_id)
    tab = ce.pack_tables(task)
    s = BatchedEnv(task, B, device="cpu").reset(seed=seed)
    acts = np.random.default_rng(seed).uniform(-1, 1, (n, B, task.act_dim)).astype(np.float32)
    meds = []
    for t in range(n):
        s = twin.env_step(tab, task, s, torch.from_numpy(acts[t].T.copy()))
        meds.append(np.median(np.abs(s.obs.numpy() - g["obs"][t])))
        np.testing.assert_array_equal(s.terminated.numpy(), g["terminated"][t])
    assert meds[4] < 1e-2 and meds[-1] < 3e-2, meds


def test_foot_row_above_31_reaches_the_obs(twin):
    """(f) Make one foot a single pair row above 31 that surely touches
    (its radii sum set to 10 m) while row 32 below it does not, and the
    other foot a pair row above 31 that cannot touch (-10 m): the obs' foot
    flags follow those rows' depths. A 32-bit mask would drop the rows, or
    read them mod 32."""
    task = make_task(HUMANOID)
    B = 2
    s = BatchedEnv(task, B, device="cpu").reset(seed=1)
    tab = ce.pack_tables(task, frame_skip=1)
    assert [tab.row_foot[r] for r in (13, 59, 67, 18, 80, 85)] == [0, 0, 0, 1, 1, 1]
    nfloor = tab.nr - tab.npair
    hit, miss = 60, 90
    probe = type(tab).from_buffer_copy(tab)
    probe.pair_rsum[hit - nfloor], probe.pair_rsum[miss - nfloor] = 10.0, -10.0
    for r in range(tab.nr):
        probe.row_foot[r] = -1
    probe.row_foot[hit], probe.row_foot[miss] = 0, 1
    _, _, depth = twin.physics_step(probe, s.q, s.v, torch.zeros((task.model.nv, B)))
    assert (depth[hit] > 0).all() and (depth[hit - 32] <= 0).all() and (depth[miss] <= 0).all()
    out = twin.env_step(probe, task, s, torch.zeros((task.act_dim, B)))
    assert out.obs[-2].tolist() == [1.0, 1.0] and out.obs[-1].tolist() == [0.0, 0.0]
    assert ctypes.sizeof(probe) == ctypes.sizeof(tab)
