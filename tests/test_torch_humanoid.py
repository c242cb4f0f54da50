"""The humanoid family (Humanoid, HumanoidFlagrun, HumanoidFlagrunHarder) on
the port, against the JAX package, at small sizes (B = 2-4, frame_skip 0 or
1, eager JAX).

(a) make_physics_step_plain vs one eager JAX `make_substep_scalar` substep
    on the humanoid: 66 self-collision pair rows, nv = 23.
(b) env_step_plain vs the eager JAX kernel body for Flagrun and
    FlagrunHarder: with frame_skip=0 a forced reset (FlagrunHarder: one
    lying, one standing), a flag retarget on its timer and one on reaching
    the flag, and a forced cube throw; with frame_skip=1 the thrown cube's
    first substep. Reset q, epoch, step count and the flag draws are
    bitwise; so are the cube's Threefry draws.
(e) full_self_collision_pairs equal to the JAX package's (66 and 75 pairs).
(f) termination at the edges of the alive test: the JAX package's output
    hook, the port's and the host twin agree exactly.

`PYTHONPATH=. python tests/test_torch_humanoid.py [env id]` runs the shipped policy on
the JAX package's jitted env step on the CPU (`jax_policy_rollout`).

Bounds: the JAX package's humanoid-family budget
(tests/test_pallas_equivalence.py:80-86): median |dq| < 1.5e-3, mean
< 5e-3, max < 8e-2, aux median < 5e-2; the walkers' mean < 1e-5 where it
holds (the plain version and eager JAX run the same float32 formulas in
the same order). test_torch_humanoid_twin.py holds the kernels' C++.
"""

import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybulletgym_tpu as pg
from pybulletgym_tpu.ops import contacts as ct_j
from pybulletgym_tpu.ops import rand as rand_j
from pybulletgym_tpu.ops import step as step_j
from pybulletgym_tpu_torch import make_task
from pybulletgym_tpu_torch.envs.base import env_step_plain, reset_fn
from pybulletgym_tpu_torch.ops import contacts as ct_t
from pybulletgym_tpu_torch.ops import cuda_engine as ce
from pybulletgym_tpu_torch.ops import dynamics as dyn_t
from pybulletgym_tpu_torch.ops import rand as rand_t
from pybulletgym_tpu_torch.ops.step import make_physics_step_plain
from pybulletgym_tpu_torch.utils.interop import env_state_from_numpy, env_state_to_numpy
from test_torch_engine import _jax_kernel_body

HUMANOID = "HumanoidPyBulletEnv-v0"
FLAGRUN = "HumanoidFlagrunPyBulletEnv-v0"
HARDER = "HumanoidFlagrunHarderPyBulletEnv-v0"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset(task, B, seed, epoch=0):
    return reset_fn(task, torch.full((B,), seed, dtype=torch.uint32),
                    torch.arange(B, dtype=torch.int32),
                    torch.full((B,), epoch, dtype=torch.uint32))


def _q_bounds(dq, mean):
    """The humanoid-family q budget, and the walkers' mean where it holds."""
    assert np.median(dq) < 1.5e-3 and dq.max() < 8e-2, (np.median(dq), dq.max())
    assert dq.mean() < mean, dq.mean()


def test_physics_step_plain_matches_jax():
    """(a) one substep with random torques from a post-reset state"""
    tj, tt = pg.make_task(HUMANOID), make_task(HUMANOID)
    B = 2
    s = _reset(tt, B, 9)
    tau = np.zeros((tt.model.nv, B), np.float32)
    a = np.random.default_rng(9).uniform(-1, 1, (tt.act_dim, B)).astype(np.float32)
    tau[tt.act_dofs] = tt.gains * a
    substep, _, n_rows = step_j.make_substep_scalar(tj.model, tj.physics)
    qj, vj, dj = substep([jnp.asarray(r) for r in s.q.numpy()],
                         [jnp.asarray(r) for r in s.v.numpy()], [jnp.asarray(r) for r in tau])
    cfg1 = dataclasses.replace(tt.physics, frame_skip=1)
    q2, v2, d2 = make_physics_step_plain(tt.model, cfg1)[0](s.q, s.v, torch.from_numpy(tau))
    dq = np.abs(np.stack([np.asarray(x) for x in qj]) - q2.numpy())
    _q_bounds(dq, 1e-5)
    assert n_rows == 95 and d2.shape == (95, B)
    dd = np.abs(np.stack([np.asarray(x) for x in dj]) - d2.numpy())
    assert dd.max() < 1e-5, dd.max()
    dv = np.abs(np.stack([np.asarray(x) for x in vj]) - v2.numpy())
    assert np.median(dv) < 1.5e-3, np.median(dv)


def test_reset_matches_jax():
    """reset_fn (FlagrunHarder: the flag, the lying pose, the retarget hook
    at reset) against the JAX package's reset"""
    from pybulletgym_tpu.envs.base import make_env

    tj, tt = pg.make_task(HARDER), make_task(HARDER)
    B = 4
    reset, _ = make_env(tj)
    sj = env_state_to_numpy(reset(jnp.full((B,), 5, jnp.uint32), jnp.arange(B, dtype=jnp.int32),
                                  jnp.zeros((B,), jnp.uint32)))
    st = _reset(tt, B, 5)
    np.testing.assert_array_equal(sj["q"], st.q.numpy())  # reset draws and pose bitwise
    assert sorted(sj["aux"]) == sorted(st.aux)
    for k in ("flag_count", "flag_timeout", "frame", "ground_counter", "initial_z",
              "target_x", "target_y"):
        np.testing.assert_array_equal(sj["aux"][k], st.aux[k].numpy(), err_msg=k)
    np.testing.assert_allclose(sj["aux"]["potential"], st.aux["potential"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(sj["obs"], st.obs.numpy(), atol=1e-5)


def test_hash_and_draws_match_jax():
    """rand.hash_epoch wraps mod 2^32 as the JAX package's uint32 arithmetic
    does; the flag and cube draws on it are bitwise"""
    rng = np.random.default_rng(3)
    epoch = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    epoch[:2] = (0, 2**32 - 1)
    count = rng.integers(0, 2000, 64).astype(np.float32)
    seed = np.full(64, 77, np.uint32)
    env_id = np.arange(64, dtype=np.int32)
    e2_j = jnp.uint32(epoch) * jnp.uint32(2654435761) + (
        jnp.asarray(count).astype(jnp.int32).astype(jnp.uint32) * jnp.uint32(0x9E3779B9))
    e2_t = rand_t.hash_epoch(torch.from_numpy(epoch.astype(np.int64)), torch.from_numpy(count))
    np.testing.assert_array_equal(np.asarray(e2_j).astype(np.int64), e2_t.numpy())
    for stream, lo, hi in ((101, -13.125, 13.125), (102, -6.25, 6.25), (110, -3.14, 3.14),
                           (111, 20.0, 30.0), (112, -1.0, 1.0), (114, -1.0, 1.0)):
        uj = rand_j.uniform(jnp.asarray(seed), stream, jnp.asarray(env_id), e2_j, lo, hi)
        ut = rand_t.uniform(torch.from_numpy(seed.astype(np.int64)), stream,
                            torch.from_numpy(env_id), e2_t, lo, hi)
        np.testing.assert_array_equal(np.asarray(uj), ut.numpy(), err_msg=str(stream))


def _lying(task, seed, env_id, epoch):
    u = rand_t.uniform(seed, task.LIE_STREAMS[0], env_id, epoch)
    return bool(u < 0.5)


def _adversity_state(task, B, seed):
    """A post-reset batch with: env 0 forced to reset into a lying pose
    and env 3 into a standing one (FlagrunHarder), env 1's flag timer at
    its end, env 2 next to its flag (and, on FlagrunHarder, due for a cube
    throw: frame 120, ground_counter 0)."""
    s = env_state_to_numpy(_reset(task, B, seed))
    s["terminated"] = np.array([True, False, False, True])
    harder = "frame" in s["aux"]
    if harder:  # the epochs whose reset is lying (env 0) and standing (env 3)
        e0 = next(e for e in range(1, 64) if _lying(task, seed, 0, e))
        e3 = next(e for e in range(1, 64) if not _lying(task, seed, 3, e))
        s["epoch"] = np.array([e0 - 1, 7, 0, e3 - 1], np.uint32)
        s["aux"]["frame"] = np.array([5.0, 33.0, 120.0, 7.0], np.float32)
        s["aux"]["ground_counter"] = np.array([0.0, 0.0, 0.0, 3.0], np.float32)
    else:
        s["epoch"] = np.array([2**32 - 1, 7, 0, 3], np.uint32)  # env 0's epoch wraps
    s["step_count"] = np.array([17, 40, 3, 999], np.int32)
    s["aux"]["flag_timeout"] = np.array([50.0, 1.0, 80.0, 20.0], np.float32)
    s["aux"]["flag_count"] = np.array([0.0, 3.0, 1.0, 0.0], np.float32)
    s["aux"]["target_x"][2] = 0.4  # the torso is within 1 m of it
    s["aux"]["target_y"][2] = 0.2
    return s


@pytest.mark.parametrize("env_id", [FLAGRUN, HARDER])
def test_env_step_plain_matches_jax_kernel_body(env_id):
    """(b) frame_skip=0: the reset, the retargets and the throw, exactly"""
    tj, tt = pg.make_task(env_id), make_task(env_id)
    B = 4
    sj = _adversity_state(tt, B, 21)
    a = np.random.default_rng(21).uniform(-1.5, 1.5, (tt.act_dim, B)).astype(np.float32)
    rj = _jax_kernel_body(tj, sj, a, frame_skip=0)
    rt = env_step_plain(tt, env_state_from_numpy(sj, device="cpu"), torch.from_numpy(a), frame_skip=0)
    cube = []
    if env_id == HARDER:
        cube = list(range(tt.cube_qadr, tt.cube_qadr + 7))
        assert _lying(tt, 21, 0, int(rt.epoch[0])) and rt.q[2, 0] == np.float32(0.3)
        assert not _lying(tt, 21, 3, int(rt.epoch[3]))
        # the throw moved env 2's cube only; its place and speed are close
        moved = np.abs(rj["q"][cube] - sj["q"][cube]).max(0)
        assert moved[2] > 1.0 and moved[[0, 1, 3]].max() == 0.0
        np.testing.assert_allclose(rj["q"][cube], rt.q.numpy()[cube], rtol=1e-6, atol=1e-5)
    rest = [i for i in range(tt.model.nq) if i not in cube]
    np.testing.assert_array_equal(rj["q"][rest], rt.q.numpy()[rest])  # reset q bitwise
    np.testing.assert_array_equal(rj["epoch"], rt.epoch.numpy())
    np.testing.assert_array_equal(rj["step_count"], rt.step_count.numpy())
    np.testing.assert_array_equal(rj["terminated"], rt.terminated.numpy())
    np.testing.assert_array_equal(rj["truncated"], rt.truncated.numpy())
    # flags: env 0's first of its new episode, env 1 (timer) and env 2
    # (reached) drew new ones, env 3 kept its own; the draws are bitwise
    np.testing.assert_array_equal(rt.aux["flag_count"].numpy(), [0.0, 4.0, 2.0, 0.0])
    np.testing.assert_array_equal(rt.aux["flag_timeout"].numpy(), [149.0, 150.0, 150.0, 149.0])
    for k in ("flag_count", "flag_timeout", "target_x", "target_y", "initial_z") + (
            ("frame", "ground_counter") if env_id == HARDER else ()):
        np.testing.assert_array_equal(rj["aux"][k], rt.aux[k].numpy(), err_msg=k)
    np.testing.assert_allclose(rj["aux"]["potential"], rt.aux["potential"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(rj["obs"], rt.obs.numpy(), atol=1e-5)
    np.testing.assert_allclose(rj["reward"], rt.reward.numpy(), atol=1e-3)


def test_cube_throw_substep_matches_jax():
    """(b) frame_skip=1 on FlagrunHarder, the cube thrown on env 2"""
    tj, tt = pg.make_task(HARDER), make_task(HARDER)
    B = 4
    sj = _adversity_state(tt, B, 21)
    a = np.random.default_rng(22).uniform(-1, 1, (tt.act_dim, B)).astype(np.float32)
    rj = _jax_kernel_body(tj, sj, a, frame_skip=1)
    rt = env_step_plain(tt, env_state_from_numpy(sj, device="cpu"), torch.from_numpy(a), frame_skip=1)
    dq = np.abs(rj["q"] - rt.q.numpy())
    _q_bounds(dq, 1e-5)
    cq = slice(tt.cube_qadr, tt.cube_qadr + 3)
    assert np.abs(rt.q.numpy()[cq, 2] - sj["q"][cq, 2]).max() > 1.0  # thrown
    np.testing.assert_allclose(rj["q"][cq], rt.q.numpy()[cq], atol=1e-4)
    for k in rj["aux"]:
        da = np.abs(rj["aux"][k] - rt.aux[k].numpy())
        assert np.median(da) < 5e-2, (k, da)
    np.testing.assert_array_equal(rj["terminated"], rt.terminated.numpy())


@pytest.mark.parametrize("env_id,n_pairs", [(HUMANOID, 66), (HARDER, 75)])
def test_full_self_collision_pairs_match_jax(env_id, n_pairs):
    """(e)"""
    tj, tt = pg.make_task(env_id), make_task(env_id)
    full_j = ct_j.full_self_collision_pairs(tj.model, exclude_geoms=("cube_geom",))
    full_t = ct_t.full_self_collision_pairs(tt.model, exclude_geoms=("cube_geom",))
    assert full_t == full_j and len(full_t) == 66
    assert tt.physics.solver.self_collision_pairs == tj.physics.solver.self_collision_pairs
    _, pairs = ct_t.build_contact_plan(tt.model, tt.physics.solver)
    assert len(pairs) == n_pairs
    assert tt.foot_rows == tj.foot_rows


def _at_height(task, B, seed, z):
    """A post-reset batch (numpy) with the root shifted so that the base
    body's COM sits at height z[i] in env i."""
    s = env_state_to_numpy(_reset(task, B, seed))
    fk = dyn_t.forward_kinematics(task.model, list(torch.from_numpy(s["q"])),
                                  list(torch.from_numpy(s["v"])), with_inertia=False)
    com_z = fk.com[task.base_body][2].numpy()
    s["q"][2] += (np.asarray(z, np.float32) - com_z).astype(np.float32)
    return s


@pytest.mark.parametrize("env_id", [HUMANOID, HARDER])
def test_termination_matches_jax_and_the_twin(env_id):
    """(f) The alive test at its edges: Humanoid's base COM just below and
    above 0.78; FlagrunHarder's get-up counter stepping onto and off its
    limit of 170 (COM just below or above 0.8). The JAX package's output
    hook, the port's and the host twin (the kernels' C++, frame_skip 0:
    outputs on the given state) agree on termination exactly and on alive
    and reward to float32 round-off."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the host twin")
    tj, tt = pg.make_task(env_id), make_task(env_id)
    B = 4
    if env_id == HUMANOID:
        z, counter, want = [0.77, 0.78 - 1e-5, 0.78 + 1e-5, 0.79], None, [1, 1, 0, 0]
    else:  # (COM, counter before the step): 170 ends it, 169 or 168 does not
        z, counter, want = [0.8 - 1e-5, 0.8 + 1e-5, 0.8 - 1e-5, 0.8 + 1e-5], \
            [169.0, 169.0, 168.0, 171.0], [1, 0, 0, 1]
    s = _at_height(tt, B, 31, z)
    if counter is not None:
        s["aux"]["ground_counter"] = np.array(counter, np.float32)
        s["aux"]["frame"] = np.full(B, 7.0, np.float32)  # no cube throw
    n_rows = len(step_j.sc_rows(ct_j.build_contact_plan(tj.model, tj.physics.solver)))
    ids = (s["seed"], s["env_id"], s["epoch"])
    oj = tj.output_scalar([jnp.asarray(x) for x in s["q"]], [jnp.asarray(x) for x in s["v"]],
                          [jnp.zeros(B)] * n_rows, [jnp.zeros(B)] * tj.act_dim,
                          {k: jnp.asarray(x) for k, x in s["aux"].items()},
                          tuple(jnp.asarray(x) for x in ids))
    zt = torch.zeros(B)
    ot = tt.output_scalar(list(torch.from_numpy(s["q"])), list(torch.from_numpy(s["v"])),
                          [zt] * n_rows, [zt] * tt.act_dim,
                          {k: torch.from_numpy(x) for k, x in s["aux"].items()},
                          tuple(torch.from_numpy(x.astype(np.int64)) for x in ids))
    twin = ce.HostTwin()
    oh = twin.env_step(ce.pack_tables(tt, frame_skip=0), tt, env_state_from_numpy(s, device="cpu"), torch.zeros((tt.act_dim, B)))
    term = {"jax": np.asarray(oj[2]), "port": ot[2].numpy(), "twin": oh.terminated.numpy()}
    for k, x in term.items():
        np.testing.assert_array_equal(x, np.array(want, bool), err_msg=k)
    alive_j = np.asarray(oj[4]["alive"])
    np.testing.assert_allclose(ot[4]["alive"].numpy(), alive_j, atol=1e-6)
    np.testing.assert_allclose(oh.rewards["alive"].numpy(), alive_j, atol=1e-6)
    np.testing.assert_allclose(ot[1].numpy(), np.asarray(oj[1]), atol=1e-3)
    np.testing.assert_allclose(oh.reward.numpy(), np.asarray(oj[1]), atol=1e-3)


def jax_policy_rollout(env_id, B=8, seed=123, log=print):
    """The shipped policy's return on the JAX package's XLA env step on the
    host CPU: one env step (policy included) jitted, looped from Python
    over one episode; returns masked after the first done, as
    tests/test_frozen_policy.py does. Logs the compile time and progress."""
    import time

    import jax

    from pybulletgym_tpu.envs.base import make_env
    from test_frozen_policy import _policy

    tj = pg.make_task(env_id)
    reset, step = make_env(tj)
    act = _policy(os.path.join(ROOT, "examples", "weights", f"{env_id}.npz"))
    one = jax.jit(lambda s: step(s, act(s.obs.T).T))
    s = reset(jnp.full((B,), seed, jnp.uint32), jnp.arange(B, dtype=jnp.int32),
              jnp.zeros((B,), jnp.uint32))
    t0 = time.time()
    rews, dones = [], []
    for t in range(tj.max_episode_steps):
        s = one(s)
        rews.append(np.asarray(s.reward))
        dones.append(np.asarray(s.done))
        if t == 0 or (t + 1) % 100 == 0:
            log(f"step {t + 1}: {time.time() - t0:.1f} s")
    alive = np.cumprod(1.0 - np.stack(dones).astype(np.float32), 0)
    prev = np.concatenate([np.ones((1, B), np.float32), alive[:-1]], 0)
    returns = (np.stack(rews) * prev).sum(0)
    lengths = prev.sum(0)
    log(f"{env_id}: returns {returns.tolist()} mean {returns.mean()} lengths {lengths.tolist()}")
    return returns, lengths


if __name__ == "__main__":
    # python tests/test_torch_humanoid.py [env id]: the JAX CPU rollout above
    import sys

    jax_policy_rollout(sys.argv[1] if len(sys.argv) > 1 else HUMANOID,
                       log=lambda m: print(m, flush=True))
