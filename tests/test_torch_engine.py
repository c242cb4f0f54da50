"""The port's env step against the JAX package, and the CUDA kernels' C++
against the plain version, on HalfCheetah (hinge and slide joints) and Ant
(a free root joint and the "ant" alive mode).

(a) make_physics_step_plain vs an eager JAX frame_skip loop over
    `make_substep_scalar`: the same float32 formulas in the same order,
    mean |dq| < 1e-5.
(b) env_step_plain vs an eager JAX composition of the TPU kernel body
    (pallas_engine.py · make_pallas_env_step, rebuilt below), through a
    forced auto-reset: epoch, step count and the reset q exact.
(c) the 20-step CPU golden: median |dobs| < 1e-3 at step 5, < 3e-2 at
    step 20 (the drift budget of test_pallas_equivalence.py), terminated
    equal; through the plain version for HalfCheetah and Ant, through the
    host twin for Hopper, Walker2D, HalfCheetah and Ant.
(d) the host twin (csrc/engine_core.h built with g++) vs the plain version,
    under the bounds chip_smoke.py holds the CUDA kernels to; and on
    HalfCheetah with `bthigh` made a cylinder (disk rows on the regular
    branch), mean |dq| < 1e-5 and depths to 1e-5 over one substep.
(e) BatchedEnv on "cuda", the default device, raises when no GPU is present.
test_torch_cuda.py holds the CUDA kernels against the plain version on a GPU.
"""

import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybulletgym_tpu as pg
from pybulletgym_tpu.envs.base import make_env
from pybulletgym_tpu.ops import smath as sm_j
from pybulletgym_tpu.ops import step as step_j
from pybulletgym_tpu_torch import make_batched, make_task
from pybulletgym_tpu_torch.envs import locomotion as loco_t
from pybulletgym_tpu_torch.envs.base import BatchedEnv, Task, env_step_plain, reset_fn
from pybulletgym_tpu_torch.models.mjcf import load_mjcf
from pybulletgym_tpu_torch.models.schema import GeomType
from pybulletgym_tpu_torch.ops import cuda_engine as ce
from pybulletgym_tpu_torch.ops.step import make_physics_step_plain
from pybulletgym_tpu_torch.utils.interop import (
    env_state_from_numpy, env_state_to_numpy, policy_from_npz,
)
from test_torch_cuda import bounds_env  # chip_smoke.py's env-step bounds

ENV = "HalfCheetahPyBulletEnv-v0"
ANT = "AntPyBulletEnv-v0"
WALKERS = ("HopperPyBulletEnv-v0", "Walker2DPyBulletEnv-v0", ENV, ANT)
HUMANOIDS = ("HumanoidPyBulletEnv-v0", "HumanoidFlagrunPyBulletEnv-v0",
             "HumanoidFlagrunHarderPyBulletEnv-v0")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", params=[ENV, ANT])
def tasks(request):
    return pg.make_task(request.param), make_task(request.param)


def _rand_tau(task, B, seed):
    tau = np.zeros((task.model.nv, B), np.float32)
    a = np.random.default_rng(seed).uniform(-1, 1, (task.act_dim, B)).astype(np.float32)
    tau[task.act_dofs] = task.gains * a
    return tau


def _jax_reset(task_j, B, seed):
    reset, _ = make_env(task_j)
    s = reset(jnp.full((B,), seed, jnp.uint32), jnp.arange(B, dtype=jnp.int32),
              jnp.zeros((B,), jnp.uint32))
    return env_state_to_numpy(s)


def _jax_kernel_body(task, st, action, frame_skip):
    """pallas_engine.py · make_pallas_env_step's kernel body, eagerly on
    (B,) arrays (env_id read from the state, as the XLA path does)."""
    model, cfg = task.model, task.physics
    substep, _, n_rows = step_j.make_substep_scalar(model, cfg)
    seed = jnp.asarray(st["seed"], jnp.uint32)
    env_id = jnp.asarray(st["env_id"], jnp.int32)
    done = jnp.asarray(st["terminated"] | st["truncated"])
    epoch = jnp.asarray(st["epoch"], jnp.uint32) + done.astype(jnp.uint32)
    fq, fv, faux = task.initial_state_scalar(seed, env_id, epoch)
    q = [jnp.where(done, fq[i], st["q"][i]) for i in range(model.nq)]
    v = [jnp.where(done, fv[i], st["v"][i]) for i in range(model.nv)]
    aux = {k: jnp.where(done, faux[k], st["aux"][k]) for k in sorted(faux)}
    step_count = jnp.where(done, 0, jnp.asarray(st["step_count"]))
    ids = (seed, env_id, epoch)
    q, v, aux = task.pre_physics_scalar(q, v, aux, ids)
    a = [jnp.clip(jnp.asarray(action[i]), -1.0, 1.0) for i in range(task.act_dim)]
    zero = jnp.zeros_like(q[0])
    tau = tuple(t if not isinstance(t, float) else zero for t in task.action_tau_scalar(a))
    d = [zero] * n_rows
    for _ in range(frame_skip):
        q, v, d = substep(q, v, tau)
    obs, reward, term, aux2, comps = task.output_scalar(list(q), list(v), list(d), a, aux, ids)
    finite = sm_j.isfinite(reward)
    for x in list(obs) + list(q) + list(v):
        finite = finite & sm_j.isfinite(x)
    term = term | ~finite
    obs = [jnp.where(sm_j.isfinite(o), o, 0.0) for o in obs]
    step2 = step_count + 1
    return dict(
        q=np.stack([np.asarray(x) for x in q]), v=np.stack([np.asarray(x) for x in v]),
        obs=np.stack([np.asarray(x) for x in obs]),
        reward=np.asarray(jnp.where(sm_j.isfinite(reward), reward, 0.0)),
        terminated=np.asarray(term), truncated=np.asarray((step2 >= task.max_episode_steps) & ~term),
        step_count=np.asarray(step2), epoch=np.asarray(epoch),
        aux={k: np.asarray(x) for k, x in aux2.items()},
    )


def test_reset_matches_jax(tasks):
    tj, tt = tasks
    sj = _jax_reset(tj, 3, 5)
    st = reset_fn(tt, torch.full((3,), 5, dtype=torch.uint32),
                  torch.arange(3, dtype=torch.int32), torch.zeros(3, dtype=torch.uint32))
    np.testing.assert_array_equal(sj["q"], st.q.numpy())  # reset draws are bitwise
    np.testing.assert_allclose(sj["obs"], st.obs.numpy(), atol=1e-6)
    for k in sj["aux"]:
        np.testing.assert_allclose(sj["aux"][k], st.aux[k].numpy(), rtol=1e-6, err_msg=k)


def test_physics_step_plain_matches_jax(tasks):
    """(a)"""
    tj, tt = tasks
    B = 2
    s = _jax_reset(tj, B, 9)
    tau = _rand_tau(tj, B, 9)
    substep, _, _ = step_j.make_substep_scalar(tj.model, tj.physics)
    q, v = [jnp.asarray(r) for r in s["q"]], [jnp.asarray(r) for r in s["v"]]
    taus = [jnp.asarray(r) for r in tau]
    for _ in range(tj.physics.frame_skip):
        q, v, d = substep(q, v, taus)
    step, _, n_rows = make_physics_step_plain(tt.model, tt.physics)
    q2, v2, d2 = step(torch.tensor(s["q"]), torch.tensor(s["v"]), torch.from_numpy(tau))
    dq = np.abs(np.stack([np.asarray(x) for x in q]) - q2.numpy())
    assert dq.mean() < 1e-5, dq.mean()
    np.testing.assert_allclose(np.stack([np.asarray(x) for x in d]), d2.numpy(), atol=1e-5)
    assert d2.shape == (n_rows, B) == ({9: 16, 15: 25}[tt.model.nq], B)


def test_env_step_plain_matches_jax_kernel_body(tasks):
    """(b)"""
    tj, tt = tasks
    B = 3
    sj = _jax_reset(tj, B, 21)
    sj["terminated"] = np.array([True, False, False])
    sj["epoch"] = np.array([2**32 - 1, 4, 0], np.uint32)  # epoch wraps like uint32
    sj["step_count"] = np.array([17, 999, 3], np.int32)  # env 1 truncates
    st = env_state_from_numpy(sj, device="cpu")
    a = np.random.default_rng(21).uniform(-1.5, 1.5, (tt.act_dim, B)).astype(np.float32)

    rj0 = _jax_kernel_body(tj, sj, a, frame_skip=0)
    rt0 = env_step_plain(tt, st, torch.from_numpy(a), frame_skip=0)
    np.testing.assert_array_equal(rj0["q"], rt0.q.numpy())  # reset q exact
    rj = _jax_kernel_body(tj, sj, a, frame_skip=tj.physics.frame_skip)
    rt = env_step_plain(tt, st, torch.from_numpy(a))
    for r_j, r_t in ((rj0, rt0), (rj, rt)):
        np.testing.assert_array_equal(r_j["epoch"], r_t.epoch.numpy())
        np.testing.assert_array_equal(r_j["step_count"], r_t.step_count.numpy())
        np.testing.assert_array_equal(r_j["truncated"], r_t.truncated.numpy())
        np.testing.assert_array_equal(r_j["terminated"], r_t.terminated.numpy())
    assert rt.epoch.tolist() == [0, 4, 0] and rt.step_count.tolist() == [1, 1000, 4]
    assert rt.truncated.tolist() == [False, not rt.terminated[1].item(), False]
    assert np.abs(rj["q"] - rt.q.numpy()).mean() < 1e-5
    np.testing.assert_allclose(rj["obs"], rt.obs.numpy(), atol=1e-4)
    np.testing.assert_allclose(rj["reward"], rt.reward.numpy(), atol=1e-3)
    for k in rj["aux"]:
        np.testing.assert_allclose(rj["aux"][k], rt.aux[k].numpy(), rtol=1e-5, atol=1e-3)


def _replay_golden(env_id, step):
    """Replay the 20-step CPU golden through `step(state, actions (B, act))`
    and hold it to the drift budget."""
    g = np.load(os.path.join(ROOT, "tests", "goldens", f"{env_id}.cpu.npz"))
    B, n, seed = int(g["batch"]), int(g["n_steps"]), int(g["seed"])
    env = make_batched(env_id, B, device="cpu")
    s = env.reset(seed=seed)
    acts = np.random.default_rng(seed).uniform(-1, 1, (n, B, env.action_size)).astype(np.float32)
    meds = []
    for t in range(n):
        s = step(env, s, acts[t])
        meds.append(np.median(np.abs(s.obs.numpy() - g["obs"][t])))
        np.testing.assert_array_equal(s.terminated.numpy(), g["terminated"][t])
    assert meds[4] < 1e-3 and meds[-1] < 3e-2, meds
    return env


@pytest.mark.parametrize("env_id", [ENV, ANT])
def test_golden_rollout(env_id):
    """(c) the plain version"""
    env = _replay_golden(env_id, lambda env, s, a: env.step(s, a))
    assert env.step_fn.launches == 0  # CPU tensors never launch a kernel


@pytest.fixture(scope="module")
def twin():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the host twin")
    return ce.HostTwin()


@pytest.mark.parametrize("env_id", WALKERS)
def test_golden_rollout_on_host_twin(env_id, twin):
    """(c) the kernels' C++"""
    task = make_task(env_id)
    tab = ce.pack_tables(task)
    _replay_golden(env_id, lambda env, s, a: twin.env_step(
        tab, task, s, torch.from_numpy(a.T.copy())))


def test_host_twin_physics_step(tasks, twin):
    """(d) physics"""
    _, tt = tasks
    B = 8
    s = BatchedEnv(tt, B, device="cpu").reset(seed=0)
    tau = torch.from_numpy(_rand_tau(tt, B, 3))
    qp, vp, dp = make_physics_step_plain(tt.model, tt.physics)[0](s.q, s.v, tau)
    qh, vh, dh = twin.physics_step(ce.pack_physics(tt.model, tt.physics), s.q, s.v, tau)
    dq = (qp - qh).abs()
    assert dq.mean() < 3e-4 and dq.max() < 1e-2
    assert ((dp > 0) != (dh > 0)).float().mean() < 0.01


def test_host_twin_env_step(tasks, twin):
    """(d) env step: 3 steps, every 3rd env forced to reset before step 2."""
    _, tt = tasks
    B = 8
    tab, tab0 = ce.pack_tables(tt), ce.pack_tables(tt, frame_skip=0)
    sp = sh = BatchedEnv(tt, B, device="cpu").reset(seed=4)
    rng = np.random.default_rng(4)
    for t in range(3):
        if t == 1:
            forced = torch.zeros(B, dtype=torch.bool)
            forced[::3] = True
            sp = sp._replace(terminated=sp.terminated | forced)
            sh = sh._replace(terminated=sh.terminated | forced)
            a0 = torch.zeros(tt.act_dim, B)
            # same input state: the post-reset q is bitwise the plain one
            assert torch.equal(twin.env_step(tab0, tt, sh, a0).q,
                               env_step_plain(tt, sh, a0, frame_skip=0).q)
            again = twin.env_step(tab, tt, sh, a0)
            assert torch.equal(again.q, twin.env_step(tab, tt, sh, a0).q)
        a = torch.from_numpy(rng.uniform(-1, 1, (tt.act_dim, B)).astype(np.float32))
        sp = env_step_plain(tt, sp, a)
        sh = twin.env_step(tab, tt, sh, a)
        bounds_env(sh, sp, len(tt.foot_rows))
    if tt.model.nq != tt.model.nv:  # the free joint's quaternion stays a unit one
        assert (1 - sh.q[3:7].norm(dim=0)).abs().max() < 1e-5


def test_frozen_sac_policy_on_host_twin(twin):
    """The shipped SAC policy keeps its 3000 floor (test_frozen_policy.py:41)
    on the kernels' arithmetic: B=8, reset(seed=123), 1000 steps, returns
    masked after the first done."""
    tt = make_task(ENV)
    tab = ce.pack_tables(tt)
    policy = policy_from_npz(os.path.join(ROOT, "examples", "weights", f"{ENV}.npz"), device="cpu")
    s = make_batched(ENV, 8, device="cpu").reset(seed=123)
    rews, dones = [], []
    with torch.no_grad():
        for _ in range(1000):
            s = twin.env_step(tab, tt, s, policy(s.obs.T).T.contiguous())
            rews.append(s.reward)
            dones.append(s.done)
    alive = torch.cumprod(1.0 - torch.stack(dones).float(), 0)
    prev = torch.cat([torch.ones_like(alive[:1]), alive[:-1]], 0)
    returns = (torch.stack(rews) * prev).sum(0)
    assert torch.isfinite(returns).all() and returns.mean() >= 3000.0, returns


def test_batched_env_cuda_without_gpu_raises():
    """(e)"""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batched(ENV, 4, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batched(ANT, 4)  # the default device is the GPU


@pytest.mark.parametrize("env_id", WALKERS + HUMANOIDS)
def test_pack_tables_takes_the_walkers(env_id):
    task = make_task(env_id)
    t = ce.pack_tables(task)
    assert (t.nq, t.nv, t.act, t.nfeet) == (task.model.nq, task.model.nv, task.act_dim,
                                            len(task.foot_rows))
    assert t.alive_mode == ce.ALIVE_MODES[task.spec.alive_mode]
    assert list(t.qpos0[:t.nq]) == [float(np.float32(x)) for x in task.model.qpos0]
    # the walkers keep the small scratch; the humanoid family, with its
    # self-collision pairs, takes the large one
    assert t.caps_id == (env_id in HUMANOIDS) and (t.npair > 0) == (env_id in HUMANOIDS)
    assert t.naux == len(reset_fn(task, *(torch.zeros(1, dtype=dt) for dt in (
        torch.uint32, torch.int32, torch.uint32))).aux)


def test_work_per_env_step_counts_the_loops(tasks):
    """The floor count behind the kernels' bound: the substeps scale with
    frame_skip, and the bytes are each input read once, each output written
    once (HalfCheetah: 130 in, 226 out)."""
    _, tt = tasks
    t, t0 = ce.pack_tables(tt), ce.pack_tables(tt, frame_skip=0)
    (f, nbytes), (f0, _) = ce.work_per_env_step(t), ce.work_per_env_step(t0)
    assert f - f0 == 4 * ce.substep_flops(t) > 0
    phys_f, phys_b = ce.work_per_env_step(ce.pack_physics(tt.model, tt.physics), env_step=False)
    # q and v in and out, tau in, the depths out
    assert phys_f == 4 * ce.substep_flops(t)
    assert phys_b == 4 * (2 * tt.model.nq + 3 * tt.model.nv + t.nr)
    if tt.model.nq == tt.model.nv:
        assert nbytes == 356
    else:  # the free joint and twice the contact rows make Ant's substep dearer
        assert ce.substep_flops(t) > ce.substep_flops(ce.pack_tables(make_task(ENV)))


def disked_cheetah(task, cylinder):
    """`task` (HalfCheetah, of either package) with the `bthigh` capsule made
    a cylinder of the same size (`cylinder`: that package's
    GeomType.CYLINDER): its two end caps are 8 disk rows, and the thigh's
    axis is slanted, so the rim directions take the regular branch."""
    m = task.model
    g = m.geom_index("bthigh")
    cyl = dataclasses.replace(m.geoms[g], gtype=cylinder)
    task.model = m.replace(geoms=m.geoms[:g] + (cyl,) + m.geoms[g + 1:])
    return task


def disk_touch_state(task, B, seed, depth=3e-3):
    """A post-reset batch of the disked HalfCheetah with the root lowered so
    that the cylinder's deepest rim point lies `depth` into the floor.
    Returns (state, the disk rows)."""
    from pybulletgym_tpu_torch.ops import contacts as ct_t
    from pybulletgym_tpu_torch.ops import dynamics as dyn_t
    from pybulletgym_tpu_torch.ops.step import sc_rows

    s = reset_fn(task, torch.full((B,), seed, dtype=torch.uint32),
                 torch.arange(B, dtype=torch.int32), torch.zeros(B, dtype=torch.uint32))
    plan = ct_t.build_contact_plan(task.model, task.physics.solver)
    disk = [r for r, c in enumerate(sc_rows(plan)) if getattr(c, "kind", "") == "disk"]
    fk = dyn_t.forward_kinematics(task.model, list(s.q), list(s.v), with_inertia=False)
    d = torch.stack([ct_t.narrowphase_scalar(task.model, fk, plan).depth[r] for r in disk])
    q = s.q.clone()
    q[1] -= depth - d.max(0).values  # rootz
    return s._replace(q=q), disk


def test_pack_tables_refuses_what_the_kernels_lack(tasks, tmp_path, twin):
    _, tt = tasks
    # disk rows (a cylinder against the floor plane) pack, and the kernels'
    # C++ steps them as the plain version does: one substep from a state in
    # which the slanted cylinder's rim is 3 mm into the floor
    disked = disked_cheetah(loco_t.WalkerTask(loco_t.HALF_CHEETAH), GeomType.CYLINDER)
    tab = ce.pack_physics(disked.model, disked.physics, frame_skip=1)
    s, disk = disk_touch_state(disked, 4, 6)
    assert len(disk) == 8 and [tab.row_disk[r] for r in disk] == [1, 1, 2, 2] * 2
    tau = torch.from_numpy(_rand_tau(disked, 4, 6))
    cfg1 = dataclasses.replace(disked.physics, frame_skip=1)
    qp, vp, dp = make_physics_step_plain(disked.model, cfg1)[0](s.q, s.v, tau)
    qh, vh, dh = twin.physics_step(tab, s.q, s.v, tau)
    assert (dp[disk] > 0).any(dim=0).all()  # a rim row touches in every env
    assert (qp - qh).abs().mean() < 1e-5 and (qp - qh).abs().max() < 1e-2
    assert (dp - dh).abs().max() < 1e-5

    # a task class the kernels do not know
    class Unknown(Task):
        pass

    with pytest.raises(NotImplementedError, match="Unknown"):
        ce.pack_tables(Unknown())
    # a pre-physics hook that is not FlagrunHarder's
    class Pushed(loco_t.WalkerTask):
        def pre_physics_scalar(self, q, v, aux, ids=None):
            return q, v, aux

    with pytest.raises(NotImplementedError, match="Pushed"):
        ce.pack_tables(Pushed(loco_t.HALF_CHEETAH))
    # a model above 128 dofs (22 free balls: 132), over the huge class's
    # caps, is not refused: it takes the sized class (seven balls, nv 42,
    # are in the large class: test_torch_big_models.py; eleven, nv 66, in
    # the huge one: test_torch_huge_models.py; test_torch_sized_models.py)
    balls = "".join(
        f'<body name="b{i}" pos="{i} 0 1"><joint name="j{i}" type="free"/>'
        f'<geom name="g{i}" type="sphere" size="0.1"/></body>' for i in range(22))
    xml = tmp_path / "balls.xml"
    xml.write_text('<mujoco model="balls"><worldbody><geom name="floor" type="plane" '
                   f'size="10 10 0.1"/>{balls}</worldbody></mujoco>')
    model = load_mjcf(str(xml))
    assert model.nv == 132
    assert ce.tables_class(ce.pack_physics(model, tt.physics)) == ce.SIZED
    env = BatchedEnv(tt, 4, device="cpu")  # the kernel library is built lazily
    with pytest.raises(ValueError, match="action shape"):
        env.step(env.reset(), np.zeros((4, tt.act_dim - 1), np.float32))
