"""The CUDA kernels on a GPU, against their plain PyTorch versions.

This file imports torch and the port only, never jax, so it runs on a GPU
machine without the JAX package (tests/conftest.py imports jax, hence
`--noconftest`):

    python -m pytest --noconftest tests/test_torch_cuda.py

Without a GPU every test here skips. Ragged batches (B=1, 3E+1 for the
launch's E envs a block, 4097) are held on HalfCheetah and Humanoid. The
bounds are the walker budget of
test_pallas_equivalence.py:38-51 on HalfCheetah (hinge and slide joints),
Ant (a free root), Atlas (nv 36 over a group of 32 lanes, root paths past
bit 31), Pusher (disk rows, empty aux) and Thrower (a free ball that is not
body 0), and the humanoid-family budget of
test_pallas_equivalence.py:80-86 on Humanoid and FlagrunHarder (self-
collision pairs, the large scratch instantiation, the cube), as
chip_smoke.py holds them. The Gym-MuJoCo mirrors HopperMuJoCo (a planar
root), AntMuJoCo (a free root, obs with a zero block), HumanoidMuJoCo (obs
376, 331 of them zeros) and ReacherMuJoCo (the disk-drawn target, held to 1
ulp) at the walker budget, and one SAC iteration, whose collect launches
the env kernel. A user's task (a HalfCheetah subclass with its own reward
and aux key) through task_step_kernel, its hooks translated, at the walker
budget, and through the composed backend's CUDA graph (one physics launch
a replay). Seven free balls (nv 42) through physics_step_kernel's large
build (engine_core.h's large tables' class), at the walker budget. The
default class's PGS sweep (one butterfly a contact row and a limit pair)
against the host twin on HalfCheetah, Humanoid and Atlas, and the large
and huge builds (the same substep, the sweep by row windows) on balls and
two Humanoids.
"""

import shutil

import pytest
import torch

from pybulletgym_tpu_torch import make_batched, make_task
from pybulletgym_tpu_torch.envs.base import env_step_plain
from pybulletgym_tpu_torch.ops import cuda_engine as ce
from pybulletgym_tpu_torch.parallel import ppo, sac

ENV = "HalfCheetahPyBulletEnv-v0"
ANT = "AntPyBulletEnv-v0"
HUMANOID = "HumanoidPyBulletEnv-v0"
HARDER = "HumanoidFlagrunHarderPyBulletEnv-v0"
PUSHER = "PusherPyBulletEnv-v0"
THROWER = "ThrowerPyBulletEnv-v0"
ATLAS = "AtlasPyBulletEnv-v0"
IDS = {"half_cheetah": ENV, "ant": ANT, "humanoid": HUMANOID, "humanoid_flagrun_harder": HARDER,
       "atlas": ATLAS}
B = 300  # not a multiple of any launch's envs a block: a ragged last block

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


def bounds_fixed(a, b):
    """The walkers' env-step parity for the fixed-base family (no foot
    flags): q mean/max, obs mean, reward median, termination flips, aux
    medians; epoch, step count and truncation exact."""
    dq = (a.q - b.q).abs()
    assert dq.mean() < 3e-4 and dq.max() < 1e-2
    assert (a.obs - b.obs).abs().mean() < 1e-3
    assert (a.reward - b.reward).abs().median() < 5e-3
    assert (a.terminated != b.terminated).float().mean() < 0.01
    for k in b.aux:
        assert (a.aux[k] - b.aux[k]).abs().median() < 5e-3, k
    for name in ("epoch", "step_count", "truncated"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def bounds_humanoid(a, b):
    """The humanoid family's env-step parity: median/mean/max |dq|,
    termination flips, aux medians; epoch, step count and truncation
    exact."""
    dq = (a.q - b.q).abs()
    assert dq.median() < 1.5e-3 and dq.mean() < 5e-3 and dq.max() < 8e-2
    assert (a.terminated != b.terminated).float().mean() < 0.01
    for k in b.aux:
        assert (a.aux[k] - b.aux[k]).abs().median() < 5e-2, k
    for name in ("epoch", "step_count", "truncated"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.fixture(scope="module", params=[ENV, ANT, ATLAS])
def task(request):
    _need_gpu()
    return make_task(request.param)


def _state(task, seed):
    """A CUDA batch after reset, with every 3rd env due for an auto-reset."""
    env = make_batched(IDS[task.spec.name], B, device="cuda")
    s = env.reset(seed=seed)
    forced = torch.zeros(B, dtype=torch.bool, device="cuda")
    forced[::3] = True
    return env, s._replace(terminated=forced)


def test_env_kernel_matches_plain(task):
    env, s = _state(task, 2)
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
    if task.model.nq != task.model.nv:  # the free joint's quaternion stays a unit one
        assert (1 - out.q[3:7].norm(dim=0)).abs().max() < 1e-5


def test_physics_kernel_matches_plain(task):
    _, s = _state(task, 3)
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


@pytest.fixture(scope="module", params=[HUMANOID, HARDER])
def humanoid(request):
    _need_gpu()
    return make_task(request.param)


def test_humanoid_env_kernel_matches_plain(humanoid):
    """The large instantiation: pair rows, the humanoid alive mode, flags,
    the lying reset, the cube and the get-up machine"""
    task = humanoid
    env, s = _state(task, 2)
    if "frame" in s.aux:  # a cube throw on every 4th env
        throw = torch.zeros(B, dtype=torch.bool, device="cuda")
        throw[1::4] = True
        s.aux["frame"] = torch.where(throw, 120.0, s.aux["frame"])
        s.aux["ground_counter"] = torch.where(throw, 0.0, s.aux["ground_counter"])
    g = torch.Generator(device="cuda").manual_seed(2)
    a = torch.rand((task.act_dim, B), device="cuda", generator=g) * 2 - 1
    out = env.step_fn(s, a)
    assert env.step_fn.launches == 1
    bounds_humanoid(out, env_step_plain(task, s, a))
    forced = s.terminated
    reset_k = ce.make_cuda_env_step(task, frame_skip=0)(s, a)
    reset_p = env_step_plain(task, s, a, frame_skip=0)
    assert torch.equal(reset_k.q[:, forced], reset_p.q[:, forced])
    for k in ("target_x", "target_y"):  # the flag draws
        assert torch.equal(reset_k.aux[k][forced], reset_p.aux[k][forced]), k
    again = env.step_fn(s, a)
    for name in ("q", "v", "obs", "reward", "terminated", "truncated", "step_count", "epoch"):
        assert torch.equal(getattr(out, name), getattr(again, name)), name
    assert (1 - out.q[3:7].norm(dim=0)).abs().max() < 1e-5


def test_humanoid_physics_kernel_matches_plain(humanoid):
    task = humanoid
    _, s = _state(task, 3)
    phys = ce.make_cuda_physics_step(task.model, task.physics)[0]
    g = torch.Generator(device="cuda").manual_seed(3)
    tau = torch.zeros((task.model.nv, B), device="cuda")
    act = torch.as_tensor(task.act_dofs, dtype=torch.int64, device="cuda")
    gains = torch.as_tensor(task.gains, device="cuda")
    tau[act] = gains * (torch.rand((task.act_dim, B), device="cuda", generator=g) * 2 - 1)
    qk, vk, dk = phys(s.q, s.v, tau)
    qp, vp, dp = phys.plain(s.q, s.v, tau)
    dq = (qk - qp).abs()
    assert dq.median() < 1.5e-3 and dq.mean() < 5e-3 and dq.max() < 8e-2
    assert ((dk > 0) != (dp > 0)).float().mean() < 0.01
    assert torch.isfinite(vk).all() and phys.launches == 1


@pytest.fixture(scope="module", params=[PUSHER, THROWER])
def arm(request):
    _need_gpu()
    return request.param, make_task(request.param)


def test_arm_env_kernel_matches_plain(arm):
    """Pusher's disk rows and empty aux, Thrower's free ball: one step with
    every 3rd env forced to reset; the reset draws bitwise"""
    env_id, task = arm
    env = make_batched(env_id, B, device="cuda")
    forced = torch.zeros(B, dtype=torch.bool, device="cuda")
    forced[::3] = True
    s = env.reset(seed=2)._replace(terminated=forced)
    g = torch.Generator(device="cuda").manual_seed(2)
    a = torch.rand((task.act_dim, B), device="cuda", generator=g) * 2 - 1
    out = env.step_fn(s, a)
    assert env.step_fn.launches == 1 and sorted(out.aux) == sorted(s.aux)
    bounds_fixed(out, env_step_plain(task, s, a))
    reset_k = ce.make_cuda_env_step(task, frame_skip=0)(s, a)
    reset_p = env_step_plain(task, s, a, frame_skip=0)
    assert torch.equal(reset_k.q[:, forced], reset_p.q[:, forced])
    assert torch.equal(reset_k.v[:, forced], reset_p.v[:, forced])
    again = env.step_fn(s, a)
    for name in ("q", "v", "obs", "reward", "terminated", "truncated", "step_count", "epoch"):
        assert torch.equal(getattr(out, name), getattr(again, name)), name


def test_arm_physics_kernel_matches_plain(arm):
    env_id, task = arm
    s = make_batched(env_id, B, device="cuda").reset(seed=3)
    g = torch.Generator(device="cuda").manual_seed(3)
    a = torch.rand((task.act_dim, B), device="cuda", generator=g) * 2 - 1
    zero = torch.zeros(B, device="cuda")
    tau = torch.stack([zero if isinstance(x, float) else x
                       for x in task.action_tau_scalar(list(a))], 0)
    phys = ce.make_cuda_physics_step(task.model, task.physics)[0]
    qk, vk, dk = phys(s.q, s.v, tau)
    qp, vp, dp = phys.plain(s.q, s.v, tau)
    dq = (qk - qp).abs()
    assert dq.mean() < 3e-4 and dq.max() < 1e-2
    assert dk.shape == dp.shape and ((dk > 0) != (dp > 0)).float().mean() < 0.01
    assert torch.isfinite(vk).all() and phys.launches == 1


def test_wrappers_refuse_bad_cuda_inputs(task):
    env, s = _state(task, 4)
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


def _user_task():
    from pybulletgym_tpu_torch.envs import locomotion as loco

    class Sprinter(loco.WalkerTask):  # double progress, and a count of fast steps
        def __init__(self):
            super().__init__(loco.HALF_CHEETAH)

        def initial_state_scalar(self, seed, env_id, epoch):
            q, v, aux = super().initial_state_scalar(seed, env_id, epoch)
            return q, v, dict(aux, fast=torch.zeros_like(aux["potential"]))

        def output_scalar(self, q, v, depths, a, aux, ids=None):
            obs, reward, term, aux2, comps = super().output_scalar(q, v, depths, a, aux, ids)
            fast = aux["fast"] + torch.where(v[0] > 1.0, 1.0, 0.0)
            return obs, reward + comps["progress"], term, dict(aux2, fast=fast), comps

    return Sprinter()


def test_user_task_kernel_matches_plain():
    """A user's task: 3 steps of task_step_kernel (3 launches, no other
    kernel) against the plain version from the same inputs, every 3rd env
    reset; then 2 composed steps replayed from a CUDA graph (one physics
    launch a replay) against the task kernel's."""
    _need_gpu()
    from pybulletgym_tpu_torch.envs.base import BatchedEnv

    task = _user_task()
    env = BatchedEnv(task, B, device="cuda")
    assert env.step_fn.kernel == "task_step_kernel"
    s = env.reset(seed=5)
    s = s._replace(terminated=torch.arange(B, device="cuda") % 3 == 0)
    ce.reset_launch_counts()
    for t in range(3):
        a = torch.rand((task.act_dim, B), device="cuda", generator=torch.Generator(
            "cuda").manual_seed(t)) * 2 - 1
        k = env.step_fn(s, a)
        bounds_env(k, env_step_plain(task, s, a), len(task.foot_rows))
        assert sorted(k.aux) == sorted(s.aux) and "fast" in k.aux
        s = k
    assert dict(ce.LAUNCHES) == dict(dict.fromkeys(ce.LAUNCHES, 0), task_step_kernel=3)
    comp = BatchedEnv(task, B, device="cuda", backend="composed")
    ce.reset_launch_counts()
    for _ in range(2):
        c, k = comp.step_fn(s, a), env.step_fn(s, a)
        bounds_env(c, k, len(task.foot_rows))
        s = k
    assert ce.LAUNCHES["physics_step_kernel"] == 2 and comp.step_fn.launches == 2


def test_ppo_train_step_launches_the_env_kernel():
    """One PPO train step on Ant on the GPU: T launches of env_step_kernel,
    a finite loss, num_epochs x num_minibatches Adam updates."""
    _need_gpu()
    cfg = ppo.PPOConfig(rollout_length=4, num_epochs=2, num_minibatches=2)
    env = make_batched(ANT, 256)
    ts = ppo.init_train_state(0, env.observation_size, env.action_size, cfg)
    step = ppo.make_train_step(env.task, cfg, step_fn=env.step_fn)
    ce.reset_launch_counts()
    ts, es, metrics = step(ts, env.reset(seed=0))
    torch.cuda.synchronize()
    assert env.step_fn.launches == ce.LAUNCHES["env_step_kernel"] == 4
    assert int(ts.opt_count) == 4
    assert torch.isfinite(metrics["loss"]) and es.q.is_cuda


def _take(s, n):
    """The first n envs of a batch-trailing state, each field contiguous."""
    f = lambda x: x[..., :n].contiguous()  # noqa: E731
    names = ("q", "v", "obs", "reward", "terminated", "truncated", "step_count", "epoch",
             "env_id", "seed")
    return s._replace(**{k: f(getattr(s, k)) for k in names},
                      aux={k: f(x) for k, x in s.aux.items()},
                      rewards={k: f(x) for k, x in s.rewards.items()})


RAGGED = 4097


@pytest.fixture(scope="module", params=[ENV, HUMANOID])
def ragged(request):
    """A batch of 4097 (every 3rd env due for an auto-reset), its actions
    and torques, and the plain version's env step and physics step on it;
    every env is independent, so the first n envs of these are the plain
    outputs of a batch of n."""
    _need_gpu()
    env_id = request.param
    task = make_task(env_id)
    env = make_batched(env_id, RAGGED, device="cuda")
    forced = torch.zeros(RAGGED, dtype=torch.bool, device="cuda")
    forced[::3] = True
    s = env.reset(seed=7)._replace(terminated=forced)
    g = torch.Generator(device="cuda").manual_seed(7)
    a = torch.rand((task.act_dim, RAGGED), device="cuda", generator=g) * 2 - 1
    tau = torch.zeros((task.model.nv, RAGGED), device="cuda")
    act = torch.as_tensor(task.act_dofs, dtype=torch.int64, device="cuda")
    tau[act] = torch.as_tensor(task.gains, device="cuda") * a
    phys = ce.make_cuda_physics_step(task.model, task.physics)[0]
    return dict(env_id=env_id, task=task, env=env, s=s, a=a, tau=tau, phys=phys,
                env_plain=env_step_plain(task, s, a), phys_plain=phys.plain(s.q, s.v, tau))


@pytest.mark.parametrize("size", ["1", "3E+1", "4097"])
def test_ragged_batches_match_plain(ragged, size):
    """Both kernels at B=1, one env past 3 full blocks, and 4097"""
    task, env, phys = ragged["task"], ragged["env"], ragged["phys"]
    humanoid = ragged["env_id"] == HUMANOID
    for kernel, tables in (("env_step_kernel", env.step_fn.tables),
                           ("physics_step_kernel", phys.tables)):
        E = ce.launch_config(tables, kernel)["E"]
        n = {"1": 1, "3E+1": 3 * E + 1, "4097": RAGGED}[size]
        s, a, tau = _take(ragged["s"], n), ragged["a"][:, :n].contiguous(), ragged["tau"][:, :n].contiguous()
        if kernel == "env_step_kernel":
            out = env.step_fn(s, a)
            want = _take(ragged["env_plain"], n)
            if humanoid:
                bounds_humanoid(out, want)
            else:
                bounds_env(out, want, len(task.foot_rows))
        else:
            qk, vk, dk = phys(s.q, s.v, tau)
            qp, vp, dp = (x[:, :n] for x in ragged["phys_plain"])
            dq = (qk - qp).abs()
            if humanoid:
                assert dq.median() < 1.5e-3 and dq.mean() < 5e-3 and dq.max() < 8e-2
            else:
                assert dq.mean() < 3e-4 and dq.max() < 1e-2
            assert ((dk > 0) != (dp > 0)).float().mean() < 0.01
            assert torch.isfinite(vk).all()


MUJOCO = ("HopperMuJoCoEnv-v0", "AntMuJoCoEnv-v0", "HumanoidMuJoCoEnv-v0", "ReacherMuJoCoEnv-v0")


def ulps(a, b):
    """|a - b| in float32 spacings (same-signed finite values)."""
    return (a.view(torch.int32).to(torch.int64) - b.view(torch.int32).to(torch.int64)).abs()


@pytest.fixture(scope="module", params=MUJOCO)
def mujoco(request):
    _need_gpu()
    return request.param, make_task(request.param)


def test_mujoco_env_kernel_matches_plain(mujoco):
    """One step with every 3rd env forced to reset: the reset draws bitwise
    (Reacher's disk-drawn target to 1 ulp), the step at the walker budget,
    bitwise repeatable"""
    env_id, task = mujoco
    env = make_batched(env_id, B, device="cuda")
    forced = torch.zeros(B, dtype=torch.bool, device="cuda")
    forced[::3] = True
    s = env.reset(seed=2)._replace(terminated=forced)
    g = torch.Generator(device="cuda").manual_seed(2)
    a = torch.rand((task.act_dim, B), device="cuda", generator=g) * 2 - 1
    out = env.step_fn(s, a)
    assert env.step_fn.launches == 1 and sorted(out.aux) == sorted(s.aux)
    bounds_fixed(out, env_step_plain(task, s, a))
    reset_k = ce.make_cuda_env_step(task, frame_skip=0)(s, a)
    reset_p = env_step_plain(task, s, a, frame_skip=0)
    disk = [task.tx, task.ty] if hasattr(task, "tx") else []
    rest = [j for j in range(task.model.nq) if j not in disk]
    assert torch.equal(reset_k.q[rest][:, forced], reset_p.q[rest][:, forced])
    assert torch.equal(reset_k.v[:, forced], reset_p.v[:, forced])
    if disk:
        assert ulps(reset_k.q[disk][:, forced], reset_p.q[disk][:, forced]).max() <= 1
    for k in reset_p.aux:
        assert torch.equal(reset_k.aux[k][forced], reset_p.aux[k][forced]), k
    again = env.step_fn(s, a)
    for name in ("q", "v", "obs", "reward", "terminated", "truncated", "step_count", "epoch"):
        assert torch.equal(getattr(out, name), getattr(again, name)), name


def test_mujoco_physics_kernel_matches_plain(mujoco):
    env_id, task = mujoco
    s = make_batched(env_id, B, device="cuda").reset(seed=3)
    g = torch.Generator(device="cuda").manual_seed(3)
    a = torch.rand((task.act_dim, B), device="cuda", generator=g) * 2 - 1
    zero = torch.zeros(B, device="cuda")
    tau = torch.stack([zero if isinstance(x, float) else x
                       for x in task.action_tau_scalar(list(a))], 0)
    phys = ce.make_cuda_physics_step(task.model, task.physics)[0]
    qk, vk, dk = phys(s.q, s.v, tau)
    qp, vp, dp = phys.plain(s.q, s.v, tau)
    dq = (qk - qp).abs()
    assert dq.mean() < 3e-4 and dq.max() < 1e-2
    assert dk.shape == dp.shape
    if dk.numel():  # ReacherMuJoCo has no contact rows
        assert ((dk > 0) != (dp > 0)).float().mean() < 0.01
    assert torch.isfinite(vk).all() and phys.launches == 1


def test_sac_iteration_launches_the_env_kernel():
    """One SAC iteration on HopperMuJoCo on the GPU: steps_per_iter launches
    of env_step_kernel, finite losses, updates_per_iter Adam updates."""
    _need_gpu()
    cfg = sac.SACConfig(hidden=(64, 64), steps_per_iter=2, updates_per_iter=2, batch_size=64,
                        warmup_steps=0)
    env = make_batched("HopperMuJoCoEnv-v0", 256)
    ss = sac.init_sac_state(0, env.observation_size, env.action_size, 256, cfg)
    it = sac.make_sac_iteration(env.task, cfg, step_fn=env.step_fn)
    ce.reset_launch_counts()
    ss, es, metrics = it(ss, env.reset(seed=0))
    torch.cuda.synchronize()
    assert env.step_fn.launches == ce.LAUNCHES["env_step_kernel"] == 2
    assert int(ss.opt_critic[2]) == int(ss.opt_actor[2]) == 2 and ss.buf_ptr == 2
    assert all(torch.isfinite(x) for x in metrics.values()) and es.q.is_cuda


def test_large_tables_physics_kernel_matches_plain():
    """Seven free balls (nv 42, over the default tables' 40 dofs) through
    physics_step_kernel's large build (the tables in global memory), at the
    walker budget, counted apart."""
    _need_gpu()
    from pybulletgym_tpu_torch.models.mjcf import parse_mjcf
    from pybulletgym_tpu_torch.ops.step import PhysicsConfig

    balls = "".join(
        f'<body name="b{i}" pos="{0.3 * i} 0 0.09"><joint name="j{i}" type="free"/>'
        f'<geom name="g{i}" type="sphere" size="0.1"/></body>' for i in range(7))
    model = parse_mjcf('<mujoco model="balls"><worldbody><geom name="floor" type="plane" '
                       f'size="10 10 0.1"/>{balls}</worldbody></mujoco>', "balls")
    phys = ce.make_cuda_physics_step(model, PhysicsConfig())[0]
    assert phys.size == ce.LARGE and phys.kernel == "physics_step_kernel_large"
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.as_tensor(model.qpos0, dtype=torch.float32, device="cuda")[:, None].repeat(1, B)
    v = torch.rand((model.nv, B), device="cuda", generator=g) - 0.5
    tau = torch.rand((model.nv, B), device="cuda", generator=g) * 2 - 1
    ce.reset_launch_counts()
    qk, vk, dk = phys(q, v, tau)
    torch.cuda.synchronize()
    assert ce.LAUNCHES["physics_step_kernel_large"] == phys.launches == 1
    assert ce.LAUNCHES["physics_step_kernel"] == 0
    qp, vp, dp = phys.plain(q, v, tau)
    dq = (qk - qp).abs()
    assert dq.mean() < 3e-4 and dq.max() < 1e-2
    assert ((dk > 0) != (dp > 0)).float().mean() < 0.01


def test_huge_tables_physics_kernel_matches_plain():
    """Eleven free balls (nv 66, over the large class's 64 dofs) through
    physics_step_kernel's huge build (the tables and the scratch in global
    memory), at the walker budget, counted apart; a CUDA graph of the
    launch replays on the buffer that prepare allocated, bitwise."""
    _need_gpu()
    from pybulletgym_tpu_torch.models.mjcf import parse_mjcf
    from pybulletgym_tpu_torch.ops.step import PhysicsConfig

    balls = "".join(
        f'<body name="b{i}" pos="{0.3 * i} 0 0.09"><joint name="j{i}" type="free"/>'
        f'<geom name="g{i}" type="sphere" size="0.1"/></body>' for i in range(11))
    model = parse_mjcf('<mujoco model="balls"><worldbody><geom name="floor" type="plane" '
                       f'size="10 10 0.1"/>{balls}</worldbody></mujoco>', "balls")
    phys = ce.make_cuda_physics_step(model, PhysicsConfig())[0]
    assert phys.size == ce.HUGE and phys.kernel == "physics_step_kernel_huge"
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.as_tensor(model.qpos0, dtype=torch.float32, device="cuda")[:, None].repeat(1, B)
    v = torch.rand((model.nv, B), device="cuda", generator=g) - 0.5
    tau = torch.rand((model.nv, B), device="cuda", generator=g) * 2 - 1
    phys.prepare(torch.device("cuda"), B)
    ce.reset_launch_counts()
    qk, vk, dk = phys(q, v, tau)
    torch.cuda.synchronize()
    assert ce.LAUNCHES["physics_step_kernel_huge"] == phys.launches == 1
    assert ce.LAUNCHES["physics_step_kernel"] == ce.LAUNCHES["physics_step_kernel_large"] == 0
    qp, vp, dp = phys.plain(q, v, tau)
    dq = (qk - qp).abs()
    assert dq.mean() < 3e-4 and dq.max() < 1e-2
    assert ((dk > 0) != (dp > 0)).float().mean() < 0.01
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = phys(q, v, tau)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(out, (qk, vk, dk)))


def test_tree_builds_match_the_twin():
    """Eleven free balls through the huge physics build, seven through the
    large one, a chain of 26 hinges on the floor through the large one
    (supports past PATH_CAP: path_solve_mem), a pair row over three mask
    words through the huge one (the sweep's further windows: win_step;
    tests/torch_scenes.py, one substep as tests/test_torch_tree_paths.py),
    and the two-Humanoid scene (chip_smoke.py's humanoids_task) through both
    large builds from a reset state, every third env forced to reset:
    against the host twin of the same class (the core built with g++, the
    lanes and butterflies emulated in the card's order) on every env. The
    two differ by FMA contraction and the last bits of
    sinf/cosf only: |dq| mean 1e-5, max 2e-3, each env's largest |dv|
    within 2e-3 of its largest |v| (as test_sweep_matches_the_twin). The
    task build against the task's host twin (HostTaskTwin,
    chip_smoke.task_vs_twin): the same bounds, epoch and step_count bit
    for bit, the forced resets (frame_skip 0) bit for bit. The chain and
    the pair row also against the plain step at the walker budget; the
    chain against the twin at the walker budget too (mean 3e-4, max 1e-2),
    as tests/test_torch_tree_paths.py holds its twin against the plain
    step: its 26 coupled contacts amplify the roundings (on a CPU the twin
    and the plain step differ by mean |dq| 1.5e-4, max 1.9e-3)."""
    _need_gpu()
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the host twin")
    import os
    import sys

    from pybulletgym_tpu_torch.envs.base import reset_fn
    from pybulletgym_tpu_torch.models.mjcf import parse_mjcf
    from pybulletgym_tpu_torch.ops import contacts as ct
    from pybulletgym_tpu_torch.ops import task_kernel as tk
    from pybulletgym_tpu_torch.ops.step import PhysicsConfig
    from torch_scenes import WIDE_PAIRS, chain_xml, wide_xml

    def near(phys, q, v, tau, walker=False):
        qk, vk, dk = (x.cpu() for x in phys(q, v, tau))
        qh, vh, dh = ce.HostTwin().physics_step(phys.tables, *(x.cpu().contiguous()
                                                               for x in (q, v, tau)))
        dq = (qk - qh).abs()
        rel = ((vk - vh).abs().amax(0) / (vh.abs().amax(0) + 1e-6)).max()
        if walker:
            return bool(dq.mean() < 3e-4 and dq.max() < 1e-2), (dq.mean(), dq.max(), rel)
        return bool(dq.mean() < 1e-5 and dq.max() < 2e-3 and rel < 2e-3), (dq.mean(), dq.max(), rel)

    balls = lambda k: "".join(  # noqa: E731
        f'<body name="b{i}" pos="{0.3 * i} 0 0.09"><joint name="j{i}" type="free"/>'
        f'<geom name="g{i}" type="sphere" size="0.1"/></body>' for i in range(k))
    scenes = {k: (f'<mujoco model="balls"><worldbody><geom name="floor" type="plane" '
                  f'size="10 10 0.1"/>{balls(k)}</worldbody></mujoco>', PhysicsConfig(), size)
              for k, size in ((11, ce.HUGE), (7, ce.LARGE))}
    scenes["chain"] = (chain_xml(), PhysicsConfig(frame_skip=1), ce.LARGE)
    scenes["wide"] = (wide_xml(), PhysicsConfig(frame_skip=1, solver=ct.SolverConfig(
        self_collision_pairs=WIDE_PAIRS)), ce.HUGE)
    for name, (xml, cfg, size) in scenes.items():
        model = parse_mjcf(xml, str(name))
        phys = ce.make_cuda_physics_step(model, cfg)[0]
        assert phys.size == size, name
        g = torch.Generator(device="cuda").manual_seed(4)
        q = torch.as_tensor(model.qpos0, dtype=torch.float32, device="cuda")[:, None].repeat(1, B)
        v = torch.rand((model.nv, B), device="cuda", generator=g) - 0.5
        tau = torch.rand((model.nv, B), device="cuda", generator=g) * 2 - 1
        ok, stats = near(phys, q, v, tau, walker=name == "chain")
        assert ok, (name, stats)
        if name in ("chain", "wide"):
            t = phys.tables
            wide = [j for j in range(t.nr + t.nl) if t.path_w1[j] > t.path_w0[j] + 1]
            assert (max(t.path_n[j] for j in range(t.nr + t.nl)) > 24) == (name == "chain")
            assert (wide != []) == (name == "wide")
            qk, _, dk = phys(q, v, tau)
            qp, _, dp = phys.plain(q, v, tau)
            dq = (qk - qp).abs()
            assert (dk > 0).any() and dq.mean() < 3e-4 and dq.max() < 1e-2, (name, dq.max())

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs

    task = cs.humanoids_task(cs.humanoids_xml(2), 2)
    dev = torch.device("cuda")
    s = reset_fn(task, torch.full((B,), 3, dtype=torch.uint32, device=dev),
                 torch.arange(B, dtype=torch.int32, device=dev),
                 torch.zeros(B, dtype=torch.uint32, device=dev))
    forced = torch.zeros(B, dtype=torch.bool, device=dev)
    forced[::3] = True
    s = s._replace(terminated=forced)
    g = torch.Generator(device="cuda").manual_seed(5)
    a = torch.rand((task.act_dim, B), device=dev, generator=g) * 2 - 1
    tau = torch.zeros((task.model.nv, B), device=dev)
    tau[task.act_dofs] = torch.tensor(task.gears, device=dev)[:, None] * a
    phys = ce.make_cuda_physics_step(task.model, task.physics)[0]
    fused = tk.CudaTaskStep(task)
    fused.prepare(dev, B)
    assert phys.size == fused.size == ce.LARGE
    ok, stats = near(phys, s.q, s.v, tau)
    assert ok, stats
    rec = cs.task_vs_twin(fused, s, a, B, mean_dq=1e-5)
    assert rec["reset_envs"] == B // 3, rec


def test_sized_tables_physics_kernel_matches_plain():
    """22 free balls (nv 132, over the huge class's 128 dofs: five mask
    words) through physics_step_kernel's sized build (caps from the model,
    the tables and the whole scratch in global memory), at the walker
    budget, counted apart; a CUDA graph of the launch replays on the scratch
    buffer that prepare allocated, bitwise."""
    _need_gpu()
    from pybulletgym_tpu_torch.models.mjcf import parse_mjcf
    from pybulletgym_tpu_torch.ops.step import PhysicsConfig

    balls = "".join(
        f'<body name="b{i}" pos="{0.3 * i} 0 0.09"><joint name="j{i}" type="free"/>'
        f'<geom name="g{i}" type="sphere" size="0.1"/></body>' for i in range(22))
    model = parse_mjcf('<mujoco model="balls"><worldbody><geom name="floor" type="plane" '
                       f'size="10 10 0.1"/>{balls}</worldbody></mujoco>', "balls")
    phys = ce.make_cuda_physics_step(model, PhysicsConfig())[0]
    assert phys.size == ce.SIZED and phys.kernel == "physics_step_kernel_sized"
    assert phys.caps == (32, 160, 160, 32, 32, 32, 160, 32, 160)
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.as_tensor(model.qpos0, dtype=torch.float32, device="cuda")[:, None].repeat(1, B)
    v = torch.rand((model.nv, B), device="cuda", generator=g) - 0.5
    tau = torch.rand((model.nv, B), device="cuda", generator=g) * 2 - 1
    phys.prepare(torch.device("cuda"), B)
    assert phys.buffers[(0, B)].shape == (B, phys.tables.sc_stride)
    assert ce.launch_config(phys.tables, "physics_step_kernel", B)["shared_bytes"] == 0
    ce.reset_launch_counts()
    qk, vk, dk = phys(q, v, tau)
    torch.cuda.synchronize()
    assert ce.LAUNCHES["physics_step_kernel_sized"] == phys.launches == 1
    assert sum(ce.LAUNCHES.values()) == 1
    qp, vp, dp = phys.plain(q, v, tau)
    dq = (qk - qp).abs()
    assert dq.mean() < 3e-4 and dq.max() < 1e-2
    assert ((dk > 0) != (dp > 0)).float().mean() < 0.01
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = phys(q, v, tau)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(out, (qk, vk, dk)))


@pytest.mark.parametrize("env_id", [ENV, HUMANOID, ATLAS])
def test_sweep_matches_the_twin(env_id):
    """The card's PGS sweep by each row's block (one butterfly of four dots
    a contact row, one a limit pair) against the host twin, which emulates
    the same butterflies in the card's order: one physics step (four
    substeps) from a landed state (30 env steps of random actions), B=300,
    the same tables. The two differ only by FMA contraction: |dq| mean 1e-5,
    max 2e-3, each env's largest |dv| within 2e-3 of its largest |v| (3-10x
    the differences an H100 showed; the walkers' budget against the plain
    version is 3e-4 / 1e-2)."""
    _need_gpu()
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the host twin")
    task = make_task(env_id)
    env = make_batched(env_id, B, device="cuda")
    s = env.reset(seed=4)
    g = torch.Generator(device="cuda").manual_seed(4)
    for _ in range(30):
        s = env.step_fn(s, torch.rand((task.act_dim, B), device="cuda", generator=g) * 2 - 1)
    phys = ce.make_cuda_physics_step(task.model, task.physics)[0]
    assert ce.sweep_group_sums(phys.tables) == (phys.tables.nr + phys.tables.nl
                                                - sum(ce.limit_pairs(phys.tables)))
    tau = torch.zeros((task.model.nv, B), device="cuda")
    act = torch.as_tensor(task.act_dofs, dtype=torch.int64, device="cuda")
    tau[act] = torch.as_tensor(task.gains, device="cuda") * (
        torch.rand((task.act_dim, B), device="cuda", generator=g) * 2 - 1)
    qk, vk, _ = (x.cpu() for x in phys(s.q, s.v, tau))
    qh, vh, _ = ce.HostTwin().physics_step(phys.tables, s.q.cpu().contiguous(),
                                           s.v.cpu().contiguous(), tau.cpu().contiguous())
    dq = (qk - qh).abs()
    assert dq.mean() < 1e-5 and dq.max() < 2e-3, (dq.mean(), dq.max())
    rel = (vk - vh).abs().amax(0) / (vh.abs().amax(0) + 1e-6)
    assert rel.max() < 2e-3, rel.max()
