"""User tasks in the port: any `Task` runs through the fused step (its hooks
translated into `task_step_kernel`, `ops.task_kernel`) and the composed
step (`envs.base.make_env`, `ComposedEnvStep`, `BatchedEnv(backend=...)`),
and a user's ID through `api.registry.register`. Held against the JAX
package, at B=8, on two user tasks written once for each package:

(i) `BackwardCheetah`, a `WalkerTask(HALF_CHEETAH)` subclass: its reward
    pays for running backwards (the progress component negated), it keeps
    an aux key that the env kernel does not know (a running count of steps
    with a negative root x-velocity), and its pre-physics hook adds a
    constant to the back thigh's velocity;
(ii) `ArmTask`, a new `Task` over a two-link arm parsed from MJCF text in
    this file, whose capsules and tip sphere make point rows against the
    floor; its reset draws from `ops.rand`.

Checks: the reset bitwise to JAX `make_env(task)[0]`; 10 steps through a
forced auto-reset against the eager JAX composition of the TPU kernel body
(mean |dq| < 1e-5; epoch, step count, truncation and the reset q exact),
and the arm's against JAX's `make_env` step (its XLA path, jitted) within
`bounds_env`; the task kernel's C++ (its translated hooks built with g++,
`HostTaskTwin`) against the plain step within `bounds_env`, its reset
bitwise; the translation's refusals; the stacked-array adapters equal
JAX's; the backend dispatch; `register` through every entry point; one PPO
train step and one SAC iteration with the default step; and the
reach-pruning and row functions of `ops.contacts` equal JAX's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybulletgym_tpu as pg
from pybulletgym_tpu.envs import base as base_j
from pybulletgym_tpu.envs import locomotion as loco_j
from pybulletgym_tpu.models import mjcf as mjcf_j
from pybulletgym_tpu.ops import contacts as ct_j
from pybulletgym_tpu.ops import rand as rand_j
from pybulletgym_tpu.ops import step as step_j
import pybulletgym_tpu_torch as pt
from pybulletgym_tpu_torch.api import registry as reg
from pybulletgym_tpu_torch.envs import base as base_t
from pybulletgym_tpu_torch.envs import locomotion as loco_t
from pybulletgym_tpu_torch.models import mjcf as mjcf_t
from pybulletgym_tpu_torch.models import schema as schema_t
from pybulletgym_tpu_torch.ops import contacts as ct_t
from pybulletgym_tpu_torch.ops import cuda_engine as ce
from pybulletgym_tpu_torch.ops import rand as rand_t
from pybulletgym_tpu_torch.ops import step as step_t
from pybulletgym_tpu_torch.ops import task_kernel as tk
from pybulletgym_tpu_torch.parallel import ppo, sac
from pybulletgym_tpu_torch.utils.interop import env_state_from_numpy, env_state_to_numpy
from test_reach_prune import _toy_model
from test_torch_cuda import bounds_env
from test_torch_engine import _jax_kernel_body

B = 8
STEPS = 10
FORCED_AT = 5  # the step before which every third env is forced to reset

ARM_XML = """<mujoco model="arm2">
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="upper" pos="0 0 0.5">
      <joint name="shoulder" type="hinge" axis="0 1 0" range="-100 100" limited="true"
             damping="0.1"/>
      <geom name="upper_g" type="capsule" fromto="0 0 0 0.3 0 0" size="0.04"/>
      <body name="lower" pos="0.3 0 0">
        <joint name="elbow" type="hinge" axis="0 1 0" range="-120 120" limited="true"
               damping="0.1"/>
        <geom name="lower_g" type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"/>
        <geom name="tip" type="sphere" pos="0.3 0 0" size="0.05"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor joint="shoulder" gear="20"/>
    <motor joint="elbow" gear="10"/>
  </actuator>
</mujoco>"""


def backward_cheetah(loco, xp):
    """BackwardCheetah for the package of `loco` (its locomotion module),
    with `xp` its array namespace (jax.numpy or torch)."""

    class BackwardCheetah(loco.WalkerTask):
        PUSH = 0.5  # added to the back thigh's velocity before the physics

        def __init__(self):
            super().__init__(loco.HALF_CHEETAH)
            self.push_dof = self.model.dof_index("bthigh")

        def initial_state_scalar(self, seed, env_id, epoch):
            q, v, aux = super().initial_state_scalar(seed, env_id, epoch)
            return q, v, dict(aux, backward_steps=xp.zeros_like(aux["potential"]))

        def pre_physics_scalar(self, q, v, aux, ids=None):
            v = list(v)
            v[self.push_dof] = v[self.push_dof] + self.PUSH
            return q, v, aux

        def output_scalar(self, q, v, depths, a, aux, ids=None):
            obs, reward, term, aux2, comps = super().output_scalar(q, v, depths, a, aux, ids)
            progress = comps["progress"]
            back = aux["backward_steps"] + xp.where(v[0] < 0.0, 1.0, 0.0)
            return (obs, reward - 2.0 * progress, term, dict(aux2, backward_steps=back),
                    dict(comps, progress=-progress))

    return BackwardCheetah


def arm_task(pkg, xp):
    """ArmTask for the package `pkg` (a namespace of its Task, load_mjcf,
    rand, PhysicsConfig and SolverConfig), with `xp` its array namespace."""

    class ArmTask(pkg.Task):
        GEARS = (20.0, 10.0)

        def __init__(self, xml_path):
            self.model = pkg.load_mjcf(xml_path)
            self.physics = pkg.PhysicsConfig(timestep=0.01, frame_skip=2,
                                             solver=pkg.SolverConfig())
            self.dofs = [self.model.dof_index(n) for n in ("shoulder", "elbow")]
            self.obs_dim, self.act_dim, self.max_episode_steps = 7, 2, 1000

        def initial_state_scalar(self, seed, env_id, epoch):
            q = [pkg.rand.uniform(seed, 0, env_id, epoch, 0.6, 1.2),
                 pkg.rand.uniform(seed, 1, env_id, epoch, -0.3, 0.3)]
            v = [pkg.rand.uniform(seed, 2 + i, env_id, epoch, -0.1, 0.1) for i in range(2)]
            return q, v, {"touches": xp.zeros_like(q[0])}

        def action_tau_scalar(self, a):
            tau = [0.0] * self.model.nv
            for d, g, ai in zip(self.dofs, self.GEARS, a):
                tau[d] = g * ai
            return tau

        def output_scalar(self, q, v, depths, a, aux, ids=None):
            tip_z = 0.5 - 0.3 * xp.sin(q[0]) - 0.3 * xp.sin(q[0] + q[1])
            touch = depths[0] > 0.0
            for d in depths[1:]:
                touch = touch | (d > 0.0)
            flag = xp.where(touch, 1.0, 0.0)
            obs = [xp.cos(q[0]), xp.sin(q[0]), xp.cos(q[1]), xp.sin(q[1]), 0.1 * v[0],
                   0.1 * v[1], flag]
            ctrl = -0.1 * (a[0] * a[0] + a[1] * a[1])
            reach = -xp.abs(tip_z - 0.2)
            return (obs, ctrl + reach, tip_z < -0.02, {"touches": aux["touches"] + flag},
                    {"ctrl": ctrl, "reach": reach})

    return ArmTask


_PKG_J = type("pkg", (), dict(
    Task=base_j.Task, load_mjcf=staticmethod(mjcf_j.load_mjcf), rand=rand_j,
    PhysicsConfig=step_j.PhysicsConfig, SolverConfig=ct_j.SolverConfig))
_PKG_T = type("pkg", (), dict(
    Task=base_t.Task, load_mjcf=staticmethod(mjcf_t.load_mjcf), rand=rand_t,
    PhysicsConfig=step_t.PhysicsConfig, SolverConfig=ct_t.SolverConfig))
BackwardCheetahJ, BackwardCheetahT = backward_cheetah(loco_j, jnp), backward_cheetah(loco_t, torch)
ArmTaskJ, ArmTaskT = arm_task(_PKG_J, jnp), arm_task(_PKG_T, torch)


@pytest.fixture(scope="module")
def arm_xml(tmp_path_factory):
    path = tmp_path_factory.mktemp("arm") / "arm2.xml"
    path.write_text(ARM_XML)
    return str(path)


def _make(name, arm_xml):
    """(JAX task, port task) of one user task."""
    if name == "backward_cheetah":
        return BackwardCheetahJ(), BackwardCheetahT()
    return ArmTaskJ(arm_xml), ArmTaskT(arm_xml)


@pytest.fixture(scope="module", params=["backward_cheetah", "arm"])
def tasks(request, arm_xml):
    return _make(request.param, arm_xml)


def _ids(n=B, seed=3):
    return (np.full(n, seed, np.uint32), np.arange(n, dtype=np.int32), np.zeros(n, np.uint32))


_RESETS = {}


def _jax_reset(tj):
    """JAX make_env's reset of `tj` as numpy (computed once a task: its
    eager FK takes seconds)."""
    if id(tj) not in _RESETS:
        _RESETS[id(tj)] = (tj, env_state_to_numpy(
            base_j.make_env(tj)[0](*(jnp.asarray(x) for x in _ids()))))
    return dict(_RESETS[id(tj)][1])


def _actions(tt):
    return np.random.default_rng(17).uniform(-1.3, 1.3, (STEPS, tt.act_dim, B)).astype(np.float32)


def _forced():
    f = np.zeros(B, bool)
    f[::3] = True
    return f


def _n_flags(tt):
    return 1 if isinstance(tt, ArmTaskT) else len(tt.foot_rows)


def test_reset_bitwise_to_jax(tasks):
    """The reset draws bitwise (q, v and the counters); obs and aux, which
    go through each library's sin and cos, to 1e-6 as
    test_torch_engine.py · test_reset_matches_jax holds them."""
    tj, tt = tasks
    sj = _jax_reset(tj)
    reset, _ = base_t.make_env(tt)
    st = env_state_to_numpy(reset(*(torch.from_numpy(x) for x in _ids())))
    for k in ("q", "v", "step_count", "epoch", "env_id", "seed"):
        np.testing.assert_array_equal(sj[k], st[k], err_msg=k)
    np.testing.assert_allclose(sj["obs"], st["obs"], atol=1e-6)
    assert sorted(sj["aux"]) == sorted(st["aux"]) and sorted(sj["rewards"]) == sorted(st["rewards"])
    for k in sj["aux"]:
        np.testing.assert_allclose(sj["aux"][k], st["aux"][k], rtol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def port_rollout(tasks):
    """The port's 10 composed steps (make_env's step: eager, the plain
    physics on the CPU) from the JAX reset, every third env forced to reset
    before step 5; and the reset q of that step (no physics)."""
    tj, tt = tasks
    step = base_t.make_env(tt)[1]
    st = env_state_from_numpy(_jax_reset(tj), device="cpu")
    acts, forced = _actions(tt), torch.from_numpy(_forced())
    states, reset_q = [], None
    for t in range(STEPS):
        a = torch.from_numpy(acts[t])
        if t == FORCED_AT:
            st = st._replace(terminated=st.terminated | forced)
            reset_q = base_t.env_step_plain(tt, st, a, frame_skip=0).q
        st = step(st, a)
        states.append(st)
    return states, reset_q


def test_steps_against_the_jax_kernel_body(tasks, port_rollout):
    """The port's steps against the eager JAX composition of the TPU kernel
    body, each rolled from its own state: mean |dq| < 1e-5 every step;
    epoch, step count, truncation, termination and the forced envs' reset
    q exact."""
    tj, tt = tasks
    states, reset_q = port_rollout
    sj = _jax_reset(tj)
    acts, forced = _actions(tt), _forced()
    for t, st in enumerate(states):
        if t == FORCED_AT:
            sj = dict(sj, terminated=sj["terminated"] | forced)
            r0 = _jax_kernel_body(tj, sj, acts[t], frame_skip=0)
            np.testing.assert_array_equal(r0["q"][:, forced], reset_q.numpy()[:, forced])
        rj = _jax_kernel_body(tj, sj, acts[t], frame_skip=tj.physics.frame_skip)
        dq = np.abs(rj["q"] - st.q.numpy())
        assert dq.mean() < 1e-5, (t, dq.mean())
        for k in ("epoch", "step_count", "truncated", "terminated"):
            np.testing.assert_array_equal(rj[k], getattr(st, k).numpy(), err_msg=f"{k} step {t}")
        np.testing.assert_allclose(rj["obs"], st.obs.numpy(), atol=1e-4)
        np.testing.assert_allclose(rj["reward"], st.reward.numpy(), atol=1e-3)
        assert sorted(rj["aux"]) == sorted(st.aux)
        for k in rj["aux"]:
            np.testing.assert_allclose(rj["aux"][k], st.aux[k].numpy(), rtol=1e-5, atol=1e-3)
        sj = dict(sj, **{k: rj[k] for k in ("q", "v", "terminated", "truncated", "step_count",
                                            "epoch", "aux")})
    assert states[-1].epoch.numpy()[forced].tolist() == [1] * int(forced.sum())
    if isinstance(tt, ArmTaskT):  # the point rows were live
        assert sum(float(s.obs[-1].sum()) for s in states) > 0


def test_arm_against_jax_make_env(arm_xml):
    """The arm's steps against JAX's make_env step (its XLA path, jitted),
    within test_pallas_equivalence.py's bounds. (On the CPU, BackwardCheetah's
    XLA step takes 42 s eager and 32 s to compile, over this file's time; it
    is held to the kernel body above.)"""
    import jax

    tj, tt = _make("arm", arm_xml)
    sj0 = _jax_reset(tj)
    jstep = jax.jit(base_j.make_env(tj)[1])
    tstep = base_t.make_env(tt)[1]
    sj = base_j.EnvState(**{k: (jnp.asarray(x) if not isinstance(x, dict) else
                                {n: jnp.asarray(y) for n, y in x.items()})
                            for k, x in sj0.items()})
    st = env_state_from_numpy(sj0, device="cpu")
    acts, forced = _actions(tt), _forced()
    for t in range(STEPS):
        if t == FORCED_AT:
            sj = sj._replace(terminated=sj.terminated | jnp.asarray(forced))
            st = st._replace(terminated=st.terminated | torch.from_numpy(forced))
        sj = jstep(sj, jnp.asarray(acts[t]))
        st = tstep(st, torch.from_numpy(acts[t]))
        bounds_env(st, env_state_from_numpy(env_state_to_numpy(sj), device="cpu"), 1)


def test_stacked_adapters_equal_jax(tasks):
    tj, tt = tasks
    ids_np = _ids()
    ids_j = tuple(jnp.asarray(x) for x in ids_np)
    ids_t = tuple(torch.from_numpy(x) for x in ids_np)
    qj, vj, auxj = tj.initial_state(*ids_j)
    qt, vt, auxt = tt.initial_state(*ids_t)
    np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    a = np.random.default_rng(2).uniform(-1, 1, (tt.act_dim, B)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(tj.action_tau(jnp.asarray(a))),
                                  tt.action_tau(torch.from_numpy(a)).numpy())
    pj = tj.pre_physics(qj, vj, auxj, ids_j)
    pt_ = tt.pre_physics(qt, vt, auxt, ids_t)
    for x, y in zip(pj[:2], pt_[:2]):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    depths = np.random.default_rng(3).uniform(
        -0.01, 0.01, (base_t._n_rows(tt), B)).astype(np.float32)
    oj = tj.output(qj, vj, jnp.asarray(depths), jnp.asarray(a), auxj, ids_j)
    ot = tt.output(qt, vt, torch.from_numpy(depths), torch.from_numpy(a), auxt, ids_t)
    np.testing.assert_allclose(np.asarray(oj[0]), ot[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(oj[1]), ot[1].numpy(), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(oj[2]), ot[2].numpy())
    for k in oj[3]:
        np.testing.assert_allclose(np.asarray(oj[3][k]), ot[3][k].numpy(), rtol=1e-6, atol=1e-5)
    assert sorted(oj[4]) == sorted(ot[4])


def test_task_kernel_host_twin(tasks):
    """The task kernel's own C++ (task_core.h and the task's translated
    hooks, g++ -ffp-contract=off) against the plain step: 10 steps, each
    rolled from its own state, every third env forced to reset before step
    5, within bounds_env; the forced envs' reset bitwise."""
    tj, tt = tasks
    twin = tk.HostTaskTwin(tt)
    reset = tk.HostTaskTwin(tt, frame_skip=0)
    sh = sp = env_state_from_numpy(_jax_reset(tj), device="cpu")
    acts, forced = _actions(tt), torch.from_numpy(_forced())
    for t in range(STEPS):
        a = torch.from_numpy(acts[t])
        if t == FORCED_AT:
            sh = sh._replace(terminated=sh.terminated | forced)
            sp = sp._replace(terminated=sp.terminated | forced)
            assert torch.equal(reset(sh, a).q[:, forced],
                               base_t.env_step_plain(tt, sh, a, frame_skip=0).q[:, forced])
        sh, sp = twin(sh, a), base_t.env_step_plain(tt, sp, a)
        bounds_env(sh, sp, _n_flags(tt))
        assert sorted(sh.aux) == sorted(sp.aux) and sorted(sh.rewards) == sorted(sp.rewards)
    assert sh.epoch[forced].tolist() == [1] * int(forced.sum())


@pytest.mark.parametrize("env_id", sorted(reg.registry))
def test_every_shipped_task_translates(env_id):
    """Each of the 26 shipped tasks' hooks translates (chip_smoke.py builds
    five of them and holds them to env_step_kernel), with the env kernel's
    aux and reward keys."""
    task = pt.make_task(env_id)
    prog = tk.trace_hooks(task)
    _, aux_keys, comp_keys = ce.TASK_KINDS[type(task).__name__]
    assert prog.aux_keys == tuple(sorted(aux_keys)) and prog.comp_keys == tuple(sorted(comp_keys))
    assert prog.ops["output"] > 0 and prog.flops["initial_state"] <= prog.ops["initial_state"]
    assert "namespace hooks" in prog.source and f"NOBS = {task.obs_dim};" in prog.source


class _Branchy(base_t.Task):
    """A task whose output the kernel cannot take: `how` is "cumsum" (an op
    that couples the envs and has no translation) or "mean" (a reduction
    over the batch)."""

    def __init__(self, task, how):
        self.__dict__.update(task.__dict__)
        self.inner, self.how = task, how

    def initial_state_scalar(self, *ids):
        return self.inner.initial_state_scalar(*ids)

    def action_tau_scalar(self, a):
        return self.inner.action_tau_scalar(a)

    def output_scalar(self, q, v, depths, a, aux, ids=None):
        obs, reward, term, aux2, comps = self.inner.output_scalar(q, v, depths, a, aux, ids)
        if self.how == "cumsum":
            reward = reward + torch.cumsum(q[0], 0)
        else:
            reward = reward - q[0].mean()
        return obs, reward, term, aux2, comps


@pytest.mark.parametrize("how, match", [("cumsum", "cumsum.* no CUDA translation"),
                                        ("mean", "elementwise")])
def test_translation_refuses_what_the_kernel_cannot_run(arm_xml, how, match):
    task = _Branchy(ArmTaskT(arm_xml), how)
    with pytest.raises(NotImplementedError, match=f"_Branchy.output_scalar.*{match}"):
        base_t.BatchedEnv(task, 4, device="cpu")
    # the composed backend runs the same task in torch
    env = base_t.BatchedEnv(task, 4, device="cpu", backend="composed")
    assert env.backend == "composed"


def test_backend_dispatch(tasks):
    _, tt = tasks
    env = base_t.BatchedEnv(tt, 4, device="cpu")
    assert env.backend == "fused" and not ce.env_kernel_supports(tt)
    assert isinstance(env.step_fn, tk.CudaTaskStep) and env.step_fn.kernel == "task_step_kernel"
    assert env.step_fn.program.aux_keys == tuple(sorted(env.reset().aux))
    # a built-in ID keeps the env-step kernel
    builtin = pt.make_batched("HalfCheetahPyBulletEnv-v0", 4, device="cpu")
    assert builtin.backend == "fused" and builtin.step_fn.kernel == "env_step_kernel"
    assert base_t.BatchedEnv(loco_t.WalkerTask(loco_t.HALF_CHEETAH), 4, device="cpu",
                             backend="composed").backend == "composed"
    with pytest.raises(ValueError, match="unknown backend"):
        base_t.BatchedEnv(tt, 4, device="cpu", backend="xla")


@pytest.fixture
def restore_registry():
    saved = dict(reg.registry)
    yield
    reg.registry.clear()
    reg.registry.update(saved)
    try:
        import gymnasium
    except ImportError:
        return
    for k in [k for k in gymnasium.registry if k.startswith(f"{reg.NAMESPACE}/") and
              k.split("/", 1)[1] not in saved]:
        del gymnasium.registry[k]


def test_register_reaches_every_entry_point(arm_xml, restore_registry):
    """A registered ID through make_task, make_batched, make, make_vec and
    gymnasium; its horizon of 50 truncates at step 50; registering it again
    replaces it."""
    pt.register("Arm2-v0", lambda: ArmTaskT(arm_xml), 50, reward_threshold=1.0)
    task = pt.make_task("Arm2-v0")
    assert isinstance(task, ArmTaskT) and task.max_episode_steps == 50
    env = pt.make_batched("Arm2-v0", 2, device="cpu")
    assert env.backend == "fused" and env.step_fn.kernel == "task_step_kernel"
    s = env.reset(seed=1)
    s = s._replace(q=torch.zeros_like(s.q))  # the arm held level: no termination
    zero = np.zeros((2, 2), np.float32)
    for t in range(50):
        assert not bool(s.truncated.any()), t
        s = env.step(s, zero)
    assert s.truncated.all() and (s.step_count == 50).all() and not s.terminated.any()
    adapter = pt.make("Arm2-v0", device="cpu", backend="composed", graph=False)
    obs, _ = adapter.reset(seed=0)
    assert obs.shape == (7,) and adapter._env.backend == "composed"
    vec = pt.make_vec("Arm2-v0", 3, device="cpu")
    obs, _ = vec.reset(seed=0)
    assert obs.shape == (3, 7) and vec.step(np.zeros((3, 2), np.float32))[0].shape == (3, 7)
    pt.register_with_gymnasium()
    try:
        import gymnasium
    except ImportError:
        gymnasium = None
    if gymnasium is not None:
        assert "Arm2-v0" not in gymnasium.registry  # never a bare ID
        g = gymnasium.make(f"{reg.NAMESPACE}/Arm2-v0", device="cpu")
        assert g.reset(seed=0)[0].shape == (7,)
    reg.register("Arm2-v0", lambda: ArmTaskT(arm_xml), 7)
    assert pt.make_task("Arm2-v0").max_episode_steps == 7


def test_learners_take_a_user_task_by_default():
    """One PPO train step and one SAC iteration on BackwardCheetah with
    step_fn=None: the default step is the fused one (the task kernel's
    wrapper, whose plain version steps CPU tensors), and the metrics are
    finite."""
    tt = BackwardCheetahT()
    env = base_t.BatchedEnv(tt, B, device="cpu")
    cfg = ppo.PPOConfig(rollout_length=2, num_epochs=1, num_minibatches=2, hidden=(16, 16))
    ts = ppo.init_train_state(0, tt.obs_dim, tt.act_dim, cfg, device="cpu")
    ts, es, m = ppo.make_train_step(tt, cfg)(ts, env.reset(seed=0))
    assert all(np.isfinite(float(x)) for x in m.values()) and (es.step_count == 2).all()
    assert sorted(es.aux) == sorted(env.reset().aux) and "backward_steps" in es.aux
    scfg = sac.SACConfig(steps_per_iter=2, updates_per_iter=2, batch_size=8, warmup_steps=0,
                         hidden=(16, 16))
    ss = sac.init_sac_state(0, tt.obs_dim, tt.act_dim, B, scfg, device="cpu")
    ss, es, m = sac.make_sac_iteration(tt, scfg)(ss, env.reset(seed=0))
    assert all(np.isfinite(float(x)) for x in m.values()) and (es.step_count == 2).all()


def _port_model(mj):
    """The JAX package's Model `mj` as the port's, field for field."""
    def conv(cls, x):
        return cls(**{f.name: getattr(x, f.name) for f in dataclasses.fields(x)})

    fields = {f.name: getattr(mj, f.name) for f in dataclasses.fields(mj)}
    fields["bodies"] = tuple(conv(schema_t.Body, b) for b in mj.bodies)
    fields["geoms"] = tuple(conv(schema_t.Geom, g) for g in mj.geoms)
    fields["actuators"] = tuple(conv(schema_t.Actuator, a) for a in mj.actuators)
    return schema_t.Model(**fields)


def _same_balls(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert len(a) == len(b)
        for (ca, ra), (cb, rb) in zip(a, b):
            np.testing.assert_allclose(ca, cb, atol=1e-12)
            assert abs(ra - rb) < 1e-12


@pytest.mark.parametrize("limit_deg", [10.0, 45.0, 170.0])
def test_reach_pruning_equals_jax_on_the_toy_chain(limit_deg):
    mj = _toy_model(limit_deg)
    mt = _port_model(mj)
    pairs = (("tip1", "tip2"),)
    assert ct_t.prune_pairs_by_reach(mt, pairs) == ct_j.prune_pairs_by_reach(mj, pairs)
    for g in range(2):
        _same_balls(ct_t.reach_bound_balls(mt, mt.geoms[g], 0),
                    ct_j.reach_bound_balls(mj, mj.geoms[g], 0))
    assert ct_t._lca(mt, 1, 2) == ct_j._lca(mj, 1, 2) == 0


def test_reach_pruning_and_row_bodies_equal_jax():
    """The humanoid's 66 pairs (kept and pruned, and every geom's balls in
    each pair's LCA frame), and plan_row_bodies on HalfCheetah and
    Humanoid."""
    for env_id in ("HalfCheetahPyBulletEnv-v0", "HumanoidPyBulletEnv-v0"):
        tj, tt = pg.make_task(env_id), pt.make_task(env_id)
        assert (ct_t.plan_row_bodies(ct_t.build_contact_plan(tt.model, tt.physics.solver))
                == ct_j.plan_row_bodies(ct_j.build_contact_plan(tj.model, tj.physics.solver)))
    pairs = tt.physics.solver.self_collision_pairs
    assert len(pairs) == 66 and pairs == tj.physics.solver.self_collision_pairs
    kept, pruned = ct_t.prune_pairs_by_reach(tt.model, pairs)
    assert (kept, pruned) == ct_j.prune_pairs_by_reach(tj.model, pairs)
    assert pruned == () and len(kept) == 66
    for na, nb in pairs[::5]:
        ga, gb = tt.model.geoms[tt.model.geom_index(na)], tt.model.geoms[tt.model.geom_index(nb)]
        lca = ct_t._lca(tt.model, ga.body, gb.body)
        assert lca == ct_j._lca(tj.model, ga.body, gb.body)
        for g in (ga, gb):
            _same_balls(ct_t.reach_bound_balls(tt.model, g, lca),
                        ct_j.reach_bound_balls(tj.model, tj.model.geoms[tj.model.geom_index(g.name)],
                                               lca))
