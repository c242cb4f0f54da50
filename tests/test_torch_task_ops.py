"""The hook translation's ops (`ops/task_kernel.py`, `csrc/task_ops.h`) on
the CPU, on the task kernel's own C++ built with g++ (`HostTaskTwin`, one
build a task):

(a) Every op. `OpProbe` (tests/torch_user_tasks.py: InvertedPendulum's
    model, an obs entry an op) at B=40, one step from a seeded reset, its
    actions putting x on -0.0, halfway values (+-0.5, 1.5, 2.5, 3.5) and
    |x| > 20 (softplus's threshold), and x on NaN, +inf and -inf in six
    envs: the host twin's obs against the plain step's (`env_step_plain`,
    torch's CPU kernels), each entry as OP_ENTRIES says: bit for bit, or
    within its ulp count (libm functions: torch's CPU kernels run Sleef's
    vector functions or glibc's, the twin glibc's; a sign of zero counts no
    ulp), or within its tolerance relative to max(1, |value|) where torch's
    CPU kernel sums in another order or precision than the CUDA kernel the
    translation follows and the sum may cancel (OP_ENTRIES says which and
    why). One case an entry.
(b) ShapedAnt (tests/torch_user_tasks.py) registered as ShapedAnt-v0: its
    reset bitwise to the JAX twin's `make_env` reset in q, v and the
    counters, obs and aux (through each library's sin and cos) within 1e-6
    as tests/test_torch_custom_task.py holds them; by ID through
    `make_batched` the fused step is `task_step_kernel`'s wrapper; the host
    twin against the plain step for 10 steps, each rolled from its own
    state, every third env forced to reset before step 5, within
    `bounds_env` (test_torch_cuda.py), the forced envs' reset bitwise.
    tests/test_torch_shaped_ant.py holds the plain steps to the JAX twin's
    kernel body.
(c) What stays refused, one case each: a reduction and a scan over the
    batch, torch's random draws, a matrix product, a per-env index, a
    Python branch on a value, a dtype outside the kernel's, a per-env value
    past 64 elements, a write into a view and an op that moves the batch
    axis: `BatchedEnv` raises NotImplementedError naming the op, and
    backend="composed" still takes the task.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybulletgym_tpu_torch as pt
from pybulletgym_tpu.envs import base as base_j
from pybulletgym_tpu.envs import locomotion as loco_j
from pybulletgym_tpu_torch.api import registry as reg
from pybulletgym_tpu_torch.envs import base as base_t
from pybulletgym_tpu_torch.envs import locomotion as loco_t
from pybulletgym_tpu_torch.envs import pendula
from pybulletgym_tpu_torch.ops import task_kernel as tk
from pybulletgym_tpu_torch.utils.interop import env_state_to_numpy
from test_torch_cuda import bounds_env
import torch_user_tasks as ut

B_OPS = 40
B = 6
STEPS = 10
FORCED_AT = 5


class NN_JAX:
    """The JAX side of ShapedAnt's `nn`, with torch's formulas where the
    libraries differ: softplus's threshold 20 (jax.nn.softplus has none)
    and lerp's two branches."""

    @staticmethod
    def softplus(x):
        return jnp.where(x > 20.0, x, jnp.log1p(jnp.exp(x)))

    sigmoid = staticmethod(jax.nn.sigmoid)
    relu = staticmethod(jax.nn.relu)

    @staticmethod
    def lerp(a, b, w):
        return jnp.where(jnp.abs(w) < 0.5, a + w * (b - a), b - (b - a) * (1.0 - w))

    @staticmethod
    def norm0(u):
        return jnp.linalg.norm(u, axis=0)


ShapedAntJ = ut.shaped_ant(loco_j, jnp, NN_JAX)
ShapedAntT = ut.shaped_ant(loco_t, torch, ut.NN_TORCH)
OpProbe = ut.op_probe(pendula, torch)


@pytest.fixture(scope="module")
def probe():
    """(the host twin's step, the plain step, the finite-input mask) of the
    op probe."""
    task = OpProbe()
    acts = torch.from_numpy(ut.probe_actions(B_OPS, 5))
    s = base_t.BatchedEnv(task, B_OPS, device="cpu").reset(seed=1)
    twin = tk.HostTaskTwin(task)
    finite = torch.isfinite(ut.op_inputs(list(torch.clamp(acts, -1.0, 1.0)), torch)[2])
    return twin(s, acts), base_t.env_step_plain(task, s, acts), finite.numpy()


def test_probe_runs_and_reaches_the_edges(probe):
    sh, sp, finite = probe
    assert (~finite).sum() == len(ut.PROBE_SPECIAL) and not sp.terminated.any()
    assert torch.isfinite(sh.obs).all() and sh.obs.shape == (len(ut.OP_ENTRIES), B_OPS)
    for name in ("isnan", "isposinf", "isneginf"):  # the special envs reached the ops
        k = [n for n, _ in ut.OP_ENTRIES].index(name)
        assert sh.obs[k].sum() == 2, name
    for k in ("epoch", "step_count", "truncated", "terminated"):
        assert torch.equal(getattr(sh, k), getattr(sp, k)), k


@pytest.mark.parametrize("k, name, tol", [(k, n, t) for k, (n, t) in enumerate(ut.OP_ENTRIES)],
                         ids=[n for n, _ in ut.OP_ENTRIES])
def test_every_op_on_the_host_twin(probe, k, name, tol):
    """(a) one entry of the probe's obs: bit for bit or within its ulp count"""
    sh, sp, finite = probe
    h, p = sh.obs[k].numpy(), sp.obs[k].numpy()
    if name in ut.FINITE_ONLY:
        h, p = h[finite], p[finite]
    if tol == "bits":
        np.testing.assert_array_equal(h.view(np.int32), p.view(np.int32), err_msg=name)
    elif isinstance(tol, float):
        np.testing.assert_array_less(np.abs(h - p), tol * np.maximum(1.0, np.abs(p)) + 1e-30,
                                     err_msg=name)
    else:
        ulp = ut.ulps(h, p)
        assert ulp.max() <= tol, (name, ulp.max(), h[ulp.argmax()], p[ulp.argmax()])


def _ids(n=B, seed=3):
    return (np.full(n, seed, np.uint32), np.arange(n, dtype=np.int32), np.zeros(n, np.uint32))


@pytest.fixture(scope="module")
def shaped_ant_id():
    saved = dict(reg.registry)
    pt.register(ut.SHAPED_ANT_ID, ShapedAntT, ut.SHAPED_ANT_STEPS)
    yield ut.SHAPED_ANT_ID
    reg.registry.clear()
    reg.registry.update(saved)


def test_shaped_ant_reset_matches_jax(shaped_ant_id):
    """(b) the reset: draws bitwise, obs and aux to 1e-6"""
    sj = env_state_to_numpy(base_j.make_env(ShapedAntJ())[0](*(jnp.asarray(x) for x in _ids())))
    env = pt.make_batched(shaped_ant_id, B, device="cpu")
    st = env_state_to_numpy(base_t.reset_fn(env.task, *(torch.from_numpy(x) for x in _ids())))
    for k in ("q", "v", "step_count", "epoch", "env_id", "seed"):
        np.testing.assert_array_equal(sj[k], st[k], err_msg=k)
    np.testing.assert_allclose(sj["obs"], st["obs"], atol=1e-6)
    assert sorted(sj["aux"]) == sorted(st["aux"]) and "speed_avg" in st["aux"]
    assert sorted(sj["rewards"]) == sorted(st["rewards"]) and "shaped" in st["rewards"]
    for k in sj["aux"]:
        np.testing.assert_allclose(sj["aux"][k], st["aux"][k], rtol=1e-6, err_msg=k)


def test_shaped_ant_host_twin_matches_plain(shaped_ant_id):
    """(b) by ID the fused step is the task kernel's; its C++ against the
    plain step: 10 steps within bounds_env, the forced resets bitwise"""
    env = pt.make_batched(shaped_ant_id, B, device="cpu")
    task = env.task
    assert env.backend == "fused" and env.step_fn.kernel == "task_step_kernel"
    twin, reset = tk.HostTaskTwin(task), tk.HostTaskTwin(task, frame_skip=0)
    acts = np.random.default_rng(17).uniform(-1.3, 1.3, (STEPS, task.act_dim, B))
    forced = torch.zeros(B, dtype=torch.bool)
    forced[::3] = True
    sh = sp = env.reset(seed=3)
    for t in range(STEPS):
        a = torch.from_numpy(acts[t].astype(np.float32))
        if t == FORCED_AT:
            sh = sh._replace(terminated=sh.terminated | forced)
            sp = sp._replace(terminated=sp.terminated | forced)
            rh, rp = reset(sh, a), base_t.env_step_plain(task, sh, a, frame_skip=0)
            assert torch.equal(rh.q[:, forced], rp.q[:, forced])
            assert torch.equal(rh.v[:, forced], rp.v[:, forced])
        sh, sp = twin(sh, a), base_t.env_step_plain(task, sp, a)
        bounds_env(sh, sp, len(task.foot_rows))
        assert sorted(sh.aux) == sorted(sp.aux) and sorted(sh.rewards) == sorted(sp.rewards)
        np.testing.assert_allclose(sh.aux["speed_avg"], sp.aux["speed_avg"], atol=1e-3)
    assert sh.epoch[forced].tolist() == [1] * int(forced.sum())
    assert (sh.rewards["shaped"] != 0).any()


def _refusing(how):
    """InvertedPendulum whose reward goes through one op the kernel cannot
    take (`how`)."""

    class Refused(pendula.InvertedPendulumTask):
        def output_scalar(self, q, v, depths, a, aux, ids=None):
            obs, reward, term, aux2, comps = super().output_scalar(q, v, depths, a, aux, ids)
            x = q[0]
            if how == "batch_sum":
                extra = x.sum()
            elif how == "batch_scan":
                extra = torch.cumsum(x, 0)
            elif how == "draw":
                extra = torch.rand_like(x)
            elif how == "matmul":
                m = torch.ones(2, 2, dtype=x.dtype, device=x.device)
                extra = (m @ torch.stack([x, x]))[0]
            elif how == "gather":
                u = torch.stack([x, -x])
                extra = u.gather(0, (q[1] > 0).to(torch.int64)[None])[0]
            elif how == "per_env_index":
                extra = torch.stack([x, -x])[(q[1] > 0).to(torch.int64), torch.arange(
                    x.shape[-1], device=x.device)]
            elif how == "branch":
                extra = x if torch.equal(x, q[1]) else -x
            elif how == "dtype":
                extra = x.to(torch.float16).to(x.dtype)
            elif how == "cap":
                extra = torch.stack([x * k for k in range(65)]).sum(0)
            elif how == "view_write":
                u = torch.stack([x, x])
                u[0] += 1.0
                extra = u[1]
            else:  # "batch_axis": the batch moved off the last axis
                extra = torch.stack([x, -x], dim=-1).sum(-1)
            return obs, reward + extra, term, aux2, comps

    return Refused()


@pytest.mark.parametrize("how, match", [
    ("batch_sum", r"sum.* couples the envs"), ("batch_scan", r"cumsum.* couples the envs"),
    ("draw", r"rand_like.*Threefry"), ("matmul", r"mm.*sum of products"),
    ("gather", r"gather.*per-env index"), ("per_env_index", r"index.*per-env index"),
    ("branch", r"branch"), ("dtype", r"dtype torch.float16"),
    ("cap", r"stack.* 65 elements.* at most 64"), ("view_write", r"add_.*view"),
    ("batch_axis", r"stack.*batch axis")])
def test_what_stays_refused(how, match):
    """(c) fused raises naming the op; composed is taken only when asked"""
    task = _refusing(how)
    with pytest.raises(NotImplementedError, match=f"Refused.output_scalar.*{match}"):
        base_t.BatchedEnv(task, 4, device="cpu")
    assert base_t.BatchedEnv(task, 4, device="cpu", backend="composed").backend == "composed"
