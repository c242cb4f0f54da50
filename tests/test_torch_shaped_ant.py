"""ShapedAnt (tests/torch_user_tasks.py) against its JAX twin: the port's 10
plain steps at B=6 (`env_step_plain`, the torch hooks and the plain
physics) against the eager JAX composition of the TPU kernel body
(test_torch_engine.py · `_jax_kernel_body`), each rolled from its own
state, every third env forced to reset before step 5: within `bounds_env`
(test_torch_cuda.py) every step; epoch, step count and truncation exact;
the forced envs' reset q and v bitwise; every aux key (the new
`speed_avg` too) within rtol 1e-5, atol 1e-3 as test_torch_custom_task.py
holds aux. The JAX twin's eager Ant step takes seconds on a CPU, so this
file is apart from tests/test_torch_task_ops.py, which holds the same
task's reset to JAX and its host twin to the plain step."""

import jax.numpy as jnp
import numpy as np
import torch

from pybulletgym_tpu.envs import base as base_j
from pybulletgym_tpu_torch.envs import base as base_t
from pybulletgym_tpu_torch.utils.interop import env_state_from_numpy, env_state_to_numpy
from test_torch_cuda import bounds_env
from test_torch_engine import _jax_kernel_body
from test_torch_task_ops import B, FORCED_AT, STEPS, ShapedAntJ, ShapedAntT, _ids


def test_steps_against_the_jax_kernel_body():
    tj, tt = ShapedAntJ(), ShapedAntT()
    sj = env_state_to_numpy(base_j.make_env(tj)[0](*(jnp.asarray(x) for x in _ids())))
    st = env_state_from_numpy(sj, device="cpu")
    acts = np.random.default_rng(17).uniform(-1.3, 1.3, (STEPS, tt.act_dim, B)).astype(np.float32)
    forced = np.zeros(B, bool)
    forced[::3] = True
    for t in range(STEPS):
        a = torch.from_numpy(acts[t])
        if t == FORCED_AT:
            sj = dict(sj, terminated=sj["terminated"] | forced)
            st = st._replace(terminated=st.terminated | torch.from_numpy(forced))
            r0 = _jax_kernel_body(tj, sj, acts[t], frame_skip=0)
            p0 = base_t.env_step_plain(tt, st, a, frame_skip=0)
            np.testing.assert_array_equal(r0["q"][:, forced], p0.q.numpy()[:, forced])
            np.testing.assert_array_equal(r0["v"][:, forced], p0.v.numpy()[:, forced])
        rj = _jax_kernel_body(tj, sj, acts[t], frame_skip=tj.physics.frame_skip)
        st = base_t.env_step_plain(tt, st, a)
        ref = env_state_from_numpy(dict(sj, **{k: rj[k] for k in (
            "q", "obs", "reward", "terminated", "truncated", "step_count", "epoch")}),
            device="cpu")
        bounds_env(st, ref, len(tt.foot_rows))
        assert sorted(rj["aux"]) == sorted(st.aux)
        for k in rj["aux"]:
            np.testing.assert_allclose(rj["aux"][k], st.aux[k].numpy(), rtol=1e-5, atol=1e-3,
                                       err_msg=k)
        sj = dict(sj, **{k: rj[k] for k in ("q", "v", "terminated", "truncated", "step_count",
                                            "epoch", "aux")})
    assert st.epoch.numpy()[forced].tolist() == [1] * int(forced.sum())
