"""The port's gymnasium API (`make`, `make_vec`, both adapters and the
gymnasium registration) against the JAX package's, on the CPU.

The adapters are held to the JAX adapter on InvertedPendulum (obs within
1e-5, rewards, flags and info keys equal; each reset's q and v bitwise
equal to the eager JAX reset of the same seed and epoch, and within one
float32 spacing of the draws' bound 0.1 (7.45e-9) of the JAX adapter's
jitted one, which XLA's CPU compile rounds apart on some draws); the vector
adapter to the port's own `BatchedEnv`
(bitwise). The port registers its
IDs under the namespace ``pybulletgym_tpu_torch/`` and leaves the bare IDs
to the JAX package, whichever is imported first.
"""

import os
import subprocess
import sys

import gymnasium
import numpy as np
import pytest
import torch

import pybulletgym_tpu as pg
import pybulletgym_tpu_torch as pt
from pybulletgym_tpu_torch.api import gym_adapter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PENDULUM = "InvertedPendulumPyBulletEnv-v0"


def test_registry_specs_match_jax():
    assert sorted(pt.registry) == sorted(pg.registry)
    for env_id, spec in pt.registry.items():
        ref = pg.registry[env_id]
        assert (spec.max_episode_steps, spec.reward_threshold) == \
            (ref.max_episode_steps, ref.reward_threshold), env_id
        task, ref_task = pt.make_task(env_id), pg.make_task(env_id)
        assert (task.act_dim, task.obs_dim) == (ref_task.act_dim, ref_task.obs_dim), env_id


def test_gymnasium_registration_uses_its_own_namespace():
    for env_id, spec in pt.registry.items():
        gs = gymnasium.registry[f"pybulletgym_tpu_torch/{env_id}"]
        assert gs.entry_point == "pybulletgym_tpu_torch.api.gym_adapter:make_adapter"
        assert gs.kwargs == {"env_id": env_id}
        assert gs.reward_threshold == spec.reward_threshold
        assert gs.max_episode_steps is None and gs.disable_env_checker
        # the bare ID stays the JAX package's
        assert gymnasium.registry[env_id].entry_point == \
            "pybulletgym_tpu.api.gym_adapter:make_adapter"
    pt.register_with_gymnasium()  # again: nothing is displaced
    assert gymnasium.registry[PENDULUM].entry_point.startswith("pybulletgym_tpu.")


def test_gymnasium_make_forwards_device():
    env = gymnasium.make(f"pybulletgym_tpu_torch/{PENDULUM}", device="cpu")
    assert isinstance(env.unwrapped, gym_adapter.GymAdapter)
    assert env.unwrapped._env.device == torch.device("cpu")
    obs, info = env.reset(seed=0)
    assert obs.shape == (5,) and obs.dtype == np.float32 and info == {}
    obs, r, term, trunc, info = env.step(env.action_space.sample())
    assert obs.shape == (5,) and isinstance(r, float) and isinstance(term, bool)
    assert sorted(info) == ["reward"]
    # the bare ID still builds the JAX package's adapter
    assert type(gymnasium.make(PENDULUM).unwrapped).__module__ == \
        "pybulletgym_tpu.api.gym_adapter"


def test_entry_points_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        assert pt.make(PENDULUM)._env.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.make(PENDULUM)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.make_vec(PENDULUM, 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gymnasium.make(f"pybulletgym_tpu_torch/{PENDULUM}")


def test_without_gymnasium():
    code = (
        "import sys; sys.modules['gymnasium'] = None\n"
        "import numpy as np\n"
        "import pybulletgym_tpu_torch as pt\n"
        "from pybulletgym_tpu_torch.api import gym_adapter as ga\n"
        "assert ga.gymnasium is None\n"
        f"env = pt.make({PENDULUM!r}, device='cpu')\n"
        "assert isinstance(env.action_space, ga.Box) and env.action_space.shape == (1,)\n"
        "assert env.observation_space.high.shape == (5,)\n"
        "obs, _ = env.reset(seed=1)\n"
        "obs, r, term, trunc, info = env.step(np.zeros(1, np.float32))\n"
        "assert obs.shape == (5,) and r == 1.0 and not term and not trunc\n"
        f"v = pt.make_vec({PENDULUM!r}, 3, device='cpu')\n"
        "assert v.action_space.shape == (3, 1)\n"
        "v.reset(seed=0); out = v.step(np.zeros((3, 1), np.float32)); v.close()\n"
        "assert out[0].shape == (3, 5) and out[2].dtype == bool\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_api_and_utils_never_load_jax():
    """With gymnasium installed too: the adapters, the registration, the
    utils and the renderer load neither jax nor the JAX package."""
    code = (
        "import sys, gymnasium, numpy as np\n"
        "import pybulletgym_tpu_torch as pt\n"
        "from pybulletgym_tpu_torch.utils import checkpoint, metrics, render\n"
        "from pybulletgym_tpu_torch.models import sdf\n"
        f"env = gymnasium.make('pybulletgym_tpu_torch/{PENDULUM}', device='cpu')\n"
        "env.reset(seed=0); env.step(np.zeros(1, np.float32))\n"
        "assert env.render().shape == (240, 320, 3)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'pybulletgym_tpu' or m.startswith('pybulletgym_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr


def test_gym_adapter_matches_jax():
    """reset(seed=3), 20 seeded steps, then reset(): epoch 1 of seed 3."""
    env, ref = pt.make(PENDULUM, device="cpu"), pg.make(PENDULUM)
    eager = pg.make_batched(PENDULUM, 1, backend="xla", jit=False)
    assert env.action_space == ref.action_space
    assert env.observation_space == ref.observation_space
    rng = np.random.default_rng(0)
    for seed in (3, None):
        obs, info = env.reset(seed=seed)
        obs_ref, info_ref = ref.reset(seed=seed)
        assert info == info_ref == {}
        drawn = eager.reset(seed=env._epochs.seed, epoch=env._epochs.epoch)
        for k in ("q", "v"):
            np.testing.assert_array_equal(getattr(env._state, k).numpy(),
                                          np.asarray(getattr(drawn, k)), err_msg=k)
            np.testing.assert_allclose(getattr(env._state, k).numpy(),
                                       np.asarray(getattr(ref._state, k)), rtol=0,
                                       atol=np.spacing(np.float32(0.1)), err_msg=k)
        np.testing.assert_allclose(obs, obs_ref, rtol=0, atol=1e-5)
        assert obs.dtype == np.float32
        for _ in range(20 if seed is not None else 0):
            a = rng.uniform(-1, 1, (1,)).astype(np.float32)
            obs, r, term, trunc, info = env.step(a)
            obs_ref, r_ref, term_ref, trunc_ref, info_ref = ref.step(a)
            np.testing.assert_allclose(obs, obs_ref, rtol=0, atol=1e-5)
            assert (r, term, trunc) == (r_ref, term_ref, trunc_ref)
            assert sorted(info) == sorted(info_ref)
            assert all(info[k] == info_ref[k] for k in info)
    assert int(env._state.epoch[0]) == int(ref._state.epoch[0]) == 1


def test_vector_adapter_matches_batched_env():
    B, env_id = 4, "HopperPyBulletEnv-v0"
    vec = pt.make_vec(env_id, B, device="cpu")
    benv = pt.make_batched(env_id, B, device="cpu")
    assert vec.action_space.shape == (B, 3) and vec.observation_space.shape == (B, 15)
    obs, _ = vec.reset(seed=5)
    s = benv.reset(seed=5)
    np.testing.assert_array_equal(obs, s.obs.T.numpy())
    rng = np.random.default_rng(1)
    for _ in range(3):
        a = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
        obs, r, term, trunc, info = vec.step(a)
        s = benv.step(s, a)
        assert obs.shape == (B, 15) and obs.dtype == np.float32 and obs.flags.c_contiguous
        np.testing.assert_array_equal(obs, s.obs.T.numpy())
        np.testing.assert_array_equal(r, s.reward.numpy())
        assert term.dtype == trunc.dtype == np.bool_
        np.testing.assert_array_equal(term, s.terminated.numpy())
        np.testing.assert_array_equal(trunc, s.truncated.numpy())
        assert sorted(info) == sorted(s.rewards)
        for k in info:
            np.testing.assert_array_equal(info[k], s.rewards[k].numpy())
    # a reset without a seed takes the next epoch of the last one
    vec.reset()
    assert torch.equal(vec._state.q, benv.reset(seed=5, epoch=1).q)
