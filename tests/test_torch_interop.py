"""State and weights carried between the JAX package and the port: an
EnvState round-trips exactly, and a shipped policy npz gives the same
actions as the JAX evaluation in test_frozen_policy.py (float32 matmuls in
other libraries: 1e-5)."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybulletgym_tpu as pg
from pybulletgym_tpu.envs.base import make_env
from pybulletgym_tpu_torch.utils.interop import (
    env_state_from_numpy, env_state_to_numpy, policy_from_npz,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "examples", "weights")


def test_env_state_round_trip():
    task = pg.make_task("HalfCheetahPyBulletEnv-v0")
    reset, _ = make_env(task)
    sj = reset(jnp.full((3,), 2**32 - 1, jnp.uint32), jnp.arange(3, dtype=jnp.int32),
               jnp.full((3,), 7, jnp.uint32))
    d = env_state_to_numpy(sj)
    st = env_state_from_numpy(d, device="cpu")
    assert st.seed.dtype == torch.uint32 and st.epoch.dtype == torch.uint32
    assert st.step_count.dtype == torch.int32 and st.terminated.dtype == torch.bool
    back = env_state_to_numpy(st)
    for k in ("q", "v", "obs", "reward", "terminated", "truncated", "step_count", "epoch",
              "env_id", "seed"):
        np.testing.assert_array_equal(d[k], back[k], err_msg=k)
        assert d[k].dtype == back[k].dtype, k
    for group in ("aux", "rewards"):
        assert sorted(d[group]) == sorted(back[group])
        for k in d[group]:
            np.testing.assert_array_equal(d[group][k], back[group][k])


def _jax_policy(path):
    """tests/test_frozen_policy.py · _policy, verbatim semantics."""
    d = np.load(path)
    n = int(d["n_layers"])
    ws = [jnp.asarray(d[f"w{i}"]) for i in range(n)]
    bs = [jnp.asarray(d[f"b{i}"]) for i in range(n)]
    norm = None
    if "normalized" in d and bool(d["normalized"]):
        norm = (jnp.asarray(d["obs_mean"]), jnp.sqrt(jnp.asarray(d["obs_var"]) + 1e-8))
    squash = "squash" in d and bool(d["squash"])

    def act(obs):
        h = obs
        if norm is not None:
            h = jnp.clip((h - norm[0]) / norm[1], -10.0, 10.0)
        for i, (w, b) in enumerate(zip(ws, bs)):
            h = h @ w + b
            if i < n - 1:
                h = jnp.tanh(h)
        return jnp.tanh(h) if squash else jnp.clip(h, -1.0, 1.0)

    return act


@pytest.mark.parametrize("name", [
    "HalfCheetahPyBulletEnv-v0",            # SAC: tanh head, raw observations
    "InvertedPendulumPyBulletEnv-v0",       # clip head, raw observations
    "HopperPyBulletEnv-v0",                 # clip head, normalized observations
    "AntPyBulletEnv-v0",                    # clip head, normalized observations
    "AtlasPyBulletEnv-v0",                  # obs 70, act 30
])
def test_policy_from_npz_matches_jax(name):
    path = os.path.join(WEIGHTS, f"{name}.npz")
    with np.load(path) as d:
        obs_dim = d["w0"].shape[0]
    obs = np.random.default_rng(0).normal(0, 2, (16, obs_dim)).astype(np.float32)
    want = np.asarray(_jax_policy(path)(jnp.asarray(obs)))
    got = policy_from_npz(path, device="cpu")(torch.from_numpy(obs)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_shipped_weights_cover_the_cases():
    flags = []
    for p in glob.glob(os.path.join(WEIGHTS, "*.npz")):
        if p.endswith((".trainstate.npz", ".saclearner.npz")):
            continue
        with np.load(p) as d:
            flags.append((bool(d.get("normalized", False)), bool(d.get("squash", False))))
    assert (False, True) in flags and (False, False) in flags and any(n for n, _ in flags)
