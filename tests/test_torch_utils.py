"""The port's utils against the JAX package's, on the CPU: checkpoints
(round trips that resume bitwise, the four template mismatches, and files
that cross between the packages in both directions), `EpisodeStats`
(episode count exact, sums within rtol 1e-6), the SDF importer (equal),
and rendering (geom rows within 1e-5 of JAX's; native and orthographic
frames differ from JAX's in at most 0.1% of pixels).

The JAX side runs eagerly (`jit=False`) or through host numpy, so this file
compiles no JAX env step.
"""

import os
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybulletgym_tpu as pg
import pybulletgym_tpu_torch as pt
from pybulletgym_tpu.models.sdf import parse_sdf_world_geoms as jax_parse_sdf
from pybulletgym_tpu.utils import checkpoint as jax_checkpoint
from pybulletgym_tpu.utils import render as jax_render
from pybulletgym_tpu.utils.metrics import EpisodeStats as JaxEpisodeStats
from pybulletgym_tpu_torch.models.sdf import parse_sdf_world_geoms
from pybulletgym_tpu_torch.parallel import ppo, sac
from pybulletgym_tpu_torch.utils import checkpoint, render
from pybulletgym_tpu_torch.utils.interop import (
    env_state_to_numpy, sac_state_from_npz, train_state_from_npz,
)
from pybulletgym_tpu_torch.utils.metrics import EpisodeStats
from test_sdf import SDF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "examples", "weights")
HOPPER = "HopperPyBulletEnv-v0"
B = 8


def _leaves(tree):
    return checkpoint._flatten(tree)[0]


def _assert_leaves_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        if isinstance(x, torch.Generator):
            assert isinstance(y, torch.Generator) and x.device == y.device
            assert torch.equal(x.get_state(), y.get_state()), f"leaf {i}: generator state"
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device, f"leaf {i}"
            assert torch.equal(x, y), f"leaf {i}"
        else:
            assert type(x) is type(y) and x == y, f"leaf {i}"


@pytest.fixture(scope="module")
def hopper_run():
    """Port Hopper, plain step, B=8: the state after 5 steps and 10 seeded
    actions."""
    env = pt.make_batched(HOPPER, B, device="cpu")
    acts = np.random.default_rng(0).uniform(-1, 1, (10, B, 3)).astype(np.float32)
    s = env.reset(seed=7)
    for a in acts[:5]:
        s = env.step(s, a)
    return env, s, acts


# ---- checkpoints -----------------------------------------------------------------


def test_envstate_roundtrip_resumes_exact_trajectory(hopper_run, tmp_path):
    env, s, acts = hopper_run
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, s)
    s2 = checkpoint.load(path, env.reset(seed=0))
    _assert_leaves_equal(s, s2)
    ref, res = s, s2
    for a in acts[5:]:
        ref, res = env.step(ref, a), env.step(res, a)
    _assert_leaves_equal(ref, res)


def test_trainstate_roundtrip(tmp_path):
    cfg = ppo.PPOConfig(hidden=(16, 16))
    ts = ppo.init_train_state(3, 5, 1, cfg, device="cpu")
    torch.randn(4, generator=ts.generator)  # the stream has moved
    path = str(tmp_path / "ts.npz")
    checkpoint.save(path, ts)
    ts2 = checkpoint.load(path, ppo.init_train_state(9, 5, 1, cfg, device="cpu"))
    _assert_leaves_equal(ts, ts2)
    assert isinstance(ts2.params, type(ts.params))
    assert torch.equal(torch.randn(4, generator=ts.generator),
                       torch.randn(4, generator=ts2.generator))


def test_sacstate_roundtrip(tmp_path):
    cfg = sac.SACConfig(hidden=(8, 8), buffer_slots=4)
    ss = sac.init_sac_state(1, 5, 2, 3, cfg, device="cpu")
    ss = ss._replace(buf_obs=torch.randn(ss.buf_obs.shape, generator=ss.generator),
                     buf_ptr=3, buf_full=True)
    path = str(tmp_path / "ss.npz")
    checkpoint.save(path, ss)
    ss2 = checkpoint.load(path, sac.init_sac_state(2, 5, 2, 3, cfg, device="cpu"))
    _assert_leaves_equal(ss, ss2)
    assert type(ss2.buf_ptr) is int and type(ss2.buf_full) is bool


@pytest.mark.parametrize("case", ["more_in_template", "fewer_in_template", "structure", "shape"])
def test_template_mismatches_raise_value_error(case, tmp_path):
    """tests/test_checkpoint.py's four cases: more leaves in the template
    than in the file, fewer, a different structure (dict keys) with the
    same leaf count, and a leaf of another shape."""
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, {"a": np.zeros(3), "b": torch.ones(2)})
    template = {
        "more_in_template": {"a": np.zeros(3), "b": torch.ones(2), "c": np.zeros(1)},
        "fewer_in_template": {"a": np.zeros(3)},
        "structure": {"a": np.zeros(3), "z": torch.ones(2)},
        "shape": {"a": np.zeros(4), "b": torch.ones(2)},
    }[case]
    with pytest.raises(ValueError):
        checkpoint.load(path, template)


def test_jax_saved_envstate_loads_into_port(tmp_path):
    path = str(tmp_path / "jax.npz")
    jax_checkpoint.save(path, pg.make_batched(HOPPER, B, backend="xla", jit=False).reset(seed=7))
    env = pt.make_batched(HOPPER, B, device="cpu")
    s = checkpoint.load(path, env.reset(seed=0))
    _assert_leaves_equal(s, env.reset(seed=7))


def test_port_saved_envstate_loads_in_jax(hopper_run, tmp_path):
    env, _, acts = hopper_run
    s = env.reset(seed=11)
    for a in acts[:3]:
        s = env.step(s, a)
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, s)
    sj = jax_checkpoint.load(path, pg.make_batched(HOPPER, B, backend="xla", jit=False).reset(0))
    want, got = env_state_to_numpy(s), env_state_to_numpy(sj)
    for k in want:
        if isinstance(want[k], dict):
            assert sorted(want[k]) == sorted(got[k])
            for n in want[k]:
                np.testing.assert_array_equal(want[k][n], got[k][n], err_msg=f"{k}.{n}")
        else:
            assert want[k].dtype == got[k].dtype, k
            np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def test_trainstate_leaves_in_jax_order(tmp_path):
    """A port-saved TrainState has the shipped JAX TrainState's leaf at
    every index but the key's, where the port keeps its generator."""
    src = os.path.join(WEIGHTS, "AntPyBulletEnv-v0.trainstate.npz")
    ts, _ = train_state_from_npz(src, device="cpu")
    path = str(tmp_path / "ts.npz")
    checkpoint.save(path, ts)
    key_index = next(i for i, x in enumerate(_leaves(ts)) if isinstance(x, torch.Generator))
    with np.load(src) as ref, np.load(path) as got:
        n = sum(k.startswith("leaf_") for k in ref)
        assert n == sum(k.startswith("leaf_") for k in got)
        assert ref[f"leaf_{key_index}"].shape == (2,)  # the JAX key
        for i in range(n):
            if i != key_index:
                assert got[f"leaf_{i}"].dtype == ref[f"leaf_{i}"].dtype, f"leaf {i}"
                np.testing.assert_array_equal(got[f"leaf_{i}"], ref[f"leaf_{i}"], err_msg=f"leaf {i}")


def test_sacstate_leaves_in_jax_order(tmp_path):
    """A port-saved SACState begins with the shipped learner's leaves
    (actor, critics, targets, log_alpha, the three Adam states), then the
    generator where the learner keeps its key, then the ring."""
    src = os.path.join(WEIGHTS, "HopperMuJoCoEnv-v0.saclearner.npz")
    cfg = sac.SACConfig(buffer_slots=2)
    ss = sac_state_from_npz(src, 4, cfg, device="cpu")
    path = str(tmp_path / "ss.npz")
    checkpoint.save(path, ss)
    with np.load(src) as ref, np.load(path) as got:
        n = sum(k.startswith("leaf_") for k in ref)
        assert isinstance(_leaves(ss)[n - 1], torch.Generator)
        for i in range(n - 1):
            np.testing.assert_array_equal(got[f"leaf_{i}"], ref[f"leaf_{i}"], err_msg=f"leaf {i}")
        assert sum(k.startswith("leaf_") for k in got) == n + 7  # 5 ring tensors, ptr, full


# ---- EpisodeStats ----------------------------------------------------------------


def test_episode_stats_match_jax():
    Bs, T = 64, 300
    rng = np.random.default_rng(4)
    rewards = rng.normal(1.0, 2.0, (T, Bs)).astype(np.float32)
    dones = rng.random((T, Bs)) < 0.02
    st, ref = EpisodeStats.init(Bs, device="cpu"), JaxEpisodeStats.init(Bs)
    for r, d in zip(rewards, dones):
        st = st.update(torch.from_numpy(r), torch.from_numpy(d))
        ref = ref.update(jnp.asarray(r), jnp.asarray(d))
    assert st.n_episodes.dtype == torch.int32 and st.sum_returns.dtype == torch.float32
    assert int(st.n_episodes) == int(ref.n_episodes) == int(dones.sum())
    for name in ("sum_returns", "sum_lengths", "running_return", "running_length"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(st.mean_return()), float(ref.mean_return()), rtol=1e-6)
    np.testing.assert_allclose(float(st.mean_length()), float(ref.mean_length()), rtol=1e-6)
    empty = EpisodeStats.init(2, device="cpu")
    assert float(empty.mean_return()) == 0.0 and float(empty.mean_length()) == 0.0


# ---- SDF ---------------------------------------------------------------------------


def test_sdf_matches_jax():
    got, want = parse_sdf_world_geoms(SDF), jax_parse_sdf(SDF)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert (g.name, g.body, int(g.gtype), g.friction, g.contype, g.conaffinity) == \
            (w.name, w.body, int(w.gtype), w.friction, w.contype, w.conaffinity)
        for f in ("size", "pos", "quat"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)


# ---- rendering -------------------------------------------------------------------


@pytest.fixture(scope="module")
def hopper_frames():
    """Port Hopper (B=2, 3 zero-action plain steps) and the JAX task fed the
    same q and v as numpy."""
    env = pt.make_batched(HOPPER, 2, device="cpu")
    s = env.reset(seed=0)
    for _ in range(3):
        s = env.step(s, np.zeros((2, 3), np.float32))
    host = types.SimpleNamespace(q=s.q.numpy(), v=s.v.numpy())
    return env.task, s, pg.make_task(HOPPER), host


def test_geom_rows_match_jax(hopper_frames):
    task, s, jtask, host = hopper_frames
    for env in (0, 1):
        got, want = render._geom_rows(task, s, env), jax_render._geom_rows(jtask, host, env)
        assert got.shape == want.shape and got.shape[0] > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("which", ["native", "ortho"])
def test_frames_match_jax(hopper_frames, which):
    task, s, jtask, host = hopper_frames
    fn, ref = {"native": (render.render_state_native, jax_render.render_state_native),
               "ortho": (render._render_state_ortho, jax_render._render_state_ortho)}[which]
    got, want = fn(task, s), ref(jtask, host)
    assert got is not None and want is not None, "no g++ for the native renderer"
    assert got.shape == (240, 320, 3) and got.dtype == np.uint8
    assert (got < 250).any(), "the frame is blank"
    differ = (got != want).any(-1).mean()
    assert differ <= 1e-3, f"{differ:.2%} of pixels differ"


def test_adapter_render_modes():
    env = pt.make("HopperPyBulletEnv-v0", device="cpu")
    env.reset(seed=0)
    frame = env.render()
    assert frame.shape == (240, 320, 3) and frame.dtype == np.uint8
    np.testing.assert_array_equal(frame, render.render_state_native(env._env.task, env._state))
    human = pt.make("HopperPyBulletEnv-v0", device="cpu", render_mode="human")
    human.reset(seed=0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert human.render() is None
        assert human.render() is None  # warned once
    assert len([w for w in caught if "render_mode='human'" in str(w.message)]) == 1
    human.close()
