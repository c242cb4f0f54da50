"""The port's example scripts (`pybulletgym_tpu_torch/examples/`) against the
JAX package's (`examples/`), on the CPU at a tiny size (B=8, 1-2
iterations, rollout 4; InvertedPendulum, whose plain step takes milliseconds):

(a) `train_ppo` writes an .npz with the keys, shapes and dtypes that the JAX
    script writes for the same arguments (the JAX script run in-process,
    its `ppo.train` replaced by a fresh JAX TrainState of the same config,
    so that it writes without compiling a train step), and the JAX
    `enjoy.py` policy class loads it. Exact.
(b) `train_loop` run twice (1 + 1 iterations) resumes ("resuming from")
    and ends bitwise where one run of 2 iterations ends: every entry of
    the TrainState file (the generator's stream too), the env batch and
    the policy file. Exact.
(c) `enjoy` on shipped weights gives, at every step, the action that the
    JAX `enjoy.py` policy class gives on the same observation: atol 1e-6
    (float32 products in torch and numpy, summed in their own orders).
    Plain head, normalised observations, and the SAC tanh head.
(d) a checkpoint that `train_loop` wrote loads with the JAX
    `utils/checkpoint.load`, and a JAX-written one with the port's `load`
    and into `train_loop`, which resumes from it: leaf by leaf, exact (the
    generator's leaf is the JAX key's uint32[2], its seed's two words).
Also: no module of the port, and not `chip_smoke.py`, imports jax, the JAX
package or `examples/` (an AST walk), and `--device cuda` without a card
raises.
"""

import ast
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybulletgym_tpu as pg
import pybulletgym_tpu_torch as pt
from pybulletgym_tpu.parallel import ppo as ppo_j
from pybulletgym_tpu.utils import checkpoint as jax_checkpoint
from pybulletgym_tpu_torch.examples import enjoy, train_loop, train_ppo
from pybulletgym_tpu_torch.parallel import ppo
from pybulletgym_tpu_torch.utils import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "examples", "weights")
ENV = "InvertedPendulumPyBulletEnv-v0"
TINY = ["--batch", "8", "--rollout", "4", "--device", "cpu"]


def _jax_example(name):
    """examples/<name>.py as a module, run from its file (not edited)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _npz(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def _jax_train_state(cfg, seed=0):
    env = pg.make_batched(ENV, 8, backend="xla", jit=False)
    return ppo_j.init_train_state(jax.random.PRNGKey(seed), env.observation_size,
                                  env.action_size, cfg)


def _port_leaves(path, cfg):
    """A port TrainState file's leaves as numpy, the generator as its key."""
    task = pt.make_task(ENV)
    ts = checkpoint.load(path, ppo.init_train_state(0, task.obs_dim, task.act_dim, cfg,
                                                    device="cpu"))
    return [checkpoint._to_numpy(x) for x in checkpoint._flatten(ts)[0]], ts


def test_train_ppo_writes_the_jax_scripts_npz(tmp_path, monkeypatch, capsys):
    """(a)"""
    port_out, jax_out = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    train_ppo.main([ENV, "--iters", "1", "--out", port_out, *TINY])
    assert "saved" in capsys.readouterr().out

    def fake_train(env_id, batch_size, num_iterations, cfg=None, seed=0, progress=None):
        return _jax_train_state(cfg, seed), None, {"reward_mean": jnp.float32(0.0)}

    monkeypatch.setattr(ppo_j, "train", fake_train)
    monkeypatch.setattr(sys, "argv", ["train_ppo.py", ENV, "--iters", "1", "--batch", "8",
                                      "--rollout", "4", "--out", jax_out])
    _jax_example("train_ppo").main()
    port, ref = _npz(port_out), _npz(jax_out)
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert port[k].shape == ref[k].shape and port[k].dtype == ref[k].dtype, k
    assert int(port["n_layers"]) == int(ref["n_layers"]) == 3
    pi = _jax_example("enjoy").SmallReactivePolicy(port_out)
    assert pi.act(np.zeros(5, np.float32)).shape == (1,)


def test_train_loop_resume_is_one_run(tmp_path, capsys):
    """(b)"""
    split, whole = str(tmp_path / "split"), str(tmp_path / "whole")
    for _ in range(2):
        train_loop.main([ENV, "--iters", "1", "--weights-dir", split, "--normalize", *TINY])
    out = capsys.readouterr().out
    assert out.count("fresh start") == 1 and out.count("resuming from") == 1
    assert "incompatible" not in out
    train_loop.main([ENV, "--iters", "2", "--weights-dir", whole, "--normalize", *TINY])
    names = sorted(os.listdir(whole))
    assert names == sorted(os.listdir(split)) == sorted(
        [f"{ENV}.npz", f"{ENV}.trainstate.npz", f"{ENV}.b8.envstate.npz"])
    for name in names:
        a, b = _npz(os.path.join(split, name)), _npz(os.path.join(whole, name))
        assert sorted(a) == sorted(b), name
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}: {k}")
    ts = _npz(os.path.join(whole, f"{ENV}.trainstate.npz"))
    assert any(k.startswith("__torch_generator_") for k in ts)


@pytest.mark.parametrize("env_id,steps", [
    (ENV, 20),                                   # linear head, clipped
    ("InvertedDoublePendulumPyBulletEnv-v0", 20),  # normalised observations
    ("HalfCheetahPyBulletEnv-v0", 2),            # SAC: tanh head
])
def test_enjoy_actions_match_the_jax_policy(env_id, steps, monkeypatch, capsys):
    """(c)"""
    seen = []
    make = pt.make

    class Recorder:
        def __init__(self, env):
            self.env, self.obs = env, None

        def reset(self, **kw):
            self.obs, info = self.env.reset(**kw)
            return self.obs, info

        def step(self, action):
            seen.append((self.obs.copy(), np.array(action)))
            out = self.env.step(action)
            self.obs = out[0]
            return out

    monkeypatch.setattr(pt, "make", lambda *a, **kw: Recorder(make(*a, **kw)))
    enjoy.main([env_id, "--episodes", "1", "--max-steps", str(steps), "--device", "cpu"])
    assert f"in {steps} steps" in capsys.readouterr().out
    assert len(seen) == steps
    pi = _jax_example("enjoy").SmallReactivePolicy(os.path.join(WEIGHTS, env_id + ".npz"))
    for t, (obs, action) in enumerate(seen):
        np.testing.assert_allclose(action, pi.act(obs), rtol=0, atol=1e-6, err_msg=f"step {t}")


def test_checkpoints_cross_both_ways(tmp_path, capsys):
    """(d)"""
    cfg_j = ppo_j.PPOConfig(rollout_length=4, num_minibatches=8)
    cfg = ppo.PPOConfig(rollout_length=4, num_minibatches=8)
    # the port's file in JAX
    port_dir = str(tmp_path / "port")
    train_loop.main([ENV, "--iters", "1", "--weights-dir", port_dir, *TINY])
    ck = os.path.join(port_dir, f"{ENV}.trainstate.npz")
    want, ts = _port_leaves(ck, cfg)
    got = jax.tree.leaves(jax_checkpoint.load(ck, _jax_train_state(cfg_j)))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = np.asarray(g)
        assert g.shape == w.shape, i
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=f"leaf {i}")
    seed = ts.generator.initial_seed()
    assert [int(x) for x in got[-4]] == [seed >> 32, seed & 0xFFFFFFFF]  # the key
    assert int(ts.opt_count) == 32  # 4 epochs x 8 minibatches

    # JAX's file in the port: checkpoint.load, then train_loop resumes from it
    tsj = _jax_train_state(cfg_j, seed=5)
    tsj = tsj._replace(opt_count=jnp.int32(320), key=jnp.array([7, 9], jnp.uint32))
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    jck = str(jax_dir / f"{ENV}.trainstate.npz")
    jax_checkpoint.save(jck, tsj)
    want = [np.asarray(x) for x in jax.tree.leaves(tsj)]
    got, ts = _port_leaves(jck, cfg)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=f"leaf {i}")
    assert ts.generator.initial_seed() == (7 << 32) | 9
    capsys.readouterr()
    train_loop.main([ENV, "--iters", "1", "--weights-dir", str(jax_dir), *TINY])
    out = capsys.readouterr().out
    assert "resuming from" in out and "incompatible" not in out
    assert int(_npz(jck)[f"leaf_{len(want) - 5}"]) == 352  # opt_count moved on by 32


@pytest.mark.parametrize("script,args", [
    (train_ppo, ["--iters", "1", "--out", "x.npz"]),
    (train_loop, ["--iters", "1", "--weights-dir", "w"]),
    (enjoy, ["--episodes", "1"]),
])
def test_device_cuda_without_a_card_raises(script, args, tmp_path, monkeypatch):
    """The default device is the card, and no script falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the scripts run on it")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main([ENV, *args])


def _imports(path):
    """The top-level names of the modules that a file imports."""
    names = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_imports_no_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(ROOT, "pybulletgym_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    assert any(f.endswith(os.path.join("examples", "enjoy.py")) for f in files)
    bad = {os.path.relpath(f, ROOT): sorted(n & {"jax", "jaxlib", "pybulletgym_tpu", "examples"})
           for f in files for n in [_imports(f)] if n & {"jax", "jaxlib", "pybulletgym_tpu",
                                                         "examples"}}
    assert not bad, bad
