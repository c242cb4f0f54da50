"""The port's host-side model data equals the JAX package's for HalfCheetah
and Ant: Model, contact and limit plans, and the WalkerTask constants. Exact
equality throughout (both sides run the same numpy code on the same XML)."""

import os
import subprocess
import sys

import numpy as np
import pytest

import pybulletgym_tpu as pg
from pybulletgym_tpu.ops import contacts as ct_j
from pybulletgym_tpu_torch import make_task
from pybulletgym_tpu_torch.ops import contacts as ct_t

ENV = "HalfCheetahPyBulletEnv-v0"
ANT = "AntPyBulletEnv-v0"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (nq, nv, bodies), contact rows, limit rows, obs, act, initial_z
EXPECT = {
    ENV: ((9, 9, 9), 16, 12, 26, 6, 0.72539830),
    ANT: ((15, 14, 9), 25, 16, 28, 8, 0.75),
}


@pytest.fixture(scope="module", params=[ENV, ANT])
def tasks(request):
    return pg.make_task(request.param), make_task(request.param)


def _expect(tt):
    return EXPECT[{"half_cheetah": ENV, "ant": ANT}[tt.spec.name]]


def _same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for k, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{k}]")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _same(a[k], b[k], f"{what}[{k}]")
    elif hasattr(a, "__dataclass_fields__"):
        for f in a.__dataclass_fields__:
            _same(getattr(a, f), getattr(b, f), f"{what}.{f}")
    else:
        assert a == b, f"{what}: {a!r} != {b!r}"


def test_model_equal(tasks):
    tj, tt = tasks
    mj, mt = tj.model, tt.model
    for f in mj.__dataclass_fields__:
        if f in ("bodies", "geoms", "actuators"):
            for k, (x, y) in enumerate(zip(getattr(mj, f), getattr(mt, f))):
                for g in x.__dataclass_fields__:
                    _same(getattr(x, g), getattr(y, g), f"{f}[{k}].{g}")
            assert len(getattr(mj, f)) == len(getattr(mt, f))
        else:
            _same(getattr(mj, f), getattr(mt, f), f)
    assert (mt.nq, mt.nv, len(mt.bodies)) == _expect(tt)[0]


def test_plans_equal(tasks):
    tj, tt = tasks
    pj = ct_j.build_contact_plan(tj.model, tj.physics.solver)
    pt = ct_t.build_contact_plan(tt.model, tt.physics.solver)
    assert [tuple(c) for c in pj[0]] == [tuple(c) for c in pt[0]]
    assert [tuple(c) for c in pj[1]] == [tuple(c) for c in pt[1]] == []
    assert ct_j.plan_rows(pj) == ct_t.plan_rows(pt) == _expect(tt)[1]
    assert ct_j.plan_row_geoms(pj) == ct_t.plan_row_geoms(pt)
    assert all(c.kind == "point" for c in pt[0])
    lj, lt = ct_j.build_limit_plan(tj.model), ct_t.build_limit_plan(tt.model)
    for f in lj._fields:
        np.testing.assert_array_equal(getattr(lj, f), getattr(lt, f))
    assert lt.dof.shape == (_expect(tt)[2],)


def test_task_constants_equal(tasks):
    tj, tt = tasks
    assert tj.foot_rows == tt.foot_rows
    assert tj.base_body == tt.base_body
    _same(tj.part_frames, tt.part_frames, "part_frames")
    for name in ("gains", "act_dofs", "act_qadr", "j_mid", "j_halfrange"):
        np.testing.assert_array_equal(getattr(tj, name), getattr(tt, name), err_msg=name)
    assert (tt.obs_dim, tt.act_dim, tt.max_episode_steps) == (*_expect(tt)[3:5], 1000)
    assert tt.physics == tt.physics.__class__(**{
        f: getattr(tj.physics, f) for f in tj.physics.__dataclass_fields__
        if f != "solver"}, solver=tt.physics.solver)
    assert tt.initial_z == tj.initial_z  # bitwise: the float32 FK result
    assert abs(tt.initial_z - _expect(tt)[5]) < 1e-7


def test_unknown_id_lists_known():
    with pytest.raises(KeyError, match="HumanoidPyBulletEnv-v0"):
        make_task("NoSuchEnv-v0")


def test_import_never_loads_jax():
    code = (
        "import sys, pybulletgym_tpu_torch\n"
        "from pybulletgym_tpu_torch.envs import base, locomotion\n"
        "from pybulletgym_tpu_torch.ops import cuda_engine, step, contacts, dynamics\n"
        "from pybulletgym_tpu_torch.utils import interop\n"
        "from pybulletgym_tpu_torch.parallel import networks, ppo\n"
        "from pybulletgym_tpu_torch.examples import enjoy, train_loop, train_ppo\n"
        "pybulletgym_tpu_torch.make_task('HalfCheetahPyBulletEnv-v0')\n"
        "pybulletgym_tpu_torch.make_task('AntPyBulletEnv-v0')\n"
        "pybulletgym_tpu_torch.make_task('HumanoidFlagrunHarderPyBulletEnv-v0')\n"
        "pybulletgym_tpu_torch.make_task('AtlasPyBulletEnv-v0')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'pybulletgym_tpu' or m.startswith('pybulletgym_tpu.')\n"
        "       or m == 'examples' or m.startswith('examples.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
