"""The port's scalar dynamics agree with the JAX package's eager scalar
functions on HalfCheetah at random q, v (B=4): FK poses, M, C, the Cholesky
factor and its solves, at rtol 1e-5 (atol 1e-5 for entries near zero). The
structural-zero pattern (Python 0.0 entries) must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybulletgym_tpu as pg
from pybulletgym_tpu.ops import dynamics as dyn_j
from pybulletgym_tpu_torch import make_task
from pybulletgym_tpu_torch.ops import dynamics as dyn_t

ENV = "HalfCheetahPyBulletEnv-v0"
B = 4
RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def case():
    tj, tt = pg.make_task(ENV), make_task(ENV)
    rng = np.random.default_rng(7)
    q = rng.uniform(-0.6, 0.6, (tj.model.nq, B)).astype(np.float32)
    q[1] = rng.uniform(0.0, 0.3, B)  # rootz
    v = rng.normal(0, 2, (tj.model.nv, B)).astype(np.float32)
    qj, vj = [jnp.asarray(r) for r in q], [jnp.asarray(r) for r in v]
    qt, vt = [torch.from_numpy(r) for r in q], [torch.from_numpy(r) for r in v]
    fkj = dyn_j.forward_kinematics(tj.model, qj, vj)
    fkt = dyn_t.forward_kinematics(tt.model, qt, vt)
    return tj, tt, (qj, vj, fkj), (qt, vt, fkt)


def _close(a, b, what):
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, float) and isinstance(b, float), f"{what}: zero pattern differs"
        assert a == b, what
        return
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=RTOL, atol=ATOL, err_msg=what)


def _tree(a, b, what):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for k, (x, y) in enumerate(zip(a, b)):
            _tree(x, y, f"{what}[{k}]")
    else:
        _close(a, b, what)


def test_forward_kinematics(case):
    _, _, (_, _, fj), (_, _, ft) = case
    for field in ("R", "p", "S", "vel", "com", "inertia"):
        _tree(getattr(fj, field), getattr(ft, field), field)


def test_mass_matrix_bias_cholesky(case):
    tj, tt, (qj, vj, fj), (qt, vt, ft) = case
    Mj, Mt = dyn_j.mass_matrix(tj.model, fj), dyn_t.mass_matrix(tt.model, ft)
    _tree(Mj, Mt, "M")
    _tree(dyn_j.bias_forces(tj.model, fj, (0.0, 0.0, -9.8)),
          dyn_t.bias_forces(tt.model, ft, (0.0, 0.0, -9.8)), "C")
    _tree(dyn_j.passive_forces(tj.model, qj, vj), dyn_t.passive_forces(tt.model, qt, vt),
          "passive")
    Lj, dj = dyn_j.cholesky(Mj)
    Lt, dt = dyn_t.cholesky(Mt)
    _tree(Lj, Lt, "L")
    _tree(dj, dt, "inv_diag")


def test_solves_and_integrate(case):
    tj, tt, (qj, vj, fj), (qt, vt, ft) = case
    tau = np.random.default_rng(8).normal(0, 50, (tj.model.nv, B)).astype(np.float32)
    rj, Lj, dj = dyn_j.rhs_and_factor(tj.model, fj, qj, vj, [jnp.asarray(r) for r in tau],
                                      (0.0, 0.0, -9.8))
    rt, Lt, dt = dyn_t.rhs_and_factor(tt.model, ft, qt, vt, [torch.from_numpy(r) for r in tau],
                                      (0.0, 0.0, -9.8))
    _tree(rj, rt, "rhs")
    yj, yt = dyn_j.chol_solve_fwd(Lj, dj, rj), dyn_t.chol_solve_fwd(Lt, dt, rt)
    _tree(yj, yt, "fwd")
    _tree(dyn_j.chol_solve_back(Lj, dj, yj), dyn_t.chol_solve_back(Lt, dt, yt), "back")
    _tree(dyn_j.lt_matvec(Lj, vj), dyn_t.lt_matvec(Lt, vt), "Lt v")
    # a structurally sparse right-hand side: a limit row's unit vector
    e_j, e_t = [0.0] * 9, [0.0] * 9
    e_j[5] = e_t[5] = 1.0
    _tree(dyn_j.chol_solve_fwd(Lj, dj, e_j), dyn_t.chol_solve_fwd(Lt, dt, e_t), "fwd e5")
    _tree(dyn_j.integrate(tj.model, qj, vj, 0.004125),
          dyn_t.integrate(tt.model, qt, vt, 0.004125), "integrate")
