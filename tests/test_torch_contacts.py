"""The port's narrowphase, contact Jacobians and PGS agree with the JAX
package's eager scalar functions on HalfCheetah (B=4).

Narrowphase points and depths: within 1e-6 (a few float32 products and sums
on identical FK inputs). The PGS: both sides get the SAME y rows, limit rows,
z and q (made with numpy), so only the libraries' float32 kernels differ;
five sweeps of 16 contact and 12 limit rows divide by effective masses
|y|^2 + 1e-9 that reach 1e-3, which can amplify a last-bit difference of a
dot product a thousandfold in an impulse, hence 1e-4 on z and z_pseudo."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybulletgym_tpu as pg
from pybulletgym_tpu.ops import contacts as ct_j
from pybulletgym_tpu.ops import dynamics as dyn_j
from pybulletgym_tpu_torch import make_task
from pybulletgym_tpu_torch.ops import contacts as ct_t
from pybulletgym_tpu_torch.ops import dynamics as dyn_t

ENV = "HalfCheetahPyBulletEnv-v0"
B = 4


@pytest.fixture(scope="module")
def case():
    tj, tt = pg.make_task(ENV), make_task(ENV)
    rng = np.random.default_rng(11)
    q = rng.uniform(-0.5, 0.5, (9, B)).astype(np.float32)
    q[1] = rng.uniform(-0.45, -0.2, B)  # rootz low: several rows penetrate
    v = rng.normal(0, 1, (9, B)).astype(np.float32)
    qj, vj = [jnp.asarray(r) for r in q], [jnp.asarray(r) for r in v]
    qt, vt = [torch.from_numpy(r) for r in q], [torch.from_numpy(r) for r in v]
    fj = dyn_j.forward_kinematics(tj.model, qj, vj)
    ft = dyn_t.forward_kinematics(tt.model, qt, vt)
    pj = ct_j.build_contact_plan(tj.model, tj.physics.solver)
    pt = ct_t.build_contact_plan(tt.model, tt.physics.solver)
    return tj, tt, (qj, fj, pj), (qt, ft, pt)


def test_narrowphase_and_jacobians(case):
    tj, tt, (_, fj, pj), (_, ft, pt) = case
    sj = ct_j.narrowphase_scalar(tj.model, fj, pj)
    st = ct_t.narrowphase_scalar(tt.model, ft, pt)
    assert len(sj.depth) == len(st.depth) == 16
    for r in range(16):
        np.testing.assert_allclose(np.asarray(sj.depth[r]), st.depth[r].numpy(), atol=1e-6)
        for k in range(3):
            np.testing.assert_allclose(np.asarray(sj.P[r][k]), st.P[r][k].numpy(), atol=1e-6)
        np.testing.assert_array_equal(sj.W[r], st.W[r])
        assert sj.mu[r] == st.mu[r]
    assert (np.stack([np.asarray(d) for d in sj.depth]) > 0).any(), "no penetrating row"
    Jj = ct_j.scalar_jacobians(tj.model, fj, sj)
    Jt = ct_t.scalar_jacobians(tt.model, ft, st)
    for r in range(16):
        for k in range(3):
            for d in range(9):
                a, b = Jj[r][k][d], Jt[r][k][d]
                if isinstance(a, float):
                    assert isinstance(b, float) and a == b == 0.0
                else:
                    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-6)


def test_solve_scalar_same_inputs(case):
    tj, tt, (qj, fj, pj), (qt, ft, pt) = case
    sj = ct_j.narrowphase_scalar(tj.model, fj, pj)
    st = ct_t.narrowphase_scalar(tt.model, ft, pt)
    rng = np.random.default_rng(12)
    # identical depths on both sides: the JAX ones
    depth = np.stack([np.asarray(d) for d in sj.depth])
    st = st._replace(depth=[torch.from_numpy(d.copy()) for d in depth])
    y_rows = rng.normal(0, 0.3, (16, 3, 9)).astype(np.float32)
    y_lim = rng.normal(0, 0.3, (12, 9)).astype(np.float32)
    z = rng.normal(0, 1, (9, B)).astype(np.float32)

    def rows(fn, y):  # per-row nv-lists of per-env scalars (broadcast over B)
        return [tuple([fn(np.full(B, y[r, k, d], np.float32)) for d in range(9)]
                      for k in range(3)) for r in range(16)]

    yr_j, yr_t = rows(jnp.asarray, y_rows), rows(torch.from_numpy, y_rows)
    yl_j = [[jnp.asarray(np.full(B, y_lim[i, d], np.float32)) for d in range(9)] for i in range(12)]
    yl_t = [[torch.from_numpy(np.full(B, y_lim[i, d], np.float32)) for d in range(9)]
            for i in range(12)]
    lim_j, lim_t = ct_j.build_limit_plan(tj.model), ct_t.build_limit_plan(tt.model)
    dt = tj.physics.timestep
    zj, zpj, lnj = ct_j.solve_scalar(tj.model, tj.physics.solver, dt, sj, yr_j, lim_j, yl_j,
                                     qj, [jnp.asarray(r) for r in z])
    zt, zpt, lnt = ct_t.solve_scalar(tt.model, tt.physics.solver, dt, st, yr_t, lim_t, yl_t,
                                     qt, [torch.from_numpy(r.copy()) for r in z])
    for a, b in zip(zj + zpj + lnj, zt + zpt + lnt):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-4, rtol=1e-5)
