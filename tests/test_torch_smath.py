"""The port's scalar math agrees with the JAX package's. Both run the same
float32 formulas on the CPU, so the bound is 1e-6 absolute (the Cephes
polynomials are accurate to ~1e-7; the libraries' sin/cos may differ in the
last bits), with NaN where JAX gives NaN."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pybulletgym_tpu.ops import smath as sm_j
from pybulletgym_tpu_torch.ops import smath as sm_t

TOL = 1e-6


def _grid():
    rng = np.random.default_rng(0)
    special = np.array([0.0, -0.0, 1.0, -1.0, 1e-31, -1e-31, 1e-30, 0.41421357, 2.4142137,
                        1e30, -1e30, np.inf, -np.inf, np.nan], np.float32)
    vals = np.concatenate([special, rng.normal(0, 3, 40).astype(np.float32)])
    y, x = np.meshgrid(vals, vals)
    return y.ravel(), x.ravel()


def _close(j, t):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=TOL, rtol=0, equal_nan=True)


@pytest.mark.parametrize("fn", ["atan", "asin", "isfinite"])
def test_unary(fn):
    _, x = _grid()
    j = getattr(sm_j, fn)(jnp.asarray(x))
    t = getattr(sm_t, fn)(torch.from_numpy(x))
    if fn == "isfinite":
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    else:
        _close(j, t)


def test_atan2():
    y, x = _grid()
    _close(sm_j.atan2(jnp.asarray(y), jnp.asarray(x)), sm_t.atan2(torch.from_numpy(y),
                                                                  torch.from_numpy(x)))


def _quats(n=64, seed=1):
    q = np.random.default_rng(seed).normal(size=(4, n)).astype(np.float32)
    return q / np.linalg.norm(q, axis=0)


@pytest.mark.parametrize("fn", ["quat_mul", "quat_rotate", "quat_integrate", "m3_from_quat",
                                "quat_to_rpy", "quat_normalize"])
def test_quaternion_ops(fn):
    qa, qb = _quats(seed=1), _quats(seed=2)
    w = np.random.default_rng(3).normal(size=(3, qa.shape[1])).astype(np.float32)
    J = lambda a: tuple(jnp.asarray(r) for r in a)  # noqa: E731
    T = lambda a: tuple(torch.from_numpy(r) for r in a)  # noqa: E731
    args = {
        "quat_mul": ((J(qa), J(qb)), (T(qa), T(qb))),
        "quat_rotate": ((J(qa), J(w)), (T(qa), T(w))),
        "quat_integrate": ((J(qa), J(w), 0.004125), (T(qa), T(w), 0.004125)),
        "m3_from_quat": ((J(qa),), (T(qa),)),
        "quat_to_rpy": ((J(qa),), (T(qa),)),
        "quat_normalize": ((J(2 * qa),), (T(2 * qa),)),
    }[fn]
    out_j = getattr(sm_j, fn)(*args[0])
    out_t = getattr(sm_t, fn)(*args[1])
    assert len(out_j) == len(out_t)
    for a, b in zip(out_j, out_t):
        _close(a, b)


def test_spatial_ops():
    rng = np.random.default_rng(4)
    a, b = (tuple(rng.normal(size=(3, 16)).astype(np.float32)) for _ in range(2))
    c, d = (tuple(rng.normal(size=(3, 16)).astype(np.float32)) for _ in range(2))
    J = lambda x: tuple(jnp.asarray(r) for r in x)  # noqa: E731
    T = lambda x: tuple(torch.from_numpy(r) for r in x)  # noqa: E731
    for fn in ("sv_cross_motion", "sv_cross_force"):
        rj = getattr(sm_j, fn)((J(a), J(b)), (J(c), J(d)))
        rt = getattr(sm_t, fn)((T(a), T(b)), (T(c), T(d)))
        for pj, pt in zip(rj, rt):
            for x, y in zip(pj, pt):
                _close(x, y)
    _close(sm_j.sv_dot((J(a), J(b)), (J(c), J(d))), sm_t.sv_dot((T(a), T(b)), (T(c), T(d))))
