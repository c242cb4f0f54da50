"""Threefry-2x32 in the port is bitwise equal to the JAX package's, over a
grid of (seed, stream, env_id, epoch) that includes 0 and 2^32-1."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pybulletgym_tpu.ops import rand as rand_j
from pybulletgym_tpu_torch.ops import rand as rand_t

EDGE = [0, 1, 7, 1234, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]


def _grid():
    g = np.array(list(itertools.product(EDGE, [0, 1, 5, 100], range(0, 1 << 20, 99991),
                                        EDGE)), dtype=np.uint64)
    return [g[:, k].astype(np.uint32) for k in range(4)]


def _t(x):
    return torch.from_numpy(x.astype(np.int64))


def _j(x):
    return jnp.asarray(x, jnp.uint32)


def test_threefry_bitwise():
    seed, stream, env, epoch = _grid()
    j0, j1 = rand_j.threefry2x32(_j(seed), _j(stream), _j(env), _j(epoch))
    t0, t1 = rand_t.threefry2x32(_t(seed), _t(stream), _t(env), _t(epoch))
    np.testing.assert_array_equal(np.asarray(j0).astype(np.int64), t0.numpy())
    np.testing.assert_array_equal(np.asarray(j1).astype(np.int64), t1.numpy())


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.1, 0.1), (-2.5, 7.0)])
def test_uniform_bitwise(lo, hi):
    seed, stream, env, epoch = _grid()
    uj = np.asarray(rand_j.uniform(_j(seed), _j(stream), _j(env), _j(epoch), lo, hi))
    # uint32 tensors, as EnvState holds seed and epoch
    ut = rand_t.uniform(torch.from_numpy(seed), _t(stream),
                        torch.from_numpy(env.astype(np.int32)),
                        torch.from_numpy(epoch), lo, hi)
    assert ut.dtype == torch.float32
    np.testing.assert_array_equal(uj.view(np.uint32), ut.numpy().view(np.uint32))


@pytest.mark.parametrize("n", [2, 7, 1000])
def test_randint_bitwise(n):
    seed, stream, env, epoch = _grid()
    rj = np.asarray(rand_j.randint(_j(seed), _j(stream), _j(env), _j(epoch), n))
    rt = rand_t.randint(_t(seed), _t(stream), _t(env), _t(epoch), n)
    assert rt.dtype == torch.int32
    np.testing.assert_array_equal(rj, rt.numpy())


def test_python_int_inputs():
    """Scalars as Python ints (streams are static ints in the tasks)."""
    j = np.asarray(rand_j.uniform(jnp.uint32(2**32 - 1), 3, jnp.uint32(5), jnp.uint32(0)))
    t = rand_t.uniform(2**32 - 1, 3, 5, 0)
    assert j.view(np.uint32) == t.numpy().view(np.uint32)
