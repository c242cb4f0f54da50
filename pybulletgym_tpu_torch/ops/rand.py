"""Counter-based stateless PRNG (Threefry-2x32, 20 rounds), bitwise equal to
the JAX package's `ops.rand` for every (seed, stream, env_id, epoch).

Torch has no `+`, `<<`, `>>` or `%` on uint32 tensors, so the words are
carried in int64 and masked to 32 bits after every operation that can
overflow. Inputs may be Python ints or integer tensors of any dtype; the
value depends only on the four counters, never on execution order.
"""

from __future__ import annotations

import torch

_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF


def _u32(x) -> torch.Tensor:
    """Any integer input -> int64 tensor holding its uint32 value."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(int(x) & _M32, dtype=torch.int64)
    return x.to(torch.int64) & _M32


def _rotl(x, d):
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds. Returns two int64 tensors of uint32 words."""
    k0, k1 = _u32(k0), _u32(k1)
    x0 = (_u32(c0) + k0) & _M32
    x1 = (_u32(c1) + k1) & _M32
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    for block in range(5):
        rots = _ROT_A if block % 2 == 0 else _ROT_B
        for r in rots:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        inj = block + 1
        x0 = (x0 + ks[inj % 3]) & _M32
        x1 = (x1 + ks[(inj + 1) % 3] + inj) & _M32
    return x0, x1


def _bits(seed, stream, env_id, epoch):
    r0, _ = threefry2x32(seed, stream, env_id, epoch)
    return r0


def uniform(seed, stream, env_id, epoch, lo=0.0, hi=1.0):
    """U[lo, hi) float32 — 24-bit mantissa uniforms from one threefry call."""
    b = _bits(seed, stream, env_id, epoch)
    u = (b >> 8).to(torch.int32).to(torch.float32) * (2.0 ** -24)
    return lo + (hi - lo) * u


_GOLDEN = 2654435761
_HASH = 0x9E3779B9


def _mul32(x, k: int):
    """x * k mod 2^32 for a uint32 word x (int64) and a 32-bit constant k,
    in 16-bit halves of k so that no int64 product overflows."""
    lo = x * (k & 0xFFFF)
    hi = (x * (k >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def hash_epoch(epoch, count):
    """The per-draw counter of Flagrun's flags and FlagrunHarder's cube:
    epoch * 2654435761 + uint32(int32(count)) * 0x9E3779B9, mod 2^32
    (count is a float32 tensor, truncated to int32 first)."""
    c = count.to(torch.int32).to(torch.int64) & _M32
    return (_mul32(_u32(epoch), _GOLDEN) + _mul32(c, _HASH)) & _M32


def randint(seed, stream, env_id, epoch, n):
    """Uniform int32 in [0, n) (n is a static Python int)."""
    return (_bits(seed, stream, env_id, epoch) % int(n)).to(torch.int32)
