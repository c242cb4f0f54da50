"""Structure-of-arrays scalar math: vectors/quaternions/matrices as tuples.

Torch counterpart of the JAX package's `ops.smath`, formula for formula, so
the plain engine rounds the same way. Every geometric object is a flat tuple
of *scalar leaves*; a "scalar" is a torch tensor of any batch shape (``(B,)``
in the plain engine) or a Python float. A ``Vec3`` is ``(x, y, z)``, a
``Quat`` is ``(w, x, y, z)`` (w first), a ``Mat3`` is a 9-tuple row-major.

Replaces the vector math Bullet does inside ``p.stepSimulation``
[ref: pybullet C++ (Bullet3 LinearMath), exercised via stepSimulation].
"""

from __future__ import annotations

import torch


# ---------------------------------------------------------------------------
# Vec3 — tuples (x, y, z)
# ---------------------------------------------------------------------------


def v3(x, y, z):
    return (x, y, z)


def v3_zero(like):
    z = torch.zeros_like(like)
    return (z, z, z)


def v3_add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def v3_sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def v3_neg(a):
    return (-a[0], -a[1], -a[2])


def v3_scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def v3_mul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def v3_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def v3_cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def v3_norm2(a):
    return v3_dot(a, a)


def v3_norm(a, eps=0.0):
    return torch.sqrt(v3_norm2(a) + eps)


def v3_normalize(a, eps=1e-12):
    inv = 1.0 / v3_norm(a, eps)
    return v3_scale(a, inv)


def v3_lerp(a, b, t):
    return v3_add(a, v3_scale(v3_sub(b, a), t))


def v3_where(c, a, b):
    return (torch.where(c, a[0], b[0]), torch.where(c, a[1], b[1]), torch.where(c, a[2], b[2]))


# ---------------------------------------------------------------------------
# Quat — tuples (w, x, y, z)
# ---------------------------------------------------------------------------


def quat_identity(like):
    o = torch.ones_like(like)
    z = torch.zeros_like(like)
    return (o, z, z, z)


def quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    )


def quat_conj(q):
    return (q[0], -q[1], -q[2], -q[3])


def quat_normalize(q, eps=1e-12):
    n = torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3] + eps)
    inv = 1.0 / n
    return (q[0] * inv, q[1] * inv, q[2] * inv, q[3] * inv)


def quat_rotate(q, v):
    """Rotate Vec3 v by quaternion q (active rotation, body->world if q is
    the body orientation)."""
    w, x, y, z = q
    # t = 2 * cross(q.xyz, v)
    tx = 2.0 * (y * v[2] - z * v[1])
    ty = 2.0 * (z * v[0] - x * v[2])
    tz = 2.0 * (x * v[1] - y * v[0])
    # v' = v + w*t + cross(q.xyz, t)
    return (
        v[0] + w * tx + (y * tz - z * ty),
        v[1] + w * ty + (z * tx - x * tz),
        v[2] + w * tz + (x * ty - y * tx),
    )


def quat_rotate_inv(q, v):
    return quat_rotate(quat_conj(q), v)


def quat_from_axis_angle(axis, angle):
    """axis: Vec3 (unit), angle: scalar."""
    half = 0.5 * angle
    s = torch.sin(half)
    return (torch.cos(half), axis[0] * s, axis[1] * s, axis[2] * s)


def quat_integrate(q, omega, dt):
    """Integrate orientation by angular velocity `omega` (world frame, Vec3)
    over dt using the exponential map: q' = exp(dt/2 * omega) * q."""
    ang = v3_scale(omega, dt)
    theta2 = v3_norm2(ang)
    theta = torch.sqrt(theta2 + 1e-20)
    half = 0.5 * theta
    # sin(half)/theta, series-safe for small theta
    k = torch.where(theta2 > 1e-12, torch.sin(half) / theta, 0.5 - theta2 / 48.0)
    dq = (torch.cos(half), ang[0] * k, ang[1] * k, ang[2] * k)
    return quat_normalize(quat_mul(dq, q))


def quat_to_rpy(q):
    """Quaternion -> (roll, pitch, yaw), XYZ-extrinsic convention matching
    pybullet's getEulerFromQuaternion [ref: robot_bases.py · Pose_Helper.rpy]."""
    w, x, y, z = q
    sinr = 2.0 * (w * x + y * z)
    cosr = 1.0 - 2.0 * (x * x + y * y)
    roll = torch.atan2(sinr, cosr)
    sinp = torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0)
    pitch = torch.asin(sinp)
    siny = 2.0 * (w * z + x * y)
    cosy = 1.0 - 2.0 * (y * y + z * z)
    yaw = torch.atan2(siny, cosy)
    return roll, pitch, yaw


# ---------------------------------------------------------------------------
# Branchless polynomial transcendentals (Cephes atanf scheme, f32-accurate to
# ~1e-7), copied exactly from the JAX package so the observations agree with
# it; torch.atan2 would differ in the last bits. The CUDA core has the same.
# ---------------------------------------------------------------------------

_PI = 3.141592653589793
_PI_2 = 1.5707963267948966
_PI_4 = 0.7853981633974483


def atan(x):
    """Branchless single-precision arctangent (Cephes atanf ranges)."""
    ax = torch.abs(x)
    # range reduction
    big = ax > 2.414213562373095    # tan(3π/8)
    mid = ax > 0.4142135623730950   # tan(π/8)
    z = torch.where(big, -1.0 / torch.where(ax > 1e-30, ax, 1e-30),
                  torch.where(mid, (ax - 1.0) / (ax + 1.0), ax))
    off = torch.where(big, _PI_2, torch.where(mid, _PI_4, 0.0))
    zz = z * z
    y = (
        ((8.05374449538e-2 * zz - 1.38776856032e-1) * zz + 1.99777106478e-1) * zz
        - 3.33329491539e-1
    ) * zz * z + z
    return torch.sign(x) * (off + y)


def atan2(y, x):
    """Branchless atan2 (matches atan2 to ~1e-6 in f32)."""
    safe_x = torch.where(torch.abs(x) > 1e-30, x, 1e-30)
    base = atan(y / safe_x)
    shift = torch.where(
        x < 0.0, torch.where(y >= 0.0, _PI, -_PI), 0.0
    )
    out = base + shift
    # x == 0 exactly: ±π/2 by the sign of y
    tiny_x = torch.abs(x) <= 1e-30
    return torch.where(tiny_x, torch.where(y >= 0.0, _PI_2, -_PI_2), out)


def asin(x):
    """arcsin via atan2 (clamped)."""
    xc = torch.clamp(x, -1.0, 1.0)
    return atan2(xc, torch.sqrt(torch.clamp_min(1.0 - xc * xc, 0.0)))


def isfinite(x):
    """Finiteness check, same formula as the JAX package and the CUDA core."""
    return (x == x) & (torch.abs(x) < 3.0e38)


# ---------------------------------------------------------------------------
# Mat3 — 9-tuples, row-major (m00, m01, m02, m10, ..., m22)
# ---------------------------------------------------------------------------


def m3_identity(like):
    o = torch.ones_like(like)
    z = torch.zeros_like(like)
    return (o, z, z, z, o, z, z, z, o)


def m3_from_quat(q):
    w, x, y, z = q
    x2, y2, z2 = x + x, y + y, z + z
    xx, yy, zz = x * x2, y * y2, z * z2
    xy, xz, yz = x * y2, x * z2, y * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    return (
        1.0 - (yy + zz), xy - wz, xz + wy,
        xy + wz, 1.0 - (xx + zz), yz - wx,
        xz - wy, yz + wx, 1.0 - (xx + yy),
    )


def m3_vec(m, v):
    return (
        m[0] * v[0] + m[1] * v[1] + m[2] * v[2],
        m[3] * v[0] + m[4] * v[1] + m[5] * v[2],
        m[6] * v[0] + m[7] * v[1] + m[8] * v[2],
    )


def m3_tvec(m, v):
    """Transpose(m) @ v."""
    return (
        m[0] * v[0] + m[3] * v[1] + m[6] * v[2],
        m[1] * v[0] + m[4] * v[1] + m[7] * v[2],
        m[2] * v[0] + m[5] * v[1] + m[8] * v[2],
    )


def m3_mul(a, b):
    return (
        a[0] * b[0] + a[1] * b[3] + a[2] * b[6],
        a[0] * b[1] + a[1] * b[4] + a[2] * b[7],
        a[0] * b[2] + a[1] * b[5] + a[2] * b[8],
        a[3] * b[0] + a[4] * b[3] + a[5] * b[6],
        a[3] * b[1] + a[4] * b[4] + a[5] * b[7],
        a[3] * b[2] + a[4] * b[5] + a[5] * b[8],
        a[6] * b[0] + a[7] * b[3] + a[8] * b[6],
        a[6] * b[1] + a[7] * b[4] + a[8] * b[7],
        a[6] * b[2] + a[7] * b[5] + a[8] * b[8],
    )


def m3_transpose(m):
    return (m[0], m[3], m[6], m[1], m[4], m[7], m[2], m[5], m[8])


def m3_add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def m3_sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def m3_scale(a, s):
    return tuple(x * s for x in a)


def m3_outer(a, b):
    """a b^T for Vec3 a, b."""
    return (
        a[0] * b[0], a[0] * b[1], a[0] * b[2],
        a[1] * b[0], a[1] * b[1], a[1] * b[2],
        a[2] * b[0], a[2] * b[1], a[2] * b[2],
    )


def m3_diag(d0, d1, d2, like=None):
    z = torch.zeros_like(d0) if like is None else torch.zeros_like(like)
    return (d0 + z, z, z, z, d1 + z, z, z, z, d2 + z)


def m3_similarity(r, m):
    """R @ M @ R^T — rotate a symmetric 3x3 (e.g. inertia) into world frame."""
    return m3_mul(r, m3_mul(m, m3_transpose(r)))


# ---------------------------------------------------------------------------
# Spatial (Plucker) vectors at the WORLD ORIGIN.
#   motion m = (ang ω, lin v_o): v_o is the velocity of the body-fixed point
#     coincident with the world origin.
#   force  f = (ang n_o, lin f): n_o is the moment about the world origin.
# Replaces Bullet's btMultiBody spatial algebra
# [ref: pybullet C++ btMultiBody, exercised via stepSimulation].
# ---------------------------------------------------------------------------


def sv_zero(like):
    return (v3_zero(like), v3_zero(like))


def sv_add(a, b):
    return (v3_add(a[0], b[0]), v3_add(a[1], b[1]))


def sv_sub(a, b):
    return (v3_sub(a[0], b[0]), v3_sub(a[1], b[1]))


def sv_scale(a, s):
    return (v3_scale(a[0], s), v3_scale(a[1], s))


def sv_dot(a, b):
    """Motion·force pairing: ω·n_o + v_o·f (order-agnostic)."""
    return v3_dot(a[0], b[0]) + v3_dot(a[1], b[1])


def sv_cross_motion(v, m):
    """Spatial motion cross product v ×̂ m (both motions).

    [ω v]× [mω mv] = (ω × mω,  ω × mv + v × mω)
    """
    return (
        v3_cross(v[0], m[0]),
        v3_add(v3_cross(v[0], m[1]), v3_cross(v[1], m[0])),
    )


def sv_cross_force(v, f):
    """Spatial force cross product v ×̂* f.

    [ω v]×* [n f] = (ω × n + v × f,  ω × f)
    """
    return (
        v3_add(v3_cross(v[0], f[0]), v3_cross(v[1], f[1])),
        v3_cross(v[0], f[1]),
    )


# ---------------------------------------------------------------------------
# Spatial inertia about the world origin, stored as (m, h, I_o) where
#   m   : total mass (scalar)
#   h   : m * com (Vec3, first mass moment about origin)
#   I_o : 3x3 rotational inertia about the world origin (Mat3)
# Composite (CRBA) addition is leafwise addition in this representation.
# ---------------------------------------------------------------------------


def inertia_zero(like):
    z = torch.zeros_like(like)
    return (z, v3_zero(like), m3_scale(m3_identity(like), z))


def inertia_add(a, b):
    return (a[0] + b[0], v3_add(a[1], b[1]), m3_add(a[2], b[2]))


def inertia_mul(I, v):
    """Apply spatial inertia to a motion vector: returns a force vector.

    h_ang@o = I_o ω + h × v_o
    h_lin   = m v_o - h × ω
    """
    m, h, I_o = I
    omega, vo = v
    n = v3_add(m3_vec(I_o, omega), v3_cross(h, vo))
    f = v3_sub(v3_scale(vo, m), v3_cross(h, omega))
    return (n, f)


def inertia_from_body(mass, com_w, ic_w):
    """Build origin-frame spatial inertia from mass, world COM position and
    world-frame rotational inertia about the COM (Mat3).

    I_o = I_c + m (|c|² E − c cᵀ)   (parallel-axis to the origin)
    """
    c = com_w
    c2 = v3_dot(c, c)
    para = m3_sub(m3_diag(c2, c2, c2), m3_outer(c, c))
    return (mass, v3_scale(c, mass), m3_add(ic_w, m3_scale(para, mass)))
