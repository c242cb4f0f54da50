"""Generalized-coordinate rigid-body dynamics, looped over static topology.

Torch counterpart of the scalar path of the JAX package's `ops.dynamics`
(the Pallas kernel body): world-frame spatial algebra,

  FK -> per-dof motion subspaces S (Plucker vectors at the world origin)
     -> body spatial velocities -> CRBA mass matrix M + RNE bias forces C
     -> dense Cholesky -> qdd.

Everything operates on *lists of scalar leaves* (see `ops.smath`): `q` is a
list of nq tensors, `v`/`tau` lists of nv tensors, each of identical batch
shape. The Python loops run over the static `Model`; structural zeros stay
the Python float 0.0 (`_is0`/`_madd`), so only the non-zero sparsity pattern
of the kinematic tree is computed — and every sum is taken in the same order
as in the JAX package. The CUDA core (`csrc/engine_core.h`) runs the same
loops over packed tables, where a structural zero is a stored 0 that adds
nothing.

The packed XLA path of the JAX module (`pack_S`, `crba_packed`,
`bias_packed`, batched `factorize`/`solve_*`) is not ported.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from pybulletgym_tpu_torch.models.schema import JointType, Model
from pybulletgym_tpu_torch.ops import smath as sm

# ---------------------------------------------------------------------------
# sparsity helpers: structural zeros are the Python float 0.0
# ---------------------------------------------------------------------------


def _is0(x) -> bool:
    return isinstance(x, float) and x == 0.0


def _mul(a, b):
    if _is0(a) or _is0(b):
        return 0.0
    return a * b


def _add(a, b):
    if _is0(a):
        return b
    if _is0(b):
        return a
    return a + b


def _madd(acc, a, b):
    return _add(acc, _mul(a, b))


class FK(NamedTuple):
    """Forward-kinematics products, all in world frame."""

    R: list          # per body: Mat3 (body->world rotation)
    p: list          # per body: Vec3 (body frame origin)
    S: list          # per dof: motion (ang, lin) at world origin
    vel: list        # per body: spatial velocity (ang, lin@origin)
    com: list        # per body: world COM Vec3
    inertia: list    # per body: origin-frame spatial inertia (m, h, I_o)


def _const_v3(a: np.ndarray):
    return (float(a[0]), float(a[1]), float(a[2]))


def _const_m3(a: np.ndarray):
    return tuple(float(x) for x in np.asarray(a).reshape(-1))


def _rodrigues(u, theta):
    """Rotation matrix about unit axis u (Vec3 of consts or scalars) by
    angle theta (a tensor): R = I + sin θ [u]× + (1−cos θ)[u]×²."""
    s = torch.sin(theta)
    c = 1.0 - torch.cos(theta)
    ux, uy, uz = u
    return (
        1.0 - c * (uy * uy + uz * uz), -s * uz + c * ux * uy, s * uy + c * ux * uz,
        s * uz + c * ux * uy, 1.0 - c * (ux * ux + uz * uz), -s * ux + c * uy * uz,
        -s * uy + c * ux * uz, s * ux + c * uy * uz, 1.0 - c * (ux * ux + uy * uy),
    )


def forward_kinematics(model: Model, q: Sequence, v: Sequence, with_inertia: bool = True) -> FK:
    """World-frame FK + motion subspaces + body velocities.

    Matches what Bullet recomputes inside stepSimulation and exposes via
    getLinkState/getBasePositionAndOrientation
    [ref: robot_bases.py · BodyPart.pose/speed].
    """
    nb = len(model.bodies)
    R: List = [None] * nb
    P: List = [None] * nb
    S: List = [None] * model.nv
    VEL: List = [None] * nb
    COM: List = [None] * nb
    IN: List = [None] * nb
    like = q[0]

    for i, b in enumerate(model.bodies):
        if b.parent == -1:
            Rp = sm.m3_identity(like)
            pp = sm.v3_zero(like)
            vp = sm.sv_zero(like)
        else:
            Rp, pp, vp = R[b.parent], P[b.parent], VEL[b.parent]

        # static frame offset from parent
        off_r = _const_m3(_quat_np_to_mat(b.quat))
        off_p = _const_v3(b.pos)
        R0 = sm.m3_mul(Rp, off_r)
        p0 = sm.v3_add(pp, sm.m3_vec(Rp, off_p))

        if b.jtype == JointType.HINGE:
            th = q[b.q_adr] - b.jref
            a = sm.v3_add(p0, sm.m3_vec(R0, _const_v3(b.jpos)))
            u = sm.m3_vec(R0, _const_v3(b.jaxis))
            Rj = _rodrigues(u, th)
            Ri = sm.m3_mul(Rj, R0)
            pi = sm.v3_add(a, sm.m3_vec(Rj, sm.v3_sub(p0, a)))
            d = b.v_adr
            S[d] = (u, sm.v3_cross(a, u))
            vi = sm.sv_add(vp, sm.sv_scale(S[d], v[d]))
        elif b.jtype == JointType.SLIDE:
            u = sm.m3_vec(R0, _const_v3(b.jaxis))
            Ri = R0
            pi = sm.v3_add(p0, sm.v3_scale(u, q[b.q_adr] - b.jref))
            d = b.v_adr
            S[d] = (sm.v3_zero(like), u)
            vi = sm.sv_add(vp, sm.sv_scale(S[d], v[d]))
        else:  # FREE (root-level only, enforced by the MJCF loader)
            qa = b.q_adr
            pi = (q[qa], q[qa + 1], q[qa + 2])
            quat = (q[qa + 3], q[qa + 4], q[qa + 5], q[qa + 6])
            Ri = sm.m3_from_quat(quat)
            cols = (
                (Ri[0], Ri[3], Ri[6]),
                (Ri[1], Ri[4], Ri[7]),
                (Ri[2], Ri[5], Ri[8]),
            )
            vi = vp
            for k in range(3):  # angular dofs (body-frame components)
                d = b.v_adr + k
                S[d] = (cols[k], sm.v3_cross(pi, cols[k]))
                vi = sm.sv_add(vi, sm.sv_scale(S[d], v[d]))
            for k in range(3):  # linear dofs (body-frame components)
                d = b.v_adr + 3 + k
                S[d] = (sm.v3_zero(like), cols[k])
                vi = sm.sv_add(vi, sm.sv_scale(S[d], v[d]))

        R[i], P[i], VEL[i] = Ri, pi, vi

        if b.mass > 0.0:
            com_w = sm.v3_add(pi, sm.m3_vec(Ri, _const_v3(b.com)))
            COM[i] = com_w
            if with_inertia:
                ic_w = sm.m3_similarity(Ri, _const_m3(b.inertia))
                IN[i] = sm.inertia_from_body(float(b.mass), com_w, ic_w)
        else:
            COM[i] = pi
            if with_inertia:
                IN[i] = sm.inertia_zero(like)

    return FK(R, P, S, VEL, COM, IN)


def _quat_np_to_mat(qn: np.ndarray) -> np.ndarray:
    w, x, y, z = [float(t) for t in qn]
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


# ---------------------------------------------------------------------------
# RNE bias forces (C) — velocity products + gravity
# ---------------------------------------------------------------------------


def bias_forces(model: Model, fk: FK, gravity) -> List:
    """C(q, qd): per-dof bias torques, world-frame recursive Newton-Euler
    with the gravity trick (fictitious base acceleration of -g).

    gravity: 3-tuple of floats, e.g. (0, 0, -9.8) for the walkers
    [ref: scene_bases.py · Scene gravity=9.8], (0, 0, 0) for Reacher.
    """
    nb = len(model.bodies)
    like = fk.vel[0][0][0] if nb else None
    gx, gy, gz = (float(g) for g in gravity)
    a0 = (
        sm.v3_zero(like),
        (torch.full_like(like, -gx), torch.full_like(like, -gy), torch.full_like(like, -gz)),
    )

    avp: List = [None] * nb
    f: List = [None] * nb
    for i, b in enumerate(model.bodies):
        ap = a0 if b.parent == -1 else avp[b.parent]
        vi = fk.vel[i]
        # Σ_d S_d qd_d = v_i − v_parent
        parent_vel = fk.vel[b.parent] if b.parent != -1 else (sm.v3_zero(like), sm.v3_zero(like))
        vj = sm.sv_sub(vi, parent_vel)
        avp[i] = sm.sv_add(ap, sm.sv_cross_motion(vi, vj))
        hi = sm.inertia_mul(fk.inertia[i], vi)
        f[i] = sm.sv_add(sm.inertia_mul(fk.inertia[i], avp[i]), sm.sv_cross_force(vi, hi))

    # backward accumulation of subtree forces
    for i in range(nb - 1, -1, -1):
        p = model.bodies[i].parent
        if p != -1:
            f[p] = sm.sv_add(f[p], f[i])

    C = [None] * model.nv
    for i, b in enumerate(model.bodies):
        for d in model.body_dofs[i]:
            C[d] = sm.sv_dot(fk.S[d], f[i])
    return C


# ---------------------------------------------------------------------------
# CRBA mass matrix — lower triangle as list-of-lists of scalars
# ---------------------------------------------------------------------------


def mass_matrix(model: Model, fk: FK) -> List[List]:
    """Composite-rigid-body algorithm in the world-origin frame, where
    composite inertia addition is leafwise addition. Returns M as an nv×nv
    list-of-lists with the lower triangle populated (0.0 = structural zero).
    """
    nv = model.nv
    nb = len(model.bodies)
    Ic = list(fk.inertia)
    for i in range(nb - 1, -1, -1):
        p = model.bodies[i].parent
        if p != -1:
            Ic[p] = sm.inertia_add(Ic[p], Ic[i])

    M = [[0.0] * nv for _ in range(nv)]
    for i, b in enumerate(model.bodies):
        anc = model.ancestor_dofs[i]
        for d in model.body_dofs[i]:
            F = sm.inertia_mul(Ic[i], fk.S[d])
            for e in anc:
                if e <= d:
                    M[d][e] = sm.sv_dot(fk.S[e], F)
    for d in range(nv):
        arm = float(model.dof_armature[d])
        if arm != 0.0:
            M[d][d] = M[d][d] + arm
    return M


# ---------------------------------------------------------------------------
# dense unrolled Cholesky (scalar lists) + solves
# ---------------------------------------------------------------------------


def cholesky(M: List[List], eps: float = 1e-9):
    """Lower Cholesky of the CRBA matrix. Structural zeros are pruned
    while looping; fill-in appears only where the tree creates it."""
    n = len(M)
    L = [[0.0] * n for _ in range(n)]
    inv_diag = [0.0] * n
    for j in range(n):
        s = M[j][j]
        for k in range(j):
            s = _add(s, -_mul(L[j][k], L[j][k])) if not _is0(L[j][k]) else s
        djj = torch.sqrt(torch.clamp_min(s, eps))
        L[j][j] = djj
        inv_diag[j] = 1.0 / djj
        for i in range(j + 1, n):
            s = M[i][j] if i >= j else 0.0
            for k in range(j):
                if not (_is0(L[i][k]) or _is0(L[j][k])):
                    s = _add(s, -_mul(L[i][k], L[j][k]))
            if _is0(s):
                continue
            L[i][j] = s * inv_diag[j]
    return L, inv_diag


def chol_solve_fwd(L, inv_diag, b: Sequence):
    """Forward substitution y = L⁻¹ b. b: list of nv scalars (0.0 allowed
    as structural zero — leading zeros propagate, so a constraint row whose
    support starts deep in the tree costs only its subtree)."""
    n = len(L)
    y = [0.0] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            if not (_is0(L[i][k]) or _is0(y[k])):
                s = _add(s, -_mul(L[i][k], y[k]))
        y[i] = 0.0 if _is0(s) else s * inv_diag[i]
    return y


def chol_solve_back(L, inv_diag, y: Sequence):
    """Back substitution x = L⁻ᵀ y (structural zeros skipped)."""
    n = len(L)
    x = [0.0] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            if not (_is0(L[k][i]) or _is0(x[k])):
                s = _add(s, -_mul(L[k][i], x[k]))
        x[i] = 0.0 if _is0(s) else s * inv_diag[i]
    return x


def lt_matvec(L, v: Sequence):
    """z = Lᵀ v (lists; structural zeros skipped). The change of basis into
    Cholesky square-root space: constraint rows J satisfy J·v = (L⁻¹Jᵀ)ᵀz,
    so the whole PGS sweep can run on z with forward-solved rows only."""
    n = len(L)
    z = [0.0] * n
    for i in range(n):
        s = _mul(L[i][i], v[i]) if not _is0(v[i]) else 0.0
        for k in range(i + 1, n):
            if not (_is0(L[k][i]) or _is0(v[k])):
                s = _madd(s, L[k][i], v[k])
        z[i] = s
    return z


def chol_solve(L, inv_diag, b: Sequence):
    """Solve M x = b given L (lower) with M = L Lᵀ. b: list of nv scalars
    (0.0 allowed as structural zero)."""
    return chol_solve_back(L, inv_diag, chol_solve_fwd(L, inv_diag, b))


# ---------------------------------------------------------------------------
# passive forces + forward dynamics
# ---------------------------------------------------------------------------


def passive_forces(model: Model, q: Sequence, v: Sequence) -> List:
    """Per-dof passive torque: -damping*qd - stiffness*(q - springref).
    Mirrors the joint damping/stiffness Bullet reads from the MJCF
    [ref: BulletMJCFImporter; exercised via stepSimulation]."""
    taup = [0.0] * model.nv
    for i, b in enumerate(model.bodies):
        for d in model.body_dofs[i]:
            t = 0.0
            damp = float(model.dof_damping[d])
            if damp != 0.0:
                t = _add(t, -damp * v[d])
            stiff = float(model.dof_stiffness[d])
            if stiff != 0.0 and b.jtype != JointType.FREE:
                t = _add(t, -stiff * (q[b.q_adr] - float(model.dof_springref[d])))
            taup[d] = t
    return taup


def rhs_and_factor(model: Model, fk: FK, q, v, tau, gravity):
    """Unconstrained-dynamics RHS (tau + tau_passive − C) and the Cholesky
    factor of M, without solving — the square-root-space contact path
    forward-solves the RHS together with its constraint rows."""
    C = bias_forces(model, fk, gravity)
    taup = passive_forces(model, q, v)
    rhs = [
        _add(_add(tau[d] if not _is0(tau[d]) else 0.0, taup[d]), -C[d] if not _is0(C[d]) else 0.0)
        for d in range(model.nv)
    ]
    M = mass_matrix(model, fk)
    L, inv_diag = cholesky(M)
    return rhs, L, inv_diag


def fwd_dynamics(model: Model, fk: FK, q, v, tau, gravity):
    """qdd = M⁻¹ (tau + tau_passive − C). Returns (qdd, L, inv_diag) so the
    contact solver can reuse the factorization."""
    rhs, L, inv_diag = rhs_and_factor(model, fk, q, v, tau, gravity)
    qdd = chol_solve(L, inv_diag, rhs)
    return qdd, L, inv_diag


# ---------------------------------------------------------------------------
# semi-implicit Euler integration (Bullet's integrator
# [ref: scene_bases.py · World.step — fixedTimeStep/numSubSteps])
# ---------------------------------------------------------------------------


def integrate(model: Model, q: Sequence, v: Sequence, dt: float):
    """q' = q ⊕ dt·v (v already updated — semi-implicit). Free-joint
    orientation integrates by quaternion exponential map."""
    q2 = list(q)
    for b in model.bodies:
        if b.jtype == JointType.FREE:
            qa, va = b.q_adr, b.v_adr
            quat = (q[qa + 3], q[qa + 4], q[qa + 5], q[qa + 6])
            R = sm.m3_from_quat(quat)
            w_world = sm.m3_vec(R, (v[va], v[va + 1], v[va + 2]))
            v_world = sm.m3_vec(R, (v[va + 3], v[va + 4], v[va + 5]))
            q2[qa] = q[qa] + dt * v_world[0]
            q2[qa + 1] = q[qa + 1] + dt * v_world[1]
            q2[qa + 2] = q[qa + 2] + dt * v_world[2]
            nq = sm.quat_integrate(quat, w_world, dt)
            q2[qa + 3], q2[qa + 4], q2[qa + 5], q2[qa + 6] = nq
        else:
            q2[b.q_adr] = q[b.q_adr] + dt * v[b.v_adr]
    return q2
