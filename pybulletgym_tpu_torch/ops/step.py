"""Fused physics stepping: substep = dynamics + contacts + integrate.

Replaces the reference's `scene.global_step()` -> `p.stepSimulation()`
(one C++ call doing frame_skip substeps [ref: scene_bases.py · World.step]).
Torques are held constant across substeps, matching Bullet's motor semantics
[ref: robot_bases.py · Joint.set_motor_torque].

`make_physics_step_plain` is the plain PyTorch version of the physics
kernel (`ops.cuda_engine.make_cuda_physics_step`): the same loops as the
kernel body, on stacked batch-trailing tensors ``q (nq, B)``, ``v (nv, B)``,
``tau (nv, B)``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from pybulletgym_tpu_torch.models.schema import Model
from pybulletgym_tpu_torch.ops import contacts as ct
from pybulletgym_tpu_torch.ops import dynamics as dyn


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """Timing per the reference scene contract
    [ref: scene_bases.py · Scene]: walkers run
    fixedTimeStep=0.0165, numSubSteps=4 (physics dt 4.125 ms);
    pendula/manipulators run timestep=0.0165, frame_skip=1."""

    timestep: float = 0.0165 / 4
    frame_skip: int = 4
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.8)
    solver: ct.SolverConfig = dataclasses.field(default_factory=ct.SolverConfig)
    # Bullet clamps every multibody dof velocity to
    # btMultiBody::m_maxCoordinateVelocity = 100 (rad/s or m/s) each step;
    # without it an undamped pendulum spun up by random torque accelerates
    # until float32 absorption freezes the trajectory entirely.
    max_velocity: float = 100.0

    @property
    def control_dt(self) -> float:
        return self.timestep * self.frame_skip


def make_substep_scalar(model: Model, cfg: PhysicsConfig):
    """Scalar substep over SoA lists — the kernel body, in plain torch.

    Every loop (Cholesky, constraint rows, PGS iterations) runs in Python
    over the static model, with structural zeros pruned.

    substep(q_list, v_list, tau_list) -> (q', v', depths_list)
    """
    plan = ct.build_contact_plan(model, cfg.solver)
    lim = ct.build_limit_plan(model)

    def substep(q, v, tau):
        q, v = list(q), list(v)
        fk = dyn.forward_kinematics(model, q, v)
        rhs, L, inv_diag = dyn.rhs_and_factor(
            model, fk, q, v, list(tau), cfg.gravity
        )
        # square-root-space contact solve (see ct.solve_scalar): constraint
        # rows forward-solve only; ONE back substitution recovers v/vp.
        y_dyn = dyn.chol_solve_fwd(L, inv_diag, rhs)
        sc = ct.narrowphase_scalar(model, fk, plan)
        if sc is not None or lim is not None:
            zv = dyn.lt_matvec(L, v)
            z = []
            for d in range(model.nv):
                t = zv[d]
                if not _is0f(y_dyn[d]):
                    dy = cfg.timestep * y_dyn[d]
                    t = dy if _is0f(t) else t + dy
                z.append(t)
            y_rows = y_lim = None
            if sc is not None:
                J = ct.scalar_jacobians(model, fk, sc)
                y_rows = [
                    tuple(dyn.chol_solve_fwd(L, inv_diag, Jd) for Jd in row)
                    for row in J
                ]
            if lim is not None:
                y_lim = []
                for i in range(lim.dof.shape[0]):
                    e = [0.0] * model.nv
                    e[int(lim.dof[i])] = 1.0
                    y_lim.append(dyn.chol_solve_fwd(L, inv_diag, e))
            z3, zp, _ = ct.solve_scalar(
                model, cfg.solver, cfg.timestep, sc, y_rows, lim, y_lim, q, z
            )
            v3 = dyn.chol_solve_back(L, inv_diag, z3)
            vp = dyn.chol_solve_back(L, inv_diag, zp)
        else:
            qdd = dyn.chol_solve_back(L, inv_diag, y_dyn)
            v3 = [
                v[d] + cfg.timestep * qdd[d] if not _is0f(qdd[d]) else v[d]
                for d in range(model.nv)
            ]
            vp = [0.0] * model.nv
        v3 = [
            vd if _is0f(vd) else torch.clamp(vd, -cfg.max_velocity, cfg.max_velocity)
            for vd in v3
        ]
        v_pos = [
            v3[d] + vp[d] if not _is0f(vp[d]) else v3[d] for d in range(model.nv)
        ]
        q2 = dyn.integrate(model, q, v_pos, cfg.timestep)
        depths = list(sc.depth) if sc is not None else []
        return q2, v3, depths

    return substep, plan, (len(sc_rows(plan)))


def sc_rows(plan):
    floor_cands, pair_cands = plan
    out = []
    for c in floor_cands:
        out.extend([c] * (4 if c.kind == "disk" else 1))
    out.extend(pair_cands)
    return out


def _is0f(x):
    return isinstance(x, float) and x == 0.0


def make_physics_step_plain(model: Model, cfg: PhysicsConfig):
    """Control step: frame_skip substeps with held torques, on stacked
    tensors. Returns the LAST substep's contact depths, as the kernel does.

    step(q (nq,B), v (nv,B), tau (nv,B)) -> (q', v', depths (R,B))
    """
    substep, plan, n_rows = make_substep_scalar(model, cfg)

    def step(q, v, tau):
        q_s = [q[i] for i in range(model.nq)]
        v_s = [v[i] for i in range(model.nv)]
        tau_s = [tau[i] for i in range(model.nv)]
        depths = [torch.zeros_like(q_s[0])] * n_rows
        for _ in range(cfg.frame_skip):
            q_s, v_s, depths = substep(q_s, v_s, tau_s)
        d = torch.stack(list(depths), 0) if n_rows else q.new_zeros((0, q.shape[-1]))
        return torch.stack(list(q_s), 0), torch.stack(list(v_s), 0), d

    return step, plan, n_rows
