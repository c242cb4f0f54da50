"""Static model schema: the compile-time output of the MJCF loader.

A `Model` is frozen host-side data (Python ints, tuples, numpy arrays),
identical to the JAX package's schema. The plain torch engine loops over it
in Python, pruning structural zeros; `ops.cuda_engine.pack_tables` flattens
it into the fixed-size tables the CUDA kernels read. This is the analog of
Bullet's in-memory `btMultiBody` + collision-shape structures built by
`p.loadMJCF` [ref: robot_bases.py · MJCFBasedRobot.reset].
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Tuple

import numpy as np


class JointType(enum.IntEnum):
    FREE = 0   # 7 qpos (3 pos + wxyz quat), 6 dof ([ang_body, lin_body])
    HINGE = 1  # 1 qpos, 1 dof
    SLIDE = 2  # 1 qpos, 1 dof


class GeomType(enum.IntEnum):
    PLANE = 0
    SPHERE = 1
    CAPSULE = 2   # size = (radius, half_length), axis = local +z
    CYLINDER = 3  # size = (radius, half_length), axis = local +z
    BOX = 4       # size = (hx, hy, hz)


@dataclasses.dataclass(frozen=True)
class Body:
    """One body with exactly one joint (multi-joint MJCF bodies are expanded
    into chains of massless pseudo-bodies; jointless bodies are welded into
    their parent at build time)."""

    name: str
    parent: int                  # index into Model.bodies, -1 = world
    jtype: JointType
    # Frame offset from the parent body frame (applied before the joint).
    pos: np.ndarray              # (3,)
    quat: np.ndarray             # (4,) wxyz
    # Joint anchor/axis in this body's own (zero-configuration) frame.
    jpos: np.ndarray             # (3,)
    jaxis: np.ndarray            # (3,) unit; unused for FREE
    jref: float                  # MJCF joint `ref`: displacement = q - ref
    q_adr: int
    v_adr: int
    # Mass properties in the body frame.
    mass: float
    com: np.ndarray              # (3,)
    inertia: np.ndarray          # (3,3) rotational inertia about the COM


@dataclasses.dataclass(frozen=True)
class Geom:
    name: str
    body: int                    # -1 = world-attached (static)
    gtype: GeomType
    size: np.ndarray             # type-dependent, see GeomType
    pos: np.ndarray              # (3,) in body frame
    quat: np.ndarray             # (4,) wxyz in body frame
    friction: float              # sliding friction coefficient
    contype: int
    conaffinity: int


@dataclasses.dataclass(frozen=True)
class Actuator:
    name: str
    joint: str
    v_adr: int                   # dof index the motor drives
    gear: float
    ctrlrange: Tuple[float, float]


@dataclasses.dataclass(frozen=True)
class Model:
    name: str
    bodies: Tuple[Body, ...]
    nq: int
    nv: int
    qpos0: np.ndarray            # (nq,) reference configuration
    # Per-dof parameters (hinge/slide dofs; free dofs get zeros).
    dof_armature: np.ndarray     # (nv,)
    dof_damping: np.ndarray      # (nv,)
    dof_stiffness: np.ndarray    # (nv,)
    dof_springref: np.ndarray    # (nv,)
    jnt_limited: np.ndarray      # (nv,) bool
    jnt_range: np.ndarray        # (nv, 2) radians/meters
    geoms: Tuple[Geom, ...]
    actuators: Tuple[Actuator, ...]
    # Original MJCF body frames that survive weld-merging, for observation
    # code that needs "link" positions: name -> (host body idx, pos, quat).
    frames: Dict[str, Tuple[int, np.ndarray, np.ndarray]]
    sites: Dict[str, Tuple[int, np.ndarray, np.ndarray]]
    # Option block (recorded; the env layer overrides timing per the
    # reference scene contract [ref: scene_bases.py · Scene]).
    opt_timestep: float
    opt_gravity: np.ndarray      # (3,)

    # ---- derived topology helpers (filled by the MJCF loader) ----
    body_dofs: Tuple[Tuple[int, ...], ...] = ()      # dofs of each body
    ancestor_dofs: Tuple[Tuple[int, ...], ...] = ()  # dofs on root path, incl own
    joint_names: Tuple[str, ...] = ()                # per hinge/slide dof
    dof_body: Tuple[int, ...] = ()                   # body index per dof

    def body_index(self, name: str) -> int:
        for i, b in enumerate(self.bodies):
            if b.name == name:
                return i
        raise KeyError(name)

    def geom_index(self, name: str) -> int:
        for i, g in enumerate(self.geoms):
            if g.name == name:
                return i
        raise KeyError(name)

    def dof_index(self, joint_name: str) -> int:
        return self.joint_names.index(joint_name)

    @property
    def hinge_slide_dofs(self) -> Tuple[int, ...]:
        return tuple(
            d
            for b in self.bodies
            if b.jtype != JointType.FREE
            for d in self.body_dofs[self.bodies.index(b)]
        )

    def replace(self, **kw) -> "Model":
        return dataclasses.replace(self, **kw)
