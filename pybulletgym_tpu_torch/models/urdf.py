"""URDF importer (torch port, numpy only): Bullet's `p.loadURDF`
[ref: robot_bases.py · URDFBasedRobot — used by the Atlas env, SURVEY §2.2].

A copy of the JAX package's `models/urdf.py`. Front-end only: parses the
URDF link/joint graph into the same `_RawBody` tree the MJCF importer
produces, then reuses `mjcf._build` (expansion, weld-merging, address
assignment). Supported:

* joints: revolute, continuous, prismatic, fixed (weld-merged),
  floating (free root); planar/ball are rejected.
* geometry: box, sphere, cylinder, capsule (Bullet URDF extension);
  meshes are skipped (a geom-less link is fine) — URDF `<inertial>`
  masses are explicit and override geom-derived ones.
* one actuator per movable joint, gear = `<limit effort>` (URDF has no
  actuator section; the reference drives URDF robots through the same
  torque motors as MJCF ones [ref: Joint.set_motor_torque]).
"""

from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from pybulletgym_tpu_torch.models.mjcf import (
    _RawBody, _RawGeom, _RawJoint, _build, _nq_from_axis_angle, _nq_mul,
    _nq_to_mat,
)
from pybulletgym_tpu_torch.models.schema import Model


def _floats(s, default=None):
    if s is None:
        return None if default is None else np.asarray(default, float)
    return np.array([float(x) for x in s.replace(",", " ").split()])


def _rpy_quat(rpy) -> np.ndarray:
    r, p, y = (float(x) for x in rpy)
    qx = _nq_from_axis_angle([1, 0, 0], r)
    qy = _nq_from_axis_angle([0, 1, 0], p)
    qz = _nq_from_axis_angle([0, 0, 1], y)
    # URDF rpy is extrinsic x-y-z: R = Rz Ry Rx
    return _nq_mul(qz, _nq_mul(qy, qx))


def _origin(elem) -> tuple:
    o = elem.find("origin") if elem is not None else None
    if o is None:
        return np.zeros(3), np.array([1.0, 0, 0, 0])
    xyz = _floats(o.get("xyz"), [0, 0, 0])
    rpy = _floats(o.get("rpy"), [0, 0, 0])
    return xyz, _rpy_quat(rpy)


def _geom_from_collision(col, name: str, index: int) -> Optional[_RawGeom]:
    g = col.find("geometry")
    if g is None:
        return None
    pos, quat = _origin(col)
    for shape in g:
        attrs = {"name": name, "pos": " ".join(map(str, pos))}
        if shape.tag == "box":
            size = _floats(shape.get("size"), [0.1, 0.1, 0.1]) / 2.0
            attrs.update(type="box", size=" ".join(map(str, size)))
        elif shape.tag == "sphere":
            attrs.update(type="sphere", size=shape.get("radius", "0.05"))
        elif shape.tag in ("cylinder", "capsule"):
            r = float(shape.get("radius", "0.05"))
            hl = float(shape.get("length", "0.1")) / 2.0
            attrs.update(type=shape.tag, size=f"{r} {hl}")
        elif shape.tag == "mesh":
            return None  # collision meshes unsupported (the roster needs none)
        else:
            return None
        raw = _RawGeom(attrs, deg2rad=1.0, index=index)
        raw.quat = quat / np.linalg.norm(quat)
        return raw
    return None


def _inertial(link) -> Optional[tuple]:
    ine = link.find("inertial")
    if ine is None:
        return None
    mass = float(ine.find("mass").get("value")) if ine.find("mass") is not None else 0.0
    com, quat = _origin(ine)
    I = np.zeros((3, 3))
    it = ine.find("inertia")
    if it is not None:
        ixx = float(it.get("ixx", "0")); iyy = float(it.get("iyy", "0"))
        izz = float(it.get("izz", "0")); ixy = float(it.get("ixy", "0"))
        ixz = float(it.get("ixz", "0")); iyz = float(it.get("iyz", "0"))
        I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    R = _nq_to_mat(quat)
    return mass, com, R @ I @ R.T


_JOINT_MAP = {"revolute": "hinge", "continuous": "hinge",
              "prismatic": "slide", "floating": "free"}


def parse_urdf(xml_string: str, name: Optional[str] = None,
               root_free: bool = False,
               root_pos=(0.0, 0.0, 0.0)) -> Model:
    """Build a Model from URDF text. `root_free=True` mounts the root link
    on a free joint (Bullet's useFixedBase=False default for loadURDF);
    `root_pos` is the spawn position of the root link (the reference passes
    basePosition to p.loadURDF [ref: robot_bases.py · URDFBasedRobot.reset])."""
    robot = ET.fromstring(xml_string)
    if robot.tag != "robot":
        raise ValueError("not a URDF <robot> document")

    links: Dict[str, ET.Element] = {
        l.get("name"): l for l in robot.findall("link")
    }
    joints = robot.findall("joint")
    child_of: Dict[str, ET.Element] = {}
    children_of: Dict[str, List[ET.Element]] = {}
    for j in joints:
        parent = j.find("parent").get("link")
        child = j.find("child").get("link")
        child_of[child] = j
        children_of.setdefault(parent, []).append(j)

    roots = [n for n in links if n not in child_of]
    if len(roots) != 1:
        raise ValueError(f"URDF must have exactly one root link, got {roots}")

    gcount = [0]
    acount = [0]
    actuators_raw = []

    def make_body(link_name: str, pos, quat, joint: Optional[ET.Element]) -> _RawBody:
        raw = _RawBody(link_name, pos, quat)
        link = links[link_name]
        raw.inertial = _inertial(link)
        for i, col in enumerate(link.findall("collision")):
            g = _geom_from_collision(
                col, col.get("name", f"{link_name}_col{i}"), gcount[0]
            )
            gcount[0] += 1
            if g is not None:
                raw.geoms.append(g)

        if joint is not None:
            jtype = joint.get("type")
            if jtype != "fixed":
                if jtype not in _JOINT_MAP:
                    raise ValueError(f"unsupported URDF joint type {jtype!r}")
                axis_el = joint.find("axis")
                axis = _floats(axis_el.get("xyz"), [1, 0, 0]) if axis_el is not None else np.array([1.0, 0, 0])
                limit = joint.find("limit")
                dyn = joint.find("dynamics")
                attrs = {
                    "name": joint.get("name"),
                    "type": _JOINT_MAP[jtype],
                    "axis": " ".join(map(str, axis)),
                    "damping": (dyn.get("damping", "0") if dyn is not None else "0"),
                }
                if jtype in ("revolute", "prismatic") and limit is not None:
                    lo = limit.get("lower"); hi = limit.get("upper")
                    if lo is not None and hi is not None:
                        attrs["range"] = f"{lo} {hi}"
                        attrs["limited"] = "true"
                rj = _RawJoint(attrs, deg2rad=1.0)  # URDF angles are radians
                raw.joints.append(rj)
                if jtype in ("revolute", "continuous", "prismatic"):
                    effort = (
                        float(limit.get("effort", "1")) if limit is not None else 1.0
                    )
                    actuators_raw.append(
                        (joint.get("name"), joint.get("name"), effort, (-1.0, 1.0))
                    )
                    acount[0] += 1
        elif root_free:
            raw.joints.append(_RawJoint({"name": f"{link_name}_free", "type": "free"},
                                        deg2rad=1.0))

        for cj in children_of.get(link_name, []):
            cpos, cquat = _origin(cj)
            raw.children.append(
                make_body(cj.find("child").get("link"), cpos, cquat, cj)
            )
        return raw

    world = _RawBody("world", np.zeros(3), np.array([1.0, 0, 0, 0]))
    world.children.append(
        make_body(roots[0], np.asarray(root_pos, float),
                  np.array([1.0, 0, 0, 0]), None)
    )

    return _build(
        robot.get("name", name or "urdf"), world, actuators_raw,
        inertiafromgeom="auto", settotalmass=-1.0,
        opt_timestep=0.002, opt_gravity=np.array([0.0, 0.0, -9.81]),
    )


def load_urdf(path: str, root_free: bool = False,
              root_pos=(0.0, 0.0, 0.0)) -> Model:
    with open(path) as f:
        return parse_urdf(
            f.read(),
            name=os.path.splitext(os.path.basename(path))[0],
            root_free=root_free,
            root_pos=root_pos,
        )
