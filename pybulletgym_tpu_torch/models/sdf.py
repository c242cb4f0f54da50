"""SDF importer (minimal): the reference loads its stadium ground from
`plane_stadium.sdf` via `p.loadSDF` [ref: scene_stadium.py ·
StadiumScene.episode_restart — SURVEY §2.2]. The only SDF content the env
suite consumes is static world geometry (a ground plane plus decorative
meshes, which Bullet also treats as visual-only for collisions there), so
this importer extracts static collision primitives into world-attached
geoms; articulated SDF models are out of scope (none exist in the roster).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Optional

import numpy as np

from pybulletgym_tpu_torch.models.schema import Geom, GeomType


def _floats(s, default):
    if s is None:
        return np.asarray(default, float)
    return np.array([float(x) for x in s.split()])


def _quat_from_rpy(rpy):
    """SDF <pose> rpy (fixed-axis roll-pitch-yaw, R = Rz*Ry*Rx) -> wxyz."""
    hr, hp, hy = 0.5 * rpy[0], 0.5 * rpy[1], 0.5 * rpy[2]
    cr, sr = np.cos(hr), np.sin(hr)
    cp, sp = np.cos(hp), np.sin(hp)
    cy, sy = np.cos(hy), np.sin(hy)
    return np.array([
        cy * cp * cr + sy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
    ])


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _quat_rotate(q, v):
    w, x, y, z = q
    u = np.array([x, y, z])
    return v + 2.0 * np.cross(u, np.cross(u, v) + w * v)


def parse_sdf_world_geoms(xml_string: str) -> List[Geom]:
    """Static collision geoms (plane/box/sphere/cylinder) from an SDF doc,
    in world coordinates, ready to merge into a Model's geom list."""
    root = ET.fromstring(xml_string)
    out: List[Geom] = []
    idx = 0
    for model in root.iter("model"):
        mpose = _floats(
            model.findtext("pose"), [0, 0, 0, 0, 0, 0]
        )
        for link in model.iter("link"):
            for col in link.iter("collision"):
                geo = col.find("geometry")
                if geo is None:
                    continue
                pose = _floats(col.findtext("pose"), [0, 0, 0, 0, 0, 0])
                # compose model and collision poses: the collision offset
                # is expressed in the (possibly rotated) model frame
                # (ADVICE r1: translations alone silently misplaced any
                # rotated geometry)
                mquat = _quat_from_rpy(mpose[3:6])
                pos = mpose[:3] + _quat_rotate(mquat, pose[:3])
                quat = _quat_mul(mquat, _quat_from_rpy(pose[3:6]))
                name = col.get("name", f"sdf{idx}")
                if geo.find("plane") is not None:
                    out.append(Geom(name, -1, GeomType.PLANE,
                                    np.array([0.0, 0.0, 0.0]), pos,
                                    quat, 0.8, 1, 1))
                elif geo.find("box") is not None:
                    size = _floats(geo.find("box").findtext("size"),
                                   [1, 1, 1]) / 2.0
                    out.append(Geom(name, -1, GeomType.BOX, size, pos,
                                    quat, 0.8, 1, 1))
                elif geo.find("sphere") is not None:
                    r = float(geo.find("sphere").findtext("radius", "0.5"))
                    out.append(Geom(name, -1, GeomType.SPHERE,
                                    np.array([r]), pos,
                                    quat, 0.8, 1, 1))
                elif geo.find("cylinder") is not None:
                    c = geo.find("cylinder")
                    r = float(c.findtext("radius", "0.5"))
                    hl = float(c.findtext("length", "1.0")) / 2.0
                    out.append(Geom(name, -1, GeomType.CYLINDER,
                                    np.array([r, hl]), pos,
                                    quat, 0.8, 1, 1))
                # meshes: visual-only in the reference stadium too — skip
                idx += 1
    return out


def load_sdf_world_geoms(path: str) -> List[Geom]:
    with open(path) as f:
        return parse_sdf_world_geoms(f.read())
