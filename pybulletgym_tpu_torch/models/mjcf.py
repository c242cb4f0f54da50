"""MJCF parser and compile-time model construction (host-side, numpy).

Replaces Bullet's `BulletMJCFImporter` C++ loader (`p.loadMJCF`, called from
`MJCFBasedRobot.reset` [ref: robot_bases.py · MJCFBasedRobot.reset]) with a
once-per-model host pass: XML -> kinematic tree -> frozen `Model`.

Supported MJCF subset (everything the roster models use — verified against
the gymnasium asset files on disk):
  compiler(angle, inertiafromgeom, settotalmass), option(timestep, gravity),
  single-level <default> for joint/geom/motor, nested <body> with pos/quat,
  <joint type=free|hinge|slide> (pos/axis/range/ref/armature/damping/
  stiffness/springref/limited), <geom type=plane|sphere|capsule|cylinder|box>
  (size/fromto/pos/quat/axisangle/friction/density/contype/conaffinity),
  <site>, <actuator><motor joint gear ctrlrange>.

Mass/inertia are computed from geometry exactly as MuJoCo's compiler does
(density-based, default 1000 kg/m^3); the test suite cross-checks every
roster model against the local `mujoco` bindings as an oracle.
"""

from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from pybulletgym_tpu_torch.models.schema import (
    Actuator,
    Body,
    Geom,
    GeomType,
    JointType,
    Model,
)

# ---------------------------------------------------------------------------
# host-side quaternion helpers (wxyz)
# ---------------------------------------------------------------------------


def _nq_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def _nq_rot(q, v):
    w, x, y, z = q
    u = np.array([x, y, z])
    return v + 2.0 * np.cross(u, np.cross(u, v) + w * v)


def _nq_from_axis_angle(axis, angle):
    axis = np.asarray(axis, dtype=np.float64)
    n = np.linalg.norm(axis)
    if n < 1e-12:
        return np.array([1.0, 0.0, 0.0, 0.0])
    axis = axis / n
    h = 0.5 * angle
    return np.concatenate([[math.cos(h)], axis * math.sin(h)])


def _nq_to_mat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _nq_z_align(direction):
    """Quaternion rotating local +z onto `direction` (unit)."""
    d = np.asarray(direction, dtype=np.float64)
    d = d / np.linalg.norm(d)
    z = np.array([0.0, 0.0, 1.0])
    c = float(np.dot(z, d))
    if c > 1.0 - 1e-12:
        return np.array([1.0, 0.0, 0.0, 0.0])
    if c < -1.0 + 1e-12:
        return np.array([0.0, 1.0, 0.0, 0.0])  # 180 deg about x
    axis = np.cross(z, d)
    return _nq_from_axis_angle(axis, math.acos(max(-1.0, min(1.0, c))))


# ---------------------------------------------------------------------------
# XML helpers
# ---------------------------------------------------------------------------


def _floats(s: Optional[str], default=None) -> Optional[np.ndarray]:
    if s is None:
        return None if default is None else np.asarray(default, dtype=np.float64)
    return np.array([float(x) for x in s.replace(",", " ").split()])


def _merged_attrs(elem: ET.Element, defaults: Dict[str, Dict[str, str]]) -> Dict[str, str]:
    out = dict(defaults.get(elem.tag, {}))
    out.update(elem.attrib)
    return out


# ---------------------------------------------------------------------------
# geometry mass properties (MuJoCo-compatible, density-based)
# ---------------------------------------------------------------------------


def _geom_mass_inertia(gtype: GeomType, size: np.ndarray, density: float):
    """Returns (mass, 3x3 inertia about the geom COM in the geom frame)."""
    if gtype == GeomType.SPHERE:
        r = size[0]
        m = density * 4.0 / 3.0 * math.pi * r**3
        i = 0.4 * m * r * r
        return m, np.diag([i, i, i])
    if gtype == GeomType.CAPSULE:
        r, hl = size[0], size[1]
        m_cyl = density * math.pi * r * r * (2.0 * hl)
        m_sph = density * 4.0 / 3.0 * math.pi * r**3
        izz = 0.5 * m_cyl * r * r + 0.4 * m_sph * r * r
        ixx = (
            m_cyl * (r * r / 4.0 + (2.0 * hl) ** 2 / 12.0)
            + m_sph * (0.4 * r * r + hl * hl + 0.75 * r * hl)
        )
        return m_cyl + m_sph, np.diag([ixx, ixx, izz])
    if gtype == GeomType.CYLINDER:
        r, hl = size[0], size[1]
        m = density * math.pi * r * r * (2.0 * hl)
        izz = 0.5 * m * r * r
        ixx = m * (3.0 * r * r + (2.0 * hl) ** 2) / 12.0
        return m, np.diag([ixx, ixx, izz])
    if gtype == GeomType.BOX:
        hx, hy, hz = size[0], size[1], size[2]
        m = density * 8.0 * hx * hy * hz
        return m, np.diag(
            [
                m * (hy * hy + hz * hz) / 3.0,
                m * (hx * hx + hz * hz) / 3.0,
                m * (hx * hx + hy * hy) / 3.0,
            ]
        )
    return 0.0, np.zeros((3, 3))  # PLANE: massless / static


_GEOM_TYPES = {
    "plane": GeomType.PLANE,
    "sphere": GeomType.SPHERE,
    "capsule": GeomType.CAPSULE,
    "cylinder": GeomType.CYLINDER,
    "box": GeomType.BOX,
}


# ---------------------------------------------------------------------------
# raw parse tree
# ---------------------------------------------------------------------------


class _RawJoint:
    def __init__(self, attrs: Dict[str, str], deg2rad: float):
        self.name = attrs.get("name", "")
        self.type = attrs.get("type", "hinge")
        self.pos = _floats(attrs.get("pos"), [0, 0, 0])
        self.axis = _floats(attrs.get("axis"), [0, 0, 1])
        n = np.linalg.norm(self.axis)
        self.axis = self.axis / (n if n > 0 else 1.0)
        ang = deg2rad if self.type == "hinge" else 1.0
        rng = _floats(attrs.get("range"), [0, 0]) * ang
        self.range = rng
        # MJCF-old semantics: limited iff limited="true" (possibly inherited
        # from <default>, already merged into attrs by _merged_attrs).
        self.limited = attrs.get("limited", "false").lower() == "true"
        self.ref = float(attrs.get("ref", "0")) * ang
        self.armature = float(attrs.get("armature", "0"))
        self.damping = float(attrs.get("damping", "0"))
        self.stiffness = float(attrs.get("stiffness", "0"))
        self.springref = float(attrs.get("springref", "0")) * ang


class _RawGeom:
    def __init__(self, attrs: Dict[str, str], deg2rad: float, index: int):
        self.name = attrs.get("name", f"geom{index}")
        gtype = attrs.get("type", "sphere")
        if gtype not in _GEOM_TYPES:
            raise ValueError(f"unsupported geom type {gtype!r}")
        self.gtype = _GEOM_TYPES[gtype]
        size = _floats(attrs.get("size"), [0, 0, 0])
        self.density = float(attrs.get("density", "1000"))
        fr = _floats(attrs.get("friction"))
        self.friction = float(fr[0]) if fr is not None else 1.0
        self.contype = int(attrs.get("contype", "1"))
        self.conaffinity = int(attrs.get("conaffinity", "1"))

        pos = _floats(attrs.get("pos"), [0, 0, 0])
        quat = _floats(attrs.get("quat"))
        if quat is None and "axisangle" in attrs:
            aa = _floats(attrs["axisangle"])
            quat = _nq_from_axis_angle(aa[:3], aa[3] * deg2rad)
        if quat is None and "zaxis" in attrs:
            quat = _nq_z_align(_floats(attrs["zaxis"]))
        if quat is None and "euler" in attrs:
            e = _floats(attrs["euler"]) * deg2rad
            quat = _nq_mul(
                _nq_mul(
                    _nq_from_axis_angle([1, 0, 0], e[0]),
                    _nq_from_axis_angle([0, 1, 0], e[1]),
                ),
                _nq_from_axis_angle([0, 0, 1], e[2]),
            )
        if quat is None:
            quat = np.array([1.0, 0.0, 0.0, 0.0])
        quat = quat / np.linalg.norm(quat)

        if "fromto" in attrs:
            ft = _floats(attrs["fromto"])
            a, b = ft[:3], ft[3:]
            pos = 0.5 * (a + b)
            d = b - a
            hl = 0.5 * float(np.linalg.norm(d))
            quat = _nq_z_align(d)
            size = np.array([size[0], hl, 0.0])

        self.pos = pos
        self.quat = quat
        if self.gtype == GeomType.SPHERE:
            self.size = np.array([size[0]])
        elif self.gtype in (GeomType.CAPSULE, GeomType.CYLINDER):
            self.size = np.array([size[0], size[1]])
        elif self.gtype == GeomType.BOX:
            self.size = size[:3].copy()
        else:
            self.size = size[:3].copy()

    def mass_inertia(self):
        return _geom_mass_inertia(self.gtype, self.size, self.density)


class _RawBody:
    def __init__(self, name, pos, quat):
        self.name = name
        self.pos = pos
        self.quat = quat
        self.joints: List[_RawJoint] = []
        self.geoms: List[_RawGeom] = []
        self.sites: List[Tuple[str, np.ndarray, np.ndarray]] = []
        self.children: List["_RawBody"] = []
        # explicit (mass, com, inertia-about-com) overriding geom-derived
        # mass props — used by the URDF importer's <inertial> elements
        self.inertial = None


def _parse_body(elem: ET.Element, defaults, deg2rad, counter) -> _RawBody:
    name = elem.get("name", f"body{counter[0]}")
    counter[0] += 1
    pos = _floats(elem.get("pos"), [0, 0, 0])
    quat = _floats(elem.get("quat"), [1, 0, 0, 0])
    quat = quat / np.linalg.norm(quat)
    body = _RawBody(name, pos, quat)
    for child in elem:
        if child.tag == "joint":
            body.joints.append(_RawJoint(_merged_attrs(child, defaults), deg2rad))
        elif child.tag == "freejoint":
            a = dict(child.attrib)
            a["type"] = "free"
            body.joints.append(_RawJoint(a, deg2rad))
        elif child.tag == "geom":
            body.geoms.append(
                _RawGeom(_merged_attrs(child, defaults), deg2rad, counter[1])
            )
            counter[1] += 1
        elif child.tag == "site":
            spos = _floats(child.get("pos"), [0, 0, 0])
            squat = _floats(child.get("quat"), [1, 0, 0, 0])
            body.sites.append((child.get("name", f"site{counter[0]}"), spos, squat))
        elif child.tag == "body":
            body.children.append(_parse_body(child, defaults, deg2rad, counter))
    return body


# `limited` handling: MJCF pre-2.0 semantics (these files): a joint is limited
# iff `limited="true"` appears on the joint or in defaults. The gym files set
# limited in <default> and override to "false" on root joints.


def parse_mjcf(xml_string: str, name: Optional[str] = None) -> Model:
    root = ET.fromstring(xml_string)
    comp = root.find("compiler")
    angle = comp.get("angle", "degree") if comp is not None else "degree"
    deg2rad = math.pi / 180.0 if angle == "degree" else 1.0
    inertiafromgeom = (
        comp.get("inertiafromgeom", "auto") if comp is not None else "auto"
    )
    settotalmass = float(comp.get("settotalmass", "-1")) if comp is not None else -1.0

    opt = root.find("option")
    opt_timestep = float(opt.get("timestep", "0.002")) if opt is not None else 0.002
    opt_gravity = (
        _floats(opt.get("gravity"), [0, 0, -9.81])
        if opt is not None
        else np.array([0.0, 0.0, -9.81])
    )

    defaults: Dict[str, Dict[str, str]] = {}
    dflt = root.find("default")
    if dflt is not None:
        for child in dflt:
            defaults[child.tag] = dict(child.attrib)

    worldbody = root.find("worldbody")
    if worldbody is None:
        raise ValueError("MJCF missing <worldbody>")

    counter = [0, 0]
    world = _RawBody("world", np.zeros(3), np.array([1.0, 0, 0, 0]))
    for child in worldbody:
        if child.tag == "geom":
            world.geoms.append(_RawGeom(_merged_attrs(child, defaults), deg2rad, counter[1]))
            counter[1] += 1
        elif child.tag == "body":
            world.children.append(_parse_body(child, defaults, deg2rad, counter))
        elif child.tag == "site":
            spos = _floats(child.get("pos"), [0, 0, 0])
            squat = _floats(child.get("quat"), [1, 0, 0, 0])
            world.sites.append((child.get("name", f"wsite{counter[0]}"), spos, squat))

    actuators_raw = []
    act = root.find("actuator")
    if act is not None:
        for m in act:
            if m.tag != "motor":
                raise ValueError(f"unsupported actuator {m.tag!r}")
            a = _merged_attrs(m, defaults)
            cr = _floats(a.get("ctrlrange"), [-1, 1])
            actuators_raw.append(
                (
                    a.get("name", a["joint"]),
                    a["joint"],
                    float(a.get("gear", "1")),
                    (float(cr[0]), float(cr[1])),
                )
            )

    return _build(
        root.get("model", name or "mjcf"),
        world,
        actuators_raw,
        inertiafromgeom,
        settotalmass,
        opt_timestep,
        opt_gravity,
    )


def load_mjcf(path: str) -> Model:
    with open(path) as f:
        return parse_mjcf(f.read(), name=os.path.splitext(os.path.basename(path))[0])


# ---------------------------------------------------------------------------
# build: expansion, weld-merging, address assignment
# ---------------------------------------------------------------------------


def _body_mass_props(raw: _RawBody):
    """Mass, COM, inertia-about-COM in the body frame from its geoms."""
    m_tot = 0.0
    h = np.zeros(3)
    for g in raw.geoms:
        m, _ = g.mass_inertia()
        m_tot += m
        h += m * g.pos
    if m_tot <= 0.0:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    com = h / m_tot
    inertia = np.zeros((3, 3))
    for g in raw.geoms:
        m, ic = g.mass_inertia()
        r = _nq_to_mat(g.quat)
        ic_body = r @ ic @ r.T
        d = g.pos - com
        inertia += ic_body + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    return m_tot, com, inertia


def _build(
    name, world, actuators_raw, inertiafromgeom, settotalmass, opt_timestep, opt_gravity
) -> Model:
    bodies: List[Body] = []
    geoms: List[Geom] = []
    frames: Dict[str, Tuple[int, np.ndarray, np.ndarray]] = {}
    sites: Dict[str, Tuple[int, np.ndarray, np.ndarray]] = {}
    qpos0: List[float] = []
    dof_params = {k: [] for k in ("armature", "damping", "stiffness", "springref")}
    jnt_limited: List[bool] = []
    jnt_range: List[Tuple[float, float]] = []
    joint_names: List[str] = []
    dof_body: List[int] = []
    joint_dof: Dict[str, int] = {}

    # world-attached geoms/sites
    for g in world.geoms:
        geoms.append(
            Geom(g.name, -1, g.gtype, g.size, g.pos, g.quat, g.friction, g.contype, g.conaffinity)
        )
    for sname, spos, squat in world.sites:
        sites[sname] = (-1, spos, squat)

    def add_dof(j: _RawJoint, body_idx: int):
        v = len(dof_body)
        dof_body.append(body_idx)
        if j.type == "free":
            for _ in range(6):
                dof_params["armature"].append(0.0)
                dof_params["damping"].append(j.damping)
                dof_params["stiffness"].append(0.0)
                dof_params["springref"].append(0.0)
                jnt_limited.append(False)
                jnt_range.append((0.0, 0.0))
                joint_names.append(j.name)
            # 5 extra dof_body entries for the remaining free dofs
            for _ in range(5):
                dof_body.append(body_idx)
        else:
            dof_params["armature"].append(j.armature)
            dof_params["damping"].append(j.damping)
            dof_params["stiffness"].append(j.stiffness)
            dof_params["springref"].append(j.springref)
            jnt_limited.append(j.limited)
            jnt_range.append((float(j.range[0]), float(j.range[1])))
            joint_names.append(j.name)
        joint_dof[j.name] = v
        return v

    def walk(raw: _RawBody, parent_idx: int, off_pos, off_quat, depth=0):
        """Emit bodies for `raw` (chain for multi-joint, weld-merge for
        jointless) and recurse. off_pos/off_quat accumulate welded offsets."""
        body_pos = off_pos + _nq_rot(off_quat, raw.pos)
        body_quat = _nq_mul(off_quat, raw.quat)

        if raw.inertial is not None:
            mass, com, inertia = raw.inertial
        else:
            mass, com, inertia = (
                _body_mass_props(raw) if inertiafromgeom != "false"
                else (0.0, np.zeros(3), np.zeros((3, 3)))
            )

        if raw.joints:
            jlist = raw.joints
            host_parent = parent_idx
            for k, j in enumerate(jlist):
                last = k == len(jlist) - 1
                idx = len(bodies)
                if j.type == "free":
                    if host_parent != -1 or k != 0 or not last:
                        raise ValueError(
                            f"free joint on non-root/multi-joint body {raw.name!r}"
                        )
                    jt = JointType.FREE
                    q_adr = len(qpos0)
                    qpos0.extend(list(body_pos) + list(body_quat))
                elif j.type == "hinge":
                    jt = JointType.HINGE
                    q_adr = len(qpos0)
                    qpos0.append(j.ref)
                elif j.type == "slide":
                    jt = JointType.SLIDE
                    q_adr = len(qpos0)
                    qpos0.append(j.ref)
                else:
                    raise ValueError(f"unsupported joint type {j.type!r}")
                v_adr = add_dof(j, idx)
                bodies.append(
                    Body(
                        name=raw.name if last else f"{raw.name}~{j.name}",
                        parent=host_parent,
                        jtype=jt,
                        pos=body_pos if k == 0 else np.zeros(3),
                        quat=body_quat if k == 0 else np.array([1.0, 0, 0, 0]),
                        jpos=j.pos.copy(),
                        jaxis=j.axis.copy(),
                        jref=j.ref,
                        q_adr=q_adr,
                        v_adr=v_adr,
                        mass=mass if last else 0.0,
                        com=com if last else np.zeros(3),
                        inertia=inertia if last else np.zeros((3, 3)),
                    )
                )
                host_parent = idx
            host = host_parent
            g_pos, g_quat = np.zeros(3), np.array([1.0, 0, 0, 0])
        else:
            # Weld: merge into parent (combine inertia in the parent frame).
            host = parent_idx
            g_pos, g_quat = body_pos, body_quat
            if host == -1:
                if mass > 0:
                    raise ValueError(f"jointless massive body {raw.name!r} at world level")
            elif mass > 0:
                b = bodies[host]
                com_w = g_pos + _nq_rot(g_quat, com)
                r = _nq_to_mat(g_quat)
                i_w = r @ inertia @ r.T
                m_new = b.mass + mass
                com_new = (b.mass * b.com + mass * com_w) / m_new
                d1 = b.com - com_new
                d2 = com_w - com_new
                i_new = (
                    b.inertia
                    + b.mass * (np.dot(d1, d1) * np.eye(3) - np.outer(d1, d1))
                    + i_w
                    + mass * (np.dot(d2, d2) * np.eye(3) - np.outer(d2, d2))
                )
                bodies[host] = Body(
                    b.name, b.parent, b.jtype, b.pos, b.quat, b.jpos, b.jaxis,
                    b.jref, b.q_adr, b.v_adr, m_new, com_new, i_new,
                )

        frames[raw.name] = (host, g_pos.copy(), g_quat.copy())
        for g in raw.geoms:
            geoms.append(
                Geom(
                    g.name,
                    host,
                    g.gtype,
                    g.size,
                    g_pos + _nq_rot(g_quat, g.pos),
                    _nq_mul(g_quat, g.quat),
                    g.friction,
                    g.contype,
                    g.conaffinity,
                )
            )
        for sname, spos, squat in raw.sites:
            sites[sname] = (host, g_pos + _nq_rot(g_quat, spos), _nq_mul(g_quat, squat))

        for child in raw.children:
            if raw.joints:
                walk(child, host, np.zeros(3), np.array([1.0, 0, 0, 0]), depth + 1)
            else:
                walk(child, host, g_pos, g_quat, depth + 1)

    for child in world.children:
        walk(child, -1, np.zeros(3), np.array([1.0, 0, 0, 0]))

    # settotalmass: scale all masses (and inertias) proportionally, as the
    # MuJoCo compiler does.
    if settotalmass > 0:
        total = sum(b.mass for b in bodies)
        if total > 0:
            s = settotalmass / total
            for i, b in enumerate(bodies):
                bodies[i] = Body(
                    b.name, b.parent, b.jtype, b.pos, b.quat, b.jpos, b.jaxis,
                    b.jref, b.q_adr, b.v_adr, b.mass * s, b.com, b.inertia * s,
                )

    actuators = tuple(
        Actuator(aname, jname, joint_dof[jname], gear, cr)
        for (aname, jname, gear, cr) in actuators_raw
    )

    nv = len(dof_body)
    body_dofs = []
    for i, b in enumerate(bodies):
        if b.jtype == JointType.FREE:
            body_dofs.append(tuple(range(b.v_adr, b.v_adr + 6)))
        else:
            body_dofs.append((b.v_adr,))
    ancestor_dofs = []
    for i, b in enumerate(bodies):
        anc: List[int] = []
        j = i
        while j != -1:
            anc = list(body_dofs[j]) + anc
            j = bodies[j].parent
        ancestor_dofs.append(tuple(anc))

    return Model(
        name=name,
        bodies=tuple(bodies),
        nq=len(qpos0),
        nv=nv,
        qpos0=np.array(qpos0, dtype=np.float64),
        dof_armature=np.array(dof_params["armature"]),
        dof_damping=np.array(dof_params["damping"]),
        dof_stiffness=np.array(dof_params["stiffness"]),
        dof_springref=np.array(dof_params["springref"]),
        jnt_limited=np.array(jnt_limited, dtype=bool),
        jnt_range=np.array(jnt_range, dtype=np.float64).reshape(-1, 2),
        geoms=tuple(geoms),
        actuators=actuators,
        frames=frames,
        sites=sites,
        opt_timestep=opt_timestep,
        opt_gravity=opt_gravity,
        body_dofs=tuple(body_dofs),
        ancestor_dofs=tuple(ancestor_dofs),
        joint_names=tuple(joint_names),
        dof_body=tuple(dof_body),
    )
